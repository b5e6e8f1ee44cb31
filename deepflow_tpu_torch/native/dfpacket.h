// Shared decoded-packet record for the native fast path.
// Own copy of deepflow_tpu/native/dfpacket.h. Layout must match
// PACKET_DTYPE in deepflow_tpu_torch/native/__init__.py.
#pragma once

#include <cstdint>

struct DfPacketOut {
    uint32_t ip_src;     // v4 only on the fast path; v6 falls back to Python
    uint32_t ip_dst;
    uint16_t port_src;
    uint16_t port_dst;
    uint8_t  protocol;   // 1 tcp, 2 udp, 3 icmp, 0 = not decodable here
    uint8_t  tcp_flags;
    uint16_t window;
    uint32_t seq;
    uint32_t ack;
    uint32_t payload_off;
    uint32_t payload_len;
    // tunnel decapsulation (reference: agent/src/common/decapsulate.rs):
    // when a VXLAN/GENEVE/GRE/ERSPAN outer was stripped, the fields above
    // describe the INNER packet and these record the tunnel
    uint8_t  tunnel_type;  // 0 none, 1 vxlan, 2 geneve, 3 erspan, 4 gre-teb
    uint8_t  _pad[3];
    uint32_t tunnel_id;    // VNI / session id / GRE key
};
