"""MetaPacket: decoded packet header view + capture sources.

Own copy of ``deepflow_tpu/agent/packet.py``: ``MetaPacket`` and
``TcpFlags``, ``decode_ethernet`` with VXLAN, GENEVE, GRE and ERSPAN
decapsulation at one nesting level, the pcap reader (classic libpcap
format, both byte orders) and the synthetic frame builders. ``read_pcap``
decodes IPv4 frames with the port's native batch decoder
(``native/dfnative.cpp`` df_decode_eth_batch) unless asked not to, and a
native library that does not build or load raises; the frames the native
decoder leaves (IPv6, VLAN in a tunnel, odd ones) take the Python decoder.
This module loads no torch.
"""

from __future__ import annotations

import socket
import struct
import time
from dataclasses import dataclass, field
from enum import IntFlag


class TcpFlags(IntFlag):
    FIN = 0x01
    SYN = 0x02
    RST = 0x04
    PSH = 0x08
    ACK = 0x10
    URG = 0x20


@dataclass
class MetaPacket:
    timestamp_ns: int = 0
    ip_src: bytes = b""
    ip_dst: bytes = b""
    port_src: int = 0
    port_dst: int = 0
    protocol: int = 0            # pb.L4Protocol values: 1 tcp, 2 udp, 3 icmp
    tcp_flags: int = 0
    seq: int = 0
    ack: int = 0
    window: int = 0
    payload: bytes = b""
    packet_len: int = 0          # on-wire length
    tap_port: int = 0
    # uprobe-source extras (sslprobe): thread-scoped chain id + tid
    syscall_trace_id: int = 0
    tid: int = 0
    # tunnel decapsulation (reference: common/decapsulate.rs): when an
    # outer VXLAN/GENEVE/GRE/ERSPAN layer was stripped, the 5-tuple above
    # is the INNER packet's and these record the tunnel
    tunnel_type: int = 0         # 0 none, 1 vxlan, 2 geneve, 3 erspan,
    tunnel_id: int = 0           # 4 gre-teb; VNI / session id / GRE key

    @property
    def key(self) -> tuple:
        # tunnel identity is part of flow identity: overlapping tenant IP
        # space across VNIs must not merge into one flow
        return (self.ip_src, self.ip_dst, self.port_src, self.port_dst,
                self.protocol, self.tunnel_type, self.tunnel_id)

    @property
    def reverse_key(self) -> tuple:
        return (self.ip_dst, self.ip_src, self.port_dst, self.port_src,
                self.protocol, self.tunnel_type, self.tunnel_id)


ETH_IPV4 = 0x0800
ETH_IPV6 = 0x86DD


def decode_ethernet(frame: bytes, timestamp_ns: int = 0,
                    tap_port: int = 0,
                    _depth: int = 0) -> MetaPacket | None:
    """Ethernet II -> IPv4/IPv6 -> TCP/UDP/ICMP header decode, with
    VXLAN/GENEVE/GRE/ERSPAN decapsulation (one nesting level, matching
    the native fast path)."""
    if len(frame) < 14:
        return None
    eth_type = struct.unpack_from(">H", frame, 12)[0]
    off = 14
    if eth_type == 0x8100 and len(frame) >= 18:  # 802.1Q VLAN
        eth_type = struct.unpack_from(">H", frame, 16)[0]
        off = 18
    if eth_type == ETH_IPV4:
        return _decode_ipv4(frame, off, timestamp_ns, tap_port, len(frame),
                            _depth)
    if eth_type == ETH_IPV6:
        return _decode_ipv6(frame, off, timestamp_ns, tap_port, len(frame))
    return None


def _decap(frame: bytes, inner_off: int, ttype: int, tid: int, ts: int,
           tap: int, depth: int) -> MetaPacket | None:
    if depth >= 2:
        return None
    inner = decode_ethernet(frame[inner_off:], ts, tap, _depth=depth + 1)
    if inner is None:
        return None
    if inner.tunnel_type == 0:  # innermost tunnel wins the stamp
        inner.tunnel_type = ttype
        inner.tunnel_id = tid
    # byte metrics count WIRE bytes: the outer frame's length, including
    # the overlay headers (matches the native fast path)
    inner.packet_len = len(frame)
    return inner


def _try_decap_udp(frame: bytes, pay: int, end: int, dport: int, ts: int,
                   tap: int, depth: int) -> MetaPacket | None:
    # VXLAN (RFC 7348): 8-byte header, I-flag validates the VNI
    if dport == 4789 and end >= pay + 8 and frame[pay] & 0x08:
        vni = int.from_bytes(frame[pay + 4:pay + 7], "big")
        return _decap(frame, pay + 8, 1, vni, ts, tap, depth)
    # GENEVE (RFC 8926): options + inner proto Transparent Eth Bridging
    if dport == 6081 and end >= pay + 8:
        optlen = (frame[pay] & 0x3F) * 4
        inner_proto = struct.unpack_from(">H", frame, pay + 2)[0]
        vni = int.from_bytes(frame[pay + 4:pay + 7], "big")
        if inner_proto == 0x6558:
            return _decap(frame, pay + 8 + optlen, 2, vni, ts, tap, depth)
    return None


def _try_decap_gre(frame: bytes, l4: int, end: int, ts: int, tap: int,
                   depth: int) -> MetaPacket | None:
    if end < l4 + 4:
        return None
    flags, gre_proto = struct.unpack_from(">HH", frame, l4)
    gh = l4 + 4
    if flags & 0x8000:
        gh += 4  # checksum + reserved
    key = 0
    if flags & 0x2000:
        if end < gh + 4:
            return None
        key = struct.unpack_from(">I", frame, gh)[0]
        gh += 4
    has_seq = bool(flags & 0x1000)
    if has_seq:
        gh += 4
    if gre_proto == 0x88BE:  # ERSPAN: II has an 8B header (seq bit), I none
        sess = (struct.unpack_from(">H", frame, gh + 2)[0] & 0x03FF
                if has_seq and end >= gh + 4 else 0)
        return _decap(frame, gh + (8 if has_seq else 0), 3, sess, ts, tap,
                      depth)
    if gre_proto == 0x22EB:  # ERSPAN III: 12B header
        sess = (struct.unpack_from(">H", frame, gh + 2)[0] & 0x03FF
                if end >= gh + 4 else 0)
        return _decap(frame, gh + 12, 3, sess, ts, tap, depth)
    if gre_proto == 0x6558:  # transparent ethernet bridging
        return _decap(frame, gh, 4, key, ts, tap, depth)
    return None


def _decode_ipv4(frame: bytes, off: int, ts: int, tap: int,
                 wire_len: int, depth: int = 0) -> MetaPacket | None:
    if len(frame) < off + 20:
        return None
    ver_ihl = frame[off]
    ihl = (ver_ihl & 0x0F) * 4
    total_len = struct.unpack_from(">H", frame, off + 2)[0]
    proto = frame[off + 9]
    ip_src = frame[off + 12:off + 16]
    ip_dst = frame[off + 16:off + 20]
    l4_off = off + ihl
    end = min(len(frame), off + total_len)
    if proto == 47:  # GRE / ERSPAN
        inner = _try_decap_gre(frame, l4_off, end, ts, tap, depth)
        if inner is not None:
            return inner
        return None  # plain GRE payloads are not flow material
    if proto == 17 and end >= l4_off + 8:
        dport = struct.unpack_from(">H", frame, l4_off + 2)[0]
        inner = _try_decap_udp(frame, l4_off + 8, end, dport, ts, tap,
                               depth)
        if inner is not None:
            return inner
    return _decode_l4(frame, l4_off, end, proto, ip_src, ip_dst, ts, tap,
                      wire_len)


def _decode_ipv6(frame: bytes, off: int, ts: int, tap: int,
                 wire_len: int) -> MetaPacket | None:
    if len(frame) < off + 40:
        return None
    next_header = frame[off + 6]
    payload_len = struct.unpack_from(">H", frame, off + 4)[0]
    ip_src = frame[off + 8:off + 24]
    ip_dst = frame[off + 24:off + 40]
    l4_off = off + 40
    end = min(len(frame), l4_off + payload_len)
    return _decode_l4(frame, l4_off, end, next_header, ip_src, ip_dst, ts,
                      tap, wire_len)


def _decode_l4(frame: bytes, off: int, end: int, proto: int, ip_src: bytes,
               ip_dst: bytes, ts: int, tap: int,
               wire_len: int) -> MetaPacket | None:
    p = MetaPacket(timestamp_ns=ts, ip_src=ip_src, ip_dst=ip_dst,
                   tap_port=tap, packet_len=wire_len)
    if proto == 6:  # TCP
        if end < off + 20:
            return None
        (p.port_src, p.port_dst, p.seq, p.ack) = struct.unpack_from(
            ">HHII", frame, off)
        data_off = (frame[off + 12] >> 4) * 4
        p.tcp_flags = frame[off + 13]
        p.window = struct.unpack_from(">H", frame, off + 14)[0]
        p.protocol = 1
        p.payload = frame[off + data_off:end]
        return p
    if proto == 17:  # UDP
        if end < off + 8:
            return None
        p.port_src, p.port_dst = struct.unpack_from(">HH", frame, off)
        p.protocol = 2
        p.payload = frame[off + 8:end]
        return p
    if proto in (1, 58):  # ICMP / ICMPv6
        p.protocol = 3
        p.payload = frame[off:end]
        return p
    return None


# -- pcap file source (classic format, both endiannesses) --------------------

PCAP_MAGIC_US_LE = 0xA1B2C3D4
PCAP_MAGIC_NS_LE = 0xA1B23C4D


def read_pcap_records(path: str) -> list[tuple[bytes, int, int]]:
    """Raw pcap records: (frame_bytes, ts_ns, orig_len) — no decoding."""
    raw: list[tuple[bytes, int, int]] = []
    with open(path, "rb") as f:
        hdr = f.read(24)
        if len(hdr) < 24:
            raise ValueError(f"not a pcap file (too short): {path}")
        magic = struct.unpack_from("<I", hdr, 0)[0]
        if magic == PCAP_MAGIC_US_LE:
            endian, scale = "<", 1000
        elif magic == PCAP_MAGIC_NS_LE:
            endian, scale = "<", 1
        elif struct.unpack_from(">I", hdr, 0)[0] == PCAP_MAGIC_US_LE:
            endian, scale = ">", 1000
        elif struct.unpack_from(">I", hdr, 0)[0] == PCAP_MAGIC_NS_LE:
            endian, scale = ">", 1
        else:
            raise ValueError(f"not a pcap file: {path}")
        while True:
            rec = f.read(16)
            if len(rec) < 16:
                break
            ts_sec, ts_frac, incl, orig = struct.unpack(endian + "IIII", rec)
            data = f.read(incl)
            if len(data) < incl:
                break
            ts_ns = ts_sec * 1_000_000_000 + ts_frac * scale
            raw.append((data, ts_ns, orig))
    return raw


def read_pcap(path: str, use_native: bool = True) -> list[MetaPacket]:
    """Own pcap reader — no libpcap dependency. Returns decoded packets.

    With ``use_native``, IPv4 frames decode through the native batch
    decoder (which must build and load) and v6/vlan/other frames through
    the Python decoder; without it, every frame through the Python one.
    """
    raw = read_pcap_records(path)
    out: list[MetaPacket] = []
    if use_native:
        from deepflow_tpu_torch.native import decode_eth_batch
        # chunk the native batches so a large capture never holds a
        # second full copy of itself in the join buffer
        for lo in range(0, len(raw), 65536):
            chunk = raw[lo:lo + 65536]
            _decode_chunk(chunk, decode_eth_batch([r[0] for r in chunk]),
                          out)
        return out
    for data, ts_ns, orig in raw:
        mp = decode_ethernet(data, timestamp_ns=ts_ns)
        if mp is not None:
            mp.packet_len = orig
            out.append(mp)
    return out


def _decode_chunk(raw, decoded, out: list) -> None:
    """Materialize MetaPackets from one native decode batch."""
    recs, ok = decoded
    # column-wise extraction once (structured-scalar access is slow)
    cols = {name: recs[name].tolist() for name in
            ("ip_src", "ip_dst", "port_src", "port_dst", "protocol",
             "tcp_flags", "window", "seq", "ack", "payload_off",
             "payload_len", "tunnel_type", "tunnel_id")}
    ok_l = ok.tolist()
    for i, (data, ts_ns, orig) in enumerate(raw):
        if ok_l[i]:
            po = cols["payload_off"][i]
            pl = cols["payload_len"][i]
            out.append(MetaPacket(
                timestamp_ns=ts_ns,
                ip_src=cols["ip_src"][i].to_bytes(4, "big"),
                ip_dst=cols["ip_dst"][i].to_bytes(4, "big"),
                port_src=cols["port_src"][i],
                port_dst=cols["port_dst"][i],
                protocol=cols["protocol"][i],
                tcp_flags=cols["tcp_flags"][i], seq=cols["seq"][i],
                ack=cols["ack"][i], window=cols["window"][i],
                payload=data[po:po + pl], packet_len=orig,
                tunnel_type=cols["tunnel_type"][i],
                tunnel_id=cols["tunnel_id"][i]))
        else:  # v6 / vlan / odd frames: Python slow path
            mp = decode_ethernet(data, timestamp_ns=ts_ns)
            if mp is not None:
                mp.packet_len = orig
                out.append(mp)


# -- synthetic builders (tests + fake traffic) --------------------------------

def build_tcp(ip_src: str, ip_dst: str, port_src: int, port_dst: int,
              flags: int = TcpFlags.ACK, payload: bytes = b"",
              seq: int = 0, ack: int = 0, timestamp_ns: int | None = None,
              window: int = 65535) -> MetaPacket:
    return MetaPacket(
        timestamp_ns=time.time_ns() if timestamp_ns is None else timestamp_ns,
        ip_src=socket.inet_aton(ip_src), ip_dst=socket.inet_aton(ip_dst),
        port_src=port_src, port_dst=port_dst, protocol=1,
        tcp_flags=int(flags), seq=seq, ack=ack, window=window,
        payload=payload, packet_len=54 + len(payload))


def build_udp(ip_src: str, ip_dst: str, port_src: int, port_dst: int,
              payload: bytes = b"",
              timestamp_ns: int | None = None) -> MetaPacket:
    return MetaPacket(
        timestamp_ns=time.time_ns() if timestamp_ns is None else timestamp_ns,
        ip_src=socket.inet_aton(ip_src), ip_dst=socket.inet_aton(ip_dst),
        port_src=port_src, port_dst=port_dst, protocol=2,
        payload=payload, packet_len=42 + len(payload))


def encode_tcp_frame(ip_src: str, ip_dst: str, port_src: int, port_dst: int,
                     flags: int = TcpFlags.ACK, payload: bytes = b"",
                     seq: int = 0, ack: int = 0,
                     window: int = 65535) -> bytes:
    """Raw Ethernet/IPv4/TCP frame bytes (native-pipeline tests + bench)."""
    total = 20 + 20 + len(payload)
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, total, 0, 0x4000, 64, 6, 0,
                     socket.inet_aton(ip_src), socket.inet_aton(ip_dst))
    tcp = struct.pack(">HHIIBBHHH", port_src, port_dst, seq & 0xFFFFFFFF,
                      ack & 0xFFFFFFFF, 5 << 4, int(flags), window, 0, 0)
    return b"\x00" * 12 + b"\x08\x00" + ip + tcp + payload


def encode_udp_frame(ip_src: str, ip_dst: str, port_src: int, port_dst: int,
                     payload: bytes = b"") -> bytes:
    total = 20 + 8 + len(payload)
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, total, 0, 0x4000, 64, 17, 0,
                     socket.inet_aton(ip_src), socket.inet_aton(ip_dst))
    udp = struct.pack(">HHHH", port_src, port_dst, 8 + len(payload), 0)
    return b"\x00" * 12 + b"\x08\x00" + ip + udp + payload
