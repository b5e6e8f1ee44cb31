// Native flow pipeline (port): packets stay C structs from capture to the
// L7 boundary; only payload segments that need protocol parsing and
// closed-flow records ever surface to Python.
//
// Own copy of deepflow_tpu/native/flowmap.cpp, built into the port's
// library by deepflow_tpu_torch/native/__init__.py: the flow map
// (df_fm_*: flow table, TCP FSM, RTT, retransmissions, eviction by heap,
// close records, the L7 payload sink) and the TPACKET_V3 ring (df_ring_*).
// One single-threaded map per dispatcher shard, a batch ABI for ctypes,
// and an L7 sink that copies payload bytes out of the ring so blocks can
// be released at once. The packed structs must match the dtypes in
// native/__init__.py.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <cerrno>
#include <net/if.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <unistd.h>

#include <linux/if_ether.h>
#include <linux/if_packet.h>

#include "dfpacket.h"
extern "C" int32_t df_decode_eth(const uint8_t* data, uint32_t len,
                                 DfPacketOut* out);

namespace {

// ---------------------------------------------------------------------------
// flow key / hash
// ---------------------------------------------------------------------------

struct FlowKey {
    uint64_t a;  // ip_src << 32 | ip_dst
    uint64_t b;  // port_src << 32 | port_dst << 16 | proto
    uint64_t c;  // tunnel_type << 32 | tunnel_id — overlapping tenant IP
                 // space across VNIs must NOT merge into one flow
    bool operator==(const FlowKey& o) const {
        return a == o.a && b == o.b && c == o.c;
    }
};

static inline FlowKey make_key(const DfPacketOut& p) {
    return FlowKey{(uint64_t)p.ip_src << 32 | p.ip_dst,
                   (uint64_t)p.port_src << 32 |
                       (uint64_t)p.port_dst << 16 | p.protocol,
                   (uint64_t)p.tunnel_type << 32 | p.tunnel_id};
}

static inline FlowKey reverse_key(const FlowKey& k) {
    return FlowKey{(k.a << 32) | (k.a >> 32),
                   ((k.b >> 32) & 0xFFFF) << 16 |
                       ((k.b >> 16) & 0xFFFF) << 32 | (k.b & 0xFF),
                   k.c};
}

struct KeyHash {
    size_t operator()(const FlowKey& k) const {
        uint64_t x = k.a * 0x9E3779B97F4A7C15ULL;
        x ^= (k.b + 0xBF58476D1CE4E5B9ULL) * 0x94D049BB133111EBULL;
        x ^= (k.c + 0xD6E8FEB86659FD93ULL) * 0xFF51AFD7ED558CCDULL;
        x ^= x >> 31;
        return (size_t)x;
    }
};

// TCP FSM states (mirror of the Python FlowState enum)
enum : uint8_t {
    ST_INIT = 0, ST_SYN_SENT, ST_SYN_ACK, ST_ESTABLISHED,
    ST_FIN_1, ST_CLOSED, ST_RST
};
enum : uint8_t { CT_UNKNOWN = 0, CT_FIN, CT_RST, CT_TIMEOUT, CT_FORCED };
enum : uint8_t {
    TCP_FIN = 0x01, TCP_SYN = 0x02, TCP_RST = 0x04,
    TCP_PSH = 0x08, TCP_ACK = 0x10
};

struct DirStats {
    uint64_t packets = 0, bytes = 0;
    uint32_t retrans = 0, zero_window = 0;
    uint32_t max_payload_seq = 0;
    uint8_t tcp_flags_bits = 0;
    bool has_payload_seq = false;
};

struct Flow {
    uint64_t flow_id;
    FlowKey key;  // canonical: client (initiator) side first
    uint64_t start_ns, end_ns;
    uint64_t syn_ns = 0, synack_ns = 0;
    DirStats tx, rx;
    uint32_t rtt_us = 0;
    uint16_t syn_count = 0, synack_count = 0;
    uint8_t state = ST_INIT;
    uint8_t close_type = CT_UNKNOWN;
    int32_t l7_mode = 0;  // 0 = infer (surface payloads), >0 = known proto
                          // (keep surfacing), -1 = muted (stop surfacing)
    uint32_t payload_pkts = 0;
};

}  // namespace

extern "C" {

// Must match FLOW_RECORD_DTYPE in deepflow_tpu_torch/native/__init__.py (packed, no padding).
#pragma pack(push, 1)
struct FlowRecord {
    uint64_t flow_id;
    uint32_t ip_src, ip_dst;
    uint16_t port_src, port_dst;
    uint8_t protocol;
    uint8_t state;
    uint8_t close_type;
    uint8_t closed;
    uint64_t start_ns, end_ns;
    uint64_t tx_packets, rx_packets, tx_bytes, rx_bytes;
    uint32_t tx_retrans, rx_retrans, tx_zero_window, rx_zero_window;
    uint8_t tx_flags_bits, rx_flags_bits;
    uint16_t syn_count, synack_count;
    uint32_t rtt_us;
    uint8_t tunnel_type;
    uint32_t tunnel_id;
};

// Must match SLOW_EVENT_DTYPE in native/__init__.py: a frame the v4 fast
// path can't decode (v6/vlan-exotic), copied out of the ring for the Python
// slow path.
struct SlowEvent {
    uint64_t ts_ns;
    uint32_t off;
    uint32_t len;
};

// Must match L7_EVENT_DTYPE in native/__init__.py. payload_off indexes into
// the caller-provided l7 payload buffer (bytes are COPIED there, so ring
// blocks / batch buffers can be released before Python parses).
struct L7Event {
    uint64_t flow_id;
    uint64_t ts_ns;
    uint32_t payload_off;
    uint32_t payload_len;
    uint8_t is_tx;
    uint8_t protocol;
    uint32_t ip_src, ip_dst;
    uint16_t port_src, port_dst;
    uint8_t tunnel_type;
    uint32_t tunnel_id;
};
#pragma pack(pop)

struct L7Sink {
    uint8_t* buf;
    uint32_t buf_cap, buf_used;
    L7Event* evs;
    uint32_t ev_cap, n;
    uint64_t dropped;
};

struct DfFlowMap {
    std::unordered_map<FlowKey, Flow, KeyHash> flows;
    // lazy-deletion min-heap: (end_ns, tiebreak, key)
    struct HeapEnt {
        uint64_t end_ns, seq;
        FlowKey key;
        bool operator>(const HeapEnt& o) const {
            return end_ns != o.end_ns ? end_ns > o.end_ns : seq > o.seq;
        }
    };
    std::priority_queue<HeapEnt, std::vector<HeapEnt>, std::greater<HeapEnt>>
        evict_heap;
    std::vector<FlowRecord> closed;   // drained via df_fm_poll_closed
    uint64_t next_flow_id = 1, heap_seq = 0;
    uint32_t max_flows;
    // stats
    uint64_t n_packets = 0, n_created = 0, n_closed = 0, n_evicted = 0,
             n_l7_events = 0, n_l7_dropped = 0, n_slow = 0, n_excluded = 0;
    bool server_port[65536] = {};
    bool exclude_port[65536] = {};  // agent's own telemetry ports
};

static const uint16_t kKnownPorts[] = {
    22, 25, 53, 80, 88, 110, 143, 389, 443, 465, 587, 993, 995, 1433, 1521,
    2379, 3000, 3306, 4222, 5000, 5432, 5672, 6379, 8000, 8080, 8443, 8888,
    9000, 9090, 9092, 9200, 11211, 27017, 50051};

DfFlowMap* df_fm_new(uint32_t max_flows) {
    auto* fm = new DfFlowMap();
    fm->max_flows = max_flows ? max_flows : (1u << 16);
    fm->flows.reserve(fm->max_flows * 2);
    for (int i = 0; i < 1024; i++) fm->server_port[i] = true;
    for (uint16_t p : kKnownPorts) fm->server_port[p] = true;
    return fm;
}

void df_fm_free(DfFlowMap* fm) { delete fm; }

static void fill_record(const Flow& f, uint8_t closed_flag, FlowRecord* r) {
    r->flow_id = f.flow_id;
    r->ip_src = (uint32_t)(f.key.a >> 32);
    r->ip_dst = (uint32_t)f.key.a;
    r->port_src = (uint16_t)(f.key.b >> 32);
    r->port_dst = (uint16_t)(f.key.b >> 16);
    r->protocol = (uint8_t)f.key.b;
    r->state = f.state;
    r->close_type = f.close_type;
    r->closed = closed_flag;
    r->start_ns = f.start_ns;
    r->end_ns = f.end_ns;
    r->tx_packets = f.tx.packets;
    r->rx_packets = f.rx.packets;
    r->tx_bytes = f.tx.bytes;
    r->rx_bytes = f.rx.bytes;
    r->tx_retrans = f.tx.retrans;
    r->rx_retrans = f.rx.retrans;
    r->tx_zero_window = f.tx.zero_window;
    r->rx_zero_window = f.rx.zero_window;
    r->tx_flags_bits = f.tx.tcp_flags_bits;
    r->rx_flags_bits = f.rx.tcp_flags_bits;
    r->syn_count = f.syn_count;
    r->synack_count = f.synack_count;
    r->rtt_us = f.rtt_us;
    r->tunnel_type = (uint8_t)(f.key.c >> 32);
    r->tunnel_id = (uint32_t)f.key.c;
}

static void close_flow(DfFlowMap* fm, Flow& f) {
    fm->n_closed++;
    FlowRecord r;
    fill_record(f, 1, &r);
    fm->closed.push_back(r);
}

static void evict_oldest(DfFlowMap* fm) {
    while (!fm->evict_heap.empty()) {
        auto ent = fm->evict_heap.top();
        fm->evict_heap.pop();
        auto it = fm->flows.find(ent.key);
        if (it == fm->flows.end()) continue;  // stale
        if (it->second.end_ns > ent.end_ns) {  // refreshed: re-file
            fm->evict_heap.push({it->second.end_ns, ++fm->heap_seq, ent.key});
            continue;
        }
        it->second.close_type = CT_FORCED;
        close_flow(fm, it->second);
        fm->flows.erase(it);
        fm->n_evicted++;
        return;
    }
}

static void tcp_update(Flow& f, const DfPacketOut& p, DirStats& d,
                       uint64_t ts_ns) {
    uint8_t flags = p.tcp_flags;
    d.tcp_flags_bits |= flags;
    if (p.window == 0 && !(flags & TCP_RST)) d.zero_window++;
    if (p.payload_len) {
        uint32_t end_seq = p.seq + p.payload_len;  // u32 wraps naturally
        if (d.has_payload_seq) {
            uint32_t behind = d.max_payload_seq - p.seq;
            if (behind > 0 && behind < 0x80000000u) {
                d.retrans++;
            } else {
                d.max_payload_seq = end_seq;
            }
        } else {
            d.max_payload_seq = end_seq;
            d.has_payload_seq = true;
        }
    }
    if (flags & TCP_RST) {
        f.state = ST_RST;
        f.close_type = CT_RST;
        return;
    }
    bool syn = flags & TCP_SYN, ack = flags & TCP_ACK, fin = flags & TCP_FIN;
    if (syn && !ack) {
        f.syn_count++;
        if (f.state == ST_INIT) {
            f.state = ST_SYN_SENT;
            f.syn_ns = ts_ns;
        }
    } else if (syn && ack) {
        f.synack_count++;
        if (f.state == ST_SYN_SENT) {
            f.state = ST_SYN_ACK;
            f.synack_ns = ts_ns;
        }
    } else if (fin) {
        if (f.state == ST_ESTABLISHED || f.state == ST_SYN_ACK ||
            f.state == ST_INIT) {
            f.state = ST_FIN_1;
        } else if (f.state == ST_FIN_1) {
            f.state = ST_CLOSED;
            f.close_type = CT_FIN;
        }
    } else if (ack) {
        if (f.state == ST_SYN_ACK) {
            f.state = ST_ESTABLISHED;
            if (f.syn_ns && f.synack_ns && ts_ns > f.syn_ns)
                f.rtt_us = (uint32_t)((ts_ns - f.syn_ns) / 1000);
        } else if (f.state == ST_INIT) {
            f.state = ST_ESTABLISHED;  // mid-stream pickup
        }
    }
}

// Inject one decoded packet. Returns the flow (creating it if needed).
static void inject_decoded(DfFlowMap* fm, const DfPacketOut& p,
                           const uint8_t* frame, uint64_t ts_ns,
                           L7Sink* sink) {
    if (fm->exclude_port[p.port_src] || fm->exclude_port[p.port_dst]) {
        fm->n_excluded++;  // agent's own telemetry: feedback-loop guard
        return;
    }
    fm->n_packets++;
    FlowKey k = make_key(p);
    bool is_tx = true;
    auto it = fm->flows.find(k);
    if (it == fm->flows.end()) {
        FlowKey rk = reverse_key(k);
        it = fm->flows.find(rk);
        if (it != fm->flows.end()) {
            is_tx = false;
        } else {
            if (fm->flows.size() >= fm->max_flows) evict_oldest(fm);
            // direction heuristic on mid-stream pickup: a well-known source
            // port marks the SERVER side
            FlowKey canon = k;
            if (p.protocol == 1 && !(p.tcp_flags & TCP_SYN)) {
                bool src_srv = fm->server_port[p.port_src] &&
                               !fm->server_port[p.port_dst];
                if (src_srv) {
                    canon = rk;
                    is_tx = false;
                }
            }
            Flow f;
            f.flow_id = fm->next_flow_id++;
            f.key = canon;
            f.start_ns = ts_ns;
            f.end_ns = ts_ns;
            fm->n_created++;
            it = fm->flows.emplace(canon, f).first;
            fm->evict_heap.push({ts_ns, ++fm->heap_seq, canon});
        }
    }
    Flow& f = it->second;
    f.end_ns = ts_ns;
    DirStats& d = is_tx ? f.tx : f.rx;
    d.packets++;
    // bytes = wire length approximation: ip total via payload_off+len covers
    // the decoded portion; use the frame view (payload_off+payload_len)
    d.bytes += p.payload_off + p.payload_len;
    if (p.protocol == 1) tcp_update(f, p, d, ts_ns);
    if (p.payload_len && f.l7_mode >= 0 && sink != nullptr) {
        f.payload_pkts++;
        if (sink->n < sink->ev_cap &&
            sink->buf_used + p.payload_len <= sink->buf_cap) {
            memcpy(sink->buf + sink->buf_used, frame + p.payload_off,
                   p.payload_len);
            L7Event& e = sink->evs[sink->n++];
            e.flow_id = f.flow_id;
            e.ts_ns = ts_ns;
            e.payload_off = sink->buf_used;
            e.payload_len = p.payload_len;
            e.is_tx = is_tx ? 1 : 0;
            e.protocol = p.protocol;
            e.ip_src = (uint32_t)(f.key.a >> 32);
            e.ip_dst = (uint32_t)f.key.a;
            e.port_src = (uint16_t)(f.key.b >> 32);
            e.port_dst = (uint16_t)(f.key.b >> 16);
            e.tunnel_type = (uint8_t)(f.key.c >> 32);
            e.tunnel_id = (uint32_t)f.key.c;
            sink->buf_used += p.payload_len;
            fm->n_l7_events++;
        } else {
            sink->dropped++;
            fm->n_l7_dropped++;
        }
    }
    // CLOSED/RST flows are reaped at the next tick (not immediately), so
    // trailing ACKs land on the existing flow instead of spawning a stray
    // one-packet flow (mirrors the Python FlowMap)
}

// Batch inject from packed frames. slow_idx receives indices of frames the
// v4 fast path can't decode (v6/short) for the Python slow path.
// Returns number of packets handled natively.
uint64_t df_fm_inject_batch(DfFlowMap* fm, const uint8_t* data,
                            const uint32_t* offsets, const uint64_t* ts_ns,
                            uint32_t n, uint8_t* l7_buf, uint32_t l7_buf_cap,
                            L7Event* l7_out, uint32_t l7_cap,
                            uint32_t* n_l7, uint32_t* slow_idx,
                            uint32_t slow_cap, uint32_t* n_slow) {
    L7Sink sink{l7_buf, l7_buf_cap, 0, l7_out, l7_cap, 0, 0};
    uint32_t slow = 0;
    uint64_t handled = 0;
    DfPacketOut p;
    for (uint32_t i = 0; i < n; i++) {
        const uint8_t* frame = data + offsets[i];
        uint32_t len = offsets[i + 1] - offsets[i];
        if (df_decode_eth(frame, len, &p)) {
            inject_decoded(fm, p, frame, ts_ns[i], &sink);
            handled++;
        } else {
            fm->n_slow++;
            if (slow < slow_cap) slow_idx[slow++] = i;
        }
    }
    *n_l7 = sink.n;
    *n_slow = slow;
    return handled;
}

void df_fm_set_l7(DfFlowMap* fm, uint32_t ip_src, uint32_t ip_dst,
                  uint16_t port_src, uint16_t port_dst, uint8_t proto,
                  uint8_t tunnel_type, uint32_t tunnel_id, int32_t mode) {
    FlowKey k{(uint64_t)ip_src << 32 | ip_dst,
              (uint64_t)port_src << 32 | (uint64_t)port_dst << 16 | proto,
              (uint64_t)tunnel_type << 32 | tunnel_id};
    auto it = fm->flows.find(k);
    if (it == fm->flows.end()) {
        it = fm->flows.find(reverse_key(k));
        if (it == fm->flows.end()) return;
    }
    it->second.l7_mode = mode;
}

// Expire idle/closed flows. Timeouts mirror FlowMap.FLOW_TIMEOUT_NS.
void df_fm_tick(DfFlowMap* fm, uint64_t now_ns) {
    static const uint64_t kTimeout[7] = {
        5'000'000'000ULL,    // INIT
        5'000'000'000ULL,    // SYN_SENT
        5'000'000'000ULL,    // SYN_ACK
        300'000'000'000ULL,  // ESTABLISHED
        30'000'000'000ULL,   // FIN_1
        0, 0};               // CLOSED/RST close immediately on packet
    for (auto it = fm->flows.begin(); it != fm->flows.end();) {
        Flow& f = it->second;
        uint64_t timeout =
            f.state < 5 ? kTimeout[f.state] : 60'000'000'000ULL;
        if (f.state == ST_CLOSED || f.state == ST_RST ||
            (now_ns > f.end_ns && now_ns - f.end_ns > timeout)) {
            if (f.close_type == CT_UNKNOWN) f.close_type = CT_TIMEOUT;
            close_flow(fm, f);
            it = fm->flows.erase(it);
        } else {
            ++it;
        }
    }
}

// Drain closed-flow records. Returns number written.
uint32_t df_fm_poll_closed(DfFlowMap* fm, FlowRecord* out, uint32_t cap) {
    uint32_t n = (uint32_t)fm->closed.size();
    if (n > cap) n = cap;
    memcpy(out, fm->closed.data(), (size_t)n * sizeof(FlowRecord));
    fm->closed.erase(fm->closed.begin(), fm->closed.begin() + n);
    return n;
}

// Snapshot all active flows (metering). Returns number written.
uint32_t df_fm_export_active(DfFlowMap* fm, FlowRecord* out, uint32_t cap) {
    uint32_t n = 0;
    for (auto& kv : fm->flows) {
        if (n >= cap) break;
        fill_record(kv.second, 0, &out[n++]);
    }
    return n;
}

// Force-close everything (shutdown).
void df_fm_flush_all(DfFlowMap* fm) {
    for (auto& kv : fm->flows) {
        if (kv.second.close_type == CT_UNKNOWN)
            kv.second.close_type = CT_FORCED;
        close_flow(fm, kv.second);
    }
    fm->flows.clear();
}

uint32_t df_fm_active_count(DfFlowMap* fm) {
    return (uint32_t)fm->flows.size();
}

uint32_t df_fm_closed_count(DfFlowMap* fm) {
    return (uint32_t)fm->closed.size();
}

// stats: [packets, created, closed, evicted, l7_events, l7_dropped, slow,
//         excluded]
void df_fm_stats(DfFlowMap* fm, uint64_t* out8) {
    out8[0] = fm->n_packets;
    out8[1] = fm->n_created;
    out8[2] = fm->n_closed;
    out8[3] = fm->n_evicted;
    out8[4] = fm->n_l7_events;
    out8[5] = fm->n_l7_dropped;
    out8[6] = fm->n_slow;
    out8[7] = fm->n_excluded;
}

void df_fm_exclude_port(DfFlowMap* fm, uint16_t port, int32_t on) {
    fm->exclude_port[port] = on != 0;
}

// ---------------------------------------------------------------------------
// TPACKET_V3 mmap RX ring (reference: dispatcher/recv_engine af_packet)
// ---------------------------------------------------------------------------

struct DfRing {
    int fd = -1;
    uint8_t* map = nullptr;
    size_t map_len = 0;
    uint32_t block_size = 0, block_nr = 0;
    uint32_t cur_block = 0;
};

// Returns nullptr on failure with errno-style code in *err.
DfRing* df_ring_open(const char* ifname, uint32_t block_size,
                     uint32_t block_nr, int32_t* err) {
    *err = 0;
    int fd = socket(AF_PACKET, SOCK_RAW, htons(ETH_P_ALL));
    if (fd < 0) {
        *err = errno;
        return nullptr;
    }
    int ver = TPACKET_V3;
    if (setsockopt(fd, SOL_PACKET, PACKET_VERSION, &ver, sizeof(ver)) < 0) {
        *err = errno;
        close(fd);
        return nullptr;
    }
    tpacket_req3 req{};
    req.tp_block_size = block_size;
    req.tp_block_nr = block_nr;
    req.tp_frame_size = 2048;
    req.tp_frame_nr = (block_size / 2048) * block_nr;
    req.tp_retire_blk_tov = 60;  // ms: deliver partial blocks promptly
    req.tp_feature_req_word = 0;
    if (setsockopt(fd, SOL_PACKET, PACKET_RX_RING, &req, sizeof(req)) < 0) {
        *err = errno;
        close(fd);
        return nullptr;
    }
    size_t map_len = (size_t)block_size * block_nr;
    void* map = mmap(nullptr, map_len, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_LOCKED, fd, 0);
    if (map == MAP_FAILED) {
        map = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);  // retry without MAP_LOCKED (ulimit)
        if (map == MAP_FAILED) {
            *err = errno;
            close(fd);
            return nullptr;
        }
    }
    sockaddr_ll sll{};
    sll.sll_family = AF_PACKET;
    sll.sll_protocol = htons(ETH_P_ALL);
    sll.sll_ifindex = ifname && ifname[0] ? (int)if_nametoindex(ifname) : 0;
    if (ifname && ifname[0] && sll.sll_ifindex == 0) {
        *err = ENODEV;
        munmap(map, map_len);
        close(fd);
        return nullptr;
    }
    if (bind(fd, (sockaddr*)&sll, sizeof(sll)) < 0) {
        *err = errno;
        munmap(map, map_len);
        close(fd);
        return nullptr;
    }
    auto* r = new DfRing();
    r->fd = fd;
    r->map = (uint8_t*)map;
    r->map_len = map_len;
    r->block_size = block_size;
    r->block_nr = block_nr;
    return r;
}

void df_ring_close(DfRing* r) {
    if (!r) return;
    if (r->map) munmap(r->map, r->map_len);
    if (r->fd >= 0) close(r->fd);
    delete r;
}

// Promiscuous mode for mirror/SPAN capture: the NIC must accept frames
// addressed to the mirrored hosts, not just to us. Returns 0 on success.
int32_t df_ring_promisc(DfRing* r, const char* ifname, int32_t on) {
    if (!r || !ifname || !ifname[0]) return -1;
    unsigned idx = if_nametoindex(ifname);
    if (!idx) return -1;
    packet_mreq mr{};
    mr.mr_ifindex = (int)idx;
    mr.mr_type = PACKET_MR_PROMISC;
    int opt = on ? PACKET_ADD_MEMBERSHIP : PACKET_DROP_MEMBERSHIP;
    return setsockopt(r->fd, SOL_PACKET, opt, &mr, sizeof(mr)) < 0
        ? -1 : 0;
}

// Poll for ready blocks and inject frames straight into the flow map.
// Payload segments needing L7 parsing are COPIED into l7_buf (events in
// l7_out) so blocks can be released before Python sees them. Returns the
// number of packets consumed this call; 0 on timeout; -1 on error.
int64_t df_ring_rx_batch(DfRing* r, DfFlowMap* fm, int32_t timeout_ms,
                         uint8_t* l7_buf, uint32_t l7_buf_cap,
                         L7Event* l7_out, uint32_t l7_cap, uint32_t* n_l7,
                         uint32_t max_blocks, int32_t skip_outgoing,
                         uint8_t* slow_buf, uint32_t slow_buf_cap,
                         SlowEvent* slow_out, uint32_t slow_cap,
                         uint32_t* n_slow) {
    L7Sink sink{l7_buf, l7_buf_cap, 0, l7_out, l7_cap, 0, 0};
    *n_l7 = 0;
    *n_slow = 0;
    uint32_t slow_used = 0, slow_n = 0;
    int64_t consumed = 0;
    uint32_t blocks_done = 0;
    if (max_blocks == 0) max_blocks = r->block_nr;
    while (blocks_done < max_blocks) {
        auto* desc = (tpacket_block_desc*)(r->map +
                                           (size_t)r->cur_block *
                                               r->block_size);
        auto& h1 = desc->hdr.bh1;
        if (!(h1.block_status & TP_STATUS_USER)) {
            if (consumed > 0 || timeout_ms == 0) break;
            pollfd pfd{r->fd, POLLIN | POLLERR, 0};
            int pr = poll(&pfd, 1, timeout_ms);
            if (pr < 0) return errno == EINTR ? consumed : -1;
            if (pr == 0) break;  // timeout
            continue;
        }
        uint32_t num = h1.num_pkts;
        auto* ppd = (tpacket3_hdr*)((uint8_t*)desc + h1.offset_to_first_pkt);
        DfPacketOut p;
        for (uint32_t i = 0; i < num; i++) {
            const uint8_t* frame = (uint8_t*)ppd + ppd->tp_mac;
            uint32_t len = ppd->tp_snaplen;
            uint64_t ts = (uint64_t)ppd->tp_sec * 1'000'000'000ULL +
                          ppd->tp_nsec;
            // loopback duplicates every frame as in+out: drop one copy
            auto* sll = (sockaddr_ll*)((uint8_t*)ppd +
                                       TPACKET_ALIGN(sizeof(tpacket3_hdr)));
            if (skip_outgoing && sll->sll_pkttype == PACKET_OUTGOING) {
                consumed++;
                ppd = (tpacket3_hdr*)((uint8_t*)ppd + ppd->tp_next_offset);
                continue;
            }
            if (df_decode_eth(frame, len, &p)) {
                inject_decoded(fm, p, frame, ts, &sink);
            } else {
                // v6/vlan-exotic: copy out for the Python slow path (the
                // block is released before Python runs)
                fm->n_slow++;
                if (slow_out != nullptr && slow_n < slow_cap &&
                    slow_used + len <= slow_buf_cap) {
                    memcpy(slow_buf + slow_used, frame, len);
                    slow_out[slow_n].ts_ns = ts;
                    slow_out[slow_n].off = slow_used;
                    slow_out[slow_n].len = len;
                    slow_used += len;
                    slow_n++;
                }
            }
            consumed++;
            ppd = (tpacket3_hdr*)((uint8_t*)ppd + ppd->tp_next_offset);
        }
        h1.block_status = TP_STATUS_KERNEL;  // release to kernel
        __sync_synchronize();
        r->cur_block = (r->cur_block + 1) % r->block_nr;
        blocks_done++;
    }
    *n_l7 = sink.n;
    *n_slow = slow_n;
    return consumed;
}

// Kernel drop counter (tpacket_stats_v3); returns drops since last call.
uint64_t df_ring_drops(DfRing* r) {
    tpacket_stats_v3 st{};
    socklen_t len = sizeof(st);
    if (getsockopt(r->fd, SOL_PACKET, PACKET_STATISTICS, &st, &len) < 0)
        return 0;
    return st.tp_drops;
}

}  // extern "C"
