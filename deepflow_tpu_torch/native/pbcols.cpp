// Native columnar decode of FlowLogBatch (L4_LOG and L7_LOG frames):
// protobuf wire -> struct-of-arrays of L4 and L7 rows, no Python objects
// until the store append. The parse runs with the interpreter lock
// released (ctypes), so several decode workers use several cores.
//
// Own copy of deepflow_tpu/native/pbcols.cpp (DfL4Cols, parse_l4,
// df_decode_l4_cols; DfL7Cols, parse_l7, df_decode_l7_cols), with the
// port's care (dfwire.h):
//   - capacity overflow (-2) is told apart from malformed input (-1);
//     df_flow_batch_counts gives the rows a batch needs, so the caller
//     grows its buffers and retries;
//   - a string field that is not valid UTF-8 (close_type, the pods, the
//     sixteen L7 strings), or a tag past 32 bits, is malformed: the pure
//     decoder (proto/wire.py) raises on the first and skips the second;
//   - string cells go into the caller's arena, sized to the payload;
//   - an address of a length other than 0, 4 or 16 bytes sets
//     DF_IP_FALLBACK and an empty one DF_IP_*_EMPTY (the pure decoder
//     writes "" for it, the reference's native one "0.0.0.0");
//   - uint32 and enum fields keep the low 32 bits of their varint and
//     tunnel_type is clamped to 4 before it is narrowed, as the pure
//     path stores them (the reference narrows to the column first).
// As in protobuf, unknown fields and known ones of another wire type are
// skipped, and a repeated singular field's last value wins.
// Layouts must match the ctypes bindings in native/__init__.py; bump
// df_abi_version() in dfnative.cpp on ANY change here.
//
// Wire schema (deepflow_tpu/proto/messages.proto):
//   FlowLogBatch{ repeated L4FlowLog l4 = 1; repeated L7FlowLog l7 = 2; }
//   L4FlowLog fields 1..26, L7FlowLog 1..33, FlowKey 1..8.

#include <cstdint>
#include <cstring>

#include "dfwire.h"

using dfwire::Reader;

namespace {

enum { MALFORMED = dfwire::MALFORMED };

// ip_flags bits (must match native/__init__.py)
enum {
    IP_SRC_EMPTY = 1,
    IP_DST_EMPTY = 2,
    IP_FALLBACK = 4,
};

// The FlowKey fields both row kinds keep.
struct KeyOut {
    uint32_t* ip4_src;
    uint32_t* ip4_dst;
    uint8_t* is_v6;
    uint32_t* ip6_src_off;
    uint32_t* ip6_dst_off;
    uint8_t* ip_flags;
    uint16_t* port_src;
    uint16_t* port_dst;
    uint8_t* proto;
    uint32_t* tap_port;   // null: not kept (L7)
    uint8_t* tunnel_type;
    uint32_t* tunnel_id;
    uint8_t* arena;
    uint32_t arena_cap;
    uint32_t* arena_used;
};

static uint8_t tunnel(uint64_t v) {
    uint32_t t = (uint32_t)v;
    return (uint8_t)(t > 4 ? 4 : t);
}

static int parse_key(const uint8_t* sub, uint64_t n, const KeyOut& k,
                     uint32_t r) {
    Reader kr{sub, sub + n};
    while (kr.ok && kr.p < kr.end) {
        uint32_t kf, kw;
        if (!kr.next_tag(&kf, &kw)) return MALFORMED;
        if (kw == 0) {
            uint64_t kv = kr.varint();
            if (!kr.ok) return MALFORMED;
            switch (kf) {
                case 3: k.port_src[r] = (uint16_t)kv; break;
                case 4: k.port_dst[r] = (uint16_t)kv; break;
                case 5: k.proto[r] = (uint8_t)kv; break;
                case 6: if (k.tap_port) k.tap_port[r] = (uint32_t)kv; break;
                case 7: k.tunnel_type[r] = tunnel(kv); break;
                case 8: k.tunnel_id[r] = (uint32_t)kv; break;
                default: break;
            }
        } else if (kw == 2) {
            const uint8_t* ks;
            uint64_t kn;
            if (!kr.bytes(&ks, &kn)) return MALFORMED;
            if (kf != 1 && kf != 2) continue;
            uint8_t empty = kf == 1 ? IP_SRC_EMPTY : IP_DST_EMPTY;
            uint32_t* ip = kf == 1 ? k.ip4_src : k.ip4_dst;
            k.ip_flags[r] &= (uint8_t)~empty;
            ip[r] = 0;
            if (kn == 4) {
                ip[r] = (uint32_t)ks[0] << 24 | (uint32_t)ks[1] << 16 |
                        (uint32_t)ks[2] << 8 | ks[3];
            } else if (kn == 0) {
                k.ip_flags[r] |= empty;
            } else if (kn == 16) {
                k.is_v6[r] = 1;
                uint32_t* off = kf == 1 ? k.ip6_src_off : k.ip6_dst_off;
                if (*k.arena_used + 16 > k.arena_cap) return dfwire::OVERFLOW;
                memcpy(k.arena + *k.arena_used, ks, 16);
                off[r] = *k.arena_used;
                *k.arena_used += 16;
            } else {
                k.ip_flags[r] |= IP_FALLBACK;
            }
        } else if (!kr.skip(kw)) {
            return MALFORMED;
        }
    }
    return kr.ok ? 0 : MALFORMED;
}

static void zero_key(const KeyOut& k, uint32_t r) {
    k.ip4_src[r] = k.ip4_dst[r] = 0;
    k.is_v6[r] = 0;
    k.ip6_src_off[r] = k.ip6_dst_off[r] = 0;
    k.ip_flags[r] = IP_SRC_EMPTY | IP_DST_EMPTY;  // absent bytes are empty
    k.port_src[r] = k.port_dst[r] = 0;
    k.proto[r] = 0;
    if (k.tap_port) k.tap_port[r] = 0;
    k.tunnel_type[r] = 0;
    k.tunnel_id[r] = 0;
}

// "fin", "rst", ... -> the index in store/schema.py CLOSE_TYPES; any
// other value is 0, as the pure path's _close_type_idx.
static uint8_t close_type_idx(const uint8_t* s, uint64_t n) {
    if (n == 3 && !memcmp(s, "fin", 3)) return 1;
    if (n == 3 && !memcmp(s, "rst", 3)) return 2;
    if (n == 7 && !memcmp(s, "timeout", 7)) return 3;
    if (n == 6 && !memcmp(s, "forced", 6)) return 4;
    return 0;
}

}  // namespace

extern "C" {

#pragma pack(push, 1)
struct DfL4Cols {
    uint64_t* flow_id;
    uint64_t* start_time_ns;
    uint64_t* end_time_ns;
    uint64_t* packet_tx;
    uint64_t* packet_rx;
    uint64_t* byte_tx;
    uint64_t* byte_rx;
    uint64_t* l7_request;
    uint64_t* l7_response;
    uint32_t* rtt_us;
    uint32_t* art_us;
    uint32_t* retrans_tx;
    uint32_t* retrans_rx;
    uint32_t* zero_win_tx;
    uint32_t* zero_win_rx;
    uint8_t*  close_type;      // index into CLOSE_TYPES
    uint32_t* syn_count;
    uint32_t* synack_count;
    uint32_t* gpid_0;
    uint32_t* gpid_1;
    // key
    uint32_t* ip4_src;         // host byte order; see ip_flags, is_v6
    uint32_t* ip4_dst;
    uint8_t*  is_v6;           // 1: an address is 16 bytes (the arena)
    uint32_t* ip6_src_off;
    uint32_t* ip6_dst_off;
    uint8_t*  ip_flags;        // IP_* bits
    uint16_t* port_src;
    uint16_t* port_dst;
    uint8_t*  proto;
    uint32_t* tap_port;
    uint8_t*  tunnel_type;     // clamped to 4
    uint32_t* tunnel_id;
    // pod strings: arena (off, len); len 0 = empty
    uint32_t* pod0_off;
    uint32_t* pod0_len;
    uint32_t* pod1_off;
    uint32_t* pod1_len;
    // shared string arena
    uint8_t*  arena;
    uint32_t  arena_cap;
    uint32_t  arena_used;
    uint32_t  cap;
};

// String slots of an L7 row (order matches L7_STRS in
// native/__init__.py): 0 version(4) 1 request_type(5)
// 2 request_domain(6) 3 request_resource(7) 4 endpoint(8)
// 5 response_exception(12) 6 response_result(13) 7 trace_id(16)
// 8 span_id(17) 9 parent_span_id(18) 10 x_request_id(19)
// 11 process_kname_0(29) 12 process_kname_1(30) 13 attrs_json(31)
// 14 pod_0(32) 15 pod_1(33)
#define DF_L7_NSTR 16

struct DfL7Cols {
    uint64_t* flow_id;
    uint64_t* start_time_ns;
    uint64_t* end_time_ns;
    uint64_t* syscall_trace_id_request;
    uint64_t* syscall_trace_id_response;
    uint64_t* captured_request_byte;
    uint64_t* captured_response_byte;
    uint32_t* l7_protocol;
    uint32_t* request_id;
    uint32_t* response_status;
    int32_t*  response_code;
    uint32_t* syscall_thread_0;
    uint32_t* syscall_thread_1;
    uint32_t* gpid_0;
    uint32_t* gpid_1;
    // key
    uint32_t* ip4_src;
    uint32_t* ip4_dst;
    uint8_t*  is_v6;
    uint32_t* ip6_src_off;
    uint32_t* ip6_dst_off;
    uint8_t*  ip_flags;
    uint16_t* port_src;
    uint16_t* port_dst;
    uint8_t*  proto;
    uint8_t*  tunnel_type;
    uint32_t* tunnel_id;
    uint32_t* str_off[DF_L7_NSTR];
    uint32_t* str_len[DF_L7_NSTR];
    // shared string arena
    uint8_t*  arena;
    uint32_t  arena_cap;
    uint32_t  arena_used;
    uint32_t  cap;
};
#pragma pack(pop)

static KeyOut l4_key(DfL4Cols* c) {
    return KeyOut{c->ip4_src, c->ip4_dst, c->is_v6, c->ip6_src_off,
                  c->ip6_dst_off, c->ip_flags, c->port_src, c->port_dst,
                  c->proto, c->tap_port, c->tunnel_type, c->tunnel_id,
                  c->arena, c->arena_cap, &c->arena_used};
}

static KeyOut l7_key(DfL7Cols* c) {
    return KeyOut{c->ip4_src, c->ip4_dst, c->is_v6, c->ip6_src_off,
                  c->ip6_dst_off, c->ip_flags, c->port_src, c->port_dst,
                  c->proto, nullptr, c->tunnel_type, c->tunnel_id,
                  c->arena, c->arena_cap, &c->arena_used};
}

static int parse_l4(const uint8_t* sub, uint64_t n, DfL4Cols* c,
                    uint32_t r) {
    // zero the row (batches reuse the arrays)
    c->flow_id[r] = c->start_time_ns[r] = c->end_time_ns[r] = 0;
    c->packet_tx[r] = c->packet_rx[r] = c->byte_tx[r] = c->byte_rx[r] = 0;
    c->l7_request[r] = c->l7_response[r] = 0;
    c->rtt_us[r] = c->art_us[r] = 0;
    c->retrans_tx[r] = c->retrans_rx[r] = 0;
    c->zero_win_tx[r] = c->zero_win_rx[r] = 0;
    c->close_type[r] = 0;
    c->syn_count[r] = c->synack_count[r] = 0;
    c->gpid_0[r] = c->gpid_1[r] = 0;
    c->pod0_off[r] = c->pod0_len[r] = c->pod1_off[r] = c->pod1_len[r] = 0;
    KeyOut key = l4_key(c);
    zero_key(key, r);

    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return MALFORMED;
        if (wire == 0) {
            uint64_t v = rd.varint();
            if (!rd.ok) return MALFORMED;
            switch (field) {
                case 1: c->flow_id[r] = v; break;
                case 3: c->start_time_ns[r] = v; break;
                case 4: c->end_time_ns[r] = v; break;
                case 5: c->packet_tx[r] = v; break;
                case 6: c->packet_rx[r] = v; break;
                case 7: c->byte_tx[r] = v; break;
                case 8: c->byte_rx[r] = v; break;
                case 9: c->l7_request[r] = v; break;
                case 10: c->l7_response[r] = v; break;
                case 11: c->rtt_us[r] = (uint32_t)v; break;
                case 12: c->art_us[r] = (uint32_t)v; break;
                case 13: c->retrans_tx[r] = (uint32_t)v; break;
                case 14: c->retrans_rx[r] = (uint32_t)v; break;
                case 15: c->zero_win_tx[r] = (uint32_t)v; break;
                case 16: c->zero_win_rx[r] = (uint32_t)v; break;
                case 20: c->syn_count[r] = (uint32_t)v; break;
                case 21: c->synack_count[r] = (uint32_t)v; break;
                case 23: c->gpid_0[r] = (uint32_t)v; break;
                case 24: c->gpid_1[r] = (uint32_t)v; break;
                default: break;  // 18, 19, 22: not in the rows
            }
            continue;
        }
        if (wire == 2) {
            const uint8_t* s;
            uint64_t sn;
            if (!rd.bytes(&s, &sn)) return MALFORMED;
            int rc = 0;
            switch (field) {
                case 2: rc = parse_key(s, sn, key, r); break;
                case 17:
                    if (!dfwire::valid_utf8(s, sn)) return MALFORMED;
                    c->close_type[r] = close_type_idx(s, sn);
                    break;
                case 25:
                case 26: {
                    uint32_t* off = field == 25 ? c->pod0_off : c->pod1_off;
                    uint32_t* len = field == 25 ? c->pod0_len : c->pod1_len;
                    off[r] = len[r] = 0;
                    if (sn)  // arena_put refuses invalid UTF-8
                        rc = dfwire::arena_put(c->arena, c->arena_cap,
                                               &c->arena_used, s, sn,
                                               &off[r], &len[r]);
                    break;
                }
                default: break;
            }
            if (rc) return rc;
            continue;
        }
        if (!rd.skip(wire)) return MALFORMED;
    }
    return rd.ok ? 0 : MALFORMED;
}

static int l7_str_slot(uint32_t field) {
    switch (field) {
        case 4: return 0; case 5: return 1; case 6: return 2;
        case 7: return 3; case 8: return 4; case 12: return 5;
        case 13: return 6; case 16: return 7; case 17: return 8;
        case 18: return 9; case 19: return 10; case 29: return 11;
        case 30: return 12; case 31: return 13; case 32: return 14;
        case 33: return 15;
        default: return -1;
    }
}

static int parse_l7(const uint8_t* sub, uint64_t n, DfL7Cols* c,
                    uint32_t r) {
    c->flow_id[r] = c->start_time_ns[r] = c->end_time_ns[r] = 0;
    c->syscall_trace_id_request[r] = c->syscall_trace_id_response[r] = 0;
    c->captured_request_byte[r] = c->captured_response_byte[r] = 0;
    c->l7_protocol[r] = c->request_id[r] = c->response_status[r] = 0;
    c->response_code[r] = 0;
    c->syscall_thread_0[r] = c->syscall_thread_1[r] = 0;
    c->gpid_0[r] = c->gpid_1[r] = 0;
    for (int i = 0; i < DF_L7_NSTR; i++)
        c->str_off[i][r] = c->str_len[i][r] = 0;
    KeyOut key = l7_key(c);
    zero_key(key, r);

    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return MALFORMED;
        if (wire == 0) {
            uint64_t v = rd.varint();
            if (!rd.ok) return MALFORMED;
            switch (field) {
                case 1: c->flow_id[r] = v; break;
                case 3: c->l7_protocol[r] = (uint32_t)v; break;
                case 9: c->request_id[r] = (uint32_t)v; break;
                case 10: c->response_status[r] = (uint32_t)v; break;
                case 11: c->response_code[r] = (int32_t)(uint32_t)v; break;
                case 14: c->start_time_ns[r] = v; break;
                case 15: c->end_time_ns[r] = v; break;
                case 20: c->syscall_trace_id_request[r] = v; break;
                case 21: c->syscall_trace_id_response[r] = v; break;
                case 22: c->syscall_thread_0[r] = (uint32_t)v; break;
                case 23: c->syscall_thread_1[r] = (uint32_t)v; break;
                case 24: c->captured_request_byte[r] = v; break;
                case 25: c->captured_response_byte[r] = v; break;
                case 27: c->gpid_0[r] = (uint32_t)v; break;
                case 28: c->gpid_1[r] = (uint32_t)v; break;
                default: break;  // 26 agent_id: not in the rows
            }
            continue;
        }
        if (wire == 2) {
            const uint8_t* s;
            uint64_t sn;
            if (!rd.bytes(&s, &sn)) return MALFORMED;
            int rc = 0;
            if (field == 2) {
                rc = parse_key(s, sn, key, r);
            } else {
                int slot = l7_str_slot(field);
                if (slot >= 0) {
                    c->str_off[slot][r] = c->str_len[slot][r] = 0;
                    if (sn)  // arena_put refuses invalid UTF-8
                        rc = dfwire::arena_put(
                            c->arena, c->arena_cap, &c->arena_used, s, sn,
                            &c->str_off[slot][r], &c->str_len[slot][r]);
                }
            }
            if (rc) return rc;
            continue;
        }
        if (!rd.skip(wire)) return MALFORMED;
    }
    return rd.ok ? 0 : MALFORMED;
}

// Decode the L4 rows of a FlowLogBatch columnar. The L7 entries are not
// parsed: their (offset, length) in `data` go to l7_off / l7_len
// (capacity l7_cap), counted in *n_l7. Returns the number of L4 rows,
// -1 for malformed input, or -2 when a buffer is too small
// (df_flow_batch_counts gives the rows needed).
int64_t df_decode_l4_cols(const uint8_t* data, uint64_t len,
                          DfL4Cols* cols, uint32_t* l7_off,
                          uint32_t* l7_len, uint32_t l7_cap,
                          uint32_t* n_l7) {
    Reader rd{data, data + len};
    uint32_t n = 0, l7n = 0;
    cols->arena_used = 0;
    *n_l7 = 0;
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return MALFORMED;
        if ((field == 1 || field == 2) && wire == 2) {
            const uint8_t* sub;
            uint64_t sublen;
            if (!rd.bytes(&sub, &sublen)) return MALFORMED;
            if (field == 2) {
                if (l7n >= l7_cap) return dfwire::OVERFLOW;
                l7_off[l7n] = (uint32_t)(sub - data);
                l7_len[l7n] = (uint32_t)sublen;
                l7n++;
                continue;
            }
            if (n >= cols->cap) return dfwire::OVERFLOW;
            int rc = parse_l4(sub, sublen, cols, n++);
            if (rc) return rc;
        } else if (!rd.skip(wire)) {
            return MALFORMED;
        }
    }
    if (!rd.ok) return MALFORMED;
    *n_l7 = l7n;
    return n;
}

// Decode the L7 rows of a FlowLogBatch columnar (top-level field 2; the
// L4 entries are skipped). Returns the number of L7 rows, -1 for
// malformed input, or -2 when a buffer is too small.
int64_t df_decode_l7_cols(const uint8_t* data, uint64_t len,
                          DfL7Cols* cols) {
    Reader rd{data, data + len};
    uint32_t n = 0;
    cols->arena_used = 0;
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return MALFORMED;
        if (field == 2 && wire == 2) {
            const uint8_t* sub;
            uint64_t sublen;
            if (!rd.bytes(&sub, &sublen)) return MALFORMED;
            if (n >= cols->cap) return dfwire::OVERFLOW;
            int rc = parse_l7(sub, sublen, cols, n++);
            if (rc) return rc;
        } else if (!rd.skip(wire)) {
            return MALFORMED;
        }
    }
    return rd.ok ? (int64_t)n : (int64_t)MALFORMED;
}

// The L4 and L7 entries of a FlowLogBatch. Returns 0, or -1.
int32_t df_flow_batch_counts(const uint8_t* data, uint64_t len,
                             uint64_t* n_l4, uint64_t* n_l7) {
    uint64_t counts[2];
    int32_t rc = dfwire::count_fields(data, len, counts, 2);
    *n_l4 = counts[0];
    *n_l7 = counts[1];
    return rc;
}

}  // extern "C"
