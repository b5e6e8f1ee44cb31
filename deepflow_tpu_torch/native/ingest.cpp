// Native columnar decode of TpuSpanBatch (TPU_SPAN frames) and
// DocumentBatch (METRICS frames): protobuf wire -> struct-of-arrays for
// spans and memory samples, and for metric documents, no Python objects
// until the store append.
//
// Own copy of deepflow_tpu/native/ingest.cpp (DfSpanCols, parse_span,
// parse_mem_sample, df_decode_span_cols; DfDocCols, parse_doc and its
// meters, df_decode_doc_cols), with four changes:
//   - capacity overflow (-2) is told apart from malformed input (-1), and
//     df_span_batch_counts gives the row counts a batch needs, so the
//     caller grows its buffers and retries: a well-formed batch never
//     leaves this path;
//   - a string cell that is not valid UTF-8, or a tag past 32 bits (it
//     would alias a field number), is malformed (-1): the port's pure
//     decoder (proto/wire.py) then raises on the first and skips the
//     field of the second, so both paths write the same rows or none;
//   - string cells are copied into the caller's arena, which the caller
//     sizes to the payload (every cell is a substring of it).
// As in protobuf, a known field of the wrong wire type is skipped and a
// 32-bit field keeps the low 32 bits of its varint.
// Layouts must match the ctypes bindings in native/__init__.py; bump
// df_abi_version() in dfnative.cpp on ANY change here.
//
// Wire schema (deepflow_tpu/proto/messages.proto):
//   TpuSpanBatch{ repeated TpuSpan spans = 1;
//                 repeated TpuMemorySample memory = 2; }
//   DocumentBatch{ repeated Document docs = 1; }
//   Document{ timestamp_s=1, MetricTag tag=2, FlowMeter flow_meter=3,
//             AppMeter app_meter=4, interval_s=5 }
// Unknown fields are skipped by wire type.

#include <cstdint>
#include <cstring>

#include "dfwire.h"

using dfwire::Reader;

extern "C" {

// Span string slots (order matches SPAN_STRS in native/__init__.py):
// 0 hlo_module(7) 1 hlo_op(8) 2 hlo_category(9) 3 collective(15)
// 4 process_name(20)
#define DF_SPAN_NSTR 5

#pragma pack(push, 1)
struct DfSpanCols {
    // spans
    uint64_t* start_ns;
    uint64_t* duration_ns;
    uint64_t* flops;
    uint64_t* bytes_accessed;
    uint64_t* bytes_transferred;
    uint64_t* step;
    uint32_t* device_id;
    uint32_t* chip_id;
    uint32_t* core_id;
    uint32_t* slice_id;
    uint32_t* kind;
    uint32_t* program_id;
    uint32_t* run_id;
    uint32_t* replica_group_size;
    uint32_t* pid;
    uint32_t* str_off[DF_SPAN_NSTR];
    uint32_t* str_len[DF_SPAN_NSTR];
    // memory samples
    uint64_t* m_timestamp_ns;
    uint64_t* m_bytes_in_use;
    uint64_t* m_peak_bytes_in_use;
    uint64_t* m_bytes_limit;
    uint64_t* m_largest_free_block;
    uint32_t* m_device_id;
    uint32_t* m_num_allocs;
    uint32_t* m_pid;
    uint32_t* m_pname_off;
    uint32_t* m_pname_len;
    // shared string arena
    uint8_t*  arena;
    uint32_t  arena_cap;
    uint32_t  arena_used;
    uint32_t  cap;       // span rows
    uint32_t  mem_cap;   // memory rows
    uint32_t  n_mem;     // OUT: memory rows decoded
};
#pragma pack(pop)

enum { DF_MALFORMED = dfwire::MALFORMED, DF_OVERFLOW = dfwire::OVERFLOW };

static int span_str_slot(uint32_t field) {
    switch (field) {
        case 7: return 0; case 8: return 1; case 9: return 2;
        case 15: return 3; case 20: return 4;
        default: return -1;
    }
}

// A string cell into the arena: DF_MALFORMED for invalid UTF-8,
// DF_OVERFLOW for a full arena, 0 when stored.
static int arena_put(DfSpanCols* c, const uint8_t* s, uint64_t n,
                     uint32_t* off_out, uint32_t* len_out) {
    return dfwire::arena_put(c->arena, c->arena_cap, &c->arena_used, s, n,
                             off_out, len_out);
}

static int parse_span(const uint8_t* sub, uint64_t n, DfSpanCols* c,
                      uint32_t r) {
    c->start_ns[r] = c->duration_ns[r] = c->flops[r] = 0;
    c->bytes_accessed[r] = c->bytes_transferred[r] = c->step[r] = 0;
    c->device_id[r] = c->chip_id[r] = c->core_id[r] = 0;
    c->slice_id[r] = c->kind[r] = c->program_id[r] = 0;
    c->run_id[r] = c->replica_group_size[r] = c->pid[r] = 0;
    for (int i = 0; i < DF_SPAN_NSTR; i++)
        c->str_off[i][r] = c->str_len[i][r] = 0;

    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (wire == 0) {
            uint64_t v = rd.varint();
            if (!rd.ok) return DF_MALFORMED;
            switch (field) {
                case 1: c->start_ns[r] = v; break;
                case 2: c->duration_ns[r] = v; break;
                case 3: c->device_id[r] = (uint32_t)v; break;
                case 4: c->chip_id[r] = (uint32_t)v; break;
                case 5: c->core_id[r] = (uint32_t)v; break;
                case 6: c->slice_id[r] = (uint32_t)v; break;
                case 10: c->kind[r] = (uint32_t)v; break;
                case 11: c->flops[r] = v; break;
                case 12: c->bytes_accessed[r] = v; break;
                case 13: c->program_id[r] = (uint32_t)v; break;
                case 14: c->run_id[r] = (uint32_t)v; break;
                case 16: c->bytes_transferred[r] = v; break;
                case 17: c->replica_group_size[r] = (uint32_t)v; break;
                case 18: c->step[r] = v; break;
                case 19: c->pid[r] = (uint32_t)v; break;
                default: break;
            }
            continue;
        }
        if (wire == 2) {
            uint64_t kn = rd.varint();
            if (!rd.ok || (uint64_t)(rd.end - rd.p) < kn) return DF_MALFORMED;
            const uint8_t* ks = rd.p;
            rd.p += kn;
            int slot = span_str_slot(field);
            if (slot >= 0 && kn) {
                int rc = arena_put(c, ks, kn, &c->str_off[slot][r],
                                   &c->str_len[slot][r]);
                if (rc) return rc;
            }
            continue;
        }
        if (!rd.skip(wire)) return DF_MALFORMED;
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

static int parse_mem_sample(const uint8_t* sub, uint64_t n, DfSpanCols* c,
                            uint32_t r) {
    c->m_timestamp_ns[r] = c->m_bytes_in_use[r] = 0;
    c->m_peak_bytes_in_use[r] = c->m_bytes_limit[r] = 0;
    c->m_largest_free_block[r] = 0;
    c->m_device_id[r] = c->m_num_allocs[r] = c->m_pid[r] = 0;
    c->m_pname_off[r] = c->m_pname_len[r] = 0;

    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (wire == 0) {
            uint64_t v = rd.varint();
            if (!rd.ok) return DF_MALFORMED;
            switch (field) {
                case 1: c->m_timestamp_ns[r] = v; break;
                case 2: c->m_device_id[r] = (uint32_t)v; break;
                case 3: c->m_bytes_in_use[r] = v; break;
                case 4: c->m_peak_bytes_in_use[r] = v; break;
                case 5: c->m_bytes_limit[r] = v; break;
                case 6: c->m_largest_free_block[r] = v; break;
                case 7: c->m_num_allocs[r] = (uint32_t)v; break;
                case 8: c->m_pid[r] = (uint32_t)v; break;
                default: break;
            }
            continue;
        }
        if (wire == 2) {
            uint64_t kn = rd.varint();
            if (!rd.ok || (uint64_t)(rd.end - rd.p) < kn) return DF_MALFORMED;
            const uint8_t* ks = rd.p;
            rd.p += kn;
            if (field == 9 && kn) {
                int rc = arena_put(c, ks, kn, &c->m_pname_off[r],
                                   &c->m_pname_len[r]);
                if (rc) return rc;
            }
            continue;
        }
        if (!rd.skip(wire)) return DF_MALFORMED;
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

// Decode a TpuSpanBatch columnar. Returns the number of SPAN rows (memory
// rows are counted in cols->n_mem), DF_MALFORMED (-1) for malformed
// input, or DF_OVERFLOW (-2) when a row buffer or the
// arena is too small (df_span_batch_counts gives the rows needed).
int64_t df_decode_span_cols(const uint8_t* data, uint64_t len,
                            DfSpanCols* cols) {
    Reader rd{data, data + len};
    uint32_t n = 0, nm = 0;
    cols->arena_used = 0;
    cols->n_mem = 0;
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if ((field == 1 || field == 2) && wire == 2) {
            uint64_t sublen = rd.varint();
            if (!rd.ok || (uint64_t)(rd.end - rd.p) < sublen)
                return DF_MALFORMED;
            const uint8_t* sub = rd.p;
            rd.p += sublen;
            int rc;
            if (field == 1) {
                if (n >= cols->cap) return DF_OVERFLOW;
                rc = parse_span(sub, sublen, cols, n++);
            } else {
                if (nm >= cols->mem_cap) return DF_OVERFLOW;
                rc = parse_mem_sample(sub, sublen, cols, nm++);
            }
            if (rc) return rc;
        } else if (!rd.skip(wire)) {
            return DF_MALFORMED;
        }
    }
    if (!rd.ok) return DF_MALFORMED;
    cols->n_mem = nm;
    return n;
}

// The span and memory-sample entries of a TpuSpanBatch, counted by one
// pass over its top-level fields. Returns 0, or DF_MALFORMED.
int32_t df_span_batch_counts(const uint8_t* data, uint64_t len,
                             uint64_t* n_spans, uint64_t* n_mem) {
    uint64_t counts[2];
    int32_t rc = dfwire::count_fields(data, len, counts, 2);
    *n_spans = counts[0];
    *n_mem = counts[1];
    return rc;
}

// ---------------------------------------------------------------------------
// DocumentBatch (METRICS frames) -> DfDocCols
// ---------------------------------------------------------------------------

// ip_flags bits: the pure decoder maps empty address bytes to "" (not
// "0.0.0.0") and formats other lengths as v6; the flags let Python write
// "" and send a batch with any other length down the pure path.
enum {
    DF_IP_SRC_EMPTY = 1,  // tag.ip_src absent or empty -> ""
    DF_IP_DST_EMPTY = 2,  // tag.ip_dst absent or empty -> ""
    DF_IP_FALLBACK = 4,   // a length other than 0 or 4: the pure path
};

#pragma pack(push, 1)
struct DfDocCols {
    uint64_t* timestamp_s;
    // FlowMeter (column names of flow_metrics.network.1s)
    uint64_t* packet_tx;
    uint64_t* packet_rx;
    uint64_t* byte_tx;
    uint64_t* byte_rx;
    uint64_t* flow_count;
    uint64_t* new_flow;
    uint64_t* closed_flow;
    uint64_t* rtt_sum;
    uint64_t* rtt_count;
    uint64_t* retrans;
    uint64_t* syn_count;
    uint64_t* synack_count;
    // AppMeter (column names of flow_metrics.application.1s)
    uint64_t* request;
    uint64_t* response;
    uint64_t* rrt_sum;
    uint64_t* rrt_count;
    uint64_t* rrt_max;
    uint64_t* error_client;
    uint64_t* error_server;
    uint64_t* timeout;
    // MetricTag
    uint32_t* ip4_src;         // host byte order; see ip_flags
    uint32_t* ip4_dst;
    uint32_t* proto;           // enums and uint32s: their low 32 bits
    uint32_t* l7_protocol;
    uint32_t* app_service_off; // tag.app_service in the arena
    uint32_t* app_service_len;
    uint32_t* port;
    uint32_t* direction;
    uint8_t*  has_flow;        // wire presence == HasField
    uint8_t*  has_app;
    uint8_t*  ip_flags;        // DF_IP_* bits
    // shared string arena
    uint8_t*  arena;
    uint32_t  arena_cap;
    uint32_t  arena_used;
    uint32_t  cap;
};
#pragma pack(pop)

// FlowMeter: every field a varint; 8-12 are uint32 on the wire.
static int parse_flow_meter(const uint8_t* sub, uint64_t n, DfDocCols* c,
                            uint32_t r) {
    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (wire != 0) {
            if (!rd.skip(wire)) return DF_MALFORMED;
            continue;
        }
        uint64_t v = rd.varint();
        if (!rd.ok) return DF_MALFORMED;
        switch (field) {
            case 1: c->packet_tx[r] = v; break;
            case 2: c->packet_rx[r] = v; break;
            case 3: c->byte_tx[r] = v; break;
            case 4: c->byte_rx[r] = v; break;
            case 5: c->flow_count[r] = v; break;
            case 6: c->new_flow[r] = v; break;
            case 7: c->closed_flow[r] = v; break;
            case 8: c->rtt_sum[r] = (uint32_t)v; break;
            case 9: c->rtt_count[r] = (uint32_t)v; break;
            case 10: c->retrans[r] = (uint32_t)v; break;
            case 11: c->syn_count[r] = (uint32_t)v; break;
            case 12: c->synack_count[r] = (uint32_t)v; break;
            default: break;
        }
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

// AppMeter: every field a uint64 varint.
static int parse_app_meter(const uint8_t* sub, uint64_t n, DfDocCols* c,
                           uint32_t r) {
    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (wire != 0) {
            if (!rd.skip(wire)) return DF_MALFORMED;
            continue;
        }
        uint64_t v = rd.varint();
        if (!rd.ok) return DF_MALFORMED;
        switch (field) {
            case 1: c->request[r] = v; break;
            case 2: c->response[r] = v; break;
            case 3: c->rrt_sum[r] = v; break;
            case 4: c->rrt_count[r] = v; break;
            case 5: c->rrt_max[r] = v; break;
            case 6: c->error_client[r] = v; break;
            case 7: c->error_server[r] = v; break;
            case 8: c->timeout[r] = v; break;
            default: break;
        }
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

static int parse_metric_tag(const uint8_t* sub, uint64_t n, DfDocCols* c,
                            uint32_t r) {
    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (wire == 0) {
            uint64_t v = rd.varint();
            if (!rd.ok) return DF_MALFORMED;
            switch (field) {
                case 3: c->port[r] = (uint32_t)v; break;
                case 4: c->proto[r] = (uint32_t)v; break;
                case 5: c->l7_protocol[r] = (uint32_t)v; break;
                case 10: c->direction[r] = (uint32_t)v; break;
                default: break;  // 6 agent_id, 8/9 gpids: not in the rows
            }
            continue;
        }
        if (wire == 2) {
            const uint8_t* ks;
            uint64_t kn;
            if (!rd.bytes(&ks, &kn)) return DF_MALFORMED;
            if (field == 1 || field == 2) {
                uint8_t empty = field == 1 ? DF_IP_SRC_EMPTY
                                           : DF_IP_DST_EMPTY;
                uint32_t* ip = field == 1 ? c->ip4_src : c->ip4_dst;
                // the last value on the wire wins, as in protobuf
                c->ip_flags[r] &= (uint8_t)~empty;
                if (kn == 4) {
                    ip[r] = (uint32_t)ks[0] << 24 | (uint32_t)ks[1] << 16 |
                            (uint32_t)ks[2] << 8 | ks[3];
                } else if (kn == 0) {
                    ip[r] = 0;
                    c->ip_flags[r] |= empty;
                } else {
                    c->ip_flags[r] |= DF_IP_FALLBACK;
                }
            } else if (field == 7) {  // app_service
                c->app_service_off[r] = c->app_service_len[r] = 0;
                if (kn) {
                    int rc = dfwire::arena_put(
                        c->arena, c->arena_cap, &c->arena_used, ks, kn,
                        &c->app_service_off[r], &c->app_service_len[r]);
                    if (rc) return rc;
                }
            }
            continue;
        }
        if (!rd.skip(wire)) return DF_MALFORMED;
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

static int parse_doc(const uint8_t* sub, uint64_t n, DfDocCols* c,
                     uint32_t r) {
    // zero the row (batches reuse the arrays)
    c->timestamp_s[r] = 0;
    c->packet_tx[r] = c->packet_rx[r] = c->byte_tx[r] = c->byte_rx[r] = 0;
    c->flow_count[r] = c->new_flow[r] = c->closed_flow[r] = 0;
    c->rtt_sum[r] = c->rtt_count[r] = c->retrans[r] = 0;
    c->syn_count[r] = c->synack_count[r] = 0;
    c->request[r] = c->response[r] = 0;
    c->rrt_sum[r] = c->rrt_count[r] = c->rrt_max[r] = 0;
    c->error_client[r] = c->error_server[r] = c->timeout[r] = 0;
    c->ip4_src[r] = c->ip4_dst[r] = 0;
    c->proto[r] = c->l7_protocol[r] = 0;
    c->app_service_off[r] = c->app_service_len[r] = 0;
    c->port[r] = c->direction[r] = 0;
    c->has_flow[r] = c->has_app[r] = 0;
    // absent bytes fields decode as empty, so start from "empty"
    c->ip_flags[r] = DF_IP_SRC_EMPTY | DF_IP_DST_EMPTY;

    Reader rd{sub, sub + n};
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (wire == 0) {
            uint64_t v = rd.varint();
            if (!rd.ok) return DF_MALFORMED;
            if (field == 1) c->timestamp_s[r] = v;
            continue;  // 5 interval_s: not in the rows
        }
        if (wire == 2) {
            const uint8_t* sp;
            uint64_t sn;
            if (!rd.bytes(&sp, &sn)) return DF_MALFORMED;
            int rc = 0;
            switch (field) {
                case 2: rc = parse_metric_tag(sp, sn, c, r); break;
                case 3:  // wire presence is HasField, even of an empty one
                    c->has_flow[r] = 1;
                    rc = parse_flow_meter(sp, sn, c, r);
                    break;
                case 4:
                    c->has_app[r] = 1;
                    rc = parse_app_meter(sp, sn, c, r);
                    break;
                default: break;
            }
            if (rc) return rc;
            continue;
        }
        if (!rd.skip(wire)) return DF_MALFORMED;
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

// Decode a DocumentBatch columnar. Returns the number of documents,
// DF_MALFORMED (-1), or DF_OVERFLOW (-2) when the rows or the arena are
// too small (df_doc_batch_count gives the rows needed).
int64_t df_decode_doc_cols(const uint8_t* data, uint64_t len,
                           DfDocCols* cols) {
    Reader rd{data, data + len};
    uint32_t n = 0;
    cols->arena_used = 0;
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (field == 1 && wire == 2) {
            const uint8_t* sub;
            uint64_t sublen;
            if (!rd.bytes(&sub, &sublen)) return DF_MALFORMED;
            if (n >= cols->cap) return DF_OVERFLOW;
            int rc = parse_doc(sub, sublen, cols, n++);
            if (rc) return rc;
        } else if (!rd.skip(wire)) {
            return DF_MALFORMED;
        }
    }
    return rd.ok ? (int64_t)n : (int64_t)DF_MALFORMED;
}

// The documents of a DocumentBatch. Returns 0, or DF_MALFORMED.
int32_t df_doc_batch_count(const uint8_t* data, uint64_t len,
                           uint64_t* n_docs) {
    return dfwire::count_fields(data, len, n_docs, 1);
}

}  // extern "C"
