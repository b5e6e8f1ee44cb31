// Native columnar decode of TpuSpanBatch (TPU_SPAN frames): protobuf wire
// -> struct-of-arrays for spans and memory samples, no Python objects
// until the store append.
//
// Own copy of the TpuSpanBatch part of deepflow_tpu/native/ingest.cpp
// (DfSpanCols, parse_span, parse_mem_sample, df_decode_span_cols), with
// three changes:
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
// Unknown fields are skipped by wire type.

#include <cstdint>
#include <cstring>

namespace {

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint64_t varint() {
        uint64_t v = 0;
        int shift = 0;
        while (p < end && shift < 64) {
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
        }
        ok = false;
        return 0;
    }

    // A field's number and wire type; a tag past 32 bits would alias a
    // field number, so it is refused.
    bool next_tag(uint32_t* field, uint32_t* wire) {
        uint64_t tag = varint();
        if (!ok || tag > UINT32_MAX) return ok = false;
        *field = (uint32_t)(tag >> 3);
        *wire = (uint32_t)(tag & 7);
        return true;
    }

    bool skip(uint32_t wire) {
        switch (wire) {
            case 0: varint(); return ok;
            case 1: if (end - p < 8) return ok = false; p += 8; return true;
            case 2: {
                uint64_t n = varint();
                if (!ok || (uint64_t)(end - p) < n) return ok = false;
                p += n;
                return true;
            }
            case 5: if (end - p < 4) return ok = false; p += 4; return true;
            default: return ok = false;
        }
    }
};

// Python's strict UTF-8: no overlong forms, no surrogates, nothing past
// U+10FFFF.
bool valid_utf8(const uint8_t* s, uint64_t n) {
    const uint8_t* end = s + n;
    while (s < end) {
        uint8_t c = *s;
        if (c < 0x80) { s++; continue; }
        int more;
        uint8_t lo = 0x80, hi = 0xBF;
        if (c >= 0xC2 && c <= 0xDF) more = 1;
        else if (c >= 0xE0 && c <= 0xEF) {
            more = 2;
            if (c == 0xE0) lo = 0xA0;
            if (c == 0xED) hi = 0x9F;
        } else if (c >= 0xF0 && c <= 0xF4) {
            more = 3;
            if (c == 0xF0) lo = 0x90;
            if (c == 0xF4) hi = 0x8F;
        } else {
            return false;
        }
        if (end - s <= more) return false;
        if (s[1] < lo || s[1] > hi) return false;
        for (int i = 2; i <= more; i++)
            if ((s[i] & 0xC0) != 0x80) return false;
        s += more + 1;
    }
    return true;
}

}  // namespace

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

enum { DF_MALFORMED = -1, DF_OVERFLOW = -2 };

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
    if (!valid_utf8(s, n)) return DF_MALFORMED;
    if (c->arena_used + n > c->arena_cap) return DF_OVERFLOW;
    memcpy(c->arena + c->arena_used, s, n);
    *off_out = c->arena_used;
    *len_out = (uint32_t)n;
    c->arena_used += (uint32_t)n;
    return 0;
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
    Reader rd{data, data + len};
    *n_spans = *n_mem = 0;
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return DF_MALFORMED;
        if (!rd.skip(wire)) return DF_MALFORMED;
        if (wire == 2 && field == 1) (*n_spans)++;
        if (wire == 2 && field == 2) (*n_mem)++;
    }
    return rd.ok ? 0 : DF_MALFORMED;
}

}  // extern "C"
