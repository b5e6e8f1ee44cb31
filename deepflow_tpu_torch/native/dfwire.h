// Protobuf wire reading shared by the port's columnar decoders
// (ingest.cpp: TpuSpanBatch and DocumentBatch; pbcols.cpp: FlowLogBatch).
//
// The reader of deepflow_tpu/native/ingest.cpp and pbcols.cpp, with the
// port's two refusals: a tag past 32 bits (it would alias a field
// number) and a string cell that is not valid UTF-8 are malformed, as
// the pure decoder (proto/wire.py) skips the first and raises on the
// second, so both paths write the same rows or none.
#pragma once

#include <cstdint>
#include <cstring>

namespace dfwire {

enum { MALFORMED = -1, OVERFLOW = -2 };

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

    // A field's number and wire type; a tag past 32 bits is refused.
    bool next_tag(uint32_t* field, uint32_t* wire) {
        uint64_t tag = varint();
        if (!ok || tag > UINT32_MAX) return ok = false;
        *field = (uint32_t)(tag >> 3);
        *wire = (uint32_t)(tag & 7);
        return true;
    }

    // A length-delimited field's bytes.
    bool bytes(const uint8_t** s, uint64_t* n) {
        *n = varint();
        if (!ok || (uint64_t)(end - p) < *n) return ok = false;
        *s = p;
        p += *n;
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
static inline bool valid_utf8(const uint8_t* s, uint64_t n) {
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

// A string cell copied into a caller's arena: MALFORMED for invalid
// UTF-8, OVERFLOW for a full arena, 0 when stored.
static inline int arena_put(uint8_t* arena, uint32_t cap, uint32_t* used,
                            const uint8_t* s, uint64_t n, uint32_t* off_out,
                            uint32_t* len_out) {
    if (!valid_utf8(s, n)) return MALFORMED;
    if (*used + n > cap) return OVERFLOW;
    memcpy(arena + *used, s, n);
    *off_out = *used;
    *len_out = (uint32_t)n;
    *used += (uint32_t)n;
    return 0;
}

// The length-delimited top-level fields numbered 1..nfields of a
// message, counted into counts[number - 1]. Returns 0, or MALFORMED.
static inline int32_t count_fields(const uint8_t* data, uint64_t len,
                                   uint64_t* counts, uint32_t nfields) {
    Reader rd{data, data + len};
    for (uint32_t i = 0; i < nfields; i++) counts[i] = 0;
    while (rd.ok && rd.p < rd.end) {
        uint32_t field, wire;
        if (!rd.next_tag(&field, &wire)) return MALFORMED;
        if (!rd.skip(wire)) return MALFORMED;
        if (wire == 2 && field >= 1 && field <= nfields) counts[field - 1]++;
    }
    return rd.ok ? 0 : MALFORMED;
}

}  // namespace dfwire
