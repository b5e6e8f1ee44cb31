// qexec (port): native kernels for dictionary-encoded DF-SQL execution.
//
// Own copy of deepflow_tpu/native/qexec.cpp, built into the port's
// library by deepflow_tpu_torch/native/__init__.py. GROUP BY over
// dictionary-encoded columns runs through a hash table keyed on the small
// ints, never the strings: one O(n) open-addressing pass over all key
// columns at once, where numpy's lexsort is O(n log n). The filters
// return ascending index lists, so later conjuncts and gathers touch only
// survivors.
//
// All entry points take pre-cast int64 key columns (dictionary ids,
// enum ids and integer timestamps all fit; the ctypes wrapper casts).
// ctypes releases the interpreter lock around every call, so the query
// engine's morsel pool runs these concurrently. The numpy paths they
// replace stay in query/engine.py; its cost models choose per call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
    // splitmix64 finalizer — good avalanche for sequential dict ids
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

inline uint64_t next_pow2(uint64_t v) {
    uint64_t p = 16;
    while (p < v) p <<= 1;
    return p;
}

}  // namespace

extern "C" {

// Hash-group n_rows over n_keys int64 key columns.
//   order_out:  n_rows indices, grouped (all rows of group 0, then 1, ...)
//               in FIRST-OCCURRENCE group order
//   bounds_out: n_groups+1 offsets into order_out (caller sizes n_rows+1)
// Returns n_groups (>= 0), or -1 on bad args. Row order within a group is
// the original row order (counting sort is stable), which the engine's
// reduceat/LAST semantics rely on.
int64_t df_qx_group(const int64_t* const* keys, uint32_t n_keys,
                    uint64_t n_rows, uint64_t* order_out,
                    uint64_t* bounds_out) {
    if (n_keys == 0 || keys == nullptr) return -1;
    if (n_rows == 0) {
        bounds_out[0] = 0;
        return 0;
    }
    const uint64_t cap = next_pow2(n_rows * 2);
    const uint64_t mask = cap - 1;
    // open-addressing table: slot -> representative row (+1; 0 == empty)
    std::vector<uint64_t> slot_row(cap, 0);
    std::vector<uint32_t> slot_gid(cap, 0);
    std::vector<uint32_t> gids(n_rows);
    std::vector<uint64_t> counts;
    counts.reserve(1024);
    uint32_t n_groups = 0;
    for (uint64_t i = 0; i < n_rows; i++) {
        uint64_t h = 0x243f6a8885a308d3ULL;
        for (uint32_t k = 0; k < n_keys; k++)
            h = mix64(h ^ (uint64_t)keys[k][i]);
        uint64_t s = h & mask;
        for (;;) {
            const uint64_t rep = slot_row[s];
            if (rep == 0) {  // new group
                slot_row[s] = i + 1;
                slot_gid[s] = n_groups;
                gids[i] = n_groups;
                counts.push_back(1);
                n_groups++;
                break;
            }
            const uint64_t r = rep - 1;
            bool eq = true;
            for (uint32_t k = 0; k < n_keys; k++) {
                if (keys[k][r] != keys[k][i]) { eq = false; break; }
            }
            if (eq) {
                const uint32_t g = slot_gid[s];
                gids[i] = g;
                counts[g]++;
                break;
            }
            s = (s + 1) & mask;
        }
    }
    // counting sort rows into group-contiguous order
    bounds_out[0] = 0;
    for (uint32_t g = 0; g < n_groups; g++)
        bounds_out[g + 1] = bounds_out[g] + counts[g];
    std::vector<uint64_t> cursor(bounds_out, bounds_out + n_groups);
    for (uint64_t i = 0; i < n_rows; i++)
        order_out[cursor[gids[i]]++] = i;
    return (int64_t)n_groups;
}

// Fused gather + segmented reduce: out[g] = op over vals[order[i]] for
// i in [bounds[g], bounds[g+1]). op: 0=sum, 1=min, 2=max. Replaces the
// engine's gather-copy + ufunc.reduceat; accumulation is sequential in
// group order, so results are bit-identical to the numpy path (sum is
// left-to-right, min/max propagate NaN exactly like np.minimum/maximum).
// Called through ctypes, which releases the interpreter lock: the morsel
// pool's scan workers run this concurrently.
void df_qx_agg_f64(const double* vals, const uint64_t* order,
                   const uint64_t* bounds, uint64_t n_groups,
                   int32_t op, double* out) {
    for (uint64_t g = 0; g < n_groups; g++) {
        const uint64_t s = bounds[g], e = bounds[g + 1];
        if (s >= e) { out[g] = 0.0; continue; }
        double acc = vals[order[s]];
        if (op == 0) {
            for (uint64_t i = s + 1; i < e; i++) acc += vals[order[i]];
        } else if (op == 1) {
            for (uint64_t i = s + 1; i < e; i++) {
                const double v = vals[order[i]];
                // mirror np.minimum: NaN in either operand propagates
                if (v < acc || v != v) acc = v;
            }
        } else {
            for (uint64_t i = s + 1; i < e; i++) {
                const double v = vals[order[i]];
                if (v > acc || v != v) acc = v;
            }
        }
        out[g] = acc;
    }
}

// mask[i] = 1 iff col[i] is in `set` (hash set, O(n + n_set)) — the
// dictionary-id IN / LIKE-pushdown filter. np.isin is sort-based
// O(n log n_set); this is the encoded-predicate fast path.
void df_qx_isin_u32(const uint32_t* col, uint64_t n, const uint32_t* set,
                    uint64_t n_set, uint8_t* mask_out) {
    if (n_set == 0) {
        std::memset(mask_out, 0, n);
        return;
    }
    const uint64_t cap = next_pow2(n_set * 2);
    const uint64_t hmask = cap - 1;
    // slot -> value+1 (0 == empty)
    std::vector<uint64_t> tbl(cap, 0);
    for (uint64_t j = 0; j < n_set; j++) {
        uint64_t s = mix64(set[j]) & hmask;
        while (tbl[s] != 0 && tbl[s] != (uint64_t)set[j] + 1)
            s = (s + 1) & hmask;
        tbl[s] = (uint64_t)set[j] + 1;
    }
    for (uint64_t i = 0; i < n; i++) {
        const uint64_t v = (uint64_t)col[i] + 1;
        uint64_t s = mix64(col[i]) & hmask;
        uint8_t hit = 0;
        for (;;) {
            const uint64_t t = tbl[s];
            if (t == 0) break;
            if (t == v) { hit = 1; break; }
            s = (s + 1) & hmask;
        }
        mask_out[i] = hit;
    }
}

// -- selective filter + gather ------------------------------------------------
//
// Selective predicates over encoded columns produce INDEX LISTS instead of
// full boolean masks: out_idx holds the ascending row positions that pass,
// so downstream gathers touch only survivors. ctypes releases the
// interpreter lock around each; the morsel pool runs them concurrently.

// out_idx[j] = ascending positions i where lo <= col[i] <= hi (inclusive
// both ends; caller encodes one-sided ranges with dtype min/max). Bounds
// arrive as raw 64-bit patterns (lo_bits/hi_bits) reinterpreted per
// esize/is_signed — the ctypes wrapper packs them from the column dtype.
// Returns the match count, or -1 on unsupported esize.
int64_t df_qx_sel_cmp(const void* vals, uint32_t esize, uint32_t is_signed,
                      uint64_t n, uint64_t lo_bits, uint64_t hi_bits,
                      uint64_t* out_idx) {
    uint64_t m = 0;
    switch ((esize << 1) | (is_signed & 1)) {
#define DF_SEL_CASE(sz, sgn, T)                                         \
    case ((sz << 1) | sgn): {                                           \
        const T* v = (const T*)vals;                                    \
        const T lo = (T)lo_bits, hi = (T)hi_bits;                       \
        for (uint64_t i = 0; i < n; i++)                                \
            if (v[i] >= lo && v[i] <= hi) out_idx[m++] = i;             \
        break;                                                          \
    }
        DF_SEL_CASE(1, 0, uint8_t)
        DF_SEL_CASE(1, 1, int8_t)
        DF_SEL_CASE(2, 0, uint16_t)
        DF_SEL_CASE(2, 1, int16_t)
        DF_SEL_CASE(4, 0, uint32_t)
        DF_SEL_CASE(4, 1, int32_t)
        DF_SEL_CASE(8, 0, uint64_t)
        DF_SEL_CASE(8, 1, int64_t)
#undef DF_SEL_CASE
        default:
            return -1;
    }
    return (int64_t)m;
}

// Index-list sibling of df_qx_isin_u32: out_idx[j] = ascending positions
// where col[i] is in `set` (hash set, O(n + n_set)). Returns match count.
int64_t df_qx_sel_isin_u32(const uint32_t* col, uint64_t n,
                           const uint32_t* set, uint64_t n_set,
                           uint64_t* out_idx) {
    if (n_set == 0) return 0;
    const uint64_t cap = next_pow2(n_set * 2);
    const uint64_t hmask = cap - 1;
    std::vector<uint64_t> tbl(cap, 0);  // slot -> value+1 (0 == empty)
    for (uint64_t j = 0; j < n_set; j++) {
        uint64_t s = mix64(set[j]) & hmask;
        while (tbl[s] != 0 && tbl[s] != (uint64_t)set[j] + 1)
            s = (s + 1) & hmask;
        tbl[s] = (uint64_t)set[j] + 1;
    }
    uint64_t m = 0;
    for (uint64_t i = 0; i < n; i++) {
        const uint64_t v = (uint64_t)col[i] + 1;
        uint64_t s = mix64(col[i]) & hmask;
        for (;;) {
            const uint64_t t = tbl[s];
            if (t == 0) break;
            if (t == v) { out_idx[m++] = i; break; }
            s = (s + 1) & hmask;
        }
    }
    return (int64_t)m;
}

// out[j] = src[idx[j]] for any element size — the survivor gather that
// replaces numpy fancy indexing (which allocates an intermediate bool
// mask first on the python path). Returns 0, or -1 on unsupported esize.
int32_t df_qx_gather(const void* src, uint32_t esize, const uint64_t* idx,
                     uint64_t n_idx, void* out) {
    switch (esize) {
#define DF_GATHER_CASE(sz, T)                                           \
    case sz: {                                                          \
        const T* s = (const T*)src;                                     \
        T* o = (T*)out;                                                 \
        for (uint64_t j = 0; j < n_idx; j++) o[j] = s[idx[j]];          \
        break;                                                          \
    }
        DF_GATHER_CASE(1, uint8_t)
        DF_GATHER_CASE(2, uint16_t)
        DF_GATHER_CASE(4, uint32_t)
        DF_GATHER_CASE(8, uint64_t)
#undef DF_GATHER_CASE
        default:
            return -1;
    }
    return 0;
}

}  // extern "C"
