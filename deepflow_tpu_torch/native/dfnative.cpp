// dfnative (port): the string dictionary behind the store's native interning.
//
// Own copy of the dictionary part of deepflow_tpu/native/dfnative.cpp
// (df_abi_version and df_dict_*), built by deepflow_tpu_torch/native/
// __init__.py into a library of the port's own, with the port's own ABI
// version. Exposed as a C ABI consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ABI contract between this library and the ctypes bindings in
// native/__init__.py. Bump on ANY change to an exported signature (the
// qexec.cpp kernels' included) or to the DfSpanCols layout in ingest.cpp;
// load() refuses a library whose version differs.
int32_t df_abi_version() { return 2; }

// ---------------------------------------------------------------------------
// Dictionary: string <-> uint32 id, id 0 reserved for ""
// ---------------------------------------------------------------------------

struct DfDict {
    std::unordered_map<std::string, uint32_t> map;
    std::vector<std::string> strings;
    DfDict() {
        strings.emplace_back("");
        map.emplace("", 0);
    }
};

static uint32_t dict_intern(DfDict* d, std::string&& s) {
    auto it = d->map.find(s);
    if (it != d->map.end()) return it->second;
    uint32_t id = (uint32_t)d->strings.size();
    d->strings.push_back(s);
    d->map.emplace(std::move(s), id);
    return id;
}

DfDict* df_dict_new() { return new DfDict(); }

void df_dict_free(DfDict* d) { delete d; }

uint64_t df_dict_len(DfDict* d) { return d->strings.size(); }

// Encode n strings packed into `data` with `offsets` (n+1 entries,
// offsets[i]..offsets[i+1] is string i). Writes ids into out (n entries).
void df_dict_encode_batch(DfDict* d, const char* data,
                          const uint32_t* offsets, uint32_t n,
                          uint32_t* out) {
    for (uint32_t i = 0; i < n; i++)
        out[i] = dict_intern(
            d, std::string(data + offsets[i], offsets[i + 1] - offsets[i]));
}

// Batch-encode n string cells given as (off,len) pairs into a shared
// arena, the shape the columnar span decoder (ingest.cpp) produces, so
// interning never materializes Python strings. Writes ids into out (n
// entries) and returns the dictionary length AFTER the batch; the caller
// diffs against the length BEFORE to learn which ids are new and fetches
// them back via df_dict_get. NOT thread-safe: the caller
// (store/dictionary.py) holds the Python-side dictionary lock across the
// call.
uint64_t df_dict_encode_arena(DfDict* d, const uint8_t* arena,
                              const uint32_t* offs, const uint32_t* lens,
                              uint32_t n, uint32_t* out) {
    for (uint32_t i = 0; i < n; i++)
        out[i] = lens[i] == 0 ? 0  // id 0 is always ""
                 : dict_intern(d, std::string((const char*)arena + offs[i],
                                              lens[i]));
    return d->strings.size();
}

// Lookup without insert; returns UINT32_MAX when absent.
uint32_t df_dict_lookup(DfDict* d, const char* s, uint32_t len) {
    auto it = d->map.find(std::string(s, len));
    return it == d->map.end() ? UINT32_MAX : it->second;
}

// Copy string `id` into buf (cap bytes); returns its length, or -1.
int32_t df_dict_get(DfDict* d, uint32_t id, char* buf, uint32_t cap) {
    if (id >= d->strings.size()) return -1;
    const std::string& s = d->strings[id];
    uint32_t n = (uint32_t)s.size() < cap ? (uint32_t)s.size() : cap;
    memcpy(buf, s.data(), n);
    return (int32_t)s.size();
}

// Bulk-load entries (the Python side's inserts). Ids assigned in order.
void df_dict_load(DfDict* d, const char* data, const uint32_t* offsets,
                  uint32_t n) {
    for (uint32_t i = 0; i < n; i++)
        dict_intern(
            d, std::string(data + offsets[i], offsets[i + 1] - offsets[i]));
}

}  // extern "C"
