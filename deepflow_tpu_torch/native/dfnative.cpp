// dfnative (port): the string dictionary behind the store's native interning,
// and the batch packet header decode of the flow path.
//
// Own copy of the dictionary and packet decode parts of
// deepflow_tpu/native/dfnative.cpp (df_abi_version, df_dict_*,
// df_decode_eth and df_decode_eth_batch), built by deepflow_tpu_torch/
// native/__init__.py into a library of the port's own, with the port's own
// ABI version. Exposed as a C ABI consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ABI contract between this library and the ctypes bindings in
// native/__init__.py. Bump on ANY change to an exported signature (the
// qexec.cpp kernels' and flowmap.cpp's included) or to a packed layout
// (DfSpanCols and DfDocCols in ingest.cpp, DfL4Cols and DfL7Cols in
// pbcols.cpp, DfPacketOut, FlowRecord, L7Event, SlowEvent);
// load() refuses a library whose version differs.
int32_t df_abi_version() { return 4; }

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

// ---------------------------------------------------------------------------
// Batch ethernet/IPv4/TCP/UDP header decode (pcap replay fast path).
// Output: fixed-width record per packet into parallel arrays.
// ---------------------------------------------------------------------------

#include "dfpacket.h"

static inline uint16_t rd16(const uint8_t* p) {
    return (uint16_t)((p[0] << 8) | p[1]);
}
static inline uint32_t rd32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}

// Tunnel decapsulation (reference: agent/src/common/decapsulate.rs).
// Attempt to strip one VXLAN/GENEVE/GRE/ERSPAN layer starting at the
// inner ethernet frame; on success the inner packet is decoded into `out`
// (offsets stay relative to the ORIGINAL buffer) and tunnel_type/id are
// stamped. Depth-capped by the caller.
static int32_t decode_frame(const uint8_t* data, uint32_t len,
                            uint32_t base, DfPacketOut* out, int depth);

static int32_t try_decap_eth(const uint8_t* data, uint32_t len,
                             uint32_t inner_off, uint8_t ttype,
                             uint32_t tid, DfPacketOut* out, int depth) {
    if (depth >= 2 || inner_off + 34 > len) return 0;
    DfPacketOut inner;
    if (!decode_frame(data, len, inner_off, &inner, depth + 1)) return 0;
    *out = inner;
    if (out->tunnel_type == 0) {  // innermost tunnel wins the stamp
        out->tunnel_type = ttype;
        out->tunnel_id = tid;
    }
    return 1;
}

static int32_t decode_frame(const uint8_t* data, uint32_t len,
                            uint32_t base, DfPacketOut* out, int depth) {
    memset(out, 0, sizeof(*out));
    if (len < base + 34) return 0;
    uint16_t eth_type = rd16(data + base + 12);
    uint32_t off = base + 14;
    if (eth_type == 0x8100) {
        if (len < base + 38) return 0;
        eth_type = rd16(data + base + 16);
        off = base + 18;
    }
    if (eth_type != 0x0800) return 0;  // v4 fast path only
    uint8_t ihl = (data[off] & 0x0F) * 4;
    if (len < off + ihl) return 0;
    uint16_t total = rd16(data + off + 2);
    uint8_t proto = data[off + 9];
    out->ip_src = rd32(data + off + 12);
    out->ip_dst = rd32(data + off + 16);
    uint32_t l4 = off + ihl;
    uint32_t end = off + total;
    if (end > len) end = len;
    if (proto == 6) {
        if (end < l4 + 20) return 0;
        out->protocol = 1;
        out->port_src = rd16(data + l4);
        out->port_dst = rd16(data + l4 + 2);
        out->seq = rd32(data + l4 + 4);
        out->ack = rd32(data + l4 + 8);
        uint8_t doff = (data[l4 + 12] >> 4) * 4;
        out->tcp_flags = data[l4 + 13];
        out->window = rd16(data + l4 + 14);
        out->payload_off = l4 + doff;
        out->payload_len = end > l4 + doff ? end - (l4 + doff) : 0;
        return 1;
    }
    if (proto == 17) {
        if (end < l4 + 8) return 0;
        uint16_t dport = rd16(data + l4 + 2);
        uint32_t pay = l4 + 8;
        // VXLAN (RFC 7348): 8-byte header, I-flag bit validates the VNI.
        // A recognized tunnel whose inner frame the fast path can't decode
        // (v6 inner, nested vlan) must go to the Python slow path — NOT be
        // reported as the outer VTEP UDP flow, which would merge every
        // tenant into one flow
        if (dport == 4789 && end >= pay + 8 && (data[pay] & 0x08)) {
            uint32_t vni = ((uint32_t)data[pay + 4] << 16) |
                           ((uint32_t)data[pay + 5] << 8) | data[pay + 6];
            return try_decap_eth(data, end, pay + 8, 1, vni, out, depth);
        }
        // GENEVE (RFC 8926): variable options, inner proto must be
        // Transparent Ethernet Bridging
        if (dport == 6081 && end >= pay + 8) {
            uint32_t optlen = (uint32_t)(data[pay] & 0x3F) * 4;
            uint16_t inner_proto = rd16(data + pay + 2);
            uint32_t vni = ((uint32_t)data[pay + 4] << 16) |
                           ((uint32_t)data[pay + 5] << 8) | data[pay + 6];
            if (inner_proto == 0x6558)
                return try_decap_eth(data, end, pay + 8 + optlen, 2, vni,
                                     out, depth);
        }
        out->protocol = 2;
        out->port_src = rd16(data + l4);
        out->port_dst = dport;
        out->payload_off = pay;
        out->payload_len = end > pay ? end - pay : 0;
        return 1;
    }
    if (proto == 47 && end >= l4 + 4) {  // GRE / ERSPAN
        uint16_t flags = rd16(data + l4);
        uint16_t gre_proto = rd16(data + l4 + 2);
        uint32_t gh = l4 + 4;
        if (flags & 0x8000) gh += 4;  // checksum (+reserved)
        uint32_t key = 0;
        if (flags & 0x2000) {         // key present
            if (end < gh + 4) return 0;
            key = rd32(data + gh);
            gh += 4;
        }
        bool has_seq = (flags & 0x1000) != 0;
        if (has_seq) gh += 4;
        if (end >= gh) {
            if (gre_proto == 0x88BE) {  // ERSPAN: II has an 8B header
                // (flagged by the GRE sequence bit), I has none
                uint32_t inner = gh + (has_seq ? 8 : 0);
                uint32_t sess = has_seq && end >= gh + 4
                    ? (rd16(data + gh + 2) & 0x03FF) : 0;
                if (try_decap_eth(data, end, inner, 3, sess, out, depth))
                    return 1;
            } else if (gre_proto == 0x22EB) {  // ERSPAN III: 12B header
                uint32_t sess = end >= gh + 4
                    ? (rd16(data + gh + 2) & 0x03FF) : 0;
                if (try_decap_eth(data, end, gh + 12, 3, sess, out, depth))
                    return 1;
            } else if (gre_proto == 0x6558) {  // transparent eth bridging
                if (try_decap_eth(data, end, gh, 4, key, out, depth))
                    return 1;
            }
        }
        return 0;  // plain GRE payloads need the Python slow path
    }
    if (proto == 1) {
        out->protocol = 3;
        out->payload_off = l4;
        out->payload_len = end > l4 ? end - l4 : 0;
        return 1;
    }
    return 0;
}

// Decode one frame at `data` of length `len` into out (tunnels stripped,
// see decode_frame). Returns 1 on success, 0 when the frame needs the
// Python slow path (v6, vlan-in-tunnel, short).
int32_t df_decode_eth(const uint8_t* data, uint32_t len, DfPacketOut* out) {
    return decode_frame(data, len, 0, out, 0);
}

// Batch decode: n frames packed into `data` with n+1 `offsets`.
// Writes one DfPacketOut per frame; ok[i]=1 when the fast path decoded it.
void df_decode_eth_batch(const uint8_t* data, const uint32_t* offsets,
                         uint32_t n, DfPacketOut* outs, uint8_t* ok) {
    for (uint32_t i = 0; i < n; i++) {
        ok[i] = (uint8_t)df_decode_eth(data + offsets[i],
                                       offsets[i + 1] - offsets[i],
                                       &outs[i]);
    }
}

}  // extern "C"
