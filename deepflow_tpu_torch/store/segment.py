"""On-disk columnar segment: per-column blocks + self-validating footer.

Own copy of ``deepflow_tpu/store/segment.py``, whole: both formats (v1,
and v2 with sorted runs; ``DF_SEG_FORMAT`` selects the writer's), the
const / zlib / raw / delta / for / dictrank codecs with ``choose_codec``,
per-column zones, zstr collation-order zones, the skip indexes (an
inline id list or a bloom filter), per-block crc32 checks (``DF_NO_CRC``,
``ChecksumError``, ``verify`` / ``verify_buffer``) and ``LazyChunk``. It
writes the reference's bytes, so each package reads the other's
segments. Nothing is left out.

ONE file per segment holds every column as a contiguous block, because
the store's unit of work is a sealed in-memory chunk, not a merge tree.

Layout (little-endian):

    magic           8 bytes   b"DFSEG001" (v1) / b"DFSEG002" (v2)
    column blocks   64-byte aligned, encoded per the column's codec
    index blocks    64-byte aligned (v2: dict-rank id maps, bloom bits)
    footer          JSON (utf-8)
    footer_len      u32
    footer_crc32    u32       crc32 of the JSON bytes
    tail magic      8 bytes   b"DFSEGEND"

The footer carries rows, the time column's min/max (the planner's pruning
and TTL coordinates), per-column block offsets/codecs, and the
dict-generation watermark of every string column at write time — a reader
whose dictionaries are SHORTER than recorded cannot decode the block's ids
and must treat the segment as torn (the dictionary dump is persisted
before the manifest commit, so this only happens on tampered/partial
state).

Format v2 (``DFSEG002``) extends v1 the ClickHouse-MergeTree way — v1
files stay readable forever (see store/migration.py for the online
migrate-on-compact path):

  * ``format: 2`` plus ``run``/``sorted_by`` footer fields: compaction
    merges small sealed segments into sorted, time-partitioned runs and
    records the run id so the planner and ops tooling can tell a
    compacted run from a raw flush.
  * lightweight integer codecs: ``delta`` (zigzag deltas, for
    monotone-ish u64/i64 ns timestamps and sequence columns) and ``for``
    (frame-of-reference: subtract the zone minimum, store narrow
    offsets). Both decode to exactly the written values; zone maps stay
    in the logical (encoded-id / raw-integer) space.
  * ``dictrank``: a per-segment LOCAL dictionary for string columns —
    the block stores rank-ordered local ids (0..card-1 in lexicographic
    order of the distinct strings present) and an ``idmap`` side block
    mapping local rank -> global dictionary id. Reads gather through the
    idmap so downstream consumers still see global ids, while the
    stored ids are dense (narrow FoR-packable) and RANK-ordered, which
    is what makes real string *range* zone maps (``zstr``) possible.
  * per-column skip indexes for equality/IN pruning: an inline sorted
    distinct-id list (``ids`` — the bitmap index, for low-cardinality
    enum/tag columns) and a ``bloom`` block (split double-hash bloom
    filter over the global dictionary ids, for high-cardinality columns
    like trace_id/pod). Both are consulted by the query planner's
    segment pruner; a bloom can false-positive (scan anyway — sound)
    but never false-negative.

Scans are zero-copy where it counts: ``raw`` blocks become read-only numpy
views directly over the shared mmap (no read(), no materialized rows — the
encoded query pipeline consumes them as ordinary chunk arrays);
encoded blocks decode once on first touch and stay cached. ``chunk()``
returns a LAZY column mapping: a column decodes the first time a scan
actually touches it, so a segment pruned by zone maps or bloom filters
never pays a decompress/cumsum/gather for any column.

Codec choice is one function (``choose_codec``), cheapest test first:

  ``const``    the whole column is one value — the block stores ONE
               element, reads are a stride-0 broadcast view
  ``for``      v2 int columns whose range fits a narrower width
  ``delta``    v2 8-byte int columns whose zigzag deltas pack narrower
               than the FoR offsets (monotone-ish time/seq columns)
  ``dictrank`` v2 string columns with enough repetition (compaction
               only — needs the dictionaries to rank strings)
  ``zlib``     compress only when it actually pays (>= ~25% saving),
               decided on an 8 KiB probe memoized in the tier's
               codec-hint cache; callers on a starved host pass
               compress=False to skip deflate entirely
  ``raw``      everything else: the mmap zero-copy fast path

Every choice is counted into the caller's ``codec_counts`` and timed via
the optional ``observe`` hook, so the tier snapshot and the learned cost
model can see what the writer actually picked.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import time as _time
import zlib
from collections.abc import Mapping

import numpy as np

MAGIC = b"DFSEG001"
MAGIC_V2 = b"DFSEG002"
TAIL_MAGIC = b"DFSEGEND"
_TAIL = struct.Struct("<II8s")  # footer_len, footer_crc32, tail magic
_ALIGN = 64

# compress a column block only when it saves at least this fraction —
# a raw block is an mmap zero-copy view, which is worth real bytes
_ZLIB_MIN_SAVING = 0.25
# probe a block's first slice before paying a full-block deflate: an
# incompressible column costs one tiny compress, not its whole length
_ZLIB_PROBE = 8192

# v2 skip-index sizing: <= _BITMAP_MAX_CARD distinct ids are stored
# inline as a sorted list (exact membership — the bitmap index for
# low-cardinality enum tags); above that a bloom filter over the ids
_BITMAP_MAX_CARD = 64
_BLOOM_BITS_PER_KEY = 12
_BLOOM_K = 6
# string-range zone bounds are truncated to this many chars in the
# footer; a truncated UPPER bound is dropped (open) — sound either way
_ZSTR_MAX = 64

_CODECS_V2 = ("const", "for", "delta", "dictrank", "zlib", "raw")


class SegmentError(Exception):
    """Unreadable/torn segment file. recovery policy: drop the file."""


class ChecksumError(SegmentError):
    """A column/index block's crc32 does not match its footer record:
    the file parsed fine (footer crc passed) but a block's bytes rotted
    after the write — bit flip, bad sector, torn page. recovery policy:
    QUARANTINE the segment (never serve it) and repair from a published
    copy; unlike a torn file there is nothing wrong with the metadata,
    so the file is kept on disk for repair/forensics."""

    def __init__(self, path: str, block: str) -> None:
        super().__init__(f"{path}: block {block!r} crc mismatch")
        self.path = path
        self.block = block


# kill switch + bench baseline: DF_NO_CRC=1 skips writing (and therefore
# verifying) block checksums — segments written this way are readable
# forever but never verifiable, exactly like pre-checksum files
_crc_enabled = not os.environ.get("DF_NO_CRC")


def _pad(f, align: int = _ALIGN) -> int:
    pos = f.tell()
    rem = pos % align
    if rem:
        f.write(b"\0" * (align - rem))
        pos += align - rem
    return pos


def _zone(arr: np.ndarray):
    """(zmin, zmax) zone-map bounds for a column, or None when the dtype
    has no total order the planner can prune against. Integer columns
    (including uint32 dictionary ids and enum codes) always qualify;
    floats qualify only when every value is finite — a NaN poisons
    comparisons, and Infinity does not round-trip through strict JSON."""
    if not arr.size:
        return None
    k = arr.dtype.kind
    if k in "iu":
        return int(arr.min()), int(arr.max())
    if k == "f" and bool(np.isfinite(arr).all()):
        return float(arr.min()), float(arr.max())
    return None


def _narrow_width(maxval: int) -> int:
    """Narrowest unsigned byte width holding maxval."""
    if maxval < (1 << 8):
        return 1
    if maxval < (1 << 16):
        return 2
    if maxval < (1 << 32):
        return 4
    return 8


_U64 = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (same constants as qexec.cpp)."""
    x = x + _U64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def _bloom_params(card: int) -> int:
    """Bloom size in bits (power of two) for `card` distinct keys."""
    bits = 1 << max(10, (card * _BLOOM_BITS_PER_KEY - 1).bit_length())
    return min(bits, 1 << 24)  # cap at 2 MiB of bits


def _bloom_build(ids: np.ndarray) -> bytes:
    """Split double-hash bloom over uint32 dictionary ids."""
    m = _bloom_params(len(ids))
    bits = np.zeros(m >> 3, dtype=np.uint8)
    h1 = _splitmix64(ids.astype(np.uint64))
    h2 = _splitmix64(h1 ^ _U64(0xA5A5A5A5A5A5A5A5)) | _U64(1)
    mask = _U64(m - 1)
    for i in range(_BLOOM_K):
        pos = (h1 + _U64(i) * h2) & mask
        np.bitwise_or.at(bits, (pos >> _U64(3)).astype(np.int64),
                         (_U64(1) << (pos & _U64(7))).astype(np.uint8))
    return bits.tobytes()


def _bloom_maybe(bits: np.ndarray, m: int, sid: int) -> bool:
    """False => sid is PROVABLY absent; True => maybe present."""
    h1 = int(_splitmix64(np.array([sid], dtype=np.uint64))[0])
    h2 = int(_splitmix64(np.array([h1 ^ 0xA5A5A5A5A5A5A5A5],
                                  dtype=np.uint64))[0]) | 1
    for i in range(_BLOOM_K):
        pos = (h1 + i * h2) & (m - 1)
        if not (int(bits[pos >> 3]) >> (pos & 7)) & 1:
            return False
    return True


# -- v2 integer codecs -------------------------------------------------------

def _encode_for(arr: np.ndarray, zone) -> tuple[dict, bytes] | None:
    """Frame-of-reference: store (value - zmin) at the narrowest width.
    Only offered when it actually narrows the element (>= 50% saving)."""
    if zone is None or arr.dtype.kind not in "iu":
        return None
    base, zmax = int(zone[0]), int(zone[1])
    rng = zmax - base
    if rng >= (1 << 63):
        return None
    width = _narrow_width(rng)
    if width >= arr.dtype.itemsize:
        return None
    if arr.dtype.kind == "u":
        off = arr.astype(np.uint64) - _U64(base)
    else:
        off = (arr.astype(np.int64) - base).astype(np.uint64)
    return ({"base": base, "width": width},
            off.astype(f"<u{width}").tobytes())


def _decode_for(buf: memoryview, c: dict, rows: int,
                dt: np.dtype) -> np.ndarray:
    width = int(c["width"])
    base = int(c["base"])
    off = np.frombuffer(buf, dtype=f"<u{width}", count=rows)
    if dt.kind == "u":
        out = off.astype(np.uint64) + _U64(base & 0xFFFFFFFFFFFFFFFF)
    else:
        out = off.astype(np.int64) + base
    return out.astype(dt, copy=False)


def _encode_delta(arr: np.ndarray, zone) -> tuple[dict, bytes] | None:
    """Zigzag delta coding for 8-byte int columns (u64 ns timestamps,
    sequence numbers): monotone-ish data packs into 1-2 byte deltas.
    Arithmetic is mod 2^64 throughout, so any value round-trips."""
    if arr.dtype.kind not in "iu" or arr.dtype.itemsize != 8 \
            or len(arr) < 2:
        return None
    au = arr.view(np.uint64) if arr.dtype.kind == "i" \
        else arr.astype(np.uint64, copy=False)
    d = (au[1:] - au[:-1]).view(np.int64)  # two's-complement deltas
    zz = ((d << np.int64(1)) ^ (d >> np.int64(63))).view(np.uint64)
    width = _narrow_width(int(zz.max()))
    if width > 4:
        return None
    return ({"base": int(arr[0]), "width": width},
            zz.astype(f"<u{width}").tobytes())


def _decode_delta(buf: memoryview, c: dict, rows: int,
                  dt: np.dtype) -> np.ndarray:
    width = int(c["width"])
    base = _U64(int(c["base"]) & 0xFFFFFFFFFFFFFFFF)
    out = np.empty(rows, dtype=np.uint64)
    out[0] = base
    if rows > 1:
        zz = np.frombuffer(buf, dtype=f"<u{width}",
                           count=rows - 1).astype(np.uint64)
        d = (zz >> _U64(1)) ^ (_U64(0) - (zz & _U64(1)))
        out[1:] = base + np.cumsum(d, dtype=np.uint64)
    return out.view(dt) if dt.kind == "i" else out.astype(dt, copy=False)


# -- unified codec choice ----------------------------------------------------

def choose_codec(name: str, arr: np.ndarray, raw: memoryview, *,
                 fmt: int, compress: bool, zone,
                 codec_hints: dict | None) -> tuple[str, dict, object]:
    """THE codec decision for one column block -> (codec, meta, blob).

    One function so every writer (flush, compaction, migration) makes
    the same choice the same way and the choice is observable: the
    caller counts the returned codec into the tier's ``codec_counts``
    and times the call into the codec cost model. ``codec_hints`` is
    the tier's per-column memo — it caches the zlib probe verdict
    exactly as before, and v2 size probes are cheap enough (min/max is
    shared with the zone map, one np.diff) to run every time.
    """
    if arr.size and bool((arr == arr[0]).all()):
        return "const", {}, raw[:arr.dtype.itemsize]
    if fmt >= 2 and arr.size:
        f = _encode_for(arr, zone)
        d = _encode_delta(arr, zone)
        best = None
        for codec, enc in (("for", f), ("delta", d)):
            if enc is not None and (best is None
                                    or len(enc[1]) < len(best[2])):
                best = (codec, enc[0], enc[1])
        if best is not None:
            return best
    if compress and raw.nbytes >= 256:
        worth = None if codec_hints is None else codec_hints.get(name)
        if worth is None:
            worth = True
            if raw.nbytes > 2 * _ZLIB_PROBE:
                probe = zlib.compress(raw[:_ZLIB_PROBE], 1)
                worth = len(probe) <= _ZLIB_PROBE * (1.0 - _ZLIB_MIN_SAVING)
            if codec_hints is not None:
                codec_hints[name] = worth
        if worth:
            comp = zlib.compress(raw, 1)
            if len(comp) <= raw.nbytes * (1.0 - _ZLIB_MIN_SAVING):
                return "zlib", {}, comp
    return "raw", {}, raw


def _rank_encode(arr: np.ndarray, d) -> tuple[dict, bytes, bytes,
                                              list[str]] | None:
    """Dict-order rewrite for one string column (compaction only):
    -> (meta, rank_block, idmap_block, sorted_strings) or None when the
    rewrite would not pay (near-unique column — bloom covers those)."""
    uniq = np.unique(arr)
    card = len(uniq)
    if card < 2:
        return None
    strs = [d.decode(int(u)) for u in uniq]
    order = np.argsort(np.asarray(strs, dtype=object), kind="stable")
    idmap = uniq[order].astype(np.uint32)  # rank -> global id
    width = _narrow_width(card - 1)
    # rank block + idmap must beat the plain u32 ids to be worth it
    if width * len(arr) + 4 * card >= arr.nbytes:
        return None
    # global id -> rank lookup via the numerically-sorted uniq
    rank_of = np.empty(card, dtype=np.uint32)
    rank_of[order] = np.arange(card, dtype=np.uint32)
    ranks = rank_of[np.searchsorted(uniq, arr)]
    sorted_strs = [strs[int(i)] for i in order]
    return ({"width": width, "card": card},
            ranks.astype(f"<u{width}").tobytes(), idmap.tobytes(),
            sorted_strs)


def _zstr_bounds(strs_sorted: list[str]) -> list:
    """[lo, hi] string zone bounds for the footer. lo truncates to a
    PREFIX (a prefix is <= the value, so lower-bound pruning stays
    sound); a truncated hi is dropped (null = unbounded above)."""
    lo, hi = strs_sorted[0], strs_sorted[-1]
    lo = lo[:_ZSTR_MAX]
    return [lo, hi if len(hi) <= _ZSTR_MAX else None]


def write_segment(path: str, chunk, time_col: str | None = None,
                  dict_gens: dict[str, tuple[int, int]] | None = None,
                  fsync: bool = True, compress: bool = True,
                  codec_hints: dict | None = None,
                  fmt: int | None = None, level: int = 0,
                  run: int | None = None, sorted_by: str | None = None,
                  dicts: dict | None = None,
                  codec_counts: dict | None = None,
                  observe=None) -> dict:
    """Write one sealed chunk as a segment file. Returns the footer dict.

    The file is fsync'd before return (crash safety: the manifest commit
    that makes this segment live must never point at a torn file); the
    DIRECTORY fsync is the caller's job, batched across a commit.

    ``fmt`` picks the on-disk format (2 = current, 1 = the frozen legacy
    writer kept for the cross-version golden tests and the migration
    bench baseline). The default (None) honors ``DF_SEG_FORMAT`` so a
    whole process can be pinned to v1 flushes; an EXPLICIT fmt wins over
    the env — compaction always emits v2 runs, which is what makes
    migrate-on-compact converge even in a pinned-v1 process.
    ``level`` 0 is flush-grade: cheap codecs only, no skip indexes — the
    flusher runs beside the ingest hot path. ``level`` 1 is
    compaction-grade: the caller pre-sorted the chunk (``sorted_by``),
    string columns get the dict-order rewrite + zstr range zones when
    ``dicts`` is provided, and equality skip indexes (inline id list /
    bloom) are built for every dictionary column.

    ``codec_hints`` is the tier's per-column codec memo (zlib probe
    verdicts); ``codec_counts``/``observe`` surface every codec choice
    to the tier snapshot and the learned cost model.
    """
    if fmt is None:
        env_fmt = os.environ.get("DF_SEG_FORMAT", "").strip()
        fmt = int(env_fmt) if env_fmt else 2
    if fmt == 1:
        return _write_segment_v1(path, chunk, time_col, dict_gens,
                                 fsync, compress, codec_hints)
    rows = len(next(iter(chunk.values()))) if chunk else 0
    str_cols = set(dict_gens or ()) if dict_gens else set()
    cols: dict[str, dict] = {}
    tmp = f"{path}.tmp.{os.getpid()}"
    t_ns = _time.perf_counter_ns
    with open(tmp, "wb") as f:
        f.write(MAGIC_V2)
        for name in sorted(chunk):
            arr = np.ascontiguousarray(chunk[name])
            # byte view, no copy: the flusher runs beside the ingest hot
            # path, and a tobytes() here would hold the GIL for a full
            # memcpy of every column it commits
            raw = memoryview(arr).cast("B")
            z = _zone(arr)
            t0 = t_ns()
            codec, meta, blob = "raw", {}, raw
            ranked = None
            if level >= 1 and dicts is not None and name in str_cols \
                    and arr.dtype == np.uint32 and arr.size \
                    and name in dicts:
                ranked = _rank_encode(arr, dicts[name])
            if ranked is not None:
                codec, meta = "dictrank", dict(ranked[0])
                blob = ranked[1]
            else:
                codec, meta, blob = choose_codec(
                    name, arr, raw, fmt=2, compress=compress, zone=z,
                    codec_hints=codec_hints)
            off = _pad(f)
            f.write(blob)
            ent = {"off": off,
                   "nbytes": blob.nbytes if isinstance(blob, memoryview)
                   else len(blob),
                   "dtype": arr.dtype.str, "codec": codec,
                   "raw_nbytes": raw.nbytes, **meta}
            if _crc_enabled:
                # per-block crc32 (additive field — readers without it
                # treat the block as unverifiable, never unreadable)
                ent["crc"] = zlib.crc32(blob) & 0xFFFFFFFF
            if ranked is not None:
                ioff = _pad(f)
                f.write(ranked[2])
                ent["idmap_off"] = ioff
                ent["idmap_nbytes"] = len(ranked[2])
                if _crc_enabled:
                    ent["idmap_crc"] = zlib.crc32(ranked[2]) & 0xFFFFFFFF
                ent["zstr"] = _zstr_bounds(ranked[3])
            if z is not None:
                ent["zmin"], ent["zmax"] = z
            if level >= 1 and arr.size and (
                    (name in str_cols and arr.dtype == np.uint32)
                    or arr.dtype == np.uint16):
                uniq = np.unique(arr)
                if len(uniq) <= _BITMAP_MAX_CARD:
                    ent["ids"] = [int(u) for u in uniq]
                elif arr.dtype == np.uint32:
                    bl = _bloom_build(uniq.astype(np.uint32))
                    boff = _pad(f)
                    f.write(bl)
                    ent["bloom"] = {"off": boff, "nbytes": len(bl),
                                    "k": _BLOOM_K}
                    if _crc_enabled:
                        ent["bloom"]["crc"] = zlib.crc32(bl) & 0xFFFFFFFF
                    if dicts is not None and name in dicts \
                            and "zstr" not in ent:
                        d = dicts[name]
                        strs = sorted(d.decode(int(u)) for u in uniq)
                        ent["zstr"] = _zstr_bounds(strs)
            if codec_counts is not None:
                codec_counts[codec] = codec_counts.get(codec, 0) + 1
            if observe is not None:
                observe(codec, len(arr), t_ns() - t0)
            cols[name] = ent
        footer = {"format": 2, "rows": rows, "cols": cols,
                  "dict_gens": {k: list(v)
                                for k, v in (dict_gens or {}).items()}}
        if run is not None:
            footer["run"] = int(run)
        if sorted_by is not None:
            footer["sorted_by"] = sorted_by
        if time_col is not None and rows and time_col in chunk:
            t = chunk[time_col]
            footer["time_col"] = time_col
            footer["tmin"] = int(t.min())
            footer["tmax"] = int(t.max())
        fb = json.dumps(footer, sort_keys=True).encode()
        _pad(f, 8)
        f.write(fb)
        f.write(_TAIL.pack(len(fb), zlib.crc32(fb) & 0xFFFFFFFF,
                           TAIL_MAGIC))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return footer


def _write_segment_v1(path: str, chunk, time_col, dict_gens,
                      fsync: bool, compress: bool,
                      codec_hints: dict | None) -> dict:
    """The frozen v1 writer — byte-compatible with every segment written
    before format v2. Kept for the golden cross-version read matrix and
    the migration bench baseline, NOT for new code."""
    rows = len(next(iter(chunk.values()))) if chunk else 0
    cols: dict[str, dict] = {}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        for name in sorted(chunk):
            arr = np.ascontiguousarray(chunk[name])
            raw = memoryview(arr).cast("B")
            codec, blob = "raw", raw
            if arr.size and bool((arr == arr[0]).all()):
                codec, blob = "const", raw[:arr.dtype.itemsize]
            elif compress and raw.nbytes >= 256:
                worth = None if codec_hints is None \
                    else codec_hints.get(name)
                if worth is None:
                    worth = True
                    if raw.nbytes > 2 * _ZLIB_PROBE:
                        probe = zlib.compress(raw[:_ZLIB_PROBE], 1)
                        worth = len(probe) <= _ZLIB_PROBE \
                            * (1.0 - _ZLIB_MIN_SAVING)
                    if codec_hints is not None:
                        codec_hints[name] = worth
                if worth:
                    comp = zlib.compress(raw, 1)
                    if len(comp) <= raw.nbytes * (1.0 - _ZLIB_MIN_SAVING):
                        codec, blob = "zlib", comp
            off = _pad(f)
            f.write(blob)
            cols[name] = {"off": off,
                          "nbytes": blob.nbytes
                          if isinstance(blob, memoryview) else len(blob),
                          "dtype": arr.dtype.str, "codec": codec,
                          "raw_nbytes": raw.nbytes}
            z = _zone(arr)
            if z is not None:
                cols[name]["zmin"], cols[name]["zmax"] = z
        footer = {"rows": rows, "cols": cols,
                  "dict_gens": {k: list(v)
                                for k, v in (dict_gens or {}).items()}}
        if time_col is not None and rows and time_col in chunk:
            t = chunk[time_col]
            footer["time_col"] = time_col
            footer["tmin"] = int(t.min())
            footer["tmax"] = int(t.max())
        fb = json.dumps(footer, sort_keys=True).encode()
        _pad(f, 8)
        f.write(fb)
        f.write(_TAIL.pack(len(fb), zlib.crc32(fb) & 0xFFFFFFFF,
                           TAIL_MAGIC))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return footer


class LazyChunk(Mapping):
    """A segment chunk that decodes columns on first touch.

    Looks like the familiar {column -> ndarray} mapping the whole query
    engine consumes, but a column block is only decoded (zlib inflate,
    delta cumsum, dictrank gather) when a scan actually reads it — a
    segment pruned by zone maps or bloom filters costs zero decode, and
    a needle query over 3 of 40 columns decodes 3. Decoded arrays are
    cached on the backing Segment, so repeat scans stay warm exactly
    like the eager chunk cache did."""

    __slots__ = ("_seg", "_names", "_fills", "rows")

    def __init__(self, seg: "Segment", columns=None, fills=None) -> None:
        self._seg = seg
        self.rows = seg.rows
        names = dict.fromkeys(seg._cols)
        self._fills = {}
        if columns:
            for name, spec in columns.items():
                if name not in names:
                    names[name] = None
                    fill = (fills or {}).get(name, spec.default)
                    self._fills[name] = (fill, spec.np_dtype)
        self._names = names

    def __getitem__(self, name: str) -> np.ndarray:
        if name in self._seg._cols:
            return self._seg.column(name)
        try:
            fill, dt = self._fills[name]
        except KeyError:
            raise KeyError(name) from None
        a = self._seg._cache.get(name)
        if a is None:
            a = np.broadcast_to(np.asarray(fill, dtype=dt), (self.rows,))
            self._seg._cache[name] = a
        return a

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name) -> bool:
        return name in self._names


class Segment:
    """A validated, mmap'd on-disk segment (format v1 or v2).

    ``chunk()`` yields the familiar {column -> ndarray} shape the whole
    query engine consumes (engine._materialize sees no difference between
    a RAM chunk and a mapped one). Arrays over raw blocks are read-only
    views into the mapping — dropping the Segment drops the mapping only
    once no live snapshot still references the views (numpy keeps the
    exporting buffer alive), so eviction can never pull pages out from
    under an in-flight scan.
    """

    __slots__ = ("path", "rows", "tmin", "tmax", "time_col", "dict_gens",
                 "nbytes", "zones", "fmt", "run", "sorted_by", "_mm",
                 "_cols", "_cache", "_lock", "_indexes", "_crc_ok")

    def __init__(self, path: str, footer: dict, mm, nbytes: int) -> None:
        self.path = path
        self.rows = int(footer["rows"])
        self.tmin = footer.get("tmin")
        self.tmax = footer.get("tmax")
        self.time_col = footer.get("time_col")
        self.fmt = int(footer.get("format", 1))
        self.run = footer.get("run")
        self.sorted_by = footer.get("sorted_by")
        self.dict_gens = {k: tuple(v)
                          for k, v in footer.get("dict_gens", {}).items()}
        self.nbytes = nbytes
        # per-column (zmin, zmax) over the ENCODED values (uint32 dict
        # ids for string columns). Segments from before zone maps fall
        # back to the footer's time min/max, so time pruning keeps
        # working across the format generations.
        self.zones = {name: (c["zmin"], c["zmax"])
                      for name, c in footer["cols"].items()
                      if "zmin" in c and "zmax" in c}
        tc = footer.get("time_col")
        if (tc is not None and tc not in self.zones
                and self.tmin is not None and self.tmax is not None):
            self.zones[tc] = (self.tmin, self.tmax)
        self._mm = mm
        self._cols = footer["cols"]
        self._cache: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._indexes: dict[str, object] = {}
        # blocks whose crc already matched THIS mapping: a Segment object
        # is one mmap generation, so the hot query path pays one crc pass
        # per block per open, ~zero after warm-up
        self._crc_ok: set[str] = set()

    @classmethod
    def open(cls, path: str) -> "Segment":
        try:
            size = os.path.getsize(path)
            if size < len(MAGIC) + _TAIL.size:
                raise SegmentError(f"{path}: truncated ({size} bytes)")
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except OSError as e:
            raise SegmentError(f"{path}: {e}") from e
        try:
            magic = mm[:len(MAGIC)]
            if magic not in (MAGIC, MAGIC_V2):
                raise SegmentError(f"{path}: bad magic")
            flen, fcrc, tail = _TAIL.unpack(mm[size - _TAIL.size:])
            if tail != TAIL_MAGIC:
                raise SegmentError(f"{path}: bad tail magic (torn write)")
            foot_off = size - _TAIL.size - flen
            if flen <= 0 or foot_off < len(MAGIC):
                raise SegmentError(f"{path}: bad footer length {flen}")
            fb = mm[foot_off:foot_off + flen]
            if (zlib.crc32(fb) & 0xFFFFFFFF) != fcrc:
                raise SegmentError(f"{path}: footer crc mismatch")
            try:
                footer = json.loads(fb)
            except ValueError as e:
                raise SegmentError(f"{path}: footer json: {e}") from e
            rows = footer.get("rows")
            cols = footer.get("cols")
            if not isinstance(rows, int) or rows < 0 \
                    or not isinstance(cols, dict):
                raise SegmentError(f"{path}: malformed footer")
            fmt = int(footer.get("format", 1))
            if (magic == MAGIC_V2) != (fmt >= 2):
                raise SegmentError(f"{path}: magic/format mismatch")
            for name, c in cols.items():
                cls._validate_col(path, name, c, rows, foot_off, fmt)
        except SegmentError:
            mm.close()
            raise
        return cls(path, footer, mm, size)

    @staticmethod
    def _validate_col(path, name, c, rows, foot_off, fmt) -> None:
        off, nb = c.get("off", -1), c.get("nbytes", -1)
        if off < 0 or nb < 0 or off + nb > foot_off:
            raise SegmentError(
                f"{path}: column {name!r} block out of bounds")
        try:
            dt = np.dtype(c["dtype"])
        except (TypeError, KeyError) as e:
            raise SegmentError(
                f"{path}: column {name!r} dtype: {e}") from e
        codec = c.get("codec")
        if fmt >= 2 and codec not in _CODECS_V2:
            raise SegmentError(
                f"{path}: column {name!r} unknown codec {codec!r}")
        if codec == "const" and nb != dt.itemsize:
            raise SegmentError(
                f"{path}: column {name!r} const block holds "
                f"{nb} bytes, dtype wants {dt.itemsize}")
        if codec in ("for", "delta", "dictrank"):
            width = c.get("width")
            if width not in (1, 2, 4, 8):
                raise SegmentError(
                    f"{path}: column {name!r} bad codec width {width!r}")
            n_enc = rows - 1 if codec == "delta" else rows
            if nb != max(n_enc, 0) * width:
                raise SegmentError(
                    f"{path}: column {name!r} {codec} block holds "
                    f"{nb} bytes, wants {max(n_enc, 0) * width}")
            if codec == "delta" and not isinstance(c.get("base"), int):
                raise SegmentError(
                    f"{path}: column {name!r} delta base missing")
            if codec == "for" and not isinstance(c.get("base"), int):
                raise SegmentError(
                    f"{path}: column {name!r} for base missing")
            if codec == "dictrank":
                card = c.get("card")
                ioff, inb = c.get("idmap_off", -1), \
                    c.get("idmap_nbytes", -1)
                if not isinstance(card, int) or card < 1 \
                        or inb != card * 4 or ioff < 0 \
                        or ioff + inb > foot_off:
                    raise SegmentError(
                        f"{path}: column {name!r} idmap out of bounds")
        bloom = c.get("bloom")
        if bloom is not None:
            boff, bnb = bloom.get("off", -1), bloom.get("nbytes", -1)
            if boff < 0 or bnb < 8 or boff + bnb > foot_off \
                    or bnb & (bnb - 1):
                raise SegmentError(
                    f"{path}: column {name!r} bloom block invalid")
        want = rows * dt.itemsize
        have = nb if codec == "raw" else c.get("raw_nbytes", -1)
        if have != want:
            raise SegmentError(
                f"{path}: column {name!r} holds {have} bytes, "
                f"schema wants {want}")

    def _check_crc(self, block: str, off: int, nbytes: int, crc) -> None:
        """Verify one block's crc against the footer record (no-op for
        pre-checksum blocks: crc None). Memoized per mmap generation in
        ``_crc_ok`` so repeat touches cost a set lookup."""
        if crc is None or block in self._crc_ok:
            return
        got = zlib.crc32(self._mm[off:off + nbytes]) & 0xFFFFFFFF
        if got != crc:
            raise ChecksumError(self.path, block)
        with self._lock:
            self._crc_ok.add(block)

    def verify(self) -> dict:
        """Full checksum pass over every column/index block (the scrub
        and fsck entry point). Pre-checksum blocks (v1, or written under
        DF_NO_CRC) are counted but never accused: readable, never
        verifiable. Unlike the first-touch path this recomputes every
        crc — bytes can rot after a block was memoized clean — and
        refreshes the memo both ways: clean blocks won't pay a second
        pass at query time, corrupt ones lose their alibi."""
        blocks = checked = nbytes = 0
        corrupt: list[str] = []
        for name, c in self._cols.items():
            todo = [(name, c.get("off"), c.get("nbytes"), c.get("crc")),
                    (f"idmap:{name}", c.get("idmap_off"),
                     c.get("idmap_nbytes"), c.get("idmap_crc"))]
            b = c.get("bloom")
            if b is not None:
                todo.append((f"bloom:{name}", b.get("off"),
                             b.get("nbytes"), b.get("crc")))
            for block, off, nb, crc in todo:
                if off is None:
                    continue
                blocks += 1
                nbytes += nb
                if crc is None:
                    continue
                checked += 1
                got = zlib.crc32(self._mm[off:off + nb]) & 0xFFFFFFFF
                with self._lock:
                    if got == crc:
                        self._crc_ok.add(block)
                    else:
                        self._crc_ok.discard(block)
                if got != crc:
                    corrupt.append(block)
        return {"blocks": blocks, "checked": checked, "bytes": nbytes,
                "corrupt": corrupt,
                "verifiable": checked > 0 or blocks == 0}

    def column(self, name: str) -> np.ndarray:
        a = self._cache.get(name)
        if a is not None:
            return a
        c = self._cols[name]
        if _crc_enabled:
            # verify-on-first-touch: the block's bytes are about to be
            # decoded/viewed — one crc pass per mmap generation
            self._check_crc(name, c["off"], c["nbytes"], c.get("crc"))
        dt = np.dtype(c["dtype"])
        codec = c["codec"]
        if codec == "raw":
            a = np.frombuffer(self._mm, dtype=dt, count=self.rows,
                              offset=c["off"])
        elif codec == "const":
            # stride-0 broadcast of the block's single element: still a
            # view over the mapping (keeps pages alive), still zero-copy
            v = np.frombuffer(self._mm, dtype=dt, count=1, offset=c["off"])
            a = np.broadcast_to(v, (self.rows,))
        elif codec == "for":
            a = _decode_for(memoryview(self._mm)[c["off"]:
                                                 c["off"] + c["nbytes"]],
                            c, self.rows, dt)
        elif codec == "delta":
            a = _decode_delta(memoryview(self._mm)[c["off"]:
                                                   c["off"] + c["nbytes"]],
                              c, self.rows, dt)
        elif codec == "dictrank":
            width, card = int(c["width"]), int(c["card"])
            ranks = np.frombuffer(self._mm, dtype=f"<u{width}",
                                  count=self.rows, offset=c["off"])
            if self.rows and int(ranks.max()) >= card:
                raise SegmentError(f"{self.path}: column {name!r} rank "
                                   f"out of idmap range")
            a = self.idmap(name)[ranks]
        else:
            raw = zlib.decompress(
                self._mm[c["off"]:c["off"] + c["nbytes"]])
            if len(raw) != c["raw_nbytes"]:
                raise SegmentError(f"{self.path}: column {name!r} "
                                   f"decompressed size mismatch")
            a = np.frombuffer(raw, dtype=dt, count=self.rows)
        self._cache[name] = a
        return a

    # -- v2 skip indexes (planner-facing) ------------------------------------

    def idmap(self, name: str) -> np.ndarray:
        """dictrank rank -> global dictionary id map (uint32, ascending
        in LEXICOGRAPHIC string order)."""
        key = f"idmap:{name}"
        a = self._cache.get(key)
        if a is None:
            c = self._cols[name]
            if _crc_enabled:
                self._check_crc(key, c["idmap_off"], c["idmap_nbytes"],
                                c.get("idmap_crc"))
            a = np.frombuffer(self._mm, dtype=np.uint32,
                              count=int(c["card"]),
                              offset=c["idmap_off"])
            self._cache[key] = a
        return a

    def str_zone(self, name: str):
        """(lo, hi_or_None) string-order zone bounds for a dictionary
        column, or None when this segment has no zstr index. hi None =
        unbounded above (truncated at write time)."""
        c = self._cols.get(name)
        z = c.get("zstr") if c else None
        if not z:
            return None
        return (z[0], z[1])

    def maybe_contains(self, name: str, sids) -> bool:
        """False => NONE of the dictionary ids in `sids` appear in this
        segment's column (provable — safe to skip the segment). True =>
        at least one may be present (inline id list is exact, bloom can
        false-positive). Columns without a skip index return True."""
        c = self._cols.get(name)
        if c is None:
            return True
        b = c.get("bloom")
        if _crc_enabled and b is not None and name not in self._indexes:
            # outside self._lock (non-reentrant; _check_crc takes it to
            # memoize) — a racing duplicate check is benign
            self._check_crc(f"bloom:{name}", b["off"], b["nbytes"],
                            b.get("crc"))
        with self._lock:
            idx = self._indexes.get(name)
            if idx is None:
                ids = c.get("ids")
                if ids is not None:
                    idx = frozenset(ids)
                elif c.get("bloom") is not None:
                    b = c["bloom"]
                    bits = np.frombuffer(self._mm, dtype=np.uint8,
                                         count=b["nbytes"],
                                         offset=b["off"])
                    idx = (bits, b["nbytes"] << 3)
                else:
                    idx = True
                self._indexes[name] = idx
        if idx is True:
            return True
        if isinstance(idx, frozenset):
            return any(int(s) in idx for s in sids)
        bits, m = idx
        return any(_bloom_maybe(bits, m, int(s)) for s in sids)

    def has_index(self, name: str) -> bool:
        c = self._cols.get(name)
        return bool(c and ("ids" in c or "bloom" in c))

    def codecs(self) -> dict[str, str]:
        """{column -> codec} (ops/inspector view)."""
        return {name: c.get("codec", "raw")
                for name, c in self._cols.items()}

    def chunk(self, columns=None, fills=None) -> LazyChunk:
        """The lazy column map. With a schema (`columns`:
        {name -> ColumnSpec}), columns added AFTER this segment was
        written are backfilled with their fill value — same additive
        compat rule as ColumnarTable.load()."""
        return LazyChunk(self, columns, fills)

    def __repr__(self) -> str:  # debugging/ops
        return (f"Segment({os.path.basename(self.path)}, v{self.fmt}, "
                f"rows={self.rows}, t=[{self.tmin},{self.tmax}], "
                f"{self.nbytes}B)")


def verify_buffer(buf, name: str = "<buf>") -> dict:
    """Checksum-verify a whole segment held in memory — the scrub path
    for objstore blobs, which have no mmap and no Segment object.

    Returns {"ok", "verifiable", "corrupt", "reason"}:
      * unparseable/torn (bad magic/tail/footer)  -> ok=False, "torn..."
      * parseable, block crc mismatch             -> ok=False, corrupt=[..]
      * parseable pre-checksum (v1 / DF_NO_CRC)   -> ok=True, verifiable=False
    """
    mv = memoryview(buf)
    size = len(mv)
    try:
        if size < len(MAGIC) + _TAIL.size:
            raise SegmentError("truncated")
        if bytes(mv[:len(MAGIC)]) not in (MAGIC, MAGIC_V2):
            raise SegmentError("bad magic")
        flen, fcrc, tail = _TAIL.unpack(mv[size - _TAIL.size:])
        if tail != TAIL_MAGIC:
            raise SegmentError("bad tail magic (torn write)")
        foot_off = size - _TAIL.size - flen
        if flen <= 0 or foot_off < len(MAGIC):
            raise SegmentError(f"bad footer length {flen}")
        fb = mv[foot_off:foot_off + flen]
        if (zlib.crc32(fb) & 0xFFFFFFFF) != fcrc:
            raise SegmentError("footer crc mismatch")
        footer = json.loads(bytes(fb))
        cols = footer.get("cols")
        if not isinstance(cols, dict):
            raise SegmentError("malformed footer")
    except (SegmentError, struct.error, ValueError) as e:
        return {"ok": False, "verifiable": False, "corrupt": [],
                "reason": f"torn: {name}: {e}"}
    corrupt: list[str] = []
    checked = 0
    for cname, c in cols.items():
        todo = [(cname, c.get("off"), c.get("nbytes"), c.get("crc")),
                (f"idmap:{cname}", c.get("idmap_off"),
                 c.get("idmap_nbytes"), c.get("idmap_crc"))]
        b = c.get("bloom")
        if isinstance(b, dict):
            todo.append((f"bloom:{cname}", b.get("off"), b.get("nbytes"),
                         b.get("crc")))
        for block, off, nb, crc in todo:
            if off is None or crc is None:
                continue
            checked += 1
            if not isinstance(off, int) or not isinstance(nb, int) \
                    or off < 0 or nb < 0 or off + nb > foot_off \
                    or (zlib.crc32(mv[off:off + nb]) & 0xFFFFFFFF) != crc:
                corrupt.append(block)
    return {"ok": not corrupt, "verifiable": checked > 0,
            "corrupt": corrupt,
            "reason": f"crc: {name}: {corrupt}" if corrupt else ""}
