"""Columnar table with dictionary-encoded string columns, in memory.

Own copy of the parts of ``deepflow_tpu/store/table.py`` that the
profile tables use: ``ColumnSpec`` and a ``ColumnarTable`` that buffers
appended row batches or column batches (dict column name -> np.ndarray)
and seals them into an immutable chunk once ``chunk_rows`` rows or more
are buffered, with the reference's retention (``trim_before``) and
dictionary compaction (``compact_dictionaries``), and its change tokens
(``sync_state``, ``bucket_marks``), which the query cache validates
against. Values are cast to the column's numpy dtype with ``astype``, so
a value outside the column's width wraps, as the reference's columnar
decode path does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from deepflow_tpu_torch.native import ArenaStrings
from deepflow_tpu_torch.store.dictionary import Dictionary

_DTYPES = {
    "u8": np.uint8, "u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
    "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
    "f32": np.float32, "f64": np.float64,
    "str": np.uint32,   # dictionary-encoded
    "enum": np.uint16,  # index into the spec's enum_values
}


def _cast(values: list, dtype) -> np.ndarray:
    """A list of Python numbers cast to dtype as astype casts. Integers
    never pass through float64, which np.asarray takes for ints past
    2**63 mixed with smaller ones."""
    if not np.issubdtype(dtype, np.integer):
        return np.asarray(values).astype(dtype)
    try:
        a = np.asarray(values, dtype=np.int64)
    except OverflowError:  # ints of 2**63 and up (none negative)
        a = np.asarray(values, dtype=np.uint64)
    return a.astype(dtype)


@dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str                      # key of _DTYPES
    enum_values: tuple[str, ...] = ()  # for kind == "enum": index -> label
    default: object = 0

    @property
    def np_dtype(self):
        return _DTYPES[self.kind]

    def enum_of(self, label: str) -> int:
        return self.enum_values.index(label)


class ColumnarTable:
    """Append-only columnar table; one string dictionary per str column.

    Appends go into an open buffer of segments, which is sealed into one
    chunk when it holds ``chunk_rows`` rows or more: at batch
    granularity, as the reference seals its stripes, so both seal at the
    same rows. One lock guards the chunks, the buffer and the
    dictionaries (the reference stripes its writers; the port's tables
    have one writer each). A reader takes a ``view()``: the chunks and
    the dictionaries that decode them, as of one moment."""

    def __init__(self, name: str, columns: list[ColumnSpec],
                 chunk_rows: int = 1 << 16) -> None:
        self.name = name
        self.columns = {c.name: c for c in columns}
        self.chunk_rows = chunk_rows
        self.dicts: dict[str, Dictionary] = {
            c.name: Dictionary(f"{name}.{c.name}")
            for c in columns if c.kind == "str"}
        self._chunks: list[dict[str, np.ndarray]] = []  # sealed
        self._open: dict[str, list[np.ndarray]] = {n: [] for n in self.columns}
        self._open_rows = 0
        # the open buffer as one chunk, until the next append changes it
        self._open_chunk: dict[str, np.ndarray] | None = None
        self._lock = threading.Lock()
        self.rows_written = 0  # live rows: appended less trimmed
        # per-table fill overrides: the value a column takes when a write
        # omits it, instead of the schema default (Database stamps
        # shard_id through this)
        self.fills: dict[str, object] = {}
        # Write watermark: bumped on every mutation that can change a
        # query answer (append, trim). The query cache keys on it for
        # exact invalidation (query/cache.py). Beside it, per TIME BUCKET,
        # the watermark of the last write into that bucket, so the
        # partial-aggregate cache re-scans only the buckets that changed;
        # _wide_mark stands for writes spanning too many buckets to mark
        # one by one (a bucket's mark is max(its mark, _wide_mark)).
        self.watermark = 0
        self._bucket_marks: dict[int, int] = {}
        self._wide_mark = 0
        self._time_col = "time" if "time" in self.columns else None
        # bucket width in the time column's unit (ns for u64, else s):
        # 60 s buckets match a dashboard's refresh
        if self._time_col is not None:
            ns = self.columns[self._time_col].kind == "u64"
            self._bucket_div = 60 * 1_000_000_000 if ns else 60
        else:
            self._bucket_div = 0

    def _fill(self, name: str, spec: ColumnSpec):
        return self.fills.get(name, "" if spec.kind == "str"
                              else spec.default)

    def _column(self, name: str, spec: ColumnSpec, v, n: int) -> np.ndarray:
        """One column's values (a sequence of n, or a scalar meaning "this
        value in every row") in the column's stored form, a new array:
        callers such as the native decoder reuse their buffers."""
        if spec.kind == "str":
            d = self.dicts[name]
            if isinstance(v, ArenaStrings):
                return d.encode_arena(v.arena, v.off, v.lens)
            if isinstance(v, (list, np.ndarray)):
                return d.encode_batch(v)
            return np.full(n, d.encode(v), dtype=np.uint32)
        if isinstance(v, np.ndarray):
            return v.astype(spec.np_dtype)
        if isinstance(v, list):
            return _cast(v, spec.np_dtype)
        return np.full(n, _cast([v], spec.np_dtype)[0])

    # -- change tracking (query-cache invalidation) --------------------------

    def _note_span(self, tmin: int, tmax: int) -> None:
        """Mark the time buckets of [tmin, tmax] with the current
        watermark. Caller holds self._lock (watermark already bumped)."""
        if not self._bucket_div:
            return
        b0, b1 = int(tmin) // self._bucket_div, int(tmax) // self._bucket_div
        if b1 - b0 >= 512:  # absurd span (poisoned clock): invalidate all
            self._wide_mark = self.watermark
            return
        for b in range(b0, b1 + 1):
            self._bucket_marks[b] = self.watermark

    def _note_segment(self, seg: np.ndarray | None) -> None:
        """Watermark bump + bucket marking for one appended time segment.
        Caller holds self._lock."""
        self.watermark += 1
        if self._bucket_div and seg is not None and len(seg):
            self._note_span(int(seg.min()), int(seg.max()))

    def bucket_marks(self) -> tuple[int, dict[int, int], int, int]:
        """(watermark, {bucket: mark}, wide_mark, bucket_div) snapshot."""
        with self._lock:
            return (self.watermark, dict(self._bucket_marks),
                    self._wide_mark, self._bucket_div)

    def sync_state(self) -> list:
        """JSON-able change token: [watermark, [[dict name, gen, len], ...]].
        Two equal tokens guarantee the same query answers and that
        dictionary ids handed out before are still valid."""
        with self._lock:
            dicts = sorted((n, *d.sync_state()[:2])
                           for n, d in self.dicts.items())
            return [self.watermark, [list(t) for t in dicts]]

    def append_rows(self, rows: list[dict]) -> None:
        """Append a batch of row dicts. Missing columns take the fill."""
        if not rows:
            return
        cols = {name: [r.get(name, self._fill(name, spec)) for r in rows]
                for name, spec in self.columns.items()}
        self.append_columns(cols, len(rows))

    def append_columns(self, cols: dict[str, list | np.ndarray],
                       n: int | None = None) -> None:
        """Column-oriented append. A column value may be a scalar, meaning
        "this value for every row in the batch"; a missing column takes
        the fill."""
        if n is None:
            n = len(next(iter(cols.values())))
        for name, v in cols.items():
            if isinstance(v, (list, np.ndarray, ArenaStrings)) \
                    and len(v) != n:
                raise ValueError(
                    f"{self.name}: column {name!r} has {len(v)} values, "
                    f"expected {n}")
        if n == 0:
            return
        with self._lock:  # encoding too: a compaction swaps dictionaries
            segs = {name: self._column(name, spec,
                                       cols.get(name, self._fill(name, spec)),
                                       n)
                    for name, spec in self.columns.items()}
            for name, seg in segs.items():
                self._open[name].append(seg)
            self._open_rows += n
            self._open_chunk = None
            self.rows_written += n
            self._note_segment(segs.get(self._time_col))
            if self._open_rows >= self.chunk_rows:
                self._chunks.append(self._merge_open())
                self._open = {name: [] for name in self.columns}
                self._open_rows = 0
                self._open_chunk = None

    def _merge_open(self) -> dict[str, np.ndarray]:
        """The open buffer as one chunk; its segments collapse into that
        chunk's arrays, so the next merge copies only later appends."""
        chunk = {}
        for name, segs in self._open.items():
            chunk[name] = segs[0] if len(segs) == 1 else np.concatenate(segs)
            self._open[name] = [chunk[name]]
        return chunk

    def _chunks_locked(self) -> list[dict[str, np.ndarray]]:
        chunks = list(self._chunks)
        if self._open_rows:
            if self._open_chunk is None:
                self._open_chunk = self._merge_open()
            chunks.append(self._open_chunk)
        return chunks

    def snapshot(self) -> list[dict[str, np.ndarray]]:
        """The sealed chunks and the open buffer's rows, oldest first.
        Readers must not write into the arrays."""
        with self._lock:
            return self._chunks_locked()

    def view(self) -> "TableView":
        """The chunks and the dictionaries that decode them, taken
        together under the lock."""
        with self._lock:
            return TableView(self.name, self.columns, dict(self.dicts),
                             self._chunks_locked())

    def column_concat(self, names: list[str]) -> dict[str, np.ndarray]:
        """The named columns over every row, from one snapshot."""
        chunks = self.snapshot()
        return {name: (np.concatenate([ch[name] for ch in chunks]) if chunks
                       else np.empty(0, dtype=self.columns[name].np_dtype))
                for name in names}

    def __len__(self) -> int:
        return self.rows_written

    # -- retention -----------------------------------------------------------

    def trim_before(self, time_col: str, cutoff: int) -> int:
        """Drop the sealed chunks whose every row is older than cutoff (the
        open buffer stays). Returns the rows dropped."""
        dropped = 0
        with self._lock:
            kept = []
            for ch in self._chunks:
                t = ch[time_col]
                if len(t) and int(t.max()) < cutoff:
                    dropped += len(t)
                else:
                    kept.append(ch)
            self._chunks = kept
            self.rows_written -= dropped
            if dropped:
                self.watermark += 1
                if self._bucket_div and time_col == self._time_col:
                    # a cached partial of a bucket the trim reached must
                    # not keep serving the rows it dropped
                    cut_b = int(cutoff) // self._bucket_div
                    for b in self._bucket_marks:
                        if b <= cut_b:
                            self._bucket_marks[b] = self.watermark
                else:
                    self._wide_mark = self.watermark
        return dropped

    def compact_dictionaries(self, min_entries: int = 4096,
                             max_live_frac: float = 0.5) -> dict:
        """Rebuild each string dictionary of ``min_entries`` entries or more
        of which at most ``max_live_frac`` are still referenced, down to
        the live ids. Dictionaries are append-only, so after TTL trims a
        high-cardinality column would otherwise grow without bound.

        New ids keep the old ids' order, so grouped and ordered answers
        do not change, and the table's watermark stays; the new
        dictionary's gen is the old one's plus one, so cached encoded
        partials and change tokens over the old ids go stale. The
        remapped chunks and the new dictionary replace the old ones under
        the lock; a view taken before keeps the old pair. Returns
        {column: {"before": n, "after": n}}."""
        stats: dict[str, dict] = {}
        with self._lock:
            for name, d in list(self.dicts.items()):
                old_n = len(d)
                if old_n < min_entries:
                    continue
                ids = [ch[name] for ch in self._chunks] + self._open[name]
                used = np.unique(np.concatenate(ids)) if ids else \
                    np.empty(0, dtype=np.uint32)
                used = used[used != 0]
                if len(used) + 1 > old_n * max_live_frac:
                    continue
                lut = np.zeros(old_n, dtype=np.uint32)
                lut[used] = np.arange(1, len(used) + 1, dtype=np.uint32)
                self._chunks = [{**ch, name: lut[ch[name]]}
                                for ch in self._chunks]
                self._open[name] = [lut[seg] for seg in self._open[name]]
                self._open_chunk = None
                nd = Dictionary(d.name, [""] + d.decode_many(used))
                nd.gen, nd.version = d.gen + 1, d.version + 1
                self.dicts[name] = nd
                stats[name] = {"before": old_n, "after": len(used) + 1}
        return stats


@dataclass(frozen=True)
class TableView:
    """One moment of a ColumnarTable: its chunks, oldest first, and the
    dictionaries that decode them. Readers must not write into the
    arrays."""

    name: str
    columns: dict[str, ColumnSpec]
    dicts: dict[str, Dictionary]
    chunks: list[dict[str, np.ndarray]]

    def view(self) -> "TableView":
        return self

    def __len__(self) -> int:
        return sum(len(next(iter(ch.values()), ())) for ch in self.chunks)
