"""Columnar table with dictionary-encoded string columns.

Own copy of ``deepflow_tpu/store/table.py``: ``ColumnSpec`` and a
``ColumnarTable`` that buffers appended row batches or column batches
(dict column name -> np.ndarray) and seals them into an immutable chunk
once ``chunk_rows`` rows or more are buffered, with the reference's
retention (``trim_before``), dictionary compaction
(``compact_dictionaries``), change tokens (``sync_state``,
``bucket_marks``), which the query cache validates against, and its
on-disk half: ``attach_tier``, ``take_flushable`` / ``confirm_flush``
(the staged chunks and the committed segment swap under the one table
lock, so a reader sees each row exactly once), ``note_tier_evict`` /
``note_tier_publish`` / ``note_tier_compact``, scan units that put the
tier's segments (with their zones and skip indexes) before the RAM
chunks, and the npz ``save`` / ``load`` of a data dir without the
tier. Left out: the reference's per-thread write stripes (the port's
tables have one writer each) and its change listeners (no standing
queries). Values are cast to the column's numpy dtype with ``astype``, so
a value outside the column's width wraps, as the reference's columnar
decode path does.
"""

from __future__ import annotations

import threading
import os
import shutil
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
        # the on-disk tier (store/tiered.py TableTier), attached by the
        # Database when storage is on. Its segments come FIRST in a scan
        # (the oldest rows); _pending_flush holds the merged chunk staged
        # for a tier commit, served from RAM until confirm_flush()
        self.tier = None
        self._pending_flush: list[dict[str, np.ndarray]] = []
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

    def flush(self) -> None:
        """Seal the open buffer into a chunk."""
        with self._lock:
            self._seal_open()

    def _seal_open(self) -> None:
        """Caller holds self._lock."""
        if self._open_rows:
            self._chunks.append(self._merge_open())
            self._open = {name: [] for name in self.columns}
            self._open_rows = 0
            self._open_chunk = None

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
                self._seal_open()

    def _merge_open(self) -> dict[str, np.ndarray]:
        """The open buffer as one chunk; its segments collapse into that
        chunk's arrays, so the next merge copies only later appends."""
        chunk = {}
        for name, segs in self._open.items():
            chunk[name] = segs[0] if len(segs) == 1 else np.concatenate(segs)
            self._open[name] = [chunk[name]]
        return chunk

    # -- on-disk tier (store/tiered.py) --------------------------------------

    def attach_tier(self, tier) -> None:
        """Adopt an on-disk tier (the restart's recovery): its rows join
        the row count and its time span marks the cache buckets, so
        change tokens move as if the rows were loaded."""
        with self._lock:
            self.tier = tier
            tier._columns = self.columns
            tier._fills = self.fills
            self.rows_written += tier.rows
            self.watermark += 1
            tmin, tmax = tier.span()
            if tmin is not None and tmax is not None:
                self._note_span(tmin, tmax)
            elif tier.rows:
                self._wide_mark = self.watermark

    def stage_flush(self, seal: bool = True) -> None:
        """Move every sealed RAM chunk into _pending_flush (still served
        by scans); with ``seal``, the open buffer first."""
        with self._lock:
            if seal:
                self._seal_open()
            if self._chunks:
                self._pending_flush.extend(self._chunks)
                self._chunks = []

    def take_flushable(self, seal: bool = True,
                       stage: bool = True) -> dict | None:
        """Stage every sealed RAM chunk for a tier commit.

        The chunks move into _pending_flush (still served by scans) and
        merge into ONE chunk outside the table lock. Returns the payload
        for TieredStore.commit(), or None when there is nothing to
        flush. One flusher thread (the list is its own between take and
        confirm). ``seal=False`` takes only the chunks that sealed by
        size: the group-commit path for cycles with no acks waiting on
        durability, which leaves the open buffer filling.
        ``stage=False`` takes only what ``stage_flush`` staged before."""
        if stage:
            self.stage_flush(seal)
        with self._lock:
            parts = list(self._pending_flush)
        if not parts:
            return None
        merged = ({name: np.concatenate([ch[name] for ch in parts])
                   for name in self.columns}
                  if len(parts) > 1 else parts[0])
        with self._lock:
            self._pending_flush = [merged]
        return {
            "chunk": merged, "rows": _rows_of(merged),
            "time_col": self._time_col, "dicts": dict(self.dicts),
            "dict_state": {n: d.sync_state()[:2]
                           for n, d in self.dicts.items()},
        }

    def confirm_flush(self, payload: dict) -> None:
        """The tier committed the staged chunk: adopt its segment into
        the scan set and stop serving the RAM copy, both under the one
        lock every scan takes, so a reader sees the rows exactly once
        (rows_written is unchanged). The watermark moves, so change
        tokens cover the flush; the bucket marks stay, since no answer
        changed."""
        with self._lock:
            seg = payload.get("segment")
            if seg is not None and self.tier is not None:
                self.tier._add(seg)
            self._pending_flush = [ch for ch in self._pending_flush
                                   if ch is not payload["chunk"]]
            self.watermark += 1

    def _note_tier_span(self, tmin, tmax) -> None:
        """Caller holds self._lock (watermark already bumped)."""
        if self._bucket_div and tmin is not None and tmax is not None:
            self._note_span(int(tmin), int(tmax))
        else:
            self._wide_mark = self.watermark

    def note_tier_publish(self, rows: int, tmin=None, tmax=None) -> None:
        """Rows another shard published join the count and mark their
        time range, as a flush commit's would."""
        with self._lock:
            self.rows_written += rows
            self.watermark += 1
            self._note_tier_span(tmin, tmax)

    def note_tier_evict(self, rows: int, tmin=None, tmax=None) -> None:
        """Evicted rows leave the count, and their time range is marked,
        so a cached answer over it does not keep serving them."""
        with self._lock:
            self.rows_written -= rows
            self.watermark += 1
            self._note_tier_span(tmin, tmax)

    def note_tier_compact(self) -> None:
        """A compaction rebuilt the segment set: answers are the same,
        but the token moves, so no cached plan pins unlinked files."""
        with self._lock:
            self.watermark += 1
            self._wide_mark = self.watermark

    # -- read path -----------------------------------------------------------

    def _units_locked(self) -> list[tuple]:
        """(chunk, zones, segment) per scan unit, oldest first: the
        tier's segments (their per-column zones and the Segment, whose
        skip indexes the planner reads), then the RAM chunks (None,
        None). Caller holds self._lock: confirm_flush swaps a segment in
        and its staged copy out under it, so no list holds both or
        neither."""
        units = list(self.tier.units()) if self.tier is not None else []
        units.extend((ch, None, None) for ch in self._pending_flush)
        units.extend((ch, None, None) for ch in self._chunks)
        if self._open_rows:
            if self._open_chunk is None:
                self._open_chunk = self._merge_open()
            units.append((self._open_chunk, None, None))
        return units

    def scan_units(self) -> list[tuple]:
        with self._lock:
            return self._units_locked()

    def snapshot(self) -> list[dict[str, np.ndarray]]:
        """The tier's chunks, the sealed chunks and the open buffer's
        rows, oldest first. Readers must not write into the arrays."""
        return [u[0] for u in self.scan_units()]

    def view(self) -> "TableView":
        """The scan units and the dictionaries that decode them, taken
        together under the lock."""
        with self._lock:
            units = self._units_locked()
            return TableView(self.name, self.columns, dict(self.dicts),
                             [u[0] for u in units],
                             [(u[1], u[2]) for u in units])

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
        open buffer, the staged flush and the tier stay: the janitor
        evicts segments). Returns the rows dropped."""
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
        {column: {"before": n, "after": n}}. A table with a tier is left
        as it is: its segments hold the ids as written."""
        if self.tier is not None:
            return {}
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


    # -- persistence (npz per chunk + dictionary json) ------------------------

    def save(self, dirpath: str) -> None:
        """Write every chunk and dictionary into a staging dir and swap it
        into place, keeping the previous dir as .old until the swap is
        done: a kill at any point leaves the old or the new state
        loadable."""
        staging = dirpath + ".staging"
        old = dirpath + ".old"
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        with self._lock:
            chunks = self._units_locked()
            dicts = dict(self.dicts)
        for i, (ch, _z, _s) in enumerate(chunks):
            np.savez_compressed(os.path.join(staging, f"chunk_{i:06d}.npz"),
                                **{k: np.asarray(ch[k]) for k in ch})
        for name, d in dicts.items():
            d.dump(os.path.join(staging, f"dict_{name}.json"))
        with open(os.path.join(staging, "_complete"), "w") as f:
            f.write("1")
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(dirpath):
            os.rename(dirpath, old)
        os.rename(staging, dirpath)
        shutil.rmtree(old, ignore_errors=True)

    @staticmethod
    def recover_dir(dirpath: str) -> str | None:
        """The loadable directory after a possible crash mid-save, or
        None when there is none."""
        old = dirpath + ".old"
        shutil.rmtree(dirpath + ".staging", ignore_errors=True)
        have_dir = os.path.isdir(dirpath)
        # a dir without the marker is complete unless an .old sibling
        # says its swap was cut
        if have_dir and (os.path.exists(os.path.join(dirpath, "_complete"))
                         or not os.path.isdir(old)):
            shutil.rmtree(old, ignore_errors=True)
            return dirpath
        if os.path.isdir(old):
            shutil.rmtree(dirpath, ignore_errors=True)
            os.rename(old, dirpath)
            return dirpath
        return dirpath if have_dir else None

    def load(self, dirpath: str, from_version: int | None = None) -> None:
        """Replace the table's RAM rows by a saved dir's, migrating each
        chunk from ``from_version``; a column the save predates takes
        the fill."""
        from deepflow_tpu_torch.store import migration
        if self.recover_dir(dirpath) is None:
            return
        with self._lock:
            self._open = {name: [] for name in self.columns}
            self._open_rows = 0
            self._open_chunk = None
            self._chunks = []
            for fn in sorted(os.listdir(dirpath)):
                if not (fn.startswith("chunk_") and fn.endswith(".npz")):
                    continue
                with np.load(os.path.join(dirpath, fn)) as z:
                    ch = {k: z[k] for k in z.files}
                if from_version is not None \
                        and from_version < migration.SCHEMA_VERSION:
                    ch = migration.migrate_chunk(self.name, ch, from_version)
                if not ch:
                    continue
                n = _rows_of(ch)
                for name, spec in self.columns.items():
                    if name not in ch:
                        ch[name] = self._column(
                            name, spec, self._fill(name, spec), n)
                self._chunks.append(ch)
            for name in self.dicts:
                p = os.path.join(dirpath, f"dict_{name}.json")
                if os.path.exists(p):
                    self.dicts[name] = Dictionary.load(p, f"{self.name}.{name}")
            self.rows_written = sum(_rows_of(ch) for ch in self._chunks)
            self.watermark += 1
            if self._time_col:
                for ch in self._chunks:
                    self._note_segment(ch.get(self._time_col))
            else:
                self._wide_mark = self.watermark


def _rows_of(ch) -> int:
    """Rows of a chunk without decoding a column: a segment's LazyChunk
    carries ``rows``; a RAM chunk pays one len()."""
    rows = getattr(ch, "rows", None)
    if rows is not None:
        return rows
    return len(next(iter(ch.values()))) if ch else 0


@dataclass(frozen=True)
class TableView:
    """One moment of a ColumnarTable: its chunks, oldest first, and the
    dictionaries that decode them; ``units`` pairs each chunk with its
    pruning metadata, (zones, segment) for a tier chunk and (None, None)
    for a RAM one. Readers must not write into the arrays."""

    name: str
    columns: dict[str, ColumnSpec]
    dicts: dict[str, Dictionary]
    chunks: list[dict[str, np.ndarray]]
    units: list[tuple] | None = None

    def view(self) -> "TableView":
        return self

    def scan_units(self) -> list[tuple]:
        """(chunk, zones, segment) per chunk, as ColumnarTable's."""
        meta = self.units or [(None, None)] * len(self.chunks)
        return [(ch, z, s) for ch, (z, s) in zip(self.chunks, meta)]

    def __len__(self) -> int:
        return sum(_rows_of(ch) for ch in self.chunks)
