"""Tiered segment store: the on-disk tier under every ColumnarTable.

Own copy of ``deepflow_tpu/store/tiered.py``: ``TableTier`` and
``TieredStore`` with the commit protocol below, ``recover`` (torn
unlisted segments deleted, an unreadable manifest scavenged and
counted), compaction into sorted v2 runs (``DF_COMPACT_CRASH``), TTL and
size eviction, ``persist_ack_floors``, ``migrate_v1_remaining``,
``snapshot`` and the quarantine bookkeeping. It writes the reference's
manifest, so either package recovers the other's directory. Nothing is
left out; the scrubber (``store/scrub.py``) drives the quarantine half.

One TieredStore per Database owns a directory of per-table segment
files plus ONE manifest — the single atomic commit point (tmp + fsync +
rename, the ack_state.json pattern) for everything durable:

    segments/
      MANIFEST.json                     <- the commit point
      <table.name>/
        seg_00000001.seg                <- store/segment.py format
        dict_<col>.json                 <- dictionary dumps (append-only)

Commit protocol (the order IS the crash-safety argument):

  1. dictionary dumps for changed dictionaries (append-only: a dump taken
     after a chunk was encoded is a superset of every id the chunk uses)
  2. segment files written + fsync'd
  3. MANIFEST.json replaced atomically (lists the new segments AND the
     per-agent ack floors that become releasable once the data is down)
  4. only now does ColumnarTable.confirm_flush swap each table's staged
     RAM copy for the tier's mmap view — under one table lock, so a
     concurrent snapshot sees the rows exactly once — and acks release

A SIGKILL at any point leaves either the old manifest (new segment files
are unlisted -> deleted as torn tail on recovery, their frames unacked ->
retransmitted) or the new one (segments + covering dictionaries + floors
all present). Ack floors living INSIDE the manifest is what closes the
two-file commit race: a frame is acked only if the same rename that
persisted its rows persisted its floor.

Eviction is whole-segment (CK partition drops, not row deletes), manifest
first, unlink after — and every dropped row is ledgered as
``segment_evict`` by the caller (janitor), never silent.
"""

from __future__ import annotations

import json
import logging
import os
import threading

import numpy as np

from deepflow_tpu_torch.store.segment import Segment, SegmentError, write_segment

log = logging.getLogger("df.tiered")

MANIFEST = "MANIFEST.json"
_FORMAT_VERSION = 1
# flush generations between zlib probe re-runs (TableTier.codec_hints)
_CODEC_REPROBE_GENS = 32
# compaction defaults: merge sealed segments into 1-hour sorted runs,
# splitting a run into pieces of at most this many rows
_PARTITION_NS = 3_600_000_000_000
_TARGET_ROWS = 1 << 20


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TableTier:
    """One table's slice of the tier: its live Segment list + counters.

    Attached to a ColumnarTable (table.tier); ``chunks()`` is called from
    inside snapshot() so it must stay cheap — the column-map list is
    cached and only rebuilt when the segment set changes."""

    def __init__(self, name: str, dirpath: str, next_id: int = 1) -> None:
        self.name = name
        self.dir = dirpath
        self.next_id = next_id
        self._lock = threading.Lock()
        self._segments: list[Segment] = []
        # committed to the manifest but not yet adopted into scans: the
        # table still serves these rows from its _pending_flush chunk
        # until confirm_flush() swaps tier view and RAM copy atomically
        self._staged: list[Segment] = []
        self._chunk_cache: list[dict] | None = None
        # zone maps aligned 1:1 with _chunk_cache (same segment order) so
        # the scan planner can pair every chunk with its pruning bounds
        self._zone_cache: list[dict] | None = None
        # live Segment objects aligned with the two caches above (the
        # planner consults their bloom/bitmap skip indexes)
        self._seg_cache: list[Segment] | None = None
        # set at attach time so chunks() can backfill additively-new
        # columns exactly like ColumnarTable.load() does
        self._columns = None
        self._fills: dict = {}
        # (gen, version) of the last dictionary dump per column — dumps
        # are skipped when nothing changed
        self._dict_dumped: dict[str, tuple[int, int]] = {}
        # zlib worth-compressing verdicts memoized per column; cleared
        # every _CODEC_REPROBE_GENS flush generations so a column whose
        # entropy drifts gets re-probed (see segment.write_segment)
        self._codec_memo: dict[str, bool] = {}
        self._codec_memo_gen: int | None = None
        # chosen-codec tally across every block this tier wrote (flush
        # AND compaction) — surfaced in the tier snapshot so ops can see
        # what choose_codec actually picked
        self.codec_counts: dict[str, int] = {}
        # fn -> {reason, rows, bytes, tmin, tmax}: segments pulled from
        # service after failing checksum verification. The manifest
        # vouches for these names (recovery must neither serve nor
        # torn-tail-delete them — the file is the repair/forensics
        # evidence) but they never join _segments until repaired.
        # Mutated only under TieredStore._lock, like next_id.
        self.quarantined: dict[str, dict] = {}

    # -- read side ----------------------------------------------------------

    def segments(self) -> list[Segment]:
        with self._lock:
            return list(self._segments)

    def _fill_caches(self) -> None:
        live = [s for s in self._segments if s.rows]
        # LAZY chunks: a column block decodes on first touch, so a
        # segment the planner prunes (zones/bloom) never pays a decode
        self._chunk_cache = [s.chunk(self._columns, self._fills)
                             for s in live]
        self._zone_cache = [s.zones for s in live]
        self._seg_cache = live

    def chunks(self) -> list[dict]:
        with self._lock:
            if self._chunk_cache is None:
                self._fill_caches()
            return list(self._chunk_cache)

    def units(self) -> list[tuple[dict, dict, Segment]]:
        """(chunk, zones, segment) triples for the scan planner — zones
        is the segment's per-column (zmin, zmax) map (possibly just the
        time column for pre-zone-map segments); the Segment itself rides
        along so the planner can consult its v2 skip indexes
        (maybe_contains / str_zone) before touching any column."""
        with self._lock:
            if self._chunk_cache is None:
                self._fill_caches()
            return list(zip(self._chunk_cache, self._zone_cache,
                            self._seg_cache))

    def zoned_count(self) -> int:
        """Segments carrying per-column zone maps (vs time-only/none)."""
        with self._lock:
            return sum(1 for s in self._segments
                       if any("zmin" in c for c in s._cols.values()))

    @property
    def rows(self) -> int:
        with self._lock:
            return sum(s.rows for s in self._segments)

    @property
    def bytes(self) -> int:
        with self._lock:
            return sum(s.nbytes for s in self._segments)

    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments)

    def span(self) -> tuple[int | None, int | None]:
        with self._lock:
            tmins = [s.tmin for s in self._segments if s.tmin is not None]
            tmaxs = [s.tmax for s in self._segments if s.tmax is not None]
        return (min(tmins) if tmins else None,
                max(tmaxs) if tmaxs else None)

    def manifest_names(self) -> list[str]:
        """Segment filenames the manifest must vouch for: adopted AND
        staged — a staged segment's file is already fsync'd and its rows
        are only acked because this list persists them."""
        with self._lock:
            return [os.path.basename(s.path)
                    for s in self._segments + self._staged]

    # -- mutation (TieredStore holds its own lock around these) -------------

    def _stage(self, seg: Segment) -> None:
        with self._lock:
            self._staged.append(seg)

    def _add(self, seg: Segment) -> None:
        with self._lock:
            self._staged = [s for s in self._staged if s is not seg]
            self._segments.append(seg)
            self._chunk_cache = None
            self._zone_cache = None

    def _remove(self, victims: list[Segment]) -> None:
        ids = {id(s) for s in victims}
        with self._lock:
            self._segments = [s for s in self._segments
                              if id(s) not in ids]
            self._chunk_cache = None
            self._zone_cache = None

    def codec_hints(self, gen: int) -> dict[str, bool]:
        """The per-table compress/skip memo write_segment consults.
        Cleared every _CODEC_REPROBE_GENS generations: the 8 KiB probe
        runs once per column per memo generation, not once per flush."""
        with self._lock:
            if (self._codec_memo_gen is None
                    or gen - self._codec_memo_gen >= _CODEC_REPROBE_GENS):
                self._codec_memo.clear()
                self._codec_memo_gen = gen
            return self._codec_memo

    def persist_dicts(self, dicts: dict) -> int:
        """Dump changed dictionaries (atomic per file). MUST run before
        the manifest commit that lists segments encoded against them."""
        n = 0
        for col, d in dicts.items():
            state = (d.gen, d.version)
            if self._dict_dumped.get(col) == state:
                continue
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"dict_{col}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            d.dump(tmp)
            with open(tmp, "rb+") as f:
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._dict_dumped[col] = state
            n += 1
        if n:
            _fsync_dir(self.dir)
        return n

    def dict_path(self, col: str) -> str:
        return os.path.join(self.dir, f"dict_{col}.json")


class TieredStore:
    """Database-level tier: per-table TableTiers + the atomic manifest."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self._tables: dict[str, TableTier] = {}
        # True once any commit has run with the in-memory (npz) tables
        # already imported — from then on the npz chunk dirs are dead
        # weight and are NOT loaded (a row lives in exactly one tier).
        self.npz_imported = False
        self.ack_floors: dict[int, int] = {}
        # per agent, the committed seqs above its floor (a gap below
        # them); the reference persists the floors only
        self.ack_parked: dict[int, list[int]] = {}
        self.flush_gen = 0
        self.evict_gen = 0
        # one compaction run id per merged group; persisted in the
        # manifest so run ids stay unique across restarts
        self.compact_gen = 0
        self.stats = {"commits": 0, "segments_written": 0,
                      "rows_flushed": 0, "torn_dropped": 0,
                      "segments_evicted": 0, "rows_evicted": 0,
                      "bytes_evicted": 0,
                      "runs_built": 0, "segments_replaced": 0,
                      "compact_rows": 0, "bytes_before": 0,
                      "bytes_after": 0, "segments_migrated": 0,
                      "segments_quarantined": 0, "rows_quarantined": 0,
                      "segments_repaired": 0,
                      "manifest_corrupt": 0, "segments_scavenged": 0}
        # fault injection (chaos.ChaosInjector or None): consulted at
        # the top of every segment-writing commit so scrub-check can
        # exercise the ENOSPC degradation path in-process
        self.chaos = None
        # observed write-cost of each codec choice (deferred import:
        # query.costmodel must not be imported at store import time —
        # query/__init__ imports the engine which imports the store)
        self._codec_cost = None

    def tier(self, name: str) -> TableTier:
        with self._lock:
            tt = self._tables.get(name)
            if tt is None:
                tt = self._tables[name] = TableTier(
                    name, os.path.join(self.root, name))
            return tt

    def tables(self) -> dict[str, TableTier]:
        with self._lock:
            return dict(self._tables)

    # -- manifest ------------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def _write_manifest(self) -> None:
        """Atomic replace; caller holds self._lock."""
        doc = {
            "version": _FORMAT_VERSION,
            "npz_imported": self.npz_imported,
            "flush_gen": self.flush_gen,
            "evict_gen": self.evict_gen,
            "compact_gen": self.compact_gen,
            "ack_floors": {str(k): v for k, v in self.ack_floors.items()},
            **({"ack_parked": {str(k): v for k, v in self.ack_parked.items()}}
               if self.ack_parked else {}),
            "tables": {
                name: {"next_id": tt.next_id,
                       "segments": tt.manifest_names(),
                       **({"quarantined": tt.quarantined}
                          if tt.quarantined else {})}
                for name, tt in self._tables.items()},
        }
        path = self._manifest_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.root)

    # -- recovery ------------------------------------------------------------

    def recover(self) -> None:
        """Load the manifest, open every listed segment, and delete
        anything on disk the manifest does not vouch for (torn tail from
        a crash mid-commit). Unreadable listed segments are dropped too
        — recovery always converges to a state where manifest == disk."""
        with self._lock:
            path = self._manifest_path()
            doc = {}
            scavenge = False
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    # corrupt manifest (torn JSON, bad sector): SCAVENGE
                    # instead of starting empty — adopt every readable
                    # .seg file on disk. Deliberate tradeoff: ack floors
                    # restart from ack_state.json alone, so the worst
                    # case is bounded duplicates (the last uncommitted
                    # flush retransmits), never total data loss.
                    log.warning("tier manifest unreadable; scavenging "
                                "readable segments", exc_info=True)
                    self.stats["manifest_corrupt"] += 1
                    doc = {}
                    scavenge = True
            self.npz_imported = bool(doc.get("npz_imported", False))
            self.flush_gen = int(doc.get("flush_gen", 0))
            self.evict_gen = int(doc.get("evict_gen", 0))
            self.compact_gen = int(doc.get("compact_gen", 0))
            self.ack_floors = {int(k): int(v) for k, v in
                               doc.get("ack_floors", {}).items()}
            self.ack_parked = {int(k): [int(s) for s in v] for k, v in
                               doc.get("ack_parked", {}).items()}
            dropped = False
            for name, ent in doc.get("tables", {}).items():
                tt = self.tier(name)
                tt.next_id = int(ent.get("next_id", 1))
                q = ent.get("quarantined")
                if isinstance(q, dict):
                    # quarantined files stay on disk awaiting repair but
                    # are NEVER opened or served
                    tt.quarantined = {str(fn): dict(info)
                                      for fn, info in q.items()}
                for fn in ent.get("segments", []):
                    if fn in tt.quarantined:
                        continue
                    p = os.path.join(tt.dir, fn)
                    try:
                        tt._add(Segment.open(p))
                    except SegmentError as e:
                        log.warning("dropping torn segment: %s", e)
                        self.stats["torn_dropped"] += 1
                        dropped = True
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
            if scavenge:
                dropped |= self._scavenge()
            # torn tail: segment files the manifest never committed
            # (quarantined names are vouched for — they are evidence,
            # not tail)
            listed = {name: {os.path.basename(s.path)
                             for s in tt.segments()}
                      | set(tt.quarantined)
                      for name, tt in self._tables.items()}
            for entry in os.listdir(self.root):
                tdir = os.path.join(self.root, entry)
                if not os.path.isdir(tdir):
                    continue
                keep = listed.get(entry, set())
                for fn in os.listdir(tdir):
                    if fn.endswith(".seg") and fn not in keep \
                            or ".tmp." in fn:
                        log.warning("deleting uncommitted file %s/%s",
                                    entry, fn)
                        self.stats["torn_dropped"] += 1
                        try:
                            os.unlink(os.path.join(tdir, fn))
                        except OSError:
                            pass
            if dropped or scavenge:
                self._write_manifest()

    def _scavenge(self) -> bool:
        """Corrupt-manifest recovery: adopt every readable .seg file on
        disk (Segment.open's footer validation filters torn ones) and
        rebuild next_id past the highest adopted file. Caller holds
        self._lock and rewrites the manifest afterwards."""
        adopted = False
        try:
            entries = os.listdir(self.root)
        except OSError:
            return False
        for entry in sorted(entries):
            tdir = os.path.join(self.root, entry)
            if not os.path.isdir(tdir):
                continue
            tt = self.tier(entry)
            max_id = 0
            for fn in sorted(os.listdir(tdir)):
                if not fn.endswith(".seg") or ".tmp." in fn:
                    continue
                p = os.path.join(tdir, fn)
                try:
                    tt._add(Segment.open(p))
                except SegmentError as e:
                    log.warning("scavenge: dropping torn segment: %s", e)
                    self.stats["torn_dropped"] += 1
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                    continue
                adopted = True
                self.stats["segments_scavenged"] += 1
                try:
                    max_id = max(max_id,
                                 int(fn[len("seg_"):-len(".seg")], 10))
                except ValueError:
                    pass
            tt.next_id = max(tt.next_id, max_id + 1)
        return adopted

    def validate_dicts(self, name: str, dicts: dict) -> list[Segment]:
        """Drop segments whose recorded dict generations exceed what the
        loaded dictionaries can decode (a dump went missing). Returns the
        dropped segments; the caller re-commits the manifest via the next
        flush. Normal operation never trips this — dumps are committed
        before the segments that need them."""
        bad: list[Segment] = []
        tt = self.tier(name)
        for seg in tt.segments():
            for col, gens in seg.dict_gens.items():
                d = dicts.get(col)
                dlen = gens[1] if len(gens) > 1 else 0
                if d is not None and len(d) < dlen:
                    bad.append(seg)
                    break
        if bad:
            with self._lock:
                tt._remove(bad)
                self.stats["torn_dropped"] += len(bad)
                self._write_manifest()
            for seg in bad:
                log.warning("dropping segment with undecodable ids: %r",
                            seg)
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
        return bad

    # -- quarantine + repair (data-integrity layer) ---------------------------

    def quarantine(self, name: str, seg: Segment, reason: str) -> dict:
        """Pull a corrupt segment from service through the ONE manifest
        commit point: after the rename it is never served again — by
        this process, by recovery, or by a restart. The FILE stays on
        disk as repair/forensics evidence (recovery's torn-tail sweep
        vouches for quarantined names). Returns what was quarantined
        (the caller owns the ``segment_quarantine`` ledger entry and the
        table watermark/rows bookkeeping, eviction-style)."""
        fn = os.path.basename(seg.path)
        with self._lock:
            tt = self.tier(name)
            victims = [s for s in tt.segments()
                       if os.path.basename(s.path) == fn]
            if not victims and fn in tt.quarantined:
                return {"file": fn, "rows": 0, "already": True}
            tt._remove(victims)
            info = {"reason": str(reason)[:200], "rows": seg.rows,
                    "bytes": seg.nbytes, "tmin": seg.tmin,
                    "tmax": seg.tmax}
            tt.quarantined[fn] = info
            self._write_manifest()
            self.stats["segments_quarantined"] += 1
            self.stats["rows_quarantined"] += seg.rows
            log.warning("quarantined %s/%s (%s): %d rows out of service",
                        name, fn, reason, seg.rows)
            return {"file": fn, "rows": seg.rows, "bytes": seg.nbytes,
                    "tmin": seg.tmin, "tmax": seg.tmax, "already": False}

    def unquarantine(self, name: str, seg: Segment) -> dict | None:
        """Swap a repaired, RE-VERIFIED segment back into service (one
        manifest commit). ``seg`` must be a freshly opened Segment over
        the repaired file at its original path."""
        fn = os.path.basename(seg.path)
        with self._lock:
            tt = self.tier(name)
            info = tt.quarantined.pop(fn, None)
            if info is None:
                return None
            tt._add(seg)
            self._write_manifest()
            self.stats["segments_repaired"] += 1
            log.info("repaired %s/%s: %d rows back in service",
                     name, fn, seg.rows)
            return info

    def drop_quarantined(self, name: str, fn: str) -> dict | None:
        """Give up on a quarantined file (no healthy copy anywhere):
        manifest first, then unlink — the rows are lost and the CALLER
        must ledger them dropped."""
        with self._lock:
            tt = self._tables.get(name)
            info = tt.quarantined.pop(fn, None) if tt else None
            if info is None:
                return None
            self._write_manifest()
            try:
                os.unlink(os.path.join(tt.dir, fn))
            except OSError:
                pass
            return info

    def quarantined(self) -> dict[str, dict[str, dict]]:
        """{table -> {fn -> info}} of everything awaiting repair."""
        with self._lock:
            return {name: dict(tt.quarantined)
                    for name, tt in self._tables.items()
                    if tt.quarantined}

    def quarantine_info(self, name: str) -> dict | None:
        """Degraded-query annotation input: what this table is currently
        missing (None when whole). Same contract as federation's
        missing_shards — queries in the repair gap say so, never
        silently return short."""
        with self._lock:
            tt = self._tables.get(name)
            if tt is None or not tt.quarantined:
                return None
            return {"segments": len(tt.quarantined),
                    "rows": sum(int(i.get("rows", 0) or 0)
                                for i in tt.quarantined.values()),
                    "files": sorted(tt.quarantined)}

    # -- commit --------------------------------------------------------------

    def commit(self, writes: dict[str, dict],
               ack_floors: dict[int, int] | None = None,
               mark_imported: bool = False,
               compress: bool = True,
               ack_parked: dict[int, list[int]] | None = None) -> int:
        """One atomic flush commit. ``writes`` maps table name ->
        payload from ColumnarTable.take_flushable():
        {chunk, rows, time_col, dicts, dict_state}. Returns rows
        committed. See the module docstring for the ordering argument.

        mark_imported: only Database.flush_to_tier passes True — it has
        drained EVERY table's RAM chunks into ``writes``, so from this
        commit on the npz chunk dirs hold nothing the tier doesn't."""
        with self._lock:
            if writes and self.chaos is not None:
                # disk-fault injection point: raises OSError(ENOSPC).
                # The flusher catches it, requeues the gate entries and
                # backs off — acks stay withheld, agents retransmit.
                self.chaos.on_tier_write()
            rows = 0
            nseg = 0
            dirty_dirs: set[str] = set()
            for name, payload in writes.items():
                tt = self.tier(name)
                tt.persist_dicts(payload.get("dicts") or {})
                os.makedirs(tt.dir, exist_ok=True)
                fn = f"seg_{tt.next_id:08d}.seg"
                tt.next_id += 1
                p = os.path.join(tt.dir, fn)
                write_segment(p, payload["chunk"],
                              time_col=payload.get("time_col"),
                              dict_gens=payload.get("dict_state"),
                              compress=compress,
                              codec_hints=tt.codec_hints(self.flush_gen),
                              codec_counts=tt.codec_counts,
                              observe=self._codec_observe)
                dirty_dirs.add(tt.dir)
                seg = Segment.open(p)
                tt._stage(seg)
                # handed back so ColumnarTable.confirm_flush can swap
                # the tier view for the RAM copy under ONE table lock
                payload["segment"] = seg
                nseg += 1
                rows += payload["rows"]
            for d in dirty_dirs:
                _fsync_dir(d)
            if ack_floors:
                for a, s in ack_floors.items():
                    if s > self.ack_floors.get(a, -1):
                        self.ack_floors[a] = s
                # the caller's parked seqs are its whole current view
                self.ack_parked = {
                    a: [s for s in seqs if s > self.ack_floors.get(a, -1)]
                    for a, seqs in (ack_parked or {}).items()}
                self.ack_parked = {a: v for a, v in self.ack_parked.items()
                                   if v}
            self.flush_gen += 1
            if mark_imported:
                self.npz_imported = True
            # the manifest lists the staged segments (manifest_names):
            # this rename is the durability point; scan visibility flips
            # per table at confirm_flush
            self._write_manifest()
            self.stats["commits"] += 1
            self.stats["segments_written"] += nseg
            self.stats["rows_flushed"] += rows
            return rows

    def _codec_observe(self, codec: str, n: int, ns: float) -> None:
        """Feed every codec choice's measured encode cost into a learned
        cost model (query/costmodel.py, imported lazily to keep the
        store importable without the query package)."""
        m = self._codec_cost
        if m is None:
            from deepflow_tpu_torch.query.costmodel import KernelCostModel
            m = self._codec_cost = KernelCostModel(
                ("const", "for", "delta", "dictrank", "zlib", "raw"))
        m.observe(codec, n, ns)

    # -- compaction (segment format v2) --------------------------------------

    def _compact_groups(self, tt: TableTier,
                        partition_ns: int, min_merge: int) -> list[list]:
        """Partition the table's sealed segments into time buckets and
        return the groups worth compacting: >= min_merge segments in one
        bucket, or any bucket still holding a format-v1 segment
        (migrate-on-compact — a lone v1 file gets rewritten as a v2 run
        so ``migrate_v1_remaining`` drains to zero)."""
        buckets: dict[object, list] = {}
        for s in tt.segments():
            if not s.rows:
                continue
            key = None if s.tmin is None else int(s.tmin) // partition_ns
            buckets.setdefault(key, []).append(s)
        out = []
        for key, group in sorted(buckets.items(),
                                 key=lambda kv: (kv[0] is None,
                                                 kv[0] or 0)):
            if any(s.fmt < 2 for s in group):
                out.append(group)
                continue
            runs = {s.run for s in group}
            if None not in runs and len(runs) == 1:
                # the bucket is already exactly one compacted run
                # (possibly split into pieces) — recompacting it would
                # churn bytes forever without changing anything
                continue
            if len(group) >= min_merge:
                out.append(group)
        return out

    @staticmethod
    def _build_run(victims: list[Segment], columns, fills,
                   target_rows: int) -> dict:
        """Merge a group's rows into ONE time-sorted chunk, split into
        <= target_rows pieces. Pure read work — runs OUTSIDE the store
        lock (and on the shared scan pool when one is available)."""
        time_col = next((s.time_col for s in victims
                         if s.time_col is not None), None)
        chunks = [s.chunk(columns, fills) for s in victims]
        names: dict[str, np.dtype] = {}
        for ch in chunks:
            for name in ch:
                if name not in names:
                    names[name] = np.asarray(ch[name]).dtype
        merged: dict[str, np.ndarray] = {}
        for name, dt in names.items():
            parts = [np.asarray(ch[name]) if name in ch
                     else np.zeros(s.rows, dtype=dt)
                     for s, ch in zip(victims, chunks)]
            merged[name] = np.concatenate(parts) if parts \
                else np.empty(0, dtype=dt)
        rows = len(next(iter(merged.values()))) if merged else 0
        if time_col is not None and time_col in merged and rows:
            t = merged[time_col]
            if not bool(np.all(t[:-1] <= t[1:])):
                # stable: equal-time rows keep their pre-compaction
                # relative order, so LAST-by-max-time answers hold
                order = np.argsort(t, kind="stable")
                merged = {k: np.ascontiguousarray(v[order])
                          for k, v in merged.items()}
        dict_gens: dict[str, tuple] = {}
        for s in victims:
            for col, g in s.dict_gens.items():
                cur = dict_gens.get(col)
                dict_gens[col] = tuple(g) if cur is None else \
                    tuple(max(a, b) for a, b in zip(cur, g))
        pieces = [{k: v[lo:lo + target_rows] for k, v in merged.items()}
                  for lo in range(0, max(rows, 1), target_rows)]
        return {"victims": victims, "pieces": pieces, "rows": rows,
                "time_col": time_col, "dict_gens": dict_gens,
                "bytes_before": sum(s.nbytes for s in victims),
                "migrated": sum(1 for s in victims if s.fmt < 2)}

    def compact(self, name: str, dicts: dict | None = None, *,
                partition_ns: int = _PARTITION_NS, min_merge: int = 2,
                target_rows: int = _TARGET_ROWS, pool=None) -> dict:
        """Merge one table's small sealed segments into sorted,
        time-partitioned format-v2 runs behind the ONE manifest commit
        point. Crash-safe by the same argument as commit()/evict():

          build     new run files written + fsync'd, NOT in the manifest
                    (crash here: recovery deletes them as torn tail, the
                    old segments still serve every row)
          commit    MANIFEST.json rename lists the runs and drops the
                    victims (crash after: recovery deletes the victim
                    FILES as unlisted; every row already lives in a run)
          unlink    victim files removed

        No row exists in zero or two live manifests at any crash point,
        which is what the restart-mid-compaction chaos arm proves.
        ``dicts`` (the table's live dictionaries) enables the dict-order
        rewrite + zstr/bloom string indexes; merging stays correct
        without them. Build work runs on ``pool`` (the shared scan pool)
        when given. Returns a counters dict; the CALLER owns the
        table watermark bump and the hop-ledger entry for replaced rows.
        """
        tt = self.tables().get(name)
        out = {"groups": 0, "runs_built": 0, "segments_replaced": 0,
               "rows": 0, "bytes_before": 0, "bytes_after": 0,
               "segments_migrated": 0, "new_segments": []}
        if tt is None:
            return out
        groups = self._compact_groups(tt, partition_ns, min_merge)
        if not groups:
            return out
        crash = os.environ.get("DF_COMPACT_CRASH", "")
        build = lambda g: self._build_run(g, tt._columns, tt._fills,
                                          target_rows)
        if pool is None:
            try:
                from deepflow_tpu_torch.query.pool import get_pool
                pool = get_pool()
            except ImportError:  # store used without the query package
                pool = None
        built = pool.map(build, groups) if pool is not None \
            else [build(g) for g in groups]
        for plan in built:
            victims = plan["victims"]
            with self._lock:
                live = {id(s) for s in tt.segments()}
                if not all(id(v) in live for v in victims):
                    # a victim was evicted while we were building —
                    # drop this group, its rows are gone on purpose
                    continue
                self.compact_gen += 1
                run_id = self.compact_gen
                os.makedirs(tt.dir, exist_ok=True)
                new_segs = []
                for piece in plan["pieces"]:
                    fn = f"seg_{tt.next_id:08d}.seg"
                    tt.next_id += 1
                    p = os.path.join(tt.dir, fn)
                    write_segment(
                        p, piece, time_col=plan["time_col"],
                        dict_gens=plan["dict_gens"], fmt=2, level=1,
                        run=run_id, sorted_by=plan["time_col"],
                        dicts=dicts,
                        codec_hints=tt.codec_hints(self.flush_gen),
                        codec_counts=tt.codec_counts,
                        observe=self._codec_observe)
                    new_segs.append(Segment.open(p))
                _fsync_dir(tt.dir)
                if crash == "after_stage":
                    os._exit(43)
                tt._remove(victims)
                for s in new_segs:
                    tt._add(s)
                self._write_manifest()
                if crash == "after_commit":
                    os._exit(43)
                for v in victims:
                    try:
                        os.unlink(v.path)
                    except OSError:
                        pass
                bytes_after = sum(s.nbytes for s in new_segs)
                out["groups"] += 1
                out["runs_built"] += 1
                out["segments_replaced"] += len(victims)
                out["rows"] += plan["rows"]
                out["bytes_before"] += plan["bytes_before"]
                out["bytes_after"] += bytes_after
                out["segments_migrated"] += plan["migrated"]
                out["new_segments"].extend(new_segs)
                self.stats["runs_built"] += 1
                self.stats["segments_replaced"] += len(victims)
                self.stats["compact_rows"] += plan["rows"]
                self.stats["bytes_before"] += plan["bytes_before"]
                self.stats["bytes_after"] += bytes_after
                self.stats["segments_migrated"] += plan["migrated"]
        return out

    # -- eviction ------------------------------------------------------------

    def evict(self, name: str, cutoff: int | None = None,
              max_bytes: int | None = None) -> dict:
        """Whole-segment TTL + size-budget eviction for one table.
        Segments with tmax < cutoff go first; then oldest-first until the
        table fits max_bytes. Manifest commits BEFORE the unlink (a crash
        in between leaves unlisted files that recovery deletes).

        Returns {rows, segments, bytes, tmin, tmax} of what was dropped —
        the caller owns the ``segment_evict`` ledger entry and the table
        watermark/rows bookkeeping."""
        with self._lock:
            tt = self._tables.get(name)
            if tt is None:
                return {"rows": 0, "segments": 0, "bytes": 0,
                        "tmin": None, "tmax": None}
            segs = tt.segments()
            victims = []
            if cutoff is not None:
                victims = [s for s in segs
                           if s.tmax is not None and s.tmax < cutoff]
            if max_bytes is not None:
                keep = [s for s in segs if s not in victims]
                total = sum(s.nbytes for s in keep)
                # oldest first = commit order (ids are monotonic)
                for s in keep:
                    if total <= max_bytes:
                        break
                    victims.append(s)
                    total -= s.nbytes
            if not victims:
                return {"rows": 0, "segments": 0, "bytes": 0,
                        "tmin": None, "tmax": None}
            tt._remove(victims)
            self.evict_gen += 1
            self._write_manifest()
            for s in victims:
                try:
                    os.unlink(s.path)
                except OSError:
                    pass
            out = {
                "rows": sum(s.rows for s in victims),
                "segments": len(victims),
                "bytes": sum(s.nbytes for s in victims),
                "tmin": min((s.tmin for s in victims
                             if s.tmin is not None), default=None),
                "tmax": max((s.tmax for s in victims
                             if s.tmax is not None), default=None),
            }
            self.stats["segments_evicted"] += out["segments"]
            self.stats["rows_evicted"] += out["rows"]
            self.stats["bytes_evicted"] += out["bytes"]
            return out

    def persist_ack_floors(self, floors: dict[int, int]) -> None:
        """Commit ack floors with no segment writes (final drain)."""
        self.commit({}, ack_floors=floors)

    def migrate_v1_remaining(self) -> int:
        """Format-v1 segments still live — the migrate-on-compact drain
        gauge (zero once every byte on disk is format v2)."""
        return sum(1 for tt in self.tables().values()
                   for s in tt.segments() if s.fmt < 2)

    def snapshot(self) -> dict:
        """Ops/health view: per-table tier stats + generations."""
        with self._lock:
            tables = {}
            for name, tt in self._tables.items():
                tmin, tmax = tt.span()
                segs = tt.segments()
                tables[name] = {"segments": tt.segment_count(),
                                "zoned_segments": tt.zoned_count(),
                                "rows": tt.rows, "bytes": tt.bytes,
                                "tmin": tmin, "tmax": tmax,
                                "v1_segments": sum(1 for s in segs
                                                   if s.fmt < 2),
                                "runs": len({s.run for s in segs
                                             if s.run is not None}),
                                "codec_counts": dict(tt.codec_counts)}
                if tt.quarantined:
                    tables[name]["quarantined_segments"] = \
                        len(tt.quarantined)
                    tables[name]["quarantined_rows"] = sum(
                        int(i.get("rows", 0) or 0)
                        for i in tt.quarantined.values())
            out = {"root": self.root, "flush_gen": self.flush_gen,
                   "evict_gen": self.evict_gen,
                   "compact_gen": self.compact_gen,
                   "npz_imported": self.npz_imported,
                   "stats": dict(self.stats), "tables": tables,
                   "migrate_v1_remaining": sum(t["v1_segments"]
                                               for t in tables.values())}
            if self._codec_cost is not None:
                out["codec_cost"] = self._codec_cost.snapshot()
            return out
