"""The database: the named tables of schema.py, in RAM or over a tier.

Own copy of ``deepflow_tpu/store/db.py::Database``. With
``storage=True`` and a ``data_dir`` every table gets an on-disk tier
under ``<data_dir>/segments/`` (``store/tiered.py``): ``flush_to_tier``
moves the sealed chunks into mmap'd columnar segments in one atomic
commit, ``compact_tier`` merges them into sorted v2 runs, and a restart
adopts them (``_attach_tiers``). Without storage, ``save`` / ``load``
snapshot the tables into ``data_dir`` as npz chunks at a clean stop, as
the reference's do. A row lives in exactly one of the two, so a crash
never loads it twice.
"""

from __future__ import annotations

import logging
import os
import threading

from deepflow_tpu_torch.store import migration, schema
from deepflow_tpu_torch.store.dictionary import Dictionary
from deepflow_tpu_torch.store.table import ColumnarTable, ColumnSpec

log = logging.getLogger("df.db")


class Database:
    """A set of named ColumnarTables, one per schema table."""

    def __init__(self, data_dir: str | None = None,
                 chunk_rows: int = 1 << 16, shard_id: int = 0,
                 storage: bool = False) -> None:
        self.data_dir = data_dir
        self.chunk_rows = chunk_rows
        # every ingested row with a shard_id column is stamped with the
        # receiving server's shard identity (0 = standalone)
        self.shard_id = shard_id
        self._tables: dict[str, ColumnarTable] = {}
        self._lock = threading.Lock()
        self.tier_store = None
        # a storage-backed database adopts its recovered segments at the
        # first table access, even if the caller never ran load()
        self._loaded = False
        self._load_lock = threading.Lock()
        if storage and data_dir:
            from deepflow_tpu_torch.store.tiered import TieredStore
            self.tier_store = TieredStore(os.path.join(data_dir,
                                                       "segments"))
            self.tier_store.recover()
        for name, cols in schema.TABLES.items():
            self.create_table(name, cols)

    def create_table(self, name: str,
                     columns: list[ColumnSpec]) -> ColumnarTable:
        with self._lock:
            if name in self._tables:
                return self._tables[name]
            t = ColumnarTable(name, columns, self.chunk_rows)
            if self.shard_id and "shard_id" in t.columns:
                t.fills["shard_id"] = self.shard_id
            self._tables[name] = t
            return t

    def _ensure_loaded(self) -> None:
        """The implicit load() of a storage-backed database (load takes
        table locks, so it runs under a lock of its own)."""
        if self._loaded or self.tier_store is None:
            return
        with self._load_lock:
            if not self._loaded:
                self.load()

    def table(self, name: str) -> ColumnarTable:
        self._ensure_loaded()
        try:
            return self._tables[name]
        except KeyError:
            raise KeyError(
                f"no such table {name!r}; known: {sorted(self._tables)}")

    def tables(self) -> list[str]:
        self._ensure_loaded()
        return sorted(self._tables)

    def flush(self) -> None:
        """Seal every table's open buffer."""
        for t in self._tables.values():
            t.flush()

    # -- on-disk tier --------------------------------------------------------

    def stage_flush(self, seal: bool = True) -> None:
        """Stage every table's sealed chunks (and with ``seal`` its open
        buffer) for the next ``flush_to_tier(stage=False)``."""
        for t in list(self._tables.values()):
            t.stage_flush(seal)

    def flush_to_tier(self, ack_floors: dict[int, int] | None = None,
                      seal: bool = True, compress: bool = True,
                      stage: bool = True,
                      ack_parked: dict[int, list[int]] | None = None) -> int:
        """Drain every table's sealed RAM chunks into one atomic tier
        commit; returns the rows committed. ``ack_floors`` (and the seqs
        ``ack_parked`` above them) ride the same manifest rename that
        persists the rows. ``seal=False`` takes only the chunks sealed by
        size (no ack waits on durability); ``compress=False`` leaves zlib
        out; ``stage=False`` commits only what ``stage_flush`` staged."""
        if self.tier_store is None:
            return 0
        self._ensure_loaded()
        writes: dict[str, dict] = {}
        for name, t in list(self._tables.items()):
            if t.tier is None:
                t.attach_tier(self.tier_store.tier(name))
            payload = t.take_flushable(seal=seal, stage=stage)
            if payload is not None:
                writes[name] = payload
        if not writes and not ack_floors:
            return 0
        rows = self.tier_store.commit(writes, ack_floors=ack_floors,
                                      mark_imported=True,
                                      compress=compress,
                                      ack_parked=ack_parked)
        for name, payload in writes.items():
            self._tables[name].confirm_flush(payload)
        return rows

    def compact_tier(self, name: str | None = None, *,
                     min_merge: int = 2, pool=None, **kw) -> dict:
        """Compact one table's tier (every table's when name is None)
        into sorted format-v2 runs, with the table's dictionaries (the
        dict-order rewrite and the string skip indexes), and move the
        change token of each table that changed. Returns the summed
        counters."""
        out = {"runs_built": 0, "segments_replaced": 0, "rows": 0,
               "bytes_before": 0, "bytes_after": 0,
               "segments_migrated": 0}
        if self.tier_store is None:
            return out
        self._ensure_loaded()
        for n in ([name] if name is not None else list(self._tables)):
            t = self._tables.get(n)
            res = self.tier_store.compact(
                n, dicts=dict(t.dicts) if t is not None else None,
                min_merge=min_merge, pool=pool, **kw)
            if res["runs_built"] and t is not None:
                t.note_tier_compact()
            for k in out:
                out[k] += res.get(k, 0)
        return out

    def _attach_tiers(self) -> None:
        """The restart's recovery: take the longest persisted dictionary
        of each column (dumps are append-only), drop the segments no
        dictionary can decode, and adopt each table's tier."""
        for name, t in self._tables.items():
            if t.tier is not None:
                continue  # adopted already: attaching again double-counts
            tt = self.tier_store.tier(name)
            for col in t.dicts:
                p = tt.dict_path(col)
                if not os.path.exists(p):
                    continue
                try:
                    d2 = Dictionary.load(p, f"{name}.{col}")
                except (OSError, ValueError, KeyError):
                    log.warning("tier dict %s unreadable", p, exc_info=True)
                    continue
                if len(d2) > len(t.dicts[col]):
                    t.dicts[col] = d2
            if tt.segment_count():
                self.tier_store.validate_dicts(name, t.dicts)
            t.attach_tier(tt)

    # -- persistence ---------------------------------------------------------

    def save(self) -> None:
        """Persist at a clean stop: a full tier commit with storage on,
        else one npz snapshot per table."""
        if not self.data_dir:
            return
        if self.tier_store is not None:
            self.flush_to_tier()
        else:
            for name, t in self._tables.items():
                t.save(os.path.join(self.data_dir, name.replace(".", "/")))
        migration.write_manifest(self.data_dir)

    def load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        if not self.data_dir or not os.path.isdir(self.data_dir):
            return
        migration.validate_loadable(self.data_dir)
        version = migration.read_manifest_version(self.data_dir)
        # once the tier has taken the npz state in, the chunk dirs are
        # stale copies of what the segments hold
        if self.tier_store is None or not self.tier_store.npz_imported:
            for name, t in self._tables.items():
                d = os.path.join(self.data_dir, name.replace(".", "/"))
                if os.path.isdir(d) or os.path.isdir(d + ".old"):
                    t.load(d, from_version=version)
        if self.tier_store is not None:
            self._attach_tiers()
