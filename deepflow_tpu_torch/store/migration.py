"""Schema versioning + on-load migration for the store.

Own copy of ``deepflow_tpu/store/migration.py``, whole: a MANIFEST.json
records the schema version a data dir was written with; at load, the
chain of migrations between that version and the current one is applied
to each table's chunks (rename / retype / drop; purely-additive columns
need no migration — ColumnarTable.load backfills defaults). Beside it,
the segment FORMAT migration (v1 -> v2, online, on compaction). The
version numbers are the reference's, so a data dir moves between the
packages.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

# bump when a saved format changes shape beyond additive columns
SCHEMA_VERSION = 3

MANIFEST = "MANIFEST.json"


@dataclass(frozen=True)
class Rename:
    table: str
    old: str
    new: str


@dataclass(frozen=True)
class Retype:
    table: str
    column: str
    np_dtype: object  # target numpy dtype


@dataclass(frozen=True)
class Drop:
    table: str
    column: str


# version N -> ops upgrading N to N+1
MIGRATIONS: dict[int, list] = {
    # v1 -> v2: l4 "rtt"/"art" were written as u32 microseconds
    # under the same names — no shape change shipped, so the chain is empty;
    # the machinery and tests carry the contract for future bumps.
    1: [],
    # v2 -> v3: step health pipeline adds profile.tpu_step_metrics. A new
    # table is purely additive (v2 dirs simply have no chunks for it), so
    # the op chain is empty; the bump records that v3 readers may find it.
    2: [],
}


def migrate_chunk(table: str, chunk: dict, from_version: int) -> dict:
    """Apply the migration chain to one loaded chunk (pure function)."""
    v = from_version
    while v < SCHEMA_VERSION:
        for op in MIGRATIONS.get(v, []):
            if op.table != table:
                continue
            if isinstance(op, Rename):
                if op.old in chunk:
                    chunk[op.new] = chunk.pop(op.old)
            elif isinstance(op, Retype):
                if op.column in chunk:
                    chunk[op.column] = chunk[op.column].astype(op.np_dtype)
            elif isinstance(op, Drop):
                chunk.pop(op.column, None)
        v += 1
    return chunk


def write_manifest(data_dir: str) -> None:
    path = os.path.join(data_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"schema_version": SCHEMA_VERSION,
                   "saved_at_ns": time.time_ns()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_manifest_version(data_dir: str) -> int:
    """Version a data dir was saved with; 1 for pre-manifest dirs."""
    path = os.path.join(data_dir, MANIFEST)
    try:
        with open(path) as f:
            return int(json.load(f).get("schema_version", 1))
    except (OSError, ValueError):
        return 1


def validate_loadable(data_dir: str) -> None:
    v = read_manifest_version(data_dir)
    if v > SCHEMA_VERSION:
        raise RuntimeError(
            f"data dir {data_dir} was written by schema v{v}; this build "
            f"understands <= v{SCHEMA_VERSION} (downgrade-unsafe)")


# -- segment FORMAT migration (ckissu-style, online) -------------------------
#
# Orthogonal to the SCHEMA chain above: SCHEMA_VERSION covers column
# shapes, SEGMENT_FORMAT covers the on-disk byte layout of one segment
# file (store/segment.py). The upgrade is ONLINE and idempotent —
# never a boot-time rewrite pass:
#
#   V1-LIVE    a DFSEG001 file listed in the tier manifest. Readable
#              forever (Segment.open handles both magics); counted by
#              migrate_v1_remaining in /v1/health.
#   STAGED     compaction wrote its rows into a v2 run file; the
#              manifest still lists only the v1 segment. Crash here:
#              recovery deletes the unlisted run, state = V1-LIVE.
#   COMMITTED  the manifest rename listed the run and dropped the v1
#              segment. Crash here: recovery deletes the v1 FILE as
#              unlisted torn tail, state = V2-LIVE.
#   V2-LIVE    only the v2 run remains.
#
# Every crash point converges through TieredStore.recover()'s single
# rule (manifest == disk), which is the restart-mid-migrate chaos arm's
# whole proof obligation. Downgrade safety: a pre-v2 build refuses
# DFSEG002 files by magic, and SEGMENT_FORMAT > its known max is the
# same "downgrade-unsafe" contract as validate_loadable.

SEGMENT_FORMAT = 2


def segment_format_counts(store) -> dict[int, int]:
    """{format_version -> live segment count} across a TieredStore."""
    out: dict[int, int] = {}
    for tt in store.tables().values():
        for s in tt.segments():
            out[s.fmt] = out.get(s.fmt, 0) + 1
    return out


def migrate_segments(db, tables: list[str] | None = None, *,
                     pool=None) -> dict:
    """Drive migrate-on-compact for a Database with an attached tier:
    compact every table still holding v1 segments (compaction always
    emits format-v2 runs, even for a lone v1 segment). Returns the
    aggregate compaction counters plus ``v1_remaining``. Safe to call
    repeatedly; a fully-migrated store is a no-op."""
    store = getattr(db, "tier_store", None)
    out = {"tables": 0, "runs_built": 0, "segments_migrated": 0,
           "v1_remaining": 0}
    if store is None:
        return out
    names = tables if tables is not None else [
        name for name, tt in store.tables().items()
        if any(s.fmt < 2 for s in tt.segments())]
    for name in names:
        res = db.compact_tier(name, min_merge=1, pool=pool) \
            if hasattr(db, "compact_tier") else \
            store.compact(name, min_merge=1, pool=pool)
        out["tables"] += 1
        out["runs_built"] += res.get("runs_built", 0)
        out["segments_migrated"] += res.get("segments_migrated", 0)
    out["v1_remaining"] = store.migrate_v1_remaining()
    return out


__all__ = ["SCHEMA_VERSION", "SEGMENT_FORMAT", "MIGRATIONS", "Rename",
           "Retype", "Drop", "migrate_chunk", "write_manifest",
           "read_manifest_version", "validate_loadable",
           "segment_format_counts", "migrate_segments", "np"]
