"""Datasource rollups: derived 1m/1h/1d aggregates from 1s metric tables.

Own copy of ``deepflow_tpu/server/datasource.py``, on the port's engine,
scan pool and ``query/sketch.py``. With storage on, each roll that wrote
rows folds the rollup tables' tier segments into sorted runs
(``db.compact_tier``; ``stats["compact_runs"]``).

Reference analog: server/ingester/datasource (rollup management with
configurable aggregators per datasource). A periodic job aggregates
completed buckets from flow_metrics.*.1s upward using the query engine
itself, so the rollup algebra is exactly the algebra queries use —
Sum/Max/Min partials compose, which is what makes a rollup row
byte-identical to recomputing the same aggregate from raw rows.

Percentiles do NOT decompose, so they roll up as mergeable DDSketch
state (query/sketch.py) in a side column: PERCENTILE() over a long
range answers from the sketch within its relative-error bound (gamma)
instead of scanning raw rows.

query/datasource.py consumes `horizons()` to transparently swap a
query's table for the coarsest rollup tier that still answers exactly.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from deepflow_tpu_torch.query import engine as qengine
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.store.db import Database

log = logging.getLogger("df.datasource")

# per-side universal resource tags carried through every rollup stage
from deepflow_tpu_torch.store import schema as _schema

_SIDE_TAGS = [f"{n}_{s}" for s in ("0", "1")
              for n in _schema.SIDE_TAG_NAMES]


class RollupSpec:
    """One metric family's rollup recipe.

    tags     — group-by columns carried through unchanged
    aggs     — meter column -> aggregator name (Sum | Max | Min); the
               aggregator must be DECOMPOSABLE (partials merge by the
               same function), which is what keeps rollup == recompute
    sketches — sketch column -> source meter column: mergeable DDSketch
               JSON built from raw values at the first stage, merged
               bucket-wise at the later stages
    """

    def __init__(self, tags: list[str], aggs: dict[str, str],
                 sketches: dict[str, str] | None = None) -> None:
        for fn in aggs.values():
            if fn not in ("Sum", "Max", "Min"):
                raise ValueError(f"non-decomposable aggregator {fn!r}")
        self.tags = list(tags)
        self.aggs = dict(aggs)
        self.sketches = dict(sketches or {})


FAMILIES: dict[str, RollupSpec] = {
    "flow_metrics.network": RollupSpec(
        tags=["ip_src", "ip_dst", "server_port", "protocol", "direction",
              "agent_id", "host_id", "host", "pod_name", "pod_ns",
              "tpu_pod", "tpu_worker", "slice_id"] + _SIDE_TAGS,
        aggs={c: "Sum" for c in
              ["packet_tx", "packet_rx", "byte_tx", "byte_rx",
               "flow_count", "new_flow", "closed_flow", "rtt_sum",
               "rtt_count", "retrans", "syn_count", "synack_count"]}),
    "flow_metrics.application": RollupSpec(
        tags=["ip_src", "ip_dst", "server_port", "l7_protocol",
              "app_service", "agent_id", "host_id", "host", "pod_name",
              "pod_ns", "tpu_pod", "tpu_worker", "slice_id"] + _SIDE_TAGS,
        aggs={**{c: "Sum" for c in
                 ["request", "response", "rrt_sum", "rrt_count",
                  "error_client", "error_server", "timeout"]},
              "rrt_max": "Max"},
        sketches={"rrt_max_sketch": "rrt_max"}),
}


# rollup stages: (src interval suffix, dst suffix, bucket seconds)
_STAGES = [("1s", "1m", 60), ("1m", "1h", 3600),
           ("1h", "1d", 86400)]

# bucket width by interval suffix (1s tables hold raw-second rows)
BUCKET_S = {"1s": 1, "1m": 60, "1h": 3600, "1d": 86400}


class RollupJob:
    def __init__(self, db: Database, interval_s: float = 15.0,
                 lateness_s: int = 90) -> None:
        self.db = db
        self.interval_s = interval_s
        self.lateness_s = lateness_s  # wait for flow-timeout stragglers
        # per (family, stage): last fully-rolled bucket (epoch s);
        # restart-safe — initialized from the destination table's max(time)
        self._watermark: dict[tuple, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"rollups": 0, "rows": 0, "sketch_rows": 0,
                      "compact_runs": 0}
        self._stats_lock = threading.Lock()  # families roll concurrently

    def start(self) -> "RollupJob":
        if self.running():
            return self
        self._stop.clear()  # restartable (HA leader churn)
        self._thread = threading.Thread(
            target=self._run, name="df-rollup", daemon=True)
        self._thread.start()
        return self

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            if not self._thread.is_alive():
                self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.roll(now_s=int(time.time()))
            except Exception:
                log.exception("rollup failed")

    def _initial_watermark(self, dst, bucket: int) -> int:
        """Resume after restart: already-rolled buckets must not re-roll.
        The newest dst row marks its whole bucket as done."""
        best = 0
        for ch in dst.snapshot():
            t = ch.get("time")
            if t is not None and len(t):
                best = max(best, (int(t.max()) // bucket) * bucket + bucket)
        return best

    def horizons(self) -> dict[tuple[str, str], int]:
        """Per (family, interval-suffix) completeness horizon (epoch s,
        exclusive): every source row with time < horizon is represented
        in that tier. The 1s tier is always complete (it IS the source).
        Feeds transparent datasource selection (query/datasource.py) —
        a query whose time window closes under the horizon can answer
        from the rollup without missing late rows."""
        out: dict[tuple[str, str], int] = {}
        for family in FAMILIES:
            for src_sfx, dst_sfx, bucket in _STAGES:
                key = (family, dst_sfx)
                wm = self._watermark.get(key)
                if wm is None:
                    wm = self._initial_watermark(
                        self.db.table(f"{family}.{dst_sfx}"), bucket)
                    if wm:  # cache only a real resume point
                        self._watermark[key] = wm
                out[key] = wm
        return out

    def roll(self, now_s: int) -> int:
        """Run every rollup stage: complete buckets older than now-lateness.

        Families roll concurrently on the shared scan pool (they touch
        disjoint src/dst tables); the stages WITHIN a family stay serial
        because each feeds the next (1s -> 1m -> 1h -> 1d). Queries a
        stage runs inside a pool worker degrade to the serial engine
        path via the in_worker guard — no nested fan-out."""
        def _roll_family(item):
            family, spec = item
            n = 0
            for src_sfx, dst_sfx, bucket in _STAGES:
                n += self._roll_stage(
                    now_s, family, src_sfx, dst_sfx, bucket, spec)
            return n
        fams = list(FAMILIES.items())
        pool = qpool.get_pool()
        if pool is not None and len(fams) > 1:
            total = sum(pool.map(_roll_family, fams))
        else:
            total = sum(_roll_family(f) for f in fams)
        if total:
            self.stats["rollups"] += 1
            self.stats["rows"] += total
            self._compact_destinations()
        return total

    def _compact_destinations(self) -> None:
        """A rollup table gains one small flushed segment per completed
        bucket; fold them into sorted format-v2 runs, so a long-range
        query over a coarse tier scans a few runs instead of hundreds of
        slivers. A no-op without tiered storage, and cheap with nothing
        to merge (the planner skips single-run groups)."""
        if self.db.tier_store is None:
            return
        for family in FAMILIES:
            for _src_sfx, dst_sfx, _bucket in _STAGES:
                try:
                    res = self.db.compact_tier(f"{family}.{dst_sfx}")
                except Exception:
                    log.exception("rollup compaction failed")
                    continue
                with self._stats_lock:
                    self.stats["compact_runs"] += res.get("runs_built", 0)

    def _sketch_map(self, src, spec: RollupSpec, sketch_col: str,
                    wm: int, horizon: int, bucket: int) -> dict:
        """(bucket_start, tag tuple) -> HistogramSketch for one stage's
        window. First stage (src has no sketch column): build from raw
        source values. Later stages: merge the src tier's JSON states —
        sketch merge is bucket-wise addition, so 1h == merging the 1m
        states == building from raw, modulo nothing (merge is exact on
        the sketch representation)."""
        from deepflow_tpu_torch.query.sketch import HistogramSketch
        merging = sketch_col in src.columns
        val_col = sketch_col if merging else spec.sketches[sketch_col]
        sql_text = ("SELECT time, " + ", ".join(spec.tags) +
                    f", {val_col} FROM t "
                    f"WHERE time >= {wm} AND time < {horizon}")
        res = qengine.execute(src, sql_text)
        ntags = len(spec.tags)
        out: dict[tuple, HistogramSketch] = {}
        for row in res.values:
            key = ((int(row[0]) // bucket) * bucket,
                   tuple(row[1:1 + ntags]))
            sk = out.get(key)
            if sk is None:
                sk = out[key] = HistogramSketch()
            v = row[1 + ntags]
            if merging:
                if v:
                    try:
                        sk.merge(HistogramSketch.from_dict(json.loads(v)))
                    except (ValueError, TypeError):
                        log.warning("undecodable sketch state dropped")
            else:
                sk.add_many([v])
        return out

    def _roll_stage(self, now_s: int, family: str, src_sfx: str,
                    dst_sfx: str, bucket: int, spec: RollupSpec) -> int:
        src = self.db.table(f"{family}.{src_sfx}")
        dst = self.db.table(f"{family}.{dst_sfx}")
        if len(src) == 0:
            return 0
        # hold back: rows can arrive up to flow-timeout after their capture
        # bucket closes (flow_map flush semantics)
        horizon = ((now_s - self.lateness_s) // bucket) * bucket
        key = (family, dst_sfx)
        if key not in self._watermark:
            self._watermark[key] = self._initial_watermark(dst, bucket)
        wm = self._watermark[key]
        if horizon <= wm:
            return 0
        meters = list(spec.aggs)
        select = ", ".join(
            [f"time(time, {bucket}) AS tmin"] + spec.tags
            + [f"{fn}({c}) AS {c}" for c, fn in spec.aggs.items()])
        group = ", ".join([f"time(time, {bucket})"] + spec.tags)
        sql_text = (f"SELECT {select} FROM t "
                    f"WHERE time >= {wm} AND time < {horizon} "
                    f"GROUP BY {group}")
        res = qengine.execute(src, sql_text)
        n = 0
        if res.values:
            sketch_maps = {
                sc: self._sketch_map(src, spec, sc, wm, horizon, bucket)
                for sc in spec.sketches if sc in dst.columns}
            cols = {name: [] for name in res.columns}
            for row in res.values:
                for name, v in zip(res.columns, row):
                    cols[name].append(v)
            ntags = len(spec.tags)
            for sc, smap in sketch_maps.items():
                vals = []
                for row in res.values:
                    k = (int(row[0]), tuple(row[1:1 + ntags]))
                    sk = smap.get(k)
                    vals.append("" if sk is None
                                else json.dumps(sk.to_dict()))
                cols[sc] = vals
                with self._stats_lock:
                    self.stats["sketch_rows"] += len(vals)
            cols["time"] = [int(t) for t in cols.pop("tmin")]
            for c in meters:
                cols[c] = [int(v) for v in cols[c]]
            for c in list(cols):
                cspec = dst.columns[c]
                if cspec.kind == "enum":  # labels -> indices for append
                    cols[c] = [cspec.enum_of(v) for v in cols[c]]
            dst.append_columns(cols, n=len(res.values))
            n = len(res.values)
        self._watermark[key] = horizon
        return n
