"""Retention janitor: TTL enforcement over the store and its tier.

Own copy of ``deepflow_tpu/server/janitor.py``: one thread walks the
tables every ``interval_s`` and drops the whole sealed chunks older than
each table's TTL (``ColumnarTable.trim_before``), then compacts the
dictionaries of a table it trimmed; with a storage tier,
``sweep_tier`` evicts whole segments past the same TTLs and then the
oldest segments past the node's byte budget (``tier_max_bytes``), each
eviction counted in the ``tier_*_evicted`` stats and as
``segment_evict`` on the ``storage`` hop. Its stats show in
``/v1/health`` under ``"janitor"``, and its thread beats a ``janitor``
heartbeat.
"""

from __future__ import annotations

import logging
import threading
import time

from deepflow_tpu_torch.telemetry import Telemetry

log = logging.getLogger("df.janitor")

# seconds; the reference's entries for the tables the port has. Tables
# absent here are never trimmed (the reference has no entry for
# profile.tpu_memory or profile.tpu_step_metrics either).
DEFAULT_TTL_S = {
    "flow_log.l4_flow_log": 3 * 86400,
    "flow_log.l7_flow_log": 3 * 86400,
    "profile.in_process_profile": 3 * 86400,
    "profile.tpu_hlo_span": 3 * 86400,
    "flow_metrics.network.1s": 1 * 86400,
    "flow_metrics.application.1s": 1 * 86400,
    "flow_metrics.network.1m": 7 * 86400,
    "flow_metrics.application.1m": 7 * 86400,
    "flow_metrics.network.1h": 30 * 86400,
    "flow_metrics.application.1h": 30 * 86400,
    "prometheus.samples": 7 * 86400,
    "deepflow_system.deepflow_system": 7 * 86400,
    "event.event": 7 * 86400,
    "application_log.log": 7 * 86400,
}


class Janitor:
    def __init__(self, db, ttl_s: dict | None = None,
                 interval_s: float = 300.0,
                 telemetry: Telemetry | None = None,
                 tier_max_bytes: int = 0) -> None:
        self.db = db
        self.ttl_s = dict(DEFAULT_TTL_S)
        if ttl_s:
            self.ttl_s.update(ttl_s)
        self.interval_s = interval_s
        # the node's on-disk byte budget (0 = TTL only): past it the
        # globally oldest segments go first
        self.tier_max_bytes = max(0, int(tier_max_bytes))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"sweeps": 0, "rows_trimmed": 0, "dicts_compacted": 0,
                      "tier_rows_evicted": 0, "tier_segments_evicted": 0,
                      "tier_bytes_evicted": 0}
        self._telemetry = telemetry or Telemetry("server", enabled=False)

    def start(self) -> "Janitor":
        if self.running():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="df-janitor", daemon=True)
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

    def sweep(self, now_s: float | None = None) -> int:
        """One pass; returns rows trimmed."""
        now = now_s if now_s is not None else time.time()
        trimmed = 0
        for name, ttl in self.ttl_s.items():
            try:
                table = self.db.table(name)
            except KeyError:
                # a typo'd TTL entry must be visible, not silently skipped
                log.warning("janitor: no such table %r in TTL config", name)
                continue
            if "time" not in table.columns:
                continue
            n = table.trim_before("time", _cutoff(table, now, ttl))
            if n:
                log.info("janitor: trimmed %d rows from %s", n, name)
                compacted = table.compact_dictionaries()
                if compacted:
                    log.info("janitor: compacted dictionaries on %s: %s",
                             name, compacted)
                    self.stats["dicts_compacted"] += len(compacted)
            trimmed += n
        trimmed += self.sweep_tier(now)
        self.stats["sweeps"] += 1
        self.stats["rows_trimmed"] += trimmed
        return trimmed

    def _tier_drop(self, name: str, dropped: dict) -> int:
        """Fold one tier eviction into the table's bookkeeping, the
        ``storage`` hop and the stats."""
        if not dropped["rows"] and not dropped["segments"]:
            return 0
        try:
            self.db.table(name).note_tier_evict(
                dropped["rows"], dropped["tmin"], dropped["tmax"])
        except KeyError:
            pass  # segments of a table this build no longer has
        self._telemetry.hop("storage").account(
            emitted=dropped["rows"], dropped=dropped["rows"],
            reason="segment_evict")
        self.stats["tier_rows_evicted"] += dropped["rows"]
        self.stats["tier_segments_evicted"] += dropped["segments"]
        self.stats["tier_bytes_evicted"] += dropped["bytes"]
        log.info("janitor: evicted %d segments (%d rows, %d bytes) "
                 "from tier %s", dropped["segments"], dropped["rows"],
                 dropped["bytes"], name)
        return dropped["rows"]

    def sweep_tier(self, now: float) -> int:
        """The tier's retention: whole segments past each table's TTL,
        then, past the node's byte budget, the segments of the table
        holding the globally oldest rows. Returns rows evicted."""
        ts = getattr(self.db, "tier_store", None)
        if ts is None:
            return 0
        evicted = 0
        for name, ttl in self.ttl_s.items():
            try:
                table = self.db.table(name)
            except KeyError:
                continue
            if table.tier is None or "time" not in table.columns:
                continue
            evicted += self._tier_drop(
                name, ts.evict(name, cutoff=_cutoff(table, now, ttl)))
        while self.tier_max_bytes:
            tables = ts.snapshot()["tables"]
            if sum(v["bytes"] for v in tables.values()) \
                    <= self.tier_max_bytes:
                break
            cand = sorted((v["tmin"] is None, v["tmin"], n, v["bytes"])
                          for n, v in tables.items() if v["segments"])
            if not cand:
                break
            _, _, name, nbytes = cand[0]
            # a budget one byte under the table's size forces exactly its
            # oldest segment(s) out
            dropped = ts.evict(name, max_bytes=max(0, nbytes - 1))
            if not dropped["segments"]:
                break
            evicted += self._tier_drop(name, dropped)
        return evicted

    def _run(self) -> None:
        # the janitor sleeps interval_s between beats; the deadman widens
        # its window accordingly
        hb = self._telemetry.heartbeat("janitor",
                                       interval_hint_s=self.interval_s)
        hb.beat()
        while not self._stop.wait(self.interval_s):
            hb.beat(progress=self.stats["sweeps"])
            try:
                self.sweep()
            except Exception:
                log.exception("janitor sweep failed")


def _cutoff(table, now: float, ttl: float) -> int:
    """now - ttl in the table's time unit: u64 time is ns, u32 epoch
    seconds."""
    if table.columns["time"].kind == "u64":
        return int((now - ttl) * 1e9)
    return int(now - ttl)
