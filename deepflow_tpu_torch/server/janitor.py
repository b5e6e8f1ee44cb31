"""Retention janitor: TTL enforcement over the in-memory store.

Own copy of ``deepflow_tpu/server/janitor.py``'s TTL part: one thread
walks the tables every ``interval_s`` and drops the whole sealed chunks
older than each table's TTL (``ColumnarTable.trim_before``), then
compacts the dictionaries of a table it trimmed. The port has no storage
tiers, so there is no tier budget. Its stats show in ``/v1/health``
under ``"janitor"``, and its thread beats a ``janitor`` heartbeat.
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
    "deepflow_system.deepflow_system": 7 * 86400,
}


class Janitor:
    def __init__(self, db, ttl_s: dict | None = None,
                 interval_s: float = 300.0,
                 telemetry: Telemetry | None = None) -> None:
        self.db = db
        self.ttl_s = dict(DEFAULT_TTL_S)
        if ttl_s:
            self.ttl_s.update(ttl_s)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"sweeps": 0, "rows_trimmed": 0, "dicts_compacted": 0}
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
            # schema convention: u64 time = ns, u32 = epoch seconds
            if table.columns["time"].kind == "u64":
                cutoff = int((now - ttl) * 1e9)
            else:
                cutoff = int(now - ttl)
            n = table.trim_before("time", cutoff)
            if n:
                log.info("janitor: trimmed %d rows from %s", n, name)
                compacted = table.compact_dictionaries()
                if compacted:
                    log.info("janitor: compacted dictionaries on %s: %s",
                             name, compacted)
                    self.stats["dicts_compacted"] += len(compacted)
            trimmed += n
        self.stats["sweeps"] += 1
        self.stats["rows_trimmed"] += trimmed
        return trimmed

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
