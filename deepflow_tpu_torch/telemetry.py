"""Self-telemetry: hop ledgers, stage heartbeats and the deadman.

Own copy of ``deepflow_tpu/telemetry.py``, one registry per agent or
server (not process-global: the tests run several in one process):

* ``HopLedger`` accounts every frame of one pipeline hop as
  ``emitted = delivered + dropped(reason) + in_flight``, with an
  enqueue-to-dequeue latency histogram, so a loss is attributed to one
  hop and one reason.
* ``Heartbeat``: every long-running thread beats with a progress
  counter; stages that wake rarely declare ``interval_hint_s``.
* ``DeadmanDetector`` flags a stage whose heartbeat stalls past its
  window and snapshots the stalled thread's stack
  (``sys._current_frames()``).

The agent ships ``Telemetry.stats_metrics()`` in its DFSTATS batch into
``deepflow_system.deepflow_system``; the server's ``/v1/health`` reads
its own registry and, through ``collect_agent_selfmon``, the agents'
rows. ``DF_NO_SELFMON=1`` (or ``Telemetry(enabled=False)``) swaps in
no-op hops and heartbeats.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback

import numpy as np

log = logging.getLogger("df.telemetry")

# the kill-switch for incident debugging
SELFMON_DISABLED = os.environ.get("DF_NO_SELFMON", "") not in ("", "0")

# max bytes of formatted stack shipped per wedge verdict (tag_json cell)
_STACK_LIMIT = 4096


def _now_ns() -> int:
    return time.monotonic_ns()


class LatencyHistogram:
    """Fixed-bound latency histogram (ns).  Cheap: one list index per
    observe, percentiles estimated from bucket upper bounds."""

    # 0.1ms 1ms 10ms 100ms 1s 10s +inf — queue waits, not packet times
    BOUNDS_NS = (100_000, 1_000_000, 10_000_000, 100_000_000,
                 1_000_000_000, 10_000_000_000)

    __slots__ = ("counts", "count", "sum_ns")

    def __init__(self) -> None:
        self.counts = [0] * (len(self.BOUNDS_NS) + 1)
        self.count = 0
        self.sum_ns = 0

    def observe(self, wait_ns: int, n: int = 1) -> None:
        i = 0
        for bound in self.BOUNDS_NS:
            if wait_ns <= bound:
                break
            i += 1
        self.counts[i] += n
        self.count += n
        self.sum_ns += wait_ns * n

    def quantile(self, q: float) -> float:
        """Upper-bound estimate in ms (conservative: reports the bucket
        ceiling the q-th observation fell into)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i < len(self.BOUNDS_NS):
                    return self.BOUNDS_NS[i] / 1e6
                # +inf bucket: fall back to the mean (better than lying
                # with an arbitrary ceiling)
                return self.sum_ns / self.count / 1e6
        return self.BOUNDS_NS[-1] / 1e6

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum_ms": round(self.sum_ns / 1e6, 3),
            "p50_ms": round(self.quantile(0.50), 3),
            "p99_ms": round(self.quantile(0.99), 3),
        }


class HopLedger:
    """One pipeline hop's frame accounting.

    Invariant (after quiescence): ``emitted == delivered + dropped``.
    While traffic is moving the difference is ``in_flight`` (items
    sitting in the hop's queue/buffer).  ``account()`` is called per
    BATCH on hot paths, so the lock is cold."""

    __slots__ = ("name", "_lock", "emitted", "delivered", "dropped", "wait")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self.emitted = 0
        self.delivered = 0
        self.dropped: dict[str, int] = {}
        self.wait = LatencyHistogram()

    def account(self, emitted: int = 0, delivered: int = 0,
                dropped: int = 0, reason: str = "",
                wait_ns: int | None = None) -> None:
        with self._lock:
            self.emitted += emitted
            self.delivered += delivered
            if dropped:
                key = reason or "unknown"
                self.dropped[key] = self.dropped.get(key, 0) + dropped
            if wait_ns is not None:
                self.wait.observe(wait_ns, max(1, delivered or emitted))

    def observe_wait(self, wait_ns: int, weight: int = 1) -> None:
        """Record queue wait without moving the frame counters — for
        callers that batch emitted/delivered accounting separately (the
        query tracer defers its ledger off the query hot path)."""
        with self._lock:
            self.wait.observe(wait_ns, max(1, weight))

    def snapshot(self) -> dict:
        with self._lock:
            dropped_total = sum(self.dropped.values())
            return {
                "hop": self.name,
                "emitted": self.emitted,
                "delivered": self.delivered,
                "dropped": dict(self.dropped),
                "dropped_total": dropped_total,
                "in_flight": self.emitted - self.delivered - dropped_total,
                "wait": self.wait.snapshot(),
            }


class Heartbeat:
    """One long-running thread's liveness record.  ``beat()`` must be
    called from the owning thread (it records the thread ident used for
    the deadman stack snapshot)."""

    __slots__ = ("stage", "interval_hint_s", "beats", "progress",
                 "last_beat_mono", "thread_ident", "started_mono")

    def __init__(self, stage: str, interval_hint_s: float = 0.0) -> None:
        self.stage = stage
        # stages that legitimately sleep a long time (stats: 10s)
        # declare it so the detector widens their window instead of
        # crying wolf
        self.interval_hint_s = interval_hint_s
        self.beats = 0
        self.progress = 0
        self.started_mono = time.monotonic()
        self.last_beat_mono = self.started_mono  # armed at registration
        self.thread_ident: int | None = None

    def beat(self, progress: int | None = None) -> None:
        if self.thread_ident is None:
            self.thread_ident = threading.get_ident()
        self.beats += 1
        if progress is not None:
            self.progress = progress
        self.last_beat_mono = time.monotonic()

    def snapshot(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        return {
            "stage": self.stage,
            "beats": self.beats,
            "progress": self.progress,
            "age_s": round(now - self.last_beat_mono, 3),
            "interval_hint_s": self.interval_hint_s,
        }


class _NullHop:
    """API-compatible no-op hop for DF_NO_SELFMON."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def account(self, emitted: int = 0, delivered: int = 0,
                dropped: int = 0, reason: str = "",
                wait_ns: int | None = None) -> None:
        pass

    def observe_wait(self, wait_ns: int, weight: int = 1) -> None:
        pass

    def snapshot(self) -> dict:
        return {"hop": self.name, "emitted": 0, "delivered": 0,
                "dropped": {}, "dropped_total": 0, "in_flight": 0,
                "wait": {"count": 0, "sum_ms": 0.0,
                         "p50_ms": 0.0, "p99_ms": 0.0}}


class _NullHeartbeat:
    __slots__ = ("stage",)

    def __init__(self, stage: str) -> None:
        self.stage = stage

    def beat(self, progress: int | None = None) -> None:
        pass

    def snapshot(self, now: float | None = None) -> dict:
        return {"stage": self.stage, "beats": 0, "progress": 0,
                "age_s": 0.0, "interval_hint_s": 0.0}


class Telemetry:
    """Registry of hops + heartbeats for ONE component (one per Agent,
    one per Server — NOT process-global, because tests run both in a
    single process)."""

    def __init__(self, component: str = "agent",
                 enabled: bool | None = None) -> None:
        self.component = component
        self.enabled = (not SELFMON_DISABLED) if enabled is None else enabled
        self._lock = threading.Lock()
        self._hops: dict[str, HopLedger] = {}   # insertion order = pipeline
        self._beats: dict[str, Heartbeat] = {}
        # stage -> wedge verdict dict; maintained by the DeadmanDetector
        self.wedges: dict[str, dict] = {}
        self._wedges_total = 0

    # -- registration --------------------------------------------------------

    def hop(self, name: str) -> HopLedger:
        if not self.enabled:
            return _NullHop(name)
        with self._lock:
            h = self._hops.get(name)
            if h is None:
                h = self._hops[name] = HopLedger(name)
            return h

    def heartbeat(self, stage: str,
                  interval_hint_s: float = 0.0) -> Heartbeat:
        """Register (or re-register after a restart) a stage heartbeat."""
        if not self.enabled:
            return _NullHeartbeat(stage)
        with self._lock:
            hb = Heartbeat(stage, interval_hint_s=interval_hint_s)
            self._beats[stage] = hb
            return hb

    def unregister(self, stage: str) -> None:
        with self._lock:
            self._beats.pop(stage, None)
            self.wedges.pop(stage, None)

    # -- snapshots -----------------------------------------------------------

    def pipeline_snapshot(self) -> list[dict]:
        with self._lock:
            hops = list(self._hops.values())
        return [h.snapshot() for h in hops]

    def stages_snapshot(self) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            beats = list(self._beats.values())
            wedged = set(self.wedges)
        out = []
        for hb in beats:
            s = hb.snapshot(now)
            s["wedged"] = hb.stage in wedged
            out.append(s)
        return out

    def snapshot(self) -> dict:
        """Everything /v1/health needs, JSON-ready."""
        pipeline = self.pipeline_snapshot()
        imbalance = sum(abs(h["in_flight"]) for h in pipeline)
        return {
            "component": self.component,
            "enabled": self.enabled,
            "pipeline": pipeline,
            "ledger_imbalance": imbalance,
            "stages": self.stages_snapshot(),
            "wedges": sorted(self.wedges.values(),
                             key=lambda w: w["stage"]),
            "wedges_total": self._wedges_total,
        }

    # -- DFSTATS shipping ----------------------------------------------------

    def stats_metrics(self):
        """Yield ``(metric_name, tags, values)`` triples in the shape the
        agent's ``_emit_stats``/StatsBatch expects.  Metric names are
        chosen so PromQL resolution through the ``deepflow_system_``
        narrow-table prefix yields e.g.
        ``deepflow_system_agent_pipeline_emitted{hop="sender"}``."""
        c = self.component
        for h in self.pipeline_snapshot():
            vals = {"emitted": float(h["emitted"]),
                    "delivered": float(h["delivered"]),
                    "dropped": float(h["dropped_total"]),
                    "in_flight": float(h["in_flight"]),
                    "wait_p99_ms": h["wait"]["p99_ms"]}
            yield f"{c}.pipeline", {"hop": h["hop"]}, vals
            for reason, n in h["dropped"].items():
                yield (f"{c}.pipeline.drop", {"hop": h["hop"],
                                              "reason": reason},
                       {"dropped": float(n)})
        for s in self.stages_snapshot():
            yield (f"{c}.heartbeat", {"stage": s["stage"]},
                   {"beats": float(s["beats"]),
                    "progress": float(s["progress"]),
                    "age_s": s["age_s"],
                    "wedged": 1.0 if s["wedged"] else 0.0})
        for w in sorted(self.wedges.values(), key=lambda w: w["stage"]):
            yield (f"{c}.deadman", {"stage": w["stage"],
                                    "stack": w["stack"]},
                   {"wedged": 1.0, "stalled_s": w["stalled_s"],
                    "progress": float(w["progress"])})


class DeadmanDetector:
    """Scans a Telemetry's heartbeats; flags stalls; snapshots stacks.

    A stage is wedged when its last beat is older than
    ``max(window_s, 2.5 * interval_hint_s)``. The verdict carries the
    wedged thread's current stack (``sys._current_frames()``): where the
    stage is stuck, not just that its rows stopped."""

    def __init__(self, telemetry: Telemetry, window_s: float = 15.0,
                 check_interval_s: float | None = None,
                 on_wedge=None) -> None:
        self.telemetry = telemetry
        self.window_s = window_s
        self.check_interval_s = (check_interval_s if check_interval_s
                                 else max(0.1, window_s / 4.0))
        self.on_wedge = on_wedge  # callback(verdict_dict), e.g. log/ship
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "DeadmanDetector":
        if not self.telemetry.enabled:
            return self
        self._thread = threading.Thread(
            target=self._run,
            name=f"df-deadman-{self.telemetry.component}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None

    def check_once(self) -> list[dict]:
        """One scan; returns NEW wedge verdicts (also records them)."""
        t = self.telemetry
        now = time.monotonic()
        new = []
        with t._lock:
            beats = list(t._beats.values())
        frames = None  # lazy: only taken when something looks stuck
        for hb in beats:
            window = max(self.window_s, 2.5 * hb.interval_hint_s)
            age = now - hb.last_beat_mono
            if age <= window:
                if t.wedges.pop(hb.stage, None) is not None:
                    log.info("deadman: stage %r recovered", hb.stage)
                continue
            if hb.stage in t.wedges:  # already flagged; refresh stall age
                t.wedges[hb.stage]["stalled_s"] = round(age, 3)
                continue
            if frames is None:
                frames = sys._current_frames()
            stack = ""
            fr = frames.get(hb.thread_ident) if hb.thread_ident else None
            if fr is not None:
                stack = "".join(traceback.format_stack(fr))[-_STACK_LIMIT:]
            verdict = {
                "stage": hb.stage,
                "stalled_s": round(age, 3),
                "beats": hb.beats,
                "progress": hb.progress,
                "window_s": window,
                "stack": stack,
            }
            t.wedges[hb.stage] = verdict
            t._wedges_total += 1
            new.append(verdict)
            log.error("deadman: stage %r wedged (no beat for %.1fs, "
                      "progress=%d)\n%s", hb.stage, age, hb.progress,
                      stack or "<no stack: thread gone>")
            if self.on_wedge is not None:
                try:
                    self.on_wedge(verdict)
                except Exception:
                    log.exception("on_wedge callback failed")
        return new

    def _run(self) -> None:
        hb = self.telemetry.heartbeat(
            "deadman", interval_hint_s=self.check_interval_s)
        hb.beat()
        while not self._stop.wait(self.check_interval_s):
            hb.beat(progress=self.telemetry._wedges_total)
            try:
                self.check_once()
            except Exception:
                log.exception("deadman scan failed")


# -- deepflow_system readback (server-side health aggregation) --------------

def collect_agent_selfmon(db, window_ns: int = 600_000_000_000) -> dict:
    """Reconstitute the AGENTS' latest self-telemetry from the rows they
    shipped into ``deepflow_system.deepflow_system``.

    Agent wedges happen in a different process than the server, so
    /v1/health can't read them from a live Telemetry object — it mines
    the table the same way an operator would with PromQL.  Counters are
    cumulative; latest row per (metric, tags, value_name) wins."""
    try:
        t = db.table("deepflow_system.deepflow_system").view()
    except KeyError:
        return {"pipeline": {}, "heartbeats": {}, "wedges": []}
    # the metric-name set is closed, so resolve dictionary ids ONCE and
    # mask with numpy instead of decoding every row
    name_dict = t.dicts["metric_name"]
    wanted: dict[int, str] = {}
    for nm in ("agent.pipeline", "agent.pipeline.drop",
               "agent.heartbeat", "agent.deadman"):
        sid = name_dict.lookup(nm)
        if sid is not None:
            wanted[sid] = nm
    if not wanted:
        return {"pipeline": {}, "heartbeats": {}, "wedges": []}
    latest: dict[tuple, tuple[int, float, str]] = {}
    cutoff = time.time_ns() - window_ns
    tag_dict = t.dicts["tag_json"]
    vname_dict = t.dicts["value_name"]
    for chunk in t.chunks:
        name_ids = chunk["metric_name"]
        times = chunk["time"]
        mask = np.isin(name_ids, list(wanted))
        mask &= times.astype("int64") >= cutoff
        if not mask.any():
            continue
        idx = np.nonzero(mask)[0]
        tag_ids = chunk["tag_json"]
        vname_ids = chunk["value_name"]
        values = chunk["value"]
        for i in idx:
            name = wanted[int(name_ids[i])]
            ts = int(times[i])
            tag_json = tag_dict.decode(int(tag_ids[i]))
            vname = vname_dict.decode(int(vname_ids[i]))
            key = (name, tag_json, vname)
            prev = latest.get(key)
            if prev is None or ts >= prev[0]:
                latest[key] = (ts, float(values[i]), tag_json)
    pipeline: dict[str, dict] = {}
    heartbeats: dict[str, dict] = {}
    wedges: dict[str, dict] = {}
    for (name, tag_json, value_name), (ts, value, _) in latest.items():
        try:
            tags_d = json.loads(tag_json) if tag_json else {}
        except ValueError:
            tags_d = {}
        if name == "agent.pipeline":
            hop = tags_d.get("hop", "?")
            pipeline.setdefault(hop, {"hop": hop})[value_name] = value
        elif name == "agent.pipeline.drop":
            hop = tags_d.get("hop", "?")
            d = pipeline.setdefault(hop, {"hop": hop})
            d.setdefault("dropped_by_reason", {})[
                tags_d.get("reason", "unknown")] = value
        elif name == "agent.heartbeat":
            stage = tags_d.get("stage", "?")
            heartbeats.setdefault(stage, {"stage": stage})[value_name] = value
        elif name == "agent.deadman":
            stage = tags_d.get("stage", "?")
            w = wedges.setdefault(
                stage, {"stage": stage, "stack": tags_d.get("stack", ""),
                        "time_ns": ts})
            w[value_name] = value
            if ts > w["time_ns"]:
                w["time_ns"] = ts
    return {"pipeline": pipeline, "heartbeats": heartbeats,
            "wedges": sorted(wedges.values(), key=lambda w: w["stage"])}
