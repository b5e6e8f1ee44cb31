"""Background tier flusher + the durability gate for ack release.

Own copy of ``deepflow_tpu/server/flusher.py``: ``DurabilityGate``,
``Flusher`` (group commit, sealing only for pending acks, requeue on a
failed commit, ``seed_floors``) and ``Compactor``. Nothing is left out.
Two repairs of the reference's protocol: the gate is also a cut
(``writing`` / ``cut``), so the rows a commit takes are exactly those
of the seqs it drains (the reference drains, then seals: rows of a
batch still being written went down with no floor covering them, and a
restart wrote their retransmit twice); and the seqs parked above a gap
persist beside the floors (``ack_parked``), so a retransmit of one of
them is a dup after a restart too. The port's flusher also keeps its
last commits' wall ms (``commit_ms_quantiles``), which ``/v1/health``
shows.

This is what makes "ack after durable write" (the transport's contract)
actually mean DURABLE when persistent storage is on. Decoders stop
observing seqs into the receiver's SeqAckTracker directly; instead they
park them in the DurabilityGate after decode+write. Each flush cycle:

  1. drain the gate (every parked seq's rows are in stripes/chunks by
     now — the decoder parked it only after its table writes returned)
  2. fold the drained seqs into a private floor tracker -> candidate
     per-agent contiguous floors
  3. db.flush_to_tier(ack_floors=floors): ONE atomic manifest commit
     persists the rows AND the floors (store/tiered.py ordering)
  4. only then observe the seqs into the receiver's tracker — the acks
     that now go out describe state that survives SIGKILL

A crash between any two steps is safe: rows committed but seqs not yet
released -> the floors in the manifest already cover them, so the restart
seeds dedup above the retransmit; rows not committed -> seqs never
released, agent retransmits, rows are written again (the lost copy was
RAM-only). Exactly-once either way.

Without a gate (storage off) decoders keep the old direct-observe path —
zero behavior change for in-memory servers.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

from deepflow_tpu_torch.server.receiver import SeqAckTracker
from deepflow_tpu_torch.telemetry import Telemetry

log = logging.getLogger("df.flusher")


class DurabilityGate:
    """Seqs written to RAM tables but not yet durable on disk, and the
    cut between the decoders' write passes and the flusher's staging.

    A decoder holds ``writing()`` from its dedup check through its table
    writes to parking its seqs; the flusher holds ``cut()`` while it
    drains the gate and stages the tables' chunks. No pass is half done
    at a cut, so the staged rows are exactly those of the drained seqs
    (and of the seqs drained before)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: list[tuple[int, int]] = []  # (agent_id, seq)
        self._cv = threading.Condition()
        self._writers = 0      # decoder passes in progress
        self._cutting = False  # a cut waits: new passes wait behind it

    @contextmanager
    def writing(self):
        with self._cv:
            while self._cutting:
                self._cv.wait()
            self._writers += 1
        try:
            yield
        finally:
            with self._cv:
                self._writers -= 1
                if not self._writers:
                    self._cv.notify_all()

    @contextmanager
    def cut(self):
        with self._cv:
            self._cutting = True
            while self._writers:
                self._cv.wait()
        try:
            yield
        finally:
            with self._cv:
                self._cutting = False
                self._cv.notify_all()

    def add(self, agent_id: int, seq: int) -> None:
        with self._lock:
            self._pending.append((agent_id, seq))

    def drain(self) -> list[tuple[int, int]]:
        with self._lock:
            out, self._pending = self._pending, []
            return out

    def requeue(self, items: list[tuple[int, int]]) -> None:
        """A flush commit failed (disk full, ...): the seqs stay gated —
        releasing them would ack rows that are not durable."""
        with self._lock:
            self._pending = items + self._pending

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)


class Flusher:
    """Periodic tier flush; owns the durable-ack release ordering."""

    def __init__(self, db, gate: DurabilityGate | None = None,
                 seq_tracker=None, interval_s: float = 1.0,
                 telemetry=None) -> None:
        self.db = db
        self.gate = gate
        self.seq_tracker = seq_tracker  # the receiver's (release target)
        self.interval_s = interval_s
        # private floor bookkeeping: same contiguity algebra as the
        # receiver's tracker, but advanced BEFORE the commit so the
        # manifest can carry the floors the release will create
        self._floors = SeqAckTracker()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._flush_lock = threading.Lock()  # run loop vs final flush
        # spare-core policy: zlib in the flusher thread only pays when a
        # core is free to run it — on a single-core host the deflate
        # serializes straight against the ingest hot path
        self.compress = (os.cpu_count() or 1) > 1
        self.stats = {"flushes": 0, "rows_flushed": 0, "seqs_released": 0,
                      "errors": 0, "flush_ns": 0}
        # wall ms of the last commits that wrote rows
        self._commit_ms: deque = deque(maxlen=4096)
        # consecutive failed commits (disk full, I/O error): drives the
        # run loop's bounded exponential backoff AND the write-pressure
        # signal Server._flusher_backlog feeds the PressureController —
        # sustained write failure sheds load at the agents instead of
        # letting the gate grow without bound. Reset on the first
        # successful flush.
        self.consec_errors = 0
        self._telemetry = telemetry or Telemetry("server", enabled=False)

    def seed_floors(self, floors: dict[int, int],
                    parked: dict[int, list[int]] | None = None) -> None:
        for agent_id, contig in floors.items():
            self._floors.seed(agent_id, contig)
        for agent_id, seqs in (parked or {}).items():
            for seq in seqs:
                self._floors.observe(agent_id, seq)

    def flush_once(self, seal: bool | None = None) -> int:
        """One gate-drain + commit + release cycle (also the final drain
        on stop). Returns rows committed.

        ``seal`` controls whether open stripe buffers are force-sealed
        into the commit. Default (None) is group-commit: seal only when
        drained acks are actually waiting on durability — idle cycles
        then flush naturally-sealed chunks without chopping the ingest
        hot path's open buffers into per-interval slivers. stop() and
        explicit callers force True."""
        with self._flush_lock:
            t0 = time.perf_counter_ns()
            gate = self.gate
            with gate.cut() if gate is not None else nullcontext():
                pend = gate.drain() if gate is not None else []
                if seal is None:
                    seal = bool(pend)
                self.db.stage_flush(seal=seal)
            floors = parked = None
            if pend:
                for agent_id, seq in pend:
                    self._floors.observe(agent_id, seq)
                floors = self._floors.snapshot()
                parked = self._floors.parked()
            try:
                rows = self.db.flush_to_tier(ack_floors=floors, seal=seal,
                                             compress=self.compress,
                                             stage=False, ack_parked=parked)
            except Exception:
                self.stats["errors"] += 1
                self.consec_errors += 1
                if pend and self.gate is not None:
                    self.gate.requeue(pend)
                raise
            self.consec_errors = 0
            # release: the acks now describe durable state
            if self.seq_tracker is not None:
                for agent_id, seq in pend:
                    self.seq_tracker.observe(agent_id, seq)
            dt = time.perf_counter_ns() - t0
            self.stats["flushes"] += 1
            self.stats["rows_flushed"] += rows
            self.stats["seqs_released"] += len(pend)
            self.stats["flush_ns"] += dt
            if rows:
                self._commit_ms.append(dt / 1e6)
            return rows

    def commit_ms_quantiles(self) -> dict:
        """{n, p50, p99, max} of the wall ms of the last commits that
        wrote rows (drain, commit and release)."""
        ms = sorted(self._commit_ms)
        if not ms:
            return {"n": 0, "p50": None, "p99": None, "max": None}
        return {"n": len(ms), "p50": ms[(len(ms) - 1) // 2],
                "p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
                "max": ms[-1]}

    def start(self) -> "Flusher":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="df-flusher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Final flush AFTER the decoders drained: everything they wrote
        (and parked) becomes durable and acked before the server exits."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.flush_once(seal=True)
        except Exception:
            log.exception("final tier flush failed")

    def _run(self) -> None:
        hb = self._telemetry.heartbeat(
            "flusher", interval_hint_s=max(1.0, self.interval_s))
        hb.beat()
        while True:
            # bounded exponential backoff after failed commits: a full
            # disk gets probed at 1x, 2x, 4x ... up to 30s, not hammered
            # every interval; gate entries stay parked (acks withheld)
            # so the transport spool absorbs the stall
            wait = self.interval_s
            if self.consec_errors:
                wait = min(self.interval_s * (2 ** min(
                    self.consec_errors, 6)), 30.0)
            if self._stop.wait(wait):
                return
            hb.beat(progress=self.stats["flushes"])
            try:
                self.flush_once()
            except Exception:
                log.exception("tier flush failed (attempt %d)",
                              self.consec_errors)


class Compactor:
    """Periodic tier compaction: merges the flusher's small sealed
    segments into time-sorted format-v2 runs (store/tiered.py compact).
    Runs well below the flush cadence — each cycle is one crash-safe
    manifest commit per merge group, and any v1 segments it meets are
    migrated to v2 as a side effect (online migrate-on-compact), so a
    long-lived server converges to all-v2 with zero downtime."""

    def __init__(self, db, interval_s: float = 60.0,
                 telemetry=None) -> None:
        self.db = db
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"cycles": 0, "runs_built": 0,
                      "segments_replaced": 0, "rows": 0,
                      "segments_migrated": 0, "errors": 0,
                      "compact_ns": 0}
        self._telemetry = telemetry or Telemetry("server", enabled=False)

    def compact_once(self) -> dict:
        """One full-database compaction pass (also the dfctl/test entry
        point). Builds on the shared query pool when one is configured."""
        from deepflow_tpu_torch.query.pool import get_pool
        t0 = time.perf_counter_ns()
        res = self.db.compact_tier(pool=get_pool())
        self.stats["cycles"] += 1
        for k in ("runs_built", "segments_replaced", "rows",
                  "segments_migrated"):
            self.stats[k] += res.get(k, 0)
        self.stats["compact_ns"] += time.perf_counter_ns() - t0
        return res

    def start(self) -> "Compactor":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="df-compactor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        hb = self._telemetry.heartbeat(
            "compactor", interval_hint_s=max(1.0, self.interval_s))
        hb.beat()
        while not self._stop.wait(self.interval_s):
            hb.beat(progress=self.stats["cycles"])
            try:
                self.compact_once()
            except Exception:
                self.stats["errors"] += 1
                log.exception("tier compaction failed")
