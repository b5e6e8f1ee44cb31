"""Device span and memory sources for CUDA.

- KinetoSource: step-adaptive torch.profiler (Kineto / CUPTI) captures
  parsed into per-kernel spans; port of the reference's XPlaneSource.
- MemorySource: per-device allocator statistics from the caching
  allocator; port of the reference's MemorySource.
"""

from __future__ import annotations

import collections
import logging
import os
import shutil
import tempfile
import threading
import time

from deepflow_tpu_torch.tpuprobe.events import TpuSpanEvent
from deepflow_tpu_torch.tpuprobe.kineto import (
    extract_device_spans, load_trace)

log = logging.getLogger("df.tpuprobe")

# Kineto's session is process-global: our own capture must never collide
# with a second source in this process, and a session started by USER code
# must make us skip, not crash (starting a second session from another
# thread silently tears down the first one's and can crash at its exit)
_PROFILER_SESSION_LOCK = threading.Lock()


def _user_profiler_active() -> bool:
    """True while any torch.profiler / autograd.profiler session of this
    process is open: torch keeps one process-global flag for them."""
    from torch.autograd import profiler as ap
    return bool(ap._is_profiler_enabled)


class StepHook:
    """Zero-code step signal: a global optimizer step post-hook that
    records (step number, wall-clock ns) for every optimizer.step() in the
    process. Steps count from 1 at install()."""

    MAX_MARKS = 4096   # far more steps than one capture window holds

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._marks: collections.deque = collections.deque(
            maxlen=self.MAX_MARKS)
        self._count = 0
        self._handle = None

    def install(self) -> "StepHook":
        from torch.optim.optimizer import register_optimizer_step_post_hook
        if self._handle is None:
            self._handle = register_optimizer_step_post_hook(self._on_step)
        return self

    def remove(self) -> None:
        if self._handle is not None:
            self._handle.remove()
            self._handle = None

    def _on_step(self, optimizer, args, kwargs) -> None:
        now = time.time_ns()
        with self._lock:
            self._count += 1
            self._marks.append((self._count, now))

    def since(self, t_ns: int) -> list[tuple[int, int]]:
        """Marks at or after t_ns, plus the last one before it (which
        bounds the first step of the window from below)."""
        with self._lock:
            marks = list(self._marks)
        out = [m for m in marks if m[1] >= t_ns]
        before = [m for m in marks if m[1] < t_ns]
        return before[-1:] + out


class KinetoSource:
    """Step-adaptive torch.profiler capture from inside the workload.

    The probe's daemon thread opens a CUDA-only Kineto session (no CPU
    activity, the counterpart of host_tracer_level=0): CUPTI's activity
    records are process-wide, so kernels the training thread launches are
    captured. Each capture measures the step cadence from its own
    per-step module spans; the next window covers `steps_per_capture`
    whole steps and the gap is set so `target_coverage` of all steps are
    captured, net of the measured per-cycle dead time (start, stop,
    export and parse). Without step signal (no optimizer in the process)
    the fallback cadence holds.

    Contention guard: a window that would collide with a user's own
    profiler session, or another source, is skipped and counted as
    `contended`, never raised.
    """

    def __init__(self, sink, interval_s: float = 10.0,
                 duration_ms: int = 1000,
                 target_coverage: float = 0.5,
                 steps_per_capture: int = 20,
                 min_duration_ms: int = 200,
                 max_duration_ms: int = 4000,
                 min_gap_ms: int = 200) -> None:
        self.sink = sink
        self.interval_s = interval_s        # fallback cadence (no steps yet)
        self.duration_ms = duration_ms
        self.target_coverage = min(max(target_coverage, 0.05), 0.95)
        self.steps_per_capture = steps_per_capture
        self.min_duration_ms = min_duration_ms
        self.max_duration_ms = max_duration_ms
        self.min_gap_ms = min_gap_ms
        self.step_hook = StepHook()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step_time_s = 0.0             # estimated from module spans
        self._captured_s = 0.0
        # per-cycle dead time: session start + stop + export + parse; the
        # real cycle is dead + window + gap, so the gap shrinks by it and
        # windows stretch to amortize it
        self._dead_s = 0.0
        self._started_monotonic = time.monotonic()
        self.stats = {"captures": 0, "events": 0, "errors": 0, "skipped": 0,
                      "contended": 0, "steps_seen": 0,
                      "coverage_pct": 0.0, "est_step_ms": 0.0,
                      "captured_s": 0.0, "dead_ms": 0.0}

    def available(self) -> bool:
        """Capture only once the workload has initialised CUDA itself:
        the probe never creates a CUDA context on its own."""
        import torch
        return torch.cuda.is_initialized()

    def start(self) -> "KinetoSource":
        self.step_hook.install()
        self._started_monotonic = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="df-tpuprobe-kineto", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            # a window runs up to max_duration_ms, plus export+parse+sink
            self._thread.join(timeout=max(2.0, self.duration_ms / 1000 + 2,
                                          self.max_duration_ms / 1000 + 10))
        self.step_hook.remove()

    def _run(self) -> None:
        # first capture soon after attach, then on the adaptive cadence
        if self._stop.wait(1.0):
            return
        while not self._stop.is_set():
            if self.available():
                try:
                    self.capture_once()
                except Exception:
                    self.stats["errors"] += 1
                    log.exception("kineto capture failed")
            else:
                self.stats["skipped"] += 1
            if self._stop.wait(self._next_gap_s()):
                return

    def _next_duration_s(self) -> float:
        """Window sized to cover `steps_per_capture` whole steps, and at
        least long enough that the per-cycle dead time plus the minimum
        gap fit in the uncovered share (coverage = dur/(dur+dead+gap))."""
        if self._step_time_s <= 0:
            return self.duration_ms / 1000.0
        want = self._step_time_s * self.steps_per_capture
        t = self.target_coverage
        amortize = t * (self._dead_s + self.min_gap_ms / 1000.0) / (1.0 - t)
        want = max(want, amortize)
        return min(max(want, self.min_duration_ms / 1000.0),
                   self.max_duration_ms / 1000.0)

    def _next_gap_s(self) -> float:
        """Gap between windows for the target step coverage, net of the
        measured dead time."""
        if self._step_time_s <= 0:
            return self.interval_s  # cadence unknown: conservative fallback
        dur = self._next_duration_s()
        gap = dur * (1.0 / self.target_coverage - 1.0) - self._dead_s
        return max(gap, self.min_gap_ms / 1000.0)

    def _observe(self, events: list, wall_s: float) -> None:
        """Update the step-cadence estimate from a capture's module spans."""
        steps = {(e.hlo_module, e.run_id) for e in events
                 if e.run_id and not e.hlo_op}
        n = len(steps)
        self.stats["steps_seen"] += n
        if n >= 2 and wall_s > 0:
            est = wall_s / n
            # EWMA: workloads change phase (warm-up, eval, checkpoints)
            self._step_time_s = (est if self._step_time_s <= 0 else
                                 0.5 * self._step_time_s + 0.5 * est)
            self.stats["est_step_ms"] = round(self._step_time_s * 1000, 2)
        self.stats["captured_s"] = round(self._captured_s, 3)
        elapsed = time.monotonic() - self._started_monotonic
        if elapsed > 0:
            self.stats["coverage_pct"] = round(
                100.0 * self._captured_s / elapsed, 1)

    def capture_once(self) -> list[TpuSpanEvent]:
        if not _PROFILER_SESSION_LOCK.acquire(blocking=False):
            self.stats["contended"] += 1
            return []
        try:
            if _user_profiler_active():
                self.stats["contended"] += 1
                return []
            return self._capture_locked()
        finally:
            _PROFILER_SESSION_LOCK.release()

    def _capture_locked(self) -> list[TpuSpanEvent]:
        from torch.profiler import ProfilerActivity, profile

        tmpdir = tempfile.mkdtemp(prefix="dftorch-kineto-")
        t0 = time.monotonic()
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            # the covered span is the open-session wait only: start
            # setup, stop, export and parse are dead time
            window_t0 = time.monotonic()
            window_wall_ns = time.time_ns()
            self._stop.wait(self._next_duration_s())
            window_t1 = time.monotonic()
            prof.stop()
            t_stopped = time.monotonic()
            path = os.path.join(tmpdir, "trace.json")
            prof.export_chrome_trace(path)
            t_exported = time.monotonic()
            window_s = window_t1 - window_t0
            self._captured_s += window_s
            events = extract_device_spans(
                load_trace(path), self.step_hook.since(window_wall_ns))
            t_parsed = time.monotonic()
            self.stats["captures"] += 1
            self.stats["events"] += len(events)
            # the last cycle's dead time by phase, and its EWMA
            self.stats.update(
                last_start_ms=round((window_t0 - t0) * 1000, 1),
                last_stop_ms=round((t_stopped - window_t1) * 1000, 1),
                last_export_ms=round((t_exported - t_stopped) * 1000, 1),
                last_parse_ms=round((t_parsed - t_exported) * 1000, 1))
            dead = max(0.0, (t_parsed - t0) - window_s)
            self._dead_s = (dead if self._dead_s <= 0
                            else 0.5 * self._dead_s + 0.5 * dead)
            self.stats["dead_ms"] = round(self._dead_s * 1000, 1)
            self._observe(events, window_s)
            if events:
                self.sink(events)
            return events
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)


def memory_sample(timestamp_ns: int, device_id: int, stats: dict,
                  free_bytes: int, largest_cached_free: int) -> dict:
    """One ``profile.tpu_memory`` sample from the caching allocator's
    statistics (``torch.cuda.memory_stats``) and the device's free bytes
    (``torch.cuda.mem_get_info``).

    - bytes_in_use / peak: live tensor bytes (allocated_bytes.all).
    - bytes_limit: what the allocator can reach, its reserved segments
      plus the device's free memory.
    - largest_free_block: torch keeps no such statistic. The largest
      request that can succeed without an out-of-memory error is served
      either from a free block inside a reserved segment (the largest
      inactive block of ``torch.cuda.memory_snapshot()``) or by a new
      segment from CUDA (the device's free bytes), so it is the larger of
      the two.
    - num_allocs: live allocations (allocation.all.current).
    """
    reserved = int(stats.get("reserved_bytes.all.current", 0))
    return {
        "timestamp_ns": timestamp_ns,
        "device_id": device_id,
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": reserved + int(free_bytes),
        "largest_free_block": max(int(free_bytes), int(largest_cached_free)),
        "num_allocs": int(stats.get("allocation.all.current", 0)),
    }


def largest_inactive_blocks(snapshot: list) -> dict[int, int]:
    """device -> size of the largest free (inactive) block in the caching
    allocator's reserved segments, from torch.cuda.memory_snapshot()."""
    out: dict[int, int] = {}
    for seg in snapshot:
        dev = int(seg.get("device", 0))
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "inactive":
                out[dev] = max(out.get(dev, 0), int(blk.get("size", 0)))
    return out


class MemorySource:
    """Per-device memory timeline from allocator statistics.

    Polls each CUDA device this process has reserved memory on, at a fixed
    cadence: statistics reads only, no device sync. A process that has
    not initialised CUDA is never given a context by the probe."""

    def __init__(self, sink, poll_interval_s: float = 5.0) -> None:
        self.sink = sink
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"polls": 0, "samples": 0, "errors": 0}

    def poll_once(self) -> list[dict]:
        import torch
        samples = []
        if torch.cuda.is_initialized():
            ts = time.time_ns()
            per_dev = [(i, torch.cuda.memory_stats(i))
                       for i in range(torch.cuda.device_count())]
            used = [(i, st) for i, st in per_dev
                    if st.get("reserved_bytes.all.current", 0)]
            largest = (largest_inactive_blocks(torch.cuda.memory_snapshot())
                       if used else {})
            for i, st in used:
                free, _total = torch.cuda.mem_get_info(i)
                samples.append(memory_sample(ts, i, st, free,
                                             largest.get(i, 0)))
        self.stats["polls"] += 1
        self.stats["samples"] += len(samples)
        if samples:
            self.sink(samples)
        return samples

    def start(self) -> "MemorySource":
        self._thread = threading.Thread(
            target=self._run, name="df-tpuprobe-memory", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3.0)

    def _run(self) -> None:
        if self._stop.wait(1.0):
            return
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                self.stats["errors"] += 1
                log.exception("memory poll failed")
            if self._stop.wait(self.poll_interval_s):
                return
