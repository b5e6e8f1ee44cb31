"""Device span and memory sources for CUDA.

- KinetoSource: step-adaptive torch.profiler (Kineto / CUPTI) captures
  parsed into per-kernel spans; port of the reference's XPlaneSource.
- MemorySource: per-device allocator statistics from the caching
  allocator; port of the reference's MemorySource.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import math
import os
import shutil
import tempfile
import threading
import time

from deepflow_tpu_torch.telemetry import Telemetry
from deepflow_tpu_torch.tpuprobe.comms import CALLS
from deepflow_tpu_torch.tpuprobe.events import TpuSpanEvent
from deepflow_tpu_torch.tpuprobe.kineto import extract_device_spans, load_trace
from deepflow_tpu_torch.tpuprobe.ranks import global_rank, world_size

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
    process. Steps count from 1 at install(). It can also hold the next
    step's thread in the hook for a while (``held``), and counts the CPU
    time the holding threads spend while it holds (``held_cpu_s``).
    ``on_first_step`` is called once, on the training thread, at step 1."""

    MAX_MARKS = 4096   # far more steps than one capture window holds
    MAX_HOLD_S = 30.0  # a held step never waits longer than this

    def __init__(self, on_first_step=None) -> None:
        self.on_first_step = on_first_step
        self._lock = threading.Lock()
        self._marks: collections.deque = collections.deque(
            maxlen=self.MAX_MARKS)
        self._count = 0
        self._handle = None
        # (parked, release) of the hold the next step takes
        self._hold: tuple[threading.Event, threading.Event] | None = None
        self._held_cpu_s = 0.0
        # (CPU clock, its reading at the start) of the held body running
        self._holding: tuple[int, float] | None = None

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
            first = self._count == 1
            self._marks.append((self._count, now))
            hold = self._hold
            if hold is not None and self._count % hold[2] == 0:
                self._hold = None
            else:
                hold = None
        if first and self.on_first_step is not None:
            try:
                self.on_first_step()
            except Exception:  # never break the workload's step
                log.exception("first-step callback failed")
        if hold is not None:
            parked, release, _ = hold
            parked.set()
            release.wait(self.MAX_HOLD_S)

    @contextlib.contextmanager
    def held(self, timeout_s: float, cancel: threading.Event | None = None,
             every: int = 1):
        """Hold the thread of the next optimizer step in its step hook for
        the body of the with-block (with ``every`` > 1, of the next step
        whose number is a multiple of it). Yields True once it is held:
        backward has finished and the optimizer's work is launched, so no
        thread of a plain training loop launches device work until the
        body ends. Yields False when no such step came within timeout_s
        or ``cancel`` was set first; the body then runs beside the
        workload. The CPU time this thread spends in a held body adds to
        ``held_cpu_s``, as it goes."""
        parked, release = threading.Event(), threading.Event()
        with self._lock:
            self._hold = (parked, release, max(1, int(every)))
        took, cpu0 = False, 0.0
        try:
            deadline = time.monotonic() + timeout_s
            while not parked.wait(0.05):
                if time.monotonic() >= deadline or (cancel is not None
                                                    and cancel.is_set()):
                    break
            with self._lock:
                mine = self._hold is not None and self._hold[0] is parked
                if mine:
                    self._hold = None
            # a step that took the hold just now parks at once
            took = parked.is_set() or (not mine and parked.wait(1.0))
            cpu0 = time.thread_time()
            if took:
                with self._lock:
                    self._holding = (time.pthread_getcpuclockid(
                        threading.get_ident()), cpu0)
            yield took
        finally:
            spent = time.thread_time() - cpu0 if took else 0.0
            release.set()
            with self._lock:
                self._held_cpu_s += spent
                self._holding = None

    @property
    def held_cpu_s(self) -> float:
        """CPU seconds the holding threads spent in held bodies: work
        done while the training thread waited in the hook, so it took no
        core from the workload. A body still running counts what it has
        spent so far: a guard check that falls inside a held export and
        parse (seconds long) must not read that work as the agent's."""
        with self._lock:
            if self._holding is None:
                return self._held_cpu_s
            clock, cpu0 = self._holding
            return self._held_cpu_s + max(
                0.0, time.clock_gettime(clock) - cpu0)

    @property
    def count(self) -> int:
        """Optimizer steps since install()."""
        with self._lock:
            return self._count

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

    Step boundaries: with step signal, the session opens and closes
    while the next optimizer step's thread is held in the step hook, so
    no workload thread launches work meanwhile. Sessions set up or closed
    beside launching threads (the probe's own thread under the agent)
    sometimes left one launching thread without device records for the
    rest of the process. The same hold covers the export, the JSON load
    and the extraction of spans after the stop: the first two are C
    calls that keep the interpreter lock throughout, the extraction is
    Python that keeps it most of the time, so the training thread made
    little progress beside them anyway (PERF.md, slice 1). Parked at a step
    boundary it waits for them where a resource guard can see whose
    place they take (``StepHook.held_cpu_s``). A session opened or
    closed with no step to hold (none within three step times, or the
    workload is done) is counted as `unheld`. The step held at a stop is
    left out of the capture's spans: its kernels were launched just
    before the stop and most still run, and a capture loses some of them
    even after a synchronize (26 of 1,788 on one H100, nearly all on a
    rank of four; PERF.md, slice 8), so a window ships the whole steps
    before it. Its first step is left out too when the profiler lost the
    device record of one of its first launches (their launch records
    stay; 4 of 8 ResNet-50 captures on one H100 were short by 2 to 5
    kernels, PERF.md, slice 15); ``partial_first_steps`` counts them.

    Ranks of a data-parallel job (a launcher's WORLD_SIZE, or the default
    process group's, above 1): a rank that holds its step stalls every
    other rank at their next collective, so captures on their own clocks
    stall the job once per rank, and the stalls push the ranks' windows
    apart (on four H100s they settled on alternate windows, no step
    captured by all). So the step count sets their cycle: a window is
    `steps_per_capture` (W) steps, from a step numbered a multiple of
    P = W * 2**ceil(log2(1 / target_coverage)) to the next multiple of
    W (`period_steps` in the stats; P and W are the same on every rank,
    and no measurement enters them), so ranks in lockstep hold together
    and capture the same whole steps. A rank waits StepHook.MAX_HOLD_S
    beyond P step times for its boundary step, which a peer's hold may
    delay.

    Contention guard: a window that would collide with a user's own
    profiler session, or another source, is skipped and counted as
    `contended`, never raised.

    ``retune`` (the controller's pushed config) changes the cadence
    between captures, never inside one: the values wait until the
    capture in progress ends, and a gap in progress is measured again
    with them.
    """

    def __init__(self, sink, interval_s: float = 10.0,
                 duration_ms: int = 1000,
                 target_coverage: float = 0.5,
                 steps_per_capture: int = 20,
                 min_duration_ms: int = 200,
                 max_duration_ms: int = 4000,
                 min_gap_ms: int = 200,
                 telemetry: Telemetry | None = None,
                 step_hook: StepHook | None = None) -> None:
        self.sink = sink
        self.interval_s = interval_s        # fallback cadence (no steps yet)
        self.duration_ms = duration_ms
        self.target_coverage = min(max(target_coverage, 0.05), 0.95)
        self.steps_per_capture = steps_per_capture
        self.min_duration_ms = min_duration_ms
        self.max_duration_ms = max_duration_ms
        self.min_gap_ms = min_gap_ms
        # a hook the caller passes in outlives this source (an agent's
        # keeps counting while the guard has the probe paused, so a
        # resumed probe's steps continue the numbering); one of its own
        # is removed at stop
        self._owns_hook = step_hook is None
        self.step_hook = step_hook or StepHook()
        self._telemetry = telemetry or Telemetry("agent", enabled=False)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step_time_s = 0.0             # estimated from module spans
        self._captured_s = 0.0
        # per-cycle dead time: session start + stop + export + parse; the
        # real cycle is dead + window + gap, so the gap shrinks by it and
        # windows stretch to amortize it
        self._dead_s = 0.0
        self._started_monotonic = time.monotonic()
        self._cuda_up_at: float | None = None  # first seen initialised
        # retune(): cadence waiting for the end of a capture, and the
        # wake-up of a gap in progress
        self._retune_lock = threading.Lock()
        self._pending: dict = {}
        self._wake = threading.Event()
        self.stats = {"captures": 0, "events": 0, "errors": 0, "skipped": 0,
                      "contended": 0, "steps_seen": 0,
                      "coverage_pct": 0.0, "est_step_ms": 0.0,
                      "captured_s": 0.0, "dead_ms": 0.0, "unheld": 0,
                      "period_steps": 0, "retunes": 0,
                      "partial_first_steps": 0,
                      "interval_s": interval_s,
                      "steps_per_capture": steps_per_capture}

    def retune(self, interval_s: float, duration_ms: int,
               target_coverage: float, steps_per_capture: int) -> None:
        """New cadence, taken by the source's thread between captures."""
        with self._retune_lock:
            self._pending = {
                "interval_s": interval_s, "duration_ms": duration_ms,
                "target_coverage": min(max(target_coverage, 0.05), 0.95),
                "steps_per_capture": steps_per_capture}
        self._wake.set()

    def _apply_retune(self) -> None:
        with self._retune_lock:
            pending, self._pending = self._pending, {}
        if pending:
            for k, v in pending.items():
                setattr(self, k, v)
            self.stats["retunes"] += 1
            self.stats["interval_s"] = self.interval_s
            self.stats["steps_per_capture"] = self.steps_per_capture

    def _wait_gap(self) -> bool:
        """Wait out the gap before the next capture, measured again after
        a retune; True when the source stops."""
        t0 = time.monotonic()
        while True:
            left = self._next_gap_s() - (time.monotonic() - t0)
            if left <= 0 or self._stop.is_set():
                return self._stop.is_set()
            self._wake.wait(left)
            self._wake.clear()
            self._apply_retune()

    def available(self) -> bool:
        """Capture only once the workload has initialised CUDA itself (the
        probe never creates a CUDA context on its own) and is past its
        start-up: an optimizer step has run since start(), or, with no
        step signal, one fallback interval has passed since CUDA came up.
        A session opened while a workload launched from the runner was
        still building its model and first step crashed the process on
        the card (SIGSEGV)."""
        import torch
        if not torch.cuda.is_initialized():
            return False
        if self.step_hook.count:
            return True
        now = time.monotonic()
        if self._cuda_up_at is None:
            self._cuda_up_at = now
        return now - self._cuda_up_at >= self.interval_s

    def start(self) -> "KinetoSource":
        # a session's start imports torch._inductor (torch.profiler asks
        # hasattr(torch, "_inductor"), a lazy import that brings in
        # torch._dynamo too). Done from the probe's thread, that import
        # raced the workload's own (an optimizer's first param group
        # imports torch._dynamo) and left the workload a partly
        # initialised module. Import it here, in the attaching thread,
        # before the workload runs; it touches no device.
        import torch._inductor.config  # noqa: F401
        # Kineto tears CUPTI down after every session and sets it up again
        # at the next one (TEARDOWN_CUPTI, on unless set to 0). torch turns
        # that off for CUDA graphs after crashes on re-initialisation, and
        # a runner child with it on hung on an H100 (PERF.md, PR 3). CUPTI
        # stays up between windows unless the user chose otherwise.
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        self.step_hook.install()
        self._started_monotonic = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="df-tpuprobe-kineto", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            # a window runs up to max_duration_ms, plus export+parse+sink
            self._thread.join(timeout=max(2.0, self.duration_ms / 1000 + 2,
                                          self.max_duration_ms / 1000 + 10))
        if self._owns_hook:
            self.step_hook.remove()
        # a stopped source is not a stalled one (a guard pause outlasts
        # the deadman's window)
        self._telemetry.unregister("tpuprobe.kineto")

    def _run(self) -> None:
        # the deadman's window: a longest window plus the fallback gap
        hb = self._telemetry.heartbeat(
            "tpuprobe.kineto",
            interval_hint_s=self.interval_s + self.max_duration_ms / 1000.0)
        hb.beat()
        # first capture soon after attach, then on the adaptive cadence
        if self._stop.wait(1.0):
            return
        while not self._stop.is_set():
            self._apply_retune()  # between captures only
            # beat BEFORE the capture: a capture that never returns
            # freezes the progress counter and trips the deadman
            hb.beat(progress=self.stats["captures"] + self.stats["skipped"])
            if self.available():
                try:
                    self.capture_once()
                except Exception:
                    self.stats["errors"] += 1
                    log.exception("kineto capture failed")
            else:
                self.stats["skipped"] += 1
            if self._wait_gap():
                return

    def _period_steps(self) -> int:
        """P of a data-parallel rank's step-count cycle (the class's
        note); 0 for a lone process."""
        if world_size() <= 1:
            return 0
        return self.steps_per_capture * 2 ** math.ceil(
            math.log2(1.0 / self.target_coverage))

    def _next_duration_s(self) -> float:
        """Window sized to cover `steps_per_capture` whole steps, and at
        least long enough that the per-cycle dead time plus the minimum
        gap fit in the uncovered share (coverage = dur/(dur+dead+gap)).
        A data-parallel rank's window is counted in steps instead."""
        if self._period_steps():
            return 0.0
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
        measured dead time. A data-parallel rank's start waits for its
        step instead."""
        if self._period_steps():
            return self.min_gap_ms / 1000.0
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

    @contextlib.contextmanager
    def _at_step_boundary(self, opening: bool = True):
        """The body runs while the next step's thread is held in the step
        hook, when there is step signal and the workload still steps;
        yields whether it is held. A data-parallel rank holds the step
        that opens or closes its window in the step-count cycle."""
        if not self.step_hook.count or self._stop.is_set():
            yield False
            return
        period = self._period_steps()
        self.stats["period_steps"] = period
        every = (period if opening else self.steps_per_capture) \
            if period else 1
        wait_s = (max(1.0, (2.0 + every) * self._step_time_s)
                  if self._step_time_s > 0 else self.interval_s)
        if period:  # a peer's hold delays this rank's steps
            wait_s += StepHook.MAX_HOLD_S
        with self.step_hook.held(wait_s, cancel=self._stop,
                                 every=every) as held:
            if not held:
                self.stats["unheld"] += 1
            yield held

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
            with self._at_step_boundary(opening=True):
                if self._stop.is_set():
                    return []
                _use_workload_device()
                # calls from here on may have kernels in the capture
                calls_from_ns = time.time_ns()
                prof.start()
            # the covered span is the open session's time: start setup,
            # stop, export and parse are dead time
            window_t0 = time.monotonic()
            window_wall_ns = time.time_ns()
            self._stop.wait(self._next_duration_s())
            path = os.path.join(tmpdir, "trace.json")
            with self._at_step_boundary(opening=False) as held:
                window_t1 = time.monotonic()
                _use_workload_device()
                last_step = self.step_hook.count if held else 0
                prof.stop()
                t_stopped = time.monotonic()
                prof.export_chrome_trace(path)
                t_exported = time.monotonic()
                trace = load_trace(path)
                cpu0 = time.thread_time()
                n_trace = len(trace.get("traceEvents", ()))
                partial: list[int] = []
                events = extract_device_spans(
                    trace, self.step_hook.since(window_wall_ns),
                    rank=global_rank(), calls=CALLS.since(calls_from_ns),
                    comm_sizes=CALLS.sizes(), world=world_size(),
                    dropped=partial)
                self.stats["partial_first_steps"] += len(partial)
                del trace
                t_parsed = time.monotonic()
                cpu1 = time.thread_time()
            window_s = window_t1 - window_t0
            self._captured_s += window_s
            # the step held at the stop is left out (the class's note)
            kept = ([e for e in events if not e.run_id or e.run_id < last_step]
                    if last_step else events)
            self.stats["captures"] += 1
            self.stats["events"] += len(kept)
            # the last cycle's dead time by phase, and its EWMA
            self.stats.update(
                last_start_ms=round((window_t0 - t0) * 1000, 1),
                last_stop_ms=round((t_stopped - window_t1) * 1000, 1),
                last_export_ms=round((t_exported - t_stopped) * 1000, 1),
                last_parse_ms=round((t_parsed - t_exported) * 1000, 1),
                last_extract_cpu_ms=round((cpu1 - cpu0) * 1000, 1),
                last_trace_events=n_trace)
            dead = max(0.0, (t_parsed - t0) - window_s)
            self._dead_s = (dead if self._dead_s <= 0
                            else 0.5 * self._dead_s + 0.5 * dead)
            self.stats["dead_ms"] = round(self._dead_s * 1000, 1)
            self._observe(events, window_s)
            if kept:
                self.sink(kept)
            # this thread's CPU after the hold: its work the guard reads
            self.stats["last_unheld_cpu_ms"] = round(
                (time.thread_time() - cpu1) * 1000, 1)
            return kept
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)


def workload_devices() -> list[int]:
    """The CUDA devices the caching allocator holds memory on: the
    workload's. Allocator statistics only, so no device gets a context."""
    import torch
    return [i for i in range(torch.cuda.device_count())
            if torch.cuda.memory_stats(i).get("reserved_bytes.all.current")]


def _use_workload_device() -> None:
    """Make the workload's (first) device the current one of this, the
    probe's, thread. A session's stop synchronizes the calling thread's
    current device, device 0 in a thread that never chose one: a rank on
    cuda:2 waited for GPU 0 instead of its own and gave its process a
    context on GPU 0."""
    import torch
    devices = workload_devices()
    if devices and devices[0] != torch.cuda.current_device():
        torch.cuda.set_device(devices[0])


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
    not initialised CUDA is never given a context by the probe. A sample's
    device_id is its process's global rank when it has one, as its spans'
    (``ranks.py``), else the CUDA ordinal."""

    def __init__(self, sink, poll_interval_s: float = 5.0,
                 telemetry: Telemetry | None = None) -> None:
        self.sink = sink
        self.poll_interval_s = poll_interval_s
        self._telemetry = telemetry or Telemetry("agent", enabled=False)
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
            rank = global_rank()
            for i, st in used:
                free, _total = torch.cuda.mem_get_info(i)
                samples.append(memory_sample(
                    ts, i if rank is None else rank, st, free,
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
        self._telemetry.unregister("tpuprobe.memory")

    def _run(self) -> None:
        hb = self._telemetry.heartbeat(
            "tpuprobe.memory", interval_hint_s=self.poll_interval_s)
        hb.beat()
        if self._stop.wait(1.0):
            return
        while not self._stop.is_set():
            # beat before the poll: a memory_stats() call that never
            # returns shows as a stall
            hb.beat(progress=self.stats["polls"])
            try:
                self.poll_once()
            except Exception:
                self.stats["errors"] += 1
                log.exception("memory poll failed")
            if self._stop.wait(self.poll_interval_s):
                return
