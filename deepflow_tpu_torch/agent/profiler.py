"""In-process OnCPU profiler: periodic Python stack sampling.

Own copy of ``deepflow_tpu/agent/profiler.py``: a sampler thread walks
every Python thread's frame stack at ``hz``, folds the frames into
"module.function" strings (root;...;leaf), counts (thread, stack) over an
emit window and hands the batch to a sink. The agent's own threads (names
starting "df-") are left out.

A sample is off-cpu when its leaf function is a blocking call (wait,
recv, sleep, ...) and on-cpu otherwise. A training thread that waits for
the GPU inside a C call (``float(loss)``, ``torch.cuda.synchronize()``)
shows its Python caller as the leaf, so that time counts as on-cpu, as
in the reference.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from dataclasses import dataclass

log = logging.getLogger("df.profiler")


@dataclass
class ProfileSample:
    timestamp_ns: int
    pid: int
    tid: int
    thread_name: str
    stack: str          # folded: root;...;leaf
    count: int
    value_us: int       # count * sample period
    event_type: str = "on-cpu"
    profiler: str = "pysampler"


@dataclass
class SamplerStats:
    samples: int = 0
    emits: int = 0
    overruns: int = 0   # a sampling tick came later than one period
    last_emit_stacks: int = 0


# leaf functions that mean the thread is parked, not running
_BLOCKING_LEAVES = frozenset({
    "wait", "get", "put", "sleep", "select", "poll", "epoll", "kqueue",
    "accept", "recv", "recvfrom", "recv_into", "read", "readinto", "readline",
    "acquire", "join", "wait_for", "settimeout", "flush", "dowait",
    "_recv_bytes", "poll_once", "getaddrinfo", "connect", "sendall",
})


def classify_sample(stack: str) -> str:
    """on-cpu vs off-cpu by the leaf frame (module.func -> func)."""
    leaf = stack.rsplit(";", 1)[-1]
    func = leaf.rsplit(".", 1)[-1]
    return "off-cpu" if func in _BLOCKING_LEAVES else "on-cpu"


def fold_frame(frame) -> str:
    return f"{frame.f_globals.get('__name__', '?')}.{frame.f_code.co_name}"


def fold_stack(frame, max_depth: int = 128) -> str:
    """Walk frame -> outermost and return root;...;leaf."""
    frames = []
    while frame is not None and len(frames) < max_depth:
        frames.append(fold_frame(frame))
        frame = frame.f_back
    return ";".join(reversed(frames))


class OnCpuSampler:
    """99 Hz (default) Python stack sampler with windowed aggregation."""

    def __init__(self, sink, hz: float = 99.0,
                 emit_interval_s: float = 1.0) -> None:
        self.sink = sink
        self.period_s = 1.0 / hz
        self.period_us = int(1_000_000 / hz)
        self.emit_interval_s = emit_interval_s
        self.stats = SamplerStats()
        self._agg: dict[tuple[int, str], int] = {}
        self._thread_names: dict[int, str] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.pid = os.getpid()

    def start(self) -> "OnCpuSampler":
        self._thread = threading.Thread(
            target=self._run, name="df-oncpu-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self._emit()  # the tail window

    def _run(self) -> None:
        my_tid = threading.get_ident()
        next_tick = time.monotonic()
        next_emit = next_tick + self.emit_interval_s
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_tick:
                self._sample(my_tid)
                next_tick += self.period_s
                if now - next_tick > self.period_s:
                    # fell behind (interpreter-lock contention): skip the
                    # missed ticks
                    self.stats.overruns += 1
                    next_tick = now + self.period_s
                if now >= next_emit:
                    self._emit()
                    next_emit = now + self.emit_interval_s
            time.sleep(max(0.0, min(next_tick - time.monotonic(),
                                    self.period_s)))

    def _sample(self, my_tid: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == my_tid:
                continue
            name = names.get(tid, str(tid))
            if name.startswith("df-"):
                continue  # the agent's own threads
            stack = fold_stack(frame)
            if not stack:
                continue
            key = (tid, stack)
            self._agg[key] = self._agg.get(key, 0) + 1
            self._thread_names[tid] = name
            self.stats.samples += 1

    def _emit(self) -> None:
        if not self._agg:
            return
        agg, self._agg = self._agg, {}
        ts = time.time_ns()
        batch = [
            ProfileSample(
                timestamp_ns=ts, pid=self.pid, tid=tid,
                thread_name=self._thread_names.get(tid, str(tid)),
                stack=stack, count=n, value_us=n * self.period_us,
                event_type=classify_sample(stack))
            for (tid, stack), n in agg.items()]
        self.stats.emits += 1
        self.stats.last_emit_stacks = len(batch)
        try:
            self.sink(batch)
        except Exception:
            # a failing sink must never end the sampler
            log.exception("profile sink failed")
