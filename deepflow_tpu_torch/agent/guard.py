"""Resource guard: the agent polices its own CPU and memory footprint.

Own copy of ``deepflow_tpu/agent/guard.py``. A breach pauses the
profilers (the compressible load), a recovery resumes them, and
``_evaluate`` is the reference's decision logic unchanged: the limits,
the 0.8 recovery ratio on CPU, memory recovery against the hard limit,
the exception bitmap and ``gc.collect`` on a memory breach.

What the guard reads differs from the reference on purpose. The
reference reads ``/proc/self``, the whole process. Attached in process,
as the runner attaches it, that process is the training job: its
training thread alone runs near one CPU-second per wall-second and its
host memory (the CUDA context, the model's host side) sits far above
2048 MB, so the profilers would pause at the first check and never come
back. Here:

* ``cpu_pct`` is the CPU time of the agent's own threads (utime + stime
  of ``/proc/self/task/<tid>/stat`` over the native ids of the threads
  the agent started) per wall second, less what they spent while the
  training thread waited in the probe's step hook (the hook's
  ``held_cpu_s``: opening a capture session, closing it, exporting and
  loading its trace). That work
  takes the parked training thread's place and no core from the
  workload; the whole reading, with it, is ``threads_cpu_pct``. Work the
  agent causes on the workload's threads is in neither: CUPTI callbacks
  on launching threads, libkineto's own threads, the interpreter lock a
  capture holds.
* ``rss_mb`` is the process RSS less the RSS at the workload's first
  optimizer step (the probe's step hook reports it); until a first step
  comes, if one ever does (an agent without a probe, or a workload with
  no optimizer), less the RSS at the guard's first check. Later growth
  of the workload's own host memory counts in it too.

``read_self_usage()`` stays the whole process: its numbers ride in the
stats row beside the agent's own (``proc_cpu_pct``, ``proc_rss_mb``).
"""

from __future__ import annotations

import logging
import os
import threading
import time

log = logging.getLogger("df.guard")

_CLK_TCK = os.sysconf("SC_CLK_TCK")
_PAGE = os.sysconf("SC_PAGE_SIZE")
_MB = 1024 * 1024

EXC_CPU_LIMIT = 1 << 0
EXC_MEM_LIMIT = 1 << 1


def read_self_usage() -> tuple[float, int]:
    """(cpu_seconds_total, rss_bytes) from /proc/self."""
    with open("/proc/self/stat") as f:
        parts = f.read().rsplit(") ", 1)[1].split()
    utime, stime = int(parts[11]), int(parts[12])
    cpu_s = (utime + stime) / _CLK_TCK
    with open("/proc/self/statm") as f:
        rss_pages = int(f.read().split()[1])
    return cpu_s, rss_pages * _PAGE


def read_thread_cpu(native_id: int) -> float | None:
    """CPU seconds (utime + stime) of one thread of this process, or None
    once the thread is gone."""
    try:
        with open(f"/proc/self/task/{native_id}/stat") as f:
            parts = f.read().rsplit(") ", 1)[1].split()
        return (int(parts[11]) + int(parts[12])) / _CLK_TCK
    except (OSError, IndexError, ValueError):
        return None


class Guard:
    """``agent`` provides ``agent_threads()`` (the threads it started),
    ``pause_profilers()`` and ``resume_profilers()``; optionally
    ``held_cpu_s()`` (CPU seconds its threads spent while the training
    thread was held) and a ``first_step_rss`` attribute (bytes, None
    until the first optimizer step)."""

    def __init__(self, agent, max_cpu_pct: float = 50.0,
                 max_mem_mb: float = 2048.0,
                 check_interval_s: float = 10.0,
                 recover_ratio: float = 0.8) -> None:
        self.agent = agent
        self.max_cpu_pct = max_cpu_pct
        self.max_mem_mb = max_mem_mb
        self.check_interval_s = check_interval_s
        self.recover_ratio = recover_ratio
        self.exception_bitmap = 0
        self.degraded = False
        self.cpu_pct = 0.0          # the agent's threads, less held work
        self.threads_cpu_pct = 0.0  # the agent's threads
        self.rss_mb = 0.0           # RSS above the baseline
        self.proc_cpu_pct = 0.0     # the whole process
        self.proc_rss_mb = 0.0
        self.stats = {"checks": 0, "degrades": 0, "recoveries": 0}
        # (mono, threads cpu_s, held cpu_s, process cpu_s) at the last check
        self._last: tuple[float, float, float, float] | None = None
        self._thread_cpu: dict[threading.Thread, float] = {}
        self._ended_cpu_s = 0.0  # agent threads that have ended
        self._ended_by_name: dict[str, float] = {}
        # CPU seconds per agent thread name at the last check
        self.thread_cpu_s: dict[str, float] = {}
        self.mem_baseline: int | None = None  # bytes
        self._check_lock = threading.Lock()
        # the state after the last whole check: a stats row never shows
        # half a check, and never waits for a pause or resume
        self._snapshot = self._state()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Guard":
        self._thread = threading.Thread(
            target=self._run, name="df-guard", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.check()
            except Exception:
                log.exception("guard check failed")

    def agent_cpu_s(self) -> float:
        """CPU seconds of the agent's threads so far; a thread that has
        ended keeps the last value read for it."""
        live: dict[threading.Thread, float] = {}
        for t in self.agent.agent_threads():
            if t.native_id is None or not t.is_alive():
                continue
            cpu = read_thread_cpu(t.native_id)
            if cpu is not None:
                live[t] = cpu
        for t, cpu in self._thread_cpu.items():
            if t not in live:
                self._ended_cpu_s += cpu
                self._ended_by_name[t.name] = \
                    self._ended_by_name.get(t.name, 0.0) + cpu
        self._thread_cpu = live
        by_name = dict(self._ended_by_name)
        for t, cpu in live.items():
            by_name[t.name] = by_name.get(t.name, 0.0) + cpu
        self.thread_cpu_s = by_name
        return self._ended_cpu_s + sum(live.values())

    def _state(self) -> dict:
        return {"cpu_pct": self.cpu_pct, "rss_mb": self.rss_mb,
                "degraded": int(self.degraded),
                "threads_cpu_pct": self.threads_cpu_pct,
                "proc_cpu_pct": self.proc_cpu_pct,
                "proc_rss_mb": self.proc_rss_mb, **self.stats}

    def snapshot(self) -> dict:
        """The readings, the state and the counters after the last whole
        check (the agent.guard stats row)."""
        return dict(self._snapshot)

    def check(self, now: float | None = None) -> None:
        with self._check_lock:
            self._check(now)
            self._snapshot = self._state()

    def _check(self, now: float | None) -> None:
        self.stats["checks"] += 1
        proc_cpu_s, rss = read_self_usage()
        cpu_s = self.agent_cpu_s()
        held = getattr(self.agent, "held_cpu_s", None)
        held_s = held() if held is not None else 0.0
        mono = now if now is not None else time.monotonic()
        if self._last is not None:
            dt = mono - self._last[0]
            if dt > 0:
                used = cpu_s - self._last[1]
                self.threads_cpu_pct = 100.0 * used / dt
                # /proc counts in clock ticks, the held time in ns
                self.cpu_pct = 100.0 * max(
                    0.0, used - (held_s - self._last[2])) / dt
                self.proc_cpu_pct = 100.0 * (proc_cpu_s - self._last[3]) / dt
        self._last = (mono, cpu_s, held_s, proc_cpu_s)
        step_rss = getattr(self.agent, "first_step_rss", None)
        if step_rss is not None:
            self.mem_baseline = step_rss
        elif self.mem_baseline is None:
            self.mem_baseline = rss  # until a first step, if one comes
        self.rss_mb = max(0, rss - self.mem_baseline) / _MB
        self.proc_rss_mb = rss / _MB
        self._evaluate()

    def _evaluate(self) -> None:
        over_cpu = self.cpu_pct > self.max_cpu_pct
        over_mem = self.rss_mb > self.max_mem_mb
        self.exception_bitmap = ((EXC_CPU_LIMIT if over_cpu else 0)
                                 | (EXC_MEM_LIMIT if over_mem else 0))
        if not self.degraded and (over_cpu or over_mem):
            self.degraded = True
            self.stats["degrades"] += 1
            log.warning("resource limit hit (cpu %.1f%% rss %.0fMB): "
                        "pausing profilers", self.cpu_pct, self.rss_mb)
            self.agent.pause_profilers()
            if over_mem:
                # best-effort reclaim: CPython rarely returns RSS to the OS,
                # so free what we can and judge memory recovery against the
                # hard limit, not the hysteresis bar (see below)
                import gc
                gc.collect()
        elif self.degraded and \
                self.cpu_pct < self.max_cpu_pct * self.recover_ratio and \
                self.rss_mb <= self.max_mem_mb:
            self.degraded = False
            self.stats["recoveries"] += 1
            log.info("resource usage recovered: resuming profilers")
            # degraded is already False: resume_profilers' guard check passes
            self.agent.resume_profilers()
