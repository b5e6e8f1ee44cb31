"""The port's resource guard held against the JAX package's on the CPU:
both ``Guard._evaluate``s on one sequence of readings make the same
decisions, the agent-thread CPU reading counts the agent's threads and
not the workload's nor what they do while the training step is held,
the memory baseline is the first optimizer step's (the first check's
until then), a stats row never waits for a pause,
the profilers stay down while degraded, a pause releases a held step,
and the new config blocks keep the reference's defaults and ranges."""

import gc
import random
import threading
import time
import types

import pytest
import torch

from deepflow_tpu.agent import config as ref_config
from deepflow_tpu.agent import guard as ref_guard
from deepflow_tpu_torch.agent import agent as agent_mod
from deepflow_tpu_torch.agent import config, guard
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.tpuprobe.sources import KinetoSource, StepHook


class _FakeAgent:
    def __init__(self, threads=()) -> None:
        self.calls: list[str] = []
        self.threads = list(threads)

    def pause_profilers(self) -> None:
        self.calls.append("pause")

    def resume_profilers(self) -> None:
        self.calls.append("resume")

    def agent_threads(self):
        return self.threads


def _readings(seed: int, n: int = 200):
    rng = random.Random(seed)
    return [(rng.choice([rng.uniform(0, 30), rng.uniform(30, 45),
                         rng.uniform(39, 41), rng.uniform(45, 200)]),
             rng.choice([rng.uniform(0, 1500), rng.uniform(1900, 2100),
                         2048.0, rng.uniform(2048, 5000)]))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_equals_reference(seed, monkeypatch):
    collects = []
    monkeypatch.setattr(gc, "collect", lambda *a: collects.append(1) or 0)
    mine_agent, ref_agent = _FakeAgent(), _FakeAgent()
    mine = guard.Guard(mine_agent, max_cpu_pct=50.0, max_mem_mb=2048.0)
    ref = ref_guard.Guard(ref_agent, max_cpu_pct=50.0, max_mem_mb=2048.0)
    for cpu, mem in _readings(seed):
        deltas = []
        for g in (mine, ref):
            before = len(collects)
            g.cpu_pct, g.rss_mb = cpu, mem
            g._evaluate()
            deltas.append(len(collects) - before)
        assert deltas[0] == deltas[1]  # gc.collect on a memory breach
        assert (mine.degraded, mine.exception_bitmap, mine.stats) == \
            (ref.degraded, ref.exception_bitmap, ref.stats)
        assert mine_agent.calls == ref_agent.calls
    assert collects
    assert mine.stats["degrades"] >= 2 and mine.stats["recoveries"] >= 1
    assert (guard.EXC_CPU_LIMIT, guard.EXC_MEM_LIMIT) == \
        (ref_guard.EXC_CPU_LIMIT, ref_guard.EXC_MEM_LIMIT)


def test_read_self_usage_equals_reference():
    cpu_a, rss_a = ref_guard.read_self_usage()
    cpu, rss = guard.read_self_usage()
    cpu_b, rss_b = ref_guard.read_self_usage()
    assert cpu_a <= cpu <= cpu_b
    assert rss > 10 << 20 and abs(rss - rss_a) < 64 << 20


def _spin(cpu_s: float) -> None:
    """Spend cpu_s of this thread's CPU time in Python."""
    t0 = time.thread_time()
    while time.thread_time() - t0 < cpu_s:
        sum(i * i for i in range(2000))


def _burn(cpu_s: float, park: threading.Event, pure_python: bool) -> None:
    """Spend cpu_s of this thread's CPU time, then park. The workload's
    kind hashes with the interpreter lock released, so both threads
    really run at once."""
    import hashlib
    data = b"x" * (1 << 20)
    t0 = time.thread_time()
    while time.thread_time() - t0 < cpu_s:
        if pure_python:
            sum(i * i for i in range(2000))
        else:
            hashlib.sha256(data).digest()
    park.wait(30.0)


def test_agent_cpu_counts_agent_threads_not_the_workload():
    park = threading.Event()
    mine = threading.Thread(target=_burn, args=(0.3, park, True),
                            name="df-busy")
    workload = threading.Thread(target=_burn, args=(0.3, park, False),
                                name="trainer")
    fake = _FakeAgent([mine])
    g = guard.Guard(fake, max_cpu_pct=10_000, max_mem_mb=1 << 20)
    g.check(now=100.0)
    proc0 = guard.read_self_usage()[0]
    try:
        for t in (mine, workload):
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                guard.read_thread_cpu(mine.native_id) >= 0.3
                and guard.read_thread_cpu(workload.native_id) >= 0.3):
            time.sleep(0.02)
        mine_cpu = guard.read_thread_cpu(mine.native_id)
        g.check(now=101.0)  # one wall second on the injected clock
        proc_s = guard.read_self_usage()[0] - proc0
        assert g.agent_cpu_s() == pytest.approx(mine_cpu, abs=0.02)
        assert g.cpu_pct == pytest.approx(100.0 * mine_cpu, abs=2.0)
        assert g.cpu_pct >= 28.0
        assert g.threads_cpu_pct == g.cpu_pct  # nothing held
        # the workload thread's 0.3 s is in the process number only
        assert g.proc_cpu_pct - g.cpu_pct >= 28.0
        assert proc_s >= mine_cpu + 0.28
        assert not g.degraded
    finally:
        park.set()
        for t in (mine, workload):
            t.join(timeout=10.0)
    assert not mine.is_alive() and not workload.is_alive()
    # an ended agent thread keeps its CPU time in the reading
    assert g.agent_cpu_s() == pytest.approx(mine_cpu, abs=0.02)



def test_thread_cpu_by_name_adds_up_to_the_reading():
    """The per-thread CPU the stats row carries (agent.guard.threads):
    one entry per agent thread name, adding up to the guard's total, and
    an ended thread keeps its entry."""
    park = threading.Event()
    busy = [threading.Thread(target=_burn, args=(cpu, park, True),
                             name=name)
            for name, cpu in (("df-a", 0.2), ("df-b", 0.05))]
    g = guard.Guard(_FakeAgent(busy), max_cpu_pct=10_000,
                    max_mem_mb=1 << 20)
    try:
        for t in busy:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                guard.read_thread_cpu(busy[0].native_id) >= 0.2):
            time.sleep(0.02)
        g.check()
        assert set(g.thread_cpu_s) == {"df-a", "df-b"}
        assert sum(g.thread_cpu_s.values()) == pytest.approx(
            g.agent_cpu_s(), abs=0.02)
        assert g.thread_cpu_s["df-a"] >= 0.19
    finally:
        park.set()
        for t in busy:
            t.join(timeout=10.0)
    before = dict(g.thread_cpu_s)
    g.check()
    assert set(g.thread_cpu_s) == {"df-a", "df-b"}
    assert g.thread_cpu_s["df-a"] == pytest.approx(before["df-a"], abs=0.02)

def _tiny_step():
    model = torch.nn.Linear(8, 8)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    def step():
        model(torch.ones(2, 8)).sum().backward()
        opt.step()
        opt.zero_grad()
    return step


def test_memory_baseline_is_the_first_step():
    cfg = config.AgentConfig(profiler=config.ProfilerConfig(enabled=False))
    agent = Agent(cfg, device="cpu")  # not started: no threads
    g = guard.Guard(agent)
    g.check()
    # armed before any step: the first check's RSS, until a step comes
    provisional = g.mem_baseline
    assert provisional is not None and g.rss_mb == 0.0
    hook = StepHook(on_first_step=agent.note_first_step).install()
    try:
        step = _tiny_step()
        step()
        first = agent.first_step_rss
        assert first is not None and first > 10 << 20
        g.check()
        assert g.mem_baseline == first
        held = b"y" * (96 << 20)  # 96 MB of host memory after the step
        step()
        assert agent.first_step_rss == first  # later steps move nothing
        g.check()
        assert g.mem_baseline == first
        assert g.rss_mb >= 80.0
        assert g.proc_rss_mb >= g.rss_mb + first / (1 << 20) - 1
        del held
    finally:
        hook.remove()
    # without a probe the baseline is the guard's first check
    plain = guard.Guard(_FakeAgent())
    plain.check()
    assert plain.mem_baseline is not None and plain.rss_mb == 0.0


def test_memory_limit_armed_with_a_probe_and_no_step():
    """A workload on the card that never steps an optimizer (inference,
    serving) keeps a memory limit: the first check's RSS stands as the
    baseline."""
    cfg = config.AgentConfig(profiler=config.ProfilerConfig(enabled=False))
    agent = Agent(cfg, device="cpu")  # not started
    agent.device = types.SimpleNamespace(type="cuda")  # as on the card
    agent.step_hook = StepHook(on_first_step=agent.note_first_step)
    agent.step_hook.install()
    try:
        g = guard.Guard(agent, max_cpu_pct=10_000, max_mem_mb=64.0)
        g.check()
        assert g.mem_baseline is not None and not g.degraded
        held = b"y" * (96 << 20)
        g.check()
        assert agent.first_step_rss is None
        assert g.rss_mb >= 80.0
        assert g.degraded and g.exception_bitmap == guard.EXC_MEM_LIMIT
        del held
    finally:
        agent.step_hook.remove()


def test_cpu_spent_holding_the_step_is_not_charged():
    """The probe's thread works while the training thread waits in the
    step hook, then works beside it: the guard's reading leaves the
    first part out, threads_cpu_pct keeps both."""
    hook = StepHook().install()
    step = _tiny_step()
    step()  # step signal
    park, worked = threading.Event(), threading.Event()

    def probe_side():
        with hook.held(10.0) as took:
            assert took
            _spin(0.3)
        _spin(0.2)
        worked.set()
        park.wait(30.0)

    prober = threading.Thread(target=probe_side, name="df-busy")
    trainer = threading.Thread(target=step, name="trainer")
    fake = _FakeAgent([prober])
    fake.held_cpu_s = lambda: hook.held_cpu_s
    g = guard.Guard(fake, max_cpu_pct=10_000, max_mem_mb=1 << 20)
    g.check(now=100.0)
    try:
        prober.start()
        time.sleep(0.1)  # the hold is armed before the step comes
        trainer.start()
        assert worked.wait(30.0)
        g.check(now=101.0)
        assert hook.held_cpu_s == pytest.approx(0.3, abs=0.02)
        assert g.threads_cpu_pct == pytest.approx(50.0, abs=3.0)
        assert g.cpu_pct == pytest.approx(20.0, abs=3.0)
        assert g.snapshot()["cpu_pct"] == g.cpu_pct
        assert g.snapshot()["threads_cpu_pct"] == g.threads_cpu_pct
    finally:
        park.set()
        hook.remove()
        for t in (prober, trainer):
            t.join(timeout=10.0)
    assert not prober.is_alive() and not trainer.is_alive()



def test_check_inside_a_held_body_charges_none_of_it():
    """A guard check that falls while the probe's thread is still inside
    a held body (a capture's export and parse take seconds) leaves the
    work done so far out of its reading, and the next check the rest."""
    hook = StepHook().install()
    step = _tiny_step()
    step()  # step signal
    halfway, go_on, worked, park = (threading.Event() for _ in range(4))

    def probe_side():
        with hook.held(10.0) as took:
            assert took
            _spin(0.3)
            halfway.set()
            go_on.wait(30.0)
            _spin(0.2)
        worked.set()
        park.wait(30.0)

    prober = threading.Thread(target=probe_side, name="df-busy")
    trainer = threading.Thread(target=step, name="trainer")
    fake = _FakeAgent([prober])
    fake.held_cpu_s = lambda: hook.held_cpu_s
    g = guard.Guard(fake, max_cpu_pct=10_000, max_mem_mb=1 << 20)
    g.check(now=100.0)
    try:
        prober.start()
        time.sleep(0.1)  # the hold is armed before the step comes
        trainer.start()
        assert halfway.wait(30.0)
        g.check(now=101.0)
        assert hook.held_cpu_s >= 0.29
        assert g.threads_cpu_pct >= 28.0  # /proc counts 10 ms ticks
        assert g.cpu_pct < 3.0
        go_on.set()
        assert worked.wait(30.0)
        g.check(now=102.0)
        assert hook.held_cpu_s == pytest.approx(0.5, abs=0.03)
        assert g.threads_cpu_pct >= 18.0
        assert g.cpu_pct < 3.0
    finally:
        go_on.set()
        park.set()
        hook.remove()
        for t in (prober, trainer):
            t.join(timeout=10.0)
    assert not prober.is_alive() and not trainer.is_alive()

def test_stats_row_does_not_wait_for_a_pause():
    """A pause can wait seconds for a capture's parse; the stats row
    meanwhile shows the last whole check."""
    release = threading.Event()

    class _SlowAgent(_FakeAgent):
        def pause_profilers(self) -> None:
            release.wait(30.0)
            super().pause_profilers()

    fake = _SlowAgent()
    g = guard.Guard(fake, max_cpu_pct=-1.0, max_mem_mb=1 << 20)
    checker = threading.Thread(target=g.check)
    checker.start()
    try:
        deadline = time.monotonic() + 10.0
        while not g.degraded and time.monotonic() < deadline:
            time.sleep(0.01)
        assert g.degraded  # the check is in its pause
        t0 = time.monotonic()
        row = g.snapshot()
        assert time.monotonic() - t0 < 1.0
        assert row["checks"] == 0 and row["degraded"] == 0
    finally:
        release.set()
        checker.join(timeout=10.0)
    assert fake.calls == ["pause"]
    row = g.snapshot()
    assert row["checks"] == 1 and row["degrades"] == 1 and row["degraded"]


class _FakeProbe:
    started = 0

    def __init__(self, agent) -> None:
        self.sources = []
        self.stats = {"spans_sent": 0}
        _FakeProbe.started += 1

    def start(self):
        return self

    def stop(self) -> None:
        pass


def test_profilers_stay_down_while_degraded(monkeypatch):
    monkeypatch.setattr(agent_mod, "TpuProbe", _FakeProbe)
    cfg = config.AgentConfig()
    cfg.guard.enabled = False
    srv = Server(ingest_port=0, query_port=0).start()
    cfg.sender.servers = [("127.0.0.1", srv.ingest_port)]
    agent = Agent(cfg, device="cpu").start()
    try:
        # as on the card, where the probe runs
        agent.device = types.SimpleNamespace(type="cuda")
        agent.start_tpuprobe()
        assert agent.sampler is not None and agent.tpuprobe is not None
        g = agent.guard = guard.Guard(agent, max_cpu_pct=50.0,
                                      max_mem_mb=4096)
        g.cpu_pct, g.rss_mb = 100.0, 10.0
        g._evaluate()
        assert g.degraded and g.exception_bitmap == guard.EXC_CPU_LIMIT
        assert agent.sampler is None and agent.tpuprobe is None
        started = _FakeProbe.started
        agent.start_sampler()
        agent.start_tpuprobe()
        assert agent.sampler is None and agent.tpuprobe is None
        assert _FakeProbe.started == started
        g.cpu_pct = 39.0  # under 0.8 x 50: recovers
        g._evaluate()
        assert not g.degraded and g.stats == {
            "checks": 0, "degrades": 1, "recoveries": 1}
        assert agent.sampler is not None and agent.tpuprobe is not None
        assert _FakeProbe.started == started + 1
    finally:
        agent.stop()
        srv.stop()


def test_resumed_probe_continues_the_step_numbering(monkeypatch):
    """The agent's step hook outlives a paused probe: steps during the
    pause are counted and the resumed probe's source numbers its steps
    (the spans' run_id) on from there, where a hook of its own would
    start again at 1 and give two steps one run_id."""
    cfg = config.AgentConfig(profiler=config.ProfilerConfig(enabled=False))
    cfg.guard.enabled = False
    agent = Agent(cfg, device="cpu")  # not started
    assert agent.step_hook is None    # no probe on the CPU
    agent.device = types.SimpleNamespace(type="cuda")
    agent.step_hook = StepHook(on_first_step=agent.note_first_step)
    step = _tiny_step()
    try:
        agent.start_tpuprobe()
        first = agent.tpuprobe.sources[0]
        assert first.step_hook is agent.step_hook
        step()
        step()
        agent.pause_profilers()
        assert agent.tpuprobe is None
        step()  # while paused: still counted
        agent.resume_profilers()
        resumed = agent.tpuprobe.sources[0]
        assert resumed is not first and resumed.step_hook is agent.step_hook
        step()
        assert [s for s, _ in agent.step_hook.since(0)] == [1, 2, 3, 4]
        assert agent.first_step_rss is not None
    finally:
        if agent.tpuprobe is not None:
            agent.tpuprobe.stop()
        agent.step_hook.remove()
    # a source without the agent's hook installs and removes its own
    own = KinetoSource(lambda ev: None)
    own.step_hook.install()
    own.stop()
    assert own.step_hook._handle is None


def test_pause_releases_a_held_step():
    """The probe holds the next optimizer step while it opens a session;
    pause_profilers stops the probe, and the parked training thread goes
    on at once."""
    cfg = config.AgentConfig(profiler=config.ProfilerConfig(enabled=False))
    cfg.guard.enabled = False
    agent = Agent(cfg, device="cpu")  # not started
    src = KinetoSource(lambda ev: None)  # its capture thread not started
    src.step_hook.install()
    agent.tpuprobe = types.SimpleNamespace(
        sources=[src], stop=src.stop, stats={"spans_sent": 0})
    step = _tiny_step()
    step()  # step signal: the hook has counted a step
    in_session, done = threading.Event(), threading.Event()

    def probe_side():
        with src._at_step_boundary():  # holds the next step...
            in_session.set()
            src._stop.wait(30.0)      # ...for a session's length

    def train():
        step()
        done.set()

    holder = threading.Thread(target=probe_side, daemon=True)
    trainer = threading.Thread(target=train, daemon=True)
    try:
        holder.start()
        time.sleep(0.1)  # the hold is armed before the step comes
        trainer.start()
        assert in_session.wait(10.0)
        assert not done.wait(0.3)  # the step is parked in the hook
        t0 = time.monotonic()
        agent.pause_profilers()
        assert done.wait(5.0), "the held step was not released"
        assert time.monotonic() - t0 < 5.0
        assert agent.tpuprobe is None
    finally:
        src._stop.set()
        src.step_hook.remove()
        for t in (holder, trainer):
            t.join(timeout=5.0)
    assert not holder.is_alive() and not trainer.is_alive()


# -- config -------------------------------------------------------------------

def test_new_config_blocks_equal_reference():
    mine, ref = config.AgentConfig(), ref_config.AgentConfig()
    for sub, fields in (
            ("guard", ("enabled", "max_cpu_pct", "max_mem_mb",
                       "check_interval_s")),
            ("selfmon", ("enabled", "deadman_window_s", "check_interval_s")),
            ("chaos", ("enabled", "seed", "conn_refuse", "conn_reset",
                       "partial_write", "latency_ms", "disk_full"))):
        for f in fields:
            assert getattr(getattr(mine, sub), f) == \
                getattr(getattr(ref, sub), f), (sub, f)
    for f in ("enabled", "dir", "max_mb", "segment_mb", "max_age_s"):
        assert getattr(mine.sender.spool, f) == \
            getattr(ref.sender.spool, f), f
    assert mine.guard.enabled and mine.selfmon.enabled
    assert not mine.sender.spool.enabled and not mine.chaos.enabled


_CHECKS = [("guard", "max_cpu_pct", [0.5, 1, 400]),
           ("guard", "max_mem_mb", [15, 16, True]),
           ("guard", "check_interval_s", [0.05, 0.1]),
           ("selfmon", "deadman_window_s", [0.05, 0.1]),
           ("selfmon", "check_interval_s", [-1, 0, 2]),
           ("selfmon", "enabled", [1, False]),
           ("chaos", "conn_reset", [-0.1, 0.0, 1.0, 1.1]),
           ("chaos", "disk_full", [1.5, 0.5]),
           ("chaos", "latency_ms", [-1, 0]),
           ("chaos", "enabled", ["yes", True]),
           ("sender.spool", "max_mb", [0, 1, 64]),
           ("sender.spool", "segment_mb", [0, 1, 65]),
           ("sender.spool", "enabled", [0, True])]


@pytest.mark.parametrize("sub,name,values", _CHECKS)
def test_validate_new_ranges_equal_reference(sub, name, values):
    for v in values:
        verdicts = []
        for mod in (config, ref_config):
            cfg = mod.AgentConfig()
            target = cfg
            for part in sub.split("."):
                target = getattr(target, part)
            setattr(target, name, v)
            try:
                cfg.validate()
                verdicts.append("ok")
            except ValueError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1], (sub, name, v)


def test_probe_stats_count_the_probes_the_guard_stopped():
    """agent.tpuprobe reports every span the agent sent: a probe the
    guard stopped keeps its counts in the rows after the pause and
    beside the resumed probe's, so a rank's rows can be held to them."""
    from deepflow_tpu_torch.proto import wire

    class Probe:
        sources: list = []

        def __init__(self, spans: int) -> None:
            self.stats = {"spans_sent": spans, "batches": 1}

        def stop(self) -> None:
            self.stats["spans_sent"] += 3   # the capture its stop ships

    class Sender:
        stats: dict = {}

        def __init__(self) -> None:
            self.sent = []

        def send(self, mt, payload) -> bool:
            self.sent.append(wire.StatsBatch.FromString(payload))
            return True

    cfg = config.AgentConfig()
    cfg.profiler.enabled = cfg.guard.enabled = False
    agent = Agent(cfg, device=None)
    agent.sender = Sender()

    def probe_row() -> dict:
        agent._emit_stats()
        rows = [m.values for m in agent.sender.sent[-1].metrics
                if m.name == "agent.tpuprobe"]
        return rows[0] if rows else {}
    assert probe_row() == {}
    agent.tpuprobe = Probe(10)
    assert probe_row() == {"spans_sent": 10.0, "batches": 1.0}
    agent.pause_profilers()
    assert agent.tpuprobe is None
    assert probe_row() == {"spans_sent": 13.0, "batches": 1.0}
    agent.tpuprobe = Probe(4)   # resumed afresh
    assert probe_row() == {"spans_sent": 17.0, "batches": 2.0}
