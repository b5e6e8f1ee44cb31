"""The port's in-process agent held against the JAX package's on the CPU:
folded stacks and their on/off-cpu class on the same frames, the
sampler's stacks of the same threads, the config's validation ranges,
the Agent's frames into the port's server, and ``python -m
deepflow_tpu_torch.cli.runner`` profiling an unmodified script."""

import json
import logging
import os
import random
import subprocess
import sys
import threading
import time

import pytest

from deepflow_tpu.agent import config as ref_config
from deepflow_tpu.agent import profiler as ref_profiler
from deepflow_tpu_torch.agent import agent as agent_mod
from deepflow_tpu_torch.agent import config, profiler
from deepflow_tpu_torch.agent.agent import Agent, attach, detach
from deepflow_tpu_torch.agent.sink import FrameSink
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.tpuprobe import kineto, kineto_synth
from deepflow_tpu_torch.tpuprobe.kineto_synth import SynthModule, SynthOp
from deepflow_tpu_torch.tpuprobe.probe import TpuProbe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_NS = 1_760_000_000_000_000_000
TPU_TABLES = ("profile.tpu_hlo_span", "profile.tpu_memory",
              "profile.tpu_step_metrics")


def _wait(cond, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# -- folded stacks ----------------------------------------------------------------

def _nested(depth, out):
    if depth == 0:
        f = sys._getframe()
        out.append((profiler.fold_stack(f), ref_profiler.fold_stack(f),
                    profiler.fold_stack(f, max_depth=3),
                    ref_profiler.fold_stack(f, max_depth=3),
                    profiler.fold_frame(f), ref_profiler.fold_frame(f)))
        return
    _nested(depth - 1, out)


@pytest.mark.parametrize("depth", [0, 5, 40, 200])
def test_fold_stack_equals_reference(depth):
    out = []
    _nested(depth, out)
    full, ref_full, cut, ref_cut, leaf, ref_leaf = out[0]
    assert full == ref_full and cut == ref_cut and leaf == ref_leaf
    assert full.endswith(f"{__name__}._nested")
    assert len(cut.split(";")) == 3


@pytest.mark.parametrize("seed", range(3))
def test_classify_sample_equals_reference(seed):
    rng = random.Random(seed)
    funcs = sorted(ref_profiler._BLOCKING_LEAVES) + [
        "main", "train_step", "backward", "waiter", "get_x", "<module>"]
    for _ in range(300):
        stack = ";".join(f"{rng.choice(['m', 'a.b', 'threading', ''])}."
                         f"{rng.choice(funcs)}"
                         for _ in range(rng.randrange(1, 6)))
        assert profiler.classify_sample(stack) == \
            ref_profiler.classify_sample(stack), stack
    assert profiler.classify_sample("") == ref_profiler.classify_sample("")


def test_sampler_stacks_equal_reference():
    """Both samplers fold the same parked threads into the same stacks
    and classes, and leave out the agent's "df-" threads."""
    gate = threading.Event()
    threads = [threading.Thread(target=gate.wait, name=n, daemon=True)
               for n in ("worker", "df-plumbing")]
    for t in threads:
        t.start()
    try:
        got = []
        for mod in (profiler, ref_profiler):
            batches = []
            s = mod.OnCpuSampler(batches.append)
            s._sample(threading.get_ident())
            s._emit()
            got.append(sorted((p.thread_name, p.stack, p.count, p.value_us,
                               p.event_type) for p in batches[0]
                              if p.thread_name in ("worker", "df-plumbing")))
        assert got[0] == got[1]
        assert [g[0] for g in got[0]] == ["worker"]
        assert got[0][0][4] == "off-cpu"  # parked in Event.wait
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in threads)


def test_sampler_thread_samples_and_stops():
    batches = []
    s = profiler.OnCpuSampler(batches.append, hz=200, emit_interval_s=0.05)
    s.start()
    time.sleep(0.3)
    s.stop()
    assert not s._thread.is_alive()
    assert s.stats.samples > 0 and s.stats.emits >= 1
    stacks = [p.stack for b in batches for p in b]
    assert any(__name__ in st for st in stacks)  # this test's own frames


# -- config -------------------------------------------------------------------------

def test_config_defaults_equal_reference():
    mine, ref = config.AgentConfig(), ref_config.AgentConfig()
    for f in ("agent_id", "app_service", "stats_interval_s"):
        assert getattr(mine, f) == getattr(ref, f)
    for sub, fields in (("profiler", ("enabled", "sample_hz",
                                      "emit_interval_s")),
                        ("sender", ("servers", "queue_size", "ack_window")),
                        ("tpuprobe", ("enabled", "trace_interval_s",
                                      "trace_duration_ms", "target_coverage",
                                      "steps_per_capture", "memory_poll_s",
                                      "step_metrics", "step_topk"))):
        for f in fields:
            assert getattr(getattr(mine, sub), f) == \
                getattr(getattr(ref, sub), f), (sub, f)
    assert config.DEFAULT_INGEST_PORT == ref_config.DEFAULT_INGEST_PORT
    for s in ("h:1", "h", ":7", "", "[::1]:9", "a:b:3"):
        assert config.parse_addr(s) == ref_config._parse_addr(s)
    for bad in ("h:x", "h:"):
        with pytest.raises(ValueError):
            config.parse_addr(bad)
        with pytest.raises(ValueError):
            ref_config._parse_addr(bad)


_CHECKS = [("profiler", "sample_hz", [0.05, 0.1, 10_000, 10_001, True, "9"]),
           ("profiler", "emit_interval_s", [0.001, 0.01, 5]),
           ("tpuprobe", "trace_interval_s", [0.05, 0.1]),
           ("tpuprobe", "trace_duration_ms", [0, 1]),
           ("tpuprobe", "target_coverage", [0.0, 0.01, 0.95, 0.96]),
           ("tpuprobe", "steps_per_capture", [0, 1, 10_000, 10_001]),
           ("tpuprobe", "step_topk", [0, 1, 100, 101]),
           ("sender", "queue_size", [0, 1]),
           ("sender", "ack_window", [0, 1]),
           ("", "stats_interval_s", [0.05, 0.1, None])]


@pytest.mark.parametrize("sub,name,values", _CHECKS)
def test_validate_ranges_equal_reference(sub, name, values):
    for v in values:
        verdicts = []
        for mod in (config, ref_config):
            cfg = mod.AgentConfig()
            setattr(getattr(cfg, sub) if sub else cfg, name, v)
            try:
                cfg.validate()
                verdicts.append("ok")
            except ValueError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1], (sub, name, v)


# -- the Agent ------------------------------------------------------------------------

@pytest.fixture
def server():
    s = Server(ingest_port=0, query_port=0,
               selfstats_interval_s=3600).start()
    yield s
    s.stop()


def _cfg(server, **kw) -> config.AgentConfig:
    cfg = config.AgentConfig(app_service="svc", agent_id=4, **kw)
    cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
    return cfg


def _stats_rows(server) -> dict:
    t = server.db.table("deepflow_system.deepflow_system")
    cols = t.column_concat(["metric_name", "value_name", "value"])
    names = t.dicts["metric_name"].decode_many(cols["metric_name"])
    vnames = t.dicts["value_name"].decode_many(cols["value_name"])
    out: dict = {}
    for m, v, x in zip(names, vnames, cols["value"].tolist()):
        out.setdefault(m, {})[v] = x  # the latest emit wins
    return out


def test_agent_on_cpu_ships_profiles_and_stats(server, caplog):
    """device="cpu": the sampler, the guard, the stats thread and the
    sender run, the device probe is left out (and the startup line says
    so), and a stop ships the final stats, all acked."""
    caplog.set_level(logging.INFO, logger="df.agent")
    agent = Agent(_cfg(server, stats_interval_s=0.2), device="cpu").start()
    try:
        assert agent.tpuprobe is None
        line = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("agent started")][0]
        assert "sender, oncpu-sampler, guard, stats" in line
        assert "left out on cpu: tpuprobe" in line
        deadline = time.monotonic() + 0.6
        while time.monotonic() < deadline:
            sum(i * i for i in range(1000))  # something to sample
        assert _wait(lambda: len(server.db.table(
            "deepflow_system.deepflow_system")) > 0)
    finally:
        agent.stop()
    assert server.wait_for_rows("profile.in_process_profile", 1)
    rows = _stats_rows(server)
    assert {"agent.sender", "agent.oncpu_sampler"} <= set(rows)
    assert "agent.tpuprobe" not in rows
    assert rows["agent.oncpu_sampler"]["samples"] > 0
    tree = server.api.profile_tracing({"app_service": "svc"})["result"]
    assert tree["total_value"] > 0
    # every frame reached the store once: the server's watermark covers
    # them all (the last acks may cross the sender's close)
    sent = agent.sender.stats["sent_frames"]
    assert _wait(lambda: server.receiver.seq_tracker.contiguous(4)
                 == agent.sender.seq_base + sent)
    assert agent.sender.stats["acked_seq"] > agent.sender.seq_base
    assert all(d.stats["dups"] == 0 and d.stats["errors"] == 0
               for d in server.decoders)
    assert not agent.sampler._thread.is_alive()
    assert not agent._stats_thread.is_alive()
    assert not agent.sender._thread.is_alive()


def _synth_events():
    ops = [("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "fusion",
            3_000_000_000),
           ("void at::native::vectorized_elementwise_kernel<4>", "loop",
            400_000_000)]
    mods = []
    for s in range(3):
        t = base = s * 10_000_000_000
        sops = []
        for name, cat, dur in ops:
            sops.append(SynthOp(name, cat, t, dur))
            t += dur
        mods.append(SynthModule("train_step", 1 + s, base, t - base, sops))
    trace, steps = kineto_synth.build_trace({0: mods}, base_ns=BASE_NS)
    return kineto.extract_device_spans(trace, steps)


def _feed_probe(agent_like) -> None:
    probe = TpuProbe(agent_like)  # not started: fed by hand
    probe._sink(_synth_events())
    probe._mem_sink([{"timestamp_ns": BASE_NS, "device_id": 0,
                      "bytes_in_use": 5, "peak_bytes_in_use": 6,
                      "bytes_limit": 80 << 30, "largest_free_block": 1,
                      "num_allocs": 2}])
    probe.stop()


def test_agent_carries_the_probe_contract(server):
    """TpuProbe given the Agent ships through the durable sender the same
    span, memory and step rows as through the FrameSink."""
    agent = Agent(_cfg(server, profiler=config.ProfilerConfig(
        enabled=False)), device="cpu").start()
    try:
        agent.process_name = "trainer"
        _feed_probe(agent)
    finally:
        agent.stop()
    sink = FrameSink(process_name="trainer")
    _feed_probe(sink)
    other = Server(ingest_port=0, query_port=0,
                   selfstats_interval_s=3600).start()
    try:
        import socket
        with socket.create_connection(("127.0.0.1", other.ingest_port),
                                      timeout=5) as c:
            c.sendall(b"".join(sink.frames))
        for t in TPU_TABLES:
            n = len(server.db.table(t))
            assert n > 0 and other.wait_for_rows(t, n), t
            cols = [c for c in server.db.table(t).columns
                    if c not in ("agent_id",)]

            def rows(srv, t=t, cols=cols):
                tab = srv.db.table(t)
                data = tab.column_concat(cols)
                dec = [tab.dicts[c].decode_many(data[c]) if c in tab.dicts
                       else data[c].tolist() for c in cols]
                return sorted(zip(*dec))
            assert rows(server) == rows(other), t
    finally:
        other.stop()


def test_attach_once_and_detach(server, monkeypatch):
    registered = []
    monkeypatch.setattr(agent_mod.atexit, "register", registered.append)
    monkeypatch.setattr(agent_mod._Attached, "atexit_registered", False)
    a = attach("svc", servers=[f"127.0.0.1:{server.ingest_port}"],
               device="cpu", stats_interval_s=5.0)
    try:
        assert attach("other", device="cpu") is a
        assert a.app_service == "svc" and a.config.stats_interval_s == 5.0
        assert registered == [detach]
    finally:
        detach()
    assert agent_mod._Attached.agent is None
    detach()  # idempotent
    assert not a.sender._thread.is_alive()


# -- zero-code launch ----------------------------------------------------------------

def _run_example(server, launcher: list[str]) -> subprocess.CompletedProcess:
    tiny = ["--device", "cpu", "--steps", "8", "--d-model", "64",
            "--layers", "2", "--seq", "32", "--batch", "2"]
    return subprocess.run(
        [sys.executable, *launcher, *tiny], cwd=ROOT, capture_output=True,
        text=True, timeout=300)


@pytest.mark.parametrize("mode", ["runner", "attach"])
def test_unmodified_script_profiled(server, mode):
    """The example trains at a tiny size on the CPU, launched under the
    runner (zero-code) or attaching itself: the server holds its CPU
    stacks through the example's main and the agent's stats, every frame
    acked once, and the script's step lines are intact."""
    example = ["-m", "deepflow_tpu_torch.examples.train_with_observability"]
    addr = f"127.0.0.1:{server.ingest_port}"
    if mode == "runner":
        launcher = ["-m", "deepflow_tpu_torch.cli.runner", "--device", "cpu",
                    "--server", addr, "--service", "llama-train", *example]
    else:
        launcher = [*example, "--attach", "--server", addr]
    out = _run_example(server, launcher)
    assert out.returncode == 0, out.stderr
    steps = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert [s["step"] for s in steps] == list(range(8))
    assert all(s["ms"] > 0 and s["loss"] > 0 for s in steps)
    assert _wait(lambda: len(server.db.table(
        "deepflow_system.deepflow_system")) > 0)
    assert server.wait_for_rows("profile.in_process_profile", 1)
    tree = server.api.profile_tracing(
        {"app_service": "llama-train"})["result"]

    def paths(node, pre=()):
        here = pre + (node["name"],)
        yield here
        for c in node["children"]:
            yield from paths(c, here)
    frames = [p for p in paths(tree)]
    # the example's main, run by runpy as __main__ (the runner's own
    # frames are __main__ too, above runpy.run_module)
    want = "runpy.run_module" if mode == "runner" else "runpy._run_code"
    assert any(want in p and "__main__.main" in p[p.index(want):]
               for p in frames)
    rows = _stats_rows(server)
    assert rows["agent.sender"]["sent_frames"] > 0
    rec = server.receiver.stats
    assert rec["acks_sent"] > 0 and rec["seq_bases"] >= 1
    assert rec["bad_frames"] == 0 and rec["dropped"] == 0
    assert all(d.stats["dups"] == 0 and d.stats["errors"] == 0
               for d in server.decoders)
    pname = server.db.table("profile.in_process_profile").dicts[
        "process_name"].decode(1)
    assert pname == ("runner.py" if mode == "runner"
                     else "train_with_observability.py")
