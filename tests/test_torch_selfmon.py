"""The port's self-telemetry held against the JAX package's on the CPU:
the same call sequence on both registries gives equal snapshots and
DFSTATS metrics, the histogram, ledger and deadman behave as the
reference's tests ask (with the clock injected, so nothing sleeps
through a deadman window), the port agent's DFSTATS batch lands in the
reference server as in the port's with equal ``agents_selfmon``, and a
live agent's ledgers balance end to end."""

import json
import random
import socket
import threading
import time
import types
import urllib.request

import pytest

from deepflow_tpu import telemetry as ref_tel
from deepflow_tpu.server import Server as RefServer
from deepflow_tpu_torch import telemetry as tel
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig, ProfilerConfig
from deepflow_tpu_torch.agent.guard import Guard
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.server import Server

HOPS = ("sender", "receiver", "decoder.PROFILE", "table_write", "tpuprobe")
STAGES = ("sender", "stats", "deadman", "tpuprobe.kineto", "receiver")
REASONS = ("", "queue_full_low", "dup", "spool_evict", "decode_error")


def _wait(cond, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


class _Clock:
    """An injected monotonic clock for both telemetry modules."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def monotonic_ns(self) -> int:
        return int(self.t * 1e9)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic,
                                 monotonic_ns=c.monotonic_ns,
                                 time_ns=time.time_ns, time=time.time)
    for mod in (tel, ref_tel):
        monkeypatch.setattr(mod, "time", fake)
    return c


def _unstacked(obj):
    """Snapshots and metrics without the stack text: a stack names each
    package's own frames."""
    if isinstance(obj, dict):
        return {k: _unstacked(v) for k, v in obj.items() if k != "stack"}
    if isinstance(obj, (list, tuple)):
        return [_unstacked(v) for v in obj]
    return obj


def _drive(mod, seed: int, clock: _Clock):
    """One seeded call sequence on a fresh registry of ``mod``; returns
    the registry and the deadman's verdicts of every scan."""
    clock.t = 1000.0
    rng = random.Random(seed)
    t = mod.Telemetry("agent", enabled=True)
    d = mod.DeadmanDetector(t, window_s=3.0)
    beats, verdicts = {}, []
    for _ in range(300):
        op = rng.random()
        if op < 0.45:
            t.hop(rng.choice(HOPS)).account(
                emitted=rng.randrange(4), delivered=rng.randrange(3),
                dropped=rng.randrange(2), reason=rng.choice(REASONS),
                wait_ns=rng.choice([None, rng.randrange(2 * 10 ** 10)]))
        elif op < 0.5:
            t.hop(rng.choice(HOPS)).observe_wait(
                rng.randrange(10 ** 9), weight=rng.randrange(3))
        elif op < 0.72:
            stage = rng.choice(STAGES)
            if stage not in beats or rng.random() < 0.1:
                beats[stage] = t.heartbeat(
                    stage, interval_hint_s=rng.choice([0.0, 0.5, 2.0]))
            beats[stage].beat(progress=rng.choice([None, rng.randrange(99)]))
        elif op < 0.9:
            clock.t += rng.random() * 2.5
        elif op < 0.93:
            stage = rng.choice(STAGES)
            t.unregister(stage)
            beats.pop(stage, None)
        else:
            verdicts.append(d.check_once())
    return t, verdicts


@pytest.mark.parametrize("seed", range(4))
def test_same_calls_give_equal_snapshots_and_metrics(seed, clock):
    mine, my_verdicts = _drive(tel, seed, clock)
    ref, ref_verdicts = _drive(ref_tel, seed, clock)
    assert _unstacked(my_verdicts) == _unstacked(ref_verdicts)
    assert any(my_verdicts), "the sequence wedged no stage"
    assert _unstacked(mine.snapshot()) == _unstacked(ref.snapshot())
    assert _unstacked(list(mine.stats_metrics())) == \
        _unstacked(list(ref.stats_metrics()))
    names = {name for name, _, _ in mine.stats_metrics()}
    assert {"agent.pipeline", "agent.pipeline.drop",
            "agent.heartbeat"} <= names


@pytest.mark.parametrize("seed", range(3))
def test_histogram_quantiles_equal_reference(seed):
    rng = random.Random(seed)
    mine, ref = tel.LatencyHistogram(), ref_tel.LatencyHistogram()
    for _ in range(500):
        w = rng.choice([rng.randrange(10 ** 5), rng.randrange(10 ** 9),
                        rng.randrange(10 ** 11)])
        n = rng.randrange(1, 4)
        mine.observe(w, n)
        ref.observe(w, n)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert mine.quantile(q) == ref.quantile(q)
    assert mine.snapshot() == ref.snapshot()
    assert tel.LatencyHistogram().snapshot() == \
        ref_tel.LatencyHistogram().snapshot()


def test_histogram_quantiles():
    h = tel.LatencyHistogram()
    for _ in range(90):
        h.observe(500_000)          # 0.5 ms -> the 1 ms bucket
    for _ in range(10):
        h.observe(5_000_000_000)    # 5 s -> the 10 s bucket
    s = h.snapshot()
    assert s["count"] == 100
    assert s["p50_ms"] <= 1.0
    assert s["p99_ms"] >= 1000.0


def test_hop_ledger_conservation():
    hop = tel.HopLedger("sender")
    hop.account(emitted=10)
    hop.account(delivered=7, wait_ns=2_000_000)
    hop.account(dropped=2, reason="queue_full")
    hop.account(dropped=1, reason="send_error")
    s = hop.snapshot()
    assert (s["emitted"], s["delivered"], s["in_flight"]) == (10, 7, 0)
    assert s["dropped"] == {"queue_full": 2, "send_error": 1}
    assert s["emitted"] == s["delivered"] + s["dropped_total"] \
        + s["in_flight"]


@pytest.mark.parametrize("how", ["argument", "DF_NO_SELFMON"])
def test_disabled_telemetry_is_noop(how, monkeypatch):
    if how == "DF_NO_SELFMON":
        monkeypatch.setattr(tel, "SELFMON_DISABLED", True)
        monkeypatch.setattr(ref_tel, "SELFMON_DISABLED", True)
    snaps = []
    for mod in (tel, ref_tel):
        t = mod.Telemetry("agent", enabled=False if how == "argument"
                          else None)
        t.hop("sender").account(emitted=5, delivered=5)
        t.heartbeat("stats").beat(progress=3)
        assert list(t.stats_metrics()) == []
        # a detector over a disabled registry starts no thread
        assert mod.DeadmanDetector(t, window_s=0.1).start()._thread is None
        assert t.hop("x").snapshot()["emitted"] == 0
        snaps.append(t.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["enabled"] is False and snaps[0]["pipeline"] == []
    assert snaps[0]["stages"] == []


def test_pipeline_order_is_registration_order():
    t = tel.Telemetry("server")
    for name in ("receiver", "decoder.PROFILE", "table_write"):
        t.hop(name)
    t.hop("receiver")  # a second lookup keeps the first place
    assert [h["hop"] for h in t.pipeline_snapshot()] == \
        ["receiver", "decoder.PROFILE", "table_write"]


@pytest.mark.parametrize("mod", [tel, ref_tel], ids=["port", "reference"])
def test_deadman_wedge_and_recovery(mod, clock):
    """A stage that stops beating is flagged once its window passes on
    the injected clock, with the stalled thread's stack; it is reported
    once while it lasts and clears at its next beat."""
    t = mod.Telemetry("agent")
    d = mod.DeadmanDetector(t, window_s=15.0)
    beaten, release = threading.Event(), threading.Event()

    def stalls():
        hb = t.heartbeat("tpuprobe.kineto")
        hb.beat(progress=1)
        beaten.set()
        release.wait(10.0)   # wedged: no further beats
        hb.beat(progress=2)

    th = threading.Thread(target=stalls, daemon=True)
    th.start()
    try:
        assert beaten.wait(5.0)
        clock.t += 15.0
        assert d.check_once() == []          # still inside the window
        clock.t += 0.5
        new = d.check_once()
        assert [w["stage"] for w in new] == ["tpuprobe.kineto"]
        w = new[0]
        assert (w["stalled_s"], w["progress"], w["window_s"]) == \
            (15.5, 1, 15.0)
        assert "stalls" in w["stack"] and "release.wait" in w["stack"]
        assert t.snapshot()["wedges_total"] == 1
        clock.t += 1.0
        assert d.check_once() == []          # not reported again...
        assert t.snapshot()["wedges"][0]["stalled_s"] == 16.5
    finally:
        release.set()
        th.join(timeout=5.0)
    assert not th.is_alive()
    d.check_once()                           # ...and clears at a beat
    assert t.snapshot()["wedges"] == []
    t.unregister("tpuprobe.kineto")  # its thread has ended
    # a rarely-waking stage's window is 2.5 x its hint
    hb = t.heartbeat("stats", interval_hint_s=10.0)
    hb.beat()
    clock.t += 20.0
    assert d.check_once() == []
    clock.t += 5.5
    assert [w["stage"] for w in d.check_once()] == ["stats"]


# -- the agent's DFSTATS batch in both servers ---------------------------------

def _stats_frame(agent_id: int = 5) -> tuple[Agent, bytes]:
    """A port agent (not started) with sender drops, heartbeats, a guard
    reading and a current wedge; its DFSTATS frame."""
    cfg = AgentConfig(app_service="svc", agent_id=agent_id,
                      profiler=ProfilerConfig(enabled=False))
    cfg.sender.servers = [("127.0.0.1", 1)]
    cfg.sender.queue_size = 4
    agent = Agent(cfg, device="cpu")
    for i in range(6):  # four queued, two dropped (queue_full_low)
        agent.sender.send(MessageType.DFSTATS, b"x%d" % i)
    agent.telemetry.heartbeat("stats", interval_hint_s=10.0).beat()
    release = threading.Event()
    beaten = threading.Event()

    def wedged():
        hb = agent.telemetry.heartbeat("tpuprobe.kineto", interval_hint_s=14)
        hb.beat(progress=3)
        hb.last_beat_mono -= 100.0   # its last beat, 100 s ago
        beaten.set()
        release.wait(10.0)

    th = threading.Thread(target=wedged, name="df-tpuprobe-kineto",
                          daemon=True)
    th.start()
    assert beaten.wait(5.0)
    agent.guard = Guard(agent)
    agent.guard.check()
    sent = []
    agent.sender.send = lambda mt, p: sent.append((mt, p)) or True
    try:
        verdicts = agent.deadman.check_once()  # on_wedge ships at once
    finally:
        release.set()
        th.join(timeout=5.0)
    assert [v["stage"] for v in verdicts] == ["tpuprobe.kineto"]
    assert len(sent) == 1 and sent[0][0] == MessageType.DFSTATS
    frame = encode_frame(FrameHeader(MessageType.DFSTATS, agent_id=agent_id),
                         sent[0][1])
    return agent, frame


def test_agent_dfstats_in_both_servers_equal_selfmon():
    """The port agent's DFSTATS frame decoded by the reference server and
    by the port's: the same deepflow_system rows, equal
    collect_agent_selfmon from both packages, equal agents_selfmon and
    degraded status in both /v1/health answers, balanced server hops."""
    agent, frame = _stats_frame()
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    port = Server(ingest_port=0, query_port=0,
                  selfstats_interval_s=3600).start()
    try:
        table = "deepflow_system.deepflow_system"
        for srv in (ref, port):
            with socket.create_connection(("127.0.0.1", srv.ingest_port),
                                          timeout=5) as c:
                c.sendall(frame)
        n = len(port.db.table(table)) if _wait(
            lambda: len(port.db.table(table)) > 0) else 0
        assert n > 0 and ref.wait_for_rows(table, n)
        mine = tel.collect_agent_selfmon(port.db)
        assert mine == ref_tel.collect_agent_selfmon(ref.db)
        assert mine["pipeline"]["sender"]["emitted"] == 6.0
        assert mine["pipeline"]["sender"]["dropped_by_reason"] == \
            {"queue_full_low": 2.0}
        assert mine["pipeline"]["sender"]["in_flight"] == 4.0
        assert mine["heartbeats"]["tpuprobe.kineto"]["wedged"] == 1.0
        [w] = mine["wedges"]
        assert w["stage"] == "tpuprobe.kineto" and "wedged" in w["stack"]

        def settled(srv):
            h = _get(srv.query_port, "/v1/health")
            hops = {p["hop"]: p for p in h["pipeline"]}
            return h if all(hops[k]["in_flight"] == 0 for k in
                            ("receiver", "decoder.DFSTATS", "table_write")
                            ) else None
        assert _wait(lambda: settled(port) and settled(ref))
        got, want = settled(port), settled(ref)
        assert got["agents_selfmon"] == want["agents_selfmon"]
        assert got["status"] == want["status"] == "degraded"
        assert got["wedged_stages"] == want["wedged_stages"] == \
            ["agent:tpuprobe.kineto"]
        assert got["ledger_imbalance"] == 0
        hops = [{p["hop"]: {k: p[k] for k in ("emitted", "delivered",
                                              "dropped")}
                 for p in h["pipeline"]} for h in (got, want)]
        for hop in ("receiver", "decoder.DFSTATS", "table_write"):
            assert hops[0][hop] == hops[1][hop], hop
        rows = {(m, v) for m, v in zip(
            *[port.db.table(table).dicts[c].decode_many(
                port.db.table(table).column_concat([c])[c])
              for c in ("metric_name", "value_name")])}
        assert {("agent.guard", "cpu_pct"), ("agent.guard", "proc_rss_mb"),
                ("agent.guard", "degrades"), ("agent.deadman", "stalled_s"),
                ("agent.heartbeat", "wedged")} <= rows
    finally:
        ref.stop()
        port.stop()


# -- a live agent and server ---------------------------------------------------

@pytest.fixture
def server():
    s = Server(ingest_port=0, query_port=0).start()
    yield s
    s.stop()


def test_live_agent_ledgers_balance_end_to_end(server):
    """A port agent on the CPU ships into the port server: every hop on
    both sides balances after the stop, the server's stages beat, no
    wedge, and the agent's sender hop comes back in agents_selfmon."""
    cfg = AgentConfig(app_service="selfmon", agent_id=6,
                      stats_interval_s=0.3,
                      profiler=ProfilerConfig(sample_hz=200.0,
                                              emit_interval_s=0.2))
    cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
    agent = Agent(cfg, device="cpu").start()
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        sum(i * i for i in range(2000))  # something to sample
    for hop in agent.telemetry.pipeline_snapshot():
        assert hop["emitted"] == hop["delivered"] + hop["dropped_total"] \
            + hop["in_flight"], hop
    agent.stop()
    sent = agent.sender.stats["sent_frames"]
    assert _wait(lambda: server.receiver.seq_tracker.contiguous(6)
                 == agent.sender.seq_base + sent)

    def health():
        h = _get(server.query_port, "/v1/health")
        ok = all(p["in_flight"] == 0 for p in h["pipeline"])
        return h if ok and "agents_selfmon" in h else None
    assert _wait(health)
    h = health()
    assert h["status"] == "ok" and h["ledger_imbalance"] == 0
    assert h["wedges"] == [] and h["selfmon"]["enabled"] is True
    hops = {p["hop"]: p for p in h["pipeline"]}
    assert hops["receiver"]["emitted"] == sent
    assert hops["table_write"]["delivered"] > 0
    assert any(p["wait"]["count"] > 0 for k, p in hops.items()
               if k.startswith("decoder."))
    stages = {s["stage"]: s for s in h["stages"]}
    assert {"receiver", "deadman", "decoder.PROFILE.0"} <= set(stages)
    assert not any(s["wedged"] for s in stages.values())
    ag = h["agents_selfmon"]
    snd = ag["pipeline"]["sender"]
    # the last batch was built before its own send: one frame short
    assert snd["emitted"] == snd["delivered"] + snd["dropped"] \
        + snd["in_flight"]
    assert snd["dropped"] == 0 and snd["emitted"] >= sent - 1
    assert {"stats", "sender", "deadman"} <= set(ag["heartbeats"])
    assert ag["wedges"] == []


def test_wedge_ships_at_once_and_clears(server):
    """A stalled agent stage (its last beat pushed back past the window,
    no sleeping) ships its verdict at the deadman's scan: /v1/health is
    degraded and names it; after a beat and the stop's final stats it
    is ok again."""
    cfg = AgentConfig(app_service="wedge", agent_id=7,
                      stats_interval_s=3600,
                      profiler=ProfilerConfig(enabled=False))
    cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
    cfg.selfmon.check_interval_s = 3600  # the test scans, not the thread
    agent = Agent(cfg, device="cpu").start()
    try:
        release = threading.Event()
        beaten = threading.Event()

        def relay():
            hb = agent.telemetry.heartbeat("tpuprobe.memory")
            hb.beat(progress=1)
            hb.last_beat_mono -= 60.0
            beaten.set()
            release.wait(10.0)
            hb.beat(progress=2)  # recovery

        th = threading.Thread(target=relay, name="fake-relay", daemon=True)
        th.start()
        assert beaten.wait(5.0)
        assert [w["stage"] for w in agent.deadman.check_once()] == \
            ["tpuprobe.memory"]

        def degraded():
            h = _get(server.query_port, "/v1/health")
            return h if h["status"] == "degraded" else None
        assert _wait(degraded)
        h = degraded()
        assert h["wedged_stages"] == ["agent:tpuprobe.memory"]
        [w] = h["agents_selfmon"]["wedges"]
        assert "relay" in w["stack"] and "release.wait" in w["stack"]
        assert w["stalled_s"] >= 60.0
        release.set()
        th.join(timeout=5.0)
        assert not th.is_alive()
        agent.deadman.check_once()
        assert agent.telemetry.snapshot()["wedges"] == []
    finally:
        agent.stop()
    assert _wait(lambda: _get(server.query_port,
                              "/v1/health")["status"] == "ok")


def test_server_selfstats_rows_equal_reference():
    """Each server writes its own hop ledgers and heartbeats into
    deepflow_system.deepflow_system: the same counters give rows of the
    same names, tags and values in both packages, and the port's loop
    writes them on its own every selfstats_interval_s."""
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    selfstats_interval_s=3600, selfmon=True).start()
    port = Server(ingest_port=0, query_port=0, selfstats_interval_s=0.2,
                  selfmon=True).start()
    # the port's loop may write the same counters again: Max folds them
    sql = ("SELECT metric_name, tag_json, value_name, Max(value) AS v "
           "FROM deepflow_system WHERE metric_name = 'server.pipeline' "
           "AND tag_json = '{\"hop\": \"storage.scrub\"}' "
           "GROUP BY metric_name, tag_json, value_name ORDER BY value_name")
    try:
        table = "deepflow_system.deepflow_system"
        assert _wait(lambda: len(port.db.table(table)) > 0)
        for srv in (ref, port):
            srv.telemetry.hop("storage.scrub").account(
                emitted=5, delivered=4, dropped=1, reason="corrupt")
            srv._write_selfstats()
        got = _query(port.query_port, sql)
        assert got and got == _query(ref.query_port, sql)
        assert {r[2]: r[3] for r in got} == {
            "delivered": 4.0, "dropped": 1.0, "emitted": 5.0,
            "in_flight": 0.0, "wait_p99_ms": 0.0}
        hb = _query(port.query_port,
                    "SELECT tag_json FROM deepflow_system WHERE "
                    "metric_name = 'server.heartbeat' AND "
                    "value_name = 'beats'")
        assert ['{"stage": "selfstats"}'] in hb
    finally:
        port.stop()
        ref.stop()


def _query(port: int, sql: str) -> list:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/query",
        data=json.dumps({"sql": sql, "db": "deepflow_system"}).encode())
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())["result"]["values"]
