"""The port's on-disk spool, fault injection and durable sender under
faults, held against the JAX package's on the CPU: equal spool behaviour
and bytes on the same operation sequence, spools readable across the
packages, the same fault schedule from the same seed, exactly-once rows
with a balanced ledger under seeded faults into both servers, and an
agent restart that replays what the first boot spooled."""

import json
import os
import random
import socket
import time

import pytest

from deepflow_tpu import chaos as ref_chaos
from deepflow_tpu.agent.spool import Spool as RefSpool
from deepflow_tpu.server import Server as RefServer
from deepflow_tpu.tpuprobe.stepmetrics import encode_step_payload
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig, ProfilerConfig
from deepflow_tpu_torch.agent.sender import UniformSender
from deepflow_tpu_torch.agent.spool import Spool
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.telemetry import Telemetry

STEP = int(MessageType.STEP_METRICS)
STEPS_TABLE = "profile.tpu_step_metrics"


def _wait(cond, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def _state(sp) -> tuple:
    return (sp.pending_records(), sp.pending_bytes(), sp.max_seq(),
            sp.min_pending_seq(), dict(sp.stats))


# -- the spool -----------------------------------------------------------------

def _spool_ops(cls, d, seed: int) -> list:
    """A seeded run of appends (seqs mostly rising, some out of order),
    replays, trims, reopenings and torn tails; returns every answer."""
    rng = random.Random(seed)
    evicted = []
    kw = dict(max_bytes=12 << 10, segment_bytes=3 << 10,
              on_evict=lambda n, r: evicted.append((n, r)))
    sp = cls(str(d), **kw)
    out, seq = [], 0
    for _ in range(400):
        op = rng.random()
        if op < 0.7:
            seq += rng.randrange(1, 4)
            s = seq if rng.random() < 0.9 else max(1, seq - rng.randrange(50))
            payload = bytes(rng.randrange(256)
                            for _ in range(rng.randrange(1, 600)))
            out.append(("append", sp.append(rng.choice([1, STEP, 10]), s,
                                            payload)))
        elif op < 0.8:
            out.append(("replay", sp.replay(rng.randrange(seq + 1))))
        elif op < 0.9:
            out.append(("trim", sp.trim(rng.randrange(seq + 1))))
        elif op < 0.95:
            sp.close()
            sp = cls(str(d), **kw)
            out.append(("reopen", _state(sp)))
        else:
            sp.close()
            names = sorted(os.listdir(d))
            if names:  # tear the newest segment mid-record
                path = os.path.join(d, names[-1])
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(0, size - rng.randrange(1, 40)))
            sp = cls(str(d), **kw)
            out.append(("torn", _state(sp)))
        out.append(("state", _state(sp)))
    sp.close()
    out.append(("evicted", evicted))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_spool_equals_reference_on_the_same_sequence(seed, tmp_path):
    mine = _spool_ops(Spool, tmp_path / "port", seed)
    ref = _spool_ops(RefSpool, tmp_path / "ref", seed)
    assert mine == ref
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    kinds = {k for k, _ in mine}
    assert {"append", "replay", "trim", "reopen", "torn"} <= kinds
    assert mine[-1][1], "the cap evicted nothing"


def _spill_replay_trim(cls, d):
    sp = cls(str(d), max_bytes=1 << 20, segment_bytes=32 << 10)
    assert all(sp.append(STEP, i, b"p" * 64) for i in range(1, 201))
    out = [sp.pending_records(), [s for _, s, _ in sp.replay(150)]]
    sp.trim(199)
    sp.close()
    sp2 = cls(str(d), max_bytes=1 << 20, segment_bytes=32 << 10)
    out += [[s for _, s, _ in sp2.replay(150)], sp2.max_seq()]
    sp2.close()
    assert out[0] == 200 and out[1] == list(range(151, 201))
    return out


def _evict_at_cap(cls, d):
    evicted = []
    sp = cls(str(d), max_bytes=8 << 10, segment_bytes=2 << 10,
             on_evict=lambda n, reason: evicted.append((n, reason)))
    for i in range(1, 501):
        sp.append(STEP, i, b"p" * 64)
    seqs = [s for _, s, _ in sp.replay(0)]
    assert sp.pending_bytes() <= 8 << 10 and seqs[-1] == 500
    assert evicted and all(r == "spool_evict" for _, r in evicted)
    assert sp.stats["evicted"] == sum(n for n, _ in evicted)
    sp.close()
    return [seqs, evicted]


def _out_of_order_trim(cls, d):
    sp = cls(str(d), segment_bytes=4096)
    big = b"p" * 3000
    assert sp.append(STEP, 5000, big)
    assert sp.append(STEP, 100, b"respooled")
    assert sp.append(STEP, 5001, big)  # rotates
    out = [sp.max_seq(), sp.min_pending_seq()]
    sp.trim(100)  # an ack of only the low seq: nothing may go
    out += [sp.pending_records(), sorted(s for _, s, _ in sp.replay(100))]
    sp.trim(5000)
    out.append([s for _, s, _ in sp.replay(0)])
    sp.close()
    sp2 = cls(str(d), segment_bytes=4096)
    out += [sp2.max_seq(), sp2.min_pending_seq()]
    sp2.close()
    assert out == [5001, 100, 3, [5000, 5001], [5001], 5001, 5001]
    return out


def _torn_tail(cls, d):
    sp = cls(str(d))
    for i in range(1, 11):
        sp.append(STEP, i, b"q" * 32)
    sp.close()
    path = os.path.join(str(d), sorted(os.listdir(d))[-1])
    with open(path, "r+b") as f:  # tear the last record mid-payload
        f.truncate(os.path.getsize(path) - 7)
    sp2 = cls(str(d))
    seqs = [s for _, s, _ in sp2.replay(0)]
    sp2.close()
    assert seqs == list(range(1, 10))
    return seqs


@pytest.mark.parametrize("scenario", [_spill_replay_trim, _evict_at_cap,
                                      _out_of_order_trim, _torn_tail],
                         ids=lambda f: f.__name__.strip("_"))
def test_spool_scenarios_like_reference(scenario, tmp_path):
    assert scenario(Spool, tmp_path / "port") == \
        scenario(RefSpool, tmp_path / "ref")


@pytest.mark.parametrize("writer,reader", [(Spool, RefSpool),
                                           (RefSpool, Spool)],
                         ids=["port-to-reference", "reference-to-port"])
def test_spool_readable_across_packages(writer, reader, tmp_path):
    rng = random.Random(5)
    records = [(rng.choice([1, STEP, 10]), 1000 + i,
                os.urandom(rng.randrange(1, 300))) for i in range(300)]
    sp = writer(str(tmp_path), segment_bytes=8 << 10)
    for mt, seq, payload in records:
        assert sp.append(mt, seq, payload)
    sp.trim(1099)
    sp.close()
    got = reader(str(tmp_path), segment_bytes=8 << 10)
    replayed = got.replay(0)
    assert replayed == [r for r in records if r[1] > got.min_pending_seq()
                        - 1]
    assert replayed[-1] == records[-1] and got.max_seq() == 1299
    assert got.stats["recovered"] == len(replayed)
    got.close()


# -- fault injection -----------------------------------------------------------

SPECS = ["seed=7,conn_refuse=0.3,conn_reset=0.2,partial_write=0.25",
         "seed=42,partial_write=0.5,disk_full=0.3,stall_p=0.4,stall_s=0.001",
         "seed=3,conn_reset=1.0",
         "enabled=0,seed=11,conn_refuse=0.5,tier_enospc=0.2,objstore_eio=0.1"]


class _Sock:
    def __init__(self) -> None:
        self.sent = b""
        self.closed = False

    def sendall(self, data: bytes) -> None:
        self.sent += data

    def close(self) -> None:
        self.closed = True


def _schedule(mod, spec: str) -> list:
    inj = mod.ChaosInjector(mod.ChaosConfig.parse(spec))
    rng = random.Random(1)
    out = []
    for i in range(300):
        hook = rng.choice(["connect", "send", "accept", "spool"])
        sock = _Sock()
        try:
            if hook == "connect":
                inj.on_connect()
            elif hook == "send":
                inj.on_send(sock, bytes(range(256)) * (1 + i % 3))
            elif hook == "accept":
                inj.on_accept()
            else:
                inj.on_spool_write()
            out.append((hook, "ok", sock.sent, sock.closed))
        except OSError as e:
            out.append((hook, type(e).__name__, e.errno, sock.sent,
                        sock.closed))
    return out + [inj.stats]


@pytest.mark.parametrize("spec", SPECS)
def test_same_seed_same_fault_schedule(spec):
    assert vars(chaos.ChaosConfig.parse(spec)) == \
        vars(ref_chaos.ChaosConfig.parse(spec))
    mine = _schedule(chaos, spec)
    assert mine == _schedule(ref_chaos, spec)
    assert any(r[1] != "ok" for r in mine[:-1]), "no fault was injected"


def test_chaos_from_env_like_reference(monkeypatch):
    monkeypatch.delenv("DF_CHAOS", raising=False)
    assert chaos.chaos_from_env() is None and \
        ref_chaos.chaos_from_env() is None
    for bad in ("seed=1,no_such_knob=1", "conn_reset=x"):
        monkeypatch.setenv("DF_CHAOS", bad)
        with pytest.raises(ValueError):
            chaos.ChaosConfig.parse(bad)
        assert chaos.chaos_from_env() is None
    monkeypatch.setenv("DF_CHAOS", SPECS[0])
    mine, ref = chaos.chaos_from_env(), ref_chaos.chaos_from_env()
    assert vars(mine.config) == vars(ref.config) and mine.config.enabled
    # the sender and the receiver take it from the environment
    sender = UniformSender([("127.0.0.1", 1)])
    assert vars(sender._chaos.config) == vars(ref.config)
    srv = Server(ingest_port=0, query_port=0)
    assert vars(srv.receiver._chaos.config) == vars(ref.config)


# -- the sender under faults, into both servers --------------------------------

def _step_payload(i: int) -> bytes:
    return encode_step_payload([{
        "time": i * 1_000_000, "end_ns": i * 1_000_000 + 500,
        "latency_ns": 500, "run_id": 3, "step": i, "job": "t",
        "device_count": 1, "device_skew_ns": 0, "compute_ns": 1,
        "collective_ns": 1, "straggler_device": 0, "straggler_lag_ns": 0,
        "top_hlos": []}])


def _start(kind: str):
    if kind == "port":
        return Server(ingest_port=0, query_port=0).start()
    return RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                     selfstats_interval_s=3600).start()


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _steps(srv) -> list[int]:
    t = srv.db.table(STEPS_TABLE)
    return sorted(t.column_concat(["step"])["step"].tolist())


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_spool_and_chaos_exactly_once_into_both_servers(kind, tmp_path):
    """HIGH frames sent while no server listens overflow a tiny queue
    into the spool; once a server is reachable they replay through
    seeded connection refusals, resets and partial writes. Every step
    lands exactly once and the sender's ledger balances."""
    srv = _start(kind)
    tel = Telemetry("agent", enabled=True)
    inj = chaos.ChaosInjector(chaos.ChaosConfig(
        enabled=True, seed=17, conn_refuse=0.2, conn_reset=0.04,
        partial_write=0.06))
    sender = UniformSender([("127.0.0.1", _closed_port())], agent_id=9,
                           queue_size=4, telemetry=tel,
                           spool=Spool(str(tmp_path)), chaos=inj).start()
    n = 120
    try:
        for i in range(1, n // 2 + 1):
            assert sender.send(MessageType.STEP_METRICS, _step_payload(i))
        assert sender.stats["spooled"] >= n // 2 - 5
        sender.servers.append(("127.0.0.1", srv.ingest_port))
        for i in range(n // 2 + 1, n + 1):
            assert sender.send(MessageType.STEP_METRICS, _step_payload(i))
            if i % 10 == 0:
                time.sleep(0.01)
        assert _wait(lambda: len(srv.db.table(STEPS_TABLE)) >= n,
                     timeout=30), len(srv.db.table(STEPS_TABLE))
        # every spooled record acked (the open segment stays on disk
        # until the spool rotates or trims past it)
        assert _wait(lambda: sender.stats["acked_seq"]
                     >= sender.spool.max_seq() and not sender._pending
                     and sender._q.empty(), timeout=30)
    finally:
        sender.flush_and_stop(timeout=10)
        time.sleep(0.1)
        srv.stop()
    assert _steps(srv) == list(range(1, n + 1))  # each once
    faults = inj.stats
    assert faults["conn_refused"] + faults["conn_reset"] \
        + faults["partial_writes"] > 0
    h = tel.hop("sender").snapshot()
    assert (h["emitted"], h["delivered"], h["dropped_total"],
            h["in_flight"]) == (n, n, 0, 0), h
    assert sender.stats["replayed"] >= sender.stats["spooled"] > 0


def test_acks_trim_window_and_spool(tmp_path):
    srv = _start("port")
    sender = UniformSender([("127.0.0.1", srv.ingest_port)], agent_id=9,
                           spool=Spool(str(tmp_path))).start()
    try:
        n = 30
        for i in range(1, n + 1):
            sender.send(MessageType.STEP_METRICS, _step_payload(i))
        assert srv.wait_for_rows(STEPS_TABLE, n)
        assert _wait(lambda: sender.stats["acked_seq"] == sender.seq_base + n)
        assert not sender._unacked and not sender._pending
        assert sender.spool.pending_records() == 0
    finally:
        sender.flush_and_stop()
        srv.stop()


@pytest.mark.parametrize("kind", ["port", "reference"])
def test_restarted_agent_replays_the_spool_once(kind, tmp_path):
    """An agent with no server spools its HIGH frames and stops; a new
    agent with the same id and spool directory starts past the spooled
    seqs and replays them into the server, once each, beside its own."""
    spool_dir = str(tmp_path / "spool")

    def config(port: int) -> AgentConfig:
        cfg = AgentConfig(app_service="svc", agent_id=12,
                          stats_interval_s=3600,
                          profiler=ProfilerConfig(enabled=False))
        cfg.guard.enabled = False
        cfg.sender.servers = [("127.0.0.1", port)]
        cfg.sender.queue_size = 1
        cfg.sender.spool.enabled = True
        cfg.sender.spool.dir = spool_dir
        return cfg

    first = Agent(config(_closed_port()), device="cpu").start()
    for i in range(1, 41):
        first.send_step_metrics(_step_payload(i))
    spooled = first.sender.stats["spooled"]
    spooled_steps = [json.loads(p)["records"][0]["step"]
                     for _, _, p in first.sender.spool.replay(0)]
    max_seq = first.sender.spool.max_seq()
    first.stop()  # the server is away: the queued frame goes with it
    assert spooled >= 38 and len(spooled_steps) == spooled
    srv = _start(kind)
    try:
        second = Agent(config(srv.ingest_port), device="cpu")
        assert second.sender.seq_base >= max_seq
        assert second.sender.spool.stats["recovered"] == spooled
        second.start()
        for i in range(101, 111):
            assert second.send_step_metrics(_step_payload(i))
        assert _wait(lambda: len(srv.db.table(STEPS_TABLE))
                     >= spooled + 10, timeout=20)
        assert _wait(lambda: second.sender.stats["acked_seq"]
                     >= second.sender.spool.max_seq())
        second.stop()
        time.sleep(0.1)
    finally:
        srv.stop()
    assert _steps(srv) == sorted(spooled_steps + list(range(101, 111)))
    h = second.telemetry.hop("sender").snapshot()
    # the recovered records were emitted on this boot's ledger too
    assert h["emitted"] == h["delivered"] + h["dropped_total"]
    assert h["dropped_total"] == 0
    assert h["delivered"] >= spooled + 10
