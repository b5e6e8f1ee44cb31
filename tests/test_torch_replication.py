"""The port's replicated ingest held against the JAX package's on the CPU.

``HashRing`` placement, ``claimant`` and ``claim_mask`` equal to the
reference's on seeded member sets, agent ids and epochs (hypothesis);
ring snapshots read across the packages; fencing; the decoders' ring
tags on the native and pure paths against the reference's decoders;
``ReplicatedSender`` re-shipping a removed owner's unacked frames and
sending LOW frames once; the controller's ``assign_analyzers`` giving
the ring's order. Then R = 2 over three port shards in this process,
fed by four agents' replicated senders, with ``--storage`` off and on:
every query through every shard equals a solo server that took the same
frames, through the serial numpy path, the native query kernels, the
morsel-parallel scan and the bucket cache; one shard is stopped and the
same queries stay exact (``missing_shards == []``, ``covered_shards ==
[killed]``), the cached query asked before and after; the killed shard
restarts, the ring's epoch moves and the agents' senders adopt the new
owners with no frame dropped.
"""

import contextlib
import queue
import socket
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepflow_tpu.cluster import hashring as ref_hashring
from deepflow_tpu_torch.cluster.hashring import (ClaimTableView, HashRing,
                                                 claim_db_from_body)
from deepflow_tpu_torch.codec import FrameHeader, MessageType

MS = 1_000_000


def _members(ids) -> dict:
    return {int(s): {"addr": f"h{s}:1", "ingest": f"h{s}:2"} for s in ids}


MEMBERS3 = _members((1, 2, 3))


def _step_payload(i: int, run_id: int = 3) -> bytes:
    from deepflow_tpu_torch.tpuprobe.stepmetrics import encode_step_payload
    return encode_step_payload([{
        "time": 1_754_000_000_000_000_000 + i * MS, "end_ns": 0,
        "latency_ns": 500 + i % 7, "run_id": run_id, "step": i, "job": "t",
        "device_count": 4, "device_skew_ns": 0, "compute_ns": 1,
        "collective_ns": 1, "straggler_device": 0, "straggler_lag_ns": 0,
        "top_hlos": [], "host": f"host-{run_id}"}])


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- placement against the reference ----------------------------------------

_ids = st.sets(st.integers(1, 40), min_size=1, max_size=7)


@settings(max_examples=80, deadline=None)
@given(_ids, st.integers(1, 4), st.integers(1, 9),
       st.lists(st.integers(0, 0xFFFF), min_size=1, max_size=40),
       st.sets(st.integers(1, 40), max_size=7))
def test_owners_claimant_and_mask_equal_reference(ids, r, epoch, agents,
                                                  alive):
    port = HashRing(_members(ids), replication=r, epoch=epoch)
    ref = ref_hashring.HashRing(_members(ids), replication=r, epoch=epoch)
    for a in agents:
        assert port.owners(a) == ref.owners(a)
        assert port.ingest_addrs(a) == ref.ingest_addrs(a)
        assert port.claimant(a, epoch, alive) == ref.claimant(a, epoch,
                                                              alive)
    rng = np.random.default_rng(len(agents))
    ag = np.asarray(agents * 3, dtype=np.uint16)
    ep = rng.choice(np.array([0, epoch], dtype=np.uint32), len(ag))
    for s in ids:
        assert (port.claim_mask(ag, ep, s, alive)
                == ref.claim_mask(ag, ep, s, alive)).all()


@settings(max_examples=30, deadline=None)
@given(st.lists(_ids, min_size=1, max_size=5), st.integers(1, 3),
       st.integers(0, 5))
def test_build_history_and_covers_equal_reference(steps, r, token):
    p = q = None
    for ids in steps:
        p = HashRing.build(p, _members(ids), r, token)
        q = ref_hashring.HashRing.build(q, _members(ids), r, token)
        assert p.snapshot() == q.snapshot()
    for dead in ({1}, {2, 3}, {99}, set()):
        assert p.covers(dead) == q.covers(dead)
    for a in range(60):
        for e in list(p.history) + [123]:
            assert p.owners_at(a, e) == q.owners_at(a, e)


def test_snapshots_read_across_packages_and_fencing():
    ring = HashRing.build(None, MEMBERS3, replication=2, token=5)
    ref = ref_hashring.HashRing.from_snapshot(ring.snapshot())
    back = HashRing.from_snapshot(ref.snapshot())
    assert back.snapshot() == ring.snapshot() == ref.snapshot()
    for aid in range(100):
        assert back.owners(aid) == ring.owners(aid) == ref.owners(aid)
    old = HashRing(MEMBERS3, epoch=9, token=1)
    new = HashRing(MEMBERS3, epoch=2, token=2)
    assert new.newer_than(old) and not old.newer_than(new)
    assert HashRing(MEMBERS3, epoch=10, token=1).newer_than(old)
    from deepflow_tpu_torch.cluster.membership import ClusterMembership
    m = ClusterMembership(1, "127.0.0.1:1")
    assert m.adopt_ring(ref_hashring.HashRing(
        MEMBERS3, epoch=2, token=1).snapshot())
    assert not m.adopt_ring(HashRing(MEMBERS3, epoch=1, token=1).snapshot())
    assert m.ring.epoch == 2
    assert m.adopt_ring(HashRing(MEMBERS3, epoch=1, token=2).snapshot())
    assert m.ring.token == 2 and m.stats["ring_adoptions"] == 2
    assert not m.publish_ring(HashRing(MEMBERS3, epoch=5, token=1))


def test_claim_db_from_body_passthrough_without_ring():
    from deepflow_tpu_torch.store.db import Database
    db = Database(shard_id=1)
    assert claim_db_from_body({}, db, 1) is db
    view = claim_db_from_body(
        {"ring": HashRing(MEMBERS3).snapshot(), "alive": [1, 2]}, db, 1)
    assert view is not db and view.tables() == db.tables()


@pytest.mark.parametrize("chunk_rows", (7, 64, 1 << 16))
def test_claim_filter_reports_each_row_once(chunk_rows):
    """R = 2 copies, tagged as the decoders tag them, over many chunks:
    every alive set that covers the dead reports each row once."""
    from deepflow_tpu_torch.store.db import Database
    ring = HashRing(MEMBERS3, replication=2)
    dbs = {sid: Database(shard_id=sid, chunk_rows=chunk_rows)
           for sid in ring.members}
    agents = list(range(20, 30))
    for aid in agents:
        rows = [{"time": i, "agent_id": aid, "run_id": aid, "step": i,
                 "owner_shard": ring.owners(aid)[0],
                 "ring_epoch": ring.epoch} for i in range(25)]
        for sid in ring.owners(aid):
            dbs[sid].table("profile.tpu_step_metrics").append_rows(rows)
    for alive in ({1, 2, 3}, {1, 2}, {2, 3}, {1, 3}):
        views = [ClaimTableView(dbs[s].table("profile.tpu_step_metrics"),
                                ring, s, alive) for s in alive]
        assert sum(len(v) for v in views) == len(agents) * 25
        keys = []
        for v in views:
            cols = v.column_concat(["run_id", "step"])
            keys += list(zip(cols["run_id"].tolist(),
                             cols["step"].tolist()))
            assert len(v.view()) == len(cols["step"]) == sum(
                len(ch["step"]) for ch in v.snapshot())
        assert len(keys) == len(set(keys)) == len(agents) * 25


# -- the decoders' ring tags -------------------------------------------------

def test_span_rows_carry_the_ring_tags_on_both_paths():
    import test_torch_native as tn
    ring = HashRing(MEMBERS3, replication=2, epoch=4)
    items = tn._frames([tn._batch(s, n_spans=60) for s in range(3)],
                       agent_id=3)
    nat = tn._port_decoder()
    nat.ring = lambda: ring
    nat._handle_items(items)
    pure = tn._port_decoder()
    pure.ring = lambda: ring
    for h, p in items:
        pure.handle_pure(h, p)
    ref, ref_db = tn._ref_decoder()
    ref.ring = lambda: ref_hashring.HashRing.from_snapshot(ring.snapshot())
    ref._handle_items(items)
    for name in tn.SPAN_TABLES:
        rows = tn._rows(nat.db, name)
        assert rows and rows == tn._rows(pure.db, name) == \
            tn._rows(ref_db, name)
        cols = nat.db.table(name).column_concat(["owner_shard",
                                                 "ring_epoch"])
        assert set(cols["owner_shard"].tolist()) == {ring.owners(3)[0]}
        assert set(cols["ring_epoch"].tolist()) == {4}


@pytest.mark.parametrize("kind", ("flow", "doc"))
def test_flow_and_document_rows_carry_the_ring_tags(kind):
    import test_torch_flow_native as tf
    from deepflow_tpu.server import decoders as ref_decoders
    from deepflow_tpu_torch.server.decoders import (FlowLogDecoder,
                                                    MetricsDecoder)
    from deepflow_tpu_torch.server.tracetree import TraceTreeBuilder
    from test_torch_retention import _table_rows
    ring = HashRing(MEMBERS3, replication=2, epoch=6)
    if kind == "flow":
        cls, ref_cls, mtype = (FlowLogDecoder, ref_decoders.FlowLogDecoder,
                               MessageType.L4_LOG)
        payload, tables = tf.flow_batch(1), tf.FLOW_TABLES
    else:
        cls, ref_cls, mtype = (MetricsDecoder, ref_decoders.MetricsDecoder,
                               MessageType.METRICS)
        payload, tables = tf.doc_batch(1), tf.DOC_TABLES
    header = FrameHeader(msg_type=mtype, agent_id=3, org_id=1)
    nat, pure = tf._decoder(cls, ring=lambda: ring), \
        tf._decoder(cls, ring=lambda: ring)
    trees = None
    if kind == "flow":
        trees = TraceTreeBuilder(nat.db)
        nat.trace_trees = trees
    nat.handle(header, payload)
    pure.handle_pure(header, payload)
    assert nat.stats["native_batches"] == 1
    ref_db = tf.RefDatabase()
    ref = ref_cls(queue.Queue(), ref_db, tf.RefPlatform(),
                  ring=lambda: ref_hashring.HashRing.from_snapshot(
                      ring.snapshot()))
    ref_header = tf.RefHeader(msg_type=mtype, agent_id=3, org_id=1)
    if kind == "flow":  # the reference's protobuf path, as tf's tests
        ref._handle_pb(tf.pb.FlowLogBatch.FromString(payload), ref_header)
    else:
        ref.handle(ref_header, payload)
    for name in tables:
        got = _table_rows(nat.db.table(name))
        assert got == _table_rows(pure.db.table(name))
        assert got == _table_rows(ref_db.table(name)), name
        if got:
            t = nat.db.table(name).column_concat(["ring_epoch",
                                                  "owner_shard"])
            assert set(t["ring_epoch"].tolist()) == {6}
            assert set(t["owner_shard"].tolist()) == {ring.owners(3)[0]}
    if trees is not None:
        # a server-local sink: its table has no ring columns, so the
        # claim filter passes it through (each shard's own copy)
        trees.stop()
        tt = nat.db.table("flow_log.trace_tree")
        assert len(tt) and "ring_epoch" not in tt.columns
        view = ClaimTableView(tt, ring, 1, {1})
        assert len(view) == len(tt)


# -- the controller and the sender -------------------------------------------

def test_assign_analyzers_gives_the_ring_order():
    from deepflow_tpu.server.controller import Controller as RefController
    from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPT
    from deepflow_tpu_torch.server.controller import Controller
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    ring = HashRing(MEMBERS3, replication=2)
    ctl = Controller(PlatformInfoTable(), port=0, ring_provider=lambda: ring)
    ref = RefController(RefPT(), port=0, ring_provider=lambda: ring)
    for aid in range(50):
        assert ctl.assign_analyzers(aid) == ring.ingest_addrs(aid) == \
            ref.assign_analyzers(aid)
        assert len(ctl.assign_analyzers(aid)) == 2
    # no ring: the flat list's rendezvous order, as before
    ctl.ring_provider = ref.ring_provider = lambda: None
    ctl.set_analyzers(["a:1", "b:2", "c:3"])
    ref.set_analyzers(["a:1", "b:2", "c:3"])
    assert [ctl.assign_analyzers(a) for a in range(20)] == \
        [ref.assign_analyzers(a) for a in range(20)]


def _server(**kw):
    from deepflow_tpu_torch.server.server import Server
    return Server(host="127.0.0.1", ingest_port=0, query_port=0,
                  selfstats_interval_s=3600, **kw).start()


def _steps(srv) -> list[int]:
    t = srv.db.table("profile.tpu_step_metrics")
    return sorted(t.column_concat(["step"])["step"].tolist())


def test_replicated_sender_reships_unacked_on_rebalance():
    """A removed owner's never-delivered frames go to the owner added,
    not to the retained one, which holds its copy already."""
    from deepflow_tpu_torch.agent.sender import ReplicatedSender
    a, c = _server(), _server()
    dead = _closed_port()
    sender = ReplicatedSender(
        [("127.0.0.1", a.ingest_port), ("127.0.0.1", dead)],
        replication=2, agent_id=7).start()
    try:
        for i in range(1, 21):
            sender.send(MessageType.STEP_METRICS, _step_payload(i))
        assert a.wait_for_rows("profile.tpu_step_metrics", 20, timeout=15)
        sender.set_destinations([f"127.0.0.1:{a.ingest_port}",
                                 ("127.0.0.1", c.ingest_port)])
        assert sender.stats["rebalances"] == 1
        assert sender.stats["reshipped"] >= 20
        assert c.wait_for_rows("profile.tpu_step_metrics", 20, timeout=15)
        time.sleep(0.3)
        assert _steps(a) == _steps(c) == list(range(1, 21))
        per = sender.per_destination()
        assert set(per) == {f"127.0.0.1:{a.ingest_port}",
                            f"127.0.0.1:{c.ingest_port}"}
        assert sender.stat_totals()["sent_frames"] >= 40
        # the same list again is no rebalance
        sender.servers = [("127.0.0.1", a.ingest_port),
                          ("127.0.0.1", c.ingest_port)]
        assert sender.stats["rebalances"] == 1
    finally:
        sender.flush_and_stop(timeout=2.0)
        a.stop()
        c.stop()


def test_replicated_sender_low_priority_single_copy():
    from deepflow_tpu_torch.agent.sender import ReplicatedSender
    from deepflow_tpu_torch.proto import wire
    a, b = _server(), _server()
    sender = ReplicatedSender(
        [("127.0.0.1", a.ingest_port), ("127.0.0.1", b.ingest_port)],
        replication=2, agent_id=7).start()
    try:
        batch = wire.StatsBatch(metrics=[wire.StatsMetric(
            name="repl_low", timestamp_ns=1, values={"v": 1.0})])
        sender.send(MessageType.DFSTATS, batch.SerializeToString())
        sender.send(MessageType.STEP_METRICS, _step_payload(1))
        assert a.wait_for_rows("deepflow_system.deepflow_system", 1,
                               timeout=10)
        assert b.wait_for_rows("profile.tpu_step_metrics", 1, timeout=10)
        time.sleep(0.3)
        assert len(b.db.table("deepflow_system.deepflow_system")) == 0
        assert len(a.db.table("profile.tpu_step_metrics")) == 1
    finally:
        sender.flush_and_stop(timeout=2.0)
        a.stop()
        b.stop()


def test_agent_builds_a_replicated_sender_with_a_spool_each(tmp_path):
    from deepflow_tpu_torch.agent.agent import Agent
    from deepflow_tpu_torch.agent.config import AgentConfig
    from deepflow_tpu_torch.agent.sender import ReplicatedSender
    cfg = AgentConfig.from_dict({
        "agent_id": 5,
        "sender": {"servers": ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"],
                   "replication": 2,
                   "spool": {"enabled": True, "dir": str(tmp_path)}},
        "tpuprobe": {"enabled": False}}).validate()
    agent = Agent(cfg, device=None)
    try:
        assert isinstance(agent.sender, ReplicatedSender)
        assert agent.sender.servers == [("127.0.0.1", 1), ("127.0.0.1", 2)]
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["127.0.0.1_1", "127.0.0.1_2"]
        assert len(agent.sender.threads()) == 2
    finally:
        agent.sender.flush_and_stop(0.1)
    with pytest.raises(ValueError, match="sender.replication"):
        AgentConfig.from_dict({"sender": {"replication": 9}}).validate()


def test_replicated_shard_decodes_nothing_before_it_holds_a_ring():
    """A shard started with replication whose seed has not answered yet
    holds its frames queued, unacked, until a ring arrives, so no row is
    tagged ring_epoch 0 (the single-copy tag, reported by every owner).
    The reference decodes at once and tags those rows 0: a restarted
    replica's first frames count twice (ROADMAP Queue 3)."""
    from deepflow_tpu.server import Server as RefServer
    from deepflow_tpu_torch.agent.sender import UniformSender
    seed = f"127.0.0.1:{_closed_port()}"
    port = _server(shard_id=2, cluster_seed=seed, replication=2)
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    shard_id=2, cluster_seed=seed, replication=2).start()
    senders = [UniformSender([("127.0.0.1", s.ingest_port)],
                             agent_id=7).start() for s in (port, ref)]
    table = "profile.tpu_step_metrics"
    try:
        for i in range(1, 6):
            for snd in senders:
                snd.send(MessageType.STEP_METRICS, _step_payload(i))
        assert ref.wait_for_rows(table, 5, timeout=10)
        assert set(ref.db.table(table).column_concat(["ring_epoch"])[
            "ring_epoch"].tolist()) == {0}
        time.sleep(0.5)
        assert len(port.db.table(table)) == 0
        # nothing past the seq base the sender announced is acked
        assert senders[0].stats["acked_seq"] <= senders[0].seq_base
        port.membership.adopt_ring(HashRing(
            _members((2, 3)), replication=2, epoch=3).snapshot())
        assert port.wait_for_rows(table, 5, timeout=10)
        cols = port.db.table(table).column_concat(["ring_epoch"])
        assert set(cols["ring_epoch"].tolist()) == {3}
        _wait(lambda: senders[0].stats["acked_seq"]
              >= senders[0].seq_base + 5, "every frame acked")
    finally:
        for snd in senders:
            snd.flush_and_stop(timeout=1.0)
        port.stop()
        ref.stop()


# -- R = 2 over three port shards ----------------------------------------------

AGENTS = (41, 42, 43, 44, 45, 46)
N_STEPS = 30
SPAN_BATCHES = 2


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(what)
        time.sleep(0.05)


def _post(port: int, body: dict, path: str = "/v1/query") -> dict:
    import json
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module", params=(False, True),
                ids=("memory", "storage"))
def replicated(request, tmp_path_factory):
    """{sid: Server} at R = 2, a solo server, the agents' senders and the
    frames each sent."""
    import test_torch_native as tn
    from deepflow_tpu_torch.agent.sender import (ReplicatedSender,
                                                 UniformSender)
    storage = request.param
    root = tmp_path_factory.mktemp("repl")

    def kw(sid):
        out = {"sync_port": 0, "shard_id": sid, "replication": 2,
               "fanout_timeout_s": 2.0}
        if storage:
            out.update(data_dir=str(root / f"s{sid}"), storage=True,
                       flush_interval_s=0.2)
        return out

    servers, senders = {}, {}
    state = {"servers": servers, "senders": senders, "storage": storage,
             "kw": kw}
    try:
        servers[1] = _server(cluster_advertise="", **kw(1))
        seed = f"127.0.0.1:{servers[1].query_port}"
        for sid in (2, 3):
            servers[sid] = _server(cluster_seed=seed, **kw(sid))
        state["seed"] = seed
        _wait(lambda: all(s.membership.ring is not None
                          and sorted(s.membership.ring.members) == [1, 2, 3]
                          for s in servers.values()),
              "the ring never converged on every shard")
        ring = servers[1].membership.ring
        assert all(s.membership.ring.epoch == ring.epoch
                   for s in servers.values())
        solo = _server()
        state["solo"] = solo
        one = {aid: UniformSender([("127.0.0.1", solo.ingest_port)],
                                  agent_id=aid).start() for aid in AGENTS}
        frames = []
        for aid in AGENTS:
            senders[aid] = ReplicatedSender(ring.ingest_addrs(aid),
                                            replication=2,
                                            agent_id=aid).start()
            for i in range(1, N_STEPS + 1):
                frames.append((aid, MessageType.STEP_METRICS,
                               _step_payload(i, run_id=aid)))
            for b in range(SPAN_BATCHES):
                frames.append((aid, MessageType.TPU_SPAN,
                               tn._batch(aid * 10 + b, n_spans=50,
                                         n_mem=0)))
        for aid, mt, p in frames:
            senders[aid].send(mt, p)
            one[aid].send(mt, p)
        state["spans"] = len(
            [1 for _a, mt, _p in frames if mt == MessageType.TPU_SPAN]) * 55
        for s in one.values():
            s.flush_and_stop(5.0)
        want = len(AGENTS) * N_STEPS
        _wait(lambda: len(solo.db.table("profile.tpu_step_metrics"))
              == want, "the solo server took every frame")
        _wait(lambda: sum(len(s.db.table("profile.tpu_step_metrics"))
                          for s in servers.values()) == 2 * want,
              "every frame on its two owners")
        _wait(lambda: sum(len(s.db.table("profile.tpu_hlo_span"))
                          for s in servers.values())
              == 2 * len(solo.db.table("profile.tpu_hlo_span")),
              "every span on its two owners")
        if storage:
            for s in list(servers.values()) + [solo]:
                if s.flusher is not None:
                    s.flusher.flush_once(seal=True)
            assert all(s.db.table("profile.tpu_step_metrics").tier
                       is not None for s in servers.values())
        state["victim"] = next(s for s in (3, 2, 1) if any(
            s == ring.owners(a)[0] for a in AGENTS))
        yield state
    finally:
        for s in senders.values():
            s.flush_and_stop(timeout=1.0)
        for s in list(servers.values()) + [state.get("solo")]:
            if s is not None:
                with contextlib.suppress(Exception):
                    s.stop()


QUERIES = {
    "count": "SELECT Count(*) AS n FROM profile.tpu_step_metrics",
    "sum_by_run": ("SELECT run_id, Sum(latency_ns) AS s, Count() AS n "
                   "FROM profile.tpu_step_metrics GROUP BY run_id "
                   "ORDER BY run_id"),
    "distinct": ("SELECT host, Count(DISTINCT step) AS d, Avg(latency_ns) "
                 "AS a FROM profile.tpu_step_metrics GROUP BY host "
                 "ORDER BY host"),
    "rows": ("SELECT run_id, step, latency_ns FROM "
             "profile.tpu_step_metrics WHERE step > 25 "
             "ORDER BY run_id, step"),
    "spans": ("SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n FROM "
              "profile.tpu_hlo_span GROUP BY hlo_op ORDER BY d DESC "
              "LIMIT 5"),
    "span_agents": ("SELECT agent_id, Count() AS n FROM "
                    "profile.tpu_hlo_span GROUP BY agent_id "
                    "ORDER BY agent_id"),
}

MODES = {
    # (env, the kernel the cost models choose, or None for theirs)
    "serial_numpy": ({"DF_QUERY_PARALLEL": "0", "DF_QUERY_CACHE": "0"},
                     "numpy"),
    "native": ({"DF_QUERY_PARALLEL": "0", "DF_QUERY_CACHE": "0"},
               "native"),
    "morsel": ({"DF_QUERY_PARALLEL": "1", "DF_QUERY_MORSEL_ROWS": "16",
                "DF_QUERY_CACHE": "0"}, None),
    "bucket_cache": ({"DF_QUERY_CACHE": "1"}, None),
}


@contextlib.contextmanager
def _mode(name: str, monkeypatch):
    from deepflow_tpu_torch.query import engine
    env, kern = MODES[name]
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        if kern is not None:
            m.setattr(engine._COST, "choose", lambda n: kern)
            m.setattr(engine._FILT, "choose", lambda n: kern)
        yield


def _answers(state, alive: list[int], mode: str, monkeypatch):
    solo = state["solo"]
    with _mode(mode, monkeypatch):
        want = {q: _post(solo.query_port, {"sql": sql})["result"]
                for q, sql in QUERIES.items()}
        out = []
        for sid in alive:
            port = state["servers"][sid].query_port
            for q, sql in QUERIES.items():
                got = _post(port, {"sql": sql})
                out.append((sid, q, got["result"], got["federation"],
                            want[q]))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_healthy_cluster_answers_exactly(replicated, mode, monkeypatch):
    raw = sum(len(s.db.table("profile.tpu_step_metrics"))
              for s in replicated["servers"].values())
    assert raw == 2 * len(AGENTS) * N_STEPS  # every frame on two shards
    for sid, q, got, fed, want in _answers(replicated, [1, 2, 3], mode,
                                           monkeypatch):
        assert fed["missing_shards"] == [] and fed["shards"] == 3, (sid, q)
        assert "covered_shards" not in fed
        assert got == want, (sid, q)


def test_cached_query_before_the_kill(replicated, monkeypatch):
    """Asked twice (the second a warm hit) before the kill; the same
    query is asked again after it below."""
    for _ in range(2):
        for sid, q, got, fed, want in _answers(replicated, [1, 2],
                                               "bucket_cache", monkeypatch):
            assert got == want and fed["missing_shards"] == [], (sid, q)
    fed = replicated["servers"][1].api.federation
    assert fed.sql_cache_counters["warm_hits"] >= 1


def test_kill_one_shard(replicated):
    victim = replicated["victim"]
    replicated["servers"].pop(victim).stop()
    replicated["killed"] = victim


@pytest.mark.parametrize("mode", sorted(MODES))
def test_answers_stay_exact_after_the_kill(replicated, mode, monkeypatch):
    victim = replicated["killed"]
    alive = sorted(replicated["servers"])
    assert victim not in alive and len(alive) == 2
    for sid, q, got, fed, want in _answers(replicated, alive, mode,
                                           monkeypatch):
        assert fed["missing_shards"] == [], (sid, q, fed)
        assert fed["covered_shards"] == [victim], (sid, q, fed)
        assert got == want, (sid, q)


@pytest.mark.parametrize("route", ("/v1/profile/TpuFlame", "/v1/tpu/steps"))
def test_profile_routes_stay_exact_after_the_kill(replicated, route):
    solo = replicated["solo"]
    body = {"job": "t"} if "steps" in route else {}
    want = _post(solo.query_port, body, route)
    for sid in sorted(replicated["servers"]):
        got = _post(replicated["servers"][sid].query_port, body, route)
        fed = got.pop("federation")
        assert fed["missing_shards"] == [] and \
            fed["covered_shards"] == [replicated["killed"]]
        assert got == want


def test_restart_moves_the_ring_and_agents_follow(replicated):
    """The killed shard back on new ports: the directory bumps, the
    seed's ring moves to a new epoch, and each agent's sender adopts the
    new owners (its synchronizer's path) with every frame acked and
    none dropped. With storage the restarted shard recovers its rows and
    the answers stay exact. Without, it comes back empty yet alive, and
    the reference's claim rule (the first ALIVE owner of a row's epoch
    reports it) makes it the claimant of rows it lost: the answer is
    short by exactly those rows, in both packages' rule."""
    from deepflow_tpu_torch.agent.synchronizer import Synchronizer
    servers, victim = replicated["servers"], replicated["killed"]
    seed = servers[1].membership
    old = seed.ring
    version0 = seed.directory.version
    servers[victim] = _server(cluster_seed=replicated["seed"],
                              **replicated["kw"](victim))
    _wait(lambda: seed.ring.epoch > old.epoch
          and seed.ring.members[victim]["ingest"]
          == f"127.0.0.1:{servers[victim].ingest_port}",
          "the ring never moved to a new epoch")
    assert seed.directory.version > version0
    ring = seed.ring
    for aid, sender in replicated["senders"].items():
        fake = type("F", (), {})()
        fake.agent = type("A", (), {"sender": sender})()
        fake._configured_servers = list(sender.servers)
        fake.stats = {"rebalances": 0}
        Synchronizer._apply_analyzers(fake, ring.ingest_addrs(aid))
        assert [f"{h}:{p}" for h, p in sender.servers] == \
            ring.ingest_addrs(aid)
    for sender in replicated["senders"].values():
        assert sender.flush(10.0)
        tot = sender.stat_totals()
        assert tot["dropped"] == 0 and tot["unacked_evicted"] == 0
    _wait(lambda: all(s.membership.ring is not None
                      and s.membership.ring.epoch == ring.epoch
                      for s in servers.values()),
          "every shard adopted the new ring")
    solo = replicated["solo"]
    want = _post(solo.query_port, {"sql": QUERIES["count"]})["result"]
    for sid in sorted(servers):
        got = _post(servers[sid].query_port, {"sql": QUERIES["count"]})
        assert got["federation"]["missing_shards"] == []
        if replicated["storage"]:
            assert got["result"] == want
            continue
        lost = sum(N_STEPS for a in AGENTS
                   if old.claimant(a, old.epoch, {1, 2, 3}) == victim)
        ref = ref_hashring.HashRing.from_snapshot(old.snapshot())
        assert lost == sum(N_STEPS for a in AGENTS if ref.claimant(
            a, old.epoch, {1, 2, 3}) == victim) > 0
        assert got["result"]["values"][0][0] == \
            want["values"][0][0] - lost
