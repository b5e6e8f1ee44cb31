"""The port's read tier against the reference's: stateless querier
replicas over the shared object store (``store/objstore.py``,
``store/segcache.py``) answer equal to one server holding every row; a
pointer swap mid-query waits for the frozen snapshot; a stale exclusion
after a compaction is refused; the segment cache defers an evicted
segment's unlink until its last pin drops and never blocks a release on
its lock. Each test of ``tests/test_readtier.py`` has its counterpart
here (its publisher no-op test in ``test_torch_objstore.py``), run
through both packages or held against the reference's answers. A store
published by either package is adopted by the other's ``ReadTier`` with
equal answers and equal ``pub_token``s, and a read replica beside an
R = 2 replicated pair stays exact through a shard's stop and restart."""

import gc
import importlib
import json
import os
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from deepflow_tpu.cli import dfctl as ref_dfctl
from deepflow_tpu.query import engine as ref_engine
from deepflow_tpu.server.server import Server as RefServer
from deepflow_tpu_torch.cli import dfctl
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.store.db import Database

TBL = "flow_log.l7_flow_log"
BASE_NS = 1_754_000_000_000_000_000
PKGS = ("deepflow_tpu", "deepflow_tpu_torch")

AGG = ("SELECT app_service, Count(*) AS n, Sum(response_duration) AS s, "
       "Min(response_code) AS mn, Max(response_code) AS mx "
       "FROM l7_flow_log GROUP BY app_service ORDER BY app_service")
SQLS = [
    AGG,
    "SELECT Count(DISTINCT endpoint) AS d, Count(*) AS n FROM l7_flow_log",
    "SELECT app_service, request_type, Count(*) AS n FROM l7_flow_log "
    "GROUP BY app_service, request_type ORDER BY app_service, request_type",
    "SELECT time, app_service, endpoint FROM l7_flow_log "
    "WHERE response_code = 200 ORDER BY time DESC LIMIT 7",
    "SELECT endpoint, Count(*) AS n FROM l7_flow_log "
    "WHERE app_service = 'svc-2' GROUP BY endpoint ORDER BY endpoint",
]


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    obj, sc = m("store.objstore"), m("store.segcache")
    return types.SimpleNamespace(
        name=name, objstore=obj, ObjStore=obj.ObjStore,
        SegmentPublisher=obj.SegmentPublisher, SegmentCache=sc.SegmentCache,
        ReadTier=sc.ReadTier, Database=m("store.db").Database,
        Server=m("server.server").Server)


@pytest.fixture(scope="module")
def pkgs():
    return [_pkg(n) for n in PKGS]


# each row's values by its index: a row is the same whatever batch holds it
_RNG = np.random.default_rng(16)
_SVC = _RNG.integers(0, 5, 4096)
_DUR = _RNG.integers(0, 90_000, 4096)


def _rows(n0: int, n: int, agent: int | None = None,
          epoch: int = 0) -> list[dict]:
    out = []
    for i in range(n0, n0 + n):
        r = {"time": BASE_NS + i * 1_000_000, "flow_id": 100 + i,
             "app_service": f"svc-{int(_SVC[i])}",
             "endpoint": f"/api/{'abc'[i % 3]}",
             "request_type": "GET" if i % 2 == 0 else "POST",
             "response_code": (200, 404, 500)[i % 3],
             "response_duration": 10_000 + int(_DUR[i])}
        if agent is not None:
            r["agent_id"], r["ring_epoch"] = agent, epoch
        out.append(r)
    return out


def _post(port: int, body: dict, path: str = "/v1/query") -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def _canon(x):
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, float)):
        return round(float(x), 6)
    if isinstance(x, list):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    return x


def _answer(port: int, sql: str) -> dict:
    return _canon(_post(port, {"sql": sql, "db": "flow_log"})["result"])


# -- the segment cache: LRU eviction against an in-flight scan --------------

def _published(P, d, batches):
    """One sealed segment per batch, published; (store, its entries)."""
    db = P.Database(data_dir=str(d / "ing"), shard_id=1, storage=True)
    for rows in batches:
        db.table(TBL).append_rows(rows)
        assert db.flush_to_tier() == len(rows)
    P.SegmentPublisher(P.ObjStore(str(d / "obj")), 1).publish(db.tier_store)
    store = P.ObjStore(str(d / "obj"))
    doc = store.get_pointer(P.objstore.pointer_name(1))
    return store, doc["tables"][TBL]["segments"]


class _Holder:
    pass


def _rs(seg):
    return types.SimpleNamespace(key=(1, TBL, seg["fn"]), shard=1,
                                 table=TBL, fn=seg["fn"])


def test_eviction_defers_unlink_until_last_ref_drops(pkgs, tmp_path):
    """A segment evicted while a slow scan still pins its mmap keeps its
    file until the scan's reference drops; the finalizer then unlinks."""
    def run(P, d):
        store, segs = _published(P, d, [_rows(0, 8), _rows(8, 8)])
        cache = P.SegmentCache(str(d / "cache"), store, max_bytes=1)
        h1 = _Holder()
        ent1 = cache.pin(_rs(segs[0]), h1)
        seg1, path1 = ent1["seg"], ent1["path"]
        got, errs = [], []

        def slow_scan():
            try:
                for _ in range(10):
                    got.append(np.asarray(seg1.column("flow_id")).copy())
                    time.sleep(0.01)
            except Exception as e:  # pragma: no cover - the regression
                errs.append(e)
        scan = threading.Thread(target=slow_scan)
        scan.start()
        # a budget of one byte: the second pin evicts the first segment
        # while the scan above still holds it
        h2 = _Holder()
        cache.pin(_rs(segs[1]), h2)
        snap = cache.snapshot()
        state = (ent1["condemned"], ent1["unlinked"], os.path.exists(path1))
        scan.join(timeout=10)
        assert not errs
        for arr in got:
            np.testing.assert_array_equal(arr, np.arange(100, 108))
        del h1, ent1, seg1
        gc.collect()
        deadline = time.monotonic() + 5
        while os.path.exists(path1) and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.02)
        return ({k: snap[k] for k in ("evictions", "deferred_unlinks",
                                      "rows_evicted", "misses", "hits")},
                state, os.path.exists(path1))
    ref, port = (run(P, tmp_path / P.name) for P in pkgs)
    assert port == ref
    snap, state, exists_after = port
    assert snap["evictions"] == 1 and snap["deferred_unlinks"] == 1
    assert snap["rows_evicted"] == 8
    assert state == (True, False, True), "unlinked under a live scan"
    assert not exists_after


def test_release_never_blocks_on_held_cache_lock(pkgs, tmp_path):
    """A finalizer's release can fire in a thread that holds the cache
    lock (GC runs at any allocation); it must not block on the
    non-reentrant lock: the release is deferred to the next operation."""
    def run(P, d):
        store, segs = _published(P, d, [_rows(0, 8)])
        cache = P.SegmentCache(str(d / "cache"), store)
        h = _Holder()  # the pin lives while h does
        ent = cache.pin(_rs(segs[0]), h)
        cache.discard(_rs(segs[0]).key)  # condemned while still pinned
        before = (ent["condemned"], ent["unlinked"])
        assert cache._lock.acquire()     # the GC-interrupted thread's
        try:
            done = []
            t = threading.Thread(target=lambda: (cache._release(ent),
                                                 done.append(True)))
            t.start()
            t.join(timeout=5)
        finally:
            cache._lock.release()
        cache.snapshot()  # drains the deferred release
        return before, bool(done), ent["unlinked"], \
            os.path.exists(ent["path"])
    ref, port = (run(P, tmp_path / P.name) for P in pkgs)
    assert port == ref == ((True, False), True, True, False)


# -- the answers ------------------------------------------------------------

def _cluster(S, tmp_path, n_queriers=2, **ingest_kw):
    obj = str(tmp_path / "obj")
    # the tests flush and publish by hand: the loops stay idle
    ingest = S(host="127.0.0.1", ingest_port=0, query_port=0, sync_port=0,
               shard_id=1, cluster_advertise="", storage=True,
               data_dir=str(tmp_path / "ingest"), objstore=obj,
               publish_interval_s=60.0, flush_interval_s=3600,
               **ingest_kw).start()
    seed = f"127.0.0.1:{ingest.query_port}"
    qs = [S(host="127.0.0.1", ingest_port=0, query_port=0, sync_port=0,
            shard_id=8 + i, role="querier", objstore=obj, cluster_seed=seed,
            readtier_poll_s=60.0).start() for i in range(n_queriers)]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if all(len(q.api.federation.remote_peers()) == 1 for q in qs):
            break
        time.sleep(0.05)
    assert all(len(q.api.federation.remote_peers()) == 1 for q in qs)
    return ingest, qs


def _stop(*servers):
    for s in servers:
        s.stop()


@pytest.fixture(scope="module")
def solo():
    """The reference's standalone server over every row (0..24)."""
    s = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                  sync_port=0, selfstats_interval_s=3600).start()
    s.db.table(TBL).append_rows(_rows(0, 24))
    yield s
    s.stop()


def test_readtier_answers_byte_identical(tmp_path, solo, capsys):
    """A port ingest shard with two cold querier replicas, beside the
    reference's same deployment: sealed history from the replicas, live
    rows from the shard exactly once, every answer equal to the solo
    server's and to the reference replicas'; /v1/health's blocks."""
    clusters = {}
    try:
        for name, S in (("ref", RefServer), ("port", Server)):
            ingest, qs = _cluster(S, tmp_path / name)
            clusters[name] = (ingest, qs)
            # 16 rows sealed and published; 8 stay in RAM
            ingest.db.table(TBL).append_rows(_rows(0, 16))
            assert ingest.db.flush_to_tier() == 16
            assert ingest.publisher.maybe_publish(ingest.db.tier_store)
            ingest.db.table(TBL).append_rows(_rows(16, 8))
            for q in qs:
                q.readtier.poll()
                t = q.db.table(TBL)
                assert len(t) == 16 and t.tier.rows == 16
        for sql in SQLS:
            want = _answer(solo.query_port, sql)
            for name, (ingest, qs) in clusters.items():
                for q in qs:
                    got = _post(q.query_port, {"sql": sql, "db": "flow_log"})
                    assert got["federation"]["missing_shards"] == [], sql
                    assert _canon(got["result"]) == want, (name, sql)
        ingest, qs = clusters["port"]
        ref_ingest, ref_qs = clusters["ref"]
        for q, rq in zip(qs, ref_qs):
            assert q.readtier.snapshot()["adopted"] == {"1": 1} \
                == rq.readtier.snapshot()["adopted"]
            # the same adopted state hashes alike in both packages
            assert q.readtier.pub_token(TBL) == rq.readtier.pub_token(TBL)
        # queriers never enter the ingest ring or the scatter
        assert {p.shard_id for p in ingest.membership.peers(
            role="ingest")} == {1}
        assert ingest.api.federation.remote_peers() == []
        with urllib.request.urlopen(
                f"http://127.0.0.1:{qs[0].query_port}/v1/health",
                timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["readtier"]["tables"][TBL]["rows"] == 16
        assert "partial_cache" in health and "scrub" in health
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ingest.query_port}/v1/health",
                timeout=10) as resp:
            ih = json.loads(resp.read())
        assert ih["publish"]["publish_gen"] == 1
        assert "scrub" in ih["storage"]
        # dfctl readtier renders a replica's view as the reference's does
        outs = []
        for main in (ref_dfctl.main, dfctl.main):
            assert main(["--server", f"127.0.0.1:{qs[0].query_port}",
                         "readtier"]) in (0, None)
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0]
        assert "(ingest shard -> publish gen): 1->1" in outs[1]
    finally:
        for ingest, qs in clusters.values():
            _stop(*qs, ingest)


def test_manifest_swap_mid_query_consistent_snapshot(tmp_path):
    """A pointer swap while a query holds the frozen snapshot waits; the
    answers before, during and after it equal the reference solo's."""
    ref_solo = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                         sync_port=0, selfstats_interval_s=3600).start()
    ingest, qs = _cluster(Server, tmp_path, n_queriers=1)
    q = qs[0]
    body = {"sql": AGG, "db": "flow_log"}
    try:
        ref_solo.db.table(TBL).append_rows(_rows(0, 16))
        ingest.db.table(TBL).append_rows(_rows(0, 16))
        assert ingest.db.flush_to_tier() == 16
        assert ingest.publisher.maybe_publish(ingest.db.tier_store)
        q.readtier.poll()
        assert _answer(q.query_port, AGG) == _answer(ref_solo.query_port,
                                                     AGG)
        # gen 2 lands while the querier holds a frozen snapshot
        ref_solo.db.table(TBL).append_rows(_rows(16, 8))
        want24 = _answer(ref_solo.query_port, AGG)
        ingest.db.table(TBL).append_rows(_rows(16, 8))
        assert ingest.db.flush_to_tier() == 8
        assert ingest.publisher.maybe_publish(ingest.db.tier_store)
        with q.readtier.freeze():
            polled = threading.Thread(target=q.readtier.poll)
            polled.start()
            polled.join(timeout=0.3)
            assert polled.is_alive(), "adoption ran in a frozen snapshot"
            # frozen at gen 1, the shard at gen 2: the shard answers in
            # full and the stale local view is left out (in process: an
            # HTTP call would wait on the freeze this thread holds)
            assert _canon(q.api.query(body)["result"]) == want24
            assert q.readtier.snapshot()["adopted"] == {"1": 1}
        polled.join(timeout=10)
        assert not polled.is_alive()
        assert q.readtier.snapshot()["adopted"] == {"1": 2}
        assert len(q.db.table(TBL)) == 24
        assert _answer(q.query_port, AGG) == want24
    finally:
        _stop(q, ingest, ref_solo)


def test_handshake_refuses_stale_exclusion_after_compaction(tmp_path,
                                                            solo):
    """Between a compaction's commit and the next publish the shard's
    ``publisher.current`` names retired fns: the gen matches but the
    exclusion matches nothing while the run holds the same rows. The
    shard must not ack then, or every compacted row counts twice."""
    ingest, qs = _cluster(Server, tmp_path, n_queriers=1)
    q = qs[0]
    try:
        for lo in (0, 8, 16):
            ingest.db.table(TBL).append_rows(_rows(lo, 8))
            assert ingest.db.flush_to_tier() == 8
        assert ingest.publisher.maybe_publish(ingest.db.tier_store)
        q.readtier.poll()
        want = _answer(solo.query_port, AGG)
        assert _answer(q.query_port, AGG) == want
        res = ingest.db.compact_tier(TBL, min_merge=2)
        assert res["segments_replaced"] == 3
        gen, fn_sets = ingest.publisher.current
        live = {os.path.basename(s.path)
                for s in ingest.db.table(TBL).tier.segments()}
        assert gen == 1 and fn_sets[TBL] and not (fn_sets[TBL] & live)
        got = _post(q.query_port, {"sql": AGG, "db": "flow_log"})
        assert got["federation"]["missing_shards"] == []
        assert _canon(got["result"]) == want
        # the next publish re-arms the handshake at gen 2
        assert ingest.publisher.maybe_publish(ingest.db.tier_store)
        q.readtier.poll()
        assert q.readtier.snapshot()["adopted"] == {"1": 2}
        assert _answer(q.query_port, AGG) == want
    finally:
        _stop(q, ingest)


def test_querier_cache_rooted_in_subdir_preserves_data_dir(pkgs,
                                                           tmp_path):
    """The segment cache wipes its root at start, so a querier roots it
    in <data_dir>/segcache: a --data-dir naming an existing tier
    survives."""
    for P in pkgs:
        data = tmp_path / P.name / "data"
        (data / "tier").mkdir(parents=True)
        keep = data / "tier" / "seg-000001.bin"
        keep.write_bytes(b"precious segment bytes")
        (data / "MANIFEST.json").write_text("{}")
        q = P.Server(host="127.0.0.1", ingest_port=0, query_port=0,
                     sync_port=0, shard_id=9, role="querier",
                     objstore=str(tmp_path / P.name / "obj"),
                     data_dir=str(data)).start()
        try:
            assert q.segcache.root == os.path.join(str(data), "segcache")
            assert keep.read_bytes() == b"precious segment bytes"
            assert (data / "MANIFEST.json").exists()
        finally:
            q.stop()
    with pytest.raises(ValueError, match="objstore"):
        Server(ingest_port=0, query_port=0, role="querier")


# -- both directions across the packages ------------------------------------

@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)],
                         ids=["ref-publishes-port-adopts",
                              "port-publishes-ref-adopts"])
def test_store_adopted_across_packages(pkgs, tmp_path, writer, reader):
    """One package's publisher, the other's ReadTier: every answer equals
    a solo table's over the same rows, the remote tier's string columns
    remap into the reader's ids, and the pub_token equals the one the
    writer's own ReadTier computes."""
    W, R = pkgs[writer], pkgs[reader]
    db = W.Database(data_dir=str(tmp_path / "ing"), shard_id=1,
                    storage=True)
    for lo in (0, 300, 500):
        db.table(TBL).append_rows(_rows(lo, 300 if lo == 0 else 200))
        db.flush_to_tier()
    db.compact_tier(TBL, min_merge=2)
    db.table(TBL).append_rows(_rows(700, 100))
    db.flush_to_tier()
    W.SegmentPublisher(W.ObjStore(str(tmp_path / "obj")), 1) \
        .publish(db.tier_store)
    tiers = {}
    for P in (W, R):
        qdb = P.Database(shard_id=9)
        # the reader's own dictionary first holds other strings: its ids
        # differ from the publisher's
        qdb.table(TBL).dicts["app_service"].encode("svc-local")
        cache = P.SegmentCache(str(tmp_path / f"cache-{P.name}"),
                               P.ObjStore(str(tmp_path / "obj")),
                               max_bytes=1 << 20)
        rt = P.ReadTier(qdb, P.ObjStore(str(tmp_path / "obj")), cache,
                        shard_id=9)
        assert rt.poll() == 1
        tiers[P.name] = (qdb, rt)
    qdb, rt = tiers[R.name]
    assert rt.pub_token(TBL) == tiers[W.name][1].pub_token(TBL) != ""
    assert len(qdb.table(TBL)) == 800
    solo_db = Database()
    solo_db.table(TBL).append_rows(_rows(0, 300) + _rows(300, 200)
                                   + _rows(500, 200) + _rows(700, 100))
    run = engine.execute if R.name == "deepflow_tpu_torch" \
        else ref_engine.execute
    for sql in SQLS:
        want = engine.execute(solo_db.table(TBL), sql)
        got = run(qdb.table(TBL), sql)
        assert _canon(got.values) == _canon(want.values), sql


# -- a read replica beside an R = 2 replicated pair --------------------------

def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_read_replica_beside_replicated_pair(tmp_path, solo):
    """Two ingest shards at R = 2, each holding every row of four agents
    (sealed at different points, published), and a querier replica:
    each row counts once, claimed as the shard that published its copy.
    Stopping shard 2 (its blobs stay published) leaves the answer exact
    and covered; after a restart on its data dir it is exact again."""
    obj = str(tmp_path / "obj")
    kw = dict(host="127.0.0.1", ingest_port=0, query_port=0, sync_port=0,
              storage=True, objstore=obj, publish_interval_s=60.0,
              flush_interval_s=3600, replication=2, compact_interval_s=0)
    s1 = Server(shard_id=1, cluster_advertise="",
                data_dir=str(tmp_path / "s1"), **kw).start()
    seed = f"127.0.0.1:{s1.query_port}"
    s2 = Server(shard_id=2, cluster_seed=seed,
                data_dir=str(tmp_path / "s2"), **kw).start()
    q = Server(host="127.0.0.1", ingest_port=0, query_port=0, sync_port=0,
               shard_id=9, role="querier", objstore=obj,
               cluster_seed=seed, readtier_poll_s=60.0).start()
    servers = [q, s2, s1]
    try:
        assert _wait(lambda: s1.membership.ring is not None
                     and len(s1.membership.ring.members) == 2)
        epoch = s1.membership.ring.epoch
        assert _wait(lambda: all(
            s.membership.ring is not None
            and s.membership.ring.epoch == epoch for s in (s2, q)))
        # agent a's 6 rows land on both owners; each seals a different
        # prefix, so published and live halves differ between copies
        for s, cut in ((s1, 2), (s2, 4)):
            for a in range(4):
                rows = _rows(a * 6, 6, agent=a + 1, epoch=epoch)
                s.db.table(TBL).append_rows(rows[:cut])
                s.db.flush_to_tier()
                s.db.table(TBL).append_rows(rows[cut:])
            assert s.publisher.maybe_publish(s.db.tier_store)
        q.readtier.poll()
        assert q.readtier.snapshot()["adopted"] == {"1": 1, "2": 1}
        want = _answer(solo.query_port, AGG)
        got = _post(q.query_port, {"sql": AGG, "db": "flow_log"})
        assert got["federation"]["missing_shards"] == []
        assert _canon(got["result"]) == want
        for sql in SQLS[1:]:
            assert _answer(q.query_port, sql) \
                == _answer(solo.query_port, sql), sql
        # shard 2 stops (in process: a kill without the process); its
        # published copies stay, its claim moves to shard 1
        s2.stop()
        servers.remove(s2)
        got = _post(q.query_port, {"sql": AGG, "db": "flow_log"})
        assert got["federation"]["missing_shards"] == []
        assert got["federation"].get("covered_shards") == [2]
        assert _canon(got["result"]) == want
        # a restart on the same data dir re-joins; the querier adopts the
        # gen its stop published before the restarted shard publishes:
        # the shard names no fns yet, so it must answer in full
        s2 = Server(shard_id=2, cluster_seed=seed,
                    data_dir=str(tmp_path / "s2"), **kw).start()
        servers.append(s2)
        assert _wait(lambda: any(p.shard_id == 2 and p.addr.endswith(
            f":{s2.query_port}") for p in q.membership.peers()))
        q.readtier.poll()
        assert q.readtier.snapshot()["adopted"] == {"1": 1, "2": 2}
        got = _post(q.query_port, {"sql": AGG, "db": "flow_log"})
        assert got["federation"]["missing_shards"] == []
        assert _canon(got["result"]) == want
        # its first publish re-arms the handshake
        assert s2.publisher.maybe_publish(s2.db.tier_store)
        q.readtier.poll()
        assert q.readtier.snapshot()["adopted"] == {"1": 1, "2": 3}
        got = _post(q.query_port, {"sql": AGG, "db": "flow_log"})
        assert _canon(got["result"]) == want
    finally:
        _stop(*servers)
