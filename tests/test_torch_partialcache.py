"""The port's cluster-wide partial cache against the reference's:
CACHE_PARTIAL frames byte-equal both ways, the same share rules and
digests, the adverts riding the membership join exchange, the serving
side's refusals and token gate, and the compute-once ledger over three
querier replicas: once the first replica warms a storm of bucketable
aggregates, the others answer it with no bucket scan of their own, and
the buckets served fleet-wide equal the buckets fetched."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deepflow_tpu.cluster import partialcache as ref_pc
from deepflow_tpu.cluster import wire as ref_wire
from deepflow_tpu.cluster.membership import \
    ClusterMembership as RefMembership
from deepflow_tpu.server.server import Server as RefServer
from deepflow_tpu_torch.cluster import partialcache as pc
from deepflow_tpu_torch.cluster import wire
from deepflow_tpu_torch.cluster.membership import ClusterMembership
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.store.db import Database

TBL = "flow_log.l7_flow_log"
BASE_NS = 1_754_000_000_000_000_000
_RNG = np.random.default_rng(21)
_SVC = _RNG.integers(0, 6, 4096)
_DUR = _RNG.integers(0, 90_000, 4096)


def _rows(n0: int, n: int) -> list[dict]:
    # ten seconds apart: 60 s buckets hold six rows each
    return [{"time": BASE_NS + i * 10_000_000_000, "flow_id": 100 + i,
             "app_service": f"svc-{int(_SVC[i])}",
             "endpoint": f"/api/{'abcd'[i % 4]}",
             "request_type": "GET" if i % 2 == 0 else "POST",
             "response_code": (200, 404, 500)[i % 3],
             "response_duration": 10_000 + int(_DUR[i])}
            for i in range(n0, n0 + n)]


STORM = [
    "SELECT app_service, Count(*) AS n FROM l7_flow_log "
    "GROUP BY app_service ORDER BY app_service",
    "SELECT endpoint, Sum(response_duration) AS s FROM l7_flow_log "
    "GROUP BY endpoint ORDER BY endpoint",
    "SELECT app_service, Max(response_duration) AS m FROM l7_flow_log "
    "GROUP BY app_service ORDER BY app_service",
    "SELECT request_type, Min(response_duration) AS m FROM l7_flow_log "
    "GROUP BY request_type ORDER BY request_type",
]


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


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/query",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


# -- the wire ----------------------------------------------------------------

def _objects():
    rng = np.random.default_rng(3)
    db = Database()
    db.table(TBL).append_rows(_rows(0, 200))
    part = engine.execute_partial(
        db.table(TBL), STORM[1].replace(" ORDER BY endpoint", ""),
        encoded=True)
    yield {"buckets": {}}
    yield {"buckets": {"29233333": part}, "dict_sync": {
        "endpoint": {"gen": 1, "len": 4, "base": 0,
                     "delta": ["/api/a", "/api/b", "/api/c", "/api/d"]}}}
    yield {"buckets": {str(b): {"kind": "agg", "ids": rng.integers(
        0, 1 << 32, 17, dtype=np.uint64).astype(np.uint32),
        "sums": rng.normal(size=17), "n": np.int64(17)}
        for b in range(3)}, "nested": [[1, 2.5, "x"], {"y": None}]}


@pytest.mark.parametrize("i", range(3))
def test_cache_partial_frames_byte_equal(i):
    obj = list(_objects())[i]
    for sid in (0, 7, 65535):
        frame = wire.encode_cache_partial(obj, shard_id=sid)
        assert frame == ref_wire.encode_cache_partial(obj, shard_id=sid)
        for dec in (wire.decode_cache_partial, ref_wire.decode_cache_partial):
            got, got_sid = dec(frame)
            assert got_sid == sid
            assert wire.encode_cache_partial(got, shard_id=sid) == frame


def test_cache_partial_decode_refuses_other_frames():
    frame = wire.encode_result({"kind": "unchanged", "state": [1]},
                               shard_id=3)
    for dec, err in ((wire.decode_cache_partial, wire.WireError),
                     (ref_wire.decode_cache_partial, ref_wire.WireError)):
        with pytest.raises(err):
            dec(frame)


# -- share rules, digests, adverts ------------------------------------------

def test_share_rules_and_digests_match_reference():
    for extra in (None, ("org", 1), ("rt", 2), ("rt", None),
                  ("rt", 1, (3,)), ("fed", 1, "[1, 2]"), "x"):
        mine, theirs = pc.share_org(extra), ref_pc.share_org(extra)
        assert (mine is pc._UNSHARED) == (theirs is ref_pc._UNSHARED)
        if mine is not pc._UNSHARED:
            assert mine == theirs
    for org in (None, 1, 7):
        assert pc.key_variants(org) == ref_pc.key_variants(org)
        for sql in STORM:
            assert pc.digest_of(TBL, sql, org) \
                == ref_pc.digest_of(TBL, "  " + sql.replace(" ", "  "), org)


def test_adverts_ride_the_join_exchange():
    """A joiner's warm digests reach the seed, the seed's merged map
    rides the join answer back, own adverts are left out, and a digest
    names only an alive peer: as in the reference."""
    out = []
    for M in (RefMembership, ClusterMembership):
        seed = M(1, "127.0.0.1:1001")
        a = M(8, "127.0.0.1:1008", seed="127.0.0.1:1001", role="querier")
        b = M(9, "127.0.0.1:1009", seed="127.0.0.1:1001", role="querier")
        a.cache_adv_local = lambda: ["d1", "d2"]
        b.cache_adv_local = lambda: ["d3"]
        seed.directory.upsert(seed.self_peer())
        for j in (a, b):
            body = j.self_peer().to_dict()
            body["cache_adv"] = j._local_advs()
            resp = seed.handle_join(body)
            j.directory.adopt(resp)
            j._merge_advs(resp.get("cache_adv"))
        out.append((sorted(seed.cache_adverts().items()),
                    b.advert_for("d1"), b.advert_for("d3"),
                    a.advert_for("d3"), a.advert_for("nope")))
    assert out[1] == out[0]
    advs, b_d1, b_d3, a_d3, none = out[1]
    assert dict(advs)["d1"] == [8, "127.0.0.1:1008"]
    assert b_d1 == (8, "127.0.0.1:1008") and b_d3 is None
    assert a_d3 is None and none is None  # a never pulled b's advert


# -- three replicas: compute each bucket once --------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    obj = str(tmp / "obj")
    ingest = Server(host="127.0.0.1", ingest_port=0, query_port=0,
                    sync_port=0, shard_id=1, cluster_advertise="",
                    storage=True, data_dir=str(tmp / "ingest"),
                    objstore=obj, publish_interval_s=60.0,
                    flush_interval_s=3600).start()
    seed = f"127.0.0.1:{ingest.query_port}"
    qs = [Server(host="127.0.0.1", ingest_port=0, query_port=0,
                 sync_port=0, shard_id=8 + i, role="querier", objstore=obj,
                 cluster_seed=seed, readtier_poll_s=60.0,
                 api_token="s3cret").start() for i in range(3)]
    solo = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                     sync_port=0, selfstats_interval_s=3600).start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                len(q.api.federation.remote_peers()) == 1 for q in qs):
            time.sleep(0.05)
        for lo in (0, 120, 240):
            ingest.db.table(TBL).append_rows(_rows(lo, 120))
            assert ingest.db.flush_to_tier() == 120
        solo.db.table(TBL).append_rows(_rows(0, 360))
        assert ingest.publisher.maybe_publish(ingest.db.tier_store)
        for q in qs:
            q.readtier.poll()
        yield ingest, qs, solo
    finally:
        for s in (*qs, ingest, solo):
            s.stop()


def test_compute_once_ledger_over_three_replicas(fleet):
    ingest, qs, solo = fleet
    want = {sql: _canon(_post(solo.query_port,
                              {"sql": sql, "db": "flow_log"})["result"])
            for sql in STORM}
    for sql in STORM:  # the first replica warms the storm
        assert _canon(_post(qs[0].query_port, {"sql": sql, "db": "flow_log"})
                      ["result"]) == want[sql]
    warm = qs[0].api.query_cache.counters["bucket_misses"]
    assert warm > 0 and qs[0].partial_cache.advertised_digests()
    qs[0].membership._join_once()  # push the adverts to the seed
    for q in qs[1:]:
        q.membership._join_once()  # pull the merged map
    for q in qs[1:]:
        for sql in STORM:
            got = _post(q.query_port, {"sql": sql, "db": "flow_log"})
            assert got["federation"]["missing_shards"] == []
            assert _canon(got["result"]) == want[sql]
        # not one bucket scanned here: every slice came from a peer
        assert q.api.query_cache.counters["bucket_misses"] == 0
        assert q.api.query_cache.counters["dist_hits"] == warm
    served = sum(q.partial_cache.snapshot()["served_buckets"] for q in qs)
    fetched = sum(q.partial_cache.snapshot()["fetched_buckets"]
                  for q in qs)
    assert served == fetched == 2 * warm
    for q in qs:
        snap = q.partial_cache.snapshot()
        assert snap["remap_failures"] == snap["fetch_errors"] == 0
        assert snap["serve_rejects"] == 0
        # the fetch hop's ledger conserves on every replica
        for h in q.telemetry.snapshot()["pipeline"]:
            assert h["emitted"] == h["delivered"] + h["dropped_total"] \
                + h["in_flight"], h


def test_serve_refuses_another_publish_state(fleet):
    _ingest, qs, _solo = fleet
    p = qs[0].partial_cache
    before = p.snapshot()["serve_rejects"]
    body = {"table": TBL, "sql": STORM[0], "org": None,
            "pub_token": "0" * 16, "buckets": [29233333]}
    assert p.serve(body) == {"buckets": {}}
    assert p.snapshot()["serve_rejects"] == before + 1
    # no buckets asked, no token: answered empty, not counted
    assert p.serve({"table": TBL, "buckets": []}) == {"buckets": {}}
    assert p.snapshot()["serve_rejects"] == before + 1


def test_cache_partial_route_is_gated_by_the_token(fleet):
    _ingest, qs, _solo = fleet
    q = qs[0]
    body = json.dumps({"table": TBL, "sql": STORM[0], "buckets": [],
                       "pub_token": q.readtier.pub_token(TBL)}).encode()
    url = f"http://127.0.0.1:{q.query_port}/v1/cache/partial"
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(url, data=body),
                               timeout=10)
    assert ei.value.code == 403
    req = urllib.request.Request(url, data=body,
                                 headers={"X-DF-Token": "s3cret"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        got, sid = wire.decode_cache_partial(resp.read())
    assert got == {"buckets": {}} and sid == q.shard_id
