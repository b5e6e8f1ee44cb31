"""The port's cluster federation held against the JAX package's on the CPU.

Wire frames byte for byte against the reference's (``cluster/wire.py``),
the peer directory's versions, join / TTL / seed readback, the fan-out's
hedge and timeout (a shard that does not answer lands in
``missing_shards``), the dictionary sync's remap and its decoded
fallback, a shard's ``shard.exec`` span adopted into the coordinator's
query trace, and ``dfctl cluster``. Then the corpus end to end, after
``tests/test_cluster.py``: seeded rows round-robin over three port
shards, all of them on one port solo server, and the same split over the
reference's own three-shard cluster; every federated surface (DF-SQL
with aggregates, rows, HAVING, ORDER and LIMIT, EXPLAIN, ``tpu_flame``,
``profile_tracing``, ``tpu_steps`` and the critical path, PromQL, Tempo
search and trace assembly) through each port shard must equal the port
solo server's answer and the reference cluster's, exactly, except
``Percentile``: within 1e-9 relative of the reference's federated value
and 2 % of the solo exact one. Servers run in this process on port 0.
"""

import contextlib
import http.server
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepflow_tpu.cluster import dictsync as ref_dictsync
from deepflow_tpu.cluster import wire as ref_wire
from deepflow_tpu.cluster.membership import PeerDirectory as RefDirectory
from deepflow_tpu.store.schema import (L7_PROTOS, PROFILE_EVENT_TYPES,
                                       RESPONSE_STATUS, TPU_SPAN_KINDS)
from deepflow_tpu_torch.cluster import dictsync, wire
from deepflow_tpu_torch.cluster.membership import (ClusterMembership, Peer,
                                                   PeerDirectory)
from deepflow_tpu_torch.cluster.remote import (FanOut, ShardCallError,
                                               ShardClient)
from test_torch_promql import _close
from test_torch_promql import _rows as _prom_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- wire format -------------------------------------------------------------

WIRE_OBJECTS = {
    "table": {"columns": ["n", "name", "ratio"],
              "values": [[1, "alpha", 2.5], [2, "beta", -0.25],
                         [3, "", 1e12]],
              "extra": {"groups": 3}},
    "rows_partial": {"kind": "rows", "columns": ["t", "svc"],
                     "values": [[10, "a"], [11, "b"]]},
    "empty": {"columns": ["a"], "values": []},
    "big": {"columns": ["s", "v"],
            "values": [[f"stack;frame_{i};leaf", i] for i in range(200)]},
    "mixed": {"columns": ["x", "b"], "values": [[1, True], [2.5, False],
                                                [1 << 63, None]]},
    "json": {"spans": [{"span_id": "s1", "start_ns": 5}], "unknown": True},
    "jsonb": {"kind": "agg", "n_groups": 3,
              "keys": [{"e": "app_service",
                        "ids": np.array([4, 0, 9], dtype=np.uint32)}],
              "items": {}, "sites": {"Sum(x)": np.array([1.5, 2.0, -3.0])},
              "dicts": {"app_service": [0, 10]}},
    "scalar": [1, 2, {"a": None}],
}


def _jsonable(o):
    if isinstance(o, np.ndarray):
        return {"dtype": o.dtype.str, "v": o.tolist()}
    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    return o


@pytest.mark.parametrize("name", sorted(WIRE_OBJECTS))
def test_wire_frames_byte_equal_and_decode_across(name):
    obj = WIRE_OBJECTS[name]
    frame = wire.encode_result(obj, shard_id=7)
    assert frame == ref_wire.encode_result(obj, shard_id=7)
    got, sid = ref_wire.decode_result(frame)
    back, sid2 = wire.decode_result(frame)
    assert sid == sid2 == 7
    assert _jsonable(got) == _jsonable(back)
    if "values" in obj:
        assert back["values"] == [list(r) for r in obj["values"]]
    elif name != "jsonb":
        assert back == obj
    if name == "big":  # the frame layer's zlib above 512 B
        from deepflow_tpu_torch.codec import COMPRESS_FLAG, HEADER_FMT
        import struct
        ver = struct.unpack_from(HEADER_FMT, frame)[2]
        assert ver & COMPRESS_FLAG


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(-(1 << 62) + 1, (1 << 62) - 1),
                          st.floats(allow_nan=False, width=64),
                          st.text(max_size=8)), max_size=30),
       st.integers(0, 0xFFFF))
def test_wire_tables_byte_equal_hypothesis(rows, shard):
    obj = {"columns": ["i", "f", "s"], "values": [list(r) for r in rows]}
    frame = wire.encode_result(obj, shard_id=shard)
    assert frame == ref_wire.encode_result(obj, shard_id=shard)
    assert wire.decode_result(frame) == ref_wire.decode_result(frame)


def test_wire_rejects_foreign_and_short_frames():
    from deepflow_tpu_torch.codec import FrameHeader, MessageType, \
        encode_frame
    with pytest.raises(wire.WireError):
        wire.decode_result(b"\x00\x01")
    with pytest.raises(wire.WireError):
        wire.decode_result(encode_frame(
            FrameHeader(MessageType.TPU_SPAN, agent_id=1), b"x" * 8))


def test_inject_and_extract_ctx():
    from deepflow_tpu_torch.query import qtrace
    body = {"op": "sql_partial"}
    assert wire.inject_ctx(body) is body  # no trace open
    tracer = qtrace.QueryTracer(None, service="t")
    with tracer.start_trace("query", capture=True) as root:
        with qtrace.span("scatter"):
            out = wire.inject_ctx(body)
    assert out is not body and "qtrace" not in body
    ctx = wire.extract_ctx(out)
    assert ctx["tid"] == root.trace_id and ctx["sid"]
    assert ref_wire.extract_ctx(out) == ctx
    assert wire.extract_ctx({"qtrace": "x"}) is None


# -- membership --------------------------------------------------------------

def _dir_ops(d, P):
    out = [d.upsert(P(shard_id=1, addr="a:1", epoch=10)), d.version]
    # a heartbeat (same address and epoch) bumps nothing
    out += [d.upsert(P(shard_id=1, addr="a:1", epoch=10)), d.version]
    # a restart (epoch) and an address move are membership changes
    out += [d.upsert(P(shard_id=1, addr="a:1", epoch=11)),
            d.upsert(P(shard_id=1, addr="b:2", epoch=11)), d.version]
    out += [d.upsert(P(shard_id=2, addr="c:3", epoch=5,
                       ingest_addr="c:4")), d.version,
            d.upsert(P(shard_id=2, addr="c:3", epoch=5,
                       ingest_addr="c:5")), d.version]
    return out


def test_peer_directory_version_semantics_equal_reference():
    from deepflow_tpu.cluster.membership import Peer as RefPeer
    d, r = PeerDirectory(), RefDirectory()
    assert _dir_ops(d, Peer) == _dir_ops(r, RefPeer) == \
        [True, 1, False, 1, True, True, 3, True, 4, True, 5]
    strip = [{k: v for k, v in p.items() if k != "last_seen_ns"}
             for p in d.snapshot()["peers"]]
    assert strip == [{k: v for k, v in p.items() if k != "last_seen_ns"}
                     for p in r.snapshot()["peers"]]
    # adoption is forward-only, across packages too
    j = PeerDirectory()
    j.adopt(r.snapshot())
    assert j.version == 5 and [p.shard_id for p in j.alive()] == [1, 2]
    j.upsert(Peer(shard_id=3, addr="d:4", epoch=1))
    v = j.version
    j.adopt({"version": 1, "peers": []})
    assert j.version == v and len(j.snapshot()["peers"]) == 3


def test_ttl_and_handle_join():
    m = ClusterMembership(1, "127.0.0.1:1")
    m.start()
    body = Peer(shard_id=2, addr="127.0.0.1:2", epoch=7,
                ingest_addr="127.0.0.1:3").to_dict()
    snap = m.handle_join(body)
    assert [p["shard_id"] for p in snap["peers"]] == [1, 2]
    assert snap["peers"][1]["ingest_addr"] == "127.0.0.1:3"
    assert [p.shard_id for p in m.peers(include_self=False)] == [2]
    # 15 s of silence: dead
    with m.directory._lock:
        m.directory._peers[2].last_seen_ns -= 16 * 10**9
    assert m.peers(include_self=False) == []
    assert [p.shard_id for p in m.peers(include_self=False, ttl_s=20)] \
        == [2]
    # a rejoin brings it back without a version bump
    v = m.directory.version
    m.handle_join(body)
    assert m.directory.version == v
    assert [p.shard_id for p in m.peers(include_self=False)] == [2]
    assert m.is_seed and not ClusterMembership(
        2, "127.0.0.1:2", seed="127.0.0.1:1").is_seed


# -- fan-out: hedge, timeout, missing_shards ---------------------------------

class _SlowShard:
    """A /v1/shard/exec stub: answers ``{"n": k}`` (k counts the
    requests) after ``delays[k]`` seconds (the last delay repeats)."""

    def __init__(self, delays: list[float]) -> None:
        self.delays = delays
        self.calls = 0
        lock = threading.Lock()
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with lock:
                    k = outer.calls
                    outer.calls += 1
                time.sleep(outer.delays[min(k, len(outer.delays) - 1)])
                data = wire.encode_result({"n": k}, shard_id=9)
                try:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_hedge_answers_once_from_the_faster_attempt():
    slow = _SlowShard([1.5, 0.0])
    fan = FanOut(timeout_s=5.0, hedge_delay_s=0.1)
    try:
        t0 = time.monotonic()
        res, missing = fan.scatter(
            [Peer(shard_id=9, addr=slow.addr, epoch=1)], {"op": "x"},
            "cluster.sql")
        took = time.monotonic() - t0
        # one partial for the shard, the hedged second request's
        assert res == {9: {"n": 1}} and missing == []
        assert took < 1.2
        st_ = fan.stats()[slow.addr]
        assert st_["hedges"] == 1 and st_["attempts"] == 2
        assert st_["errors"] == 0
    finally:
        fan.close()
        slow.close()


def test_timeout_lands_in_missing_shards_and_the_ledger():
    from deepflow_tpu_torch.telemetry import Telemetry
    slow = _SlowShard([3.0])
    tel = Telemetry("server")
    fan = FanOut(telemetry=tel, timeout_s=0.5, retries=1, hedge_delay_s=0)
    try:
        res, missing = fan.scatter(
            [Peer(shard_id=4, addr=slow.addr, epoch=1)], {"op": "x"},
            "cluster.flame")
        assert res == {} and missing == [4]
        with pytest.raises(ShardCallError) as e:
            ShardClient(slow.addr, timeout_s=0.3, retries=0).call({})
        assert e.value.reason == "timeout"
        hop = [h for h in tel.snapshot()["pipeline"]
               if h["hop"] == "cluster.flame"][0]
        assert hop["emitted"] == 1 and hop["delivered"] == 0
        assert hop["dropped"] == {"timeout": 1}
    finally:
        fan.close()
        slow.close()


# -- dictionary sync ---------------------------------------------------------

def _syncs(rng, n):
    """A seeded run of dict_sync deltas for one column: appends, a
    resync after a gen flip, and a delta past a prefix never seen."""
    out, strings, gen = [], [], 0
    for i in range(n):
        if rng.random() < 0.15:
            gen, strings = gen + 1, []
        add = [f"s{gen}-{len(strings) + k}" for k in
               range(int(rng.integers(0, 5)))]
        base = len(strings) if rng.random() > 0.1 else len(strings) + 3
        strings = strings + add
        out.append({"gen": gen, "len": len(strings), "base": base,
                    "delta": add})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_dictsync_remap_equals_reference(seed):
    from deepflow_tpu.store.dictionary import Dictionary as RefDict
    from deepflow_tpu_torch.store.dictionary import Dictionary
    rng = np.random.default_rng(seed)
    port, ref = dictsync.DictSync(), ref_dictsync.DictSync()
    ld, rd = Dictionary("svc"), RefDict("svc")
    for s in ["pre-a", "pre-b"]:
        ld.encode(s)
        rd.encode(s)
    for sync in _syncs(rng, 30):
        assert port.apply_sync(2, "t", "svc", dict(sync)) == \
            ref.apply_sync(2, "t", "svc", dict(sync))
        assert port.known_state(2, "t") == ref.known_state(2, "t")
        known = port.known_state(2, "t").get("svc")
        if not known or not known[1]:
            continue
        gen, ln = known
        ids = rng.integers(0, ln, 12).astype(np.uint32)
        part = {"kind": "agg", "n_groups": 12, "dicts": {"svc": [gen, ln]},
                "keys": [{"e": "svc", "ids": ids}], "items": {},
                "sites": {"Count(DISTINCT svc)": {
                    "ed": "svc", "sets": [[int(i)] for i in ids]}}}
        got = port.remap_partial(2, "t", dict(part), {"svc": ld})
        want = ref.remap_partial(2, "t", dict(part), {"svc": rd})
        assert got["keys"][0]["ids"].tolist() == \
            want["keys"][0]["ids"].tolist()
        assert got["sites"] == want["sites"]
        assert ld.snapshot() == rd.snapshot()
    # ids past the mirror: the remap refuses, in both packages
    bad = {"kind": "agg", "dicts": {"svc": [99, 5]},
           "keys": [{"e": "svc", "ids": np.array([4], dtype=np.uint32)}]}
    with pytest.raises(dictsync.DictSyncError):
        port.remap_partial(2, "t", bad, {"svc": ld})
    with pytest.raises(ref_dictsync.DictSyncError):
        ref.remap_partial(2, "t", bad, {"svc": rd})
    assert port.snapshot() == ref.snapshot()


def test_build_sync_equals_reference():
    from deepflow_tpu.store.table import ColumnarTable as RefTable
    from deepflow_tpu.store import schema as ref_schema
    from deepflow_tpu_torch.store import schema
    from deepflow_tpu_torch.store.table import ColumnarTable
    name = "flow_log.l7_flow_log"
    rows = [{"app_service": f"svc-{i % 7}", "endpoint": f"/e{i % 3}"}
            for i in range(40)]
    p = ColumnarTable(name, schema.TABLES[name])
    r = RefTable(name, ref_schema.TABLES[name])
    p.append_rows(rows)
    r.append_rows(rows)
    cols = {"app_service": [0, 7], "endpoint": [0, 3]}
    for known in ({}, {"app_service": [0, 4]}, {"endpoint": [1, 2]}):
        assert dictsync.build_sync(p, cols, known) == \
            ref_dictsync.build_sync(r, cols, known)
    assert dictsync.build_sync(p, {"app_service": [5, 7]}, {}) is None


# -- the corpus --------------------------------------------------------------

BASE_S = 1_754_000_000
BASE_NS = BASE_S * 1_000_000_000
_L7 = {n: i for i, n in enumerate(L7_PROTOS)}
_RS = {n: i for i, n in enumerate(RESPONSE_STATUS)}
_EV = {n: i for i, n in enumerate(PROFILE_EVENT_TYPES)}
_KIND = {n: i for i, n in enumerate(TPU_SPAN_KINDS)}
PROM_T0 = 1_760_000_000  # test_torch_promql's rows
N_L7 = 600


def _corpus(seed: int = 0) -> dict:
    """Rows per table, from a numpy seed. Every start_ns is unique (the
    trace trees are deterministic) and every flame stack's total is
    distinct (so is the children's order)."""
    rng = np.random.default_rng(seed)
    svcs = ("svc-a", "svc-b", "svc-c")
    protos = (_L7["http1"], _L7["dns"], _L7["http1"], _L7["mysql"])
    span_plan = {0: ("trace-1", "s1", ""), 1: ("trace-1", "s2", "s1"),
                 2: ("trace-1", "s3", "s1"), 3: ("trace-1", "s4", "s2"),
                 4: ("trace-1", "s5", "s2"),
                 5: ("trace-2", "r1", ""), 6: ("trace-2", "r2", "r1"),
                 7: ("trace-2", "r3", "r2")}
    l7 = []
    # dense enough that a percentile's sketch bin (~2 %), not the exact
    # percentile's interpolation between neighbouring rows, bounds it
    durs = rng.lognormal(11.0, 0.6, N_L7).astype(np.int64)
    for i in range(N_L7):
        tid, sid, parent = span_plan.get(i, (f"solo-{i}", f"sp-{i}", ""))
        l7.append({
            "time": BASE_NS + i * 1_000_000,
            "flow_id": 100 + i, "app_service": svcs[i % 3],
            "ip_src": f"10.0.0.{i % 4}", "ip_dst": "10.0.1.1",
            "port_src": 40000 + i, "port_dst": 8080,
            "l7_protocol": protos[i % 4],
            "request_type": "GET" if i % 2 == 0 else "POST",
            "endpoint": f"/api/{'abcd'[int(rng.integers(0, 4))]}",
            "request_id": i,
            "response_status": _RS["ok"] if i % 5 else _RS["server_error"],
            "response_code": (200, 404, 500)[i % 3],
            "response_duration": int(durs[i]),
            "trace_id": tid, "span_id": sid, "parent_span_id": parent})
    profile = []
    for stack, per, n in (("main;ingest;decode", 10, 4),
                          ("main;ingest;write", 5, 5),
                          ("main;query;merge", 6, 2)):
        for _ in range(n):
            profile.append({"time": BASE_NS + len(profile) * 1000,
                            "app_service": "svc-prof",
                            "process_name": "df",
                            "event_type": _EV["on-cpu"],
                            "profiler": "py-spy", "stack": stack,
                            "value": per, "count": 1})
    tpu = []
    plan = (("mod_a", "convolution", "conv.1", 900),
            ("mod_a", "all-reduce", "ar.1", 410),
            ("mod_b", "convolution", "conv.2", 170),
            ("mod_b", "other", "copy.3", 65))
    for j, (mod, cat, op, dur) in enumerate(plan):
        for k in range(3):
            tpu.append({"time": BASE_NS + (j * 3 + k) * 500,
                        "duration_ns": dur + k, "device_id": k,
                        "kind": _KIND["device-compute"],
                        "hlo_module": mod, "hlo_category": cat,
                        "hlo_op": op, "flops": 1000})
    tpu.append({"time": BASE_NS, "duration_ns": 9999, "device_id": 0,
                "kind": _KIND["host-compile"], "hlo_module": "mod_h",
                "hlo_category": "compile", "hlo_op": "jit", "flops": 0})
    steps = []
    lat = rng.integers(80_000_000, 95_000_000, 40)
    for i in range(40):
        for h, host in enumerate(("host-0", "host-1")):
            t = BASE_NS + i * 100_000_000
            # step 31 is a regression, for the critical path
            ln = int(lat[i]) * (3 if i == 31 else 1) + h * 1_000_000
            steps.append({
                "time": t, "end_ns": t + ln, "latency_ns": ln,
                "run_id": 7, "step": i, "job": "train", "device_count": 2,
                "device_skew_ns": h * 500, "compute_ns": ln // 2,
                "collective_ns": ln // 4, "straggler_device": h,
                "straggler_lag_ns": h * 100, "top_hlos": "[]",
                "host": host})
    net, app, sysrows = _prom_rows(seed)
    return {"flow_log.l7_flow_log": l7,
            "profile.in_process_profile": profile,
            "profile.tpu_hlo_span": tpu,
            "profile.tpu_step_metrics": steps,
            "flow_metrics.network.1s": net[:300],
            "flow_metrics.application.1s": app[:300],
            "deepflow_system.deepflow_system": sysrows}


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


def _get(port: int, path: str, params: dict | None = None) -> dict:
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _wait_converged(servers, n: int, what: str) -> None:
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if all(len(s.api.federation.remote_peers()) == n - 1
               for s in servers):
            return
        time.sleep(0.05)
    pytest.fail(f"{what}: the directory never converged")


@pytest.fixture(scope="module")
def clusters():
    """(port solo, [port shards 1..3], [reference shards 1..3])."""
    from deepflow_tpu.server import Server as RefServer
    from deepflow_tpu_torch.server.server import Server
    corpus = _corpus()
    started = []

    def start(cls, **kw):
        s = cls(host="127.0.0.1", ingest_port=0, query_port=0,
                sync_port=0, selfstats_interval_s=3600, **kw).start()
        started.append(s)
        return s

    try:
        solo = start(Server)
        fams = []
        for cls in (Server, RefServer):
            seed = start(cls, shard_id=1, cluster_advertise="")
            addr = f"127.0.0.1:{seed.query_port}"
            fams.append([seed] + [start(cls, shard_id=sid,
                                        cluster_seed=addr)
                                  for sid in (2, 3)])
        for name, rows in corpus.items():
            solo.db.table(name).append_rows(rows)
            for shards in fams:
                for i, row in enumerate(rows):
                    shards[i % 3].db.table(name).append_rows([row])
        for shards, what in zip(fams, ("port", "reference")):
            _wait_converged(shards, 3, what)
        yield solo, fams[0], fams[1]
    finally:
        for s in started:
            with contextlib.suppress(Exception):
                s.stop()


EXACT_SQL = {
    "aggs": ("SELECT app_service, Sum(response_duration) AS s, "
             "Count(*) AS n, Avg(response_duration) AS a, "
             "Min(response_code) AS mn, Max(response_code) AS mx "
             "FROM l7_flow_log GROUP BY app_service ORDER BY app_service"),
    "distinct": ("SELECT Count(DISTINCT endpoint) AS d, Count(*) AS n "
                 "FROM l7_flow_log"),
    "distinct_by": ("SELECT app_service, Count(DISTINCT endpoint) AS d "
                    "FROM l7_flow_log GROUP BY app_service "
                    "ORDER BY app_service"),
    "having": ("SELECT app_service, Count(*) AS n FROM l7_flow_log "
               "GROUP BY app_service HAVING Count(*) > 199 "
               "ORDER BY app_service"),
    "rows_limit": ("SELECT time, app_service, endpoint FROM l7_flow_log "
                   "WHERE response_code = 200 ORDER BY time DESC LIMIT 7"),
    "last": ("SELECT app_service, Last(response_code) AS lc "
             "FROM l7_flow_log GROUP BY app_service ORDER BY app_service"),
    "enum_keys": ("SELECT l7_protocol, response_status, Count(*) AS n "
                  "FROM l7_flow_log GROUP BY l7_protocol, response_status "
                  "ORDER BY l7_protocol, response_status"),
    "order_agg_limit": ("SELECT endpoint, Avg(response_duration) AS a "
                        "FROM l7_flow_log GROUP BY endpoint "
                        "ORDER BY a DESC LIMIT 2"),
    "spans": ("SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n "
              "FROM profile.tpu_hlo_span WHERE kind = 'device-compute' "
              "GROUP BY hlo_op ORDER BY d DESC LIMIT 3"),
    "steps": ("SELECT host, Avg(latency_ns) AS a, Max(step) AS s "
              "FROM profile.tpu_step_metrics GROUP BY host ORDER BY host"),
}


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("name", sorted(EXACT_SQL))
def test_sql_through_each_shard_equals_solo_and_reference(clusters, name, k):
    solo, port, ref = clusters
    body = {"sql": EXACT_SQL[name], "db": "flow_log"}
    want = _post(solo.query_port, "/v1/query", body)["result"]
    got = _post(port[k].query_port, "/v1/query", body)
    theirs = _post(ref[k].query_port, "/v1/query", body)
    assert got["federation"]["missing_shards"] == []
    assert got["federation"]["shards"] == 3
    assert want["values"], name
    assert _canon(got["result"]) == _canon(want)
    assert _canon(got["result"]) == _canon(theirs["result"])
    assert {k_: got["federation"][k_] for k_ in ("shards",
                                                  "missing_shards")} == \
        {k_: theirs["federation"][k_] for k_ in ("shards",
                                                  "missing_shards")}


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("p", (50, 90, 99))
def test_percentile_within_tolerance(clusters, p, k):
    solo, port, ref = clusters
    sql = (f"SELECT app_service, Percentile(response_duration, {p}) AS q "
           "FROM l7_flow_log GROUP BY app_service ORDER BY app_service")
    body = {"sql": sql, "db": "flow_log"}
    want = _post(solo.query_port, "/v1/query", body)["result"]["values"]
    got = _post(port[k].query_port, "/v1/query", body)["result"]["values"]
    theirs = _post(ref[(k + 1) % 3].query_port, "/v1/query",
                   body)["result"]["values"]
    assert [r[0] for r in got] == [r[0] for r in want] == \
        [r[0] for r in theirs]
    for g, w, t in zip(got, want, theirs):
        # merge-order independent: the reference through another shard
        assert g[1] == pytest.approx(t[1], rel=1e-9)
        assert g[1] == pytest.approx(w[1], rel=0.02)


def test_remap_failure_falls_back_to_a_decoded_partial(clusters,
                                                      monkeypatch):
    """A shard partial the mirror cannot cover is asked for again in the
    decoded form: its rows stay in the answer, no shard goes missing."""
    solo, port, _ref = clusters
    fed = port[1].api.federation
    monkeypatch.setenv("DF_QUERY_CACHE", "0")

    def refuse(*a, **k):
        raise dictsync.DictSyncError("mirror gap")
    monkeypatch.setattr(fed.dict_sync, "remap_partial", refuse)
    before = fed.sql_cache_counters["remap_failures"]
    body = {"sql": EXACT_SQL["distinct_by"], "db": "flow_log"}
    got = _post(port[1].query_port, "/v1/query", body)
    assert got["federation"]["missing_shards"] == []
    assert fed.sql_cache_counters["remap_failures"] == before + 2
    assert _canon(got["result"]) == _canon(
        _post(solo.query_port, "/v1/query", body)["result"])


def test_federated_count_is_the_union_and_shard_ids_audit(clusters):
    _solo, port, _ref = clusters
    n_union = sum(len(s.db.table("flow_log.l7_flow_log")) for s in port)
    body = {"sql": "SELECT Count(*) AS n FROM l7_flow_log",
            "db": "flow_log"}
    assert _post(port[1].query_port, "/v1/query",
                 body)["result"]["values"][0][0] == n_union == N_L7
    body = {"sql": "SELECT shard_id, Count(*) AS n FROM l7_flow_log "
                   "GROUP BY shard_id ORDER BY shard_id", "db": "flow_log"}
    audit = _post(port[0].query_port, "/v1/query", body)["result"]["values"]
    assert [r[0] for r in audit] == [1, 2, 3]
    assert sum(r[1] for r in audit) == n_union


@pytest.mark.parametrize("analyze", (False, True))
def test_explain_names_the_federation_route(clusters, analyze):
    _solo, port, ref = clusters
    sql = ("EXPLAIN " + ("ANALYZE " if analyze else "")
           + EXACT_SQL["aggs"])
    got = _post(port[2].query_port, "/v1/query",
                {"sql": sql, "db": "flow_log"})["explain"]
    theirs = _post(ref[2].query_port, "/v1/query",
                   {"sql": sql, "db": "flow_log"})["explain"]
    keys = ("analyze", "table", "federated", "path", "shards")
    assert {k: got["plan"].get(k) for k in keys} == \
        {k: theirs["plan"].get(k) for k in keys}
    assert got["plan"]["federated"] is True
    if analyze:
        assert got["plan"]["path"] == "federation"
        assert got["plan"]["shards"] == 3
        assert got["federation"]["missing_shards"] == []
        stages = {s["stage"] for s in got["stages"]}
        assert {"plan", "execute"} <= stages


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("route,body", [
    ("/v1/profile/TpuFlame", {}),
    ("/v1/profile/TpuFlame", {"include_host": True}),
    ("/v1/profile/ProfileTracing", {"app_service": "svc-prof"}),
    ("/v1/profile/ProfileTracing", {}),
    ("/v1/tpu/steps", {"job": "train"}),
    ("/v1/tpu/steps/critical_path", {"job": "train"}),
    ("/v1/tpu/steps/critical_path", {"run_id": 7, "step": 31}),
])
def test_profile_surfaces_equal_solo_and_reference(clusters, route, body, k):
    solo, port, ref = clusters
    want = _post(solo.query_port, route, body)
    got = _post(port[k].query_port, route, body)
    theirs = _post(ref[k].query_port, route, body)
    assert got.pop("federation")["missing_shards"] == []
    theirs.pop("federation")
    assert _canon(got) == _canon(want)
    assert _canon(got) == _canon(theirs)
    if route == "/v1/profile/TpuFlame" and not body:
        assert "mod_h" not in json.dumps(got["result"])


def _sorted_prom(data: dict) -> dict:
    data = dict(data)
    data["result"] = sorted(
        data.get("result", []),
        key=lambda s: json.dumps(s.get("metric", {}), sort_keys=True))
    return data


PROM = ("sum by (server_port) (rate(flow_metrics_application_request[1m]))",
        "flow_metrics_network_byte_tx",
        "max(flow_metrics_application_rrt_max)",
        "rate(deepflow_system_agent_sender_sent_frames[1m])",
        "histogram_quantile(0.9, sum by (le) "
        "(rate(deepflow_system_req_latency_bucket[1m])))")


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("q", PROM)
def test_promql_equals_solo_and_reference(clusters, q, k):
    solo, port, ref = clusters
    rng = {"start": PROM_T0 + 120, "end": PROM_T0 + 280, "step": 30}
    want = _get(solo.query_port, "/prom/api/v1/query_range",
                {"query": q, **rng})
    got = _get(port[k].query_port, "/prom/api/v1/query_range",
               {"query": q, **rng})
    theirs = _get(ref[k].query_port, "/prom/api/v1/query_range",
                  {"query": q, **rng})
    assert want["status"] == got["status"] == theirs["status"] == "success"
    assert want["data"]["result"]
    assert "federation" not in got and "warnings" not in got
    # series by series; values within 1e-9 (the summation order differs)
    _close(_sorted_prom(got["data"]), _sorted_prom(want["data"]))
    _close(_sorted_prom(got["data"]), _sorted_prom(theirs["data"]))
    inst = {"query": q, "time": PROM_T0 + 250}
    got = _get(port[k].query_port, "/prom/api/v1/query", inst)
    _close(_sorted_prom(got["data"]), _sorted_prom(
        _get(solo.query_port, "/prom/api/v1/query", inst)["data"]))


def test_promql_series_federates(clusters):
    solo, port, _ref = clusters
    params = {"match[]": "flow_metrics_network_byte_tx",
              "start": PROM_T0, "end": PROM_T0 + 600}
    want = _get(solo.query_port, "/prom/api/v1/series", params)
    got = _get(port[1].query_port, "/prom/api/v1/series", params)
    key = lambda s: json.dumps(s, sort_keys=True)  # noqa: E731
    assert sorted(got["data"], key=key) == sorted(want["data"], key=key)
    assert len(want["data"]) > 1


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("extra", [{}, {"tags": 'service.name="svc-a"'},
                                   {"minDuration": "100us"},
                                   {"tags": "http.status_code=404",
                                    "limit": 5}])
def test_tempo_search_equals_solo_and_reference(clusters, extra, k):
    solo, port, ref = clusters
    window = {"start": BASE_S - 10, "end": BASE_S + 3600, "limit": 50,
              **extra}
    want = _get(solo.query_port, "/api/search", window)
    got = _get(port[k].query_port, "/api/search", window)
    theirs = _get(ref[k].query_port, "/api/search", window)
    assert got.pop("federation")["missing_shards"] == []
    theirs.pop("federation")
    assert want["traces"]
    assert _canon(got) == _canon(want) == _canon(theirs)


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("tid", ("trace-1", "trace-2", "solo-9"))
def test_trace_assembly_equals_solo_and_reference(clusters, tid, k):
    solo, port, ref = clusters
    want = _get(solo.query_port, f"/api/traces/{tid}")
    got = _get(port[k].query_port, f"/api/traces/{tid}")
    assert _canon(got) == _canon(want)
    assert _canon(got) == _canon(_get(ref[k].query_port,
                                      f"/api/traces/{tid}"))
    want = _post(solo.query_port, "/v1/trace/Tracing", {"trace_id": tid})
    got = _post(port[k].query_port, "/v1/trace/Tracing", {"trace_id": tid})
    theirs = _post(ref[k].query_port, "/v1/trace/Tracing",
                   {"trace_id": tid})
    assert got["result"].pop("federation")["missing_shards"] == []
    theirs["result"].pop("federation")
    assert _canon(got) == _canon(want) == _canon(theirs)


def test_trace_spans_really_split(clusters):
    _solo, port, _ref = clusters
    per_shard = [len(s.api.collect_trace_spans("trace-1")) for s in port]
    assert sorted(per_shard) == [1, 2, 2] and sum(per_shard) == 5


def test_shard_exec_span_joins_the_coordinators_trace(clusters,
                                                      monkeypatch):
    """EXPLAIN ANALYZE on shard 1: shards 2 and 3 adopt its context, so
    their shard.exec spans carry its trace id, each under the
    coordinator's shard.call span for it, and the federated trace
    assembly shows them."""
    _solo, port, _ref = clusters
    monkeypatch.setenv("DF_QUERY_TRACE_SAMPLE", "1")
    ex = _post(port[0].query_port, "/v1/query",
               {"sql": "EXPLAIN ANALYZE " + EXACT_SQL["distinct"],
                "db": "flow_log"})["explain"]
    tid = ex["trace_id"]
    calls = {}
    for s in port[0].api._query_trace_spans(tid):
        if s["name"] == "shard.call":
            calls[s["span_id"]] = s
    assert len(calls) == 2
    for shard in port[1:]:
        shard.api.qtracer.flush()
        spans = shard.api._query_trace_spans(tid)
        execs = [s for s in spans if s["name"] == "shard.exec"]
        assert len(execs) == 1, spans
        assert execs[0]["parent_span_id"] in calls
    tree = _post(port[0].query_port, "/v1/trace/Tracing",
                 {"trace_id": tid})["result"]
    names = json.dumps(tree)
    assert names.count("shard.exec") == 2


def test_membership_surfaces(clusters):
    _solo, port, _ref = clusters
    fp = port[0].query_port
    peers = _get(fp, "/v1/cluster/peers")
    assert [p["shard_id"] for p in peers["peers"]] == [1, 2, 3]
    assert peers["version"] >= 3
    j2 = _get(port[1].query_port, "/v1/cluster/peers")
    assert [p["shard_id"] for p in j2["peers"]] == [1, 2, 3]
    ingest = {p["shard_id"]: p["ingest_addr"] for p in peers["peers"]}
    assert ingest == {s.shard_id: f"127.0.0.1:{s.ingest_port}"
                      for s in port}
    status = _get(fp, "/v1/cluster/status")
    by_id = {p["shard_id"]: p for p in status["peers"]}
    assert status["shard_id"] == 1 and all(by_id[s]["alive"]
                                           for s in (1, 2, 3))
    assert by_id[2]["raw_rows"] == sum(
        len(port[1].db.table(n)) for n in port[1].db.tables())
    health = _get(fp, "/v1/health")
    assert health["cluster"]["peers_alive"] == 3
    assert "dict_sync" in health and "federation_cache" in health
    # ingested rows carry the receiving shard's id
    assert port[2].db.shard_id == 3


def _dfctl_out(mod, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def test_dfctl_cluster_equals_reference(clusters, monkeypatch):
    from deepflow_tpu.cli import dfctl as ref_dfctl
    from deepflow_tpu_torch.cli import dfctl
    _solo, port, _ref = clusters
    addr = f"127.0.0.1:{port[0].query_port}"
    status = _get(port[0].query_port, "/v1/cluster/status")
    # one answer for both (latency and last-seen move between calls)
    monkeypatch.setattr(dfctl, "_api", lambda *a, **k: status)
    monkeypatch.setattr(ref_dfctl, "_api", lambda *a, **k: status)
    for extra in ([], ["--json"]):
        got = _dfctl_out(dfctl, ["--server", addr, "cluster"] + extra)
        assert got == _dfctl_out(ref_dfctl, ["--server", addr, "cluster"]
                                 + extra)
    assert "alive" in got and "SHARD" in _dfctl_out(
        dfctl, ["--server", addr, "cluster"])
    monkeypatch.undo()
    live = _dfctl_out(dfctl, ["--server", addr, "cluster", "--json"])
    assert [p["shard_id"] for p in json.loads(live)["peers"]] == [1, 2, 3]


def test_degraded_shard_is_annotated_never_a_500(clusters):
    """Without a ring a killed shard's rows are gone from the answer,
    which says so; every fan-out hop's ledger balances."""
    _solo, port, _ref = clusters
    fp = port[0].query_port
    port[2].stop()
    body = {"sql": "SELECT app_service, Count(*) AS n FROM l7_flow_log "
                   "GROUP BY app_service ORDER BY app_service",
            "db": "flow_log"}
    got = _post(fp, "/v1/query", body)
    assert got["federation"]["missing_shards"] == [3]
    assert sum(r[1] for r in got["result"]["values"]) == N_L7 * 2 // 3
    rng = {"start": PROM_T0 + 120, "end": PROM_T0 + 280, "step": 30}
    got = _get(fp, "/prom/api/v1/query_range",
               {"query": "sum(flow_metrics_network_byte_tx)", **rng})
    assert got["status"] == "success" and got["data"]["result"]
    assert got["federation"]["missing_shards"] == [3]
    assert any("shards [3]" in w for w in got["warnings"])
    got = _get(fp, "/api/search", {"start": BASE_S - 10,
                                   "end": BASE_S + 3600})
    assert got["federation"]["missing_shards"] == [3]
    assert _get(fp, "/api/traces/trace-1")["batches"][0]["spans"]
    got = _post(fp, "/v1/profile/TpuFlame", {})
    assert got["federation"]["missing_shards"] == [3]
    by_id = {p["shard_id"]: p
             for p in _get(fp, "/v1/cluster/status")["peers"]}
    assert by_id[3]["alive"] is False and by_id[2]["alive"] is True
    hops = [h for h in port[0].telemetry.snapshot()["pipeline"]
            if h["hop"].startswith("cluster.")]
    assert {h["hop"] for h in hops} >= {
        "cluster.sql", "cluster.promql", "cluster.tempo", "cluster.trace",
        "cluster.flame"}
    for h in hops:
        assert h["emitted"] == h["delivered"] + h["dropped_total"], h
        assert h["in_flight"] == 0, h
    assert sum(h["dropped_total"] for h in hops) > 0


# -- flags and imports -------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"shard_id": -1, "cluster_advertise": ""}, "shard id"),
    ({"shard_id": 1 << 16, "cluster_advertise": ""}, "shard id"),
    ({"shard_id": 0, "cluster_advertise": ""}, "shard id >= 1"),
    ({"shard_id": 2}, "needs a cluster"),
    ({"replication": 2}, "needs a cluster"),
    ({"shard_id": 1, "cluster_advertise": "", "replication": 9},
     "replication"),
    ({"shard_id": 1, "cluster_advertise": "", "replication": -1},
     "replication"),
    ({"shard_id": 1, "cluster_seed": "nohost"}, "host:port"),
    ({"shard_id": 1, "cluster_advertise": "h:0"}, "host:port"),
    ({"shard_id": 1, "cluster_advertise": "", "fanout_timeout_s": 0},
     "timeout"),
])
def test_a_bad_cluster_flag_fails_the_start(kw, match):
    from deepflow_tpu_torch.server.server import Server
    with pytest.raises(ValueError, match=match):
        Server(host="127.0.0.1", ingest_port=0, query_port=0, **kw)


def test_cluster_server_and_dfctl_cluster_load_no_torch():
    code = (
        "import io, contextlib, json, sys\n"
        "from deepflow_tpu_torch.server.server import Server\n"
        "from deepflow_tpu_torch.server import integration, exporters\n"
        "from deepflow_tpu_torch.agent import integration_proxy\n"
        "from deepflow_tpu_torch.utils import (influxline, kafkawire,\n"
        "    msgpack, promwire, snappy)\n"
        "from deepflow_tpu_torch.cli import dfctl\n"
        "s = Server(host='127.0.0.1', ingest_port=0, query_port=0,\n"
        "           shard_id=1, cluster_advertise='', replication=2).start()\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    dfctl.main(['--server', f'127.0.0.1:{s.query_port}',\n"
        "                'cluster', '--json'])\n"
        "s.stop()\n"
        "assert json.loads(buf.getvalue())['shard_id'] == 1\n"
        "assert 'torch' not in sys.modules, 'torch loaded'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
