"""The port's integration ingest held against the JAX package's.

Both servers, started in this process on port 0, take the same seeded
bodies (``tests/integration_corpus.py``) on every route the agent's
proxy forwards, and must hold the same rows in every table those routes
fill, answer the same PromQL and Tempo queries over them, and refuse the
same garbage with 400. Remote-write's SmartEncoding ids must equal the
reference's across two ingest nodes sharing a controller and across a
``--storage`` restart; rows without an org land in the default org; the
agent's proxy forwards what it should, and the runner's config file
turns it on. Every socket and wait here is bounded (5 s or less).
"""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from deepflow_tpu.server.integration import IntegrationAPI as RefIntegration
from deepflow_tpu.server.server import Server as RefServer
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch.agent.integration_proxy import IntegrationProxy
from deepflow_tpu_torch.server.integration import IntegrationAPI
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.utils import msgpack, promwire, snappy

import integration_corpus as ic

BASE_NS = 1_700_000_000_000_000_000
TABLES = ("flow_log.l7_flow_log", "application_log.log",
          "prometheus.samples", "prometheus.label_sets",
          "ext_metrics.metrics", "profile.in_process_profile")
# columns stamped with the ingest's own clock: left out of the comparison
NOW_COLS = {"profile.in_process_profile": {"time"},
            "prometheus.label_sets": {"time"}}


def _post(port: int, path: str, body: bytes, ctype: str = "",
          method: str = "POST", query: str = "",
          headers: dict | None = None) -> tuple[int, dict]:
    url = f"http://127.0.0.1:{port}{path}" + (f"?{query}" if query else "")
    req = urllib.request.Request(url, data=body, method=method, headers={
        "Content-Type": ctype or "application/octet-stream",
        **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return json.loads(r.read())


def _rows(db, name: str) -> list:
    """A table's rows, strings decoded, sorted; the ingest-clock columns
    left out."""
    t = db.table(name)
    names = [n for n in t.columns if n not in NOW_COLS.get(name, ())]
    cols = t.column_concat(names)
    dec = [t.dicts[n].decode_many(cols[n]) if n in t.dicts
           else cols[n].tolist() for n in names]
    return sorted(zip(*dec))


@pytest.fixture(scope="module")
def pair():
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    port = Server(ingest_port=0, query_port=0, sync_port=0,
                  selfstats_interval_s=3600).start()
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def _post_both(pair, post) -> tuple:
    path, body, ctype, method, query = post
    return tuple(_post(srv.query_port, path, body, ctype, method, query)
                 for srv in pair)


def _assert_same_tables(pair) -> None:
    ref, port = pair
    for name in TABLES:
        assert _rows(port.db, name) == _rows(ref.db, name), name


@pytest.mark.parametrize("seed", [0, 1])
def test_every_route_writes_the_references_rows(pair, seed):
    c = ic.corpus(seed, BASE_NS + seed * 10**12)
    before = {t: len(pair[1].db.table(t)) for t in c["counts"]}
    for post in c["posts"]:
        want, got = _post_both(pair, post)
        assert got == want, post[0]
        assert got[0] == 200, (post[0], got)
    for name, n in c["counts"].items():
        assert len(pair[1].db.table(name)) - before[name] == n, name
    _assert_same_tables(pair)
    assert pair[1].api.integration.stats == pair[0].api.integration.stats


def test_readers_answer_like_the_reference(pair):
    """PromQL over the remote-write and Telegraf rows, Tempo's trace of
    an OTLP trace and DF-SQL over the app logs, on both servers."""
    c = ic.corpus(2, BASE_NS + 5 * 10**12)
    for post in c["posts"]:
        _post_both(pair, post)
    ref, port = pair
    base_s = c["base_ns"] // 10**9
    for name, labels, value in (c["remote_write"], c["telegraf"]):
        sel = ",".join(f'{k}="{v}"' for k, v in labels.items())
        q = urllib.parse.urlencode({"query": f"{name}{{{sel}}}",
                                    "time": base_s + 20})
        got = _get(port.query_port, f"/api/v1/query?{q}")
        assert got == _get(ref.query_port, f"/api/v1/query?{q}")
        assert float(got["data"]["result"][0]["value"][1]) == \
            pytest.approx(value)
    tid = c["trace_id"]
    got = _get(port.query_port, f"/api/traces/{tid}")
    assert got == _get(ref.query_port, f"/api/traces/{tid}")
    spans = [s for b in got["batches"] for s in b["spans"]]
    assert len(spans) == c["trace_spans"]
    # the tree: each span the child of the one before
    assert [s["parentSpanID"] for s in spans][1:] == \
        [s["spanID"] for s in spans][:-1]
    sql = {"db": "application_log", "sql":
           "SELECT app_service, log_source, Count() AS n FROM log "
           "GROUP BY app_service, log_source ORDER BY app_service"}
    got = _post(port.query_port, "/v1/query", json.dumps(sql).encode())
    want = _post(ref.query_port, "/v1/query", json.dumps(sql).encode())
    assert got[0] == 200 and got[1]["result"] == want[1]["result"]


def test_datadog_json_and_gzip_bodies(pair):
    """Datadog's JSON form, and a gzip'd Telegraf body, as the
    reference takes them."""
    dd = [[{"trace_id": 7, "span_id": 8, "service": "json-dd",
            "name": "q", "resource": "SELECT", "start": BASE_NS,
            "duration": 5, "meta": {"http.status_code": "500"}}]]
    import gzip
    lines = f"gz,host=a v=1i {BASE_NS}\ngz,host=b v=2.5 {BASE_NS}".encode()
    for post in (("/v0.3/traces", json.dumps(dd).encode(),
                  "application/json", "POST", ""),
                 ("/api/v1/telegraf", gzip.compress(lines), "text/plain",
                  "POST", "")):
        path, body, ctype, method, query = post
        want, got = (_post(srv.query_port, path, body, ctype, method,
                           headers={"Content-Encoding": "gzip"}
                           if path.endswith("telegraf") else None)
                     for srv in pair)
        assert got == want and got[0] == 200, path
    _assert_same_tables(pair)


@pytest.mark.parametrize("path,body,ctype,gz", [
    ("/api/v1/write", b"complete garbage!!", "", False),
    ("/api/v1/otlp/traces", b"[1, 2]", "application/json", False),
    ("/api/v1/otlp/traces", b"{not json", "application/json", False),
    ("/api/v1/otlp/logs", b'{"resourceLogs": [1]}', "application/json",
     False),
    ("/api/v1/otlp/logs", b'{"resourceLogs": [{"resource": 3}]}',
     "application/json", False),
    ("/v0.4/traces", b"\xc1", "application/msgpack", False),
    ("/v0.4/traces", msgpack.packb({"a": 1}), "application/msgpack", False),
    ("/v0.3/traces", b"{}", "application/json", False),
    ("/api/v1/telegraf", b"not gzip at all", "text/plain", True),
])
def test_garbage_is_400_like_the_reference(pair, path, body, ctype, gz):
    headers = {"Content-Encoding": "gzip"} if gz else None
    ref, port = pair
    want = _post(ref.query_port, path, body, ctype, headers=headers)
    got = _post(port.query_port, path, body, ctype, headers=headers)
    assert want[0] == 400
    assert got[0] == 400


def test_non_json_routes_refuse_other_methods(pair):
    """PUT is Datadog's alone; a GET of an ingest route is no route."""
    _, port = pair
    assert _post(port.query_port, "/api/v1/write", b"x" * 100,
                 method="PUT")[0] == 405
    # the connection stays usable: the refused body was read
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port.query_port,
                                      timeout=5)
    try:
        for method, path, body in (("PUT", "/api/v1/log", b'{"x": 1}'),
                                   ("POST", "/api/v1/log",
                                    b'{"message": "after a PUT"}')):
            conn.request(method, path, body)
            r = conn.getresponse()
            r.read()
            assert r.status == (405 if method == "PUT" else 200)
    finally:
        conn.close()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port.query_port, "/api/v1/telegraf")
    assert e.value.code == 404


def test_integration_rows_land_in_the_default_org(pair):
    _, port = pair
    c = ic.corpus(3, BASE_NS + 7 * 10**12, traces=1, log_lines=2,
                  series=1, samples=1, telegraf_points=1, dd_traces=1,
                  sw_segments=1)
    for path, body, ctype, method, query in c["posts"]:
        assert _post(port.query_port, path, body, ctype, method,
                     query)[0] == 200
    for db, table in (("application_log", "log"),
                      ("flow_log", "l7_flow_log"),
                      ("ext_metrics", "metrics"),
                      ("prometheus", "samples")):
        for org, want in ((1, True), (2, False)):
            code, out = _post(port.query_port, "/v1/query", json.dumps({
                "db": db, "sql": f"SELECT Count() AS n FROM {table}",
                "org_id": org}).encode())
            assert code == 200
            vals = out["result"]["values"]  # no row: no group
            assert bool(vals and vals[0][0]) == want, (table, org)


# -- SmartEncoding ids --------------------------------------------------------

def _write_request(now_s: int) -> list:
    return [("req_total", {"job": "api", "az": "a"}, [(now_s * 1000, 1.0)]),
            ("req_total", {"job": "api", "az": "b"}, [(now_s * 1000, 2.0)]),
            ("lat_sum", {"job": "api", "az": "a"}, [(now_s * 1000, 3.0)]),
            ("lat_sum", {"job": "api"}, [(now_s * 1000, 4.0)])]


def _ids(db) -> dict:
    t = db.table("prometheus.samples")
    cols = t.column_concat(["metric_id", "label_set_id", "value"])
    return {float(v): (int(m), int(s)) for m, s, v in
            zip(cols["metric_id"], cols["label_set_id"], cols["value"])}


def test_two_ingest_nodes_share_the_controllers_ids():
    """Two ingest nodes with their own stores, each taking its ids from
    one controller (the port's over its sync transport, the reference's
    over gRPC), give every series the reference's ids."""
    import grpc

    from deepflow_tpu.server.controller import Controller as RefController
    from deepflow_tpu.server.platform_info import \
        PlatformInfoTable as RefPlatform
    from deepflow_tpu.server.prom_encoder import GrpcPromEncoderClient
    from deepflow_tpu_torch.server.controller import Controller
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.server.prom_encoder import PromEncoderClient

    now = int(time.time())
    body = snappy.compress(promwire.write_request(_write_request(now)))
    second = snappy.compress(promwire.write_request(
        [("gpu_util", {"gpu": "1"}, [(now * 1000, 5.0)])]
        + _write_request(now)[1:2]))
    ctl = Controller(PlatformInfoTable(), host="127.0.0.1", port=0).start()
    ref_ctl = RefController(RefPlatform(), host="127.0.0.1", port=0).start()
    clients, channels = [], []
    try:
        nodes, ref_nodes = [], []
        for _ in range(2):
            cl = PromEncoderClient(f"127.0.0.1:{ctl.port}", timeout_s=5.0)
            clients.append(cl)
            nodes.append(IntegrationAPI(Database(), prom_encoder=cl))
            ch = grpc.insecure_channel(f"127.0.0.1:{ref_ctl.port}")
            channels.append(ch)
            ref_nodes.append(RefIntegration(
                RefDatabase(), prom_encoder=GrpcPromEncoderClient(ch)))
        for api in nodes + ref_nodes:
            api.ingest_prometheus(body)
        nodes[1].ingest_prometheus(second)
        ref_nodes[1].ingest_prometheus(second)
        views = [_ids(api.db) for api in nodes]
        assert views == [_ids(api.db) for api in ref_nodes]
        assert views[0] == {k: v for k, v in views[1].items()
                            if k != 5.0}
        assert views[0][1.0][0] == views[0][2.0][0]   # one metric
        assert views[0][1.0][1] != views[0][2.0][1]   # two series
        assert views[0][1.0][1] != views[0][3.0][1]   # metric in identity
        for api, ref_api in zip(nodes, ref_nodes):
            assert _rows(api.db, "prometheus.label_sets") == \
                _rows(ref_api.db, "prometheus.label_sets")
    finally:
        for cl in clients:
            cl.close()
        for ch in channels:
            ch.close()
        ctl.stop()
        ref_ctl.stop()


def test_ids_survive_a_storage_restart(tmp_path):
    """A --storage server restarted on its data directory keeps every
    id on disk and allocates new ones past them, as the reference's
    does; no series gets a second label_sets row."""
    now = int(time.time())
    first = snappy.compress(promwire.write_request(
        [("a_total", {"x": "1"}, [(now * 1000, 1.0)]),
         ("b_total", {"x": "1"}, [(now * 1000, 2.0)])]))
    later = snappy.compress(promwire.write_request(
        [("c_total", {"y": "2"}, [(now * 1000, 3.0)]),
         ("a_total", {"x": "1"}, [(now * 1000, 4.0)])]))
    views = []
    for cls, kw in ((Server, {"sync_port": 0, "flush_interval_s": 0.1}),
                    (RefServer, {"flush_interval_s": 0.1})):
        d = str(tmp_path / cls.__module__.split(".")[0])
        for body in (first, later):
            srv = cls(host="127.0.0.1", ingest_port=0, query_port=0,
                      data_dir=d, storage=True, selfstats_interval_s=3600,
                      **kw).start()
            try:
                assert _post(srv.query_port, "/api/v1/write", body)[0] \
                    == 200
            finally:
                srv.stop()
        srv = cls(host="127.0.0.1", ingest_port=0, query_port=0,
                  data_dir=d, storage=True, selfstats_interval_s=3600,
                  **kw).start()
        try:
            ids = _ids(srv.db)
            sids = srv.db.table("prometheus.label_sets").column_concat(
                ["label_set_id"])["label_set_id"].tolist()
        finally:
            srv.stop()
        views.append((ids, sorted(sids)))
    assert views[0] == views[1]
    ids, sids = views[0]
    assert ids[4.0] == ids[1.0]                 # a known series' ids
    assert ids[3.0][0] not in (ids[1.0][0], ids[2.0][0])
    assert sids == sorted(set(sids)) and len(sids) == 3


def test_ns_samples_are_skipped_not_wrapped():
    for api in (IntegrationAPI(Database()), RefIntegration(RefDatabase())):
        out = api.ingest_prometheus(snappy.compress(promwire.write_request(
            [("m2", {}, [(1_750_000_000_000_000_000, 1.0),
                         (1_750_000_000_000, 2.0)])])))
        assert out == {"accepted_samples": 1, "series": 1}
        assert api.db.table("prometheus.samples").column_concat(
            ["value"])["value"].tolist() == [2.0]


def test_uncompressed_write_request_is_taken():
    data = promwire.write_request([("plain", {"a": "b"}, [(10_000, 1.0)])])
    for api in (IntegrationAPI(Database()), RefIntegration(RefDatabase())):
        assert api.ingest_prometheus(data) == \
            {"accepted_samples": 1, "series": 1}


# -- the agent's proxy --------------------------------------------------------

def test_proxy_forwards_every_path_and_refuses_others(pair):
    _, port = pair
    proxy = IntegrationProxy(f"127.0.0.1:{port.query_port}",
                             host="127.0.0.1", port=0).start()
    try:
        c = ic.corpus(4, BASE_NS + 9 * 10**12, traces=2, log_lines=2,
                      series=2, samples=2, telegraf_points=2, dd_traces=1,
                      sw_segments=1)
        before = {t: len(port.db.table(t)) for t in c["counts"]}
        for path, body, ctype, method, query in c["posts"]:
            code, _ = _post(proxy.port, path, body, ctype, method, query)
            assert code == 200, path
        for name, n in c["counts"].items():
            assert len(port.db.table(name)) - before[name] == n, name
        assert proxy.stats["forwarded"] == len(c["posts"])
        # a gzip'd body keeps its encoding through the proxy
        import gzip
        code, out = _post(proxy.port, "/api/v1/telegraf", gzip.compress(
            f"gz,host=p v=1i {BASE_NS}".encode()), "text/plain",
            headers={"Content-Encoding": "gzip"})
        assert (code, out) == (200, {"accepted": 1, "bad_lines": 0})
        # the server's own 400 comes through
        assert _post(proxy.port, "/api/v1/write", b"garbage!!")[0] == 400
        req = urllib.request.Request(
            f"http://127.0.0.1:{proxy.port}/v1/query", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 404
        assert proxy.stats["rejected"] == 1
        assert proxy.stats["forwarded"] == len(c["posts"]) + 2
    finally:
        proxy.stop()


def test_proxy_answers_502_without_a_server():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    proxy = IntegrationProxy(f"127.0.0.1:{dead}", host="127.0.0.1",
                             port=0).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{proxy.port}/api/v1/log", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 502
        assert proxy.stats["errors"] == 1
    finally:
        proxy.stop()


def test_agent_runs_the_proxy_from_its_config(pair, tmp_path):
    """An agent whose config file turns the integration listener on
    forwards to the server, ships an agent.integration_proxy stats row,
    and the runner reads that file with -f."""
    from deepflow_tpu_torch.agent.agent import Agent
    from deepflow_tpu_torch.agent.config import AgentConfig
    from deepflow_tpu_torch.cli import runner

    _, port = pair
    path = tmp_path / "agent.yaml"
    path.write_text(
        "integration:\n  enabled: true\n  host: 127.0.0.1\n  port: 0\n"
        f"  server_http: 127.0.0.1:{port.query_port}\n"
        "profiler:\n  enabled: false\ntpuprobe:\n  enabled: false\n"
        "guard:\n  enabled: false\n"
        f"sender:\n  servers: ['127.0.0.1:{port.ingest_port}']\n")
    cfg = AgentConfig.load(str(path))
    assert cfg.integration.enabled and cfg.integration.port == 0
    agent = Agent(cfg, device=None).start()
    try:
        lp = agent.integration_proxy.port
        before = len(port.db.table("application_log.log"))
        code, out = _post(lp, "/api/v1/log", json.dumps(
            {"message": "from a sidecar", "timestamp_ns": BASE_NS}).encode(),
            "application/json")
        assert (code, out) == (200, {"accepted": 1})
        assert len(port.db.table("application_log.log")) == before + 1
        agent._emit_stats()
        deadline = time.monotonic() + 5
        got = []
        while not got and time.monotonic() < deadline:
            code, out = _post(port.query_port, "/v1/query", json.dumps({
                "db": "deepflow_system", "sql":
                "SELECT value FROM deepflow_system WHERE metric_name = "
                "'agent.integration_proxy' AND value_name = 'forwarded'"})
                .encode())
            got = out["result"]["values"]
            time.sleep(0.05)
        assert got and got[-1][0] == 1.0
    finally:
        agent.stop()
    assert agent.integration_proxy._httpd is None

    seen = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(runner, "attach", lambda **kw: seen.append(kw))
        mp.setattr(runner, "detach", lambda: None)
        mp.setattr(runner.runpy, "run_module", lambda *a, **k: None)
        assert runner.main(["-f", str(path), "--device", "cpu", "-m",
                            "x"]) == 0
    finally:
        mp.undo()
    assert seen[0]["config"].integration.enabled
    assert seen[0]["servers"] is None  # the file's sender address
    assert "controller" not in seen[0] and "group" not in seen[0]
