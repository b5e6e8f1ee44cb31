"""The port's PromQL engine held against the JAX package's on the CPU.

The same rows, made from a numpy seed, go into both packages' stores:
ten minutes of ``flow_metrics.network.1s`` and ``flow_metrics.
application.1s`` (per-interval deltas, three hosts, three server ports,
two orgs) and ``deepflow_system`` self-telemetry (a cumulative counter
with a reset, a gauge and histogram buckets with ``le`` labels). Each
query of the corpus (selectors and matchers, rate / irate / increase,
the aggregations, vector matching, set operators, subqueries,
``histogram_quantile``, the label functions) runs through ``evaluate``
over a range and ``evaluate_instant`` at its end in both packages: the
series must carry the same labels and their values agree within a
relative tolerance of 1e-9 (both engines run the same float64 numpy
arithmetic; the tolerance covers summation order only). ``series``,
``label_names``, ``label_values``, ``scope_to_org`` and the errors of
bad queries agree too, and the querier's ``/api/v1/*`` routes answer as
the engine does.
"""

import json
import math
import urllib.parse
import urllib.request

import numpy as np
import pytest

from deepflow_tpu.query import promql as ref_promql
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch.query import promql
from deepflow_tpu_torch.store.db import Database

T0 = 1_760_000_000  # epoch s
SPAN_S = 600
START, END, STEP = T0 + 120, T0 + SPAN_S, 30
RTOL = 1e-9

QUERIES = [
    # selectors and matchers
    "flow_metrics_network_byte_tx",
    'flow_metrics_network_byte_tx{host="h1"}',
    'flow_metrics_network_byte_tx{host!="h1"}',
    'flow_metrics_network_byte_tx{host=~"h[12]"}',
    'flow_metrics_network_packet_tx{protocol!~"ud.", server_port="80"}',
    'flow_metrics_application_request{l7_protocol="http1"}',
    # range functions over the delta tables
    "rate(flow_metrics_network_byte_tx[1m])",
    "irate(flow_metrics_network_packet_tx[2m])",
    "increase(flow_metrics_application_request[5m])",
    "rate(flow_metrics_network_byte_tx[1m] offset 1m)",
    "sum_over_time(flow_metrics_application_error_server[2m])",
    "count_over_time(flow_metrics_network_byte_rx[90s])",
    # aggregations
    "sum by (server_port) (rate(flow_metrics_application_request[1m]))",
    "sum without (ip_src, ip_dst) (rate(flow_metrics_network_byte_rx[1m]))",
    "avg by (host) (flow_metrics_network_rtt_sum)",
    "max by (host) (flow_metrics_application_rrt_max)",
    "min(flow_metrics_application_rrt_max)",
    "count by (host) (flow_metrics_network_byte_tx)",
    "stddev by (host) (flow_metrics_network_byte_tx)",
    "stdvar(flow_metrics_network_byte_tx)",
    "group by (server_port) (flow_metrics_application_request)",
    "topk(2, sum by (server_port) "
    "(rate(flow_metrics_application_request[1m])))",
    "bottomk(1, sum by (host) (flow_metrics_network_byte_tx))",
    "quantile(0.9, flow_metrics_application_rrt_max)",
    'count_values("depth", deepflow_system_queue_depth)',
    # counters, gauges and histograms of the narrow self-telemetry table
    "rate(deepflow_system_agent_sender_sent_frames[1m])",
    "increase(deepflow_system_agent_sender_sent_frames[3m])",
    "resets(deepflow_system_agent_sender_sent_frames[5m])",
    "deriv(deepflow_system_queue_depth[2m])",
    "predict_linear(deepflow_system_queue_depth[2m], 60)",
    "delta(deepflow_system_queue_depth[2m])",
    "quantile_over_time(0.5, deepflow_system_queue_depth[3m])",
    "histogram_quantile(0.9, sum by (le) "
    "(rate(deepflow_system_req_latency_bucket[1m])))",
    "histogram_quantile(0.5, rate(deepflow_system_req_latency_bucket[2m]))",
    # vector matching and set operators
    "sum by (host) (rate(flow_metrics_network_byte_tx[1m])) / on (host) "
    "sum by (host) (rate(flow_metrics_network_byte_rx[1m]))",
    "sum by (host, server_port) (rate(flow_metrics_application_request[1m]))"
    " / on (host) group_left sum by (host) "
    "(rate(flow_metrics_application_request[1m]))",
    "flow_metrics_network_byte_tx > bool 500",
    "flow_metrics_network_byte_tx > 500",
    "sum by (host) (flow_metrics_network_byte_tx) and on (host) "
    'sum by (host) (flow_metrics_network_byte_rx{host!="h3"})',
    'sum by (host) (flow_metrics_network_byte_tx{host="h1"}) or '
    "sum by (host) (flow_metrics_network_byte_rx)",
    "sum by (host) (flow_metrics_network_byte_tx) unless on (host) "
    'sum by (host) (flow_metrics_network_byte_rx{host="h2"})',
    "sum(rate(flow_metrics_application_error_server[1m])) / "
    "sum(rate(flow_metrics_application_request[1m]))",
    # subqueries
    "max_over_time(rate(flow_metrics_network_byte_tx[1m])[5m:30s])",
    "rate(sum(flow_metrics_application_request)[2m:15s])",
    # label and math functions
    'label_replace(sum by (host) (flow_metrics_network_byte_tx), '
    '"node", "n$1", "host", "h(.*)")',
    'label_join(sum by (host, server_port) (flow_metrics_network_byte_tx),'
    ' "hp", ":", "host", "server_port")',
    "clamp_max(abs(deriv(deepflow_system_queue_depth[2m])), 0.05)",
    "round(sqrt(sum by (host) (flow_metrics_network_byte_tx)), 0.5)",
    "sort_desc(sum by (host) (flow_metrics_network_byte_tx))",
    "scalar(sum(flow_metrics_network_byte_tx)) * 2 + time()",
    "vector(1) + 2",
    'absent(flow_metrics_network_byte_tx{host="nope"})',
    "timestamp(flow_metrics_application_request)",
]


def _rows(seed: int):
    """(network rows, application rows, self-telemetry rows)."""
    rng = np.random.default_rng(seed)
    net, app, sysrows = [], [], []
    hosts, ports = ("h1", "h2", "h3"), (80, 443, 8080)
    for s in range(0, SPAN_S, 5):
        for h in hosts:
            if rng.random() < 0.15:
                continue  # gaps: series are not dense
            port = int(rng.choice(ports))
            base = {"time": T0 + s, "host": h, "server_port": port,
                    "ip_src": f"10.0.0.{hosts.index(h) + 1}",
                    "ip_dst": f"10.0.1.{ports.index(port) + 1}",
                    "org_id": 1 if rng.random() < 0.8 else 2}
            net.append({**base, "protocol": int(rng.integers(1, 3)),
                        "byte_tx": int(rng.integers(0, 2000)),
                        "byte_rx": int(rng.integers(0, 2000)),
                        "packet_tx": int(rng.integers(0, 50)),
                        "rtt_sum": int(rng.integers(0, 10**6))})
            req = int(rng.integers(1, 40))
            app.append({**base, "l7_protocol": int(rng.integers(1, 3)),
                        "app_service": f"svc-{port}",
                        "request": req, "response": req,
                        "error_server": int(rng.integers(0, 3)),
                        "rrt_sum": int(rng.integers(0, 10**6)),
                        "rrt_count": req,
                        "rrt_max": int(rng.integers(0, 10**5))})
    counter = 0.0
    for s in range(0, SPAN_S, 10):
        t = (T0 + s) * 1_000_000_000
        counter = 0.0 if s == 300 else counter + float(rng.integers(5, 50))
        for name, value, tags, v in (
                ("agent.sender", "sent_frames", {"job": "api"}, counter),
                ("queue", "depth", {"job": "api"},
                 float(rng.integers(0, 10)))):
            sysrows.append({"time": t, "metric_name": name,
                            "value_name": value,
                            "tag_json": json.dumps(tags), "value": v,
                            "host": "h1"})
        n = (s // 10 + 1) * 100
        for le, frac in (("0.1", 0.6), ("0.5", 0.9), ("+Inf", 1.0)):
            sysrows.append({"time": t, "metric_name": "req_latency",
                            "value_name": "bucket",
                            "tag_json": json.dumps({"le": le}),
                            "value": float(int(n * frac)), "host": "h1"})
    return net, app, sysrows


@pytest.fixture(scope="module")
def dbs():
    net, app, sysrows = _rows(0)
    out = []
    for db in (RefDatabase(), Database()):
        db.table("flow_metrics.network.1s").append_rows(net)
        db.table("flow_metrics.application.1s").append_rows(app)
        db.table("deepflow_system.deepflow_system").append_rows(sysrows)
        out.append(db)
    return out


def _close(got, want) -> None:
    """Two answers of the same shape; numbers (or their Prometheus
    strings) within RTOL, NaN only against NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (got, want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, (float, int)) and not isinstance(want, bool) or (
            isinstance(want, str) and _num(want) is not None
            and _num(got) is not None):
        g, w = float(got), float(want)
        if math.isnan(w):
            assert math.isnan(g)
        else:
            assert g == pytest.approx(w, rel=RTOL, abs=0), (got, want)
    else:
        assert got == want


def _num(s):
    try:
        return float(s)
    except (TypeError, ValueError):
        return None


def _by_labels(series: list[dict]) -> list[dict]:
    return sorted(series, key=lambda s: json.dumps(s.get("metric", {}),
                                                   sort_keys=True))


@pytest.mark.parametrize("q", QUERIES)
def test_query_range_equals_reference(dbs, q):
    ref_db, db = dbs
    want = ref_promql.evaluate(ref_db, q, START, END, STEP)
    got = promql.evaluate(db, q, START, END, STEP)
    assert want, q  # every query of the corpus has an answer
    _close(_by_labels(got), _by_labels(want))


@pytest.mark.parametrize("q", QUERIES)
def test_instant_query_equals_reference(dbs, q):
    ref_db, db = dbs
    want = ref_promql.evaluate_instant(ref_db, ref_promql.parse(q), END)
    got = promql.evaluate_instant(db, promql.parse(q), END)
    if want["resultType"] == "vector":
        want["result"] = _by_labels(want["result"])
        got["result"] = _by_labels(got["result"])
    _close(got, want)


@pytest.mark.parametrize("q", QUERIES[:12])
def test_scope_to_org_equals_reference(dbs, q):
    """Org 2's view: the flow tables' rows of that org only."""
    ref_db, db = dbs
    a, b = ref_promql.parse(q), promql.parse(q)
    ref_promql.scope_to_org(a, 2)
    promql.scope_to_org(b, 2)
    _close(_by_labels(promql.evaluate(db, b, START, END, STEP)),
           _by_labels(ref_promql.evaluate(ref_db, a, START, END, STEP)))


def test_metadata_equals_reference(dbs):
    ref_db, db = dbs
    matches = ['flow_metrics_network_byte_tx{host=~"h[13]"}',
               "deepflow_system_req_latency_bucket"]
    assert _by_labels(promql.series(db, matches, T0, T0 + SPAN_S)) == \
        _by_labels(ref_promql.series(ref_db, matches, T0, T0 + SPAN_S))
    assert promql.label_names(db, matches, T0, T0 + SPAN_S) == \
        ref_promql.label_names(ref_db, matches, T0, T0 + SPAN_S)
    for label in ("host", "le", "__name__", "server_port"):
        for m in ([], matches):
            assert promql.label_values(db, label, m, T0, T0 + SPAN_S) == \
                ref_promql.label_values(ref_db, label, m, T0, T0 + SPAN_S)


@pytest.mark.parametrize("q", [
    "rate(flow_metrics_network_byte_tx)",       # a range function, no range
    "sum by (host (flow_metrics_network_byte_tx)",
    "flow_metrics_network_nope",                # no such column
    "ext_metrics_cpu_usage",                    # no rows: unknown metric
    "remote_write_metric_total",
    'absent("foo")',
    "flow_metrics_network_byte_tx + on (host) group_left "
    "flow_metrics_network_byte_rx",            # many-to-many
])
def test_errors_equal_reference(dbs, q):
    ref_db, db = dbs
    with pytest.raises(ref_promql.PromqlError) as want:
        ref_promql.evaluate(ref_db, q, START, END, STEP)
    with pytest.raises(promql.PromqlError) as got:
        promql.evaluate(db, q, START, END, STEP)
    assert str(got.value) == str(want.value)
    assert type(got.value).__name__ == type(want.value).__name__


def test_querier_routes_answer_as_the_engine(dbs):
    """GET /api/v1/query_range, /query, /series, /labels and
    /label/<l>/values (and their /prom aliases) on the port's server
    over the same rows."""
    from deepflow_tpu_torch.server import Server
    net, app, sysrows = _rows(0)
    server = Server(ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    try:
        server.db.table("flow_metrics.network.1s").append_rows(net)
        server.db.table("flow_metrics.application.1s").append_rows(app)
        server.db.table("deepflow_system.deepflow_system").append_rows(
            sysrows)

        def get(path, **q):
            url = (f"http://127.0.0.1:{server.query_port}{path}?"
                   + urllib.parse.urlencode(q, doseq=True))
            with urllib.request.urlopen(url, timeout=30) as r:
                return json.loads(r.read())
        q = QUERIES[12]
        for prefix in ("", "/prom"):
            out = get(f"{prefix}/api/v1/query_range", query=q, start=START,
                      end=END, step=STEP)
            assert out["status"] == "success"
            _close(_by_labels(out["data"]["result"]), _by_labels(
                promql.evaluate(server.db, q, START, END, STEP)))
            out = get(f"{prefix}/api/v1/query", query=q, time=END)
            assert out["data"]["resultType"] == "vector"
            assert len(out["data"]["result"]) == 3
            out = get(f"{prefix}/api/v1/series",
                      **{"match[]": "flow_metrics_network_byte_tx",
                         "start": T0, "end": T0 + SPAN_S})
            assert len(out["data"]) == len(promql.series(
                server.db, ["flow_metrics_network_byte_tx"], T0,
                T0 + SPAN_S))
            out = get(f"{prefix}/api/v1/labels", start=T0, end=T0 + SPAN_S)
            assert "host" in out["data"] and "__name__" in out["data"]
            out = get(f"{prefix}/api/v1/label/host/values", start=T0,
                      end=T0 + SPAN_S)
            assert out["data"] == ["h1", "h2", "h3"]
        assert get("/api/v1/query", query="rate(", time=END)["status"] \
            == "error"
        assert get("/api/v1/series")["status"] == "error"  # no match[]
    finally:
        server.stop()
