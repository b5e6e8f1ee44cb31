"""The port's query traces and EXPLAIN held against the JAX package's on
the CPU.

The tracer must build the reference's span trees, sample as it does
(the same head verdict for the same trace id, the tail kept), conserve
its ``query.trace`` hop ledger, and write the reference's
``deepflow_system.query_trace`` rows. Over the same rows, the port's
querier must answer ``EXPLAIN`` with the plan only and ``EXPLAIN
ANALYZE`` with stages that sum to within 20 % of its wall time, with the
reference querier's plan; tracing must not change an answer; and
``dfctl explain --json`` must print the reference's JSON but for the
times.
"""

import json
import threading

import numpy as np
import pytest

import test_torch_query_parallel as tqp
import test_torch_server as ts
from deepflow_tpu.cli import dfctl as ref_dfctl
from deepflow_tpu.query import qtrace as ref_qtrace
from deepflow_tpu.server.querier import QuerierAPI as RefAPI
from deepflow_tpu.store import Database as RefDatabase
from deepflow_tpu.telemetry import Telemetry as RefTelemetry
from deepflow_tpu_torch.cli import dfctl
from deepflow_tpu_torch.query import engine, qtrace
from deepflow_tpu_torch.server.querier import QuerierAPI
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.telemetry import Telemetry

SPAN = tqp.SPAN
STAGE_RTOL = 0.20   # the reference's gate (tests/test_query_trace.py)


# -- the tracer ------------------------------------------------------------------

def test_span_tree_shapes_and_parenting():
    tr = qtrace.QueryTracer(Telemetry(), service="svc-t", sink=None)
    with tr.start_trace("query", kind="sql", capture=True) as root:
        with qtrace.span("plan"):
            pass
        with qtrace.span("execute") as ex:
            ex.annotate(rows=3)
            with qtrace.span("scan t"):
                qtrace.bump("chunks")
                qtrace.bump("chunks", 2)
    spans = {d["name"]: d for d in root.trace_spans()}
    assert set(spans) == {"query", "plan", "execute", "scan t"}
    assert spans["query"]["parent_span_id"] == ""
    assert spans["plan"]["parent_span_id"] == spans["query"]["span_id"]
    assert spans["execute"]["parent_span_id"] == spans["query"]["span_id"]
    assert spans["scan t"]["parent_span_id"] == spans["execute"]["span_id"]
    assert spans["execute"]["attrs"]["rows"] == 3
    assert spans["scan t"]["attrs"]["chunks"] == 3
    assert spans["query"]["attrs"] == {"kind": "sql"}
    assert all(d["service"] == "svc-t" and d["kind"] == "query"
               for d in spans.values())
    assert len({d["trace_id"] for d in spans.values()}) == 1
    assert all(d["end_ns"] >= d["start_ns"] for d in spans.values())
    assert spans["query"]["cpu_ns"] >= 0
    # no active trace afterwards: instrumentation reverts to no-ops
    assert not qtrace.active()
    assert qtrace.span("orphan") is qtrace._NULL_SPAN


def test_head_sampling_verdicts_like_reference():
    rng = np.random.default_rng(0)
    ids = ["%032x" % int(x) for x in rng.integers(0, 2**62, 300)]
    ids += ["not-hex-" + str(i) for i in range(50)] + ["00" * 16]
    for n in (1, 2, 8, 64):
        got = [qtrace._head_keep(i, n) for i in ids]
        assert got == [ref_qtrace._head_keep(i, n) for i in ids]
    assert 0 < sum(qtrace._head_keep(i, 8) for i in ids[:300]) < 300


def test_rows_from_spans_like_reference():
    tr = qtrace.QueryTracer(Telemetry(), sink=None)
    with tr.start_trace("query", capture=True, kind="sql") as root:
        with qtrace.span("execute", rows=5, path="local"):
            with qtrace.span("prune t", candidates=0, scanned=4):
                pass
    spans = root.trace_spans()
    spans.append({"trace_id": "t", "span_id": "s", "name": "odd",
                  "attrs": {"b": np.int64(3), "a": [1, "x"]}})
    rows = qtrace.rows_from_spans(spans)
    assert rows == ref_qtrace.rows_from_spans(spans)
    assert qtrace.spans_from_rows(rows) == ref_qtrace.spans_from_rows(rows)
    back = {d["span_id"]: d for d in qtrace.spans_from_rows(rows)}
    for d in spans[:-1]:
        b = back[d["span_id"]]
        assert (b["name"], b["start_ns"], b["duration_ns"], b["attrs"]) \
            == (d["name"], d["start_ns"], d["duration_ns"], d["attrs"])


def test_ledger_conservation_with_sampling_and_sink_errors(monkeypatch):
    """emitted == delivered + dropped(reason) + in_flight on the
    query.trace hop, across keep, sample-out and sink errors, with the
    reference's counts for the same traces."""
    monkeypatch.setenv("DF_QUERY_TRACE", "1")
    monkeypatch.setenv("DF_QUERY_TRACE_SAMPLE", "2")
    monkeypatch.setenv("DF_QUERY_TRACE_SLOW_MS", "60000")
    fail = {"on": False}
    written = []

    def sink(spans):
        if fail["on"]:
            raise OSError("disk gone")
        written.extend(spans)

    snaps = []
    for mod, tel in ((qtrace, Telemetry()), (ref_qtrace, RefTelemetry())):
        tr = mod.QueryTracer(tel, service="svc", sink=sink)
        for k in range(40):
            with tr.start_trace("query", trace_id="%032x" % (k * 7919)):
                with mod.span("execute"):
                    pass
        tr.flush()
        snaps.append(tr.snapshot())
    snap, ref_snap = snaps
    led = snap["ledger"]
    assert led["emitted"] == 80  # 40 traces x 2 spans
    assert 0 < led["dropped"]["sampled_out"] < 80
    assert led["emitted"] == (led["delivered"] + led["dropped_total"]
                              + led["in_flight"])
    assert led["in_flight"] == snap["pending"] == 0
    assert {k: snap[k] for k in ("traces", "spans", "written",
                                 "sampled_out")} == \
        {k: ref_snap[k] for k in ("traces", "spans", "written",
                                  "sampled_out")}
    tr = qtrace.QueryTracer(Telemetry(), sink=sink)
    fail["on"] = True
    with tr.start_trace("query", trace_id="00" * 16):  # head-kept
        pass
    assert tr.flush() == 0
    led = tr.snapshot()["ledger"]
    assert led["dropped"]["sink_error"] == 1
    assert led["emitted"] == (led["delivered"] + led["dropped_total"]
                              + led["in_flight"])


def test_kill_switch_and_tail_keep(monkeypatch):
    monkeypatch.setenv("DF_QUERY_TRACE", "0")
    tr = qtrace.QueryTracer(Telemetry(), sink=None)
    with tr.start_trace("query") as root:
        assert root is qtrace._NULL_SPAN
        assert qtrace.span("x") is qtrace._NULL_SPAN
    assert tr.snapshot()["traces"] == 0
    assert tr.snapshot()["enabled"] is False
    with tr.start_trace("query", capture=True) as root:  # EXPLAIN ANALYZE
        pass
    assert root.trace_spans()
    # tail sampling: a sampled-out trace is kept when it errors or is slow
    monkeypatch.setenv("DF_QUERY_TRACE", "1")
    monkeypatch.setenv("DF_QUERY_TRACE_SAMPLE", "1000000")
    monkeypatch.setenv("DF_QUERY_TRACE_SLOW_MS", "30")
    kept = []
    tr = qtrace.QueryTracer(Telemetry(), sink=kept.extend)
    with tr.start_trace("query", trace_id="%032x" % 5, quiet=True):
        pass
    with pytest.raises(ValueError):
        with tr.start_trace("query", trace_id="%032x" % 6):
            raise ValueError("boom")
    with tr.start_trace("query", trace_id="%032x" % 7, slow=True):
        threading.Event().wait(0.05)
    tr.flush()
    assert sorted(d["status"] for d in kept) == ["error", "ok"]
    assert [d["attrs"] for d in kept if d["status"] == "ok"] == \
        [{"slow": True}]
    assert "ValueError: boom" in [d for d in kept
                                  if d["status"] == "error"][0]["attrs"][
        "error"]


def test_span_overflow_is_counted(monkeypatch):
    monkeypatch.setenv("DF_QUERY_TRACE_SAMPLE", "1")
    tr = qtrace.QueryTracer(Telemetry(), sink=lambda spans: None)
    with tr.start_trace("query"):
        for _ in range(qtrace.MAX_SPANS_PER_TRACE + 9):
            qtrace.span("loop").finish()
    tr.flush()
    snap = tr.snapshot()
    # the root is recorded past the cap: the children over it are dropped
    assert snap["overflow"] == 9
    assert snap["ledger"]["dropped"]["overflow"] == 9
    assert snap["spans"] == qtrace.MAX_SPANS_PER_TRACE + 1


def test_pool_workers_parent_under_the_submitting_span(monkeypatch):
    """A morsel scan's worker threads re-attach to the query's trace:
    spans they open parent under the span open at submit time."""
    from deepflow_tpu_torch.query import pool
    monkeypatch.setenv("DF_QUERY_THREADS", "3")
    tr = qtrace.QueryTracer(Telemetry(), sink=None)

    def work(i):
        with qtrace.span("morsel", i=i):
            qtrace.annotate(done=True)
        return i * i

    with tr.start_trace("query", capture=True) as root:
        with qtrace.span("execute"):
            assert pool.get_pool().map(work, range(6)) == \
                [i * i for i in range(6)]
        with qtrace.span("other") as other:
            buf, sid = qtrace.current_buf(), qtrace.current_span_id()

            def worker():
                with qtrace.use_buf(buf, sid):
                    qtrace.span("side").finish()
            th = threading.Thread(target=worker)
            th.start()
            th.join()
    spans = root.trace_spans()
    ex = next(d for d in spans if d["name"] == "execute")
    morsels = [d for d in spans if d["name"] == "morsel"]
    assert len(morsels) == 6
    assert all(d["parent_span_id"] == ex["span_id"]
               and d["attrs"]["done"] for d in morsels)
    side = next(d for d in spans if d["name"] == "side")
    assert side["parent_span_id"] == other.span_id
    assert pool.in_worker() is False


# -- EXPLAIN in the querier --------------------------------------------------------

@pytest.fixture(scope="module")
def apis():
    """The reference's querier and the port's, in process, each over its
    own database holding the same span rows, in sealed chunks of the
    same size."""
    rows = tqp._rows(3000, seed=21, minutes=4)
    ref_db, port_db = RefDatabase(), Database()
    for db in (ref_db, port_db):
        t = db.table(SPAN)
        t.chunk_rows = 400
        for i in range(0, len(rows), 100):
            t.append_rows(rows[i:i + 100])
    return RefAPI(ref_db), QuerierAPI(port_db, telemetry=Telemetry())


EXPLAIN_SQL = [
    "SELECT hlo_op FROM tpu_hlo_span",
    "SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n FROM tpu_hlo_span "
    "WHERE kind = 'device-compute' GROUP BY hlo_op ORDER BY d DESC LIMIT 5",
    "SELECT run_id, Count() AS n FROM tpu_hlo_span GROUP BY run_id",
    "SELECT hlo_op, Percentile(duration_ns, 90) AS p FROM tpu_hlo_span "
    "GROUP BY hlo_op",
]


def _explain(api, sql: str, analyze: bool) -> dict:
    kw = "EXPLAIN ANALYZE" if analyze else "EXPLAIN"
    return api.query({"sql": f"{kw} {sql}", "db": "profile"})


@pytest.mark.parametrize("sql", EXPLAIN_SQL)
def test_explain_is_the_plan_only(apis, sql):
    ref, port = apis
    got, want = _explain(port, sql, False), _explain(ref, sql, False)
    ex = got["explain"]
    assert ex["analyze"] is False and "rows_returned" not in ex
    assert [st["stage"] for st in ex["stages"]] == ["plan"]
    assert ex["plan"] == want["explain"]["plan"] == {
        "analyze": False, "table": f"profile.{SPAN.split('.')[1]}",
        "federated": False}
    assert set(ex) == set(want["explain"])
    assert got["debug"] == want["debug"]
    assert got["result"]["columns"] == want["result"]["columns"]


# EXPLAIN ANALYZE runs of each scanning step whose median is gated: a
# query here takes 0.4-20 ms, and one scheduler pause of a busy test
# worker (4.3 ms was seen) can fall between two stages of one run
STAGE_RUNS = 5


@pytest.mark.parametrize("sql", EXPLAIN_SQL)
def test_explain_analyze_sums_its_stages(apis, sql, monkeypatch):
    """Cold (cache bypassed) and then through the cache's miss and hit:
    rows_returned is the answer's, and the plan has the reference
    querier's keys and cache outcome; the runs that scan sum their
    stages to within 20 % of their wall time, at the median of five
    runs of each step (every miss but the last stores nothing, so each
    is a miss); the observed stage costs feed the stage cost model."""
    ref, port = apis
    answer = engine.execute(port.db.table(SPAN), sql.replace(
        "tpu_hlo_span", "t"))
    runs = [("bypass", {"DF_QUERY_CACHE": "0"})] * STAGE_RUNS \
        + [("miss", {"DF_QUERY_CACHE_MIN_NS": "1e30"})] * (STAGE_RUNS - 1) \
        + [("miss", {}), ("hit", {})]
    gaps: dict[str, list] = {}
    for step, env in runs:
        for k in ("DF_QUERY_CACHE", "DF_QUERY_CACHE_MIN_NS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = _explain(port, sql, True)
        want = _explain(ref, sql, True)
        ex = got["explain"]
        assert ex["rows_returned"] == len(answer.values) == \
            want["explain"]["rows_returned"]
        assert set(ex["plan"]) == set(want["explain"]["plan"])
        assert ex["plan"]["cache_outcome"] == step
        assert want["explain"]["plan"]["cache_outcome"] == step
        assert {st["stage"] for st in ex["stages"]} == {"plan", "execute"}
        stage_sum = sum(st["wall_ms"] for st in ex["stages"])
        assert 0 < stage_sum <= ex["total_ms"]
        gaps.setdefault(step, []).append(
            (ex["total_ms"] - stage_sum) / ex["total_ms"])
    for step in ("bypass", "miss"):
        assert len(gaps[step]) == STAGE_RUNS
        assert np.median(gaps[step]) <= STAGE_RTOL, (step, gaps[step])
    snap = port.stage_cost.snapshot()
    assert snap["ns_per_row"]["plan"] and snap["ns_per_row"]["execute"]


def test_explain_analyze_names_the_morsel_degree(apis, monkeypatch):
    _, port = apis
    monkeypatch.setenv("DF_QUERY_CACHE", "0")
    monkeypatch.setenv("DF_QUERY_PARALLEL", "1")
    monkeypatch.setenv("DF_QUERY_THREADS", "4")
    plan = _explain(port, EXPLAIN_SQL[1], True)["explain"]["plan"]
    chunks = len(port.db.table(SPAN).snapshot())
    assert plan["scan_mode"] == "parallel" and plan["morsel_degree"] == 4
    assert plan["morsels"] == chunks
    assert plan["prune"] == {"candidates": 0, "zone_pruned": 0,
                             "bloom_checked": 0, "bloom_pruned": 0,
                             "scanned": chunks}
    assert plan["cache_outcome"] == "bypass"


def test_answers_the_same_with_tracing_on_and_off(apis, monkeypatch):
    _, port = apis
    monkeypatch.setenv("DF_QUERY_CACHE", "0")
    monkeypatch.setenv("DF_QUERY_TRACE_SAMPLE", "1")
    body = {"sql": EXPLAIN_SQL[1], "db": "profile"}
    monkeypatch.setenv("DF_QUERY_TRACE", "0")
    off = port.query(dict(body))
    monkeypatch.setenv("DF_QUERY_TRACE", "1")
    on = port.query(dict(body))
    assert json.dumps(off) == json.dumps(on)
    port.qtracer.flush()
    res = engine.execute(port.db.table("deepflow_system.query_trace"),
                         "SELECT name, status, attr_json FROM t")
    names = {(v[0], v[1]) for v in res.values}
    assert {("query", "ok"), ("parse", "ok"), ("plan", "ok"),
            ("execute", "ok"), ("cache.lookup", "ok")} <= names
    health = port.health()
    led = health["query_trace"]["ledger"]
    assert led["emitted"] == (led["delivered"] + led["dropped_total"]
                              + led["in_flight"])
    assert health["query_trace"]["written"] == len(res.values)
    assert set(health["query"]) >= {"scanned_segments", "pool_threads",
                                    "pool_dispatched", "pool_busy",
                                    "degree"}
    assert set(health["query_cache"]) == set(
        RefAPI(RefDatabase()).health()["query_cache"])


# -- dfctl explain -------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    ref, port = ts._start_pair()
    try:
        frames, counts = ts._frames()
        ts._ingest((ref, port), frames, counts)
        yield ref, port
    finally:
        ref.stop()
        port.stop()


def _untimed(ex: dict, srv) -> dict:
    ex = dict(ex)
    for k in ("trace_id", "total_ms"):
        assert ex.pop(k)
    for st in ex["stages"]:
        assert st.pop("wall_ms") >= 0 and st.pop("cpu_ms") >= 0
    ex["stages"] = sorted(ex["stages"], key=lambda st: st["stage"])
    prune = ex["plan"].get("prune")
    if prune:  # each server scans its own chunks (the port's are smaller)
        prune["scanned"] = prune["scanned"] == len(
            srv.db.table(ex["plan"]["table"]).snapshot()) * next(
            st["detail"].get("bucket_stale", 1) for st in ex["stages"]
            if st["stage"] == "execute")
    return ex


@pytest.mark.parametrize("args", [
    ["explain", "SELECT hlo_op, Sum(duration_ns) AS d FROM tpu_hlo_span "
                "GROUP BY hlo_op ORDER BY d DESC", "--db", "profile"],
    ["explain", "SELECT Count() AS n FROM profile.tpu_hlo_span",
     "--no-analyze"],
    ["explain", "EXPLAIN SELECT run_id FROM tpu_hlo_span", "--db",
     "profile"],
    ["explain", "SELECT nope FROM tpu_hlo_span", "--db", "profile"],
])
def test_dfctl_explain_like_reference(pair, args, capsys):
    """--json prints the reference's explain JSON but for the times;
    the text lists the same plan lines and stages."""
    ref, port = pair
    outs = {}
    for name, main, srv in (("port", dfctl.main, port),
                            ("ref", ref_dfctl.main, ref)):
        for mode in ("json", "text"):
            argv = ["--server", f"127.0.0.1:{srv.query_port}", *args]
            try:
                rc = main(argv + (["--json"] if mode == "json" else []))
                end = f"rc {rc}"
            except SystemExit as e:
                end = f"exit {e.code}"
            outs[name, mode] = capsys.readouterr().out, end
    (pj, pend), (rj, rend) = outs["port", "json"], outs["ref", "json"]
    assert pend == rend
    if "nope" in args[1]:
        assert pend.startswith("exit error 400")
        return
    assert _untimed(json.loads(pj), port) == _untimed(json.loads(rj), ref)
    (pt, _), (rt, _) = outs["port", "text"], outs["ref", "text"]

    def lines(text):  # the plan lines and stage names, times left out
        return sorted(ln.split()[0] for ln in text.splitlines()[1:]
                      if ln.strip() and not ln.startswith(("-", "total")))
    assert lines(pt) == lines(rt)
    assert pt.startswith("trace_id: ") and "stage" in pt
