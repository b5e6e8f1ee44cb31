"""The port's DF-SQL held against the JAX package's on the CPU.

The parser must build the reference's tree for every statement of a
corpus and refuse the same bad ones with the same message. The engine
gets the same seeded rows in a reference ``ColumnarTable`` and a port
one, for each of the port's six table schemas, and every query of a
corpus must give the same columns and values: integers and strings
exactly, float64 results (Avg, Percentile, ratios) to a relative 1e-12.
The port's encoded path must equal its decoded one, random queries from
a small grammar must give the reference's answer, and a query that runs
while rows are appended must see whole batches only.
"""

import dataclasses
import math
import os
import sys
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepflow_tpu.query import catalog as ref_catalog
from deepflow_tpu.query import engine as ref_engine
from deepflow_tpu.query import sql as ref_sql
from deepflow_tpu.store import schema as ref_schema
from deepflow_tpu.store.table import ColumnarTable as RefTable
from deepflow_tpu.store.table import ColumnSpec as RefSpec
from deepflow_tpu_torch.query import catalog, engine
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.store import schema
from deepflow_tpu_torch.store.table import ColumnarTable, ColumnSpec

FLOAT_RTOL = 1e-12   # float64 results: the same operations, in order
BASE_NS = 1_760_000_000_000_000_000
WORDS = ("", "gemm", "add", "nccl_allreduce", "Memcpy DtoD", "a.b*x",
         "foo[1]x", "trainer", "b")

# -- parser ------------------------------------------------------------------

PARSE_CORPUS = [
    # tests/test_query.py
    "SELECT Sum(bytes) AS b, svc FROM flow WHERE proto = 'tcp' "
    "GROUP BY svc ORDER BY b DESC LIMIT 10",
    "SELECT svc, bytes FROM flow WHERE bytes >= 100",
    "SELECT svc FROM flow WHERE proto = 'udp'",
    "SELECT bytes FROM flow WHERE svc LIKE 'a%'",
    "SELECT bytes FROM flow WHERE svc IN ('db', 'cache')",
    "SELECT svc, Sum(bytes) AS total, Count(*) AS n, Max(latency) AS mx "
    "FROM flow GROUP BY svc ORDER BY total DESC",
    "SELECT Sum(bytes) / Count(*) AS avg_bytes, Avg(latency) FROM flow",
    "SELECT time(time, 60) AS ts, Sum(bytes) AS b FROM flow "
    "GROUP BY ts ORDER BY ts",
    "SELECT Percentile(latency, 50) AS p50 FROM flow",
    "SELECT Last(svc) FROM flow",
    "SELECT 5 AS c, svc FROM flow LIMIT 2",
    "SELECT Sum(bytes) AS b, 7 AS c FROM flow",
    "SELECT v FROM f WHERE a = b",
    "SELECT v FROM f WHERE a <> b",
    "SELECT s FROM f WHERE s LIKE 'foo[1]%'",
    "SELECT svc FROM flow WHERE svc < 'banana'",
    "SELECT bytes FROM flow WHERE svc NOT IN ('api')",
    "SELECT bytes FROM flow WHERE NOT svc LIKE 'a%' OR -bytes < -3",
    "SELECT x FROM t WHERE a = 'it\\'s'",
    "SELECT 1.5 * (a + b) - c / 2 AS e FROM t",
    # tests/test_sql_depth.py
    "SELECT pod_0, Sum(byte_tx) AS b FROM t GROUP BY pod_0 "
    "HAVING Sum(byte_tx) > 20 ORDER BY b DESC",
    "SELECT pod_0, Avg(rtt) AS art FROM t WHERE service_1 = 'db-svc' "
    "GROUP BY pod_0 HAVING Avg(rtt) > 1000",
    "SELECT Max(rrt), Avg(rrt), Sum(error) FROM t",
    "SHOW TAGS FROM flow_log.l4_flow_log",
    "show databases",
    "SHOW tables",
    "SHOW METRICS FROM network",
    "SELECT Count(DISTINCT svc) FROM t",
    "SELECT CASE WHEN lat > 900 THEN 'vslow' WHEN lat > 500 THEN 'slow' "
    "ELSE 'ok' END AS c, Count() FROM t GROUP BY c",
    "SELECT CASE WHEN lat > 500 THEN 1 ELSE 0 END AS hot, svc FROM t",
    "SELECT svc, CASE WHEN Avg(lat) > 490 THEN 'hot' ELSE 'cool' END "
    "AS h FROM t GROUP BY svc",
    "SELECT Time(time, 10) AS bucket, Count() FROM t GROUP BY bucket",
    "SELECT svc AS lat, Count() FROM t GROUP BY lat",
    # tests/test_query_encoded.py
    "SELECT svc, proto, Sum(bytes) AS s FROM flow GROUP BY svc, proto "
    "HAVING Sum(bytes) > 100 ORDER BY s DESC, svc, proto LIMIT 7",
    "SELECT Min(latency) AS mn, Max(latency) AS mx, Count(*) AS n "
    "FROM flow WHERE svc LIKE 'svc-1%'",
    "EXPLAIN SELECT svc FROM flow",
    "explain analyze SELECT Count() FROM flow WHERE a >= 1.25",
]

# the querier's own SQL (deepflow_tpu/server/querier.py:529-771), by the
# table it runs on
QUERIER_SQL = {
    # the smoke's flow dashboards (chip_flows.py FLOW_QUERIES)
    "flow_log.l4_flow_log": [
        "SELECT ip_src, ip_dst, Sum(byte_tx) AS bytes FROM t "
        "GROUP BY ip_src, ip_dst ORDER BY bytes DESC, ip_src, ip_dst "
        "LIMIT 10"],
    "flow_log.l7_flow_log": [
        "SELECT ip_dst, port_dst, endpoint, Count() AS requests, "
        "Sum(CASE WHEN response_status IN ('client_error', "
        "'server_error', 'timeout') THEN 1 ELSE 0 END) AS errors, "
        "Percentile(response_duration, 90) AS rrt_p90 FROM t "
        "GROUP BY ip_dst, port_dst, endpoint "
        "ORDER BY requests DESC, ip_dst, port_dst, endpoint LIMIT 20"],
    "flow_metrics.network.1s": [
        "SELECT server_port, Sum(new_flow) AS flows, "
        "Sum(closed_flow) AS closed FROM t GROUP BY server_port "
        "ORDER BY flows DESC, server_port LIMIT 20",
        "SELECT server_port, Avg(rtt) AS rtt FROM t GROUP BY server_port"],
    "flow_metrics.application.1s": [
        "SELECT server_port, Avg(rrt) AS a, Max(rrt) AS m, Sum(error) AS e "
        "FROM t GROUP BY server_port ORDER BY server_port"],
    "profile.tpu_hlo_span": [
        "SELECT hlo_module, hlo_category, hlo_op, Sum(duration_ns) AS d "
        "FROM t WHERE duration_ns > 0 AND kind IN ('device-compute', "
        "'device-collective', 'device-transfer') "
        "GROUP BY hlo_module, hlo_category, hlo_op",
        "SELECT hlo_op, hlo_module, Sum(bytes_accessed) AS b, "
        "Sum(duration_ns) AS d, Count() AS n FROM t "
        "WHERE bytes_accessed > 0 GROUP BY hlo_op, hlo_module "
        "ORDER BY b DESC LIMIT 15",
        "SELECT hlo_op, Sum(bytes_accessed) AS b FROM t "
        "WHERE bytes_accessed > 0 AND time >= 1760000000000000000 "
        "AND time < 1760000020000000000 GROUP BY hlo_op "
        "ORDER BY b DESC LIMIT 10",
        "SELECT time, duration_ns, device_id, core_id, hlo_op, collective, "
        "run_id, bytes_transferred, replica_group_size, step, host, "
        "slice_id, tpu_pod FROM t WHERE duration_ns > 0 "
        "AND collective != ''"],
    "profile.tpu_memory": [
        "SELECT time, device_id, bytes_in_use, peak_bytes_in_use, "
        "bytes_limit, largest_free_block FROM t WHERE bytes_limit > 0 "
        "AND device_id = 1 ORDER BY time"],
    "profile.tpu_step_metrics": [
        "SELECT time, end_ns, latency_ns, run_id, step, job, device_count, "
        "device_skew_ns, compute_ns, collective_ns, straggler_device, "
        "straggler_lag_ns, top_hlos, host FROM t WHERE job = 'train_step' "
        "AND run_id = 3"],
}
PARSE_CORPUS += [q for qs in QUERIER_SQL.values() for q in qs]

BAD_SQL = ["", "SELECT", "SELECT a FROM", "SELECT a FROM t WHERE",
           "SELECT a FROM t LIMIT x", "SHOW nonsense", "SHOW TAGS",
           "SELECT a FROM t GARBAGE", "SELECT CASE END FROM t",
           "SELECT a FROM t WHERE b IN ()", "EXPLAIN",
           "SELECT 'open FROM t", "SELECT a FROM t WHERE a LIKE 5",
           "SELECT a FROM t WHERE b NOT = 1", "SHOW tables extra",
           "SELECT a ; FROM t"]


def _dump(x):
    """A structural dump of an AST: class names and fields, recursively."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple((f.name, _dump(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_dump(i) for i in x))
    return (type(x).__name__, x)


def test_parse_corpus_is_large_enough():
    assert len(PARSE_CORPUS) >= 40 and len(set(PARSE_CORPUS)) == \
        len(PARSE_CORPUS)


@pytest.mark.parametrize("sql", PARSE_CORPUS)
def test_parse_like_reference(sql):
    mine, ref = S.parse_statement(sql), ref_sql.parse_statement(sql)
    assert _dump(mine) == _dump(ref)
    if isinstance(mine, S.Select):
        for a, b in zip(mine.items, ref.items):
            assert S.expr_name(a.expr) == ref_sql.expr_name(b.expr)
            assert S.contains_agg(a.expr) == ref_sql.contains_agg(b.expr)
        assert _dump(S.parse(sql)) == _dump(ref_sql.parse(sql))


@pytest.mark.parametrize("sql", BAD_SQL)
def test_bad_sql_raises_like_reference(sql):
    with pytest.raises(ref_sql.SqlError) as ref_err:
        ref_sql.parse_statement(sql)
    with pytest.raises(S.SqlError) as err:
        S.parse_statement(sql)
    assert str(err.value) == str(ref_err.value)


# -- engine over the ten tables ---------------------------------------------

# per table: a str column, a second str column, an enum column (or None),
# a small int tag, and a metric
ROLES = {
    "profile.tpu_hlo_span": ("hlo_op", "hlo_module", "kind", "device_id",
                             "duration_ns"),
    "profile.in_process_profile": ("app_service", "thread_name",
                                   "event_type", "tid", "value"),
    "profile.tpu_step_metrics": ("job", "host", None, "run_id",
                                 "latency_ns"),
    "profile.tpu_memory": ("process_name", "host", None, "device_id",
                           "bytes_in_use"),
    "deepflow_system.deepflow_system": ("metric_name", "value_name", None,
                                        "agent_id", "value"),
    "deepflow_system.query_trace": ("name", "service", None, "agent_id",
                                    "duration_ns"),
    "flow_log.l4_flow_log": ("ip_src", "ip_dst", "close_type", "port_dst",
                             "byte_tx"),
    "flow_log.l7_flow_log": ("endpoint", "request_type", "response_status",
                             "port_dst", "response_duration"),
    "flow_metrics.network.1s": ("ip_src", "ip_dst", "protocol",
                                "server_port", "byte_tx"),
    "flow_metrics.application.1s": ("ip_dst", "app_service", "l7_protocol",
                                    "server_port", "rrt_sum"),
    **{f"flow_metrics.network.{sfx}": ("ip_src", "ip_dst", "protocol",
                                       "server_port", "byte_tx")
       for sfx in ("1m", "1h", "1d")},
    **{f"flow_metrics.application.{sfx}": ("ip_dst", "app_service",
                                           "l7_protocol", "server_port",
                                           "rrt_sum")
       for sfx in ("1m", "1h", "1d")},
    "flow_log.trace_tree": ("root_service", "trace_id", None, "span_count",
                            "duration_ns"),
    "event.event": ("event_type", "resource_name", None, "agent_id", "pid"),
    "event.file_agg": ("path", "host", "op", "pid", "bytes"),
    "application_log.log": ("app_service", "body", "log_source", "agent_id",
                            "severity_number"),
    "prometheus.samples": ("metric_name", "labels_json", None, "metric_id",
                           "value"),
    "prometheus.label_sets": ("metric_name", "labels_json", None,
                              "metric_id", "label_set_id"),
    "ext_metrics.metrics": ("metric_name", "value_name", None, "agent_id",
                            "value"),
}
TABLES = tuple(ROLES)

TEMPLATES = [
    "SELECT {S}, Sum({M}) AS s, Count(*) AS n FROM t GROUP BY {S} "
    "ORDER BY s DESC LIMIT 5",
    "SELECT {S}, {K}, {M} FROM t WHERE {M} > 100 ORDER BY {M} DESC, {S} "
    "LIMIT 7",
    "SELECT {S}, time FROM t WHERE {S} = 'gemm'",
    "SELECT {S}, {K} FROM t WHERE {S} IN ('gemm', 'absent', '') "
    "ORDER BY {K}",
    "SELECT {S} FROM t WHERE {S} LIKE 'a%' OR {S} LIKE '%[1]%' "
    "OR {S} LIKE 'a._*%'",
    "SELECT {S}, {M} FROM t WHERE {S} = 'never-seen' OR {S} IN ('nope') "
    "OR {S} LIKE 'zz%' OR {S} > 'zzz'",
    "SELECT {S}, Count() AS n FROM t WHERE {S} < 'b' GROUP BY {S}",
    "SELECT {S}, {S2} FROM t WHERE {S} != {S2} AND {S} >= 'add' LIMIT 10",
    "SELECT {K}, Avg({M}) AS a, Min({M}) AS lo, Max({M}) AS hi, "
    "Percentile({M}, 90) AS p90 FROM t GROUP BY {K} ORDER BY {K}",
    "SELECT time(time, 10) AS b, Count() AS n, Sum({M}) AS s FROM t "
    "GROUP BY b ORDER BY b",
    "SELECT {S}, Count(DISTINCT {K}) AS d, Last({S2}) AS l, Last({M}) AS lm "
    "FROM t GROUP BY {S} HAVING Count() > 2 ORDER BY d DESC, {S}",
    "SELECT CASE WHEN {M} > 500 THEN 'hot' WHEN {K} = 0 THEN 'zero' "
    "ELSE 'cold' END AS c, Count() AS n FROM t GROUP BY c",
    "SELECT CASE WHEN {M} > 500 THEN 1 ELSE 0 END AS hot, {S} FROM t "
    "WHERE NOT ({S} = 'gemm') LIMIT 6",
    "SELECT 7 AS c, {S}, 'x' AS lit FROM t WHERE NOT ({S} = 'gemm') "
    "LIMIT 3",
    "SELECT Sum({M}) AS s, 1 AS one FROM t WHERE {K} >= 2 AND {K} < 3",
    "SELECT {S}, Sum({M}) / Count() AS avg_m FROM t "
    "WHERE {S} NOT IN ('gemm') GROUP BY {S} HAVING Sum({M}) > 0 "
    "ORDER BY avg_m",
    "SELECT Count() AS n, Sum({M}) AS s FROM t WHERE {K} > 70000",
    "SELECT {S}, {K} FROM t ORDER BY {S} DESC, {K} LIMIT 9",
    "SELECT {S}, Sum({M}) AS s FROM t GROUP BY {S} "
    "HAVING {S} IN ('gemm', 'add') OR {S} = ''",
    "SELECT {S}, {S2}, Count() AS n FROM t GROUP BY {S}, {S2} "
    "ORDER BY {S2} DESC, n, {S}",
    "SELECT time, {M} FROM t WHERE time >= 1760000010000000000 "
    "AND time < 1760000020000000000 ORDER BY time",
    "SELECT org_id, Count() AS n FROM t WHERE org_id = 2 OR {M} < 50 "
    "GROUP BY org_id",
    "SELECT {K}, Percentile({M}, 50) AS p FROM t WHERE {K} = 3 "
    "AND time < 1760000003000000000 GROUP BY {K}",
    "SELECT Max({M}) - Min({M}) AS spread, Avg({K}) * 2 AS a2 FROM t "
    "HAVING Count() >= 1",
    # several ranges on one column, as the query cache's bucket scans
    # make them: they fold into one (engine._fold_ranges)
    "SELECT {S}, Sum({M}) AS s, Count() AS n FROM t "
    "WHERE time >= 1760000005000000000 AND {K} >= 1 "
    "AND time < 1760000025000000000 AND {K} <= 3 "
    "AND time >= 1760000010000000000 GROUP BY {S} ORDER BY {S}",
    "SELECT Count() AS n, Sum({M}) AS s FROM t "
    "WHERE {K} >= 3 AND time >= 0 AND {K} < 3",
]
ENUM_TEMPLATES = [
    "SELECT {E}, Count() AS n FROM t WHERE {E} IN ('{L1}', 'nope') "
    "GROUP BY {E}",
    "SELECT {E}, {S} FROM t WHERE {E} > '{L1}' ORDER BY {E}, {S} LIMIT 8",
    "SELECT {E}, Sum({M}) AS s FROM t WHERE {E} LIKE '%-%' "
    "GROUP BY {E} ORDER BY {E} DESC",
    "SELECT {E} FROM t WHERE {E} = '{L1}' OR {E} = 'absent-label'",
]


def _queries(table: str) -> list[str]:
    s, s2, e, k, m = ROLES[table]
    # flow_log.trace_tree carries no universal tags, org_id among them
    scoped = any(c.name == "org_id" for c in schema.TABLES[table])
    out = [q.format(S=s, S2=s2, K=k, M=m) for q in TEMPLATES
           if scoped or "org_id" not in q]
    if e is not None:
        label = schema.TABLES[table]
        label = next(c for c in label if c.name == e).enum_values[1]
        out += [q.format(E=e, S=s, M=m, L1=label) for q in ENUM_TEMPLATES]
    return out + QUERIER_SQL.get(table, [])


CORPUS = [(t, q) for t in TABLES for q in _queries(t)]


def _rows(table: str, n: int, seed: int) -> list[dict]:
    """n rows of a table's schema from a seed: few distinct values per
    column, so filters, groups and ties all occur."""
    rng = np.random.default_rng(seed)
    rows = [dict() for _ in range(n)]
    for spec in schema.TABLES[table]:
        if spec.kind == "str":
            vals = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
        elif spec.kind == "enum":
            vals = rng.integers(0, len(spec.enum_values), n).tolist()
        elif spec.kind == "f64":
            vals = (rng.random(n) * 1000).tolist()
        elif spec.name == "time" and spec.kind == "u32":  # epoch seconds
            vals = (BASE_NS // 10**9 + rng.integers(0, 30, n)).tolist()
        elif spec.name in ("time", "end_ns"):
            vals = (BASE_NS + rng.integers(0, 30 * 10**9, n)).tolist()
        elif spec.name == "org_id":
            vals = rng.integers(1, 3, n).tolist()
        elif spec.kind == "u64":
            vals = rng.integers(0, 1000, n).tolist()
        else:
            vals = rng.integers(0, 5, n).tolist()
        for r, v in zip(rows, vals):
            r[spec.name] = v
    return rows


CHUNK_ROWS = 30


def _pair(table: str, rows: list[dict]):
    """A reference and a port table holding the same rows, appended in
    two batches into chunks of CHUNK_ROWS, so that 80 rows make two
    sealed chunks on both sides."""
    ref = RefTable(table, ref_schema.TABLES[table], chunk_rows=CHUNK_ROWS)
    port = ColumnarTable(table, schema.TABLES[table], chunk_rows=CHUNK_ROWS)
    for t in (ref, port):
        t.append_rows(rows[:len(rows) // 2])
        t.append_rows(rows[len(rows) // 2:])
    return ref, port


@pytest.fixture(scope="module")
def tables():
    return {t: _pair(t, _rows(t, 80, seed=i)) for i, t in enumerate(TABLES)}


def _same(got: dict, want: dict) -> bool:
    """Equal columns and values: ints, strings and bools exactly, floats
    to FLOAT_RTOL."""
    if got["columns"] != want["columns"] or \
            len(got["values"]) != len(want["values"]):
        return False
    for gr, wr in zip(got["values"], want["values"]):
        if len(gr) != len(wr):
            return False
        for g, w in zip(gr, wr):
            if type(g) is not type(w):
                return False
            if isinstance(g, float):
                if not (g == w or (math.isnan(g) and math.isnan(w))
                        or math.isclose(g, w, rel_tol=FLOAT_RTOL)):
                    return False
            elif g != w:
                return False
    return True


def _answer(execute, table, sql):
    try:
        return "ok", execute(table, sql).to_dict()
    except Exception as e:  # both must fail alike
        return "error", str(e)


def test_corpus_covers_every_table():
    assert len(CORPUS) >= 5 * len(TEMPLATES)
    assert {t for t, _ in CORPUS} == set(schema.TABLES)


@pytest.mark.parametrize("table,sql", CORPUS)
def test_query_like_reference(tables, table, sql):
    ref, port = tables[table]
    want = ref_engine.execute(ref, sql).to_dict()
    got = engine.execute(port, sql).to_dict()
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("table", TABLES)
def test_empty_table_like_reference(table):
    """Every corpus query over an empty table: typed empty results, the
    same as the reference's (a bare aggregate over no rows has no
    group)."""
    ref, port = _pair(table, [])
    for sql in _queries(table):
        want = ref_engine.execute(ref, sql).to_dict()
        got = engine.execute(port, sql).to_dict()
        assert _same(got, want), sql
        assert got["values"] == [], sql


@pytest.mark.parametrize("table", TABLES)
def test_decoded_path_equals_encoded(tables, table, monkeypatch):
    """DF_QUERY_ENCODED=0: the decode-then-sort path gives the encoded
    path's answer on every corpus query."""
    _, port = tables[table]
    queries = _queries(table)
    encoded = [engine.execute(port, q).to_dict() for q in queries]
    monkeypatch.setenv("DF_QUERY_ENCODED", "0")
    for q, want in zip(queries, encoded):
        assert _same(engine.execute(port, q).to_dict(), want), q


BAD_QUERIES = [
    "SELECT nope FROM t",
    "SELECT Sum(hlo_op) FROM t",
    "SELECT Sum(duration_ns) FROM t ORDER BY time",
    "SELECT Percentile(duration_ns) FROM t",
    "SELECT hlo_op FROM t WHERE hlo_op < hlo_module",
    "SELECT duration_ns FROM t WHERE duration_ns LIKE 'a%'",
    "SELECT Sum(DISTINCT duration_ns) FROM t",
    "SELECT Count(DISTINCT *) FROM t",
    "SELECT hlo_op FROM t WHERE duration_ns < 'x'",
    "SELECT nofunc(time) FROM t",
    "SELECT Sum(time) AS s FROM t WHERE Sum(time) > 1",
    "SELECT time(time) FROM t",
    "SELECT * FROM t",
    "SELECT hlo_op FROM t WHERE kind = device_id",
]


@pytest.mark.parametrize("sql", BAD_QUERIES)
def test_bad_query_fails_like_reference(tables, sql):
    ref, port = tables["profile.tpu_hlo_span"]
    want = _answer(ref_engine.execute, ref, sql)
    got = _answer(engine.execute, port, sql)
    assert want[0] == "error" and got == want
    with pytest.raises(engine.QueryError):
        engine.execute(port, sql)


def test_ranges_on_one_column_fold_into_one():
    """Conjunct ranges on a column intersect into one primitive at the
    first one's place; an empty intersection is "never"."""
    port = ColumnarTable("flow_metrics.network.1s",
                         schema.TABLES["flow_metrics.network.1s"])
    where = S.parse("SELECT byte_tx FROM t WHERE time >= 100 AND "
                    "server_port = 80 AND time < 500 AND time >= 160 "
                    "AND time <= 219").where
    assert engine._filter_prims(port, where) == [
        ("range", "time", 160, 219), ("range", "server_port", 80, 80)]
    where = S.parse("SELECT byte_tx FROM t WHERE server_port > 80 "
                    "AND server_port < 81").where
    assert engine._filter_prims(port, where) == [
        ("never", "server_port", 0, 0)]


def test_unseen_strings_match_nothing_and_order_by_collation():
    """A string the dictionary never saw matches no row in =, IN and
    LIKE (and every row in !=); ids follow insertion order, so < and
    ORDER BY over a str column go through the strings' order."""
    t = ColumnarTable("t", [ColumnSpec("s", "str"), ColumnSpec("v", "u64")])
    t.append_rows([{"s": w, "v": i} for i, w in
                   enumerate(["zeta", "alpha", "mid", "alpha", ""])])
    q = lambda sql: engine.execute(t, sql).values  # noqa: E731
    assert q("SELECT v FROM t WHERE s = 'beta'") == []
    assert q("SELECT v FROM t WHERE s IN ('beta', 'gamma')") == []
    assert q("SELECT v FROM t WHERE s LIKE 'beta%'") == []
    assert q("SELECT v FROM t WHERE s != 'beta'") == [[0], [1], [2], [3],
                                                       [4]]
    assert q("SELECT s FROM t WHERE s < 'mid'") == [["alpha"], ["alpha"],
                                                     [""]]
    assert q("SELECT s, v FROM t ORDER BY s, v DESC") == [
        ["", 4], ["alpha", 3], ["alpha", 1], ["mid", 2], ["zeta", 0]]
    assert q("SELECT s, Count() AS n FROM t GROUP BY s ORDER BY s DESC") \
        == [["zeta", 1.0], ["mid", 1.0], ["alpha", 2.0], ["", 1.0]]


def test_sums_add_in_float64_like_reference():
    """Sums add in float64 (the stand-in the engine replaced added in
    uint64): past 2**53 they round as the reference's do; enum columns
    filter, compare and decode by label."""
    cols = [("k", "enum", ("x", "y", "z")), ("v", "u64", ())]
    ref = RefTable("t", [RefSpec(n, k, e) for n, k, e in cols])
    port = ColumnarTable("t", [ColumnSpec(n, k, e) for n, k, e in cols])
    rows = [{"k": 1, "v": (1 << 64) - 1}, {"k": 1, "v": 2},
            {"k": 2, "v": (1 << 53) + 1}, {"k": 2, "v": 1}]
    for t in (ref, port):
        t.append_rows(rows)
    for sql in ("SELECT k, Sum(v) AS s, Count() AS n FROM t GROUP BY k",
                "SELECT k, Sum(v) AS s FROM t WHERE k IN ('z', 'w') "
                "GROUP BY k",
                "SELECT k FROM t WHERE k < 'z'",
                "SELECT k, v FROM t WHERE v > 1180591620717411303424"):
        assert engine.execute(port, sql).to_dict() == \
            ref_engine.execute(ref, sql).to_dict(), sql
    got = engine.execute(port, "SELECT k, Sum(v) AS s FROM t GROUP BY k")
    # uint64 addition gave 1 and 2**53 + 2 here
    assert got.values == [["y", float(2**64)], ["z", float(2**53)]]


def test_time_buckets_and_percentiles_of_one_row_groups():
    rows = [{"time": BASE_NS + s * 10**9 + 7, "duration_ns": d,
             "hlo_op": op}
            for s, d, op in ((0, 5, "a"), (9, 7, "a"), (10, 1, "b"),
                             (25, 9, "c"), (59, 4, "a"), (60, 3, "b"))]
    ref, port = _pair("profile.tpu_hlo_span", rows)
    for sql in ("SELECT time(time, 10) AS b, Count() AS n, "
                "Percentile(duration_ns, 95) AS p FROM t GROUP BY b "
                "ORDER BY b",
                "SELECT hlo_op, Percentile(duration_ns, 0) AS lo, "
                "Percentile(duration_ns, 100) AS hi, "
                "Percentile(duration_ns, 37.5) AS mid FROM t "
                "GROUP BY hlo_op",
                "SELECT time(time, 60) AS m, hlo_op, Last(duration_ns) AS l "
                "FROM t GROUP BY m, hlo_op ORDER BY m DESC, hlo_op"):
        got = engine.execute(port, sql).to_dict()
        assert _same(got, ref_engine.execute(ref, sql).to_dict()), sql
    got = engine.execute(port, "SELECT time(time, 10) AS b, "
                               "Percentile(duration_ns, 95) AS p FROM t "
                               "GROUP BY b ORDER BY b")
    assert got.values[1] == [1760000010, 1.0]  # a one-row group


# -- the catalog ---------------------------------------------------------------

@pytest.mark.parametrize("what", ["tags", "metrics"])
@pytest.mark.parametrize("table", TABLES + ("tpu_hlo_span", "tpu_memory"))
def test_show_like_reference(what, table):
    assert catalog.show(what, table) == ref_catalog.show(what, table)


def test_show_databases_and_tables_are_the_ports():
    tables = [r[0] for r in catalog.show("tables")["values"]]
    assert tables == sorted(schema.TABLES)
    ref_tables = [r[0] for r in ref_catalog.show("tables")["values"]]
    assert set(tables) <= set(ref_tables)
    assert catalog.show("databases") == {
        "columns": ["name"], "values": [["application_log"],
                                        ["deepflow_system"], ["event"],
                                        ["ext_metrics"], ["flow_log"],
                                        ["flow_metrics"], ["profile"],
                                        ["prometheus"]]}
    assert catalog.show("tags", "flow_log.trace_tree") == \
        ref_catalog.show("tags", "flow_log.trace_tree")
    assert catalog.show("tags", "event.event") == \
        ref_catalog.show("tags", "event.event")
    assert catalog.show("tags", "event.file_agg") == \
        ref_catalog.show("tags", "event.file_agg")


def test_derived_metric_rewrite_like_reference(monkeypatch):
    """The reference's rules (over the flow-metric tables) ship with the
    port; a rule given to both packages rewrites the same AST and runs
    to the same answer."""
    assert catalog.DERIVED == ref_catalog.DERIVED
    rules = {"profile.tpu_hlo_span": {
        "busy": {"AVG": ("ratio", "duration_ns", "flops"),
                 "MAX": ("col", "duration_ns"),
                 "SUM": ("sum2", "flops", "bytes_accessed")}}}
    monkeypatch.setattr(catalog, "DERIVED", rules)
    monkeypatch.setattr(ref_catalog, "DERIVED", rules)
    rows = _rows("profile.tpu_hlo_span", 40, seed=9)
    ref, port = _pair("profile.tpu_hlo_span", rows)
    cols = set(port.columns)
    for sql in ("SELECT hlo_op, Avg(busy), Max(busy) AS m, Sum(busy) "
                "FROM t GROUP BY hlo_op HAVING Avg(busy) > 0 "
                "ORDER BY Avg(busy) DESC",
                "SELECT CASE WHEN Sum(busy) > 10 THEN 'x' END AS c FROM t"):
        a = S.parse(sql)
        b = ref_sql.parse(sql)
        for ia, ib in zip(a.items, b.items):
            assert _dump(catalog.rewrite_derived(ia.expr, port.name, cols)) \
                == _dump(ref_catalog.rewrite_derived(ib.expr, ref.name,
                                                     cols))
        assert _same(engine.execute(port, sql).to_dict(),
                     ref_engine.execute(ref, sql).to_dict()), sql
    assert catalog.show("metrics", port.name) == \
        ref_catalog.show("metrics", port.name)
    sql = "SELECT Min(busy) FROM t"
    assert _answer(engine.execute, port, sql) == \
        _answer(ref_engine.execute, ref, sql)
    with pytest.raises(engine.QueryError, match="not defined"):
        engine.execute(port, sql)


# -- property test over a small grammar ------------------------------------

PROP_COLS = [("k16", "u16", ()), ("ks", "str", ()),
             ("ke", "enum", ("up", "down", "device-x")), ("v64", "u64", ())]
PROP_WORDS = ("", "a", "ab", "b", "gemm", "nccl")
PROP_NAMES = ("k16", "ks", "ke", "v64")
_prop_row = st.fixed_dictionaries({
    "k16": st.integers(0, 3) | st.integers(0, 65535),
    "ks": st.sampled_from(PROP_WORDS),
    "ke": st.integers(0, 2),
    # the reference adds in float64: keep sums of 40 summands exact
    "v64": st.integers(0, (1 << 40) - 1),
})


def conditions(names, words, labels, big):
    """WHERE conditions over a small int tag, a str column, an enum column
    and a u64 metric (``names``): = != < <= > >= IN LIKE on the string,
    comparisons on the ints, = on the enum, joined by AND, OR and NOT.
    Words and labels include ones no row holds."""
    k16, ks, ke, v64 = names
    word = st.sampled_from(tuple(words) + ("absent", "zz"))
    atom = st.one_of(
        word.map(lambda w: f"{ks} = '{w}'"),
        word.map(lambda w: f"{ks} != '{w}'"),
        st.tuples(st.sampled_from(["<", "<=", ">", ">="]), word).map(
            lambda p: f"{ks} {p[0]} '{p[1]}'"),
        st.lists(word, min_size=1, max_size=3).map(
            lambda ws: f"{ks} IN (" + ", ".join(f"'{w}'" for w in ws)
            + ")"),
        st.sampled_from(["a%", "%b", "_", "%", "g_mm", "zz%", "%e%"]).map(
            lambda p: f"{ks} LIKE '{p}'"),
        st.integers(0, 65535).map(lambda x: f"{k16} < {x}"),
        st.integers(0, 4).map(lambda x: f"{k16} = {x}"),
        st.sampled_from(tuple(labels) + ("gone",)).map(
            lambda w: f"{ke} = '{w}'"),
        st.integers(0, big).map(lambda x: f"{v64} > {x}"),
    )
    return st.recursive(
        atom, lambda inner: st.one_of(
            st.tuples(inner, inner).map(lambda p: f"({p[0]} AND {p[1]})"),
            st.tuples(inner, inner).map(lambda p: f"({p[0]} OR {p[1]})"),
            inner.map(lambda c: f"NOT ({c})")),
        max_leaves=4)


def _tail(order, limit) -> str:
    out = ""
    if order:
        out += " ORDER BY " + ", ".join(f"{c}{' DESC' if d else ''}"
                                        for c, d in order)
    return out + (f" LIMIT {limit}" if limit is not None else "")


def group_queries(table, names, words, labels, big):
    """SELECT <keys>, Sum(<metric>) AS s, Count() AS n ... GROUP BY <keys>
    with an optional WHERE, HAVING, ORDER BY and LIMIT."""
    k16, ks, ke, v64 = names

    def build(keys, where, having, order, limit):
        order = [(c, d) for c, d in order if c in ("s", "n", *keys)]
        return (f"SELECT {', '.join(keys)}, Sum({v64}) AS s, Count() AS n "
                f"FROM {table}" + (f" WHERE {where}" if where else "")
                + f" GROUP BY {', '.join(keys)}"
                + (f" HAVING {having}" if having else "")
                + _tail(order, limit))
    return st.builds(
        build,
        st.lists(st.sampled_from([k16, ks, ke]), min_size=1, max_size=3,
                 unique=True),
        st.none() | conditions(names, words, labels, big),
        st.none() | st.integers(0, 3).map(lambda h: f"Count() > {h}")
        | st.integers(0, 2 * big).map(lambda x: f"Sum({v64}) >= {x}"),
        st.lists(st.tuples(st.sampled_from(["s", "n", k16, ks, ke]),
                           st.booleans()), max_size=2),
        st.none() | st.integers(0, 6))


def select_queries(table, names, words, labels, big):
    """SELECT <the four columns> with an optional WHERE, ORDER BY and
    LIMIT."""
    return st.builds(
        lambda where, order, limit: (
            f"SELECT {', '.join(names)} FROM {table}"
            + (f" WHERE {where}" if where else "") + _tail(order, limit)),
        st.none() | conditions(names, words, labels, big),
        st.lists(st.tuples(st.sampled_from(names), st.booleans()),
                 max_size=2),
        st.none() | st.integers(0, 6))


def _prop_tables(rows):
    """The rows in two batches, each of eight rows or more sealing a
    chunk on both sides."""
    ref = RefTable("t", [RefSpec(*c) for c in PROP_COLS], chunk_rows=8)
    port = ColumnarTable("t", [ColumnSpec(*c) for c in PROP_COLS],
                         chunk_rows=8)
    for t in (ref, port):
        t.append_rows(rows[:len(rows) // 2])
        t.append_rows(rows[len(rows) // 2:])
    return ref, port


_PROP = ("t", PROP_NAMES, PROP_WORDS, PROP_COLS[2][2], 1 << 40)


@settings(max_examples=60, deadline=None)
@given(rows=st.lists(_prop_row, max_size=40), sql=group_queries(*_PROP))
def test_group_queries_like_reference(rows, sql):
    ref, port = _prop_tables(rows)
    assert engine.execute(port, sql).to_dict() == \
        ref_engine.execute(ref, sql).to_dict()


@settings(max_examples=60, deadline=None)
@given(rows=st.lists(_prop_row, max_size=40), sql=select_queries(*_PROP))
def test_select_queries_like_reference(rows, sql):
    ref, port = _prop_tables(rows)
    assert engine.execute(port, sql).to_dict() == \
        ref_engine.execute(ref, sql).to_dict()


# -- concurrency ---------------------------------------------------------------

def test_query_during_appends_sees_whole_batches():
    """Batches of 50 rows, each with a run_id and an op string of its
    own, append while queries run: every group a query sees is a whole
    batch, and ORDER BY over the growing dictionary sorts by the
    strings."""
    t = ColumnarTable("profile.tpu_hlo_span",
                      schema.TABLES["profile.tpu_hlo_span"])
    batches, per = 150, 50
    stop = threading.Event()

    def writer():
        for b in range(batches):
            t.append_columns({"run_id": np.full(per, b, dtype=np.uint32),
                              "hlo_op": [f"op{b:04d}"] * per,
                              "duration_ns": np.arange(per)}, per)
        stop.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=writer)
        th.start()
        seen = 0
        while not stop.is_set() or seen < batches:
            res = engine.execute(
                t, "SELECT hlo_op, run_id, Count() AS n, "
                   "Sum(duration_ns) AS s FROM t GROUP BY hlo_op, run_id "
                   "ORDER BY hlo_op DESC").values
            assert all(n == per and s == per * (per - 1) / 2
                       for _, _, n, s in res)
            assert [r[0] for r in res] == sorted((r[0] for r in res),
                                                 reverse=True)
            assert [r[1] for r in res] == list(range(len(res)))[::-1]
            seen = len(res)
        th.join(timeout=30)
        assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert seen == batches and len(t) == batches * per

