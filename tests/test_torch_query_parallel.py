"""The port's partial aggregates, morsel-parallel scans and native query
kernels held against the JAX package's on the CPU.

The same seeded span rows go into a reference ``ColumnarTable`` and a
port one. ``execute_partial`` / ``combine_partials`` / ``merge_partials``
must give the reference's partials and answers for every aggregate the
reference supports; the morsel-parallel path must give the serial
path's bytes at 1, 2, 4 and 8 threads and two morsel sizes, and must
really run on the pool; each native kernel of ``native/qexec.cpp`` must
equal the reference's native kernel and the numpy expression it
replaces, and the engine must give the same bytes with every kernel
choice forced either way.
"""

import json

import numpy as np
import pytest

import test_torch_sql as tsql
from deepflow_tpu import native as ref_native
from deepflow_tpu.query import engine as ref_engine
from deepflow_tpu.store import schema as ref_schema
from deepflow_tpu.store.table import ColumnarTable as RefTable
from deepflow_tpu_torch import native
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.query.costmodel import KernelCostModel
from deepflow_tpu_torch.store import schema
from deepflow_tpu_torch.store.table import ColumnarTable

SPAN = "profile.tpu_hlo_span"
BASE_NS = tsql.BASE_NS
MINUTE = 60 * 10**9


def _rows(n: int, seed: int, minutes: int = 5) -> list[dict]:
    """Span rows over several 60 s buckets: few distinct kernels, runs
    and kinds, so groups, filters and ties all occur."""
    rng = np.random.default_rng(seed)
    t = BASE_NS + np.sort(rng.integers(0, minutes * MINUTE, n))
    kinds = schema.TPU_SPAN_KINDS
    return [{"time": int(t[i]),
             "hlo_op": tsql.WORDS[int(rng.integers(0, len(tsql.WORDS)))],
             "hlo_module": f"m{int(rng.integers(0, 3))}",
             "kind": int(rng.integers(0, len(kinds))),  # the label's index
             "run_id": int(rng.integers(0, 40)),
             "device_id": int(rng.integers(0, 4)),
             "duration_ns": int(rng.integers(0, 10**6)),
             "bytes_accessed": int(rng.integers(0, 10**9)),
             "flops": int(rng.integers(0, 10**12))} for i in range(n)]


def _pair(rows: list[dict], chunk_rows: int = 97):
    ref = RefTable(SPAN, ref_schema.TABLES[SPAN], chunk_rows=chunk_rows)
    port = ColumnarTable(SPAN, schema.TABLES[SPAN], chunk_rows=chunk_rows)
    for t in (ref, port):
        for i in range(0, len(rows), 50):
            t.append_rows(rows[i:i + 50])
    return ref, port


@pytest.fixture(scope="module")
def tables():
    return _pair(_rows(1200, seed=7))


# -- partial aggregates --------------------------------------------------------

AGGREGATES = {
    "count": "Count()",
    "count_distinct_str": "Count(DISTINCT hlo_module)",
    "count_distinct_int": "Count(DISTINCT device_id)",
    "sum": "Sum(duration_ns)",
    "sum_expr": "Sum(duration_ns * 2 - device_id)",
    "avg": "Avg(bytes_accessed)",
    "min": "Min(duration_ns)",
    "max": "Max(flops)",
    "last": "Last(hlo_module)",
    "percentile": "Percentile(duration_ns, 90)",
}


def _agg_sql(agg: str, where: str = "") -> str:
    return (f"SELECT hlo_op, kind, {AGGREGATES[agg]} AS a, Count() AS n "
            f"FROM t {where}GROUP BY hlo_op, kind HAVING Count() > 1 "
            "ORDER BY a DESC, hlo_op, kind LIMIT 20")


def _canon(x) -> str:
    return json.dumps(x, sort_keys=True, default=lambda a: a.tolist())


@pytest.mark.parametrize("agg", AGGREGATES)
def test_decoded_partial_and_merge_like_reference(tables, agg):
    """A partial per half of the rows, decoded: the reference's states,
    and the reference's merged answer."""
    ref, port = tables
    cut = BASE_NS + 2 * MINUTE + 7
    halves = [f"WHERE time < {cut} ", f"WHERE time >= {cut} "]
    got = [engine.execute_partial(port, _agg_sql(agg, w)) for w in halves]
    want = [ref_engine.execute_partial(ref, _agg_sql(agg, w))
            for w in halves]
    assert _canon(got) == _canon(want)
    sql = _agg_sql(agg)
    res = engine.merge_partials(port, sql, got).to_dict()
    assert res == ref_engine.merge_partials(ref, sql, want).to_dict()
    if agg not in ("last", "percentile"):  # exact merges: the one scan
        assert tsql._same(res, engine.execute(port, sql).to_dict())


@pytest.mark.parametrize("agg", AGGREGATES)
def test_encoded_combine_and_merge_like_reference(tables, agg):
    """Encoded partials of the 60 s buckets folded by combine_partials
    and reduced by merge_partials: the reference's answer, and for the
    exact aggregates the serial scan's; what cannot fold exactly refuses
    to in both."""
    ref, port = tables
    sql = _agg_sql(agg)

    def bucket_parts(eng, t):
        return [eng.execute_partial(
            t, _agg_sql(agg, f"WHERE time >= {BASE_NS + b * MINUTE} AND "
                             f"time < {BASE_NS + (b + 1) * MINUTE} "),
            encoded=True) for b in range(5)]
    got, want = bucket_parts(engine, port), bucket_parts(ref_engine, ref)
    assert [p["n_groups"] for p in got] == [p["n_groups"] for p in want]
    # LAST does not fold, nor COUNT(DISTINCT) over a column that has no
    # dictionary (its partial keeps decoded value lists)
    if agg in ("last", "count_distinct_int"):
        with pytest.raises(engine._FastUnsupported):
            engine.combine_partials(port, sql, got)
        with pytest.raises(ref_engine._FastUnsupported):
            ref_engine.combine_partials(ref, sql, want)
        return
    one = engine.combine_partials(port, sql, got)
    ref_one = ref_engine.combine_partials(ref, sql, want)
    assert one["n_groups"] == ref_one["n_groups"]
    res = engine.merge_partials(port, sql, [one]).to_dict()
    assert res == ref_engine.merge_partials(ref, sql, [ref_one]).to_dict()
    if agg != "percentile":
        assert res == engine.execute(port, sql).to_dict()


def test_row_partials_push_down_order_and_limit(tables):
    ref, port = tables
    sql = "SELECT hlo_op, duration_ns FROM t ORDER BY duration_ns DESC LIMIT 5"
    got = engine.execute_partial(port, sql)
    assert got == ref_engine.execute_partial(ref, sql)
    assert got["kind"] == "rows" and len(got["values"]) == 5
    merged = engine.merge_partials(port, sql, [got, got]).to_dict()
    assert merged == ref_engine.merge_partials(ref, sql, [got, got]).to_dict()


def test_encoded_partial_carries_the_views_dictionary_state(tables):
    _, port = tables
    part = engine.execute_partial(
        port, "SELECT hlo_module, Count() AS n FROM t GROUP BY hlo_module",
        encoded=True)
    d = port.dicts["hlo_module"]
    assert part["dicts"] == {"hlo_module": [d.gen, len(d)]}
    assert part["keys"][0]["e"] == "hlo_module"


# -- morsel-parallel scans -----------------------------------------------------

PARALLEL_SQL = [
    "SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n, Max(flops) AS f "
    "FROM t GROUP BY hlo_op",
    "SELECT kind, Avg(bytes_accessed) AS a FROM t GROUP BY kind "
    "HAVING Avg(bytes_accessed) > 1000 ORDER BY kind",
    "SELECT hlo_op, Sum(duration_ns) AS d FROM t WHERE kind = "
    "'device-compute' GROUP BY hlo_op ORDER BY d DESC, hlo_op LIMIT 3",
    "SELECT time(time, 60) AS m, Count() AS c, Min(duration_ns) AS lo FROM t "
    "WHERE hlo_op = 'gemm' GROUP BY time(time, 60) ORDER BY m",
    "SELECT run_id, Count(DISTINCT hlo_op) AS u FROM t GROUP BY run_id",
    "SELECT hlo_op, Sum(duration_ns) AS d FROM t WHERE hlo_op LIKE 'a%' "
    "OR run_id > 30 GROUP BY hlo_op ORDER BY hlo_op",
    # planner-rejected: serial, and still the same bytes
    "SELECT hlo_op, Percentile(duration_ns, 95) AS p FROM t GROUP BY hlo_op",
    "SELECT hlo_op, Last(run_id) AS l FROM t GROUP BY hlo_op",
    "SELECT Count() AS n, Sum(duration_ns) AS d FROM t WHERE run_id >= 7 "
    "AND run_id < 20",
]


@pytest.mark.parametrize("morsel", ["256", "1000"])
def test_thread_sweep_byte_identical(tables, monkeypatch, morsel):
    """DF_QUERY_THREADS in {1, 2, 4, 8}: the same bytes as the serial
    scan, which gives the reference's answers."""
    ref, port = tables
    monkeypatch.setenv("DF_QUERY_PARALLEL", "1")
    monkeypatch.setenv("DF_QUERY_MORSEL_ROWS", morsel)
    baseline = None
    for threads in ("1", "2", "4", "8"):
        monkeypatch.setenv("DF_QUERY_THREADS", threads)
        got = json.dumps([engine.execute(port, sql).to_dict()
                          for sql in PARALLEL_SQL])
        if baseline is None:
            baseline = got
        assert got == baseline, f"threads={threads} diverged"
    for sql, res in zip(PARALLEL_SQL, json.loads(baseline)):
        assert tsql._same(res, ref_engine.execute(ref, sql).to_dict()), sql


def test_parallel_path_actually_taken(tables, monkeypatch):
    """The sweep proves identity; this proves the pool ran, with the
    morsel count and degree on the scan's trace span."""
    from deepflow_tpu_torch.query import qtrace
    _, port = tables
    monkeypatch.setenv("DF_QUERY_PARALLEL", "1")
    monkeypatch.setenv("DF_QUERY_THREADS", "2")
    monkeypatch.setenv("DF_QUERY_MORSEL_ROWS", "256")
    before = qpool.stats()["dispatched"]
    tr = qtrace.QueryTracer(sink=None)
    with tr.start_trace("query", capture=True) as root:
        engine.execute(port, PARALLEL_SQL[0])
    assert qpool.stats()["dispatched"] > before
    scan = next(d for d in root.trace_spans() if d["name"] == f"scan {SPAN}")
    assert scan["attrs"]["mode"] == "parallel"
    assert scan["attrs"]["degree"] == 2
    assert scan["attrs"]["morsels"] == sum(
        -(-len(ch["time"]) // 256) for ch in port.snapshot())


def test_parallel_scan_during_appends_sees_whole_view(monkeypatch):
    """Rows appended while a morsel-parallel query runs are not in its
    view: the answer over the rows written before equals the serial one."""
    _, port = _pair(_rows(900, seed=3))
    sql = ("SELECT hlo_op, Sum(duration_ns) AS d FROM t WHERE time < "
           f"{BASE_NS + 5 * MINUTE} GROUP BY hlo_op")
    want = engine.execute(port, sql).to_dict()
    monkeypatch.setenv("DF_QUERY_PARALLEL", "1")
    monkeypatch.setenv("DF_QUERY_THREADS", "4")
    monkeypatch.setenv("DF_QUERY_MORSEL_ROWS", "256")
    late = [dict(r, time=r["time"] + 10 * MINUTE) for r in _rows(300, 4)]
    for i in range(0, 300, 30):
        port.append_rows(late[i:i + 30])
        assert engine.execute(port, sql).to_dict() == want


def test_small_tables_stay_serial_unless_forced(tables, monkeypatch):
    _, port = tables
    monkeypatch.delenv("DF_QUERY_PARALLEL", raising=False)
    monkeypatch.setenv("DF_QUERY_THREADS", "4")
    view = port.view()
    q = engine._normalize(view, engine.S.parse(PARALLEL_SQL[0]))
    assert engine._plan_parallel(view, q) is None  # under two morsels
    monkeypatch.setenv("DF_QUERY_PARALLEL", "1")
    assert engine._plan_parallel(view, q)[0] == "parallel"
    monkeypatch.setenv("DF_QUERY_THREADS", "1")
    assert engine._plan_parallel(view, q) is None


# -- native kernels --------------------------------------------------------------

def _keys(rng, n):
    return [rng.integers(0, 7, n), rng.integers(-3, 3, n).astype(np.int64),
            rng.integers(0, 2**40, n) % 5]


def test_qx_group_equals_reference_and_numpy():
    rng = np.random.default_rng(1)
    keys = _keys(rng, 5000)
    order, bounds, ng = native.qx_group(keys)
    r_order, r_bounds, r_ng = ref_native.qx_group(keys)
    assert ng == r_ng and (order == r_order).all() \
        and (bounds == r_bounds).all()
    # numpy: the first-occurrence grouping of the engine's lexsort path
    stack = np.stack(keys, axis=1)
    _, first, inv = np.unique(stack, axis=0, return_index=True,
                              return_inverse=True)
    rank = np.argsort(np.argsort(first))  # group id by first occurrence
    want = np.argsort(rank[inv.ravel()], kind="stable")
    assert ng == len(first) and (order == want).all()
    assert (np.diff(bounds) == np.bincount(rank[inv.ravel()])).all()


@pytest.mark.parametrize("op,ufunc", [(0, np.add), (1, np.minimum),
                                      (2, np.maximum)])
@pytest.mark.parametrize("values", ["integers", "floats"])
def test_qx_agg_f64_equals_reference_and_numpy(op, ufunc, values):
    """Bit for bit: the reference's kernel, and numpy's row-order
    accumulation of each group. numpy's reduceat gives the same bits for
    integer values (every sum exact below 2**53), MIN and MAX, but not
    for float sums: it adds a segment pairwise, the kernel in row order
    (the reference's docstring, engine.py:362-366, claims reduceat's
    bits; ROADMAP notes on the reference)."""
    rng = np.random.default_rng(2 + op)
    if values == "integers":
        vals = rng.integers(0, 10**9, 4000).astype(np.float64)
    else:
        vals = rng.standard_normal(4000) * 10.0**rng.integers(-8, 8, 4000)
        vals[::97] = np.nan if op else 0.0
    order = rng.permutation(4000).astype(np.int64)
    bounds = np.unique(np.concatenate(
        [[0, 4000], rng.integers(1, 4000, 300)])).astype(np.int64)
    got = native.qx_agg_f64(vals, order, bounds, op)
    assert got.tobytes() == ref_native.qx_agg_f64(
        vals, order, bounds, op).tobytes()
    g = vals[order]
    in_order = np.array([ufunc.accumulate(g[a:b])[-1]
                         for a, b in zip(bounds[:-1], bounds[1:])])
    assert got.tobytes() == in_order.tobytes()
    reduceat = ufunc.reduceat(g, bounds[:-1])
    if values == "integers" or op:
        assert got.tobytes() == reduceat.tobytes()
    else:
        assert np.allclose(got, reduceat, rtol=1e-12, atol=0,
                           equal_nan=True)


@pytest.mark.parametrize("dtype", ["u1", "i1", "u2", "i2", "u4", "i4", "u8",
                                   "i8"])
def test_qx_sel_range_and_gather_equal_reference_and_numpy(dtype):
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    col = rng.integers(info.min, info.max, 3000, dtype=dtype,
                       endpoint=True)
    lo, hi = sorted(rng.integers(info.min, info.max, 2, dtype=dtype))
    for a, b in ((lo, hi), (info.min, hi), (lo, info.max), (hi, lo)):
        got = native.qx_sel_range(col, a, b)
        want = np.nonzero((col >= a) & (col <= b))[0].astype(np.uint64)
        assert got.dtype == np.uint64 and (got == want).all()
        assert (got == ref_native.qx_sel_range(col, a, b)).all()
        gathered = native.qx_gather(col, got)
        assert gathered.dtype == col.dtype and (gathered == col[got]).all()
        assert (gathered == ref_native.qx_gather(col, got)).all()


@pytest.mark.parametrize("n_set", [0, 1, 5, 300])
def test_qx_isin_kernels_equal_reference_and_numpy(n_set):
    rng = np.random.default_rng(4 + n_set)
    col = rng.integers(0, 500, 4000).astype(np.uint32)
    ids = rng.integers(0, 600, n_set).astype(np.uint32)
    mask = np.isin(col, ids)
    got = native.qx_isin_u32(col, ids)
    assert got.dtype == bool and (got == mask).all()
    assert (got == ref_native.qx_isin_u32(col, ids)).all()
    pos = native.qx_sel_isin(col, ids)
    assert (pos == np.nonzero(mask)[0]).all()
    assert (pos == ref_native.qx_sel_isin(col, ids)).all()


def test_qx_kernels_refuse_bad_arguments():
    with pytest.raises(ValueError):
        native.qx_sel_range(np.zeros(3, np.float64), 0, 1)
    with pytest.raises(IndexError):
        native.qx_gather(np.arange(3), np.array([5], np.uint64))
    with pytest.raises(ValueError):
        native.qx_agg_f64(np.zeros(2), np.array([0, 5]), np.array([0, 2]),
                          0)


class _Forced(KernelCostModel):
    """A cost model whose choice is fixed: one kernel, every call."""

    def __init__(self, kernel: str) -> None:
        super().__init__()
        self.kernel = kernel

    def choose(self, n: int) -> str:
        return self.kernel


def test_engine_gives_the_same_bytes_with_each_kernel_forced(tables,
                                                             monkeypatch):
    """The group and filter kernels forced native, then numpy, serial
    and morsel-parallel: the same bytes, which give the reference's
    answers; forced native really ran the native kernels."""
    ref, port = tables
    corpus = PARALLEL_SQL + [q for t, q in tsql.CORPUS if t == SPAN]
    calls = {"qx_group": 0, "qx_sel_isin": 0, "qx_sel_range": 0}
    for name in calls:
        def counted(*a, _f=getattr(native, name), _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(native, name, counted)
    monkeypatch.setenv("DF_QUERY_MORSEL_ROWS", "256")
    monkeypatch.setenv("DF_QUERY_THREADS", "4")
    answers = {}
    for kernel in ("native", "numpy"):
        monkeypatch.setattr(engine, "_COST", _Forced(kernel))
        monkeypatch.setattr(engine, "_FILT", _Forced(kernel))
        for par in ("0", "1"):
            monkeypatch.setenv("DF_QUERY_PARALLEL", par)
            out = []
            for sql in corpus:
                try:
                    out.append(engine.execute(port, sql).to_dict())
                except engine.QueryError as e:
                    out.append(str(e))
            answers[kernel, par] = json.dumps(out)
        if kernel == "native":
            assert all(calls.values()), calls
            seen = dict(calls)
        else:
            assert calls == seen, "numpy forced: no native kernel ran"
    assert len(set(answers.values())) == 1
    for sql, got in zip(corpus, json.loads(answers["numpy", "0"])):
        if isinstance(got, dict):
            assert tsql._same(got, ref_engine.execute(ref, sql).to_dict())
