"""The port's query cache held against the JAX package's on the CPU.

The same seeded span rows go into a reference ``ColumnarTable`` and a
port one, each behind its own ``QueryCache``; the same sequence of
queries and writes must give the same answers and the same counters.
A hit must be exact: after an append only the touched 60 s buckets are
scanned again, and after a janitor trim or a dictionary compaction the
next identical query must equal a fresh scan. DF_QUERY_CACHE=0 bypasses
the cache, DF_QUERY_CACHE_MIN_NS keeps cheap answers out of it, and the
``query.cache`` hop ledger accounts for every lookup.
"""

import numpy as np
import pytest

import test_torch_query_parallel as tqp
from deepflow_tpu.query.cache import QueryCache as RefCache
from deepflow_tpu.query.cache import change_token as ref_change_token
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.query.cache import QueryCache, change_token
from deepflow_tpu_torch.query.costmodel import KernelCostModel
from deepflow_tpu_torch.telemetry import Telemetry

BASE_NS, MINUTE = tqp.BASE_NS, tqp.MINUTE
SQL = ("SELECT hlo_op, Count() AS n, Sum(duration_ns) AS d FROM t "
       "GROUP BY hlo_op ORDER BY n DESC, hlo_op")


def _caches(rows=None, chunk_rows=97):
    ref, port = tqp._pair(rows if rows is not None
                          else tqp._rows(600, seed=11, minutes=3),
                          chunk_rows=chunk_rows)
    return ref, port, RefCache(), QueryCache()


def _both(ref, port, rc, pc, sql=SQL):
    """The port's cached answer, held equal to the reference's cached
    answer and to a fresh scan of the port's table."""
    got = pc.execute(port, sql).to_dict()
    assert got == rc.execute(ref, sql).to_dict()
    assert got == engine.execute(port, sql).to_dict()
    return got


def test_exact_bucket_invalidation_like_reference():
    ref, port, rc, pc = _caches()
    r1 = _both(ref, port, rc, pc)
    nb = len(port.bucket_marks()[1])
    assert pc.counters["misses"] == 1
    assert pc.counters["bucket_misses"] == nb >= 3  # all cold
    r2 = _both(ref, port, rc, pc)
    assert pc.counters["hits"] == 1 and r2 == r1
    # an append into bucket 1 only: the whole result goes stale, and the
    # bucket layer re-scans exactly that bucket
    row = {"time": BASE_NS + MINUTE + 5, "hlo_op": "gemm",
           "duration_ns": 7}
    for t in (ref, port):
        t.append_rows([row])
    r3 = _both(ref, port, rc, pc)
    assert pc.counters["stale"] == 1
    assert pc.counters["bucket_misses"] == nb + 1
    assert pc.counters["bucket_hits"] == nb - 1
    old = {v[0]: v for v in r1["values"]}
    new = {v[0]: v for v in r3["values"]}
    assert new["gemm"][1:] == [old["gemm"][1] + 1, old["gemm"][2] + 7]
    assert pc.counters == rc.counters


@pytest.mark.parametrize("how", ["serial", "pool"])
def test_bucket_refill_either_way_like_reference(how, monkeypatch):
    """Stale buckets refill one after another or on the scan pool, as
    the table's refill model chooses: the reference's answers and
    counters either way, and the time observed for the way taken."""
    monkeypatch.setenv("DF_QUERY_THREADS", "4")
    ref, port, rc, pc = _caches()
    model = KernelCostModel(kernels=("serial", "pool"))
    model.choose = lambda n: how
    pc._refill[port.name] = model
    before = qpool.stats()["dispatched"]
    _both(ref, port, rc, pc)
    # the pool counts each bucket it took; the serial loop none
    assert (qpool.stats()["dispatched"] > before) == (how == "pool")
    assert pc.counters["bucket_misses"] == len(port.bucket_marks()[1]) >= 3
    other = "pool" if how == "serial" else "serial"
    assert model.coef[how] > 0 and model.coef[other] is None
    assert pc.counters == rc.counters


@pytest.mark.parametrize("rows,first", [(600, "serial"), (1200, "pool")])
def test_bucket_refill_measures_both_ways_first(rows, first, monkeypatch):
    """A table's first cold fill refills serially under four morsels of
    rows and on the pool from four up, its second the other way; from
    then on the cheaper prediction is taken."""
    monkeypatch.setenv("DF_QUERY_THREADS", "4")
    monkeypatch.setenv("DF_QUERY_MORSEL_ROWS", "256")  # four: 1,024 rows
    ref, port, rc, pc = _caches(tqp._rows(rows, seed=11, minutes=3))
    _both(ref, port, rc, pc)
    model = pc._refill[port.name]
    second = "pool" if first == "serial" else "serial"
    assert model.coef[first] > 0 and model.coef[second] is None
    _both(ref, port, rc, pc, SQL + " LIMIT 5")
    assert model.coef[second] > 0
    assert pc.counters == rc.counters


def test_bypass_and_change_token_like_reference(monkeypatch):
    ref, port, rc, pc = _caches()
    assert change_token(port) == ref_change_token(ref)
    tok = change_token(port)
    monkeypatch.setenv("DF_QUERY_CACHE", "0")
    _both(ref, port, rc, pc, "SELECT Count() AS n FROM t")
    assert pc.counters["bypass"] == 1 and pc.snapshot()["entries"] == 0
    monkeypatch.delenv("DF_QUERY_CACHE")
    # dictionary growth without a row write must NOT change the token
    port.dicts["hlo_op"].encode("never-written-to-a-row")
    assert change_token(port) == tok
    for t in (ref, port):
        t.append_rows([{"time": BASE_NS, "hlo_op": "x"}])
    assert change_token(port) != tok
    assert change_token(port)[0] == ref_change_token(ref)[0]


@pytest.mark.parametrize("sql", [
    SQL,
    "SELECT kind, Avg(bytes_accessed) AS a, Max(flops) AS f FROM t "
    "WHERE run_id < 20 GROUP BY kind HAVING Count() > 3",
    "SELECT Count(DISTINCT hlo_module) AS u, Min(duration_ns) AS lo FROM t",
    # not bucketable: the whole-result layer only
    "SELECT hlo_op, Percentile(duration_ns, 50) AS p FROM t GROUP BY hlo_op",
    "SELECT hlo_op, Last(run_id) AS l FROM t GROUP BY hlo_op",
    "SELECT hlo_op, duration_ns FROM t WHERE run_id = 3 ORDER BY "
    "duration_ns DESC, hlo_op LIMIT 4",
])
def test_trim_between_identical_queries(sql):
    """A janitor trim drops whole sealed chunks and re-marks every bucket
    it reached: the next identical query equals a fresh scan, in both
    packages."""
    ref, port, rc, pc = _caches(chunk_rows=100)
    before = _both(ref, port, rc, pc, sql)
    cutoff = BASE_NS + MINUTE + MINUTE // 2
    dropped = port.trim_before("time", cutoff)
    assert dropped == ref.trim_before("time", cutoff) > 0
    after = _both(ref, port, rc, pc, sql)
    assert pc.counters["stale"] == 1 and pc.counters == rc.counters
    if "Count(DISTINCT" not in sql and "Last(" not in sql:
        assert after != before


def test_trim_rescans_only_the_buckets_it_reached():
    ref, port, rc, pc = _caches(chunk_rows=100)
    _both(ref, port, rc, pc)
    marks = port.bucket_marks()[1]
    assert pc.counters["bucket_misses"] == len(marks)
    cutoff = BASE_NS + MINUTE + MINUTE // 2
    for t in (ref, port):
        assert t.trim_before("time", cutoff) > 0
    _both(ref, port, rc, pc)
    # the buckets at or below the cutoff's are re-marked; the rest hold
    reached = sum(b <= cutoff // MINUTE for b in marks)
    assert 0 < reached < len(marks)
    assert pc.counters["bucket_misses"] == len(marks) + reached
    assert pc.counters["bucket_hits"] == len(marks) - reached
    assert pc.counters == rc.counters


def test_compaction_between_identical_queries():
    """A dictionary compaction rebinds ids (gen + 1) without a row write:
    the cached result and every cached bucket partial go stale, and the
    next identical query equals a fresh scan and the answer before."""
    rng = np.random.default_rng(5)
    rows = tqp._rows(800, seed=12, minutes=3)
    for i, r in enumerate(rows):  # many strings, most in the early rows
        r["hlo_op"] = (f"early-{i}" if r["time"] < BASE_NS + MINUTE
                       else f"k{int(rng.integers(0, 6))}")
    ref, port, rc, pc = _caches(rows, chunk_rows=50)
    sql = ("SELECT hlo_op, Count() AS n, Sum(duration_ns) AS d FROM t "
           "WHERE time >= " + str(BASE_NS + MINUTE) + " GROUP BY hlo_op "
           "ORDER BY hlo_op")
    first = _both(ref, port, rc, pc, sql)
    for t in (ref, port):
        assert t.trim_before("time", BASE_NS + MINUTE) > 0
    trimmed = _both(ref, port, rc, pc, sql)
    assert trimmed == first  # the trim dropped no row the query reads
    gen = port.dicts["hlo_op"].gen
    stats = port.compact_dictionaries(min_entries=16)
    assert stats == ref.compact_dictionaries(min_entries=16)
    assert stats["hlo_op"]["after"] < stats["hlo_op"]["before"]
    assert port.dicts["hlo_op"].gen == gen + 1
    stale = pc.counters["stale"]
    misses = pc.counters["bucket_misses"]
    again = _both(ref, port, rc, pc, sql)
    assert again == first
    assert pc.counters["stale"] == stale + 1
    # every bucket partial encoded the old ids: all scanned again
    assert pc.counters["bucket_misses"] == misses + len(
        port.bucket_marks()[1])
    assert pc.counters == rc.counters


def test_admission_floor_keeps_cheap_answers_out(monkeypatch):
    ref, port, rc, pc = _caches()
    monkeypatch.setenv("DF_QUERY_CACHE_MIN_NS", str(10**15))
    _both(ref, port, rc, pc)
    _both(ref, port, rc, pc)
    assert pc.counters["misses"] == 2 and pc.counters["hits"] == 0
    assert pc.snapshot()["entries"] == 0
    assert pc.snapshot()["cost"]["ns_per_row"]["cold"] > 0
    monkeypatch.delenv("DF_QUERY_CACHE_MIN_NS")
    _both(ref, port, rc, pc)
    _both(ref, port, rc, pc)
    assert pc.counters["hits"] == 1 and pc.counters == rc.counters


def test_lru_evicts_past_max_entries():
    ref, port = tqp._pair(tqp._rows(200, seed=2, minutes=1))
    pc, rc = QueryCache(max_entries=2), RefCache(max_entries=2)
    for k in range(4):
        _both(ref, port, rc, pc, f"SELECT Count() AS n FROM t WHERE "
                                 f"run_id >= {k}")
    assert pc.snapshot()["entries"] == 2
    assert pc.counters["evictions"] == rc.counters["evictions"] > 0


def test_org_scoped_variants_do_not_collide():
    _, port, _, pc = _caches()
    scoped = engine.S.parse(SQL)
    scoped.where = engine.S.BinOp("=", engine.S.Col("org_id"),
                                  engine.S.Lit(2))
    a = pc.execute(port, SQL).to_dict()
    b = pc.execute(port, SQL, select=scoped, extra_key=("org", 2)).to_dict()
    assert a["values"] and b["values"] == []
    assert pc.execute(port, SQL).to_dict() == a
    assert pc.counters["hits"] == 1


def test_hop_ledger_accounts_every_lookup(monkeypatch):
    tel = Telemetry("server")
    ref, port = tqp._pair(tqp._rows(300, seed=4, minutes=2))
    pc = QueryCache(telemetry=tel)
    pc.execute(port, SQL)                       # miss
    pc.execute(port, SQL)                       # hit
    port.append_rows([{"time": BASE_NS, "hlo_op": "add"}])
    pc.execute(port, SQL)                       # stale
    monkeypatch.setenv("DF_QUERY_CACHE", "0")
    pc.execute(port, SQL)                       # bypass
    hop = tel.hop("query.cache").snapshot()
    assert hop["emitted"] == 4 and hop["delivered"] == 1
    assert hop["dropped"] == {"miss": 1, "stale": 1, "bypass": 1}
    assert hop["in_flight"] == 0


def test_answers_while_rows_append():
    """Appends racing a cached query: each answer equals a fresh scan
    of the rows written before it, never a mix of two states."""
    import threading
    ref, port, rc, pc = _caches(tqp._rows(400, seed=9, minutes=3))
    late = tqp._rows(400, seed=10, minutes=3)
    stop = threading.Event()

    def writer():
        for i in range(0, 400, 20):
            port.append_rows(late[i:i + 20])
        stop.set()
    th = threading.Thread(target=writer)
    th.start()
    seen = 0
    while not stop.is_set() or seen < 3:
        n_before = len(port)
        got = pc.execute(port, "SELECT Count() AS n FROM t").to_dict()
        n = got["values"][0][0]
        assert n_before <= n <= len(port) and n % 20 == 0
        seen += 1
    th.join()
    assert pc.execute(port, SQL).to_dict() == engine.execute(
        port, SQL).to_dict()
