"""The port's flow-metric rollups and transparent datasource selection
held against the JAX package on the CPU.

The same 1 s rows of ``flow_metrics.network.1s`` and
``flow_metrics.application.1s``, made from a numpy seed over two days,
go into both packages' stores; each package's ``RollupJob.roll(now_s)``
writes its 1m, 1h and 1d tiers, and every tier's rows must be equal
(the latency sketches' JSON included; as sets of rows, since the
reference's pool threads append through stripes of their own, in no
fixed order), as must the completeness
horizons, for a first roll and for a second one after more rows. Then
``select_rollup`` and ``sketch_percentile`` must pick the same tier for
each query of a corpus (aligned and unaligned windows, tags, time
buckets, the aggregates that decompose and those that do not), a
picked tier's answer must equal the 1 s table's, and the querier must
answer from the tier with the datasource in its debug block and in
EXPLAIN's plan.
"""

import json

import numpy as np
import pytest

from deepflow_tpu.query import datasource as ref_qds
from deepflow_tpu.query import engine as ref_engine
from deepflow_tpu.query import sql as ref_sql
from deepflow_tpu.server.datasource import RollupJob as RefRollupJob
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch.query import datasource as qds
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.server.datasource import FAMILIES, RollupJob
from deepflow_tpu_torch.server.querier import QuerierAPI
from deepflow_tpu_torch.store.db import Database
from test_torch_retention import _table_rows

DAY = 86400
T0 = 1_760_000_000 // DAY * DAY  # a day boundary, epoch s
NOW_1 = T0 + DAY + 5 * 3600      # first roll: a day and five hours in
NOW_2 = T0 + 2 * DAY + 600       # second roll, after more rows
TIERS = [f"{fam}.{sfx}" for fam in FAMILIES for sfx in ("1m", "1h", "1d")]


def _rows(seed: int, lo: int, hi: int):
    """Network and application rows every 37 s in [lo, hi): two hosts,
    two ports, some rows of a second org."""
    rng = np.random.default_rng(seed)
    net, app = [], []
    for t in range(lo, hi, 37):
        for host in ("h1", "h2"):
            base = {"time": t, "host": host, "ip_src": "10.0.0.1",
                    "ip_dst": f"10.0.1.{1 + (t // 37) % 2}",
                    "server_port": int(rng.choice([80, 443])),
                    "org_id": 1 if rng.random() < 0.9 else 2}
            net.append({**base, "protocol": 1, "direction": 1,
                        "byte_tx": int(rng.integers(0, 10**6)),
                        "packet_tx": int(rng.integers(0, 900)),
                        "rtt_sum": int(rng.integers(0, 10**5)),
                        "rtt_count": int(rng.integers(0, 9))})
            app.append({**base, "l7_protocol": 1, "app_service": "shop",
                        "request": int(rng.integers(1, 50)),
                        "error_server": int(rng.integers(0, 3)),
                        "rrt_sum": int(rng.integers(0, 10**6)),
                        "rrt_count": int(rng.integers(1, 50)),
                        "rrt_max": int(rng.integers(1, 10**5))})
    return net, app


def _rows_of(db, name: str) -> list[tuple]:
    """The tier's rows, each latency sketch's JSON state as its sorted
    dump: the order of its buckets is the order the rows were merged in,
    which neither package fixes (the scan pool's presence changes it)."""
    t = db.table(name)
    rows = _table_rows(t)
    if "rrt_max_sketch" in t.columns:
        k = list(t.columns).index("rrt_max_sketch")
        rows = [r[:k] + (json.dumps(json.loads(r[k]), sort_keys=True)
                         if r[k] else "",) + r[k + 1:] for r in rows]
    return sorted(rows)


def _fill(dbs, lo: int, hi: int, seed: int) -> None:
    net, app = _rows(seed, lo, hi)
    for db in dbs:
        db.table("flow_metrics.network.1s").append_rows(net)
        db.table("flow_metrics.application.1s").append_rows(app)


@pytest.fixture(scope="module")
def rolled():
    """Both stores filled and rolled twice; the jobs kept."""
    ref_db, db = RefDatabase(), Database()
    ref_job, job = RefRollupJob(ref_db), RollupJob(db)
    _fill((ref_db, db), T0, NOW_1, seed=0)
    first = (ref_job.roll(NOW_1), job.roll(NOW_1))
    snap = {name: (_rows_of(ref_db, name), _rows_of(db, name))
            for name in TIERS}
    _fill((ref_db, db), NOW_1, NOW_2, seed=1)
    second = (ref_job.roll(NOW_2), job.roll(NOW_2))
    return ref_db, db, ref_job, job, first, second, snap


def test_first_roll_equals_reference(rolled):
    *_, first, _, snap = rolled
    assert first[0] == first[1] > 0
    for name, (want, got) in snap.items():
        assert got == want, name
    assert all(snap[f"{f}.1d"][1] for f in FAMILIES)  # a whole day rolled


@pytest.mark.parametrize("name", TIERS)
def test_second_roll_equals_reference(rolled, name):
    ref_db, db, ref_job, job, _, second, _ = rolled
    assert second[0] == second[1] > 0
    got = _rows_of(db, name)
    assert got == _rows_of(ref_db, name) and got
    assert job.horizons() == ref_job.horizons()
    assert job.stats == {k: ref_job.stats[k] for k in job.stats}


def test_a_restarted_job_resumes_at_the_tiers_rows(rolled):
    """A new job over rolled tiers starts from their last bucket: it
    rolls nothing twice, as the reference's."""
    ref_db, db, *_ = rolled
    assert RollupJob(db).horizons() == RefRollupJob(ref_db).horizons()
    assert RollupJob(db).roll(NOW_2) == 0


H = 3600
SQL = [
    # whole days and hours: the coarsest aligned tier
    f"SELECT Sum(byte_tx) AS b FROM t WHERE time >= {T0} "
    f"AND time < {T0 + DAY}",
    f"SELECT host, Sum(request) AS r, Max(rrt_max) AS m FROM t "
    f"WHERE time >= {T0 + H} AND time < {T0 + 20 * H} GROUP BY host "
    "ORDER BY host",
    f"SELECT time(time, 3600) AS h, Sum(byte_tx) AS b FROM t "
    f"WHERE time >= {T0} AND time < {T0 + 6 * H} "
    "GROUP BY time(time, 3600) ORDER BY h",
    f"SELECT server_port, Sum(rrt_sum) / Sum(rrt_count) AS avg_rrt FROM t "
    f"WHERE time >= {T0 + 2 * H} AND time < {T0 + 5 * H} AND host = 'h1' "
    "GROUP BY server_port ORDER BY server_port",
    f"SELECT Min(rrt_max) AS lo FROM t WHERE time >= {T0} "
    f"AND time < {T0 + 2 * H}",
    # minute-aligned windows and buckets: 1m
    f"SELECT Sum(packet_tx) AS p FROM t WHERE time >= {T0 + 120} "
    f"AND time < {T0 + 3 * H}",
    f"SELECT time(time, 300) AS m, Sum(request) AS r FROM t "
    f"WHERE time >= {T0} AND time < {T0 + H} GROUP BY time(time, 300) "
    "ORDER BY m",
    # raw only: unaligned, no upper bound, Avg, Count, a raw timestamp,
    # a window past the horizon
    f"SELECT Sum(byte_tx) AS b FROM t WHERE time >= {T0 + 7} "
    f"AND time < {T0 + H}",
    f"SELECT Sum(byte_tx) AS b FROM t WHERE time >= {T0}",
    f"SELECT Avg(byte_tx) AS a FROM t WHERE time >= {T0} "
    f"AND time < {T0 + H}",
    f"SELECT Count() AS n FROM t WHERE time >= {T0} AND time < {T0 + H}",
    f"SELECT time, byte_tx FROM t WHERE time >= {T0} AND time < {T0 + 60}",
    f"SELECT Sum(byte_tx) AS b FROM t WHERE time >= {T0} "
    f"AND time < {NOW_2 + DAY}",
]


def _family_table(db, sql: str):
    fam = ("flow_metrics.application.1s" if any(
        c in sql for c in ("request", "rrt_")) else "flow_metrics.network.1s")
    return db.table(fam)


@pytest.mark.parametrize("sql", SQL)
def test_select_rollup_picks_the_reference_tier(rolled, sql):
    ref_db, db, ref_job, job, *_ = rolled
    want = ref_qds.select_rollup(ref_db, _family_table(ref_db, sql),
                                 ref_sql.parse(sql), ref_job.horizons())
    got = qds.select_rollup(db, _family_table(db, sql), S.parse(sql),
                            job.horizons())
    assert (got is None) == (want is None)
    raw = _family_table(db, sql)
    if got is None:
        return
    table, info = got
    assert table.name == want[0].name and info == want[1]
    # the tier's answer is the raw table's, and the reference's
    answer = engine.execute(table, sql).to_dict()
    assert answer == engine.execute(raw, sql).to_dict()
    assert answer == ref_engine.execute(want[0], sql).to_dict()


def test_corpus_reaches_every_tier_and_raw(rolled):
    ref_db, db, ref_job, job, *_ = rolled
    picked = set()
    for sql in SQL:
        got = qds.select_rollup(db, _family_table(db, sql), S.parse(sql),
                                job.horizons())
        picked.add(None if got is None else got[1]["tier"])
    assert picked == {None, "1m", "1h", "1d"}


@pytest.mark.parametrize("p", [50, 90, 99])
def test_sketch_percentile_equals_reference(rolled, p):
    ref_db, db, ref_job, job, *_ = rolled
    sql = (f"SELECT host, Percentile(rrt_max, {p}) AS q FROM t "
           f"WHERE time >= {T0} AND time < {T0 + DAY} GROUP BY host")
    want = ref_qds.sketch_percentile(
        ref_db, ref_db.table("flow_metrics.application.1s"),
        ref_sql.parse(sql), ref_job.horizons())
    got = qds.sketch_percentile(db, db.table("flow_metrics.application.1s"),
                                S.parse(sql), job.horizons())
    assert got[0].to_dict() == want[0].to_dict() and got[1] == want[1]
    assert got[1]["tier"] == "1d" and len(got[0].values) == 2


def test_querier_answers_from_the_tier_and_explains_it(rolled):
    """/v1/query over the raw table answers from the picked tier with
    the datasource in its debug block; EXPLAIN's plan names it; the
    answer equals the same query on the 1 s table with no rollup job."""
    _, db, _, job, *_ = rolled
    api = QuerierAPI(db, rollup=job)
    plain = QuerierAPI(db)
    sql = SQL[1].replace("FROM t", "FROM application")
    got = api.query({"db": "flow_metrics", "sql": sql})
    assert got["debug"]["datasource"]["tier"] == "1h"
    assert got["debug"]["table"] == "flow_metrics.application.1h"
    want = plain.query({"db": "flow_metrics", "sql": sql})
    assert got["result"] == want["result"]
    assert "datasource" not in want["debug"]
    for kw in ("EXPLAIN", "EXPLAIN ANALYZE"):
        ex = api.query({"db": "flow_metrics", "sql": f"{kw} {sql}"})
        assert "flow_metrics.application.1h" in ex["explain"]["plan"][
            "datasource"]
        assert ex["explain"]["plan"]["table"] == \
            "flow_metrics.application.1h"


def test_rollup_slivers_fold_into_runs_with_storage(tmp_path):
    """With storage on, each roll that wrote rows compacts the rollup
    tables' tier: the 1m slivers flushed after earlier rolls fold into a
    sorted run, as the reference's do (``stats["compact_runs"]``), and
    the 1m answers equal a store's without a tier."""
    sql = ("SELECT host, server_port, Sum(byte_tx) AS b, Count() AS n "
           "FROM t GROUP BY host, server_port ORDER BY host, server_port")
    out = []
    for Db, Job, run in ((RefDatabase, RefRollupJob, ref_engine.execute),
                         (Database, RollupJob, engine.execute)):
        db = Db(data_dir=str(tmp_path / Db.__module__), storage=True)
        job = Job(db)
        segs = []
        for h in range(3):
            lo, hi = T0 + h * 3600, T0 + (h + 1) * 3600
            _fill((db,), lo, hi, seed=10 + h)
            job.roll(hi + 600)
            db.flush_to_tier()
            segs.append(db.table("flow_metrics.network.1m").tier
                        .segment_count())
        got = run(db.table("flow_metrics.network.1m"), sql).values
        out.append((job.stats["compact_runs"], segs, got))
    plain = Database()
    plain_job = RollupJob(plain)
    for h in range(3):
        _fill((plain,), T0 + h * 3600, T0 + (h + 1) * 3600, seed=10 + h)
        plain_job.roll(T0 + (h + 1) * 3600 + 600)
    want = engine.execute(plain.table("flow_metrics.network.1m"), sql)
    assert out[1] == out[0]
    runs, segs, got = out[1]
    assert runs >= 1 and segs[1] == 2 and segs[2] < 3
    assert got == want.values and got
