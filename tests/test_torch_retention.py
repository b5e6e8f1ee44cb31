"""The port's retention and multi-chunk reads held against the JAX
package's on the CPU.

The same rows, clock and ``chunk_rows``, appended in the same batches
from one thread, go into a reference and a port table or database:
``trim_before`` and ``Janitor.sweep(now_s=...)`` must drop the same
rows, rows newer than the cutoff stay, and after a trim
``compact_dictionaries`` changes no answer. The server's frames decoded
into databases of many sealed chunks give the reference's rows and its
answers to the profile queries, before and after a sweep whose cutoff
falls mid-window. A writer, a janitor and readers running at once keep
every answer whole.
"""

import sys
import threading

import numpy as np
import pytest

import test_torch_server as tsrv
import test_torch_sql as tsql

from deepflow_tpu.codec import StreamDecoder as RefStreamDecoder
from deepflow_tpu.query import engine as ref_engine
from deepflow_tpu.server import decoders as ref_decoders
from deepflow_tpu.server.janitor import Janitor as RefJanitor
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu.server.querier import QuerierAPI as RefQuerierAPI
from deepflow_tpu.store import schema as ref_schema
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu.store.table import ColumnarTable as RefTable
from deepflow_tpu.telemetry import Telemetry as RefTelemetry
from deepflow_tpu_torch.codec import StreamDecoder
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.server import decoders
from deepflow_tpu_torch.server.janitor import DEFAULT_TTL_S, Janitor
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.querier import QuerierAPI
from deepflow_tpu_torch.store import schema
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.table import ColumnarTable

DAY_NS = 86400 * 10**9
NOW_NS = 1_760_000_000 * 10**9
TTL_TABLES = sorted(DEFAULT_TTL_S)
PROFILE_DECODERS = ("ProfileDecoder", "TpuSpanDecoder",
                    "StepMetricsDecoder", "StatsDecoder")


def _per_unit(table: str) -> int:
    """ns per unit of a table's time column, as the janitor reads it:
    u64 nanoseconds, u32 epoch seconds (the flow-metric tables)."""
    kind = next(c.kind for c in schema.TABLES[table] if c.name == "time")
    return 1 if kind == "u64" else 10**9


def _dated_rows(table: str, n: int, seed: int, days: float = 10.0,
                unique_from: int | None = None) -> list[dict]:
    """tsql's seeded rows of a table, their times rising evenly over the
    `days` before NOW_NS; rows from `unique_from` on take a string of
    their own in every str column (dictionary entries a trim kills)."""
    rows = tsql._rows(table, n, seed)
    step = int(days * DAY_NS) // max(1, n)
    for i, r in enumerate(rows):
        r["time"] = (NOW_NS - int(days * DAY_NS) + i * step) \
            // _per_unit(table)
        if unique_from is not None and i < unique_from:
            for spec in schema.TABLES[table]:
                if spec.kind == "str":
                    r[spec.name] = f"{spec.name}-{i}"
    return rows


def _batches(n: int, seed: int) -> list[tuple[int, int]]:
    """(start, end) of append batches of 5-40 rows over n rows."""
    rng = np.random.default_rng(seed)
    out, i = [], 0
    while i < n:
        j = min(n, i + int(rng.integers(5, 41)))
        out.append((i, j))
        i = j
    return out


def _table_rows(t) -> list[tuple]:
    """Every row in storage order, strings decoded."""
    names = list(t.columns)
    cols = t.column_concat(names)
    dec = [t.dicts[c].decode_many(cols[c]) if c in t.dicts
           else cols[c].tolist() for c in names]
    return list(zip(*dec))


def _pair(table: str, rows: list[dict], chunk_rows: int, seed: int):
    ref = RefTable(table, ref_schema.TABLES[table], chunk_rows=chunk_rows)
    port = ColumnarTable(table, schema.TABLES[table], chunk_rows=chunk_rows)
    for i, j in _batches(len(rows), seed):
        ref.append_rows(rows[i:j])
        port.append_rows(rows[i:j])
    return ref, port


@pytest.mark.parametrize("table", TTL_TABLES)
@pytest.mark.parametrize("chunk_rows", [1, 37, 100])
def test_trim_before_drops_what_reference_drops(table, chunk_rows):
    rows = _dated_rows(table, 400, seed=chunk_rows)
    ref, port = _pair(table, rows, chunk_rows, seed=chunk_rows)
    assert len(port.snapshot()) > 1
    for days_ago in (11, 9.5, 7, 7, 3.2, 0.5, 0):
        cutoff = (NOW_NS - int(days_ago * DAY_NS)) // _per_unit(table)
        dropped = port.trim_before("time", cutoff)
        assert dropped == ref.trim_before("time", cutoff), days_ago
        assert len(port) == len(ref) == sum(
            len(ch["time"]) for ch in port.snapshot())
        got = _table_rows(port)
        assert got == _table_rows(ref)
        # rows at or after the cutoff all stay
        assert sum(r["time"] >= cutoff for r in rows) <= len(got)
    # the open buffer is never trimmed (batches hold at most 40 rows)
    assert (len(port) > 0) == (chunk_rows > 40)


def _databases(chunk_rows: int) -> tuple[Database, RefDatabase]:
    port = Database(chunk_rows=chunk_rows)
    ref = RefDatabase(chunk_rows=chunk_rows)
    for i, table in enumerate(schema.TABLES):
        rows = _dated_rows(table, 300, seed=i)
        for a, b in _batches(len(rows), seed=i):
            port.table(table).append_rows(rows[a:b])
            ref.table(table).append_rows(rows[a:b])
    return port, ref


def test_janitor_sweep_drops_what_reference_drops():
    """The default TTLs over ten days of rows in every table: both
    janitors trim the same rows at each sweep, tables the reference has
    no TTL for keep every row, and the stats count the trims."""
    port_db, ref_db = _databases(chunk_rows=16)
    port_j, ref_j = Janitor(port_db), RefJanitor(ref_db)
    now_s = NOW_NS / 1e9
    total = 0
    for later_days in (0, 1.5, 4, 4, 8):
        now = now_s + later_days * 86400
        got = port_j.sweep(now_s=now)
        assert got == ref_j.sweep(now_s=now), later_days
        total += got
        for name in schema.TABLES:
            assert len(port_db.table(name)) == len(ref_db.table(name))
            assert _table_rows(port_db.table(name)) == \
                _table_rows(ref_db.table(name)), name
    assert total > 0
    assert port_j.stats["sweeps"] == 5
    assert port_j.stats["rows_trimmed"] == total == \
        ref_j.stats["rows_trimmed"]
    for name in ("profile.tpu_memory", "profile.tpu_step_metrics"):
        assert name not in DEFAULT_TTL_S and len(port_db.table(name)) == 300


@pytest.mark.parametrize("table", TTL_TABLES)
def test_compaction_after_trim_changes_no_answer(table):
    """Old rows with strings of their own are trimmed; compacting the
    dictionaries then shrinks them and leaves every corpus query's
    answer as it was, and equal to the reference's after its own
    compaction."""
    rows = _dated_rows(table, 400, seed=5, unique_from=200)
    ref, port = _pair(table, rows, 40, seed=5)
    cutoff = (NOW_NS - 4 * DAY_NS) // _per_unit(table)
    assert port.trim_before("time", cutoff) == \
        ref.trim_before("time", cutoff) > 150
    queries = tsql._queries(table)
    before = [tsql._answer(engine.execute, port, q) for q in queries]
    sizes = {c: len(d) for c, d in port.dicts.items()}
    stats = port.compact_dictionaries(min_entries=8, max_live_frac=0.9)
    want_stats = ref.compact_dictionaries(min_entries=8, max_live_frac=0.9)
    assert stats == want_stats and stats
    assert all(len(port.dicts[c]) < sizes[c] for c in stats)
    after = [tsql._answer(engine.execute, port, q) for q in queries]
    for q, b, a in zip(queries, before, after):
        assert b[0] == a[0] and (a[0] == "error" and a == b
                                 or tsql._same(a[1], b[1])), q
        want = tsql._answer(ref_engine.execute, ref, q)
        assert want[0] == a[0] and (a[0] == "error"
                                    or tsql._same(a[1], want[1])), q
    assert _table_rows(port) == _table_rows(ref)


# -- the server's frames over many chunks -------------------------------------

CHUNK = 6


def _decoded_dbs(frames) -> tuple[Database, RefDatabase]:
    """The frames through each package's four profile decoders, in
    order from this thread, into databases of CHUNK-row chunks."""
    port_db, ref_db = Database(chunk_rows=CHUNK), RefDatabase(
        chunk_rows=CHUNK)
    mine = {c.MSG_TYPE: c(None, port_db, PlatformInfoTable())
            for c in (getattr(decoders, n) for n in PROFILE_DECODERS)}
    tel = RefTelemetry("server", enabled=False)
    theirs = {}
    for c in (getattr(ref_decoders, n) for n in PROFILE_DECODERS):
        d = theirs[c.MSG_TYPE] = c(None, ref_db, RefPlatform(),
                                   telemetry=tel)
        d._hop = tel.hop(f"decoder.{c.MSG_TYPE.name}")
        d._tw_hop = tel.hop("table_write")
    data = b"".join(frames)
    for header, payload in StreamDecoder().feed(data):
        mine[header.msg_type]._handle_items([(header, payload)])
    for header, payload in RefStreamDecoder().feed(data):
        theirs[header.msg_type]._handle_items([(header, payload)])
    assert mine[decoders.TpuSpanDecoder.MSG_TYPE].stats["pure_batches"] == 0
    assert all(d.stats["errors"] == 0 for d in mine.values())
    return port_db, ref_db


@pytest.fixture(scope="module")
def frames():
    return tsrv._frames()


def _same_answers(port_db, ref_db):
    port_api, ref_api = QuerierAPI(port_db), RefQuerierAPI(ref_db)
    for method in tsrv.QUERIES:
        for body in tsrv._bodies():
            assert tsrv._answer(port_api, method, body) == \
                tsrv._answer(ref_api, method, body), (method, body)


def test_many_chunks_give_reference_rows_and_answers(frames):
    port_db, ref_db = _decoded_dbs(frames[0])
    spans = port_db.table("profile.tpu_hlo_span")
    assert len(spans.snapshot()) >= 3 and len(spans._chunks) >= 2
    for name in schema.TABLES:  # a stats batch's maps have no order
        assert sorted(_table_rows(port_db.table(name))) == \
            sorted(_table_rows(ref_db.table(name))), name
    _same_answers(port_db, ref_db)


def test_sweep_mid_window_keeps_reference_rows_and_answers(frames):
    """A sweep whose cutoff falls inside the frames' time window trims
    the same chunks as the reference's, keeps every row at or after the
    cutoff, and the profile queries over what stays, and after a
    compaction, answer as the reference's."""
    port_db, ref_db = _decoded_dbs(frames[0])
    t = port_db.table("profile.tpu_hlo_span")
    times = t.column_concat(["time"])["time"]
    # just past the first sealed chunk's newest row (float seconds keep
    # the janitor's cutoff to within a microsecond)
    cutoff_ns = int(t.snapshot()[0]["time"].max()) + 10_000
    assert times.min() < cutoff_ns < times.max()
    ttl = {name: 3600 for name in DEFAULT_TTL_S}
    now_s = cutoff_ns / 1e9 + 3600
    got = Janitor(port_db, ttl_s=ttl).sweep(now_s=now_s)
    assert got == RefJanitor(ref_db, ttl_s=ttl).sweep(now_s=now_s) > 0
    cutoff = int((now_s - 3600) * 1e9)
    left = t.column_concat(["time"])["time"]
    assert 0 < len(left) < len(times)
    assert (times >= cutoff).sum() <= len(left)
    # what stays is every row from the oldest kept chunk's first row on
    assert left.tolist() == times[len(times) - len(left):].tolist()
    for name in schema.TABLES:  # a stats batch's maps have no order
        assert sorted(_table_rows(port_db.table(name))) == \
            sorted(_table_rows(ref_db.table(name))), name
    _same_answers(port_db, ref_db)
    for db in (port_db, ref_db):
        for name in schema.TABLES:
            db.table(name).compact_dictionaries(min_entries=1,
                                                max_live_frac=1.0)
    _same_answers(port_db, ref_db)


# -- concurrency -------------------------------------------------------------

def test_writer_janitor_and_readers_at_once_see_whole_batches():
    """Batches of 20 rows, each with a run_id and an op string of its
    own, append into 60-row chunks while a thread trims old chunks and
    compacts the dictionaries and two readers query: every group a
    query sees is a whole batch whose op string is its own, and the
    row count always equals the rows in the chunks."""
    t = ColumnarTable("profile.tpu_hlo_span",
                      schema.TABLES["profile.tpu_hlo_span"], chunk_rows=60)
    batches, per = 400, 20
    done = threading.Event()
    errors: list[BaseException] = []

    def writer():
        for b in range(batches):
            t.append_columns({"time": np.full(per, b, dtype=np.uint64),
                              "run_id": np.full(per, b, dtype=np.uint32),
                              "hlo_op": [f"op{b:04d}"] * per,
                              "duration_ns": np.arange(per)}, per)
        done.set()

    def janitor():
        while not done.is_set():
            t.trim_before("time", max(0, len(t) // per - 100))
            t.compact_dictionaries(min_entries=2, max_live_frac=0.95)

    def reader():
        try:
            while not done.is_set():
                res = engine.execute(
                    t, "SELECT hlo_op, run_id, Count() AS n FROM t "
                       "GROUP BY hlo_op, run_id").values
                assert all(n == per and op == f"op{r:04d}"
                           for op, r, n in res), res[:3]
                v = t.view()
                assert sum(len(ch["time"]) for ch in v.chunks) % per == 0
        except BaseException as e:  # reported below
            errors.append(e)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f)
                   for f in (writer, janitor, reader, reader)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(t) == sum(len(ch["time"]) for ch in t.snapshot())
    assert len(t) < batches * per
    res = engine.execute(t, "SELECT Max(run_id) AS m FROM t").values
    assert res == [[batches - 1]]
