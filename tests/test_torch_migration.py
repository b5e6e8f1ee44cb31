"""The port's schema migration, crash-safe save and npz persistence held
against the JAX package's.

The reference's cases (``tests/test_migration.py``) run on both
packages with the same outcomes; a data dir saved by either package
loads in the other with the same rows; and ``migrate_segments`` drains a
tier of v1 segments online in both, to the same answers.
"""

import json
import os
import shutil
import time
import types

import numpy as np
import pytest

from deepflow_tpu.query import execute as ref_execute
from deepflow_tpu.server.janitor import Janitor as RefJanitor
from deepflow_tpu.store import migration as ref_migration
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu.store.table import ColumnarTable as RefTable
from deepflow_tpu.store.table import ColumnSpec as RefSpec
from deepflow_tpu_torch.query.engine import execute
from deepflow_tpu_torch.server.janitor import Janitor
from deepflow_tpu_torch.store import migration
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.table import ColumnarTable, ColumnSpec

import test_torch_segment as tseg

REF = types.SimpleNamespace(
    name="ref", migration=ref_migration, Database=RefDatabase,
    Table=RefTable, Spec=RefSpec, Janitor=RefJanitor, execute=ref_execute)
PORT = types.SimpleNamespace(
    name="port", migration=migration, Database=Database,
    Table=ColumnarTable, Spec=ColumnSpec, Janitor=Janitor, execute=execute)
PKGS = [REF, PORT]


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


def test_versions_and_chain_like_reference():
    assert migration.SCHEMA_VERSION == ref_migration.SCHEMA_VERSION
    assert migration.SEGMENT_FORMAT == ref_migration.SEGMENT_FORMAT
    assert migration.MANIFEST == ref_migration.MANIFEST
    assert {k: len(v) for k, v in migration.MIGRATIONS.items()} == \
        {k: len(v) for k, v in ref_migration.MIGRATIONS.items()}


@pytest.mark.parametrize("old", [1, 2, 3])
def test_migrate_chunk_like_reference(old, monkeypatch):
    """The same op chain over the same chunk gives the same chunk."""
    chain = {1: [("Rename", ("t.demo", "latency", "rtt")),
                 ("Retype", ("t.demo", "rtt", np.uint64))],
             2: [("Drop", ("t.demo", "gone"))]}
    outs = []
    for mod in (ref_migration, migration):
        for v, ops in chain.items():
            monkeypatch.setitem(mod.MIGRATIONS, v,
                                [getattr(mod, k)(*a) for k, a in ops])
        ch = {"time": np.arange(3, dtype=np.uint64),
              "latency": np.array([1, 2, 3], dtype=np.uint32),
              "gone": np.zeros(3, dtype=np.uint8)}
        out = mod.migrate_chunk("t.demo", ch, old)
        outs.append({k: (str(v.dtype), v.tolist()) for k, v in out.items()})
    assert outs[0] == outs[1]


def test_v1_dir_loads_into_v2_schema(tmp_path, monkeypatch, pkg):
    v1 = pkg.Table("t.demo", [pkg.Spec("time", "u64"),
                              pkg.Spec("latency", "u32")], chunk_rows=4)
    v1.append_columns({"time": [1, 2], "latency": [10, 20]})
    v1.flush()
    d = str(tmp_path / "t" / "demo")
    v1.save(d)
    assert pkg.migration.read_manifest_version(str(tmp_path)) == 1
    monkeypatch.setitem(pkg.migration.MIGRATIONS, 1, [
        pkg.migration.Rename("t.demo", "latency", "rtt"),
        pkg.migration.Retype("t.demo", "rtt", np.uint64)])
    v2 = pkg.Table("t.demo", [pkg.Spec("time", "u64"),
                              pkg.Spec("rtt", "u64"),
                              pkg.Spec("added", "str")], chunk_rows=4)
    v2.load(d, from_version=1)
    out = v2.column_concat(["time", "rtt", "added"])
    assert out["rtt"].tolist() == [10, 20]
    assert out["rtt"].dtype == np.uint64
    assert out["added"].tolist() == [0, 0]


def test_manifest_written_and_version_gate(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path))
    db.table("flow_log.l4_flow_log").append_rows([{"time": 1, "flow_id": 7}])
    db.flush()
    db.save()
    mf = json.load(open(tmp_path / "MANIFEST.json"))
    assert mf["schema_version"] == pkg.migration.SCHEMA_VERSION
    json.dump({"schema_version": pkg.migration.SCHEMA_VERSION + 5},
              open(tmp_path / "MANIFEST.json", "w"))
    with pytest.raises(RuntimeError):
        pkg.Database(data_dir=str(tmp_path)).load()


def test_crash_during_save_keeps_old_state(tmp_path, pkg):
    cols = [pkg.Spec("time", "u64"), pkg.Spec("v", "u32")]
    d = str(tmp_path / "t")
    t = pkg.Table("t", cols, chunk_rows=2)
    t.append_columns({"time": [1, 2], "v": [1, 2]})
    t.flush()
    t.save(d)
    staging = d + ".staging"
    os.makedirs(staging)
    open(os.path.join(staging, "chunk_000000.npz"), "wb").write(b"garbage")
    t2 = pkg.Table("t", cols, chunk_rows=2)
    t2.load(d)
    assert t2.column_concat(["time"])["time"].tolist() == [1, 2]
    assert not os.path.isdir(staging)
    t.save(d)
    os.rename(d, d + ".old")
    t3 = pkg.Table("t", cols, chunk_rows=2)
    t3.load(d)
    assert t3.column_concat(["time"])["time"].tolist() == [1, 2]
    assert os.path.isdir(d) and not os.path.isdir(d + ".old")
    t.save(d)
    shutil.copytree(d, d + ".old")
    t4 = pkg.Table("t", cols, chunk_rows=2)
    t4.load(d)
    assert t4.column_concat(["time"])["time"].tolist() == [1, 2]
    assert not os.path.isdir(d + ".old")


def test_save_load_roundtrip_through_database(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path))
    db.table("flow_log.l4_flow_log").append_rows(
        [{"time": 5, "flow_id": 9, "ip_src": "1.2.3.4"}])
    db.flush()
    db.save()
    db2 = pkg.Database(data_dir=str(tmp_path))
    db2.load()
    out = db2.table("flow_log.l4_flow_log").column_concat(["flow_id"])
    assert out["flow_id"].tolist() == [9]


def test_janitor_trims_by_ttl(pkg):
    db = pkg.Database()
    t = db.table("flow_log.l4_flow_log")
    now = time.time()
    t.append_rows([{"time": int((now - 10 * 86400) * 1e9), "flow_id": 1}] * 4)
    t.flush()
    t.append_rows([{"time": int(now * 1e9), "flow_id": 2}] * 2)
    t.flush()
    j = pkg.Janitor(db)
    assert j.sweep(now_s=now) == 4
    assert len(t) == 2
    assert j.stats["rows_trimmed"] == 4 and j.stats["sweeps"] == 1


SQL = ["SELECT ip_src, Count() AS c, Sum(flow_id) AS s FROM t "
       "GROUP BY ip_src ORDER BY ip_src",
       "SELECT Max(time) AS t FROM t WHERE ip_src = '10.0.0.3'"]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_each_package_loads_the_others_save(tmp_path, writer, reader):
    """A data dir saved at a clean stop (npz, no tier) by one package
    loads in the other with the same answers."""
    db = writer.Database(data_dir=str(tmp_path), chunk_rows=50)
    t = db.table("flow_log.l4_flow_log")
    t.append_rows([{"time": 1000 + i, "flow_id": i,
                    "ip_src": f"10.0.0.{i % 7}"} for i in range(180)])
    db.flush()
    want = [writer.execute(t, s).values for s in SQL]
    db.save()
    other = reader.Database(data_dir=str(tmp_path))
    other.load()
    t2 = other.table("flow_log.l4_flow_log")
    assert len(t2) == 180
    assert [reader.execute(t2, s).values for s in SQL] == want


def test_segment_format_counts_and_online_migration(tmp_path, pkg):
    """migrate_segments drains a tier of v1 segments to v2 online, to the
    same answers, in both packages (the same counts each)."""
    db = tseg.seed_db(tseg.REF if pkg is REF else tseg.PORT,
                      str(tmp_path / "db"), n_flushes=4, v1=True)
    ns = tseg.REF if pkg is REF else tseg.PORT
    want = tseg.golden(ns, db)
    assert pkg.migration.segment_format_counts(db.tier_store) == {1: 4}
    out = pkg.migration.migrate_segments(db)
    assert out["v1_remaining"] == 0 and out["segments_migrated"] == 4
    assert pkg.migration.segment_format_counts(db.tier_store) == {2: 1}
    assert tseg.golden(ns, db) == want
    again = pkg.migration.migrate_segments(db)
    assert again["runs_built"] == 0 and again["tables"] == 0
