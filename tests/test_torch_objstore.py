"""The port's object store and segment publisher against the
reference's: the same rows published by both packages give the same
pointer document, key for key, and the same blob bytes; the publisher's
no-op tick, its blob GC after the swap, and the ``objstore_eio`` chaos
hook behave alike."""

import importlib
import json
import os
import types

import numpy as np
import pytest

TBL = "flow_log.l7_flow_log"
SPAN = "profile.tpu_hlo_span"
BASE_NS = 1_754_000_000_000_000_000
PKGS = ("deepflow_tpu", "deepflow_tpu_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    obj = m("store.objstore")
    return types.SimpleNamespace(
        name=name, objstore=obj, ObjStore=obj.ObjStore,
        SegmentPublisher=obj.SegmentPublisher, chaos=m("chaos"),
        Database=m("store.db").Database)


@pytest.fixture(scope="module")
def pkgs():
    return [_pkg(n) for n in PKGS]


def _both(pkgs, tmp_path, fn):
    out = []
    for P in pkgs:
        d = tmp_path / P.name
        d.mkdir()
        out.append(fn(P, d))
    return out


def l7_rows(n0: int, n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed + n0)
    svc = rng.integers(0, 5, n)
    code = rng.choice([200, 404, 500], n)
    dur = rng.integers(1_000, 90_000, n)
    return [{"time": BASE_NS + (n0 + i) * 1_000_000, "flow_id": 100 + n0 + i,
             "app_service": f"svc-{int(svc[i])}",
             "endpoint": f"/api/{int(svc[i]) % 3}",
             "request_type": "GET" if i % 2 == 0 else "POST",
             "response_code": int(code[i]),
             "response_duration": int(dur[i])} for i in range(n)]


def span_rows(n0: int, n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed + 7 * n0)
    ops = rng.integers(0, 40, n)
    return [{"time": BASE_NS + (n0 + i) * 100_000,
             "duration_ns": int(rng.integers(1_000, 500_000)),
             "device_id": int(rng.integers(0, 8)), "hlo_op": f"op{ops[i]}",
             "hlo_module": f"mod{ops[i] % 4}",
             "run_id": 1, "step": (n0 + i) // 50} for i in range(n)]


def _publish_batches(P, d, batches, shard=1):
    db = P.Database(data_dir=str(d / "ing"), shard_id=shard, storage=True)
    for table, rows in batches:
        db.table(table).append_rows(rows)
        assert db.flush_to_tier() == len(rows)
    pub = P.SegmentPublisher(P.ObjStore(str(d / "obj")), shard)
    return db, pub


def test_keys_and_pointer_names_match(pkgs):
    ref, port = (P.objstore for P in pkgs)
    for args in ((1, TBL, "seg_00000007.seg"), (65535, SPAN, "x.seg")):
        assert port.seg_key(*args) == ref.seg_key(*args)
    assert port.dict_key(3, TBL, "endpoint", 1, 42) \
        == ref.dict_key(3, TBL, "endpoint", 1, 42) \
        == f"dicts/3/{TBL}/endpoint.g1.v42.json"
    assert port.pointer_name(9) == ref.pointer_name(9) == "MANIFEST-9"


def test_published_store_equal_across_packages(pkgs, tmp_path):
    """The same rows flushed and published by each package: the pointer
    files are byte-equal, and so is every blob."""
    batches = [(TBL, l7_rows(0, 300)), (SPAN, span_rows(0, 400)),
               (TBL, l7_rows(300, 200))]

    def run(P, d):
        _db, pub = _publish_batches(P, d, batches)
        stats = pub.publish(_db.tier_store)
        store = P.ObjStore(str(d / "obj"))
        keys = store.list_keys()
        ptr = open(os.path.join(str(d / "obj"), "ptr", "MANIFEST-1"),
                   "rb").read()
        return stats, keys, {k: store.get_bytes(k) for k in keys}, ptr
    ref, port = _both(pkgs, tmp_path, run)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    doc = json.loads(port[3])
    assert list(doc) == ["publish_gen", "shard_id", "tables"]
    assert doc["publish_gen"] == 1 and doc["shard_id"] == 1
    assert len(doc["tables"][TBL]["segments"]) == 2
    assert sorted(doc["tables"][TBL]["segments"][0]) == [
        "bytes", "fn", "rows", "time_col", "tmax", "tmin"]


def test_publisher_noop_when_tier_unchanged(pkgs, tmp_path):
    def run(P, d):
        db = P.Database(data_dir=str(d / "ing"), shard_id=1, storage=True)
        db.table(TBL).append_rows(l7_rows(0, 8))
        db.flush_to_tier()
        pub = P.SegmentPublisher(P.ObjStore(str(d / "obj")), 1)
        seen = [pub.maybe_publish(db.tier_store), pub.publish_gen,
                # an unchanged tier: no swap, no gen churn for pollers
                pub.maybe_publish(db.tier_store), pub.publish_gen]
        db.table(TBL).append_rows(l7_rows(8, 8))
        db.flush_to_tier()
        seen += [pub.maybe_publish(db.tier_store), pub.publish_gen]
        # a restarted publisher keeps its gens monotonic
        seen.append(P.SegmentPublisher(P.ObjStore(str(d / "obj")),
                                       1).publish_gen)
        return seen
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port[1] == 1 and port[2] is None and port[3] == 1
    assert port[5] == 2 and port[6] == 2


def test_blob_gc_runs_after_the_swap(pkgs, tmp_path):
    """A compaction retires three published segments: the next publish
    uploads the run, swaps the pointer, then deletes the three blobs."""
    def run(P, d):
        db, pub = _publish_batches(
            P, d, [(TBL, l7_rows(i * 40, 40)) for i in range(3)])
        first = pub.publish(db.tier_store)
        res = db.compact_tier(TBL, min_merge=2)
        assert res["runs_built"] == 1
        second = pub.publish(db.tier_store)
        store = P.ObjStore(str(d / "obj"))
        doc = store.get_pointer(P.objstore.pointer_name(1))
        return (first, second, store.list_keys(f"seg/1/{TBL}"),
                [s["fn"] for s in doc["tables"][TBL]["segments"]],
                pub.current[0], sorted(pub.current[1][TBL]))
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    first, second, keys, fns, gen, cur = port
    assert first["segments_uploaded"] == 3
    assert second["segments_uploaded"] == 1 and second["blobs_gced"] == 3
    assert keys == [f"seg/1/{TBL}/{fn}" for fn in fns] and len(fns) == 1
    assert gen == 2 and cur == fns


def test_objstore_eio_fails_the_put_before_bytes_land(pkgs, tmp_path):
    """The same DF_CHAOS seed fails the same puts in both packages; a
    failed put leaves no blob and no temp file."""
    def run(P, d):
        store = P.ObjStore(str(d / "obj"))
        store.chaos = P.chaos.ChaosInjector(
            P.chaos.ChaosConfig.parse("seed=7,objstore_eio=0.5"))
        failed = []
        for i in range(24):
            try:
                store.put_if_absent(f"seg/1/t/{i:04d}.seg", data=b"b" * i)
            except OSError as e:
                failed.append((i, e.errno))
        leftovers = [f for _r, _d, fs in os.walk(str(d / "obj"))
                     for f in fs if ".tmp." in f]
        return failed, store.list_keys(), leftovers, \
            store.chaos.stats["objstore_eio"]
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    failed, keys, leftovers, n = port
    assert 0 < len(failed) < 24 and n == len(failed)
    assert all(code == 5 for _i, code in failed)  # EIO
    assert len(keys) == 24 - len(failed) and leftovers == []


def test_failed_upload_keeps_the_pointer_off_the_missing_blob(pkgs,
                                                              tmp_path):
    """A publish whose segment upload fails names only what made it
    into the store; the next tick retries and converges."""
    def run(P, d):
        db, pub = _publish_batches(P, d, [(TBL, l7_rows(0, 30))])
        pub.store.chaos = P.chaos.ChaosInjector(
            P.chaos.ChaosConfig.parse("seed=1,objstore_eio=1.0"))
        r1 = pub.maybe_publish(db.tier_store)
        doc1 = pub.store.get_pointer(P.objstore.pointer_name(1))
        pub.store.chaos = None
        r2 = pub.maybe_publish(db.tier_store)
        doc2 = pub.store.get_pointer(P.objstore.pointer_name(1))
        return (r1, doc1["tables"], pub.stats["upload_errors"], r2,
                [s["fn"] for s in doc2["tables"][TBL]["segments"]])
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    r1, tables1, errors, r2, fns = port
    assert r1["segments_uploaded"] == 0 and errors > 0
    assert all(not t["segments"] for t in tables1.values())
    assert r2["segments_uploaded"] == 1 and len(fns) == 1
