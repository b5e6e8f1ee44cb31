"""The port's self-healing storage against the reference's: each test of
``tests/test_scrub.py`` runs its inputs through both packages and holds
the port's results (block checksums, quarantine decisions on the same
bit flips, repairs, ledgers, the object store's torn puts and mirrors,
the segment cache's verify-on-fetch and backoff, the flush path's
ENOSPC) equal to the reference's."""

import importlib
import os
import shutil
import types

import numpy as np
import pytest

NET = "flow_metrics.network.1s"
PKGS = ("deepflow_tpu", "deepflow_tpu_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    seg = m("store.segment")
    return types.SimpleNamespace(
        name=name, chaos=m("chaos"), objstore=m("store.objstore"),
        segment=seg, Segment=seg.Segment, write_segment=seg.write_segment,
        verify_buffer=seg.verify_buffer, ChecksumError=seg.ChecksumError,
        Database=m("store.db").Database, ObjStore=m("store.objstore").ObjStore,
        Scrubber=m("store.scrub").Scrubber,
        SegmentCache=m("store.segcache").SegmentCache,
        TieredStore=m("store.tiered").TieredStore,
        Flusher=m("server.flusher").Flusher,
        DurabilityGate=m("server.flusher").DurabilityGate,
        SeqAckTracker=m("server.receiver").SeqAckTracker,
        Server=m("server.server").Server,
        Telemetry=m("telemetry").Telemetry)


@pytest.fixture(scope="module")
def pkgs():
    return [_pkg(n) for n in PKGS]


def _both(pkgs, tmp_path, fn):
    """fn(P, dir) in each package's own directory; the two results."""
    out = []
    for P in pkgs:
        d = tmp_path / P.name
        d.mkdir()
        out.append(fn(P, d))
    return out


def _chunk(n=200, t0=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"time": np.arange(t0, t0 + n, dtype=np.uint32),
            "v": np.arange(n, dtype=np.uint64),
            "w": rng.integers(0, 1000, n).astype(np.uint64)}


def _fill_net(db, n=50, t0=1_754_000_000, seed=0):
    rng = np.random.default_rng(seed)
    db.table(NET).append_rows(
        [{"ip_src": "10.0.0.1", "ip_dst": "10.9.9.9", "server_port": 443,
          "protocol": 1, "host": "h", "byte_tx": int(b), "packet_tx": 1,
          "rtt_sum": 10, "rtt_count": 1, "time": t0 + i}
         for i, b in enumerate(rng.integers(100, 10_000, n))])


def _ledger(telemetry) -> dict:
    return {h["hop"]: (h["emitted"], h["delivered"], h["dropped"],
                       h["in_flight"])
            for h in telemetry.snapshot()["pipeline"]}


def _conserved(telemetry) -> None:
    for h in telemetry.snapshot()["pipeline"]:
        assert h["emitted"] == h["delivered"] + h["dropped_total"] \
            + h["in_flight"], h


# -- per-block checksums ----------------------------------------------------

def test_checksum_roundtrip(pkgs, tmp_path):
    def run(P, d):
        p = str(d / "seg_00000001.seg")
        P.write_segment(p, _chunk(), time_col="time")
        seg = P.Segment.open(p)
        assert all("crc" in c for c in seg._cols.values())
        assert np.array_equal(seg.column("v"), _chunk()["v"])
        return seg.verify(), open(p, "rb").read()
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    v = port[0]
    assert v["verifiable"] and not v["corrupt"]
    assert v["checked"] == v["blocks"] > 0


def test_bit_flip_caught_on_first_touch(pkgs, tmp_path):
    def run(P, d):
        p = str(d / "seg_00000001.seg")
        P.write_segment(p, _chunk(), time_col="time")
        info = P.chaos.corrupt_segment(p, seed=3, mode="bit_flip")
        seg = P.Segment.open(p)  # opens: the footer's crc is intact
        with pytest.raises(P.ChecksumError) as ei:
            seg.column(info["column"])
        return info, ei.value.block, seg.verify()["corrupt"]
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    info, block, corrupt = port
    assert block == info["column"] and info["column"] in corrupt


def test_verify_recomputes_after_memoized_clean_read(pkgs, tmp_path):
    """Bytes can rot AFTER a block was read (and memoized) clean: the
    scrub pass recomputes, in both packages alike."""
    def run(P, d):
        p = str(d / "seg_00000001.seg")
        P.write_segment(p, _chunk(), time_col="time")
        seg = P.Segment.open(p)
        seg.column("v")  # memoizes v as clean
        before = seg.verify()["corrupt"]
        info = P.chaos.corrupt_segment(p, seed=11, mode="bit_flip")
        return before, info, seg.verify()["corrupt"]
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    before, info, after = port
    assert before == [] and info["column"] in after


def test_pre_checksum_segment_readable_never_verifiable(pkgs, tmp_path):
    def run(P, d):
        p1 = str(d / "v1.seg")
        P.write_segment(p1, _chunk(), time_col="time", fmt=1)
        s1 = P.Segment.open(p1)
        assert np.array_equal(s1.column("v"), _chunk()["v"])
        p2 = str(d / "nocrc.seg")
        saved = P.segment._crc_enabled
        P.segment._crc_enabled = False  # the DF_NO_CRC kill-switch
        try:
            P.write_segment(p2, _chunk(), time_col="time")
        finally:
            P.segment._crc_enabled = saved
        s2 = P.Segment.open(p2)
        assert np.array_equal(s2.column("v"), _chunk()["v"])
        return s1.verify(), s2.verify()
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    v1, v2 = port
    assert not v1["verifiable"] and v1["checked"] == 0
    assert not v2["verifiable"]


def test_verify_buffer_clean_torn_flipped_precrc(pkgs, tmp_path):
    def run(P, d):
        p = str(d / "seg.seg")
        P.write_segment(p, _chunk(seed=5), time_col="time")
        buf = open(p, "rb").read()
        clean = P.verify_buffer(buf)
        torn = P.verify_buffer(buf[:len(buf) // 2])
        info = P.chaos.corrupt_segment(p, seed=5, mode="bit_flip")
        flipped = P.verify_buffer(open(p, "rb").read())
        pv1 = str(d / "v1.seg")
        P.write_segment(pv1, _chunk(), time_col="time", fmt=1)
        pre = P.verify_buffer(open(pv1, "rb").read())
        return clean, torn, info, flipped, pre
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    clean, torn, info, flipped, pre = port
    assert clean == {"ok": True, "verifiable": True, "corrupt": [],
                     "reason": ""}
    assert not torn["ok"] and torn["reason"].startswith("torn")
    assert not flipped["ok"] and info["column"] in flipped["corrupt"]
    assert pre["ok"] and not pre["verifiable"]


# -- scrub -> quarantine -> repair ------------------------------------------

def _seed_tier_with_blob(P, d, shard=1):
    """One flushed segment and its published blob."""
    db = P.Database(data_dir=str(d / "data"), storage=True)
    _fill_net(db)
    assert db.flush_to_tier() == 50
    obj = P.ObjStore(str(d / "obj"))
    seg = db.tier_store.tables()[NET].segments()[0]
    fn = os.path.basename(seg.path)
    obj.put_if_absent(P.objstore.seg_key(shard, NET, fn), src_path=seg.path)
    return db, obj, seg, fn


def test_scrub_quarantines_and_repairs(pkgs, tmp_path):
    def run(P, d):
        db, obj, seg, _fn = _seed_tier_with_blob(P, d)
        P.chaos.corrupt_segment(seg.path, seed=2, mode="bit_flip")
        scrub = P.Scrubber(db, objstore=obj, shard_id=1,
                           telemetry=P.Telemetry("server", enabled=True))
        cyc = scrub.scrub_once(max_bytes=0)
        assert db.tier_store.quarantine_info(NET) is None  # back
        tt = db.tier_store.tables()[NET]
        assert not tt.segments()[0].verify()["corrupt"]
        _conserved(scrub._telemetry)
        stats = {k: v for k, v in scrub.stats.items()
                 if k != "bytes_scanned"}
        return (cyc, stats, len(db.table(NET)),
                _ledger(scrub._telemetry))
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    cyc, stats, rows, ledger = port
    assert cyc["corrupt"] == 1 and cyc["repaired"] == 1
    assert stats["quarantined"] == 1 and rows == 50
    # the corrupt segment and its clean blob, the quarantined rows and
    # their repair
    assert ledger["storage.scrub"][:3] == (2, 1, {"corrupt": 1})
    assert ledger["storage"][:3] == (50, 0, {"segment_quarantine": 50})
    assert ledger["storage.repair"][:3] == (50, 50, {})


def test_quarantine_survives_restart_then_retry_repairs(pkgs, tmp_path):
    def run(P, d):
        db, obj, seg, fn = _seed_tier_with_blob(P, d)
        key = P.objstore.seg_key(1, NET, fn)
        stash = obj.get_bytes(key)
        obj.delete(key)  # no healthy copy anywhere
        P.chaos.corrupt_segment(seg.path, seed=4, mode="bit_flip")
        scrub = P.Scrubber(db, objstore=obj, shard_id=1)
        cyc1 = scrub.scrub_once(max_bytes=0)
        qi = db.tier_store.quarantine_info(NET)
        rows_q = len(db.table(NET))  # never served while quarantined
        # a restart on the same dir: the manifest keeps it out
        db2 = P.Database(data_dir=str(d / "data"), storage=True)
        db2.load()
        qi2 = db2.tier_store.quarantine_info(NET)
        rows_q2 = len(db2.table(NET))
        # the healthy copy comes back: the retry repairs and re-admits
        obj.put_if_absent(key, data=stash)
        cyc2 = P.Scrubber(db2, objstore=obj, shard_id=1).scrub_once(
            max_bytes=0)
        return (cyc1, qi, rows_q, qi2, rows_q2, cyc2,
                db2.tier_store.quarantine_info(NET), len(db2.table(NET)))
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    cyc1, qi, rows_q, qi2, rows_q2, cyc2, qi3, rows = port
    assert cyc1["corrupt"] == 1 and cyc1["repair_failed"] >= 1
    assert qi["rows"] == 50 and rows_q == 0
    assert qi2["rows"] == 50 and rows_q2 == 0
    assert cyc2["repaired"] == 1 and qi3 is None and rows == 50


def _corrupt_copy(P, d, src: str) -> bytes:
    """src's bytes with one bit flipped INSIDE a column block (a blind
    flip can land in padding between blocks and verify clean)."""
    p = str(d / "corrupt_copy.seg")
    shutil.copyfile(src, p)
    P.chaos.corrupt_segment(p, seed=13, mode="bit_flip")
    return open(p, "rb").read()


def test_scrub_republishes_corrupt_blob_from_local(pkgs, tmp_path):
    def run(P, d):
        db, obj, seg, fn = _seed_tier_with_blob(P, d)
        key = P.objstore.seg_key(1, NET, fn)
        obj.delete(key)
        obj.put_if_absent(key, data=_corrupt_copy(P, d, seg.path))
        scrub = P.Scrubber(db, objstore=obj, shard_id=1,
                           telemetry=P.Telemetry("server", enabled=True))
        cyc = scrub.scrub_once(max_bytes=0)
        assert P.verify_buffer(obj.get_bytes(key))["ok"]
        return (cyc, scrub.stats["blobs_corrupt"],
                scrub.stats["blobs_republished"], obj.get_bytes(key),
                _ledger(scrub._telemetry))
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port[1] == 1 and port[2] == 1
    # the local segment verified clean, the blob corrupt
    assert port[4]["storage.scrub"][:3] == (2, 1, {"corrupt": 1})


def test_scrub_byte_budget_resumes_with_cursor(pkgs, tmp_path):
    def run(P, d):
        db = P.Database(data_dir=str(d / "data"), storage=True)
        for i in range(3):
            _fill_net(db, n=20, t0=1_754_000_000 + i * 1000, seed=i)
            db.flush_to_tier()
        assert len(db.tier_store.tables()[NET].segments()) == 3
        scrub = P.Scrubber(db)
        # a budget of one byte ends a cycle after one unit
        return [scrub.scrub_once(max_bytes=1)["scanned"]
                for _ in range(3)], scrub._cursor
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port[0] == [1, 1, 1]  # the cursor walked all three


# -- corrupt-state recovery -------------------------------------------------

def test_manifest_truncation_scavenges_segments(pkgs, tmp_path):
    def run(P, d):
        db = P.Database(data_dir=str(d / "data"), storage=True)
        _fill_net(db)
        db.flush_to_tier()
        man = os.path.join(str(d / "data"), "segments", "MANIFEST.json")
        raw = open(man, "rb").read()
        with open(man, "wb") as f:
            f.write(raw[:len(raw) // 2])  # torn mid-byte
        db2 = P.Database(data_dir=str(d / "data"), storage=True)
        db2.load()
        return (db2.tier_store.stats["manifest_corrupt"],
                db2.tier_store.stats["segments_scavenged"],
                len(db2.table(NET)))
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref == (1, 1, 50)


def test_corrupt_ack_state_treated_as_absent(pkgs, tmp_path):
    def run(P, d):
        srv = P.Server(data_dir=str(d), storage=True)
        with open(srv._ack_state_path(), "w") as f:
            f.write('{"7": 41')  # torn mid-byte: invalid JSON
        floors = srv._load_ack_state()
        hops = {h["hop"]: h["dropped"]
                for h in srv.telemetry.snapshot()["pipeline"]}
        return floors, hops.get("storage")
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port[0] == {} and port[1] == {"state_corrupt": 1}


# -- object store: torn blobs, mirrors --------------------------------------

def test_put_if_absent_never_exposes_torn_blob(pkgs, tmp_path, monkeypatch):
    """A writer killed between staging and rename: the key stays absent
    and its temp file stays invisible; a later writer wins cleanly."""
    def run(P, d):
        obj = P.ObjStore(str(d / "obj"))
        monkeypatch.setattr(P.objstore.os, "replace",
                            lambda *a: (_ for _ in ()).throw(
                                KeyboardInterrupt("killed mid-put")))
        with pytest.raises(KeyboardInterrupt):
            obj.put_if_absent("seg/1/t/a.seg", data=b"x" * 64)
        monkeypatch.undo()
        seen = (obj.exists("seg/1/t/a.seg"), obj.list_keys("seg/1"))
        with pytest.raises(OSError):
            obj.get_bytes("seg/1/t/a.seg")
        obj.put_if_absent("seg/1/t/a.seg", data=b"y" * 64)
        return seen, obj.get_bytes("seg/1/t/a.seg"), obj.stats
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port[0] == (False, []) and port[1] == b"y" * 64


def test_objstore_mirror_failover(pkgs, tmp_path):
    def run(P, d):
        mirror = P.ObjStore(str(d / "m"))
        mirror.put_if_absent("seg/1/t/a.seg", data=b"z" * 64)
        obj = P.ObjStore(str(d / "obj"), mirrors=[str(d / "m")])
        got = obj.get_bytes("seg/1/t/a.seg")
        size = obj.fetch("seg/1/t/a.seg", str(d / "local" / "a.seg"))
        return got, size, obj.stats
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port[0] == b"z" * 64 and port[2]["mirror_hits"] == 2


# -- segment cache: verify-on-fetch, backoff, failover ----------------------

def _rseg(shard, table, fn):
    return types.SimpleNamespace(key=(shard, table, fn), shard=shard,
                                 table=table, fn=fn)


def test_segcache_fetch_verifies_and_fails_over(pkgs, tmp_path):
    def run(P, d):
        seg_path = str(d / "seg_00000001.seg")
        P.write_segment(seg_path, _chunk(), time_col="time")
        key = P.objstore.seg_key(1, "t", "seg_00000001.seg")
        # the primary holds a corrupt copy, the alternate a clean one
        prim = P.ObjStore(str(d / "prim"))
        prim.put_if_absent(key, data=_corrupt_copy(P, d, seg_path))
        alt = P.ObjStore(str(d / "alt"))
        alt.put_if_absent(key, src_path=seg_path)
        cache = P.SegmentCache(str(d / "cache"), prim, alt_stores=[alt])
        ent = cache._fetch(_rseg(1, "t", "seg_00000001.seg"))
        assert not ent["seg"].verify()["corrupt"]
        return ent["rows"], cache.stats
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    rows, stats = port
    assert rows == 200
    assert stats["fetch_corrupt"] == 1 and stats["fetch_failover"] == 1


def test_segcache_fetch_backoff_after_all_sources_fail(pkgs, tmp_path):
    def run(P, d):
        prim = P.ObjStore(str(d / "prim"))  # empty: every fetch fails
        cache = P.SegmentCache(str(d / "cache"), prim)
        r = _rseg(1, "t", "seg_00000001.seg")
        with pytest.raises(OSError):
            cache._fetch(r)
        fails = cache._backoff[r.key][0]
        with pytest.raises(OSError, match="backing off"):
            cache._fetch(r)  # inside the window: fails fast
        backoffs = cache.stats["fetch_backoffs"]
        seg_path = str(d / "seg_00000001.seg")
        P.write_segment(seg_path, _chunk(), time_col="time")
        prim.put_if_absent(P.objstore.seg_key(1, "t", "seg_00000001.seg"),
                           src_path=seg_path)
        cache._backoff[r.key] = (1, 0.0)  # the window expired
        ent = cache._fetch(r)
        return fails, backoffs, ent["rows"], r.key in cache._backoff
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref == (1, 1, 200, False)


# -- disk faults on the flush path ------------------------------------------

def test_enospc_flush_requeues_and_recovers(pkgs, tmp_path):
    def run(P, d):
        db = P.Database(data_dir=str(d), storage=True)
        _fill_net(db, n=5)
        gate = P.DurabilityGate()
        tracker = P.SeqAckTracker()
        tracker.seed(3, -1)
        gate.add(3, 0)
        fl = P.Flusher(db, gate=gate, seq_tracker=tracker)
        db.tier_store.chaos = P.chaos.ChaosInjector(P.chaos.ChaosConfig(
            enabled=True, seed=1, tier_enospc=1.0))
        seen = []
        for _ in range(2):
            with pytest.raises(OSError):
                fl.flush_once()
            # the acks stay parked
            seen.append((fl.consec_errors, len(gate),
                         tracker.contiguous(3)))
        db.tier_store.chaos = None  # the disk recovers
        rows = fl.flush_once()
        return seen, rows, fl.consec_errors, len(gate), \
            tracker.contiguous(3)
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    assert port == ([(1, 1, -1), (2, 1, -1)], 5, 0, 0, 0)


def test_tiered_commit_chaos_hook_only_on_writes(pkgs, tmp_path):
    def run(P, d):
        ts = P.TieredStore(str(d / "segments"))
        ts.chaos = P.chaos.ChaosInjector(P.chaos.ChaosConfig(
            enabled=True, seed=1, tier_enospc=1.0))
        return ts.commit({}), ts.chaos.stats["tier_enospc"]
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref == (0, 0)  # nothing to write: no fault


# -- fsck and dfctl ----------------------------------------------------------

def _dfctl(main, port, args, capsys) -> tuple[str, object]:
    try:
        rc = main(["--server", f"127.0.0.1:{port}", *args])
    except SystemExit as e:
        rc = f"exit {e.code}"
    return capsys.readouterr().out, rc


def test_fsck_route_and_dfctl_like_reference(pkgs, tmp_path, capsys):
    """``GET /v1/fsck`` and ``dfctl fsck`` over the same rotten segment
    in each package's server: the same report, exit 1 and ``DEGRADED``
    while a segment is corrupt or quarantined (no published copy to
    repair from), the quarantine's ``degraded`` on a query, and ``fsck:
    OK`` with exit 0 over a clean tier; ``dfctl readtier`` on a server
    that is no querier says so."""
    import json as _json
    import urllib.request

    from deepflow_tpu.cli import dfctl as ref_dfctl
    from deepflow_tpu_torch.cli import dfctl

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return _json.loads(r.read())

    def post(port, sql):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/query",
            data=_json.dumps({"sql": sql}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            return _json.loads(r.read())

    def run(P, d):
        kw = {"selfstats_interval_s": 3600} if P.name == PKGS[0] else {}
        srv = P.Server(host="127.0.0.1", ingest_port=0, query_port=0,
                       sync_port=0, data_dir=str(d), storage=True,
                       scrub_interval_s=0, flush_interval_s=3600,
                       **kw).start()
        main = ref_dfctl.main if P.name == PKGS[0] else dfctl.main
        try:
            _fill_net(srv.db)
            assert srv.flusher.flush_once(seal=True) == 50
            clean = _dfctl(main, srv.query_port, ["fsck", NET], capsys)
            seg = srv.db.tier_store.tables()[NET].segments()[0]
            P.chaos.corrupt_segment(seg.path, seed=2, mode="bit_flip")
            report = get(srv.query_port, f"/v1/fsck?table={NET}&repair=0")
            bad = _dfctl(main, srv.query_port, ["fsck", NET, "--no-repair"],
                         capsys)
            fixed = _dfctl(main, srv.query_port, ["fsck", NET], capsys)
            q = post(srv.query_port, f"SELECT Count() AS n FROM {NET}")
            rt = _dfctl(main, srv.query_port, ["readtier"], capsys)
            return clean, report, bad, fixed, q, rt
        finally:
            srv.stop()
    ref, port = _both(pkgs, tmp_path, run)
    assert port == ref
    clean, report, bad, fixed, q, rt = port
    assert clean[1] == 0 and clean[0].rstrip().endswith("fsck: OK")
    assert not report["ok"] and report["tables"][NET]["corrupt"]
    assert bad[1] == 1 and "fsck: DEGRADED" in bad[0]
    assert fixed[1] == 1 and "quarantined: " in fixed[0]
    # the quarantined rows are missing: the count finds none
    assert q["result"]["values"] in ([], [[0]])
    assert q["degraded"]["rows"] == 50
    assert q["warnings"] and rt[1] == 0 and "not a" in rt[0]
