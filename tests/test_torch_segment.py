"""The port's on-disk segments held against the JAX package's.

The same chunks go through both ``write_segment``s, v1 and v2, over
every codec (const, zlib, raw, delta, for, dictrank) and both skip
indexes: the files must be the same bytes. Each package opens the
other's files and must read the same columns, zones, zstr zones and
``maybe_contains`` answers, and check the same block crc32s. The
reference's own format cases (``tests/test_segment_v2.py`` and the
segment half of ``tests/test_storage.py``) run on both packages with the
same outcomes, over ``flow_log.l7_flow_log``, a table both schemas hold
(the reference's cases use ``application_log.log``, which the port took
only later).
"""

import json
import os
import struct
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest

from deepflow_tpu import chaos as ref_chaos
from deepflow_tpu.query import execute as ref_execute
from deepflow_tpu.store import segment as ref_segment
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu.store.dictionary import Dictionary as RefDictionary
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.query.engine import execute
from deepflow_tpu_torch.store import segment
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.dictionary import Dictionary

REF = types.SimpleNamespace(
    name="ref", seg=ref_segment, Database=RefDatabase,
    Dictionary=RefDictionary, execute=ref_execute, chaos=ref_chaos,
    module="deepflow_tpu")
PORT = types.SimpleNamespace(
    name="port", seg=segment, Database=Database, Dictionary=Dictionary,
    execute=execute, chaos=chaos, module="deepflow_tpu_torch")
PKGS = [REF, PORT]
TABLE = "flow_log.l7_flow_log"
T0 = 1_754_000_000_000_000_000


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


def _dict_pair(words):
    """A reference and a port dictionary holding the same strings."""
    rd, pd = RefDictionary(), Dictionary()
    for w in words:
        assert rd.encode(w) == pd.encode(w)
    return rd, pd


def _chunks(seed: int) -> dict[str, tuple[dict, dict]]:
    """name -> (chunk, write_segment kwargs), covering every codec."""
    rng = np.random.default_rng(seed)
    n = 4096
    i = np.arange(n, dtype=np.uint64)
    t = T0 + i * 1_000_000 + rng.integers(0, 1000, n).astype(np.uint64)
    t[50] -= np.uint64(5_000_000)  # a late row: not monotone
    return {
        "mixed": ({"time": t,
                   "const": np.full(n, 7, dtype=np.uint32),
                   "repeat": (i % 4).astype(np.uint64),
                   "noise": rng.integers(0, 2**63, n, dtype=np.uint64),
                   "narrow": rng.integers(-5_000_000, -4_940_000,
                                          n).astype(np.int64),
                   "f": rng.random(n).astype(np.float64)},
                  {"time_col": "time"}),
        "ids": ({"time": t[:1000],
                 "svc": np.array([3, 9, 9, 3, 17] * 200, dtype=np.uint32),
                 "trace": np.arange(1000, dtype=np.uint32)},
                {"time_col": "time", "dict_gens": {"svc": (0, 18),
                                                   "trace": (0, 1000)}}),
        "empty_tail": ({"v": np.zeros(0, dtype=np.uint64)}, {}),
    }


WORDS = ["pear", "apple", "zebra", "mango", "kiwi", "fig", "lime"]


def _ranked():
    """A string column for dictrank, as a (chunk, kwargs-without-dicts)."""
    ids = np.array([1 + (j * 3) % len(WORDS) for j in range(600)],
                   dtype=np.uint32)
    return {"svc": ids, "time": T0 + np.arange(600, dtype=np.uint64)}, {
        "time_col": "time", "dict_gens": {"svc": (0, len(WORDS) + 1)},
        "level": 1}


CASES = [(name, fmt) for name in ("mixed", "ids", "empty_tail")
         for fmt in (1, 2)] + [("ranked", 2), ("ids_level1", 2)]


def _case(name, fmt):
    if name == "ranked":
        ch, kw = _ranked()
        rd, pd = _dict_pair(WORDS)
        return ch, {**kw, "fmt": fmt}, {"svc": rd}, {"svc": pd}
    if name == "ids_level1":
        ch, kw = _chunks(1)["ids"]
        return ch, {**kw, "fmt": fmt, "level": 1}, None, None
    ch, kw = _chunks(1)[name]
    return ch, {**kw, "fmt": fmt}, None, None


@pytest.mark.parametrize("name,fmt", CASES)
def test_same_bytes_as_reference(tmp_path, name, fmt):
    """The same chunk through both writers is the same file: no footer
    field differs."""
    ch, kw, rdicts, pdicts = _case(name, fmt)
    pr, pp = str(tmp_path / "r.seg"), str(tmp_path / "p.seg")
    fr = ref_segment.write_segment(pr, ch, dicts=rdicts, **kw)
    fp = segment.write_segment(pp, ch, dicts=pdicts, **kw)
    assert fr == fp
    assert open(pr, "rb").read() == open(pp, "rb").read()


def _read(seg, probe: dict) -> dict:
    ch = seg.chunk()
    return {"rows": seg.rows, "fmt": seg.fmt, "tmin": seg.tmin,
            "tmax": seg.tmax, "zones": seg.zones, "run": seg.run,
            "dict_gens": seg.dict_gens, "codecs": seg.codecs(),
            "cols": {k: np.asarray(ch[k]).tolist() for k in ch},
            "dtypes": {k: str(np.asarray(ch[k]).dtype) for k in ch},
            "str_zone": {k: seg.str_zone(k) for k in ch},
            "has_index": {k: seg.has_index(k) for k in ch},
            "maybe": {k: [seg.maybe_contains(k, ids) for ids in probe[k]]
                      for k in probe if k in ch},
            "verify": seg.verify()}


@pytest.mark.parametrize("name,fmt", CASES)
@pytest.mark.parametrize("writer", PKGS, ids=lambda p: p.name)
def test_each_package_reads_the_others_segments(tmp_path, name, fmt,
                                                writer):
    """A segment written by either package opens in both with equal
    columns, zones, zstr zones, skip-index answers and crc checks."""
    ch, kw, rdicts, pdicts = _case(name, fmt)
    p = str(tmp_path / "s.seg")
    writer.seg.write_segment(p, ch, dicts=rdicts if writer is REF
                             else pdicts, **kw)
    probe = {"svc": [[3], [2, 17], [2, 4, 1000], [1], [5, 6]],
             "trace": [[999], [5000], [7, 70_000]]}
    got_ref = _read(ref_segment.Segment.open(p), probe)
    got_port = _read(segment.Segment.open(p), probe)
    assert got_port == got_ref
    for k, v in ch.items():
        assert got_port["cols"][k] == np.asarray(v).tolist()


@pytest.mark.parametrize("mode", ["bit_flip", "truncate"])
def test_corrupt_segment_like_reference(tmp_path, mode):
    """chaos.corrupt_segment does the reference's damage to the same
    file, and both packages accuse the same block (or refuse the file)."""
    ch, kw, _r, _p = _case("mixed", 2)
    outs = []
    for pk in PKGS:
        p = str(tmp_path / f"{pk.name}.seg")
        segment.write_segment(p, ch, **kw)
        outs.append(pk.chaos.corrupt_segment(p, seed=5, mode=mode))
    assert outs[0] == outs[1]
    assert open(tmp_path / "ref.seg", "rb").read() == \
        open(tmp_path / "port.seg", "rb").read()
    p = str(tmp_path / "port.seg")
    if mode == "truncate":
        for pk in PKGS:
            with pytest.raises(pk.seg.SegmentError):
                pk.seg.Segment.open(p)
        return
    res = [pk.seg.Segment.open(p).verify() for pk in PKGS]
    assert res[0] == res[1]
    assert res[1]["corrupt"] == [outs[1]["column"]]
    buf = open(p, "rb").read()
    assert ref_segment.verify_buffer(buf, "x") == \
        segment.verify_buffer(buf, "x")


# -- the reference's segment cases (tests/test_storage.py) --------------------

def _small(n=100, t0=1000):
    return {"time": np.arange(t0, t0 + n, dtype=np.uint32),
            "v": np.arange(n, dtype=np.uint64),
            "tag": np.zeros(n, dtype=np.uint32)}


def test_segment_roundtrip(tmp_path, pkg):
    p = str(tmp_path / "seg_00000001.seg")
    ch = _small()
    pkg.seg.write_segment(p, ch, time_col="time",
                          dict_gens={"tag": (0, 17)}, fmt=1)
    seg = pkg.seg.Segment.open(p)
    assert seg.rows == 100
    assert (seg.tmin, seg.tmax) == (1000, 1099)
    assert seg.dict_gens == {"tag": (0, 17)}
    out = seg.chunk()
    for name in ch:
        assert np.array_equal(out[name], ch[name]), name
    assert not out["time"].flags.writeable


def test_segment_codecs(tmp_path, pkg):
    rng = np.random.default_rng(7)
    ch = {"const64": np.full(4096, 0xDEAD, dtype=np.uint64),
          "repeat": np.arange(4096, dtype=np.uint64) % 4,
          "noise": rng.integers(0, 2**63, 4096, dtype=np.uint64)}
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(p, ch, fmt=1)
    assert {k: v["codec"] for k, v in footer["cols"].items()} == {
        "const64": "const", "repeat": "zlib", "noise": "raw"}
    assert footer["cols"]["const64"]["nbytes"] == 8
    out = pkg.seg.Segment.open(p).chunk()
    for name in ch:
        assert np.array_equal(out[name], ch[name]), name
    assert out["const64"].strides == (0,)
    p2 = str(tmp_path / "seg2.seg")
    footer2 = pkg.seg.write_segment(p2, ch, compress=False, fmt=1)
    assert {k: v["codec"] for k, v in footer2["cols"].items()} == {
        "const64": "const", "repeat": "raw", "noise": "raw"}


def test_segment_const_block_validated(tmp_path, pkg):
    p = str(tmp_path / "seg.seg")
    pkg.seg.write_segment(p, {"c": np.full(64, 5, dtype=np.uint64)})
    with open(p, "rb") as f:
        buf = bytearray(f.read())
    flen, _fcrc, magic = struct.unpack("<II8s", buf[-16:])
    foot = json.loads(bytes(buf[-16 - flen:-16]))
    foot["cols"]["c"]["nbytes"] = 4  # lies about the block size
    fb = json.dumps(foot, sort_keys=True).encode()
    buf = buf[:len(buf) - 16 - flen] + fb + struct.pack(
        "<II8s", len(fb), zlib.crc32(fb) & 0xFFFFFFFF, magic)
    with open(p, "wb") as f:
        f.write(buf)
    with pytest.raises(pkg.seg.SegmentError, match="const block"):
        pkg.seg.Segment.open(p)


def test_segment_torn_tail_detected(tmp_path, pkg):
    p = str(tmp_path / "seg.seg")
    pkg.seg.write_segment(p, _small(), time_col="time")
    size = os.path.getsize(p)
    for cut in (size - 4, size // 2, 10):
        with open(p, "r+b") as f:
            f.truncate(cut)
        with pytest.raises(pkg.seg.SegmentError):
            pkg.seg.Segment.open(p)
        pkg.seg.write_segment(p, _small(), time_col="time")
    with open(p, "r+b") as f:
        f.seek(size - 30)
        b = f.read(1)
        f.seek(size - 30)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(pkg.seg.SegmentError):
        pkg.seg.Segment.open(p)


# -- the reference's v2 cases (tests/test_segment_v2.py) ----------------------

def test_delta_codec_roundtrip(tmp_path, pkg):
    t = np.cumsum(np.full(4096, 1_000_000, dtype=np.uint64)) + np.uint64(T0)
    t[100] -= np.uint64(2_000_000)
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(p, {"time": t}, fmt=2)
    assert footer["cols"]["time"]["codec"] == "delta"
    assert footer["cols"]["time"]["nbytes"] < t.nbytes // 2
    out = pkg.seg.Segment.open(p).chunk()["time"]
    assert out.dtype == np.uint64 and np.array_equal(out, t)


def test_for_codec_roundtrip_signed_and_extremes(tmp_path, pkg):
    rng = np.random.default_rng(3)
    near_max = (np.uint64(2**64 - 70_000)
                + rng.integers(0, 60_000, 4096).astype(np.uint64))
    neg = rng.integers(-5_000_000, -4_940_000, 4096).astype(np.int64)
    wide = rng.integers(0, 2**63, 4096, dtype=np.uint64)
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(
        p, {"near_max": near_max, "neg": neg, "wide": wide}, fmt=2)
    assert footer["cols"]["near_max"]["codec"] == "for"
    assert footer["cols"]["neg"]["codec"] == "for"
    assert footer["cols"]["wide"]["codec"] in ("raw", "zlib")
    out = pkg.seg.Segment.open(p).chunk()
    assert np.array_equal(out["near_max"], near_max)
    assert np.array_equal(out["neg"], neg)
    assert np.array_equal(out["wide"], wide)


def test_choose_codec_is_observable(tmp_path, pkg):
    arr = np.cumsum(np.full(2048, 7, dtype=np.uint64))
    raw = memoryview(np.ascontiguousarray(arr)).cast("B")
    codec, _meta, _blob = pkg.seg.choose_codec(
        "t", arr, raw, fmt=2, compress=True,
        zone=(int(arr.min()), int(arr.max())), codec_hints=None)
    assert codec == "delta"
    counts, seen = {}, []
    pkg.seg.write_segment(str(tmp_path / "s.seg"),
                          {"t": arr, "c": np.zeros(2048, dtype=np.uint32)},
                          fmt=2, codec_counts=counts,
                          observe=lambda c, n, ns: seen.append((c, n)))
    assert counts == {"delta": 1, "const": 1}
    assert sorted(seen) == [("const", 2048), ("delta", 2048)]


def test_dictrank_rewrite_and_zstr(tmp_path, pkg):
    d = pkg.Dictionary()
    words = ["pear", "apple", "zebra", "mango", "kiwi"]
    ids = np.array([d.encode(w) for w in words] * 40, dtype=np.uint32)
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(p, {"svc": ids}, fmt=2, level=1,
                                   dict_gens={"svc": (0, 1)},
                                   dicts={"svc": d})
    ent = footer["cols"]["svc"]
    assert ent["codec"] == "dictrank"
    assert ent["zstr"][0] == "apple" and ent["zstr"][1] == "zebra"
    seg = pkg.seg.Segment.open(p)
    assert seg.str_zone("svc") == ("apple", "zebra")
    out = seg.chunk()["svc"]
    assert np.array_equal(out, ids)
    assert [d.decode(int(s)) for s in out[:5]] == words


def test_inline_id_index_exact(tmp_path, pkg):
    ids = np.array([3, 9, 9, 3, 17] * 100, dtype=np.uint32)
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(p, {"svc": ids}, fmt=2, level=1,
                                   dict_gens={"svc": (0, 1)})
    assert footer["cols"]["svc"]["ids"] == [3, 9, 17]
    seg = pkg.seg.Segment.open(p)
    assert seg.has_index("svc")
    assert seg.maybe_contains("svc", [9])
    assert seg.maybe_contains("svc", [2, 17])
    assert not seg.maybe_contains("svc", [2, 4, 1000])


def test_bloom_index_sound_and_tight(tmp_path, pkg):
    present = np.arange(0, 20_000, 2, dtype=np.uint32)
    bits = np.frombuffer(pkg.seg._bloom_build(present), dtype=np.uint8)
    m = pkg.seg._bloom_params(len(present))
    assert all(pkg.seg._bloom_maybe(bits, m, int(s)) for s in present[:2000])
    absent = np.arange(1, 20_001, 2, dtype=np.uint32)[:4000]
    fp = sum(pkg.seg._bloom_maybe(bits, m, int(s)) for s in absent)
    assert fp / len(absent) < 0.01
    ids = np.arange(5000, dtype=np.uint32)
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(p, {"trace": ids}, fmt=2, level=1,
                                   dict_gens={"trace": (0, 1)})
    assert "bloom" in footer["cols"]["trace"]
    seg = pkg.seg.Segment.open(p)
    assert seg.maybe_contains("trace", [4999])
    assert sum(seg.maybe_contains("trace", [i])
               for i in range(6000, 7000)) < 10


def test_flush_grade_skips_indexes(tmp_path, pkg):
    ids = np.arange(5000, dtype=np.uint32)
    p = str(tmp_path / "seg.seg")
    footer = pkg.seg.write_segment(p, {"trace": ids}, fmt=2, level=0,
                                   dict_gens={"trace": (0, 1)})
    assert "bloom" not in footer["cols"]["trace"]
    seg = pkg.seg.Segment.open(p)
    assert not seg.has_index("trace")
    assert seg.maybe_contains("trace", [999_999])


def test_lazy_chunk_decodes_on_touch(tmp_path, pkg):
    p = str(tmp_path / "seg.seg")
    pkg.seg.write_segment(p, {"a": np.arange(1000, dtype=np.uint64),
                              "b": (np.arange(1000, dtype=np.uint64) * 37)
                              % 11,
                              "c": np.arange(1000, dtype=np.uint32)}, fmt=2)
    seg = pkg.seg.Segment.open(p)
    ch = seg.chunk()
    assert ch.rows == 1000
    assert not seg._cache
    np.testing.assert_array_equal(ch["a"], np.arange(1000))
    assert set(seg._cache) == {"a"}


def _v2chunk(n=500):
    i = np.arange(n, dtype=np.uint64)
    return {"time": T0 + i * 1_000_000, "svc": (i % 7).astype(np.uint32),
            "dur": (1000 + i * 37 % 5000).astype(np.uint64)}


def test_v1_written_v2_read_byte_identical(tmp_path, pkg):
    ch = _v2chunk()
    p1, p2 = str(tmp_path / "v1.seg"), str(tmp_path / "v2.seg")
    pkg.seg.write_segment(p1, ch, time_col="time", fmt=1)
    pkg.seg.write_segment(p2, ch, time_col="time", fmt=2)
    s1, s2 = pkg.seg.Segment.open(p1), pkg.seg.Segment.open(p2)
    assert (s1.fmt, s2.fmt) == (1, 2)
    assert (s1.tmin, s1.tmax) == (s2.tmin, s2.tmax)
    c1, c2 = s1.chunk(), s2.chunk()
    for name in ch:
        assert np.array_equal(c1[name], ch[name]), name
        assert np.array_equal(c2[name], ch[name]), name


def test_env_pin_yields_to_explicit_fmt(tmp_path, monkeypatch, pkg):
    monkeypatch.setenv("DF_SEG_FORMAT", "1")
    ch = _v2chunk(50)
    pd, pe = str(tmp_path / "d.seg"), str(tmp_path / "e.seg")
    pkg.seg.write_segment(pd, ch)
    pkg.seg.write_segment(pe, ch, fmt=2)
    assert pkg.seg.Segment.open(pd).fmt == 1
    assert pkg.seg.Segment.open(pe).fmt == 2


def _row(j: int) -> dict:
    return {"time": j * 1_000_000, "app_service": f"svc-{j % 5}",
            "request_id": j % 24 + 1,
            "trace_id": f"{j * 2654435761 % 2**32:08x}",
            "endpoint": f"m{j % 9}"}


def seed_db(pkg, data_dir, n_flushes=6, rows=200, v1=False):
    """A storage database of n_flushes segments of `rows` L7 rows."""
    if v1:
        os.environ["DF_SEG_FORMAT"] = "1"
    try:
        db = pkg.Database(data_dir=data_dir, storage=True, chunk_rows=rows)
        t = db.table(TABLE)
        for s in range(n_flushes):
            t.append_rows([_row(s * rows + j) for j in range(rows)])
            t.flush()
            db.flush_to_tier()
    finally:
        os.environ.pop("DF_SEG_FORMAT", None)
    return db


GOLDEN_SQL = [
    "SELECT app_service, Count(*) AS c, Sum(request_id) AS s "
    "FROM l7 GROUP BY app_service ORDER BY app_service",
    "SELECT Count(*) AS c FROM l7 WHERE trace_id = '9908b100'",
    "SELECT Count(*) AS c FROM l7 WHERE app_service >= 'svc-3'",
    "SELECT Max(time) AS t FROM l7 WHERE request_id = 7",
]


def golden(pkg, db):
    t = db.table(TABLE)
    return [pkg.execute(t, s).values for s in GOLDEN_SQL]


def test_mixed_manifest_and_migration_equality(tmp_path, pkg):
    d = str(tmp_path / "db")
    db = seed_db(pkg, d, n_flushes=4, v1=True)
    first = golden(pkg, db)
    t = db.table(TABLE)
    t.append_rows([{"time": 10**15 + j, "app_service": f"svc-{j % 5}",
                    "request_id": j % 24 + 1, "trace_id": f"x{j:07d}",
                    "endpoint": "late"} for j in range(100)])
    t.flush()
    db.flush_to_tier()
    assert {s.fmt for s in db.tier_store.tier(TABLE).segments()} == {1, 2}
    mixed = golden(pkg, db)
    assert mixed[0][0][1] > first[0][0][1]
    res = db.compact_tier()
    assert res["runs_built"] >= 1
    assert db.tier_store.migrate_v1_remaining() == 0
    assert {s.fmt for s in db.tier_store.tier(TABLE).segments()} == {2}
    assert golden(pkg, db) == mixed
    assert golden(pkg, pkg.Database(data_dir=d, storage=True)) == mixed


def test_compacted_runs_are_sorted_and_ranked(tmp_path, pkg):
    db = seed_db(pkg, str(tmp_path / "db"), n_flushes=5, v1=True)
    db.compact_tier()
    segs = db.tier_store.tier(TABLE).segments()
    assert segs
    for s in segs:
        assert s.fmt == 2 and s.run is not None and s.sorted_by == "time"
        tcol = np.asarray(s.chunk()["time"])
        assert (tcol[1:] >= tcol[:-1]).all()
        codecs = s.codecs()
        assert codecs["time"] in ("delta", "for")
        assert codecs["app_service"] == "dictrank"
        assert s.has_index("trace_id")
        assert s.str_zone("app_service") is not None


def _crash_compact(pkg, data_dir, mode, pin_v1=False):
    env = {k: v for k, v in os.environ.items() if k != "DF_SEG_FORMAT"}
    env["DF_COMPACT_CRASH"] = mode
    env["JAX_PLATFORMS"] = "cpu"
    if pin_v1:
        env["DF_SEG_FORMAT"] = "1"
    child = (f"from {pkg.module}.store.db import Database\n"
             f"Database({data_dir!r}, storage=True).compact_tier()\n")
    return subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, timeout=120)


def test_restart_mid_compaction_converges(tmp_path, pkg):
    d = str(tmp_path / "db")
    want = golden(pkg, seed_db(pkg, d, v1=True))
    proc = _crash_compact(pkg, d, "after_stage")
    assert proc.returncode == 43, proc.stderr.decode()[-500:]
    db = pkg.Database(data_dir=d, storage=True)
    assert db.tier_store.migrate_v1_remaining() > 0
    assert golden(pkg, db) == want
    db.compact_tier()
    assert db.tier_store.migrate_v1_remaining() == 0
    assert golden(pkg, db) == want


def test_restart_mid_migration_converges(tmp_path, pkg):
    d = str(tmp_path / "db")
    want = golden(pkg, seed_db(pkg, d, v1=True))
    proc = _crash_compact(pkg, d, "after_commit", pin_v1=True)
    assert proc.returncode == 43, proc.stderr.decode()[-500:]
    db = pkg.Database(data_dir=d, storage=True)
    assert db.tier_store.migrate_v1_remaining() == 0
    assert golden(pkg, db) == want
    assert db.compact_tier()["segments_replaced"] == 0
    assert golden(pkg, db) == want


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
@pytest.mark.parametrize("v1", [True, False], ids=["v1", "v2"])
def test_each_package_recovers_the_others_tier(tmp_path, writer, reader, v1):
    """A data directory flushed (and compacted) by one package recovers
    in the other with the same answers, and the same answers as the
    writer's."""
    d = str(tmp_path / "db")
    db = seed_db(writer, d, n_flushes=3, v1=v1)
    want = golden(writer, db)
    other = reader.Database(data_dir=d, storage=True)
    assert golden(reader, other) == want
    assert other.compact_tier()["runs_built"] >= 1
    assert golden(reader, other) == want
    assert golden(writer, writer.Database(data_dir=d, storage=True)) == want
