"""The port's native span decode held against the JAX package's on the CPU.

The same ``TpuSpanBatch`` bytes, made from a seed by the port's encoder
(``batch_to_pb``) with memory samples, empty strings, non-ASCII names,
names of 200+ characters and ``slice_id`` both 0 and set, go through the
port's ``SpanColumnDecoder`` and the reference's: the columns must be
equal, and equal the port's pure ``wire`` decode. Through the decoders,
the rows the port's native path, its pure path and the reference's
decoder write are equal. A batch past the reference's 4 MiB string arena
stays on the port's native path; a truncated or corrupt one takes the
pure path and counts as a decode error, as in the reference. The build
is held to its contract: processes that build at once share one good
library, and a failed build or a wrong ABI raises.
"""

import os
import queue
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from deepflow_tpu import native as ref_native
from deepflow_tpu.server import decoders as ref_decoders
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu.telemetry import Telemetry as RefTelemetry
from deepflow_tpu_torch import native
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.decoders import TpuSpanDecoder
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.dictionary import Dictionary
from deepflow_tpu_torch.tpuprobe.events import TpuSpanEvent, batch_to_pb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_NS = 1_760_000_000_000_000_000
LONG = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel"
        "_impl_nocast<at::native::BinaryFunctor<c10::BFloat16, c10::BFloat"
        "16, c10::BFloat16, at::native::binary_internal::MulFunctor<float>"
        " > >(at::TensorIteratorBase&, at::native::BinaryFunctor<c10::BFlo"
        "at16, c10::BFloat16, c10::BFloat16> const&)::{lambda(int)#1}>(int"
        ", at::native::gpu_kernel_impl_nocast<...>::{lambda(int)#1})")
NAMES = ("", "gemm", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
         "Memcpy DtoD (Device -> Device)", "核函数_ñandú_✓", LONG,
         LONG + "_b", "a" * 300)
CATS = ("", "kernel", "gpu_memcpy", "gpu_memset", "nccl")
PNAMES = ("", "trainer", "python3 -m train ✓")
SPAN_TABLES = ("profile.tpu_hlo_span", "profile.tpu_memory")
SPAN_STR_COLS = ("hlo_module", "hlo_op", "hlo_category", "collective",
                 "process_name")


def _batch(seed: int, n_spans: int = 200, n_mem: int = 12) -> bytes:
    """Spans from batch_to_pb, then hand-made spans with their own
    slice_id (0 or set) and memory samples, joined as one message."""
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    big = lambda: int(rng.integers(0, 2**62))  # noqa: E731
    events = [TpuSpanEvent(
        start_ns=BASE_NS + int(rng.integers(0, 10**10)),
        duration_ns=int(rng.integers(0, 10**7)),
        device_id=int(rng.integers(0, 8)), chip_id=int(rng.integers(0, 8)),
        core_id=int(rng.integers(0, 200)), hlo_module=pick(NAMES[:3]),
        hlo_op=pick(NAMES), hlo_category=pick(CATS),
        kind=int(rng.integers(0, 6)), flops=big(), bytes_accessed=big(),
        program_id=int(rng.integers(0, 2**32)),
        run_id=int(rng.integers(0, 2**32)), collective=pick(NAMES[:3]),
        bytes_transferred=big(), replica_group_size=int(rng.integers(0, 9)),
        step=int(rng.integers(0, 10**6))) for _ in range(n_spans)]
    body = batch_to_pb(events, pid=int(rng.integers(0, 2**31)),
                       process_name=pick(PNAMES))
    spans = [wire.TpuSpan(
        start_ns=BASE_NS + i, duration_ns=1000 + i, device_id=i % 3,
        slice_id=int(rng.integers(0, 4)), hlo_module="train_step",
        hlo_op=pick(NAMES), kind=1, run_id=i, step=i, pid=7,
        process_name=pick(PNAMES)) for i in range(n_spans // 10)]
    mem = [wire.TpuMemorySample(
        timestamp_ns=BASE_NS + int(rng.integers(0, 10**10)),
        device_id=i % 4, bytes_in_use=big(), peak_bytes_in_use=big(),
        bytes_limit=80 << 30, largest_free_block=big(),
        num_allocs=int(rng.integers(0, 2**32)), pid=i,
        process_name=pick(PNAMES)) for i in range(n_mem)]
    return body + wire.TpuSpanBatch(spans, mem).SerializeToString()


def _strings(arena: np.ndarray, off: np.ndarray, lens: np.ndarray) -> list:
    ab = arena.tobytes()
    return [ab[o:o + n].decode("utf-8")
            for o, n in zip(off.tolist(), lens.tolist())]


def _canon(res) -> dict:
    """A decode's columns with every string cell as its str."""
    n, cols, n_mem, arena = res
    out = {"n": n, "n_mem": n_mem}
    for k, v in cols.items():
        if k.endswith("_len"):
            continue
        if k.endswith("_off"):
            base = k[:-4]
            out[base] = _strings(arena, v, cols[f"{base}_len"])
        else:
            out[k] = v.tolist()
    return out


def _pure(payload: bytes) -> dict:
    """The pure wire decode in the columnar decoders' form."""
    b = wire.TpuSpanBatch.FromString(payload)
    out = {"n": len(b.spans), "n_mem": len(b.memory)}
    for k in native.SpanColumnDecoder.U64 + native.SpanColumnDecoder.U32:
        out[k] = [getattr(s, k) for s in b.spans]
    for k in SPAN_STR_COLS:
        out[k] = [getattr(s, k) for s in b.spans]
    for k in native.SpanColumnDecoder.M_U64 + native.SpanColumnDecoder.M_U32:
        if k.startswith("m_pname"):
            continue
        out[k] = [getattr(m, k[2:]) for m in b.memory]
    out["m_pname"] = [m.process_name for m in b.memory]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_native_columns_equal_reference_and_pure(seed):
    payload = _batch(seed)
    got = _canon(native.SpanColumnDecoder().decode(payload))
    want = _canon(ref_native.SpanColumnDecoder().decode(payload))
    assert got == want
    assert got == _pure(payload)
    assert any(len(s) > 200 for s in got["hlo_op"])
    assert any(not s.isascii() for s in got["hlo_op"])
    assert 0 in got["slice_id"] and any(got["slice_id"])
    assert got["n_mem"] == 12


def test_decoder_buffers_grow_and_are_reused():
    """Small buffers grow to a batch's counts and arena to its payload;
    a smaller batch after it decodes into the same buffers."""
    dec = native.SpanColumnDecoder(cap=4, mem_cap=1, arena_cap=16)
    big, small = _batch(1, n_spans=500, n_mem=40), _batch(2, n_spans=30)
    assert _canon(dec.decode(big)) == _pure(big)
    arrays = dict(dec.arrays)
    assert _canon(dec.decode(small)) == _pure(small)
    assert all(dec.arrays[k] is a for k, a in arrays.items())
    assert _canon(dec.decode(b"")) == _pure(b"")


def _frames(payloads, agent_id=3):
    return [(FrameHeader(MessageType.TPU_SPAN, agent_id=agent_id), p)
            for p in payloads]


def _port_decoder(db=None) -> TpuSpanDecoder:
    platform = PlatformInfoTable()
    platform.set_clock_offset(3, -5_000_000)
    return TpuSpanDecoder(queue.Queue(), db or Database(), platform)


def _ref_decoder():
    platform = RefPlatform()
    platform.set_clock_offset(3, -5_000_000)
    db = RefDatabase()
    dec = ref_decoders.TpuSpanDecoder(
        queue.Queue(), db, platform,
        telemetry=RefTelemetry("server", enabled=False))
    dec.start()  # its hops are made here; its workers find no frame
    dec.stop()
    return dec, db


def _rows(db, name: str) -> list:
    t = db.table(name)
    names = sorted(t.columns)
    cols = t.column_concat(names)
    dec = [t.dicts[n].decode_many(cols[n]) if n in t.dicts
           else cols[n].tolist() for n in names]
    return sorted(zip(*dec))


def test_native_pure_and_reference_rows_equal():
    """Several batches, an agent with a clock offset: the native path, the
    pure path and the reference's decoder write the same rows."""
    items = _frames([_batch(s, n_spans=150) for s in range(5)])
    nat = _port_decoder()
    nat._handle_items(items)
    pure = _port_decoder()
    for h, p in items:
        pure.handle_pure(h, p)
    ref, ref_db = _ref_decoder()
    ref._handle_items(items)
    assert nat.stats["native_batches"] == 5 and \
        nat.stats["pure_batches"] == 0 and nat.stats["errors"] == 0
    for name in SPAN_TABLES:
        rows = _rows(nat.db, name)
        assert rows and rows == _rows(pure.db, name), name
        assert rows == _rows(ref_db, name), name


def test_batch_past_the_reference_arena_stays_native():
    """22,000 spans whose names are kernel-length and distinct: 6 MB of
    string cells, past the reference's 4 MiB arena, so the reference's
    native decoder refuses the batch; the port's decodes it, and its
    rows equal the pure path's."""
    events = [TpuSpanEvent(start_ns=BASE_NS + i, duration_ns=i + 1,
                           hlo_module="train_step",
                           hlo_op=f"{LONG[:240]}<{i}>", run_id=i % 50)
              for i in range(22_000)]
    payload = batch_to_pb(events, pid=9, process_name="trainer")
    assert len(payload) > 5 << 20
    assert ref_native.SpanColumnDecoder().decode(payload) is None
    dec = _port_decoder()
    dec._handle_items(_frames([payload]))
    assert dec.stats["native_batches"] == 1
    assert dec.stats["pure_batches"] == 0
    assert len(dec.db.table("profile.tpu_hlo_span")) == 22_000
    pure = _port_decoder()
    pure.handle_pure(*_frames([payload])[0])
    assert _rows(dec.db, "profile.tpu_hlo_span") == \
        _rows(pure.db, "profile.tpu_hlo_span")


def _corrupt() -> dict[str, bytes]:
    good = _batch(7, n_spans=20, n_mem=2)
    span = wire.span_entry(wire.encode_span(wire.TpuSpan(
        start_ns=5, hlo_op="x", process_name="p")))
    return {
        "cut inside a span": good[:len(good) - 3],
        "length past the end": good + b"\x0a\x7f" + b"\x08\x01",
        "wire type 7": good + b"\x0f",
        "varint never ends": good + b"\x08" + b"\xff" * 12,
        "span entry cut": span[:-2],
        "group wire type in a span": wire.span_entry(b"\x0b"),
    }


@pytest.mark.parametrize("case", sorted(_corrupt()))
def test_corrupt_batch_takes_pure_path_and_errors_like_reference(case):
    payload = _corrupt()[case]
    assert native.SpanColumnDecoder().decode(payload) is None
    port = _port_decoder()
    port._handle_items(_frames([payload]))
    ref, ref_db = _ref_decoder()
    ref._handle_items(_frames([payload]))
    assert port.stats["pure_batches"] == 1
    assert port.stats["native_batches"] == 0
    assert port.stats["errors"] == ref.stats["errors"] == 1
    for name in SPAN_TABLES:
        assert len(port.db.table(name)) == len(ref_db.table(name)) == 0


def test_invalid_utf8_is_refused_by_both_port_paths():
    """A string cell that is not UTF-8: the native decoder refuses the
    batch as the pure one does, so the batch is one decode error and
    writes nothing (the reference's native path writes it with
    replacement characters while its protobuf path refuses it)."""
    body = b"\x42\x02\xc3\x28"  # field 8 (hlo_op), an invalid 2-byte form
    payload = wire.span_entry(body)
    with pytest.raises(UnicodeDecodeError):
        wire.TpuSpanBatch.FromString(payload)
    assert native.SpanColumnDecoder().decode(payload) is None
    port = _port_decoder()
    port._handle_items(_frames([payload]))
    assert port.stats["pure_batches"] == port.stats["errors"] == 1
    assert len(port.db.table("profile.tpu_hlo_span")) == 0


def _varint(v: int) -> bytes:
    out = bytearray()
    while v > 0x7F:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    return bytes(out + bytes((v,)))


_ODD = {
    "string field as a varint": b"\x40\x05",
    "varint field as a string": b"\x0a\x01x" + b"\x10\x07",
    "u32 fields past 32 bits": b"".join(
        _varint(f << 3) + _varint(v) for f, v in
        ((3, 2**32 + 5), (6, 2**32), (14, 2**40 + 9), (19, 2**63 + 1))),
    "ten-byte varint past 64 bits": b"\x08" + b"\xff" * 9 + b"\x7f",
    "unknown fixed-width fields": b"\xa9\x03" + b"\x01" * 8
                                  + b"\xad\x03" + b"\x02" * 4,
}


@pytest.mark.parametrize("case", sorted(_ODD))
def test_odd_fields_parse_like_protobuf_on_both_paths(case):
    """Parseable oddities, each in a span beside a normal one: a known
    field of another wire type is skipped, a 32-bit field keeps the low
    32 bits of its varint, unknown fields are skipped. The native path
    takes the batch, and its rows equal the pure path's and the
    reference's (whose protobuf parses the same way)."""
    normal = wire.encode_span(wire.TpuSpan(start_ns=BASE_NS, hlo_op="k",
                                           duration_ns=3, slice_id=2))
    payload = wire.span_entry(_ODD[case]) + wire.span_entry(normal)
    port = _port_decoder()
    port._handle_items(_frames([payload]))
    pure = _port_decoder()
    pure.handle_pure(*_frames([payload])[0])
    ref, ref_db = _ref_decoder()
    ref._handle_items(_frames([payload]))
    assert port.stats["native_batches"] == 1 and port.stats["errors"] == 0
    assert port.stats["pure_batches"] == 0
    for name in SPAN_TABLES:
        rows = _rows(port.db, name)
        assert rows == _rows(pure.db, name) == _rows(ref_db, name), name
    assert len(port.db.table("profile.tpu_hlo_span")) == 2


def test_tag_past_32_bits_leaves_the_native_path():
    """A field number past 2**29 (a tag past 32 bits) would alias a known
    field if cut to 32 bits: the native decoder leaves the batch to the
    pure path, which skips the unknown field as protobuf does."""
    aliased = _varint(((1 << 32) + 1) << 3) + _varint(99)  # field 2**32+1
    payload = wire.span_entry(aliased + wire.uint_field("x", 1, BASE_NS))
    assert native.SpanColumnDecoder().decode(payload) is None
    port = _port_decoder()
    port._handle_items(_frames([payload]))
    assert port.stats["pure_batches"] == 1 and port.stats["errors"] == 0
    start = port.db.table("profile.tpu_hlo_span").column_concat(["time"])
    assert start["time"].tolist() == [BASE_NS - 5_000_000]


def test_dictionary_encode_arena_equals_encode_batch():
    """Native interning through the mirror gives the ids encode_batch
    gives, with Python-side inserts between native batches (a lone
    surrogate among them) and a rebuilt dictionary."""
    rng = np.random.default_rng(3)
    words = list(NAMES) + [f"w{i}" for i in range(50)]
    arena_d, py_d = Dictionary("a"), Dictionary("p")
    for step in range(6):
        cells = [words[i] for i in rng.integers(0, len(words), 300)]
        raw = [c.encode() for c in cells]
        arena = np.frombuffer(b"".join(raw), dtype=np.uint8)
        lens = np.array([len(b) for b in raw], dtype=np.uint32)
        offs = (np.cumsum(lens) - lens).astype(np.uint32)
        got = arena_d.encode_arena(arena, offs, lens)
        want = py_d.encode_batch(cells)
        assert got.tolist() == want.tolist()
        extra = [f"py{step}", "\ud800lone"]
        assert [arena_d.encode(s) for s in extra] == \
            [py_d.encode(s) for s in extra]
    assert arena_d._strings == py_d._strings
    rebuilt = Dictionary("r", arena_d._strings[:10])
    cells = arena_d._strings[5:15]
    raw = [c.encode("utf-8", "surrogatepass") for c in cells
           if "\ud800" not in c]
    arena = np.frombuffer(b"".join(raw), dtype=np.uint8)
    lens = np.array([len(b) for b in raw], dtype=np.uint32)
    offs = (np.cumsum(lens) - lens).astype(np.uint32)
    ids = rebuilt.encode_arena(arena, offs, lens)
    assert rebuilt.decode_many(ids) == [b.decode() for b in raw]


def test_native_dict_like_reference():
    mine, ref = native.NativeDict(), ref_native.NativeDict()
    words = ["", "a", "核", LONG, "a", LONG * 3, "b"]
    assert mine.encode_many([w.encode() for w in words]).tolist() == \
        ref.encode_many(words).tolist()
    assert len(mine) == len(ref)
    for w in words + ["absent"]:
        assert mine.lookup(w.encode()) == ref.lookup(w)
    for i in range(len(mine)):
        assert mine.get(i).decode() == ref.decode(i)
    with pytest.raises(IndexError):
        mine.get(len(mine))
    mine.load_entries([b"z", b"a"])
    ref.load_entries(["z", "a"])
    assert len(mine) == len(ref) and mine.lookup(b"z") == ref.lookup("z")


_BUILD_CHILD = textwrap.dedent("""
    import os, sys, time
    from deepflow_tpu_torch import native
    native.BUILD_DIR = sys.argv[1]
    while not os.path.exists(sys.argv[2]):
        time.sleep(0.001)
    lib = native.load()
    dec = native.SpanColumnDecoder()
    n, cols, n_mem, _ = dec.decode(bytes.fromhex(sys.argv[3]))
    print(native.library_path(), lib.df_abi_version(), n,
          cols["start_ns"].tolist())
""")


def test_concurrent_build_gives_every_process_a_good_library(tmp_path):
    """Two processes that find no library build it at once: both load the
    same good one, and no temporary file is left."""
    go = tmp_path / "go"
    build_dir = tmp_path / "build"
    payload = wire.TpuSpanBatch(
        [wire.TpuSpan(start_ns=11), wire.TpuSpan(start_ns=22)]
    ).SerializeToString()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_CHILD, str(build_dir), str(go),
         payload.hex()], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    path, abi, n, starts = lines.pop().split(" ", 3)
    assert os.path.dirname(path) == str(build_dir)
    assert abi == str(native.ABI_VERSION) and n == "2"
    assert starts == "[11, 22]"
    assert sorted(os.listdir(build_dir)) == [".lock",
                                             os.path.basename(path)]


_BROKEN_CHILD = textwrap.dedent("""
    import sys
    from deepflow_tpu_torch import native
    native._DIR, native.BUILD_DIR = sys.argv[1], sys.argv[1] + "/_build"
    try:
        native.load()
    except native.NativeLibraryError as e:
        print("RAISED", e)
""")


_ABI_LINE = f"return {native.ABI_VERSION}; }}"


@pytest.mark.parametrize("edit,expect", [
    ((_ABI_LINE, _ABI_LINE.replace(";", "")), "error"),
    ((_ABI_LINE, "return 99; }"), "has ABI 99"),
])
def test_failed_build_or_wrong_abi_raises(tmp_path, edit, expect):
    """Sources that do not compile raise with the compiler's stderr; a
    library of another ABI version raises on load. Neither returns."""
    for name in native.SOURCES + native.HEADERS:
        with open(os.path.join(ROOT, "deepflow_tpu_torch", "native",
                               name)) as f:
            text = f.read()
        if name == "dfnative.cpp":
            assert edit[0] in text
            text = text.replace(edit[0], edit[1])
        (tmp_path / name).write_text(text)
    out = subprocess.run([sys.executable, "-c", _BROKEN_CHILD,
                          str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("RAISED") and expect in out.stdout, \
        out.stdout
