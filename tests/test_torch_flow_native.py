"""The port's native flow-log and metric-document decode held against the
JAX package on the CPU.

``FlowLogBatch`` and ``DocumentBatch`` bytes are made from a numpy seed
with the reference's protobuf classes: L4 and L7 rows with every field
set or left out, empty and non-ASCII strings, pods, W3C trace ids, empty
addresses, meters present, absent and present but empty. They go
through the port's ``L4ColumnDecoder``, ``L7ColumnDecoder`` and
``DocColumnDecoder`` and the reference's: every column the reference
decodes must be equal. Through the decoders, the rows of the port's
native path equal those of its pure ``wire`` path and of the reference's
protobuf path, and the trace-tree spans fed on both port paths are
equal. An IPv6 batch, a malformed batch and a tag past 32 bits take the
pure path (``pure_batches``), which raises or writes the same rows; a
batch past the buffers grows them and stays native; a failed build or
an ABI mismatch raises when a flow decoder is made.
"""

import os
import queue
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from deepflow_tpu import native as ref_native
from deepflow_tpu.codec import FrameHeader as RefHeader
from deepflow_tpu.proto import pb
from deepflow_tpu.server import decoders as ref_decoders
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch import native
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.server.decoders import FlowLogDecoder, MetricsDecoder
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.tracetree import TraceTreeBuilder
from deepflow_tpu_torch.store.db import Database
from test_torch_retention import _table_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_760_000_000_000_000_000
WORDS = ("", "GET", "POST", "/api/v1/users", "svc.example", "核函数_ñ✓",
         "x" * 300, "HTTP/1.1", "select * from t")
CLOSE = ("", "fin", "rst", "timeout", "forced", "other")
FLOW_TABLES = ("flow_log.l4_flow_log", "flow_log.l7_flow_log")
DOC_TABLES = ("flow_metrics.network.1s", "flow_metrics.application.1s")
SEEDS = (0, 1, 2)


def _ip(rng, empty_p: float = 0.0) -> bytes:
    if rng.random() < empty_p:
        return b""
    return bytes([10, int(rng.integers(0, 3)), int(rng.integers(0, 4)),
                  int(rng.integers(1, 9))])


def _key(rng, empty_p: float, v6: bool = False) -> "pb.FlowKey":
    k = pb.FlowKey(port_src=int(rng.integers(1024, 65536)),
                   port_dst=int(rng.choice([80, 443, 8080, 3306])),
                   proto=int(rng.integers(0, 4)),
                   tap_port=int(rng.integers(0, 3)),
                   tunnel_type=int(rng.integers(0, 5)),
                   tunnel_id=int(rng.integers(0, 3)))
    if v6:
        k.ip_src = b"\x20\x01\x0d\xb8" + bytes(11) + b"\x01"
        k.ip_dst = b"\x20\x01\x0d\xb8" + bytes(11) + b"\x02"
    else:
        k.ip_src, k.ip_dst = _ip(rng, empty_p), _ip(rng, empty_p)
    return k


def _word(rng) -> str:
    return WORDS[int(rng.integers(0, len(WORDS)))]


def flow_batch(seed: int, n_l4: int = 60, n_l7: int = 80,
               empty_p: float = 0.1, v6: bool = False) -> bytes:
    """L4 and L7 rows of one FlowLogBatch. Each field is set or left out
    at random; a third of the L7 rows carry a trace of four spans."""
    rng = np.random.default_rng(seed)
    batch = pb.FlowLogBatch()
    for i in range(n_l4):
        f = batch.l4.add(flow_id=int(rng.integers(1, 1 << 40)),
                         start_time_ns=T0 + i * 1000,
                         end_time_ns=T0 + i * 1000 + int(
                             rng.integers(0, 10**9)))
        if rng.random() < 0.9 or (v6 and i == n_l4 // 2):
            f.key.CopyFrom(_key(rng, empty_p, v6 and i == n_l4 // 2))
        for name in ("packet_tx", "packet_rx", "byte_tx", "byte_rx",
                     "l7_request", "l7_response", "rtt_us", "art_us",
                     "retrans_tx", "retrans_rx", "zero_win_tx",
                     "zero_win_rx", "syn_count", "synack_count", "gpid_0",
                     "gpid_1"):
            if rng.random() < 0.7:
                setattr(f, name, int(rng.integers(0, 1 << 20)))
        f.close_type = CLOSE[int(rng.integers(0, len(CLOSE)))]
        if rng.random() < 0.3:
            f.pod_0, f.pod_1 = _word(rng), _word(rng)
    for i in range(n_l7):
        f = batch.l7.add(flow_id=int(rng.integers(1, 1 << 40)),
                         l7_protocol=int(rng.integers(0, 8)),
                         start_time_ns=T0 + i * 7000)
        f.end_time_ns = f.start_time_ns + int(rng.integers(-5, 10**6))
        if rng.random() < 0.9:
            f.key.CopyFrom(_key(rng, empty_p))
        for name in ("version", "request_type", "request_domain",
                     "request_resource", "endpoint", "response_exception",
                     "response_result", "x_request_id", "process_kname_0",
                     "process_kname_1", "attrs_json", "pod_0", "pod_1"):
            if rng.random() < 0.6:
                setattr(f, name, _word(rng))
        for name in ("request_id", "response_status",
                     "syscall_trace_id_request", "syscall_trace_id_response",
                     "syscall_thread_0", "syscall_thread_1",
                     "captured_request_byte", "captured_response_byte",
                     "gpid_0", "gpid_1"):
            if rng.random() < 0.6:
                setattr(f, name, int(rng.integers(0, 5 if name ==
                                                  "response_status"
                                                  else 1 << 20)))
        f.response_code = int(rng.choice([0, 200, 404, 500, -1]))
        if i % 3 == 0:
            trace = i // 12
            f.trace_id = f"{seed:08x}{trace:024x}"
            f.span_id = f"{i:016x}"
            if i % 12:
                f.parent_span_id = f"{i - 3:016x}"
    return batch.SerializeToString()


def doc_batch(seed: int, n: int = 120, empty_p: float = 0.1,
              v6: bool = False) -> bytes:
    """Documents with a flow meter, an app meter, both, or neither (some
    meters present but empty), from a seed."""
    rng = np.random.default_rng(seed)
    batch = pb.DocumentBatch()
    for i in range(n):
        d = batch.docs.add(timestamp_s=1_760_000_000 + i // 4,
                           interval_s=1)
        d.tag.ip_src, d.tag.ip_dst = _ip(rng, empty_p), _ip(rng, empty_p)
        if v6 and i == n // 2:
            d.tag.ip_dst = b"\x20\x01\x0d\xb8" + bytes(11) + b"\x02"
        d.tag.port = int(rng.choice([80, 443, 8080]))
        d.tag.proto = int(rng.integers(0, 4))
        d.tag.l7_protocol = int(rng.integers(0, 8))
        d.tag.direction = int(rng.integers(0, 3))
        if rng.random() < 0.4:
            d.tag.app_service = _word(rng)
        kind = int(rng.integers(0, 4))
        if kind in (1, 3):
            d.flow_meter.SetInParent()
            for name in ("packet_tx", "packet_rx", "byte_tx", "byte_rx",
                         "flow_count", "new_flow", "closed_flow",
                         "rtt_sum_us", "rtt_count", "retrans", "syn_count",
                         "synack_count"):
                if rng.random() < 0.7:
                    setattr(d.flow_meter, name, int(rng.integers(0, 1 << 30)))
        if kind in (2, 3):
            d.app_meter.SetInParent()
            for name in ("request", "response", "rrt_sum_us", "rrt_count",
                         "rrt_max_us", "error_client", "error_server",
                         "timeout"):
                if rng.random() < 0.7:
                    setattr(d.app_meter, name, int(rng.integers(0, 1 << 40)))
    return batch.SerializeToString()


# -- the decoders' columns against the reference's ---------------------------

def _same_columns(got: dict, want: dict, n: int) -> None:
    assert set(want) <= set(got), set(want) - set(got)
    for name, w in want.items():
        assert np.array_equal(got[name][:n].astype(np.int64),
                              w[:n].astype(np.int64)), name


@pytest.mark.parametrize("seed", SEEDS)
def test_l4_columns_equal_reference(seed):
    payload = flow_batch(seed)
    n, cols, n_l7, arena = native.L4ColumnDecoder().decode(payload)
    rn, rcols, rsegs, rarena = ref_native.L4ColumnDecoder().decode(payload)
    assert n == rn == 60 and n_l7 == len(rsegs) == 80
    _same_columns(cols, rcols, n)
    assert bytes(arena) == bytes(rarena)


@pytest.mark.parametrize("seed", SEEDS)
def test_l7_columns_equal_reference(seed):
    payload = flow_batch(seed)
    n, cols, arena = native.L7ColumnDecoder().decode(payload)
    rn, rcols, rarena = ref_native.L7ColumnDecoder().decode(payload)
    assert n == rn == 80
    _same_columns(cols, rcols, n)
    assert bytes(arena) == bytes(rarena)


@pytest.mark.parametrize("seed", SEEDS)
def test_doc_columns_equal_reference(seed):
    payload = doc_batch(seed)
    n, cols, arena = native.DocColumnDecoder().decode(payload)
    rn, rcols, rarena = ref_native.DocColumnDecoder().decode(payload)
    assert n == rn == 120
    _same_columns(cols, rcols, n)
    assert bytes(arena) == bytes(rarena)


def test_buffers_grow_to_the_batch_and_stay_native():
    """Decoders made with room for two rows take a batch of hundreds:
    the rows and the arena grow to it, and the columns are the ones a
    roomy decoder gives."""
    payload, docs = flow_batch(5, 300, 400), doc_batch(5, 500)
    for cls, data in ((native.L4ColumnDecoder, payload),
                      (native.L7ColumnDecoder, payload),
                      (native.DocColumnDecoder, docs)):
        small = cls(cap=2, arena_cap=16).decode(data)
        big = cls().decode(data)
        assert small[0] == big[0] > 2
        _same_columns(small[1], big[1], small[0])


# -- rows through the decoders -----------------------------------------------

HEADER = FrameHeader(msg_type=MessageType.L4_LOG, agent_id=3, org_id=1)


def _decoder(cls, **kw):
    return cls(queue.Queue(), Database(), PlatformInfoTable(), **kw)


def _ref_rows(payload: bytes, cls, mtype, pb_path: bool) -> dict:
    db = RefDatabase()
    dec = cls(queue.Queue(), db, RefPlatform())
    header = RefHeader(msg_type=mtype, agent_id=3, org_id=1)
    if pb_path:
        dec._handle_pb(pb.FlowLogBatch.FromString(payload), header)
    else:
        dec.handle(header, payload)
    return db


@pytest.mark.parametrize("seed", SEEDS)
def test_flow_rows_native_equal_pure_and_reference(seed):
    """The native path's L4 and L7 rows equal the port's pure path's
    and the reference's protobuf path's (empty addresses as "" in all
    three), and the batch counts as native."""
    payload = flow_batch(seed)
    nat, pure = _decoder(FlowLogDecoder), _decoder(FlowLogDecoder)
    assert nat.handle(HEADER, payload) == 140
    assert pure.handle_pure(HEADER, payload) == 140
    assert nat.stats["native_batches"] == 1
    assert nat.stats["pure_batches"] == 0
    ref = _ref_rows(payload, ref_decoders.FlowLogDecoder,
                    MessageType.L4_LOG, pb_path=True)
    for name in FLOW_TABLES:
        got = _table_rows(nat.db.table(name))
        assert got == _table_rows(pure.db.table(name)), name
        assert got == _table_rows(ref.table(name)), name
        assert len(got) == (60 if "l4" in name else 80)


@pytest.mark.parametrize("seed", SEEDS)
def test_doc_rows_native_equal_pure_and_reference(seed):
    payload = doc_batch(seed)
    nat, pure = _decoder(MetricsDecoder), _decoder(MetricsDecoder)
    header = FrameHeader(msg_type=MessageType.METRICS, agent_id=3, org_id=1)
    n = nat.handle(header, payload)
    assert n == pure.handle_pure(header, payload) > 0
    assert (nat.stats["native_batches"], nat.stats["pure_batches"]) == (1, 0)
    ref = _ref_rows(payload, ref_decoders.MetricsDecoder,
                    MessageType.METRICS, pb_path=False)
    for name in DOC_TABLES:
        got = _table_rows(nat.db.table(name))
        assert got == _table_rows(pure.db.table(name)), name
        assert got == _table_rows(ref.table(name)), name


def test_uint32_meters_keep_their_low_32_bits_as_protobuf_does():
    """FlowMeter's rtt_sum_us .. synack_count are uint32 on the wire: a
    varint past 32 bits keeps its low bits on both port paths."""
    from deepflow_tpu_torch.proto import wire
    d = wire.Document(timestamp_s=5)
    d.flow_meter.packet_tx = 1 << 40
    # rtt_sum_us (field 8) = 2**33 + 7, appended inside the flow meter
    extra = bytes([8 << 3]) + bytes([0x87, 0x80, 0x80, 0x80, 0x20])
    meter = d.flow_meter.SerializeToString() + extra
    body = bytes([1 << 3, 5]) + bytes([3 << 3 | 2, len(meter)]) + meter
    payload = bytes([1 << 3 | 2, len(body)]) + body
    header = FrameHeader(msg_type=MessageType.METRICS, agent_id=1)
    nat, pure = _decoder(MetricsDecoder), _decoder(MetricsDecoder)
    nat.handle(header, payload)
    pure.handle_pure(header, payload)
    t = "flow_metrics.network.1s"
    assert _table_rows(nat.db.table(t)) == _table_rows(pure.db.table(t))
    assert int(nat.db.table(t).column_concat(["rtt_sum"])["rtt_sum"][0]) == 7


def test_trace_tree_spans_equal_on_both_paths():
    payload = flow_batch(4)
    got = []
    for path in ("handle", "handle_pure"):
        trees = TraceTreeBuilder(None)
        dec = _decoder(FlowLogDecoder, trace_trees=trees)
        getattr(dec, path)(HEADER, payload)
        got.append({t: trees.pending_spans(t) for t in trees._pending})
    assert got[0] == got[1] and len(got[0]) == 7
    assert all(len(spans) == 4 for spans in list(got[0].values())[:-1])


def test_several_workers_write_every_row_once(monkeypatch):
    """``WORKERS`` workers (here 6, more than this test's frames
    need, with a short switch interval) drain one queue, each with its
    own native buffers: every frame's rows land once, the same rows as
    one thread writes, in some order."""
    monkeypatch.setattr(FlowLogDecoder, "WORKERS", 6)
    payloads = [flow_batch(100 + i, 40, 50) for i in range(24)]
    one = _decoder(FlowLogDecoder)
    for p in payloads:
        one.handle(HEADER, p)
    many = _decoder(FlowLogDecoder)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        many.start()
        for p in payloads:
            many.q.put([(HEADER, p)])
        deadline = time.monotonic() + 60
        while many.stats["batches"] < len(payloads) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        threads = list(many._threads)
        many.stop()
    finally:
        sys.setswitchinterval(old)
    assert len(threads) == 6 and not any(t.is_alive() for t in threads)
    assert many.stats["batches"] == len(payloads)
    assert many.stats["native_batches"] == len(payloads)
    for name in FLOW_TABLES:
        assert sorted(_table_rows(many.db.table(name))) == \
            sorted(_table_rows(one.db.table(name)))


@pytest.mark.parametrize("cls,make,mtype", [
    (FlowLogDecoder, flow_batch, MessageType.L4_LOG),
    (MetricsDecoder, doc_batch, MessageType.METRICS)])
def test_full_address_memo_resets_without_losing_a_batch(monkeypatch, cls,
                                                         make, mtype):
    """The address memo one short of its bound: the next batches, each
    with many new addresses, cross it (L4, then L7 or the documents'
    two sides) and still write the pure path's rows."""
    from deepflow_tpu_torch.server import decoders
    monkeypatch.setattr(decoders, "_IP_MEMO_MAX", 16)
    header = FrameHeader(msg_type=mtype, agent_id=3, org_id=1)
    nat, pure = _decoder(cls), _decoder(cls)
    nat._ip_memo.update((0xC0A80000 + i, "192.168.0.%d" % i)
                        for i in range(15))
    for seed in SEEDS:
        payload = make(seed)
        assert nat.handle(header, payload) == \
            pure.handle_pure(header, payload) > 0
    assert nat.stats["errors"] == 0
    assert nat.stats["native_batches"] == len(SEEDS)
    for name in (FLOW_TABLES if cls is FlowLogDecoder else DOC_TABLES):
        assert _table_rows(nat.db.table(name)) == \
            _table_rows(pure.db.table(name)), name


# -- batches that leave the native path --------------------------------------

def test_ipv6_batch_takes_the_pure_path():
    """One IPv6 row sends the whole batch down the pure path, as the
    reference routes v6 to protobuf; its rows equal the pure path's and
    print the v6 address."""
    for cls, payload, tables in (
            (FlowLogDecoder, flow_batch(7, v6=True), FLOW_TABLES),
            (MetricsDecoder, doc_batch(7, v6=True), DOC_TABLES)):
        dec, pure = _decoder(cls), _decoder(cls)
        assert dec.handle(HEADER, payload) == \
            pure.handle_pure(HEADER, payload)
        assert (dec.stats["native_batches"],
                dec.stats["pure_batches"]) == (0, 1)
        for name in tables:
            assert _table_rows(dec.db.table(name)) == \
                _table_rows(pure.db.table(name))
        rows = _table_rows(dec.db.table(tables[0])) + \
            _table_rows(dec.db.table(tables[1]))
        assert any("2001:db8::" in str(r) for r in rows)


def _bad_utf8(payload: bytes, word: bytes) -> bytes:
    i = payload.index(word)
    return payload[:i] + b"\xff" + payload[i + 1:]


MALFORMED = {
    "truncated": lambda p: p[:-3],
    "bad_wire_type": lambda p: p + bytes([3 << 3 | 7]),
    "invalid_utf8": lambda p: _bad_utf8(p, b"svc.example"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
@pytest.mark.parametrize("which", ["flow", "doc"])
def test_malformed_batch_takes_the_pure_path_and_raises(case, which):
    cls, payload = ((FlowLogDecoder, flow_batch(8)) if which == "flow"
                    else (MetricsDecoder, doc_batch(8)))
    bad = MALFORMED[case](payload)
    dec = _decoder(cls)
    with pytest.raises(Exception):
        dec.handle(HEADER, bad)
    assert (dec.stats["native_batches"], dec.stats["pure_batches"]) == (0, 1)
    assert all(len(dec.db.table(t)) == 0 for t in FLOW_TABLES + DOC_TABLES)


def test_tag_past_32_bits_leaves_the_native_path():
    """An unknown field whose tag is past 32 bits: the native decoder
    refuses it, the pure path skips it and writes the batch's rows."""
    payload = flow_batch(9)
    tag = bytes([0x80, 0x80, 0x80, 0x80, 0x10])  # field 2**29, varint
    bad = payload + tag + bytes([1])
    dec, pure = _decoder(FlowLogDecoder), _decoder(FlowLogDecoder)
    assert dec.handle(HEADER, bad) == pure.handle_pure(HEADER, payload)
    assert dec.stats["pure_batches"] == 1
    for name in FLOW_TABLES:
        assert _table_rows(dec.db.table(name)) == \
            _table_rows(pure.db.table(name))


# -- the build ---------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import queue, sys
    from deepflow_tpu_torch import native
    from deepflow_tpu_torch.server import decoders
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.store.db import Database
    native._DIR, native.BUILD_DIR = sys.argv[1], sys.argv[1] + "/_build"
    cls = getattr(decoders, sys.argv[2])
    try:
        cls(queue.Queue(), Database(), PlatformInfoTable())
        print("BUILT")
    except native.NativeLibraryError as e:
        print("RAISED", e)
""")

_ABI_LINE = f"return {native.ABI_VERSION}; }}"


@pytest.mark.parametrize("cls", ["FlowLogDecoder", "MetricsDecoder"])
@pytest.mark.parametrize("edit,expect", [
    (("df_decode_l4_cols(", "df_decode_l4_cols_broken("), "RAISED"),
    ((_ABI_LINE, "return 3; }"), "has ABI 3"),
])
def test_flow_decoder_raises_on_a_failed_build_or_abi(tmp_path, cls, edit,
                                                      expect):
    """A library without the flow decoders (an old build of the sources)
    or of the previous ABI raises when a flow decoder is made: there is
    no pure fallback for the whole decoder."""
    for name in native.SOURCES + native.HEADERS:
        with open(os.path.join(ROOT, "deepflow_tpu_torch", "native",
                               name)) as f:
            text = f.read()
        if edit[0] in text:
            text = text.replace(edit[0], edit[1])
        (tmp_path / name).write_text(text)
    out = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), cls],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("RAISED") and expect in out.stdout, \
        out.stdout


def test_selfcheck_and_verify_abi_say_every_path_is_live():
    """``python -m deepflow_tpu_torch.native``: both commands exit 0,
    and the self-check names the flow decoders live."""
    for flag in ("--selfcheck", "--verify-abi"):
        out = subprocess.run([sys.executable, "-m",
                              "deepflow_tpu_torch.native", flag], cwd=ROOT,
                             capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stdout + out.stderr
    assert "L4 flow-log columnar decode : live" in subprocess.run(
        [sys.executable, "-m", "deepflow_tpu_torch.native", "--selfcheck"],
        cwd=ROOT, capture_output=True, text=True, timeout=240).stdout
