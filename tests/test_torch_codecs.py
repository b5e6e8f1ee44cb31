"""The port's wire codecs (``deepflow_tpu_torch/utils/``) held against
the JAX package's: snappy, the Prometheus ``WriteRequest``, InfluxDB
lines, MessagePack and the Kafka producer's messages must give the
reference's bytes and parses on the same seeded inputs, and raise where
the reference raises. Pure byte code: no server, socket or wait.
"""

import math
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepflow_tpu.utils import influxline as ref_influx
from deepflow_tpu.utils import kafkawire as ref_kafka
from deepflow_tpu.utils import msgpack as ref_msgpack
from deepflow_tpu.utils import promwire as ref_promwire
from deepflow_tpu.utils import snappy as ref_snappy
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.utils import influxline, kafkawire, msgpack, \
    promwire, snappy


def _payloads(seed: int) -> list[bytes]:
    """Seeded payloads: empty, short, repetitive, random, and long enough
    for the compressor's 65,536-byte literal runs and 2- and 3-byte
    literal lengths."""
    rng = np.random.default_rng(seed)
    return [b"", b"a", b"hello world " * 100,
            rng.integers(0, 256, 59, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, 61, dtype=np.uint8).tobytes(),
            rng.integers(0, 4, 300, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, 140_001, dtype=np.uint8).tobytes()]


# -- snappy -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_snappy_compress_gives_the_references_bytes(seed):
    for data in _payloads(seed):
        out = snappy.compress(data)
        assert out == ref_snappy.compress(data)
        assert snappy.decompress(out) == data
        assert ref_snappy.decompress(out) == data


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=4096))
def test_snappy_round_trips_like_the_reference(data):
    out = snappy.compress(data)
    assert out == ref_snappy.compress(data)
    assert snappy.decompress(out) == ref_snappy.decompress(out) == data


def test_snappy_copies_and_overlaps():
    """Copy elements with 1-, 2- and 4-byte offsets, an overlapping copy
    (run-length), decoded by both."""
    streams = [
        bytes([12, 0x0C]) + b"abcd" + bytes([0x11, 0x04]),  # copy1
        bytes([10, 0x00]) + b"x" + bytes([(8 << 2) | 2, 1, 0]),  # copy2 run
        bytes([8, 0x0C]) + b"wxyz" + bytes([(3 << 2) | 3, 4, 0, 0, 0]),
    ]
    for s in streams:
        assert snappy.decompress(s) == ref_snappy.decompress(s)
    assert snappy.decompress(streams[1]) == b"x" * 10


@pytest.mark.parametrize("bad", [
    b"\x0a\xfc", bytes([4, 0x11, 0x04]), b"\xff" * 6, bytes([3, 0x08]),
    bytes([5, 0x04]) + b"ab", bytes([2, 0x04]) + b"abcd",
    bytes([8, 0x0C]) + b"abcd" + bytes([0x11, 0x09])])
def test_snappy_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ref_snappy.SnappyError) as want:
        ref_snappy.decompress(bad)
    with pytest.raises(snappy.SnappyError) as got:
        snappy.decompress(bad)
    assert str(got.value) == str(want.value)


# -- Prometheus WriteRequest --------------------------------------------------

def _series(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 6))):
        labels = {f"l{j}": f"v{int(rng.integers(0, 9))}"
                  for j in range(int(rng.integers(0, 4)))}
        samples = [(int(1_700_000_000_000 + rng.integers(0, 10**6)),
                    float(rng.normal() * 10 ** int(rng.integers(-3, 9))))
                   for _ in range(int(rng.integers(1, 4)))]
        out.append((f"metric_{i}_total", labels, samples))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_write_request_gives_the_references_bytes(seed):
    series = _series(seed)
    data = promwire.write_request(series)
    assert data == ref_promwire.write_request(series)
    assert promwire.timeseries(*series[0]) == \
        ref_promwire.timeseries(*series[0])
    # and it parses back to the series (labels sorted, name apart)
    from deepflow_tpu_torch.server.integration import parse_write_request
    got = parse_write_request(data)
    assert [(n, l) for n, l, _ in got] == \
        [(n, dict(sorted(l.items()))) for n, l, _ in series]
    assert [s for _, _, s in got] == [s for _, _, s in series]


def test_varint_and_its_refusal():
    for v in (0, 1, 127, 128, 300, 2**32, 2**63):
        assert promwire.varint(v) == ref_promwire.varint(v)
    with pytest.raises(ValueError):
        promwire.varint(-1)


# -- InfluxDB lines -----------------------------------------------------------

LINES = [
    "cpu,host=w0,cpu=cpu0 usage_idle=97.5,usage_user=1.25 "
    "1700000000000000000",
    'm value=42i,flag=t,ratio=0.5,name="disk one",n=7u',
    "disk\\ io,path=/var/lib\\,data used=1 1700000000000000001",
    'm msg="say \\"hi\\", x=1",v=2',
    "m a=true,b=FALSE,c=T,d=f,e=-3i,g=1e3,h=-0.0",
    "weird\\,name,tag\\ key=tag\\=value f\\ 1=1",
    "m v=inf", "m v=nan", "m v=1 notatime",
]
BAD_LINES = ["", "nofields", "m ", "m v=", 'm v="unterminated', "m, v=1",
             "m =1", "m v=1i2", "m v=1 1 2"]


def _point(p) -> tuple:
    fields = {k: ("nan" if isinstance(v, float) and math.isnan(v) else v,
                  type(v).__name__) for k, v in p.fields.items()}
    return p.measurement, p.tags, fields, p.timestamp_ns


@pytest.mark.parametrize("line", LINES + BAD_LINES)
def test_influx_line_parses_like_the_reference(line):
    try:
        want = ("ok", _point(ref_influx.parse_line(line)))
    except (ref_influx.LineProtocolError, ValueError) as e:
        want = ("error", type(e).__name__, str(e))
    try:
        got = ("ok", _point(influxline.parse_line(line)))
    except (influxline.LineProtocolError, ValueError) as e:
        got = ("error", type(e).__name__, str(e))
    assert got == want


def test_influx_lines_count_bad_lines_like_the_reference():
    text = "\n".join(LINES + BAD_LINES + ["# comment", "", "mem used=2i"])
    pts, bad = influxline.parse_lines(text)
    ref_pts, ref_bad = ref_influx.parse_lines(text)
    assert bad == ref_bad
    assert [_point(p) for p in pts] == [_point(p) for p in ref_pts]


# -- MessagePack --------------------------------------------------------------

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2**63), max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_objects = st.recursive(
    _scalars, lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=40)


@settings(max_examples=300, deadline=None)
@given(_objects)
def test_msgpack_packs_and_unpacks_like_the_reference(obj):
    data = msgpack.packb(obj)
    assert data == ref_msgpack.packb(obj)
    assert msgpack.unpackb(data) == ref_msgpack.unpackb(data)


def test_msgpack_reads_the_wide_forms_a_client_sends():
    """dd-trace writes fixed-width ints, 32-bit arrays and maps, float32
    and str8: the forms packb never makes."""
    blobs = [b"\xcd\x00\x05", b"\xd2\xff\xff\xff\xfe", b"\xca" +
             struct.pack(">f", 1.5), b"\xd9\x03abc",
             b"\xdd\x00\x00\x00\x02\x01\x02",
             b"\xdf\x00\x00\x00\x01\xa1k\xc3", b"\xc4\x02ab",
             b"\x92\x91\x81\xa4name\xa3web\x80"]
    for b in blobs:
        assert msgpack.unpackb(b) == ref_msgpack.unpackb(b)


@pytest.mark.parametrize("bad", [b"", b"\xc1", b"\x92\x01", b"\xd9\x05ab",
                                 b"\x01\x02", b"\x91" * 200 + b"\x01"])
def test_msgpack_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ref_msgpack.MsgpackError) as want:
        ref_msgpack.unpackb(bad)
    with pytest.raises(msgpack.MsgpackError) as got:
        msgpack.unpackb(bad)
    assert str(got.value) == str(want.value)


# -- Kafka --------------------------------------------------------------------

def test_kafka_message_sets_and_requests_give_the_references_bytes():
    msgs = [(None, b'{"a": 1}', 123), (b"key", b'{"b": 2}', 456),
            (None, b"", 0), (b"", b"x" * 1000, 2**40)]
    ms = kafkawire.message_set(msgs)
    assert ms == ref_kafka.message_set(msgs)
    assert kafkawire.produce_request("flows", 3, ms, 17) == \
        ref_kafka.produce_request("flows", 3, ms, 17)
    assert kafkawire.metadata_request(["a", "bb"], 9) == \
        ref_kafka.metadata_request(["a", "bb"], 9)


def _metadata_body(n_parts: int, topic_error: int = 0) -> bytes:
    out = struct.pack(">i", 1) + struct.pack(">i", 0)
    out += struct.pack(">h", 9) + b"127.0.0.1" + struct.pack(">i", 9092)
    out += struct.pack(">i", 1) + struct.pack(">h", topic_error)
    out += struct.pack(">h", 5) + b"flows" + struct.pack(">i", n_parts)
    for pid in range(n_parts):
        out += struct.pack(">hiii", 0, pid, 0, 1) + struct.pack(">i", 0)
        out += struct.pack(">i", 1) + struct.pack(">i", 0)
    return out


@pytest.mark.parametrize("n_parts,err", [(1, 0), (3, 0), (2, 5), (0, 3)])
def test_kafka_responses_parse_like_the_reference(n_parts, err):
    body = _metadata_body(n_parts, err)
    got = kafkawire.parse_metadata_response(body, "flows")
    want = ref_kafka.parse_metadata_response(body, "flows")
    assert (got.brokers, got.partition_leaders, got.topic_error) == \
        (want.brokers, want.partition_leaders, want.topic_error)
    produce = (struct.pack(">i", 1) + struct.pack(">h", 5) + b"flows"
               + struct.pack(">i", 1) + struct.pack(">ihqq", 1, err, 7, -1)
               + struct.pack(">i", 0))
    got = kafkawire.parse_produce_response(produce)
    want = ref_kafka.parse_produce_response(produce)
    assert (got.error_code, got.base_offset) == \
        (want.error_code, want.base_offset)
    assert kafkawire.error_name(err) == ref_kafka.error_name(err)
    assert kafkawire.RETRIABLE_ERRORS == ref_kafka.RETRIABLE_ERRORS


# -- EventBatch ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_event_batch_matches_protobuf(seed):
    """``wire.EventBatch`` against the reference's protobuf both ways:
    the parsed messages are equal (map order on the wire is not fixed)."""
    from deepflow_tpu.proto import pb
    rng = np.random.default_rng(seed)
    events = [wire.Event(
        timestamp_ns=int(rng.integers(0, 2**63)),
        event_type=str(rng.choice(["file-io-read", "process-start", ""])),
        resource_type="file", resource_name=f"/data/{i}",
        pid=int(rng.integers(0, 2**32)), description="d" * i,
        attrs={f"k{j}": str(j) for j in range(int(rng.integers(0, 4)))})
        for i in range(int(rng.integers(0, 6)))]
    data = wire.EventBatch(events).SerializeToString()
    ref = pb.EventBatch.FromString(data)
    assert [(e.timestamp_ns, e.event_type, e.resource_type,
             e.resource_name, e.pid, e.description, dict(e.attrs))
            for e in ref.events] == \
        [(e.timestamp_ns, e.event_type, e.resource_type, e.resource_name,
          e.pid, e.description, e.attrs) for e in events]
    back = wire.EventBatch.FromString(ref.SerializeToString())
    assert back == wire.EventBatch(events)
