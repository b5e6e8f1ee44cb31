"""The port's flow messages (``proto/wire.py``) held against protobuf's
generated classes of the JAX package: the same fields, filled at random
from a seed, serialize to the same bytes, and the same bytes (with
unknown fields and fields of the wrong wire type among them) parse to
the same fields."""

import numpy as np
import pytest

from deepflow_tpu.proto import pb
from deepflow_tpu_torch.proto import wire

MESSAGES = ("FlowKey", "L4FlowLog", "L7FlowLog", "FlowLogBatch",
            "MetricTag", "FlowMeter", "AppMeter", "Document",
            "DocumentBatch")
SEEDS = range(4)
WORDS = ("", "GET", "/api/v1/users?id=7", "redis", "élan", "数据",
         "x" * 300)


def _pick(values: list, rng):
    return values[int(rng.integers(len(values)))]


def _value(kind: str, rng):
    if kind == "u32":
        return _pick([0, 1, 127, 128, (1 << 32) - 1,
                      int(rng.integers(0, 1 << 32))], rng)
    if kind == "u64":
        return _pick([0, 1, (1 << 64) - 1,
                      int(rng.integers(0, 1 << 62)) * 4 + 3], rng)
    if kind in ("i32", "enum"):
        lo = -(1 << 31) if kind == "i32" else 0
        return _pick([0, -1 if kind == "i32" else 1, 31,
                      int(rng.integers(lo, 1 << 31))], rng)
    if kind == "s":
        return _pick(WORDS, rng)
    return bytes(rng.integers(0, 256, int(rng.integers(0, 17)),
                              dtype=np.uint8))


def _fill(port, ref, rng) -> None:
    """The same random values into both; a field left out keeps its
    default, and a submessage may end up present but empty (a zero set
    into it)."""
    for f in type(port).FIELDS:
        name, _, kind = f[:3]
        if kind == "msg":
            r = rng.random()
            if r < 0.6:
                _fill(getattr(port, name), getattr(ref, name), rng)
            elif r < 0.8:
                sub = f[3].FIELDS[0]
                zero = "" if sub[2] == "s" else b"" if sub[2] == "b" else 0
                setattr(getattr(port, name), sub[0], zero)
                setattr(getattr(ref, name), sub[0], zero)
        elif kind == "rep":
            for _ in range(int(rng.integers(0, 4))):
                sub = f[3]()
                _fill(sub, getattr(ref, name).add(), rng)
                getattr(port, name).append(sub)
        elif rng.random() < 0.75:
            v = _value(kind, rng)
            setattr(port, name, v)
            setattr(ref, name, v)


def _fields(msg, cls) -> dict:
    """Every field of a port or a protobuf message by the port's schema,
    submessages as (present, fields)."""
    out = {}
    for f in cls.FIELDS:
        name, _, kind = f[:3]
        if kind == "msg":
            out[name] = (msg.HasField(name),
                         _fields(getattr(msg, name), f[3]))
        elif kind == "rep":
            out[name] = [_fields(m, f[3]) for m in getattr(msg, name)]
        else:
            v = getattr(msg, name)
            out[name] = bytes(v) if kind == "b" else v
    return out


def _pair(name: str, seed: int):
    port, ref = getattr(wire, name)(), getattr(pb, name)()
    _fill(port, ref, np.random.default_rng(seed))
    return port, ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", MESSAGES)
def test_bytes_equal_protobuf(name, seed):
    port, ref = _pair(name, seed)
    cls = getattr(wire, name)
    assert _fields(port, cls) == _fields(ref, cls)
    data = ref.SerializeToString()
    assert port.SerializeToString() == data
    back = cls.FromString(data)
    assert back == port
    assert _fields(back, cls) == _fields(ref, cls)


# a varint field 99, a fixed64 field 98, a fixed32 field 97 and a
# length-delimited field 96 (unknown everywhere); then field 1 of every
# message again as a varint and field 2 as a fixed32, wire types that no
# field of these messages has at 1 or 2 but for the varints (which then
# parse as a field's new last value)
UNKNOWN = (bytes([0x98, 0x06, 0x05]) + bytes([0x91, 0x06]) + b"\x01" * 8
           + bytes([0x8D, 0x06]) + b"\x02" * 4 + bytes([0x82, 0x06, 0x02])
           + b"ab")
WRONG_TYPE = bytes([0x08, 0x05, 0x15]) + b"\x03\x00\x00\x00"


@pytest.mark.parametrize("name", MESSAGES)
def test_unknown_and_wrong_type_fields_parse_as_protobuf(name):
    port, ref = _pair(name, seed=11)
    cls = getattr(wire, name)
    for tail in (UNKNOWN, WRONG_TYPE, UNKNOWN + WRONG_TYPE):
        data = ref.SerializeToString() + tail
        want = getattr(pb, name).FromString(data)
        got = cls.FromString(data)
        assert _fields(got, cls) == _fields(want, cls)


@pytest.mark.parametrize("field,raw,want", [
    # a uint32 keeps its low 32 bits, an int32 or an enum its low 32 bits
    # as a signed value, as protobuf parses them
    ("port_src", (1 << 40) + 5, 5),
    ("proto", (1 << 32) - 1, -1),
    ("proto", (1 << 35) + 2, 2),
])
def test_varints_wider_than_their_field(field, raw, want):
    num = next(f[1] for f in wire.FlowKey.FIELDS if f[0] == field)
    data = bytes(wire._varint(num << 3)) + wire._varint(raw)
    assert getattr(pb.FlowKey.FromString(data), field) == want
    assert getattr(wire.FlowKey.FromString(data), field) == want


def test_submessage_presence_follows_protobuf():
    """Reading a submessage creates nothing; setting any field of it, a
    zero too, makes it (and its parents) present, and a present empty
    submessage is written; assignment to a submessage is refused."""
    for cls in (wire, pb):
        d = cls.Document()
        m = d.flow_meter
        assert not d.HasField("flow_meter")
        assert d.SerializeToString() == b""
        m.packet_tx = 0
        assert d.HasField("flow_meter")
        assert d.SerializeToString() == b"\x1a\x00"
        b = cls.DocumentBatch()
        if cls is wire:
            b.docs.append(cls.Document())
        else:
            b.docs.add()
        assert b.SerializeToString() == b"\x0a\x00"
        with pytest.raises(AttributeError):
            d.flow_meter = cls.FlowMeter()
    with pytest.raises(AttributeError):
        wire.FlowKey().no_such_field = 1
    with pytest.raises(wire.WireError):
        wire.FlowKey(port_src=1 << 32).SerializeToString()
    f = wire.L7FlowLog(response_code=-1)
    assert f.SerializeToString() == pb.L7FlowLog(
        response_code=-1).SerializeToString()


def test_enum_constants_are_protobufs():
    for enum in (wire.L4Protocol, wire.L7Protocol, wire.ResponseStatus):
        for e in enum:
            assert getattr(wire, e.name) == getattr(pb, e.name) == e
    assert len(wire.L7Protocol) == len(pb.L7Protocol.keys())
