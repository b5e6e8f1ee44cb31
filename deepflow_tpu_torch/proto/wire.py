"""Dependency-free protobuf codec for the messages the agent ships.

Encodes and decodes ``TpuSpan``, ``TpuMemorySample``, ``TpuSpanBatch``,
``Profile``, ``ProfileBatch``, ``StatsMetric``, ``StatsBatch``, ``Event``
and ``EventBatch`` of
``deepflow_tpu/proto/messages.proto``, and its flow messages (``FlowKey``,
``L4FlowLog``, ``L7FlowLog``, ``FlowLogBatch``, ``MetricTag``,
``FlowMeter``, ``AppMeter``, ``Document``, ``DocumentBatch``, on
``PbMessage`` below, with the ``L4Protocol``, ``L7Protocol`` and
``ResponseStatus`` enums), and its control-plane messages (below
``SyncRequest``; messages.proto:333-529), the pcap upload (``PcapUpload``)
and the labeler's feed (``PodMapRequest``, ``PodMapEntry``,
``PodMapResponse``; messages.proto:513-554), without the protobuf package: the
fields are written in field-number order and proto3 defaults (0, "", b"")
are skipped, so ``TpuSpanBatch`` and ``ProfileBatch`` serialize to the
same bytes as the generated classes. ``StatsMetric``'s two maps and
``Event``'s ``attrs`` are
written in their dicts' order, each entry with its key and value; map
order on the wire is not fixed, so only the parsed messages compare.
Decoding parses as protobuf does: unknown fields, and known ones of
another wire type, are skipped, and a varint keeps the low bits its
field's width holds.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from dataclasses import dataclass, field
from enum import IntEnum


class TpuSpanKind(IntEnum):
    SPAN_UNKNOWN = 0
    DEVICE_COMPUTE = 1      # kernel on the SMs
    DEVICE_COLLECTIVE = 2   # NCCL all-reduce / all-gather / ...
    DEVICE_TRANSFER = 3     # memcpy / memset
    HOST_RUNTIME = 4
    HOST_COMPILE = 5


class ProfileEventType(IntEnum):
    PROFILE_EVENT_UNKNOWN = 0
    ON_CPU = 1
    OFF_CPU = 2
    MEM_ALLOC = 3
    TPU_DEVICE = 4
    TPU_HOST = 5


SPAN_UNKNOWN = TpuSpanKind.SPAN_UNKNOWN
DEVICE_COMPUTE = TpuSpanKind.DEVICE_COMPUTE
DEVICE_COLLECTIVE = TpuSpanKind.DEVICE_COLLECTIVE
DEVICE_TRANSFER = TpuSpanKind.DEVICE_TRANSFER
HOST_RUNTIME = TpuSpanKind.HOST_RUNTIME
HOST_COMPILE = TpuSpanKind.HOST_COMPILE

_U32 = (1 << 32) - 1
_U64 = (1 << 64) - 1


class WireError(ValueError):
    pass


@dataclass
class TpuSpan:
    start_ns: int = 0
    duration_ns: int = 0
    device_id: int = 0
    chip_id: int = 0
    core_id: int = 0
    slice_id: int = 0
    hlo_module: str = ""
    hlo_op: str = ""
    hlo_category: str = ""
    kind: int = 0
    flops: int = 0
    bytes_accessed: int = 0
    program_id: int = 0
    run_id: int = 0
    collective: str = ""
    bytes_transferred: int = 0
    replica_group_size: int = 0
    step: int = 0
    pid: int = 0
    process_name: str = ""


@dataclass
class TpuMemorySample:
    timestamp_ns: int = 0
    device_id: int = 0
    bytes_in_use: int = 0
    peak_bytes_in_use: int = 0
    bytes_limit: int = 0
    largest_free_block: int = 0
    num_allocs: int = 0
    pid: int = 0
    process_name: str = ""


@dataclass
class Profile:
    process_name: str = ""
    app_service: str = ""
    pid: int = 0
    tid: int = 0
    thread_name: str = ""
    event_type: int = 0     # ProfileEventType
    timestamp_ns: int = 0
    stack: bytes = b""      # folded: root;frame;...;leaf
    value: int = 0          # microseconds or bytes
    count: int = 0
    container_id: str = ""
    profiler: str = ""


def _schema(cls, widths: dict[str, int]) -> tuple:
    """(name, field number, "u" varint | "s" string | "b" bytes, max
    value) per field; the dataclass fields are declared in field-number
    order."""
    out = []
    for num, f in enumerate(dataclasses.fields(cls), start=1):
        kind = {"str": "s", "bytes": "b"}.get(f.type, "u")
        out.append((f.name, num, kind, widths.get(f.name, _U64)))
    return tuple(out)


_SPAN_SCHEMA = _schema(TpuSpan, {
    n: _U32 for n in ("device_id", "chip_id", "core_id", "slice_id", "kind",
                      "program_id", "run_id", "replica_group_size", "pid")})
_MEM_SCHEMA = _schema(TpuMemorySample, {
    n: _U32 for n in ("device_id", "num_allocs", "pid")})
_PROFILE_SCHEMA = _schema(Profile, {
    n: _U32 for n in ("pid", "tid", "event_type", "count")})


_SMALL_VARINTS = tuple(bytes((v,)) for v in range(0x80))


def _varint(v: int) -> bytes:
    if 0 <= v < 0x80:
        return _SMALL_VARINTS[v]
    if 0 < v < 0x4000:
        return bytes((v & 0x7F | 0x80, v >> 7))
    if v >> 28:
        # nanosecond times: the low four groups vary from span to span,
        # the high ones change every 2**28 ns, so theirs are kept
        return bytes((v & 0x7F | 0x80, v >> 7 & 0x7F | 0x80,
                      v >> 14 & 0x7F | 0x80, v >> 21 & 0x7F | 0x80)) \
            + _high_varint(v >> 28)
    out = bytearray()
    while v > 0x7F:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


@functools.lru_cache(maxsize=256)
def _high_varint(v: int) -> bytes:
    return _varint(v)


def _len_field(num: int, b: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(b)) + b


def _encode_msg(msg, schema) -> bytes:
    out = bytearray()
    for name, num, kind, vmax in schema:
        v = getattr(msg, name)
        if kind in "sb":
            if v:
                out += _len_field(num, v.encode() if kind == "s" else v)
        elif v:
            v = int(v)
            if not 0 <= v <= vmax:
                raise WireError(f"{name}={v} out of range")
            out += _varint(num << 3) + _varint(v)
    return bytes(out)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = val = 0
    while True:
        if i >= len(buf):
            raise WireError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def _iter_fields(buf: bytes):
    """(field number, wire type, value) for each field; varints as int,
    length-delimited and fixed-width fields as their bytes."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        num, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            yield num, wt, v
            continue
        if wt == 2:
            ln, i = _read_varint(buf, i)
        elif wt in (1, 5):
            ln = 8 if wt == 1 else 4
        else:
            raise WireError(f"unsupported wire type {wt}")
        if i + ln > n:
            raise WireError("truncated field")
        yield num, wt, buf[i:i + ln]
        i += ln


def _decode_msg(buf: bytes, cls, schema):
    """As protobuf parses: a known field of another wire type is skipped
    like an unknown one, and a varint keeps the low bits its field's
    width holds; a string that is not UTF-8 raises."""
    by_num = {num: (name, kind, vmax) for name, num, kind, vmax in schema}
    msg = cls()
    for num, wt, v in _iter_fields(buf):
        spec = by_num.get(num)
        if spec is None:
            continue
        name, kind, vmax = spec
        if kind in "sb":
            if wt == 2:
                setattr(msg, name, v.decode("utf-8") if kind == "s" else v)
        elif wt == 0:
            setattr(msg, name, v & vmax)
    return msg


def encode_span(span: TpuSpan) -> bytes:
    """One TpuSpan message's bytes, without the batch's length prefix. The
    fields are written in number order, so the bytes of a span whose
    fields are split between several TpuSpans are those spans' bytes
    joined."""
    return _encode_msg(span, _SPAN_SCHEMA)


def uint_field(name: str, num: int, v: int) -> bytes:
    """One unsigned 64-bit field with its tag; nothing for 0."""
    if not v:
        return b""
    if not 0 <= v <= _U64:
        raise WireError(f"{name}={v} out of range")
    return _varint(num << 3) + _varint(v)


def span_entry(body: bytes) -> bytes:
    """A TpuSpan's bytes as one entry of TpuSpanBatch.spans."""
    return _len_field(1, body)


@dataclass
class TpuSpanBatch:
    spans: list = field(default_factory=list)
    memory: list = field(default_factory=list)

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf's name)
        out = bytearray()
        for num, items, schema in ((1, self.spans, _SPAN_SCHEMA),
                                   (2, self.memory, _MEM_SCHEMA)):
            for m in items:
                out += _len_field(num, _encode_msg(m, schema))
        return bytes(out)

    @classmethod
    def FromString(cls, data) -> "TpuSpanBatch":  # noqa: N802
        batch = cls()
        for num, wt, v in _iter_fields(bytes(data)):
            if num == 1 and wt == 2:
                batch.spans.append(_decode_msg(v, TpuSpan, _SPAN_SCHEMA))
            elif num == 2 and wt == 2:
                batch.memory.append(
                    _decode_msg(v, TpuMemorySample, _MEM_SCHEMA))
        return batch


@dataclass
class ProfileBatch:
    profiles: list = field(default_factory=list)

    def SerializeToString(self) -> bytes:  # noqa: N802
        return b"".join(_len_field(1, _encode_msg(p, _PROFILE_SCHEMA))
                        for p in self.profiles)

    @classmethod
    def FromString(cls, data) -> "ProfileBatch":  # noqa: N802
        return cls([_decode_msg(v, Profile, _PROFILE_SCHEMA)
                    for num, wt, v in _iter_fields(bytes(data))
                    if num == 1 and wt == 2])


@dataclass
class StatsMetric:
    name: str = ""
    timestamp_ns: int = 0
    tags: dict = field(default_factory=dict)     # str -> str
    values: dict = field(default_factory=dict)   # str -> float (double)

    def encode(self) -> bytes:
        out = bytearray()
        if self.name:
            out += _len_field(1, self.name.encode())
        if self.timestamp_ns:
            if not 0 <= self.timestamp_ns <= _U64:
                raise WireError(f"timestamp_ns={self.timestamp_ns} "
                                "out of range")
            out += _varint(2 << 3) + _varint(int(self.timestamp_ns))
        for k, v in self.tags.items():
            out += _len_field(3, _len_field(1, k.encode())
                              + _len_field(2, v.encode()))
        for k, v in self.values.items():
            out += _len_field(4, _len_field(1, k.encode()) + _varint(2 << 3 | 1)
                              + struct.pack("<d", float(v)))
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "StatsMetric":
        m = cls()
        for num, wt, v in _iter_fields(buf):
            if num == 1 and wt == 2:
                m.name = v.decode("utf-8")
            elif num == 2 and wt == 0:
                m.timestamp_ns = v
            elif num in (3, 4) and wt == 2:
                key, val = _map_entry(v, num)
                (m.tags if num == 3 else m.values)[key] = val
        return m


def _map_entry(buf: bytes, num: int) -> tuple:
    """(key, value) of one map entry; an entry may leave either out, and
    then it takes its default."""
    key, val = "", "" if num == 3 else 0.0
    for f, wt, v in _iter_fields(buf):
        if f == 1 and wt == 2:
            key = v.decode("utf-8")
        elif f == 2 and num == 3 and wt == 2:
            val = v.decode("utf-8")
        elif f == 2 and num == 4 and wt == 1:
            val = struct.unpack("<d", v)[0]
    return key, val


@dataclass
class StatsBatch:
    metrics: list = field(default_factory=list)

    def SerializeToString(self) -> bytes:  # noqa: N802
        return b"".join(_len_field(1, m.encode()) for m in self.metrics)

    @classmethod
    def FromString(cls, data) -> "StatsBatch":  # noqa: N802
        return cls([StatsMetric.decode(v)
                    for num, wt, v in _iter_fields(bytes(data))
                    if num == 1 and wt == 2])



@dataclass
class Event:
    """A resource or process event (messages.proto:315-323); a file-I/O
    event carries ``latency_ns`` and ``bytes`` in ``attrs``."""
    timestamp_ns: int = 0
    event_type: str = ""
    resource_type: str = ""
    resource_name: str = ""
    pid: int = 0
    description: str = ""
    attrs: dict = field(default_factory=dict)    # str -> str

    def encode(self) -> bytes:
        out = bytearray(_encode_msg(self, _EVENT_SCHEMA))
        for k, v in self.attrs.items():
            out += _len_field(7, _len_field(1, k.encode())
                              + _len_field(2, v.encode()))
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Event":
        e = _decode_msg(buf, cls, _EVENT_SCHEMA)
        e.attrs = {}
        for num, wt, v in _iter_fields(buf):
            if num == 7 and wt == 2:
                key, val = _map_entry(v, 3)
                e.attrs[key] = val
        return e


_EVENT_SCHEMA = (("timestamp_ns", 1, "u", _U64), ("event_type", 2, "s", 0),
                 ("resource_type", 3, "s", 0), ("resource_name", 4, "s", 0),
                 ("pid", 5, "u", _U32), ("description", 6, "s", 0))


@dataclass
class EventBatch:
    events: list = field(default_factory=list)

    def SerializeToString(self) -> bytes:  # noqa: N802
        return b"".join(_len_field(1, e.encode()) for e in self.events)

    @classmethod
    def FromString(cls, data) -> "EventBatch":  # noqa: N802
        return cls([Event.decode(v)
                    for num, wt, v in _iter_fields(bytes(data))
                    if num == 1 and wt == 2])

# -- flow logs and metric documents ------------------------------------------
# messages.proto:147-297. The agent's flow path fills these field by field,
# as it fills protobuf's generated classes, so they follow protobuf's
# rules: reading a submessage creates it empty, setting any field of it
# (a zero too) makes it present in its parent, and a present submessage is
# written even when empty. Fields go out in field-number order with proto3
# defaults skipped, so the bytes are protobuf's.


class L4Protocol(IntEnum):
    L4_UNKNOWN = 0
    TCP = 1
    UDP = 2
    ICMP = 3


class L7Protocol(IntEnum):
    L7_UNKNOWN = 0
    HTTP1 = 1
    HTTP2 = 2
    GRPC = 3
    DNS = 4
    MYSQL = 5
    REDIS = 6
    KAFKA = 7
    POSTGRESQL = 8
    MONGODB = 9
    MEMCACHED = 10
    MQTT = 11
    AMQP = 12
    NATS = 13
    DUBBO = 14
    FASTCGI = 15
    TLS = 16
    PING = 17
    ROCKETMQ = 18
    SOFARPC = 19
    ZMTP = 20
    OPENWIRE = 21
    TARS = 22
    BRPC = 23
    ORACLE = 24
    DAMENG = 25
    ISO8583 = 26
    NETSIGN = 27
    WEBSPHEREMQ = 28
    SOMEIP = 29
    PULSAR = 30


class ResponseStatus(IntEnum):
    STATUS_UNKNOWN = 0
    OK = 1
    CLIENT_ERROR = 2
    SERVER_ERROR = 3
    TIMEOUT = 4


# the enums' values as module constants, as protobuf's generated module
# has them (the parsers write ``pb.HTTP1``, ``pb.L7_UNKNOWN``)
globals().update({e.name: int(e) for enum in
                  (L4Protocol, L7Protocol, ResponseStatus) for e in enum})

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_SCALAR_DEFAULTS = {"s": "", "b": b"", "u32": 0, "u64": 0, "i32": 0,
                    "enum": 0, "f64": 0.0, "bool": False, "os64": 0}
# repeated scalars: "rs" strings, "ru32" / "ri32" packed varints
_REP_SCALARS = ("rs", "ru32", "ri32")
_INT_RANGES = {"u32": (0, _U32), "u64": (0, _U64), "i32": (_I32_MIN, _I32_MAX),
               "enum": (_I32_MIN, _I32_MAX), "ru32": (0, _U32),
               "ri32": (_I32_MIN, _I32_MAX), "os64": (_I64_MIN, _I64_MAX)}
_ZERO_F64 = bytes(8)


def _int_in_range(name: str, kind: str, v) -> int:
    v = int(v)
    lo, hi = _INT_RANGES[kind]
    if not lo <= v <= hi:
        raise WireError(f"{name}={v} out of range")
    return v


def _narrow(kind: str, v: int) -> int:
    """A parsed varint as protobuf keeps it for the field's type."""
    if kind in ("u32", "ru32"):
        return v & _U32
    if kind in ("i32", "enum", "ri32"):
        v &= _U32
        return v - (1 << 32) if v > _I32_MAX else v
    return v & _U64


class _SubMessage:
    """A singular message field: created empty on first read; assigning
    to it is an error, as in protobuf."""

    def __init__(self, name: str, cls) -> None:
        self.name, self.key, self.cls = name, "_m_" + name, cls

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        d = obj.__dict__
        m = d.get(self.key)
        if m is None:
            m = d[self.key] = self.cls()
            m.__dict__["_up"] = (obj, self.name)
        return m

    def __set__(self, obj, value) -> None:
        raise AttributeError(
            f"assignment to submessage field {self.name!r} is not allowed")


class PbMessage:
    """Base of the flow and control-plane messages. ``FIELDS`` lists
    (name, number, kind) or (name, number, "msg" | "rep", class) in number
    order; kinds are "u32", "u64", "i32", "enum" (int32 on the wire),
    "f64" (double), "bool", "s", "b", "os64" (an ``optional sint64``: its
    presence is kept, so a set 0 is written and ``HasField`` tells it from
    an absent one) and the repeated scalars "rs" (strings), "ru32" and
    "ri32" (packed varints)."""

    FIELDS: tuple = ()

    def __init_subclass__(cls) -> None:
        cls._scalars = {}
        cls._reps = []
        cls._optional = set()
        cls._plan = []
        for f in cls.FIELDS:
            name, num, kind = f[:3]
            if kind == "msg":
                setattr(cls, name, _SubMessage(name, f[3]))
                cls._plan.append((name, kind, _varint(num << 3 | 2), f[3]))
                continue
            if kind == "rep" or kind in _REP_SCALARS:
                cls._reps.append(name)
                cls._plan.append((name, kind, _varint(num << 3 | 2),
                                  f[3] if kind == "rep" else None))
                continue
            cls._scalars[name] = _SCALAR_DEFAULTS[kind]
            if kind == "os64":
                cls._optional.add(name)
            wt = 2 if kind in ("s", "b") else 1 if kind == "f64" else 0
            cls._plan.append((name, kind, _varint(num << 3 | wt), None))
        cls._by_num = {f[1]: (f[0], f[2], f[3] if len(f) > 3 else None)
                       for f in cls.FIELDS}

    def __init__(self, **fields) -> None:
        d = self.__dict__
        d.update(self._scalars)
        d["_up"] = None
        d["_present"] = set()
        for name in self._reps:
            d[name] = []
        for k, v in fields.items():
            if isinstance(type(self).__dict__.get(k), _SubMessage):
                getattr(self, k).CopyFrom(v)  # as protobuf's constructor
            else:
                setattr(self, k, v)

    def __setattr__(self, name: str, value) -> None:
        d = self.__dict__
        if name in self._reps:
            d[name] = list(value)
        elif name in self._scalars:
            d[name] = value
            if name in self._optional:
                d["_present"].add(name)
        else:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        up = d["_up"]
        if up is not None:
            d["_up"] = None
            up[0]._mark(up[1])

    def _mark(self, name: str) -> None:
        """A submessage got a field: it and this message's own chain of
        parents are present from now on."""
        d = self.__dict__
        d["_present"].add(name)
        up = d["_up"]
        if up is not None:
            d["_up"] = None
            up[0]._mark(up[1])

    def HasField(self, name: str) -> bool:  # noqa: N802 (protobuf's name)
        if name not in self._optional and not isinstance(
                type(self).__dict__.get(name), _SubMessage):
            raise ValueError(f"{name!r} is not a singular message field")
        return name in self.__dict__["_present"]

    def CopyFrom(self, other: "PbMessage") -> None:  # noqa: N802
        """This message becomes a copy of ``other`` (and, as a
        submessage, present in its parent)."""
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom({type(other).__name__}) into "
                            f"{type(self).__name__}")
        d = self.__dict__
        d.update(self._scalars)
        d["_present"] = set()
        for name in self._reps:
            d[name] = []
        for f in self.FIELDS:
            d.pop("_m_" + f[0], None)
        self._merge(other.SerializeToString())
        up = d["_up"]
        if up is not None:
            d["_up"] = None
            up[0]._mark(up[1])

    def _encode(self, out: bytearray) -> None:
        d = self.__dict__
        for name, kind, tag, _ in self._plan:
            if kind == "msg":
                if name in d["_present"]:
                    body = bytearray()
                    d["_m_" + name]._encode(body)
                    out += tag
                    out += _varint(len(body))
                    out += body
            elif kind == "rep":
                for m in d[name]:
                    body = bytearray()
                    m._encode(body)
                    out += tag
                    out += _varint(len(body))
                    out += body
            elif kind == "rs":
                for v in d[name]:
                    b = v.encode()
                    out += tag
                    out += _varint(len(b))
                    out += b
            elif kind in ("ru32", "ri32"):
                if d[name]:
                    body = b"".join(
                        _varint(_int_in_range(name, kind, v) & _U64)
                        for v in d[name])
                    out += tag
                    out += _varint(len(body))
                    out += body
            elif kind == "os64":
                if name in d["_present"]:
                    v = _int_in_range(name, kind, d[name])
                    out += tag
                    out += _varint(((v << 1) ^ (v >> 63)) & _U64)
            elif kind == "f64":
                b = struct.pack("<d", float(d[name]))
                if b != _ZERO_F64:  # -0.0 is written, as protobuf does
                    out += tag
                    out += b
            else:
                v = d[name]
                if not v:
                    continue
                out += tag
                if kind == "s":
                    b = v.encode()
                    out += _varint(len(b))
                    out += b
                elif kind == "b":
                    out += _varint(len(v))
                    out += v
                elif kind == "bool":
                    out += b"\x01"
                else:
                    out += _varint(_int_in_range(name, kind, v) & _U64)

    def SerializeToString(self) -> bytes:  # noqa: N802
        out = bytearray()
        self._encode(out)
        return bytes(out)

    @classmethod
    def FromString(cls, data) -> "PbMessage":  # noqa: N802
        """As protobuf parses: unknown fields and known ones of another
        wire type are skipped, a uint32 keeps its low 32 bits and an
        int32 or enum its low 32 bits as a signed value; a repeated
        submessage appends, a singular one merges; a packed repeated
        varint field also parses unpacked."""
        msg = cls()
        msg._merge(bytes(data))
        return msg

    def _merge(self, buf: bytes) -> None:
        d = self.__dict__
        by_num = self._by_num
        for num, wt, v in _iter_fields(buf):
            spec = by_num.get(num)
            if spec is None:
                continue
            name, kind, sub = spec
            if kind in ("ru32", "ri32"):
                if wt == 2:
                    i = 0
                    while i < len(v):
                        x, i = _read_varint(v, i)
                        d[name].append(_narrow(kind, x))
                elif wt == 0:
                    d[name].append(_narrow(kind, v))
            elif kind == "f64":
                if wt == 1:
                    d[name] = struct.unpack("<d", v)[0]
            elif kind in ("s", "b", "rs", "msg", "rep"):
                if wt != 2:
                    continue
                if kind == "s":
                    d[name] = v.decode("utf-8")
                elif kind == "b":
                    d[name] = v
                elif kind == "rs":
                    d[name].append(v.decode("utf-8"))
                elif kind == "msg":
                    d["_present"].add(name)
                    getattr(self, name)._merge(v)
                else:
                    m = sub()
                    m._merge(v)
                    d[name].append(m)
            elif wt == 0:
                if kind == "bool":
                    d[name] = bool(v)
                elif kind == "os64":
                    v &= _U64
                    d[name] = (v >> 1) ^ -(v & 1)
                    d["_present"].add(name)
                else:
                    d[name] = _narrow(kind, v)

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and \
            self.SerializeToString() == other.SerializeToString()

    def __repr__(self) -> str:
        d = self.__dict__
        parts = [f"{n}={d[n]!r}" for n in self._scalars
                 if d[n] or n in d["_present"]]
        parts += [f"{f[0]}={getattr(self, f[0])!r}" for f in self.FIELDS
                  if f[2] == "msg" and f[0] in d["_present"]]
        parts += [f"{n}=[{len(d[n])}]" for n in self._reps if d[n]]
        return f"{type(self).__name__}({', '.join(parts)})"


class FlowKey(PbMessage):
    FIELDS = (("ip_src", 1, "b"), ("ip_dst", 2, "b"),
              ("port_src", 3, "u32"), ("port_dst", 4, "u32"),
              ("proto", 5, "enum"), ("tap_port", 6, "u32"),
              ("tunnel_type", 7, "u32"), ("tunnel_id", 8, "u32"))


class L4FlowLog(PbMessage):
    FIELDS = (("flow_id", 1, "u64"), ("key", 2, "msg", FlowKey),
              ("start_time_ns", 3, "u64"), ("end_time_ns", 4, "u64"),
              ("packet_tx", 5, "u64"), ("packet_rx", 6, "u64"),
              ("byte_tx", 7, "u64"), ("byte_rx", 8, "u64"),
              ("l7_request", 9, "u64"), ("l7_response", 10, "u64"),
              ("rtt_us", 11, "u32"), ("art_us", 12, "u32"),
              ("retrans_tx", 13, "u32"), ("retrans_rx", 14, "u32"),
              ("zero_win_tx", 15, "u32"), ("zero_win_rx", 16, "u32"),
              ("close_type", 17, "s"), ("tcp_flags_bit_tx", 18, "u32"),
              ("tcp_flags_bit_rx", 19, "u32"), ("syn_count", 20, "u32"),
              ("synack_count", 21, "u32"), ("agent_id", 22, "u32"),
              ("gpid_0", 23, "u32"), ("gpid_1", 24, "u32"),
              ("pod_0", 25, "s"), ("pod_1", 26, "s"))


class L7FlowLog(PbMessage):
    FIELDS = (("flow_id", 1, "u64"), ("key", 2, "msg", FlowKey),
              ("l7_protocol", 3, "enum"), ("version", 4, "s"),
              ("request_type", 5, "s"), ("request_domain", 6, "s"),
              ("request_resource", 7, "s"), ("endpoint", 8, "s"),
              ("request_id", 9, "u32"), ("response_status", 10, "enum"),
              ("response_code", 11, "i32"), ("response_exception", 12, "s"),
              ("response_result", 13, "s"), ("start_time_ns", 14, "u64"),
              ("end_time_ns", 15, "u64"), ("trace_id", 16, "s"),
              ("span_id", 17, "s"), ("parent_span_id", 18, "s"),
              ("x_request_id", 19, "s"),
              ("syscall_trace_id_request", 20, "u64"),
              ("syscall_trace_id_response", 21, "u64"),
              ("syscall_thread_0", 22, "u32"),
              ("syscall_thread_1", 23, "u32"),
              ("captured_request_byte", 24, "u64"),
              ("captured_response_byte", 25, "u64"),
              ("agent_id", 26, "u32"), ("gpid_0", 27, "u32"),
              ("gpid_1", 28, "u32"), ("process_kname_0", 29, "s"),
              ("process_kname_1", 30, "s"), ("attrs_json", 31, "s"),
              ("pod_0", 32, "s"), ("pod_1", 33, "s"))


class FlowLogBatch(PbMessage):
    FIELDS = (("l4", 1, "rep", L4FlowLog), ("l7", 2, "rep", L7FlowLog))


class MetricTag(PbMessage):
    FIELDS = (("ip_src", 1, "b"), ("ip_dst", 2, "b"), ("port", 3, "u32"),
              ("proto", 4, "enum"), ("l7_protocol", 5, "enum"),
              ("agent_id", 6, "u32"), ("app_service", 7, "s"),
              ("gpid_0", 8, "u32"), ("gpid_1", 9, "u32"),
              ("direction", 10, "u32"))


class FlowMeter(PbMessage):
    FIELDS = (("packet_tx", 1, "u64"), ("packet_rx", 2, "u64"),
              ("byte_tx", 3, "u64"), ("byte_rx", 4, "u64"),
              ("flow_count", 5, "u64"), ("new_flow", 6, "u64"),
              ("closed_flow", 7, "u64"), ("rtt_sum_us", 8, "u32"),
              ("rtt_count", 9, "u32"), ("retrans", 10, "u32"),
              ("syn_count", 11, "u32"), ("synack_count", 12, "u32"))


class AppMeter(PbMessage):
    FIELDS = (("request", 1, "u64"), ("response", 2, "u64"),
              ("rrt_sum_us", 3, "u64"), ("rrt_count", 4, "u64"),
              ("rrt_max_us", 5, "u64"), ("error_client", 6, "u64"),
              ("error_server", 7, "u64"), ("timeout", 8, "u64"))


class Document(PbMessage):
    FIELDS = (("timestamp_s", 1, "u64"), ("tag", 2, "msg", MetricTag),
              ("flow_meter", 3, "msg", FlowMeter),
              ("app_meter", 4, "msg", AppMeter), ("interval_s", 5, "u32"))


class DocumentBatch(PbMessage):
    FIELDS = (("docs", 1, "rep", Document),)


# -- the control plane --------------------------------------------------------
# messages.proto:333-529: agent <-> controller sync, NTP, gpids and the
# Prometheus id allocator. The reference carries them over gRPC; the port
# carries the same bytes over HTTP/1.1 (server/syncwire.py).


class AgentState(IntEnum):
    ENV_UNKNOWN = 0
    RUNNING = 1
    DISABLED = 2
    DEGRADED = 3    # the resource guard has paused the profilers


class SyncStatus(IntEnum):
    SYNC_UNKNOWN = 0
    SUCCESS = 1
    FAILED = 2
    HEARTBEAT = 3


globals().update({e.name: int(e) for enum in (AgentState, SyncStatus)
                  for e in enum})


class TpuDeviceInfo(PbMessage):
    FIELDS = (("device_id", 1, "u32"), ("chip_id", 2, "u32"),
              ("core_id", 3, "u32"), ("slice_id", 4, "u32"),
              ("device_kind", 5, "s"), ("coords", 6, "ri32"),
              ("hbm_bytes", 7, "u64"))


class PlatformData(PbMessage):
    FIELDS = (("hostname", 1, "s"), ("host_ip", 2, "s"),
              ("host_id", 3, "u32"), ("pod_name", 4, "s"),
              ("pod_namespace", 5, "s"), ("node_name", 6, "s"),
              ("cluster_id", 7, "s"), ("tpu_pod_name", 8, "s"),
              ("tpu_worker_id", 9, "s"), ("slice_count", 10, "u32"),
              ("devices", 11, "rep", TpuDeviceInfo),
              ("accelerator_type", 12, "s"), ("runtime_version", 13, "s"))


class ProcessInfo(PbMessage):
    FIELDS = (("pid", 1, "u32"), ("name", 2, "s"), ("cmdline", 3, "s"),
              ("start_time_ns", 4, "u64"), ("container_id", 5, "s"),
              ("gpid", 6, "u32"))


class RemoteCommand(PbMessage):
    FIELDS = (("id", 1, "u64"), ("cmd", 2, "s"), ("args", 3, "rs"))


class CommandResult(PbMessage):
    FIELDS = (("id", 1, "u64"), ("exit_code", 2, "i32"), ("output", 3, "s"))


class SyncRequest(PbMessage):
    """``launcher_id`` (18) is the port's own field: the launcher's
    identity of a rank (``tpuprobe/ranks.py::launcher_identity``), which
    tells apart the agents of one host that the reference's registry
    keys by host alone. The reference's parser skips it as unknown."""
    FIELDS = (("ctrl_ip", 1, "s"), ("ctrl_mac", 2, "s"),
              ("hostname", 3, "s"), ("agent_id", 4, "u32"),
              ("config_version", 5, "u64"), ("platform_version", 6, "u64"),
              ("state", 7, "enum"), ("exception_bitmap", 8, "u64"),
              ("platform", 9, "msg", PlatformData),
              ("processes", 10, "rep", ProcessInfo), ("version", 11, "s"),
              ("cpu_usage", 12, "f64"), ("mem_bytes", 13, "u64"),
              ("agent_group", 14, "s"), ("config_epoch", 15, "u64"),
              ("command_results", 16, "rep", CommandResult),
              ("clock_offset_ns", 17, "os64"), ("launcher_id", 18, "s"))


class NtpRequest(PbMessage):
    FIELDS = (("t1_ns", 1, "u64"),)


class NtpResponse(PbMessage):
    FIELDS = (("t1_ns", 1, "u64"), ("t2_ns", 2, "u64"), ("t3_ns", 3, "u64"))


class QosDirective(PbMessage):
    FIELDS = (("pressure_level", 1, "u32"), ("sample_rate", 2, "f64"),
              ("weight", 3, "u32"), ("rate_fps", 4, "f64"),
              ("updated_ns", 5, "u64"))


class GpidEntry(PbMessage):
    FIELDS = (("agent_id", 1, "u32"), ("pid", 2, "u32"), ("gpid", 3, "u32"),
              ("ip", 4, "b"), ("port", 5, "u32"), ("proto", 6, "enum"),
              ("role", 7, "u32"), ("process_name", 8, "s"))


class SyncResponse(PbMessage):
    FIELDS = (("status", 1, "enum"), ("agent_id", 2, "u32"),
              ("user_config_yaml", 3, "b"), ("config_version", 4, "u64"),
              ("platform", 5, "msg", PlatformData),
              ("platform_version", 6, "u64"),
              ("gpid_table", 7, "rep", GpidEntry),
              ("config_epoch", 8, "u64"),
              ("commands", 9, "rep", RemoteCommand),
              ("analyzer_addrs", 10, "rs"),
              ("analyzer_assignment", 11, "bool"),
              ("qos", 12, "msg", QosDirective))


class GpidSyncRequest(PbMessage):
    FIELDS = (("agent_id", 1, "u32"), ("entries", 2, "rep", GpidEntry))


class GpidSyncResponse(PbMessage):
    FIELDS = (("entries", 1, "rep", GpidEntry),)


class PromEncodeRequest(PbMessage):
    FIELDS = (("metric_names", 1, "rs"), ("label_sets", 2, "rs"))


class PromEncodeResponse(PbMessage):
    FIELDS = (("metric_ids", 1, "ru32"), ("label_set_ids", 2, "ru32"))


class PcapUpload(PbMessage):
    """An agent's rolling capture of the frames a pcap ACL matched."""
    FIELDS = (("name", 1, "s"), ("agent_id", 2, "u32"),
              ("start_ns", 3, "u64"), ("packet_count", 4, "u32"),
              ("pcap_gz", 5, "b"))


class PodMapRequest(PbMessage):
    FIELDS = (("version", 1, "u64"), ("epoch", 2, "u64"))


class PodMapEntry(PbMessage):
    FIELDS = (("cidr", 1, "s"), ("pod", 2, "s"), ("namespace", 3, "s"),
              ("workload", 4, "s"), ("node", 5, "s"))


class PodMapResponse(PbMessage):
    FIELDS = (("version", 1, "u64"), ("epoch", 2, "u64"),
              ("entries", 3, "rep", PodMapEntry))
