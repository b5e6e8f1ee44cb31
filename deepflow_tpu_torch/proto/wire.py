"""Dependency-free protobuf codec for the messages the agent ships.

Encodes and decodes ``TpuSpan``, ``TpuMemorySample``, ``TpuSpanBatch``,
``Profile``, ``ProfileBatch``, ``StatsMetric`` and ``StatsBatch`` of
``deepflow_tpu/proto/messages.proto`` without the protobuf package: the
fields are written in field-number order and proto3 defaults (0, "", b"")
are skipped, so ``TpuSpanBatch`` and ``ProfileBatch`` serialize to the
same bytes as the generated classes. ``StatsMetric``'s two maps are
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
