"""Dependency-free protobuf codec for the device-span messages.

Encodes and decodes ``TpuSpan``, ``TpuMemorySample`` and ``TpuSpanBatch``
of ``deepflow_tpu/proto/messages.proto`` without the protobuf package: the
fields are written in field-number order and proto3 defaults (0, "") are
skipped, so ``TpuSpanBatch.SerializeToString()`` gives the same bytes as
the generated class. Unknown fields are skipped on decode.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import IntEnum


class TpuSpanKind(IntEnum):
    SPAN_UNKNOWN = 0
    DEVICE_COMPUTE = 1      # kernel on the SMs
    DEVICE_COLLECTIVE = 2   # NCCL all-reduce / all-gather / ...
    DEVICE_TRANSFER = 3     # memcpy / memset
    HOST_RUNTIME = 4
    HOST_COMPILE = 5


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


def _schema(cls, widths: dict[str, int]) -> tuple:
    """(name, field number, "u" varint | "s" string, max value) per field;
    the dataclass fields are declared in field-number order."""
    out = []
    for num, f in enumerate(dataclasses.fields(cls), start=1):
        kind = "s" if f.type == "str" else "u"
        out.append((f.name, num, kind, widths.get(f.name, _U64)))
    return tuple(out)


_SPAN_SCHEMA = _schema(TpuSpan, {
    n: _U32 for n in ("device_id", "chip_id", "core_id", "slice_id", "kind",
                      "program_id", "run_id", "replica_group_size", "pid")})
_MEM_SCHEMA = _schema(TpuMemorySample, {
    n: _U32 for n in ("device_id", "num_allocs", "pid")})


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _encode_msg(msg, schema) -> bytes:
    out = bytearray()
    for name, num, kind, vmax in schema:
        v = getattr(msg, name)
        if kind == "s":
            if v:
                b = v.encode()
                out += _varint(num << 3 | 2) + _varint(len(b)) + b
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
    """(field number, value) for each field; varints as int, length-
    delimited as bytes, fixed widths skipped."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        num, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            yield num, v
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise WireError("truncated bytes")
            yield num, buf[i:i + ln]
            i += ln
        elif wt in (1, 5):
            i += 8 if wt == 1 else 4
            if i > n:
                raise WireError("truncated fixed field")
        else:
            raise WireError(f"unsupported wire type {wt}")


def _decode_msg(buf: bytes, cls, schema):
    by_num = {num: (name, kind) for name, num, kind, _ in schema}
    msg = cls()
    for num, v in _iter_fields(buf):
        spec = by_num.get(num)
        if spec is None:
            continue
        name, kind = spec
        if kind == "s":
            if not isinstance(v, bytes):
                raise WireError(f"{name}: expected a string")
            setattr(msg, name, v.decode("utf-8"))
        else:
            if not isinstance(v, int):
                raise WireError(f"{name}: expected a varint")
            setattr(msg, name, v)
    return msg


@dataclass
class TpuSpanBatch:
    spans: list = field(default_factory=list)
    memory: list = field(default_factory=list)

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf's name)
        out = bytearray()
        for num, items, schema in ((1, self.spans, _SPAN_SCHEMA),
                                   (2, self.memory, _MEM_SCHEMA)):
            for m in items:
                b = _encode_msg(m, schema)
                out += _varint(num << 3 | 2) + _varint(len(b)) + b
        return bytes(out)

    @classmethod
    def FromString(cls, data) -> "TpuSpanBatch":  # noqa: N802
        batch = cls()
        for num, v in _iter_fields(bytes(data)):
            if num == 1:
                batch.spans.append(_decode_msg(v, TpuSpan, _SPAN_SCHEMA))
            elif num == 2:
                batch.memory.append(
                    _decode_msg(v, TpuMemorySample, _MEM_SCHEMA))
        return batch
