"""Minimal protobuf wire-format reader for the L7 parsers of protocols
that carry protobuf (Pulsar commands, bRPC metadata).

Own copy of ``deepflow_tpu/tpuprobe/pbwire.py``: field traversal without
descriptors (varint, 64-bit, length-delimited, 32-bit).
"""

from __future__ import annotations

import struct
from typing import Iterator


class WireError(Exception):
    pass


def read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if i >= len(buf):
            raise WireError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, i
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). Length-delimited values are
    raw bytes (caller decides: submessage, string, packed)."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = read_varint(buf, i)
            yield field, wt, v
        elif wt == 1:
            if i + 8 > n:
                raise WireError("truncated fixed64")
            yield field, wt, struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wt == 2:
            ln, i = read_varint(buf, i)
            if i + ln > n:
                raise WireError("truncated bytes")
            yield field, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:
            if i + 4 > n:
                raise WireError("truncated fixed32")
            yield field, wt, struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise WireError(f"unsupported wire type {wt}")


def fields_dict(buf: bytes) -> dict[int, list]:
    """Group repeated fields: {field_number: [values...]}."""
    out: dict[int, list] = {}
    for f, _, v in iter_fields(buf):
        out.setdefault(f, []).append(v)
    return out


def first(d: dict[int, list], field: int, default=None):
    v = d.get(field)
    return v[0] if v else default


def as_str(v, default: str = "") -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return default if v is None else str(v)


def zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def f64(v: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]
