"""Minimal MessagePack codec (decode + encode of the core types).

Own copy of ``deepflow_tpu/utils/msgpack.py``: pure byte code,
the same bytes in and out.

Used for Datadog trace ingest (dd-trace agents ship msgpack on
/v0.3/traces and /v0.4/traces — reference analog:
agent/src/integration_collector.rs:893) without a msgpack dependency.
Spec: the public MessagePack format specification.
"""

from __future__ import annotations

import struct


class MsgpackError(ValueError):
    pass


def _need(buf: bytes, i: int, n: int) -> None:
    if i + n > len(buf):
        raise MsgpackError("truncated msgpack")


# dd-trace payloads are at most a few levels deep; a bound keeps a
# crafted body of nested fixarrays from hitting Python's recursion limit
# (which would surface as a 500 instead of a 400 MsgpackError).
_MAX_DEPTH = 100


def _decode(buf: bytes, i: int, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise MsgpackError("msgpack nesting too deep")
    _need(buf, i, 1)
    b = buf[i]
    i += 1
    if b <= 0x7F:                       # positive fixint
        return b, i
    if b >= 0xE0:                       # negative fixint
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:               # fixmap
        return _decode_map(buf, i, b & 0x0F, depth + 1)
    if 0x90 <= b <= 0x9F:               # fixarray
        return _decode_array(buf, i, b & 0x0F, depth + 1)
    if 0xA0 <= b <= 0xBF:               # fixstr
        n = b & 0x1F
        _need(buf, i, n)
        return buf[i:i + n].decode("utf-8", "replace"), i + n
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    if b in (0xC4, 0xC5, 0xC6):         # bin8/16/32
        w = 1 << (b - 0xC4)
        _need(buf, i, w)
        n = int.from_bytes(buf[i:i + w], "big")
        i += w
        _need(buf, i, n)
        return buf[i:i + n], i + n
    if b == 0xCA:
        _need(buf, i, 4)
        return struct.unpack_from(">f", buf, i)[0], i + 4
    if b == 0xCB:
        _need(buf, i, 8)
        return struct.unpack_from(">d", buf, i)[0], i + 8
    if b in (0xCC, 0xCD, 0xCE, 0xCF):   # uint8/16/32/64
        w = 1 << (b - 0xCC)
        _need(buf, i, w)
        return int.from_bytes(buf[i:i + w], "big"), i + w
    if b in (0xD0, 0xD1, 0xD2, 0xD3):   # int8/16/32/64
        w = 1 << (b - 0xD0)
        _need(buf, i, w)
        return int.from_bytes(buf[i:i + w], "big", signed=True), i + w
    if b in (0xD9, 0xDA, 0xDB):         # str8/16/32
        w = 1 << (b - 0xD9)
        _need(buf, i, w)
        n = int.from_bytes(buf[i:i + w], "big")
        i += w
        _need(buf, i, n)
        return buf[i:i + n].decode("utf-8", "replace"), i + n
    if b in (0xDC, 0xDD):               # array16/32
        w = 2 << (b - 0xDC)
        _need(buf, i, w)
        n = int.from_bytes(buf[i:i + w], "big")
        return _decode_array(buf, i + w, n, depth + 1)
    if b in (0xDE, 0xDF):               # map16/32
        w = 2 << (b - 0xDE)
        _need(buf, i, w)
        n = int.from_bytes(buf[i:i + w], "big")
        return _decode_map(buf, i + w, n, depth + 1)
    raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")


def _decode_array(buf: bytes, i: int, n: int, depth: int = 0):
    out = []
    for _ in range(n):
        v, i = _decode(buf, i, depth)
        out.append(v)
    return out, i


def _decode_map(buf: bytes, i: int, n: int, depth: int = 0):
    out = {}
    for _ in range(n):
        k, i = _decode(buf, i, depth)
        if isinstance(k, (list, dict)):
            # unhashable key would raise TypeError -> generic 500 at the
            # HTTP layer; crafted input must stay a 400 MsgpackError
            raise MsgpackError("container msgpack map key")
        v, i = _decode(buf, i, depth)
        out[k] = v
    return out, i


def unpackb(buf: bytes):
    v, i = _decode(buf, 0)
    if i != len(buf):
        raise MsgpackError(f"{len(buf) - i} trailing bytes")
    return v


def packb(obj) -> bytes:
    """Encode the core types (tests + exporters)."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            for code, w in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if obj < (1 << (8 * w)):
                    out.append(code)
                    out += obj.to_bytes(w, "big")
                    return
            raise MsgpackError("uint too large")
        else:
            for code, w in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
                if -(1 << (8 * w - 1)) <= obj:
                    out.append(code)
                    out += obj.to_bytes(w, "big", signed=True)
                    return
            raise MsgpackError("int too small")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode()
        if len(b) <= 0x1F:
            out.append(0xA0 | len(b))
        elif len(b) < (1 << 8):
            out += bytes([0xD9, len(b)])
        elif len(b) < (1 << 16):
            out.append(0xDA)
            out += len(b).to_bytes(2, "big")
        else:
            out.append(0xDB)
            out += len(b).to_bytes(4, "big")
        out += b
    elif isinstance(obj, bytes):
        if len(obj) < (1 << 8):
            out += bytes([0xC4, len(obj)])
        elif len(obj) < (1 << 16):
            out.append(0xC5)
            out += len(obj).to_bytes(2, "big")
        else:
            out.append(0xC6)
            out += len(obj).to_bytes(4, "big")
        out += obj
    elif isinstance(obj, (list, tuple)):
        if len(obj) <= 0x0F:
            out.append(0x90 | len(obj))
        elif len(obj) < (1 << 16):
            out.append(0xDC)
            out += len(obj).to_bytes(2, "big")
        else:
            out.append(0xDD)
            out += len(obj).to_bytes(4, "big")
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        if len(obj) <= 0x0F:
            out.append(0x80 | len(obj))
        elif len(obj) < (1 << 16):
            out.append(0xDE)
            out += len(obj).to_bytes(2, "big")
        else:
            out.append(0xDF)
            out += len(obj).to_bytes(4, "big")
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    else:
        raise MsgpackError(f"cannot encode {type(obj).__name__}")
