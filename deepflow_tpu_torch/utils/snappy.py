"""Pure-Python snappy block-format decompressor.

Own copy of ``deepflow_tpu/utils/snappy.py``: pure byte code,
the same bytes in and out.

Prometheus remote-write bodies are snappy-compressed protobuf and the image
has no snappy library — so we implement the (small) block format:
a uvarint uncompressed length followed by elements tagged by the low 2 bits:
00 literal, 01 copy-1byte (3-bit len, 11-bit offset), 10 copy-2byte,
11 copy-4byte. Spec: google/snappy format_description.txt.
"""

from __future__ import annotations


class SnappyError(Exception):
    pass


def _read_uvarint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if i >= len(buf):
            raise SnappyError("truncated uvarint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, i
        shift += 7
        if shift > 35:
            raise SnappyError("uvarint too long")


def decompress(data: bytes) -> bytes:
    expected, i = _read_uvarint(data, 0)
    if expected > (1 << 30):
        raise SnappyError(f"implausible uncompressed size {expected}")
    out = bytearray()
    n = len(data)
    while i < n:
        tag = data[i]
        i += 1
        elem_type = tag & 0x3
        if elem_type == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if i + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[i:i + extra], "little")
                i += extra
            length += 1
            if i + length > n:
                raise SnappyError("truncated literal")
            out += data[i:i + length]
            i += length
            continue
        if elem_type == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if i >= n:
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[i]
            i += 1
        elif elem_type == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if i + 2 > n:
                raise SnappyError("truncated copy2")
            offset = int.from_bytes(data[i:i + 2], "little")
            i += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if i + 4 > n:
                raise SnappyError("truncated copy4")
            offset = int.from_bytes(data[i:i + 4], "little")
            i += 4
        if offset == 0 or offset > len(out):
            raise SnappyError(f"bad copy offset {offset}")
        # overlapping copies are legal: byte-at-a-time when needed
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:
            for k in range(length):
                out.append(out[start + k])
    if len(out) != expected:
        raise SnappyError(
            f"decompressed {len(out)} bytes, header said {expected}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Minimal valid compressor (all literals) — for tests and loopback.
    Produces correct, not optimal, snappy."""
    out = bytearray()
    # uvarint length
    v = len(data)
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            break
    i = 0
    while i < len(data):
        chunk = data[i:i + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            nbytes = (ln.bit_length() + 7) // 8
            out.append(((59 + nbytes) << 2))
            out += ln.to_bytes(nbytes, "little")
        out += chunk
        i += len(chunk)
    return bytes(out)
