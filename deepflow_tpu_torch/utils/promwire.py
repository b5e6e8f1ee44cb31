"""Prometheus WriteRequest wire encoding (the write-side twin of the
pbwire reader). Shared by the remote-write exporter and tests so both speak
the exact same bytes.

Own copy of ``deepflow_tpu/utils/promwire.py``: pure byte code,
the same bytes in and out.
"""

from __future__ import annotations

import struct


def varint(v: int) -> bytes:
    if v < 0:
        raise ValueError(f"varint: negative value {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _label(name: bytes, value: bytes) -> bytes:
    body = (b"\x0a" + varint(len(name)) + name
            + b"\x12" + varint(len(value)) + value)
    return b"\x0a" + varint(len(body)) + body


def _sample(value: float, ts_ms: int) -> bytes:
    body = b"\x09" + struct.pack("<d", value) + b"\x10" + varint(ts_ms)
    return b"\x12" + varint(len(body)) + body


def timeseries(name: str, labels: dict, samples: list) -> bytes:
    """One TimeSeries message (field 1 of WriteRequest).
    samples: [(ts_ms, value), ...]"""
    body = _label(b"__name__", name.encode())
    for k, v in sorted(labels.items()):
        body += _label(k.encode(), str(v).encode())
    for ts_ms, value in samples:
        body += _sample(value, ts_ms)
    return b"\x0a" + varint(len(body)) + body


def write_request(series: list) -> bytes:
    """series: [(name, labels_dict, [(ts_ms, value), ...]), ...]"""
    return b"".join(timeseries(n, l, s) for n, l, s in series)
