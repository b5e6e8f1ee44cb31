"""Shard-result wire format: one codec frame, columnar payload.

Own copy of ``deepflow_tpu/cluster/wire.py``, built on the port's
``codec.py``: the same object gives the same bytes in both packages,
the CACHE_PARTIAL frames of the cluster-wide partial cache
(``cluster/partialcache.py``) included.

Layout inside a MessageType.SHARD_RESULT frame (zlib handled by the
frame layer for payloads > 512B):

    [u32 meta_len][meta json][col bytes]...

meta = {"kind": "table", "columns": [...], "encodings": [...], "n": N,
        "extra": {...}} for row/column data — numeric columns travel as
raw little-endian float64/int64 arrays (8 bytes/row, no JSON number
parsing on the hot merge path), everything else as a JSON list. Any
non-tabular object (agg partials, peer lists, span dicts) falls back to
{"kind": "json"} with the object as the JSON body. Both sides derive
the column layout from the same parsed query, so the encodings list is
all the schema negotiation there is.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from deepflow_tpu_torch.codec import (FrameHeader, MessageType, decode_frame,
                                encode_frame)

_LEN = struct.Struct(">I")

# per-column encodings
_F64 = "f64"     # raw little-endian float64 bytes
_I64 = "i64"     # raw little-endian int64 bytes
_JSON = "json"   # JSON list (strings, mixed, nested)


class WireError(Exception):
    pass


# -- query-trace context propagation -----------------------------------------
# The trace context of a federated query rides the scatter body as one
# small JSON dict under this key; shards that predate query tracing
# ignore it (unknown body keys were always tolerated), shards that know
# it adopt the context so their spans stitch into the coordinator's
# trace (query/qtrace.py).

QTRACE_KEY = "qtrace"


def inject_ctx(body: dict) -> dict:
    """Return ``body`` with the calling thread's active trace context
    attached (a copy — scatter bodies are shared across peers); the
    body passes through untouched when no trace is active."""
    from deepflow_tpu_torch.query import qtrace
    ctx = qtrace.ctx_for_wire()
    if ctx is None:
        return body
    out = dict(body)
    out[QTRACE_KEY] = ctx
    return out


def extract_ctx(body: dict) -> dict | None:
    ctx = body.get(QTRACE_KEY) if isinstance(body, dict) else None
    return ctx if isinstance(ctx, dict) else None


def _encode_jsonb(obj) -> bytes:
    """"jsonb" kind: arbitrary JSON structure whose embedded ndarrays
    travel as dtype-preserving raw blobs appended after the JSON body
    ({"__bin__": i} placeholders mark the splice points). Carries the
    encoded agg partials — uint32 dictionary-id columns stay 4 bytes per
    group instead of JSON-quoted strings. Only emitted when a payload
    actually contains ndarrays, so pre-encoding peers never see it."""
    blobs: list[np.ndarray] = []

    def strip(o):
        if isinstance(o, np.ndarray):
            blobs.append(np.ascontiguousarray(o))
            return {"__bin__": len(blobs) - 1}
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        if isinstance(o, np.generic):
            return o.item()
        return o

    body = strip(obj)
    meta = {"kind": "jsonb", "obj": body,
            "blobs": [[a.dtype.str, int(a.size)] for a in blobs]}
    mb = json.dumps(meta, separators=(",", ":")).encode()
    return _LEN.pack(len(mb)) + mb + b"".join(a.tobytes() for a in blobs)


def _decode_jsonb(meta: dict, buf: memoryview):
    arrays: list[np.ndarray] = []
    off = 0
    for dt, size in meta.get("blobs", []):
        dtype = np.dtype(dt)
        end = off + dtype.itemsize * int(size)
        arrays.append(np.frombuffer(buf[off:end], dtype=dtype))
        off = end

    def restore(o):
        if isinstance(o, dict):
            if len(o) == 1 and "__bin__" in o:
                return arrays[int(o["__bin__"])]
            return {k: restore(v) for k, v in o.items()}
        if isinstance(o, list):
            return [restore(v) for v in o]
        return o

    return restore(meta.get("obj"))


def _encode_table(obj: dict) -> bytes:
    columns = list(obj["columns"])
    values = obj["values"]
    n = len(values)
    encodings: list[str] = []
    blobs: list[bytes] = []
    for ci in range(len(columns)):
        col = [row[ci] for row in values]
        if n and all(isinstance(v, bool) is False and
                     isinstance(v, (int, float)) for v in col):
            if all(isinstance(v, int) and -(1 << 62) < v < (1 << 62)
                   for v in col):
                encodings.append(_I64)
                blobs.append(np.asarray(col, dtype="<i8").tobytes())
            else:
                encodings.append(_F64)
                blobs.append(np.asarray(col, dtype="<f8").tobytes())
        else:
            encodings.append(_JSON)
            b = json.dumps(col, separators=(",", ":")).encode()
            blobs.append(_LEN.pack(len(b)) + b)
    # every top-level key besides the column data rides along in meta
    # (e.g. a rows-partial's {"kind": "rows"} marker) and is restored on
    # decode — the table layout is an encoding, not a schema filter
    extra = {k: v for k, v in obj.items()
             if k not in ("columns", "values")}
    meta = {"kind": "table", "columns": columns, "encodings": encodings,
            "n": n, "extra": extra}
    mb = json.dumps(meta, separators=(",", ":")).encode()
    return _LEN.pack(len(mb)) + mb + b"".join(blobs)


def _decode_table(meta: dict, buf: memoryview) -> dict:
    n = int(meta["n"])
    cols: list[list] = []
    off = 0
    for enc in meta["encodings"]:
        if enc in (_F64, _I64):
            dtype = "<f8" if enc == _F64 else "<i8"
            end = off + 8 * n
            cols.append(np.frombuffer(buf[off:end], dtype=dtype).tolist())
            off = end
        elif enc == _JSON:
            (blen,) = _LEN.unpack(buf[off:off + 4])
            off += 4
            cols.append(json.loads(bytes(buf[off:off + blen])))
            off += blen
        else:
            raise WireError(f"unknown column encoding {enc!r}")
    values = [list(row) for row in zip(*cols)] if cols and n else []
    out = {"columns": list(meta["columns"]), "values": values}
    out.update(meta.get("extra") or {})
    return out


def encode_result(obj, shard_id: int = 0) -> bytes:
    """Serialize one shard response into a SHARD_RESULT frame."""
    if (isinstance(obj, dict) and "columns" in obj and "values" in obj
            and isinstance(obj.get("values"), list)):
        payload = _encode_table(obj)
    else:
        # the json form unless obj holds ndarrays (json refuses them):
        # no walk over every answer, a shard's change token included
        try:
            b = json.dumps({"kind": "json", "obj": obj},
                           separators=(",", ":")).encode()
        except TypeError:
            payload = _encode_jsonb(obj)
        else:
            payload = _LEN.pack(len(b)) + b
    return encode_frame(
        FrameHeader(MessageType.SHARD_RESULT, agent_id=shard_id & 0xFFFF),
        payload)


def decode_result(frame: bytes):
    """Inverse of encode_result -> (obj, shard_id)."""
    header, payload, consumed = decode_frame(frame)
    if consumed == 0:
        raise WireError("short shard-result frame")
    if header.msg_type != MessageType.SHARD_RESULT:
        raise WireError(f"unexpected frame type {header.msg_type}")
    view = memoryview(payload)
    (mlen,) = _LEN.unpack(view[:4])
    meta = json.loads(bytes(view[4:4 + mlen]))
    if meta.get("kind") == "table":
        return _decode_table(meta, view[4 + mlen:]), header.agent_id
    if meta.get("kind") == "jsonb":
        return _decode_jsonb(meta, view[4 + mlen:]), header.agent_id
    return meta.get("obj"), header.agent_id


def encode_cache_partial(obj, shard_id: int = 0) -> bytes:
    """Serialize one distributed partial-cache exchange (request ack or
    warm bucket response) into a CACHE_PARTIAL frame. Always the jsonb
    form — encoded per-bucket partials are exactly the ndarray-bearing
    payloads jsonb exists for, and the kind doubles as the type check
    (a stray SHARD_RESULT on this path must fail loudly)."""
    return encode_frame(
        FrameHeader(MessageType.CACHE_PARTIAL, agent_id=shard_id & 0xFFFF),
        _encode_jsonb(obj))


def decode_cache_partial(frame: bytes):
    """Inverse of encode_cache_partial -> (obj, shard_id)."""
    header, payload, consumed = decode_frame(frame)
    if consumed == 0:
        raise WireError("short cache-partial frame")
    if header.msg_type != MessageType.CACHE_PARTIAL:
        raise WireError(f"unexpected frame type {header.msg_type}")
    view = memoryview(payload)
    (mlen,) = _LEN.unpack(view[:4])
    meta = json.loads(bytes(view[4:4 + mlen]))
    if meta.get("kind") != "jsonb":
        raise WireError(f"unexpected cache-partial kind {meta.get('kind')!r}")
    return _decode_jsonb(meta, view[4 + mlen:]), header.agent_id
