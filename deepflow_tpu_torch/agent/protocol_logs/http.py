"""HTTP/1.x and HTTP/2 (+gRPC detection) parsers.

Reference analog: protocol_logs/http.rs (HTTP1/2 log parsing, trace-id
header propagation l7_flow_log glue).

Own copy of ``deepflow_tpu/agent/protocol_logs/http.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.hpack_huffman import huffman_decode
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register,
    status_from_code)

_METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ",
            b"PATCH ", b"TRACE ", b"CONNECT ")
# trace headers we lift into l7_flow_log (reference: trace_types config)
_TRACE_HEADERS = (b"traceparent", b"x-b3-traceid", b"sw8", b"uber-trace-id")
_SPAN_HEADERS = (b"x-b3-spanid",)


def _parse_headers(block: bytes) -> dict[bytes, bytes]:
    headers = {}
    for line in block.split(b"\r\n"):
        if b":" in line:
            k, _, v = line.partition(b":")
            headers[k.strip().lower()] = v.strip()
    return headers


def _trace_ids(headers: dict[bytes, bytes]) -> tuple[str, str, str]:
    trace_id = span_id = x_request_id = ""
    for h in _TRACE_HEADERS:
        v = headers.get(h)
        if v:
            s = v.decode("latin1")
            if h == b"traceparent":  # 00-<trace>-<span>-<flags>
                parts = s.split("-")
                if len(parts) >= 4:
                    trace_id, span_id = parts[1], parts[2]
            elif h == b"uber-trace-id":
                parts = s.split(":")
                trace_id = parts[0]
                if len(parts) > 1:
                    span_id = parts[1]
            else:
                trace_id = s
            break
    for h in _SPAN_HEADERS:
        v = headers.get(h)
        if v and not span_id:
            span_id = v.decode("latin1")
    xr = headers.get(b"x-request-id")
    if xr:
        x_request_id = xr.decode("latin1")
    return trace_id, span_id, x_request_id


@register
class Http1Parser(L7Parser):
    PROTOCOL = pb.HTTP1
    NAME = "http1"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        return (payload.startswith(_METHODS)
                or payload.startswith(b"HTTP/1."))

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        head, _, _body = payload.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n", 1)
        first = lines[0]
        headers = _parse_headers(lines[1] if len(lines) > 1 else b"")
        trace_id, span_id, x_request_id = _trace_ids(headers)
        if first.startswith(b"HTTP/1."):
            parts = first.split(b" ", 2)
            code = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                version=parts[0].decode("latin1").replace("HTTP/", ""),
                response_code=code,
                response_status=status_from_code(code),
                response_result=(parts[2].decode("latin1")
                                 if len(parts) > 2 else ""),
                trace_id=trace_id, span_id=span_id,
                x_request_id=x_request_id,
                captured_byte=len(payload))]
        method, _, rest = first.partition(b" ")
        path, _, version = rest.rpartition(b" ")
        host = headers.get(b"host", b"").decode("latin1")
        path_s = path.decode("latin1")
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
            version=version.decode("latin1").replace("HTTP/", ""),
            request_type=method.decode("latin1"),
            request_domain=host,
            request_resource=path_s,
            endpoint=path_s.split("?")[0],
            trace_id=trace_id, span_id=span_id, x_request_id=x_request_id,
            captured_byte=len(payload))]


H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
_H2_FRAME_TYPES = set(range(10))
# minimal HPACK static table entries we care about
_HPACK_STATIC = {
    2: (":method", "GET"), 3: (":method", "POST"),
    4: (":path", "/"), 5: (":path", "/index.html"),
    6: (":scheme", "http"), 7: (":scheme", "https"),
    8: (":status", "200"), 9: (":status", "204"), 10: (":status", "206"),
    11: (":status", "304"), 12: (":status", "400"), 13: (":status", "404"),
    14: (":status", "500"),
    31: ("content-type", ""),
    38: ("host", ""),
}


@register
class Http2Parser(L7Parser):
    """HTTP/2 frames; HPACK headers decoded including Huffman strings
    (RFC 7541 Appendix B) — covers gRPC's :path and typical stacks."""

    PROTOCOL = pb.HTTP2
    NAME = "http2"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if payload.startswith(H2_PREFACE):
            return True
        if len(payload) < 9:
            return False
        length = int.from_bytes(payload[0:3], "big")
        ftype = payload[3]
        stream_id = int.from_bytes(payload[5:9], "big") & 0x7FFFFFFF
        # frame must be sane: known type, length plausible, settings on s0
        if ftype not in _H2_FRAME_TYPES or length > (1 << 20):
            return False
        if ftype == 4:  # SETTINGS
            return stream_id == 0 and length % 6 == 0
        # DATA/HEADERS: the frame must fit in the captured payload — random
        # bytes rarely satisfy this (cuts false positives on garbage)
        return (ftype in (0, 1) and stream_id != 0
                and 9 + length <= len(payload))

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if payload.startswith(H2_PREFACE):
            payload = payload[len(H2_PREFACE):]
        out = []
        off = 0
        while off + 9 <= len(payload):
            length = int.from_bytes(payload[off:off + 3], "big")
            ftype = payload[off + 3]
            stream_id = int.from_bytes(payload[off + 5:off + 9],
                                       "big") & 0x7FFFFFFF
            frame = payload[off + 9:off + 9 + length]
            off += 9 + length
            if ftype != 1:  # HEADERS
                continue
            headers = _hpack_literal_headers(frame)
            grpc = headers.get("content-type", "").startswith(
                "application/grpc")
            path = headers.get(":path", "")
            status = headers.get(":status", "")
            if status:
                code = int(status) if status.isdigit() else 0
                out.append(L7ParseResult(
                    l7_protocol=pb.GRPC if grpc else self.PROTOCOL,
                    msg_type=MSG_RESPONSE, version="2",
                    request_id=stream_id,
                    response_code=code,
                    response_status=status_from_code(code),
                    captured_byte=len(payload)))
            else:
                out.append(L7ParseResult(
                    l7_protocol=pb.GRPC if grpc else self.PROTOCOL,
                    msg_type=MSG_REQUEST, version="2",
                    request_type=headers.get(":method", ""),
                    request_domain=headers.get(":authority", ""),
                    request_resource=path,
                    endpoint=path,
                    request_id=stream_id,
                    captured_byte=len(payload)))
        return out


def _hpack_literal_headers(frame: bytes) -> dict[str, str]:
    """Best-effort HPACK: static-index entries + literals, Huffman included."""
    headers: dict[str, str] = {}
    i = 0
    n = len(frame)
    while i < n:
        b = frame[i]
        if b & 0x80:  # indexed field
            idx, i = _hpack_int(frame, i, 7)
            if idx in _HPACK_STATIC:
                k, v = _HPACK_STATIC[idx]
                if v:
                    headers[k] = v
            continue
        # literal with/without indexing
        if b & 0x40:
            prefix_bits = 6
        elif b & 0x20:  # dynamic table size update
            _, i = _hpack_int(frame, i, 5)
            continue
        else:
            prefix_bits = 4
        idx, i = _hpack_int(frame, i, prefix_bits)
        if idx is None:
            return headers
        if idx:
            name = _HPACK_STATIC.get(idx, (str(idx), ""))[0]
        else:
            name, i = _hpack_string(frame, i)
            if name is None:
                return headers
        value, i = _hpack_string(frame, i)
        if value is None:
            return headers
        headers[name] = value
    return headers


def _hpack_int(frame: bytes, i: int, prefix_bits: int):
    """HPACK prefix integer (RFC 7541 §5.1) -> (value, next_index)."""
    mask = (1 << prefix_bits) - 1
    v = frame[i] & mask
    i += 1
    if v < mask:
        return v, i
    shift = 0
    while i < len(frame):
        b = frame[i]
        i += 1
        v += (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return v, i
    return None, i


def _hpack_string(frame: bytes, i: int):
    if i >= len(frame):
        return None, i
    huffman = bool(frame[i] & 0x80)
    ln, i = _hpack_int(frame, i, 7)
    if ln is None or i + ln > len(frame):
        return None, i
    raw = frame[i:i + ln]
    i += ln
    if huffman:
        decoded = huffman_decode(raw)
        if decoded is None:
            return None, i
        return decoded.decode("latin1", "replace"), i
    return raw.decode("latin1", "replace"), i
