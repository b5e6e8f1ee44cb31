"""SofaRPC (bolt), bRPC, Tars, ZMTP, OpenWire parsers.

Reference analog: the CE protocol list (l7_protocol_log.rs:163-226 — SofaRPC,
bRPC, Tars, ZMTP, OpenWire entries).

Own copy of ``deepflow_tpu/agent/protocol_logs/rpc2.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)


@register
class SofaRpcParser(L7Parser):
    """Bolt protocol v1: u8 proto=1, u8 type (0 resp, 1 req, 2 oneway),
    u16 cmdcode (0 heartbeat, 1 request, 2 response), u8 ver2,
    u32 request_id, u8 codec, ... classname scan for service identity."""

    PROTOCOL = pb.SOFARPC
    NAME = "sofarpc"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 10 or payload[0] != 1:
            return False
        ptype = payload[1]
        cmdcode = struct.unpack_from(">H", payload, 2)[0]
        return ptype in (0, 1, 2) and cmdcode in (0, 1, 2)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        ptype = payload[1]
        cmdcode = struct.unpack_from(">H", payload, 2)[0]
        request_id = struct.unpack_from(">I", payload, 5)[0]
        is_req = ptype in (1, 2)
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_REQUEST if is_req else MSG_RESPONSE,
            request_id=request_id,
            captured_byte=len(payload))
        if cmdcode == 0:
            res.request_type = "heartbeat"
            res.endpoint = "heartbeat"
            res.session_less = True
            return [res]
        if is_req:
            # service identity: a dotted printable class/interface name,
            # anywhere after the fixed header (header length varies with
            # bolt version, so scan instead of assuming an offset)
            import re
            m = re.search(
                rb"[A-Za-z_$][A-Za-z0-9_$]*(?:\.[A-Za-z0-9_$]+){2,}"
                rb"(?::[0-9.]+)?", payload[10:])
            if m:
                svc = m.group().decode("latin1", "replace")
                res.request_domain = svc
                res.endpoint = svc
            res.request_type = "oneway" if ptype == 2 else "call"
            res.session_less = ptype == 2
        else:
            status = struct.unpack_from(">H", payload, 10)[0] \
                if len(payload) >= 12 else 0
            res.response_code = status
            res.response_status = 1 if status == 0 else 3
        return [res]


@register
class BrpcParser(L7Parser):
    """baidu-rpc standard protocol: 'PRPC' + u32 body_size + u32 meta_size,
    then RpcMeta protobuf (request.service/method, correlation_id)."""

    PROTOCOL = pb.BRPC
    NAME = "brpc"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        return payload.startswith(b"PRPC") and len(payload) >= 12

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        body_size, meta_size = struct.unpack_from(">II", payload, 4)
        meta = payload[12:12 + meta_size]
        from deepflow_tpu_torch.proto import pbwire as w
        service = method = err_text = ""
        corr = 0
        err_code = 0
        saw_request = saw_response = False
        try:
            for f, _, v in w.iter_fields(meta):
                if f == 1 and isinstance(v, bytes):       # request meta
                    saw_request = True
                    d = w.fields_dict(v)
                    service = w.as_str(w.first(d, 1))
                    method = w.as_str(w.first(d, 2))
                elif f == 2 and isinstance(v, bytes):     # response meta
                    saw_response = True
                    d = w.fields_dict(v)
                    err_code = int(w.first(d, 1, 0) or 0)
                    err_text = w.as_str(w.first(d, 2))
                elif f == 4 and not isinstance(v, bytes):  # correlation_id
                    corr = int(v)
        except w.WireError:
            return []
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_REQUEST if saw_request or not saw_response
            else MSG_RESPONSE,
            request_domain=service,
            request_type=method,
            endpoint=f"{service}/{method}".strip("/"),
            request_id=corr & 0xFFFFFFFF,
            captured_byte=len(payload))
        if saw_response:
            res.response_code = err_code
            res.response_status = 1 if err_code == 0 else 3
            res.response_exception = err_text[:128]
        return [res]


def _tars_read(buf: bytes, i: int):
    """One TARS field -> (tag, value, next_i). Supports the header types."""
    if i >= len(buf):
        raise ValueError("eof")
    head = buf[i]
    tag, ttype = head >> 4, head & 0xF
    i += 1
    if tag == 15:
        tag = buf[i]
        i += 1
    if ttype == 0:      # int8
        return tag, buf[i], i + 1
    if ttype == 1:      # int16
        return tag, struct.unpack_from(">h", buf, i)[0], i + 2
    if ttype == 2:      # int32
        return tag, struct.unpack_from(">i", buf, i)[0], i + 4
    if ttype == 3:      # int64
        return tag, struct.unpack_from(">q", buf, i)[0], i + 8
    if ttype == 6:      # string1
        ln = buf[i]
        return tag, buf[i + 1:i + 1 + ln].decode("latin1", "replace"), \
            i + 1 + ln
    if ttype == 7:      # string4
        ln = struct.unpack_from(">I", buf, i)[0]
        return tag, buf[i + 4:i + 4 + ln].decode("latin1", "replace"), \
            i + 4 + ln
    if ttype == 12:     # zero
        return tag, 0, i
    raise ValueError(f"tars type {ttype}")


@register
class TarsParser(L7Parser):
    """Tars RequestPacket: u32 total len + tars-encoded struct
    (1 iVersion, 2 cPacketType, 3 iMessageType, 4 iRequestId,
    5 sServantName, 6 sFuncName | response: 5 iRet)."""

    PROTOCOL = pb.TARS
    NAME = "tars"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 8:
            return False
        total = struct.unpack_from(">I", payload, 0)[0]
        if not (8 <= total <= len(payload) + 4096):
            return False
        try:
            tag, version, _ = _tars_read(payload, 4)
        except (ValueError, struct.error, IndexError):
            return False
        return tag == 1 and version in (1, 2, 3)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        fields: dict[int, object] = {}
        i = 4
        try:
            while i < len(payload) and len(fields) < 8:
                tag, value, i = _tars_read(payload, i)
                fields[tag] = value
        except (ValueError, struct.error, IndexError):
            pass
        servant = str(fields.get(5, "")) if isinstance(
            fields.get(5), str) else ""
        func = str(fields.get(6, "")) if isinstance(
            fields.get(6), str) else ""
        is_resp = not servant and 5 in fields  # response: tag5 = iRet int
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
            request_domain=servant,
            request_type=func,
            endpoint=f"{servant}/{func}".strip("/"),
            request_id=int(fields.get(4, 0) or 0) & 0xFFFFFFFF,
            captured_byte=len(payload))
        if is_resp:
            ret = int(fields.get(5, 0) or 0)
            res.response_code = ret
            res.response_status = 1 if ret == 0 else 3
        return [res]


@register
class ZmtpParser(L7Parser):
    """ZeroMQ transport protocol v3: greeting (\\xff...\\x7f + version +
    mechanism) and command/message frames."""

    PROTOCOL = pb.ZMTP
    NAME = "zmtp"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        return (len(payload) >= 11 and payload[0] == 0xFF
                and payload[9] == 0x7F and payload[10] in (1, 2, 3))

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        version = f"{payload[10]}.{payload[11]}" if len(payload) > 11 else ""
        mechanism = ""
        if len(payload) >= 32:
            mechanism = payload[12:32].rstrip(b"\x00").decode(
                "latin1", "replace")
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_REQUEST if is_request else MSG_RESPONSE,
            version=version,
            request_type="greeting",
            request_resource=mechanism,
            endpoint="greeting",
            session_less=True,
            captured_byte=len(payload))]


@register
class OpenwireParser(L7Parser):
    """ActiveMQ OpenWire: u32 size + u8 datatype; WIREFORMAT_INFO(1)
    carries the 'ActiveMQ' magic."""

    PROTOCOL = pb.OPENWIRE
    NAME = "openwire"

    _TYPES = {1: "WireFormatInfo", 2: "BrokerInfo", 3: "ConnectionInfo",
              4: "SessionInfo", 5: "ConsumerInfo", 6: "ProducerInfo",
              10: "KeepAlive", 11: "ShutdownInfo", 15: "Response",
              21: "MessageAck", 26: "ActiveMQMessage", 27: "ActiveMQBytesMessage",
              28: "ActiveMQMapMessage", 31: "ActiveMQTextMessage"}

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 5:
            return False
        if payload[4] == 1 and b"ActiveMQ" in payload[:20]:
            return True
        size = struct.unpack_from(">I", payload, 0)[0]
        return (port_dst == 61616 and payload[4] in self._TYPES
                and 1 <= size <= len(payload) + 4096)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        dtype = payload[4]
        name = self._TYPES.get(dtype, str(dtype))
        is_resp = dtype == 15
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
            request_type=name,
            endpoint=name,
            session_less=dtype in (1, 2, 10, 26, 27, 28, 31),
            captured_byte=len(payload))
        if is_resp:
            res.response_status = 1
        return [res]
