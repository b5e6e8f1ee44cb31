"""Dubbo, FastCGI, RocketMQ parsers (reference analog: protocol_logs/rpc/
dubbo.rs, fastcgi.rs, mq/rocketmq.rs).

Own copy of ``deepflow_tpu/agent/protocol_logs/rpc.py``.
"""

from __future__ import annotations

import json
import re
import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_DUBBO_MAGIC = 0xDABB
# dubbo hessian strings are length-prefixed-ish; method/service appear as
# readable tokens — extract printable runs
_PRINTABLE_RE = re.compile(rb"[\x20-\x7e]{3,}")


@register
class DubboParser(L7Parser):
    PROTOCOL = pb.DUBBO
    NAME = "dubbo"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        return len(payload) >= 16 and \
            struct.unpack_from(">H", payload, 0)[0] == _DUBBO_MAGIC

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if not self.check(payload):
            return []  # continuation segment of a multi-packet body
        flags = payload[2]
        status = payload[3]
        req_id = struct.unpack_from(">Q", payload, 4)[0]
        is_req = bool(flags & 0x80)
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_REQUEST if is_req else MSG_RESPONSE,
            request_id=req_id & 0xFFFFFFFF,
            captured_byte=len(payload))
        if is_req:
            # body: dubbo-version, service path, version, method (hessian)
            tokens = [t.decode("latin1") for t in
                      _PRINTABLE_RE.findall(payload[16:16 + 256])]
            # heuristic: service looks like a.b.C, method is the next token
            service = next((t for t in tokens if "." in t and
                            not t[0].isdigit()), "")
            try:
                method = tokens[tokens.index(service) + 2] if service else ""
            except (ValueError, IndexError):
                method = ""
            res.request_domain = service
            res.request_type = method
            res.endpoint = f"{service}/{method}".strip("/")
        else:
            # 20 OK; 30/31/40... errors
            res.response_code = status
            res.response_status = 1 if status == 20 else (
                2 if status in (30, 31) else 3)
        return [res]


_FCGI_TYPES = {1: "BEGIN_REQUEST", 4: "PARAMS", 5: "STDIN", 6: "STDOUT",
               7: "STDERR", 3: "END_REQUEST"}


@register
class FastcgiParser(L7Parser):
    PROTOCOL = pb.FASTCGI
    NAME = "fastcgi"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 8 or payload[0] != 1:  # version 1
            return False
        rtype = payload[1]
        length = struct.unpack_from(">H", payload, 4)[0]
        return rtype in _FCGI_TYPES and 8 + length <= len(payload) and (
            port_dst == 9000 or rtype == 1)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        out = []
        off = 0
        params: dict[str, str] = {}
        request_id = 0
        saw_request = saw_response = False
        end_status = None
        while off + 8 <= len(payload):
            rtype = payload[off + 1]
            request_id = struct.unpack_from(">H", payload, off + 2)[0]
            length = struct.unpack_from(">H", payload, off + 4)[0]
            pad = payload[off + 6]
            body = payload[off + 8:off + 8 + length]
            off += 8 + length + pad
            if rtype == 1:
                saw_request = True
            elif rtype == 4 and body:
                params.update(_fcgi_params(body))
            elif rtype in (6, 7):
                saw_response = True
            elif rtype == 3 and len(body) >= 5:
                saw_response = True
                end_status = body[4]  # protocol status
        if saw_request or params:
            out.append(L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                request_type=params.get("REQUEST_METHOD", ""),
                request_resource=params.get("SCRIPT_NAME",
                                            params.get("REQUEST_URI", "")),
                request_domain=params.get("SERVER_NAME", ""),
                endpoint=params.get("SCRIPT_NAME", ""),
                request_id=request_id,
                captured_byte=len(payload)))
        if saw_response:
            out.append(L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                request_id=request_id,
                response_status=1 if not end_status else 3,
                captured_byte=len(payload)))
        return out


def _fcgi_params(body: bytes) -> dict[str, str]:
    params = {}
    i = 0
    while i < len(body):
        lens = []
        for _ in range(2):
            if i >= len(body):
                return params
            n = body[i]
            if n & 0x80:
                if i + 4 > len(body):
                    return params
                n = struct.unpack_from(">I", body, i)[0] & 0x7FFFFFFF
                i += 4
            else:
                i += 1
            lens.append(n)
        k = body[i:i + lens[0]]
        i += lens[0]
        v = body[i:i + lens[1]]
        i += lens[1]
        params[k.decode("latin1", "replace")] = v.decode("latin1", "replace")
    return params


_ROCKETMQ_CODES = {
    10: "SEND_MESSAGE", 11: "PULL_MESSAGE", 12: "QUERY_MESSAGE",
    14: "QUERY_CONSUMER_OFFSET", 15: "UPDATE_CONSUMER_OFFSET",
    34: "HEART_BEAT", 35: "UNREGISTER_CLIENT", 36: "CONSUMER_SEND_MSG_BACK",
    105: "GET_ROUTEINFO_BY_TOPIC", 310: "SEND_MESSAGE_V2",
    320: "SEND_BATCH_MESSAGE"}


@register
class RocketmqParser(L7Parser):
    """RocketMQ remoting: 4B total len + 4B header-len/serialize-type +
    JSON header {"code":..,"flag":..,"opaque":..}."""

    PROTOCOL = pb.ROCKETMQ
    NAME = "rocketmq"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 12:
            return False
        total = struct.unpack_from(">I", payload, 0)[0]
        mix = struct.unpack_from(">I", payload, 4)[0]
        ser, hlen = mix >> 24, mix & 0xFFFFFF
        if ser != 0 or hlen == 0 or hlen + 8 > total + 4 or \
                hlen > len(payload):
            return False
        return payload[8:9] == b"{" and b'"code"' in payload[8:8 + hlen]

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        mix = struct.unpack_from(">I", payload, 4)[0]
        hlen = mix & 0xFFFFFF
        try:
            hdr = json.loads(payload[8:8 + hlen].decode("utf-8", "replace"))
        except ValueError:
            return []
        code = int(hdr.get("code", 0))
        flag = int(hdr.get("flag", 0))
        opaque = int(hdr.get("opaque", 0))
        is_resp = bool(flag & 0x1)
        ext = hdr.get("extFields", {}) or {}
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
            request_type=("" if is_resp
                          else _ROCKETMQ_CODES.get(code, str(code))),
            request_resource=str(ext.get("topic", "")),
            endpoint=str(ext.get("topic", "")) or _ROCKETMQ_CODES.get(
                code, str(code)),
            request_id=opaque & 0xFFFFFFFF,
            captured_byte=len(payload))
        if is_resp:
            res.response_code = code
            res.response_status = 1 if code == 0 else 3
            res.response_exception = str(hdr.get("remark", ""))[:128]
        return [res]
