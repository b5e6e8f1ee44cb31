"""Enterprise-protocol tail: Oracle TNS, IBM/WebSphere MQ, ISO8583,
SOME/IP, Dameng, NetSign.

Reference analogs: protocol_logs/sql/oracle.rs, mq/web_sphere_mq.rs,
rpc/iso8583.rs, rpc/some_ip.rs, sql/dameng.rs, rpc/net_sign.rs. Note the
reference DELEGATES dameng/netsign framing to closed enterprise crates
(dameng.rs:210, net_sign.rs:375); here those two are honest minimal
port+framing parsers built from public knowledge, while Oracle TNS, MQ
TSH, ISO8583 and SOME/IP follow their public wire specs.

Own copy of ``deepflow_tpu/agent/protocol_logs/enterprise.py``.
"""

from __future__ import annotations

import re
import struct

from deepflow_tpu_torch.agent.protocol_logs.base import (
    MSG_REQUEST, MSG_RESPONSE, L7ParseResult, L7Parser, register)
from deepflow_tpu_torch.proto import wire as pb

# ---------------------------------------------------------------------------
# Oracle TNS (sql/oracle.rs)
# ---------------------------------------------------------------------------

_TNS_TYPES = {1: "CONNECT", 2: "ACCEPT", 4: "REFUSE", 5: "REDIRECT",
              6: "DATA", 11: "RESEND", 12: "MARKER", 14: "CONTROL"}
_SQL_VERB = re.compile(
    rb"\b(SELECT|INSERT|UPDATE|DELETE|MERGE|BEGIN|CALL|CREATE|ALTER|DROP|"
    rb"COMMIT|ROLLBACK)\b", re.IGNORECASE)
_SERVICE_RE = re.compile(rb"SERVICE_NAME=([^)]+)")


@register
class OracleParser(L7Parser):
    PROTOCOL = pb.ORACLE
    NAME = "oracle"
    PORTS = (1521, 1522, 1525)

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 8:
            return False
        length = struct.unpack_from(">H", payload)[0]
        ptype = payload[4]
        if ptype not in _TNS_TYPES or payload[2:4] != b"\x00\x00":
            return False
        if ptype == 1:  # CONNECT carries the descriptor text
            return b"(DESCRIPTION=" in payload or b"(CONNECT_DATA=" in payload
        # other types only on the known ports (8-byte header is weak alone)
        return port_dst in self.PORTS and 8 <= length <= 65535

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if len(payload) < 8:
            return []
        ptype = payload[4]
        tname = _TNS_TYPES.get(ptype, "")
        if not tname:
            return []
        if ptype == 1:  # CONNECT
            m = _SERVICE_RE.search(payload)
            svc = m.group(1).decode("ascii", "replace") if m else ""
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                request_type="CONNECT", request_domain=svc,
                captured_byte=len(payload))]
        if ptype == 2:  # ACCEPT
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                response_status=1, captured_byte=len(payload))]
        if ptype == 4:  # REFUSE
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                response_status=3,
                response_exception="connection refused",
                captured_byte=len(payload))]
        if ptype == 6 and is_request:  # DATA: surface embedded SQL
            m = _SQL_VERB.search(payload)
            if m:
                verb = m.group(1).decode().upper()
                sql = payload[m.start():m.start() + 256].split(b"\x00")[0]
                return [L7ParseResult(
                    l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                    request_type=verb,
                    attrs={"sql": sql.decode("utf-8", "replace")},
                    captured_byte=len(payload))]
            return []
        if ptype == 6:
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                response_status=1, captured_byte=len(payload))]
        return []


# ---------------------------------------------------------------------------
# IBM / WebSphere MQ (mq/web_sphere_mq.rs): TSH segment headers
# ---------------------------------------------------------------------------

_TSH_SEGMENTS = {
    0x01: "INITIAL_DATA", 0x02: "RESYNC_DATA", 0x03: "RESET_DATA",
    0x04: "MESSAGE_DATA", 0x05: "STATUS_DATA", 0x06: "SECURITY_DATA",
    0x07: "USERID_DATA", 0x08: "HEARTBEAT",
    0x81: "MQCONN", 0x82: "MQDISC", 0x83: "MQOPEN", 0x84: "MQCLOSE",
    0x85: "MQGET", 0x86: "MQPUT", 0x87: "MQPUT1", 0x88: "MQSET",
    0x89: "MQINQ", 0x8A: "MQCMIT", 0x8B: "MQBACK", 0x8C: "SPI",
    0x91: "MQCONN_REPLY", 0x92: "MQDISC_REPLY", 0x93: "MQOPEN_REPLY",
    0x94: "MQCLOSE_REPLY", 0x95: "MQGET_REPLY", 0x96: "MQPUT_REPLY",
    0x97: "MQPUT1_REPLY",
}


@register
class WebSphereMqParser(L7Parser):
    PROTOCOL = pb.WEBSPHEREMQ
    NAME = "websphere_mq"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        return len(payload) >= 28 and payload[:3] == b"TSH" and \
            payload[3:4] in (b" ", b"M", b"C")

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if len(payload) < 28 or payload[:3] != b"TSH":
            return []
        # TSHM carries conversation+request ids before the common fields
        off = 12 if payload[3:4] == b"M" else 4
        seg_len = struct.unpack_from(">I", payload, 4)[0]
        seg_type = payload[off + 5] if off + 5 < len(payload) else 0
        name = _TSH_SEGMENTS.get(seg_type, f"SEGMENT_{seg_type:#x}")
        is_reply = name.endswith("_REPLY") or seg_type == 0x05
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_reply else MSG_REQUEST,
            request_type="" if is_reply else name,
            response_status=1 if is_reply else 0,
            session_less=name in ("HEARTBEAT",),
            attrs={"segment_length": seg_len},
            captured_byte=len(payload))]


# ---------------------------------------------------------------------------
# ISO8583 financial messages (rpc/iso8583.rs)
# ---------------------------------------------------------------------------

_MTI_RE = re.compile(rb"^\d{4}$")


@register
class Iso8583Parser(L7Parser):
    PROTOCOL = pb.ISO8583
    NAME = "iso8583"
    # no IANA port; gate on the conventional deployment ports so 4 leading
    # ASCII digits on arbitrary text protocols can't pin a flow as ISO8583
    PORTS = (8583, 1080, 5105)

    @staticmethod
    def _mti_at(payload: bytes):
        """MTI possibly behind a 2-byte big-endian length prefix."""
        for off in (0, 2):
            mti = payload[off:off + 4]
            if len(mti) == 4 and _MTI_RE.match(mti):
                if off == 2:
                    ln = struct.unpack_from(">H", payload)[0]
                    if ln != len(payload) - 2:
                        continue
                # a primary bitmap must follow the MTI
                if len(payload) >= off + 12:
                    return off, mti.decode()
        return None, None

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if port_dst not in self.PORTS:
            return False
        off, mti = self._mti_at(payload)
        if mti is None:
            return False
        # version digit 0-2 (1987/1993/2003), class digit 1-8
        return mti[0] in "012" and mti[1] in "12345678"

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        off, mti = self._mti_at(payload)
        if mti is None:
            return []
        # function digit: even = request, odd = response (0200 -> 0210)
        is_resp = int(mti[2]) % 2 == 1
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
            request_type="" if is_resp else mti,
            response_status=1 if is_resp else 0,
            attrs={"mti": mti},
            captured_byte=len(payload))]


# ---------------------------------------------------------------------------
# SOME/IP automotive RPC (rpc/some_ip.rs)
# ---------------------------------------------------------------------------

_SOMEIP_REQ = {0x00: "REQUEST", 0x01: "REQUEST_NO_RETURN",
               0x02: "NOTIFICATION"}
_SOMEIP_RESP = {0x80: "RESPONSE", 0x81: "ERROR"}
_SOMEIP_CLIENT_ERRS = {2, 3, 7, 8, 10}  # unknown svc/method, wrong
# proto/interface version, wrong message type (some_ip.rs set_status)


@register
class SomeIpParser(L7Parser):
    PROTOCOL = pb.SOMEIP
    NAME = "someip"

    @staticmethod
    def _header_ok(payload: bytes, off: int) -> int:
        """Validate one message header at off; returns its total size
        (possibly beyond the capture for a truncated tail) or 0."""
        if off + 16 > len(payload):
            return 0
        length = struct.unpack_from(">I", payload, off + 4)[0]
        proto_ver, _iface, mtype, _rc = payload[off + 12:off + 16]
        if proto_ver != 1 or not (8 <= length <= (1 << 24)):
            return 0
        if mtype not in _SOMEIP_REQ and mtype not in _SOMEIP_RESP:
            return 0
        return 8 + length

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        size = self._header_ok(payload, 0)
        if not size:
            return False
        # exactly one message, a batch (next header must also be sane), or
        # a truncated capture of one larger message
        if size >= len(payload):
            return True
        return self._header_ok(payload, size) > 0

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        # TCP segments batch messages back to back (notification bursts):
        # emit them all
        out: list[L7ParseResult] = []
        off = 0
        while True:
            size = self._header_ok(payload, off)
            if not size:
                break
            out.extend(self._parse_one(payload, off))
            off += size
        return out

    def _parse_one(self, payload: bytes, off: int) -> list[L7ParseResult]:
        service_id, method_id = struct.unpack_from(">HH", payload, off)
        client_id, session_id = struct.unpack_from(">HH", payload, off + 8)
        _, _, mtype, return_code = payload[off + 12:off + 16]
        endpoint = f"{service_id:#06x}/{method_id:#06x}"
        if mtype in _SOMEIP_RESP:
            status = (1 if return_code == 0 else
                      2 if return_code in _SOMEIP_CLIENT_ERRS else 3)
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                endpoint=endpoint, request_id=session_id,
                response_code=return_code, response_status=status,
                attrs={"message_type": _SOMEIP_RESP[mtype],
                       "client_id": client_id},
                captured_byte=len(payload))]
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
            request_type=_SOMEIP_REQ[mtype], endpoint=endpoint,
            request_id=session_id,
            session_less=mtype in (0x01, 0x02),
            attrs={"message_type": _SOMEIP_REQ[mtype],
                   "client_id": client_id},
            captured_byte=len(payload))]


# ---------------------------------------------------------------------------
# Dameng DM8 (sql/dameng.rs — reference delegates to a closed crate;
# minimal port-gated framing here)
# ---------------------------------------------------------------------------

@register
class DamengParser(L7Parser):
    PROTOCOL = pb.DAMENG
    NAME = "dameng"
    PORTS = (5236, 5237)

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if port_dst not in self.PORTS or len(payload) < 64:
            return False
        # DM messages carry a 64-byte header; length (LE u32) at offset 8
        # must be plausible for the captured segment
        length = struct.unpack_from("<I", payload, 8)[0]
        return length <= (1 << 24)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if len(payload) < 64:
            return []
        cmd = payload[4]
        m = _SQL_VERB.search(payload)
        if is_request:
            verb = m.group(1).decode().upper() if m else f"CMD_{cmd}"
            attrs = {}
            if m:
                sql = payload[m.start():m.start() + 256].split(b"\x00")[0]
                attrs["sql"] = sql.decode("utf-8", "replace")
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                request_type=verb, attrs=attrs,
                captured_byte=len(payload))]
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
            response_status=1, captured_byte=len(payload))]


# ---------------------------------------------------------------------------
# NetSign crypto-service (rpc/net_sign.rs — reference delegates to a closed
# crate; minimal TLV parser here)
# ---------------------------------------------------------------------------

_NETSIGN_OPS = {b"sign": "sign", b"verify": "verify",
                b"encrypt": "encrypt", b"decrypt": "decrypt",
                b"digest": "digest"}


@register
class NetSignParser(L7Parser):
    PROTOCOL = pb.NETSIGN
    NAME = "netsign"
    PORTS = (9989, 10014)

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 12 or port_dst not in self.PORTS:
            return False
        length = struct.unpack_from(">I", payload)[0]
        return 4 <= length <= (1 << 20)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if len(payload) < 12:
            return []
        low = payload[:512].lower()
        op = next((name for key, name in _NETSIGN_OPS.items()
                   if key in low), "")
        if is_request:
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                request_type=op or "request",
                captured_byte=len(payload))]
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
            response_status=1, captured_byte=len(payload))]
