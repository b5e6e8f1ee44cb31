"""TLS handshake parser: records ClientHello SNI + version + ALPN (the
request side) and ServerHello (the response). Reference analog: the EE TLS
decoder in the CE protocol list (l7_protocol_log.rs:163-226).

Own copy of ``deepflow_tpu/agent/protocol_logs/tls.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_VERSIONS = {0x0301: "1.0", 0x0302: "1.1", 0x0303: "1.2", 0x0304: "1.3"}


@register
class TlsParser(L7Parser):
    PROTOCOL = pb.TLS
    NAME = "tls"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 9:
            return False
        # record: type 22 (handshake), version 3.x, sane length
        if payload[0] != 22 or payload[1] != 3 or payload[2] > 4:
            return False
        rec_len = struct.unpack_from(">H", payload, 3)[0]
        hs_type = payload[5]
        return rec_len >= 4 and hs_type in (1, 2)  # ClientHello/ServerHello

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        # called on every payload of an inferred flow: application-data
        # records (type 0x17) and continuations must produce nothing
        if not self.check(payload):
            return []
        hs_type = payload[5]
        if hs_type == 1:
            sni, alpn, version = _parse_client_hello(payload)
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                version=version,
                request_type="client-hello",
                request_domain=sni,
                request_resource=sni,
                endpoint=sni or "client-hello",
                attrs={"alpn": alpn} if alpn else {},
                captured_byte=len(payload))]
        version = _VERSIONS.get(
            struct.unpack_from(">H", payload, 9)[0]
            if len(payload) >= 11 else 0, "")
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
            version=version,
            response_status=1,
            response_result="server-hello",
            captured_byte=len(payload))]


def _parse_client_hello(payload: bytes) -> tuple[str, str, str]:
    """-> (sni, alpn, version)."""
    sni = alpn = ""
    try:
        i = 9  # record(5) + hs type(1) + hs len(3)
        legacy_ver = struct.unpack_from(">H", payload, i)[0]
        version = _VERSIONS.get(legacy_ver, "")
        i += 2 + 32          # version + random
        sid_len = payload[i]
        i += 1 + sid_len
        cs_len = struct.unpack_from(">H", payload, i)[0]
        i += 2 + cs_len
        comp_len = payload[i]
        i += 1 + comp_len
        if i + 2 > len(payload):
            return sni, alpn, version
        ext_len = struct.unpack_from(">H", payload, i)[0]
        i += 2
        end = min(len(payload), i + ext_len)
        while i + 4 <= end:
            etype, elen = struct.unpack_from(">HH", payload, i)
            i += 4
            body = payload[i:i + elen]
            i += elen
            if etype == 0 and len(body) >= 5:  # server_name
                name_len = struct.unpack_from(">H", body, 3)[0]
                sni = body[5:5 + name_len].decode("latin1", "replace")
            elif etype == 16 and len(body) >= 3:  # ALPN
                j = 2
                protos = []
                while j < len(body):
                    ln = body[j]
                    protos.append(body[j + 1:j + 1 + ln].decode(
                        "latin1", "replace"))
                    j += 1 + ln
                alpn = ",".join(protos)
            elif etype == 43 and len(body) >= 3:  # supported_versions
                sv = struct.unpack_from(">H", body, 1)[0]
                version = _VERSIONS.get(sv, version)
    except (struct.error, IndexError):
        pass
    return sni, alpn, version
