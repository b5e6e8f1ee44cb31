"""ICMP echo (ping) parser — reference lists Ping in the CE protocol set.

Own copy of ``deepflow_tpu/agent/protocol_logs/ping.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)


@register
class PingParser(L7Parser):
    PROTOCOL = pb.PING
    NAME = "ping"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        # ICMP flows are the only ones with port 0 (TCP/UDP always carry a
        # dst port) — without this gate, zero-heavy TCP payloads match
        if port_dst != 0 or len(payload) < 8:
            return False
        t = payload[0]
        return t in (0, 8, 128, 129) and payload[1] == 0

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        t = payload[0]
        ident, seq = struct.unpack_from(">HH", payload, 4)
        is_req = t in (8, 128)
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_REQUEST if is_req else MSG_RESPONSE,
            request_type="echo-request" if is_req else "echo-reply",
            request_id=(ident << 16) | seq,
            endpoint=f"id={ident}",
            captured_byte=len(payload))
        if not is_req:
            res.response_status = 1
        return [res]
