"""Redis RESP parser (reference analog: protocol_logs/redis.rs).

Own copy of ``deepflow_tpu/agent/protocol_logs/redis.py``.
"""

from __future__ import annotations

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_READ_CMDS = {"GET", "MGET", "EXISTS", "TTL", "SCAN", "HGET", "HGETALL",
              "LRANGE", "SMEMBERS", "ZRANGE", "KEYS", "PING", "INFO"}


@register
class RedisParser(L7Parser):
    PROTOCOL = pb.REDIS
    NAME = "redis"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if not payload or b"\r\n" not in payload[:64]:
            return False
        c = payload[0:1]
        if c == b"*":  # request array (or RESP array reply)
            return payload[1:2].isdigit()
        if port_dst == 6379 and c in b"+-$:":
            return True
        return False

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        c = payload[0:1]
        if c == b"*":
            args = self._parse_array(payload)
            if args:
                cmd = args[0].upper()
                key = args[1] if len(args) > 1 else ""
                return [L7ParseResult(
                    l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                    request_type=cmd,
                    request_resource=key,
                    endpoint=cmd,
                    captured_byte=len(payload))]
            return []
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
            captured_byte=len(payload))
        first_line = payload.split(b"\r\n", 1)[0]
        if c == b"-":
            res.response_status = 3
            res.response_exception = first_line[1:].decode("latin1",
                                                           "replace")
        else:
            res.response_status = 1
            res.response_result = first_line[:128].decode("latin1", "replace")
        return [res]

    @staticmethod
    def _parse_array(payload: bytes, max_args: int = 8) -> list[str]:
        lines = payload.split(b"\r\n")
        try:
            n = int(lines[0][1:])
        except ValueError:
            return []
        args = []
        i = 1
        while i + 1 < len(lines) and len(args) < min(n, max_args):
            if lines[i].startswith(b"$"):
                args.append(lines[i + 1].decode("latin1", "replace"))
                i += 2
            else:
                i += 1
        return args
