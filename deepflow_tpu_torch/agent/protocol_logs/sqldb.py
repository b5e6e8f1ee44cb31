"""MySQL and PostgreSQL parsers (reference analog: protocol_logs/sql/).

Own copy of ``deepflow_tpu/agent/protocol_logs/sqldb.py``.
"""

from __future__ import annotations

import re
import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_SQL_VERB_RE = re.compile(
    rb"^\s*(SELECT|INSERT|UPDATE|DELETE|CREATE|DROP|ALTER|BEGIN|COMMIT|"
    rb"ROLLBACK|SET|SHOW|USE|EXPLAIN|TRUNCATE|WITH)\b", re.IGNORECASE)
_TABLE_RE = re.compile(
    rb"\b(?:FROM|INTO|UPDATE|TABLE)\s+[`\"]?([A-Za-z0-9_.$]+)",
    re.IGNORECASE)

_MYSQL_COMMANDS = {
    1: "COM_QUIT", 2: "COM_INIT_DB", 3: "COM_QUERY", 4: "COM_FIELD_LIST",
    14: "COM_PING", 22: "COM_STMT_PREPARE", 23: "COM_STMT_EXECUTE",
    25: "COM_STMT_CLOSE",
}


def _sql_fields(sql: bytes) -> tuple[str, str]:
    verb = ""
    m = _SQL_VERB_RE.match(sql)
    if m:
        verb = m.group(1).decode().upper()
    table = ""
    tm = _TABLE_RE.search(sql)
    if tm:
        table = tm.group(1).decode("latin1", "replace")
    return verb, table


@register
class MysqlParser(L7Parser):
    PROTOCOL = pb.MYSQL
    NAME = "mysql"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 5:
            return False
        ln = int.from_bytes(payload[0:3], "little")
        seq = payload[3]
        if ln == 0 or ln + 4 > len(payload) + 1024:
            return False
        if seq == 0:
            cmd = payload[4]
            if cmd in _MYSQL_COMMANDS and (
                    cmd != 3 or _SQL_VERB_RE.match(payload[5:5 + ln - 1])):
                return cmd == 3 or port_dst == 3306
        return False

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        ln = int.from_bytes(payload[0:3], "little")
        seq = payload[3]
        if seq == 0:
            cmd = payload[4]
            name = _MYSQL_COMMANDS.get(cmd, f"COM_{cmd}")
            res = L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                request_type=name, captured_byte=len(payload))
            if cmd == 3:  # COM_QUERY
                sql = payload[5:4 + ln]
                verb, table = _sql_fields(sql)
                res.request_type = verb or name
                res.request_resource = table
                res.endpoint = table
                res.attrs["sql"] = sql[:256].decode("latin1", "replace")
            return [res]
        # response: header byte after the packet header
        marker = payload[4]
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
            captured_byte=len(payload))
        if marker == 0xFF:
            code = struct.unpack_from("<H", payload, 5)[0]
            res.response_code = code
            res.response_status = 2 if code < 2000 else 3
            res.response_exception = payload[13:13 + 64].decode(
                "latin1", "replace")
        else:
            res.response_status = 1
        return [res]


@register
class PostgresParser(L7Parser):
    PROTOCOL = pb.POSTGRESQL
    NAME = "postgresql"

    # typed messages: Q query, P parse, E execute/error, C close/complete...
    _REQ_TYPES = b"QPBEDFCHSX"
    _RESP_TYPES = b"TDCEZRSNK1234"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 5:
            return False
        t = payload[0:1]
        ln = struct.unpack_from(">I", payload, 1)[0]
        if t == b"Q" and 4 <= ln <= len(payload) + 16:
            return bool(_SQL_VERB_RE.match(payload[5:]))
        if port_dst == 5432 and t in self._REQ_TYPES and 4 <= ln < (1 << 24):
            return True
        return False

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        out = []
        off = 0
        while off + 5 <= len(payload) and len(out) < 16:
            t = payload[off:off + 1]
            ln = struct.unpack_from(">I", payload, off + 1)[0]
            body = payload[off + 5:off + 1 + ln]
            off += 1 + ln
            if t == b"Q":
                sql = body.rstrip(b"\x00")
                verb, table = _sql_fields(sql)
                out.append(L7ParseResult(
                    l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                    request_type=verb or "QUERY",
                    request_resource=table, endpoint=table,
                    attrs={"sql": sql[:256].decode("latin1", "replace")},
                    captured_byte=len(payload)))
            elif t == b"E":
                fields = body.split(b"\x00")
                sev = code = msg = ""
                for f in fields:
                    if f.startswith(b"S"):
                        sev = f[1:].decode("latin1", "replace")
                    elif f.startswith(b"C"):
                        code = f[1:].decode("latin1", "replace")
                    elif f.startswith(b"M"):
                        msg = f[1:].decode("latin1", "replace")
                out.append(L7ParseResult(
                    l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                    response_status=3 if sev in ("ERROR", "FATAL",
                                                 "PANIC") else 2,
                    response_exception=f"{code} {msg}".strip(),
                    captured_byte=len(payload)))
            elif t == b"C":  # CommandComplete
                out.append(L7ParseResult(
                    l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                    response_status=1,
                    response_result=body.rstrip(b"\x00").decode(
                        "latin1", "replace"),
                    captured_byte=len(payload)))
        return out
