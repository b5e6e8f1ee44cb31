"""MongoDB and Memcached parsers (reference analog: protocol_logs/mongo.rs,
memcached.rs).

Own copy of ``deepflow_tpu/agent/protocol_logs/nosql.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_MONGO_OPS = {1: "OP_REPLY", 2004: "OP_QUERY", 2005: "OP_GET_MORE",
              2010: "OP_COMMAND", 2011: "OP_COMMANDREPLY", 2012: "OP_COMPRESSED",
              2013: "OP_MSG"}


@register
class MongoParser(L7Parser):
    PROTOCOL = pb.MONGODB
    NAME = "mongodb"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 16:
            return False
        msg_len, _req_id, _resp_to, opcode = struct.unpack_from(
            "<IIII", payload, 0)
        return opcode in _MONGO_OPS and 16 <= msg_len < (1 << 26) and (
            port_dst == 27017 or msg_len == len(payload))

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        _msg_len, req_id, resp_to, opcode = struct.unpack_from(
            "<IIII", payload, 0)
        is_response = opcode in (1, 2011) or resp_to != 0
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_response else MSG_REQUEST,
            request_type=_MONGO_OPS.get(opcode, str(opcode)),
            request_id=resp_to if is_response else req_id,
            captured_byte=len(payload))
        if not is_response and opcode == 2013 and len(payload) > 26:
            # OP_MSG: flag(4) + section kind(1) + BSON doc; first key is the
            # command name, its value the collection
            cmd, coll = _bson_first_pair(payload[21:])
            res.request_type = cmd or res.request_type
            res.request_resource = coll
            res.endpoint = coll
        if not is_response and opcode == 2004:
            # OP_QUERY: flags(4) + fullCollectionName cstring
            name_end = payload.find(b"\x00", 20)
            if name_end > 0:
                res.request_resource = payload[20:name_end].decode(
                    "latin1", "replace")
                res.endpoint = res.request_resource
        if is_response:
            res.response_status = 1
        return [res]


def _bson_first_pair(doc: bytes) -> tuple[str, str]:
    if len(doc) < 5:
        return "", ""
    etype = doc[4]
    key_end = doc.find(b"\x00", 5)
    if key_end < 0:
        return "", ""
    key = doc[5:key_end].decode("latin1", "replace")
    value = ""
    if etype == 2 and key_end + 5 <= len(doc):  # string
        slen = struct.unpack_from("<I", doc, key_end + 1)[0]
        value = doc[key_end + 5:key_end + 4 + slen].decode(
            "latin1", "replace")
    return key, value


_MC_REQ = (b"get ", b"gets ", b"set ", b"add ", b"replace ", b"delete ",
           b"incr ", b"decr ", b"append ", b"prepend ", b"cas ", b"touch ",
           b"stats", b"flush_all", b"version")
_MC_RESP = (b"VALUE ", b"STORED", b"NOT_STORED", b"END", b"DELETED",
            b"NOT_FOUND", b"ERROR", b"CLIENT_ERROR", b"SERVER_ERROR",
            b"TOUCHED", b"VERSION ")


@register
class MemcachedParser(L7Parser):
    PROTOCOL = pb.MEMCACHED
    NAME = "memcached"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if payload.startswith(_MC_REQ):
            return b"\r\n" in payload
        return port_dst == 11211 and payload.startswith(_MC_RESP)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        first = payload.split(b"\r\n", 1)[0]
        if payload.startswith(_MC_RESP):
            err = payload.startswith((b"ERROR", b"CLIENT_ERROR",
                                      b"SERVER_ERROR"))
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                response_status=3 if payload.startswith(b"SERVER_ERROR")
                else (2 if err else 1),
                response_exception=first.decode("latin1", "replace")
                if err else "",
                response_result="" if err else first[:64].decode(
                    "latin1", "replace"),
                captured_byte=len(payload))]
        parts = first.split(b" ")
        return [L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
            request_type=parts[0].decode("latin1", "replace").upper(),
            request_resource=(parts[1].decode("latin1", "replace")
                              if len(parts) > 1 else ""),
            endpoint=parts[0].decode("latin1", "replace").upper(),
            captured_byte=len(payload))]
