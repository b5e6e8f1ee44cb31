"""Kafka parser (reference analog: protocol_logs/mq/kafka.rs).

Own copy of ``deepflow_tpu/agent/protocol_logs/mq.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_API_KEYS = {
    0: "Produce", 1: "Fetch", 2: "ListOffsets", 3: "Metadata",
    8: "OffsetCommit", 9: "OffsetFetch", 10: "FindCoordinator",
    11: "JoinGroup", 12: "Heartbeat", 13: "LeaveGroup", 14: "SyncGroup",
    15: "DescribeGroups", 16: "ListGroups", 18: "ApiVersions",
    19: "CreateTopics", 20: "DeleteTopics",
}


@register
class KafkaParser(L7Parser):
    PROTOCOL = pb.KAFKA
    NAME = "kafka"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 14:
            return False
        size = struct.unpack_from(">i", payload, 0)[0]
        api_key, api_ver = struct.unpack_from(">hh", payload, 4)
        corr = struct.unpack_from(">i", payload, 8)[0]
        client_len = struct.unpack_from(">h", payload, 12)[0]
        return (8 <= size < (1 << 24) and api_key in _API_KEYS
                and 0 <= api_ver <= 20 and corr >= 0
                and -1 <= client_len < 256
                and (port_dst == 9092 or size <= len(payload) + 4096))

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if not is_request:
            # response layout: size + correlation_id + body (no api key)
            if len(payload) < 8:
                return []
            corr = struct.unpack_from(">i", payload, 4)[0]
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_RESPONSE,
                request_id=corr, response_status=1,
                captured_byte=len(payload))]
        api_key, api_ver = struct.unpack_from(">hh", payload, 4)
        corr = struct.unpack_from(">i", payload, 8)[0]
        name = _API_KEYS.get(api_key, str(api_key))
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
            version=str(api_ver),
            request_type=name,
            request_id=corr,
            endpoint=name,
            captured_byte=len(payload))
        # topic extraction for Produce/Fetch v0-ish layouts (best effort)
        client_len = struct.unpack_from(">h", payload, 12)[0]
        off = 14 + max(0, client_len)
        if api_key in (0, 1) and off + 6 < len(payload):
            probe = payload[off:off + 64]
            topic = _first_string(probe)
            if topic:
                res.request_resource = topic
        return [res]

def _first_string(buf: bytes) -> str:
    """Scan for a plausible length-prefixed string (kafka topic)."""
    for i in range(0, max(0, len(buf) - 2)):
        ln = struct.unpack_from(">h", buf, i)[0]
        if 1 <= ln <= 64 and i + 2 + ln <= len(buf):
            s = buf[i + 2:i + 2 + ln]
            if all(32 <= c < 127 for c in s) and (
                    s.replace(b"-", b"").replace(b"_", b"")
                    .replace(b".", b"").isalnum()):
                return s.decode()
    return ""


# ---------------------------------------------------------------------------
# Pulsar (reference analog: protocol_logs/mq/pulsar.rs + PulsarApi.proto)
#
# Wire format: [total_size u32 BE][command_size u32 BE][BaseCommand protobuf]
# then, for SEND/MESSAGE frames, optional broker entry metadata (magic
# 0x0e02) and message metadata (magic 0x0e01 + crc32c + size + pb) + payload.
# BaseCommand field 1 is the command type enum; the per-type sub-message
# lives at the field number EQUAL to the enum value (PulsarApi.proto:963).
# Decoded generically with the in-repo protobuf wire reader — no generated
# stubs for the 1100-line PulsarApi.proto needed for the fields we surface.
# ---------------------------------------------------------------------------

from deepflow_tpu_torch.proto import pbwire as _pbw

_P_REQ, _P_RESP, _P_SESS = 0, 1, 2

# type -> (name, kind, request_id field in sub-msg, topic field,
#          (error_code_field, error_msg_field) | None).
# request_id -1 = Send family packing: (producer_id & 0xFFFF) << 16 |
# (sequence_id & 0xFFFF), mirroring the reference's get_msg_req.
_PULSAR_CMDS = {
    2: ("Connect", _P_REQ, 0, 0, None),
    3: ("Connected", _P_RESP, 0, 0, None),
    4: ("Subscribe", _P_REQ, 5, 1, None),
    5: ("Producer", _P_REQ, 3, 1, None),
    6: ("Send", _P_REQ, -1, 0, None),
    7: ("SendReceipt", _P_RESP, -1, 0, None),
    8: ("SendError", _P_RESP, -1, 0, (3, 4)),
    9: ("Message", _P_SESS, 0, 0, None),
    10: ("Ack", _P_SESS, 0, 0, None),
    11: ("Flow", _P_SESS, 0, 0, None),
    12: ("Unsubscribe", _P_REQ, 2, 0, None),
    13: ("Success", _P_RESP, 1, 0, None),
    14: ("Error", _P_RESP, 1, 0, (2, 3)),
    15: ("CloseProducer", _P_REQ, 2, 0, None),
    16: ("CloseConsumer", _P_REQ, 2, 0, None),
    17: ("ProducerSuccess", _P_RESP, 1, 0, None),
    18: ("Ping", _P_REQ, 0, 0, None),
    19: ("Pong", _P_RESP, 0, 0, None),
    20: ("RedeliverUnacknowledgedMessages", _P_SESS, 0, 0, None),
    21: ("PartitionedMetadata", _P_REQ, 2, 1, None),
    22: ("PartitionedMetadataResponse", _P_RESP, 2, 0, (4, 5)),
    23: ("Lookup", _P_REQ, 2, 1, None),
    24: ("LookupResponse", _P_RESP, 4, 0, (6, 7)),
    25: ("ConsumerStats", _P_REQ, 1, 0, None),
    26: ("ConsumerStatsResponse", _P_RESP, 1, 0, (2, 3)),
    27: ("ReachedEndOfTopic", _P_SESS, 0, 0, None),
    28: ("Seek", _P_REQ, 2, 0, None),
    29: ("GetLastMessageId", _P_REQ, 2, 0, None),
    30: ("GetLastMessageIdResponse", _P_RESP, 2, 0, None),
    31: ("ActiveConsumerChange", _P_SESS, 0, 0, None),
    32: ("GetTopicsOfNamespace", _P_REQ, 1, 0, None),
    33: ("GetTopicsOfNamespaceResponse", _P_RESP, 1, 0, None),
    34: ("GetSchema", _P_REQ, 1, 2, None),
    35: ("GetSchemaResponse", _P_RESP, 1, 0, (2, 3)),
    36: ("AuthChallenge", _P_REQ, 0, 0, None),
    37: ("AuthResponse", _P_RESP, 0, 0, None),
    38: ("AckResponse", _P_SESS, 0, 0, None),
    39: ("GetOrCreateSchema", _P_REQ, 1, 2, None),
    40: ("GetOrCreateSchemaResponse", _P_RESP, 1, 0, (2, 3)),
    # transaction family: request_id=1 across the board; response error
    # codes left to the generic Error command (txn error layouts vary)
    50: ("NewTxn", _P_REQ, 1, 0, None),
    51: ("NewTxnResponse", _P_RESP, 1, 0, (4, 5)),
    52: ("AddPartitionToTxn", _P_REQ, 1, 0, None),
    53: ("AddPartitionToTxnResponse", _P_RESP, 1, 0, (4, 5)),
    54: ("AddSubscriptionToTxn", _P_REQ, 1, 0, None),
    55: ("AddSubscriptionToTxnResponse", _P_RESP, 1, 0, (4, 5)),
    56: ("EndTxn", _P_REQ, 1, 0, None),
    57: ("EndTxnResponse", _P_RESP, 1, 0, (4, 5)),
    58: ("EndTxnOnPartition", _P_REQ, 1, 0, None),
    59: ("EndTxnOnPartitionResponse", _P_RESP, 1, 0, (2, 3)),
    60: ("EndTxnOnSubscription", _P_REQ, 1, 0, None),
    61: ("EndTxnOnSubscriptionResponse", _P_RESP, 1, 0, (2, 3)),
    62: ("TcClientConnectRequest", _P_REQ, 1, 0, None),
    63: ("TcClientConnectResponse", _P_RESP, 1, 0, (2, 3)),
    64: ("WatchTopicList", _P_SESS, 0, 0, None),
    65: ("WatchTopicListSuccess", _P_SESS, 0, 0, None),
    66: ("WatchTopicUpdate", _P_SESS, 0, 0, None),
    67: ("WatchTopicListClose", _P_SESS, 0, 0, None),
    68: ("TopicMigrated", _P_SESS, 0, 0, None),
}


def _pulsar_frame(payload: bytes, off: int):
    """Decode one framed BaseCommand at off. Returns (cmd_type, sub_fields,
    next_off) or None. sub_fields is the fields_dict of the sub-message."""
    if off + 8 > len(payload):
        return None
    total = struct.unpack_from(">I", payload, off)[0]
    csize = struct.unpack_from(">I", payload, off + 4)[0]
    if csize + 4 > total or total > (5 << 20):
        return None
    end = off + 8 + csize
    if end > len(payload):
        return None
    try:
        cmd = _pbw.fields_dict(payload[off + 8:end])
    except _pbw.WireError:
        return None
    ctype = _pbw.first(cmd, 1)
    meta = _PULSAR_CMDS.get(ctype)
    if meta is None:
        return None
    sub = _pbw.first(cmd, ctype)
    if not isinstance(sub, bytes):
        return None
    try:
        sub_fields = _pbw.fields_dict(sub)
    except _pbw.WireError:
        return None
    return ctype, sub_fields, off + 4 + total


def _short_topic(t: str) -> str:
    # persistent://tenant/namespace/topic -> topic (reference get_topic)
    return t.rsplit("/", 1)[-1] if t else t


@register
class PulsarParser(L7Parser):
    PROTOCOL = pb.PULSAR
    NAME = "pulsar"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        f = _pulsar_frame(payload, 0)
        if f is None:
            return False
        # a parseable BaseCommand with a known type and its own sub-message
        # is already a strong signal; off-port, require Connect/Connected
        # (every Pulsar connection starts with them) to avoid false matches
        return port_dst == 6650 or f[0] in (2, 3)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        out = []
        off = 0
        while off < len(payload) and len(out) < 16:
            f = _pulsar_frame(payload, off)
            if f is None:
                break
            ctype, sub, next_off = f
            name, kind, rid_field, topic_field, err = _PULSAR_CMDS[ctype]
            if kind == _P_SESS:
                msg_type = MSG_REQUEST if is_request else MSG_RESPONSE
            else:
                msg_type = MSG_REQUEST if kind == _P_REQ else MSG_RESPONSE
            r = L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=msg_type,
                request_type=name, endpoint=name,
                session_less=kind == _P_SESS,
                captured_byte=next_off - off)
            if rid_field == -1:  # Send family: producer_id + sequence_id
                pid = _pbw.first(sub, 1, 0)
                seq = _pbw.first(sub, 2, 0)
                r.request_id = ((int(pid) & 0xFFFF) << 16) | (int(seq) & 0xFFFF)
            elif rid_field:
                r.request_id = int(_pbw.first(sub, rid_field, 0)) & 0xFFFFFFFF
            if topic_field:
                topic = _pbw.as_str(_pbw.first(sub, topic_field, b""))
                r.request_resource = _short_topic(topic)
                if topic:
                    r.endpoint = f"{name} {r.request_resource}"
            if ctype == 2:  # Connect: protocol_version=4, broker url=6
                r.version = str(_pbw.first(sub, 4, 0))
                r.request_domain = _pbw.as_str(_pbw.first(sub, 6, b""))
            elif ctype == 3:  # Connected: protocol_version=2
                r.version = str(_pbw.first(sub, 2, 0))
            if msg_type == MSG_RESPONSE:
                code = _pbw.first(sub, err[0]) if err else None
                if code is not None:
                    r.response_status = 3  # server_error
                    r.response_code = int(code)
                    if err[1]:
                        r.response_exception = _pbw.as_str(
                            _pbw.first(sub, err[1], b""))
                else:
                    r.response_status = 1
            out.append(r)
            off = next_off
        return out
