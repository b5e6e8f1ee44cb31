"""MQTT, NATS, AMQP parsers (reference analog: protocol_logs/mqtt.rs,
plugins for NATS/AMQP in the CE list l7_protocol_log.rs:163-226).

Own copy of ``deepflow_tpu/agent/protocol_logs/messaging.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_MQTT_TYPES = {
    1: "CONNECT", 2: "CONNACK", 3: "PUBLISH", 4: "PUBACK", 5: "PUBREC",
    6: "PUBREL", 7: "PUBCOMP", 8: "SUBSCRIBE", 9: "SUBACK",
    10: "UNSUBSCRIBE", 11: "UNSUBACK", 12: "PINGREQ", 13: "PINGRESP",
    14: "DISCONNECT"}
_MQTT_RESPONSES = {2, 4, 5, 7, 9, 11, 13}


@register
class MqttParser(L7Parser):
    PROTOCOL = pb.MQTT
    NAME = "mqtt"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 2:
            return False
        ptype = payload[0] >> 4
        if ptype == 1:  # CONNECT carries the protocol name
            return b"MQTT" in payload[:16] or b"MQIsdp" in payload[:16]
        return port_dst == 1883 and ptype in _MQTT_TYPES

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        ptype = payload[0] >> 4
        name = _MQTT_TYPES.get(ptype, str(ptype))
        # variable-length 'remaining length'
        i, mult, _rem = 1, 1, 0
        while i < min(len(payload), 5):
            b = payload[i]
            _rem += (b & 0x7F) * mult
            mult *= 128
            i += 1
            if not b & 0x80:
                break
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=(MSG_RESPONSE if ptype in _MQTT_RESPONSES
                      else MSG_REQUEST),
            request_type=name, endpoint=name,
            captured_byte=len(payload))
        if ptype == 3:
            qos = (payload[0] >> 1) & 0x3
            res.session_less = qos == 0  # QoS0: fire-and-forget
        if ptype == 3 and i + 2 <= len(payload):  # PUBLISH: topic string
            tlen = struct.unpack_from(">H", payload, i)[0]
            topic = payload[i + 2:i + 2 + tlen]
            res.request_resource = topic.decode("latin1", "replace")
            res.endpoint = res.request_resource
        if ptype == 2 and len(payload) >= 4:  # CONNACK return code
            rc = payload[3]
            res.response_code = rc
            res.response_status = 1 if rc == 0 else 3
        elif res.msg_type == MSG_RESPONSE:
            res.response_status = 1
        return [res]


# unambiguous NATS verbs (port-free) vs reply tokens Redis/RESP also emits
_NATS_VERBS = (b"PUB ", b"SUB ", b"UNSUB ", b"HPUB ", b"HMSG ")
_NATS_AMBIGUOUS = (b"MSG ", b"CONNECT ", b"INFO ", b"PING", b"PONG",
                   b"+OK", b"-ERR")


@register
class NatsParser(L7Parser):
    PROTOCOL = pb.NATS
    NAME = "nats"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if b"\r\n" not in payload[:512]:
            return False
        if payload.startswith(_NATS_VERBS):
            return True
        # +OK/-ERR/PING/... collide with Redis RESP: require the NATS port
        return port_dst == 4222 and payload.startswith(_NATS_AMBIGUOUS)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        first = payload.split(b"\r\n", 1)[0]
        parts = first.split(b" ")
        verb = parts[0].decode("latin1", "replace")
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=(MSG_RESPONSE if verb in ("+OK", "-ERR", "PONG",
                                               "INFO", "MSG", "HMSG")
                      else MSG_REQUEST),
            request_type=verb, endpoint=verb,
            captured_byte=len(payload))
        if verb in ("PUB", "HPUB"):
            res.session_less = True
        if verb in ("PUB", "SUB", "HPUB", "MSG", "HMSG") and len(parts) > 1:
            res.request_resource = parts[1].decode("latin1", "replace")
            res.endpoint = res.request_resource
        if verb == "-ERR":
            res.response_status = 3
            res.response_exception = first[5:].decode("latin1", "replace")
        elif res.msg_type == MSG_RESPONSE:
            res.response_status = 1
        return [res]


_AMQP_CLASSES = {10: "connection", 20: "channel", 40: "exchange",
                 50: "queue", 60: "basic", 90: "tx"}
_AMQP_METHODS = {(60, 40): "basic.publish", (60, 60): "basic.deliver",
                 (60, 71): "basic.get-ok", (60, 80): "basic.ack",
                 (50, 10): "queue.declare", (50, 11): "queue.declare-ok",
                 (40, 10): "exchange.declare", (10, 10): "connection.start",
                 (10, 11): "connection.start-ok", (20, 10): "channel.open"}


@register
class AmqpParser(L7Parser):
    PROTOCOL = pb.AMQP
    NAME = "amqp"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if payload.startswith(b"AMQP\x00"):
            return True
        if len(payload) < 12 or port_dst != 5672:
            return False
        ftype = payload[0]
        size = struct.unpack_from(">I", payload, 3)[0]
        return ftype in (1, 2, 3, 8) and size < (1 << 24)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        if payload.startswith(b"AMQP\x00"):
            return [L7ParseResult(
                l7_protocol=self.PROTOCOL, msg_type=MSG_REQUEST,
                request_type="protocol-header", endpoint="protocol-header",
                captured_byte=len(payload))]
        ftype = payload[0]
        if ftype != 1 or len(payload) < 12:  # only method frames parsed
            return []
        class_id, method_id = struct.unpack_from(">HH", payload, 7)
        name = _AMQP_METHODS.get(
            (class_id, method_id),
            f"{_AMQP_CLASSES.get(class_id, class_id)}.{method_id}")
        is_resp = method_id % 2 == 1 and method_id > 10 or \
            name.endswith(("-ok", "ack"))
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
            request_type=name, endpoint=name,
            captured_byte=len(payload))
        if is_resp:
            res.response_status = 1
        return [res]
