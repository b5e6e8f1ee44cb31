"""Kafka wire protocol: the subset a producer needs.

Own copy of ``deepflow_tpu/utils/kafkawire.py``: pure byte code,
the same bytes in and out.

Reference analog: server/ingester/exporters/kafka_exporter (the reference
ships rows to Kafka via a client library). This image carries no Kafka
client, so the exporter speaks the protocol directly: Metadata v0 for
partition-leader discovery and Produce v2 with message-set v1 framing
(magic=1, CRC32 — the format every broker still accepts and up-converts;
record-batch v2 would additionally need CRC32C).

Protocol layout per the public Kafka protocol guide: every request is
  int32 size | int16 api_key | int16 api_version | int32 correlation_id
  | string client_id | body
and every response is
  int32 size | int32 correlation_id | body
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

API_PRODUCE = 0
API_METADATA = 3


class KafkaWireError(Exception):
    pass


# -- primitives --------------------------------------------------------------

def _str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise KafkaWireError("truncated response")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode(errors="replace")


# -- requests ----------------------------------------------------------------

def request(api_key: int, api_version: int, correlation_id: int,
            client_id: str, body: bytes) -> bytes:
    payload = (struct.pack(">hhi", api_key, api_version, correlation_id)
               + _str(client_id) + body)
    return struct.pack(">i", len(payload)) + payload


def metadata_request(topics: list[str], correlation_id: int,
                     client_id: str = "deepflow-tpu") -> bytes:
    body = struct.pack(">i", len(topics)) + b"".join(
        _str(t) for t in topics)
    return request(API_METADATA, 0, correlation_id, client_id, body)


def message_set(messages: list[tuple[bytes | None, bytes, int]]) -> bytes:
    """Message-set v1: [(key, value, timestamp_ms), ...]. The CRC32 covers
    everything after the crc field (magic, attributes, timestamp, key,
    value)."""
    out = []
    for key, value, ts_ms in messages:
        body = (struct.pack(">bbq", 1, 0, ts_ms)  # magic=1, attrs=0
                + _bytes(key) + _bytes(value))
        msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
        out.append(struct.pack(">qi", 0, len(msg)) + msg)  # offset 0
    return b"".join(out)


def produce_request(topic: str, partition: int, msg_set: bytes,
                    correlation_id: int, acks: int = 1,
                    timeout_ms: int = 10000,
                    client_id: str = "deepflow-tpu") -> bytes:
    body = (struct.pack(">hi", acks, timeout_ms)
            + struct.pack(">i", 1) + _str(topic)          # one topic
            + struct.pack(">i", 1)                        # one partition
            + struct.pack(">i", partition)
            + struct.pack(">i", len(msg_set)) + msg_set)
    return request(API_PRODUCE, 2, correlation_id, client_id, body)


# -- responses ---------------------------------------------------------------

@dataclass
class MetadataResponse:
    brokers: dict          # node_id -> (host, port)
    partition_leaders: dict  # partition -> node_id
    topic_error: int


def parse_metadata_response(data: bytes, topic: str) -> MetadataResponse:
    """Metadata v0 response body (correlation id already stripped)."""
    r = _Reader(data)
    brokers = {}
    for _ in range(r.i32()):
        node_id = r.i32()
        host = r.string() or ""
        port = r.i32()
        brokers[node_id] = (host, port)
    leaders: dict = {}
    topic_error = 0
    for _ in range(r.i32()):
        err = r.i16()
        name = r.string()
        partitions = {}
        for _ in range(r.i32()):
            p_err = r.i16()
            pid = r.i32()
            leader = r.i32()
            for _ in range(r.i32()):   # replicas
                r.i32()
            for _ in range(r.i32()):   # isr
                r.i32()
            if p_err == 0 or leader >= 0:
                partitions[pid] = leader
        if name == topic:
            topic_error = err
            leaders = partitions
    return MetadataResponse(brokers=brokers, partition_leaders=leaders,
                            topic_error=topic_error)


@dataclass
class ProduceResult:
    partition: int
    error_code: int
    base_offset: int


def parse_produce_response(data: bytes) -> ProduceResult:
    """Produce v2 response body for the single topic/partition we sent."""
    r = _Reader(data)
    n_topics = r.i32()
    if n_topics < 1:
        raise KafkaWireError("empty produce response")
    r.string()  # topic name
    n_parts = r.i32()
    if n_parts < 1:
        raise KafkaWireError("produce response without partitions")
    partition = r.i32()
    error_code = r.i16()
    base_offset = r.i64()
    r.i64()  # log_append_time
    return ProduceResult(partition=partition, error_code=error_code,
                         base_offset=base_offset)


def read_response(sock) -> tuple[int, bytes]:
    """Read one size-framed response -> (correlation_id, body)."""
    hdr = _read_exact(sock, 4)
    size = struct.unpack(">i", hdr)[0]
    if size < 4 or size > 64 * 1024 * 1024:
        raise KafkaWireError(f"bad response size {size}")
    data = _read_exact(sock, size)
    return struct.unpack(">i", data[:4])[0], data[4:]


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise KafkaWireError("connection closed mid-response")
        buf += chunk
    return buf


# error codes a producer meets (public protocol error table)
RETRIABLE_ERRORS = {5, 6, 7}  # leader-not-available, not-leader, timeout


def error_name(code: int) -> str:
    return {
        0: "NONE", 1: "OFFSET_OUT_OF_RANGE", 2: "CORRUPT_MESSAGE",
        3: "UNKNOWN_TOPIC_OR_PARTITION", 5: "LEADER_NOT_AVAILABLE",
        6: "NOT_LEADER_FOR_PARTITION", 7: "REQUEST_TIMED_OUT",
        10: "MESSAGE_TOO_LARGE", 17: "INVALID_REQUIRED_ACKS",
    }.get(code, f"ERROR_{code}")
