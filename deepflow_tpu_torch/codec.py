"""Framed transport codec: the agent->ingester wire format.

Own copy of ``deepflow_tpu/codec.py`` (frames, header, compression, crc),
byte-compatible with it: the reference ingester decodes these frames and
this decoder reads the reference's.

Frame layout (big-endian), 18-byte header followed by the payload:

    u32 frame_size | u16 magic 0xDF70 | u8 version | u8 msg_type |
    u16 agent_id | u16 org_id | u16 team_id | u32 crc32(payload)

Version 2 frames carry a u64 ``seq`` between the header and the payload
(frame_size covers it; the crc covers the payload only). Payloads over
512 bytes are zlib-compressed, flagged by bit 0x80 of the version byte.

The durable transport adds two control frames with a u64 payload: ACK
(server -> agent, the highest contiguous seq received) and SEQ_BASE
(agent -> server, the lowest seq the agent may still send). Priority
classes say which message types a full sender queue sheds first.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from enum import IntEnum

MAGIC = 0xDF70
VERSION = 1
VERSION_SEQ = 2       # header followed by a u64 seq extension
COMPRESS_FLAG = 0x80  # or-ed into the version byte when payload is zlib'd
HEADER_FMT = ">IHBBHHHI"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 18
SEQ_EXT_FMT = ">Q"
SEQ_EXT_SIZE = struct.calcsize(SEQ_EXT_FMT)  # 8
MAX_FRAME_SIZE = 64 << 20


class MessageType(IntEnum):
    """Per-frame payload type; the numbers are the reference's."""

    METRICS = 1
    L4_LOG = 2
    L7_LOG = 3
    PROFILE = 4
    TPU_SPAN = 5         # TpuSpanBatch -> tpu_hlo_span, tpu_memory
    DFSTATS = 6
    EVENT = 7
    OTEL = 8
    PROMETHEUS = 9
    APP_LOG = 10
    PCAP = 11
    SHARD_RESULT = 12
    STEP_METRICS = 13    # JSON step rollups -> tpu_step_metrics
    ACK = 14
    SEQ_BASE = 15
    CACHE_PARTIAL = 16


# Delivery priority classes: under queue pressure the sender sheds by
# class, lowest first. Self-monitoring re-ships on the next tick; profile,
# span and step data is shed last.
PRIORITY_HIGH = 0   # never shed for another frame
PRIORITY_MID = 1    # shed after LOW is exhausted
PRIORITY_LOW = 2    # shed first

_PRIORITY = {
    MessageType.DFSTATS: PRIORITY_LOW,
    MessageType.PCAP: PRIORITY_LOW,
    MessageType.ACK: PRIORITY_LOW,
    MessageType.SEQ_BASE: PRIORITY_LOW,
    MessageType.METRICS: PRIORITY_MID,
    MessageType.EVENT: PRIORITY_MID,
    MessageType.OTEL: PRIORITY_MID,
    MessageType.PROMETHEUS: PRIORITY_MID,
    MessageType.APP_LOG: PRIORITY_MID,
    MessageType.SHARD_RESULT: PRIORITY_MID,
}


def priority_of(msg_type: MessageType) -> int:
    """Shed class for a message type (HIGH unless registered lower)."""
    return _PRIORITY.get(msg_type, PRIORITY_HIGH)


@dataclass(frozen=True)
class FrameHeader:
    msg_type: MessageType
    agent_id: int = 0
    org_id: int = 0
    team_id: int = 0
    compressed: bool = False
    seq: int | None = None  # per-agent frame counter (v2 extension)


class FrameDecodeError(Exception):
    pass


def encode_frame(header: FrameHeader, payload: bytes,
                 compress: bool | None = None) -> bytes:
    """Encode one frame. If compress is None, compress payloads > 512B."""
    if compress is None:
        compress = len(payload) > 512
    if compress:
        payload = zlib.compress(payload, 1)
    base_ver = VERSION if header.seq is None else VERSION_SEQ
    ver = base_ver | (COMPRESS_FLAG if compress else 0)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    ext = b"" if header.seq is None else struct.pack(SEQ_EXT_FMT, header.seq)
    size = HEADER_SIZE + len(ext) + len(payload)
    if size > MAX_FRAME_SIZE:
        raise ValueError(f"frame too large: {size}")
    hdr = struct.pack(
        HEADER_FMT, size, MAGIC, ver, int(header.msg_type),
        header.agent_id, header.org_id, header.team_id, crc)
    return hdr + ext + payload


def encode_ack(agent_id: int, seq: int) -> bytes:
    """Server->agent ACK: highest contiguous seq received for agent_id."""
    return encode_frame(FrameHeader(MessageType.ACK, agent_id=agent_id),
                        struct.pack(SEQ_EXT_FMT, seq), compress=False)


def decode_ack(payload: bytes) -> int:
    if len(payload) < SEQ_EXT_SIZE:
        raise FrameDecodeError("short ACK payload")
    return struct.unpack_from(SEQ_EXT_FMT, payload)[0]


def encode_seq_base(agent_id: int, base: int) -> bytes:
    """Agent->server: no frame with seq < base will be sent (again). The
    server moves its contiguous watermark to base - 1, forward only, so a
    restarted agent's fresh seq space, or a gap of seqs that will never
    come, does not stall its acks."""
    return encode_frame(FrameHeader(MessageType.SEQ_BASE, agent_id=agent_id),
                        struct.pack(SEQ_EXT_FMT, base), compress=False)


def decode_seq_base(payload: bytes) -> int:
    if len(payload) < SEQ_EXT_SIZE:
        raise FrameDecodeError("short SEQ_BASE payload")
    return struct.unpack_from(SEQ_EXT_FMT, payload)[0]


def decode_frame(buf: bytes, off: int = 0
                 ) -> tuple[FrameHeader | None, bytes, int]:
    """Decode one frame at buf[off] -> (header, payload, consumed).

    consumed is 0 when buf does not yet hold a whole frame; corruption
    raises FrameDecodeError."""
    if len(buf) - off < HEADER_SIZE:
        return None, b"", 0
    size, magic, ver, mtype, agent_id, org_id, team_id, crc = \
        struct.unpack_from(HEADER_FMT, buf, off)
    if magic != MAGIC:
        raise FrameDecodeError(f"bad magic {magic:#x}")
    if size > MAX_FRAME_SIZE or size < HEADER_SIZE:
        raise FrameDecodeError(f"bad frame size {size}")
    if len(buf) - off < size:
        return None, b"", 0
    compressed = bool(ver & COMPRESS_FLAG)
    base_ver = ver & ~COMPRESS_FLAG
    seq = None
    body_off = off + HEADER_SIZE
    if base_ver == VERSION_SEQ:
        if size < HEADER_SIZE + SEQ_EXT_SIZE:
            raise FrameDecodeError(f"bad v2 frame size {size}")
        seq = struct.unpack_from(SEQ_EXT_FMT, buf, body_off)[0]
        body_off += SEQ_EXT_SIZE
    elif base_ver != VERSION:
        raise FrameDecodeError(f"bad version {ver}")
    payload = bytes(buf[body_off:off + size])
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameDecodeError("crc mismatch")
    if compressed:
        payload = zlib.decompress(payload)
    try:
        msg_type = MessageType(mtype)
    except ValueError:
        raise FrameDecodeError(f"unknown message type {mtype}") from None
    return FrameHeader(msg_type, agent_id, org_id, team_id, compressed,
                       seq), payload, size


class StreamDecoder:
    """Incremental frame decoder over a byte stream (TCP recv chunks)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[tuple[FrameHeader, bytes]]:
        """Decode all complete frames; a partial tail waits for the next
        chunk. On corruption the buffer is discarded and FrameDecodeError
        raised: the owner drops the connection."""
        self._buf.extend(data)
        buf = bytes(self._buf)
        out = []
        off = 0
        try:
            while True:
                header, payload, consumed = decode_frame(buf, off)
                if consumed == 0:
                    break
                off += consumed
                out.append((header, payload))
        except FrameDecodeError:
            self._buf.clear()
            raise
        del self._buf[:off]
        return out
