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
