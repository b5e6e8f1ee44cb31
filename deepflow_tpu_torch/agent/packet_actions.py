"""The ACL's packet actions: rolling pcap captures and NPB forwarding.

Own copy of ``deepflow_tpu/agent/packet_actions.py``, whole (reference
analog: agent/src/policy's NPB and PCAP ACL actions,
plugins/npb_sender). The actions run at the frame boundary of the paths where frames are Python
bytes: pcap replay (both engines) and the SOCK_RAW live capture. A frame
whose flow the labeler gives ``pcap`` joins the rolling capture, shipped
to the server's pcap store as a gzip'd classic pcap in a ``PCAP`` frame
every ``FLUSH_INTERVAL_S`` or ``MAX_BUFFERED`` frames (and at the stop);
one given ``npb`` is VXLAN-encapsulated (flags 0x08, the VNI) and sent
over UDP to ``npb_target`` (host:port, port 4789 when none is given).
The mmap ring's frames never surface in Python, so packet actions need
the socket capture: the flows are traced either way. The gzip header
carries no time, so one capture gives the same bytes on every run.
"""

from __future__ import annotations

import gzip
import logging
import socket
import struct
import threading
import time
from collections import deque

from deepflow_tpu_torch.agent.packet import decode_ethernet
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire

log = logging.getLogger("df.pktactions")

_PCAP_GLOBAL_HDR = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                               65535, 1)


class PacketActions:
    """Frame-level ACL action executor (pcap | npb)."""

    MAX_BUFFERED = 4096          # frames per capture window
    FLUSH_INTERVAL_S = 10.0
    VXLAN_PORT = 4789

    def __init__(self, labeler, sender=None, agent_id: int = 0,
                 npb_target: str = "", npb_vni: int = 1) -> None:
        self.labeler = labeler
        self.sender = sender
        self.agent_id = agent_id
        self.npb_target = npb_target
        self.npb_vni = npb_vni
        self._npb_addr = None
        self._npb_sock = None
        if npb_target:
            host, sep, port = npb_target.rpartition(":")
            if not sep or not port.isdigit():
                # colon-less target or IPv6 literal without a port
                host, port = npb_target, str(self.VXLAN_PORT)
            self._npb_addr = (host.strip("[]") or "127.0.0.1", int(port))
            self._npb_sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM)
        self._buf: deque = deque(maxlen=self.MAX_BUFFERED)
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._capture_seq = 0
        self._enabled_cache: tuple | None = None
        self.stats = {"pcap_frames": 0, "npb_frames": 0,
                      "npb_errors": 0, "uploads": 0, "dropped": 0}

    @property
    def npb_port(self) -> int:
        """The NPB target's UDP port (0 without a target): live capture
        excludes it, so the forwarded datagrams never feed back."""
        return self._npb_addr[1] if self._npb_addr is not None else 0

    def enabled(self) -> bool:
        """Cheap per-packet guard: the ACL scan result is cached against
        the labeler's acl_version, so hot paths pay one int compare."""
        if self.labeler is None:
            return False
        version = self.labeler.acl_version
        cached = self._enabled_cache
        if cached is None or cached[0] != version:
            cached = (version, any(r.action in ("pcap", "npb")
                                   for r in self.labeler._acls))
            self._enabled_cache = cached
        return cached[1]

    def handle_frame(self, frame: bytes, ts_ns: int) -> None:
        """Run ACL packet actions for one raw frame (decoded here; the
        callers' hot paths stay untouched when no packet ACLs exist)."""
        mp = decode_ethernet(frame, timestamp_ns=ts_ns)
        if mp is None:
            return
        self.handle_meta(mp, frame)

    def handle_meta(self, mp, frame: bytes) -> None:
        """Entry point for callers that already decoded the frame (the
        live-capture rx loop) — no second ethernet decode."""
        ts_ns = mp.timestamp_ns
        _, _, action = self.labeler.label_flow(
            mp.ip_src, mp.ip_dst, mp.port_src, mp.port_dst, mp.protocol)
        if action == "pcap":
            self.stats["pcap_frames"] += 1
            with self._lock:
                if len(self._buf) == self._buf.maxlen:
                    self.stats["dropped"] += 1
                self._buf.append((ts_ns, frame))
            self.maybe_flush()
        elif action == "npb":
            self._forward_npb(frame)

    def _forward_npb(self, frame: bytes) -> None:
        """VXLAN-encapsulate and forward to the broker (reference:
        npb_sender VXLAN/ZMQ transport — VXLAN chosen: any standard
        collector decaps it)."""
        if self._npb_sock is None:
            return
        vxlan = struct.pack(">II", 0x08 << 24, self.npb_vni << 8)
        try:
            self._npb_sock.sendto(vxlan + frame, self._npb_addr)
            self.stats["npb_frames"] += 1
        except OSError:
            self.stats["npb_errors"] += 1

    def maybe_flush(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_flush < self.FLUSH_INTERVAL_S \
                and len(self._buf) < self.MAX_BUFFERED:
            return
        self.flush()

    def flush(self) -> None:
        """Ship buffered frames as a pcap to the server's pcap store."""
        with self._lock:
            frames = list(self._buf)
            self._buf.clear()
            self._last_flush = time.monotonic()
        if not frames or self.sender is None:
            return
        out = bytearray(_PCAP_GLOBAL_HDR)
        start_ns = frames[0][0]
        for ts_ns, frame in frames:
            out += struct.pack("<IIII", ts_ns // 1_000_000_000,
                               (ts_ns % 1_000_000_000) // 1000,
                               len(frame), len(frame))
            out += frame
        self._capture_seq += 1
        up = wire.PcapUpload(
            name=f"acl-pcap-{self.agent_id}-{self._capture_seq}",
            agent_id=self.agent_id, start_ns=start_ns,
            packet_count=len(frames),
            pcap_gz=gzip.compress(bytes(out), mtime=0))
        self.sender.send(MessageType.PCAP, up.SerializeToString())
        self.stats["uploads"] += 1

    def stop(self) -> None:
        self.flush()
        if self._npb_sock is not None:
            self._npb_sock.close()
            self._npb_sock = None
