"""Frame sink: the probe's agent-side send path.

Encodes span batches and step payloads as frames with this package's
codec and either keeps them in memory or writes them to a TCP
``host:port``, such as the reference ingester. The reference sender's
spool, QoS and acknowledgements are not part of this sink.
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import threading

from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame

log = logging.getLogger("df.agent")


def parse_target(target: str) -> tuple[str, int]:
    host, sep, port = target.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"sink target must be host:port, got {target!r}")
    return host.strip("[]"), int(port)


class FrameSink:
    """The agent object a TpuProbe is given: ``config``, ``process_name``
    and the two send methods of the reference agent."""

    def __init__(self, config: AgentConfig | None = None,
                 process_name: str | None = None) -> None:
        self.config = config if config is not None else AgentConfig()
        self.process_name = (process_name or os.path.basename(sys.argv[0])
                             or "python")
        self._addr = (parse_target(self.config.sink_target)
                      if self.config.sink_target else None)
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self.frames: list[bytes] = []   # memory mode only
        self.stats = {"frames": 0, "bytes": 0, "send_errors": 0,
                      "tpu_span_frames": 0, "step_frames": 0}

    def send_tpu_spans(self, payload: bytes) -> bool:
        """A serialized TpuSpanBatch (spans and/or memory samples)."""
        return self._send(MessageType.TPU_SPAN, payload, "tpu_span_frames")

    def send_step_metrics(self, payload: bytes) -> bool:
        """A STEP_METRICS payload (JSON; see tpuprobe/stepmetrics.py)."""
        return self._send(MessageType.STEP_METRICS, payload, "step_frames")

    def _send(self, msg_type: MessageType, payload: bytes, key: str) -> bool:
        frame = encode_frame(FrameHeader(msg_type), payload)
        with self._lock:
            if self._addr is None:
                self.frames.append(frame)
            else:
                try:
                    if self._sock is None:
                        self._sock = socket.create_connection(
                            self._addr, timeout=5.0)
                    self._sock.sendall(frame)
                except OSError:
                    # drop the frame and the connection; the next frame
                    # reconnects
                    self.stats["send_errors"] += 1
                    log.warning("frame send to %s:%d failed", *self._addr)
                    self._close_locked()
                    return False
            self.stats["frames"] += 1
            self.stats[key] += 1
            self.stats["bytes"] += len(frame)
        return True

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()
