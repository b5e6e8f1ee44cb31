"""Frame sink: an in-memory stand-in for the agent, for a probe driven in
process.

Encodes span batches and step payloads as frames with this package's
codec and keeps them in memory, so a caller can decode them or write them
to a server itself. Frames to a server go through ``agent/sender.py``
(seqs, acks, retransmits) under ``Agent``.
"""

from __future__ import annotations

import os
import sys
import threading

from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame


class FrameSink:
    """The agent object a TpuProbe is given: ``config``, ``process_name``
    and the two send methods of the reference agent."""

    def __init__(self, config: AgentConfig | None = None,
                 process_name: str | None = None) -> None:
        self.config = config if config is not None else AgentConfig()
        self.process_name = (process_name or os.path.basename(sys.argv[0])
                             or "python")
        self._lock = threading.Lock()
        self.frames: list[bytes] = []
        self.stats = {"frames": 0, "bytes": 0,
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
            self.frames.append(frame)
            self.stats["frames"] += 1
            self.stats[key] += 1
            self.stats["bytes"] += len(frame)
        return True
