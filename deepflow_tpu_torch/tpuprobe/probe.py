"""TpuProbe: the agent component that owns the device span sources.

Port of ``deepflow_tpu/tpuprobe/probe.py`` with the same agent contract:
it reads ``agent.config.tpuprobe`` and ``agent.process_name`` and calls
``agent.send_tpu_spans(payload)`` / ``agent.send_step_metrics(payload)``
with serialized TpuSpanBatch bytes and STEP_METRICS JSON. An agent's
``telemetry`` (when it has one) gets the ``tpuprobe`` and
``tpuprobe.steps`` hops and the sources' heartbeats; its ``step_hook``
(when it has one) is the capture source's, so step numbers run on across
probes the agent stops and starts.
"""

from __future__ import annotations

import os
import threading

from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.telemetry import Telemetry
from deepflow_tpu_torch.tpuprobe.events import TpuSpanEvent, batch_to_pb
from deepflow_tpu_torch.tpuprobe.sources import KinetoSource, MemorySource
from deepflow_tpu_torch.tpuprobe.stepmetrics import (
    StepAggregator, encode_step_payload)


class TpuProbe:
    def __init__(self, agent) -> None:
        self.agent = agent
        cfg = agent.config.tpuprobe
        self.cfg = cfg
        self.sources: list = []
        self._lock = threading.Lock()
        self.stats = {"spans_sent": 0, "batches": 0}
        self.telemetry = (getattr(agent, "telemetry", None)
                          or Telemetry("agent", enabled=False))
        self._hop = self.telemetry.hop("tpuprobe")
        # step records get their own hop: a loss on the steps path must
        # not hide inside the span ledger
        self.stepagg: StepAggregator | None = None
        if cfg.step_metrics:
            self._steps_hop = self.telemetry.hop("tpuprobe.steps")
            self.stepagg = StepAggregator(self._step_sink, topk=cfg.step_topk)

    def start(self) -> "TpuProbe":
        self.sources.append(KinetoSource(
            self._sink,
            interval_s=self.cfg.trace_interval_s,
            duration_ms=self.cfg.trace_duration_ms,
            target_coverage=self.cfg.target_coverage,
            steps_per_capture=self.cfg.steps_per_capture,
            telemetry=self.telemetry,
            step_hook=getattr(self.agent, "step_hook", None)).start())
        if self.cfg.memory_poll_s > 0:
            self.sources.append(MemorySource(
                self._mem_sink, poll_interval_s=self.cfg.memory_poll_s,
                telemetry=self.telemetry).start())
        return self

    def stop(self) -> None:
        for s in self.sources:
            s.stop()
        if self.stepagg:
            self.stepagg.flush()  # ship the last (still-open) step

    def _sink(self, events: list[TpuSpanEvent]) -> None:
        if not events:
            return
        payload = batch_to_pb(events, pid=os.getpid(),
                              process_name=self.agent.process_name)
        with self._lock:
            self.stats["spans_sent"] += len(events)
            self.stats["batches"] += 1
        self._hop.account(emitted=1, delivered=1)
        self.agent.send_tpu_spans(payload)
        if self.stepagg:
            self.stepagg.feed(events)

    def _step_sink(self, records: list[dict]) -> None:
        if not records:
            return
        payload = encode_step_payload(
            records, pid=os.getpid(), process_name=self.agent.process_name)
        with self._lock:
            self.stats["steps_sent"] = \
                self.stats.get("steps_sent", 0) + len(records)
        self._steps_hop.account(emitted=1)
        if self.agent.send_step_metrics(payload):
            self._steps_hop.account(delivered=1)
        else:
            self._steps_hop.account(dropped=1, reason="send_queue_full")

    def _mem_sink(self, samples: list[dict]) -> None:
        if not samples:
            return
        batch = wire.TpuSpanBatch(memory=[
            wire.TpuMemorySample(**s, pid=os.getpid(),
                                 process_name=self.agent.process_name)
            for s in samples])
        with self._lock:
            self.stats["mem_samples_sent"] = \
                self.stats.get("mem_samples_sent", 0) + len(samples)
        self._hop.account(emitted=1, delivered=1)
        self.agent.send_tpu_spans(batch.SerializeToString())
