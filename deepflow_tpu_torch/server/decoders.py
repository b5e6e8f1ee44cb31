"""Per-message-type decoders: frame payloads -> tag-injected store rows.

Own copy of the profile path of ``deepflow_tpu/server/decoders.py``: the
``Decoder`` base (one receiver queue, a worker thread, stats) and the
TPU_SPAN and STEP_METRICS decoders. Span batches decode with this
package's ``proto/wire.py``; there is no native columnar decode here.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time

import numpy as np

from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.tpuprobe.stepmetrics import decode_step_payload

log = logging.getLogger("df.decoder")

# span / memory-sample fields stored under their own names
_SPAN_COLS = ("duration_ns", "device_id", "chip_id", "core_id", "kind",
              "hlo_module", "hlo_op", "hlo_category", "flops",
              "bytes_accessed", "program_id", "run_id", "collective",
              "bytes_transferred", "replica_group_size", "step", "pid",
              "process_name")
_MEM_COLS = ("device_id", "bytes_in_use", "peak_bytes_in_use",
             "bytes_limit", "largest_free_block", "num_allocs", "pid",
             "process_name")


def _shifted(times: list[int], off: int) -> np.ndarray:
    """Absolute ns times moved by a clock offset, in int64 arithmetic
    stored as uint64 (the reference's columnar path)."""
    t = np.asarray(times, dtype=np.uint64)
    if not off:
        return t
    return (t.astype(np.int64) + off).astype(np.uint64)


class Decoder:
    """Base: drain one queue, decode, write. Subclasses set MSG_TYPE."""

    MSG_TYPE: MessageType
    DRAIN_FRAMES = 64  # max frames one wakeup consumes

    def __init__(self, q: queue.Queue, db: Database,
                 platform: PlatformInfoTable) -> None:
        self.q = q
        self.db = db
        self.platform = platform
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stats_lock = threading.Lock()
        # handle_ns: wall time inside handle(); append_ns: the part spent
        # in store appends (handle_ns - append_ns = decode)
        self.stats = {"batches": 0, "rows": 0, "errors": 0, "dups": 0,
                      "handle_ns": 0, "append_ns": 0}

    def start(self) -> "Decoder":
        self._thread = threading.Thread(
            target=self._run, name=f"df-decoder-{self.MSG_TYPE.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Join the worker, then decode whatever is still queued: those
        frames were accepted and must reach the tables."""
        self._stop.set()
        if self._thread is None:
            return
        self._thread.join(timeout=2.0)
        self._thread = None
        drained = []
        while True:
            try:
                drained.extend(self.q.get_nowait())
            except queue.Empty:
                break
        if drained:
            self._handle_items(drained)

    def _handle_items(self, items: list) -> None:
        """Decode and write a list of (header, payload)."""
        batches = rows = errors = 0
        t0 = time.perf_counter_ns()
        for header, payload in items:
            try:
                rows += self.handle(header, payload)
                batches += 1
            except Exception:
                errors += 1
                log.exception("decode error (%s)", self.MSG_TYPE.name)
        dt = time.perf_counter_ns() - t0
        with self._stats_lock:
            self.stats["batches"] += batches
            self.stats["rows"] += rows
            self.stats["errors"] += errors
            self.stats["handle_ns"] += dt

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                items = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            # the receiver queues one frame list per recv(); take whatever
            # else is already queued too, up to a bound
            while len(items) < self.DRAIN_FRAMES:
                try:
                    items = items + self.q.get_nowait()
                except queue.Empty:
                    break
            self._handle_items(items)

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        raise NotImplementedError

    def _agent_tags(self, header: FrameHeader) -> dict:
        return self.platform.tags_for(header.agent_id)

    def _clock_offset(self, header: FrameHeader) -> int:
        """ns to add to this agent's absolute timestamps (sub-ms offsets
        are measurement noise, not skew)."""
        off = self.platform.offset_for(header.agent_id)
        return off if abs(off) >= 1_000_000 else 0

    def _timed_append(self, append, *args) -> None:
        t0 = time.perf_counter_ns()
        append(*args)
        dt = time.perf_counter_ns() - t0
        with self._stats_lock:
            self.stats["append_ns"] += dt

    def write(self, table_name: str, rows: list[dict]) -> None:
        self._timed_append(self.db.table(table_name).append_rows, rows)

    def write_columns(self, table_name: str, cols: dict, n: int) -> None:
        self._timed_append(self.db.table(table_name).append_columns,
                           cols, n)


class TpuSpanDecoder(Decoder):
    """TpuSpanBatch -> profile.tpu_hlo_span and profile.tpu_memory."""

    MSG_TYPE = MessageType.TPU_SPAN

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        batch = wire.TpuSpanBatch.FromString(payload)
        tags = self._agent_tags(header)
        off = self._clock_offset(header)
        spans, mem = batch.spans, batch.memory
        if spans:
            cols = {name: [getattr(s, name) for s in spans]
                    for name in _SPAN_COLS}
            cols["time"] = _shifted([s.start_ns for s in spans], off)
            cols["app_service"] = cols["process_name"]
            cols.update(tags)
            # a span's own slice wins; the agent's tag fills the rest
            tag_slice = tags.get("slice_id", 0)
            cols["slice_id"] = [s.slice_id or tag_slice for s in spans]
            self.write_columns("profile.tpu_hlo_span", cols, len(spans))
        if mem:
            cols = {name: [getattr(m, name) for m in mem]
                    for name in _MEM_COLS}
            cols["time"] = _shifted([m.timestamp_ns for m in mem], off)
            cols.update(tags)
            self.write_columns("profile.tpu_memory", cols, len(mem))
        return len(spans) + len(mem)


class StepMetricsDecoder(Decoder):
    """STEP_METRICS JSON payloads -> profile.tpu_step_metrics. A malformed
    payload raises ValueError and counts as a decode error."""

    MSG_TYPE = MessageType.STEP_METRICS

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        obj = decode_step_payload(payload)
        tags = self._agent_tags(header)
        off = self._clock_offset(header)
        pid = int(obj.get("pid") or 0)
        pname = str(obj.get("process_name") or "")
        rows = []
        for r in obj["records"]:
            t0 = int(r.get("time") or 0)
            t1 = int(r.get("end_ns") or 0)
            rows.append({
                "time": t0 + off,
                "end_ns": t1 + off,
                "latency_ns": int(r.get("latency_ns") or max(0, t1 - t0)),
                "run_id": int(r.get("run_id") or 0),
                "step": int(r.get("step") or 0),
                "job": str(r.get("job") or ""),
                "device_count": int(r.get("device_count") or 0),
                "device_skew_ns": int(r.get("device_skew_ns") or 0),
                "compute_ns": int(r.get("compute_ns") or 0),
                "collective_ns": int(r.get("collective_ns") or 0),
                "straggler_device": int(r.get("straggler_device") or 0),
                "straggler_lag_ns": int(r.get("straggler_lag_ns") or 0),
                "top_hlos": json.dumps(r.get("top_hlos") or [],
                                       separators=(",", ":")),
                "pid": pid,
                "process_name": pname,
                **tags,
            })
        self.write("profile.tpu_step_metrics", rows)
        return len(rows)
