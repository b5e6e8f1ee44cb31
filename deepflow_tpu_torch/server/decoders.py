"""Per-message-type decoders: frame payloads -> tag-injected store rows.

Own copy of the profile path of ``deepflow_tpu/server/decoders.py``: the
``DedupWindow`` that makes retransmitted frames into no second row, the
``Decoder`` base (one receiver queue, a worker thread, stats) and the
PROFILE, TPU_SPAN, STEP_METRICS and DFSTATS decoders. TPU_SPAN payloads
decode with the port's native columnar decoder (``native/ingest.cpp``),
the others with this package's ``proto/wire.py``. Each decoder accounts
its frames on a ``decoder.<TYPE>`` hop (delivered, or dropped as a dup
or a decode error) and its rows on the ``table_write`` hop, and its
worker beats a heartbeat.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time

import numpy as np

from deepflow_tpu_torch import native
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.native import (
    SPAN_STRS, ArenaStrings, SpanColumnDecoder)
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.telemetry import Telemetry
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


def _shifted(times, off: int) -> np.ndarray:
    """Absolute ns times (a list or a uint64 array) moved by a clock
    offset, in int64 arithmetic stored as uint64 (the reference's
    columnar path)."""
    t = np.asarray(times, dtype=np.uint64)
    if not off:
        return t
    return (t.astype(np.int64) + off).astype(np.uint64)


class DedupWindow:
    """Per-agent exactly-once guard: a floor that advances with
    contiguity plus a bounded park set of decoded seqs above it.

    Every seq at or below an agent's floor is a dup; seqs above it park
    and are absorbed into the floor as the run becomes contiguous. Floors
    also move forward by ``advance_floor`` (SEQ_BASE). If a park set
    outgrows ``capacity`` (an unannounced permanent gap), the floor jumps
    to the oldest parked seq. One window is shared by all decoders: the
    seq space is per agent, not per message type."""

    def __init__(self, capacity: int = 65536) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        # agent_id -> [floor, set of parked seqs > floor]
        self._state: dict[int, list] = {}
        self.stats = {"dups": 0, "tracked": 0, "floor_jumps": 0}

    def seen(self, agent_id: int, seq: int) -> bool:
        """Mark (agent, seq); True if it was marked before (a dup)."""
        with self._lock:
            st = self._state.get(agent_id)
            if st is None:
                st = self._state[agent_id] = [0, set()]
            floor, parked = st
            if seq <= floor or seq in parked:
                self.stats["dups"] += 1
                return True
            parked.add(seq)
            self.stats["tracked"] += 1
            if seq == floor + 1:
                while floor + 1 in parked:
                    floor += 1
                    parked.discard(floor)
                st[0] = floor
            elif len(parked) > self.capacity:
                floor = min(parked)
                parked.discard(floor)
                while floor + 1 in parked:
                    floor += 1
                    parked.discard(floor)
                st[0] = floor
                self.stats["floor_jumps"] += 1
            return False

    def advance_floor(self, agent_id: int, floor: int) -> None:
        """Forward-only floor jump (SEQ_BASE)."""
        with self._lock:
            st = self._state.get(agent_id)
            if st is None:
                self._state[agent_id] = [floor, set()]
                return
            if floor <= st[0]:
                return
            parked = st[1]
            parked.difference_update({s for s in parked if s <= floor})
            while floor + 1 in parked:
                floor += 1
                parked.discard(floor)
            st[0] = floor


class Decoder:
    """Base: drain one queue, decode, write. Subclasses set MSG_TYPE.

    With a ``dedup`` window, a seq'd frame seen before is counted in
    ``dups`` and writes nothing. With a ``seq_tracker``, every seq'd frame
    is observed after the pass that wrote its rows, so an ack means the
    rows are in the store (dups and decode errors are observed too: a
    resend would meet the same fate)."""

    MSG_TYPE: MessageType
    DRAIN_FRAMES = 64  # max frames one wakeup consumes

    def __init__(self, q: queue.Queue, db: Database,
                 platform: PlatformInfoTable, dedup: DedupWindow | None = None,
                 seq_tracker=None, telemetry: Telemetry | None = None) -> None:
        self.q = q
        self.db = db
        self.platform = platform
        self.dedup = dedup
        self.seq_tracker = seq_tracker
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stats_lock = threading.Lock()
        # handle_ns: wall time inside handle(); append_ns: the part spent
        # in store appends (handle_ns - append_ns = decode)
        self.stats = {"batches": 0, "rows": 0, "errors": 0, "dups": 0,
                      "handle_ns": 0, "append_ns": 0}
        self.telemetry = telemetry or Telemetry("server", enabled=False)
        self._hop = self.telemetry.hop(f"decoder.{self.MSG_TYPE.name}")
        self._tw_hop = self.telemetry.hop("table_write")

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
                drained.extend(self._unwrap(self.q.get_nowait()))
            except queue.Empty:
                break
        if drained:
            self._handle_items(drained)

    def _handle_items(self, items: list) -> None:
        """Decode and write a list of (header, payload)."""
        batches = rows = errors = dups = 0
        t0 = time.perf_counter_ns()
        for header, payload in items:
            if (self.dedup is not None and header.seq is not None
                    and self.dedup.seen(header.agent_id, header.seq)):
                dups += 1
                continue
            try:
                rows += self.handle(header, payload)
                batches += 1
            except Exception:
                errors += 1
                log.exception("decode error (%s)", self.MSG_TYPE.name)
        dt = time.perf_counter_ns() - t0
        if self.seq_tracker is not None:
            for header, _ in items:
                if header.seq is not None:
                    self.seq_tracker.observe(header.agent_id, header.seq)
        if dups:
            self._hop.account(dropped=dups, reason="dup")
        self._hop.account(delivered=batches, dropped=errors,
                          reason="decode_error" if errors else "")
        with self._stats_lock:
            self.stats["batches"] += batches
            self.stats["rows"] += rows
            self.stats["errors"] += errors
            self.stats["dups"] += dups
            self.stats["handle_ns"] += dt

    def _unwrap(self, item) -> list:
        """The frames of one queue item: the receiver's (enqueue ns,
        frames), or a bare frame list; the dequeue is accounted on the
        hop with its queue wait."""
        if isinstance(item, tuple):
            enq_ns, frames = item
            self._hop.account(emitted=len(frames),
                              wait_ns=time.monotonic_ns() - enq_ns)
        else:
            frames = item
            self._hop.account(emitted=len(frames))
        return frames

    def _run(self) -> None:
        hb = self.telemetry.heartbeat(f"decoder.{self.MSG_TYPE.name}.0")
        handled = 0
        while not self._stop.is_set():
            hb.beat(progress=handled)
            try:
                items = self._unwrap(self.q.get(timeout=0.2))
            except queue.Empty:
                continue
            # the receiver queues one frame list per recv(); take whatever
            # else is already queued too, up to a bound
            while len(items) < self.DRAIN_FRAMES:
                try:
                    items = items + self._unwrap(self.q.get_nowait())
                except queue.Empty:
                    break
            handled += len(items)
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

    def _timed_append(self, n: int, append, *args) -> None:
        t0 = time.perf_counter_ns()
        append(*args)
        dt = time.perf_counter_ns() - t0
        self._tw_hop.account(emitted=n, delivered=n, wait_ns=dt)
        with self._stats_lock:
            self.stats["append_ns"] += dt

    def write(self, table_name: str, rows: list[dict]) -> None:
        self._timed_append(len(rows), self.db.table(table_name).append_rows,
                           rows)

    def write_columns(self, table_name: str, cols: dict, n: int) -> None:
        self._timed_append(n, self.db.table(table_name).append_columns,
                           cols, n)


class ProfileDecoder(Decoder):
    """ProfileBatch -> profile.in_process_profile."""

    MSG_TYPE = MessageType.PROFILE

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        batch = wire.ProfileBatch.FromString(payload)
        tags = self._agent_tags(header)
        off = self._clock_offset(header)
        rows = [{
            "time": p.timestamp_ns + off,
            "app_service": p.app_service or p.process_name,
            "process_name": p.process_name,
            "event_type": int(p.event_type),
            "profiler": p.profiler,
            "pid": p.pid,
            "tid": p.tid,
            "thread_name": p.thread_name,
            "stack": p.stack.decode("utf-8", "replace"),
            "value": p.value,
            "count": p.count,
            **tags,
        } for p in batch.profiles]
        self.write("profile.in_process_profile", rows)
        return len(rows)


class StatsDecoder(Decoder):
    """StatsBatch -> deepflow_system.deepflow_system (self-stats): one row
    per (metric, value name)."""

    MSG_TYPE = MessageType.DFSTATS

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        batch = wire.StatsBatch.FromString(payload)
        tags = self._agent_tags(header)
        off = self._clock_offset(header)
        rows = []
        for m in batch.metrics:
            tag_json = json.dumps(m.tags, sort_keys=True)
            for vname, v in m.values.items():
                rows.append({
                    "time": m.timestamp_ns + off,
                    "metric_name": m.name,
                    "tag_json": tag_json,
                    "value_name": vname,
                    "value": v,
                    **tags,
                })
        self.write("deepflow_system.deepflow_system", rows)
        return len(rows)


class TpuSpanDecoder(Decoder):
    """TpuSpanBatch -> profile.tpu_hlo_span and profile.tpu_memory.

    Spans and memory samples decode natively (``native/ingest.cpp``
    df_decode_span_cols): fields land in numpy arrays with the
    interpreter lock released, and string cells stay (arena, off, len)
    until the dictionary interns them in C++. A batch the native decoder
    refuses is malformed: it takes the pure ``wire`` path, which raises
    on it or writes the same rows. ``native_batches`` and
    ``pure_batches`` in the stats count which path each batch took.
    Constructing the decoder builds and loads the native library, or
    raises."""

    MSG_TYPE = MessageType.TPU_SPAN

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        native.load()
        self.stats.update(native_batches=0, pure_batches=0)
        # native decode buffers, one set per thread that handles frames
        # (the worker, and stop()'s drain)
        self._tl = threading.local()

    def _columns(self) -> SpanColumnDecoder:
        dec = getattr(self._tl, "dec", None)
        if dec is None:
            dec = self._tl.dec = SpanColumnDecoder()
        return dec

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        res = self._columns().decode(payload)
        with self._stats_lock:
            self.stats["pure_batches" if res is None
                       else "native_batches"] += 1
        if res is None:
            return self.handle_pure(header, payload)
        return self._handle_cols(header, *res)

    def _handle_cols(self, header: FrameHeader, n: int, cols: dict,
                     n_mem: int, arena: np.ndarray) -> int:
        tags = self._agent_tags(header)
        off = self._clock_offset(header)

        def strs(name: str):
            lens = cols[f"{name}_len"]
            if not lens.any():
                return ""
            return ArenaStrings(arena, cols[f"{name}_off"], lens)

        if n:
            out = {name: strs(name) if name in SPAN_STRS else cols[name]
                   for name in _SPAN_COLS}
            out["time"] = _shifted(cols["start_ns"], off)
            out["app_service"] = out["process_name"]
            out.update(tags)
            sl = cols["slice_id"]  # as in handle_pure
            out["slice_id"] = np.where(sl != 0, sl,
                                       np.uint32(tags.get("slice_id", 0)))
            self.write_columns("profile.tpu_hlo_span", out, n)
        if n_mem:
            mem = {name: cols[f"m_{name}"] for name in _MEM_COLS
                   if name != "process_name"}
            mem["process_name"] = strs("m_pname")
            mem["time"] = _shifted(cols["m_timestamp_ns"], off)
            mem.update(tags)
            self.write_columns("profile.tpu_memory", mem, n_mem)
        return n + n_mem

    def handle_pure(self, header: FrameHeader, payload: bytes) -> int:
        """The batch through the pure-Python ``wire`` decoder: the same
        rows as the native path, or the decode error."""
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
