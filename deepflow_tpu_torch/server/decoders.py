"""Per-message-type decoders: frame payloads -> tag-injected store rows.

Own copy of the profile and flow paths of ``deepflow_tpu/server/
decoders.py``: the ``DedupWindow`` that makes retransmitted frames into no
second row, the ``Decoder`` base (one receiver queue, a worker thread,
stats) and the PROFILE, TPU_SPAN, STEP_METRICS, DFSTATS, L4_LOG / L7_LOG
(``FlowLogDecoder``) and METRICS (``MetricsDecoder``) decoders. TPU_SPAN
payloads decode with the port's native columnar decoder
(``native/ingest.cpp``), the others with this package's ``proto/wire.py``:
the flow decoders take the reference's protobuf path (its native columnar
flow and document decode is not ported yet). Each decoder accounts
its frames on a ``decoder.<TYPE>`` hop (delivered, or dropped as a dup
or a decode error) and its rows on the ``table_write`` hop, and its
worker beats a heartbeat.
"""

from __future__ import annotations

import ipaddress
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
from deepflow_tpu_torch.store.schema import CLOSE_TYPES
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
                 seq_tracker=None, telemetry: Telemetry | None = None,
                 msg_type: MessageType | None = None) -> None:
        if msg_type is not None:  # a decoder that serves several types
            self.MSG_TYPE = msg_type
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


class FlowLogDecoder(Decoder):
    """FlowLogBatch -> flow_log.l4_flow_log and flow_log.l7_flow_log.
    Registered for both L4_LOG and L7_LOG (``msg_type``), one instance
    each. The reference's protobuf path (its ``_handle_pb`` and
    ``_handle_l7_list``), columnar: one list per column. The endpoint
    columns take the agent's gpid and pod values; the reference resolves
    the rest (process names, per-side resource tags) from its socket scan
    and resource index, which the port does not have yet, so they stay
    empty."""

    MSG_TYPE = MessageType.L4_LOG

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        batch = wire.FlowLogBatch.FromString(payload)
        tags = self._agent_tags(header)
        # ingest-side clock correction of this agent's absolute times
        off = self._clock_offset(header)
        n = 0
        if batch.l4:
            l4 = batch.l4
            keys = [f.key for f in l4]
            src_d = [_ip_decode(k.ip_src) for k in keys]
            dst_d = [_ip_decode(k.ip_dst) for k in keys]
            cols = {
                "time": [f.end_time_ns + off for f in l4],
                "flow_id": [f.flow_id for f in l4],
                "ip_src": [t[0] for t in src_d],
                "ip_dst": [t[0] for t in dst_d],
                "ip4_src": [t[1] for t in src_d],
                "ip4_dst": [t[1] for t in dst_d],
                "port_src": [k.port_src for k in keys],
                "port_dst": [k.port_dst for k in keys],
                "protocol": [int(k.proto) for k in keys],
                "tap_port": [k.tap_port for k in keys],
                "start_time": [f.start_time_ns + off for f in l4],
                "end_time": [f.end_time_ns + off for f in l4],
                "packet_tx": [f.packet_tx for f in l4],
                "packet_rx": [f.packet_rx for f in l4],
                "byte_tx": [f.byte_tx for f in l4],
                "byte_rx": [f.byte_rx for f in l4],
                "l7_request": [f.l7_request for f in l4],
                "l7_response": [f.l7_response for f in l4],
                "rtt": [f.rtt_us for f in l4],
                "art": [f.art_us for f in l4],
                "retrans_tx": [f.retrans_tx for f in l4],
                "retrans_rx": [f.retrans_rx for f in l4],
                "zero_win_tx": [f.zero_win_tx for f in l4],
                "zero_win_rx": [f.zero_win_rx for f in l4],
                "close_type": [_close_type_idx(f.close_type) for f in l4],
                "syn_count": [f.syn_count for f in l4],
                "synack_count": [f.synack_count for f in l4],
                "tunnel_type": [min(int(k.tunnel_type), 4) for k in keys],
                "tunnel_id": [k.tunnel_id for k in keys],
                **_endpoint_cols(l4),
            }
            cols.update(tags)  # constant per batch: scalar broadcast
            self.write_columns("flow_log.l4_flow_log", cols, len(l4))
            n += len(l4)
        if batch.l7:
            n += self._handle_l7_list(batch.l7, tags, off)
        return n

    def _handle_l7_list(self, l7: list, tags: dict, off: int) -> int:
        keys = [f.key for f in l7]
        cols = {
            "time": [f.start_time_ns + off for f in l7],
            "flow_id": [f.flow_id for f in l7],
            "ip_src": [_ip_decode(k.ip_src)[0] for k in keys],
            "ip_dst": [_ip_decode(k.ip_dst)[0] for k in keys],
            "port_src": [k.port_src for k in keys],
            "port_dst": [k.port_dst for k in keys],
            "tunnel_type": [min(int(k.tunnel_type), 4) for k in keys],
            "tunnel_id": [k.tunnel_id for k in keys],
            "l7_protocol": [int(f.l7_protocol) for f in l7],
            "version": [f.version for f in l7],
            "request_type": [f.request_type for f in l7],
            "request_domain": [f.request_domain for f in l7],
            "request_resource": [f.request_resource for f in l7],
            "endpoint": [f.endpoint for f in l7],
            "request_id": [f.request_id for f in l7],
            "response_status": [int(f.response_status) for f in l7],
            "response_code": [f.response_code for f in l7],
            "response_exception": [f.response_exception for f in l7],
            "response_result": [f.response_result for f in l7],
            "response_duration": [
                max(0, f.end_time_ns - f.start_time_ns) for f in l7],
            "trace_id": [f.trace_id for f in l7],
            "span_id": [f.span_id for f in l7],
            "parent_span_id": [f.parent_span_id for f in l7],
            "x_request_id": [f.x_request_id for f in l7],
            "syscall_trace_id_request": [
                f.syscall_trace_id_request for f in l7],
            "syscall_trace_id_response": [
                f.syscall_trace_id_response for f in l7],
            "syscall_thread_0": [f.syscall_thread_0 for f in l7],
            "syscall_thread_1": [f.syscall_thread_1 for f in l7],
            "captured_request_byte": [
                f.captured_request_byte for f in l7],
            "captured_response_byte": [
                f.captured_response_byte for f in l7],
            **_endpoint_cols(l7),
            # the agent-observed kernel thread name (the reference's
            # sslprobe path); its socket-scan join fills the rest
            "process_kname_0": [f.process_kname_0 for f in l7],
            "process_kname_1": [f.process_kname_1 for f in l7],
            "attrs": [f.attrs_json for f in l7],
        }
        cols.update(tags)  # constant per batch: scalar broadcast
        self.write_columns("flow_log.l7_flow_log", cols, len(l7))
        return len(l7)


def _endpoint_cols(items: list) -> dict:
    """The reference's endpoint ladder with nothing to resolve from: the
    agent's gpids and pods, no process names."""
    return {"gprocess_id_0": [f.gpid_0 for f in items],
            "gprocess_id_1": [f.gpid_1 for f in items],
            "process_kname_0": "", "process_kname_1": "",
            "pod_0": [f.pod_0 for f in items],
            "pod_1": [f.pod_1 for f in items]}


class MetricsDecoder(Decoder):
    """DocumentBatch -> flow_metrics.network.1s (documents with a flow
    meter) and flow_metrics.application.1s (with an app meter): the
    reference's protobuf path. Its 1m rollups come from a rollup job that
    is not ported yet."""

    MSG_TYPE = MessageType.METRICS

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        batch = wire.DocumentBatch.FromString(payload)
        tags = self._agent_tags(header)
        off_s = round(self._clock_offset(header) / 1e9)  # 1 s grain
        n = 0

        def base_cols(docs):
            cols = {
                "time": [d.timestamp_s + off_s for d in docs],
                "ip_src": [_ip_decode(d.tag.ip_src)[0] for d in docs],
                "ip_dst": [_ip_decode(d.tag.ip_dst)[0] for d in docs],
                "server_port": [d.tag.port for d in docs],
            }
            cols.update(tags)  # constant per batch: scalar broadcast
            return cols

        net = [d for d in batch.docs if d.HasField("flow_meter")]
        if net:
            ms = [d.flow_meter for d in net]
            cols = base_cols(net)
            cols.update({
                "protocol": [int(d.tag.proto) for d in net],
                "direction": [d.tag.direction for d in net],
                "packet_tx": [m.packet_tx for m in ms],
                "packet_rx": [m.packet_rx for m in ms],
                "byte_tx": [m.byte_tx for m in ms],
                "byte_rx": [m.byte_rx for m in ms],
                "flow_count": [m.flow_count for m in ms],
                "new_flow": [m.new_flow for m in ms],
                "closed_flow": [m.closed_flow for m in ms],
                "rtt_sum": [m.rtt_sum_us for m in ms],
                "rtt_count": [m.rtt_count for m in ms],
                "retrans": [m.retrans for m in ms],
                "syn_count": [m.syn_count for m in ms],
                "synack_count": [m.synack_count for m in ms],
            })
            self.write_columns("flow_metrics.network.1s", cols, len(net))
            n += len(net)
        app = [d for d in batch.docs if d.HasField("app_meter")]
        if app:
            ms = [d.app_meter for d in app]
            cols = base_cols(app)
            cols.update({
                "l7_protocol": [int(d.tag.l7_protocol) for d in app],
                "app_service": [d.tag.app_service for d in app],
                "request": [m.request for m in ms],
                "response": [m.response for m in ms],
                "rrt_sum": [m.rrt_sum_us for m in ms],
                "rrt_count": [m.rrt_count for m in ms],
                "rrt_max": [m.rrt_max_us for m in ms],
                "error_client": [m.error_client for m in ms],
                "error_server": [m.error_server for m in ms],
                "timeout": [m.timeout for m in ms],
            })
            self.write_columns("flow_metrics.application.1s", cols,
                               len(app))
            n += len(app)
        return n


_IP_CACHE: dict[bytes, tuple[str, int]] = {}
_IP_CACHE_MAX = 1 << 16


def _ip_decode(raw: bytes) -> tuple[str, int]:
    """Raw address bytes -> (printable string, u32 for IPv4 else 0).
    Memoized: real traffic repeats a bounded host set."""
    hit = _IP_CACHE.get(raw)
    if hit is not None:
        return hit
    if len(raw) == 4:
        val = ("%d.%d.%d.%d" % (raw[0], raw[1], raw[2], raw[3]),
               int.from_bytes(raw, "big"))
    elif not raw:
        val = ("", 0)
    else:
        try:
            val = (str(ipaddress.ip_address(raw)), 0)
        except ValueError:
            val = (raw.hex(), 0)
    if len(_IP_CACHE) >= _IP_CACHE_MAX:
        _IP_CACHE.clear()  # a coarse reset beats per-entry LRU upkeep
    _IP_CACHE[bytes(raw)] = val
    return val


def _close_type_idx(name: str) -> int:
    try:
        return CLOSE_TYPES.index(name or "unknown")
    except ValueError:
        return 0
