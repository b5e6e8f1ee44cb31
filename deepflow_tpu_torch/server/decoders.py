"""Per-message-type decoders: frame payloads -> tag-injected store rows.

Own copy of the profile and flow paths of ``deepflow_tpu/server/
decoders.py``: the ``DedupWindow`` that makes retransmitted frames into no
second row, the ``Decoder`` base (one receiver queue, a worker thread,
stats) and the PROFILE, TPU_SPAN, STEP_METRICS, DFSTATS, L4_LOG / L7_LOG
(``FlowLogDecoder``), METRICS (``MetricsDecoder``) and EVENT
(``EventDecoder``, with the file-I/O minute windows) decoders. Every
table write feeds the exporters (``server/exporters.py``) when the
server has them; the columnar writes build row dicts only for a table
an exporter wants.
TPU_SPAN, flow-log and metric-document payloads decode with the port's
native columnar decoders (``native/ingest.cpp``, ``native/pbcols.cpp``),
the others with this package's ``proto/wire.py``; a batch the native
decoder refuses as malformed, and a flow or document batch that carries
an address other than IPv4 (the reference's routing), takes the
``wire`` path, counted in ``pure_batches``. The L7 rows that carry a
trace id feed the ingest-time trace trees (``server/tracetree.py``) on
both paths. With a replication ring (``cluster/hashring.py``) every
row an agent's frame carries is tagged with the ring's primary owner
of that agent (``owner_shard``) and the ring's ``ring_epoch``, on the
native and the pure path alike: the coordinates the query-time claim
filter dedups the replicas' copies by; rows without a ring, and the
server's own sinks, stay at epoch 0. Each decoder accounts
its frames on a ``decoder.<TYPE>`` hop (delivered, or dropped as a dup
or a decode error) and its rows on the ``table_write`` hop, and its
worker beats a heartbeat.
"""

from __future__ import annotations

import ipaddress
import json
import logging
import os
import queue
import re
import threading
import time

import numpy as np

from deepflow_tpu_torch import native
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.native import (
    IP_DST_EMPTY, IP_FALLBACK, IP_SRC_EMPTY, SPAN_STRS, ArenaStrings,
    DocColumnDecoder, L4ColumnDecoder, L7ColumnDecoder, SpanColumnDecoder)
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.schema import (
    CLOSE_TYPES, L7_PROTOS, RESPONSE_STATUS, SIDE_RESOLVE_NAMES,
    SIDE_TAG_NAMES)
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

    def __init__(self, capacity: int = 65536,
                 floors: dict[int, int] | None = None,
                 parked: dict[int, list[int]] | None = None) -> None:
        """``floors`` and ``parked``: persisted per-agent floors and the
        seqs held above them (a restart with a data dir): a retransmit of
        a frame already held is a dup."""
        self.capacity = capacity
        self._lock = threading.Lock()
        # agent_id -> [floor, set of parked seqs > floor]
        self._state: dict[int, list] = {
            int(a): [int(f), set()] for a, f in (floors or {}).items()}
        for a, seqs in (parked or {}).items():
            st = self._state.setdefault(int(a), [0, set()])
            st[1].update(int(s) for s in seqs if int(s) > st[0])
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
    resend would meet the same fate). With a ``durability`` gate
    (``--storage``) the frames park in the gate instead, and the flusher
    observes them into the tracker after the commit that made their rows
    durable (``server/flusher.py``)."""

    MSG_TYPE: MessageType
    DRAIN_FRAMES = 64  # max frames one wakeup consumes
    WORKERS = 1  # threads draining the queue; rows of several interleave

    def __init__(self, q: queue.Queue, db: Database,
                 platform: PlatformInfoTable, dedup: DedupWindow | None = None,
                 seq_tracker=None, telemetry: Telemetry | None = None,
                 msg_type: MessageType | None = None,
                 durability=None, pod_index=None, gpid_table=None,
                 resources=None, ring=None, exporters=None) -> None:
        if msg_type is not None:  # a decoder that serves several types
            self.MSG_TYPE = msg_type
        self.q = q
        self.db = db
        self.platform = platform
        # the flow enrichment's sources, each optional: genesis's pod
        # index and ResourceIndex (server/platform_info.py), and the
        # controller's GpidAllocator (its name_lookup)
        self.pod_index = pod_index
        self.gpid_table = gpid_table
        self.resources = resources
        self.dedup = dedup
        self.seq_tracker = seq_tracker
        self.durability = durability
        # zero-arg callable -> the current HashRing or None (the
        # server's _current_ring: the ring is adopted after the
        # decoders start)
        self.ring = ring
        # the ExporterManager (server/exporters.py), or None: every table
        # write feeds it
        self.exporters = exporters
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._stats_lock = threading.Lock()
        # handle_ns: wall time inside handle(); append_ns: the part spent
        # in store appends (handle_ns - append_ns = decode); export_rows:
        # row dicts built from columns for an exporter that wants them
        self.stats = {"batches": 0, "rows": 0, "errors": 0, "dups": 0,
                      "handle_ns": 0, "append_ns": 0, "export_rows": 0}
        self.telemetry = telemetry or Telemetry("server", enabled=False)
        self._hop = self.telemetry.hop(f"decoder.{self.MSG_TYPE.name}")
        self._tw_hop = self.telemetry.hop("table_write")

    def start(self) -> "Decoder":
        for i in range(max(1, self.WORKERS)):
            t = threading.Thread(
                target=self._run, args=(i,),
                name=f"df-decoder-{self.MSG_TYPE.name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        """Join the workers, then decode whatever is still queued: those
        frames were accepted and must reach the tables."""
        self._stop.set()
        if not self._threads:
            return
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
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
        if self.durability is not None:
            # the pass and the parking are one step for the flusher's cut
            with self.durability.writing():
                self._decode_items(items)
                for header, _ in items:
                    if header.seq is not None:
                        self.durability.add(header.agent_id, header.seq)
        else:
            self._decode_items(items)

    def _decode_items(self, items: list) -> None:
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
        if self.durability is None and self.seq_tracker is not None:
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

    def _run(self, worker: int = 0) -> None:
        hb = self.telemetry.heartbeat(
            f"decoder.{self.MSG_TYPE.name}.{worker}")
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
        """The frame's agent's universal tags and, with a ring, the
        replication coordinates (owner_shard, ring_epoch)."""
        tags = self.platform.tags_for(header.agent_id)
        ring = self.ring() if self.ring is not None else None
        if ring is not None:
            owners = ring.owners(header.agent_id)
            if owners:
                tags = dict(tags)
                tags["owner_shard"] = owners[0]
                tags["ring_epoch"] = ring.epoch
        return tags

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
        """Append, and feed the exporters the rows."""
        self._timed_append(len(rows), self.db.table(table_name).append_rows,
                           rows)
        if self.exporters is not None and rows:
            self.exporters.feed(table_name, rows)

    def write_columns(self, table_name: str, cols: dict, n: int) -> None:
        """Columnar append (one list, array or scalar a column, no row
        dicts). Row dicts are built for the exporters only when one wants
        the table, with Python numbers and decoded strings for cells (a
        numpy scalar would export as its string)."""
        self._timed_append(n, self.db.table(table_name).append_columns,
                           cols, n)
        if (self.exporters is not None and n
                and self.exporters.wants(table_name)):
            names = list(cols)
            expanded = [v.tolist()
                        if isinstance(v, (np.ndarray, ArenaStrings))
                        else v if isinstance(v, list) else [v] * n
                        for v in cols.values()]
            rows = [dict(zip(names, vals)) for vals in zip(*expanded)]
            with self._stats_lock:
                self.stats["export_rows"] += len(rows)
            self.exporters.feed(table_name, rows)


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


class EventDecoder(Decoder):
    """EventBatch -> event.event, and the file-I/O reducer: the
    ``file-io-read`` / ``file-io-write`` events roll up into per-(pid,
    path, op, agent tags) minute windows in event.file_agg (count, bytes,
    max and sum latency). A window is written once the newest event seen
    (the watermark) is past its end by the grace period; a later event of
    that window starts a fresh row (the counts stay right, the window
    splits). ``flush`` writes every open window (the server's stop). The
    event rows' times take the agent's clock offset, as every decoder's
    do; the windows are cut on the agent's own times, as the
    reference's are."""

    MSG_TYPE = MessageType.EVENT

    WINDOW_NS = 60 * 1_000_000_000
    GRACE_NS = 5 * 1_000_000_000

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        # (window_ns, pid, path, op, tags_json) -> [count, bytes, max, sum]
        self._agg: dict[tuple, list] = {}
        self._agg_lock = threading.Lock()
        self._watermark = 0

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        batch = wire.EventBatch.FromString(payload)
        tags = self._agent_tags(header)
        off = self._clock_offset(header)
        rows = [{
            "time": e.timestamp_ns + off,
            "event_type": e.event_type,
            "resource_type": e.resource_type,
            "resource_name": e.resource_name,
            "pid": e.pid,
            "description": e.description,
            "attrs": json.dumps(e.attrs, sort_keys=True),
            **tags,
        } for e in batch.events]
        self.write("event.event", rows)
        # the tags are the batch's: one JSON text for all its io events
        tags_json = json.dumps(tags, sort_keys=True)
        for e in batch.events:
            if e.event_type in ("file-io-read", "file-io-write"):
                self._reduce_file_io(e, tags_json)
        self._flush_agg()
        return len(rows)

    def _reduce_file_io(self, e: wire.Event, tags_json: str) -> None:
        op = 0 if e.event_type == "file-io-read" else 1
        window = e.timestamp_ns - e.timestamp_ns % self.WINDOW_NS
        try:
            latency = int(e.attrs.get("latency_ns", "0"))
            nbytes = int(e.attrs.get("bytes", "0"))
        except ValueError:
            latency = nbytes = 0
        key = (window, e.pid, e.resource_name, op, tags_json)
        with self._agg_lock:
            acc = self._agg.get(key)
            if acc is None:
                acc = self._agg[key] = [0, 0, 0, 0]
            acc[0] += 1
            acc[1] += nbytes
            acc[2] = max(acc[2], latency)
            acc[3] += latency
            if e.timestamp_ns > self._watermark:
                self._watermark = e.timestamp_ns

    def _flush_agg(self, force: bool = False) -> None:
        """Write the windows the watermark has passed (all with
        ``force``)."""
        rows = []
        with self._agg_lock:
            limit = self._watermark - self.WINDOW_NS - self.GRACE_NS
            for key in [k for k in self._agg if force or k[0] <= limit]:
                window, pid, path, op, tags_json = key
                count, nbytes, mx, total = self._agg.pop(key)
                rows.append({
                    "time": window, "pid": pid, "path": path, "op": op,
                    "count": count, "bytes": nbytes,
                    "max_latency_ns": mx, "sum_latency_ns": total,
                    **json.loads(tags_json),
                })
        if rows:
            self.write("event.file_agg", rows)

    def flush(self) -> None:
        """The final flush: every open window (the server's stop)."""
        self._flush_agg(force=True)


class PcapDecoder(Decoder):
    """PcapUpload -> ``<data-dir>/pcaps/<name>.pcap.gz``, or memory
    without a data dir; the newest ``MAX_MEMORY`` captures are kept and
    listed by the querier's ``/v1/pcaps`` (reference: decoders.py:584-631,
    the ingester's pcap module)."""

    MSG_TYPE = MessageType.PCAP
    MAX_MEMORY = 64
    _store_lock = threading.Lock()

    @staticmethod
    def _safe_name(name: str) -> str:
        """A name off the wire never walks a path."""
        cleaned = re.sub(r"[^A-Za-z0-9._-]", "_", os.path.basename(name))
        return cleaned.lstrip(".") or "unnamed"

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        up = wire.PcapUpload.FromString(payload)
        safe = self._safe_name(up.name)
        entry = {"name": safe, "agent_id": up.agent_id or header.agent_id,
                 "start_ns": up.start_ns, "packet_count": up.packet_count,
                 "bytes_gz": len(up.pcap_gz)}
        with self._store_lock:
            store = getattr(self.db, "pcap_store", None)
            if store is None:
                store = self.db.pcap_store = {"dir": None, "entries": []}
                if self.db.data_dir:
                    store["dir"] = os.path.join(self.db.data_dir, "pcaps")
                    os.makedirs(store["dir"], exist_ok=True)
            if store["dir"]:
                path = os.path.join(store["dir"], f"{safe}.pcap.gz")
                with open(path, "wb") as f:
                    f.write(up.pcap_gz)
                entry["path"] = path
            else:
                entry["data"] = up.pcap_gz
            store["entries"].append(entry)
            for old in store["entries"][:-self.MAX_MEMORY]:
                p = old.get("path")  # an evicted capture leaves no file
                if p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            del store["entries"][:-self.MAX_MEMORY]
        return 1


class FlowLogDecoder(Decoder):
    """FlowLogBatch -> flow_log.l4_flow_log and flow_log.l7_flow_log.
    Registered for both L4_LOG and L7_LOG (``msg_type``), one instance
    each.

    A batch decodes natively (``native/pbcols.cpp``: df_decode_l4_cols,
    then df_decode_l7_cols where it holds L7 entries) into numpy columns,
    with the interpreter lock released, so several decode workers
    (``WORKERS``, 1 as in the reference's default) could use several
    cores; string cells stay (arena, off, len) until the dictionary
    interns them. A batch the native decoder refuses is malformed, and a
    batch with an address that is not IPv4 is formatted by the pure path
    (the reference's routing): both take ``handle_pure``, the reference's
    protobuf path on ``proto/wire.py``, which raises on the batch or
    writes the same rows. Both paths fill the endpoint columns through
    one ladder, ``_resolve_endpoint_cols`` (the reference's): the
    agent's gpid and pod win; else the controller's gpid table
    (``gpid_table.name_lookup``: the socket scans' entries) gives each
    side's gpid and process name, and the ``ResourceIndex`` its pod and
    resource tags, each distinct endpoint resolved once a batch. On the
    native path the join runs on the decoded columns: no batch goes back
    to the pure path for it. L7 rows with a trace id feed
    ``trace_trees``. Constructing the decoder builds and loads the
    native library, or raises."""

    MSG_TYPE = MessageType.L4_LOG

    def __init__(self, *a, trace_trees=None, **kw) -> None:
        super().__init__(*a, **kw)
        native.load()
        self.trace_trees = trace_trees  # TraceTreeBuilder, or None
        self.stats.update(native_batches=0, pure_batches=0)
        self._tl = threading.local()  # native buffers per worker thread
        # u32 address -> dotted string, across batches and workers (a
        # racy duplicate insert is harmless)
        self._ip_memo: dict[int, str] = {}

    def _columns(self, name: str, cls):
        dec = getattr(self._tl, name, None)
        if dec is None:
            dec = cls()
            setattr(self._tl, name, dec)
        return dec

    def _native(self, payload):
        """(L4 decode or None, L7 decode or None), or None when the batch
        takes the pure path."""
        l4 = self._columns("l4", L4ColumnDecoder).decode(payload)
        if l4 is None or _not_v4(l4[1]):
            return None
        l7 = None
        if l4[2]:  # the L7 entries, into the L7 decoder's own buffers
            l7 = self._columns("l7", L7ColumnDecoder).decode(payload)
            if l7 is None or _not_v4(l7[1]):
                return None
        return (l4[0], l4[1], l4[3]) if l4[0] else None, l7

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        res = self._native(payload)
        with self._stats_lock:
            self.stats["pure_batches" if res is None
                       else "native_batches"] += 1
        if res is None:
            return self.handle_pure(header, payload)
        tags = self._agent_tags(header)
        off = self._clock_offset(header)
        l4, l7 = res
        n = 0
        if l4 is not None:
            n += self._handle_l4_cols(*l4, tags, off)
        if l7 is not None and l7[0]:
            n += self._handle_l7_cols(*l7, tags, off)
        return n

    def _resolve_endpoint_cols(self, n: int, ipb0, ipb1, ports0, ports1,
                               protos, agent_g0, agent_g1, pod0, pod1,
                               src_s: list, dst_s: list) -> dict:
        """The gprocess and resource columns of both sides, one ladder
        for the L4 and L7 rows of both decode paths (the reference's,
        decoders.py:708-798). ``ipb0`` / ``ipb1``: each row's address
        bytes (read only by the gpid join; None without a gpid table);
        ``pod0`` / ``pod1``: the agent's pods, a list, arena strings or a
        "" broadcast. Agent values win for the gpid and the pod; each
        distinct (address, port, protocol) asks the gpid table once and
        each distinct address the resource index once."""
        cols: dict = {}
        if self.gpid_table is None:
            cols["gprocess_id_0"] = agent_g0
            cols["gprocess_id_1"] = agent_g1
            cols["process_kname_0"] = ""
            cols["process_kname_1"] = ""
        else:
            nl = self.gpid_table.name_lookup
            cache: dict = {}
            protos = _aslist(protos, n)

            def side(ipbs, ports, agents):
                gpids, names = [], []
                for ipb, port, proto, ag in zip(ipbs, _aslist(ports, n),
                                                protos, _aslist(agents, n)):
                    k = (ipb, port, proto)
                    v = cache.get(k)
                    if v is None:
                        v = cache[k] = nl(ipb, port, proto)
                    gpids.append(ag or v[0])
                    names.append(v[1])
                return gpids, names
            cols["gprocess_id_0"], cols["process_kname_0"] = side(
                ipb0, ports0, agent_g0)
            cols["gprocess_id_1"], cols["process_kname_1"] = side(
                ipb1, ports1, agent_g1)
        if self.resources is not None and not self.resources.is_empty():
            t0, t1 = _resolve_sides(self.resources, src_s, dst_s)
            cols["pod_0"] = [p or t.pod
                             for p, t in zip(_aslist(pod0, n), t0)]
            cols["pod_1"] = [p or t.pod
                             for p, t in zip(_aslist(pod1, n), t1)]
            for name in SIDE_RESOLVE_NAMES:
                cols[f"{name}_0"] = [getattr(t, name) for t in t0]
                cols[f"{name}_1"] = [getattr(t, name) for t in t1]
        elif self.resources is not None:
            # nothing can resolve: the agent's pods, the rest "" broadcast
            cols["pod_0"], cols["pod_1"] = pod0, pod1
            for name in SIDE_RESOLVE_NAMES:
                cols[f"{name}_0"] = ""
                cols[f"{name}_1"] = ""
        elif self.pod_index is not None and len(self.pod_index):
            pods = self.pod_index.snapshot()

            def pod_of(ip: str) -> str:
                pod = pods.get(ip)
                return pod.name if pod is not None else ""
            cols["pod_0"] = [p or pod_of(a)
                             for p, a in zip(_aslist(pod0, n), src_s)]
            cols["pod_1"] = [p or pod_of(a)
                             for p, a in zip(_aslist(pod1, n), dst_s)]
        else:
            cols["pod_0"], cols["pod_1"] = pod0, pod1
        return cols

    def _endpoint_cols(self, items: list, keys: list, src_s: list,
                       dst_s: list) -> dict:
        """The ladder's front end for the pure path's message objects."""
        return self._resolve_endpoint_cols(
            len(items),
            [bytes(k.ip_src) for k in keys], [bytes(k.ip_dst) for k in keys],
            [k.port_src for k in keys], [k.port_dst for k in keys],
            [int(k.proto) for k in keys],
            [f.gpid_0 for f in items], [f.gpid_1 for f in items],
            [f.pod_0 for f in items], [f.pod_1 for f in items],
            src_s, dst_s)

    def _native_endpoint_cols(self, n: int, cols: dict, arena,
                              pod_names: tuple[str, str]) -> tuple:
        """(src dotted, dst dotted, the ladder's columns) of a native
        decode: the address bytes are built only for a gpid join."""
        flags = cols["ip_flags"]
        src_s = _dotted(self._ip_memo, cols["ip4_src"], flags, IP_SRC_EMPTY)
        dst_s = _dotted(self._ip_memo, cols["ip4_dst"], flags, IP_DST_EMPTY)
        ipb0 = ipb1 = None
        if self.gpid_table is not None:
            ipb0 = _packed(cols["ip4_src"], flags, IP_SRC_EMPTY)
            ipb1 = _packed(cols["ip4_dst"], flags, IP_DST_EMPTY)
        ep = self._resolve_endpoint_cols(
            n, ipb0, ipb1, cols["port_src"], cols["port_dst"],
            cols["proto"], cols["gpid_0"], cols["gpid_1"],
            _arena_col(cols, arena, pod_names[0]),
            _arena_col(cols, arena, pod_names[1]), src_s, dst_s)
        return src_s, dst_s, ep

    def _handle_l4_cols(self, n: int, cols: dict, arena, tags: dict,
                        off: int) -> int:
        src_s, dst_s, ep = self._native_endpoint_cols(n, cols, arena,
                                                      ("pod0", "pod1"))
        out = {
            "time": _shifted(cols["end_time_ns"], off),
            "flow_id": cols["flow_id"],
            "ip_src": src_s,
            "ip_dst": dst_s,
            "ip4_src": cols["ip4_src"],
            "ip4_dst": cols["ip4_dst"],
            "port_src": cols["port_src"],
            "port_dst": cols["port_dst"],
            "protocol": cols["proto"],
            "tap_port": cols["tap_port"],
            "start_time": _shifted(cols["start_time_ns"], off),
            "end_time": _shifted(cols["end_time_ns"], off),
            "packet_tx": cols["packet_tx"],
            "packet_rx": cols["packet_rx"],
            "byte_tx": cols["byte_tx"],
            "byte_rx": cols["byte_rx"],
            "l7_request": cols["l7_request"],
            "l7_response": cols["l7_response"],
            "rtt": cols["rtt_us"],
            "art": cols["art_us"],
            "retrans_tx": cols["retrans_tx"],
            "retrans_rx": cols["retrans_rx"],
            "zero_win_tx": cols["zero_win_tx"],
            "zero_win_rx": cols["zero_win_rx"],
            "close_type": cols["close_type"],
            "syn_count": cols["syn_count"],
            "synack_count": cols["synack_count"],
            "tunnel_type": cols["tunnel_type"],
            "tunnel_id": cols["tunnel_id"],
            **ep,
        }
        out.update(tags)  # constant per batch: scalar broadcast
        self.write_columns("flow_log.l4_flow_log", out, n)
        return n

    def _handle_l7_cols(self, n: int, cols: dict, arena, tags: dict,
                        off: int) -> int:
        src_s, dst_s, ep = self._native_endpoint_cols(n, cols, arena,
                                                      ("pod_0", "pod_1"))
        dur = np.maximum(
            cols["end_time_ns"].astype(np.int64)
            - cols["start_time_ns"].astype(np.int64), 0).astype(np.uint64)
        out = {
            "time": _shifted(cols["start_time_ns"], off),
            "flow_id": cols["flow_id"],
            "ip_src": src_s,
            "ip_dst": dst_s,
            "port_src": cols["port_src"],
            "port_dst": cols["port_dst"],
            "tunnel_type": cols["tunnel_type"],
            "tunnel_id": cols["tunnel_id"],
            "l7_protocol": cols["l7_protocol"],
            "request_id": cols["request_id"],
            "response_status": cols["response_status"],
            "response_code": cols["response_code"],
            "response_duration": dur,
            "syscall_trace_id_request": cols["syscall_trace_id_request"],
            "syscall_trace_id_response": cols["syscall_trace_id_response"],
            "syscall_thread_0": cols["syscall_thread_0"],
            "syscall_thread_1": cols["syscall_thread_1"],
            "captured_request_byte": cols["captured_request_byte"],
            "captured_response_byte": cols["captured_response_byte"],
            **ep,
            # the agent-observed kernel thread name wins; the socket
            # scan's join fills the rest
            "process_kname_0": _kname_merge(
                _arena_col(cols, arena, "process_kname_0"),
                ep["process_kname_0"], n),
            "process_kname_1": _kname_merge(
                _arena_col(cols, arena, "process_kname_1"),
                ep["process_kname_1"], n),
            "attrs": _arena_col(cols, arena, "attrs_json"),
        }
        for name in ("version", "request_type", "request_domain",
                     "request_resource", "endpoint", "response_exception",
                     "response_result", "trace_id", "span_id",
                     "parent_span_id", "x_request_id"):
            out[name] = _arena_col(cols, arena, name)
        out.update(tags)  # constant per batch: scalar broadcast
        self.write_columns("flow_log.l7_flow_log", out, n)
        if self.trace_trees is not None:
            self._feed_trace_trees(out, n)
        return n

    def handle_pure(self, header: FrameHeader, payload: bytes) -> int:
        """The batch through the pure-Python ``wire`` decoder (the
        reference's protobuf path, columnar: one list per column): the
        native path's rows, or the decode error."""
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
            src_s = [t[0] for t in src_d]
            dst_s = [t[0] for t in dst_d]
            cols = {
                "time": [f.end_time_ns + off for f in l4],
                "flow_id": [f.flow_id for f in l4],
                "ip_src": src_s,
                "ip_dst": dst_s,
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
                **self._endpoint_cols(l4, keys, src_s, dst_s),
            }
            cols.update(tags)  # constant per batch: scalar broadcast
            self.write_columns("flow_log.l4_flow_log", cols, len(l4))
            n += len(l4)
        if batch.l7:
            n += self._handle_l7_list(batch.l7, tags, off)
        return n

    def _handle_l7_list(self, l7: list, tags: dict, off: int) -> int:
        keys = [f.key for f in l7]
        src_s = [_ip_decode(k.ip_src)[0] for k in keys]
        dst_s = [_ip_decode(k.ip_dst)[0] for k in keys]
        ep = self._endpoint_cols(l7, keys, src_s, dst_s)
        cols = {
            "time": [f.start_time_ns + off for f in l7],
            "flow_id": [f.flow_id for f in l7],
            "ip_src": src_s,
            "ip_dst": dst_s,
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
            **ep,
            # the agent-observed kernel thread name (the reference's
            # sslprobe path) wins; the socket scan's join fills the rest
            "process_kname_0": [
                f.process_kname_0 or k for f, k in zip(
                    l7, _aslist(ep["process_kname_0"], len(l7)))],
            "process_kname_1": [
                f.process_kname_1 or k for f, k in zip(
                    l7, _aslist(ep["process_kname_1"], len(l7)))],
            "attrs": [f.attrs_json for f in l7],
        }
        cols.update(tags)  # constant per batch: scalar broadcast
        self.write_columns("flow_log.l7_flow_log", cols, len(l7))
        if self.trace_trees is not None:
            self._feed_trace_trees(cols, len(l7))
        return len(l7)

    def _feed_trace_trees(self, cols: dict, n: int) -> None:
        """The rows with a trace id, each as ``span_from_l7`` of the
        reference's row dict, into the ingest-time trace trees. Columns
        may be lists, arrays, arena strings or a scalar broadcast."""
        from deepflow_tpu_torch.server.tracetree import span_from_l7

        def values(name: str) -> list:
            col = cols.get(name, "")
            if isinstance(col, ArenaStrings):
                return col.tolist()
            if isinstance(col, np.ndarray):
                return col.tolist()
            if isinstance(col, list):
                return col
            return [col] * n
        tids = values("trace_id")
        rows = [i for i, t in enumerate(tids) if t]
        if not rows:
            return
        cv = {name: values(name) for name in (
            "time", "flow_id", "request_id", "span_id", "parent_span_id",
            "request_type", "endpoint", "request_resource", "app_service",
            "service_1", "host", "l7_protocol", "response_status",
            "response_code", "response_duration", "ip_src", "ip_dst",
            "x_request_id")}
        for i in rows:
            proto_i = int(cv["l7_protocol"][i])
            status_i = int(cv["response_status"][i])
            row = {name: v[i] for name, v in cv.items()}
            row["l7_protocol"] = (L7_PROTOS[proto_i]
                                  if 0 <= proto_i < len(L7_PROTOS)
                                  else "unknown")
            row["response_status"] = (
                RESPONSE_STATUS[status_i]
                if 0 <= status_i < len(RESPONSE_STATUS) else "unknown")
            self.trace_trees.add_span(tids[i], span_from_l7(row))


_IP_MEMO_MAX = 1 << 20  # distinct addresses before a full reset


def _dotted(memo: dict[int, str], u32s: np.ndarray, flags: np.ndarray,
            empty_bit: int) -> list[str]:
    """Dotted addresses of a u32 column; "" where the address bytes were
    empty (the pure path's rendering). ``memo`` keeps each distinct
    address formatted once across batches."""
    uniq, inv = np.unique(u32s, return_inverse=True)
    uniq = uniq.tolist()
    if len(memo) + len(uniq) > _IP_MEMO_MAX:
        memo.clear()
    dotted = []  # this batch's strings: another worker may clear ``memo``
    for u in uniq:
        s = memo.get(u)
        if s is None:
            s = memo[u] = "%d.%d.%d.%d" % (u >> 24 & 255, u >> 16 & 255,
                                           u >> 8 & 255, u & 255)
        dotted.append(s)
    out = [dotted[i] for i in inv.reshape(-1).tolist()]
    for i in np.flatnonzero(flags & empty_bit).tolist():
        out[i] = ""
    return out


def _not_v4(cols: dict) -> bool:
    """True when a decoded batch holds an address that is neither IPv4
    nor empty: the pure path formats those."""
    return bool(cols["is_v6"].any() or (cols["ip_flags"] & IP_FALLBACK).any())


def _arena_col(cols: dict, arena: np.ndarray, name: str):
    """A string column of arena cells, or "" broadcast when every cell
    is empty."""
    lens = cols[f"{name}_len"]
    if not lens.any():
        return ""
    return ArenaStrings(arena, cols[f"{name}_off"], lens)


def _packed(u32s: np.ndarray, flags: np.ndarray, empty_bit: int) -> list:
    """Each row's address as the pure path's bytes: 4 big-endian bytes,
    b"" where the address was empty."""
    uniq, inv = np.unique(u32s, return_inverse=True)
    raw = uniq.astype(">u4").tobytes()
    ub = [raw[i:i + 4] for i in range(0, len(raw), 4)]
    out = [ub[i] for i in inv.reshape(-1).tolist()]
    for i in np.flatnonzero(flags & empty_bit).tolist():
        out[i] = b""
    return out


def _aslist(v, n: int) -> list:
    """A column as a per-row list: a list as it is, arena strings and
    arrays converted, a scalar broadcast repeated."""
    if isinstance(v, list):
        return v
    if isinstance(v, (ArenaStrings, np.ndarray)):
        return v.tolist()
    return [v] * n


def _kname_merge(agent, resolved, n: int):
    """The agent's kernel thread names where set, else the join's."""
    if isinstance(agent, str):  # the "" broadcast: no agent names
        return resolved
    return [a or r for a, r in zip(_aslist(agent, n),
                                   _aslist(resolved, n))]


def _resolve_sides(resources, src_s: list, dst_s: list) -> tuple:
    """Each row's EndpointTags of both sides, one resolve a distinct
    address."""
    res = resources.batch_resolver()
    return [res(a) for a in src_s], [res(a) for a in dst_s]


def _side_tag_cols(resources, src_s: list, dst_s: list) -> dict:
    """A metric document's per-side tags (the documents carry no agent
    pod): every side tag from the index; "" broadcast when the index
    resolves nothing; none without an index."""
    if resources is None:
        return {}
    cols: dict = {}
    if resources.is_empty():
        for name in SIDE_TAG_NAMES:
            cols[f"{name}_0"] = ""
            cols[f"{name}_1"] = ""
        return cols
    t0, t1 = _resolve_sides(resources, src_s, dst_s)
    for name in SIDE_TAG_NAMES:
        cols[f"{name}_0"] = [getattr(t, name) for t in t0]
        cols[f"{name}_1"] = [getattr(t, name) for t in t1]
    return cols


_NET_METERS = ("packet_tx", "packet_rx", "byte_tx", "byte_rx", "flow_count",
               "new_flow", "closed_flow", "rtt_sum", "rtt_count", "retrans",
               "syn_count", "synack_count")
_APP_METERS = ("request", "response", "rrt_sum", "rrt_count", "rrt_max",
               "error_client", "error_server", "timeout")


class MetricsDecoder(Decoder):
    """DocumentBatch -> flow_metrics.network.1s (documents with a flow
    meter) and flow_metrics.application.1s (with an app meter); the 1m,
    1h and 1d rollups come from ``server/datasource.py``'s RollupJob.

    A batch decodes natively (``native/ingest.cpp`` df_decode_doc_cols):
    the meters' fields land in numpy arrays under their column names,
    HasField rides ``has_flow`` / ``has_app`` and empty addresses
    ``ip_flags``. A malformed batch, and one with an address that is
    neither IPv4 nor empty, take ``handle_pure`` (the reference's
    protobuf path, on ``proto/wire.py``), counted in ``pure_batches``.
    Constructing the decoder builds and loads the native library, or
    raises."""

    MSG_TYPE = MessageType.METRICS

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        native.load()
        self.stats.update(native_batches=0, pure_batches=0)
        self._tl = threading.local()
        self._ip_memo: dict[int, str] = {}

    def handle(self, header: FrameHeader, payload: bytes) -> int:
        dec = getattr(self._tl, "docs", None)
        if dec is None:
            dec = self._tl.docs = DocColumnDecoder()
        res = dec.decode(payload)
        if res is not None and (res[1]["ip_flags"] & IP_FALLBACK).any():
            res = None
        with self._stats_lock:
            self.stats["pure_batches" if res is None
                       else "native_batches"] += 1
        if res is None:
            return self.handle_pure(header, payload)
        return self._handle_cols(header, *res)

    def _handle_cols(self, header: FrameHeader, n: int, cols: dict,
                     arena: np.ndarray) -> int:
        tags = self._agent_tags(header)
        off_s = round(self._clock_offset(header) / 1e9)  # 1 s grain
        flags = cols["ip_flags"]
        src = np.asarray(_dotted(self._ip_memo, cols["ip4_src"], flags,
                                 IP_SRC_EMPTY), dtype=object)
        dst = np.asarray(_dotted(self._ip_memo, cols["ip4_dst"], flags,
                                 IP_DST_EMPTY), dtype=object)
        t = cols["timestamp_s"]
        if off_s:
            t = (t.astype(np.int64) + off_s).astype(np.uint64)

        def base_cols(idx: np.ndarray) -> dict:
            src_s, dst_s = src[idx].tolist(), dst[idx].tolist()
            out = {"time": t[idx], "ip_src": src_s, "ip_dst": dst_s,
                   "server_port": cols["port"][idx],
                   **_side_tag_cols(self.resources, src_s, dst_s)}
            out.update(tags)  # constant per batch: scalar broadcast
            return out

        rows = 0
        net = np.flatnonzero(cols["has_flow"])
        if len(net):
            c = base_cols(net)
            c["protocol"] = cols["proto"][net]
            c["direction"] = cols["direction"][net]
            for name in _NET_METERS:
                c[name] = cols[name][net]
            self.write_columns("flow_metrics.network.1s", c, len(net))
            rows += len(net)
        app = np.flatnonzero(cols["has_app"])
        if len(app):
            c = base_cols(app)
            lens = cols["app_service_len"][app]
            c["l7_protocol"] = cols["l7_protocol"][app]
            c["app_service"] = (ArenaStrings(
                arena, cols["app_service_off"][app], lens)
                if lens.any() else "")
            for name in _APP_METERS:
                c[name] = cols[name][app]
            self.write_columns("flow_metrics.application.1s", c, len(app))
            rows += len(app)
        return rows

    def handle_pure(self, header: FrameHeader, payload: bytes) -> int:
        """The batch through the pure-Python ``wire`` decoder (the
        reference's protobuf path): the native path's rows, or the
        decode error."""
        batch = wire.DocumentBatch.FromString(payload)
        tags = self._agent_tags(header)
        off_s = round(self._clock_offset(header) / 1e9)  # 1 s grain
        n = 0

        def base_cols(docs):
            src_s = [_ip_decode(d.tag.ip_src)[0] for d in docs]
            dst_s = [_ip_decode(d.tag.ip_dst)[0] for d in docs]
            cols = {
                "time": [d.timestamp_s + off_s for d in docs],
                "ip_src": src_s,
                "ip_dst": dst_s,
                "server_port": [d.tag.port for d in docs],
                # per-side tags: "group any metric by any resource"
                **_side_tag_cols(self.resources, src_s, dst_s),
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
