"""Dispatcher: packet sources -> flow map -> flow logs + metric documents.

Own copy of ``deepflow_tpu/agent/dispatcher.py``: ``flow_to_l4_pb`` and
``record_to_l7_pb`` turn closed flows and matched L7 sessions into the
wire's ``L4FlowLog`` and ``L7FlowLog``, the ``QuadrupleGenerator`` turns
them into per-second ``Document``s, and the dispatcher batches them into
``L4_LOG``, ``L7_LOG`` and ``METRICS`` frames for the sender, with the
reference's ledger hops (``flow_map``, ``collector``, ``dispatcher``) on
the port's ``telemetry.py``. Sources: ``inject`` (a decoded MetaPacket),
``replay_pcap`` and live capture (``live_capture.py``).

The engine is ``"native"`` by default: raw frames go through the C++ map
of ``native/flowmap.cpp`` (``native_flow.NativeFlowMap``), and a native
library that does not build or load raises. ``"python"`` runs the
pure-Python ``FlowMap`` alone and is used only when a caller names it.
MetaPacket injection always takes the Python map (disjoint key spaces,
shared output callbacks), as in the reference. With a ``labeler``
(``agent/labeler.py``) each closed flow is labeled: its L4 and L7 logs
carry the labeler's pods (``pod_0`` / ``pod_1``), and a flow an ACL
``ignore``s is dropped whole (its L4 log, its L7 logs and its documents;
``ignored_flows``). ``packet_actions`` (``agent/packet_actions.py``),
once an agent sets it, runs the pcap and NPB actions on the raw frames
of pcap replay (both engines) and of the SOCK_RAW capture. Reference
analog: agent/src/dispatcher (capture loop) + the sender conversion in
flow_generator. This module loads no torch.
"""

from __future__ import annotations

import json
import logging
import threading

from deepflow_tpu_torch.agent.collector import QuadrupleGenerator
from deepflow_tpu_torch.agent.flow_map import FlowMap, FlowNode, L7Record
from deepflow_tpu_torch.agent.packet import (
    MetaPacket, read_pcap, read_pcap_records)
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.telemetry import Telemetry

log = logging.getLogger("df.dispatcher")

ENGINES = ("native", "python")


def flow_to_l4_pb(node: FlowNode) -> pb.L4FlowLog:
    f = pb.L4FlowLog()
    f.flow_id = node.flow_id
    f.key.ip_src = node.ip_src
    f.key.ip_dst = node.ip_dst
    f.key.port_src = node.port_src
    f.key.port_dst = node.port_dst
    f.key.proto = node.protocol
    f.key.tap_port = node.tap_port
    f.key.tunnel_type = node.tunnel_type
    f.key.tunnel_id = node.tunnel_id
    f.start_time_ns = node.start_ns
    f.end_time_ns = node.end_ns
    f.packet_tx = node.tx.packets
    f.packet_rx = node.rx.packets
    f.byte_tx = node.tx.bytes
    f.byte_rx = node.rx.bytes
    f.l7_request = node.l7_request
    f.l7_response = node.l7_response
    f.rtt_us = node.rtt_us
    if node.art_count:
        f.art_us = node.art_sum_us // node.art_count
    f.retrans_tx = node.tx.retrans
    f.retrans_rx = node.rx.retrans
    f.zero_win_tx = node.tx.zero_window
    f.zero_win_rx = node.rx.zero_window
    f.close_type = node.close_type
    f.tcp_flags_bit_tx = node.tx.tcp_flags_bits
    f.tcp_flags_bit_rx = node.rx.tcp_flags_bits
    f.syn_count = node.syn_count
    f.synack_count = node.synack_count
    return f


def record_to_l7_pb(r: L7Record) -> pb.L7FlowLog:
    node = r.flow
    f = pb.L7FlowLog()
    f.flow_id = node.flow_id
    f.key.ip_src = node.ip_src
    f.key.ip_dst = node.ip_dst
    f.key.port_src = node.port_src
    f.key.port_dst = node.port_dst
    f.key.proto = node.protocol
    f.key.tunnel_type = node.tunnel_type
    f.key.tunnel_id = node.tunnel_id
    f.l7_protocol = node.l7_protocol
    f.start_time_ns = r.start_ns
    f.end_time_ns = r.end_ns
    req, resp = r.request, r.response
    if req is not None:
        if req.attrs:
            f.attrs_json = json.dumps(req.attrs, sort_keys=True,
                                      default=str)
        f.version = req.version
        f.request_type = req.request_type
        f.request_domain = req.request_domain
        f.request_resource = req.request_resource
        f.endpoint = req.endpoint
        f.request_id = req.request_id
        f.trace_id = req.trace_id
        f.span_id = req.span_id
        f.x_request_id = req.x_request_id
        f.captured_request_byte = req.captured_byte
        if req.l7_protocol:
            f.l7_protocol = req.l7_protocol
    f.syscall_trace_id_request = r.syscall_trace_id_request
    f.syscall_trace_id_response = r.syscall_trace_id_response
    f.syscall_thread_0 = r.syscall_thread_0
    f.syscall_thread_1 = r.syscall_thread_1
    if resp is not None:
        f.response_status = resp.response_status
        f.response_code = resp.response_code
        f.response_exception = resp.response_exception
        f.response_result = resp.response_result[:256]
        f.captured_response_byte = resp.captured_byte
        if not resp.trace_id == "" and not f.trace_id:
            f.trace_id = resp.trace_id
    elif req is not None and not req.session_less:
        f.response_status = 4  # unanswered request -> timeout
    return f


class Dispatcher:
    """Owns one flow map shard and converts its outputs to wire batches."""

    def __init__(self, sender=None, agent_id: int = 0,
                 flush_interval_s: float = 1.0,
                 batch_size: int = 256, engine: str = "native",
                 labeler=None, telemetry: Telemetry | None = None) -> None:
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")
        self.sender = sender
        if telemetry is None:
            telemetry = Telemetry("agent", enabled=False)
        self._telemetry = telemetry
        # ledger hops: flow_map counts records surfaced by the flow engine,
        # collector counts metric documents, dispatcher counts wire batches
        # handed to the sender (the only hop here that can drop)
        self._fm_hop = telemetry.hop("flow_map")
        self._co_hop = telemetry.hop("collector")
        self._hop = telemetry.hop("dispatcher")
        self.labeler = labeler  # the agent's labeler, or None
        # the ACL's pcap and NPB actions on frame-visible paths; None
        # until an agent sets one
        self.packet_actions = None
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self._l4_buf: list[pb.L4FlowLog] = []
        self._l7_buf: list[pb.L7FlowLog] = []
        self.quadruple = QuadrupleGenerator(self._emit_docs)
        self.flow_map = FlowMap(
            on_l4_log=self._on_l4, on_l7_log=self._on_l7,
            on_flow_update=self._on_flow_update, agent_id=agent_id)
        # the native engine takes raw frames (ring and socket capture,
        # pcap replay); MetaPacket injection keeps the Python map
        self.native_map = None
        if engine == "native":
            from deepflow_tpu_torch.agent.native_flow import NativeFlowMap
            self.native_map = NativeFlowMap(
                on_l4_log=self._on_l4, on_l7_log=self._on_l7,
                on_flow_update=self._on_flow_update, agent_id=agent_id)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the maps are single-threaded: capture, injection and the flush
        # loop all take this lock
        self._lock = threading.Lock()

    def run_packet_actions(self, frames) -> None:
        """The packet actions on (frame, ts_ns) pairs; nothing unless a
        pcap or npb ACL exists."""
        pa = self.packet_actions
        if pa is None or not pa.enabled():
            return
        for frame, ts_ns in frames:
            try:
                pa.handle_frame(frame, ts_ns)
            except Exception:
                # one malformed frame must not lose the rest of the batch
                log.exception("packet action failed")

    # -- pipeline callbacks ----------------------------------------------------

    def _label(self, node: FlowNode):
        """(source label, destination label, action)."""
        if self.labeler is None:
            return None, None, "trace"
        return self.labeler.label_flow(node.ip_src, node.ip_dst,
                                       node.port_src, node.port_dst,
                                       node.protocol)

    def _ignored(self, action: str) -> bool:
        if action != "ignore":
            return False
        self.labeler.stats["ignored_flows"] += 1
        self._fm_hop.account(emitted=1, dropped=1, reason="acl_ignore")
        return True

    def _on_flow_update(self, node: FlowNode, closed: bool) -> None:
        # an ignored flow is in no log and no document
        if self._label(node)[2] == "ignore":
            return
        self.quadruple.add_flow(node, closed)

    def _on_l4(self, node: FlowNode) -> None:
        src, dst, action = self._label(node)
        if self._ignored(action):
            return
        self._fm_hop.account(emitted=1, delivered=1)
        f = flow_to_l4_pb(node)
        if src is not None:
            f.pod_0 = src.pod
        if dst is not None:
            f.pod_1 = dst.pod
        self._l4_buf.append(f)
        if len(self._l4_buf) >= self.batch_size:
            self._flush_l4()

    def _on_l7(self, record: L7Record) -> None:
        src, dst, action = self._label(record.flow)
        if self._ignored(action):
            return
        self._fm_hop.account(emitted=1, delivered=1)
        self.quadruple.add_l7(record)
        f = record_to_l7_pb(record)
        if src is not None:
            f.pod_0 = src.pod
        if dst is not None:
            f.pod_1 = dst.pod
        self._l7_buf.append(f)
        if len(self._l7_buf) >= self.batch_size:
            self._flush_l7()

    def _flush_l4(self) -> None:
        if not self._l4_buf or self.sender is None:
            if self._l4_buf:
                self._hop.account(emitted=1, dropped=1, reason="no_sender")
            self._l4_buf = []
            return
        batch = pb.FlowLogBatch(l4=self._l4_buf)
        self._l4_buf = []
        self._hop.account(emitted=1, delivered=1)
        self.sender.send(MessageType.L4_LOG, batch.SerializeToString())

    def _flush_l7(self) -> None:
        if not self._l7_buf or self.sender is None:
            if self._l7_buf:
                self._hop.account(emitted=1, dropped=1, reason="no_sender")
            self._l7_buf = []
            return
        batch = pb.FlowLogBatch(l7=self._l7_buf)
        self._l7_buf = []
        self._hop.account(emitted=1, delivered=1)
        self.sender.send(MessageType.L7_LOG, batch.SerializeToString())

    def _emit_docs(self, docs: list) -> None:
        self._co_hop.account(emitted=len(docs))
        if self.sender is None:
            self._co_hop.account(dropped=len(docs), reason="no_sender")
            return
        self._co_hop.account(delivered=len(docs))
        batch = pb.DocumentBatch(docs=docs)
        self._hop.account(emitted=1, delivered=1)
        self.sender.send(MessageType.METRICS, batch.SerializeToString())

    @property
    def stats(self) -> dict:
        """Merged pipeline stats across the Python and native engines."""
        s = dict(self.flow_map.stats)
        if self.native_map is not None:
            for k, v in self.native_map.stats.items():
                s[k] = s.get(k, 0) + v
        return s

    # -- feeding ----------------------------------------------------------------

    def inject(self, packet: MetaPacket) -> None:
        with self._lock:
            self.flow_map.inject(packet)

    def inject_frames(self, frames: list[tuple[bytes, int]]) -> None:
        """Raw (frame, ts_ns) pairs: the native map takes them as one
        packed batch; the Python engine decodes each to a MetaPacket."""
        if self.native_map is not None:
            with self._lock:
                self.native_map.inject_frames(frames)
            return
        from deepflow_tpu_torch.agent.packet import decode_ethernet
        with self._lock:
            for frame, ts_ns in frames:
                mp = decode_ethernet(frame, timestamp_ns=ts_ns)
                if mp is not None:
                    self.flow_map.inject(mp)

    def replay_pcap(self, path: str, tick: bool = True) -> int:
        """Replay a pcap through the pipeline (golden tests / dfctl replay).

        With the native engine, frames go straight to the C++ flow map as
        one packed batch; with the Python one, each frame decodes to a
        MetaPacket in Python.
        """
        if self.native_map is not None:
            raw = [(frame, ts_ns) for frame, ts_ns, _ in
                   read_pcap_records(path)]
            self.run_packet_actions(raw)
            self.inject_frames(raw)
            n = len(raw)
        else:
            if self.packet_actions is not None and \
                    self.packet_actions.enabled():
                # the second parse only where a pcap or npb ACL exists
                self.run_packet_actions(
                    (frame, ts_ns)
                    for frame, ts_ns, _ in read_pcap_records(path))
            packets = read_pcap(path, use_native=False)
            for p in packets:
                self.inject(p)
            n = len(packets)
        if tick:
            self.flush(force=True)
        return n

    def flush(self, force: bool = False, now_ns: int | None = None) -> None:
        with self._lock:
            if force:
                self.flow_map.flush_all()
                if self.native_map is not None:
                    self.native_map.flush_all()
            else:
                self.flow_map.tick(now_ns)
                if self.native_map is not None:
                    self.native_map.tick(now_ns)
            self.quadruple.flush(
                None if now_ns is None else now_ns // 1_000_000_000)
            self._flush_l4()
            self._flush_l7()

    # -- background loop ---------------------------------------------------------

    def start(self) -> "Dispatcher":
        self._thread = threading.Thread(
            target=self._run, name="df-dispatcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Close and ship every flow, and the last rolling capture."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self.flush(force=True)
        if self.packet_actions is not None:
            self.packet_actions.stop()

    def _run(self) -> None:
        hb = self._telemetry.heartbeat(
            "dispatcher", interval_hint_s=self.flush_interval_s)
        flushes = 0
        hb.beat()
        while not self._stop.wait(self.flush_interval_s):
            flushes += 1
            hb.beat(progress=flushes)
            try:
                self.flush()
            except Exception:
                log.exception("dispatcher flush failed")
