"""FlowMap: MetaPacket stream -> flows, perf stats, L7 session logs.

Own copy of ``deepflow_tpu/agent/flow_map.py``: the TCP FSM and its
timeouts, direction, retransmissions and RTT, the L7 inference budget and
the negative endpoint cache, session matching, eviction by heap, ``tick``
and ``flush_all``. The pure-Python engine (``Dispatcher(engine="python")``)
and the L7 half of the native one. Reference analog:
agent/src/flow_generator/flow_map.rs (FlowMap::new :255, inject_meta_packet
:716, flush :2015), flow_state.rs (TCP FSM), perf/tcp.rs (RTT/ART),
protocol_logs/parser.rs:368 (SessionQueue request/response matching).
"""

from __future__ import annotations

import heapq
import ipaddress
import time
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum

from deepflow_tpu_torch.agent.packet import MetaPacket, TcpFlags
from deepflow_tpu_torch.agent.protocol_logs.base import (
    MSG_REQUEST, MSG_RESPONSE, L7ParseResult, get_parser, infer_and_parse)
from deepflow_tpu_torch.proto import wire as pb


class FlowState(IntEnum):
    INIT = 0
    SYN_SENT = 1
    SYN_ACK = 2
    ESTABLISHED = 3
    FIN_1 = 4
    CLOSED = 5
    RST = 6


CLOSE_TYPE = {FlowState.CLOSED: "fin", FlowState.RST: "rst"}

# common service ports for the no-SYN direction heuristic
KNOWN_SERVER_PORTS = frozenset({
    22, 25, 53, 80, 88, 110, 143, 389, 443, 465, 587, 993, 995, 1433, 1521,
    2379, 3000, 3306, 4222, 5000, 5432, 5672, 6379, 8000, 8080, 8443, 8888,
    9000, 9090, 9092, 9200, 11211, 27017, 50051})


@dataclass
class DirectionStats:
    packets: int = 0
    bytes: int = 0
    tcp_flags_bits: int = 0
    retrans: int = 0
    zero_window: int = 0
    max_seq: int = 0
    max_payload_seq: int | None = None  # None = no payload seen; 0 is a
                                        # legitimate post-wrap value


@dataclass
class PendingRequest:
    timestamp_ns: int
    record: L7ParseResult
    syscall_trace_id: int = 0   # thread chain id of the carrying packet
    tid: int = 0


@dataclass
class FlowNode:
    flow_id: int
    ip_src: bytes              # client side (flow initiator)
    ip_dst: bytes
    port_src: int
    port_dst: int
    protocol: int
    start_ns: int
    tap_port: int = 0
    tunnel_type: int = 0       # stripped outer tunnel (0 = none)
    tunnel_id: int = 0
    end_ns: int = 0
    state: FlowState = FlowState.INIT
    tx: DirectionStats = field(default_factory=DirectionStats)  # client->srv
    rx: DirectionStats = field(default_factory=DirectionStats)
    syn_count: int = 0
    synack_count: int = 0
    syn_ns: int = 0
    synack_ns: int = 0
    rtt_us: int = 0
    art_sum_us: int = 0
    art_count: int = 0
    l7_protocol: int = pb.L7_UNKNOWN
    l7_inferred: bool = False
    l7_infer_attempts: int = 0
    l7_request: int = 0
    l7_response: int = 0
    pending: deque = field(default_factory=deque)   # PendingRequest FIFO
    pending_by_id: dict = field(default_factory=dict)
    close_type: str = "unknown"
    new_flow_reported: bool = False

    def ip_src_str(self) -> str:
        return str(ipaddress.ip_address(self.ip_src))

    def ip_dst_str(self) -> str:
        return str(ipaddress.ip_address(self.ip_dst))


@dataclass
class L7Record:
    """A matched (or lone) request/response pair ready to become a row."""
    flow: FlowNode
    request: L7ParseResult | None
    response: L7ParseResult | None
    start_ns: int
    end_ns: int
    # uprobe-source chaining (sslprobe): links this record to others the
    # same thread produced, without W3C headers
    syscall_trace_id_request: int = 0
    syscall_trace_id_response: int = 0
    syscall_thread_0: int = 0   # request-side tid
    syscall_thread_1: int = 0   # response-side tid


class FlowMap:
    """Single-threaded flow table (shard it per dispatcher, like the
    reference's per-queue FlowMaps)."""

    FLOW_TIMEOUT_NS = {
        FlowState.INIT: 5_000_000_000,
        FlowState.SYN_SENT: 5_000_000_000,
        FlowState.SYN_ACK: 5_000_000_000,
        FlowState.ESTABLISHED: 300_000_000_000,
        FlowState.FIN_1: 30_000_000_000,
    }
    MAX_PENDING = 128
    # L7 inference budget (reference: per-endpoint inference verdict table
    # with inference_max_retries, server/agent_config/template.yaml:4276 —
    # redesigned as a per-flow attempt budget plus a negative per-endpoint
    # cache so fleets of unparseable flows to one service stop paying the
    # full parser sweep)
    INFER_MAX_ATTEMPTS = 5
    INFER_ENDPOINT_FAILS = 16     # flow give-ups before the endpoint caches
    INFER_RETRY_EVERY = 64        # periodic re-probe of a cached endpoint
    INFER_CACHE_CAP = 65536

    def __init__(self, on_l4_log=None, on_l7_log=None, on_flow_update=None,
                 agent_id: int = 0, max_flows: int = 1 << 16) -> None:
        self.flows: dict[tuple, FlowNode] = {}
        # (ip_dst, port_dst, protocol) -> consecutive inference failures
        self._infer_fails: dict[tuple, int] = {}
        self.on_l4_log = on_l4_log or (lambda f: None)
        self.on_l7_log = on_l7_log or (lambda r: None)
        self.on_flow_update = on_flow_update or (lambda f, closed: None)
        self.agent_id = agent_id
        self.max_flows = max_flows
        self._next_flow_id = 1
        # lazy-deletion min-heap of (end_ns, tiebreak, key) for O(log n)
        # eviction under churn (reference uses time-wheel expiry)
        self._evict_heap: list[tuple[int, int, tuple]] = []
        self._heap_seq = 0
        self.stats = {"packets": 0, "flows_created": 0, "flows_closed": 0,
                      "l7_records": 0, "evicted": 0}

    # -- ingest ---------------------------------------------------------------

    def inject(self, p: MetaPacket) -> None:
        self.stats["packets"] += 1
        node, is_tx = self._lookup_or_create(p)
        if node is None:
            return
        node.end_ns = p.timestamp_ns
        d = node.tx if is_tx else node.rx
        d.packets += 1
        d.bytes += p.packet_len
        if p.protocol == 1:
            self._tcp_update(node, p, d, is_tx)
        if p.payload:
            self._l7_update(node, p, is_tx)

    def _lookup_or_create(self, p: MetaPacket):
        node = self.flows.get(p.key)
        if node is not None:
            return node, True
        node = self.flows.get(p.reverse_key)
        if node is not None:
            return node, False
        if len(self.flows) >= self.max_flows:
            self._evict_oldest()
        # direction heuristic when no SYN is seen (mid-stream pickup):
        # a well-known/privileged source port marks the SERVER side
        if p.protocol == 1 and not (p.tcp_flags & TcpFlags.SYN):
            src_is_server = (p.port_src in KNOWN_SERVER_PORTS
                             or p.port_src < 1024) and not (
                p.port_dst in KNOWN_SERVER_PORTS or p.port_dst < 1024)
            if src_is_server:
                node = self._new_node(p, flipped=True)
                self.flows[p.reverse_key] = node
                self._heap_push(p.reverse_key, node)
                return node, False
        node = self._new_node(p, flipped=False)
        self.flows[p.key] = node
        self._heap_push(p.key, node)
        return node, True

    def _heap_push(self, key: tuple, node: FlowNode) -> None:
        self._heap_seq += 1
        heapq.heappush(self._evict_heap,
                       (node.end_ns or node.start_ns, self._heap_seq, key))

    def _new_node(self, p: MetaPacket, flipped: bool) -> FlowNode:
        fid = self._next_flow_id
        self._next_flow_id += 1
        self.stats["flows_created"] += 1
        if flipped:
            return FlowNode(
                flow_id=fid, ip_src=p.ip_dst, ip_dst=p.ip_src,
                port_src=p.port_dst, port_dst=p.port_src,
                protocol=p.protocol, start_ns=p.timestamp_ns,
                tap_port=p.tap_port, tunnel_type=p.tunnel_type,
                tunnel_id=p.tunnel_id)
        return FlowNode(
            flow_id=fid, ip_src=p.ip_src, ip_dst=p.ip_dst,
            port_src=p.port_src, port_dst=p.port_dst,
            protocol=p.protocol, start_ns=p.timestamp_ns,
            tap_port=p.tap_port, tunnel_type=p.tunnel_type,
            tunnel_id=p.tunnel_id)

    def _evict_oldest(self) -> None:
        # pop stale heap entries until one matches a live, un-refreshed flow
        while self._evict_heap:
            end_ns, _, key = heapq.heappop(self._evict_heap)
            node = self.flows.get(key)
            if node is None:
                continue  # flow already closed; stale entry
            if node.end_ns > end_ns:
                self._heap_push(key, node)  # saw traffic since; re-file
                continue
            del self.flows[key]
            node.close_type = "forced"
            self._close(node)
            self.stats["evicted"] += 1
            return
        # heap exhausted (shouldn't happen) — fall back to linear scan
        if self.flows:
            oldest_key = min(self.flows, key=lambda k: self.flows[k].end_ns)
            node = self.flows.pop(oldest_key)
            node.close_type = "forced"
            self._close(node)
            self.stats["evicted"] += 1

    # -- TCP state machine + perf ---------------------------------------------

    def _tcp_update(self, node: FlowNode, p: MetaPacket,
                    d: DirectionStats, is_tx: bool) -> None:
        flags = p.tcp_flags
        d.tcp_flags_bits |= flags
        if p.window == 0 and not (flags & TcpFlags.RST):
            d.zero_window += 1
        # retransmission: payload strictly behind the high-water mark, using
        # 32-bit serial-number arithmetic so 2^32 seq wraps (~4 GB) don't
        # produce false-retrans bursts (reference: flow_generator/perf/tcp.rs
        # seq-window logic)
        if p.payload:
            end_seq = (p.seq + len(p.payload)) & 0xFFFFFFFF
            if d.max_payload_seq is not None:
                behind = (d.max_payload_seq - p.seq) & 0xFFFFFFFF
                if 0 < behind < 0x80000000:
                    d.retrans += 1  # segment starts before the high-water mark
                else:
                    d.max_payload_seq = end_seq
            else:
                d.max_payload_seq = end_seq
        if flags & TcpFlags.RST:
            node.state = FlowState.RST
            node.close_type = "rst"
            return
        syn = bool(flags & TcpFlags.SYN)
        ack = bool(flags & TcpFlags.ACK)
        fin = bool(flags & TcpFlags.FIN)
        if syn and not ack:
            node.syn_count += 1
            if node.state == FlowState.INIT:
                node.state = FlowState.SYN_SENT
                node.syn_ns = p.timestamp_ns
        elif syn and ack:
            node.synack_count += 1
            if node.state == FlowState.SYN_SENT:
                node.state = FlowState.SYN_ACK
                node.synack_ns = p.timestamp_ns
        elif fin:
            if node.state in (FlowState.ESTABLISHED, FlowState.SYN_ACK,
                              FlowState.INIT):
                node.state = FlowState.FIN_1
            elif node.state == FlowState.FIN_1:
                node.state = FlowState.CLOSED
                node.close_type = "fin"
        elif ack:
            if node.state == FlowState.SYN_ACK:
                node.state = FlowState.ESTABLISHED
                if node.syn_ns and node.synack_ns:
                    node.rtt_us = max(
                        0, (p.timestamp_ns - node.syn_ns) // 1000)
            elif node.state == FlowState.INIT:
                # mid-stream pickup (agent started after the handshake):
                # promote so the flow gets the ESTABLISHED idle timeout
                node.state = FlowState.ESTABLISHED

    # -- L7 -------------------------------------------------------------------

    def _l7_update(self, node: FlowNode, p: MetaPacket, is_tx: bool) -> None:
        records: list[L7ParseResult] = []
        if not node.l7_inferred:
            ep = (node.ip_dst, node.port_dst, node.protocol)
            fails = self._infer_fails.get(ep, 0)
            if fails >= self.INFER_ENDPOINT_FAILS:
                # endpoint is known-unparseable: skip the parser sweep,
                # but re-probe periodically so a service that changes
                # protocol on the same port is eventually re-detected
                self._infer_fails[ep] = fails + 1
                if (fails - self.INFER_ENDPOINT_FAILS) \
                        % self.INFER_RETRY_EVERY:
                    node.l7_inferred = True  # give up (stays unknown)
                    return
            proto, records = infer_and_parse(p.payload, node.port_dst)
            node.l7_infer_attempts += 1
            if proto != pb.L7_UNKNOWN:
                node.l7_protocol = proto
                node.l7_inferred = True
                self._infer_fails.pop(ep, None)
            elif node.l7_infer_attempts >= self.INFER_MAX_ATTEMPTS or \
                    node.tx.packets + node.rx.packets > 10:
                node.l7_inferred = True  # give up (stays unknown)
                if len(self._infer_fails) >= self.INFER_CACHE_CAP:
                    self._infer_fails.clear()
                self._infer_fails[ep] = \
                    self._infer_fails.get(ep, 0) + 1
            if not records:
                return
        else:
            parser = get_parser(node.l7_protocol)
            if parser is None:
                return
            try:
                records = parser.parse(p.payload, is_request=is_tx)
            except Exception:
                return
        for rec in records:
            self._session_match(node, rec, p.timestamp_ns,
                                getattr(p, "syscall_trace_id", 0),
                                getattr(p, "tid", 0))

    def _session_match(self, node: FlowNode, rec: L7ParseResult,
                       ts_ns: int, trace_id: int = 0,
                       tid: int = 0) -> None:
        if rec.msg_type == MSG_REQUEST:
            node.l7_request += 1
            if rec.session_less:
                # fire-and-forget message: complete record, no response due
                self._emit_l7(node, rec, None, ts_ns, ts_ns,
                              req_trace=trace_id, req_tid=tid)
                return
            pending = PendingRequest(ts_ns, rec, trace_id, tid)
            if len(node.pending) >= self.MAX_PENDING:
                old = node.pending.popleft()
                node.pending_by_id.pop(old.record.request_id, None)
                self._emit_l7(node, old.record, None, old.timestamp_ns, 0,
                              req_trace=old.syscall_trace_id,
                              req_tid=old.tid)
            node.pending.append(pending)
            if rec.request_id:
                node.pending_by_id[rec.request_id] = pending
        else:
            node.l7_response += 1
            match = None
            if rec.request_id and rec.request_id in node.pending_by_id:
                match = node.pending_by_id.pop(rec.request_id)
                try:
                    node.pending.remove(match)
                except ValueError:
                    pass
            elif node.pending:
                match = node.pending.popleft()
                node.pending_by_id.pop(match.record.request_id, None)
            if match is not None:
                art_us = max(0, (ts_ns - match.timestamp_ns) // 1000)
                node.art_sum_us += art_us
                node.art_count += 1
                self._emit_l7(node, match.record, rec, match.timestamp_ns,
                              ts_ns, req_trace=match.syscall_trace_id,
                              req_tid=match.tid, resp_trace=trace_id,
                              resp_tid=tid)
            else:
                self._emit_l7(node, None, rec, ts_ns, ts_ns,
                              resp_trace=trace_id, resp_tid=tid)

    def _emit_l7(self, node: FlowNode, req: L7ParseResult | None,
                 resp: L7ParseResult | None, start_ns: int,
                 end_ns: int, req_trace: int = 0, req_tid: int = 0,
                 resp_trace: int = 0, resp_tid: int = 0) -> None:
        self.stats["l7_records"] += 1
        self.on_l7_log(L7Record(
            flow=node, request=req, response=resp,
            start_ns=start_ns, end_ns=end_ns or start_ns,
            syscall_trace_id_request=req_trace,
            syscall_trace_id_response=resp_trace,
            syscall_thread_0=req_tid, syscall_thread_1=resp_tid))

    # -- flush / close ---------------------------------------------------------

    def tick(self, now_ns: int | None = None) -> None:
        """Expire idle/closed flows; call periodically (1s)."""
        now = now_ns if now_ns is not None else time.time_ns()
        to_close = []
        for key, node in self.flows.items():
            if node.state in (FlowState.CLOSED, FlowState.RST):
                to_close.append(key)
                continue
            timeout = self.FLOW_TIMEOUT_NS.get(node.state, 60_000_000_000)
            if now - node.end_ns > timeout:
                node.close_type = "timeout"
                to_close.append(key)
        for key in to_close:
            self._close(self.flows.pop(key))
        # bound stale heap entries left behind by tick/flush closures
        if len(self._evict_heap) > 4 * len(self.flows) + 1024:
            self._evict_heap = [
                (n.end_ns or n.start_ns, i, k)
                for i, (k, n) in enumerate(self.flows.items())]
            heapq.heapify(self._evict_heap)
            self._heap_seq = len(self._evict_heap)
        # live flow updates for metering
        for node in self.flows.values():
            self.on_flow_update(node, False)

    def flush_all(self) -> None:
        for key in list(self.flows):
            node = self.flows.pop(key)
            if node.close_type == "unknown":
                node.close_type = "forced"
            self._close(node)

    def _close(self, node: FlowNode) -> None:
        self.stats["flows_closed"] += 1
        # flush unanswered requests
        while node.pending:
            old = node.pending.popleft()
            self._emit_l7(node, old.record, None, old.timestamp_ns, 0,
                          req_trace=old.syscall_trace_id, req_tid=old.tid)
        node.pending_by_id.clear()
        self.on_flow_update(node, True)
        self.on_l4_log(node)
