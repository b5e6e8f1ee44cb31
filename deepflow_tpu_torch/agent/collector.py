"""Collector: flows + L7 records -> per-second metric Documents.

Own copy of ``deepflow_tpu/agent/collector.py``: ``QuadrupleGenerator``
builds one ``FlowMeter`` and one ``AppMeter`` document per key and
interval. Reference analog: agent/src/collector/quadruple_generator.rs
(1s/1m stash) and collector.rs (Document assembly). Aggregation keys mirror the
reference's quadruple: (ip_src, ip_dst, server_port, protocol) for network
meters, plus l7_protocol for application meters.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from deepflow_tpu_torch.proto import wire as pb


@dataclass
class _NetStash:
    packet_tx: int = 0
    packet_rx: int = 0
    byte_tx: int = 0
    byte_rx: int = 0
    flow_count: int = 0
    new_flow: int = 0
    closed_flow: int = 0
    rtt_sum_us: int = 0
    rtt_count: int = 0
    retrans: int = 0
    syn: int = 0
    synack: int = 0
    # deltas need previous counters per live flow
    seen_flows: dict = field(default_factory=dict)


@dataclass
class _AppStash:
    request: int = 0
    response: int = 0
    rrt_sum_us: int = 0
    rrt_count: int = 0
    rrt_max_us: int = 0
    error_client: int = 0
    error_server: int = 0
    timeout: int = 0


class QuadrupleGenerator:
    def __init__(self, emit, interval_s: int = 1) -> None:
        """emit(list[pb.Document]) is called at each flush boundary."""
        self.emit = emit
        self.interval_s = interval_s
        self._net: dict[tuple, _NetStash] = {}
        self._app: dict[tuple, _AppStash] = {}
        self._last_flush_s = 0

    # -- feed -----------------------------------------------------------------

    def add_flow(self, node, closed: bool) -> None:
        key = (node.ip_src, node.ip_dst, node.port_dst, node.protocol)
        st = self._net.setdefault(key, _NetStash())
        prev = st.seen_flows.get(node.flow_id)
        if prev is None:
            st.new_flow += 1
            prev = (0, 0, 0, 0, 0, 0, 0)
        ptx, prx, btx, brx, rt, sy, sa = prev
        st.packet_tx += node.tx.packets - ptx
        st.packet_rx += node.rx.packets - prx
        st.byte_tx += node.tx.bytes - btx
        st.byte_rx += node.rx.bytes - brx
        st.retrans += (node.tx.retrans + node.rx.retrans) - rt
        st.syn += node.syn_count - sy
        st.synack += node.synack_count - sa
        if closed:
            st.closed_flow += 1
            st.seen_flows.pop(node.flow_id, None)
            if node.rtt_us:
                st.rtt_sum_us += node.rtt_us
                st.rtt_count += 1
        else:
            st.seen_flows[node.flow_id] = (
                node.tx.packets, node.rx.packets, node.tx.bytes,
                node.rx.bytes, node.tx.retrans + node.rx.retrans,
                node.syn_count, node.synack_count)
        st.flow_count = max(st.flow_count, len(st.seen_flows) + st.closed_flow)

    def add_l7(self, record) -> None:
        node = record.flow
        key = (node.ip_src, node.ip_dst, node.port_dst, node.l7_protocol)
        st = self._app.setdefault(key, _AppStash())
        if record.request is not None:
            st.request += 1
        if record.response is not None:
            st.response += 1
            status = record.response.response_status
            if status == 2:
                st.error_client += 1
            elif status == 3:
                st.error_server += 1
            elif status == 4:
                st.timeout += 1
        if record.request is not None and record.response is not None:
            rrt = max(0, (record.end_ns - record.start_ns) // 1000)
            st.rrt_sum_us += rrt
            st.rrt_count += 1
            st.rrt_max_us = max(st.rrt_max_us, rrt)
        elif record.request is not None and record.response is None \
                and not record.request.session_less:
            st.timeout += 1  # fire-and-forget messages are not timeouts

    # -- flush ----------------------------------------------------------------

    def flush(self, now_s: int | None = None) -> list:
        now = now_s if now_s is not None else int(time.time())
        docs = []
        for (ip_src, ip_dst, port, proto), st in self._net.items():
            if not (st.packet_tx or st.packet_rx or st.new_flow
                    or st.closed_flow):
                continue
            d = pb.Document()
            d.timestamp_s = now
            d.interval_s = self.interval_s
            d.tag.ip_src = ip_src
            d.tag.ip_dst = ip_dst
            d.tag.port = port
            d.tag.proto = proto
            m = d.flow_meter
            m.packet_tx = st.packet_tx
            m.packet_rx = st.packet_rx
            m.byte_tx = st.byte_tx
            m.byte_rx = st.byte_rx
            m.flow_count = st.flow_count
            m.new_flow = st.new_flow
            m.closed_flow = st.closed_flow
            m.rtt_sum_us = st.rtt_sum_us
            m.rtt_count = st.rtt_count
            m.retrans = st.retrans
            m.syn_count = st.syn
            m.synack_count = st.synack
            docs.append(d)
        for (ip_src, ip_dst, port, l7), st in self._app.items():
            if not (st.request or st.response):
                continue
            d = pb.Document()
            d.timestamp_s = now
            d.interval_s = self.interval_s
            d.tag.ip_src = ip_src
            d.tag.ip_dst = ip_dst
            d.tag.port = port
            d.tag.l7_protocol = l7
            m = d.app_meter
            m.request = st.request
            m.response = st.response
            m.rrt_sum_us = st.rrt_sum_us
            m.rrt_count = st.rrt_count
            m.rrt_max_us = st.rrt_max_us
            m.error_client = st.error_client
            m.error_server = st.error_server
            m.timeout = st.timeout
            docs.append(d)
        # carry live-flow baselines into the next window
        kept: dict[tuple, _NetStash] = {}
        for key, st in self._net.items():
            if st.seen_flows:
                ns = _NetStash()
                ns.seen_flows = st.seen_flows
                kept[key] = ns
        self._net = kept
        self._app = {}
        if docs:
            self.emit(docs)
        return docs
