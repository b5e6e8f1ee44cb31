"""Native flow pipeline wrapper: batch packet ingest through the C++ flow
map, with Python touched only at the L7 boundary and at flow close.

Own copy of ``deepflow_tpu/agent/native_flow.py``: ``NativeFlowMap``, with
the ``FlowMap`` callback contract and the lazy Python nodes of the flows
that carry payload, and ``NativeRing``, the TPACKET_V3 ring reader, over
the port's ``native/flowmap.cpp``. Constructing either builds and loads the
port's native library, or raises. This module loads no torch.

Reference analog: agent/src/flow_generator/flow_map.rs:716 +
agent/src/dispatcher/recv_engine/mod.rs:40. The split of labor:

- C++ (flowmap.cpp): decode, flow table, TCP FSM, RTT, retrans, eviction,
  close records — per-packet cost with zero Python objects.
- Python (this file): L7 protocol inference/parsing for the payload segments
  the native side surfaces, session matching, and conversion of closed-flow
  records into the same FlowNode callbacks the pure-Python FlowMap uses —
  so collectors/senders don't know which engine ran.
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np

from deepflow_tpu_torch import native
from deepflow_tpu_torch.agent.flow_map import DirectionStats, FlowMap, FlowNode, \
    FlowState
from deepflow_tpu_torch.agent.packet import decode_ethernet
from deepflow_tpu_torch.agent.protocol_logs.base import get_parser
from deepflow_tpu_torch.proto import wire as pb

_CLOSE_TYPES = {0: "unknown", 1: "fin", 2: "rst", 3: "timeout", 4: "forced"}

# l7 feedback modes for df_fm_set_l7
L7_INFER = 0
L7_MUTED = -1


class _PayloadShim:
    """Minimal stand-in for MetaPacket at the L7 boundary (FlowMap._l7_update
    only reads .payload and .timestamp_ns)."""

    __slots__ = ("payload", "timestamp_ns")

    def __init__(self, payload: bytes, ts_ns: int) -> None:
        self.payload = payload
        self.timestamp_ns = ts_ns


class NativeFlowMap:
    """Drop-in engine with the FlowMap callback contract, batch-fed.

    L7 state lives in an embedded pure-Python FlowMap whose nodes are
    created lazily per flow that actually carries payload — header-only
    flows never materialize a Python object until they close.
    """

    L7_BUF_CAP = 4 << 20
    L7_EV_CAP = 16384
    SLOW_CAP = 16384
    CLOSED_BATCH = 8192
    # inject chunk: 2048 full-MTU payloads (~3MB) fit the 4MB l7 buffer, so
    # payload-heavy batches can't overflow the event exchange
    CHUNK = 2048

    def __init__(self, on_l4_log=None, on_l7_log=None, on_flow_update=None,
                 agent_id: int = 0, max_flows: int = 1 << 16) -> None:
        lib = native.load()
        self._lib = lib
        self._fm = lib.df_fm_new(max_flows)
        self.on_l4_log = on_l4_log or (lambda f: None)
        self.on_l7_log = on_l7_log or (lambda r: None)
        self.on_flow_update = on_flow_update or (lambda f, closed: None)
        self.agent_id = agent_id
        self.max_flows = max_flows
        # embedded FlowMap reused for BOTH the L7 session logic (nodes keyed
        # by native flow_id) and the slow path (v6/vlan frames, keyed by
        # tuple — disjoint key spaces, one table)
        self._l7fm = FlowMap(on_l4_log=self.on_l4_log,
                             on_l7_log=self.on_l7_log,
                             on_flow_update=self.on_flow_update,
                             agent_id=agent_id, max_flows=max_flows)
        # preallocated exchange buffers
        self._l7_buf = np.zeros(self.L7_BUF_CAP, dtype=np.uint8)
        self._l7_evs = np.zeros(self.L7_EV_CAP, dtype=native.L7_EVENT_DTYPE)
        self._slow_idx = np.zeros(self.SLOW_CAP, dtype=np.uint32)
        self._slow_buf = np.zeros(1 << 20, dtype=np.uint8)
        self._slow_evs = np.zeros(4096, dtype=native.SLOW_EVENT_DTYPE)
        self._closed = np.zeros(self.CLOSED_BATCH,
                                dtype=native.FLOW_RECORD_DTYPE)
        self._n_l7 = ctypes.c_uint32(0)
        self._n_slow = ctypes.c_uint32(0)

    def __del__(self):
        try:
            if getattr(self, "_fm", None):
                self._lib.df_fm_free(self._fm)
                self._fm = None
        except Exception:
            pass

    # -- stats ---------------------------------------------------------------

    @property
    def stats(self) -> dict:
        out = np.zeros(8, dtype=np.uint64)
        self._lib.df_fm_stats(self._fm, out)
        s = {"packets": int(out[0]), "flows_created": int(out[1]),
             "flows_closed": int(out[2]), "evicted": int(out[3]),
             "l7_surfaced": int(out[4]), "l7_dropped": int(out[5]),
             "slow_path": int(out[6]), "excluded": int(out[7])}
        s["l7_records"] = self._l7fm.stats["l7_records"]
        return s

    def exclude_port(self, port: int, on: bool = True) -> None:
        self._lib.df_fm_exclude_port(self._fm, port, 1 if on else 0)

    @property
    def active_flows(self) -> int:
        return self._lib.df_fm_active_count(self._fm)

    # -- ingest --------------------------------------------------------------

    def inject_frames(self, frames: list[tuple[bytes, int]]) -> int:
        """Convenience: list of (frame, ts_ns) -> packed batch inject."""
        n = len(frames)
        offsets = np.zeros(n + 1, dtype=np.uint32)
        ts = np.zeros(n, dtype=np.uint64)
        total = 0
        for i, (f, t) in enumerate(frames):
            total += len(f)
            offsets[i + 1] = total
            ts[i] = t
        data = b"".join(f for f, _ in frames)
        return self.inject_batch(data, offsets, ts)

    def inject_batch(self, data: bytes, offsets: np.ndarray,
                     ts_ns: np.ndarray) -> int:
        """Packed frames -> native map. Returns packets handled natively."""
        n = len(offsets) - 1
        handled = 0
        for lo in range(0, n, self.CHUNK):
            hi = min(n, lo + self.CHUNK)
            off = np.ascontiguousarray(offsets[lo:hi + 1])
            handled += int(self._lib.df_fm_inject_batch(
                self._fm, data, off,
                np.ascontiguousarray(ts_ns[lo:hi]), hi - lo,
                self._l7_buf.ctypes.data_as(ctypes.c_void_p),
                self.L7_BUF_CAP,
                self._l7_evs.ctypes.data_as(ctypes.c_void_p),
                self.L7_EV_CAP, ctypes.byref(self._n_l7),
                self._slow_idx, self.SLOW_CAP,
                ctypes.byref(self._n_slow)))
            if self._n_l7.value:
                self._process_l7(self._n_l7.value)
            if self._n_slow.value:
                self._process_slow(data, offsets, ts_ns, lo,
                                   self._n_slow.value)
            self._drain_closed()
        return handled

    # -- L7 boundary ---------------------------------------------------------

    def _process_l7(self, n: int) -> None:
        # columnar extraction: one .tolist() per field beats per-record
        # numpy scalar access by ~5x at these event rates (the bench's
        # packet-path hot spot, VERDICT r04 item 8)
        evs = self._l7_evs[:n]
        flow_ids = evs["flow_id"].tolist()
        ts_l = evs["ts_ns"].tolist()
        off_l = evs["payload_off"].tolist()
        len_l = evs["payload_len"].tolist()
        istx_l = evs["is_tx"].tolist()
        ipsrc_l = evs["ip_src"].tolist()
        ipdst_l = evs["ip_dst"].tolist()
        psrc_l = evs["port_src"].tolist()
        pdst_l = evs["port_dst"].tolist()
        ttype_l = evs["tunnel_type"].tolist()
        tid_l = evs["tunnel_id"].tolist()
        buf_bytes = self._l7_buf
        flows = self._l7fm.flows
        l7_update = self._l7fm._l7_update
        for i in range(n):
            fid = flow_ids[i]
            node = flows.get(fid)
            if node is None:
                node = FlowNode(
                    flow_id=fid,
                    ip_src=ipsrc_l[i].to_bytes(4, "big"),
                    ip_dst=ipdst_l[i].to_bytes(4, "big"),
                    port_src=psrc_l[i], port_dst=pdst_l[i],
                    protocol=int(evs["protocol"][i]),
                    start_ns=ts_l[i],
                    tunnel_type=ttype_l[i], tunnel_id=tid_l[i])
                flows[fid] = node
            off = off_l[i]
            payload = buf_bytes[off:off + len_l[i]].tobytes()
            shim = _PayloadShim(payload, ts_l[i])
            before = node.l7_inferred
            # count surfaced payloads on the shadow so FlowMap's inference
            # give-up budget fires for native flows too; the close record
            # overwrites these counters with native truth
            node.tx.packets += 1
            try:
                l7_update(node, shim, bool(istx_l[i]))
            except Exception:
                pass
            if node.l7_inferred and not before:
                # verdict reached: tell native to keep surfacing (proto
                # known) or go quiet (unknown after the inference budget)
                mode = (int(node.l7_protocol)
                        if node.l7_protocol != pb.L7_UNKNOWN
                        and get_parser(node.l7_protocol) is not None
                        else L7_MUTED)
                self._lib.df_fm_set_l7(
                    self._fm, ipsrc_l[i], ipdst_l[i],
                    psrc_l[i], pdst_l[i], int(evs["protocol"][i]),
                    ttype_l[i], tid_l[i], mode)

    # -- slow path (v6 / vlan-exotic frames) ----------------------------------

    def _process_slow(self, data: bytes, offsets: np.ndarray,
                      ts_ns: np.ndarray, lo: int, n: int) -> None:
        for i in self._slow_idx[:n]:
            gi = lo + int(i)
            frame = data[int(offsets[gi]):int(offsets[gi + 1])]
            mp = decode_ethernet(frame, timestamp_ns=int(ts_ns[gi]))
            if mp is not None:
                self._l7fm.inject(mp)

    # -- close / tick ---------------------------------------------------------

    def _record_to_node(self, r) -> FlowNode:
        fid = int(r["flow_id"])
        node = self._l7fm.flows.pop(fid, None)
        if node is None:
            node = FlowNode(
                flow_id=fid,
                ip_src=int(r["ip_src"]).to_bytes(4, "big"),
                ip_dst=int(r["ip_dst"]).to_bytes(4, "big"),
                port_src=int(r["port_src"]), port_dst=int(r["port_dst"]),
                protocol=int(r["protocol"]), start_ns=int(r["start_ns"]),
                tunnel_type=int(r["tunnel_type"]),
                tunnel_id=int(r["tunnel_id"]))
        else:
            # flush unanswered requests through the session logic
            while node.pending:
                old = node.pending.popleft()
                self._l7fm._emit_l7(node, old.record, None,
                                    old.timestamp_ns, 0)
            node.pending_by_id.clear()
        node.start_ns = int(r["start_ns"])
        node.tunnel_type = int(r["tunnel_type"])
        node.tunnel_id = int(r["tunnel_id"])
        node.end_ns = int(r["end_ns"])
        node.state = FlowState(int(r["state"]))
        node.close_type = _CLOSE_TYPES.get(int(r["close_type"]), "unknown")
        node.tx = DirectionStats(
            packets=int(r["tx_packets"]), bytes=int(r["tx_bytes"]),
            tcp_flags_bits=int(r["tx_flags_bits"]),
            retrans=int(r["tx_retrans"]),
            zero_window=int(r["tx_zero_window"]))
        node.rx = DirectionStats(
            packets=int(r["rx_packets"]), bytes=int(r["rx_bytes"]),
            tcp_flags_bits=int(r["rx_flags_bits"]),
            retrans=int(r["rx_retrans"]),
            zero_window=int(r["rx_zero_window"]))
        node.syn_count = int(r["syn_count"])
        node.synack_count = int(r["synack_count"])
        node.rtt_us = int(r["rtt_us"])
        return node

    def _drain_closed(self) -> None:
        lib = self._lib
        while True:
            n = lib.df_fm_poll_closed(
                self._fm, self._closed.ctypes.data_as(ctypes.c_void_p),
                self.CLOSED_BATCH)
            if n == 0:
                return
            for r in self._closed[:n]:
                node = self._record_to_node(r)
                self.on_flow_update(node, True)
                self.on_l4_log(node)

    def tick(self, now_ns: int | None = None) -> None:
        now = now_ns if now_ns is not None else time.time_ns()
        self._lib.df_fm_tick(self._fm, now)
        self._drain_closed()
        # active-flow metering snapshot (cumulative counters; the collector
        # diffs against its seen_flows cache)
        active = self.active_flows
        buf = self._closed
        if active > self.CLOSED_BATCH:
            buf = np.zeros(active + 64, dtype=native.FLOW_RECORD_DTYPE)
        n = self._lib.df_fm_export_active(
            self._fm, buf.ctypes.data_as(ctypes.c_void_p), len(buf))
        for r in buf[:n]:
            fid = int(r["flow_id"])
            shadow = self._l7fm.flows.get(fid)
            node = self._active_node(r, shadow)
            self.on_flow_update(node, False)
        # slow-path flows tick through the embedded map (flow_id-keyed L7
        # shadow nodes created inline by _process_l7 are excluded: ints
        # never time out — the native map owns their lifecycle)
        self._tick_slow_path(now)

    def _active_node(self, r, shadow) -> FlowNode:
        """Metering view of an active flow (no shadow mutation)."""
        node = FlowNode(
            flow_id=int(r["flow_id"]),
            ip_src=int(r["ip_src"]).to_bytes(4, "big"),
            ip_dst=int(r["ip_dst"]).to_bytes(4, "big"),
            port_src=int(r["port_src"]), port_dst=int(r["port_dst"]),
            protocol=int(r["protocol"]), start_ns=int(r["start_ns"]),
            tunnel_type=int(r["tunnel_type"]),
            tunnel_id=int(r["tunnel_id"]))
        node.end_ns = int(r["end_ns"])
        node.tx = DirectionStats(
            packets=int(r["tx_packets"]), bytes=int(r["tx_bytes"]),
            retrans=int(r["tx_retrans"]),
            zero_window=int(r["tx_zero_window"]))
        node.rx = DirectionStats(
            packets=int(r["rx_packets"]), bytes=int(r["rx_bytes"]),
            retrans=int(r["rx_retrans"]),
            zero_window=int(r["rx_zero_window"]))
        node.syn_count = int(r["syn_count"])
        node.synack_count = int(r["synack_count"])
        node.rtt_us = int(r["rtt_us"])
        if shadow is not None:
            node.l7_protocol = shadow.l7_protocol
            node.l7_request = shadow.l7_request
            node.l7_response = shadow.l7_response
            node.art_sum_us = shadow.art_sum_us
            node.art_count = shadow.art_count
        return node

    def _tick_slow_path(self, now_ns: int) -> None:
        """Tick only tuple-keyed (slow-path) flows in the embedded map."""
        tuple_keys = [k for k in self._l7fm.flows if isinstance(k, tuple)]
        if not tuple_keys:
            return
        # temporarily restrict the embedded map's view
        shadows = {k: v for k, v in self._l7fm.flows.items()
                   if not isinstance(k, tuple)}
        for k in shadows:
            del self._l7fm.flows[k]
        try:
            self._l7fm.tick(now_ns)
        finally:
            self._l7fm.flows.update(shadows)

    def flush_all(self) -> None:
        self._lib.df_fm_flush_all(self._fm)
        self._drain_closed()
        # remaining shadows correspond to flows already closed natively
        # (drained above); anything left is slow-path — flush it
        self._l7fm.flush_all()

    # -- TPACKET_V3 ring ------------------------------------------------------

    def ring_rx(self, ring: "NativeRing", timeout_ms: int = 100,
                max_blocks: int = 0) -> int:
        """Consume ready ring blocks straight into the native map; only L7
        payload copies, slow-path frame copies (v6/vlan), and close records
        cross into Python.

        NOT thread-safe against tick()/flush_all()/inject_batch() on the
        same map — callers sharing the map across threads must serialize
        (the Dispatcher lock does this for the agent)."""
        consumed = int(self._lib.df_ring_rx_batch(
            ring._h, self._fm, timeout_ms,
            self._l7_buf.ctypes.data_as(ctypes.c_void_p), self.L7_BUF_CAP,
            self._l7_evs.ctypes.data_as(ctypes.c_void_p), self.L7_EV_CAP,
            ctypes.byref(self._n_l7), max_blocks,
            1 if ring.skip_outgoing else 0,
            self._slow_buf.ctypes.data_as(ctypes.c_void_p),
            len(self._slow_buf),
            self._slow_evs.ctypes.data_as(ctypes.c_void_p),
            len(self._slow_evs), ctypes.byref(self._n_slow)))
        if self._n_l7.value:
            self._process_l7(self._n_l7.value)
        for ev in self._slow_evs[:self._n_slow.value]:
            off, ln = int(ev["off"]), int(ev["len"])
            mp = decode_ethernet(self._slow_buf[off:off + ln].tobytes(),
                                 timestamp_ns=int(ev["ts_ns"]))
            if mp is not None:
                self._l7fm.inject(mp)
        self._drain_closed()
        return consumed


class NativeRing:
    """TPACKET_V3 mmap RX ring (reference: recv_engine af_packet)."""

    def __init__(self, interface: str = "", block_size: int = 1 << 20,
                 block_nr: int = 64) -> None:
        lib = native.load()
        self._lib = lib
        err = ctypes.c_int32(0)
        self._h = lib.df_ring_open(interface.encode(), block_size, block_nr,
                                   ctypes.byref(err))
        if not self._h:
            raise OSError(err.value, os.strerror(err.value),
                          f"ring open on {interface or 'all'!r}")
        # lo delivers every frame twice (in + out copies)
        self.skip_outgoing = interface == "lo"

    def drops(self) -> int:
        return int(self._lib.df_ring_drops(self._h))

    def promisc(self, interface: str, on: bool = True) -> bool:
        """Promiscuous mode (mirror/SPAN ports see other hosts' frames)."""
        return self._lib.df_ring_promisc(
            self._h, interface.encode(), 1 if on else 0) == 0

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.df_ring_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
