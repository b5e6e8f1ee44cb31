"""The smoke's flows phase: the port's flow/L7 agent on the card's host.

    python3 chip_phases.py flows        # alone, after the device phase

Run by ``chip_smoke.flows_phase``. Four parts, each printing its numbers:

(a) corpus: the 29 golden captures (tests/fixtures/pcaps) through the
    port's dispatcher on ``engine="python"`` and ``engine="native"``, each
    against its pinned ``.result``;
(b) packet path: the JAX package's bench shape (bench.py:86-140): a
    flow is the handshake, 94 segments of which every tenth carries 512
    bytes, and the FIN pair (99 frames), to 64 server endpoints; FLOWS
    flows. Through the native map on one core (its bare rate, the
    reference's 650k packets/s claim), the Python map on a twentieth of
    the packets, and then through the dispatcher (native map, L7 parsing,
    collector, wire conversion) with HTTP/1.1 in the payload slots (a
    request, then its response), whose L4 logs, L7 logs and documents
    (c) ships. The flows come in groups of four, the tiers of one
    service: the j-th request of each flow of a group carries the same
    W3C ``traceparent`` trace id and a span id of its own, and the
    group's frames interleave so that each tier's request lies inside
    the tier before it (a chain of four spans a trace, 25,000 traces).
    Packets/s, flows closed and L7 records print beside the host's CPU
    model;
(c) ingest and query: (b)'s frames as the agent frames them, over TCP
    into the port's server process: rows/s per table and the ingest lag,
    beside the protobuf decode's; every flow batch must take the native
    decode (``pure_batches`` 0), and the frames decoded in this process
    both ways, native and pure, must give equal rows. Then
    FLOW_QUERIES over POST /v1/query, each held to the in-process
    engine's answer over the same frames and to the 1,000 ms gate; then
    Tempo: ``/api/traces/<id>`` of a sampled trace holds its four spans
    in their chain, and ``/api/search`` and ``/v1/trace/Search`` find
    it;
(c') rollups and PromQL: ROLLUP_KEYS_A_PORT of (b)'s metric documents
    a server port and family, each sent again every ROLLUP_EVERY_S
    seconds over ROLLUP_HOURS hours of 1 s buckets ending ROLLUP_AGO_S
    ago, into a second server process, whose RollupJob rolls them: the
    1m tier must fold a minute's rows of a key into one and the 1h tier
    an hour's; a DF-SQL query over two hours must pick the 1m tier
    (EXPLAIN's datasource) and
    equal the same query kept on the 1 s table; two PromQL range
    queries (a rate by server port and a topk of it) must equal a
    DF-SQL recount of the same rows;
(d) live: checked up front, explicitly, whether AF_PACKET opens (and
    whether a TPACKET_V3 ring maps on lo); where it does not, the line
    ``flows live: not run (<errno>)`` and nothing else. Else the node
    agent (python -m deepflow_tpu_torch.agent --flow --interface lo)
    beside a stdlib HTTP server taking LIVE_REQUESTS requests (one in a
    hundred answered 500): l7_flow_log must hold exactly those requests
    with method, path, status and a response time, no flow may touch the
    agent's own sender port, and drops the socket counted fail the check.
    Then the runner phase's training child, LIVE_STEPS steps, without and
    with the node agent capturing lo (the child's frames to the server
    cross lo): the flow-capture cost % on the median step and on the
    mean, and the Guard's readings of the node agent.
"""

from __future__ import annotations

import errno
import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import chip_smoke as cs

FIXTURE_DIR = os.path.join(cs.ROOT, "tests", "fixtures", "pcaps")
FLOWS = 12_000            # 1,188,000 packets (20,000 before the smoke
                          # gained its readtier phase)
ENDPOINTS = 64
DATA_SEGMENTS = 94
PAYLOAD_BYTES = 512
PAYLOAD_EVERY = 10
PY_SHARE = 20             # the Python map's packets: a twentieth
T0 = 1_700_000_000_000_000_000
ERROR_EVERY = 100         # one response in a hundred is a 500
LIVE_REQUESTS = 2_000
LIVE_CONNECTIONS = 10
LIVE_STEPS = 40           # each training child: the smoke's time limit caps it
NODE_AGENT_ID = 100       # the node agent's frames, apart from the child's
                          # (the training part's node agent: 101)
AGENT_START_S = 60.0
LIVE_TRACE = "1ive" + "0" * 12  # the live requests' trace ids' first half
TIERS = 4                 # flows of a group: the tiers of one service
SESSIONS = DATA_SEGMENTS // PAYLOAD_EVERY // 2 + 1  # requests a flow
ROLLUP_HOURS = 3          # the re-stamped documents' span
ROLLUP_AGO_S = 1800       # ... ending this long before the phase runs
ROLLUP_KEYS_A_PORT = 2    # the re-stamped keys of a family, a server port
ROLLUP_EVERY_S = 10       # each key's document this often over the span
ROLLUP_WAIT_S = 90.0      # the rollup job rolls every 15 s, the trace
                          # trees flush a trace idle for 4 s
# the server's pure-protobuf flow decode before the native one, on the
# card's host (NVIDIA H100 80GB HBM3, 700.00 W; Intel family 6 model 207;
# PERF.md): rows/s a table from the first byte sent, and each decoder's
# rows over its own handle time
PROTOBUF_ROWS_PER_S = {"l4_flow_log": 3129, "l7_flow_log": 9990,
                       "network_1s": 2562, "application_1s": 2411}
PROTOBUF_DECODE_ROWS_PER_S = {"l4_log": 5394, "l7_log": 10117,
                              "metrics": 8240}
# the three dashboard queries over the flow tables: (db, DF-SQL)
FLOW_QUERIES = {
    "top_talkers": (
        "flow_log",
        "SELECT ip_src, ip_dst, Sum(byte_tx) AS bytes FROM l4_flow_log "
        "GROUP BY ip_src, ip_dst ORDER BY bytes DESC, ip_src, ip_dst "
        "LIMIT 10"),
    "l7_red": (
        "flow_log",
        "SELECT ip_dst, port_dst, endpoint, Count() AS requests, "
        "Sum(CASE WHEN response_status IN ('client_error', "
        "'server_error', 'timeout') THEN 1 ELSE 0 END) AS errors, "
        "Percentile(response_duration, 90) AS rrt_p90 FROM l7_flow_log "
        "GROUP BY ip_dst, port_dst, endpoint "
        "ORDER BY requests DESC, ip_dst, port_dst, endpoint LIMIT 20"),
    "flows_per_port": (
        "flow_metrics",
        "SELECT server_port, Sum(new_flow) AS flows, "
        "Sum(closed_flow) AS closed FROM network GROUP BY server_port "
        "ORDER BY flows DESC, server_port LIMIT 20"),
}
FLOW_TABLES = ("flow_log.l4_flow_log", "flow_log.l7_flow_log",
               "flow_metrics.network.1s", "flow_metrics.application.1s")


# -- traffic -------------------------------------------------------------

_TRACEPARENT = b"traceparent: 00-"
_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def trace_id(group: int, session: int) -> str:
    """The W3C trace id of the session-th request of a group's flows."""
    return f"{group + 1:024x}{session:08x}"


def span_id(group: int, session: int, tier: int) -> str:
    """The span id the tier's request of that trace carries."""
    return f"{group + 1:08x}{session:04x}{tier:04x}"


def _hex(v: np.ndarray, width: int) -> np.ndarray:
    """(len(v), width) ASCII lowercase hex digits of uint64 values."""
    shifts = (4 * np.arange(width - 1, -1, -1)).astype(np.uint64)
    return _HEX[((v.astype(np.uint64)[:, None] >> shifts)
                 & np.uint64(15)).astype(np.intp)]


def _http_payloads() -> tuple[bytes, bytes, bytes]:
    """A request (to tier 0's endpoint, with a traceparent of zeros), a
    200 and a 500, each padded to PAYLOAD_BYTES."""
    def pad(head: bytes, tail: bytes) -> bytes:
        fill = PAYLOAD_BYTES - len(head) - len(tail) - len(b"X-Pad: \r\n")
        return head + b"X-Pad: " + b"p" * fill + b"\r\n" + tail
    req = pad(b"GET /api/v1/tier0?page=3 HTTP/1.1\r\nHost: svc.local\r\n"
              + _TRACEPARENT + b"0" * 32 + b"-" + b"0" * 16 + b"-01\r\n",
              b"\r\n")
    ok = pad(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n", b"\r\n")
    err = pad(b"HTTP/1.1 500 ER\r\nContent-Length: 0\r\n", b"\r\n")
    return req, ok, err


def _template(http: bool) -> list[tuple[bytes, bool]]:
    """One flow's frames, (frame, client to server), with the addresses
    and ports of flow 0: the bench shape, its payload slots either 512
    bytes of x or HTTP (a request in one slot, its response in the next,
    from the server)."""
    from deepflow_tpu_torch.agent.packet import TcpFlags as F
    from deepflow_tpu_torch.agent.packet import encode_tcp_frame
    c, s, cp, sp = "10.0.0.2", "10.9.9.0", 40000, 8000
    req, ok, _ = _http_payloads()
    out = [(encode_tcp_frame(c, s, cp, sp, F.SYN, seq=1), True),
           (encode_tcp_frame(s, c, sp, cp, F.SYN | F.ACK, seq=1, ack=2),
            False),
           (encode_tcp_frame(c, s, cp, sp, F.ACK, seq=2, ack=2), True)]
    cseq, sseq, slot = 2, 2, 0
    for i in range(DATA_SEGMENTS):
        if i % PAYLOAD_EVERY:
            out.append((encode_tcp_frame(c, s, cp, sp, F.ACK, seq=cseq,
                                         ack=sseq), True))
        elif not http:
            out.append((encode_tcp_frame(c, s, cp, sp, F.ACK | F.PSH,
                                         payload=b"x" * PAYLOAD_BYTES,
                                         seq=cseq), True))
            cseq += PAYLOAD_BYTES
        elif slot % 2 == 0:
            out.append((encode_tcp_frame(c, s, cp, sp, F.ACK | F.PSH,
                                         payload=req, seq=cseq, ack=sseq),
                        True))
            cseq += len(req)
            slot += 1
        else:
            out.append((encode_tcp_frame(s, c, sp, cp, F.ACK | F.PSH,
                                         payload=ok, seq=sseq, ack=cseq),
                        False))
            sseq += len(ok)
            slot += 1
    out.append((encode_tcp_frame(c, s, cp, sp, F.FIN | F.ACK, seq=cseq),
                True))
    out.append((encode_tcp_frame(s, c, sp, cp, F.FIN | F.ACK, seq=sseq,
                                 ack=cseq + 1), False))
    return out


def bench_frames(n_flows: int, net: int, http: bool = False) -> tuple:
    """(packed frames, n + 1 offsets, capture times, frame count) of
    ``n_flows`` flows of the bench shape, flow after flow: client
    ``net.(i >> 8).(i & 255).2`` port 40000 + i % 20000 to server
    ``net.9.9.(i % 64)`` port 8000 + i % 64, times 1 ns apart. One flow
    is encoded, and every flow's addresses and ports are written into
    copies of it; with ``http``, one response in ERROR_EVERY is a 500,
    each request carries its trace (``trace_id``, ``span_id``: flow i is
    tier i % TIERS of group i // TIERS) and its tier's endpoint, and the
    frames of each group interleave (``_nest``)."""
    tmpl = _template(http)
    lens = np.array([len(f) for f, _ in tmpl])
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    row = np.frombuffer(b"".join(f for f, _ in tmpl), dtype=np.uint8)
    arr = np.tile(row, (n_flows, 1))
    i = np.arange(n_flows)
    cip = np.stack([np.full(n_flows, net), (i >> 8) & 255, i & 255,
                    np.full(n_flows, 2)], 1).astype(np.uint8)
    sip = np.stack([np.full(n_flows, net), np.full(n_flows, 9),
                    np.full(n_flows, 9), i % ENDPOINTS], 1).astype(np.uint8)
    cport = (40000 + i % 20000).astype(">u2").view(np.uint8).reshape(-1, 2)
    sport = (8000 + i % ENDPOINTS).astype(">u2").view(np.uint8).reshape(
        -1, 2)
    for (_, c2s), o in zip(tmpl, starts):
        src, dst = (cip, sip) if c2s else (sip, cip)
        psrc, pdst = (cport, sport) if c2s else (sport, cport)
        arr[:, o + 26:o + 30] = src
        arr[:, o + 30:o + 34] = dst
        arr[:, o + 34:o + 36] = psrc
        arr[:, o + 36:o + 38] = pdst
    order = None
    if http:
        req, ok, err = _http_payloads()
        code_at = ok.index(b"200")
        tier_at = req.index(b"tier0") + 4
        trace_at = req.index(_TRACEPARENT) + len(_TRACEPARENT)
        group, tier = i // TIERS, i % TIERS
        session = 0
        for (f, c2s), o in zip(tmpl, starts):
            if not c2s and f.endswith(ok):
                at = o + len(f) - len(ok) + code_at
                arr[::ERROR_EVERY, at:at + 3] = np.frombuffer(b"500",
                                                              np.uint8)
                arr[::ERROR_EVERY, at + 4:at + 6] = np.frombuffer(
                    err[code_at + 4:code_at + 6], np.uint8)
            elif c2s and f.endswith(req):
                at = o + len(f) - len(req)
                arr[:, at + tier_at] = _HEX[tier]
                t = at + trace_at
                arr[:, t:t + 8] = ord("0")
                arr[:, t + 8:t + 24] = _hex(group + 1, 16)
                arr[:, t + 24:t + 32] = _hex(np.full(n_flows, session), 8)
                arr[:, t + 33:t + 41] = _hex(group + 1, 8)
                arr[:, t + 41:t + 45] = _hex(np.full(n_flows, session), 4)
                arr[:, t + 45:t + 49] = _hex(tier, 4)
                session += 1
        if n_flows % TIERS == 0:
            arr, order = _nest(arr, tmpl, lens, starts)
    n = n_flows * len(tmpl)
    offsets = np.zeros(n + 1, dtype=np.uint32)
    frame_lens = lens if order is None else lens[order % len(tmpl)]
    np.cumsum(np.tile(frame_lens, n_flows // (1 if order is None
                                             else TIERS)),
              out=offsets[1:])
    return (arr.tobytes(), offsets, np.arange(T0, T0 + n, dtype=np.uint64),
            n)


def _nest(arr: np.ndarray, tmpl: list, lens: np.ndarray,
          starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each group's TIERS flows interleaved frame by frame, every flow's
    own frames in their order: a request slot goes tier 0 first, its
    response slot tier TIERS - 1 first, so each tier's request and
    response lie inside the tier before it, as a service calls the next
    while it serves. Returns the bytes in the new order, one group a
    row, and the order as flow-in-group * len(tmpl) + frame."""
    m = len(tmpl)
    _, ok, _ = _http_payloads()
    resp = [not c2s and f.endswith(ok) for f, c2s in tmpl]
    order = []
    for t in range(m):
        tiers = range(TIERS - 1, -1, -1) if resp[t] else range(TIERS)
        order += [k * m + t for k in tiers]
    order = np.asarray(order)
    row = arr.shape[1]
    idx = np.concatenate([np.arange(k * row + starts[t],
                                    k * row + starts[t] + lens[t])
                          for k, t in (divmod(o, m) for o in order)])
    return arr.reshape(-1, TIERS * row)[:, idx], order


# -- the explicit capture check ---------------------------------------------

def capture_support(interface: str = "lo") -> dict:
    """Whether socket(AF_PACKET, SOCK_RAW) opens and binds to the
    interface, and whether a TPACKET_V3 ring maps on it: "ok" or the
    errno's name for each (the ring's only when the socket opens)."""
    out = {"af_packet": "ok", "ring": "not tried"}
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                          socket.htons(3))
    except AttributeError:
        return {"af_packet": "no AF_PACKET", "ring": "not tried"}
    except OSError as e:
        return {"af_packet": errno.errorcode.get(e.errno, str(e.errno)),
                "ring": "not tried"}
    with s:
        try:
            s.bind((interface, 0))
        except OSError as e:
            out["af_packet"] = errno.errorcode.get(e.errno, str(e.errno))
            return out
    from deepflow_tpu_torch.agent.native_flow import NativeRing
    try:
        NativeRing(interface).close()
        out["ring"] = "ok"
    except OSError as e:
        out["ring"] = errno.errorcode.get(e.errno, str(e.errno))
    return out


# -- (a) corpus ----------------------------------------------------------

def corpus_part() -> dict:
    """Every golden capture on both engines against its .result."""
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.codec import MessageType
    from deepflow_tpu_torch.proto import wire
    names = sorted(fn[:-5] for fn in os.listdir(FIXTURE_DIR)
                   if fn.endswith(".pcap"))
    cs.check(len(names) == 29, f"29 golden captures ({len(names)})")
    t0 = time.perf_counter()
    for engine in ("python", "native"):
        for name in names:
            rows = []

            class Collector:
                def send(self, mt, payload):
                    if mt == MessageType.L7_LOG:
                        rows.extend(wire.FlowLogBatch.FromString(payload).l7)
                    return True
            Dispatcher(sender=Collector(), engine=engine).replay_pcap(
                os.path.join(FIXTURE_DIR, f"{name}.pcap"))
            with open(os.path.join(FIXTURE_DIR, f"{name}.result")) as f:
                want = json.load(f)
            _check_golden(f"{name} ({engine})", rows, want)
    nums = {"captures": len(names), "engines": 2,
            "ms": (time.perf_counter() - t0) * 1000.0}
    cs.phase("flows corpus", **nums)
    return nums


def _check_golden(what: str, rows: list, want: dict) -> None:
    """The pinned expectations of tests/test_golden_corpus.py."""
    cs.check(len(rows) == want["records"],
             f"{what}: {want['records']} L7 records ({len(rows)})")
    if not rows:
        return
    if "request_types" in want:
        cs.check(sorted(r.request_type for r in rows)
                 == sorted(want["request_types"]), f"{what}: request types")
    row = rows[0]
    cs.check(row.l7_protocol == want["l7_protocol"], f"{what}: protocol")
    for field in ("request_type", "request_domain", "request_resource",
                  "endpoint", "request_id", "response_result", "version"):
        if field in want:
            cs.check(str(getattr(row, field)) == str(want[field]),
                     f"{what}: {field}")
    for field in ("response_code", "response_status"):
        if field in want:
            cs.check(getattr(row, field) == want[field], f"{what}: {field}")


# -- (b) packet path --------------------------------------------------------

class _Frames:
    """The sender's place in the dispatcher: every frame it ships."""

    def __init__(self) -> None:
        self.frames: list[tuple[int, bytes]] = []

    def send(self, msg_type, payload: bytes) -> bool:
        self.frames.append((int(msg_type), payload))
        return True


def packet_part() -> tuple[dict, list]:
    """The bench shape through the bare native map, the Python map and
    the dispatcher; the dispatcher's frames go to (c)."""
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.agent.flow_map import FlowMap
    from deepflow_tpu_torch.agent.native_flow import NativeFlowMap
    from deepflow_tpu_torch.agent.packet import decode_ethernet
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {min(cores)})  # one core
    try:
        nfm = NativeFlowMap()
        warm = bench_frames(100, net=9)
        nfm.inject_batch(*warm[:3])
        data, offsets, ts, n = bench_frames(FLOWS, net=10)
        t0 = time.perf_counter()
        nfm.inject_batch(data, offsets, ts)
        native_s = time.perf_counter() - t0
        nfm.flush_all()
        nst = nfm.stats
        cs.check(nst["packets"] == n + warm[3], "the native map took every "
                 f"packet ({nst['packets']})")
        cs.check(nst["flows_closed"] == FLOWS + 100,
                 f"every flow closed ({nst['flows_closed']})")
        m = n // PY_SHARE
        frames = [(data[offsets[i]:offsets[i + 1]], int(ts[i]))
                  for i in range(m)]
        fm = FlowMap()
        t0 = time.perf_counter()
        for frame, t in frames:
            fm.inject(decode_ethernet(frame, timestamp_ns=t))
        python_s = time.perf_counter() - t0
        del frames, data
        # the agent's whole path, HTTP in the payload slots
        hdata, hoffsets, hts, hn = bench_frames(FLOWS, net=11, http=True)
        sink = _Frames()
        disp = Dispatcher(sender=sink)
        t0 = time.perf_counter()
        with disp._lock:
            disp.native_map.inject_batch(hdata, hoffsets, hts)
        disp.flush(now_ns=int(hts[-1]) + 1)
        disp.flush(force=True)
        dispatch_s = time.perf_counter() - t0
        dst = disp.stats
    finally:
        os.sched_setaffinity(0, cores)
    sessions = DATA_SEGMENTS // PAYLOAD_EVERY // 2 + 1
    cs.check(dst["flows_closed"] == FLOWS, "the dispatcher closed every "
             f"flow ({dst['flows_closed']})")
    cs.check(dst["l7_records"] == FLOWS * sessions,
             f"{sessions} HTTP sessions a flow ({dst['l7_records']})")
    nums = {"cpu": json.dumps(cs._cpu_model()), "flows": FLOWS,
            "packets": n, "endpoints": ENDPOINTS,
            "native_packets_per_s": n / native_s, "native_s": native_s,
            "native_flows_closed": nst["flows_closed"] - 100,
            "native_l7_records": nst["l7_records"],
            "python_packets": m, "python_packets_per_s": m / python_s,
            "dispatcher_packets": hn,
            "dispatcher_packets_per_s": hn / dispatch_s,
            "dispatcher_flows_closed": dst["flows_closed"],
            "dispatcher_l7_records": dst["l7_records"],
            "frames_shipped": len(sink.frames)}
    cs.phase("flows packets", **nums)
    return nums, sink.frames


# -- (c) ingest and query ---------------------------------------------------

def _local_tables(frames: list, pure: bool = False):
    """The same frames through the port's decoders in this process: the
    native path, or with ``pure`` each decoder's pure ``wire`` path.
    Returns (db, rows/s of each decoder over its own handle time)."""
    import queue

    from deepflow_tpu_torch.codec import FrameHeader, MessageType
    from deepflow_tpu_torch.server.decoders import (
        FlowLogDecoder, MetricsDecoder)
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.store.db import Database
    db, platform = Database(), PlatformInfoTable()
    decoders = {mt: cls(queue.Queue(), db, platform, msg_type=mt)
                for cls, mt in ((FlowLogDecoder, MessageType.L4_LOG),
                                (FlowLogDecoder, MessageType.L7_LOG),
                                (MetricsDecoder, MessageType.METRICS))}
    spent = dict.fromkeys(decoders, 0.0)
    rows = dict.fromkeys(decoders, 0)
    for mt, payload in frames:
        dec = decoders[mt]
        t0 = time.perf_counter()
        rows[mt] += (dec.handle_pure if pure else dec.handle)(
            FrameHeader(MessageType(mt)), payload)
        spent[mt] += time.perf_counter() - t0
    if not pure:
        cs.check(all(d.stats["pure_batches"] == 0
                     for d in decoders.values()),
                 "every flow batch decoded natively in process")
    rate = {f"{MessageType(mt).name.lower()}": rows[mt] / spent[mt]
            for mt in decoders if spent[mt]}
    return db, rate


def _same_tables(a, b) -> bool:
    """Two stores' flow tables hold the same rows, strings decoded."""
    for t in FLOW_TABLES:
        ta, tb = a.table(t), b.table(t)
        names = list(ta.columns)
        ca, cb = ta.column_concat(names), tb.column_concat(names)
        for c in names:
            if c in ta.dicts:
                if ta.dicts[c].decode_many(ca[c]) != \
                        tb.dicts[c].decode_many(cb[c]):
                    return False
            elif not np.array_equal(ca[c], cb[c]):
                return False
    return True


def local_answer(db, name: str) -> dict:
    """FLOW_QUERIES[name] by the in-process engine."""
    from deepflow_tpu_torch.query import engine
    from deepflow_tpu_torch.query.catalog import _resolve
    db_name, sql = FLOW_QUERIES[name]
    table = sql.split(" FROM ", 1)[1].split()[0]
    full, _ = _resolve(f"{db_name}.{table}" if "." not in table else table)
    return engine.execute(db.table(full), sql).to_dict()


def ingest_part(srv, frames: list) -> dict:
    """(b)'s frames, seq'd as the sender frames them, over one TCP
    connection into the server process; rows/s per table, the ingest
    lag, and the three queries against the in-process answers."""
    from deepflow_tpu_torch.codec import FrameHeader, MessageType, \
        encode_frame
    data = [encode_frame(FrameHeader(MessageType(mt), agent_id=1,
                                     seq=i + 1), payload)
            for i, (mt, payload) in enumerate(frames)]
    db, native_rate = _local_tables(frames)
    pure_db, pure_rate = _local_tables(frames, pure=True)
    cs.check(_same_tables(db, pure_db),
             "the native and the pure decode give equal rows")
    del pure_db
    want = {t: len(db.table(t)) for t in FLOW_TABLES}
    cs.check(all(want.values()), f"every flow table has rows ({want})")
    t0 = time.perf_counter()
    sent = {}

    def ship() -> None:
        with socket.create_connection(("127.0.0.1", srv.ingest_port),
                                      timeout=60) as conn:
            for fr in data:
                conn.sendall(fr)
        sent["s"] = time.perf_counter() - t0
    sender = threading.Thread(target=ship, name="flows-ship", daemon=True)
    sender.start()
    seen: dict[str, float] = {}
    while len(seen) < len(FLOW_TABLES):
        _, health, _ = cs._http(srv.query_port, "/v1/health")
        for t in FLOW_TABLES:
            if t not in seen and health["tables"].get(t, 0) >= want[t]:
                seen[t] = time.perf_counter() - t0
        cs.check(time.perf_counter() - t0 < cs.SERVER_INGEST_S,
                 f"the server took every flow row ({health['tables']})")
        time.sleep(0.05)
    sender.join(60)
    cs.check("s" in sent, "every frame was sent")
    health = cs._ingest_settled(srv.query_port)
    tables = health["tables"]
    cs.check(all(tables[t] == want[t] for t in FLOW_TABLES),
             f"the server's rows equal the in-process decode ({tables})")
    dec = health["stats"]["decoders"]
    cs.check(all(dec[k]["errors"] == 0 and dec[k]["dups"] == 0
                 for k in ("L4_LOG", "L7_LOG", "METRICS")),
             "no decode error or dup")
    cs.check(all(dec[k]["pure_batches"] == 0 and dec[k]["native_batches"]
                 for k in ("L4_LOG", "L7_LOG", "METRICS")),
             "the server decoded every flow batch natively ("
             + ", ".join(f"{k} {dec[k]['native_batches']} native "
                         f"{dec[k]['pure_batches']} pure"
                         for k in ("L4_LOG", "L7_LOG", "METRICS")) + ")")
    # each decoder's rows over its own time in handle() (decode + append;
    # the three decoders share the server's interpreter lock)
    decode = {f"{k.lower()}_decode_rows_per_s":
              dec[k]["rows"] / (dec[k]["handle_ns"] / 1e9)
              for k in ("L4_LOG", "L7_LOG", "METRICS")}
    nums = {f"{t.split('.', 1)[1].replace('.', '_')}_rows": want[t]
            for t in FLOW_TABLES}
    for t in FLOW_TABLES:
        key = t.split(".", 1)[1].replace(".", "_")
        nums[f"{key}_rows_per_s"] = want[t] / seen[t]
    last = max(seen.values())
    nums.update(decode)
    nums.update({f"inprocess_native_{k}_rows_per_s": v
                 for k, v in native_rate.items()})
    nums.update({f"inprocess_pure_{k}_rows_per_s": v
                 for k, v in pure_rate.items()})
    # beside them, not measured in this run: the protobuf path's record
    nums.update({f"recorded_protobuf_{k}_rows_per_s": v
                 for k, v in PROTOBUF_ROWS_PER_S.items()})
    nums.update({f"recorded_protobuf_{k}_decode_rows_per_s": v
                 for k, v in PROTOBUF_DECODE_ROWS_PER_S.items()})
    nums["ingest_s"] = last
    nums["frames"] = len(data)
    nums["send_s"] = sent["s"]
    nums["ingest_lag_s"] = max(0.0, last - sent["s"])
    for name, (db_name, sql) in FLOW_QUERIES.items():
        code, ans, ms = cs._http(srv.query_port, "/v1/query",
                                 {"db": db_name, "sql": sql})
        cs.check(code == 200, f"{name} answers 200 ({ans})")
        cs.check(ans["result"] == local_answer(db, name),
                 f"{name} equals the in-process answer")
        cs.check(ans["result"]["values"], f"{name} has rows")
        cs.check(ms < cs.QUERY_LIMIT_MS,
                 f"{name} answers in {ms:.1f} ms < {cs.QUERY_LIMIT_MS}")
        nums[f"{name}_ms"] = ms
    cs.phase("flows ingest", **nums)
    return nums


def tempo_part(srv) -> dict:
    """The sampled trace (the last group's last request, the newest)
    through Tempo's trace and search routes and the trace-tree search;
    each answer under the 1,000 ms gate."""
    import urllib.parse
    group, session = FLOWS // TIERS - 1, SESSIONS - 1
    tid = trace_id(group, session)
    nums: dict = {"traces": FLOWS // TIERS * SESSIONS, "trace_id": tid}
    nums["settle_s"] = _background_settled(
        srv.query_port, lambda st: st["trace_trees"]["traces_flushed"]
        >= nums["traces"] and st["rollup"]["rollups"] >= 1)
    code, ans, ms = cs._http(srv.query_port, f"/api/traces/{tid}")
    cs.check(code == 200, f"/api/traces answers 200 ({ans})")
    spans = ans["batches"][0]["spans"]
    cs.check([s["spanID"] for s in spans]
             == [span_id(group, session, k) for k in range(TIERS)]
             and [s["operationName"] for s in spans]
             == [f"GET /api/v1/tier{k}" for k in range(TIERS)]
             and [s["parentSpanID"] for s in spans]
             == [""] + [s["spanID"] for s in spans[:-1]],
             f"the trace's {TIERS} spans chain tier to tier ({spans})")
    nums["trace_ms"] = ms
    start_ns = int(spans[0]["startTimeUnixNano"])
    q = urllib.parse.urlencode({
        "tags": 'endpoint="/api/v1/tier0"', "limit": 20,
        "start": start_ns // 10**9 - 1, "end": start_ns // 10**9 + 2})
    code, ans, ms = cs._http(srv.query_port, f"/api/search?{q}")
    cs.check(code == 200 and ans["traces"]
             and ans["traces"][0]["traceID"] == tid,
             f"/api/search finds the trace first ({ans.get('traces')[:2]})")
    nums.update(search_ms=ms,
                search_inspected=ans["metrics"]["inspectedTraces"])
    cs.check(nums["search_inspected"] == nums["traces"],
             f"the search saw every trace ({nums['search_inspected']})")
    code, ans, ms = cs._http(srv.query_port, "/v1/trace/Search", {
        "from_ns": start_ns, "to_ns": start_ns + 1, "service_path": []})
    hits = ans["result"]["traces"]
    cs.check(code == 200 and [h["trace_id"] for h in hits] == [tid]
             and hits[0]["span_count"] == TIERS,
             f"/v1/trace/Search finds the trace's tree ({hits})")
    nums["tree_search_ms"] = ms
    code, ans, ms = cs._http(srv.query_port, "/v1/trace/Tracing",
                             {"trace_id": tid})
    cs.check(code == 200 and ans["result"]["span_count"] == TIERS,
             f"/v1/trace/Tracing assembles the trace ({ans})")
    nums["tracing_ms"] = ms
    slow = {k: v for k, v in nums.items()
            if k.endswith("_ms") and v >= cs.QUERY_LIMIT_MS}
    cs.check(not slow, f"every Tempo answer under {cs.QUERY_LIMIT_MS} ms "
                       f"({slow})")
    cs.phase("flows tempo", **nums)
    return nums


def _background_settled(qport: int, done) -> float:
    """Seconds until ``done(/v1/health's stats)`` holds: the server's
    background work on the ingested rows (the trace trees' flush, a
    rollup) has ended, so the timed answers do not share its core."""
    t0 = time.perf_counter()
    while True:
        _, health, _ = cs._http(qport, "/v1/health")
        if done(health["stats"]):
            return time.perf_counter() - t0
        cs.check(time.perf_counter() - t0 < ROLLUP_WAIT_S,
                 f"the server's background work ended ("
                 f"{health['stats']['rollup']}, "
                 f"{health['stats']['trace_trees']})")
        time.sleep(0.5)


def _restamped(frames: list) -> tuple[list, int, int, dict]:
    """(b)'s metric documents as a node reports its live keys: of each
    family ROLLUP_KEYS_A_PORT documents a server port, each sent again
    every ROLLUP_EVERY_S seconds over ROLLUP_HOURS hours of 1 s buckets
    ending ROLLUP_AGO_S ago (on the hour), so a minute holds several rows
    of every key for the 1m tier to fold. (DocumentBatch bytes, a batch
    a minute; first second; last second + 1; rows a family.)"""
    from deepflow_tpu_torch.codec import MessageType
    from deepflow_tpu_torch.proto import wire
    docs = [d for mt, p in frames if mt == MessageType.METRICS
            for d in wire.DocumentBatch.FromString(p).docs]
    end = (int(time.time()) - ROLLUP_AGO_S) // 3600 * 3600
    span = ROLLUP_HOURS * 3600
    keys: list[bytes] = []  # each key's document without its time
    rows = {}
    for fam, name in ((False, "network"), (True, "application")):
        per_port: dict[int, int] = {}
        for d in docs:
            if d.HasField("app_meter") != fam or \
                    per_port.get(d.tag.port, 0) >= ROLLUP_KEYS_A_PORT:
                continue
            per_port[d.tag.port] = per_port.get(d.tag.port, 0) + 1
            d.timestamp_s = 0  # field 1, written before the rest below
            keys.append(d.SerializeToString())
        rows[name] = sum(per_port.values()) * span // ROLLUP_EVERY_S
    stamps = [wire.uint_field("timestamp_s", 1, t)
              for t in range(end - span, end)]
    # DocumentBatch.docs is field 1, length-delimited, as span_entry's
    entries = [wire.span_entry(stamps[i] + body) for i in range(span)
               for body in keys[-i % ROLLUP_EVERY_S::ROLLUP_EVERY_S]]
    per = len(entries) // (span // 60)  # a batch a minute
    batches = [b"".join(entries[i:i + per])
               for i in range(0, len(entries), per)]
    return batches, end - span, end, rows


def rollup_part(frames: list) -> dict:
    """(b)'s documents, re-stamped, into a second server process; its
    rollup job rolls them; a two-hour DF-SQL query picks the 1m tier
    and equals the 1 s answer; PromQL equals a DF-SQL recount."""
    from deepflow_tpu_torch.codec import FrameHeader, MessageType, \
        encode_frame
    payloads, lo_s, hi_s, rows = _restamped(frames)
    srv = cs._ServerProcess(os.path.join(cs.OUT_DIR,
                                         "flows_rollup_server.log"))
    nums: dict = {"hours": ROLLUP_HOURS, "first_s": lo_s, "end_s": hi_s}
    try:
        with socket.create_connection(("127.0.0.1", srv.ingest_port),
                                      timeout=60) as conn:
            for p in payloads:  # no seq: no ack is left unread at close
                conn.sendall(encode_frame(FrameHeader(
                    MessageType.METRICS, agent_id=2), p))
        health = cs._ingest_settled(srv.query_port)
        dec = health["stats"]["decoders"]["METRICS"]
        cs.check(dec["pure_batches"] == 0 and dec["errors"] == 0,
                 f"the documents decoded natively ({dec})")
        nums["docs_1s"] = {t: health["tables"][t] for t in FLOW_TABLES[2:]}
        cs.check(nums["docs_1s"] == {f"flow_metrics.{f}.1s": n
                                     for f, n in rows.items()},
                 f"every re-stamped document landed ({nums['docs_1s']} "
                 f"of {rows})")
        nums["rolled_s"] = _background_settled(
            srv.query_port, lambda st: st["rollup"]["rollups"] >= 1 and all(
                st["rollup"]["horizons"][f"flow_metrics.{f}.{tier}"] >= hi_s
                for f in ("network", "application") for tier in ("1m", "1h")))
        _, health, _ = cs._http(srv.query_port, "/v1/health")
        nums["rollup"] = health["stats"]["rollup"]
        nums["tier_rows"] = tiers = {
            t: n for t, n in health["tables"].items()
            if t.startswith("flow_metrics.")}
        # a minute holds 60 / ROLLUP_EVERY_S rows of a key, an hour 60
        # minutes: a rollup that copied rows would keep their count
        fold = 60 // ROLLUP_EVERY_S
        cs.check(all(0 < tiers[f"flow_metrics.{f}.1m"] * fold
                     <= tiers[f"flow_metrics.{f}.1s"]
                     and 0 < tiers[f"flow_metrics.{f}.1h"] * 60
                     <= tiers[f"flow_metrics.{f}.1m"]
                     for f in ("network", "application")),
                 f"the 1m tier folds {fold} rows of a key, the 1h tier 60 "
                 f"({tiers})")
        # two hours, minute-aligned and not hour-aligned: the 1m tier
        lo, hi = lo_s + 420, lo_s + 420 + 7200
        sql = ("SELECT server_port, Sum(byte_tx) AS b, Sum(new_flow) AS f,"
               " Sum(packet_tx) AS p FROM network WHERE time >= {lo} AND "
               "time {op} {hi} GROUP BY server_port ORDER BY server_port")
        code, tier, ms = cs._http(srv.query_port, "/v1/query", {
            "db": "flow_metrics", "sql": sql.format(lo=lo, op="<", hi=hi)})
        cs.check(code == 200 and tier["debug"].get("datasource", {})
                 .get("tier") == "1m",
                 f"the two-hour query answers from 1m ({tier.get('debug')})")
        nums["rollup_query_ms"] = ms
        code, ex, ms = cs._http(srv.query_port, "/v1/query", {
            "db": "flow_metrics",
            "sql": "EXPLAIN " + sql.format(lo=lo, op="<", hi=hi)})
        cs.check("flow_metrics.network.1m" in str(
            ex["explain"]["plan"].get("datasource")),
            f"EXPLAIN names the 1m datasource ({ex['explain']['plan']})")
        nums["explain_ms"] = ms
        # "<= hi - 1": the same rows, a bound no tier takes: the 1 s table
        code, raw, ms = cs._http(srv.query_port, "/v1/query", {
            "db": "flow_metrics",
            "sql": sql.format(lo=lo, op="<=", hi=hi - 1)})
        cs.check(code == 200 and "datasource" not in raw["debug"]
                 and raw["result"]["values"]
                 and raw["result"] == tier["result"],
                 "the 1m answer equals the 1 s table's")
        nums["raw_query_ms"] = ms
        nums.update(_promql_checks(srv.query_port, lo_s + 3600))
    finally:
        srv.stop()
    slow = {k: v for k, v in nums.items()
            if k.endswith("_ms") and v >= cs.QUERY_LIMIT_MS}
    cs.check(not slow, f"every rollup and PromQL answer under "
                       f"{cs.QUERY_LIMIT_MS} ms ({slow})")
    cs.phase("flows rollup promql", **nums)
    return nums


def _promql_checks(qport: int, hour: int) -> dict:
    """A rate by server port and its topk 3 over twelve steps of five
    minutes from ``hour``: each step's window (t - 60, t] is one minute
    bucket, so a DF-SQL recount of the bucket's requests / 60 is the
    rate. Values within a relative 1e-9."""
    import math
    import urllib.parse
    step, n_steps = 300, 12
    start = hour + 59
    end = start + step * (n_steps - 1)
    code, ans, _ = cs._http(qport, "/v1/query", {
        "db": "flow_metrics",
        "sql": "SELECT time(time, 60) AS m, server_port, Sum(request) AS r "
               f"FROM application WHERE time >= {hour} AND time < "
               f"{end + 1} GROUP BY time(time, 60), server_port"})
    cs.check(code == 200, f"the recount answers ({ans})")
    want: dict[int, dict[str, float]] = {}
    for m, port, r in ans["result"]["values"]:
        if (m - hour) % step == 0:
            want.setdefault(m + 59, {})[str(port)] = r / 60.0
    cs.check(len(want) == n_steps, f"requests in every step ({len(want)})")
    nums = {}

    def close(a: float, b: float) -> bool:
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)
    rate = "sum by (server_port) (rate(flow_metrics_application_request[1m]))"
    for name, q in (("rate", rate), ("topk", f"topk(3, {rate})")):
        qs = urllib.parse.urlencode({"query": q, "start": start, "end": end,
                                     "step": step})
        code, out, ms = cs._http(qport, f"/api/v1/query_range?{qs}")
        cs.check(code == 200 and out["status"] == "success",
                 f"PromQL {name} answers ({out})")
        got: dict[int, dict[str, float]] = {}
        for series in out["data"]["result"]:
            port = series["metric"]["server_port"]
            for t, v in series["values"]:
                got.setdefault(int(t), {})[port] = float(v)
        if name == "rate":
            ok = set(got) == set(want) and all(
                set(got[t]) == set(want[t]) and all(
                    close(got[t][p], want[t][p]) for p in want[t])
                for t in want)
        else:  # ties may pick other ports: the values and each port's
            ok = set(got) == set(want) and all(
                len(got[t]) == 3 and all(
                    close(v, want[t][p]) for p, v in got[t].items())
                and all(close(a, b) for a, b in zip(
                    sorted(got[t].values()),
                    sorted(want[t].values())[-3:]))
                for t in want)
        cs.check(ok, f"PromQL {name} equals the DF-SQL recount")
        nums[f"promql_{name}_ms"] = ms
        nums[f"promql_{name}_series"] = len(out["data"]["result"])
    return nums


# -- (d) live ---------------------------------------------------------------

class _Handler(http.server.BaseHTTPRequestHandler):
    """GET /item?id=N: 200, or 500 for every ERROR_EVERY-th id; the
    whole response in one write (one segment)."""

    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802 (http.server's name)
        n = int(self.path.rsplit("=", 1)[1])
        code, reason = (500, "Internal Server Error") \
            if n % ERROR_EVERY == 0 else (200, "OK")
        body = b"ok"
        self.wfile.write(f"HTTP/1.1 {code} {reason}\r\nContent-Length: "
                         f"{len(body)}\r\n\r\n".encode() + body)

    def log_message(self, *args) -> None:
        pass


def _requests(port: int) -> list[tuple[str, str, int]]:
    """LIVE_REQUESTS keep-alive GETs over LIVE_CONNECTIONS connections:
    (method, path, status) of each as the client saw it."""
    import http.client
    done: list[tuple[str, str, int]] = []
    per = LIVE_REQUESTS // LIVE_CONNECTIONS
    for c in range(LIVE_CONNECTIONS):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for k in range(per):
            path = f"/item?id={c * per + k}"
            conn.request("GET", path, headers={
                "traceparent": f"00-{LIVE_TRACE}{c * per + k:016x}-"
                               f"{c * per + k + 1:016x}-01"})
            resp = conn.getresponse()
            resp.read()
            done.append(("GET", path, resp.status))
        conn.close()
    return done


class _NodeAgent:
    """python -m deepflow_tpu_torch.agent --flow --interface lo, its
    output in ``results/<name>.log``; running once it logs its capture."""

    def __init__(self, ingest_port: int, name: str, agent_id: int) -> None:
        self.log_path = os.path.join(cs.OUT_DIR, f"{name}.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deepflow_tpu_torch.agent", "--server",
             f"127.0.0.1:{ingest_port}", "--flow", "--interface", "lo",
             "--agent-id", str(agent_id)],
            cwd=cs.ROOT, stdout=self._log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        while True:
            with open(self.log_path) as f:
                text = f.read()
            if "live capture (" in text:
                break
            cs.check(self.proc.poll() is None,
                     f"the node agent runs (see {self.log_path})")
            cs.check(time.perf_counter() - t0 < AGENT_START_S,
                     "the node agent started its capture")
            time.sleep(0.1)
        self.start_s = time.perf_counter() - t0

    def stop(self) -> str:
        """SIGTERM: the agent closes its flows, ships them and exits 0."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        with open(self.log_path) as f:
            text = f.read()
        cs.check(self.proc.returncode == 0,
                 f"node agent exit code {self.proc.returncode} "
                 f"(see {self.log_path})")
        cs.check("Traceback" not in text,
                 f"the node agent raised nothing (see {self.log_path})")
        return text


def _query(qport: int, db: str, sql: str) -> list:
    code, ans, _ = cs._http(qport, "/v1/query", {"db": db, "sql": sql})
    cs.check(code == 200, f"{sql!r} answers 200 ({ans})")
    return ans["result"]["values"]


def _selfstats(qport: int, metric: str, agent_id: int) -> dict:
    """A node agent's largest value of each of a metric's values."""
    rows = _query(qport, "deepflow_system",
                  "SELECT value_name, Max(value) AS v FROM deepflow_system "
                  f"WHERE metric_name = '{metric}' AND agent_id = "
                  f"{agent_id} GROUP BY value_name")
    return {name: v for name, v in rows}


def live_part(srv, support: dict) -> dict:
    """The node agent on lo: the HTTP requests land exactly, then the
    training child without and with it."""
    nums: dict = {"af_packet": support["af_packet"],
                  "ring": support["ring"]}
    qport = srv.query_port
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    hport = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    agent = _NodeAgent(srv.ingest_port, "flows_node_agent", NODE_AGENT_ID)
    try:
        nums["agent_start_s"] = agent.start_s
        t0 = time.perf_counter()
        sent = _requests(hport)
        nums["requests_s"] = time.perf_counter() - t0
        time.sleep(1.5)   # a dispatcher tick closes the finished flows
    finally:
        httpd.shutdown()
        httpd.server_close()
        log_text = agent.stop()
    cs._ingest_settled(qport)
    nums["capture_mode"] = "ring" if "(ring," in log_text else "socket"
    cap = _selfstats(qport, "agent.live_capture", NODE_AGENT_ID)
    nums.update({f"capture_{k}": v for k, v in cap.items()})
    got = _query(qport, "flow_log",
                 "SELECT request_type, request_resource, response_code, "
                 "response_status, response_duration, trace_id "
                 "FROM l7_flow_log "
                 f"WHERE agent_id = {NODE_AGENT_ID} AND port_dst = {hport}")
    want = sorted(sent)
    rows = sorted((r[0], r[1], r[2]) for r in got)
    errors = sum(1 for _, _, code in sent if code == 500)
    nums.update(requests=len(sent), l7_rows=len(got), server_errors=errors,
                drops=cap.get("drops", 0.0))
    cs.phase("flows live http", **nums)
    cs.check(cap.get("drops", 0.0) == 0,
             f"the socket counted no drop ({cap.get('drops')})")
    cs.check(rows == want, f"l7_flow_log holds exactly the {len(sent)} "
             f"requests ({len(got)} rows)")
    cs.check(all(r[3] == ("server_error" if r[2] == 500 else "ok")
                 and r[4] > 0 for r in got),
             "every row has its status and a response time")
    cs.check(sorted(r[5] for r in got) == sorted(
        f"{LIVE_TRACE}{int(p.rsplit('=', 1)[1]):016x}" for _, p, _ in sent),
        "every live request's row carries its traceparent's trace id")
    cs.check(errors == LIVE_REQUESTS // ERROR_EVERY, f"{errors} 500s")
    # the node agent's own flows ((c)'s rows are another agent's)
    touched = _query(qport, "flow_log",
                     "SELECT Count() AS n FROM l4_flow_log WHERE "
                     f"agent_id = {NODE_AGENT_ID} AND (port_src = "
                     f"{srv.ingest_port} OR port_dst = {srv.ingest_port})")
    cs.check(touched in ([], [[0]]),
             f"no flow touches the agent's sender port ({touched})")
    seen = _query(qport, "flow_log",
                  "SELECT Count() AS n FROM l4_flow_log WHERE "
                  f"agent_id = {NODE_AGENT_ID} AND port_dst = {hport}")
    cs.check(seen == [[LIVE_CONNECTIONS]],
             f"the node agent logged the {LIVE_CONNECTIONS} connections "
             f"({seen})")
    # the training child without and with the node agent capturing lo
    child = [*cs.RUNNER, "--server", f"127.0.0.1:{srv.ingest_port}",
             "--service", "llama-train", "-m", cs.EXAMPLE, *cs.EXAMPLE_ARGS,
             "--steps", str(LIVE_STEPS)]
    plain = cs._train_child(child, "flows_child_no_capture")
    agent = _NodeAgent(srv.ingest_port, "flows_node_agent_training",
                       NODE_AGENT_ID + 1)
    try:
        captured = cs._train_child(child, "flows_child_capture")
        # the Guard reads CPU between two checks (every 10 s): a short
        # child may end before its second one has shipped
        t0 = time.perf_counter()
        while _selfstats(qport, "agent.guard", NODE_AGENT_ID + 1).get(
                "checks", 0) < 2 and time.perf_counter() - t0 < 30:
            time.sleep(0.5)
    finally:
        agent.stop()
    cs._ingest_settled(qport)
    guard = _selfstats(qport, "agent.guard", NODE_AGENT_ID + 1)
    cap = _selfstats(qport, "agent.live_capture", NODE_AGENT_ID + 1)
    cost = {"capture_cost_pct_median": 100.0 * (
                captured["step_ms_median"] / plain["step_ms_median"] - 1),
            "capture_cost_pct_mean": 100.0 * (
                captured["step_ms_mean"] / plain["step_ms_mean"] - 1),
            "step_ms_median_plain": plain["step_ms_median"],
            "step_ms_median_capture": captured["step_ms_median"],
            "step_ms_mean_plain": plain["step_ms_mean"],
            "step_ms_mean_capture": captured["step_ms_mean"],
            "guard_cpu_pct_max": guard.get("cpu_pct", 0.0),
            "guard_threads_cpu_pct_max": guard.get("threads_cpu_pct", 0.0),
            "guard_proc_cpu_pct_max": guard.get("proc_cpu_pct", 0.0),
            "guard_rss_mb_max": guard.get("proc_rss_mb", 0.0),
            "guard_degrades": guard.get("degrades", 0.0),
            "guard_checks": guard.get("checks", 0.0),
            "capture_frames_max": cap.get("frames", 0.0),
            "capture_excluded_max": cap.get("excluded", 0.0)}
    nums.update(cost)
    cs.phase("flows live training", steps=LIVE_STEPS, **cost)
    cs.check(guard.get("checks", 0) >= 2,
             "the node agent's guard checked twice")
    return nums


def flows_phase(nums: dict) -> None:
    """(a) to (d); the numbers land in ``nums`` as each part ends."""
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    support = capture_support("lo")   # explicitly, before anything runs
    nums["capture_support"] = support
    cs.phase("flows capture", **support)
    nums["corpus"] = corpus_part()
    nums["packets"], frames = packet_part()
    srv = cs._ServerProcess(os.path.join(cs.OUT_DIR, "flows_server.log"))
    try:
        nums["ingest"] = ingest_part(srv, frames)
        nums["tempo"] = tempo_part(srv)
        nums["rollup"] = rollup_part(frames)
        del frames
        if support["af_packet"] != "ok":
            print(f"flows live: not run ({support['af_packet']})",
                  flush=True)
            nums["live"] = {"not_run": support["af_packet"]}
        else:
            nums["live"] = live_part(srv, support)
    finally:
        srv.stop()
    nums["seconds"] = time.perf_counter() - t0
    cs.phase("flows", seconds=nums["seconds"])
