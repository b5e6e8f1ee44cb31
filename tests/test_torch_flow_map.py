"""The port's flow path (``agent/flow_map.py``, ``agent/native_flow.py``
over ``native/flowmap.cpp``, ``agent/collector.py``,
``agent/dispatcher.py``) held against the JAX package's on seeded
synthetic traffic (``flow_traffic.py``): handshakes, data, pipelined L7
sessions, retransmissions, zero windows, RST and FIN closes, timeouts
driven by ``tick``, eviction at ``max_flows`` and unparseable flows that
exhaust the inference budget. Each engine gives the reference's L4 logs,
L7 records and metric documents byte for byte, and the port's two
engines give the same rows. No engine falls back: a native library that
does not build or load raises."""

import os

import pytest

import flow_traffic as ft
from deepflow_tpu.agent import dispatcher as ref_dispatcher
from deepflow_tpu.agent import flow_map as ref_flow_map
from deepflow_tpu.agent import native_flow as ref_native_flow
from deepflow_tpu.agent import packet as ref_packet
from deepflow_tpu.proto import pb
from deepflow_tpu_torch import native
from deepflow_tpu_torch.agent import (
    dispatcher, flow_map, native_flow, packet)
from deepflow_tpu_torch.agent.collector import QuadrupleGenerator
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire

SEEDS = range(3)
# ticks past the ESTABLISHED idle timeout (300 s) close what stays open
LATE_NS = 400 * 1_000_000_000


class _Sink:
    """The sender's place: every frame the dispatcher hands it."""

    def __init__(self) -> None:
        self.frames: list[tuple[int, bytes]] = []

    def send(self, msg_type, payload: bytes) -> bool:
        self.frames.append((int(msg_type), payload))
        return True


def _drive(side: str, engine: str, frames: list) -> list:
    """Every frame of one dispatcher over the traffic: a flush at each
    second of capture time, one past the idle timeout, then the forced
    flush, whose documents carry the wall clock's second (zeroed here)."""
    sink = _Sink()
    if side == "port":
        disp = dispatcher.Dispatcher(sender=sink, engine=engine)
    else:
        disp = ref_dispatcher.Dispatcher(sender=sink, engine=engine)
    for chunk, end in ft.windows(frames):
        if side == "port":
            disp.inject_frames(chunk)
        elif engine == "native":
            with disp._lock:
                disp.native_map.inject_frames(chunk)
        else:
            for frame, ts in chunk:
                mp = ref_packet.decode_ethernet(frame, timestamp_ns=ts)
                if mp is not None:
                    disp.inject(mp)
        disp.flush(now_ns=end)
    disp.flush(now_ns=frames[-1][1] + LATE_NS)
    n = len(sink.frames)
    disp.flush(force=True)
    out = sink.frames[:n]
    for mt, payload in sink.frames[n:]:
        if mt == MessageType.METRICS:
            batch = wire.DocumentBatch.FromString(payload)
            for d in batch.docs:
                d.timestamp_s = 0
            payload = batch.SerializeToString()
        out.append((mt, payload))
    return out


def _rows(frames: list) -> dict:
    """The L4 and L7 rows and the metric documents of a frame list,
    sorted, as bytes."""
    out = {"l4": [], "l7": [], "docs": []}
    for mt, payload in frames:
        if mt in (MessageType.L4_LOG, MessageType.L7_LOG):
            b = wire.FlowLogBatch.FromString(payload)
            out["l4"] += [m.SerializeToString() for m in b.l4]
            out["l7"] += [m.SerializeToString() for m in b.l7]
        else:
            out["docs"] += [d.SerializeToString() for d in
                            wire.DocumentBatch.FromString(payload).docs]
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("seed", SEEDS)
def test_dispatcher_frames_equal_reference(seed, engine):
    frames = ft.synthetic(seed)
    got = _drive("port", engine, frames)
    want = _drive("ref", engine, frames)
    assert [mt for mt, _ in got] == [mt for mt, _ in want]
    for (mt, a), (_, b) in zip(got, want):
        assert a == b, MessageType(mt).name
    kinds = {mt for mt, _ in got}
    assert kinds == {MessageType.L4_LOG, MessageType.L7_LOG,
                     MessageType.METRICS}


@pytest.mark.parametrize("seed", SEEDS)
def test_engines_give_the_same_rows(seed):
    """The native map and the Python one close the same flows with the
    same counters, surface the same L7 sessions and meter the same
    documents (their order of emission may differ)."""
    frames = ft.synthetic(seed)
    py, nat = (_rows(_drive("port", e, frames))
               for e in ("python", "native"))
    assert py == nat and py["docs"]
    l7 = [wire.L7FlowLog.FromString(b) for b in py["l7"]]
    statuses = {r.response_status for r in l7}
    assert {wire.OK, wire.SERVER_ERROR}.issubset(statuses)
    assert {r.l7_protocol for r in l7} >= {wire.HTTP1, wire.REDIS, wire.DNS}
    l4 = [wire.L4FlowLog.FromString(b) for b in py["l4"]]
    assert {r.close_type for r in l4} == {"fin", "rst", "timeout"}
    assert any(r.retrans_tx for r in l4) and any(r.zero_win_rx for r in l4)


def _map_run(side: str, engine: str, frames: list, max_flows: int):
    """A bare flow map (no dispatcher) with callbacks that convert with
    the side's own functions; every tick's output and the stats."""
    fl, nf, conv = ((flow_map, native_flow, dispatcher) if side == "port"
                    else (ref_flow_map, ref_native_flow, ref_dispatcher))
    pk = packet if side == "port" else ref_packet
    out = []
    cbs = dict(
        on_l4_log=lambda n: out.append(
            ("l4", conv.flow_to_l4_pb(n).SerializeToString())),
        on_l7_log=lambda r: out.append(
            ("l7", conv.record_to_l7_pb(r).SerializeToString())),
        on_flow_update=lambda n, closed: out.append(
            ("upd", n.flow_id, closed, n.tx.packets, n.rx.bytes)))
    if engine == "native":
        fm = nf.NativeFlowMap(max_flows=max_flows, **cbs)
    else:
        fm = fl.FlowMap(max_flows=max_flows, **cbs)
    for chunk, end in ft.windows(frames):
        if engine == "native":
            fm.inject_frames(chunk)
        else:
            for frame, ts in chunk:
                mp = pk.decode_ethernet(frame, timestamp_ns=ts)
                if mp is not None:
                    fm.inject(mp)
        fm.tick(end)
    fm.flush_all()
    return out, fm.stats


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("max_flows", [8, 64])
def test_eviction_at_max_flows_equals_reference(engine, max_flows):
    frames = ft.synthetic(seed=5, n_flows=160)
    got, got_stats = _map_run("port", engine, frames, max_flows)
    want, want_stats = _map_run("ref", engine, frames, max_flows)
    assert got == want
    assert got_stats == want_stats
    assert got_stats["evicted"] > 0
    forced = [wire.L4FlowLog.FromString(b).close_type
              for kind, b, *_ in got if kind == "l4"]
    assert "forced" in forced


def test_inference_budget_and_endpoint_cache_equal_reference():
    """Unparseable flows to one endpoint: each flow gives up after its
    attempts, and past INFER_ENDPOINT_FAILS flows the endpoint is
    skipped but for a periodic re-probe; the caches match."""
    frames = ft.synthetic(seed=7, n_flows=400)
    maps = []
    for mod, pk in ((flow_map, packet), (ref_flow_map, ref_packet)):
        fm = mod.FlowMap()
        for frame, ts in frames:
            mp = pk.decode_ethernet(frame, timestamp_ns=ts)
            if mp is not None:
                fm.inject(mp)
        maps.append(fm)
    port, ref = maps
    assert port._infer_fails == ref._infer_fails
    ep = next(k for k in port._infer_fails if k[1] == 9999)
    assert port._infer_fails[ep] > flow_map.FlowMap.INFER_ENDPOINT_FAILS
    assert {k: (n.l7_inferred, n.l7_infer_attempts, n.l7_protocol)
            for k, n in port.flows.items()} == \
        {k: (n.l7_inferred, n.l7_infer_attempts, n.l7_protocol)
         for k, n in ref.flows.items()}


def test_collector_documents_equal_reference():
    """The QuadrupleGenerator alone, fed the same flows and records by
    a Python map, flushed at fixed seconds."""
    from deepflow_tpu.agent.collector import QuadrupleGenerator as RefQG
    frames = ft.synthetic(seed=3)
    outs = []
    for mod, qg_cls, pk in ((flow_map, QuadrupleGenerator, packet),
                            (ref_flow_map, RefQG, ref_packet)):
        docs = []
        qg = qg_cls(docs.extend)
        fm = mod.FlowMap(on_flow_update=qg.add_flow, on_l7_log=qg.add_l7)
        for chunk, end in ft.windows(frames):
            for frame, ts in chunk:
                fm.inject(pk.decode_ethernet(frame, timestamp_ns=ts))
            fm.tick(end)
            qg.flush(now_s=end // 1_000_000_000)
        fm.flush_all()
        qg.flush(now_s=frames[-1][1] // 1_000_000_000 + 1)
        outs.append([d.SerializeToString() for d in docs])
    assert outs[0] == outs[1] and outs[0]
    docs = [pb.Document.FromString(b) for b in outs[0]]
    assert any(d.HasField("flow_meter") for d in docs)
    assert any(d.HasField("app_meter") and d.app_meter.error_server
               for d in docs)


def test_engine_names_and_no_fallback(monkeypatch, tmp_path):
    """engine is "native" (the default) or "python"; a native library
    that does not build, or does not load, raises under "native"."""
    with pytest.raises(ValueError, match="engine must be one of"):
        dispatcher.Dispatcher(engine="auto")
    assert dispatcher.Dispatcher().native_map is not None
    assert dispatcher.Dispatcher(engine="python").native_map is None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-this-test")
    with pytest.raises(native.NativeLibraryError,
                       match="no-such-compiler-for-this-test"):
        dispatcher.Dispatcher()
    with pytest.raises(native.NativeLibraryError):
        native_flow.NativeRing("lo")

    def refuse():
        raise native.NativeLibraryError("cannot load libdfnative-x.so")
    monkeypatch.setattr(native, "load", refuse)
    with pytest.raises(native.NativeLibraryError, match="cannot load"):
        dispatcher.Dispatcher(engine="native")
    # the Python engine needs no native library, and replays a capture
    sink = _Sink()
    d = dispatcher.Dispatcher(sender=sink, engine="python")
    n = d.replay_pcap(os.path.join(os.path.dirname(__file__), "fixtures",
                                   "pcaps", "http1.pcap"))
    assert n > 0 and any(mt == MessageType.L7_LOG for mt, _ in sink.frames)
