"""The port's slice end to end on the CPU: synthetic Kineto steps ->
spans -> step records -> frames over TCP into the UNCHANGED reference
server, whose tpu_flame answer must equal the port's device_flame; and
the same steps through the JAX chain give the same rows."""

import json
import socket
import time

import pytest

from deepflow_tpu.server import Server
from deepflow_tpu.tpuprobe.xplane import parse_xplane_file
from deepflow_tpu.tpuprobe.xplane_synth import build_xspace
from deepflow_tpu_torch.agent.config import AgentConfig, TpuProbeConfig
from deepflow_tpu_torch.agent.sink import FrameSink
from deepflow_tpu_torch.codec import MessageType, StreamDecoder
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.query.flamegraph import device_flame
from deepflow_tpu_torch.tpuprobe import kineto, kineto_synth
from deepflow_tpu_torch.tpuprobe.kineto_synth import SynthModule, SynthOp
from deepflow_tpu_torch.tpuprobe.probe import TpuProbe
from deepflow_tpu_torch.tpuprobe.stepmetrics import decode_step_payload

BASE_NS = 1_760_000_000_000_000_000


def _spec(n_devices=2, n_steps=3):
    """The port's spec classes; the reference's build_xspace reads the
    same fields."""
    names = [("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "fusion",
              3_000_000_000),
             ("void at::native::vectorized_elementwise_kernel<4>", "loop",
              400_000_000),
             ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", "all-reduce",
              900_000_000),
             ("Memcpy DtoD (Device -> Device)", "copy", 50_000_000),
             ("void at::native::vectorized_elementwise_kernel<4>", "loop",
              123_000_000)]
    devices = {}
    for dev in range(n_devices):
        mods = []
        for s in range(n_steps):
            t = base = s * 10_000_000_000 + dev * 7_000_000
            ops = []
            for name, cat, dur in names:
                ops.append(SynthOp(name, cat, t, dur + dev * 1_000_000))
                t += dur + dev * 1_000_000
            mods.append(SynthModule("jit_train_step(5)", 1 + s, base,
                                    t - base, ops))
        devices[dev] = mods
    return devices


def _canon(node):
    """Flame dict with siblings in a fixed order: sibling order among equal
    totals is unspecified in both tree builds."""
    return {"name": node["name"], "total_value": node["total_value"],
            "self_value": node["self_value"],
            "children": sorted((_canon(c) for c in node["children"]),
                               key=lambda c: (-c["total_value"], c["name"]))}


def _events():
    trace, steps = kineto_synth.build_trace(_spec(), base_ns=BASE_NS)
    return kineto.extract_device_spans(trace, steps)


def _write_frames(port: int, frames: list[bytes]) -> None:
    """The sink's frames down one TCP connection, as an agent writes them."""
    with socket.create_connection(("127.0.0.1", port), timeout=5.0) as c:
        c.sendall(b"".join(frames))


@pytest.fixture
def server():
    srv = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    try:
        yield srv
    finally:
        srv.stop()


def test_frames_into_reference_server_flame_equal(server):
    events = _events()
    sink = FrameSink(process_name="t")
    probe = TpuProbe(sink)  # not started: the test feeds its sinks
    probe._sink(events)
    probe.stop()  # flushes the last step record
    _write_frames(server.ingest_port, sink.frames)
    assert server.wait_for_rows("profile.tpu_hlo_span", len(events))
    assert server.wait_for_rows("profile.tpu_step_metrics", 3)
    got = server.api.tpu_flame({})["result"]
    want = device_flame(events).to_dict()
    assert _canon(got) == _canon(want)
    assert want["total_value"] == sum(e.duration_ns for e in events)
    # the per-kernel level is there: module -> category -> kernel
    mod = want["children"][0]
    assert mod["name"] == kineto.STEP_MODULE
    cats = {c["name"] for c in mod["children"]}
    assert cats == {"module", "kernel", "gpu_memcpy"}


def test_port_and_reference_chains_give_same_rows(tmp_path):
    """The same steps through xplane (JAX chain) and Kineto (port chain)
    into two reference servers: the same span rows per (op, run_id) and
    the same step-record latencies."""
    spec = _spec()
    path = tmp_path / "s.xplane.pb"
    path.write_bytes(build_xspace(spec))
    ref_events = parse_xplane_file(str(path), capture_start_ns=BASE_NS)
    port_events = _events()

    def rows(events, send):
        srv = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
        try:
            send(srv, events)
            assert srv.wait_for_rows("profile.tpu_hlo_span", len(events))
            assert srv.wait_for_rows("profile.tpu_step_metrics", 3)
            from deepflow_tpu.query import execute
            spans = execute(
                srv.db.table("profile.tpu_hlo_span"),
                "SELECT hlo_op, run_id, kind, Sum(duration_ns) AS d FROM t "
                "GROUP BY hlo_op, run_id, kind").values
            steps = execute(
                srv.db.table("profile.tpu_step_metrics"),
                "SELECT run_id, latency_ns, device_count FROM t").values
            return (sorted(tuple(r) for r in spans),
                    sorted(tuple(r) for r in steps))
        finally:
            srv.stop()

    def send_port(srv, events):
        sink = FrameSink()
        p = TpuProbe(sink)
        p._sink(events)
        p.stop()
        _write_frames(srv.ingest_port, sink.frames)

    def send_ref(srv, events):
        from deepflow_tpu.agent.agent import Agent
        from deepflow_tpu.agent.config import AgentConfig as RefConfig
        from deepflow_tpu.tpuprobe.probe import TpuProbe as RefProbe
        cfg = RefConfig()
        cfg.sender.servers = [("127.0.0.1", srv.ingest_port)]
        cfg.profiler.enabled = False
        cfg.tpuprobe.enabled = False
        agent = Agent(cfg).start()
        try:
            p = RefProbe(agent)
            p._sink(sorted(events,
                           key=lambda e: (e.start_ns, e.hlo_op != "")))
            p.stop()
            deadline = time.monotonic() + 5
            while agent.sender.stats["sent_frames"] < 2 and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            agent.stop()

    assert rows(port_events, send_port) == rows(ref_events, send_ref)


def test_memory_samples_and_step_frames_decode():
    sink = FrameSink(AgentConfig(tpuprobe=TpuProbeConfig(step_topk=3)),
                     process_name="trainer")
    probe = TpuProbe(sink)
    events = _events()
    probe._sink(events)
    probe._mem_sink([{"timestamp_ns": 5, "device_id": 0,
                      "bytes_in_use": 7 << 30, "peak_bytes_in_use": 8 << 30,
                      "bytes_limit": 79 << 30,
                      "largest_free_block": 60 << 30, "num_allocs": 12}])
    probe.stop()
    frames = StreamDecoder().feed(b"".join(sink.frames))
    assert len(frames) == sink.stats["frames"] == 4
    spans, mem, records = [], [], []
    for h, payload in frames:
        if h.msg_type == MessageType.TPU_SPAN:
            b = wire.TpuSpanBatch.FromString(payload)
            spans += b.spans
            mem += b.memory
        else:
            assert h.msg_type == MessageType.STEP_METRICS
            obj = decode_step_payload(payload)
            assert obj["process_name"] == "trainer"
            records += obj["records"]
    assert len(spans) == probe.stats["spans_sent"] == len(events)
    assert {s.process_name for s in spans} == {"trainer"}
    assert [m.bytes_in_use for m in mem] == [7 << 30]
    assert [r["run_id"] for r in records] == [1, 2, 3]
    assert all(len(r["top_hlos"]) == 3 for r in records)
    assert device_flame(spans).to_dict() == device_flame(events).to_dict()
    json.dumps(records)


def test_sink_keeps_every_frame_in_order():
    """The sink keeps each payload as one frame, in call order, and counts
    it by type."""
    sink = FrameSink(process_name="t")
    payloads = [(MessageType.STEP_METRICS, b"{}"),
                (MessageType.TPU_SPAN, wire.TpuSpanBatch().SerializeToString()),
                (MessageType.STEP_METRICS, b'{"records": []}')]
    for t, p in payloads:
        send = (sink.send_step_metrics if t == MessageType.STEP_METRICS
                else sink.send_tpu_spans)
        assert send(p) is True
    frames = StreamDecoder().feed(b"".join(sink.frames))
    assert [(h.msg_type, p) for h, p in frames] == payloads
    assert sink.stats == {"frames": 3, "bytes": sum(map(len, sink.frames)),
                          "tpu_span_frames": 1, "step_frames": 2}
