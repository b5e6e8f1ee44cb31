"""The port's server held against the JAX package's on the CPU: the same
frame bytes, made by the port's probe from synthetic Kineto steps, go
over TCP into a reference ``deepflow_tpu.server.Server`` and into the
port's ``deepflow_tpu_torch.server.Server``; both must hold the same rows
in the three profile tables and give the same answers to the six
profile queries (exact for integers, to the reference's own rounding for
its rounded floats)."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from deepflow_tpu.server import Server as RefServer
from deepflow_tpu.store import schema as ref_schema
from deepflow_tpu_torch.agent.config import AgentConfig, TpuProbeConfig
from deepflow_tpu_torch.agent.sink import FrameSink
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.server.querier import QueryError
from deepflow_tpu_torch.store import schema
from deepflow_tpu_torch.tpuprobe import kineto, kineto_synth
from deepflow_tpu_torch.tpuprobe.kineto_synth import SynthModule, SynthOp
from deepflow_tpu_torch.tpuprobe.probe import TpuProbe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_NS = 1_760_000_000_000_000_000
STEP_PS = 10_000_000_000  # 10 ms a step
TABLES = ("profile.tpu_hlo_span", "profile.tpu_memory",
          "profile.tpu_step_metrics")
QUERIES = ("tpu_flame", "tpu_memory", "tpu_collectives", "tpu_step_trace",
           "tpu_steps", "tpu_step_critical_path")


def _spec(n_devices=2, n_steps=3):
    """2 devices x 3 steps of GEMM, elementwise, an NCCL all-reduce on
    both devices and a device-to-device copy (with bytes)."""
    ops = [("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "fusion",
            3_000_000_000, 0),
           ("void at::native::vectorized_elementwise_kernel<4>", "loop",
            400_000_000, 0),
           ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", "all-reduce",
            900_000_000, 0),
           ("Memcpy DtoD (Device -> Device)", "copy", 50_000_000,
            64 << 20)]
    devices = {}
    for dev in range(n_devices):
        mods = []
        for s in range(n_steps):
            t = base = s * STEP_PS + dev * 7_000_000
            sops = []
            for name, cat, dur, nbytes in ops:
                # the last step runs slower on device 1: a straggler
                d = dur + dev * 1_000_000 + (s == n_steps - 1) * dev * \
                    500_000_000
                sops.append(SynthOp(name, cat, t, d, bytes_accessed=nbytes))
                t += d
            mods.append(SynthModule("train_step", 1 + s, base, t - base,
                                    sops))
        devices[dev] = mods
    return devices


def _mem(t_ms, dev, used_gib, peak_gib, limit_gib=80):
    return {"timestamp_ns": BASE_NS + t_ms * 1_000_000, "device_id": dev,
            "bytes_in_use": used_gib << 30, "peak_bytes_in_use": peak_gib << 30,
            "bytes_limit": limit_gib << 30, "largest_free_block": 1 << 30,
            "num_allocs": 100 + t_ms}


def _host_and_transfer_batch() -> bytes:
    """A batch built by hand: host-runtime spans (for include_host), two
    more transfers with distinct bytes (so top_ops has a ranking), a
    span with its own slice_id, and memory samples in the same batch."""
    spans = [
        wire.TpuSpan(start_ns=BASE_NS + 2_000_000, duration_ns=300_000,
                     hlo_module="train_step", hlo_op="cudaLaunchKernel",
                     hlo_category="cuda_runtime", kind=wire.HOST_RUNTIME,
                     run_id=1, step=1, pid=7, process_name="trainer"),
        wire.TpuSpan(start_ns=BASE_NS + 12_000_000, duration_ns=2_000_000,
                     device_id=1, chip_id=1, core_id=9, slice_id=3,
                     hlo_module="train_step",
                     hlo_op="Memcpy HtoD (Pageable -> Device)",
                     hlo_category="gpu_memcpy", kind=wire.DEVICE_TRANSFER,
                     bytes_accessed=3 << 20, run_id=2, step=2, pid=7,
                     process_name="trainer"),
        wire.TpuSpan(start_ns=BASE_NS + 22_000_000, duration_ns=1_000_000,
                     hlo_module="train_step",
                     hlo_op="Memset (Device)", hlo_category="gpu_memset",
                     kind=wire.DEVICE_TRANSFER, bytes_accessed=5 << 20,
                     run_id=3, step=3, pid=7, process_name="trainer"),
    ]
    memory = [wire.TpuMemorySample(**_mem(25, 0, 70, 72), pid=7,
                                   process_name="trainer"),
              wire.TpuMemorySample(**_mem(26, 1, 9, 9, limit_gib=0), pid=7,
                                   process_name="trainer")]
    return encode_frame(FrameHeader(MessageType.TPU_SPAN),
                        wire.TpuSpanBatch(spans, memory).SerializeToString())


def _frames():
    """(frame bytes, counts) as the port's probe ships them: span batches,
    memory-sample batches and step records, plus the hand-built batch."""
    trace, steps = kineto_synth.build_trace(_spec(), base_ns=BASE_NS)
    events = kineto.extract_device_spans(trace, steps)
    sink = FrameSink(AgentConfig(tpuprobe=TpuProbeConfig(step_topk=3)),
                     process_name="trainer")
    probe = TpuProbe(sink)
    half = len(events) // 2
    probe._sink(events[:half])
    probe._mem_sink([_mem(1, 0, 10, 12), _mem(2, 1, 11, 13),
                     _mem(11, 0, 40, 41)])
    probe._sink(events[half:])
    probe._mem_sink([_mem(21, 1, 30, 60), _mem(23, 0, 12, 41)])
    probe.stop()
    frames = list(sink.frames) + [_host_and_transfer_batch()]
    counts = {"profile.tpu_hlo_span": probe.stats["spans_sent"] + 3,
              "profile.tpu_memory": probe.stats["mem_samples_sent"] + 2,
              "profile.tpu_step_metrics": probe.stats["steps_sent"]}
    return frames, counts


def _send(port: int, data: bytes) -> None:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
        c.sendall(data)


def _ingest(servers, frames, counts) -> None:
    for srv in servers:
        _send(srv.ingest_port, b"".join(frames))
    for srv in servers:
        for table, n in counts.items():
            assert srv.wait_for_rows(table, n, timeout=10), table
            assert len(srv.db.table(table)) == n


def _start_pair(offset_ns=None):
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0).start()
    port = Server(ingest_port=0, query_port=0).start()
    if offset_ns is not None:
        for srv in (ref, port):
            srv.platform.set_clock_offset(0, offset_ns)
    return ref, port


@pytest.fixture(scope="module")
def pair():
    """A reference and a port server holding the same frames."""
    ref, port = _start_pair()
    try:
        frames, counts = _frames()
        _ingest((ref, port), frames, counts)
        yield ref, port
    finally:
        ref.stop()
        port.stop()


# -- canonical forms ---------------------------------------------------------

def _canon_flame(node):
    """Siblings in a fixed order: sibling order among equal totals is
    unspecified in both tree builds."""
    return {"name": node["name"], "total_value": node["total_value"],
            "self_value": node["self_value"],
            "children": sorted((_canon_flame(c) for c in node["children"]),
                               key=lambda c: (-c["total_value"], c["name"]))}


def _sorted_dicts(rows):
    return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True))


def _canon(method, res):
    """Lists whose order the reference leaves unspecified (ties in its
    ORDER BY, a group-by's output order) in a fixed order."""
    r = res["result"]
    if method == "tpu_flame":
        return _canon_flame(r)
    if method == "tpu_memory":
        r = dict(r, timeline=_sorted_dicts(r["timeline"]),
                 top_ops=_sorted_dicts(r["top_ops"]))
        if r["forensics"] is not None:
            r["forensics"] = dict(
                r["forensics"],
                ops_near_peak=_sorted_dicts(r["forensics"]["ops_near_peak"]))
        return r
    if method == "tpu_collectives":
        return _sorted_dicts(r)
    return r


def _table_rows(table) -> tuple[list, list]:
    """(column names, rows sorted by every column) with strings decoded;
    enum columns as their stored index."""
    names = list(table.columns)
    cols = table.column_concat(names)
    dec = [table.dicts[n].decode_many(cols[n]) if n in table.dicts
           else cols[n].tolist() for n in names]
    return names, sorted(zip(*dec))


def _bodies():
    t_mid = BASE_NS + 15_000_000
    return [{}, {"time_start": t_mid}, {"time_end": t_mid},
            {"time_start": BASE_NS + 5_000_000, "time_end": t_mid},
            {"device_id": 1}, {"include_host": True},
            {"include_host": True, "device_id": 0}, {"run_id": 2},
            {"run_id": 3, "step": 3}, {"step": 2}, {"job": "train_step"},
            {"job": "nope"}, {"top": 2, "limit": 3},
            {"forensics_window_s": 0}, {"time_start": 0, "time_end": 0}]


def _answer(api, method, body):
    try:
        return "ok", _canon(method, getattr(api, method)(dict(body)))
    except Exception as e:  # both must fail alike: compare the message
        return "error", str(e)


# -- the tests ---------------------------------------------------------------

def test_schema_matches_reference_and_wire():
    """The three tables have the reference's columns, kinds, labels and
    defaults, and TPU_SPAN_KINDS is wire.TpuSpanKind's order (ingest
    stores int(kind); queries filter on labels)."""
    for name in TABLES:
        mine = [(c.name, c.kind, c.enum_values, c.default)
                for c in schema.TABLES[name]]
        ref = [(c.name, c.kind, c.enum_values, c.default)
               for c in ref_schema.TABLES[name]]
        assert mine == ref, name
    assert schema.TPU_SPAN_KINDS == ref_schema.TPU_SPAN_KINDS
    assert [k.name.lower().replace("_", "-") for k in wire.TpuSpanKind] == \
        ["span-unknown", *schema.TPU_SPAN_KINDS[1:]]
    assert [int(k) for k in wire.TpuSpanKind] == \
        list(range(len(schema.TPU_SPAN_KINDS)))


@pytest.mark.parametrize("table", TABLES)
def test_same_rows_as_reference(pair, table):
    ref, port = pair
    names, want = _table_rows(ref.db.table(table))
    got_names, got = _table_rows(port.db.table(table))
    assert got_names == names
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("method", QUERIES)
def test_same_answers_as_reference(pair, method):
    ref, port = pair
    for body in _bodies():
        assert _answer(port.api, method, body) == \
            _answer(ref.api, method, body), (method, body)


def test_answers_are_not_empty(pair):
    """The fixture's frames reach every part of every answer."""
    _, port = pair
    api = port.api
    flame = api.tpu_flame({})["result"]
    assert flame["total_value"] > 0
    assert api.tpu_flame({"include_host": True})["result"]["total_value"] \
        > flame["total_value"]
    mem = api.tpu_memory({})["result"]
    assert [d["device_id"] for d in mem["devices"]] == [0, 1]
    assert len(mem["top_ops"]) == 3 and mem["forensics"]["ops_near_peak"]
    assert mem["forensics"]["pressure_pct"] == 87.5  # 70 of 80 GiB
    colls = api.tpu_collectives({})["result"]
    assert len(colls) == 3 and all(c["n_participants"] == 2 for c in colls)
    trace = api.tpu_step_trace({"run_id": 3})["result"]
    assert set(trace["devices"]) == {"0", "1"} and trace["collectives"]
    steps = api.tpu_steps({})["result"]
    assert steps["total_steps"] == 3
    cp = api.tpu_step_critical_path({})["result"]
    assert cp["step"]["step"] == 3 and cp["attribution"]["baseline_steps"]
    with pytest.raises(QueryError):
        api.tpu_step_critical_path({"step": 99})


@pytest.mark.parametrize("offset_ns", [5_000_000, -3_000_000, 999_999])
def test_clock_offset_like_reference(offset_ns):
    """An agent's clock offset of 1 ms or more moves its times at ingest;
    one under 1 ms is noise and is ignored, in both servers."""
    ref, port = _start_pair(offset_ns)
    try:
        frames, counts = _frames()
        _ingest((ref, port), frames, counts)
        for table in TABLES:
            assert _table_rows(port.db.table(table)) == \
                _table_rows(ref.db.table(table)), table
        for method in QUERIES:
            assert _answer(port.api, method, {}) == \
                _answer(ref.api, method, {}), method
        t = port.db.table("profile.tpu_hlo_span").column_concat(["time"])
        shift = offset_ns if abs(offset_ns) >= 1_000_000 else 0
        assert int(t["time"].min()) == BASE_NS + shift
    finally:
        ref.stop()
        port.stop()


def test_bad_frame_drops_connection_not_server():
    """A flipped length byte drops that connection and counts one bad
    frame; a second connection still ingests, in both servers."""
    frames, counts = _frames()
    bad = bytearray(frames[0])
    bad[0] ^= 0xFF  # frame size > the 64 MiB limit
    ref, port = _start_pair()
    try:
        for srv in (ref, port):
            _send(srv.ingest_port, bytes(bad) + b"".join(frames))
            deadline = time.monotonic() + 5
            while srv.receiver.stats["bad_frames"] < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert srv.receiver.stats["bad_frames"] == 1
            assert len(srv.db.table("profile.tpu_hlo_span")) == 0
        _ingest((ref, port), frames, counts)
        assert port.receiver.stats["connections"] == 2
        for d in port.decoders:
            assert d.stats["errors"] == 0
        assert _table_rows(port.db.table("profile.tpu_hlo_span")) == \
            _table_rows(ref.db.table("profile.tpu_hlo_span"))
    finally:
        ref.stop()
        port.stop()


def test_undecodable_payload_counts_as_decode_error():
    """A frame that passes the codec but whose payload does not decode is
    counted in the decoder's errors, as the reference counts it."""
    junk = encode_frame(FrameHeader(MessageType.STEP_METRICS), b"{not json")
    span_junk = encode_frame(FrameHeader(MessageType.TPU_SPAN), b"\x0a\xff")
    ref, port = _start_pair()
    try:
        for srv in (ref, port):
            _send(srv.ingest_port, junk + span_junk)
        for srv in (ref, port):
            deadline = time.monotonic() + 5
            while sum(d.stats["errors"] for d in srv.decoders) < 2 and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
        errs = {d.MSG_TYPE.name: d.stats["errors"] for d in port.decoders}
        assert errs == {"TPU_SPAN": 1, "STEP_METRICS": 1}
        assert {d.MSG_TYPE.name: d.stats["errors"] for d in ref.decoders
                if d.MSG_TYPE.name in errs} == errs
    finally:
        ref.stop()
        port.stop()


def test_stop_drains_queued_frames():
    """Frames accepted by the receiver reach the tables even when the
    server stops before the decoder thread took them."""
    frames, counts = _frames()
    port = Server(ingest_port=0, query_port=0)
    q = port.receiver.register(MessageType.TPU_SPAN)
    from deepflow_tpu_torch.codec import StreamDecoder
    q.put([f for f in StreamDecoder().feed(b"".join(frames))
           if f[0].msg_type == MessageType.TPU_SPAN])
    port.start()
    port.stop()
    assert len(port.db.table("profile.tpu_hlo_span")) == \
        counts["profile.tpu_hlo_span"]


def test_http_routes_and_errors(pair):
    """The POST routes answer as the API does; a bad body is a 400, an
    unknown route a 404, as in the reference."""
    _, port = pair

    def call(path, body=None, method="POST"):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port.query_port}{path}", data=data,
            method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    routes = {"/v1/profile/TpuFlame": "tpu_flame",
              "/v1/profile/TpuCollectives": "tpu_collectives",
              "/v1/profile/TpuStepTrace": "tpu_step_trace",
              "/v1/tpu/steps": "tpu_steps",
              "/v1/tpu/steps/critical_path": "tpu_step_critical_path",
              "/v1/profile/TpuMemory": "tpu_memory"}
    for path, method in routes.items():
        code, got = call(path, {"run_id": 2})
        assert code == 200
        want = json.loads(json.dumps(getattr(port.api, method)({"run_id": 2})))
        assert got == want, path
    assert call("/v1/tpu/steps/critical_path", {"step": 99})[0] == 400
    assert call("/v1/profile/TpuFlame", {"device_id": "x"})[0] == 400
    assert call("/v1/nope", {})[0] == 404
    code, health = call("/v1/health", method="GET")
    assert code == 200 and health["status"] == "ok"
    assert health["tables"] == {t: len(port.db.table(t)) for t in TABLES}
    assert health["stats"]["receiver"]["bad_frames"] == 0
    assert set(health["stats"]["decoders"]) == {"TPU_SPAN", "STEP_METRICS"}


def test_server_subprocess_prints_ports_and_answers():
    """python -m deepflow_tpu_torch.server prints its bound ports on its
    first line, ingests, answers /v1/health, and exits 0 on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepflow_tpu_torch.server",
         "--ingest-port", "0", "--query-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ports = json.loads(proc.stdout.readline())
        frames, counts = _frames()
        _send(ports["ingest_port"], b"".join(frames))
        url = f"http://127.0.0.1:{ports['query_port']}/v1/health"
        deadline = time.monotonic() + 20
        while True:
            with urllib.request.urlopen(url, timeout=10) as r:
                health = json.loads(r.read())
            if health["tables"] == counts or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert health["status"] == "ok"
        assert health["tables"] == counts
        proc.terminate()
        _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err
        assert "Traceback" not in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_port_server_takes_reference_frames_unchanged():
    """What crosses between the packages is frame bytes: a batch encoded
    by the reference's protobuf classes ingests in the port alike."""
    from deepflow_tpu import codec as ref_codec
    from deepflow_tpu.proto import pb
    b = pb.TpuSpanBatch()
    b.spans.add(start_ns=BASE_NS, duration_ns=5, device_id=70000,
                hlo_op="k", kind=1, flops=(1 << 64) - 1,
                process_name="p")
    b.memory.add(timestamp_ns=BASE_NS, device_id=1, bytes_limit=9)
    frame = ref_codec.encode_frame(
        ref_codec.FrameHeader(ref_codec.MessageType.TPU_SPAN),
        b.SerializeToString())
    ref, port = _start_pair()
    try:
        _ingest((ref, port), [frame], {"profile.tpu_hlo_span": 1,
                                       "profile.tpu_memory": 1})
        for table in TABLES:
            assert _table_rows(port.db.table(table)) == \
                _table_rows(ref.db.table(table)), table
        # device_id 70000 wraps in the u16 column, as in the reference
        dev = port.db.table("profile.tpu_hlo_span").column_concat(
            ["device_id"])["device_id"]
        assert dev.tolist() == [70000 % 65536] and dev.dtype == np.uint16
    finally:
        ref.stop()
        port.stop()
