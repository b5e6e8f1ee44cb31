"""The port's server held against the JAX package's on the CPU: the same
frame bytes, made by the port's probe from synthetic Kineto steps, go
over TCP into a reference ``deepflow_tpu.server.Server`` and into the
port's ``deepflow_tpu_torch.server.Server``; both must hold the same rows
in the profile and self-stats tables and give the same answers to the
seven profile queries (exact for integers, to the reference's own
rounding for its rounded floats)."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings

import test_torch_sql as tsql

from deepflow_tpu.query import sql as ref_sql
from deepflow_tpu.query.engine import QueryError as RefQueryError
from deepflow_tpu.server import Server as RefServer
from deepflow_tpu.store import schema as ref_schema
from deepflow_tpu_torch.agent.config import AgentConfig, TpuProbeConfig
from deepflow_tpu_torch.agent.sink import FrameSink
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.query import sql as S
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
          "profile.tpu_step_metrics", "profile.in_process_profile",
          "deepflow_system.deepflow_system")
# and the querier's own spans and the flow tables: the port's tables, as
# the reference names them
FLOW_TABLES = ("flow_log.l4_flow_log", "flow_log.l7_flow_log",
               "flow_metrics.network.1s", "flow_metrics.application.1s")
# the rollups and the trace trees the server derives from them, and the
# resource recorder's change events
DERIVED_TABLES = tuple(f"flow_metrics.{fam}.{sfx}"
                       for fam in ("network", "application")
                       for sfx in ("1m", "1h", "1d")) + (
                           "flow_log.trace_tree", "event.event")
# the file-I/O windows and the integrations' tables (no frames here)
INTEGRATION_TABLES = ("event.file_agg", "application_log.log",
                      "prometheus.samples", "prometheus.label_sets",
                      "ext_metrics.metrics")
SCHEMA_TABLES = (TABLES + ("deepflow_system.query_trace",) + FLOW_TABLES
                 + DERIVED_TABLES + INTEGRATION_TABLES)
QUERIES = ("tpu_flame", "tpu_memory", "tpu_collectives", "tpu_step_trace",
           "tpu_steps", "tpu_step_critical_path", "profile_tracing")


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


def _profile_and_stats_frames() -> tuple[list, dict]:
    """A PROFILE batch (two services, on- and off-cpu, two profilers,
    stacks sharing prefixes, times across the query windows) and a DFSTATS
    batch, as the agent ships them."""
    stacks = ["runpy._run_code;__main__.main;m.train_step;torch.backward",
              "runpy._run_code;__main__.main;m.train_step",
              "runpy._run_code;__main__.main;queue.get",
              "threading._bootstrap;t.loop;time.sleep"]
    profiles = [
        wire.Profile(process_name="trainer", app_service=svc, pid=7,
                     tid=tid, thread_name=tname, event_type=etype,
                     timestamp_ns=BASE_NS + t_ms * 1_000_000,
                     stack=stacks[i].encode(), value=10101 * n, count=n,
                     profiler=prof)
        for i, (svc, tid, tname, etype, t_ms, n, prof) in enumerate([
            ("llama-train", 1, "MainThread", 1, 3, 40, "pysampler"),
            ("llama-train", 1, "MainThread", 1, 17, 7, "pysampler"),
            ("llama-train", 1, "MainThread", 2, 25, 2, "pysampler"),
            ("", 2, "loader", 2, 12, 5, "other")])]
    profiles.append(wire.Profile(
        process_name="trainer", app_service="llama-train", pid=7, tid=1,
        thread_name="MainThread", event_type=1,
        timestamp_ns=BASE_NS + 21_000_000, stack=stacks[0].encode(),
        value=10101 * 3, count=3, profiler="pysampler"))
    stats = wire.StatsBatch([
        wire.StatsMetric("agent.sender", BASE_NS + 30_000_000,
                         {"process": "trainer"},
                         {"sent_frames": 12.0, "acked_seq": 2.0 ** 60}),
        wire.StatsMetric("agent.oncpu_sampler", BASE_NS + 30_000_000,
                         {"process": "trainer", "z": "1"},
                         {"samples": 57.0, "overruns": 0.0})])
    frames = [encode_frame(FrameHeader(MessageType.PROFILE),
                           wire.ProfileBatch(profiles).SerializeToString()),
              encode_frame(FrameHeader(MessageType.DFSTATS),
                           stats.SerializeToString())]
    return frames, {"profile.in_process_profile": len(profiles),
                    "deepflow_system.deepflow_system": 4}


def _frames():
    """(frame bytes, counts) as the port's agent ships them: span batches,
    memory-sample batches and step records, the hand-built batch, and a
    profile batch and a stats batch."""
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
    more, more_counts = _profile_and_stats_frames()
    frames = list(sink.frames) + [_host_and_transfer_batch()] + more
    counts = {"profile.tpu_hlo_span": probe.stats["spans_sent"] + 3,
              "profile.tpu_memory": probe.stats["mem_samples_sent"] + 2,
              "profile.tpu_step_metrics": probe.stats["steps_sent"],
              # the querier's own spans: no query has run yet
              "deepflow_system.query_trace": 0,
              # no flow frames (test_torch_flow_ingest.py sends those)
              **dict.fromkeys(FLOW_TABLES + DERIVED_TABLES
                              + INTEGRATION_TABLES, 0),
              **more_counts}
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
    # both servers write their own telemetry into deepflow_system every
    # selfstats_interval_s: keep it out of the comparison
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    port = Server(ingest_port=0, query_port=0,
                  selfstats_interval_s=3600).start()
    # small chunks: the port's tables hold several sealed chunks each
    for name in port.db.tables():
        port.db.table(name).chunk_rows = 8
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


# the reference's transport labels and the port's for the same groups
TRANSPORT = {"ici": "nvlink", "dcn": "network"}


def port_transport(groups: list) -> list:
    """Collective groups with the reference's ici / dcn read as the
    port's nvlink / network."""
    return [dict(g, transport=TRANSPORT.get(g["transport"], g["transport"]))
            for g in groups]


def _canon(method, res):
    """Lists whose order the reference leaves unspecified (ties in its
    ORDER BY, a group-by's output order) in a fixed order; transports as
    the port names them."""
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
        return _sorted_dicts(port_transport(r))
    if method == "tpu_step_trace":
        return dict(r, collectives=port_transport(r["collectives"]))
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
            {"forensics_window_s": 0}, {"time_start": 0, "time_end": 0},
            {"app_service": "llama-train"}, {"app_service": "nope"},
            {"event_type": "off-cpu"}, {"event_type": "no-such-type"},
            {"profiler": "other"}, {"profiler": "nope"},
            {"app_service": "llama-train", "event_type": "on-cpu",
             "time_start": BASE_NS + 10_000_000,
             "time_end": BASE_NS + 22_000_000}]


def _answer(api, method, body):
    try:
        return "ok", _canon(method, getattr(api, method)(dict(body)))
    except Exception as e:  # both must fail alike: compare the message
        return "error", str(e)


# -- the tests ---------------------------------------------------------------

def test_schema_matches_reference_and_wire():
    """The ten tables have the reference's columns, kinds, labels and
    defaults (labels as tuples: the reference keeps some in lists), and
    TPU_SPAN_KINDS / PROFILE_EVENT_TYPES are the wire enums' order
    (ingest stores the int; queries filter on labels)."""
    for name in SCHEMA_TABLES:
        mine = [(c.name, c.kind, tuple(c.enum_values), c.default)
                for c in schema.TABLES[name]]
        ref = [(c.name, c.kind, tuple(c.enum_values), c.default)
               for c in ref_schema.TABLES[name]]
        assert mine == ref, name
    assert schema.TPU_SPAN_KINDS == ref_schema.TPU_SPAN_KINDS
    assert [k.name.lower().replace("_", "-") for k in wire.TpuSpanKind] == \
        ["span-unknown", *schema.TPU_SPAN_KINDS[1:]]
    assert [int(k) for k in wire.TpuSpanKind] == \
        list(range(len(schema.TPU_SPAN_KINDS)))
    assert schema.PROFILE_EVENT_TYPES == ref_schema.PROFILE_EVENT_TYPES
    assert [k.name.lower().replace("_", "-")
            for k in wire.ProfileEventType][1:] == \
        list(schema.PROFILE_EVENT_TYPES[1:])
    assert [int(k) for k in wire.ProfileEventType] == \
        list(range(len(schema.PROFILE_EVENT_TYPES)))


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
    cpu = api.profile_tracing({"app_service": "llama-train"})["result"]
    assert cpu["total_value"] == 10101 * (40 + 7 + 2 + 3)
    assert api.profile_tracing({"profiler": "other"})["result"][
        "total_value"] == 10101 * 5


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
        assert errs == {"TPU_SPAN": 1, "STEP_METRICS": 1, "PROFILE": 0,
                        "DFSTATS": 0, "L4_LOG": 0, "L7_LOG": 0,
                        "METRICS": 0, "PCAP": 0, "EVENT": 0}
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

    routes = {"/v1/profile/ProfileTracing": "profile_tracing",
              "/v1/profile/TpuFlame": "tpu_flame",
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
    assert health["tables"] == {t: len(port.db.table(t))
                                for t in SCHEMA_TABLES}
    assert health["stats"]["receiver"]["bad_frames"] == 0
    assert set(health["stats"]["decoders"]) == {
        "PROFILE", "TPU_SPAN", "STEP_METRICS", "DFSTATS", "L4_LOG",
        "L7_LOG", "METRICS", "PCAP", "EVENT"}
    assert health["stats"]["receiver"]["acks_sent"] == 0  # v1 frames only


def test_server_subprocess_prints_ports_and_answers():
    """python -m deepflow_tpu_torch.server prints its bound ports on its
    first line, ingests, answers /v1/health, and exits 0 on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepflow_tpu_torch.server",
         "--ingest-port", "0", "--query-port", "0", "--sync-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ports = json.loads(proc.stdout.readline())
        assert ports["sync_port"] > 0  # the controller runs by default
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


def test_profile_stack_values_and_merge_like_reference(pair):
    """The per-stack aggregate behind ProfileTracing, and the merge of
    several aggregates by stack string, equal the reference's."""
    from deepflow_tpu.query import flamegraph as ref_flame
    from deepflow_tpu_torch.query import flamegraph
    ref, port = pair
    filters = [{}, {"app_service": "llama-train"}, {"profiler": "other"},
               {"event_type": "on-cpu", "time_start_ns": BASE_NS + 10**7},
               {"time_end_ns": BASE_NS + 20_000_000}, {"app_service": "x"}]
    parts, ref_parts = [], []
    for f in filters:
        got = flamegraph.profile_stack_values(
            port.db.table("profile.in_process_profile"), **f)
        want = ref_flame.profile_stack_values(
            ref.db.table("profile.in_process_profile"), **f)
        assert sorted(zip(*got)) == sorted(zip(*want)), f
        parts.append(got)
        ref_parts.append(want)
    got = flamegraph.merge_stack_values(parts)
    want = ref_flame.merge_stack_values(ref_parts)
    assert sorted(zip(*got)) == sorted(zip(*want)) and got[0]


# -- DF-SQL over POST /v1/query ----------------------------------------------

def _post(port: int, path: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


DEVICE_KINDS_SQL = ("kind IN ('device-compute', 'device-collective', "
                    "'device-transfer')")
SQL_BODIES = [
    {"sql": "SELECT hlo_op, Sum(duration_ns) AS d FROM profile.tpu_hlo_span "
            f"WHERE {DEVICE_KINDS_SQL} GROUP BY hlo_op ORDER BY d DESC "
            "LIMIT 10"},
    {"sql": "SELECT run_id, Count(*) AS n FROM profile.tpu_hlo_span "
            "GROUP BY run_id"},
    {"sql": "SELECT run_id, Count(*) AS n FROM profile.tpu_hlo_span "
            "GROUP BY run_id", "org_id": 1},
    {"sql": "SELECT run_id, Count(*) AS n FROM profile.tpu_hlo_span "
            "GROUP BY run_id", "org_id": 2},
    {"db": "profile", "sql": "SELECT device_id, Max(bytes_in_use) AS m, "
                             "Count() AS n FROM tpu_memory "
                             "GROUP BY device_id ORDER BY device_id"},
    {"db": "deepflow_system",
     "sql": "SELECT metric_name, value_name, value, tag_json "
            "FROM deepflow_system ORDER BY metric_name, value_name"},
    {"db": "deepflow_system", "org_id": 1,
     "sql": "SELECT metric_name, value FROM deepflow_system "
            "WHERE value_name = 'acked_seq'"},
    {"sql": "SELECT app_service, event_type, profiler, Sum(value) AS v, "
            "Count() AS n FROM profile.in_process_profile "
            "WHERE stack LIKE '%train_step%' OR event_type = 'off-cpu' "
            "GROUP BY app_service, event_type, profiler"},
    {"sql": "SELECT job, run_id, step, latency_ns, host, top_hlos "
            "FROM profile.tpu_step_metrics ORDER BY run_id DESC"},
    {"db": "profile",
     "sql": "SELECT time(time, 1) AS s, hlo_op, Avg(duration_ns) AS a, "
            "Percentile(duration_ns, 99) AS p FROM tpu_hlo_span "
            "WHERE hlo_op != '' AND device_id = 1 GROUP BY s, hlo_op "
            "HAVING Count() >= 1 ORDER BY a DESC, hlo_op LIMIT 5"},
    {"sql": "SELECT collective, Count(DISTINCT device_id) AS d, "
            "Sum(bytes_transferred) AS b FROM profile.tpu_hlo_span "
            "WHERE collective != '' GROUP BY collective"},
    {"sql": "SELECT hlo_op FROM profile.tpu_hlo_span WHERE hlo_op = 'absent' "
            "OR hlo_op IN ('nope') OR hlo_op LIKE 'zz%'"},
    {"sql": "SHOW tags FROM tpu_hlo_span"},
    {"sql": "SHOW metrics FROM profile.tpu_memory"},
    {"sql": "SHOW TAGS FROM deepflow_system.deepflow_system"},
]


@pytest.mark.parametrize("path", ["/v1/query", "/v1/query/"])
@pytest.mark.parametrize("body", SQL_BODIES,
                         ids=[str(i) for i in range(len(SQL_BODIES))])
def test_sql_route_like_reference(pair, path, body):
    """POST /v1/query, with or without the trailing slash: the reference
    server's result and debug on the same rows."""
    ref, port = pair
    code, got = _post(port.query_port, path, body)
    ref_code, want = _post(ref.query_port, path, body)
    assert code == ref_code == 200, (got, want)
    assert got["result"] == want["result"]
    assert got["debug"] == want["debug"]
    assert set(got) == set(want) == {"result", "debug"}


def test_sql_route_answers_hold_rows(pair):
    """The bodies above reach real rows: org 1 holds every span, org 2
    none; db resolution names the table it read."""
    _, port = pair
    res = [_post(port.query_port, "/v1/query", b)[1] for b in SQL_BODIES]
    spans = len(port.db.table("profile.tpu_hlo_span"))
    assert res[0]["result"]["values"][0][1] > 0
    assert sum(n for _, n in res[1]["result"]["values"]) == spans
    assert res[2]["result"] == res[1]["result"]
    assert res[3]["result"]["values"] == []
    assert res[4]["debug"]["table"] == "profile.tpu_memory"
    assert res[5]["debug"]["table"] == "deepflow_system.deepflow_system"
    assert res[6]["result"]["values"] == [["agent.sender", 2.0 ** 60]]
    assert all(r["result"]["values"] for r in res[7:11])
    assert res[11]["result"]["values"] == []
    assert res[12]["debug"] == {"show": "tags"}
    assert res[12]["result"]["table"] == "profile.tpu_hlo_span"


def test_show_databases_and_tables_over_http(pair):
    """SHOW DATABASES / TABLES list the port's ten tables: the
    reference's answer cut to them."""
    ref, port = pair
    for what in ("databases", "tables"):
        code, got = _post(port.query_port, "/v1/query",
                          {"sql": f"SHOW {what}"})
        _, want = _post(ref.query_port, "/v1/query",
                        {"sql": f"SHOW {what}"})
        assert code == 200 and got["debug"] == {"show": what}
        names = [r[0] for r in got["result"]["values"]]
        mine = ({t.split(".")[0] for t in SCHEMA_TABLES}
                if what == "databases" else set(SCHEMA_TABLES))
        assert names == sorted(mine)
        assert got["result"]["values"] == [
            r for r in want["result"]["values"] if r[0] in mine]


# the engine tests' corpus, each query on the servers' own table; the
# query_trace table holds each server's own spans, not the frames' rows
SERVER_CORPUS = [re.sub(r"\bFROM t\b", f"FROM {t}", q) for t, q in tsql.CORPUS
                 if t in TABLES]
# the property grammar over the span table's columns and the fixture's ops
_SPAN_GRAMMAR = ("profile.tpu_hlo_span",
                 ("device_id", "hlo_op", "kind", "duration_ns"),
                 ("", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n",
                  "ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
                  "Memcpy DtoD (Device -> Device)", "cudaLaunchKernel"),
                 schema.TPU_SPAN_KINDS, 10**7)


def _same_answer(sql: str, got: dict, want: dict) -> bool:
    """Equal answers up to the order DF-SQL leaves open. The servers store
    a stats batch's values in the order of a map, which differs between
    them, and rows that tie on every ORDER BY key (all rows, without an
    ORDER BY) may come in any order: hold the ranked keys equal, and the
    rows as multisets unless a LIMIT may have cut a run of ties."""
    if tsql._same(got, want):
        return True
    cols = got["columns"]
    if cols != want["columns"] or len(got["values"]) != len(want["values"]):
        return False
    q = S.parse(sql)
    idx = [cols.index(S.expr_name(e) if S.expr_name(e) in cols else e.name)
           for e, _ in q.order_by]

    def keys(res):
        return {"columns": [], "values": [[r[i] for i in idx]
                                          for r in res["values"]]}
    if not tsql._same(keys(got), keys(want)):
        return False
    if q.limit is not None and len(got["values"]) >= q.limit:
        return True

    def rows(res):
        return {"columns": cols, "values": sorted(res["values"], key=repr)}
    return tsql._same(rows(got), rows(want))


def _same_over_http(pair, body):
    ref, port = pair
    code, got = _post(port.query_port, "/v1/query", body)
    ref_code, want = _post(ref.query_port, "/v1/query", body)
    assert code == ref_code == 200, (got, want)
    assert _same_answer(body["sql"], got["result"], want["result"]), \
        (got, want)
    assert got["debug"] == want["debug"]


@pytest.mark.parametrize("sql", SERVER_CORPUS,
                         ids=[str(i) for i in range(len(SERVER_CORPUS))])
def test_sql_corpus_over_http_like_reference(pair, sql):
    """Every query of the engine tests' corpus, over HTTP on the rows
    both servers ingested, gives the reference server's result (floats
    to the engine tests' FLOAT_RTOL)."""
    _same_over_http(pair, {"sql": sql})


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(sql=tsql.group_queries(*_SPAN_GRAMMAR)
       | tsql.select_queries(*_SPAN_GRAMMAR))
def test_generated_sql_over_http_like_reference(pair, sql):
    _same_over_http(pair, {"sql": sql})


@pytest.mark.parametrize("body,names", [
    ({"sql": "SELECT hlo_op FROM profile.nope"}, "no such table 'profile.nope'"),
    ({"sql": "SELECT hlo_op FROM nope", "db": "profile"},
     "no such table 'nope'"),
    ({"sql": "SELECT nope FROM profile.tpu_hlo_span"}, "unknown columns"),
    ({"sql": "SELECT hlo_op FROM"}, "expected ident"),
    ({"sql": "SELECT Sum(hlo_op) FROM profile.tpu_hlo_span"},
     "SUM over string column"),
    ({"sql": "SHOW tags FROM nope"}, "no such table 'nope' for SHOW"),
    ({"sql": "SELECT hlo_op FROM profile.tpu_hlo_span", "org_id": "x"},
     "invalid literal"),
    ({}, "expected SELECT"),
])
def test_sql_route_errors_like_reference(pair, body, names):
    """Unknown tables and columns, bad SQL and bad bodies are a 400 from
    both servers, the port's naming what is wrong."""
    ref, port = pair
    code, got = _post(port.query_port, "/v1/query", body)
    assert code == 400 and names in got["error"], got
    assert _post(ref.query_port, "/v1/query", body)[0] == 400


def _explain_shape(ans: dict, srv) -> dict:
    """An EXPLAIN answer less its times and trace id: what two servers
    over the same rows must agree on. The chunks each scan read are the
    server's own (the port's are smaller): each stale bucket's scan reads
    all of the table's chunks."""
    ex = dict(ans["explain"])
    for k in ("trace_id", "total_ms"):
        assert ex.pop(k)
    ex["plan"] = plan = dict(ex["plan"])
    if "prune" in plan:
        plan["prune"] = prune = dict(plan["prune"])
        stale = next(st["detail"]["bucket_stale"] for st in ex["stages"]
                     if st["stage"] == "execute")
        chunks = len(srv.db.table(plan["table"]).snapshot())
        assert prune.pop("scanned") == stale * chunks > 0
    ex["stages"] = sorted(
        (st["stage"], st["status"], json.dumps(st["detail"], sort_keys=True))
        for st in ex["stages"])
    return {"explain": ex, "debug": ans["debug"],
            "columns": ans["result"]["columns"],
            "stages": sorted(r[0] for r in ans["result"]["values"])}


@pytest.mark.parametrize("table", ["tpu_hlo_span", "t"])
@pytest.mark.parametrize("sql", ["EXPLAIN SELECT hlo_op FROM {}",
                                 "EXPLAIN ANALYZE SELECT Count() FROM {}"])
def test_explain_answers_like_reference(pair, sql, table):
    """EXPLAIN is the plan only, EXPLAIN ANALYZE the plan and the stages
    of a run under a captured trace: the reference server's answer on
    the same rows, but for the times and the trace id; an unknown table
    is the same 400."""
    ref, port = pair
    body = {"sql": sql.format(table), "db": "profile"}
    code, got = _post(port.query_port, "/v1/query", body)
    ref_code, want = _post(ref.query_port, "/v1/query", body)
    assert code == ref_code, (got, want)
    if table == "t":
        # the message goes on to list each server's own tables
        assert code == 400 and got["error"].split(";")[0] \
            == want["error"].split(";")[0] == "no such table 't'"
        return
    assert code == 200 and set(got) == set(want)
    assert _explain_shape(got, port) == _explain_shape(want, ref)
    ex = got["explain"]
    assert ex["plan"]["table"] == "profile.tpu_hlo_span"
    assert ("rows_returned" in ex) == ex["analyze"] == ("ANALYZE" in sql)
    if ex["analyze"]:
        assert ex["rows_returned"] == 1
        assert {st["stage"] for st in ex["stages"]} == {"plan", "execute"}


def test_org_scope_refuses_a_table_without_org_id():
    """org_id on a table with no org_id column is a 400, with the
    reference's message, not the unscoped rows."""
    from deepflow_tpu.server.querier import QuerierAPI as RefAPI
    from deepflow_tpu.store.table import ColumnarTable as RefTable
    from deepflow_tpu.store.table import ColumnSpec as RefSpec
    from deepflow_tpu_torch.store.table import ColumnSpec
    port = Server(ingest_port=0, query_port=0).start()
    try:
        t = port.db.create_table("profile.no_org", [ColumnSpec("time", "u64")])
        t.append_rows([{"time": 1}])
        body = {"sql": "SELECT time FROM profile.no_org"}
        assert _post(port.query_port, "/v1/query", body)[1]["result"][
            "values"] == [[1]]
        code, got = _post(port.query_port, "/v1/query",
                          dict(body, org_id=1))
        ref_table = RefTable("profile.no_org", [RefSpec("time", "u64")])
        with pytest.raises(RefQueryError) as ref_err:
            RefAPI._org_scope(ref_sql.parse(body["sql"]), ref_table, 1)
        assert code == 400 and got["error"] == str(ref_err.value)
    finally:
        port.stop()

