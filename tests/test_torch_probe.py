"""The port's probe pieces held against the JAX package's on the CPU:
wire bytes and frames, the Kineto parser against the xplane parser on the
same synthetic steps, the capture source's duty cycle and contention
guard, and the port's isolation from JAX."""

import ast
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from deepflow_tpu import codec as ref_codec
from deepflow_tpu.proto import pb
from deepflow_tpu.tpuprobe import events as ref_events
from deepflow_tpu.tpuprobe.stepmetrics import StepAggregator as RefAgg
from deepflow_tpu.tpuprobe.xplane import parse_xplane_file
from deepflow_tpu.tpuprobe.xplane_synth import (
    SynthModule, SynthOp, build_xspace)
from deepflow_tpu_torch import codec
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.tpuprobe import events, kineto, kineto_synth
from deepflow_tpu_torch.tpuprobe import sources as S
from deepflow_tpu_torch.tpuprobe.stepmetrics import StepAggregator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_NS = 1_760_000_000_000_000_000


# -- wire and frames ---------------------------------------------------------

def _random_events(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = dict(
            start_ns=int(rng.integers(0, 1 << 62)),
            duration_ns=int(rng.integers(1, 1 << 40)),
            device_id=int(rng.integers(0, 8)),
            chip_id=int(rng.integers(0, 8)),
            core_id=int(rng.integers(0, 40)),
            hlo_module=["", "train_step", "jit_step"][i % 3],
            hlo_op=["", "ampere_bf16_s16816gemm", "fusion.1",
                    "Memcpy HtoD (Pageable -> Device)"][i % 4],
            hlo_category=["kernel", "gpu_memcpy", "", "module"][i % 4],
            kind=int(rng.integers(0, 6)),
            flops=int(rng.integers(0, 1 << 50)) * (i % 2),
            bytes_accessed=int(rng.integers(0, 1 << 40)),
            program_id=int(rng.integers(0, 1 << 40)),
            run_id=int(rng.integers(0, 1 << 40)),
            collective=["", "all-reduce"][i % 2],
            bytes_transferred=int(rng.integers(0, 1 << 30)),
            replica_group_size=int(rng.integers(0, 9)),
            step=int(rng.integers(0, 1 << 20)))
        out.append((events.TpuSpanEvent(**kw), ref_events.TpuSpanEvent(**kw)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_batch_bytes_equal_protobuf(seed):
    pairs = _random_events(seed)
    got = events.batch_to_pb([p for p, _ in pairs], pid=4321,
                             process_name="train.py")
    ref = ref_events.batch_to_pb([r for _, r in pairs], pid=4321,
                                 process_name="train.py").SerializeToString()
    assert got == ref
    back = wire.TpuSpanBatch.FromString(ref)
    assert [s.hlo_op for s in back.spans] == [p.hlo_op for p, _ in pairs]
    assert [s.run_id for s in back.spans] == \
        [p.run_id & 0xFFFFFFFF for p, _ in pairs]


def test_memory_batch_bytes_equal_protobuf():
    rng = np.random.default_rng(7)
    samples = [{"timestamp_ns": int(rng.integers(0, 1 << 62)),
                "device_id": i, "bytes_in_use": int(rng.integers(0, 1 << 36)),
                "peak_bytes_in_use": int(rng.integers(0, 1 << 36)),
                "bytes_limit": 80 << 30, "largest_free_block": 0,
                "num_allocs": int(rng.integers(0, 5000))} for i in range(4)]
    ref = pb.TpuSpanBatch()
    for s in samples:
        m = ref.memory.add(**s)
        m.pid = 99
        m.process_name = "p"
    got = wire.TpuSpanBatch(memory=[
        wire.TpuMemorySample(**s, pid=99, process_name="p")
        for s in samples]).SerializeToString()
    assert got == ref.SerializeToString()
    back = wire.TpuSpanBatch.FromString(got)
    assert [m.bytes_in_use for m in back.memory] == \
        [s["bytes_in_use"] for s in samples]


def test_wire_rejects_out_of_range():
    with pytest.raises(wire.WireError):
        wire.TpuSpanBatch(spans=[wire.TpuSpan(device_id=1 << 32)]
                          ).SerializeToString()
    with pytest.raises(wire.WireError):
        wire.TpuSpanBatch.FromString(b"\x0a\x05\x08")


@pytest.mark.parametrize("size,seq", [(100, None), (5000, None),
                                      (5000, 77), (10, 3)])
def test_frames_decode_both_ways(size, seq):
    payload = np.random.default_rng(size).integers(
        0, 4, size, dtype=np.uint8).tobytes()
    port = codec.encode_frame(
        codec.FrameHeader(codec.MessageType.TPU_SPAN, agent_id=3, seq=seq),
        payload)
    ref = ref_codec.encode_frame(
        ref_codec.FrameHeader(ref_codec.MessageType.TPU_SPAN, agent_id=3,
                              seq=seq), payload)
    assert port == ref
    stream = port + ref_codec.encode_frame(
        ref_codec.FrameHeader(ref_codec.MessageType.STEP_METRICS), b"{}")
    for decoder, mt in ((ref_codec.StreamDecoder(), ref_codec.MessageType),
                        (codec.StreamDecoder(), codec.MessageType)):
        got = []
        for i in range(0, len(stream), 97):  # chunks split frames
            got += decoder.feed(stream[i:i + 97])
        assert [(h.msg_type, bytes(p)) for h, p in got] == [
            (mt.TPU_SPAN, payload), (mt.STEP_METRICS, b"{}")]
        assert got[0][0].seq == seq and got[0][0].agent_id == 3


def test_stream_decoder_rejects_corruption():
    frame = bytearray(codec.encode_frame(
        codec.FrameHeader(codec.MessageType.TPU_SPAN), b"x" * 64))
    frame[-1] ^= 0xFF
    with pytest.raises(codec.FrameDecodeError):
        codec.StreamDecoder().feed(bytes(frame))


# -- classify ----------------------------------------------------------------

@pytest.mark.parametrize("cat,name,want", [
    ("kernel", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgs)",
     (wire.DEVICE_COLLECTIVE, "all-reduce")),
    ("kernel", "ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)",
     (wire.DEVICE_COLLECTIVE, "all-gather")),
    ("kernel", "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(...)",
     (wire.DEVICE_COLLECTIVE, "reduce-scatter")),
    ("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgs)",
     (wire.DEVICE_COLLECTIVE, "send-recv")),
    ("kernel", "ncclKernel_Send_RING(...)", (wire.DEVICE_COLLECTIVE, "send")),
    ("kernel", "ncclKernel_Recv_RING(...)", (wire.DEVICE_COLLECTIVE, "recv")),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
     (wire.DEVICE_TRANSFER, "")),
    ("gpu_memset", "Memset (Device)", (wire.DEVICE_TRANSFER, "")),
    ("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     (wire.DEVICE_COMPUTE, "")),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", (wire.DEVICE_COMPUTE, "")),
])
def test_classify_cuda_names(cat, name, want):
    assert events.classify(cat, name) == want


@pytest.mark.parametrize("cat,name", [
    ("convolution fusion", "fusion.1"), ("all-reduce", "all-reduce.7"),
    ("", "all-gather-start.1"), ("copy", "copy.2"), ("host recv", "recv.1"),
    ("reduce-scatter", "reduce-scatter.2")])
def test_classify_keeps_xprof_names(cat, name):
    assert events.classify(cat, name) == ref_events.classify(cat, name)


# -- the Kineto parser against the xplane parser -----------------------------

def _spec(n_devices, n_steps, step_ps=10_000_000_000, skew_ps=50_000_000):
    """Steps whose module bounds are exactly their ops' extent: Kineto has
    no module line, so the port's module span is the ops' extent."""
    devices = {}
    for dev in range(n_devices):
        mods = []
        for s in range(n_steps):
            base = s * step_ps + dev * skew_ps
            ops = [
                SynthOp("sm90_xmma_gemm_bf16bf16_bf16f32", "convolution fusion",
                        base, 6_000_000_000),
                SynthOp("fusion.2", "loop fusion", base + 6_000_000_000,
                        41_000_000 + 1_000 * dev),
                SynthOp("ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
                        "all-reduce", base + 6_050_000_000,
                        1_200_000_000 + dev * 10_000_000,
                        bytes_accessed=4_194_304),
                SynthOp("all-gather.7", "all-gather", base + 7_400_000_000,
                        800_000_000, bytes_accessed=2_097_152),
                SynthOp("copy.5", "copy", base + 8_300_000_000, 100_000_000,
                        bytes_accessed=1 << 20),
                SynthOp("fusion.2", "loop fusion", base + 8_400_000_000,
                        3_000_000),
            ]
            end = max(o.offset_ps + o.duration_ps for o in ops)
            mods.append(SynthModule("jit_train_step(900)", 1000 + s, base,
                                    end - base, ops))
        devices[dev] = mods
    return devices


def _both(tmp_path, devices):
    path = tmp_path / "synth.xplane.pb"
    path.write_bytes(build_xspace(devices))
    ref = parse_xplane_file(str(path), capture_start_ns=BASE_NS)
    trace, steps = kineto_synth.build_trace(devices, base_ns=BASE_NS)
    got = kineto.extract_device_spans(trace, steps)
    return ref, got


def _key(e):
    return (e.hlo_op, e.duration_ns, e.run_id, int(e.kind), e.collective)


@pytest.mark.parametrize("n_devices,n_steps", [(1, 3), (4, 2)])
def test_kineto_spans_match_xplane(tmp_path, n_devices, n_steps):
    ref, got = _both(tmp_path, _spec(n_devices, n_steps))
    assert Counter(map(_key, got)) == Counter(map(_key, ref))
    assert sorted((e.start_ns, e.device_id) for e in got) == \
        sorted((e.start_ns, e.device_id) for e in ref)
    assert {e.hlo_module for e in got} == {kineto.STEP_MODULE}
    kernels = [e for e in got if e.hlo_op]
    assert {e.hlo_category for e in kernels} == {"kernel", "gpu_memcpy"}
    assert all(e.core_id == kineto_synth.STREAM for e in kernels)


@pytest.mark.parametrize("n_devices,n_steps", [(1, 3), (4, 2)])
def test_kineto_step_records_match_xplane(tmp_path, n_devices, n_steps):
    ref, got = _both(tmp_path, _spec(n_devices, n_steps))
    ref_recs, got_recs = [], []
    ragg, gagg = RefAgg(ref_recs.extend), StepAggregator(got_recs.extend)
    # the port emits spans in time order; the reference's parser emits a
    # plane's ops before its module spans, so it is fed in time order here
    ragg.feed(sorted(ref, key=lambda e: (e.start_ns, e.hlo_op != "")))
    gagg.feed(got)
    ragg.flush()
    gagg.flush()
    assert len(got_recs) == n_steps
    cats = {"convolution fusion": "kernel", "loop fusion": "kernel",
            "all-reduce": "kernel", "all-gather": "kernel",
            "copy": "gpu_memcpy"}
    for r in ref_recs:  # same records, under Kineto's job and categories
        r["job"] = kineto.STEP_MODULE
        r["top_hlos"] = [[op, ns, cats[c]] for op, ns, c in r["top_hlos"]]
    assert got_recs == ref_recs


def test_kineto_launch_decides_step():
    """A kernel launched before a step's hook belongs to that step even
    when it runs on the device after the hook; launches after the last
    hook belong to the step in progress; no hooks, no step."""
    trace = {"baseTimeNanoseconds": 1000, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5.0, "dur": 1.0,
         "args": {"device": 0, "stream": 7, "correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1.0, "dur": 0.1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 9.0, "dur": 1.0,
         "args": {"device": 0, "stream": 7, "correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 4.0, "dur": 0.1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 9.5, "dur": 0.2, "args": {"device": 0, "stream": 7,
                                         "correlation": 3, "bytes": 64}},
    ]}
    # hook of step 5 at 3 us: k1 (launched at 1 us) is step 5 though it
    # ran at 5 us; k2 and the memset come after the last hook -> step 6
    evs = kineto.extract_device_spans(trace, [(5, 1000 + 3000)])
    by_op = {e.hlo_op: e for e in evs if e.hlo_op}
    assert by_op["k1"].run_id == 5 and by_op["k2"].run_id == 6
    assert by_op["Memset (Device)"].run_id == 6
    assert by_op["Memset (Device)"].kind == wire.DEVICE_TRANSFER
    assert by_op["Memset (Device)"].bytes_accessed == 64
    assert by_op["k1"].start_ns == 1000 + 5000
    mods = sorted((e.run_id, e.start_ns, e.duration_ns)
                  for e in evs if not e.hlo_op)
    assert mods == [(5, 6000, 1000), (6, 10000, 1000)]
    bare = kineto.extract_device_spans(trace, [])
    assert {e.run_id for e in bare} == {0}
    assert {e.hlo_module for e in bare} == {""}
    assert all(e.hlo_op for e in bare)  # no step signal, no module spans


def test_kineto_absolute_ts():
    """Traces without baseTimeNanoseconds carry absolute microseconds."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1_700_000_000.25,
         "dur": 2.5, "args": {"device": 1, "stream": 13}}]}
    (e,) = kineto.extract_device_spans(trace)
    assert e.start_ns == 1_700_000_000_250
    assert (e.duration_ns, e.device_id, e.core_id) == (2500, 1, 13)


# -- the capture source ------------------------------------------------------

def _module_spans(n):
    return [events.TpuSpanEvent(start_ns=i, duration_ns=1,
                                hlo_module="train_step", run_id=100 + i)
            for i in range(n)]


def test_kineto_adaptive_duty_cycle():
    """Windows size to whole steps; gaps target the coverage fraction."""
    src = S.KinetoSource(lambda e: None, target_coverage=0.5,
                         steps_per_capture=10)
    assert src._next_gap_s() == src.interval_s  # no steps yet: fallback
    src._observe(_module_spans(20), wall_s=1.0)  # 50 ms steps
    assert src.stats["est_step_ms"] == 50.0
    assert abs(src._next_duration_s() - 0.5) < 1e-6
    assert abs(src._next_gap_s() - 0.5) < 1e-6
    src.target_coverage = 0.1
    assert abs(src._next_gap_s() - 4.5) < 1e-6


def test_kineto_dead_time_compensation():
    """Dead time comes out of the gap and, when it dominates, stretches
    the window so dur/(dur+dead+gap) still hits the target."""
    src = S.KinetoSource(lambda e: None, target_coverage=0.5,
                         steps_per_capture=10)
    src._observe(_module_spans(20), 1.0)
    src._dead_s = 0.2
    dur, gap = src._next_duration_s(), src._next_gap_s()
    assert abs(dur / (dur + src._dead_s + gap) - 0.5) < 0.01
    src._dead_s = 1.0
    dur, gap = src._next_duration_s(), src._next_gap_s()
    assert dur > 0.5
    assert abs(dur / (dur + src._dead_s + gap) - 0.5) < 0.01


def test_kineto_contention_guard_second_source():
    src = S.KinetoSource(lambda e: None)
    assert S._PROFILER_SESSION_LOCK.acquire(blocking=False)
    try:
        assert src.capture_once() == []
        assert src.stats["contended"] == 1
        assert src.stats["captures"] == 0
    finally:
        S._PROFILER_SESSION_LOCK.release()


def test_kineto_contention_guard_user_session():
    """A user's own torch.profiler session is counted, never joined."""
    from torch.profiler import ProfilerActivity, profile
    src = S.KinetoSource(lambda e: None)
    with profile(activities=[ProfilerActivity.CPU]):
        assert src.capture_once() == []
    assert src.stats["contended"] == 1
    assert src.stats["captures"] == 0 and src.stats["errors"] == 0


def test_step_hook_counts_optimizer_steps():
    hook = S.StepHook().install()
    try:
        p = torch.nn.Parameter(torch.ones(3))
        opt = torch.optim.SGD([p], lr=0.1, momentum=0.9)
        for _ in range(4):
            p.sum().backward()
            opt.step()
    finally:
        hook.remove()
    marks = hook.since(0)
    assert [s for s, _ in marks] == [1, 2, 3, 4]
    # the window's marks plus the last one before it
    assert [s for s, _ in hook.since(marks[2][1])] == [2, 3, 4]
    opt.step()  # removed: no longer counted
    assert len(hook.since(0)) == 4


def test_memory_sample_mapping():
    stats = {"allocated_bytes.all.current": 10 << 30,
             "allocated_bytes.all.peak": 12 << 30,
             "reserved_bytes.all.current": 14 << 30,
             "allocation.all.current": 321}
    s = S.memory_sample(5, 0, stats, free_bytes=60 << 30,
                        largest_cached_free=1 << 30)
    assert s == {"timestamp_ns": 5, "device_id": 0,
                 "bytes_in_use": 10 << 30, "peak_bytes_in_use": 12 << 30,
                 "bytes_limit": 74 << 30, "largest_free_block": 60 << 30,
                 "num_allocs": 321}
    snap = [{"device": 0, "blocks": [{"state": "active_allocated",
                                      "size": 1 << 30},
                                     {"state": "inactive", "size": 4096},
                                     {"state": "inactive", "size": 1 << 21}]},
            {"device": 1, "blocks": [{"state": "inactive", "size": 512}]}]
    assert S.largest_inactive_blocks(snap) == {0: 1 << 21, 1: 512}
    # the ingest table takes the sample's keys as they are
    pb.TpuSpanBatch().memory.add(**s)


def test_memory_source_skips_without_cuda_context():
    got = []
    src = S.MemorySource(got.extend)
    assert src.poll_once() == []
    assert src.stats["polls"] == 1 and not got


# -- the port stands alone ---------------------------------------------------

def _port_files():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py",
                                             "probe_stall.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "deepflow_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) >= 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "deepflow_tpu"), (path, m)


def test_port_import_leaves_jax_unloaded():
    code = (
        "import pkgutil, importlib, sys, deepflow_tpu_torch\n"
        "for m in pkgutil.walk_packages(deepflow_tpu_torch.__path__,"
        " 'deepflow_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'deepflow_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_raise_without_cuda(monkeypatch):
    from deepflow_tpu_torch import resolve_device
    from deepflow_tpu_torch.models import llama as tl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.Llama(tl.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.params_from_numpy({"tok_embed": np.zeros((2, 2), np.float32)})
    assert resolve_device("cpu") == torch.device("cpu")
