"""Kineto trace WRITER: synthesize torch.profiler captures from a spec.

Takes the spec that ``deepflow_tpu/tpuprobe/xplane_synth.py::build_xspace``
takes (device id -> modules -> ops, times in picoseconds) and writes what
``torch.profiler``'s ``export_chrome_trace`` would for the same device
work: one ``kernel`` or ``gpu_memcpy`` event per op with its
``cudaLaunchKernel`` / ``cudaMemcpyAsync`` launch joined by
``args.correlation``, times as microseconds relative to
``baseTimeNanoseconds``. Kineto has no module line: each module becomes
an optimizer step, and its end becomes the step hook's host time, as
KinetoSource records it. The CPU tests then feed the same steps and ops
through the reference's xplane parser and this package's Kineto parser.

``synth_dp_ranks`` is the counterpart of ``xplane_synth``'s
``synth_spmd_step`` / ``synth_multislice_step`` for a data-parallel job:
one spec per rank (each rank is its own process, so its own capture),
where every gradient bucket's all-reduce runs the same NCCL kernel name,
with start skew across ranks and a straggler. With ``xla_names`` the same
calls carry distinct XLA op names (``all-reduce.1`` ...), the spec to
hand the reference's ``build_xspace``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SynthOp:
    """One device op occurrence on a device timeline (as xplane_synth)."""
    name: str                 # kernel name, or an xprof op name
    category: str             # xprof hlo_category; picks the Kineto cat
    offset_ps: int
    duration_ps: int
    flops: int = 0
    bytes_accessed: int = 0
    replica_group_size: int = 0
    # a collective's dtype as c10d names it ("BFloat16", "Float"): the
    # kernel's args then carry the message size, as a capture with CPU
    # activity records it
    dtype: str = ""


@dataclass
class SynthModule:
    name: str                 # e.g. "jit_train_step(123)"
    run_id: int               # becomes the optimizer step number
    offset_ps: int
    duration_ps: int
    ops: list = field(default_factory=list)


def kineto_cat(category: str) -> str:
    """The Kineto event category a device op of this kind is filed under:
    xprof's copies and transfers are memcpys, everything else a kernel."""
    c = category.lower()
    return "gpu_memcpy" if "copy" in c or "transfer" in c else "kernel"


_LAUNCH = {"kernel": "cudaLaunchKernel", "gpu_memcpy": "cudaMemcpyAsync"}
STREAM = 7         # the CUDA stream every synthetic op runs on
HOST_PID = 4242    # the process that launches them


_DTYPE_SIZE = {"BFloat16": 2, "Float": 4}


def _us(ns: int) -> float:
    return round(ns / 1000.0, 3)


def build_trace(devices: dict, base_ns: int
                ) -> tuple[dict, list[tuple[int, int]]]:
    """devices: device_id -> modules (with nested ops) ->
    (chrome-trace dict, [(step, hook_ns)]). Op/module picosecond offsets
    count from base_ns on the trace's clock; each op is launched on the
    host 1 ns after its module starts (plus its index), and each step's
    hook fires when its last device module ends."""
    events = []
    hooks: dict[int, int] = {}
    corr = 0
    for dev_id, modules in sorted(devices.items()):
        for mod in modules:
            m0 = base_ns + mod.offset_ps // 1000
            m1 = m0 + mod.duration_ps // 1000
            hooks[mod.run_id] = max(hooks.get(mod.run_id, 0), m1)
            for i, op in enumerate(mod.ops):
                corr += 1
                cat = kineto_cat(op.category)
                start = base_ns + op.offset_ps // 1000
                args = {"device": dev_id, "context": 1, "stream": STREAM,
                        "correlation": corr, "External id": corr}
                if cat != "kernel":
                    args["bytes"] = op.bytes_accessed
                elif getattr(op, "dtype", "") and op.bytes_accessed:
                    # (xplane_synth's ops, which tests pass too, have none)
                    args["In msg nelems"] = (op.bytes_accessed
                                             // _DTYPE_SIZE[op.dtype])
                    args["dtype"] = op.dtype
                events.append({
                    "ph": "X", "cat": cat, "name": op.name, "pid": dev_id,
                    "tid": STREAM, "ts": _us(start - base_ns),
                    "dur": _us(op.duration_ps // 1000), "args": args})
                events.append({
                    "ph": "X", "cat": "cuda_runtime", "name": _LAUNCH[cat],
                    "pid": HOST_PID, "tid": HOST_PID,
                    "ts": _us(m0 + 1 + i - base_ns), "dur": 0.5, "args": {"correlation": corr,
                                         "External id": corr}})
    trace = {"schemaVersion": 1, "deviceProperties": [],
             "traceEvents": events, "traceName": "synthetic",
             "displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns}
    return trace, sorted(hooks.items())


NCCL_ALLREDUCE = {
    "BFloat16": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL"
                "(ncclDevKernelArgsStorage<4096ul>)",
    "Float": "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
             "(ncclDevKernelArgsStorage<4096ul>)",
}
CONV_KERNEL = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
SGD_KERNEL = ("void at::native::(anonymous namespace)::multi_tensor_apply_"
              "kernel<at::native::(anonymous namespace)::TensorListMetadata<2>>")


def synth_dp_ranks(n_ranks: int = 4, n_steps: int = 2, n_buckets: int = 3,
                   step_ps: int = 20_000_000, skew_ps: int = 50_000,
                   straggler: int | None = None,
                   straggler_ps: int = 400_000,
                   bucket_bytes: int = 26_214_400,
                   xla_names: bool = False) -> dict[int, list[SynthModule]]:
    """rank -> its modules for ``n_steps`` data-parallel steps (run_id
    1000 + s). Per step each rank runs its forward and backward
    convolutions, ``n_buckets`` bf16 gradient all-reduces of
    ``bucket_bytes`` and a float32 loss all-reduce (one NCCL kernel name
    per dtype; ``xla_names``: ``all-reduce.<k>``), then the SGD update.
    Rank r starts r * skew_ps late; the straggler's compute runs
    straggler_ps longer and its update a quarter of that. An all-reduce
    ends on every rank at once, the last rank's arrival plus its transfer
    time, so the early ranks' kernels wait: their spans are longer."""
    ready = {r: r * skew_ps + 6_000_000
             + (straggler_ps if r == straggler else 0)
             for r in range(n_ranks)}
    calls = [("BFloat16", bucket_bytes)] * n_buckets + [("Float", 4)]
    spec: dict[int, list[SynthModule]] = {r: [] for r in range(n_ranks)}
    for s in range(n_steps):
        t0 = s * step_ps
        # the k-th call starts on rank r when r is ready; it ends when the
        # last rank has arrived and the data has moved
        last = t0 + max(ready.values())
        ends = []
        for k, (_dtype, nbytes) in enumerate(calls):
            last += 1_000_000 if nbytes > 4 else 20_000
            ends.append(last)
        for r in range(n_ranks):
            base = t0 + r * skew_ps
            ops = [SynthOp("fusion.1" if xla_names else CONV_KERNEL,
                           "convolution fusion", base,
                           ready[r] - r * skew_ps - 10_000,
                           flops=3_500_000_000, bytes_accessed=8_388_608)]
            start = t0 + ready[r]
            for k, (dtype, nbytes) in enumerate(calls):
                name = (f"all-reduce.{k + 1}" if xla_names
                        else NCCL_ALLREDUCE[dtype])
                ops.append(SynthOp(name, "all-reduce", start,
                                   ends[k] - start, bytes_accessed=nbytes,
                                   dtype=dtype))
                start = ends[k] + 5_000
            upd = 300_000 + (straggler_ps // 4 if r == straggler else 0)
            ops.append(SynthOp("fusion.2" if xla_names else SGD_KERNEL,
                               "loop fusion", start, upd))
            spec[r].append(SynthModule(
                "jit_train_step(900)", 1000 + s, base,
                start + upd - base, ops))
    return spec
