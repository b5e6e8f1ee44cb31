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

``synth_mesh_ranks`` does the same for a model-parallel job on a mesh:
each rank's calls run on its communicators (tensor all-reduces, fsdp
all-gathers and reduce-scatters, sp and pp send-recvs, data
all-reduces) as a CUDA-only capture showed them on four H100s
(PERF.md): the blocking collectives of every communicator on the
workload's stream, the send-recv batches on a stream of their own, one
kernel a call; ``call_windows`` gives the host windows its call log
would hold. The
``xla_names`` twin names each call of each communicator apart and
carries its axis's size as ``replica_group_size``, as XLA's collective
HLOs with replica groups do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from deepflow_tpu_torch.tpuprobe.comms import comm_id


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
    stream: int = 0           # the CUDA stream (0: STREAM)
    comm: str = ""            # the mesh axis whose call launched it


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
P2P_STREAM = 31    # where NCCL ran send-recv batches on the H100s
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
                stream = getattr(op, "stream", 0) or STREAM
                args = {"device": dev_id, "context": 1, "stream": stream,
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
                    "tid": stream, "ts": _us(start - base_ns),
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


NCCL_KERNELS = {
    "all-gather": "ncclDevKernel_AllGather_RING_LL"
                  "(ncclDevKernelArgsStorage<4096ul>)",
    "reduce-scatter": "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL"
                      "(ncclDevKernelArgsStorage<4096ul>)",
    "send-recv": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
}
# the reference's name of each collective (XLA calls a ppermute a
# collective-permute)
XLA_COLLECTIVES = {"all-reduce": "all-reduce", "all-gather": "all-gather",
                   "reduce-scatter": "reduce-scatter",
                   "send-recv": "collective-permute"}


def call_windows(modules: list, base_ns: int) -> list[tuple[int, int, int]]:
    """The call log a rank of ``synth_mesh_ranks`` would hold: (t0, t1,
    comm) around each launch ``build_trace`` gives its collectives."""
    out = []
    for mod in modules:
        m0 = base_ns + mod.offset_ps // 1000
        for i, op in enumerate(mod.ops):
            if getattr(op, "comm", ""):
                out.append((m0 + 1 + i, m0 + 1 + i, comm_id(op.comm)))
    return out


def _mesh_calls(sizes: dict, n_layers: int, n_buckets: int) -> list:
    """One step's calls in issue order: (axis, collective, dtype)."""
    calls = []
    def some(axis, coll, n=1, dtype="BFloat16"):
        if sizes.get(axis, 1) > 1:
            calls.extend([(axis, coll, dtype)] * n)
    for _ in range(n_layers):               # forward
        some("fsdp", "all-gather", 2)
        some("pp", "send-recv")
        some("sp", "send-recv", sizes.get("sp", 1) - 1)
        some("tensor", "all-reduce", 2)
    for _ in range(n_layers):               # backward
        some("tensor", "all-reduce", 2)
        some("sp", "send-recv", sizes.get("sp", 1) - 1)
        some("fsdp", "reduce-scatter", 2)
    for axis in ("data", "sp"):             # gradients and the loss
        some(axis, "all-reduce", n_buckets)
        some(axis, "all-reduce", 1, "Float")
    return calls


def synth_mesh_ranks(shape: tuple, axes: tuple = ("data", "fsdp", "tensor"),
                     n_layers: int = 2, n_steps: int = 2, n_buckets: int = 2,
                     step_ps: int = 40_000_000, skew_ps: int = 30_000,
                     call_bytes: int = 8_388_608, xla_names: bool = False
                     ) -> dict[int, list[SynthModule]]:
    """rank -> its modules for ``n_steps`` steps (run_id 1000 + s) on a
    mesh of ``shape`` over ``axes`` (rank r at position r in row-major
    order). Every rank issues one sequence of calls (``_mesh_calls``;
    a one-rank axis issues none); call k starts on rank r r * skew_ps
    late and ends on every rank at once. Each call's kernel runs on
    STREAM (a send-recv on P2P_STREAM) and names its collective and
    dtype (``xla_names``: ``<collective>.<comm * 1000 + ordinal>`` with
    ``replica_group_size`` = the axis's size)."""
    sizes = dict(zip(axes, shape))
    calls = _mesh_calls(sizes, n_layers, n_buckets)
    n_ranks = 1
    for n in shape:
        n_ranks *= n
    spec: dict[int, list[SynthModule]] = {r: [] for r in range(n_ranks)}
    for s in range(n_steps):
        t0 = s * step_ps
        for r in range(n_ranks):
            base = t0 + r * skew_ps
            first = t0 + 1_000_000 + r * skew_ps
            ops = [SynthOp("fusion.1" if xla_names else CONV_KERNEL,
                           "convolution fusion", base, first - base - 10_000,
                           flops=1_000_000_000, bytes_accessed=4_194_304)]
            ordinal: dict[str, int] = {}
            end = first
            for k, (axis, coll, dtype) in enumerate(calls):
                start = t0 + 1_000_000 + k * 200_000 + r * skew_ps
                end = t0 + 1_000_000 + k * 200_000 + 150_000
                c = comm_id(axis)
                ordinal[axis] = ordinal.get(axis, 0) + 1
                nbytes = 4 if dtype == "Float" else call_bytes
                if xla_names:
                    name = (f"{XLA_COLLECTIVES[coll]}."
                            f"{c * 1000 + ordinal[axis]}")
                elif coll == "all-reduce":
                    name = NCCL_ALLREDUCE[dtype]
                else:
                    name = NCCL_KERNELS[coll]
                ops.append(SynthOp(
                    name, XLA_COLLECTIVES[coll], start, end - start,
                    bytes_accessed=nbytes, dtype=dtype,
                    replica_group_size=sizes[axis] if xla_names else 0,
                    stream=P2P_STREAM if coll == "send-recv" else STREAM,
                    comm=axis))
            ops.append(SynthOp("fusion.2" if xla_names else SGD_KERNEL,
                               "loop fusion", end + 5_000, 300_000))
            spec[r].append(SynthModule("jit_train_step(901)", 1000 + s,
                                       base, end + 305_000 - base, ops))
    return spec
