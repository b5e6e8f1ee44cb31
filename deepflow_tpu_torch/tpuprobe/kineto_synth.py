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
