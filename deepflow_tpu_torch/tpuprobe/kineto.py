"""Kineto (torch.profiler) chrome trace -> TpuSpanEvents.

Counterpart of ``deepflow_tpu/tpuprobe/xplane.py``: where that parses
XSpace device planes, this parses the JSON that ``torch.profiler``'s
``export_chrome_trace`` writes from a CUPTI capture. The mapping:

    TpuSpanEvent field   Kineto trace event
    -------------------  ------------------------------------------------
    hlo_op               name (the CUDA kernel's name, or "Memcpy HtoD
                         (Pageable -> Device)" style names)
    hlo_category         cat: "kernel", "gpu_memcpy" or "gpu_memset"
    device_id, chip_id   args.device (the CUDA ordinal)
    core_id              args.stream
    start_ns             baseTimeNanoseconds + ts (microseconds, relative
                         to the base): wall-clock (Unix) ns
    duration_ns          dur (microseconds), at least 1
    bytes_accessed       args.bytes (memcpy / memset only)
    kind, collective     classify(cat, name): NCCL kernels are
                         collectives, memcpy / memset transfers
    run_id, step         the optimizer step whose host window holds the
                         op's launch (see below); 0 without step signal
    hlo_module           "train_step" when the step is known, else ""

Steps: Kineto has no per-step module line like XLA's "XLA Modules". The
capture source records (step number, host time) from a global optimizer
step hook; step n's window is (hook n-1, hook n]. Each device op is
joined to its host launch (the ``cuda_runtime`` / ``cuda_driver`` event
with the same ``args.correlation``) and takes the step whose window holds
the launch; a launch after the last hook belongs to the step in progress
(last + 1). An op with no launch event in the trace is placed by its own
start. One module span per (device, step) covers that step's ops
(``hlo_op == ""``, ``hlo_category == "module"``), as xplane.py emits one
per XLA module launch, so the step-cadence estimate and StepAggregator
work unchanged. Spans come out in time order (xplane.py emits a plane's
ops before its module spans, which splits a multi-step capture's step
records; here each step closes once).

Kineto writes its times on the wall (Unix) clock: on torch 2.11 with
CUPTI 26, ``baseTimeNanoseconds`` is a fixed Unix-ns base (not the
capture's start) and ``ts`` microseconds after it, and base + ts of a
kernel falls inside the host's ``time.time_ns()`` window of the capture.
The step hook's times are on the same clock. Traces without
``baseTimeNanoseconds`` carry absolute microsecond ``ts``; both forms are
read.
"""

from __future__ import annotations

import bisect
import json

from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.tpuprobe.events import TpuSpanEvent, classify

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_MODULE = "train_step"


def _ns(ts_us, base_ns: int) -> int:
    return base_ns + round(float(ts_us) * 1000.0)


def step_of(launch_ns: int, hook_ns: list[int], hook_steps: list[int]
            ) -> int:
    """Step number for a host launch time, from the sorted hook times."""
    if not hook_ns:
        return 0
    i = bisect.bisect_left(hook_ns, launch_ns)
    return hook_steps[i] if i < len(hook_ns) else hook_steps[-1] + 1


def extract_device_spans(trace: dict, steps=()) -> list[TpuSpanEvent]:
    """Per-op device spans (plus per-step module spans) from a parsed
    chrome trace. ``steps``: [(step, hook wall-clock ns)]."""
    base = int(trace.get("baseTimeNanoseconds", 0) or 0)
    events = trace.get("traceEvents", [])
    launches: dict[int, int] = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "ts" in e:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = _ns(e["ts"], base)
    ordered = sorted(steps, key=lambda s: s[1])
    hook_steps = [int(s) for s, _ in ordered]
    hook_ns = [int(t) for _, t in ordered]

    out: list[TpuSpanEvent] = []
    bounds: dict[tuple[int, int], list[int]] = {}  # (device, step) -> [t0, t1]
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS or e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        start = _ns(e["ts"], base)
        dur = max(1, round(float(e.get("dur", 0)) * 1000.0))
        launch = launches.get(args.get("correlation"), start)
        step = step_of(launch, hook_ns, hook_steps)
        device = int(args.get("device", 0))
        name = str(e.get("name", ""))
        kind, coll = classify(cat, name)
        nbytes = int(args.get("bytes", 0) or 0)
        out.append(TpuSpanEvent(
            start_ns=start,
            duration_ns=dur,
            device_id=device,
            chip_id=device,
            core_id=int(args.get("stream", 0)),
            hlo_module=STEP_MODULE if step else "",
            hlo_op=name,
            hlo_category=cat,
            kind=kind,
            bytes_accessed=nbytes,
            run_id=step,
            collective=coll,
            bytes_transferred=nbytes if coll else 0,
            step=step))
        if step:
            b = bounds.get((device, step))
            if b is None:
                bounds[(device, step)] = [start, start + dur]
            else:
                b[0] = min(b[0], start)
                b[1] = max(b[1], start + dur)
    for (device, step), (t0, t1) in sorted(bounds.items()):
        out.append(TpuSpanEvent(
            start_ns=t0,
            duration_ns=max(1, t1 - t0),
            device_id=device,
            chip_id=device,
            hlo_module=STEP_MODULE,
            hlo_op="",
            hlo_category="module",
            kind=wire.DEVICE_COMPUTE,
            run_id=step,
            step=step))
    # time order, each module span ahead of its step's ops: StepAggregator
    # closes a step when a newer run_id arrives, so a step's spans must
    # not arrive after the next step's
    out.sort(key=lambda e: (e.start_ns, e.hlo_op != ""))
    return out


def load_trace(path: str) -> dict:
    with open(path, "rb") as f:
        return json.load(f)
