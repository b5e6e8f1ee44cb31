"""Kineto (torch.profiler) chrome trace -> TpuSpanEvents.

Counterpart of ``deepflow_tpu/tpuprobe/xplane.py``: where that parses
XSpace device planes, this parses the JSON that ``torch.profiler``'s
``export_chrome_trace`` writes from a CUPTI capture. The mapping:

    TpuSpanEvent field   Kineto trace event
    -------------------  ------------------------------------------------
    hlo_op               name (the CUDA kernel's name, or "Memcpy HtoD
                         (Pageable -> Device)" style names)
    hlo_category         cat: "kernel", "gpu_memcpy" or "gpu_memset"
    device_id            the process's global rank when it has one (a
                         launcher's RANK or the default process group;
                         ``rank``), else args.device
    chip_id              args.device (the CUDA ordinal)
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
    program_id           NCCL kernels only: comm * CALL_STRIDE + the
                         call's ordinal in its step for its communicator,
                         from 1, in launch order (see below); 0 for every
                         other op
    replica_group_size   NCCL kernels only: the communicator's group size
                         from the call log, or the world's for a call the
                         log does not hold (0 when unknown)

NCCL calls: every gradient bucket's all-reduce in a step runs a kernel of
the same name, so the op name cannot tell two calls apart the way an XLA
collective's HLO name (``all-reduce.11``) does. All ranks of a
communicator issue its collectives in the same order on its stream, and a
capture holds whole steps, so the n-th NCCL kernel of step s on a rank's
stream is the same call on every rank: ``program_id`` carries n, and the
stitcher keys a collective on (run_id, hlo_op, program_id). A CUDA-only
capture holds no message size for a kernel, so ``bytes_transferred`` of
an NCCL span is 0 unless its args carry one (``In msg nelems`` and
``dtype``, as a capture with CPU activity gives them).

Communicators: a model-parallel rank issues calls on several (one per
mesh axis), whose kernels share names, and a kernel names no process
group. The port's collectives log each call's host window with its
communicator (``comms.py``): ``calls`` [(t0 ns, t1 ns, comm)]. NCCL
launches a call's kernel inside the call, so a kernel takes the
communicator of the window that holds its launch (or the nearest one
within ``CALL_SLACK_NS``), and its ordinal counts that communicator's
calls in the step, the same on every rank of the mesh dimension. A
kernel no logged call launched keeps comm 0 and the ordinal on its
stream.

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
from deepflow_tpu_torch.tpuprobe.comms import CALL_STRIDE
from deepflow_tpu_torch.tpuprobe.events import TpuSpanEvent, classify

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_MODULE = "train_step"
CALL_SLACK_NS = 1_000   # a launch this far outside a call's window
_DEVICE, _LAUNCH = "device", "launch"
_ROLE = {**dict.fromkeys(DEVICE_CATS, _DEVICE),
         **dict.fromkeys(LAUNCH_CATS, _LAUNCH)}


# runtime and driver calls that enqueue device work: each has a device
# record of the same correlation in a whole capture
_ENQUEUE = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy",
            "cudaMemset", "cuMemset")


def _ns(ts_us, base_ns: int) -> int:
    return base_ns + round(float(ts_us) * 1000.0)


def step_of(launch_ns: int, hook_ns: list[int], hook_steps: list[int]
            ) -> int:
    """Step number for a host launch time, from the sorted hook times."""
    if not hook_ns:
        return 0
    i = bisect.bisect_left(hook_ns, launch_ns)
    return hook_steps[i] if i < len(hook_ns) else hook_steps[-1] + 1


# element sizes by c10d's dtype names ("BFloat16", "Float", ...), lowered
_DTYPE_BYTES = {"bfloat16": 2, "half": 2, "float": 4, "double": 8,
                "char": 1, "byte": 1, "bool": 1, "short": 2, "int": 4,
                "long": 8}


def _message_bytes(args: dict) -> int:
    """An NCCL call's message size from its event's args, where the
    capture recorded one; else 0."""
    n = args.get("In msg nelems")
    size = _DTYPE_BYTES.get(str(args.get("dtype", "")).lower())
    try:
        return int(n) * size if n is not None and size else 0
    except (TypeError, ValueError):
        return 0


def comm_of(launch_ns: int, calls: list, starts: list[int]) -> int:
    """The communicator of the logged call whose host window holds the
    launch, or is nearest to it within CALL_SLACK_NS; 0 for none.
    ``calls`` sorted by start, ``starts`` their starts."""
    i = bisect.bisect_right(starts, launch_ns) - 1
    best, gap = 0, CALL_SLACK_NS + 1
    for j in (i, i + 1):
        if 0 <= j < len(calls):
            t0, t1, comm = calls[j]
            d = max(t0 - launch_ns, launch_ns - t1, 0)
            if d < gap:
                best, gap = comm, d
    return best


def extract_device_spans(trace: dict, steps=(), rank: int | None = None,
                         calls=(), comm_sizes: dict | None = None,
                         world: int = 0,
                         dropped: list | None = None) -> list[TpuSpanEvent]:
    """Per-op device spans (plus per-step module spans) from a parsed
    chrome trace. ``steps``: [(step, hook wall-clock ns)]; ``rank``: the
    process's global rank (every span's device_id), None for a lone
    process (device_id is then the CUDA ordinal); ``calls``: the logged
    collective calls [(t0 ns, t1 ns, comm)], ``comm_sizes`` their groups'
    sizes, ``world`` the size of the group an unlogged call is taken to
    run on (the default one).

    A capture's first step is left out when one of its launches has no
    device record: the profiler loses the device records of the first
    kernels launched after a session opens, now and then (their launch
    records are kept), and a step short of kernels is not a whole step.
    Its number goes into ``dropped`` when one is given."""
    base = int(trace.get("baseTimeNanoseconds", 0) or 0)
    events = trace.get("traceEvents", [])
    launches: dict = {}  # correlation -> the launch's ts
    enqueues: list = []  # (correlation, ts) of the calls that enqueue
    device_events = []  # one pass over the trace; its flows, host
    for e in events:    # events and metadata are most of it
        role = _ROLE.get(e.get("cat"))
        if role is None:
            continue
        if role is _DEVICE:
            if e.get("ph") == "X":
                device_events.append(e)
        elif "ts" in e:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e["ts"]
                if str(e.get("name", "")).startswith(_ENQUEUE):
                    enqueues.append((corr, e["ts"]))
    ordered = sorted(steps, key=lambda s: s[1])
    hook_steps = [int(s) for s, _ in ordered]
    hook_ns = [int(t) for _, t in ordered]
    partial = 0  # the first step, when a launch of it lost its record
    if hook_steps and enqueues:
        # the capture's first step: its earliest launch's (the marks may
        # begin with the one before the window, the held step's)
        first = step_of(_ns(min(ts for _c, ts in enqueues), base),
                        hook_ns, hook_steps)
        recorded = {(e.get("args") or {}).get("correlation")
                    for e in device_events}
        if any(step_of(_ns(ts, base), hook_ns, hook_steps) == first
               for corr, ts in enqueues if corr not in recorded):
            partial = first
            if dropped is not None:
                dropped.append(partial)

    out: list[TpuSpanEvent] = []
    bounds: dict[tuple[int, int], list[int]] = {}  # (device, step) -> [t0, t1]
    nccl: list[tuple] = []  # (launch ns, correlation, span) of NCCL calls
    chips: dict[int, int] = {}  # device_id -> its CUDA ordinal
    # one str object per kernel name: the names' hashes, which classify
    # and the encoder's caches take, are then computed once a capture
    names: dict[str, str] = {}
    for e in device_events:
        cat = e["cat"]
        args = e.get("args") or {}
        start = _ns(e["ts"], base)
        dur = max(1, round(float(e.get("dur", 0)) * 1000.0))
        launch_ts = launches.get(args.get("correlation"))
        launch = start if launch_ts is None else _ns(launch_ts, base)
        step = step_of(launch, hook_ns, hook_steps)
        if partial and step == partial:
            continue
        ordinal = int(args.get("device", 0))
        device = ordinal if rank is None else rank
        name = str(e.get("name", ""))
        name = names.setdefault(name, name)
        kind, coll = classify(cat, name)
        call = bool(coll) and cat == "kernel"  # an NCCL kernel
        nbytes = (_message_bytes(args) if call
                  else int(args.get("bytes", 0) or 0))
        span = TpuSpanEvent(
            start_ns=start,
            duration_ns=dur,
            device_id=device,
            chip_id=ordinal,
            core_id=int(args.get("stream", 0)),
            hlo_module=STEP_MODULE if step else "",
            hlo_op=name,
            hlo_category=cat,
            kind=kind,
            bytes_accessed=nbytes,
            run_id=step,
            collective=coll,
            bytes_transferred=nbytes if coll else 0,
            step=step)
        out.append(span)
        if call:
            corr = args.get("correlation")
            nccl.append((launch, corr if isinstance(corr, int) else 0, span))
        if step:
            chips.setdefault(device, ordinal)
            b = bounds.get((device, step))
            if b is None:
                bounds[(device, step)] = [start, start + dur]
            else:
                b[0] = min(b[0], start)
                b[1] = max(b[1], start + dur)
    # each NCCL call's ordinal within its step for its communicator
    logged = sorted(calls)
    starts = [c[0] for c in logged]
    sizes = comm_sizes or {}
    ordinals: dict[tuple, int] = {}
    for launch, _, span in sorted(nccl, key=lambda c: (c[0], c[1])):
        comm = comm_of(launch, logged, starts)
        key = ((span.chip_id, span.run_id, comm) if comm
               else (span.chip_id, span.run_id, 0, span.core_id))
        ordinals[key] = n = ordinals.get(key, 0) + 1
        span.program_id = comm * CALL_STRIDE + n
        span.replica_group_size = sizes.get(comm, 0) if comm else world
    for (device, step), (t0, t1) in sorted(bounds.items()):
        out.append(TpuSpanEvent(
            start_ns=t0,
            duration_ns=max(1, t1 - t0),
            device_id=device,
            chip_id=chips[device],
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
