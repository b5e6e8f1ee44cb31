#!/usr/bin/env python3
"""Which kernels a capture keeps at its edges, on one GPU.

    python3 capture_tail.py [CAPTURES] [--start-sync]

Trains ResNet-50 (batch 128, 224 x 224, bf16, weights and images from
seeds) in this process with TpuProbe attached until CAPTURES captures
(3 by default), and
prints per capture the kernels of each of its first and last steps, the
kernels whose launch event is missing, and how long after the held
step's mark the last kernel ended. The probe leaves the step held at a
stop out of its spans; this wraps the parser, so it counts every step
the trace holds.

A capture's start, against two marks: the profiler session's start
(host clock before and after ``profile.start()``) and the step hook's
mark of the step held while the session opened. Per capture it prints
the first launches and kernels of the trace (name, launch and device
start in microseconds after the session's start returned and after the
held mark), the kernels the first step lacks against the fullest step
(each with its position in that step's launch order), and whether the
trace holds a launch or a kernel from before the session's start.

``--start-sync`` synchronizes the workload's device right after
``profile.start()`` returns, inside the probe's hold (before the held
step's thread is released): the experiment on the device records a
capture's first launches lose. The kineto line then carries
``start_sync``, and every run prints the median and mean ms of the
steps trained under the probe (each ended by reading its loss).
"""

import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _edges(trace: dict, steps, events) -> dict:
    """What one capture's trace holds at its edges."""
    evs = trace["traceEvents"]
    launches = {(e.get("args") or {}).get("correlation") for e in evs
                if e.get("cat") in LAUNCH_CATS}
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    no_launch = [e for e in dev
                 if (e.get("args") or {}).get("correlation") not in launches]
    per_step = sorted(collections.Counter(
        e.run_id for e in events if e.hlo_op).items())
    base = int(trace.get("baseTimeNanoseconds", 0))
    last_end = max((base + round(float(e["ts"]) * 1000)
                    + round(float(e.get("dur", 0)) * 1000) for e in dev),
                   default=0)
    return {"first": per_step[:2], "last": per_step[-3:],
            "n_steps": len(per_step), "no_launch": len(no_launch),
            "device_events": len(dev),
            "tail_ms": (last_end - steps[-1][1]) / 1e6 if steps else None}


def _start_edges(trace: dict, steps, marks: list, start: tuple) -> dict:
    """The capture's first launches and kernels against the session's
    start (``start``: host ns before and after profile.start()) and the
    held step's mark (the last step-hook mark before the start); per step
    of the raw trace (launch times against ``steps``, the parser's
    marks), its kernels and its launches with no device record."""
    from deepflow_tpu_torch.tpuprobe import kineto
    evs = trace["traceEvents"]
    base = int(trace.get("baseTimeNanoseconds", 0))

    def ns(ts) -> int:
        return base + round(float(ts) * 1000)

    t0, t1 = start
    held = max((t for _s, t in marks if t <= t0), default=None)
    launch = {}
    for e in evs:
        if e.get("cat") in LAUNCH_CATS and "ts" in e:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (ns(e["ts"]), e.get("name", ""))
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_CATS
                  and e.get("ph") == "X"),
                 key=lambda e: launch.get(
                     (e.get("args") or {}).get("correlation"),
                     (ns(e["ts"]), ""))[0])

    def us(x, ref):
        return None if ref is None else round((x - ref) / 1000, 1)

    first = []
    for e in dev[:8]:
        corr = (e.get("args") or {}).get("correlation")
        ln = launch.get(corr, (None, ""))[0]
        first.append({"kernel": e.get("name", "")[:60],
                      "launch_after_start_us": us(ln, t1)
                      if ln is not None else None,
                      "launch_after_held_mark_us": us(ln, held)
                      if ln is not None else None,
                      "device_after_start_us": us(ns(e["ts"]), t1)})
    launches = sorted(t for t, _n in launch.values())
    hook_ns = [t for _s, t in sorted(steps, key=lambda s: s[1])]
    hook_steps = [s for s, _t in sorted(steps, key=lambda s: s[1])]
    per_step = collections.defaultdict(list)
    recorded = set()
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        recorded.add(corr)
        ln = launch.get(corr, (ns(e["ts"]), ""))[0]
        per_step[kineto.step_of(ln, hook_ns, hook_steps)].append(
            e.get("name", ""))
    orphans = collections.Counter()
    for corr, (ln, name) in launch.items():
        if corr not in recorded and name.startswith(kineto._ENQUEUE):
            orphans[kineto.step_of(ln, hook_ns, hook_steps)] += 1
    out = {"start_call_us": round((t1 - t0) / 1000, 1),
           "held_mark_before_start_us": us(t0, held),
           "first_launch_after_start_us": us(launches[0], t1)
           if launches else None,
           "launches_before_start": sum(1 for t in launches if t < t0),
           "kernels_before_start": sum(1 for e in dev if ns(e["ts"]) < t0),
           "first_kernels": first,
           "orphan_launches_by_step": sorted(orphans.items())}
    if len(per_step) >= 2:
        steps = sorted(per_step)
        full = max(steps[1:], key=lambda s: len(per_step[s]))
        lack = collections.Counter(per_step[full]) - collections.Counter(
            per_step[steps[0]])
        order = per_step[full]
        out.update(first_step=steps[0], first_step_kernels=len(
            per_step[steps[0]]), full_step=full,
            full_step_kernels=len(order),
            first_step_lacks=[{"kernel": k[:60], "n": n,
                               "positions": [i for i, x in enumerate(order)
                                             if x == k][:4]}
                              for k, n in lack.items()])
    return out


def main() -> int:
    import torch

    from deepflow_tpu_torch.agent.config import AgentConfig, TpuProbeConfig
    from deepflow_tpu_torch.agent.sink import FrameSink
    from deepflow_tpu_torch.models import resnet as tr
    from deepflow_tpu_torch.tpuprobe import sources
    from deepflow_tpu_torch.tpuprobe.probe import TpuProbe

    if not torch.cuda.is_available():
        print("capture_tail: CUDA is not available", file=sys.stderr)
        return 2
    captures = []
    parse = sources.extract_device_spans
    starts: list[tuple[int, int]] = []
    hook: dict = {}
    prof_start = torch.profiler.profile.start

    start_sync = "--start-sync" in sys.argv[1:]

    def timed_start(self):
        t0 = time.time_ns()
        prof_start(self)
        if start_sync:
            torch.cuda.synchronize()
        starts.append((t0, time.time_ns()))
    torch.profiler.profile.start = timed_start

    def wrapped(trace, steps, rank=None, **kw):
        # the parser's keywords (the call log, communicator sizes, the
        # world) pass through as the probe gives them
        events = parse(trace, steps, rank=rank, **kw)
        edges = _edges(trace, steps, events)
        edges["start"] = _start_edges(trace, steps,
                                      list(hook["step_hook"]._marks),
                                      starts[-1])
        captures.append(edges)
        return events
    sources.extract_device_spans = wrapped

    cfg = tr.ResNetConfig()
    dev = torch.device("cuda")
    model = tr.ResNet(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    images, labels = tr.synthetic_batch(
        cfg, 128, 224, torch.Generator(device=dev).manual_seed(1), dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    def step() -> float:
        loss = tr.loss_fn(model, images, labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return float(loss.detach())

    for _ in range(3):
        step()
    sink = FrameSink(AgentConfig(tpuprobe=TpuProbeConfig(memory_poll_s=0)),
                     process_name="capture_tail")
    probe = TpuProbe(sink).start()
    kineto = probe.sources[0]
    hook["step_hook"] = kineto.step_hook
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    want = int(args[0]) if args else 3
    t0 = time.time()
    step_ms = []
    while kineto.stats["captures"] < want and time.time() - t0 < 30 * want:
        t1 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t1) * 1000.0)
    probe.stop()
    step_ms.sort()
    print(json.dumps({"kineto": kineto.stats, "start_sync": start_sync,
                      "steps": len(step_ms),
                      "median_step_ms": step_ms[len(step_ms) // 2],
                      "mean_step_ms": sum(step_ms) / len(step_ms),
                      "max_step_ms": step_ms[-1]}))
    for c in captures:
        print(json.dumps(c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
