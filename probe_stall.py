#!/usr/bin/env python3
"""Attribute the training stall around a Kineto capture to its phases.

    python3 probe_stall.py

Trains the chip_smoke configuration (llama7b() widths, 4 layers, bf16,
batch 4 x 1025) in one thread and, in the main thread, runs the capture
cycle that KinetoSource and TpuProbe run, phase by phase with the port's
own functions: session start, the window, stop, chrome-trace export,
JSON load, span extraction, TpuSpanBatch encoding and step aggregation.
A third thread sleeps 1 ms at a time and counts its wake-ups: it needs the
interpreter lock to wake, so its rate in a phase says whether that phase
leaves the lock to other threads (about 0.9 wake-ups per ms when free).
Each phase is printed with the training steps that overlap it; every
number lands in results/probe_stall.json. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

CAPTURES = 3
WINDOW_S = 1.5
OUT = os.path.join("results", "probe_stall.json")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_stall: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from deepflow_tpu_torch.models import llama as tl
    from deepflow_tpu_torch.tpuprobe import kineto
    from deepflow_tpu_torch.tpuprobe.events import batch_to_pb
    from deepflow_tpu_torch.tpuprobe.sources import StepHook
    from deepflow_tpu_torch.tpuprobe.stepmetrics import StepAggregator

    cfg = tl.LlamaConfig.llama7b(n_layers=4)
    model = tl.Llama(cfg, generator=torch.Generator("cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (4, 1025), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    step, _ = tl.make_train_step(model)
    for _ in range(3):
        float(step(tokens))
    hook = StepHook().install()
    stop = threading.Event()
    timeline: list[tuple[float, float]] = []
    wakes: list[float] = []

    def train() -> None:
        while not stop.is_set():
            t0 = time.perf_counter()
            float(step(tokens))
            torch.cuda.synchronize()
            timeline.append((t0, time.perf_counter() - t0))

    def sleeper() -> None:
        while not stop.is_set():
            time.sleep(0.001)
            wakes.append(time.perf_counter())

    threads = [threading.Thread(target=train),
               threading.Thread(target=sleeper)]
    for t in threads:
        t.start()
    captures = []
    try:
        time.sleep(2.0)
        for _ in range(CAPTURES):
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                marks = [("begin", time.perf_counter())]
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                marks.append(("start", time.perf_counter()))
                wall = time.time_ns()
                time.sleep(WINDOW_S)
                marks.append(("window", time.perf_counter()))
                prof.stop()
                marks.append(("stop", time.perf_counter()))
                prof.export_chrome_trace(path)
                marks.append(("export", time.perf_counter()))
                trace_mb = os.path.getsize(path) / 1e6
                trace = kineto.load_trace(path)
                marks.append(("json_load", time.perf_counter()))
                events = kineto.extract_device_spans(trace, hook.since(wall))
                marks.append(("extract", time.perf_counter()))
                payload = batch_to_pb(events)
                marks.append(("encode", time.perf_counter()))
                StepAggregator(lambda records: None).feed(events)
                marks.append(("stepagg", time.perf_counter()))
            time.sleep(WINDOW_S)
            captures.append((len(events), trace_mb, len(payload), marks))
    finally:
        stop.set()
        for t in threads:
            t.join()
        hook.remove()

    steps_ms = sorted(d * 1000 for _, d in timeline)
    out = {"median_step_ms": steps_ms[len(steps_ms) // 2],
           "steps": len(steps_ms), "captures": []}
    print(f"median step ms {out['median_step_ms']:.2f} over "
          f"{len(steps_ms)} steps")
    for n_events, trace_mb, n_bytes, marks in captures:
        phases = []
        for (_, a), (name, b) in zip(marks, marks[1:]):
            ms = (b - a) * 1000
            w = sum(1 for x in wakes if a <= x < b)
            overlap = [[round((t0 - a) * 1000, 1), round(d * 1000, 1)]
                       for t0, d in timeline if t0 < b and t0 + d > a]
            phases.append({"phase": name, "ms": ms,
                           "wakes_per_ms": w / max(ms, 1e-6),
                           "steps_overlapping": overlap})
        out["captures"].append({"events": n_events, "trace_mb": trace_mb,
                                "payload_bytes": n_bytes, "phases": phases})
        print(f"capture: {n_events} events, trace {trace_mb:.1f} MB, "
              f"payload {n_bytes} B")
        for p in phases:
            print(f"  {p['phase']:9s} {p['ms']:8.1f} ms  wakes/ms "
                  f"{p['wakes_per_ms']:.3f}  steps (start ms, length ms) "
                  f"{p['steps_overlapping'][:3]}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
