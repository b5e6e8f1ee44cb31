#!/usr/bin/env python3
"""Which kernels a capture keeps at its edges, on one GPU.

    python3 capture_tail.py

Trains ResNet-50 (batch 128, 224 x 224, bf16, weights and images from
seeds) in this process with TpuProbe attached until three captures, and
prints per capture the kernels of each of its first and last steps, the
kernels whose launch event is missing, and how long after the held
step's mark the last kernel ended. The probe leaves the step held at a
stop out of its spans; this wraps the parser, so it counts every step
the trace holds.
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

    def wrapped(trace, steps, rank=None, **kw):
        # the parser's keywords (the call log, communicator sizes, the
        # world) pass through as the probe gives them
        events = parse(trace, steps, rank=rank, **kw)
        captures.append(_edges(trace, steps, events))
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
    t0 = time.time()
    while kineto.stats["captures"] < 3 and time.time() - t0 < 90:
        step()
    probe.stop()
    print(json.dumps({"kineto": kineto.stats}))
    for c in captures:
        print(json.dumps(c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
