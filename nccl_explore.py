#!/usr/bin/env python3
"""What a Kineto capture shows of NCCL all-reduces on several GPUs.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        nccl_explore.py

Each rank all-reduces three bf16 gradient-sized buckets and a float32
loss a step (the DP step's pattern), then captures three steps three
ways: CUDA-only from a side thread (as the probe does), CUDA-only from
the main thread, and with CPU activity. It writes each trace and a
summary per rank into results/nccl_explore/ (the NCCL kernels' names and
args, the trace's categories and distributed info, c10d's sequence
number, whether ReduceOp.AVG exists) and prints rank 0's summary. Needs
two GPUs or more: a one-rank NCCL group launches no all-reduce kernel.
"""

import json
import os
import sys
import threading
import time

OUT = os.path.join("results", "nccl_explore")
BUCKETS = [13_000_000, 12_500_000, 600_000]  # bf16 elements


def _capture(torch, step, acts, path: str, side_thread: bool) -> dict:
    """Three steps under one session; the NCCL kernels it holds."""
    from torch.profiler import profile

    go = threading.Event()
    started = threading.Event()

    def body() -> None:
        prof = profile(activities=acts)
        prof.start()
        started.set()
        go.wait()
        prof.stop()
        prof.export_chrome_trace(path)

    if side_thread:  # start and stop in one thread, beside the steps
        t = threading.Thread(target=body)
        t.start()
        started.wait()
    else:
        prof = profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    if side_thread:
        go.set()
        t.join()
    else:
        prof.stop()
        prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    nccl = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"
            and "nccl" in e.get("name", "").lower()]
    return {"ms_3_steps": ms, "n_nccl": len(nccl),
            "nccl": [{k: e.get(k) for k in ("name", "args", "ts", "dur")}
                     for e in nccl[:8]],
            "cats": sorted({e.get("cat", "") for e in trace["traceEvents"]}),
            "distributedInfo": trace.get("distributedInfo"),
            "comms_cpu": [e for e in trace["traceEvents"]
                          if e.get("name") == "record_param_comms"][:3]}


def main() -> int:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available() or "RANK" not in os.environ:
        print("nccl_explore: run under torch.distributed.run on GPUs",
              file=sys.stderr)
        return 2
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev)
    group = dist.distributed_c10d._get_default_group()
    out = {"rank": rank, "world": world, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "nccl_version": str(torch.cuda.nccl.version()),
           "has_avg": hasattr(dist.ReduceOp, "AVG"),
           "seq": group._get_sequence_number_for_group()}
    bufs = [torch.randn(n, device=dev).to(torch.bfloat16) for n in BUCKETS]
    loss = torch.ones((), device=dev)
    w = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)

    def step():
        x = w @ w
        for b in bufs:
            dist.all_reduce(b)
            b.div_(world)
        dist.all_reduce(loss)
        loss.div_(world)
        return x

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    os.makedirs(OUT, exist_ok=True)
    cuda, cpu = [ProfilerActivity.CUDA], [ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]
    for name, acts, side in (("cuda_only_side", cuda, True),
                             ("cuda_only_main", cuda, False),
                             ("cpu_cuda", cpu, False)):
        out[name] = _capture(torch, step, acts,
                             os.path.join(OUT, f"{name}_r{rank}.json"), side)
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    out["step_ms_plain"] = (time.perf_counter() - t0) / 20 * 1000
    out["seq_after"] = group._get_sequence_number_for_group()
    with open(os.path.join(OUT, f"summary_r{rank}.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    if rank == 0:
        print(json.dumps(out, default=str)[:20000])
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
