#!/usr/bin/env python3
"""What a Kineto capture shows of NCCL all-reduces on several GPUs.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        nccl_explore.py [--mesh D,F,T]

Each rank all-reduces three bf16 gradient-sized buckets and a float32
loss a step (the DP step's pattern), then captures three steps three
ways: CUDA-only from a side thread (as the probe does), CUDA-only from
the main thread, and with CPU activity. It writes each trace and a
summary per rank into results/nccl_explore/ (the NCCL kernels' names and
args, the trace's categories and distributed info, c10d's sequence
number, whether ReduceOp.AVG exists) and prints rank 0's summary. Needs
two GPUs or more: a one-rank NCCL group launches no all-reduce kernel.

With ``--mesh D,F,T`` (D * F * T = N) the ranks form a (data, fsdp,
tensor) DeviceMesh and each step issues the sharded step's pattern on
its communicators: two bf16 all-reduces over tensor, a bf16 all-gather
and reduce-scatter over fsdp, a send-recv ring over tensor, a bf16 and a
float32 all-reduce over data (one-rank groups included). Every call's
host window (``time.time_ns()`` before and after it) is kept beside its
communicator. Three steps are captured CUDA-only from a side thread;
per rank the summary gives each NCCL kernel's name, stream and launch
time, the call window its launch falls in (or its distance to the
nearest), the streams each communicator's kernels ran on, the kernels
each call launched, and, gathered on rank 0, whether a communicator's
stream is the same number on every rank.
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


def _mesh_explore(torch, dist, rank: int, world: int, dev, shape) -> dict:
    """The mesh mode (the module's note): per-rank findings."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity

    axes = ("data", "fsdp", "tensor")
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    groups = {a: mesh.get_group(a) for a in axes}
    sizes = {a: mesh.size(mesh_dim=i) for i, a in enumerate(axes)}
    calls: list = []   # (t0 ns, t1 ns, communicator, what)
    act = torch.randn(4, 1024, 4096, device=dev).to(torch.bfloat16)
    shard = torch.randn(4096 * 11008 // 8, device=dev).to(torch.bfloat16)
    grad = torch.randn(12_500_000, device=dev).to(torch.bfloat16)
    loss = torch.ones((), device=dev)
    w = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)

    def call(axis: str, what: str, fn) -> None:
        t0 = time.time_ns()
        fn()
        calls.append((t0, time.time_ns(), axis, what))

    def ring(axis: str) -> None:
        g = groups[axis]
        n = sizes[axis]
        me = dist.get_rank(g)
        send = act[0].clone()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          dist.get_global_rank(g, (me + 1) % n), g),
               dist.P2POp(dist.irecv, recv,
                          dist.get_global_rank(g, (me - 1) % n), g)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()

    def step():
        x = w @ w
        for i in range(2):
            call("tensor", "all_reduce bf16",
                 lambda: dist.all_reduce(act, group=groups["tensor"]))
        f = sizes["fsdp"]
        full = torch.empty(shard.numel() * f, device=dev,
                           dtype=shard.dtype)
        call("fsdp", "all_gather bf16", lambda: dist.all_gather_into_tensor(
            full, shard, group=groups["fsdp"]))
        call("fsdp", "reduce_scatter bf16",
             lambda: dist.reduce_scatter_tensor(shard, full,
                                                group=groups["fsdp"]))
        if sizes["tensor"] > 1:
            call("tensor", "send_recv bf16", lambda: ring("tensor"))
        call("data", "all_reduce bf16",
             lambda: dist.all_reduce(grad, group=groups["data"]))
        call("data", "all_reduce f32",
             lambda: dist.all_reduce(loss, group=groups["data"]))
        return x

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    os.makedirs(OUT, exist_ok=True)
    calls.clear()
    path = os.path.join(OUT, f"mesh_{'x'.join(map(str, shape))}_r{rank}.json")
    t_cap = time.time_ns()
    got = _capture(torch, step, [ProfilerActivity.CUDA], path, True)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0) or 0)
    launch = {}
    for e in trace["traceEvents"]:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (base + round(float(e["ts"]) * 1000), e["name"])
    kernels = []
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower():
            a = e.get("args") or {}
            lt = launch.get(a.get("correlation"), (None, None))
            kernels.append({"name": e["name"], "stream": a.get("stream"),
                            "correlation": a.get("correlation"),
                            "launch_ns": lt[0], "launch_api": lt[1]})
    kernels.sort(key=lambda k: (k["launch_ns"] or 0, k["correlation"] or 0))
    per_call = [0] * len(calls)
    streams: dict = {}
    outside = []
    for k in kernels:
        t = k["launch_ns"]
        best, dist_ns = None, None
        for i, (t0, t1, axis, _) in enumerate(calls):
            d = 0 if t is not None and t0 <= t <= t1 else (
                min(abs(t - t0), abs(t - t1)) if t is not None else None)
            if d is not None and (dist_ns is None or d < dist_ns):
                best, dist_ns = i, d
        k["call"], k["distance_ns"] = best, dist_ns
        if best is not None:
            per_call[best] += 1
            streams.setdefault(calls[best][2], set()).add(k["stream"])
            if dist_ns:
                outside.append(dist_ns)
    out = {"shape": shape, "sizes": sizes, "capture": {
               k: v for k, v in got.items() if k != "nccl"},
           "capture_wall_ns": t_cap, "trace_base_ns": base,
           "n_calls": len(calls), "n_nccl_kernels": len(kernels),
           "kernels_per_call": {f"{a} {what}": sorted({
               per_call[i] for i, c in enumerate(calls)
               if (c[2], c[3]) == (a, what)})
               for (_, _, a, what) in calls},
           "kernels_outside_their_window": len(outside),
           "max_distance_ns": max(outside, default=0),
           "call_window_ns_median": sorted(
               c[1] - c[0] for c in calls)[len(calls) // 2] if calls else 0,
           "streams_by_comm": {a: sorted(s) for a, s in streams.items()},
           "kernel_names": sorted({k["name"] for k in kernels}),
           "launch_apis": sorted({str(k["launch_api"]) for k in kernels}),
           "first_kernels": kernels[:12],
           "group_names": {a: groups[a].group_name for a in axes}}
    every = [None] * world
    dist.all_gather_object(every, out["streams_by_comm"])
    out["streams_by_comm_every_rank"] = every
    out["same_stream_on_every_rank"] = {
        a: len({tuple(s.get(a, [])) for s in every}) == 1
        for a in axes}
    return out


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
    if "--mesh" in sys.argv:
        shape = tuple(int(x) for x in
                      sys.argv[sys.argv.index("--mesh") + 1].split(","))
        out = {"rank": rank, "world": world, "torch": torch.__version__,
               "nccl_version": str(torch.cuda.nccl.version()),
               "has_reduce_scatter_tensor": hasattr(
                   dist, "reduce_scatter_tensor"),
               "has_all_gather_into_tensor": hasattr(
                   dist, "all_gather_into_tensor"),
               **_mesh_explore(torch, dist, rank, world, dev, shape)}
        name = "x".join(map(str, shape))
        with open(os.path.join(OUT, f"mesh_{name}_summary_r{rank}.json"),
                  "w") as f:
            json.dump(out, f, indent=1, default=str)
        if rank == 0:
            print(json.dumps(out, default=str)[:12000])
        dist.destroy_process_group()
        return 0
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
