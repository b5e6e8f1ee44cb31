#!/usr/bin/env python3
"""The model-parallel checks of chip_smoke.py's ``parallel`` phase, one
rank per GPU.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        chip_parallel.py [OUT_DIR]

Each rank joins the default NCCL group on cuda:LOCAL_RANK and runs, each
against its plain form on the same inputs:

1. tiny: ``LlamaConfig.tiny(n_heads=8, n_kv_heads=4)`` in float32,
   sharded on the mp phase's mesh (``mp_shape(N)``), two steps, against
   the unsharded port on the CPU from the same weights and tokens: every
   rank's losses and the gathered weights after the steps;
2. ring: ring attention at llama7b() widths (32 heads, 8 KV heads, head
   dim 128), bf16, batch 1, S = 8192 cut over the N ranks, against the
   port's dense attention on the whole sequence (its scores bf16, the
   ring's float32);
3. pipeline: four llama7b() layers (bf16) over N stages, n_micro 4,
   batch 4 x 512 tokens, against the layers applied to each microbatch
   in sequence;
4. moe: d_model 4096, d_ff 11008, 8 experts cut over the N ranks, 4096
   tokens, bf16, against ``moe_ffn_dense``.

2-4 are timed with CUDA events (the median of REPS calls after one) beside
their plain forms, and run once more under a CUDA-only Kineto capture
that the port parses with its call log: the NCCL kernels it classifies
as collectives, by kind, must be one per logged call. Each rank writes
OUT_DIR/parallel_r<rank>.json (default results/); a failed check raises,
so the launcher exits non-zero. A one-rank group issues no collective,
so with N == 1 every call is its plain body and no NCCL kernel runs.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPS = 5
TINY_KW = {"n_heads": 8, "n_kv_heads": 4}
TINY_LOSS_RTOL = 1e-4      # float32 on the card against the CPU
TINY_UPDATE_RTOL = 1e-3    # of the CPU's update over two steps, + 2 ulps
BF16_ATOL = 5e-2           # bf16 outputs of two orders of the same sums
RING_SEQ = 8192
PIPE_LAYERS, PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 4, 4, 512, 4
MOE_D, MOE_FF, MOE_EXPERTS, MOE_TOKENS = 4096, 11008, 8, 4096


def mp_shape(n: int) -> tuple[int, int, int]:
    """The mp phase's mesh on n GPUs: (2, 1, n / 2) from four on, so that
    every rank has two communicators issuing one bf16 all-reduce kernel
    (tensor and data); else factor_devices(n)."""
    from deepflow_tpu_torch.parallel.mesh import factor_devices
    return (2, 1, n // 2) if n >= 4 and n % 2 == 0 else factor_devices(n)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _ms(torch, fn) -> float:
    """Median ms of REPS calls after a warm-up, by CUDA events."""
    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _captured(torch, fn, rank: int, world: int) -> dict:
    """One call under a CUDA-only Kineto capture, parsed by the port with
    its call log: the NCCL kernels by collective and the calls logged."""
    from torch.profiler import ProfilerActivity, profile

    from deepflow_tpu_torch.tpuprobe import kineto
    from deepflow_tpu_torch.tpuprobe.comms import CALL_STRIDE, CALLS

    t0 = time.time_ns()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    fn()
    torch.cuda.synchronize()
    prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = kineto.load_trace(path)
    calls = CALLS.since(t0)
    spans = kineto.extract_device_spans(trace, rank=rank, calls=calls,
                                        comm_sizes=CALLS.sizes(), world=world)
    nccl = [s for s in spans if "nccl" in s.hlo_op.lower()]
    kinds: dict[str, int] = {}
    for s in nccl:
        kinds[s.collective or "(none)"] = kinds.get(s.collective or "(none)",
                                                    0) + 1
    check(all(s.collective for s in nccl), f"every NCCL kernel classified "
          f"as a collective ({kinds})")
    check(len(nccl) == len(calls), f"one NCCL kernel a logged call "
          f"({len(nccl)} kernels, {len(calls)} calls)")
    check(all(s.program_id >= CALL_STRIDE for s in nccl),
          "every NCCL kernel joined to its logged call")
    return {"collectives": kinds, "calls": len(calls),
            "kernels": sum(1 for s in spans if s.hlo_category == "kernel")}


def tiny_check(torch, rank: int, dev) -> dict:
    """The tiny float32 Llama sharded on the card's mesh against the
    unsharded port on the CPU, two steps from one set of weights."""
    import torch.distributed as dist

    from deepflow_tpu_torch.models import llama as tl
    from deepflow_tpu_torch.parallel import mesh as pm

    shape = mp_shape(dist.get_world_size())
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, **TINY_KW)
    cpu = tl.Llama(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    tree = tl.params_to_numpy(cpu)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 33))
    step, _ = tl.make_train_step(cpu)
    want = [float(step(torch.from_numpy(tokens))) for _ in range(2)]
    want_tree = tl.params_to_numpy(cpu)

    mesh = pm.make_mesh(shape, dev)
    model = tl.Llama(cfg, device=dev, mesh=mesh)
    model.load_state_dict(tl.params_from_numpy(tree, dev, mesh=mesh,
                                               cfg=model.cfg))
    step, _ = tl.make_train_step(model)
    n = 4 // shape[0]
    i = pm.axis_index(mesh, "data")
    rows = torch.from_numpy(tokens[i * n:(i + 1) * n]).to(dev)
    got = [float(step(rows)) for _ in range(2)]
    got_tree = tl.params_to_numpy(model)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    check(loss_rel <= TINY_LOSS_RTOL,
          f"tiny sharded loss {got} against the CPU's {want}")
    worst = 0.0
    pairs = [(got_tree[k], want_tree[k], tree[k])
             for k in ("tok_embed", "final_norm")]
    pairs += [(got_tree["layers"][k], want_tree["layers"][k],
               tree["layers"][k]) for k in tree["layers"]]
    for a, w, b in pairs:
        moved = float(np.max(np.abs(w - b)))
        ulps = 2 * float(np.finfo(np.float32).eps * np.max(np.abs(w)))
        err = float(np.max(np.abs(a - w)))
        worst = max(worst, err / (TINY_UPDATE_RTOL * moved + ulps))
    check(worst <= 1.0, f"tiny sharded weights within {TINY_UPDATE_RTOL} "
          f"of the CPU's update ({worst:.3f} of the bound)")
    return {"mesh": list(shape), "losses": got, "cpu_losses": want,
            "loss_rel_err": loss_rel, "weights_share_of_bound": worst}


def ring_check(torch, rank: int, world: int, dev) -> dict:
    from deepflow_tpu_torch.models import llama as tl
    from deepflow_tpu_torch.parallel import mesh as pm
    from deepflow_tpu_torch.parallel.ring_attention import ring_attention

    cfg = tl.LlamaConfig.llama7b(n_layers=1)
    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn((1, RING_SEQ, h, hd), generator=g, device=dev)
               .to(torch.bfloat16) for h in (H, KV, KV))
    mesh = pm.make_mesh((world,), dev, axes=("sp",))
    n = RING_SEQ // world
    lo = rank * n
    ql, kl, vl = (t[:, lo:lo + n].contiguous() for t in (q, k, v))

    def ring():
        return ring_attention(ql, kl, vl, mesh, axis="sp", causal=True)

    def dense():
        return tl._attention(q, k, v, cfg)
    out = ring()
    want = dense()[:, lo:lo + n]
    err = float((out.float() - want.float()).abs().max())
    check(out.shape == want.shape and bool(torch.isfinite(out).all())
          and err <= BF16_ATOL, f"ring attention against dense ({err})")
    res = {"max_abs_err": err, "ms": _ms(torch, ring),
           "dense_ms": _ms(torch, dense)}
    res.update(_captured(torch, ring, rank, world))
    check(res["calls"] == world - 1, "one rotation a ring step but the last")
    return res


def _pipe_layers(torch, cfg, dev):
    from deepflow_tpu_torch.models import llama as tl
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = tl.param_shapes(cfg)["layers"]
    return {name: (torch.ones(shp, device=dev, dtype=cfg.dtype)
                   if name.endswith("norm") else
                   (torch.randn(shp, generator=g, device=dev)
                    / shp[-2] ** 0.5).to(cfg.dtype))
            for name, shp in shapes.items()}


def pipeline_check(torch, rank: int, world: int, dev) -> dict:
    from deepflow_tpu_torch.models import llama as tl
    from deepflow_tpu_torch.parallel import mesh as pm
    from deepflow_tpu_torch.parallel.pipeline import pipeline_forward

    n_layers = max(PIPE_LAYERS, world)
    cfg = tl.LlamaConfig.llama7b(n_layers=n_layers)
    layers = _pipe_layers(torch, cfg, dev)
    cos, sin = tl.rope_tables(cfg, PIPE_SEQ, dev)
    x = (torch.randn((PIPE_BATCH, PIPE_SEQ, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(4))
         .to(cfg.dtype))
    mesh = pm.make_mesh((world,), dev, axes=("pp",))

    def stage_fn(stage, h):
        for j in range(stage["wq"].shape[0]):
            h = tl._layer(cfg, cos, sin, h, {k: p[j] for k, p in
                                             stage.items()})
        return h

    def piped():
        return pipeline_forward(layers, x, stage_fn, mesh, axis="pp",
                                n_micro=PIPE_MICRO)

    def sequential():
        mb = PIPE_BATCH // PIPE_MICRO
        return torch.cat([stage_fn(layers, x[i:i + mb])
                          for i in range(0, PIPE_BATCH, mb)])
    with torch.no_grad():
        out, want = piped(), sequential()
        err = float((out.float() - want.float()).abs().max())
        check(out.shape == want.shape and bool(torch.isfinite(out).all())
              and err <= BF16_ATOL, f"pipeline against sequential ({err})")
        res = {"layers": n_layers, "max_abs_err": err, "ms": _ms(torch, piped),
               "sequential_ms": _ms(torch, sequential)}
        res.update(_captured(torch, piped, rank, world))
    ticks = PIPE_MICRO + world - 1
    check(res["calls"] == (ticks + 1 if world > 1 else 0),
          "a send-recv a tick and the final all-reduce")
    return res


def moe_check(torch, rank: int, world: int, dev) -> dict:
    from deepflow_tpu_torch.models import moe as tm
    from deepflow_tpu_torch.parallel import mesh as pm

    params = tm.init_moe_params(MOE_D, MOE_FF, MOE_EXPERTS, device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(5))
    x = (torch.randn((MOE_TOKENS, MOE_D), device=dev, generator=torch
                     .Generator(device=dev).manual_seed(6))
         .to(torch.bfloat16))
    mesh = pm.make_mesh((world,), dev, axes=("ep",))

    def ep():
        return tm.moe_ffn(params, x, mesh, axis="ep")

    def dense():
        return tm.moe_ffn_dense(params, x)
    with torch.no_grad():
        out, want = ep(), dense()
        err = float((out.float() - want.float()).abs().max())
        check(out.shape == want.shape and bool(torch.isfinite(out).all())
              and err <= BF16_ATOL, f"expert-parallel MoE against dense "
              f"({err})")
        per = MOE_EXPERTS // world
        shards = set(((x @ params["router"]).float().argmax(-1) // per)
                     .tolist())
        res = {"max_abs_err": err, "ms": _ms(torch, ep),
               "dense_ms": _ms(torch, dense), "ranks_routed_to": len(shards)}
        res.update(_captured(torch, ep, rank, world))
    check(res["ranks_routed_to"] == world, "tokens routed to every rank")
    check(res["calls"] == (1 if world > 1 else 0), "one all-reduce")
    return res


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available() or "RANK" not in os.environ:
        print("chip_parallel: run under torch.distributed.run on GPUs",
              file=sys.stderr)
        return 2
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results"
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", device_id=dev)
    result: dict = {"rank": rank, "world": world}
    try:
        for name, fn in (("tiny", lambda: tiny_check(torch, rank, dev)),
                         ("ring", lambda: ring_check(torch, rank, world,
                                                     dev)),
                         ("pipeline", lambda: pipeline_check(
                             torch, rank, world, dev)),
                         ("moe", lambda: moe_check(torch, rank, world, dev))):
            t0 = time.perf_counter()
            result[name] = fn()
            result[name]["wall_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        result["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
    finally:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"parallel_r{rank}.json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
