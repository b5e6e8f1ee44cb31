"""Train a Llama-style model or a ResNet on the card, a workload that
knows nothing of the agent unless asked (``--attach``).

    # terminal 1
    python -m deepflow_tpu_torch.server

    # terminal 2, zero-code:
    python -m deepflow_tpu_torch.cli.runner --service llama-train \\
        -m deepflow_tpu_torch.examples.train_with_observability
    #   ...or let the script attach the agent itself:
    python -m deepflow_tpu_torch.examples.train_with_observability --attach

    # then, e.g.
    curl -s -XPOST localhost:20416/v1/profile/TpuFlame -d '{}'
    curl -s -XPOST localhost:20416/v1/profile/ProfileTracing \\
        -d '{"app_service": "llama-train"}'

    # data-parallel ResNet-50, one process and one agent per GPU:
    torchrun --nproc-per-node 8 -m deepflow_tpu_torch.cli.runner \
        --server H:P -m deepflow_tpu_torch.examples.train_with_observability \
        --preset resnet50 --image 224 --batch 128

Weights, tokens, images and labels come from fixed seeds. Each step
prints one JSON line ``{"step", "ms", "loss"}``: ``ms`` is the host time
of the step, which reads the loss and ends in
``torch.cuda.synchronize()``.

The ResNet presets (``resnet50``: the reference's ``ResNetConfig()``;
``resnet-tiny``: ``ResNetConfig.tiny()``) train data-parallel when a
launcher started the process (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``):
each rank joins the default process group over NCCL on its GPU
(``cuda:LOCAL_RANK``), or over gloo with ``--device cpu``, draws its own
images (seed 1 + rank) at ``--batch`` per rank, and takes the
reference's pmap step (``parallel/dp.py``). Its step lines add ``rank``,
``world`` and ``allreduce_calls``, the all-reduce calls one step issues.
Without a launcher the same step runs in a group of one.
"""

import argparse
import json
import sys
import time

import torch

from deepflow_tpu_torch.models import llama as tl
from deepflow_tpu_torch.tpuprobe.ranks import launcher_env

RESNET_PRESETS = ("resnet50", "resnet-tiny")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--attach", action="store_true",
                        help="attach the in-process agent directly")
    parser.add_argument("--server", default="127.0.0.1:20033")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--layers", type=int, default=6)
    parser.add_argument("--seq", type=int, default=512)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--preset", choices=("llama7b", *RESNET_PRESETS),
                        default=None,
                        help="llama7b: LlamaConfig.llama7b() widths with "
                             "--layers depth (--d-model is ignored); "
                             "resnet50 / resnet-tiny: data-parallel ResNet "
                             "at --image pixels, --batch per rank")
    parser.add_argument("--image", type=int, default=224)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.preset in RESNET_PRESETS:
        train_resnet(args)
        return

    if args.attach:
        from deepflow_tpu_torch.agent.agent import attach
        from deepflow_tpu_torch.agent.config import TpuProbeConfig
        attach(app_service="llama-train", servers=[args.server],
               device=args.device,
               tpuprobe=TpuProbeConfig(trace_interval_s=5.0,
                                       trace_duration_ms=1000))

    if args.preset == "llama7b":
        cfg = tl.LlamaConfig.llama7b(n_layers=args.layers)
    else:
        cfg = tl.LlamaConfig(
            vocab=8192, d_model=args.d_model, n_layers=args.layers,
            n_heads=8, n_kv_heads=4, d_ff=int(args.d_model * 2.75),
            max_seq=args.seq * 2)
    dev = torch.device(args.device)
    model = tl.Llama(cfg, device=dev)
    train_step, _opt = tl.make_train_step(model)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"training: d={cfg.d_model} L={cfg.n_layers} seq={args.seq} "
          f"batch={args.batch} on {name}", flush=True)
    t0 = time.time()
    loss = float("nan")
    for i in range(args.steps):
        ts = time.perf_counter()
        loss = float(train_step(tokens))  # reads the loss: waits for it
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1000.0
        print(json.dumps({"step": i, "ms": ms, "loss": loss}), flush=True)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s), final loss {loss:.4f}",
          flush=True)


def train_resnet(args) -> None:
    """The data-parallel ResNet loop (one rank of it under a launcher)."""
    import torch.distributed as dist

    from deepflow_tpu_torch.device import resolve_device
    from deepflow_tpu_torch.models import resnet as tr

    env = launcher_env()
    rank, world, local = env if env is not None else (0, 1, 0)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if args.attach:
        from deepflow_tpu_torch.agent.agent import attach
        attach(app_service="resnet-train", servers=[args.server],
               device=args.device)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if env is None:  # a group of one: the same step, no launcher
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    try:
        cfg = (tr.ResNetConfig() if args.preset == "resnet50"
               else tr.ResNetConfig.tiny())
        model = tr.ResNet(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        step = tr.make_dp_train_step(model)  # the reference's lr 0.1
        images, labels = tr.synthetic_batch(
            cfg, args.batch, args.image,
            torch.Generator(device=dev).manual_seed(1 + rank), dev)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        print(f"training: resnet stages={cfg.stage_sizes} "
              f"width={cfg.width} image={args.image} batch={args.batch} "
              f"rank={rank}/{world} on {name}", flush=True)
        t0 = time.time()
        loss = float("nan")
        for i in range(args.steps):
            ts = time.perf_counter()
            loss = float(step(images, labels))  # reads the mean loss
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - ts) * 1000.0
            # one write a line: the ranks share the launcher's stdout
            sys.stdout.write(json.dumps({
                "step": i, "ms": ms, "loss": loss, "rank": rank,
                "world": world, "allreduce_calls": step.calls_per_step})
                + "\n")
            sys.stdout.flush()
        dt = time.time() - t0
        print(f"done: {args.steps} steps in {dt:.1f}s "
              f"({args.steps / dt:.2f} steps/s), final loss {loss:.4f}",
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
