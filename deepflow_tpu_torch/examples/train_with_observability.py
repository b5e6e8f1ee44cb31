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

    # Llama-7B sharded on the (data, fsdp, tensor) mesh, one rank per GPU:
    torchrun --nproc-per-node 4 -m deepflow_tpu_torch.cli.runner \
        --server H:P -m deepflow_tpu_torch.examples.train_with_observability \
        --preset llama7b --layers 4 --mesh auto    # or --mesh D,F,T, --sp N

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

``--mesh auto|D,F,T`` trains the Llama sharded (``models/llama.py``,
``parallel/mesh.py``) on the (data, fsdp, tensor) mesh of the launcher's
ranks (``auto``: ``factor_devices(world)``), joined the same way;
``--sp N`` trains it in the long-context mode instead, the sequence cut
over N ranks on a (data, sp) mesh of (world / N, N). Every rank draws
the tokens from seed 1 and the weights from seed 0 and keeps its
blocks; ``--batch`` is the global batch, cut over ``data``. Its step
lines add ``rank``, ``world``, ``mesh`` (each axis's size),
``calls``, the collective calls each communicator issued that step,
and on the card ``peak_mb``, the rank's peak allocated memory.
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
    parser.add_argument("--mesh", default=None,
                        help="auto or D,F,T: train the Llama sharded on "
                             "the (data, fsdp, tensor) mesh of the ranks")
    parser.add_argument("--sp", type=int, default=0,
                        help="N: the long-context mode, the sequence cut "
                             "over N ranks")
    args = parser.parse_args()
    if args.preset in RESNET_PRESETS:
        train_resnet(args)
        return
    if args.mesh or args.sp:
        train_llama_mesh(args)
        return

    if args.attach:
        from deepflow_tpu_torch.agent.agent import attach
        from deepflow_tpu_torch.agent.config import TpuProbeConfig
        attach(app_service="llama-train", servers=[args.server],
               device=args.device,
               tpuprobe=TpuProbeConfig(trace_interval_s=5.0,
                                       trace_duration_ms=1000))

    cfg = _llama_config(args)
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


def _llama_config(args) -> "tl.LlamaConfig":
    if args.preset == "llama7b":
        return tl.LlamaConfig.llama7b(n_layers=args.layers)
    return tl.LlamaConfig(
        vocab=8192, d_model=args.d_model, n_layers=args.layers,
        n_heads=8, n_kv_heads=4, d_ff=int(args.d_model * 2.75),
        max_seq=args.seq * 2)


def _join(args, service: str) -> tuple[int, int, torch.device]:
    """This rank joins the launcher's default process group (NCCL on
    cuda:LOCAL_RANK, gloo with --device cpu; a group of one without a
    launcher): (rank, world, device)."""
    import torch.distributed as dist

    from deepflow_tpu_torch.device import resolve_device

    env = launcher_env()
    rank, world, local = env if env is not None else (0, 1, 0)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if args.attach:
        from deepflow_tpu_torch.agent.agent import attach
        attach(app_service=service, servers=[args.server],
               device=args.device)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if env is None:  # a group of one: the same step, no launcher
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return rank, world, dev


def _say(text: str) -> None:
    # one write a line: the ranks share the launcher's stdout, which it
    # leaves unbuffered, so print's text and its newline are two writes
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


def train_llama_mesh(args) -> None:
    """The sharded Llama loop (one rank of it under a launcher)."""
    import torch.distributed as dist

    from deepflow_tpu_torch.parallel import mesh as pm

    rank, world, dev = _join(args, "llama-train")
    try:
        if args.sp:
            if world % args.sp:
                raise ValueError(f"--sp {args.sp} does not divide the "
                                 f"world of {world}")
            mesh = pm.make_mesh((world // args.sp, args.sp), dev,
                                axes=("data", "sp"))
        else:
            shape = (None if args.mesh == "auto" else
                     tuple(int(x) for x in args.mesh.split(",")))
            mesh = pm.make_mesh(shape, dev)
        cfg = _llama_config(args)
        model = tl.Llama(cfg, device=dev, mesh=mesh,
                         sp_axis="sp" if args.sp else None,
                         generator=torch.Generator(device=dev).manual_seed(0))
        step, _opt = tl.make_train_step(model)
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                               device=dev, generator=torch.Generator(
                                   device=dev).manual_seed(1))
        n = args.batch // pm.axis_size(mesh, "data")
        if n * pm.axis_size(mesh, "data") != args.batch:
            raise ValueError(f"--batch {args.batch} does not divide over "
                             f"the data axis")
        i = pm.axis_index(mesh, "data")
        tokens = tokens[i * n:(i + 1) * n]
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        _say(f"training: d={cfg.d_model} L={cfg.n_layers} seq={args.seq} "
             f"batch={args.batch} mesh={shape} rank={rank}/{world} on {name}")
        t0 = time.time()
        loss = float("nan")
        for i in range(args.steps):
            ts = time.perf_counter()
            loss = float(step(tokens))  # reads the mean loss
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - ts) * 1000.0
            fields = {"step": i, "ms": ms, "loss": loss, "rank": rank,
                      "world": world, "mesh": shape, "calls": step.calls}
            if dev.type == "cuda":
                fields["peak_mb"] = (torch.cuda.max_memory_allocated(dev)
                                     / 2**20)
            _say(json.dumps(fields))
        dt = time.time() - t0
        _say(f"done: {args.steps} steps in {dt:.1f}s "
             f"({args.steps / dt:.2f} steps/s), final loss {loss:.4f}")
    finally:
        dist.destroy_process_group()


def train_resnet(args) -> None:
    """The data-parallel ResNet loop (one rank of it under a launcher)."""
    import torch.distributed as dist

    from deepflow_tpu_torch.models import resnet as tr

    rank, world, dev = _join(args, "resnet-train")
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
        _say(f"training: resnet stages={cfg.stage_sizes} "
             f"width={cfg.width} image={args.image} batch={args.batch} "
             f"rank={rank}/{world} on {name}")
        t0 = time.time()
        loss = float("nan")
        for i in range(args.steps):
            ts = time.perf_counter()
            loss = float(step(images, labels))  # reads the mean loss
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - ts) * 1000.0
            _say(json.dumps({"step": i, "ms": ms, "loss": loss,
                             "rank": rank, "world": world,
                             "allreduce_calls": step.calls_per_step}))
        dt = time.time() - t0
        _say(f"done: {args.steps} steps in {dt:.1f}s "
             f"({args.steps / dt:.2f} steps/s), final loss {loss:.4f}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
