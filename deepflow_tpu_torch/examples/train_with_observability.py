"""Train a Llama-style model on the card, a workload that knows nothing of
the agent unless asked (``--attach``).

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

Weights and tokens come from fixed seeds. Each step prints one JSON line
``{"step", "ms", "loss"}``: ``ms`` is the host time of the step, which
reads the loss and ends in ``torch.cuda.synchronize()``.
"""

import argparse
import json
import time

import torch

from deepflow_tpu_torch.models import llama as tl


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
    parser.add_argument("--preset", choices=("llama7b",), default=None,
                        help="llama7b: LlamaConfig.llama7b() widths with "
                             "--layers depth (--d-model is ignored)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

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


if __name__ == "__main__":
    main()
