#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases alone, for a shorter call.

    python3 chip_phases.py resnet dp parallel mp flows control storage \
        cluster readtier enrich integrations

The device phase (the card's name and power limit) first, then each named
phase (``resnet``: ResNet-50 trained with the probe in this process;
``dp``: the data-parallel example under torch.distributed.run on every
GPU, shipping into a server process; ``parallel``: chip_parallel.py's
checks on every GPU; ``mp``: the sharded Llama-7B example on every GPU,
plain and shipping into a server process; ``flows``: the flow/L7 agent
on the card's host, chip_flows.py; ``control``: the control plane with
two jobs on the card, chip_control.py; ``storage``: the durable tier,
chip_storage.py, fed the span frames of phases 2-4, which run first;
``cluster``: three servers as one replicated cluster, chip_cluster.py,
fed the same frames; ``readtier``: an ingest shard and four querier
replicas over an object store, chip_readtier.py, fed the same frames;
``enrich``: every flow row's process and pod, chip_enrich.py;
``integrations``: OTLP, remote-write, Telegraf, Datadog and SkyWalking in
through the agent's proxy, the four exporters out and the file-I/O
windows, chip_integrations.py, with phase 3's span frames replayed,
which phases 2-4 make first)
with the same checks as the smoke.
The numbers land in results/chip_phases.json; a failed check raises.
"""

import json
import os
import sys
import time

import chip_smoke as cs


def _span_sink(torch):
    """Phases 2-4 of the smoke: the model trained with the probe, and the
    sink that holds its frames."""
    from deepflow_tpu_torch.models import llama as tl
    model, tokens, _nums = cs.model_phase(torch, tl)
    train_step, _opt = tl.make_train_step(model)
    sink, probe, _training, window = cs.training_phase(
        torch, train_step, (tokens,))
    cs.frames_phase(sink, probe, window)
    return sink


def main(names: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 2
    phases = {"resnet": lambda res: cs.resnet_phase(torch),
              "dp": lambda res: cs.dp_phase(torch, res),
              "parallel": lambda res: cs.parallel_phase(torch, res),
              "mp": lambda res: cs.mp_phase(torch, res),
              "flows": lambda res: cs.flows_phase(res),
              "control": lambda res: cs.control_phase(res),
              "enrich": lambda res: cs.enrich_phase(res),
              "integrations": lambda res: cs.integrations_phase(
                  sink().frames, res),
              "storage": lambda res: cs.storage_phase(sink(), res),
              "cluster": lambda res: cs.cluster_phase(sink(), res),
              "readtier": lambda res: cs.readtier_phase(sink(), res)}
    unknown = [n for n in names if n not in phases]
    if unknown or not names:
        print(f"chip_phases: name phases among {sorted(phases)}",
              file=sys.stderr)
        return 2
    frames: list = []

    def sink():
        """Phases 2-4 once, for every phase that replays their frames."""
        if not frames:
            frames.append(_span_sink(torch))
        return frames[0]

    t0 = time.perf_counter()
    result = {"device": cs.device_phase(torch)}
    try:
        for name in names:
            result[name] = {}
            got = phases[name](result[name])
            if got is not None:
                result[name] = got
    finally:
        result["seconds"] = time.perf_counter() - t0
        os.makedirs(cs.OUT_DIR, exist_ok=True)
        with open(os.path.join(cs.OUT_DIR, "chip_phases.json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
    print(f"chip_phases: {' '.join(names)} passed in "
          f"{result['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
