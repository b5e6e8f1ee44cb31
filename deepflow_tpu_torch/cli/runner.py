"""deepflow-run for the PyTorch port: profile a script with no change to
its code.

    python -m deepflow_tpu_torch.cli.runner [-f CONFIG.yaml] [--server H:P]
        [--service NAME] [--device cuda|cpu] [--agent-id N]
        [--controller H:P] [--group G] [-m] target [args...]

    # one agent per rank of a data-parallel job:
    torchrun --nproc-per-node N -m deepflow_tpu_torch.cli.runner \
        --server H:P -m deepflow_tpu_torch.examples.train_with_observability \
        --preset resnet50

Attaches the in-process agent (OnCPU sampler, device probe, self-stats,
durable sender), then runs the target with ``runpy`` as a script path or,
with ``-m``, as a module, and detaches when it ends. The runner itself
never touches the device: the probe waits until the workload has
initialised CUDA. Without CUDA it exits with status 2 unless ``--device
cpu`` is given. Under a launcher each rank's agent takes its rank's own
agent id (``agent/config.py``) unless ``--agent-id`` names one. With
``--controller`` the agent registers with the controller before the
target starts (a bounded first sync; reference: runner.py:23, :83), ships
under the id it assigns, uploads its platform data and NTP offset, and
takes its ``--group``'s config by poll and push. ``-f`` reads the
agent's config file (``agent/config.py``; the flags win), so a file
with ``integration: {enabled: true, port: P}`` runs the node-local
integration listener beside the job, where its sidecars post to
``localhost:P``.
"""

from __future__ import annotations

import argparse
import runpy
import sys

from deepflow_tpu_torch.agent.agent import attach, detach
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.device import resolve_device


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="deepflow-run")
    parser.add_argument("-f", "--config", default=None,
                        help="agent config YAML (the flags below win)")
    parser.add_argument("--server", default=None,
                        help="host:port of the ingester (default: the "
                             "config file's, else 127.0.0.1:20033)")
    parser.add_argument("--service", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the workload "
                             "runs; the device probe needs cuda")
    parser.add_argument("--agent-id", type=int, default=None,
                        help="the agent's id (default: 0, or under a "
                             "launcher the rank's own nonzero id)")
    parser.add_argument("--controller", default=None,
                        help="host:port of the controller's sync port: "
                             "controller-assigned id, platform tags, "
                             "pushed config")
    parser.add_argument("--group", default=None,
                        help="agent group (the controller's config and "
                             "org for it)")
    parser.add_argument("-m", dest="module", action="store_true",
                        help="run target as a module (python -m style)")
    parser.add_argument("target")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    opts = parser.parse_args(argv)
    try:
        resolve_device(opts.device)  # asks is_available(), no context
    except RuntimeError as e:
        print(f"deepflow-run: {e}", file=sys.stderr)
        return 2

    config = (AgentConfig.load(opts.config) if opts.config is not None
              else None)
    # the flags given win over the file's fields
    given = {k: v for k, v in (("agent_id", opts.agent_id),
                               ("controller", opts.controller),
                               ("group", opts.group)) if v is not None}
    server = opts.server or (None if config else "127.0.0.1:20033")
    attach(app_service=opts.service or opts.target,
           servers=[server] if server else None, device=opts.device,
           config=config, **given)
    sys.argv = [opts.target] + opts.args
    try:
        if opts.module:
            runpy.run_module(opts.target, run_name="__main__",
                             alter_sys=True)
        else:
            runpy.run_path(opts.target, run_name="__main__")
        return 0
    finally:
        detach()


if __name__ == "__main__":
    sys.exit(main())
