"""Which rank of a distributed job this process is.

A launcher (``torchrun``, ``python -m torch.distributed.run``, or any that
follows its convention) starts one process per GPU and tells each its
global ``RANK``, the ``WORLD_SIZE`` and its ``LOCAL_RANK`` on the node.
The probe and the agent read them here:

- a span's ``device_id`` is the process's global rank, read from the
  default process group once the workload has set one up, else from the
  launcher's ``RANK``. That is what JAX's global ``device.id`` is on a
  multi-host job, so collectives stitch across ranks by it even when a
  launcher gives each rank one visible GPU (every local ordinal 0). A lone
  process has no rank and keeps the CUDA ordinal, so the devices of a
  one-process multi-GPU job stay apart;
- the agent's id without a controller is ``agent_id_for_rank``: distinct
  for the ranks of one job, the same for a rank that restarts, never 0 (a
  lone process's default), within the frame header's u16. Two jobs that
  ship into one server collide on it (both rank 0s are agent 1), so with a
  controller the controller assigns the id, keyed by
  ``launcher_identity``: the job (the launcher's run id, else its
  rendezvous address, else the launcher's pid) and the global rank.
"""

from __future__ import annotations

import os
import sys

MAX_AGENT_ID = 0xFFFF  # the frame header's agent_id is a u16


def launcher_env() -> tuple[int, int, int] | None:
    """(rank, world_size, local_rank) as a launcher set them, or None
    outside a launcher (or when they do not parse)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    try:
        rank = int(env["RANK"])
        world = int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
    except ValueError:
        return None
    if rank < 0 or world < 1 or rank >= world:
        return None
    return rank, world, local


def _default_group():
    """torch.distributed when the workload has initialised its default
    process group, else None. A process that has not imported torch has
    none, and asking loads no torch (a node agent never does)."""
    if "torch" not in sys.modules:
        return None
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist
    except (ImportError, RuntimeError):
        pass
    return None


def global_rank() -> int | None:
    """The process's rank in the default process group once the workload
    has initialised one, else the launcher's RANK, else None."""
    dist = _default_group()
    if dist is not None:
        return int(dist.get_rank())
    env = launcher_env()
    return None if env is None else env[0]


def world_size() -> int:
    """The default process group's size once initialised, else the
    launcher's WORLD_SIZE, else 1."""
    dist = _default_group()
    if dist is not None:
        return int(dist.get_world_size())
    env = launcher_env()
    return 1 if env is None else env[1]


def agent_id_for_rank(rank: int) -> int:
    """A nonzero u16 agent id for a global rank: rank + 1, wrapping past
    65,535 ranks."""
    return 1 + int(rank) % MAX_AGENT_ID


def launcher_agent_id() -> int | None:
    """The agent id of a process a launcher started, or None outside
    one."""
    env = launcher_env()
    return None if env is None else agent_id_for_rank(env[0])


def launcher_identity() -> str:
    """"<job>/<rank>" for a process a launcher started, "" outside one.
    The job is TORCHELASTIC_RUN_ID (torchrun sets it, the same across a
    rank's restarts), else MASTER_ADDR:MASTER_PORT, else the launcher's
    pid: the same for every rank of one job, different for two jobs on
    one host."""
    env = launcher_env()
    if env is None:
        return ""
    e = os.environ
    job = e.get("TORCHELASTIC_RUN_ID") or (
        f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}"
        if e.get("MASTER_ADDR") and e.get("MASTER_PORT")
        else f"ppid{os.getppid()}")
    return f"{job}/{env[0]}"
