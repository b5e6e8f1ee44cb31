"""GPU host and device topology -> PlatformData tags.

Own counterpart of ``deepflow_tpu/tpuprobe/topology.py``: the platform
data an agent uploads on every controller sync, which the controller
turns into the universal tags of the agent's rows (``host``, ``pod_*``,
``tpu_pod``, ``tpu_worker``, ``slice_id``). The host half is the
reference's (hostname, ``HOSTNAME`` as the pod name, ``POD_NAMESPACE``),
but ``host_ip`` is the caller's (the synchronizer passes its address
on the connection to the controller): the reference resolves the
hostname, a name lookup that can leave the host. The TPU fields take the
GPU job's counterparts:

- one device entry per CUDA device the process uses (the caching
  allocator holds memory on it, ``sources.workload_devices``):
  ``device_id`` is the spans' ``device_id`` (the global rank for a rank
  of a launcher's job, else the CUDA ordinal; ``tpuprobe/ranks.py``),
  ``chip_id`` the CUDA ordinal, ``core_id`` and ``slice_id`` 0,
  ``device_kind`` the device's name, ``hbm_bytes`` its ``total_memory``;
- ``accelerator_type`` is the first device's name, ``runtime_version``
  torch's version and its CUDA's, ``slice_count`` 1 once a device is
  seen;
- ``tpu_worker_id`` is the node rank the launcher set (``GROUP_RANK``,
  else ``NODE_RANK``, else "0"), ``tpu_pod_name`` the launcher's run id
  (``TORCHELASTIC_RUN_ID``) where there is one.

As the reference never starts a JAX backend in a process that has not
used one, this reads ``torch.cuda`` only when torch is already imported
and CUDA already initialised: it never loads torch (a node agent has
none) and never makes a CUDA context. Before the workload initialises
CUDA the data has no devices; the synchronizer collects it again until
it has.
"""

from __future__ import annotations

import os
import socket
import sys

from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.tpuprobe.ranks import global_rank


def _torch_cuda_up():
    """torch when the process has imported it and initialised CUDA, else
    None; asking imports nothing."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch
    except (AttributeError, RuntimeError):
        pass
    return None


def collect_platform_data(host_ip: str = "") -> wire.PlatformData:
    """Best-effort snapshot of this host and the CUDA devices in use."""
    env = os.environ
    p = wire.PlatformData(host_ip=host_ip)
    p.hostname = socket.gethostname()
    p.pod_name = env.get("HOSTNAME", "")
    p.pod_namespace = env.get("POD_NAMESPACE", "")
    p.tpu_pod_name = env.get("TORCHELASTIC_RUN_ID", "")
    p.tpu_worker_id = env.get("GROUP_RANK", env.get("NODE_RANK", "0"))
    torch = _torch_cuda_up()
    if torch is None:
        return p
    from deepflow_tpu_torch.tpuprobe.sources import workload_devices
    rank = global_rank()
    for ordinal in workload_devices():
        props = torch.cuda.get_device_properties(ordinal)
        p.devices.append(wire.TpuDeviceInfo(
            device_id=ordinal if rank is None else rank, chip_id=ordinal,
            device_kind=props.name, hbm_bytes=int(props.total_memory)))
    if p.devices:
        p.slice_count = 1
        p.accelerator_type = p.devices[0].device_kind
        p.runtime_version = f"torch {torch.__version__} cuda " \
                            f"{torch.version.cuda}"
    return p
