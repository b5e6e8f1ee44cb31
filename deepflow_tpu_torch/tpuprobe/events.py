"""Normalized device span events shared by all probe sources.

Own copy of ``deepflow_tpu/tpuprobe/events.py``: the same ``TpuSpanEvent``
fields, so one span means the same on the wire whichever package sent it.
``classify`` keeps the reference's xprof categories and op names and adds
CUDA's: NCCL kernel names and Kineto's ``gpu_memcpy`` / ``gpu_memset``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from deepflow_tpu_torch.proto import wire

# xprof hlo_category / op-name prefix -> collective name
_COLLECTIVES = {
    "all-reduce": "all-reduce",
    "all-gather": "all-gather",
    "all-to-all": "all-to-all",
    "reduce-scatter": "reduce-scatter",
    "collective-permute": "collective-permute",
    "collective": "collective",
    "send": "send",
    "recv": "recv",
    "host send": "send",
    "host recv": "recv",
}

# NCCL kernel names, e.g. "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(...)"
# or "ncclKernel_SendRecv_RING_SIMPLE_Sum_int8_t(...)"
_NCCL_RE = re.compile(r"nccl\w*?_(AllReduce|AllGather|ReduceScatter|"
                      r"Reduce|Broadcast|AllToAll|SendRecv|Send|Recv)",
                      re.IGNORECASE)
_NCCL_COLLECTIVES = {
    "allreduce": "all-reduce",
    "allgather": "all-gather",
    "reducescatter": "reduce-scatter",
    "reduce": "reduce",
    "broadcast": "broadcast",
    "alltoall": "all-to-all",
    "sendrecv": "send-recv",
    "send": "send",
    "recv": "recv",
}


def classify(category: str, name: str) -> tuple[int, str]:
    """(TpuSpanKind, collective) from a category and an op/kernel name."""
    cat = (category or "").lower()
    m = _NCCL_RE.search(name or "")
    if m:
        return wire.DEVICE_COLLECTIVE, _NCCL_COLLECTIVES[m.group(1).lower()]
    nm = (name or "").lower()
    for key, coll in _COLLECTIVES.items():
        if key in cat or nm.startswith(key.replace(" ", "-")):
            return wire.DEVICE_COLLECTIVE, coll
    if cat in ("gpu_memcpy", "gpu_memset") or "infeed" in cat or \
            "outfeed" in cat or "copy" in cat or "transfer" in cat:
        return wire.DEVICE_TRANSFER, ""
    return wire.DEVICE_COMPUTE, ""


@dataclass
class TpuSpanEvent:
    start_ns: int
    duration_ns: int
    device_id: int = 0
    chip_id: int = 0
    core_id: int = 0
    hlo_module: str = ""
    hlo_op: str = ""
    hlo_category: str = ""
    kind: int = wire.DEVICE_COMPUTE
    flops: int = 0
    bytes_accessed: int = 0
    program_id: int = 0
    run_id: int = 0
    collective: str = ""
    bytes_transferred: int = 0
    replica_group_size: int = 0   # devices per replica group (0 = all)
    step: int = 0

    def to_pb(self, pid: int = 0, process_name: str = "") -> wire.TpuSpan:
        return wire.TpuSpan(
            start_ns=max(0, self.start_ns),
            duration_ns=self.duration_ns,
            device_id=self.device_id,
            chip_id=self.chip_id,
            core_id=self.core_id,
            hlo_module=self.hlo_module,
            hlo_op=self.hlo_op,
            hlo_category=self.hlo_category,
            kind=int(self.kind),
            flops=self.flops,
            bytes_accessed=self.bytes_accessed,
            program_id=self.program_id & 0xFFFFFFFF,
            run_id=self.run_id & 0xFFFFFFFF,
            collective=self.collective,
            bytes_transferred=self.bytes_transferred,
            replica_group_size=self.replica_group_size,
            step=self.step,
            pid=pid,
            process_name=process_name)


def batch_to_pb(events: list[TpuSpanEvent], pid: int = 0,
                process_name: str = "") -> bytes:
    """Span events -> serialized TpuSpanBatch bytes."""
    return wire.TpuSpanBatch(
        spans=[ev.to_pb(pid, process_name) for ev in events]
    ).SerializeToString()
