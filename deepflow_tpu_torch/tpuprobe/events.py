"""Normalized device span events shared by all probe sources.

Own copy of ``deepflow_tpu/tpuprobe/events.py``: the same ``TpuSpanEvent``
fields, so one span means the same on the wire whichever package sent it.
``classify`` keeps the reference's xprof categories and op names and adds
CUDA's: NCCL kernel names and Kineto's ``gpu_memcpy`` / ``gpu_memset``.

``program_id`` is XLA's program id in the reference. A CUDA capture has
no programs; on an NCCL kernel's span it carries the call's ordinal in
its step on its stream (``kineto.py``), which tells apart the calls of
one step that run kernels of one name, and is 0 on every other span.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=4096)
def classify(category: str, name: str) -> tuple[int, str]:
    """(TpuSpanKind, collective) from a category and an op/kernel name.
    A capture repeats a few hundred kernel names, so answers are kept."""
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
    program_id: int = 0           # NCCL: the call's ordinal in its step
    run_id: int = 0
    collective: str = ""
    bytes_transferred: int = 0
    replica_group_size: int = 0   # devices per replica group (0 = all)
    step: int = 0


@functools.lru_cache(maxsize=8192)
def _middle_fields(device_id, chip_id, core_id, hlo_module, hlo_op,
                   hlo_category, kind, flops, bytes_accessed,
                   program_id) -> bytes:
    """TpuSpan fields 3-13: one kernel on one stream repeats them in
    every step of a capture."""
    return wire.encode_span(wire.TpuSpan(
        device_id=device_id, chip_id=chip_id, core_id=core_id,
        hlo_module=hlo_module, hlo_op=hlo_op, hlo_category=hlo_category,
        kind=int(kind), flops=flops, bytes_accessed=bytes_accessed,
        program_id=program_id & 0xFFFFFFFF))


@functools.lru_cache(maxsize=8192)
def _last_fields(run_id, collective, bytes_transferred, replica_group_size,
                 step, pid, process_name) -> bytes:
    """TpuSpan fields 14-20: the same for every op of one step."""
    return wire.encode_span(wire.TpuSpan(
        run_id=run_id & 0xFFFFFFFF, collective=collective,
        bytes_transferred=bytes_transferred,
        replica_group_size=replica_group_size, step=step, pid=pid,
        process_name=process_name))


def batch_to_pb(events: list[TpuSpanEvent], pid: int = 0,
                process_name: str = "") -> bytes:
    """Span events -> serialized TpuSpanBatch bytes, each span with the
    batch's pid and process_name, a start_ns below 0 as 0, and the low 32
    bits of program_id and run_id (the reference's ``to_pb``). No
    TpuSpan is built per event: a capture's tens of thousands of spans
    were the agent's largest CPU cost outside the held step (PERF.md,
    slice 5)."""
    out = bytearray()
    for ev in events:
        body = wire.uint_field("start_ns", 1, max(0, ev.start_ns))
        body += wire.uint_field("duration_ns", 2, ev.duration_ns)
        body += _middle_fields(
            ev.device_id, ev.chip_id, ev.core_id, ev.hlo_module, ev.hlo_op,
            ev.hlo_category, ev.kind, ev.flops, ev.bytes_accessed,
            ev.program_id)
        body += _last_fields(
            ev.run_id, ev.collective, ev.bytes_transferred,
            ev.replica_group_size, ev.step, pid, process_name)
        out += wire.span_entry(body)
    return bytes(out)
