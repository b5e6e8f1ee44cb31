"""Schemas of the profile tables the TPU_SPAN / STEP_METRICS ingest writes.

Own copy of the profile part of ``deepflow_tpu/store/schema.py``: the same
table names, columns, kinds and defaults, so rows and queries mean the
same in both packages. Times are u64 nanoseconds.
"""

from __future__ import annotations

from deepflow_tpu_torch.store.table import ColumnSpec as C

# labels of wire.TpuSpanKind, in its order: ingest stores int(kind)
TPU_SPAN_KINDS = (
    "unknown", "device-compute", "device-collective", "device-transfer",
    "host-runtime", "host-compile")

# Universal tags injected by the ingester on every row.
UNIVERSAL_TAGS = [
    C("org_id", "u16", default=1),  # multi-tenancy scope; 1 = default org
    C("shard_id", "u16"),           # receiving shard; 0 = standalone
    C("owner_shard", "u16"),        # replication: ring-primary owner
    C("ring_epoch", "u32"),         # 0 = single-copy row
    C("agent_id", "u16"),
    C("host_id", "u16"),
    C("host", "str"),
    C("pod_name", "str"),
    C("pod_ns", "str"),
    C("tpu_pod", "str"),            # accelerator topology tags
    C("tpu_worker", "u16"),
    C("slice_id", "u16"),
]

TABLES: dict[str, list[C]] = {}


def _table(name: str, cols: list[C]) -> None:
    TABLES[name] = cols


# one row per device span (kernel, memcpy, collective, or module)
_table("profile.tpu_hlo_span", [
    C("time", "u64"),                   # start ns
    C("duration_ns", "u64"),
    C("device_id", "u16"),
    C("chip_id", "u16"),
    C("core_id", "u16"),
    C("kind", "enum", TPU_SPAN_KINDS),
    C("hlo_module", "str"),
    C("hlo_op", "str"),
    C("hlo_category", "str"),
    C("flops", "u64"),
    C("bytes_accessed", "u64"),
    C("program_id", "u32"),
    C("run_id", "u32"),
    C("collective", "str"),
    C("bytes_transferred", "u64"),
    C("replica_group_size", "u16"),
    C("step", "u64"),
    C("pid", "u32"),
    C("process_name", "str"),
    C("app_service", "str"),
    *UNIVERSAL_TAGS,
])

# One row per (run_id, step) per reporting host: the agent's view of its
# local devices. Pod-level truth is merged at query time (stephealth.py).
_table("profile.tpu_step_metrics", [
    C("time", "u64"),                   # step start ns (min device bound)
    C("end_ns", "u64"),                 # step end ns (max device bound)
    C("latency_ns", "u64"),             # end_ns - time (this host's view)
    C("run_id", "u32"),
    C("step", "u64"),
    C("job", "str"),                    # module of the step program
    C("device_count", "u16"),
    C("device_skew_ns", "u64"),         # spread of device end times
    C("compute_ns", "u64"),             # sum of device compute self-time
    C("collective_ns", "u64"),          # sum of device collective time
    C("straggler_device", "u16"),       # latest-finishing local device
    C("straggler_lag_ns", "u64"),       # its end minus median device end
    C("top_hlos", "str"),               # json [[op, self_ns, category], ...]
    C("pid", "u32"),
    C("process_name", "str"),
    *UNIVERSAL_TAGS,
])

# per-device memory usage timeline (allocator statistics)
_table("profile.tpu_memory", [
    C("time", "u64"),                   # sample ns
    C("device_id", "u16"),
    C("bytes_in_use", "u64"),
    C("peak_bytes_in_use", "u64"),
    C("bytes_limit", "u64"),
    C("largest_free_block", "u64"),
    C("num_allocs", "u32"),
    C("pid", "u32"),
    C("process_name", "str"),
    *UNIVERSAL_TAGS,
])
