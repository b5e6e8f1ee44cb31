"""Schemas of the port's tables, where the agents' frames and the
querier's own query traces land.

Own copy of the profile, self-telemetry and query-trace parts of
``deepflow_tpu/store/schema.py``: the same table names, columns, kinds and
defaults, so rows and queries mean the same in both packages. Times are
u64 nanoseconds.
"""

from __future__ import annotations

from deepflow_tpu_torch.store.table import ColumnSpec as C

# labels of wire.ProfileEventType, in its order: ingest stores the int
PROFILE_EVENT_TYPES = (
    "unknown", "on-cpu", "off-cpu", "mem-alloc", "tpu-device", "tpu-host")
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


# one row per (thread, folded stack) per sampler emit window
_table("profile.in_process_profile", [
    C("time", "u64"),                   # ns
    C("app_service", "str"),
    C("process_name", "str"),
    C("event_type", "enum", PROFILE_EVENT_TYPES),
    C("profiler", "str"),
    C("pid", "u32"),
    C("tid", "u32"),
    C("thread_name", "str"),
    C("stack", "str"),                  # folded stack, dictionary-encoded
    C("value", "u64"),                  # us or bytes
    C("count", "u32"),
    *UNIVERSAL_TAGS,
])

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

# the agents' self-stats: one row per (metric, value name) per emit
_table("deepflow_system.deepflow_system", [
    C("time", "u64"),
    C("metric_name", "str"),
    C("tag_json", "str"),
    C("value_name", "str"),
    C("value", "f64"),
    *UNIVERSAL_TAGS,
])

# the querier's own query traces (query/qtrace.py): one row per span
_table("deepflow_system.query_trace", [
    C("time", "u64"),               # span start, epoch ns
    C("trace_id", "str"),
    C("span_id", "str"),
    C("parent_span_id", "str"),
    C("name", "str"),               # operation: query/plan/scan/prune...
    C("service", "str"),            # deepflow-querier-<shard>
    C("duration_ns", "u64"),
    C("cpu_ns", "u64"),
    C("status", "str"),             # ok | error
    C("attr_json", "str"),          # prune counts, cache layer, degree...
    *UNIVERSAL_TAGS,
])
