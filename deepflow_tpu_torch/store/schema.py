"""Schemas of the port's tables, where the agents' frames and the
querier's own query traces land.

Own copy of ``deepflow_tpu/store/schema.py``: the profile, flow-log,
1 s flow-metric, self-telemetry and query-trace tables, the flow-metric
rollups (1m, 1h, 1d), ``flow_log.trace_tree``, the events
(``event.event``, where the agents' events and the resource recorder's
changes land, and ``event.file_agg``, the file-I/O minute windows), and
the integrations' tables (``application_log.log``,
``prometheus.samples`` with its ``prometheus.label_sets`` join table,
``ext_metrics.metrics``): the same table names, columns, kinds and
defaults, so rows and queries mean the same in both packages. Times are
u64 nanoseconds, but for the flow-metric and Prometheus tables' u32
epoch seconds.
"""

from __future__ import annotations

from deepflow_tpu_torch.store.table import ColumnSpec as C

L4_PROTOS = ("unknown", "tcp", "udp", "icmp")
# labels of wire.L7Protocol, in its order: ingest stores the int
L7_PROTOS = (
    "unknown", "http1", "http2", "grpc", "dns", "mysql", "redis", "kafka",
    "postgresql", "mongodb", "memcached", "mqtt", "amqp", "nats", "dubbo",
    "fastcgi", "tls", "ping", "rocketmq", "sofarpc", "zmtp",
    "openwire", "tars", "brpc", "oracle", "dameng", "iso8583", "netsign",
    "websphere_mq", "someip", "pulsar")
RESPONSE_STATUS = ("unknown", "ok", "client_error", "server_error", "timeout")
CLOSE_TYPES = ("unknown", "fin", "rst", "timeout", "forced")
TUNNEL_TYPES = ("none", "vxlan", "geneve", "erspan", "gre")
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


# Per-side resource tags (side 0 = ip_src, side 1 = ip_dst), resolved by
# IP at ingest from genesis's ResourceIndex (server/platform_info.py).
# `pod` is resolved apart: an agent's value wins over the index's.
SIDE_TAG_NAMES = ("pod", "pod_ns", "workload", "service", "node", "az",
                  "subnet")
SIDE_RESOLVE_NAMES = tuple(n for n in SIDE_TAG_NAMES if n != "pod")


def _side_tags(side: str) -> list[C]:
    return [
        C(f"pod_ns_{side}", "str"),
        C(f"workload_{side}", "str"),     # pod_group analog
        C(f"service_{side}", "str"),
        C(f"node_{side}", "str"),
        C(f"az_{side}", "str"),
        C(f"subnet_{side}", "str"),
    ]


PER_SIDE_TAGS = _side_tags("0") + _side_tags("1")

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

# -- flow logs (reference: server/ingester/flow_log/log_data) -------------
# one row per closed (or force-flushed) flow
_table("flow_log.l4_flow_log", [
    C("time", "u64"),                   # flow end ns
    C("flow_id", "u64"),
    C("ip4_src", "u32"),
    C("ip4_dst", "u32"),
    C("ip_src", "str"),                 # printable (v4/v6)
    C("ip_dst", "str"),
    C("port_src", "u16"),
    C("port_dst", "u16"),
    C("protocol", "enum", L4_PROTOS),
    C("tap_port", "u32"),
    C("start_time", "u64"),
    C("end_time", "u64"),
    C("packet_tx", "u64"),
    C("packet_rx", "u64"),
    C("byte_tx", "u64"),
    C("byte_rx", "u64"),
    C("l7_request", "u64"),
    C("l7_response", "u64"),
    C("rtt", "u32"),                    # us
    C("art", "u32"),                    # us
    C("retrans_tx", "u32"),
    C("retrans_rx", "u32"),
    C("zero_win_tx", "u32"),
    C("zero_win_rx", "u32"),
    C("close_type", "enum", CLOSE_TYPES),
    C("syn_count", "u32"),
    C("synack_count", "u32"),
    C("tunnel_type", "enum", TUNNEL_TYPES),
    C("tunnel_id", "u32"),
    C("gprocess_id_0", "u32"),
    C("gprocess_id_1", "u32"),
    C("process_kname_0", "str"),    # socket-inode scan: comm at ip:port
    C("process_kname_1", "str"),
    C("pod_0", "str"),              # resource at ip_src
    C("pod_1", "str"),              # resource at ip_dst
    *PER_SIDE_TAGS,
    *UNIVERSAL_TAGS,
])

# one row per matched request/response (or lone request or response)
_table("flow_log.l7_flow_log", [
    C("time", "u64"),                   # request start ns
    C("flow_id", "u64"),
    C("app_service", "str"),            # set for app-instrumented spans
    C("ip_src", "str"),
    C("ip_dst", "str"),
    C("port_src", "u16"),
    C("port_dst", "u16"),
    C("tunnel_type", "enum", TUNNEL_TYPES),
    C("tunnel_id", "u32"),
    C("l7_protocol", "enum", L7_PROTOS),
    C("version", "str"),
    C("request_type", "str"),
    C("request_domain", "str"),
    C("request_resource", "str"),
    C("endpoint", "str"),
    C("request_id", "u32"),
    C("response_status", "enum", RESPONSE_STATUS),
    C("response_code", "i32"),
    C("response_exception", "str"),
    C("response_result", "str"),
    C("response_duration", "u64"),      # ns
    C("trace_id", "str"),
    C("span_id", "str"),
    C("parent_span_id", "str"),
    C("x_request_id", "str"),
    C("syscall_trace_id_request", "u64"),
    C("syscall_trace_id_response", "u64"),
    C("syscall_thread_0", "u32"),
    C("syscall_thread_1", "u32"),
    C("pod_0", "str"),
    C("pod_1", "str"),
    *PER_SIDE_TAGS,
    C("captured_request_byte", "u64"),
    C("captured_response_byte", "u64"),
    C("gprocess_id_0", "u32"),
    C("gprocess_id_1", "u32"),
    C("process_kname_0", "str"),
    C("process_kname_1", "str"),
    C("attrs", "str"),                  # json: parser extras (sql, alpn...)
    *UNIVERSAL_TAGS,
])

# precomputed trace trees: one row per (trace_id, flush window), written
# at ingest by the TraceTreeBuilder (server/tracetree.py), so trace
# assembly touches only that trace's rows and service-path search never
# scans l7_flow_log
_table("flow_log.trace_tree", [
    C("time", "u64"),                   # earliest span start ns
    C("trace_id", "str"),
    C("span_count", "u32"),
    C("duration_ns", "u64"),
    C("root_service", "str"),
    C("services", "str"),               # json: DFS-ordered service path
    C("tree", "str"),                   # json: encoded span list
])

# -- flow metrics, 1 s and the rollups (reference: server/libs/flow-metrics)
_NETWORK_COLS = [
    C("time", "u32"),                   # epoch seconds
    C("ip_src", "str"),
    C("ip_dst", "str"),
    C("server_port", "u16"),
    C("protocol", "enum", L4_PROTOS),
    C("direction", "u8"),
    C("packet_tx", "u64"),
    C("packet_rx", "u64"),
    C("byte_tx", "u64"),
    C("byte_rx", "u64"),
    C("flow_count", "u64"),
    C("new_flow", "u64"),
    C("closed_flow", "u64"),
    C("rtt_sum", "u64"),                # us
    C("rtt_count", "u64"),
    C("retrans", "u64"),
    C("syn_count", "u64"),
    C("synack_count", "u64"),
    C("pod_0", "str"),
    C("pod_1", "str"),
    *PER_SIDE_TAGS,
    *UNIVERSAL_TAGS,
]
for _sfx in ("1s", "1m", "1h", "1d"):
    _table(f"flow_metrics.network.{_sfx}", list(_NETWORK_COLS))

_APP_COLS = [
    C("time", "u32"),
    C("ip_src", "str"),
    C("ip_dst", "str"),
    C("server_port", "u16"),
    C("l7_protocol", "enum", L7_PROTOS),
    C("app_service", "str"),
    C("request", "u64"),
    C("response", "u64"),
    C("rrt_sum", "u64"),                # us
    C("rrt_count", "u64"),
    C("rrt_max", "u64"),
    C("error_client", "u64"),
    C("error_server", "u64"),
    C("timeout", "u64"),
    C("pod_0", "str"),
    C("pod_1", "str"),
    *PER_SIDE_TAGS,
    *UNIVERSAL_TAGS,
]
_table("flow_metrics.application.1s", list(_APP_COLS))
# the rollup tiers also carry a mergeable latency-distribution state
# (query/sketch.py, JSON) built from the raw rrt_max values: PERCENTILE()
# over a long range answers from it within the sketch's error bound
for _sfx in ("1m", "1h", "1d"):
    _table(f"flow_metrics.application.{_sfx}",
           list(_APP_COLS) + [C("rrt_max_sketch", "str")])

# the resource recorder's change events (server/recorder.py): one row per
# added, modified or deleted resource
_table("event.event", [
    C("time", "u64"),
    C("event_type", "str"),
    C("resource_type", "str"),
    C("resource_name", "str"),
    C("pid", "u32"),
    C("description", "str"),
    C("attrs", "str"),                  # json
    *UNIVERSAL_TAGS,
])

# windowed file-I/O aggregation (server/decoders.py EventDecoder): per
# (pid, path, op) minute windows of the raw file-io events
_table("event.file_agg", [
    C("time", "u64"),                   # window start ns
    C("pid", "u32"),
    C("path", "str"),
    C("op", "enum", ["read", "write"]),
    C("count", "u64"),
    C("bytes", "u64"),
    C("max_latency_ns", "u64"),
    C("sum_latency_ns", "u64"),
    *UNIVERSAL_TAGS,
])

# application logs (server/integration.py): the whole body, OTLP severity,
# and trace_id / span_id, so a log line joins its trace
_table("application_log.log", [
    C("time", "u64"),                   # ns
    C("app_service", "str"),
    C("app_instance", "str"),
    C("log_source", "enum",
      ("unknown", "app", "otlp", "syslog", "agent")),
    C("severity_number", "u8"),         # OTLP severity 1-24 (0 unknown)
    C("severity_text", "str"),
    C("body", "str"),                   # the full line, never truncated
    C("trace_id", "str"),
    C("span_id", "str"),
    C("attrs", "str"),                  # json
    *UNIVERSAL_TAGS,
])

# Prometheus remote-write samples; a series' label set is one canonical
# JSON string, with the cluster-wide SmartEncoding ids beside it
_table("prometheus.samples", [
    C("time", "u32"),                   # epoch s (remote-write ms / 1000)
    C("metric_name", "str"),
    C("labels_json", "str"),
    C("metric_id", "u32"),
    C("label_set_id", "u32"),
    C("value", "f64"),
    *UNIVERSAL_TAGS,
])

# the id -> label-set join table
_table("prometheus.label_sets", [
    C("time", "u32"),                   # first seen, epoch s
    C("label_set_id", "u32"),
    C("metric_id", "u32"),
    C("metric_name", "str"),
    C("labels_json", "str"),
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

# Telegraf's influx lines: the shape of deepflow_system, so PromQL serves
# both (metric ext_metrics_<measurement>_<field>)
_table("ext_metrics.metrics", [
    C("time", "u64"),
    C("metric_name", "str"),            # measurement
    C("tag_json", "str"),
    C("value_name", "str"),             # field key
    C("value", "f64"),
    *UNIVERSAL_TAGS,
])
