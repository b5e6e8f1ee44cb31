"""A seeded corpus of the telemetry workloads post to the integration
routes, for the integration tests and the smoke's ``integrations`` phase.

``corpus(seed, base_ns)`` gives the posts (path, body, content type,
method, query) of every route the agent's proxy forwards: OTLP/JSON
traces with W3C ids (traces of four spans, each span the child of the
one before), OTLP logs and app logs that carry those ids, a
snappy-compressed remote-write ``WriteRequest`` built with the port's
``promwire``, Telegraf lines (string fields among them, which carry no
sample), Datadog msgpack traces, SkyWalking segments and one folded
profile; and what they must make: the rows each table gains, a
remote-write series and an ``ext_metrics`` series with their last
values, and a trace id with its spans. Times are ``base_ns`` plus
offsets of whole milliseconds; the same seed and base give the same
bytes.
"""

import json

import numpy as np

from deepflow_tpu_torch.utils import msgpack, promwire, snappy

SERVICES = ("checkout", "cart", "payments", "search")
SPANS_PER_TRACE = 4


def _hex(rng, n: int) -> str:
    return "".join(f"{int(b):02x}" for b in rng.integers(0, 256, n // 2))


def _attr(key: str, value) -> dict:
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def corpus(seed: int = 0, base_ns: int = 1_700_000_000_000_000_000,
           traces: int = 8, log_lines: int = 12, series: int = 6,
           samples: int = 5, telegraf_points: int = 10,
           dd_traces: int = 4, sw_segments: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    base_ms = base_ns // 1_000_000
    posts = []
    counts = {"flow_log.l7_flow_log": 0, "application_log.log": 0,
              "prometheus.samples": 0, "ext_metrics.metrics": 0,
              "profile.in_process_profile": 0}

    # OTLP traces: each trace one service's four nested spans
    trace_ids = []
    resource_spans = []
    for t in range(traces):
        tid = _hex(rng, 32)
        trace_ids.append(tid)
        service = SERVICES[t % len(SERVICES)]
        spans = []
        parent = ""
        for s in range(SPANS_PER_TRACE):
            sid = _hex(rng, 16)
            start = base_ns + (t * 100 + s) * 1_000_000
            grpc = s == SPANS_PER_TRACE - 1
            attrs = ([_attr("rpc.system", "grpc"),
                      _attr("rpc.method", "Charge")] if grpc else
                     [_attr("http.method", "GET"),
                      _attr("http.target", f"/api/{service}/{s}"),
                      _attr("http.host", f"{service}.svc"),
                      _attr("http.status_code",
                            int(rng.choice([200, 200, 404, 503])))])
            spans.append({
                "traceId": tid, "spanId": sid, "parentSpanId": parent,
                "name": f"{service}.op{s}",
                "startTimeUnixNano": str(start),
                "endTimeUnixNano": str(start + int(rng.integers(1, 900))
                                       * 1000),
                "attributes": attrs,
                "status": {"code": int(rng.choice([0, 1, 2]))}})
            parent = sid
        resource_spans.append({
            "resource": {"attributes": [_attr("service.name", service)]},
            "scopeSpans": [{"spans": spans}]})
    posts.append(("/api/v1/otlp/traces",
                  json.dumps({"resourceSpans": resource_spans}).encode(),
                  "application/json", "POST", ""))
    counts["flow_log.l7_flow_log"] += traces * SPANS_PER_TRACE

    # OTLP logs and app logs, joined to the traces by their ids
    records = []
    for i in range(log_lines):
        records.append({
            "timeUnixNano": str(base_ns + i * 1_000_000),
            "severityNumber": int(rng.choice([5, 9, 13, 17])),
            "severityText": str(rng.choice(["DEBUG", "INFO", "WARN"])),
            "body": ({"stringValue": f"otlp line {i}"} if i % 3 else
                     {"kvlistValue": {"values": [_attr("k", i)]}}),
            "traceId": trace_ids[i % traces], "spanId": _hex(rng, 16),
            "attributes": [_attr("thread", f"t{i % 2}")]})
    posts.append(("/api/v1/otlp/logs", json.dumps({"resourceLogs": [{
        "resource": {"attributes": [_attr("service.name", "trainer"),
                                    _attr("service.instance.id", "r0")]},
        "scopeLogs": [{"logRecords": records}]}]}).encode(),
        "application/json", "POST", ""))
    app_logs = [{"timestamp_ns": base_ns + i * 2_000_000,
                 "service": "trainer", "instance": "r1",
                 "severity": str(rng.choice(["info", "error", "warning"])),
                 "message": f"app line {i}", "trace_id": trace_ids[i % traces],
                 "step": str(i)} for i in range(log_lines)]
    posts.append(("/api/v1/log", json.dumps(app_logs).encode(),
                  "application/json", "POST", ""))
    counts["application_log.log"] += 2 * log_lines

    # remote-write: series of a gauge, with a value each sample
    rw = []
    last = {}
    for s in range(series):
        labels = {"job": "trainer", "rank": str(s % 2), "gpu": str(s)}
        vals = [(base_ms + k * 1000, float(rng.normal() * 100))
                for k in range(samples)]
        rw.append(("train_gpu_util", labels, vals))
        last[s] = vals[-1][1]
    posts.append(("/api/v1/write",
                  snappy.compress(promwire.write_request(rw)),
                  "application/x-protobuf", "POST", ""))
    counts["prometheus.samples"] += series * samples

    # Telegraf: two numeric fields and a string field a point
    lines = []
    for p in range(telegraf_points):
        ts = base_ns + p * 1_000_000_000
        lines.append(f"gpu_host,host=node{p % 2} temp_c={40 + p}i,"
                     f"load={float(rng.random()):.6f},note=\"ok {p}\" {ts}")
    posts.append(("/api/v1/telegraf", "\n".join(lines).encode(),
                  "text/plain", "POST", ""))
    counts["ext_metrics.metrics"] += 2 * telegraf_points

    # Datadog msgpack traces (PUT, as dd-trace sends them)
    dd = []
    for t in range(dd_traces):
        tid = int(rng.integers(1, 2**62))
        trace, parent = [], 0
        for s in range(3):
            sid = int(rng.integers(1, 2**62))
            trace.append({
                "trace_id": tid, "span_id": sid, "parent_id": parent,
                "service": "dd-web", "name": "web.request",
                "resource": f"GET /dd/{s}",
                "start": base_ns + (t * 10 + s) * 1_000_000,
                "duration": int(rng.integers(1000, 10**6)),
                "error": int(s == 2 and t % 2),
                "meta": {"http.method": "GET",
                         "http.status_code": str(200 + 100 * (s % 3))}})
            parent = sid
        dd.append(trace)
    posts.append(("/v0.4/traces", msgpack.packb(dd),
                  "application/msgpack", "PUT", ""))
    counts["flow_log.l7_flow_log"] += 3 * dd_traces

    # SkyWalking segments: an entry span and two children, the second
    # segment linked to the first by a ref
    segs = []
    for g in range(sw_segments):
        seg_id = f"seg{seed}-{g}"
        spans = [{"spanId": k, "parentSpanId": k - 1,
                  "operationName": f"/sw/{g}/{k}",
                  "startTime": base_ms + g * 10 + k,
                  "endTime": base_ms + g * 10 + k + 3,
                  "isError": k == 2 and g == 1,
                  "tags": [{"key": "http.method", "value": "POST"},
                           {"key": "status_code", "value": "200"},
                           {"key": "url", "value": f"/sw/{g}/{k}"}]}
                 for k in range(3)]
        if g:
            spans[0]["refs"] = [{"parentTraceSegmentId": f"seg{seed}-0",
                                 "parentSpanId": 1}]
        segs.append({"traceId": f"sw-trace-{seed}",
                     "traceSegmentId": seg_id, "service": "sw-api",
                     "spans": spans})
    posts.append(("/v3/segments", json.dumps(segs).encode(),
                  "application/json", "POST", ""))
    counts["flow_log.l7_flow_log"] += 3 * sw_segments

    # one folded profile
    stacks = [f"main;train;step{k};kernel_{k % 3} {int(rng.integers(1, 500))}"
              for k in range(6)]
    posts.append(("/api/v1/profile/ingest", "\n".join(stacks).encode(),
                  "text/plain", "POST", "name=sidecar&units=samples"))
    counts["profile.in_process_profile"] += len(stacks)

    return {"posts": posts, "counts": counts,
            "trace_id": trace_ids[0], "trace_spans": SPANS_PER_TRACE,
            "remote_write": ("train_gpu_util", {"gpu": "0"}, last[0]),
            "telegraf": ("ext_metrics_gpu_host_temp_c", {"host": "node1"},
                         float(40 + telegraf_points - 1)),
            "base_ns": base_ns}
