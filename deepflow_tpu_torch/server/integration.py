"""Integration ingest: telemetry a workload already emits, over HTTP.

Own copy of ``deepflow_tpu/server/integration.py``. ``IntegrationAPI``
turns each body into the reference's rows:

- OTLP/HTTP JSON traces (``POST /api/v1/otlp/traces``), Datadog's
  msgpack or JSON traces (``/v0.3/traces``, ``/v0.4/traces``, PUT too)
  and SkyWalking segments (``/v3/segments``) into
  ``flow_log.l7_flow_log``, and the rows that carry a trace id into the
  ingest-time trace trees (``server/tracetree.py``);
- folded profiles (``/api/v1/profile/ingest``) into
  ``profile.in_process_profile``;
- app logs (``/api/v1/log``) and OTLP logs (``/api/v1/otlp/logs``) into
  ``application_log.log``;
- Prometheus remote-write (``/api/v1/write``: snappy-compressed or plain
  ``WriteRequest`` protobuf) into ``prometheus.samples``, with the
  SmartEncoding ids (``server/prom_encoder.py``) and one
  ``prometheus.label_sets`` row per series first seen; the ids and the
  seen set are restored from that table on the first write after a
  restart (``seed_from_store``). Samples with a time that is no u32
  epoch second (a sender's nanoseconds) are skipped;
- Telegraf's influx lines (``/api/v1/telegraf``) into
  ``ext_metrics.metrics``, one row per numeric field.

Every table write also feeds the exporters (``server/exporters.py``),
as the decoders' writes do. A body that does not decode raises
``ValueError`` (the querier answers 400); rows carry no org, so they land
in the default org (the column's default, 1). ``stats`` counts the rows
of each kind.
"""

from __future__ import annotations

import json
import logging
import time

from deepflow_tpu_torch.proto import pbwire
from deepflow_tpu_torch.server.prom_encoder import PromEncoder
from deepflow_tpu_torch.server.tracetree import span_from_l7
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.schema import L7_PROTOS, RESPONSE_STATUS
from deepflow_tpu_torch.utils import influxline, msgpack, snappy

log = logging.getLogger("df.integration")


def _int0(v) -> int:
    """An int from a user's tag value, 0 when it is none: bad data must
    not poison the rest of the batch."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


def _status_from_http(code: int) -> int:
    # RESPONSE_STATUS: 0 unknown, 1 ok, 2 client_error, 3 server_error
    if code >= 500:
        return 3
    if code >= 400:
        return 2
    return 1 if code else 0


def _any_value_str(v) -> str:
    """OTLP AnyValue -> display string: plain scalars verbatim, structured
    bodies (kvlist, array, bytes) as JSON."""
    if not isinstance(v, dict):
        return "" if v is None else str(v)
    for key in ("stringValue", "intValue", "doubleValue", "boolValue"):
        if key in v:
            return str(v[key])
    if "kvlistValue" in v or "arrayValue" in v or "bytesValue" in v:
        return json.dumps(v, sort_keys=True)
    return ""


def _attr_map(attrs: list) -> dict:
    out = {}
    for a in attrs or []:
        v = a.get("value", {})
        out[a.get("key", "")] = (
            v.get("stringValue") or v.get("intValue")
            or v.get("doubleValue") or v.get("boolValue") or "")
    return out


class IntegrationAPI:
    def __init__(self, db: Database, exporters=None,
                 prom_encoder=None, trace_trees=None) -> None:
        self.db = db
        self.exporters = exporters
        self.trace_trees = trace_trees  # TraceTreeBuilder, or None
        # SmartEncoding: the controller's allocator (a combined server),
        # a PromEncoderClient (a remote ingest node) or a local one
        self.prom_encoder = (prom_encoder if prom_encoder is not None
                             else PromEncoder())
        self._known_set_ids: set[int] = set()
        self._seeded = False
        self.stats = {"otlp_spans": 0, "profiles": 0, "app_logs": 0,
                      "telegraf_rows": 0, "prom_samples": 0,
                      "datadog_spans": 0, "skywalking_spans": 0}

    def _write(self, table_name: str, rows: list[dict]) -> None:
        """Append, feed the exporters, and put the L7 rows that carry a
        trace id into the trace trees (with their enum codes as labels,
        as the decoders' rows have them)."""
        self.db.table(table_name).append_rows(rows)
        if self.exporters is not None and rows:
            self.exporters.feed(table_name, rows)
        if (self.trace_trees is not None
                and table_name == "flow_log.l7_flow_log"):
            for r in rows:
                tid = r.get("trace_id", "")
                if not tid:
                    continue
                d = dict(r)
                for key, labels in (("l7_protocol", L7_PROTOS),
                                    ("response_status", RESPONSE_STATUS)):
                    v = d.get(key, 0)
                    if isinstance(v, int):
                        d[key] = (labels[v] if 0 <= v < len(labels)
                                  else "unknown")
                self.trace_trees.add_span(tid, span_from_l7(d))

    # -- OTLP/HTTP JSON traces (POST /api/v1/otlp/traces) --------------------

    def ingest_otlp_traces(self, body: dict) -> dict:
        rows = []
        if not isinstance(body, dict):
            raise ValueError("OTLP body must be a JSON object")
        for rs in body.get("resourceSpans", []):
            if not isinstance(rs, dict):
                raise ValueError("resourceSpans entries must be objects")
            res_attrs = _attr_map(rs.get("resource", {}).get("attributes"))
            service = str(res_attrs.get("service.name", ""))
            for ss in rs.get("scopeSpans",
                             rs.get("instrumentationLibrarySpans", [])):
                for span in ss.get("spans", []):
                    attrs = _attr_map(span.get("attributes"))
                    start = int(span.get("startTimeUnixNano", 0))
                    end = int(span.get("endTimeUnixNano", start))
                    code = int(span.get("status", {}).get("code", 0))
                    status = {0: 0, 1: 1, 2: 3}.get(code, 0)
                    http_code = int(attrs.get("http.status_code", 0) or 0)
                    rows.append({
                        "time": start,
                        "app_service": service,
                        "l7_protocol": 3 if str(
                            attrs.get("rpc.system", "")) == "grpc" else 1,
                        "request_type": str(
                            attrs.get("http.method",
                                      attrs.get("rpc.method", ""))),
                        "endpoint": span.get("name", ""),
                        "request_resource": str(
                            attrs.get("http.target",
                                      attrs.get("url.path", ""))),
                        "request_domain": str(
                            attrs.get("http.host",
                                      attrs.get("server.address", ""))),
                        "response_status": status,
                        "response_code": http_code,
                        "response_duration": max(0, end - start),
                        "trace_id": span.get("traceId", ""),
                        "span_id": span.get("spanId", ""),
                        "parent_span_id": span.get("parentSpanId", ""),
                    })
        self._write("flow_log.l7_flow_log", rows)
        self.stats["otlp_spans"] += len(rows)
        return {"accepted_spans": len(rows)}

    # -- folded profiles (POST /api/v1/profile/ingest) -----------------------

    def ingest_profile(self, params: dict, raw: bytes) -> dict:
        """Body: folded-stack text, one 'frame;frame;leaf <value>' a line
        (Pyroscope's collapsed format)."""
        name = params.get("name", "external")
        units = params.get("units", "samples")
        now = time.time_ns()
        rows = []
        for line in raw.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line or " " not in line:
                continue
            stack, _, value = line.rpartition(" ")
            try:
                v = int(float(value))
            except ValueError:
                continue
            rows.append({
                "time": now,
                "app_service": name,
                "process_name": name,
                "event_type": 1,  # on-cpu
                "profiler": "pyroscope",
                "stack": stack,
                "value": v,
                "count": 1,
            })
        self._write("profile.in_process_profile", rows)
        self.stats["profiles"] += len(rows)
        return {"accepted_stacks": len(rows), "units": units}

    # -- Prometheus remote-write (POST /api/v1/write) ------------------------

    def ingest_prometheus(self, raw: bytes) -> dict:
        try:
            data = snappy.decompress(raw)
        except snappy.SnappyError:
            data = raw  # an uncompressed sender
        try:
            series = parse_write_request(data)
        except pbwire.WireError as e:
            raise ValueError(f"not a WriteRequest: {e}") from None
        if not self._seeded:
            self.seed_from_store()
        names = [name for name, _, _ in series]
        sets_json = [json.dumps(labels, sort_keys=True)
                     for _, labels, _ in series]
        # a series is its metric and its labels: two metrics with one
        # label set are two series, with two label_set_ids
        set_keys = [f"{n}|{ls}" for n, ls in zip(names, sets_json)]
        metric_ids, set_ids = self.prom_encoder.encode(names, set_keys)
        rows = []
        dict_rows = []
        now_s = int(time.time())
        for (name, _labels, samples), labels_json, mid, sid in zip(
                series, sets_json, metric_ids, set_ids):
            if sid not in self._known_set_ids:
                self._known_set_ids.add(sid)
                dict_rows.append({
                    "time": now_s, "label_set_id": sid, "metric_id": mid,
                    "metric_name": name, "labels_json": labels_json})
            for ts_ms, value in samples:
                ts_s = int(ts_ms // 1000)
                if not 0 <= ts_s < 2**32:
                    continue  # ns from the sender: no u32 epoch second
                rows.append({
                    "time": ts_s,
                    "metric_name": name,
                    "labels_json": labels_json,
                    "metric_id": mid,
                    "label_set_id": sid,
                    "value": value,
                })
        if dict_rows:
            self.db.table("prometheus.label_sets").append_rows(dict_rows)
        self._write("prometheus.samples", rows)
        self.stats["prom_samples"] += len(rows)
        return {"accepted_samples": len(rows), "series": len(series)}

    def seed_from_store(self) -> None:
        """Restore the encoder's ids and the seen set from the persisted
        ``prometheus.label_sets`` (idempotent; runs on the first write, so
        it sees the table a restart loaded after this object was built)."""
        self._seeded = True
        t = self.db.table("prometheus.label_sets")
        if not len(t):
            return
        cols = t.column_concat(["label_set_id", "metric_id",
                                "metric_name", "labels_json"])
        metric_ids: dict[str, int] = {}
        set_ids: dict[str, int] = {}
        for sid, mid, mn, lj in zip(cols["label_set_id"],
                                    cols["metric_id"],
                                    cols["metric_name"],
                                    cols["labels_json"]):
            name = t.dicts["metric_name"].decode(int(mn))
            labels = t.dicts["labels_json"].decode(int(lj))
            metric_ids[name] = int(mid)
            set_ids[f"{name}|{labels}"] = int(sid)
            self._known_set_ids.add(int(sid))
        seed = getattr(self.prom_encoder, "seed", None)
        if seed is not None:  # a remote node's client has nothing to seed
            seed(metric_ids, set_ids)

    # -- app logs (POST /api/v1/log) -----------------------------------------

    _SEVERITY_NUM = {"trace": 1, "debug": 5, "info": 9, "warn": 13,
                     "warning": 13, "error": 17, "fatal": 21, "crit": 21,
                     "critical": 21}

    def ingest_app_log(self, body: dict) -> dict:
        entries = body if isinstance(body, list) else [body]
        entries = [e for e in entries if isinstance(e, dict)]
        rows = []
        for e in entries:
            sev_text = str(e.get("severity", e.get("level", "")))
            sev_num = _int0(e.get("severity_number", 0)) or \
                self._SEVERITY_NUM.get(sev_text.lower(), 0)
            rows.append({
                "time": _int0(e.get("timestamp_ns") or 0) or time.time_ns(),
                "app_service": str(e.get("service", "")),
                "app_instance": str(e.get("instance", "")),
                "log_source": 1,  # app
                "severity_number": min(24, max(0, sev_num)),
                "severity_text": sev_text,
                "body": str(e.get("message", "")),
                "trace_id": str(e.get("trace_id", "")),
                "span_id": str(e.get("span_id", "")),
                "attrs": json.dumps(
                    {k: str(v) for k, v in e.items()
                     if k not in ("message", "timestamp_ns", "service",
                                  "instance", "severity", "level",
                                  "severity_number", "trace_id", "span_id")},
                    sort_keys=True),
            })
        self._write("application_log.log", rows)
        self.stats["app_logs"] += len(rows)
        return {"accepted": len(rows)}

    # -- OTLP logs (POST /api/v1/otlp/logs) ----------------------------------
    # OTLP/HTTP JSON LogsData: resourceLogs -> scopeLogs -> logRecords

    def ingest_otlp_logs(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ValueError("OTLP body must be a JSON object")
        rows = []
        for rl in body.get("resourceLogs", []):
            if not isinstance(rl, dict):
                raise ValueError("resourceLogs entries must be objects")
            res = rl.get("resource", {})
            if not isinstance(res, dict):
                raise ValueError("resource must be an object")
            res_attrs = _attr_map(res.get("attributes"))
            service = str(res_attrs.get("service.name", ""))
            instance = str(res_attrs.get("service.instance.id", ""))
            for sl in rl.get("scopeLogs", []):
                if not isinstance(sl, dict):
                    continue
                for rec in sl.get("logRecords", []):
                    if not isinstance(rec, dict):
                        continue
                    text = _any_value_str(rec.get("body", {}))
                    attrs = _attr_map(rec.get("attributes"))
                    ts = _int0(rec.get("timeUnixNano", 0)) or \
                        _int0(rec.get("observedTimeUnixNano", 0)) or \
                        time.time_ns()
                    rows.append({
                        "time": ts,
                        "app_service": service,
                        "app_instance": instance,
                        "log_source": 2,  # otlp
                        "severity_number": min(24, max(0, _int0(
                            rec.get("severityNumber", 0)))),
                        "severity_text": str(rec.get("severityText", "")),
                        "body": text,
                        "trace_id": str(rec.get("traceId", "")),
                        "span_id": str(rec.get("spanId", "")),
                        "attrs": json.dumps(
                            {k: str(v) for k, v in attrs.items()},
                            sort_keys=True),
                    })
        self._write("application_log.log", rows)
        self.stats["app_logs"] += len(rows)
        return {"accepted": len(rows)}

    # -- Telegraf (POST /api/v1/telegraf) ------------------------------------

    def ingest_telegraf(self, raw: bytes) -> dict:
        points, bad = influxline.parse_lines(raw.decode("utf-8", "replace"))
        now = time.time_ns()
        rows = []
        for p in points:
            tag_json = json.dumps(p.tags, sort_keys=True)
            ts = p.timestamp_ns or now
            for k, v in p.fields.items():
                if isinstance(v, str):  # a string field is no sample
                    continue
                rows.append({
                    "time": ts,
                    "metric_name": p.measurement,
                    "tag_json": tag_json,
                    "value_name": k,
                    "value": float(v),
                    # Telegraf's host tag is also the universal host column
                    # (PromQL's matchers prefer a real column)
                    "host": p.tags.get("host", ""),
                })
        self._write("ext_metrics.metrics", rows)
        self.stats["telegraf_rows"] += len(rows)
        return {"accepted": len(rows), "bad_lines": bad}

    # -- Datadog traces (PUT/POST /v0.3/traces, /v0.4/traces) ----------------
    # dd-trace clients ship msgpack (or JSON) bodies: a list of traces,
    # each a list of span maps

    def ingest_datadog(self, raw: bytes, content_type: str = "") -> dict:
        if "json" in content_type:
            traces = json.loads(raw.decode("utf-8", "replace") or "[]")
        else:
            traces = msgpack.unpackb(raw) if raw else []
        if not isinstance(traces, list):
            raise ValueError("datadog body must be a list of traces")
        rows = []
        for trace in traces:
            if not isinstance(trace, list):
                continue
            for span in trace:
                if not isinstance(span, dict):
                    continue
                meta = span.get("meta") or {}
                start = _int0(span.get("start", 0))
                code = _int0(meta.get("http.status_code", 0) or 0)
                err = _int0(span.get("error", 0) or 0)
                rows.append({
                    "time": start,
                    "app_service": str(span.get("service", "")),
                    "l7_protocol": 1,
                    "request_type": str(meta.get("http.method", "")),
                    "endpoint": str(span.get("name", "")),
                    "request_resource": str(span.get("resource", "")),
                    "request_domain": str(meta.get("http.host", "")),
                    "response_status": 3 if err else
                    _status_from_http(code),
                    "response_code": code,
                    "response_duration": max(0, _int0(
                        span.get("duration", 0))),
                    # dd ids are u64: 16 hex digits join the low halves of
                    # OTLP-propagated W3C ids
                    "trace_id": f"{_int0(span.get('trace_id', 0)):016x}",
                    "span_id": f"{_int0(span.get('span_id', 0)):016x}",
                    "parent_span_id":
                        f"{_int0(span.get('parent_id', 0)):016x}"
                        if span.get("parent_id") else "",
                })
        self._write("flow_log.l7_flow_log", rows)
        self.stats["datadog_spans"] += len(rows)
        return {"accepted_spans": len(rows)}

    # -- SkyWalking segments (POST /v3/segments, segment JSON) ---------------
    # the shape of skywalking-data-collect-protocol's SegmentObject

    def ingest_skywalking(self, body) -> dict:
        segments = body if isinstance(body, list) else [body]
        rows = []
        for seg in segments:
            if not isinstance(seg, dict):
                continue
            trace_id = str(seg.get("traceId", ""))
            seg_id = str(seg.get("traceSegmentId", ""))
            service = str(seg.get("service", ""))
            spans = seg.get("spans", [])
            for span in spans if isinstance(spans, list) else []:
                if not isinstance(span, dict):
                    continue
                raw_tags = span.get("tags") or []
                tags = {str(t.get("key")): str(t.get("value"))
                        for t in raw_tags if isinstance(t, dict)} \
                    if isinstance(raw_tags, list) else {}
                start_ms = _int0(span.get("startTime", 0))
                end_ms = _int0(span.get("endTime", start_ms)) or start_ms
                sid = _int0(span.get("spanId", 0))
                parent = _int0(span.get("parentSpanId", -1))
                if parent >= 0:
                    parent_span = f"{seg_id}-{parent}"
                else:  # a link to another segment through refs
                    refs = span.get("refs") or []
                    ref = refs[0] if refs and isinstance(refs[0], dict) \
                        else {}
                    ref_seg = ref.get("parentTraceSegmentId")
                    parent_span = (
                        f"{ref_seg}-{_int0(ref.get('parentSpanId', 0))}"
                        if ref_seg else "")
                code = _int0(tags.get("http.status_code",
                                      tags.get("status_code", 0)) or 0)
                rows.append({
                    "time": start_ms * 1_000_000,
                    "app_service": service,
                    "l7_protocol": 1,
                    "request_type": str(tags.get("http.method", "")),
                    "endpoint": str(span.get("operationName", "")),
                    "request_resource": str(tags.get(
                        "url", tags.get("http.url", ""))),
                    "response_status": 3 if span.get("isError") else
                    _status_from_http(code),
                    "response_code": code,
                    "response_duration": max(0, (end_ms - start_ms)
                                             * 1_000_000),
                    "trace_id": trace_id,
                    "span_id": f"{seg_id}-{sid}",
                    "parent_span_id": parent_span,
                })
        self._write("flow_log.l7_flow_log", rows)
        self.stats["skywalking_spans"] += len(rows)
        return {"accepted_spans": len(rows)}


def parse_write_request(data: bytes) -> list[tuple[str, dict, list]]:
    """A Prometheus ``WriteRequest``'s series: [(metric_name, labels,
    [(ts_ms, value), ...]), ...]; a series without a name or samples is
    left out. Raises ``pbwire.WireError`` on bytes that are no
    protobuf."""
    w = pbwire
    out = []
    for f, _, ts_buf in w.iter_fields(data):
        if f != 1 or not isinstance(ts_buf, bytes):
            continue
        labels: dict[str, str] = {}
        samples: list[tuple[int, float]] = []
        for lf, _, lv in w.iter_fields(ts_buf):
            if lf == 1 and isinstance(lv, bytes):  # Label
                ld = w.fields_dict(lv)
                labels[w.as_str(w.first(ld, 1))] = w.as_str(w.first(ld, 2))
            elif lf == 2 and isinstance(lv, bytes):  # Sample
                sd = w.fields_dict(lv)
                raw_v = w.first(sd, 1, 0)
                value = w.f64(raw_v) if isinstance(raw_v, int) else raw_v
                ts_ms = w.first(sd, 2, 0)
                if ts_ms > (1 << 62):  # no zigzag here: garbage
                    continue
                samples.append((ts_ms, value))
        name = labels.pop("__name__", "")
        if name and samples:
            out.append((name, labels, samples))
    return out
