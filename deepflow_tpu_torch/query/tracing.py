"""Distributed-trace assembly: l7 flow logs (+ device spans) -> trace tree.

Own copy of ``deepflow_tpu/query/tracing.py``.

Reference analog: server/querier/app/distributed_tracing (TraceMap built from
trace_tree) and the query-time stitching of SURVEY.md §3.3: spans join on
trace_id / span ids, with time containment as the fallback, and (TPU-native
twist) device HLO spans overlay onto the host span that dispatched them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from deepflow_tpu_torch.store.table import ColumnarTable


@dataclass
class TraceSpan:
    span_id: str
    parent_span_id: str
    name: str
    service: str
    l7_protocol: str
    start_ns: int
    end_ns: int
    status: str
    response_code: int
    ip_src: str = ""
    ip_dst: str = ""
    kind: str = "network"       # network | device
    attrs: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "service": self.service,
            "l7_protocol": self.l7_protocol,
            "start_ns": int(self.start_ns),
            "end_ns": int(self.end_ns),
            "duration_ns": int(self.end_ns - self.start_ns),
            "status": self.status,
            "response_code": int(self.response_code),
            "ip_src": self.ip_src,
            "ip_dst": self.ip_dst,
            "kind": self.kind,
            "attrs": self.attrs,
            "children": [c.to_dict() for c in
                         sorted(self.children, key=lambda s: s.start_ns)],
        }


def _rows(table: ColumnarTable, mask_fn) -> list[dict]:
    out = []
    for ch in table.snapshot():
        if not ch:
            continue
        n = len(next(iter(ch.values())))
        if n == 0:
            continue
        mask = mask_fn(ch)
        idx = np.flatnonzero(mask)
        for i in idx.tolist():
            row = {}
            for name, arr in ch.items():
                spec = table.columns[name]
                v = arr[i]
                if spec.kind == "str":
                    row[name] = table.dicts[name].decode(int(v))
                elif spec.kind == "enum":
                    row[name] = spec.enum_values[int(v)]
                else:
                    row[name] = int(v)
            out.append(row)
    return out


def scan_trace_spans(l7_table: ColumnarTable, trace_id: str) -> list[dict]:
    """One shard's raw span dicts for a trace, scanned from l7_flow_log.
    The dict shape feeds build_trace_from_spans, so a cluster coordinator
    can pool span dicts from every shard (spans of one trace may land on
    many shards) and assemble once — dedup is by (span_id, start_ns,
    flow_id) there."""
    tid_code = l7_table.dicts["trace_id"].lookup(trace_id)
    if tid_code is None:
        return []
    rows = _rows(l7_table, lambda ch: ch["trace_id"] == tid_code)
    spans: list[dict] = []
    for r in rows:
        name = r["endpoint"] or r["request_resource"] or r["request_type"]
        spans.append({
            "span_id": (r["span_id"]
                        or f"flow-{r['flow_id']}-{r['request_id']}"),
            "parent_span_id": r["parent_span_id"],
            "name": f"{r['request_type']} {name}".strip(),
            "service": r.get("app_service") or r.get("host", ""),
            "l7_protocol": r["l7_protocol"],
            "start_ns": r["time"],
            "end_ns": r["time"] + r["response_duration"],
            "status": r["response_status"],
            "response_code": r["response_code"],
            "ip_src": r["ip_src"], "ip_dst": r["ip_dst"],
            "flow_id": r["flow_id"],
            "x_request_id": r["x_request_id"],
        })
    return spans


def build_trace(l7_table: ColumnarTable, trace_id: str,
                tpu_table: ColumnarTable | None = None,
                max_spans: int = 1000) -> dict:
    """Assemble the trace tree for one trace_id by scanning l7_flow_log.

    This is the FALLBACK path (standalone library use, or data not yet
    precomputed); the server prefers build_trace_from_spans over the
    ingest-time flow_log.trace_tree rows."""
    spans = scan_trace_spans(l7_table, trace_id)
    if not spans:
        return {"trace_id": trace_id, "spans": [], "span_count": 0,
                "truncated": False}
    return build_trace_from_spans(trace_id, spans, tpu_table, max_spans)


def build_trace_from_spans(trace_id: str, span_dicts: list[dict],
                           tpu_table: ColumnarTable | None = None,
                           max_spans: int = 1000) -> dict:
    """Assemble from precomputed span dicts (flow_log.trace_tree rows +
    TraceTreeBuilder pending spans) — touches ONLY this trace's data.
    Reference: querier reading ingester-written trace_tree
    (libs/tracetree/tracetree.go:47)."""
    spans: list[TraceSpan] = []
    seen: set = set()
    for d in span_dicts:
        key = (d.get("span_id", ""), int(d.get("start_ns", 0)),
               int(d.get("flow_id", 0)))
        if key in seen:  # straggler rows can duplicate a span
            continue
        seen.add(key)
        # query-trace spans (kind="query") carry their own attrs dict;
        # flow spans get the classic flow identity pair
        attrs = d.get("attrs")
        if not isinstance(attrs, dict):
            attrs = {"flow_id": d.get("flow_id", 0),
                     "x_request_id": d.get("x_request_id", "")}
        spans.append(TraceSpan(
            span_id=d.get("span_id", ""),
            parent_span_id=d.get("parent_span_id", ""),
            name=d.get("name", ""),
            service=d.get("service", ""),
            l7_protocol=str(d.get("l7_protocol", "")),
            start_ns=int(d.get("start_ns", 0)),
            end_ns=int(d.get("end_ns", 0)),
            status=str(d.get("status", "unknown")),
            response_code=int(d.get("response_code", 0)),
            ip_src=d.get("ip_src", ""), ip_dst=d.get("ip_dst", ""),
            kind=str(d.get("kind", "network")),
            attrs=attrs,
        ))
    return _assemble(trace_id, spans, tpu_table, max_spans)


def _assemble(trace_id: str, spans: list[TraceSpan],
              tpu_table: ColumnarTable | None,
              max_spans: int) -> dict:
    total = len(spans)
    truncated = total > max_spans
    if truncated:
        # deterministic: keep the earliest spans, report the cut
        spans = sorted(spans, key=lambda s: s.start_ns)[:max_spans]
    spans.sort(key=lambda s: (s.start_ns, -(s.end_ns - s.start_ns)))

    # explicit parent links first
    by_id = {s.span_id: s for s in spans if s.span_id}
    roots: list[TraceSpan] = []
    unparented: list[TraceSpan] = []
    for s in spans:
        parent = by_id.get(s.parent_span_id) if s.parent_span_id else None
        if parent is not None and parent is not s:
            parent.children.append(s)
        else:
            unparented.append(s)
    # fallback: time containment (client span encloses server span)
    for s in unparented:
        best = None
        for cand in spans:
            if cand is s:
                continue
            if cand.start_ns <= s.start_ns and s.end_ns <= cand.end_ns and \
                    (cand.end_ns - cand.start_ns) > (s.end_ns - s.start_ns):
                if best is None or (cand.end_ns - cand.start_ns) < \
                        (best.end_ns - best.start_ns):
                    best = cand
        if best is not None:
            best.children.append(s)
        else:
            roots.append(s)

    # overlay TPU device spans: ONE scan over the whole trace window, each
    # device span attached to the tightest containing leaf only
    leaves = [s for s in spans if not s.children]
    if tpu_table is not None and len(tpu_table) and leaves:
        lo = min(s.start_ns for s in leaves)
        hi = max(s.end_ns for s in leaves)
        device_kinds = (1, 2, 3)  # compute/collective/transfer only

        def in_window(ch):
            t = ch["time"]
            return ((t >= lo) & (t < hi)
                    & np.isin(ch["kind"], device_kinds))

        dev_rows = _rows(tpu_table, in_window)[:50 * len(leaves)]
        for r in dev_rows:
            t = r["time"]
            best = None
            for s in leaves:
                if s.start_ns <= t < s.end_ns:
                    if best is None or (s.end_ns - s.start_ns) < \
                            (best.end_ns - best.start_ns):
                        best = s
            if best is None:
                continue
            best.children.append(TraceSpan(
                span_id=f"hlo-{r['run_id']}-{r['hlo_op']}",
                parent_span_id=best.span_id,
                name=r["hlo_op"] or r["hlo_module"],
                service=f"tpu-device-{r['device_id']}",
                l7_protocol="",
                start_ns=r["time"],
                end_ns=r["time"] + r["duration_ns"],
                status="ok",
                response_code=0,
                kind="device",
                attrs={"hlo_category": r["hlo_category"],
                       "collective": r["collective"],
                       "flops": r["flops"]},
            ))

    return {
        "trace_id": trace_id,
        "span_count": total,
        "truncated": truncated,
        "spans": [s.to_dict() for s in
                  sorted(roots, key=lambda s: s.start_ns)],
    }


def build_syscall_trace(l7_table: ColumnarTable, syscall_trace_id: int,
                        max_hops: int = 16) -> dict:
    """Trace assembly WITHOUT W3C headers: follow thread-scoped syscall
    chain ids (reference socket_trace.bpf.c:1291) hop by hop.

    An ingress request assigns a chain id T to its thread; every egress the
    thread performs before its next ingress (the downstream calls the
    request caused) carries T. So rows sharing a syscall_trace_id_request
    or _response belong to one causal chain; each hop's response-side id
    chains to the next window of work.
    """
    seen_ids: set[int] = set()
    frontier = {int(syscall_trace_id)}
    rows: dict[tuple, dict] = {}
    for _ in range(max_hops):
        frontier = {t for t in frontier if t and t not in seen_ids}
        if not frontier:
            break
        seen_ids.update(frontier)
        ids = list(frontier)

        def match(ch, ids=ids):
            import numpy as np
            m = np.isin(ch["syscall_trace_id_request"], ids)
            m |= np.isin(ch["syscall_trace_id_response"], ids)
            return m

        frontier = set()
        for r in _rows(l7_table, match):
            key = (r["flow_id"], r["time"], r["request_id"])
            if key in rows:
                continue
            rows[key] = r
            frontier.add(int(r["syscall_trace_id_request"]))
            frontier.add(int(r["syscall_trace_id_response"]))

    spans = []
    for r in rows.values():
        name = r["endpoint"] or r["request_resource"] or r["request_type"]
        spans.append(TraceSpan(
            span_id=f"flow-{r['flow_id']}-{r['time']}",
            parent_span_id="",
            name=f"{r['request_type']} {name}".strip(),
            service=r.get("app_service") or r.get("host", ""),
            l7_protocol=r["l7_protocol"],
            start_ns=r["time"],
            end_ns=r["time"] + max(r["response_duration"], 1),
            status=r["response_status"],
            response_code=r["response_code"],
            ip_src=r["ip_src"], ip_dst=r["ip_dst"],
            attrs={
                "syscall_trace_id_request":
                    int(r["syscall_trace_id_request"]),
                "syscall_trace_id_response":
                    int(r["syscall_trace_id_response"]),
            }))
    spans.sort(key=lambda s: s.start_ns)
    # parenting: a span is the child of the span whose REQUEST chain id it
    # shares and which started earlier (the ingress that caused it);
    # fallback to time containment
    roots: list[TraceSpan] = []
    for i, s in enumerate(spans):
        parent = None
        for cand in spans[:i]:
            if cand.attrs["syscall_trace_id_request"] and \
                    cand.attrs["syscall_trace_id_request"] == \
                    s.attrs["syscall_trace_id_request"]:
                parent = cand
        if parent is None:
            for cand in spans[:i]:
                if cand.start_ns <= s.start_ns and \
                        s.end_ns <= cand.end_ns:
                    parent = cand
        if parent is not None:
            parent.children.append(s)
        else:
            roots.append(s)
    return {
        "syscall_trace_id": int(syscall_trace_id),
        "span_count": len(spans),
        "spans": [s.to_dict() for s in roots],
    }
