"""Own copy of ``deepflow_tpu/query/tracing_adapter.py``.

Tracing adapter: federate spans from EXTERNAL tracing backends into the
trace view.

Reference analog: server/querier/app/tracing-adapter (pluggable adapters —
SkyWalking et al — that fetch a trace from a third-party APM by trace id
and splice its spans into DeepFlow's tree, so app-instrumented spans and
network/eBPF spans render as ONE trace). Embedded redesign: adapters are
HTTP fetchers for the two open formats that cover the ecosystem —
Jaeger's query API and Tempo/OTLP JSON — merged into the same TraceSpan
tree build_trace produces from flow logs.
"""

from __future__ import annotations

import json
import logging
import urllib.parse
import urllib.request

from deepflow_tpu_torch.query.tracing import TraceSpan

log = logging.getLogger("df.tracing-adapter")


def _get_json(url: str, timeout: float = 5.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


class JaegerAdapter:
    """GET {base}/api/traces/{trace_id} (Jaeger query service JSON)."""

    name = "jaeger"

    def __init__(self, base_url: str) -> None:
        self.base = base_url.rstrip("/")

    def fetch(self, trace_id: str) -> list[TraceSpan]:
        data = _get_json(
            f"{self.base}/api/traces/{urllib.parse.quote(trace_id)}")
        out: list[TraceSpan] = []
        for trace in data.get("data", []):
            procs = {pid: p.get("serviceName", "")
                     for pid, p in (trace.get("processes") or {}).items()}
            for sp in trace.get("spans", []):
                parent = ""
                for ref in sp.get("references", []):
                    if ref.get("refType") == "CHILD_OF":
                        parent = ref.get("spanID", "")
                start_us = int(sp.get("startTime", 0))
                dur_us = int(sp.get("duration", 0))
                out.append(TraceSpan(
                    span_id=sp.get("spanID", ""),
                    parent_span_id=parent,
                    name=sp.get("operationName", ""),
                    service=procs.get(sp.get("processID", ""), ""),
                    l7_protocol="app",
                    start_ns=start_us * 1000,
                    end_ns=(start_us + dur_us) * 1000,
                    status="ok",
                    response_code=0,
                    kind="external",
                    attrs={"adapter": self.name}))
        return out


class OtlpJsonAdapter:
    """GET {base}/api/traces/{trace_id} returning OTLP-JSON resourceSpans
    (Tempo-style)."""

    name = "otlp"

    def __init__(self, base_url: str) -> None:
        self.base = base_url.rstrip("/")

    def fetch(self, trace_id: str) -> list[TraceSpan]:
        data = _get_json(
            f"{self.base}/api/traces/{urllib.parse.quote(trace_id)}")
        out: list[TraceSpan] = []
        batches = data.get("resourceSpans", []) or \
            data.get("batches", [])
        for rs in batches:
            service = ""
            for attr in (rs.get("resource") or {}).get("attributes", []):
                if attr.get("key") == "service.name":
                    service = str(
                        (attr.get("value") or {}).get("stringValue", ""))
            for ss in rs.get("scopeSpans",
                             rs.get("instrumentationLibrarySpans", [])):
                for sp in ss.get("spans", []):
                    start = int(sp.get("startTimeUnixNano", 0))
                    end = int(sp.get("endTimeUnixNano", start))
                    out.append(TraceSpan(
                        span_id=sp.get("spanId", ""),
                        parent_span_id=sp.get("parentSpanId", ""),
                        name=sp.get("name", ""),
                        service=service,
                        l7_protocol="app",
                        start_ns=start,
                        end_ns=end,
                        status="ok",
                        response_code=0,
                        kind="external",
                        attrs={"adapter": self.name}))
        return out


_ADAPTERS = {"jaeger": JaegerAdapter, "otlp": OtlpJsonAdapter}


class AdapterRegistry:
    """Configured external backends, merged into build_trace output."""

    def __init__(self) -> None:
        self._adapters: list = []

    def add(self, kind: str, base_url: str) -> None:
        cls = _ADAPTERS.get(kind)
        if cls is None:
            raise ValueError(
                f"unknown adapter {kind!r}; known: {sorted(_ADAPTERS)}")
        base_url = base_url.rstrip("/")
        if not base_url.startswith(("http://", "https://")):
            raise ValueError(
                f"base_url must be an http(s) URL, got {base_url!r}")
        for a in self._adapters:  # idempotent: reconcile loops re-POST
            if a.name == kind and a.base == base_url:
                return
        self._adapters.append(cls(base_url))

    def remove(self, base_url: str) -> bool:
        base_url = base_url.rstrip("/")
        before = len(self._adapters)
        self._adapters = [a for a in self._adapters
                          if a.base != base_url]
        return len(self._adapters) != before

    def list(self) -> list[dict]:
        return [{"kind": a.name, "base_url": a.base}
                for a in self._adapters]

    def merge_into(self, tree: dict, trace_id: str) -> dict:
        """Fetch external spans and splice them into a build_trace tree
        (parent links by span id when the app propagated W3C context,
        time containment otherwise)."""
        external: list[TraceSpan] = []
        if not self._adapters:
            return tree
        # concurrent fetches: one dead backend must not serialize a 5s
        # stall per adapter into every trace query
        import concurrent.futures as _fut
        import time as _time
        with _fut.ThreadPoolExecutor(
                max_workers=min(4, len(self._adapters))) as pool:
            futs = {pool.submit(a.fetch, trace_id): a
                    for a in self._adapters}
            for f in _fut.as_completed(futs):
                a = futs[f]
                try:
                    external.extend(f.result())
                except Exception as e:
                    # visible, but throttled to one warning/min per adapter
                    now = _time.monotonic()
                    last = getattr(a, "_last_warn", 0)
                    if now - last > 60:
                        a._last_warn = now
                        log.warning("tracing adapter %s (%s) failed: %s",
                                    a.name, a.base, e)
                    else:
                        log.debug("adapter %s fetch failed: %s", a.name, e)
        if not external:
            return tree

        def index(node: dict, acc: dict) -> None:
            acc[node["span_id"]] = node
            for c in node.get("children", []):
                index(c, acc)

        by_id: dict = {}
        for root in tree.get("spans", []):
            index(root, by_id)
        ext_by_id = {s.span_id: s.to_dict() for s in external}
        placed = set()
        # parent-by-id, TOPOLOGICALLY: only attach to a parent already in
        # the tree (flow span or previously-placed external) — mutually-
        # referencing externals can't form a cycle this way; they fall
        # through to containment/root placement instead
        progress = True
        while progress:
            progress = False
            for s in external:
                if s.span_id in placed:
                    continue
                d = ext_by_id[s.span_id]
                parent = by_id.get(s.parent_span_id)
                if parent is None and s.parent_span_id in placed:
                    parent = ext_by_id.get(s.parent_span_id)
                if parent is not None and parent is not d:
                    parent.setdefault("children", []).append(d)
                    placed.add(s.span_id)
                    progress = True
        for s in external:
            if s.span_id in placed:
                continue
            best = None
            for node in by_id.values():
                if node["start_ns"] <= s.start_ns and \
                        s.end_ns <= node["end_ns"]:
                    if best is None or (node["end_ns"] - node["start_ns"]
                                        ) < (best["end_ns"]
                                             - best["start_ns"]):
                        best = node
            if best is not None:
                best.setdefault("children", []).append(ext_by_id[s.span_id])
            else:
                tree.setdefault("spans", []).append(ext_by_id[s.span_id])
            placed.add(s.span_id)
        tree["span_count"] = tree.get("span_count", 0) + len(external)
        tree["external_spans"] = len(external)
        return tree
