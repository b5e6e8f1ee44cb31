"""Ingest-time trace-tree precompute.

Own copy of ``deepflow_tpu/server/tracetree.py``.

Reference analog: server/ingester/flow_log/dbwriter/tracetree_writer.go:74
(the aggregation window keyed by trace search-id) +
server/libs/tracetree/tracetree.go:47 (the encoded per-trace node list).

Redesign: FlowLogDecoder feeds every l7 row that carries a trace_id into a
TraceTreeBuilder. Spans accumulate in memory per trace; once a trace has
been idle for `flush_after_s` its compact span list is written as ONE row
to flow_log.trace_tree (append-only: a late straggler batch simply
produces a second row for the same trace, merged at read time). Queries
touch only that trace's rows; service-path search scans the per-trace
table, never per-span l7_flow_log.
"""

from __future__ import annotations

import json
import logging
import threading
import time

log = logging.getLogger("df.tracetree")

# span fields persisted into the encoded tree (a projection of the l7 row:
# enough to rebuild the tree + stats without going back to l7_flow_log)
SPAN_FIELDS = ("span_id", "parent_span_id", "name", "service",
               "l7_protocol", "start_ns", "end_ns", "status",
               "response_code", "ip_src", "ip_dst", "flow_id",
               "x_request_id")


def span_from_l7(row: dict) -> dict:
    """Project one decoded l7 row dict into the persisted span shape."""
    name = row.get("endpoint") or row.get("request_resource") or \
        row.get("request_type") or ""
    start = int(row.get("time", 0))
    return {
        "span_id": row.get("span_id")
        or f"flow-{row.get('flow_id', 0)}-{row.get('request_id', 0)}",
        "parent_span_id": row.get("parent_span_id", ""),
        "name": f"{row.get('request_type', '')} {name}".strip(),
        "service": row.get("app_service") or row.get("service_1")
        or row.get("host", ""),
        "l7_protocol": row.get("l7_protocol", ""),
        "start_ns": start,
        "end_ns": start + int(row.get("response_duration", 0)),
        "status": row.get("response_status", "unknown"),
        "response_code": int(row.get("response_code", 0)),
        "ip_src": row.get("ip_src", ""),
        "ip_dst": row.get("ip_dst", ""),
        "flow_id": int(row.get("flow_id", 0)),
        "x_request_id": row.get("x_request_id", ""),
    }


def service_path(spans: list[dict]) -> list[str]:
    """DFS-ordered unique service sequence (the searchable path)."""
    by_id = {s["span_id"]: s for s in spans if s["span_id"]}
    children: dict[str, list] = {}
    roots = []
    for s in sorted(spans, key=lambda x: x["start_ns"]):
        p = s.get("parent_span_id", "")
        if p and p in by_id and by_id[p] is not s:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    path: list[str] = []

    def walk(s):
        svc = s.get("service", "")
        if svc and (not path or path[-1] != svc):
            path.append(svc)
        for c in children.get(s["span_id"], []):
            walk(c)

    for r in roots:
        walk(r)
    return path


class TraceTreeBuilder:
    """Accumulates spans per trace_id; flushes idle traces to the
    flow_log.trace_tree table."""

    def __init__(self, db, flush_after_s: float = 4.0,
                 max_spans_per_trace: int = 100_000) -> None:
        self.db = db
        self.flush_after_s = flush_after_s
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._pending: dict[str, list[dict]] = {}
        self._last_seen: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"spans": 0, "traces_flushed": 0, "rows": 0,
                      "dropped_spans": 0}

    # -- ingest side ----------------------------------------------------------

    def add_span(self, trace_id: str, span: dict) -> None:
        if not trace_id:
            return
        with self._lock:
            lst = self._pending.setdefault(trace_id, [])
            if len(lst) >= self.max_spans_per_trace:
                self.stats["dropped_spans"] += 1
                return
            lst.append(span)
            self._last_seen[trace_id] = time.monotonic()
            self.stats["spans"] += 1

    def pending_spans(self, trace_id: str) -> list[dict]:
        """Spans accumulated but not yet flushed (read-time merge)."""
        with self._lock:
            return list(self._pending.get(trace_id, ()))

    def pending_summaries(self) -> list[dict]:
        """Search-shape entries for traces still buffering (so search
        sees in-flight traces without forcing a premature flush)."""
        with self._lock:
            items = [(tid, list(spans))
                     for tid, spans in self._pending.items()]
        out = []
        for tid, spans in items:
            if not spans:
                continue
            start = min(s["start_ns"] for s in spans)
            end = max(s["end_ns"] for s in spans)
            path = service_path(spans)
            out.append({
                "trace_id": tid, "time": start,
                "duration_ns": max(0, end - start),
                "span_count": len(spans),
                "root_service": path[0] if path else "",
                "services": path,
            })
        return out

    # -- flush side -----------------------------------------------------------

    def flush_idle(self, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        with self._lock:
            ripe = [tid for tid, seen in self._last_seen.items()
                    if now - seen >= self.flush_after_s]
            batches = {tid: self._pending.pop(tid) for tid in ripe}
            for tid in ripe:
                del self._last_seen[tid]
        return self._write(batches)

    def flush_all(self) -> int:
        with self._lock:
            batches = self._pending
            self._pending = {}
            self._last_seen.clear()
        return self._write(batches)

    def _write(self, batches: dict[str, list[dict]]) -> int:
        rows = []
        for tid, spans in batches.items():
            if not spans:
                continue
            start = min(s["start_ns"] for s in spans)
            end = max(s["end_ns"] for s in spans)
            path = service_path(spans)
            rows.append({
                "time": start,
                "trace_id": tid,
                "span_count": len(spans),
                "duration_ns": max(0, end - start),
                "root_service": path[0] if path else "",
                "services": json.dumps(path),
                "tree": json.dumps(spans, separators=(",", ":")),
            })
        if rows:
            self.db.table("flow_log.trace_tree").append_rows(rows)
            self.stats["traces_flushed"] += len(rows)
            self.stats["rows"] += len(rows)
        return len(rows)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "TraceTreeBuilder":
        self._thread = threading.Thread(
            target=self._run, name="df-tracetree", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3.0)
        self.flush_all()

    def _run(self) -> None:
        interval = max(0.5, self.flush_after_s / 4)
        while not self._stop.wait(interval):
            try:
                self.flush_idle()
            except Exception:
                log.exception("trace-tree flush failed")


def search(table, service_path_query: list[str] | None = None,
           root_service: str | None = None,
           time_from_ns: int = 0, time_to_ns: int = 0,
           min_duration_ns: int = 0, limit: int = 50,
           pending: list[dict] | None = None) -> list[dict]:
    """Service-path search over precomputed trace_tree rows.

    `service_path_query` matches traces whose DFS service path contains
    the given services as a contiguous subsequence (e.g. ['cart', 'db']
    finds every trace where cart called db).
    """
    import numpy as np

    want = list(service_path_query or [])
    hits: dict[str, dict] = {}
    for ch in table.snapshot():
        if not ch:
            continue
        mask = np.ones(len(ch["time"]), dtype=bool)
        if time_from_ns:
            mask &= ch["time"] >= time_from_ns
        if time_to_ns:
            mask &= ch["time"] < time_to_ns
        if min_duration_ns:
            mask &= ch["duration_ns"] >= min_duration_ns
        if root_service is not None:
            code = table.dicts["root_service"].lookup(root_service)
            mask &= (ch["root_service"] == (code if code is not None
                                            else 0xFFFFFFFF))
        for i in np.flatnonzero(mask).tolist():
            tid = table.dicts["trace_id"].decode(int(ch["trace_id"][i]))
            path = json.loads(
                table.dicts["services"].decode(int(ch["services"][i])))
            if want and not _contains_subseq(path, want):
                continue
            prev = hits.get(tid)
            entry = {
                "trace_id": tid,
                "time": int(ch["time"][i]),
                "duration_ns": int(ch["duration_ns"][i]),
                "span_count": int(ch["span_count"][i]),
                "root_service": table.dicts["root_service"].decode(
                    int(ch["root_service"][i])),
                "services": path,
            }
            if prev is None:
                hits[tid] = entry
            else:  # merge straggler rows of the same trace
                prev["span_count"] += entry["span_count"]
                lo = min(prev["time"], entry["time"])
                hi = max(prev["time"] + prev["duration_ns"],
                         entry["time"] + entry["duration_ns"])
                prev["time"], prev["duration_ns"] = lo, hi - lo
                for svc in entry["services"]:
                    if svc not in prev["services"]:
                        prev["services"].append(svc)
    for entry in pending or ():
        if time_from_ns and entry["time"] < time_from_ns:
            continue
        if time_to_ns and entry["time"] >= time_to_ns:
            continue
        if min_duration_ns and entry["duration_ns"] < min_duration_ns:
            continue
        if root_service is not None and \
                entry["root_service"] != root_service:
            continue
        if want and not _contains_subseq(entry["services"], want):
            continue
        prev = hits.get(entry["trace_id"])
        if prev is None:
            hits[entry["trace_id"]] = entry
        else:
            prev["span_count"] += entry["span_count"]
            lo = min(prev["time"], entry["time"])
            hi = max(prev["time"] + prev["duration_ns"],
                     entry["time"] + entry["duration_ns"])
            prev["time"], prev["duration_ns"] = lo, hi - lo
            for svc in entry["services"]:
                if svc not in prev["services"]:
                    prev["services"].append(svc)
    out = sorted(hits.values(), key=lambda h: -h["time"])
    return out[:limit]


def _contains_subseq(path: list[str], want: list[str]) -> bool:
    n, m = len(path), len(want)
    if m == 0:
        return True
    return any(path[i:i + m] == want for i in range(n - m + 1))
