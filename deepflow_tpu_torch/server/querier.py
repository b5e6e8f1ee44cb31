"""Querier: the profile queries over the store, and their HTTP API.

Own copy of the TPU queries of ``deepflow_tpu/server/querier.py``
(``tpu_flame``, ``tpu_memory``, ``tpu_collectives``, ``tpu_step_trace``,
``tpu_steps``, ``tpu_step_critical_path``) and of their POST routes, with
the same request bodies and answers. The reference phrases each query in
DF-SQL; here each is the same filter, group-by and sort over the table's
columns (``query/columnar.py``). No federation.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepflow_tpu_torch.query import columnar
from deepflow_tpu_torch.query.flamegraph import build_flame_tree
from deepflow_tpu_torch.server import stephealth
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
from deepflow_tpu_torch.tpuprobe.collectives import stitch, step_trace

log = logging.getLogger("df.querier")

DEVICE_KINDS = tuple(k for k in TPU_SPAN_KINDS if k.startswith("device-"))
_STEP_COLS = ["time", "end_ns", "latency_ns", "run_id", "step", "job",
              "device_count", "device_skew_ns", "compute_ns",
              "collective_ns", "straggler_device", "straggler_lag_ns",
              "top_hlos", "host"]
_SPAN_ROW_COLS = ["time", "duration_ns", "device_id", "core_id", "hlo_op",
                  "collective", "run_id", "bytes_transferred",
                  "replica_group_size", "step", "host", "slice_id",
                  "tpu_pod"]


class QueryError(Exception):
    """A query that cannot be answered as asked (HTTP 400)."""


def _time_window(body: dict) -> list:
    """The reference's time filter: a falsy bound is no bound."""
    where = []
    if body.get("time_start"):
        where.append(("time", ">=", int(body["time_start"])))
    if body.get("time_end"):
        where.append(("time", "<", int(body["time_end"])))
    return where


class QuerierAPI:
    """Route logic, separated from the HTTP plumbing for in-process use."""

    def __init__(self, db: Database, stats_provider=None) -> None:
        self.db = db
        self.stats_provider = stats_provider or (lambda: {})

    def health(self) -> dict:
        return {
            "status": "ok",
            "tables": {name: len(self.db.table(name))
                       for name in self.db.tables()},
            "stats": self.stats_provider(),
        }

    def tpu_flame(self, body: dict) -> dict:
        """Flame view over device spans: module -> category -> op.
        Device kinds only, unless include_host."""
        where = [("duration_ns", ">", 0)]
        if not body.get("include_host"):
            where.append(("kind", "in", DEVICE_KINDS))
        where += _time_window(body)
        if body.get("device_id") is not None:
            where.append(("device_id", "=", int(body["device_id"])))
        res = columnar.group(self.db.table("profile.tpu_hlo_span"),
                             ["hlo_module", "hlo_category", "hlo_op"],
                             ["duration_ns"], where=where)
        stacks, values = [], []
        for mod, cat, op, d in res:
            stacks.append(";".join(x for x in (mod, cat or "other", op) if x))
            values.append(int(d))
        return {"result": build_flame_tree(stacks, values).to_dict()}

    def tpu_memory(self, body: dict) -> dict:
        """Memory view: per-device usage timeline, headroom summary, top
        ops by bytes accessed, and the ops that ran around the sample of
        highest pressure."""
        where = [("bytes_limit", ">", 0), *_time_window(body)]
        if body.get("device_id") is not None:
            where.append(("device_id", "=", int(body["device_id"])))
        res = columnar.select(
            self.db.table("profile.tpu_memory"),
            ["time", "device_id", "bytes_in_use", "peak_bytes_in_use",
             "bytes_limit", "largest_free_block"],
            where=where, order_by="time")
        timeline = [
            {"time": int(t), "device_id": int(d), "bytes_in_use": int(b),
             "peak_bytes_in_use": int(p), "bytes_limit": int(lim),
             "largest_free_block": int(fr)}
            for t, d, b, p, lim, fr in res]
        devices: dict[int, dict] = {}
        for s in timeline:  # time-ordered: last write wins = latest
            d = s["device_id"]
            cur = devices.setdefault(d, {"device_id": d, "peak_pct": 0.0})
            cur["bytes_in_use"] = s["bytes_in_use"]
            cur["peak_bytes_in_use"] = s["peak_bytes_in_use"]
            cur["bytes_limit"] = s["bytes_limit"]
            cur["largest_free_block"] = s["largest_free_block"]
            cur["peak_pct"] = round(
                100.0 * s["peak_bytes_in_use"] / s["bytes_limit"], 1)
            cur["headroom_bytes"] = s["bytes_limit"] - s["peak_bytes_in_use"]
        spans = self.db.table("profile.tpu_hlo_span")
        top_n = int(body.get("top", 15))
        sres = columnar.group(
            spans, ["hlo_op", "hlo_module"],
            ["bytes_accessed", "duration_ns"], count=True,
            where=[("bytes_accessed", ">", 0), *_time_window(body)],
            order_by="bytes_accessed", desc=True, limit=top_n)
        top_ops = [
            {"hlo_op": op, "hlo_module": mod, "bytes_accessed": int(b),
             "duration_ns": int(d), "count": int(n),
             "hbm_gbps": round(b / max(1, d), 2)}  # bytes/ns = GB/s
            for op, mod, b, d, n in sres]
        forensics = None
        if timeline:
            worst = max(timeline,
                        key=lambda s: s["bytes_in_use"] / s["bytes_limit"])
            w = int(body.get("forensics_window_s", 10)) * 1_000_000_000
            t0, t1 = worst["time"] - w, worst["time"] + w
            fres = columnar.group(
                spans, ["hlo_op"], ["bytes_accessed"],
                where=[("bytes_accessed", ">", 0), ("time", ">=", t0),
                       ("time", "<", t1)],
                order_by="bytes_accessed", desc=True, limit=10)
            forensics = {
                "pressure_peak": worst,
                "pressure_pct": round(
                    100.0 * worst["bytes_in_use"] / worst["bytes_limit"], 1),
                "ops_near_peak": [
                    {"hlo_op": op, "bytes_accessed": int(b)}
                    for op, b in fres],
            }
        return {"result": {
            "devices": sorted(devices.values(),
                              key=lambda d: d["device_id"]),
            "timeline": timeline[-int(body.get("limit", 2000)):],
            "top_ops": top_ops,
            "forensics": forensics,
        }}

    def tpu_collectives(self, body: dict) -> dict:
        """Collectives stitched across their participant devices."""
        rows = self._tpu_span_rows(body, collectives_only=True)
        return {"result": [g.to_dict() for g in stitch(rows)]}

    def tpu_step_trace(self, body: dict) -> dict:
        """One training step across devices: per-device span bounds,
        stitched collectives and device skew."""
        run_id = body.get("run_id")
        return {"result": step_trace(
            self._tpu_span_rows(body),
            run_id=None if run_id is None else int(run_id))}

    def _step_rollups(self, body: dict) -> list[dict]:
        """Per-host step records merged into one rollup per
        (job, run_id, step), time-ordered."""
        where = []
        if body.get("job"):
            where.append(("job", "=", str(body["job"]).replace("'", "")))
        if body.get("run_id") is not None:
            where.append(("run_id", "=", int(body["run_id"])))
        where += _time_window(body)
        res = columnar.select(self.db.table("profile.tpu_step_metrics"),
                              _STEP_COLS, where=where)
        return stephealth.merge_host_partials(
            [dict(zip(_STEP_COLS, row)) for row in res])

    def tpu_steps(self, body: dict) -> dict:
        """Per-step health timeline, each step scored by the EWMA+MAD
        regression detector."""
        scored = stephealth.score_timeline(self._step_rollups(body))
        limit = int(body.get("limit", 500))
        return {"result": {"steps": scored[-limit:],
                           "total_steps": len(scored)}}

    def tpu_step_critical_path(self, body: dict) -> dict:
        """Where one step's latency went (compute, collective wait or
        device skew) against a baseline of the healthy steps before it;
        the latest step unless step (and run_id) name one."""
        rollups = self._step_rollups(body)
        if not rollups:
            raise QueryError("no step records in window")
        want_run = body.get("run_id")
        want_step = body.get("step")
        idx = len(rollups) - 1
        if want_step is not None:
            idx = next(
                (i for i, r in enumerate(rollups)
                 if r["step"] == int(want_step)
                 and (want_run is None or r["run_id"] == int(want_run))),
                -1)
            if idx < 0:
                raise QueryError(f"step {want_step} not found in window")
        target = rollups[idx]
        # the baseline is the healthy steps BEFORE the target
        sc = stephealth.EwmaMad()
        for r in rollups[:idx]:
            if r["job"] == target["job"]:
                sc.feed(r)
        att = stephealth.attribute(target, sc.baseline())
        return {"result": {"step": target, "attribution": att}}

    def _tpu_span_rows(self, body: dict,
                       collectives_only: bool = False) -> list[dict]:
        where = [("duration_ns", ">", 0)]
        if collectives_only:
            where.append(("collective", "!=", ""))
        where += _time_window(body)
        res = columnar.select(self.db.table("profile.tpu_hlo_span"),
                              _SPAN_ROW_COLS, where=where)
        return [dict(zip(_SPAN_ROW_COLS, row)) for row in res]


class QuerierHTTP:
    """The querier's HTTP server: the profile POST routes and
    GET /v1/health."""

    def __init__(self, api: QuerierAPI, host: str = "127.0.0.1",
                 port: int = 20416) -> None:
        self.api = api
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None

    def start(self) -> "QuerierHTTP":
        api = self.api
        routes = {
            "/v1/profile/TpuFlame": api.tpu_flame,
            "/v1/profile/TpuCollectives": api.tpu_collectives,
            "/v1/profile/TpuStepTrace": api.tpu_step_trace,
            "/v1/tpu/steps": api.tpu_steps,
            "/v1/tpu/steps/critical_path": api.tpu_step_critical_path,
            "/v1/profile/TpuMemory": api.tpu_memory,
        }

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _send(self, code: int, obj: dict) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                if self.path.split("?")[0].rstrip("/") in ("/v1/health",
                                                           "/health"):
                    self._send(200, api.health())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self) -> None:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) if n else b"{}")
                    fn = routes.get(self.path.split("?")[0].rstrip("/"))
                    if fn is None:
                        self._send(404, {"error": f"no route {self.path}"})
                    else:
                        self._send(200, fn(body))
                except (QueryError, KeyError, ValueError) as e:
                    # json.JSONDecodeError is a ValueError
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    log.exception("querier 500")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        threading.Thread(target=self._httpd.serve_forever,
                         name="df-querier-http", daemon=True).start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
