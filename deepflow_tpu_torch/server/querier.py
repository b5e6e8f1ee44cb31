"""Querier: DF-SQL and the profile queries over the store, and their
HTTP API.

Own copy of the local path of ``deepflow_tpu/server/querier.py``:
``POST /v1/query`` runs one DF-SQL statement (``query/sql.py``,
``query/engine.py``), with SHOW answered from the catalog
(``query/catalog.py``), the table resolved as the reference resolves it
(db prefix included) and ``org_id`` scoping; the TPU queries
(``tpu_flame``, ``tpu_memory``, ``tpu_collectives``, ``tpu_step_trace``,
``tpu_steps``, ``tpu_step_critical_path``) build the reference's SQL
text and run it through the engine; ``profile_tracing`` folds the CPU
flame graph (``query/flamegraph.py``). Each has its POST route, with the
reference's request bodies and answers. A SELECT runs under a query
trace (``query/qtrace.py``: parse, plan and execute spans, written into
``deepflow_system.query_trace``) through the result and bucket-partial
cache (``query/cache.py``); ``EXPLAIN`` answers with the plan,
``EXPLAIN ANALYZE`` runs the query under a captured trace and answers
with its stages. No federation and no rollup datasource. ``GET
/v1/health`` carries the cache's, the scan pool's and the tracer's stats
(``query_cache``, ``query``, ``query_trace``), the server's own
self-telemetry (``selfmon``, ``stages``, ``pipeline``,
``ledger_imbalance``, ``wedges``) and the agents', read back from
``deepflow_system`` (``agents_selfmon``); a current wedge makes its
``status`` ``degraded`` with the ``wedged_stages``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepflow_tpu_torch.query import catalog, engine, qtrace
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.query.cache import QueryCache
from deepflow_tpu_torch.query.costmodel import KernelCostModel
from deepflow_tpu_torch.query.engine import QueryError
from deepflow_tpu_torch.query.flamegraph import (
    build_flame_tree, profile_flame_tree)
from deepflow_tpu_torch.server import stephealth
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
from deepflow_tpu_torch.telemetry import Telemetry, collect_agent_selfmon
from deepflow_tpu_torch.tpuprobe.collectives import stitch, step_trace

log = logging.getLogger("df.querier")

_STEP_COLS = ("time, end_ns, latency_ns, run_id, step, job, "
              "device_count, device_skew_ns, compute_ns, "
              "collective_ns, straggler_device, straggler_lag_ns, "
              "top_hlos, host")


def _time_window(body: dict) -> list[str]:
    """The reference's time filter: a falsy bound is no bound."""
    where = []
    if body.get("time_start"):
        where.append(f"time >= {int(body['time_start'])}")
    if body.get("time_end"):
        where.append(f"time < {int(body['time_end'])}")
    return where


class QuerierAPI:
    """Route logic, separated from the HTTP plumbing for in-process use."""

    def __init__(self, db: Database, stats_provider=None,
                 telemetry: Telemetry | None = None) -> None:
        self.db = db
        self.stats_provider = stats_provider or (lambda: {})
        self.telemetry = telemetry
        # result + partial-aggregate cache behind POST /v1/query
        self.query_cache = QueryCache(telemetry=telemetry)
        # dogfooded query tracing: every served query writes its span
        # tree into deepflow_system.query_trace through this tracer
        self.qtracer = qtrace.QueryTracer(
            telemetry, service=f"deepflow-querier-{db.shard_id}",
            sink=self._qtrace_sink)
        # per-stage costs observed by EXPLAIN ANALYZE runs feed the same
        # EWMA cost-model machinery the kernel and degree choosers use
        self.stage_cost = KernelCostModel(("plan", "execute"))

    def _qtrace_sink(self, spans: list[dict]) -> None:
        self.db.table("deepflow_system.query_trace") \
            .append_rows(qtrace.rows_from_spans(spans))

    def health(self) -> dict:
        out = {
            "status": "ok",
            "tables": {name: len(self.db.table(name))
                       for name in self.db.tables()},
            "stats": self.stats_provider(),
        }
        out["query_cache"] = self.query_cache.snapshot()
        pool_stats = qpool.stats()
        out["query"] = {
            **engine.scan_stats(),  # the reference's pruning counters
            "pool_busy": pool_stats["busy"],
            "pool_threads": pool_stats["threads"],
            "pool_dispatched": pool_stats["dispatched"],
            "degree": engine._DEGREE.snapshot(),
        }
        # span counters + the query.trace hop ledger (emitted ==
        # delivered + dropped + pending, as for every frame hop)
        out["query_trace"] = self.qtracer.snapshot()
        wedged_stages: list[str] = []
        if self.telemetry is not None:
            selfmon = self.telemetry.snapshot()
            out["selfmon"] = selfmon
            out["stages"] = selfmon["stages"]
            out["pipeline"] = selfmon["pipeline"]
            out["ledger_imbalance"] = selfmon["ledger_imbalance"]
            out["wedges"] = selfmon["wedges"]
            wedged_stages += [w["stage"] for w in selfmon["wedges"]]
        agents = collect_agent_selfmon(self.db)
        if agents["pipeline"] or agents["heartbeats"] or agents["wedges"]:
            out["agents_selfmon"] = agents
        # an agent's wedge degrades health only while it is current (its
        # latest heartbeat row still says wedged): a recovered stage's
        # verdict rows stay in the table
        live = {s["stage"] for s in agents["heartbeats"].values()
                if s.get("wedged")}
        for w in agents["wedges"]:
            if w["stage"] in live or not agents["heartbeats"]:
                wedged_stages.append("agent:" + w["stage"])
        if wedged_stages:
            out["status"] = "degraded"
            out["wedged_stages"] = sorted(set(wedged_stages))
        return out

    def _resolve_table(self, table_name: str, db_name: str = ""):
        # resolution order: as-given, db-prefixed, then with the default
        # interval suffix (flow_metrics tables are <name>.<interval>)
        candidates = [table_name, f"{table_name}.1s"]
        if db_name:
            candidates = [f"{db_name}.{table_name}",
                          f"{db_name}.{table_name}.1s"] + candidates
        for cand in candidates:
            try:
                return self.db.table(cand)
            except KeyError:
                continue
        raise QueryError(
            f"no such table {table_name!r}; known: {self.db.tables()}")

    @staticmethod
    def _org_scope(select: S.Select, table, org) -> None:
        if "org_id" not in table.columns:
            # silently dropping the filter would hand one tenant
            # another tenant's rows — refuse instead
            raise QueryError(
                f"table {table.name!r} has no org scoping; "
                "query it without org_id")
        # cooperative VIEW filter, not a security boundary: the caller
        # names the org it wants and nothing verifies it may. ANDed into
        # the parsed AST rather than the SQL text so the filter can't be
        # quoted away.
        cond = S.BinOp("=", S.Col("org_id"), S.Lit(int(org)))
        select.where = (cond if select.where is None
                        else S.BinOp("AND", select.where, cond))

    def query(self, body: dict) -> dict:
        """One DF-SQL statement: body {"sql", "db", "org_id"}; the answer
        {"result": {"columns", "values"}, "debug": {"table"}}, for SHOW
        the catalog's table with {"debug": {"show"}}, and for EXPLAIN
        [ANALYZE] the plan and stages (``_explain``)."""
        sql_text = body.get("sql", "")
        # parse before the trace opens: it decides WHICH trace to open
        # (EXPLAIN runs captured; SHOW is catalog introspection, never
        # traced). The parse cost is re-attributed as a span below.
        t0, c0 = time.time_ns(), time.thread_time_ns()
        stmt = S.parse_statement(sql_text)
        parse_t1, parse_c1 = time.time_ns(), time.thread_time_ns()
        if isinstance(stmt, S.Show):
            try:
                result = catalog.show(stmt.what, stmt.table)
            except KeyError as e:
                raise QueryError(
                    f"no such table {e.args[0]!r} for SHOW") from None
            return {"result": result, "debug": {"show": stmt.what}}
        db_name = body.get("db", "")
        if isinstance(stmt, S.Explain):
            return self._explain(body, stmt, db_name)
        with self.qtracer.start_trace("query", kind="sql",
                                      sql=sql_text[:200]):
            self._parse_span(t0, c0, parse_t1, parse_c1)
            return self._run_select(body, stmt, sql_text, db_name)

    @staticmethod
    def _parse_span(t0: int, c0: int, t1: int, c1: int) -> None:
        """Re-attribute a parse that happened just before the trace
        opened (statement routing needs the AST first)."""
        sp = qtrace.span("parse")
        if isinstance(sp, qtrace.Span):
            sp.start_ns, sp.cpu_start_ns = t0, c0
            sp.end_ns = t1
            sp.cpu_ns = c1 - c0
            sp._buf.add(sp)

    def _plan(self, body: dict, select: S.Select, db_name: str):
        """The plan span: resolve the table and scope it to the org."""
        with qtrace.span("plan") as pl:
            table = self._resolve_table(select.table, db_name)
            org = body.get("org_id")
            if org is not None:
                self._org_scope(select, table, org)
            pl.annotate(table=table.name, federated=False)
        return table

    def _run_select(self, body: dict, select: S.Select, sql_text: str,
                    db_name: str) -> dict:
        """Plan + execute one SELECT (the body of ``query()``, shared
        with the EXPLAIN ANALYZE path, under whatever trace is open)."""
        table = self._plan(body, select, db_name)
        org = body.get("org_id")
        # org scoping rewrote the AST, not the text — fold it into the
        # cache key so scoped variants of one SQL string don't collide
        with qtrace.span("execute", path="local") as ex:
            result = self.query_cache.execute(
                table, sql_text, select=select,
                extra_key=None if org is None else ("org", org))
            ex.annotate(rows=len(result.values))
        return {"result": result.to_dict(), "debug": {"table": table.name}}

    def _explain(self, body: dict, stmt: S.Explain, db_name: str) -> dict:
        """EXPLAIN: plan only. EXPLAIN ANALYZE: run the query under a
        CAPTURED trace and annotate the plan with observed wall/CPU per
        stage; the observed stage costs feed the stage cost model."""
        root = self.qtracer.start_trace(
            "query", kind="explain", sql=stmt.sql[:200], capture=True)
        answer = None
        with root:
            if stmt.analyze:
                # held past the root's end: freeing a large answer is
                # work of no stage, and would count in total_ms alone
                answer = self._run_select(body, stmt.select, stmt.sql,
                                          db_name)
            else:
                self._plan(body, stmt.select, db_name)
        del answer
        # E2E = the root span's wall (query work only; excludes the
        # trace's own sink flush) — the number stage walls must sum to
        total_ns = root.duration_ns
        spans = root.trace_spans()
        root_id = root.span_id
        stages = []
        for d in spans:
            if d["parent_span_id"] != root_id:
                continue
            stages.append({"stage": d["name"],
                           "wall_ms": round(d["duration_ns"] / 1e6, 3),
                           "cpu_ms": round(d["cpu_ns"] / 1e6, 3),
                           "status": d["status"],
                           "detail": d["attrs"]})
        stages.sort(key=lambda s: -s["wall_ms"])
        plan: dict = {"analyze": stmt.analyze}
        rows_out = 0
        for d in spans:
            a = d["attrs"]
            nm = d["name"]
            if nm == "plan":
                plan.update({k: a[k] for k in
                             ("table", "federated", "datasource")
                             if k in a})
            elif nm == "execute":
                plan["path"] = a.get("path", "")
                rows_out = int(a.get("rows", 0) or 0)
            elif nm.startswith("prune"):
                pr = plan.setdefault("prune", {"candidates": 0,
                                               "zone_pruned": 0,
                                               "bloom_checked": 0,
                                               "bloom_pruned": 0,
                                               "scanned": 0})
                for k in pr:
                    pr[k] += int(a.get(k, 0) or 0)
            elif nm.startswith("scan"):
                if "mode" in a:
                    plan["scan_mode"] = a["mode"]
                if "degree" in a:
                    plan["morsel_degree"] = a["degree"]
                if "morsels" in a:
                    plan["morsels"] = a["morsels"]
            elif nm == "cache.lookup":
                plan["cache_layer"] = a.get("layer", "")
                if "outcome" in a:
                    plan["cache_outcome"] = a["outcome"]
        if stmt.analyze:
            for s in stages:
                self.stage_cost.observe(s["stage"], max(rows_out, 1),
                                        s["wall_ms"] * 1e6)
        result_rows = [[s["stage"], s["wall_ms"], s["cpu_ms"],
                        json.dumps(s["detail"], sort_keys=True,
                                   default=str)]
                       for s in stages]
        explain = {"analyze": stmt.analyze, "trace_id": root.trace_id,
                   "plan": plan, "stages": stages,
                   "total_ms": round(total_ns / 1e6, 3),
                   "spans": len(spans)}
        if stmt.analyze:
            explain["rows_returned"] = rows_out
        return {"result": {"columns": ["stage", "wall_ms", "cpu_ms",
                                       "detail"],
                           "values": result_rows},
                "explain": explain,
                "debug": {"explain": True, "table": plan.get("table", "")}}

    def profile_tracing(self, body: dict) -> dict:
        """CPU flame graph of the sampled stacks; each of time_start,
        time_end (ns), event_type, app_service and profiler filters when
        given."""
        tree = profile_flame_tree(
            self.db.table("profile.in_process_profile"),
            time_start_ns=body.get("time_start"),
            time_end_ns=body.get("time_end"),
            event_type=body.get("event_type"),
            app_service=body.get("app_service"),
            profiler=body.get("profiler"))
        return {"result": tree.to_dict()}

    def tpu_flame(self, body: dict) -> dict:
        """Flame view over device spans: module -> category -> op.
        Device kinds only, unless include_host."""
        where = ["duration_ns > 0"]
        if not body.get("include_host"):
            device_kinds = ", ".join(
                f"'{k}'" for k in TPU_SPAN_KINDS if k.startswith("device-"))
            where.append(f"kind IN ({device_kinds})")
        where += _time_window(body)
        if body.get("device_id") is not None:
            where.append(f"device_id = {int(body['device_id'])}")
        res = engine.execute(
            self.db.table("profile.tpu_hlo_span"),
            "SELECT hlo_module, hlo_category, hlo_op, Sum(duration_ns) AS d "
            f"FROM t WHERE {' AND '.join(where)} "
            "GROUP BY hlo_module, hlo_category, hlo_op")
        stacks, values = [], []
        for mod, cat, op, d in res.values:
            stacks.append(";".join(x for x in (mod, cat or "other", op) if x))
            values.append(int(d))
        return {"result": build_flame_tree(stacks, values).to_dict()}

    def tpu_memory(self, body: dict) -> dict:
        """Memory view: per-device usage timeline, headroom summary, top
        ops by bytes accessed, and the ops that ran around the sample of
        highest pressure."""
        where = ["bytes_limit > 0", *_time_window(body)]
        if body.get("device_id") is not None:
            where.append(f"device_id = {int(body['device_id'])}")
        res = engine.execute(
            self.db.table("profile.tpu_memory"),
            "SELECT time, device_id, bytes_in_use, peak_bytes_in_use, "
            "bytes_limit, largest_free_block FROM t "
            f"WHERE {' AND '.join(where)} ORDER BY time")
        timeline = [
            {"time": int(t), "device_id": int(d), "bytes_in_use": int(b),
             "peak_bytes_in_use": int(p), "bytes_limit": int(lim),
             "largest_free_block": int(fr)}
            for t, d, b, p, lim, fr in res.values]
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
        swhere = ["bytes_accessed > 0", *_time_window(body)]
        top_n = int(body.get("top", 15))
        sres = engine.execute(
            spans, "SELECT hlo_op, hlo_module, Sum(bytes_accessed) AS b, "
                   "Sum(duration_ns) AS d, Count() AS n FROM t "
                   f"WHERE {' AND '.join(swhere)} "
                   "GROUP BY hlo_op, hlo_module ORDER BY b DESC "
                   f"LIMIT {top_n}")
        top_ops = [
            {"hlo_op": op, "hlo_module": mod, "bytes_accessed": int(b),
             "duration_ns": int(d), "count": int(n),
             "hbm_gbps": round(b / max(1, d), 2)}  # bytes/ns = GB/s
            for op, mod, b, d, n in sres.values]
        forensics = None
        if timeline:
            worst = max(timeline,
                        key=lambda s: s["bytes_in_use"] / s["bytes_limit"])
            w = int(body.get("forensics_window_s", 10)) * 1_000_000_000
            t0, t1 = worst["time"] - w, worst["time"] + w
            fres = engine.execute(
                spans, "SELECT hlo_op, Sum(bytes_accessed) AS b FROM t "
                       f"WHERE bytes_accessed > 0 AND time >= {t0} "
                       f"AND time < {t1} GROUP BY hlo_op "
                       "ORDER BY b DESC LIMIT 10")
            forensics = {
                "pressure_peak": worst,
                "pressure_pct": round(
                    100.0 * worst["bytes_in_use"] / worst["bytes_limit"], 1),
                "ops_near_peak": [
                    {"hlo_op": op, "bytes_accessed": int(b)}
                    for op, b in fres.values],
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
            job = str(body["job"]).replace("'", "")
            where.append(f"job = '{job}'")
        if body.get("run_id") is not None:
            where.append(f"run_id = {int(body['run_id'])}")
        where += _time_window(body)
        sql_text = f"SELECT {_STEP_COLS} FROM t"
        if where:
            sql_text += f" WHERE {' AND '.join(where)}"
        res = engine.execute(self.db.table("profile.tpu_step_metrics"),
                             sql_text)
        return stephealth.merge_host_partials(
            [dict(zip(res.columns, row)) for row in res.values])

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
        where = ["duration_ns > 0"]
        if collectives_only:
            where.append("collective != ''")
        where += _time_window(body)
        res = engine.execute(
            self.db.table("profile.tpu_hlo_span"),
            "SELECT time, duration_ns, device_id, core_id, hlo_op, "
            "program_id, collective, run_id, bytes_transferred, "
            "replica_group_size, step, host, slice_id, tpu_pod FROM t "
            f"WHERE {' AND '.join(where)}")
        return [dict(zip(res.columns, row)) for row in res.values]


class QuerierHTTP:
    """The querier's HTTP server: POST /v1/query, the profile POST routes
    and GET /v1/health."""

    def __init__(self, api: QuerierAPI, host: str = "127.0.0.1",
                 port: int = 20416) -> None:
        self.api = api
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None

    def start(self) -> "QuerierHTTP":
        api = self.api
        routes = {
            "/v1/query": api.query,
            "/v1/profile/ProfileTracing": api.profile_tracing,
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
                except (QueryError, S.SqlError, KeyError, ValueError) as e:
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
