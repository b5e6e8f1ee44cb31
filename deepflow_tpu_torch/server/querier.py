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
with its stages. A query over ``flow_metrics.*.1s`` that a rollup tier
answers exactly runs on that tier (``query/datasource.py``, the rollup
job's horizons; EXPLAIN's ``datasource``). Grafana's other two
datasources: PromQL (``query/promql.py``) on ``GET /api/v1/query_range``,
``/api/v1/query``, ``/api/v1/series``, ``/api/v1/labels`` and
``/api/v1/label/<l>/values`` (and under ``/prom``), and Tempo over
``flow_log.l7_flow_log`` on ``GET /api/traces/<id>``, ``/api/echo``,
``/api/search``, ``/api/search/tags`` and ``/api/search/tag/<name>/
values``, with the trace tree (``POST /v1/trace/Tracing``, from the
ingest-time ``flow_log.trace_tree`` rows, the trace builder's pending
spans and the querier's own query traces) and the service-path search
(``POST /v1/trace/Search``); external Jaeger or OTLP-JSON backends join
a trace through ``POST /v1/tracing-adapters``. In a cluster
(``cluster/``, the server's ``--shard-id`` and ``--cluster-seed``) every
surface scatters to the alive shards through ``POST /v1/shard/exec``
(the six ops of the reference: ``sql_partial``, ``promql_raw``,
``tempo_scan``, ``trace_spans``, ``profile_flame``, ``table_counts``,
answered from the replication ring's claim view) and merges here; an
answer carries ``"federation": {"shards", "missing_shards"}`` (and
``covered_shards`` when the ring covers a dead one), never a 500 for a
dead shard; ``POST /v1/cluster/join``, ``GET /v1/cluster/peers`` and
``/v1/cluster/status`` serve the membership. On a read-tier cluster (the
server's ``--objstore``, ``--role querier``) a shard answers a querier's
``sql_partial`` without the segments it published when the querier
adopted its current publish gen (``store/segcache.py``
``PublishedExcludeView``), and ``POST /v1/cache/partial`` serves warm
bucket slices to peer replicas (``cluster/partialcache.py``; gated by
the API token, ``DF_API_TOKEN``, when one is set). A DF-SQL answer over
a table with quarantined segments carries ``degraded`` (rows awaiting
repair) and a warning, and a federated one ``degraded_shards``; ``GET
/v1/fsck`` verifies every sealed segment now and quarantines and
repairs the corrupt ones (``store/scrub.py``). The HTTP server speaks
HTTP/1.1 with keep-alive, so a coordinator's shard calls reuse their
connections (``cluster/remote.py``). ``GET
/v1/health`` carries the cache's, the scan pool's and the tracer's stats
(``query_cache``, ``query``, ``query_trace``), the server's own
self-telemetry (``selfmon``, ``stages``, ``pipeline``,
``ledger_imbalance``, ``wedges``) and the agents', read back from
``deepflow_system`` (``agents_selfmon``), and with ``--storage`` the tier's ``storage`` block
(segments, rows and bytes per table, codecs, flush, eviction and
compaction counters, and the scrubber's ``scrub``), the publisher's
``publish``, a querier's ``readtier`` and ``partial_cache``; a current
wedge makes its
``status`` ``degraded`` with the ``wedged_stages``. ``GET /v1/segments``
lists each on-disk segment (``?table=``, ``?v1=1``). With the server's
controller: ``GET /v1/agents`` (the fleet with each agent's health, its
clock offset and its platform's devices), ``POST /v1/agent-group-config``
(a group's new YAML, validated and pushed), ``POST /v1/orgs`` (list, or
assign a group to an org) and ``GET`` / ``POST /v1/analyzers``. ``POST
/v1/pcaps`` lists the agents' pcap ACL captures, or with ``{"name"}``
answers one, gzip'd and in base64. The integrations' ingest routes
(``server/integration.py``) take what workloads already emit: ``POST
/api/v1/otlp/traces``, ``/api/v1/otlp/logs``, ``/api/v1/log``,
``/api/v1/profile/ingest``, ``/api/v1/write`` (Prometheus remote-write),
``/api/v1/telegraf``, ``/v0.3/traces`` and ``/v0.4/traces`` (Datadog,
PUT too) and ``/v3/segments`` (SkyWalking); a gzip'd body is unpacked,
and a body that does not decode answers 400. ``GET /v1/exporters``
lists the exporters (``server/exporters.py``) with their counters and
hop ledgers, ``POST /v1/exporters`` attaches one and ``POST
/v1/exporters/delete`` removes one; ``/v1/health`` carries both and the
integrations' row counts (``integration``).
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import re
import socket
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, parse_qsl, urlparse

import numpy as np

from deepflow_tpu_torch.cluster import wire as cluster_wire
from deepflow_tpu_torch.cluster.dictsync import build_sync
from deepflow_tpu_torch.cluster.hashring import claim_db_from_body
from deepflow_tpu_torch.query import catalog, engine, promql, qtrace
from deepflow_tpu_torch.query import datasource as qds
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.query.cache import QueryCache, change_token
from deepflow_tpu_torch.query.costmodel import KernelCostModel
from deepflow_tpu_torch.query.engine import QueryError
from deepflow_tpu_torch.query.flamegraph import (
    build_flame_tree, profile_flame_tree, profile_stack_values)
from deepflow_tpu_torch.query.tracing import (
    build_syscall_trace, build_trace_from_spans, scan_trace_spans)
from deepflow_tpu_torch.query.tracing_adapter import AdapterRegistry
from deepflow_tpu_torch.server import stephealth
from deepflow_tpu_torch.server import tracetree as tt
from deepflow_tpu_torch.server.integration import IntegrationAPI
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
from deepflow_tpu_torch.telemetry import Telemetry, collect_agent_selfmon
from deepflow_tpu_torch.tpuprobe.collectives import stitch, step_trace

log = logging.getLogger("df.querier")


class AuthError(Exception):
    """A gated route called without the API token (HTTP 403)."""


_DD_TRACE_PATHS = ("/v0.3/traces", "/v0.4/traces")

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
                 telemetry: Telemetry | None = None, rollup=None,
                 trace_trees=None, controller=None,
                 storage_provider=None,
                 api_token: str | None = None, exporters=None,
                 prom_encoder=None) -> None:
        self.db = db
        self.shard_id = db.shard_id
        # the shared token gating POST /v1/cache/partial; empty: open
        self.api_token = (api_token if api_token is not None
                          else os.environ.get("DF_API_TOKEN", ""))
        # set by the server: the segment publisher (an ingest node with
        # an object store), the read tier and the cluster-wide partial
        # cache (a querier replica), and the scrubber (/v1/fsck repair
        # and the storage block's scrub); None when off
        self.publisher = None
        self.readtier = None
        self.partial_cache = None
        self.scrubber = None
        # the server's _start_cluster sets both (cluster/membership.py,
        # cluster/federation.py); None: a standalone server
        self.membership = None
        self.federation = None
        # the server's storage block for /v1/health (None: storage off)
        self.storage_provider = storage_provider
        # server/controller.py's Controller, or None: the fleet routes
        self.controller = controller
        self.stats_provider = stats_provider or (lambda: {})
        self.telemetry = telemetry
        # RollupJob (server/datasource.py): its horizons drive the
        # transparent choice of a rollup tier; None: raw tables only
        self.rollup = rollup
        # TraceTreeBuilder: its pending spans join the stored trees
        self.trace_trees = trace_trees
        # the server's ExporterManager (server/exporters.py), or None
        self.exporters = exporters
        # the integrations' ingest routes; remote-write ids from the
        # controller's allocator in a combined server, else from
        # ``prom_encoder`` (a PromEncoderClient) or a local allocator
        if prom_encoder is None and controller is not None:
            prom_encoder = controller.prom_encoder
        self.integration = IntegrationAPI(
            db, exporters=exporters, prom_encoder=prom_encoder,
            trace_trees=trace_trees)
        # external tracing backends spliced into /v1/trace/Tracing
        self.trace_adapters = AdapterRegistry()
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
        engine.set_scan_telemetry(telemetry)

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
        if self.storage_provider is not None:
            storage = self.storage_provider()
            if storage is not None:
                out["storage"] = storage
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
        if self.membership is not None:
            out["cluster"] = {
                "shard_id": self.shard_id,
                "version": self.membership.directory.version,
                "peers_alive": len(self.membership.peers()),
            }
        if self.federation is not None:
            out["dict_sync"] = self.federation.dict_sync.snapshot()
            out["federation_cache"] = dict(
                self.federation.sql_cache_counters)
        if self.readtier is not None:
            # the adopted publish state and the segment cache's fetch,
            # hit, miss and evict ledger
            out["readtier"] = self.readtier.snapshot()
            if self.scrubber is not None:
                out["scrub"] = self.scrubber.snapshot()
        if self.partial_cache is not None:
            out["partial_cache"] = self.partial_cache.snapshot()
        if self.publisher is not None:
            out["publish"] = dict(self.publisher.stats)
            out["publish"]["publish_gen"] = self.publisher.publish_gen
        if self.exporters is not None:
            ex = self.exporters.stats()
            if ex:
                # each exporter's counters with its exporter.<kind> hop
                out["exporters"] = ex
        out["integration"] = dict(self.integration.stats)
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

    def segments(self, table: str | None = None,
                 v1_only: bool = False) -> dict:
        """GET /v1/segments (the `dfctl segments` backend): each on-disk
        segment of a table (or of all tables) with its format, rows,
        codecs, zones, skip indexes and sorted run; ``v1_only`` keeps the
        segments still awaiting the format migration."""
        store = self.db.tier_store
        if store is None:
            return {"tables": {}, "storage": False}
        self.db._ensure_loaded()
        tables: dict[str, list] = {}
        for name in [table] if table else sorted(store.tables()):
            rows = []
            for seg in store.tier(name).segments():
                if v1_only and seg.fmt >= 2:
                    continue
                codecs = seg.codecs()
                rows.append({
                    "file": os.path.basename(seg.path),
                    "format": seg.fmt, "rows": seg.rows,
                    "bytes": seg.nbytes,
                    "tmin": seg.tmin, "tmax": seg.tmax,
                    "run": seg.run, "sorted_by": seg.sorted_by,
                    "codecs": codecs, "zoned_cols": len(seg.zones),
                    "indexed_cols": sorted(
                        c for c in codecs if seg.has_index(c)),
                })
            if rows or not v1_only:
                tables[name] = rows
        return {"tables": tables, "storage": True,
                "compact_gen": store.compact_gen}

    def fsck(self, table: str | None = None, repair: bool = True) -> dict:
        """GET /v1/fsck (the `dfctl fsck` backend): verify every block
        checksum of every sealed local segment now, without waiting for
        the scrubber's paced walk. Corrupt segments go through the
        scrubber's quarantine and repair (``repair=False`` reports
        only). Pre-checksum segments count as unverifiable, never as
        corrupt."""
        store = self.db.tier_store
        if store is None:
            return {"storage": False, "tables": {}}
        self.db._ensure_loaded()
        scrub = self.scrubber
        if scrub is None and repair:
            from deepflow_tpu_torch.store.scrub import Scrubber
            scrub = Scrubber(self.db, shard_id=self.shard_id,
                             telemetry=self.telemetry)
        tables: dict[str, dict] = {}
        for name in [table] if table else sorted(store.tables()):
            res = {"segments": 0, "blocks_checked": 0, "bytes": 0,
                   "clean": 0, "unverifiable": 0, "corrupt": [],
                   "repaired": [], "repair_failed": []}
            for seg in store.tier(name).segments():
                v = seg.verify()
                res["segments"] += 1
                res["blocks_checked"] += v["checked"]
                res["bytes"] += v["bytes"]
                if v["corrupt"]:
                    fn = os.path.basename(seg.path)
                    res["corrupt"].append({"file": fn,
                                           "blocks": v["corrupt"]})
                    if scrub is not None:
                        ok = scrub.quarantine_and_repair(
                            name, seg, f"fsck:{','.join(v['corrupt'])}")
                        res["repaired" if ok
                            else "repair_failed"].append(fn)
                elif v["verifiable"]:
                    res["clean"] += 1
                else:
                    res["unverifiable"] += 1
            q = store.quarantined().get(name)
            if q:
                res["quarantined"] = q
            tables[name] = res
        return {"storage": True, "tables": tables,
                "ok": not any(t["corrupt"] or t.get("quarantined")
                              for t in tables.values())}

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

    def _fed(self):
        """The FederationCoordinator iff remote peers are alive right
        now; otherwise every query takes the plain local path."""
        if self.federation is not None and self.federation.active():
            return self.federation
        return None

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

    def _plan(self, body: dict, select: S.Select, db_name: str,
              sketches: bool = True):
        """The plan span: resolve the table, scope it to the org, and
        choose the datasource (a cluster's scatter takes the raw table
        as the reference's does): a rollup tier that answers the query
        exactly takes the table's place (the rollups share its column
        names, so the SQL text runs unchanged and the cache keys on the
        table), and a PERCENTILE the tiers' sketches cover is answered
        from them (``sketches``). Returns (table, debug, sketch answer or
        None, the FederationCoordinator or None)."""
        with qtrace.span("plan") as pl:
            table = self._resolve_table(select.table, db_name)
            org = body.get("org_id")
            if org is not None:
                self._org_scope(select, table, org)
            fed = self._fed()
            debug: dict = {"table": table.name}
            sketch = None
            if fed is None and self.rollup is not None:
                horizons = self.rollup.horizons()
                if sketches:
                    sketch = qds.sketch_percentile(self.db, table, select,
                                                   horizons)
                if sketch is None:
                    picked = qds.select_rollup(self.db, table, select,
                                               horizons)
                    if picked is not None:
                        table, debug["datasource"] = picked
                        debug["table"] = table.name
            pl.annotate(table=debug["table"], federated=fed is not None,
                        **({"datasource": str(debug["datasource"])}
                           if "datasource" in debug else {}))
        return table, debug, sketch, fed

    def _run_select(self, body: dict, select: S.Select, sql_text: str,
                    db_name: str) -> dict:
        """Plan + execute one SELECT (the body of ``query()``, shared
        with the EXPLAIN ANALYZE path, under whatever trace is open)."""
        table, debug, sketch, fed = self._plan(body, select, db_name)
        org = body.get("org_id")
        if fed is not None:
            with qtrace.span("execute", path="federation") as ex:
                result, info = fed.sql_query(table, select, sql_text,
                                             org_id=org)
                ex.annotate(shards=int(info.get("shards", 1)),
                            cache=str(info.get("cache", "")))
            return self._annotate_degraded(
                {"result": result.to_dict(), "debug": debug,
                 "federation": info}, table.name)
        if sketch is not None:
            result, debug["datasource"] = sketch
            qtrace.annotate(datasource=str(debug["datasource"]))
            return self._annotate_degraded(
                {"result": result.to_dict(), "debug": debug}, table.name)
        # org scoping rewrote the AST, not the text — fold it into the
        # cache key so scoped variants of one SQL string don't collide
        with qtrace.span("execute", path="local") as ex:
            result = self.query_cache.execute(
                table, sql_text, select=select,
                extra_key=None if org is None else ("org", org))
            ex.annotate(rows=len(result.values))
        return self._annotate_degraded(
            {"result": result.to_dict(), "debug": debug}, table.name)

    def _degraded_for(self, table_name: str) -> dict | None:
        """The quarantine marker of a table: rows the scrubber pulled
        from service (corrupt segments) and has not repaired yet. None
        when the table serves its whole history."""
        store = self.db.tier_store
        if store is None:
            return None
        info = store.quarantine_info(table_name)
        if not info:
            return None
        return {"reason": "segment_quarantine", **info}

    def _annotate_degraded(self, out: dict, table_name: str) -> dict:
        """The degraded marker and a warning on an answer, the honesty
        contract of federation's missing_shards: rows in a quarantine
        gap are missing from the answer, and the answer says so. The
        shards' markers come in under federation."""
        deg = self._degraded_for(table_name)
        fed = out.get("federation")
        fed_deg = (fed.get("degraded_shards")
                   if isinstance(fed, dict) else None)
        if deg is not None:
            out["degraded"] = deg
            out.setdefault("warnings", []).append(
                f"results may be incomplete: {deg['rows']} rows in "
                f"{deg['segments']} quarantined segment(s) of "
                f"{table_name} await repair")
        if fed_deg:
            out.setdefault("warnings", []).append(
                f"results may be incomplete: quarantined segments on "
                f"shard(s) {sorted(fed_deg)} await repair")
        return out

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
                fed_info = answer.get("federation")
            else:
                fed_info = None
                self._plan(body, stmt.select, db_name, sketches=False)
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
                if "shards" in a:
                    plan["shards"] = a["shards"]
                if a.get("cache"):
                    plan["scatter_cache"] = a["cache"]
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
            if fed_info is not None:
                explain["federation"] = fed_info
        return {"result": {"columns": ["stage", "wall_ms", "cpu_ms",
                                       "detail"],
                           "values": result_rows},
                "explain": explain,
                "debug": {"explain": True, "table": plan.get("table", "")}}

    def profile_tracing(self, body: dict) -> dict:
        """CPU flame graph of the sampled stacks; each of time_start,
        time_end (ns), event_type, app_service and profiler filters when
        given."""
        params = {k: body.get(k) for k in ("time_start", "time_end",
                                           "event_type", "app_service",
                                           "profiler")}
        fed = self._fed()
        if fed is not None:
            def flame_fn(p, db):
                part = self._flame_stacks(p, db)
                return part["stacks"], part["values"]

            (stacks, values), info = fed.flame_stacks(flame_fn, params)
            return {"result": build_flame_tree(stacks, values).to_dict(),
                    "federation": info}
        tree = profile_flame_tree(
            self.db.table("profile.in_process_profile"),
            time_start_ns=params["time_start"],
            time_end_ns=params["time_end"],
            event_type=params["event_type"],
            app_service=params["app_service"],
            profiler=params["profiler"])
        return {"result": tree.to_dict()}

    def _flame_stacks(self, params: dict, db=None) -> dict:
        """A shard's half of a federated flame graph: summed by stack in
        its own encoded space, the stacks decoded."""
        stacks, values = profile_stack_values(
            (db if db is not None else self.db).table(
                "profile.in_process_profile"),
            time_start_ns=params.get("time_start"),
            time_end_ns=params.get("time_end"),
            event_type=params.get("event_type"),
            app_service=params.get("app_service"),
            profiler=params.get("profiler"))
        return {"stacks": stacks, "values": values}

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
        table = self.db.table("profile.tpu_hlo_span")
        sql_text = (
            "SELECT hlo_module, hlo_category, hlo_op, Sum(duration_ns) AS d "
            f"FROM t WHERE {' AND '.join(where)} "
            "GROUP BY hlo_module, hlo_category, hlo_op")
        fed = self._fed()
        info = None
        if fed is not None:
            # an exact push-down: Sum partials keyed by decoded names
            res, info = fed.sql_query(table, S.parse(sql_text), sql_text)
        else:
            res = engine.execute(table, sql_text)
        stacks, values = [], []
        for mod, cat, op, d in res.values:
            stacks.append(";".join(x for x in (mod, cat or "other", op) if x))
            values.append(int(d))
        out = {"result": build_flame_tree(stacks, values).to_dict()}
        if info is not None:
            out["federation"] = info
        return out

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

    def _step_rollups(self, body: dict) -> tuple[list[dict], dict | None]:
        """Per-host step records merged into one rollup per
        (job, run_id, step), time-ordered, and the federation info when
        the query scattered. A shard's partial is a plain row SELECT:
        each host's record is held (claimed) on one shard, so the union
        of the shards' rows is the single node's row set."""
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
        table = self.db.table("profile.tpu_step_metrics")
        fed = self._fed()
        info = None
        if fed is not None:
            res, info = fed.sql_query(table, S.parse(sql_text), sql_text)
        else:
            res = engine.execute(table, sql_text)
        return stephealth.merge_host_partials(
            [dict(zip(res.columns, row)) for row in res.values]), info

    def tpu_steps(self, body: dict) -> dict:
        """Per-step health timeline, each step scored by the EWMA+MAD
        regression detector."""
        rollups, info = self._step_rollups(body)
        scored = stephealth.score_timeline(rollups)
        limit = int(body.get("limit", 500))
        out = {"result": {"steps": scored[-limit:],
                          "total_steps": len(scored)}}
        if info is not None:
            out["federation"] = info
        return out

    def tpu_step_critical_path(self, body: dict) -> dict:
        """Where one step's latency went (compute, collective wait or
        device skew) against a baseline of the healthy steps before it;
        the latest step unless step (and run_id) name one."""
        rollups, info = self._step_rollups(body)
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
        out = {"result": {"step": target, "attribution": att}}
        if info is not None:
            out["federation"] = info
        return out

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


    # -- PromQL (reference: querier/app/prometheus) --------------------------

    def _prom_db(self):
        """The db promql evaluates over: the federated shim while peers
        are alive (raw selectors fan out, the AST evaluates here, so
        every function stays exact), else the local store."""
        fed = self._fed()
        return fed.prom_db() if fed is not None else self.db

    @staticmethod
    def _prom_annotate(out: dict, db) -> dict:
        missing = sorted(getattr(db, "missing_shards", ()))
        info = dict(getattr(db, "fed_info", None) or {})
        # only when there is something to say: a healthy federated
        # answer is byte-identical to a standalone one
        if missing or info.get("covered_shards"):
            info["missing_shards"] = missing
            out["federation"] = info
        if missing:
            out.setdefault("warnings", []).append(
                f"partial result: shards {missing} did not answer")
        return out

    def prom_query_range(self, params: dict) -> dict:
        """GET /api/v1/query_range: query, start, end (epoch s), step."""
        q = params.get("query", "")
        try:
            start = int(float(params.get("start", 0)))
            end = int(float(params.get("end", 0)))
            step = max(1, int(float(params.get("step", 15))))
        except ValueError as e:
            raise QueryError(f"bad time param: {e}") from None
        db = self._prom_db()
        with self.qtracer.start_trace("query", kind="promql",
                                      promql=q[:200]):
            try:
                ast = promql.parse(q)
                if params.get("org_id") is not None:
                    promql.scope_to_org(ast, int(params["org_id"]))
                with qtrace.span("execute", path="promql_range",
                                 step=step):
                    result = promql.evaluate(db, ast, start, end, step)
            except promql.PromqlError as e:
                return {"status": "error", "errorType": "bad_data",
                        "error": str(e)}
        return self._prom_annotate(
            {"status": "success",
             "data": {"resultType": "matrix", "result": result}}, db)

    def prom_query(self, params: dict) -> dict:
        """GET /api/v1/query: an instant query at ``time`` (default now)."""
        q = params.get("query", "")
        try:
            t = int(float(params.get("time", time.time())))
        except ValueError as e:
            raise QueryError(f"bad time param: {e}") from None
        db = self._prom_db()
        with self.qtracer.start_trace("query", kind="promql",
                                      promql=q[:200]):
            try:
                ast = promql.parse(q)
                if params.get("org_id") is not None:
                    promql.scope_to_org(ast, int(params["org_id"]))
                with qtrace.span("execute", path="promql_instant"):
                    data = promql.evaluate_instant(db, ast, t)
            except promql.PromqlError as e:
                return {"status": "error", "errorType": "bad_data",
                        "error": str(e)}
        return self._prom_annotate({"status": "success", "data": data}, db)

    @staticmethod
    def _prom_meta_args(params: dict) -> tuple:
        """params is a parse_qs dict (match[] can repeat); the last hour
        by default."""
        matches = params.get("match[]", [])
        now = int(time.time())
        try:
            start = int(float(params.get("start", [now - 3600])[0]))
            end = int(float(params.get("end", [now])[0]))
        except (ValueError, IndexError) as e:
            raise QueryError(f"bad time param: {e}") from None
        return matches, start, end

    def _prom_meta(self, fn, db) -> dict:
        try:
            return self._prom_annotate({"status": "success",
                                        "data": fn(db)}, db)
        except promql.PromqlError as e:
            return {"status": "error", "errorType": "bad_data",
                    "error": str(e)}

    def prom_series(self, params: dict) -> dict:
        """GET /api/v1/series: the label sets of the series that match[]
        selects (Grafana's variable queries)."""
        matches, start, end = self._prom_meta_args(params)
        if not matches:
            return {"status": "error", "errorType": "bad_data",
                    "error": "no match[] parameter"}
        # series() goes through fetch_raw: it federates
        return self._prom_meta(
            lambda db: promql.series(db, matches, start, end),
            self._prom_db())

    def prom_labels(self, params: dict) -> dict:
        matches, start, end = self._prom_meta_args(params)
        # with match[] through series() (federated); without, metadata
        # stays local (the schema is the same on every shard)
        return self._prom_meta(
            lambda db: promql.label_names(db, matches, start, end),
            self._prom_db() if matches else self.db)

    def prom_label_values(self, label: str, params: dict) -> dict:
        matches, start, end = self._prom_meta_args(params)
        return self._prom_meta(
            lambda db: promql.label_values(db, label, matches, start, end),
            self._prom_db() if matches else self.db)

    # -- Tempo and the trace tree (reference: querier/tempo) -----------------

    _TEMPO_DUR = {"ns": 1, "us": 1e3, "µs": 1e3, "ms": 1e6, "s": 1e9,
                  "m": 60e9, "h": 3600e9}
    _TEMPO_TAGS = ("service.name", "endpoint", "l7.protocol",
                   "http.status_code")

    @classmethod
    def _tempo_duration_ns(cls, s: str) -> int:
        m = re.match(r"^([\d.]+)(ns|us|µs|ms|s|m|h)$", s.strip())
        if not m:
            raise QueryError(f"bad duration {s!r}")
        return int(float(m.group(1)) * cls._TEMPO_DUR[m.group(2)])

    def _tempo_scan(self, params: dict, db=None) -> list[dict]:
        """One partial dict per trace in the window. Tags select per
        span, but start, end and duration are the whole trace's (and a
        trace's spans may lie on several shards), so the duration
        filters and the limit apply after the scan (and the merge).
        ``db``: a claim view to scan instead of the local store."""
        tags = {}
        for k, v_quoted, v_plain in re.findall(
                r'([\w.]+)=(?:"([^"]*)"|(\S+))', params.get("tags", "")):
            tags[k] = v_quoted or v_plain
        for k in tags:
            if k not in self._TEMPO_TAGS:
                raise QueryError(
                    f"unsupported search tag {k!r}; known: "
                    f"{sorted(self._TEMPO_TAGS)}")
        where = ["trace_id != ''"]
        # a search always has a lower bound: an hour before its end (or
        # before now) unless start names one
        if params.get("start"):
            start_ts = int(float(params["start"]))
        else:
            ref = (int(float(params["end"])) if params.get("end")
                   else int(time.time()))
            start_ts = ref - 3600
        where.append(f"time >= {start_ts * 1_000_000_000}")
        end_ns = None
        if params.get("end"):
            end_ns = int(float(params["end"])) * 1_000_000_000
            where.append(f"time < {end_ns}")
        traces = self._tempo_l7(start_ts * 1_000_000_000, end_ns, tags,
                                db if db is not None else self.db)

        # the querier's own query traces answer through the same search
        self.qtracer.flush()
        qt = self.db.table("deepflow_system.query_trace")
        if not len(qt):
            return list(traces.values())
        qres = engine.execute(
            qt, "SELECT time, trace_id, parent_span_id, name, service, "
                "duration_ns, status FROM t WHERE " + " AND ".join(where))
        for t, tid, psid, name, svc, dur, status in qres.values:
            t, dur = int(t), int(dur)
            span_tags = {"service.name": svc or "", "endpoint": "",
                         "l7.protocol": "query",
                         "http.status_code": str(status)}
            matched = all(span_tags.get(k) == v for k, v in tags.items())
            tr = traces.get(tid)
            if tr is None:
                tr = traces[tid] = {
                    "traceID": tid, "_start_ns": t, "_end_ns": t + dur,
                    "spanCount": 1, "rootServiceName": svc or "",
                    "rootTraceName": name or tid, "_root_t": t,
                    "_matched": matched}
            else:
                tr["_start_ns"] = min(tr["_start_ns"], t)
                tr["_end_ns"] = max(tr["_end_ns"], t + dur)
                tr["spanCount"] += 1
                tr["_matched"] = tr["_matched"] or matched
            if psid == "":
                # the coordinator root names the trace, whatever the
                # order its spans arrive in
                tr["_root_t"] = t
                tr["rootServiceName"] = svc or ""
                tr["rootTraceName"] = name or tid
        return list(traces.values())

    def _tempo_l7(self, lo_ns: int, hi_ns: int | None, tags: dict,
                  db) -> dict[str, dict]:
        """The l7_flow_log half of the Tempo scan, columnar: one partial
        per trace in [lo_ns, hi_ns), in the order of its first row, as
        the reference's row loop builds them (start, end, spans, the
        earliest span as the root, whether any span matches every
        tag)."""
        v = db.table("flow_log.l7_flow_log").view()
        names = ("time", "trace_id", "app_service", "request_type",
                 "endpoint", "response_duration", "l7_protocol",
                 "response_code")
        if not v.chunks:
            return {}
        c = {n: np.concatenate([ch[n] for ch in v.chunks]) for n in names}
        keep = c["time"] >= lo_ns
        if hi_ns is not None:
            keep &= c["time"] < hi_ns
        empty = v.dicts["trace_id"].lookup("")
        if empty is not None:
            keep &= c["trace_id"] != empty
        rows = np.flatnonzero(keep)
        if not len(rows):
            return {}
        c = {n: a[rows] for n, a in c.items()}
        t = c["time"].astype(np.int64)
        end = t + c["response_duration"].astype(np.int64)
        match = np.ones(len(rows), dtype=bool)
        for k, val in tags.items():
            if k in ("service.name", "endpoint"):
                col = "app_service" if k == "service.name" else "endpoint"
                code = v.dicts[col].lookup(val)
                match &= (c[col] == code) if code is not None else False
            elif k == "l7.protocol":
                labels = v.columns["l7_protocol"].enum_values
                match &= np.isin(c["l7_protocol"], [
                    i for i, label in enumerate(labels) if label == val])
            else:  # http.status_code, compared as str(int(code))
                try:
                    want = int(val)
                except ValueError:
                    want = None
                match &= ((c["response_code"] == want)
                          if want is not None and str(want) == val
                          else False)
        codes, first, inv = np.unique(c["trace_id"], return_index=True,
                                      return_inverse=True)
        n = len(codes)
        start = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(start, inv, t)
        stop = np.full(n, np.iinfo(np.int64).min)
        np.maximum.at(stop, inv, end)
        spans = np.bincount(inv, minlength=n)
        matched = np.bincount(inv, weights=match, minlength=n) > 0
        # the root: the earliest span, the first row of it on a tie
        order = np.lexsort((np.arange(len(t)), t, inv))
        root = order[np.r_[0, np.flatnonzero(np.diff(inv[order])) + 1]]
        d = v.dicts
        traces: dict[str, dict] = {}
        for g in np.argsort(first, kind="stable").tolist():
            r = int(root[g])
            tid = d["trace_id"].decode(int(codes[g]))
            name = (f"{d['request_type'].decode(int(c['request_type'][r]))}"
                    f" {d['endpoint'].decode(int(c['endpoint'][r]))}"
                    ).strip()
            traces[tid] = {
                "traceID": tid, "_start_ns": int(start[g]),
                "_end_ns": int(stop[g]), "spanCount": int(spans[g]),
                "rootServiceName": d["app_service"].decode(
                    int(c["app_service"][r])),
                "rootTraceName": name or tid, "_root_t": int(t[r]),
                "_matched": bool(matched[g])}
        return traces

    def tempo_search(self, params: dict) -> dict:
        """GET /api/search: logfmt ``tags`` select traces (any one span
        matching all of them), ``minDuration`` / ``maxDuration`` and the
        time range filter them, newest first up to ``limit``; root,
        start and duration report the whole trace."""
        limit = max(1, min(int(params.get("limit", 20)), 500))
        min_ns = (self._tempo_duration_ns(params["minDuration"])
                  if params.get("minDuration") else 0)
        max_ns = (self._tempo_duration_ns(params["maxDuration"])
                  if params.get("maxDuration") else 0)
        fed = self._fed()
        info = None
        with self.qtracer.start_trace("query", kind="tempo",
                                      tags=params.get("tags", "")):
            if fed is not None:
                with qtrace.span("execute", path="federation"):
                    traces, info = fed.tempo_search(self._tempo_scan,
                                                    params)
            else:
                with qtrace.span("execute", path="local"):
                    traces = self._tempo_scan(params)
        out = []
        for tr in traces:
            if not tr["_matched"]:
                continue
            dur_ns = tr["_end_ns"] - tr["_start_ns"]
            if min_ns and dur_ns < min_ns or max_ns and dur_ns > max_ns:
                continue
            out.append({"traceID": tr["traceID"],
                        "rootServiceName": tr["rootServiceName"],
                        "rootTraceName": tr["rootTraceName"],
                        "startTimeUnixNano": str(tr["_start_ns"]),
                        "durationMs": dur_ns // 1_000_000})
        out.sort(key=lambda tr: -int(tr["startTimeUnixNano"]))
        resp = {"traces": out[:limit],
                "metrics": {"inspectedTraces": len(traces)}}
        if info is not None:
            resp["federation"] = info
        return resp

    def tempo_search_tags(self) -> dict:
        return {"tagNames": list(self._TEMPO_TAGS)}

    def tempo_search_tag_values(self, name: str) -> dict:
        """A tag's values from the live rows (a chunk scan, not the
        dictionary, so trimmed values do not linger)."""
        table = self.db.table("flow_log.l7_flow_log")
        lo, hi = 0, 1 << 62
        if name in ("service.name", "endpoint"):
            col = "app_service" if name == "service.name" else "endpoint"
            d = table.dicts[col]
            vals = []
            for c in promql._codes_in_range(table, col, lo, hi):
                try:
                    s = d.decode(c)
                except IndexError:
                    continue
                if s:
                    vals.append(s)
        elif name == "l7.protocol":
            enum = table.columns["l7_protocol"].enum_values
            vals = [enum[c] for c in promql._codes_in_range(
                table, "l7_protocol", lo, hi)
                if 0 <= c < len(enum) and enum[c]]
        elif name == "http.status_code":
            vals = [str(c) for c in sorted(promql._codes_in_range(
                table, "response_code", lo, hi)) if c]
        else:
            vals = []
        return {"tagValues": sorted(vals)}

    def tempo_trace(self, trace_id: str) -> dict:
        """GET /api/traces/<id>: the trace in Tempo's shape, each span
        with its parent."""
        tree = self._assemble_trace(trace_id)
        spans = []

        def walk(node, parent_id=""):
            spans.append({
                "traceID": trace_id,
                "spanID": node["span_id"],
                "parentSpanID": parent_id,
                "operationName": node["name"],
                "serviceName": node["service"],
                "startTimeUnixNano": str(node["start_ns"]),
                "durationNano": str(node["duration_ns"]),
                "tags": [{"key": "l7_protocol",
                          "value": node["l7_protocol"]},
                         {"key": "status", "value": node["status"]},
                         {"key": "kind", "value": node["kind"]}],
            })
            for c in node["children"]:
                walk(c, node["span_id"])

        for root in tree["spans"]:
            walk(root)
        return {"batches": [{"spans": spans}]}

    def trace(self, body: dict) -> dict:
        """POST /v1/trace/Tracing: one trace's tree by trace_id, or by a
        syscall chain id for flows without W3C headers; spans of the
        configured external backends join it."""
        trace_id = body.get("trace_id", "")
        syscall_id = body.get("syscall_trace_id")
        if syscall_id is not None:
            try:
                syscall_id = int(syscall_id)
            except (TypeError, ValueError):
                raise QueryError(
                    f"bad syscall_trace_id {syscall_id!r}") from None
            return {"result": build_syscall_trace(
                self.db.table("flow_log.l7_flow_log"), syscall_id)}
        if not trace_id:
            raise QueryError("trace_id or syscall_trace_id required")
        tree = self._assemble_trace(trace_id)
        return {"result": self.trace_adapters.merge_into(tree, trace_id)}

    def collect_trace_spans(self, trace_id: str, db=None) -> list[dict]:
        """This shard's span dicts of one trace: its flow_log.trace_tree
        rows and the trace builder's pending spans, else (rows ingested
        before any tree) an l7_flow_log scan; then the querier's own
        query-trace spans of that id. ``db``: a claim view (replication);
        replica copies also dedup at assembly by (span_id, start_ns,
        flow_id)."""
        if db is None:
            db = self.db
        spans: list[dict] = []
        tree_table = db.table("flow_log.trace_tree")
        code = tree_table.dicts["trace_id"].lookup(trace_id)
        if code is not None:
            for ch in tree_table.snapshot():
                if not ch:
                    continue
                for i in np.flatnonzero(ch["trace_id"] == code).tolist():
                    spans.extend(json.loads(
                        tree_table.dicts["tree"].decode(int(ch["tree"][i]))))
        if self.trace_trees is not None:
            spans.extend(self.trace_trees.pending_spans(trace_id))
        if not spans:
            spans = scan_trace_spans(db.table("flow_log.l7_flow_log"),
                                     trace_id)
        spans.extend(self._query_trace_spans(trace_id))
        return spans

    def _query_trace_spans(self, trace_id: str) -> list[dict]:
        """deepflow_system.query_trace's spans of one trace, with the
        tracer's unflushed ones (read-your-writes)."""
        qt = self.db.table("deepflow_system.query_trace")
        code = qt.dicts["trace_id"].lookup(trace_id)
        rows: list[dict] = []
        if code is not None:
            for ch in qt.snapshot():
                if not ch:
                    continue
                for i in np.flatnonzero(ch["trace_id"] == code).tolist():
                    row = {}
                    for name, arr in ch.items():
                        spec = qt.columns[name]
                        v = arr[i]
                        if spec.kind == "str":
                            row[name] = qt.dicts[name].decode(int(v))
                        elif spec.kind == "enum":
                            row[name] = spec.enum_values[int(v)]
                        else:
                            row[name] = int(v)
                    rows.append(row)
        spans = qtrace.spans_from_rows(rows)
        spans.extend(self.qtracer.pending_spans(trace_id))
        return spans

    def _assemble_trace(self, trace_id: str, max_spans: int = 1000) -> dict:
        """One trace's tree: this shard's spans and, while peers are
        alive, every other shard's (a trace's spans may be ingested
        anywhere; build_trace_from_spans dedups the union)."""
        fed = self._fed()
        info = None
        if fed is not None:
            spans, info = fed.trace_spans(self.collect_trace_spans,
                                          trace_id)
        else:
            spans = self.collect_trace_spans(trace_id)
        tree = build_trace_from_spans(
            trace_id, spans,
            tpu_table=self.db.table("profile.tpu_hlo_span"),
            max_spans=max_spans)
        if info is not None:
            tree["federation"] = info
        return tree

    def trace_search(self, body: dict) -> dict:
        """POST /v1/trace/Search: the traces whose service path holds
        ``service_path`` (a list, or "a>b"), over the stored trees and
        the pending ones. Body: service_path, root_service, from_ns,
        to_ns, min_duration_ns, limit."""
        body = body or {}
        path = body.get("service_path") or []
        if isinstance(path, str):
            path = [p for p in path.split(">") if p]
        pending = (self.trace_trees.pending_summaries()
                   if self.trace_trees is not None else None)
        hits = tt.search(
            self.db.table("flow_log.trace_tree"),
            service_path_query=[str(p) for p in path],
            root_service=body.get("root_service"),
            time_from_ns=int(body.get("from_ns", 0) or 0),
            time_to_ns=int(body.get("to_ns", 0) or 0),
            min_duration_ns=int(body.get("min_duration_ns", 0) or 0),
            limit=int(body.get("limit", 50) or 50),
            pending=pending)
        return {"result": {"traces": hits, "count": len(hits)}}

    def tracing_adapters_api(self, body: dict | None = None) -> dict:
        """POST /v1/tracing-adapters: {"kind": "jaeger" | "otlp",
        "base_url"} adds a backend, {"remove": base_url} drops one; the
        list either way."""
        if body and body.get("remove"):
            return {"removed": self.trace_adapters.remove(
                str(body["remove"])),
                "adapters": self.trace_adapters.list()}
        if body and body.get("kind"):
            try:
                self.trace_adapters.add(str(body["kind"]),
                                        str(body.get("base_url", "")))
            except ValueError as e:
                raise QueryError(str(e)) from None
        return {"adapters": self.trace_adapters.list()}


    # -- cluster (scatter-gather) ------------------------------------------

    def shard_exec(self, body: dict) -> dict:
        """POST /v1/shard/exec: the shard-local half of every federated
        query. Strictly local (never fans out again, even with peers
        alive): the coordinator is the only merge point. With the ring
        and alive set in the body it answers from the claim view, so
        each replicated row is reported by exactly one alive owner; a
        traced coordinator's context makes this shard's spans join its
        trace (landing in this shard's query_trace table)."""
        op = body.get("op", "")
        db = claim_db_from_body(body, self.db, self.shard_id)
        with self.qtracer.adopt(cluster_wire.extract_ctx(body),
                                "shard.exec", op=op, shard=self.shard_id):
            return self._shard_exec_op(body, db, op)

    def _shard_exec_op(self, body: dict, db, op: str) -> dict:
        if op == "sql_partial":
            table = (db.table(body["table"]) if body.get("table")
                     else self._resolve_table("", ""))
            org = body.get("org_id")

            def select_for(table) -> S.Select:
                select = S.parse_statement(body.get("sql", ""))
                if not isinstance(select, S.Select):
                    raise QueryError("sql_partial needs a SELECT")
                if org is not None:
                    # the coordinator's org filter lives in its AST, not
                    # the SQL text: re-inject it from the op body
                    self._org_scope(select, table, org)
                return select
            if not body.get("enc"):
                # a decoded partial: the remap escape hatch
                out = engine.execute_partial(table, select_for(table))
            else:
                out = self._sql_partial_enc(body, table, select_for, org)
            # computed fresh per call: an "unchanged" reply still reports
            # a NEW quarantine (federation.degraded_shards)
            deg = self._degraded_for(str(body.get("table") or ""))
            if deg is not None:
                out["degraded"] = deg
            return out
        if op == "promql_raw":
            vs = promql.VectorSelector(
                metric=str(body.get("metric", "")),
                matchers=[tuple(m) for m in body.get("matchers", [])])
            try:
                series = promql.fetch_raw(db, vs,
                                          float(body.get("lo_s", 0)),
                                          float(body.get("hi_s", 0)))
            except promql.UnknownMetricError:
                return {"unknown": True}
            return {"series": [
                {"labels": s.labels, "t": s.t.tolist(), "v": s.v.tolist(),
                 "counter": bool(s.counter)} for s in series]}
        if op == "tempo_scan":
            return {"traces": self._tempo_scan(body.get("params") or {},
                                               db)}
        if op == "trace_spans":
            return {"spans": self.collect_trace_spans(
                str(body.get("trace_id", "")), db)}
        if op == "profile_flame":
            return self._flame_stacks(body.get("params") or {}, db)
        if op == "table_counts":
            return {name: len(self.db.table(name))
                    for name in self.db.tables()}
        raise QueryError(f"unknown shard op {op!r}")

    def _sql_partial_enc(self, body: dict, table, select_for,
                         org) -> dict:
        """The encoded half of sql_partial: the change-token short
        circuit, the bucket-cached encoded partial, and the dictionary
        delta the coordinator needs to remap our ids. ``select_for``
        parses the statement, only when the answer is computed (an
        unchanged table answers without it)."""
        # a claim view answers for other rows under another ring or
        # alive set, the table unchanged: the ring context joins both
        # the change token and the cache key
        ring = body.get("ring") or {}
        ring_ctx = None if not ring else [
            ring.get("epoch"), ring.get("token"),
            sorted(int(s) for s in body.get("alive") or [])]
        # the publish-gen handshake: a read-tier coordinator names the
        # pointer gen it adopted from us. On a match answer WITHOUT the
        # published segments (it serves those from the object store), so
        # each sealed row counts once; otherwise answer in full and it
        # drops our adopted segments. The exclusion wraps the claim view
        # (a published segment is claimed there as its publisher, us)
        rt_req = (body.get("readtier") or {}).get(str(self.shard_id))
        rt_ack = excl = None
        gen, fn_sets = (self.publisher.current if self.publisher is not None
                        else (0, {}))
        if rt_req is not None and self.publisher is not None \
                and int(rt_req) == gen:
            fns = fn_sets.get(table.name)
            # a compaction or eviction may have retired published fns
            # before the next publish moves `current`: the replacement run
            # (the same rows) would stay in our answer while the
            # coordinator serves the blobs, so ack only while every
            # published fn is still live (checked here on the tier's
            # names, and again by the view that computes)
            if not fns:
                rt_ack = gen
            elif fns <= {s.path.rpartition(os.sep)[2]
                         for s in table.tier.segments()}:
                rt_ack, excl = gen, fns
        tok = [change_token(table), ring_ctx]  # read BEFORE computing
        # the exclusion joins the token: the same table state answers for
        # other rows at another publish gen
        if_state = (body.get("if_state") or {}).get(str(self.shard_id))
        if if_state is not None and if_state == tok + (
                [["pub", rt_ack]] if rt_ack is not None else []):
            out = {"kind": "unchanged", "state": if_state}
            if rt_req is not None:
                out["rt"] = {"gen": gen, "excluded": rt_ack is not None}
            return out
        if excl is not None:
            from deepflow_tpu_torch.store.segcache import \
                PublishedExcludeView
            view = PublishedExcludeView(table, excl)
            if view.complete:
                table = view
            else:
                rt_ack = None
        if rt_ack is not None:
            tok = tok + [["pub", rt_ack]]
        rt_reply = (None if rt_req is None else
                    {"gen": gen, "excluded": rt_ack is not None})
        select = select_for(table)
        extra = ("fed", org, repr(ring_ctx)) + \
            ((("pub", rt_ack),) if rt_ack is not None else ())
        part = dict(self.query_cache.partial(
            table, body.get("sql", ""), select=select, extra_key=extra))
        dicts = part.get("dicts")
        if dicts:
            known = (body.get("dict_known") or {}).get(
                str(self.shard_id)) or {}
            sync = build_sync(table, dicts, known)
            if sync is None:
                # a dictionary's gen flipped since the partial was built:
                # its ids are unremappable, so answer decoded instead
                # (over the same exclusion, still carrying the ack)
                part = dict(engine.execute_partial(table, select))
                if rt_reply is not None:
                    part["rt"] = rt_reply
                return part
            part["dict_sync"] = sync
        part["state"] = tok
        if rt_reply is not None:
            part["rt"] = rt_reply
        return part

    def _require_token(self, token: str | None, what: str) -> None:
        """Refuse a gated route unless the caller presented the shared
        token (open when none is set)."""
        if self.api_token and (token or "") != self.api_token:
            raise AuthError(f"{what} requires a valid API token "
                            "(X-DF-Token header or token field)")

    def cache_partial(self, body: dict, token: str | None = None) -> dict:
        """POST /v1/cache/partial: the serving side of the cluster-wide
        partial cache: the warm, currently valid bucket slices this
        replica holds for a peer's (table, sql, org, pub_token)."""
        self._require_token(token, "/v1/cache/partial")
        if self.partial_cache is None:
            return {"buckets": {}}
        return self.partial_cache.serve(body)

    def cluster_join(self, body: dict) -> dict:
        if self.membership is None:
            raise QueryError("clustering not enabled")
        return self.membership.handle_join(body)

    def cluster_peers(self) -> dict:
        if self.membership is None:
            return {"version": 0, "peers": []}
        self.membership.refresh_self()
        return self.membership.directory.snapshot()

    def cluster_status(self) -> dict:
        """The dfctl ``cluster`` view: the peer table with each shard's
        raw row count and probe latency."""
        if self.federation is None:
            return {"shard_id": self.shard_id, "version": 0, "peers": [],
                    "fanout": {}}
        return self.federation.cluster_status()

    # -- the controller's routes ------------------------------------------

    def _controller(self):
        if self.controller is None:
            raise QueryError("no controller")
        return self.controller

    def agents(self, body: dict | None = None) -> dict:
        """The fleet with each agent's health (reference: querier.py
        :1472-1499), and the port's clock offset and platform devices."""
        if self.controller is None:
            return {"agents": []}
        now = time.time_ns()
        out = []
        for a in self.controller.registry.list():
            staleness_s = (now - a.get("last_seen_ns", now)) / 1e9
            p = self.controller.platform_of(a["agent_id"])
            out.append({
                "agent_id": a["agent_id"],
                "hostname": a["hostname"],
                "ctrl_ip": a["ctrl_ip"],
                "last_seen_ns": a.get("last_seen_ns", 0),
                "staleness_s": round(staleness_s, 1),
                "stale": staleness_s > 60.0,
                "state": a.get("state", 0),
                "exception_bitmap": a.get("exception_bitmap", 0),
                "degraded": a.get("degraded", False),
                "version": a.get("version", ""),
                "cpu_usage": a.get("cpu_usage", 0.0),
                "mem_bytes": a.get("mem_bytes", 0),
                "agent_group": a.get("agent_group", "default"),
                "config_version": a.get("config_version", 0),
                "syncs": a.get("syncs", 0),
                "launcher_id": a.get("launcher_id", ""),
                "clock_offset_ms": a.get("clock_offset_ms"),
                "platform": None if p is None else {
                    "host_ip": p.host_ip,
                    "accelerator_type": p.accelerator_type,
                    "runtime_version": p.runtime_version,
                    "devices": [{"device_id": d.device_id,
                                 "chip_id": d.chip_id,
                                 "device_kind": d.device_kind,
                                 "hbm_bytes": d.hbm_bytes}
                                for d in p.devices]},
            })
        return {"agents": out}

    def update_agent_config(self, body: dict) -> dict:
        ctl = self._controller()
        group = body.get("group", "default")
        version = ctl.configs.update(group, body.get("yaml", "").encode())
        return {"group": group, "version": version}

    def orgs_api(self, body: dict) -> dict:
        """List the group -> org assignments, or assign a group to an
        org. Scoped reads pass ``org_id`` on ``/v1/query``."""
        ctl = self._controller()
        if body.get("action", "list") == "assign":
            group = body.get("group", "default")
            try:
                org = int(body.get("org_id", 1))
            except (TypeError, ValueError):
                raise QueryError("org_id must be an integer")
            if org < 1 or org > 0xFFFF:
                raise QueryError("org_id out of range (1..65535)")
            ctl.assign_org(group, org)
        return {"orgs": ctl.org_assignments(), "default_org": 1}

    def pcaps(self, body: dict | None = None) -> dict:
        """The pcap store (``server/decoders.py::PcapDecoder``): the
        captures' list, or with ``name`` that capture's gzip'd pcap in
        base64."""
        store = getattr(self.db, "pcap_store", None)
        entries = list(store["entries"]) if store else []
        if body and body.get("name"):
            import base64
            for e in entries:
                if e["name"] == body["name"]:
                    data = e.get("data")
                    if data is None and e.get("path") and \
                            os.path.exists(e["path"]):
                        with open(e["path"], "rb") as f:
                            data = f.read()
                    if data is None:
                        raise QueryError("capture data gone")
                    return {"name": e["name"],
                            "pcap_gz_b64": base64.b64encode(data).decode()}
            raise QueryError(f"no capture {body['name']!r}")
        return {"pcaps": [{k: v for k, v in e.items() if k != "data"}
                          for e in entries]}

    def analyzers_api(self, body: dict | None = None) -> dict:
        ctl = self._controller()
        if body and "addrs" in body:
            try:
                ctl.set_analyzers([str(a) for a in body["addrs"]])
            except ValueError as e:
                raise QueryError(f"bad analyzer address: {e}") from None
        return {"analyzers": ctl.analyzers()}

    def exporters_api(self, body: dict) -> dict:
        """POST /v1/exporters: attach one exporter (``type``
        json-lines | otlp-json | remote-write | kafka, ``endpoint``, and
        ``tables`` for json-lines and kafka); adding one that is there
        (same type and endpoint) keeps the running one."""
        if self.exporters is None:
            raise QueryError("exporters not running")
        from deepflow_tpu_torch.server.exporters import (
            JsonLinesExporter, KafkaExporter, OtlpJsonExporter,
            RemoteWriteExporter)
        etype = body.get("type", "")
        endpoint = body.get("endpoint", "")
        if not endpoint:
            raise QueryError("endpoint required")
        if etype == "json-lines":
            exp = JsonLinesExporter(endpoint,
                                    tables=tuple(body.get("tables", [])))
        elif etype == "otlp-json":
            exp = OtlpJsonExporter(endpoint)
        elif etype == "remote-write":
            exp = RemoteWriteExporter(endpoint)
        elif etype == "kafka":
            try:
                exp = KafkaExporter(endpoint,
                                    tables=tuple(body.get("tables", [])))
            except ValueError as e:
                raise QueryError(str(e)) from None
        else:
            raise QueryError(
                "type must be json-lines|otlp-json|remote-write|kafka")
        self.exporters.add(exp)
        return {"added": etype, "endpoint": endpoint,
                "exporters": self.exporters.stats()}

    def exporters_delete(self, body: dict) -> dict:
        """POST /v1/exporters/delete: stop and remove the exporters of
        ``endpoint``."""
        if self.exporters is None:
            raise QueryError("exporters not running")
        return {"removed": self.exporters.remove(body.get("endpoint", ""))}

    def exporters_list(self) -> dict:
        """GET /v1/exporters."""
        return {"exporters": self.exporters.stats()
                if self.exporters else {}}


class QuerierHTTP:
    """The querier's HTTP server: POST /v1/query, the profile and trace
    POST routes, GET /v1/health and the PromQL and Tempo GET routes."""

    def __init__(self, api: QuerierAPI, host: str = "127.0.0.1",
                 port: int = 20416) -> None:
        self.api = api
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._conns: set = set()

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
            "/v1/trace/Tracing": api.trace,
            "/v1/trace/Search": api.trace_search,
            "/v1/tracing-adapters": api.tracing_adapters_api,
            "/v1/agent-group-config": api.update_agent_config,
            "/v1/orgs": api.orgs_api,
            "/v1/analyzers": api.analyzers_api,
            "/v1/pcaps": api.pcaps,
            "/v1/cluster/join": api.cluster_join,
            "/v1/exporters": api.exporters_api,
            "/v1/exporters/delete": api.exporters_delete,
            "/api/v1/otlp/traces": api.integration.ingest_otlp_traces,
            "/api/v1/otlp/logs": api.integration.ingest_otlp_logs,
            "/api/v1/log": api.integration.ingest_app_log,
            "/v3/segments": api.integration.ingest_skywalking,
        }
        # the routes whose body is not JSON: (raw bytes, query params,
        # content type) -> answer
        raw_routes = {
            "/api/v1/write":
                lambda raw, q, ct: api.integration.ingest_prometheus(raw),
            "/api/v1/telegraf":
                lambda raw, q, ct: api.integration.ingest_telegraf(raw),
            "/api/v1/profile/ingest":
                lambda raw, q, ct: api.integration.ingest_profile(
                    dict(parse_qsl(q)), raw),
        }
        for path in _DD_TRACE_PATHS:
            raw_routes[path] = (lambda raw, q, ct:
                                api.integration.ingest_datadog(raw, ct))

        conns = self._conns

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: a shard answers a coordinator's scatter calls on
            # one connection (a thread of its own) instead of a
            # connection and a thread a call; every answer carries its
            # Content-Length, and small writes go out at once
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def setup(self) -> None:
                super().setup()
                conns.add(self.connection)

            def finish(self) -> None:
                conns.discard(self.connection)
                super().finish()

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def _send(self, code: int, obj: dict) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _token(self, body: dict) -> str | None:
                """The API token: the X-DF-Token header, Bearer auth or
                the body's ``token`` field."""
                tok = self.headers.get("X-DF-Token")
                if tok:
                    return tok
                auth = self.headers.get("Authorization", "")
                if auth.startswith("Bearer "):
                    return auth[len("Bearer "):]
                return body.get("token")

            def _get(self, path: str, query: str):
                params = dict(parse_qsl(query))
                if path in ("/v1/health", "/health"):
                    return api.health()
                if path == "/v1/agents":
                    return api.agents()
                if path == "/v1/segments":
                    return api.segments(
                        table=params.get("table") or None,
                        v1_only=params.get("v1") in ("1", "true"))
                if path == "/v1/fsck":
                    return api.fsck(
                        table=params.get("table") or None,
                        repair=params.get("repair") not in ("0", "false"))
                if path == "/v1/analyzers":
                    return api.analyzers_api()
                if path == "/v1/exporters":
                    return api.exporters_list()
                if path == "/v1/cluster/peers":
                    return api.cluster_peers()
                if path == "/v1/cluster/status":
                    return api.cluster_status()
                if path.startswith("/prom/"):
                    path = path[len("/prom"):]
                if path == "/api/v1/query_range":
                    return api.prom_query_range(params)
                if path == "/api/v1/query":
                    return api.prom_query(params)
                if path == "/api/v1/series":
                    return api.prom_series(parse_qs(query))
                if path == "/api/v1/labels":
                    return api.prom_labels(parse_qs(query))
                if (path.startswith("/api/v1/label/")
                        and path.endswith("/values")):
                    label = path[len("/api/v1/label/"):-len("/values")]
                    return api.prom_label_values(label, parse_qs(query))
                if path.startswith("/api/traces/"):
                    return api.tempo_trace(path.rsplit("/", 1)[-1])
                if path == "/api/echo":  # Tempo's datasource health
                    return {"status": "echo"}
                if path == "/api/search":
                    return api.tempo_search(params)
                if path == "/api/search/tags":
                    return api.tempo_search_tags()
                if (path.startswith("/api/search/tag/")
                        and path.endswith("/values")):
                    return api.tempo_search_tag_values(
                        path[len("/api/search/tag/"):-len("/values")])
                return None

            def do_GET(self) -> None:
                parsed = urlparse(self.path)
                try:
                    out = self._get(parsed.path.rstrip("/"), parsed.query)
                    if out is None:
                        self._send(404, {"error": f"no route {self.path}"})
                    else:
                        self._send(200, out)
                except (QueryError, S.SqlError, KeyError, ValueError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    log.exception("querier 500")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def _raw(self) -> bytes:
                """The request body, gunzipped when its Content-Encoding
                says gzip (Telegraf's HTTP output gzips by default)."""
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b""
                if raw and self.headers.get("Content-Encoding",
                                            "").lower() == "gzip":
                    try:
                        raw = gzip.decompress(raw)
                    except (OSError, EOFError, zlib.error) as e:
                        raise ValueError(f"bad gzip body: {e}") from None
                return raw

            def do_PUT(self) -> None:
                # dd-trace clients PUT their traces; no other route
                # takes a PUT
                if urlparse(self.path).path.rstrip("/") in _DD_TRACE_PATHS:
                    return self.do_POST()
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)  # the kept-alive connection's next
                self._send(405, {"error": "method not allowed"})

            def do_POST(self) -> None:
                try:
                    parsed = urlparse(self.path)
                    path = parsed.path.rstrip("/")
                    raw_fn = raw_routes.get(path)
                    if raw_fn is not None:
                        self._send(200, raw_fn(
                            self._raw(), parsed.query,
                            self.headers.get("Content-Type", "")))
                        return
                    body = json.loads(self._raw() or b"{}")
                    payload = None
                    if path == "/v1/shard/exec":
                        # a SHARD_RESULT frame, not JSON: numeric columns
                        # ride as raw little-endian arrays
                        payload = cluster_wire.encode_result(
                            api.shard_exec(body), shard_id=api.shard_id)
                    elif path == "/v1/cache/partial":
                        # a CACHE_PARTIAL frame: bucket slices carry
                        # ndarray id columns, the jsonb form keeps them raw
                        payload = cluster_wire.encode_cache_partial(
                            api.cache_partial(body, token=self._token(body)),
                            shard_id=api.shard_id)
                    if payload is not None:
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Content-Length",
                                         str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                        return
                    fn = routes.get(path)
                    if fn is None:
                        self._send(404, {"error": f"no route {self.path}"})
                    else:
                        self._send(200, fn(body))
                except AuthError as e:
                    self._send(403, {"error": str(e)})
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
            # a stopped server answers nothing more: end the kept-alive
            # connections its handlers still wait on
            for c in list(self._conns):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
