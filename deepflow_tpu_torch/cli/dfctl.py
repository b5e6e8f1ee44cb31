"""dfctl: operator CLI against the port's querier HTTP API.

Own copy of the subcommands of ``deepflow_tpu/cli/dfctl.py`` whose
routes the port's server has, with the same arguments and the same
output for the same answers:

    python -m deepflow_tpu_torch.cli.dfctl [--server HOST:PORT] CMD ...

    health [--json]
    query "SELECT ..." [--db profile] [--org N]
    explain "SELECT ..." [--db profile] [--no-analyze] [--json]
    flame [--service my-svc] [--event-type on-cpu]
    tpu-flame [--device 0] [--include-host]
    tpu-memory [--device 0] [--start NS] [--end NS] [--top N]
    collectives [--start NS] [--end NS]
    step-trace [--run-id N]
    steps [--job J] [--run-id N] [--limit N] [--critical-path STEP] [--json]
    replay CAPTURE.pcap [--ingest HOST:PORT]
    datasources [--json] [--zones]
    segments [TABLE] [--v1] [--json]
    fsck [TABLE] [--no-repair] [--json]
    readtier [--json]
    promql EXPR [--time S | --start S --end S [--step S]] [--org N]
    trace TRACE_ID
    trace-search [--tags "endpoint=/x"] [--min-duration 10ms] [--limit N]
    query-trace TRACE_ID [--flame]
    agent list
    agent-group-config set FILE [--group G]
    org [--assign GROUP ORG_ID]
    cluster [--json]
    exporter list|add <json>|delete <endpoint>
    events [--type T] [--limit N]

``agent``, ``agent-group-config`` and ``org`` read and drive the
server's controller (reference: cli/dfctl.py:142-216): the fleet with
each agent's staleness and health, a group's new config (validated,
then pushed to its agents), and the group -> org assignments that scope
the group's rows. ``cluster`` prints the federation's peer table as
the answering shard sees it: each shard's address, epoch, last heartbeat,
raw row count (a replicated row counts once on each of its R owners),
probe latency and state, then the fan-out clients' attempts, hedges and
errors.
``datasources`` prints the reference's storage view of a server started
with ``--storage`` (per table its tier, segments, rows, bytes and time
span; ``--zones`` adds the segments with zone maps) and the rollup
horizons; on a server without storage it lists the flow-metric tables
by tier with their rows and the horizons (the reference prints only
that storage is off). ``segments`` lists each on-disk segment: format,
rows, bytes, sorted run, zones, skip indexes and codecs. ``fsck``
verifies every block checksum of every sealed segment now, quarantines
and repairs a corrupt one from its published blob, and exits 1 unless
the tier is clean (``fsck: OK``). ``readtier`` prints a querier
replica's adopted publish gens, its adopted tables, its segment cache's
ledger and the cluster-wide partial cache's counters.
``exporter`` lists the server's exporters with their counters and
hop ledgers, attaches one (``add '{"type": "otlp-json", "endpoint":
"http://collector:4318/v1/traces"}'``, inline JSON, a file, or ``@file``;
types json-lines, otlp-json, remote-write and kafka) or removes those of
an endpoint. ``events`` prints the newest ``event.event`` rows
(``--follow`` needs the standing queries, a later slice).
``replay`` runs a pcap through the agent's flow path (the dispatcher's
native flow map, the L7 parsers, the collector) and ships its L4_LOG,
L7_LOG and METRICS frames over the durable sender to an ingester; it
loads no torch. An HTTP error or an unreachable server exits non-zero
with the server's message.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request


def _api(server: str, path: str, body: dict | None = None) -> dict:
    url = f"http://{server}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        err = e.read().decode("utf-8", "replace")
        raise SystemExit(f"error {e.code}: {err}")
    except urllib.error.URLError as e:
        raise SystemExit(f"cannot reach {url}: {e.reason}")


def _load_json_arg(spec: str) -> dict:
    """A JSON spec given inline, as a file's path or as ``@file``."""
    if not spec:
        raise SystemExit("a json spec (inline or @file) is required")
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return json.load(f)
    if os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    try:
        return json.loads(spec)
    except json.JSONDecodeError as e:
        raise SystemExit(f"bad json spec: {e}\n{spec}") from None


def print_table(columns: list[str], rows: list[list]) -> None:
    if not rows:
        print("(no rows)")
        return
    widths = [max(len(str(c)), *(len(str(r[i])) for r in rows))
              for i, c in enumerate(columns)]
    print("  ".join(str(c).ljust(w) for c, w in zip(columns, widths)))
    print("  ".join("-" * w for w in widths))
    for r in rows:
        print("  ".join(str(v).ljust(w) for v, w in zip(r, widths)))


def print_flame(node: dict, depth: int = 0, total: int | None = None,
                max_depth: int = 12) -> None:
    if total is None:
        total = node["total_value"] or 1
    if depth > max_depth:
        return
    pct = 100.0 * node["total_value"] / total
    bar = "▇" * max(1, int(pct / 5)) if depth else ""
    print(f"{'  ' * depth}{node['name']}  {node['total_value']:,} "
          f"({pct:.1f}%) {bar}")
    for child in node.get("children", [])[:20]:
        print_flame(child, depth + 1, total, max_depth)


def _health(server: str, as_json: bool) -> None:
    h = _api(server, "/v1/health")
    if as_json:
        print(json.dumps(h, indent=2))
        return
    print(f"status: {h['status']}")
    if h.get("wedged_stages"):
        print("wedged: " + ", ".join(h["wedged_stages"]))
    stages = h.get("stages", [])
    if stages:
        print("\nserver stages:")
        print_table(
            ["STAGE", "BEATS", "PROGRESS", "AGE_S", "HINT_S", "STATE"],
            [[s["stage"], s["beats"], s["progress"], s["age_s"],
              s["interval_hint_s"],
              "WEDGED" if s.get("wedged") else "ok"] for s in stages])
    ag = h.get("agents_selfmon", {})
    hbs = ag.get("heartbeats", {})
    if hbs:
        print("\nagent stages (via deepflow_system):")
        print_table(
            ["STAGE", "BEATS", "PROGRESS", "AGE_S", "STATE"],
            [[s["stage"], int(s.get("beats", 0)),
              int(s.get("progress", 0)), s.get("age_s", ""),
              "WEDGED" if s.get("wedged") else "ok"]
             for s in sorted(hbs.values(), key=lambda x: x["stage"])])
    for w in h.get("wedges", []):
        print(f"\nserver wedge: {w['stage']} "
              f"stalled {w.get('stalled_s', '?')}s "
              f"(window {w.get('window_s', '?')}s)")
        if w.get("stack"):
            print(w["stack"].rstrip())
    for w in ag.get("wedges", []):
        print(f"\nagent wedge: {w['stage']} "
              f"stalled {w.get('stalled_s', '?')}s")
        if w.get("stack"):
            print(w["stack"].rstrip())
    if "ledger_imbalance" in h:
        print(f"\nledger imbalance (in-flight): "
              f"{h['ledger_imbalance']}")


def _tpu_memory(server: str, args) -> None:
    body = {"top": args.top}
    if args.device is not None:
        body["device_id"] = args.device
    if args.start:
        body["time_start"] = args.start
    if args.end:
        body["time_end"] = args.end
    r = _api(server, "/v1/profile/TpuMemory", body)["result"]
    if not r["devices"]:
        print("(no HBM samples)")
        return
    gib = 1 << 30
    print_table(
        ["DEVICE", "IN_USE_GIB", "PEAK_GIB", "LIMIT_GIB", "PEAK_%",
         "FRAG_FREE_GIB"],
        [[d["device_id"],
          round(d["bytes_in_use"] / gib, 2),
          round(d["peak_bytes_in_use"] / gib, 2),
          round(d["bytes_limit"] / gib, 2),
          d["peak_pct"],
          round(d["largest_free_block"] / gib, 2)]
         for d in r["devices"]])
    if r["top_ops"]:
        print("\ntop HLO ops by HBM traffic:")
        print_table(
            ["OP", "MODULE", "GIB_ACCESSED", "GB/S", "COUNT"],
            [[o["hlo_op"], o["hlo_module"],
              round(o["bytes_accessed"] / gib, 2), o["hbm_gbps"],
              o["count"]] for o in r["top_ops"]])
    f = r.get("forensics")
    if f:
        print(f"\npressure peak: {f['pressure_pct']}% of HBM on "
              f"device {f['pressure_peak']['device_id']} at "
              f"{f['pressure_peak']['time']}")
        for o in f["ops_near_peak"]:
            print(f"  {o['hlo_op']}: {o['bytes_accessed']:,}B near peak")


def _collectives(server: str, args) -> None:
    body = {}
    if args.start:
        body["time_start"] = args.start
    if args.end:
        body["time_end"] = args.end
    out = _api(server, "/v1/profile/TpuCollectives", body)
    rows = [[g["collective"], g["hlo_op"], g["run_id"],
             g["n_participants"], g.get("transport", "nvlink"),
             len(g.get("hosts", [])) or 1, g["latency_ns"],
             g["skew_ns"], g["algo_bw_gbyte_s"]] for g in out["result"]]
    print_table(["COLLECTIVE", "OP", "RUN", "DEVS", "TRANSPORT",
                 "HOSTS", "LATENCY_NS", "SKEW_NS", "GB/S"], rows)


def _step_trace(server: str, args) -> None:
    body = {}
    if args.run_id is not None:
        body["run_id"] = args.run_id
    tr = _api(server, "/v1/profile/TpuStepTrace", body)["result"]
    if not tr["devices"]:
        print("(no TPU span data)")
        return
    print(f"run {tr['run_id']}: step {tr['step_latency_ns']:,}ns, "
          f"device skew {tr['device_skew_ns']:,}ns")
    rows = [[d, v["compute_ns"], v["collective_ns"], v["n_spans"]]
            for d, v in sorted(tr["devices"].items())]
    print_table(["DEVICE", "COMPUTE_NS", "COLLECTIVE_NS", "SPANS"], rows)
    for g in tr["collectives"]:
        print(f"  {g['collective']} {g['hlo_op']}: "
              f"{g['latency_ns']:,}ns across "
              f"{g['n_participants']} devices (skew {g['skew_ns']}ns)")


def _critical_path(server: str, body: dict, as_json: bool) -> None:
    out = _api(server, "/v1/tpu/steps/critical_path", body)
    if as_json:
        print(json.dumps(out, indent=2))
        return
    r = out["result"]
    s, att = r["step"], r["attribution"]
    print(f"{s['job'] or '(job)'} run {s['run_id']} "
          f"step {s['step']}: {s['latency_ns']:,}ns "
          f"(baseline {att['baseline_latency_ns']:,}ns over "
          f"{att['baseline_steps']} healthy steps)")
    print(f"verdict: {att['verdict']}  straggler: "
          f"{att['straggler_host'] or '?'}:"
          f"TPU{att['straggler_device']} "
          f"(+{att['straggler_lag_ns']:,}ns)")
    print_table(
        ["COMPONENT", "NS", "BASELINE_NS", "DELTA_NS"],
        [[k, att["components_ns"][k],
          att["baseline_components_ns"][k],
          att["component_deltas_ns"][k]]
         for k in att["components_ns"]])
    if att["dominant_hlos"]:
        print("\ndominant HLOs by delta vs baseline:")
        print_table(
            ["HLO_OP", "SELF_NS", "BASELINE_NS", "DELTA_NS"],
            [[h["hlo_op"], h["self_ns"], h["baseline_ns"],
              h["delta_ns"]] for h in att["dominant_hlos"]])


def _steps(server: str, args) -> None:
    body = {"limit": args.limit}
    if args.job:
        body["job"] = args.job
    if args.run_id is not None:
        body["run_id"] = args.run_id
    if args.critical_path is not None:
        body["step"] = args.critical_path
        _critical_path(server, body, args.json)
        return
    out = _api(server, "/v1/tpu/steps", body)
    if args.json:
        print(json.dumps(out, indent=2))
        return
    steps = out["result"]["steps"]
    if not steps:
        print("(no step records)")
        return
    # sparkline scaled to the window's max latency
    blocks = "▁▂▃▄▅▆▇█"
    peak = max(s["latency_ns"] for s in steps) or 1
    rows = []
    for s in steps:
        spark = blocks[min(len(blocks) - 1,
                           int(len(blocks) * s["latency_ns"] / peak))]
        rows.append([
            s["job"], s["run_id"], s["step"],
            f"{s['latency_ns']:,}", spark,
            f"{s['device_skew_ns']:,}", f"{s['collective_ns']:,}",
            s["device_count"], len(s.get("hosts", [])),
            s["verdict"] if s["regressed"] else "ok"])
    print_table(
        ["JOB", "RUN", "STEP", "LATENCY_NS", "", "SKEW_NS",
         "WAIT_NS", "DEVS", "HOSTS", "VERDICT"], rows)
    for s in steps:
        if not s["regressed"]:
            continue
        att = s["attribution"]
        top = att["dominant_hlos"][0] if att["dominant_hlos"] else None
        print(f"\nstep {s['step']} (run {s['run_id']}) REGRESSED: "
              f"{att['verdict']} — straggler "
              f"{att['straggler_host'] or '?'}:"
              f"TPU{att['straggler_device']} "
              f"(+{att['straggler_lag_ns']:,}ns)"
              + (f", dominant HLO {top['hlo_op']} "
                 f"(+{top['delta_ns']:,}ns)" if top else ""))


def _explain(server: str, args) -> None:
    sql = args.sql.strip()
    if sql[:7].upper() != "EXPLAIN":
        kw = "EXPLAIN" if args.no_analyze else "EXPLAIN ANALYZE"
        sql = f"{kw} {sql}"
    out = _api(server, "/v1/query/", {"db": args.db, "sql": sql})
    ex = out.get("explain")
    if ex is None:
        raise SystemExit("server returned no explain block "
                         "(old server?)")
    if args.json:
        print(json.dumps(ex, indent=2))
        return
    plan = ex.get("plan", {})
    print(f"trace_id: {ex.get('trace_id', '')}")
    for k in sorted(plan):
        print(f"  {k}: {plan[k]}")
    r = out["result"]
    print_table(r["columns"], r["values"])
    if ex.get("analyze"):
        print(f"total: {ex.get('total_ms', 0):.3f}ms over "
              f"{ex.get('spans', 0)} spans")


def _storage_view(st: dict, args) -> None:
    """The reference's datasources output over a storage block."""
    if args.json:
        print(json.dumps(st, indent=2))
        return
    print(f"root: {st['root']}  flush_gen: {st['flush_gen']}  "
          f"evict_gen: {st['evict_gen']}  "
          f"gate_pending: {st.get('gate_pending', 0)}")
    tables = st.get("tables", {})
    if tables:
        # tier = trailing datasource suffix; everything else is a raw
        # event table (flow logs, profiles, ...)
        tiers = ("1s", "1m", "1h", "1d")
        rows = []
        for name, v in sorted(tables.items()):
            sfx = name.rsplit(".", 1)[-1]
            row = [name, sfx if sfx in tiers else "raw",
                   v["segments"], v["rows"], v["bytes"],
                   v["tmin"] if v["tmin"] is not None else "-",
                   v["tmax"] if v["tmax"] is not None else "-"]
            if args.zones:
                # segments without zone maps never prune
                row.append(f"{v.get('zoned_segments', 0)}"
                           f"/{v['segments']}")
            rows.append(row)
        hdr = ["TABLE", "TIER", "SEGMENTS", "ROWS", "BYTES", "TMIN", "TMAX"]
        if args.zones:
            hdr.append("ZONES")
        print()
        print_table(hdr, rows)
    else:
        print("(no segments on disk yet)")
    horizons = st.get("rollup_horizons", {})
    if horizons:
        print("\nrollup completeness horizons (exclusive, epoch s):")
        print_table(["DATASOURCE", "COMPLETE_BEFORE"],
                    [[k, v] for k, v in sorted(horizons.items())])


def _segments(server: str, args) -> None:
    q = ([f"table={args.table}"] if args.table else []) \
        + (["v1=1"] if args.v1 else [])
    out = _api(server, "/v1/segments" + ("?" + "&".join(q) if q else ""))
    if not out.get("storage"):
        print("(storage tier disabled — start the server with --storage)")
        return
    if args.json:
        print(json.dumps(out, indent=2))
        return
    rows = []
    for name, segs in sorted(out.get("tables", {}).items()):
        for s in segs:
            # a codec histogram, not one codec a column
            counts: dict[str, int] = {}
            for c in s.get("codecs", {}).values():
                counts[c] = counts.get(c, 0) + 1
            codec_s = ",".join(f"{k}:{v}" for k, v in sorted(counts.items()))
            idx = s.get("indexed_cols", [])
            rows.append([
                name, s["file"], f"v{s['format']}", s["rows"], s["bytes"],
                s["run"] if s["run"] is not None else "-",
                s.get("sorted_by") or "-", s.get("zoned_cols", 0),
                ",".join(idx) if idx else "-", codec_s or "-"])
    print_table(["TABLE", "SEGMENT", "FMT", "ROWS", "BYTES", "RUN",
                 "SORTED_BY", "ZONES", "INDEXED", "CODECS"], rows)
    print(f"\ncompact_gen: {out.get('compact_gen', 0)}")


def _fsck(server: str, args) -> int:
    q = ([f"table={args.table}"] if args.table else []) \
        + (["repair=0"] if args.no_repair else [])
    out = _api(server, "/v1/fsck" + ("?" + "&".join(q) if q else ""))
    if not out.get("storage"):
        print("(storage tier disabled — start the server with "
              "--storage)")
        return 0
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    tables = sorted(out.get("tables", {}).items())
    print_table(["TABLE", "SEGS", "CLEAN", "UNVERIF", "CORRUPT",
                 "REPAIRED", "REPAIR_FAIL", "QUARANTINED", "BLOCKS",
                 "BYTES"],
                [[name, t["segments"], t["clean"], t["unverifiable"],
                  len(t["corrupt"]), len(t["repaired"]),
                  len(t["repair_failed"]), len(t.get("quarantined") or {}),
                  t["blocks_checked"], t["bytes"]] for name, t in tables])
    for name, t in tables:
        for c in t["corrupt"]:
            print(f"  corrupt: {name}/{c['file']} "
                  f"blocks={','.join(c['blocks'])}")
        for fn, info in sorted((t.get("quarantined") or {}).items()):
            print(f"  quarantined: {name}/{fn} "
                  f"reason={info.get('reason', '?')} "
                  f"rows={info.get('rows', 0)}")
    print(f"\nfsck: {'OK' if out.get('ok') else 'DEGRADED'}")
    return 0 if out.get("ok") else 1


def _readtier(server: str, as_json: bool) -> None:
    h = _api(server, "/v1/health")
    rt = h.get("readtier")
    if rt is None:
        print("(no read tier — this server is not a "
              "--role=querier replica)")
        return
    if as_json:
        print(json.dumps({"readtier": rt,
                          "partial_cache": h.get("partial_cache"),
                          "query_cache": h.get("query_cache")}, indent=2))
        return
    adopted = rt.get("adopted", {})
    print("adopted manifests (ingest shard -> publish gen): "
          + (", ".join(f"{s}->{g}" for s, g in sorted(adopted.items()))
             or "(none)"))
    print_table(["TABLE", "SEGMENTS", "ROWS", "BYTES", "PUB_TOKEN"],
                [[name, t["segments"], t["rows"], t["bytes"],
                  (t.get("pub_token") or "-")[:12]]
                 for name, t in sorted(rt.get("tables", {}).items())])
    sc = rt.get("segcache", {})
    print(f"\nsegment cache ({sc.get('segments', 0)} segments, "
          f"{sc.get('bytes', 0)}/{sc.get('max_bytes', 0)} bytes):")
    print_table(["HITS", "MISSES", "FETCH_ERRS", "EVICTIONS",
                 "ROWS_EVICTED", "DEFERRED_UNLINKS"],
                [[sc.get("hits", 0), sc.get("misses", 0),
                  sc.get("fetch_errors", 0), sc.get("evictions", 0),
                  sc.get("rows_evicted", 0),
                  sc.get("deferred_unlinks", 0)]])
    pc = h.get("partial_cache") or {}
    qc = h.get("query_cache") or {}
    if pc:
        print("\ndistributed partial cache:")
        print_table(["DIST_HITS", "FETCHES", "FETCHED_BKTS", "SERVED_BKTS",
                     "FETCH_ERRS", "REMAP_FAILS", "ADVERTISED"],
                    [[qc.get("dist_hits", 0), pc.get("fetches", 0),
                      pc.get("fetched_buckets", 0),
                      pc.get("served_buckets", 0),
                      pc.get("fetch_errors", 0),
                      pc.get("remap_failures", 0),
                      pc.get("advertised", 0)]])


def _datasources(server: str, args) -> None:
    h = _api(server, "/v1/health")
    if h.get("storage") is not None:
        _storage_view(h["storage"], args)
        return
    as_json = args.json
    horizons = h["stats"]["rollup"]["horizons"]
    if as_json:
        print(json.dumps({"tables": h["tables"], "rollup_horizons":
                          horizons}, indent=2))
        return
    tiers = ("1s", "1m", "1h", "1d")
    rows = [[name, name.rsplit(".", 1)[-1], n]
            for name, n in sorted(h["tables"].items())
            if name.rsplit(".", 1)[-1] in tiers]
    print_table(["TABLE", "TIER", "ROWS"], rows)
    print("\nrollup completeness horizons (exclusive, epoch s):")
    print_table(["DATASOURCE", "COMPLETE_BEFORE"],
                [[k, v] for k, v in sorted(horizons.items())])


def _promql(server: str, args) -> None:
    from urllib.parse import quote
    if (args.start is None) != (args.end is None):
        raise SystemExit(
            "promql: --start and --end must be given together "
            "(a range query needs both bounds)")
    org_q = f"&org_id={args.org}" if args.org is not None else ""
    if args.start is not None:
        out = _api(server, f"/prom/api/v1/query_range?query="
                           f"{quote(args.expr)}&start={args.start}"
                           f"&end={args.end}&step={args.step}{org_q}")
        if out.get("status") != "success":
            raise SystemExit(f"promql: {out.get('error')}")
        for s in out["data"]["result"]:
            print(json.dumps(s["metric"]))
            for t, v in s["values"]:
                print(f"  {t}  {v}")
        return
    t = args.time if args.time is not None else int(time.time())
    out = _api(server, f"/prom/api/v1/query?query={quote(args.expr)}"
                       f"&time={t}{org_q}")
    if out.get("status") != "success":
        raise SystemExit(f"promql: {out.get('error')}")
    data = out["data"]
    if data["resultType"] == "scalar":
        print(data["result"][1])
    else:
        print_table(["SERIES", "VALUE"],
                    [[json.dumps(s["metric"]), s["value"][1]]
                     for s in data["result"]])


def _trace_search(server: str, args) -> None:
    from urllib.parse import urlencode
    q = {"limit": args.limit}
    for key, v in (("tags", args.tags), ("minDuration", args.min_duration),
                   ("maxDuration", args.max_duration), ("start", args.start),
                   ("end", args.end)):
        if v not in (None, ""):
            q[key] = v
    out = _api(server, f"/api/search?{urlencode(q)}")
    print_table(["TRACE_ID", "SERVICE", "NAME", "MS", "START_NS"],
                [[t["traceID"], t["rootServiceName"], t["rootTraceName"],
                  t["durationMs"], t["startTimeUnixNano"]]
                 for t in out["traces"]])


def _trace(server: str, trace_id: str) -> None:
    tree = _api(server, "/v1/trace/Tracing",
                {"trace_id": trace_id})["result"]
    print(f"trace {tree['trace_id']}: {tree['span_count']} spans")

    def show(node, depth=0):
        mark = "◆" if node["kind"] == "device" else "●"
        print(f"{'  ' * depth}{mark} {node['name']}  "
              f"[{node['service']}] {node['duration_ns'] / 1e6:.2f}ms "
              f"{node['status']}")
        for c in node["children"]:
            show(c, depth + 1)
    for root in tree["spans"]:
        show(root)


def _query_trace(server: str, trace_id: str, flame: bool) -> None:
    tree = _api(server, "/v1/trace/Tracing",
                {"trace_id": trace_id})["result"]
    if not tree["spans"]:
        raise SystemExit(f"no spans for trace {trace_id}")
    if flame:
        from deepflow_tpu_torch.query.flamegraph import (
            build_flame_tree, trace_flame_stacks)
        stacks, values = trace_flame_stacks(tree)
        print_flame(build_flame_tree(stacks, values,
                                     root_name=trace_id).to_dict())
        return
    t0 = min(int(s["start_ns"]) for s in tree["spans"])
    t1 = max(int(s["end_ns"]) for s in tree["spans"])
    total = max(1, t1 - t0)
    width = 40
    print(f"trace {tree['trace_id']}: {tree['span_count']} spans, "
          f"{total / 1e6:.2f}ms")

    def waterfall(node, depth=0):
        off = int(node["start_ns"]) - t0
        lead = min(width - 1, int(width * off / total))
        w = max(1, int(width * int(node["duration_ns"]) / total))
        bar = " " * lead + "▇" * min(w, width - lead)
        label = "  " * depth + node["name"]
        print(f"{label:<34.34} {node['duration_ns'] / 1e6:>9.3f}ms "
              f"|{bar:<{width}}| {node['service']} {node['status']}")
        for c in node["children"]:
            waterfall(c, depth + 1)

    for root in sorted(tree["spans"], key=lambda s: s["start_ns"]):
        waterfall(root)


def _cluster(server: str, as_json: bool) -> None:
    st = _api(server, "/v1/cluster/status")
    if as_json:
        print(json.dumps(st, indent=2))
        return
    print(f"answering shard: {st['shard_id']}  "
          f"directory version: {st['version']}")
    peers = sorted(st.get("peers", []), key=lambda p: p["shard_id"])
    print_table(
        ["SHARD", "ADDR", "EPOCH", "LAST_SEEN_S", "RAW_ROWS",
         "LATENCY_MS", "STATE"],
        [[p["shard_id"],
          p["addr"] + (" *" if p["shard_id"] == st["shard_id"] else ""),
          p["epoch"], p["last_seen_s"],
          # raw physical count: a replicated row is on R shards
          p["raw_rows"] if p.get("raw_rows") is not None else "-",
          p["latency_ms"] if p["latency_ms"] is not None else "-",
          "alive" if p["alive"]
          else ("DEAD " + p.get("error", "")).strip()]
         for p in peers])
    fan = st.get("fanout") or {}
    if fan:
        print("\nfan-out clients (this shard -> peer):")
        print_table(
            ["ADDR", "ATTEMPTS", "HEDGES", "ERRORS"],
            [[addr, f.get("attempts", 0), f.get("hedges", 0),
              f.get("errors", 0)] for addr, f in sorted(fan.items())])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="dfctl")
    parser.add_argument("--server", default="127.0.0.1:20416",
                        help="querier host:port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_health = sub.add_parser(
        "health", help="per-stage heartbeats, wedge verdicts, ledger "
                       "imbalance — server and agents")
    p_health.add_argument("--json", action="store_true",
                          help="raw /v1/health JSON instead of tables")

    p_query = sub.add_parser("query")
    p_query.add_argument("sql")
    p_query.add_argument("--db", default="")
    p_query.add_argument("--org", type=int, default=None,
                         help="scope results to this org id")

    p_explain = sub.add_parser(
        "explain", help="EXPLAIN ANALYZE a DF-SQL statement: plan "
                        "(scan mode, morsel degree, cache layer) + "
                        "observed per-stage wall/CPU time")
    p_explain.add_argument("sql")
    p_explain.add_argument("--db", default="")
    p_explain.add_argument("--no-analyze", action="store_true",
                           help="plan only, don't execute")
    p_explain.add_argument("--json", action="store_true",
                           help="raw explain JSON")

    p_flame = sub.add_parser("flame")
    p_flame.add_argument("--service", default=None)
    p_flame.add_argument("--event-type", default="on-cpu")

    p_tpu = sub.add_parser("tpu-flame")
    p_tpu.add_argument("--device", type=int, default=None)
    p_tpu.add_argument("--include-host", action="store_true",
                       help="include host compile/runtime spans")

    p_mem = sub.add_parser("tpu-memory",
                           help="per-device HBM usage, headroom, top ops "
                                "by memory traffic, OOM forensics")
    p_mem.add_argument("--device", type=int, default=None)
    p_mem.add_argument("--start", type=int, default=None)
    p_mem.add_argument("--end", type=int, default=None)
    p_mem.add_argument("--top", type=int, default=15)

    p_coll = sub.add_parser("collectives",
                            help="cross-device collective groups "
                                 "(latency/skew/bandwidth)")
    p_coll.add_argument("--start", type=int, default=None)
    p_coll.add_argument("--end", type=int, default=None)

    p_step = sub.add_parser("step-trace",
                            help="one training step stitched across devices")
    p_step.add_argument("--run-id", type=int, default=None)

    p_steps = sub.add_parser(
        "steps", help="per-step health waterfall: latency sparkline, "
                      "device skew, collective wait, regression verdict")
    p_steps.add_argument("--job", default=None)
    p_steps.add_argument("--run-id", type=int, default=None)
    p_steps.add_argument("--limit", type=int, default=50)
    p_steps.add_argument("--critical-path", type=int, default=None,
                         metavar="STEP",
                         help="attribute one step's latency against its "
                              "rolling healthy baseline")
    p_steps.add_argument("--json", action="store_true",
                         help="raw endpoint JSON instead of the waterfall")

    p_replay = sub.add_parser("replay")
    p_replay.add_argument("pcap")
    p_replay.add_argument("--ingest", default="127.0.0.1:20033")

    p_ds = sub.add_parser(
        "datasources", help="tiered storage view (per-table segments, "
                            "on-disk bytes, time spans; without storage "
                            "the flow-metric tables by tier) and the "
                            "rollup completeness horizons")
    p_ds.add_argument("--json", action="store_true",
                      help="raw storage block (or tables and horizons) "
                           "JSON")
    p_ds.add_argument("--zones", action="store_true",
                      help="add a ZONES column: segments carrying "
                           "zone-map footers (prunable), as zoned/total")

    p_seg = sub.add_parser(
        "segments", help="per-segment inspector: format version, rows, "
                         "codecs, zone/bloom index presence and "
                         "sorted-run membership")
    p_seg.add_argument("table", nargs="?", default=None,
                       help="limit to one table (default: all)")
    p_seg.add_argument("--v1", action="store_true",
                       help="only segments still on format v1 "
                            "(awaiting migrate-on-compact)")
    p_seg.add_argument("--json", action="store_true",
                       help="raw /v1/segments JSON")

    p_fsck = sub.add_parser(
        "fsck", help="verify every block checksum of every sealed "
                     "segment now; corrupt segments are quarantined "
                     "and repaired from their published object-store "
                     "copy (the background scrubber's on-demand form)")
    p_fsck.add_argument("table", nargs="?", default=None,
                        help="limit to one table (default: all)")
    p_fsck.add_argument("--no-repair", action="store_true",
                        help="report only: leave corrupt segments in "
                             "service (no quarantine, no repair)")
    p_fsck.add_argument("--json", action="store_true",
                        help="raw /v1/fsck JSON")

    p_rt = sub.add_parser(
        "readtier", help="stateless querier view: adopted publish gens "
                         "per ingest shard, per-table adopted "
                         "segments/rows, segment-cache hit/evict "
                         "ledger and distributed partial-cache "
                         "counters")
    p_rt.add_argument("--json", action="store_true",
                      help="raw readtier + partial_cache health JSON")

    p_trace = sub.add_parser("trace")
    p_trace.add_argument("trace_id")

    p_qtrace = sub.add_parser(
        "query-trace", help="span waterfall for one query trace id "
                            "(from EXPLAIN ANALYZE or trace-search)")
    p_qtrace.add_argument("trace_id")
    p_qtrace.add_argument("--flame", action="store_true",
                          help="render as a flame graph (self-time "
                               "weighted) instead of a waterfall")

    p_promql = sub.add_parser(
        "promql", help="evaluate a PromQL expression (instant by default; "
                       "--start/--end for a range)")
    p_promql.add_argument("expr")
    p_promql.add_argument("--time", type=int, default=None)
    p_promql.add_argument("--start", type=int, default=None)
    p_promql.add_argument("--end", type=int, default=None)
    p_promql.add_argument("--step", type=int, default=15)
    p_promql.add_argument("--org", type=int, default=None,
                          help="scope results to this org id")

    p_ts = sub.add_parser(
        "trace-search", help="search traces by tags/duration "
                             "(tags is logfmt: service.name=x ...)")
    p_ts.add_argument("--tags", default="")
    p_ts.add_argument("--min-duration", default=None)
    p_ts.add_argument("--max-duration", default=None)
    p_ts.add_argument("--start", type=int, default=None)
    p_ts.add_argument("--end", type=int, default=None)
    p_ts.add_argument("--limit", type=int, default=20)

    p_agent = sub.add_parser("agent", help="the controller's agents")
    p_agent.add_argument("action", choices=["list"])

    p_cfg = sub.add_parser("agent-group-config",
                           help="set an agent group's config (YAML file)")
    p_cfg.add_argument("action", choices=["set"])
    p_cfg.add_argument("file")
    p_cfg.add_argument("--group", default="default")

    p_org = sub.add_parser("org", help="org/team scoping: assign agent "
                                       "groups to orgs, list assignments")
    p_org.add_argument("--assign", nargs=2, metavar=("GROUP", "ORG_ID"),
                       default=None)

    p_cluster = sub.add_parser(
        "cluster", help="federation peer table: shard id, epoch, "
                        "last seen, raw rows, probe latency")
    p_cluster.add_argument("--json", action="store_true",
                           help="raw /v1/cluster/status JSON")

    p_events = sub.add_parser(
        "events", help="the newest event.event rows (resource changes, "
                       "the agents' process and file-I/O events)")
    p_events.add_argument("--type", default=None,
                          help="filter by event_type")
    p_events.add_argument("--limit", type=int, default=50)

    p_exp = sub.add_parser("exporter")
    p_exp.add_argument("action", choices=["list", "add", "delete"])
    p_exp.add_argument("spec", nargs="?",
                       help="add: json {type,endpoint,...}; delete: endpoint")

    args = parser.parse_args(argv)
    server = args.server
    if args.cmd == "health":
        _health(server, args.json)
    elif args.cmd == "query":
        body = {"db": args.db, "sql": args.sql}
        if args.org is not None:
            body["org_id"] = args.org
        r = _api(server, "/v1/query/", body)["result"]
        print_table(r["columns"], r["values"])
    elif args.cmd == "explain":
        _explain(server, args)
    elif args.cmd == "flame":
        body = {"event_type": args.event_type}
        if args.service:
            body["app_service"] = args.service
        print_flame(_api(server, "/v1/profile/ProfileTracing", body)
                    ["result"])
    elif args.cmd == "tpu-flame":
        body = {}
        if args.device is not None:
            body["device_id"] = args.device
        if args.include_host:
            body["include_host"] = True
        print_flame(_api(server, "/v1/profile/TpuFlame", body)["result"])
    elif args.cmd == "tpu-memory":
        _tpu_memory(server, args)
    elif args.cmd == "collectives":
        _collectives(server, args)
    elif args.cmd == "step-trace":
        _step_trace(server, args)
    elif args.cmd == "steps":
        _steps(server, args)
    elif args.cmd == "datasources":
        _datasources(server, args)
    elif args.cmd == "segments":
        _segments(server, args)
    elif args.cmd == "fsck":
        return _fsck(server, args)
    elif args.cmd == "readtier":
        _readtier(server, args.json)
    elif args.cmd == "promql":
        _promql(server, args)
    elif args.cmd == "trace":
        _trace(server, args.trace_id)
    elif args.cmd == "trace-search":
        _trace_search(server, args)
    elif args.cmd == "query-trace":
        _query_trace(server, args.trace_id, args.flame)
    elif args.cmd == "agent":
        out = _api(server, "/v1/agents")
        rows = [[a["agent_id"], a["hostname"], a["ctrl_ip"],
                 a.get("staleness_s", ""), a.get("degraded", ""),
                 a.get("exception_bitmap", 0), a.get("version", "")]
                for a in out["agents"]]
        print_table(["ID", "HOSTNAME", "CTRL_IP", "STALE_S", "DEGRADED",
                     "EXC", "VERSION"], rows)
    elif args.cmd == "agent-group-config":
        with open(args.file) as f:
            yaml_text = f.read()
        out = _api(server, "/v1/agent-group-config",
                   {"group": args.group, "yaml": yaml_text})
        print(f"group {out['group']} -> version {out['version']}")
    elif args.cmd == "org":
        body = {"action": "list"}
        if args.assign:
            try:
                org_id = int(args.assign[1])
            except ValueError:
                raise SystemExit(f"org: ORG_ID must be an integer, got "
                                 f"{args.assign[1]!r}")
            body = {"action": "assign", "group": args.assign[0],
                    "org_id": org_id}
        out = _api(server, "/v1/orgs", body)
        rows = sorted(out["orgs"].items())
        print_table(["GROUP", "ORG_ID"],
                    [[g, o] for g, o in rows] or
                    [["(all groups)", out["default_org"]]])
    elif args.cmd == "cluster":
        _cluster(server, args.json)
    elif args.cmd == "events":
        ev_sql = ("SELECT time, event_type, resource_type, "
                  "resource_name, description FROM event")
        if args.type:
            safe = args.type.replace("'", "")
            ev_sql += f" WHERE event_type = '{safe}'"
        r = _api(server, "/v1/query/",
                 {"db": "event", "sql": ev_sql + f" ORDER BY time DESC "
                                                 f"LIMIT {args.limit}"})
        print_table(r["result"]["columns"], r["result"]["values"])
    elif args.cmd == "exporter":
        if args.action == "list":
            out = _api(server, "/v1/exporters")
            for name, st in out["exporters"].items():
                print(name, st)
            if not out["exporters"]:
                print("(none)")
        elif args.action == "add":
            out = _api(server, "/v1/exporters", _load_json_arg(args.spec))
            print(f"added {out['added']} -> {out['endpoint']}")
        else:
            if not args.spec:
                raise SystemExit("usage: dfctl exporter delete <endpoint>")
            out = _api(server, "/v1/exporters/delete",
                       {"endpoint": args.spec})
            print(f"removed: {out['removed']}")
    elif args.cmd == "replay":
        from deepflow_tpu_torch.agent.dispatcher import Dispatcher
        from deepflow_tpu_torch.agent.sender import UniformSender
        sender = UniformSender([args.ingest]).start()
        disp = Dispatcher(sender=sender)
        n = disp.replay_pcap(args.pcap)
        sender.flush_and_stop()
        print(f"replayed {n} packets: {disp.stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
