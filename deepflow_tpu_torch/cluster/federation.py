"""Scatter-gather coordinator: one querier answers for N sharded servers.

Own copy of ``deepflow_tpu/cluster/federation.py``, the read tier's half
included: on a querier replica the coordinator freezes the adopted
segments across the scatter and its local partial, sends each ingest
shard the publish gen it adopted (a shard whose gen matches answers
without its published segments), drops the adopted segments of a shard
that answered in full, routes the local read-tier partial through the
bucket cache (and so through the cluster-wide partial cache), and
reports ``degraded_shards`` (shards serving with quarantined segments).
``Percentile`` partials merge through the port's ``query/sketch.py``,
the reference's ``cluster/sketch.py``.

Merge semantics (docs/CLUSTER.md spells out the contract):

- DF-SQL: partial-aggregate push-down. Each shard runs
  engine.execute_partial (groups keyed by DECODED values — SmartEncoding
  ids are shard-local and never merged); the coordinator reduces with
  engine.merge_partials. Exact for SUM/COUNT/MIN/MAX/AVG/LAST/
  COUNT(DISTINCT); PERCENTILE merges histogram sketches (~2% error).
- PromQL: Thanos-style raw-selector fan-out. Only fetch_raw is
  federated (via the db-shim below); the whole AST evaluates at the
  coordinator, so every PromQL function stays EXACT.
- Tempo search: shards return per-trace scan partials; one trace's spans
  may land on many shards, so trace-level start/end/duration exist only
  after the merge — duration filters and the limit apply here, never
  shard-side.
- Trace assembly / flame graphs: span-dict union (dedup by
  (span_id, start_ns, flow_id) in build_trace_from_spans) and
  stack-string sums.
- Degraded mode: a dead or timed-out shard never fails the query; its
  ids land in the "missing_shards" annotation of the partial result.
- Replicated mode (a HashRing is active): every scatter ships the ring
  snapshot + the alive set, each shard answers from its claim-filtered
  view (exactly one alive owner reports each row), and a shard failure
  triggers ONE re-scatter with the shrunk alive set so a dead primary's
  rows get promoted to the surviving replica. When every dead shard is
  covered (dead ⊆ ring members, |dead| ≤ R−1) the result is EXACT:
  missing_shards stays empty and the dead ids land in covered_shards.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np

from deepflow_tpu_torch.cluster.dictsync import DictSync, DictSyncError
from deepflow_tpu_torch.cluster.hashring import ClaimDbView, HashRing
from deepflow_tpu_torch.cluster.membership import (DEFAULT_TTL_S,
                                                   ClusterMembership, Peer)
from deepflow_tpu_torch.cluster.remote import FanOut, ShardCallError
from deepflow_tpu_torch.query import cache, engine, promql, qtrace
from deepflow_tpu_torch.query import sql as qsql
from deepflow_tpu_torch.query.flamegraph import merge_stack_values


def merge_tempo_partials(parts: list[list[dict]]) -> list[dict]:
    """Union per-shard Tempo scan partials by traceID.

    Per trace: start = min, end = max (span sets are disjoint-ish across
    shards), _matched OR (a tag may match on any shard's spans), root
    fields from whichever shard saw the earliest span (_root_t)."""
    by_id: dict[str, dict] = {}
    for part in parts:
        for tr in part:
            cur = by_id.get(tr["traceID"])
            if cur is None:
                by_id[tr["traceID"]] = dict(tr)
                continue
            if tr.get("_root_t", 0) < cur.get("_root_t", 0):
                cur["rootServiceName"] = tr.get("rootServiceName", "")
                cur["rootTraceName"] = tr.get("rootTraceName", "")
                cur["_root_t"] = tr.get("_root_t", 0)
            cur["_start_ns"] = min(cur["_start_ns"], tr["_start_ns"])
            cur["_end_ns"] = max(cur["_end_ns"], tr["_end_ns"])
            cur["spanCount"] = cur.get("spanCount", 0) + tr.get(
                "spanCount", 0)
            cur["_matched"] = cur.get("_matched", False) or tr.get(
                "_matched", False)
    return list(by_id.values())


class _FederatedPromDb:
    """Database shim handed to promql.evaluate: intercepts fetch_raw
    (the promql_fetch_raw hook) and merges local + remote RawSeries by
    full label set. Everything else (table/tables for metadata paths)
    delegates to the local store. One instance per request — it
    accumulates that request's missing_shards."""

    def __init__(self, coord: "FederationCoordinator") -> None:
        self._coord = coord
        self._db = coord.db
        self.missing_shards: set[int] = set()
        self.fed_info: dict = {}

    def table(self, name: str):
        return self._db.table(name)

    def tables(self) -> list[str]:
        return self._db.tables()

    def __getattr__(self, name: str):
        return getattr(self._db, name)

    def promql_fetch_raw(self, vs, lo_s: float, hi_s: float):
        results, info, db = self._coord.scatter_claim(
            {"op": "promql_raw", "metric": vs.metric,
             "matchers": [list(m) for m in vs.matchers],
             "lo_s": float(lo_s), "hi_s": float(hi_s)},
            hop_name="cluster.promql")
        self.missing_shards.update(info["missing_shards"])
        self.fed_info = info
        local_unknown = False
        try:
            local = promql.fetch_raw(db, vs, lo_s, hi_s)
        except promql.UnknownMetricError:
            local, local_unknown = [], True
        remote_known = False
        merged: dict[tuple, promql.RawSeries] = {}

        def fold(series_list):
            for s in series_list:
                key = tuple(sorted((k, str(v))
                            for k, v in s.labels.items()))
                cur = merged.get(key)
                if cur is None:
                    merged[key] = s
                else:
                    t = np.concatenate([cur.t, s.t])
                    v = np.concatenate([cur.v, s.v])
                    order = np.argsort(t, kind="stable")
                    cur.t, cur.v = t[order], v[order]

        fold(local)
        for res in results.values():
            if res.get("unknown"):
                continue
            remote_known = True
            fold([promql.RawSeries(
                labels=d["labels"],
                t=np.asarray(d["t"], dtype=np.int64),
                v=np.asarray(d["v"], dtype=np.float64),
                counter=bool(d["counter"])) for d in res["series"]])
        if local_unknown and not remote_known and not self.missing_shards:
            # only a clean miss is an error: with a shard unreachable the
            # metric may live exactly there, and the degraded contract
            # says partial-and-annotated, never a 500
            raise promql.UnknownMetricError(
                f"unknown metric {vs.metric!r} on every shard")
        return list(merged.values())


class FederationCoordinator:
    """Ties membership + FanOut + the per-signal merge steps together.
    Every public method returns (result, fed_info) where fed_info is
    {"shards": total answering, "missing_shards": [ids]} — the degraded
    -mode contract: partial data is annotated, never a 500."""

    def __init__(self, db, membership: ClusterMembership,
                 fanout: FanOut, shard_id: int = 0,
                 ttl_s: float = DEFAULT_TTL_S) -> None:
        self.db = db
        self.membership = membership
        self.fanout = fanout
        self.shard_id = shard_id
        self.ttl_s = ttl_s
        # int-key federation state: shard-dictionary mirrors + remap
        # tables (cluster/dictsync.py) and the per-query scatter cache —
        # raw shard partials keyed by each shard's own change token, plus
        # the merged result for the all-tokens-unchanged fast path.
        self.dict_sync = DictSync()
        self._sql_cache: OrderedDict = OrderedDict()
        self._sql_cache_max = 64
        self.sql_cache_counters = {"warm_hits": 0, "shard_unchanged": 0,
                                   "shard_refetched": 0,
                                   "remap_failures": 0}
        # the read tier (server/server.py, querier role): the adopted
        # segments this coordinator serves sealed history from, and the
        # QueryCache its local partial goes through, so bucket slices
        # (and the cluster-wide partial cache) warm up
        self.readtier = None
        self.query_cache = None

    # -- plumbing -----------------------------------------------------------

    def remote_peers(self) -> list[Peer]:
        # scatter targets are INGEST shards only: a querier replica
        # holds no rows of its own (its table is the same published
        # history this coordinator adopted), so scattering to one would
        # count every sealed row twice
        return self.membership.peers(include_self=False, ttl_s=self.ttl_s,
                                     role="ingest")

    def active(self) -> bool:
        """Any alive remote peer right now? (Single node: every query
        stays on the plain local path, zero overhead.)"""
        return bool(self.remote_peers())

    def ring(self) -> HashRing | None:
        return self.membership.ring

    def scatter(self, body: dict,
                hop_name: str) -> tuple[dict[int, object], list[int]]:
        return self.fanout.scatter(self.remote_peers(), body, hop_name)

    def _prune_clients(self) -> None:
        snap = self.membership.directory.snapshot()
        self.fanout.prune({p["addr"] for p in snap["peers"]})

    def scatter_claim(self, body: dict, hop_name: str,
                      readtier_exclude: bool = True):
        """Replica-exact scatter: -> (results, fed_info, local_db).

        Without a ring this is the PR-3 degraded path (raw local db,
        missing_shards annotated). With a ring, the op body carries the
        ring snapshot and the alive set; every shard — including this
        one, via the returned claim-view — reports each row exactly
        once: the row's first alive owner claims it. A failed shard
        triggers one re-scatter to the survivors with the shrunk alive
        set, because the survivors' first-round answers were computed
        assuming the dead shard would claim its own rows. The local
        partial MUST be computed from the returned db AFTER this call,
        so it sees the final alive set. On a read-tier querier
        (``readtier_exclude``; DF-SQL has its handshake instead) every
        shard that answered answered for its whole history, so the
        returned db leaves that shard's adopted segments out; a dead
        shard's stay in."""
        results, info, local_db = self._scatter_claim(body, hop_name)
        if self.readtier is not None and readtier_exclude and results:
            from deepflow_tpu_torch.store.segcache import ShardExcludeDb
            local_db = ShardExcludeDb(local_db, set(results))
        return results, info, local_db

    def _scatter_claim(self, body: dict, hop_name: str):
        self._prune_clients()
        ring = self.ring()
        peers = self.remote_peers()
        if ring is None:
            results, missing = self.fanout.scatter(peers, body, hop_name)
            return results, self._info(results, missing), self.db
        alive = {self.shard_id} | {p.shard_id for p in peers}
        dead: set[int] = set()
        remaining = list(peers)
        results: dict[int, object] = {}
        failed: list[int] = []
        for _round in range(3):
            b = dict(body)
            b["ring"] = ring.snapshot()
            b["alive"] = sorted(alive)
            results, failed = self.fanout.scatter(remaining, b, hop_name)
            if not failed:
                break
            dead.update(failed)
            alive -= set(failed)
            remaining = [p for p in remaining
                         if p.shard_id not in set(failed)]
        exact = not failed and ring.covers(dead)
        info = {"shards": 1 + len(results) + len(dead),
                "missing_shards": [] if exact else sorted(dead),
                "ring_epoch": ring.epoch}
        if exact and dead:
            info["covered_shards"] = sorted(dead)
        local_db = ClaimDbView(self.db, ring, self.shard_id, alive)
        return results, info, local_db

    def _info(self, results: dict, missing: list[int]) -> dict:
        return {"shards": 1 + len(results) + len(missing),
                "missing_shards": missing}

    # -- DF-SQL -------------------------------------------------------------

    def sql_query(self, table, select: qsql.Select, sql_text: str,
                  org_id=None):
        """The entry point. With a read tier, adoption is frozen across
        the scatter AND the local partial, so a pointer swap mid-query
        cannot move segments between a shard's answer and the local
        read-tier scan (both sides see one snapshot)."""
        if self.readtier is None:
            return self._sql_query(table, select, sql_text, org_id)
        with self.readtier.freeze():
            return self._sql_query(table, select, sql_text, org_id)

    def _sql_query(self, table, select: qsql.Select, sql_text: str,
                   org_id=None):
        """table/select: the coordinator's locally-resolved table and
        (org-scoped) AST. The exact resolved table NAME, the original
        sql_text and org_id travel to the shards, which re-scope
        themselves (the org filter lives in the AST, not the text) —
        both sides derive the partial layout from the same normalized
        text.

        Protocol v2 (int-key federation):
        the body carries ``"enc": 1`` plus per-shard ``if_state`` change
        tokens and ``dict_known`` mirror prefixes. A shard whose token
        matches replies {"kind": "unchanged"} and the coordinator reuses
        its cached raw partial; encoded replies are id-remapped into the
        coordinator's dictionaries before the vectorized merge. Shards
        running pre-encoding code ignore the new keys and return decoded
        partials, which join on the generic merge path unchanged."""
        import os
        cache_on = os.environ.get("DF_QUERY_CACHE", "1") != "0"
        ck = (table.name, " ".join(sql_text.split()), org_id)
        ent = self._sql_cache.get(ck) if cache_on else None
        peers = self.remote_peers()
        body = {"op": "sql_partial", "sql": sql_text,
                "table": table.name, "enc": 1,
                "dict_known": {
                    str(p.shard_id): self.dict_sync.known_state(
                        p.shard_id, table.name) for p in peers}}
        if org_id is not None:
            body["org_id"] = org_id
        rt = self.readtier
        if rt is not None:
            # the publish-gen handshake: tell each shard which of its
            # pointer gens we adopted. A shard whose current gen matches
            # answers WITHOUT its published segments (we serve them from
            # the read tier); any other shard answers in full and we drop
            # its adopted segments from the local scan
            adopted = {str(p.shard_id): rt.gen_for(p.shard_id)
                       for p in peers if rt.gen_for(p.shard_id)}
            if adopted:
                body["readtier"] = adopted
        if ent is not None:
            # one shared scatter body: per-shard tokens keyed by id
            body["if_state"] = {str(sid): st
                                for sid, st in ent["states"].items()
                                if st is not None}
        addr_by_sid = {p.shard_id: p.addr for p in peers}
        with qtrace.span("scatter", peers=len(peers)) as sc:
            results, info, db = self.scatter_claim(
                body, hop_name="cluster.sql", readtier_exclude=False)
            sc.annotate(answered=len(results),
                        missing=len(info.get("missing_shards", [])))
        # integrity degradation: a shard serving with quarantined
        # (corrupt, awaiting repair) segments says so on every reply,
        # "unchanged" ones included, so a quarantine that appears
        # between two equal queries still surfaces
        deg_shards = {str(sid): r["degraded"]
                      for sid, r in results.items()
                      if isinstance(r, dict) and r.get("degraded")}
        if deg_shards:
            info = dict(info)
            info["degraded_shards"] = deg_shards
        local = db.table(table.name) if db is not self.db else table
        ring = self.ring()
        # the local partial's validity depends on the claim view too:
        # same table state under a different ring/alive set answers for
        # different rows
        ring_ctx = None if ring is None else [
            ring.epoch, ring.token,
            sorted(getattr(db, "_alive", []) or [])]

        parts_raw: dict[int, object] = {}
        states: dict[int, object] = {}
        unchanged: set[int] = set()
        failed_sync: list[int] = []
        for sid in sorted(results):
            r = results[sid]
            if isinstance(r, dict) and r.get("kind") == "unchanged":
                cached = (ent["parts"].get(sid)
                          if ent is not None else None)
                if cached is not None and \
                        ent["states"].get(sid) == r.get("state"):
                    parts_raw[sid] = cached
                    states[sid] = r.get("state")
                    unchanged.add(sid)
                    self.sql_cache_counters["shard_unchanged"] += 1
                    continue
                # shard honored a token we no longer hold the partial
                # for (evicted/raced) — fetch it fresh, no if_state
                r = self._shard_refetch(addr_by_sid.get(sid), body)
                if r is None:
                    failed_sync.append(sid)
                    continue
            states[sid] = (r.get("state")
                           if isinstance(r, dict) else None)
            parts_raw[sid] = r

        rt_excluded: set[int] = set()
        if rt is not None:
            def _acked(sid: int) -> bool:
                for src in (parts_raw.get(sid), results.get(sid)):
                    if isinstance(src, dict) and \
                            (src.get("rt") or {}).get("excluded"):
                        return True
                return False
            # an ANSWERING shard that did not apply the exclusion (its
            # gen moved on, a compaction's window, a decoded fallback)
            # covered its published rows itself: drop its adopted
            # segments from the local scan or they would count twice.
            # Dead shards stay IN: the read tier keeps their history
            rt_excluded = {sid for sid in parts_raw
                           if rt.gen_for(sid) and not _acked(sid)}
            if rt_excluded:
                from deepflow_tpu_torch.store.segcache import \
                    ShardExcludeView
                local = ShardExcludeView(local, frozenset(rt_excluded))
        # change_token, not sync_state: the remap below grows local
        # dictionaries, which must not read as "table changed". The
        # read-tier exclusion joins the token: the same table state
        # answers for other rows under another exclusion
        local_token = [cache.change_token(table), ring_ctx] + \
            ([sorted(rt_excluded)] if rt is not None else [])

        if (ent is not None and not failed_sync
                and ent["local"] == local_token
                and set(parts_raw) == set(ent["parts"]) == unchanged
                and ent["missing"] == info["missing_shards"]):
            # nothing anywhere changed: skip remap + merge entirely
            self.sql_cache_counters["warm_hits"] += 1
            self._sql_cache.move_to_end(ck)
            info = dict(info)
            info["cache"] = "warm"
            info["shards_unchanged"] = len(unchanged)
            info["shards_refetched"] = 0
            return self._copy_result(ent["result"]), info

        if ent is not None and ent["local"] == local_token \
                and ent.get("local_part") is not None:
            local_part = ent["local_part"]
        elif rt is not None and self.query_cache is not None \
                and ring is None:
            # a querier coordinator: the local read-tier partial goes
            # through the bucket cache, so repeats recompute only stale
            # buckets, and cold buckets can come from a warm replica
            # through the cluster-wide partial cache (QueryCache.dist)
            extra = (("rt", org_id) if not rt_excluded
                     else ("rt", org_id, tuple(sorted(rt_excluded))))
            local_part = self.query_cache.partial(
                local, sql_text, select=select, extra_key=extra)
        else:
            local_part = engine.execute_partial(local, select,
                                                encoded=True)
        # dictionary snapshot: remap + merge + decode all see the same
        # objects even if a local compaction swaps them mid-query
        local_dicts = dict(getattr(table, "dicts", {}) or {})

        def _decoder(key, _ld=local_dicts):
            d = _ld.get(key)
            if d is None:
                raise engine.QueryError(
                    f"unknown dictionary column {key!r} in partial")
            return d

        partials: list = [local_part]
        remap_sp = qtrace.span("dictsync.remap")
        remapped = 0
        for sid in sorted(parts_raw):
            raw = parts_raw[sid]
            if isinstance(raw, dict) and raw.get("dicts"):
                try:
                    partials.append(self.dict_sync.remap_partial(
                        sid, table.name, raw, local_dicts))
                    remapped += 1
                    continue
                except DictSyncError:
                    # mirror can't cover the shard's ids (malformed
                    # delta / gen race) — ask that shard for a decoded
                    # partial rather than dropping its rows
                    self.sql_cache_counters["remap_failures"] += 1
                    raw = self._shard_refetch(addr_by_sid.get(sid),
                                              body, decoded=True)
                    if raw is None:
                        failed_sync.append(sid)
                        del parts_raw[sid]
                        states.pop(sid, None)
                        continue
                    parts_raw[sid] = raw
                    states[sid] = (raw.get("state")
                                   if isinstance(raw, dict) else None)
            partials.append(raw)
        remap_sp.annotate(shards_remapped=remapped)
        remap_sp.finish()
        if failed_sync:
            info = dict(info)
            info["missing_shards"] = sorted(
                set(info["missing_shards"]) | set(failed_sync))
        with qtrace.span("merge", partials=len(partials)):
            res = engine.merge_partials(table, select, partials,
                                        decoder=_decoder)
        info = dict(info)
        info["cache"] = "cold"
        info["shards_unchanged"] = len(unchanged)
        info["shards_refetched"] = len(
            [sid for sid in parts_raw if sid not in unchanged])
        if cache_on:
            self._sql_cache[ck] = {
                "local": local_token, "local_part": local_part,
                "states": states, "parts": parts_raw,
                "missing": info["missing_shards"],
                "result": self._copy_result(res)}
            self._sql_cache.move_to_end(ck)
            while len(self._sql_cache) > self._sql_cache_max:
                self._sql_cache.popitem(last=False)
        return res, info

    @staticmethod
    def _copy_result(res: engine.QueryResult) -> engine.QueryResult:
        return engine.QueryResult(columns=list(res.columns),
                                  values=[list(r) for r in res.values])

    def _shard_refetch(self, addr, body: dict, *, decoded: bool = False):
        """One direct (non-scatter) retry against a single shard; None
        on failure. decoded=True downgrades to the pre-encoding wire
        form (the remap escape hatch)."""
        if not addr:
            return None
        b = dict(body)
        b.pop("if_state", None)
        if decoded:
            b.pop("enc", None)
            b.pop("dict_known", None)
        try:
            out = self.fanout.client(addr).call(b)
        except ShardCallError:
            return None
        self.sql_cache_counters["shard_refetched"] += 1
        return out

    # -- PromQL -------------------------------------------------------------

    def prom_db(self) -> _FederatedPromDb:
        return _FederatedPromDb(self)

    # -- Tempo / tracing ----------------------------------------------------

    def tempo_search(self, scan_fn, params: dict):
        """scan_fn(params, db): the local shard's scan
        (querier._tempo_scan), run against the claim-filtered view so
        the local partial is computed AFTER the scatter settles the
        alive set."""
        results, info, db = self.scatter_claim(
            {"op": "tempo_scan", "params": params},
            hop_name="cluster.tempo")
        parts = [scan_fn(params, db)]
        parts.extend(results[sid]["traces"] for sid in sorted(results))
        return merge_tempo_partials(parts), info

    def trace_spans(self, collect_fn, trace_id: str):
        """collect_fn(trace_id, db) -> span dicts; union across shards,
        build_trace_from_spans dedups by (span_id, start_ns, flow_id)
        at assembly."""
        results, info, db = self.scatter_claim(
            {"op": "trace_spans", "trace_id": trace_id},
            hop_name="cluster.trace")
        spans = list(collect_fn(trace_id, db))
        for sid in sorted(results):
            spans.extend(results[sid]["spans"])
        return spans, info

    # -- flame graphs -------------------------------------------------------

    def flame_stacks(self, flame_fn, params: dict):
        """flame_fn(params, db) -> (stacks, values); sum per-shard
        partials by stack string before one build_flame_tree at the
        coordinator."""
        results, info, db = self.scatter_claim(
            {"op": "profile_flame", "params": params},
            hop_name="cluster.flame")
        parts = [flame_fn(params, db)]
        for sid in sorted(results):
            r = results[sid]
            parts.append((r["stacks"], r["values"]))
        return merge_stack_values(parts), info

    # -- dfctl / status -----------------------------------------------------

    def local_table_counts(self) -> dict:
        return {name: len(self.db.table(name))
                for name in self.db.tables()}

    def cluster_status(self) -> dict:
        """Peer table for dfctl: every known peer with per-shard row
        counts and a timed status probe (sequential — a status page,
        not a query path)."""
        now_ns = time.time_ns()
        self.membership.refresh_self()
        snap = self.membership.directory.snapshot()
        rows = []
        for p in [Peer.from_dict(d) for d in snap["peers"]]:
            # "raw_rows", not "rows": with replication each HIGH/MID row
            # physically exists on R shards, so per-shard counts (and
            # their sum) overstate the logical row count by ~R× — the
            # label says what is actually being counted
            entry = {"shard_id": p.shard_id, "addr": p.addr,
                     "epoch": p.epoch,
                     "last_seen_s": round(
                         max(0, now_ns - p.last_seen_ns) / 1e9, 1),
                     "alive": True, "latency_ms": None, "raw_rows": None}
            if p.shard_id == self.shard_id:
                t0 = time.monotonic()
                counts = self.local_table_counts()
                entry["latency_ms"] = round(
                    (time.monotonic() - t0) * 1e3, 2)
                entry["raw_rows"] = sum(counts.values())
            else:
                try:
                    t0 = time.monotonic()
                    counts = self.fanout.client(p.addr).call(
                        {"op": "table_counts"})
                    entry["latency_ms"] = round(
                        (time.monotonic() - t0) * 1e3, 2)
                    entry["raw_rows"] = sum(counts.values())
                except ShardCallError as e:
                    entry["alive"] = False
                    entry["error"] = str(e)
            rows.append(entry)
        out = {"shard_id": self.shard_id,
               "version": self.membership.directory.version,
               "peers": rows,
               "fanout": self.fanout.stats()}
        ring = self.ring()
        if ring is not None:
            # NOTE: per-shard "raw_rows" above are RAW counts — with
            # replication each HIGH/MID row exists on R shards, so the
            # sum over peers overstates the logical row count by ~R×.
            out["ring"] = {"epoch": ring.epoch, "token": ring.token,
                           "replication": ring.replication,
                           "members": sorted(ring.members)}
        return out
