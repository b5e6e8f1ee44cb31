"""Cluster-wide partial-aggregate cache: compute each bucket once.

Own copy of ``deepflow_tpu/cluster/partialcache.py``, whole. N querier
replicas serving the same dashboard all slice the same aggregate query
into the same 60 s bucket grid (``query/cache.py``). Without coordination
each replica scans every bucket cold once: N times the work for equal
slices. This module makes the per-bucket ENCODED partials shareable:

- **adverts**: each node folds digests of its warm shareable bucket
  stores, sha1(table | normalized SQL | org), into the membership join
  exchange (``cluster/membership.py`` gossips them both ways), so every
  replica knows who is warm after one heartbeat round trip.
- **fetch**: on a local bucket miss with a live advert, the replica
  POSTs ``/v1/cache/partial`` to the warm peer and receives the matching
  slices in one CACHE_PARTIAL frame (``cluster/wire.py``, the jsonb form:
  uint32 id columns travel as raw blobs).
- **validity**: bucket marks are node-local counters and mean nothing
  across nodes. A peer's slice is valid here because both tables hold
  EXACTLY the same rows: both are pure read-tier views (no local rows)
  whose adopted publish state hashes to the same ``pub_token``
  (``store/segcache.py`` ``ReadTier._retoken``, a content hash over the
  per-shard fn sets and dictionary states). The server also validates
  each slice against its OWN current marks and gens.
- **id spaces**: slices carry the serving node's dictionary ids. The
  response ships one dict-sync delta (the federation's ``build_sync``)
  and the requester remaps through its federation DictSync mirror of
  that peer, then re-labels the slice with its OWN dictionary states:
  the slice then folds with locally scanned ones.

The ledger proves compute-once: across a quiesced query storm,
``served_buckets`` on warm nodes equals ``fetched_buckets`` on cold ones.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import urllib.request

from deepflow_tpu_torch.cluster import wire
from deepflow_tpu_torch.cluster.dictsync import DictSyncError, build_sync
from deepflow_tpu_torch.query import qtrace
from deepflow_tpu_torch.query.cache import normalize_sql

log = logging.getLogger("df.partialcache")

# extra_key variants that are NOT org-equivalent (ring claim views,
# ad-hoc rewrites) must never be shared: marker for "not shareable"
_UNSHARED = object()


def share_org(extra_key):
    """The org a bucket-cache key variant answers for, iff the variant
    is shareable across replicas — i.e. the extra_key encodes nothing
    beyond org scoping. Ring claim contexts (("fed", org, ring_repr)
    with an active ring) and read-tier exclusion sets (("rt", org,
    excluded)) answer for different row subsets and return _UNSHARED."""
    if extra_key is None:
        return None
    if isinstance(extra_key, tuple) and len(extra_key) == 2 \
            and extra_key[0] in ("org", "rt"):
        return extra_key[1]
    return _UNSHARED


def key_variants(org) -> list:
    """Every extra_key form under which org-equivalent buckets may be
    cached locally (the serve-side lookup candidates): the coordinator
    read-tier form and the plain local-query form. Shard-side ("fed",
    ...) variants never exist on a pure read-tier node — queriers are
    not scattered to."""
    return [("rt", org), None if org is None else ("org", org)]


def digest_of(table: str, sql: str, org) -> str:
    return hashlib.sha1(
        f"{table}|{normalize_sql(sql)}|{org!r}".encode()).hexdigest()[:16]


class PartialCache:
    """One node's half of the distributed partial-aggregate cache:
    requester (QueryCache.dist hook) + server (/v1/cache/partial) +
    advert source (membership.cache_adv_local hook)."""

    def __init__(self, query_cache, membership, dict_sync, db,
                 shard_id: int = 0, telemetry=None,
                 api_token: str | None = None,
                 timeout_s: float = 2.0) -> None:
        self.query_cache = query_cache
        self.membership = membership
        # the FEDERATION DictSync: peer partials arrive in the peer's
        # local id space, exactly like shard partials do — the mirrors
        # are keyed by the peer's shard_id either way
        self.dict_sync = dict_sync
        self.db = db
        self.readtier = None          # set by server wiring on queriers
        self.shard_id = shard_id
        self.api_token = api_token
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self.counters = {"advertised": 0, "fetches": 0,
                         "fetched_buckets": 0, "fetch_errors": 0,
                         "remap_failures": 0, "served": 0,
                         "served_buckets": 0, "serve_rejects": 0}
        self._hop = (telemetry.hop("cluster.partialcache")
                     if telemetry is not None else None)
        # install both hooks — the cache calls dist() on bucket misses,
        # membership gossips advertised_digests() on every heartbeat
        query_cache.dist = self.fetch_buckets
        membership.cache_adv_local = self.advertised_digests

    # -- advert side ---------------------------------------------------------

    def advertised_digests(self) -> list[str]:
        if self.readtier is None:
            return []
        out: set[str] = set()
        for tname, sql, extra in self.query_cache.warm_keys():
            org = share_org(extra)
            if org is _UNSHARED:
                continue
            if not self.readtier.pub_token(tname):
                # pub_token returns "" (not None) before any adoption:
                # nothing shareable to advertise for this table yet
                continue
            out.add(digest_of(tname, sql, org))
        with self._lock:
            self.counters["advertised"] = len(out)
        return sorted(out)

    # -- requester side ------------------------------------------------------

    def _pure(self, table) -> bool:
        """Shareable content = every row comes from the adopted remote
        tier. A table with ANY local rows (querier selfstats, an ingest
        node's stripes) diverges per node and must not share."""
        tier = getattr(table, "tier", None)
        return tier is not None and len(table) == tier.rows

    def fetch_buckets(self, table, key: tuple, buckets: list,
                      gens) -> dict:
        """QueryCache.dist hook: -> {bucket: partial} in LOCAL id space
        for whatever slices a warm advertised peer can serve."""
        tname, sql, extra = key
        org = share_org(extra)
        if org is _UNSHARED or not buckets or self.readtier is None:
            return {}
        tok = self.readtier.pub_token(tname)
        if not tok or not self._pure(table):
            # "" = no adopted state: a fetch would ship an empty token
            # the server side always rejects — skip the round-trip
            return {}
        adv = self.membership.advert_for(digest_of(tname, sql, org))
        if adv is None:
            return {}
        sid, addr = int(adv[0]), str(adv[1])
        body = {"table": tname, "sql": sql, "org": org,
                "pub_token": tok,
                "buckets": sorted(int(b) for b in buckets),
                "dict_known": self.dict_sync.known_state(sid, tname)}
        with self._lock:
            self.counters["fetches"] += 1
        fetch_sp = qtrace.span("partialcache.fetch", peer=sid, addr=addr,
                               buckets=len(buckets))
        try:
            resp, _rsid = self._call(addr, body)
        except Exception as e:
            with self._lock:
                self.counters["fetch_errors"] += 1
            if self._hop is not None:
                self._hop.account(emitted=1, dropped=1, reason="error")
            fetch_sp.annotate(outcome="error")
            fetch_sp.finish()
            log.debug("partialcache fetch from %s failed: %s", addr, e)
            return {}
        got = (resp or {}).get("buckets") or {}
        for col, sync in ((resp or {}).get("dict_sync") or {}).items():
            self.dict_sync.apply_sync(sid, tname, col, sync)
        local_dicts = dict(getattr(table, "dicts", {}) or {})
        out: dict[int, dict] = {}
        for bs, part in got.items():
            if not isinstance(part, dict) or part.get("kind") != "agg":
                continue
            used = sorted(part.get("dicts") or {})
            try:
                mapped = self.dict_sync.remap_partial(
                    sid, tname, dict(part), local_dicts)
            except DictSyncError:
                with self._lock:
                    self.counters["remap_failures"] += 1
                continue
            if used:
                # re-label with LOCAL dictionary states: after the
                # remap the ids ARE local ids (and the remap's encode
                # side effect grew the local dict to cover them), so
                # the slice now folds with locally-scanned ones
                states, ok = {}, True
                for col in used:
                    d = local_dicts.get(col)
                    if d is None:
                        ok = False
                        break
                    g, ln, _v = d.sync_state()
                    states[col] = [g, ln]
                if not ok:
                    continue
                mapped["dicts"] = states
            out[int(bs)] = mapped
        with self._lock:
            self.counters["fetched_buckets"] += len(out)
        if self._hop is not None:
            self._hop.account(emitted=1, delivered=1)
        fetch_sp.annotate(outcome="ok", fetched=len(out))
        fetch_sp.finish()
        return out

    def _call(self, addr: str, body: dict):
        headers = {"Content-Type": "application/json"}
        if self.api_token:
            headers["X-DF-Token"] = self.api_token
        req = urllib.request.Request(
            f"http://{addr}/v1/cache/partial",
            data=json.dumps(body).encode(), headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return wire.decode_cache_partial(r.read())

    # -- server side ---------------------------------------------------------

    def _reject(self) -> dict:
        with self._lock:
            self.counters["serve_rejects"] += 1
        return {"buckets": {}}

    def serve(self, body: dict) -> dict:
        """POST /v1/cache/partial: answer with every requested bucket
        this node holds warm AND currently valid, plus the dict delta
        the requester needs to remap our ids."""
        tname = str(body.get("table", ""))
        tok = str(body.get("pub_token", ""))
        wanted = [int(b) for b in (body.get("buckets") or [])]
        if self.readtier is None or not wanted or not tok:
            return {"buckets": {}}
        if self.readtier.pub_token(tname) != tok:
            return self._reject()
        try:
            table = self.db.table(tname)
        except KeyError:
            return {"buckets": {}}
        if not self._pure(table):
            return self._reject()
        parts = self.query_cache.peek_buckets(
            table, str(body.get("sql", "")),
            key_variants(body.get("org")), wanted)
        if not parts:
            return {"buckets": {}}
        # one delta covering every returned slice: per-col max len (gens
        # are equal across slices — peek validated them against the
        # current table state)
        need: dict[str, list] = {}
        for part in parts.values():
            for col, st in (part.get("dicts") or {}).items():
                g, ln = int(st[0]), int(st[1])
                cur = need.get(col)
                if cur is None:
                    need[col] = [g, ln]
                elif cur[0] != g:
                    return self._reject()
                else:
                    cur[1] = max(cur[1], ln)
        out: dict = {"buckets": {str(b): p for b, p in parts.items()}}
        if need:
            sync = build_sync(table, need, body.get("dict_known") or {})
            if sync is None:
                return self._reject()
            out["dict_sync"] = sync
        with self._lock:
            self.counters["served"] += 1
            self.counters["served_buckets"] += len(parts)
        if self._hop is not None:
            self._hop.account(emitted=1, delivered=1)
        return out

    def snapshot(self) -> dict:
        """The counters, and ``adverts_known``: the digests this node
        knows warm somewhere (its own included)."""
        with self._lock:
            out = dict(self.counters)
        out["adverts_known"] = len(self.membership.cache_adverts())
        return out
