"""Querier-level result + partial-aggregate cache with exact invalidation.

Own copy of ``deepflow_tpu/query/cache.py`` without the standing-query
fold. Two layers, both keyed by (table name, whitespace-normalized SQL)
and validated by monotonic change tokens — never by TTL:

- whole-result cache: validated against ``change_token(table)``
  ([write watermark, [[dict, gen], ...]]). Any append, trim or
  dictionary rebuild changes the token, so a hit is always exact.
- per-time-bucket partial cache: aggregate queries are sliced into the
  table's 60 s bucket grid; each bucket's ENCODED partial
  (``engine.execute_partial(encoded=True)``) is cached against that
  bucket's write mark and the dictionary gens. An append invalidates
  only the buckets it touched, a trim every bucket it reached — warm
  repeats re-scan only stale buckets, then ``engine.combine_partials``
  folds the slices back into one exact partial.

With a storage tier the same watermark moves on every persistence
event: attaching the recovered tier, a flush commit (the RAM chunks
swapped for segments: the answers are the same, so the bucket marks
stay), a compaction (every bucket goes stale) and an eviction (the
evicted time range goes stale). A cached answer never outlives a change
to the segments it read.

The token and the marks are read BEFORE executing: a write racing the
fill can only make the stored token stale (a harmless recompute next
time), never let a stale entry validate. One fill scans one view of the
table, so every bucket it computes encodes against the same
dictionaries, and its gens are read from that view.

The ``dist`` hook (``cluster/partialcache.py``, on a read-tier querier)
asks a warm peer replica for the stale buckets before scanning them;
``warm_keys`` and ``peek_buckets`` are the serving side. A fetched slice
is stored under the (mark, gens) read before the fetch, so a write that
races the round trip can only leave a stale entry, as a local fill.

Admission goes through the learned cost hook (``query/costmodel.py``):
queries whose observed cold cost stays under DF_QUERY_CACHE_MIN_NS are
not worth an entry. DF_QUERY_CACHE=0 bypasses entirely.

Self-telemetry: one ``query.cache`` hop ledger — emitted=lookups,
delivered=hits, dropped{miss|stale|bypass}; evictions are a separate
counter surfaced in /v1/health.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.query import qtrace
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.query.costmodel import KernelCostModel


# a refill's first measured way: serial under this many morsels of rows
# (one bucket's scan passes over them all), the pool from it up
_POOL_FIRST_MORSELS = 4


def normalize_sql(sql: str) -> str:
    return " ".join(sql.split())


def change_token(table) -> list:
    """Result-validity token: [watermark, [[dict, gen], ...]].

    Deliberately NOT the full sync_state(): dictionary LENGTH is
    excluded because a dictionary can grow without a row write (a query
    never adds strings, but the reference's federation remap does).
    Growth is append-only within a gen, and rows only ever reference ids
    minted by writes (which bump the watermark), so extra entries cannot
    change any answer. Gen flips (compaction) rebind ids and DO
    invalidate."""
    wm, dicts = table.sync_state()
    return [wm, [[n, g] for n, g, _l in dicts]]


def _gens(view) -> tuple:
    """The (column, gen) pairs of a view's dictionaries: the id space of
    the encoded partials computed over it."""
    return tuple(sorted((n, d.gen) for n, d in view.dicts.items()))


class QueryCache:
    def __init__(self, max_entries: int = 128, max_buckets: int = 512,
                 telemetry=None) -> None:
        self.max_entries = max_entries
        self.max_buckets = max_buckets
        self._lock = threading.Lock()
        # (table, sql, extra) -> (token, QueryResult)
        self._results: OrderedDict[tuple, tuple] = OrderedDict()
        # (table, sql, extra) -> OrderedDict{bucket: (mark, gens, partial)}
        self._buckets: OrderedDict[tuple, OrderedDict] = OrderedDict()
        self.counters = {"hits": 0, "misses": 0, "stale": 0, "bypass": 0,
                         "evictions": 0, "bucket_hits": 0,
                         "bucket_misses": 0, "bucket_pruned": 0,
                         # buckets a peer replica served (dist hook)
                         "dist_hits": 0}
        self._hop = telemetry.hop("query.cache") if telemetry else None
        # learned cold-cost per cached query shape (admission hook)
        self.cost = KernelCostModel(kernels=("cold", "warm"))
        # per table: stale buckets refilled one after another or on the
        # scan pool. A bucket's scan is interpreter work beside a native
        # pass over the table's rows, so the pool loses to the serial
        # loop on a small table and wins on a large one (query_refill.py)
        self._refill: dict[str, KernelCostModel] = {}
        # the cluster-wide partial cache's hook: dist(table, key,
        # [bucket, ...], gens) -> {bucket: partial} of slices a warm peer
        # computed, in LOCAL dictionary ids. None: a single node
        self.dist = None

    # -- helpers -------------------------------------------------------------

    _OUTCOME_KEY = {"hit": "hits", "miss": "misses", "stale": "stale",
                    "bypass": "bypass"}

    def _account(self, outcome: str) -> None:
        with self._lock:
            self.counters[self._OUTCOME_KEY[outcome]] += 1
        if self._hop is not None:
            if outcome == "hit":
                self._hop.account(emitted=1, delivered=1)
            else:
                self._hop.account(emitted=1, dropped=1, reason=outcome)

    @staticmethod
    def _enabled() -> bool:
        return os.environ.get("DF_QUERY_CACHE", "1") != "0"

    @staticmethod
    def _min_ns() -> float:
        try:
            return float(os.environ.get("DF_QUERY_CACHE_MIN_NS", "0"))
        except ValueError:
            return 0.0

    @staticmethod
    def _copy_result(res: engine.QueryResult) -> engine.QueryResult:
        return engine.QueryResult(columns=list(res.columns),
                                  values=[list(r) for r in res.values])

    # -- whole-result layer --------------------------------------------------

    def execute(self, table, sql: str, *, select=None,
                extra_key=None) -> engine.QueryResult:
        """engine.execute() through the cache. `select` is an optional
        pre-parsed (possibly rewritten — org scoping) AST to run instead
        of parsing `sql`; any rewrite not visible in the SQL text must be
        reflected in `extra_key` or rewritten variants would collide."""
        query = select if select is not None else sql
        if not self._enabled():
            self._account("bypass")
            qtrace.span("cache.lookup", layer="result",
                        outcome="bypass").finish()
            return engine.execute(table, query)
        key = (table.name, normalize_sql(sql), extra_key)
        token = change_token(table)  # BEFORE executing: stale-safe
        with self._lock:
            ent = self._results.get(key)
            if ent is not None:
                self._results.move_to_end(key)
        if ent is not None and ent[0] == token:
            self._account("hit")
            self.cost.observe("warm", 1, 1.0)
            qtrace.span("cache.lookup", layer="result",
                        outcome="hit").finish()
            return self._copy_result(ent[1])
        outcome = "stale" if ent is not None else "miss"
        self._account(outcome)
        qtrace.span("cache.lookup", layer="result",
                    outcome=outcome).finish()
        t0 = time.perf_counter_ns()
        res = self._execute_cold(table, query, key)
        cold_ns = time.perf_counter_ns() - t0
        self.cost.observe("cold", 1, cold_ns)
        if cold_ns >= self._min_ns():
            with self._lock:
                self._results[key] = (token, self._copy_result(res))
                self._results.move_to_end(key)
                while len(self._results) > self.max_entries:
                    self._results.popitem(last=False)
                    self.counters["evictions"] += 1
        return res

    def _execute_cold(self, table, query, key: tuple):
        """Cold fill: bucketed partial plan when eligible, plain scan
        otherwise. Cold AND warm both go through the bucket partials for
        a bucketable query, so repeats are self-consistent."""
        try:
            if isinstance(query, str):
                query = S.parse(query)
            got = self._bucket_partials(table, query, key)
            if got is not None:
                view, parts = got
                combined = engine.combine_partials(view, query, parts)
                return engine.merge_partials(view, query, [combined])
        except engine._FastUnsupported:
            self._drop_buckets(key)
        except engine.QueryError:
            raise
        except Exception:
            self._drop_buckets(key)
        return engine.execute(table, query)

    # -- bucketed partial layer ----------------------------------------------

    @staticmethod
    def _bucketable(table, query: S.Select) -> bool:
        if os.environ.get("DF_QUERY_ENCODED", "1") == "0":
            return False
        norm = engine._normalize(table, query)
        if not engine._is_agg_query(norm):
            return False
        # PERCENTILE: the scan uses exact np.percentile while the partial
        # form is a sketch — caching would change answers. LAST:
        # cross-bucket timestamp ties could resolve differently.
        return not any(s.name in ("PERCENTILE", "LAST")
                       for s in engine._agg_sites(norm))

    def _bucket_partials(self, table, query: S.Select, key: tuple):
        """(view, per-bucket encoded partials) for an eligible aggregate
        query, reusing every bucket whose (write mark, dict gens) is
        unchanged; every stale bucket is scanned over ``view``. None when
        the query or the table isn't bucketable."""
        if not self._bucketable(table, query):
            return None
        _wm, marks, wide, div = table.bucket_marks()
        tc = table._time_col
        if div <= 0 or tc is None or wide or len(marks) > self.max_buckets:
            return None
        view = table.view()  # after the marks: stale-safe
        gens = _gens(view)
        with self._lock:
            store = self._buckets.get(key)
            if store is None:
                store = self._buckets[key] = OrderedDict()
                self._buckets.move_to_end(key)
                while len(self._buckets) > self.max_entries:
                    self._buckets.popitem(last=False)
                    self.counters["evictions"] += 1
            # buckets gone from the mark grid can never validate again
            for b in [b for b in store if b not in marks]:
                del store[b]
                self.counters["bucket_pruned"] += 1
            ordered = sorted(marks.items())
            slot: dict[int, dict] = {}
            stale: list[tuple[int, int]] = []
            for b, mark in ordered:
                ent = store.get(b)
                if ent is not None and ent[0] == mark and ent[1] == gens:
                    self.counters["bucket_hits"] += 1
                    slot[b] = ent[2]
                else:
                    stale.append((b, mark))
        if stale and self.dist is not None:
            stale = self._fetch_peer(table, key, stale, gens, store, slot)
        qtrace.annotate(buckets=len(ordered), bucket_stale=len(stale))
        if stale:
            def _scan(bm):
                b, _mark = bm
                bq = self._bucket_query(query, tc, b * div, (b + 1) * div)
                return engine.execute_partial(view, bq, encoded=True)
            # stale buckets recompute serially or on the shared scan pool
            # (each bucket's execute_partial runs serially inside its
            # worker: the in_worker guard stops nested fan-out), as the
            # table's refill model predicts cheaper per row scanned
            p = qpool.get_pool()
            if p is not None and len(stale) > 1:
                scanned = len(view) * len(stale)
                with self._lock:
                    model = self._refill.get(table.name)
                    if model is None:
                        # the way measured first: the pool from
                        # _POOL_FIRST_MORSELS morsels of rows up
                        big = len(view) >= (_POOL_FIRST_MORSELS
                                            * engine._morsel_rows())
                        model = self._refill[table.name] = KernelCostModel(
                            kernels=(("pool", "serial") if big
                                     else ("serial", "pool")),
                            overhead_ns={"pool": 500_000.0})
                how = model.choose(scanned)
                t0 = time.perf_counter_ns()
                outs = (p.map(_scan, stale) if how == "pool"
                        else [_scan(bm) for bm in stale])
                model.observe(how, scanned, time.perf_counter_ns() - t0)
                qtrace.annotate(refill=how)
            else:
                outs = [_scan(bm) for bm in stale]
            for (b, mark), part in zip(stale, outs):
                if part.get("kind") != "agg":
                    return None
                with self._lock:
                    self.counters["bucket_misses"] += 1
                    store[b] = (mark, gens, part)
                slot[b] = part
        return view, [slot[b] for b, _m in ordered]

    def _fetch_peer(self, table, key: tuple, stale: list, gens: tuple,
                    store: OrderedDict, slot: dict) -> list:
        """The stale buckets a warm peer serves go into the store and
        the slots; returns the buckets still to scan."""
        try:
            got = self.dist(table, key, [b for b, _m in stale], gens)
        except Exception:
            got = {}
        if not got:
            return stale
        still = []
        for b, mark in stale:
            part = got.get(b)
            if part is not None and part.get("kind") == "agg":
                with self._lock:
                    self.counters["dist_hits"] += 1
                    store[b] = (mark, gens, part)
                slot[b] = part
            else:
                still.append((b, mark))
        return still

    def partial(self, table, sql: str, *, select=None,
                extra_key=None) -> dict:
        """engine.execute_partial(encoded=True) through the bucket cache:
        a warm shard answers a scatter by folding cached bucket slices
        instead of rescanning (the shard-side half of federation)."""
        query = select if select is not None else sql
        if not self._enabled():
            return engine.execute_partial(table, query, encoded=True)
        key = (table.name, normalize_sql(sql), extra_key)
        try:
            if isinstance(query, str):
                query = S.parse(query)
            got = self._bucket_partials(table, query, key)
            if got is not None:
                view, parts = got
                return engine.combine_partials(view, query, parts)
        except engine._FastUnsupported:
            self._drop_buckets(key)
        except engine.QueryError:
            raise
        except Exception:
            self._drop_buckets(key)
        return engine.execute_partial(table, query, encoded=True)

    @staticmethod
    def _bucket_query(query: S.Select, tc: str, lo: int,
                      hi: int) -> S.Select:
        rng = S.BinOp("AND",
                      S.BinOp(">=", S.Col(tc), S.Lit(int(lo))),
                      S.BinOp("<", S.Col(tc), S.Lit(int(hi))))
        # the bucket's range first: it keeps at most a bucket's rows, so
        # the scan's later conjuncts read only those (engine._select_rows)
        where = rng if query.where is None else \
            S.BinOp("AND", rng, query.where)
        # ORDER BY/LIMIT apply at the merge, not per slice; HAVING rides
        # along so its aggregate sites ship in the partial (it is only
        # APPLIED at the merge)
        return S.Select(items=query.items, table=query.table, where=where,
                        group_by=query.group_by, having=query.having,
                        order_by=[], limit=None)

    def _drop_buckets(self, key: tuple) -> None:
        with self._lock:
            self._buckets.pop(key, None)

    # -- the partial cache's serving side ------------------------------------

    def warm_keys(self) -> list[tuple]:
        """Bucket-store keys holding at least one slice: the adverts'
        source (membership gossips digests of the shareable ones)."""
        with self._lock:
            return [k for k, v in self._buckets.items() if v]

    def peek_buckets(self, table, sql: str, extra_keys: list,
                     wanted: list) -> dict:
        """The cached slices of the wanted buckets that are valid NOW,
        under any of the candidate key variants. Validated against this
        node's own marks and dictionary gens; the caller established
        that the requester's table holds the same rows (the read tier's
        publish token)."""
        _wm, marks, wide, div = table.bucket_marks()
        if div <= 0 or wide:
            return {}
        gens = tuple(sorted((n, d.gen) for n, d in table.dicts.items()))
        norm = normalize_sql(sql)
        out: dict[int, dict] = {}
        with self._lock:
            for ek in extra_keys:
                store = self._buckets.get((table.name, norm, ek))
                if not store:
                    continue
                for b in wanted:
                    if b in out or b not in marks:
                        continue
                    ent = store.get(b)
                    if ent is not None and ent[0] == marks[b] \
                            and ent[1] == gens:
                        out[b] = ent[2]
        return out

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._results),
                    "bucket_queries": len(self._buckets),
                    "bucket_slices": sum(len(v)
                                         for v in self._buckets.values()),
                    **self.counters,
                    "cost": self.cost.snapshot()}
