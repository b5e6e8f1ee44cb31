"""The read tier: the querier side of the shared object store.

Own copy of ``deepflow_tpu/store/segcache.py``, whole. An ingest shard
publishes its sealed tier (segment blobs and dictionary dumps behind one
atomic ``MANIFEST-<shard>`` pointer, ``store/objstore.py``) after its
commit point. A stateless querier replica polls those pointers
(``ReadTier.poll``) and adopts the published segments into
``RemoteTableTier`` facades attached through the table's own
``attach_tier`` / ``note_tier_publish`` / ``note_tier_evict``, so the
query cache's change tokens move exactly as if the rows had flushed
locally. A remote tier answers the local tier's ``units()`` surface, so
``ColumnarTable.scan_units`` / ``view()`` and the engine's zone, zstr and
skip-index pruning take it as they take the local one. Segment bytes are
fetched lazily, on first column touch, into a byte-budgeted local LRU
(``SegmentCache``) and opened with the ordinary mmap ``Segment`` reader;
eviction is ledgered on the ``readtier.segcache`` hop (emitted = dropped =
rows, reason ``segment_evict``, as the janitor's tier eviction), and a
segment evicted while a scan still holds its chunk keeps its file until
the last reference drops (refcounted pins, deferred unlink).

Dictionary ids inside published segments live in the PUBLISHER's id
space. The ReadTier mirrors every published dictionary dump through a
private ``cluster.dictsync.DictSync`` and eagerly prebuilds the
publisher-to-local remap arrays, which (a) makes every remote string
column readable in local ids (``RemoteChunk`` remaps on first touch) and
(b) encodes every published string into the querier's local
dictionaries: the local dictionary is a superset of every published id
space, so the planner's literal coercion (``engine._zone_coerce``: a
dictionary miss prunes) stays sound on a querier.

The filter views at the end drop whole scan units for the publish-gen
handshake: ``PublishedExcludeView`` on an ingest shard (answer without
the published segments), ``ShardExcludeView`` on the coordinator (drop a
shard's adopted segments when it answered in full). Each returns a
``TableView`` from ``view()``, the engine's entry, as the replication
ring's claim view does; a ``RemoteSegment`` names its publisher as
``claim_as``, so under a ring the claim view claims a published segment's
rows as the shard that published them.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from collections.abc import Mapping

import numpy as np

from deepflow_tpu_torch.query import qtrace
from deepflow_tpu_torch.store import objstore
from deepflow_tpu_torch.store.segment import Segment, SegmentError
from deepflow_tpu_torch.store.table import TableView

log = logging.getLogger("df.segcache")


def _unpin(cache: "SegmentCache", ent: dict) -> None:
    # module-level finalize callback: must not close over the pinned
    # chunk (a self-reference would keep the finalizer from ever firing)
    cache._release(ent)


class SegmentCache:
    """Byte-budgeted LRU of fetched segment files, mmap'd once each.

    Entries are keyed (shard, table, filename) — segment blobs are
    immutable, so a key never changes content. Concurrent first
    touches of the same segment elect one fetch leader per key
    (per-key in-flight events); everyone else waits and re-reads.
    Eviction pops the LRU head: an unpinned entry's file is unlinked
    immediately, a pinned one is condemned and unlinked by the last
    pin's finalizer (numpy views keep the mmap pages alive past the
    unlink either way — this only bounds DISK usage honestly)."""

    def __init__(self, root: str, store, max_bytes: int = 256 << 20,
                 telemetry=None, alt_stores=None) -> None:
        self.root = root
        self.store = store
        # alternate replicas' object stores (read-only): a fetch that
        # fails against the primary — missing blob, I/O error, or a
        # copy that fails checksum verification — falls over to these
        # in order. Blobs are immutable, so any replica's copy of the
        # same key is byte-identical by contract.
        self.alt_stores = list(alt_stores or [])
        self.max_bytes = int(max_bytes)
        os.makedirs(root, exist_ok=True)
        self._wipe_leftovers()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self._inflight: dict[tuple, threading.Event] = {}
        # pin releases that could not take _lock (finalizer fired in a
        # thread already holding it); drained by pin/discard/snapshot
        self._pending: "deque[dict]" = deque()
        # per-key fetch failure state: key -> (consec_fails, next_try
        # monotonic). A key whose every source just failed is not
        # re-hammered on each scan — retries back off exponentially
        # (bounded at 30s) and the query gets the error immediately.
        self._backoff: dict[tuple, tuple[int, float]] = {}
        self._hop = (telemetry.hop("readtier.segcache")
                     if telemetry else None)
        self.stats = {"fetches": 0, "hits": 0, "misses": 0,
                      "evictions": 0, "deferred_unlinks": 0,
                      "rows_evicted": 0, "bytes_evicted": 0,
                      "fetch_errors": 0, "fetch_failover": 0,
                      "fetch_corrupt": 0, "fetch_backoffs": 0,
                      "bytes": 0, "segments": 0}

    def _wipe_leftovers(self) -> None:
        # a restarted querier starts cold: files from a previous process
        # are untracked (and their blobs may be GC'd) — drop them
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                try:
                    os.unlink(os.path.join(dirpath, f))
                except OSError:
                    pass

    # -- lookup ---------------------------------------------------------------

    def peek(self, key: tuple):
        """The cached Segment for key, or None. No fetch, no LRU touch,
        no pin — the planner's zone/index probes ride this."""
        with self._lock:
            ent = self._entries.get(key)
            return ent["seg"] if ent is not None else None

    def pin(self, rseg, holder) -> dict:
        """Fetch-if-needed and pin rseg's segment for ``holder``'s
        lifetime (a weakref finalizer on holder releases the pin).
        Returns the cache entry; entry["seg"] is the open Segment."""
        self._drain_releases()
        key = rseg.key
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    ent["refs"] += 1
                    weakref.finalize(holder, _unpin, self, ent)
                    self.stats["hits"] += 1
                    qtrace.bump("segcache_hits")
                    return ent
                ev = self._inflight.get(key)
                leader = ev is None
                if leader:
                    ev = self._inflight[key] = threading.Event()
            if not leader:
                # wait for the leader, then loop: on leader failure the
                # entry is absent and a waiter becomes the next leader
                ev.wait(timeout=60.0)
                continue
            try:
                # a miss is an objstore round-trip + mmap open: that
                # latency belongs on the query's trace, named
                with qtrace.span("segcache.fetch", table=rseg.table,
                                 shard=rseg.shard, fn=rseg.fn):
                    ent = self._fetch(rseg)
            except Exception:
                with self._lock:
                    self._inflight.pop(key, None)
                    self.stats["fetch_errors"] += 1
                ev.set()
                raise
            with self._lock:
                self._inflight.pop(key, None)
                self._entries[key] = ent
                self.stats["misses"] += 1
                self.stats["fetches"] += 1
                self.stats["bytes"] += ent["size"]
                self.stats["segments"] += 1
                ent["refs"] += 1
                weakref.finalize(holder, _unpin, self, ent)
                doomed = self._evict_over_budget_locked()
            ev.set()
            for e in doomed:
                self._unlink(e)
            return ent

    def _fetch(self, rseg) -> dict:
        with self._lock:
            bo = self._backoff.get(rseg.key)
            if bo is not None and time.monotonic() < bo[1]:
                self.stats["fetch_backoffs"] += 1
                raise OSError(
                    f"segcache: fetch of {rseg.key} backing off "
                    f"after {bo[0]} failures")
        dst_dir = os.path.join(self.root, str(rseg.shard), rseg.table)
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, rseg.fn)
        key = objstore.seg_key(rseg.shard, rseg.table, rseg.fn)
        err: Exception | None = None
        for i, store in enumerate([self.store] + self.alt_stores):
            try:
                size = store.fetch(key, dst)
                seg = Segment.open(dst)
                # verify-on-fetch: a copy that fails its block crcs is
                # discarded HERE, before any scan maps it — the next
                # source (an alternate replica's copy) gets its turn
                v = seg.verify()
                if v["corrupt"]:
                    self.stats["fetch_corrupt"] += 1
                    raise SegmentError(
                        f"{key}: fetched copy corrupt "
                        f"(blocks {v['corrupt']})")
            except (OSError, SegmentError) as e:
                err = e
                try:
                    os.unlink(dst)
                except OSError:
                    pass
                continue
            if i:
                self.stats["fetch_failover"] += 1
            with self._lock:
                self._backoff.pop(rseg.key, None)
            return {"key": rseg.key, "seg": seg, "size": size,
                    "path": dst, "rows": seg.rows, "refs": 0,
                    "condemned": False, "unlinked": False}
        with self._lock:
            fails = (self._backoff.get(rseg.key) or (0, 0.0))[0] + 1
            self._backoff[rseg.key] = (fails, time.monotonic() + min(
                0.5 * (2 ** min(fails, 6)), 30.0))
        assert err is not None
        raise err

    # -- eviction -------------------------------------------------------------

    def _evict_over_budget_locked(self) -> list[dict]:
        """Pop LRU entries until under budget (never the sole —
        just-inserted — entry). Returns the unpinned ones for the
        caller to unlink outside the lock."""
        doomed = []
        while self.stats["bytes"] > self.max_bytes \
                and len(self._entries) > 1:
            _k, ent = self._entries.popitem(last=False)
            ent["condemned"] = True
            self.stats["bytes"] -= ent["size"]
            self.stats["segments"] -= 1
            self.stats["evictions"] += 1
            self.stats["rows_evicted"] += ent["rows"]
            self.stats["bytes_evicted"] += ent["size"]
            if self._hop is not None:
                self._hop.account(emitted=ent["rows"],
                                  dropped=ent["rows"],
                                  reason="segment_evict")
            if ent["refs"] > 0:
                self.stats["deferred_unlinks"] += 1
            else:
                doomed.append(ent)
        return doomed

    def discard(self, key: tuple) -> None:
        """Drop a segment the manifest no longer vouches for (publisher
        compacted/evicted it). Row accounting is the ReadTier's job
        (note_tier_evict) — no eviction ledger here."""
        self._drain_releases()
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return
            ent["condemned"] = True
            self.stats["bytes"] -= ent["size"]
            self.stats["segments"] -= 1
            dead = ent["refs"] <= 0
            if not dead:
                self.stats["deferred_unlinks"] += 1
        if dead:
            self._unlink(ent)

    def _release(self, ent: dict) -> None:
        # weakref.finalize callback: can fire during GC at any
        # allocation point — including in a thread that currently holds
        # _lock inside pin()/discard() — and _lock is non-reentrant, so
        # blocking on it here would self-deadlock. Enqueue the release
        # (deque.append is atomic) and drain opportunistically: the
        # try-acquire fails exactly in the dangerous re-entrant case,
        # where the next pin/discard/snapshot drains instead.
        self._pending.append(ent)
        self._drain_releases(blocking=False)

    def _drain_releases(self, blocking: bool = True) -> None:
        if not self._pending:
            return
        if not self._lock.acquire(blocking=blocking):
            return
        doomed = []
        try:
            while True:
                try:
                    ent = self._pending.popleft()
                except IndexError:
                    break
                ent["refs"] -= 1
                if ent["condemned"] and ent["refs"] <= 0:
                    doomed.append(ent)
        finally:
            self._lock.release()
        for e in doomed:
            self._unlink(e)

    def _unlink(self, ent: dict) -> None:
        with self._lock:
            if ent["unlinked"]:
                return
            cur = self._entries.get(ent["key"])
            if cur is not None and cur is not ent \
                    and cur["path"] == ent["path"]:
                # the key was re-fetched to the same destination after
                # this entry was condemned — the file on disk now
                # belongs to the live entry, not this one
                ent["unlinked"] = True
                return
            ent["unlinked"] = True
        try:
            os.unlink(ent["path"])
        except OSError:
            pass

    def entries(self) -> list[tuple[tuple, dict]]:
        """Point-in-time (key, entry) pairs — the scrubber's walk
        surface. Entries may be discarded concurrently; callers treat
        each one as best-effort."""
        with self._lock:
            return list(self._entries.items())

    def snapshot(self) -> dict:
        self._drain_releases()
        with self._lock:
            out = dict(self.stats)
        out["max_bytes"] = self.max_bytes
        out["backoff_keys"] = len(self._backoff)
        return out


class RemoteSegment:
    """Planner-facing stand-in for a published segment this node may
    not have fetched yet. Pre-fetch it answers the pruning protocol
    conservatively (time zone from the manifest, no skip indexes);
    once the bytes are cached it delegates — translating between the
    querier's local dictionary ids and the publisher's where the two
    spaces differ (str columns only; enum ids are schema-global)."""

    __slots__ = ("tier", "shard", "table", "fn", "rows", "tmin", "tmax",
                 "nbytes", "time_col", "key", "path")

    @property
    def claim_as(self) -> int:
        """The shard whose claim decides this segment's rows under a
        replication ring: its publisher (cluster/hashring.py)."""
        return self.shard

    def __init__(self, tier, shard: int, table: str, fn: str,
                 meta: dict) -> None:
        self.tier = tier
        self.shard = int(shard)
        self.table = table
        self.fn = fn
        self.rows = int(meta.get("rows") or 0)
        self.tmin = meta.get("tmin")
        self.tmax = meta.get("tmax")
        self.nbytes = int(meta.get("bytes") or 0)
        self.time_col = meta.get("time_col")
        self.key = (self.shard, table, fn)
        self.path = f"objstore://{self.shard}/{table}/{fn}"

    def _cached(self):
        return self.tier.cache.peek(self.key)

    def _is_str(self, name: str) -> bool:
        cols = self.tier._columns or {}
        spec = cols.get(name)
        return spec is not None and getattr(spec, "kind", "") == "str"

    def zone_map(self) -> dict:
        seg = self._cached()
        if seg is None:
            if self.time_col and self.tmin is not None \
                    and self.tmax is not None:
                return {self.time_col: (self.tmin, self.tmax)}
            return {}
        # str-column zones are (zmin, zmax) over PUBLISHER ids — order
        # does not survive the remap, so they are dropped; str_zone
        # (string-order, remap-invariant) still prunes those columns
        return {n: z for n, z in seg.zones.items()
                if not self._is_str(n)}

    def has_index(self, name: str) -> bool:
        seg = self._cached()
        return False if seg is None else seg.has_index(name)

    def str_zone(self, name: str):
        seg = self._cached()
        return None if seg is None else seg.str_zone(name)

    def maybe_contains(self, name: str, sids) -> bool:
        seg = self._cached()
        if seg is None:
            return True
        if self._is_str(name):
            inv = self.tier.readtier.inverse_map(self.shard, self.table,
                                                 name)
            if inv is None:
                return True
            pub = {inv[s] for s in (int(x) for x in sids) if s in inv}
            if not pub:
                # none of the local ids has a published counterpart on
                # this shard => provably absent from this segment
                return False
            sids = pub
        return seg.maybe_contains(name, sids)

    def chunk(self, columns=None, fills=None) -> "RemoteChunk":
        return RemoteChunk(self, columns, fills)

    def __repr__(self) -> str:
        return (f"RemoteSegment({self.shard}/{self.table}/{self.fn}, "
                f"rows={self.rows}, cached={self._cached() is not None})")


class RemoteChunk(Mapping):
    """Lazy {column -> ndarray} over a RemoteSegment. The segment is
    fetched and pinned on the FIRST column touch and the pin lives as
    long as this chunk object — scan_units hands a fresh RemoteChunk
    to every scan, so a pin is exactly one in-flight scan's reference
    and eviction defers the unlink until the slowest scan drops it.
    str-kind columns are remapped publisher->local on first read."""

    def __init__(self, rseg: RemoteSegment, columns, fills) -> None:
        self._rseg = rseg
        self._columns = columns or {}
        self._fills = fills or {}
        self._names = list(self._columns)
        self._lock = threading.Lock()
        self._lazy = None
        self._seg = None
        self._cols: dict = {}
        self.rows = rseg.rows

    def _chunk(self):
        with self._lock:
            if self._lazy is None:
                ent = self._rseg.tier.cache.pin(self._rseg, self)
                self._seg = ent["seg"]
                self._lazy = ent["seg"].chunk(self._columns, self._fills)
            return self._lazy

    def __getitem__(self, name: str):
        arr = self._cols.get(name)
        if arr is not None:
            return arr
        if self._names and name not in self._columns:
            raise KeyError(name)
        lazy = self._chunk()
        arr = lazy[name]
        if name in self._seg._cols and self._rseg._is_str(name):
            remap = self._rseg.tier.readtier.remap_for(
                self._rseg.shard, self._rseg.table, name)
            if remap is None:
                raise LookupError(
                    f"readtier: no dictionary mirror for shard "
                    f"{self._rseg.shard} {self._rseg.table}.{name}")
            arr = remap[arr]
        self._cols[name] = arr
        return arr

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name) -> bool:
        return name in self._columns


class RemoteTableTier:
    """One table's adopted remote segments across every publishing
    shard — the querier-side counterpart of store.tiered.TableTier,
    attached through the same ``table.attach_tier`` and answering the
    same units()/rows/span() surface (scan planner included). Fresh
    RemoteChunk objects per units() call keep the pin lifetime equal
    to the scan lifetime."""

    def __init__(self, name: str, cache: SegmentCache, readtier) -> None:
        self.name = name
        self.cache = cache
        self.readtier = readtier
        self._lock = threading.Lock()
        self._segments: dict[tuple, RemoteSegment] = {}
        # set by ColumnarTable.attach_tier, same as the local tier
        self._columns = None
        self._fills: dict = {}

    # -- adoption (ReadTier only; tier lock never nests a table lock) --------

    def adopt(self, rsegs: list[RemoteSegment]) -> None:
        with self._lock:
            for r in rsegs:
                self._segments[(r.shard, r.fn)] = r

    def remove(self, shard: int, fns: list[str]) -> list[RemoteSegment]:
        out = []
        with self._lock:
            for fn in fns:
                r = self._segments.pop((int(shard), fn), None)
                if r is not None:
                    out.append(r)
        return out

    # -- TableTier read surface ----------------------------------------------

    def segments(self) -> list[RemoteSegment]:
        with self._lock:
            return [r for _k, r in sorted(self._segments.items())]

    def units(self) -> list[tuple]:
        segs = [r for r in self.segments() if r.rows]
        return [(RemoteChunk(r, self._columns, self._fills),
                 r.zone_map(), r) for r in segs]

    def chunks(self) -> list:
        return [u[0] for u in self.units()]

    def zoned_count(self) -> int:
        return sum(1 for r in self.segments()
                   if self.cache.peek(r.key) is not None)

    @property
    def rows(self) -> int:
        with self._lock:
            return sum(r.rows for r in self._segments.values())

    @property
    def bytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._segments.values())

    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments)

    def span(self) -> tuple:
        with self._lock:
            tmins = [r.tmin for r in self._segments.values()
                     if r.tmin is not None]
            tmaxs = [r.tmax for r in self._segments.values()
                     if r.tmax is not None]
        return (min(tmins) if tmins else None,
                max(tmaxs) if tmaxs else None)


class ReadTier:
    """Pointer-poll adoption loop + per-shard publish bookkeeping.

    ``poll()`` reads every ``MANIFEST-*`` pointer in the object store
    and applies the ones whose publish_gen moved: dictionary dumps
    first (mirror + eager remap prebuild), then the segment diff
    (removed -> cache discard + note_tier_evict; added ->
    RemoteSegment + note_tier_publish). Everything applies under ONE
    re-entrant adoption lock, which ``freeze()`` exposes so a
    coordinator can pin a consistent snapshot across an entire
    federated query — a pointer swap mid-query waits, never tears."""

    def __init__(self, db, store, cache: SegmentCache,
                 shard_id: int = 0) -> None:
        from deepflow_tpu_torch.cluster.dictsync import DictSync
        self.db = db
        self.store = store
        self.cache = cache
        self.shard_id = int(shard_id)
        # PRIVATE mirror of published dumps only — never shared with the
        # federation DictSync, whose mirrors track live shard state and
        # may run ahead of (or behind) what the pointers reference
        self.dictsync = DictSync()
        self._adopt_lock = threading.RLock()
        self._tiers: dict[str, RemoteTableTier] = {}
        self._adopted: dict[int, int] = {}          # shard -> publish_gen
        self._pub_state: dict[str, dict] = {}       # table -> shard -> {...}
        self._pub_tokens: dict[str, str] = {}
        self._dict_seen: dict[tuple, tuple] = {}    # (sh,tb,col)->(gen,ver)
        self._dict_gen: dict[tuple, tuple] = {}     # (sh,tb,col)->(gen,len)
        self._inverse: dict[tuple, tuple] = {}      # (sh,tb,col)->(n,{l:p})
        self.stats = {"polls": 0, "adoptions": 0, "segments_adopted": 0,
                      "segments_removed": 0, "dict_syncs": 0,
                      "errors": 0}

    # -- adoption -------------------------------------------------------------

    def poll(self) -> int:
        """Apply every pointer whose gen moved. Returns pointers
        applied. A failed apply (e.g. a blob GC'd between pointer read
        and fetch — the publisher re-swapped mid-poll) is skipped and
        retried whole on the next poll; gens only advance on success."""
        self.stats["polls"] += 1
        applied = 0
        for name in self.store.list_pointers():
            doc = self.store.get_pointer(name)
            if not isinstance(doc, dict):
                continue
            try:
                shard = int(doc.get("shard_id") or 0)
                gen = int(doc.get("publish_gen") or 0)
            except (TypeError, ValueError):
                continue
            if shard <= 0 or shard == self.shard_id:
                continue
            if self._adopted.get(shard, 0) >= gen:
                continue
            try:
                self._apply(shard, gen, doc)
                applied += 1
            except Exception:
                self.stats["errors"] += 1
                log.warning("readtier: applying %s failed", name,
                            exc_info=True)
        return applied

    def _apply(self, shard: int, gen: int, doc: dict) -> None:
        tables = doc.get("tables") or {}
        with self._adopt_lock:
            for tname, tdoc in tables.items():
                try:
                    t = self.db.table(tname)
                except KeyError:
                    continue
                rt = self._ensure_tier(tname, t)
                if rt is None:
                    continue
                # dumps before segments: every id a segment ships must
                # already have a local remap when the first scan reads it
                self._adopt_dicts(shard, tname, t,
                                  tdoc.get("dicts") or {})
                self._diff_segments(shard, tname, t, rt,
                                    tdoc.get("segments") or [])
                self._note_state(tname, shard, tdoc)
            # tables this shard stopped publishing entirely
            for tname, st in list(self._pub_state.items()):
                if shard in st and tname not in tables:
                    try:
                        t = self.db.table(tname)
                    except KeyError:
                        continue
                    rt = self._tiers.get(tname)
                    if rt is not None:
                        self._diff_segments(shard, tname, t, rt, [])
                    st.pop(shard, None)
                    self._retoken(tname)
            self._adopted[shard] = gen
            self.stats["adoptions"] += 1

    def _ensure_tier(self, name: str, t) -> RemoteTableTier | None:
        rt = self._tiers.get(name)
        if rt is not None:
            return rt
        if t.tier is not None:
            # local storage attached — an ingest shard must not adopt
            # the read tier on top of its own segments
            self.stats["errors"] += 1
            log.error("readtier: table %s already has a local tier; "
                      "refusing remote adoption", name)
            return None
        rt = RemoteTableTier(name, self.cache, self)
        self._tiers[name] = rt
        t.attach_tier(rt)  # zero segments yet: rows 0, span (None, None)
        return rt

    def _adopt_dicts(self, shard: int, tname: str, t,
                     dicts: dict) -> None:
        for col, gv in dicts.items():
            if col not in t.dicts:
                continue
            try:
                gen, ver = int(gv[0]), int(gv[1])
            except (TypeError, ValueError, IndexError):
                continue
            key = (shard, tname, col)
            if self._dict_seen.get(key) == (gen, ver):
                continue
            raw = self.store.get_bytes(
                objstore.dict_key(shard, tname, col, gen, ver))
            strings = json.loads(raw)
            n = len(strings)
            cur = self.dictsync.known_state(shard, tname).get(col)
            if cur is not None and cur[0] == gen and cur[1] >= n:
                pass  # mirror already covers this dump
            else:
                base = (cur[1] if cur is not None and cur[0] == gen
                        and cur[1] < n else 0)
                ok = self.dictsync.apply_sync(
                    shard, tname, col,
                    {"gen": gen, "len": n, "base": base,
                     "delta": strings[base:]})
                if not ok and base != 0:
                    ok = self.dictsync.apply_sync(
                        shard, tname, col,
                        {"gen": gen, "len": n, "base": 0,
                         "delta": strings})
                if not ok:
                    raise RuntimeError(
                        f"readtier: dict sync failed for {tname}.{col} "
                        f"shard {shard} gen {gen}")
                self.stats["dict_syncs"] += 1
            self._dict_seen[key] = (gen, ver)
            self._dict_gen[key] = (gen, n)
            # eager prebuild: encodes every published string into the
            # LOCAL dictionary — supersets keep local-id pruning sound
            self.dictsync._remap_array(shard, tname, col, t.dicts[col],
                                       gen, n)

    def _diff_segments(self, shard: int, tname: str, t,
                       rt: RemoteTableTier, segs: list) -> None:
        prev = {s.get("fn"): s
                for s in (self._pub_state.get(tname, {})
                          .get(shard, {}).get("segments") or [])}
        new = {s.get("fn"): s for s in segs if s.get("fn")}
        removed = [fn for fn in prev if fn not in new]
        added = [fn for fn in new if fn not in prev]
        if removed:
            gone = rt.remove(shard, removed)
            for r in gone:
                self.cache.discard(r.key)
            rows = sum(r.rows for r in gone)
            tmins = [r.tmin for r in gone if r.tmin is not None]
            tmaxs = [r.tmax for r in gone if r.tmax is not None]
            if gone:
                t.note_tier_evict(rows,
                                  min(tmins) if tmins else None,
                                  max(tmaxs) if tmaxs else None)
            self.stats["segments_removed"] += len(gone)
        if added:
            rsegs = [RemoteSegment(rt, shard, tname, fn, new[fn])
                     for fn in added]
            rt.adopt(rsegs)
            rows = sum(r.rows for r in rsegs)
            tmins = [r.tmin for r in rsegs if r.tmin is not None]
            tmaxs = [r.tmax for r in rsegs if r.tmax is not None]
            t.note_tier_publish(rows,
                                min(tmins) if tmins else None,
                                max(tmaxs) if tmaxs else None)
            self.stats["segments_adopted"] += len(rsegs)

    def _note_state(self, tname: str, shard: int, tdoc: dict) -> None:
        st = self._pub_state.setdefault(tname, {})
        st[shard] = {
            "segments": [dict(s) for s in tdoc.get("segments") or []],
            "dicts": {c: [int(v[0]), int(v[1])]
                      for c, v in (tdoc.get("dicts") or {}).items()},
        }
        self._retoken(tname)

    def _retoken(self, tname: str) -> None:
        st = self._pub_state.get(tname) or {}
        basis = {str(sh): {"fns": sorted(x.get("fn") or ""
                                         for x in v["segments"]),
                           "dicts": v["dicts"]}
                 for sh, v in st.items()}
        self._pub_tokens[tname] = hashlib.sha1(
            json.dumps(basis, sort_keys=True).encode()).hexdigest()[:16]

    # -- query-side surface ---------------------------------------------------

    def freeze(self):
        """Context manager pinning the adopted snapshot: held by the
        coordinator across scatter + local partial so a concurrent
        pointer swap cannot change the answer mid-query."""
        return self._adopt_lock

    def gen_for(self, shard: int) -> int:
        return self._adopted.get(int(shard), 0)

    def pub_token(self, table: str) -> str:
        """Content digest of everything adopted for `table` (fns +
        dict states, all shards) — the distributed partial-aggregate
        cache's cross-replica validity key."""
        return self._pub_tokens.get(table, "")

    def tier(self, table: str) -> RemoteTableTier | None:
        return self._tiers.get(table)

    def remap_for(self, shard: int, table: str, col: str):
        """publisher-id -> local-id uint32 array (or None when the
        shard never published this column's dictionary)."""
        gv = self._dict_gen.get((shard, table, col))
        if gv is None:
            return None
        try:
            t = self.db.table(table)
        except KeyError:
            return None
        d = t.dicts.get(col)
        if d is None:
            return None
        return self.dictsync._remap_array(shard, table, col, d,
                                          gv[0], gv[1])

    def inverse_map(self, shard: int, table: str, col: str):
        """local-id -> publisher-id dict for skip-index probes. The
        remap is injective (unique strings), so inversion is exact;
        a local id with no entry was never published by this shard."""
        arr = self.remap_for(shard, table, col)
        if arr is None:
            return None
        key = (shard, table, col)
        cached = self._inverse.get(key)
        if cached is None or cached[0] != len(arr):
            inv = {int(loc): pub
                   for pub, loc in enumerate(arr.tolist())}
            cached = (len(arr), inv)
            self._inverse[key] = cached
        return cached[1]

    def snapshot(self) -> dict:
        with self._adopt_lock:
            tables = {name: {"segments": rt.segment_count(),
                             "rows": rt.rows, "bytes": rt.bytes,
                             "pub_token": self._pub_tokens.get(name, "")}
                      for name, rt in self._tiers.items()}
            return {"adopted": {str(s): g
                                for s, g in self._adopted.items()},
                    "tables": tables, "stats": dict(self.stats),
                    "dictsync": dict(self.dictsync.counters),
                    "segcache": self.cache.snapshot()}


# -- scan-unit filter views (beside cluster.hashring.ClaimTableView) --------


class _FilterTableView:
    """Read-only table facade dropping whole scan units; everything else
    delegates, so the engines and the query cache run on it unmodified."""

    def __init__(self, table) -> None:
        self._table = table

    def _keep(self, seg) -> bool:  # pragma: no cover - overridden
        return True

    def _filter(self, units) -> list:
        return [u for u in units if self._keep(u[2])]

    def scan_units(self) -> list:
        return self._filter(self._table.scan_units())

    def view(self) -> TableView:
        """The engine's entry: one moment of the table, filtered."""
        v = self._table.view()
        units = self._filter(v.scan_units())
        return TableView(v.name, v.columns, v.dicts,
                         [u[0] for u in units], [u[1:] for u in units])

    def snapshot(self) -> list:
        return [u[0] for u in self.scan_units()]

    def column_concat(self, names) -> dict:
        chunks = self.view().chunks
        return {name: (np.concatenate([ch[name] for ch in chunks])
                       if chunks else np.empty(
                           0, dtype=self._table.columns[name].np_dtype))
                for name in names}

    def __len__(self) -> int:
        return len(self.view())

    def __getattr__(self, name: str):
        return getattr(self._table, name)


def _seg_fn(seg) -> str | None:
    p = getattr(seg, "path", None) if seg is not None else None
    return None if p is None else os.path.basename(p)


class PublishedExcludeView(_FilterTableView):
    """Ingest-shard side of the publish-gen handshake: when the
    coordinator's adopted gen matches this shard's last publish, the
    shard answers WITHOUT its published sealed segments (the read tier
    serves those rows), keeping the live, unflushed and not yet
    published rows only. Federation stitches the two halves exactly
    (disjoint row sets, the same dictionaries).

    The view is taken at construction, and ``complete`` reports whether
    EVERY published fn is still among its units. A compaction (or an
    eviction) can retire published segments before the next publish
    tick refreshes ``publisher.current``; in that window the exclusion
    matches nothing while the replacement run, holding the same rows,
    would still be scanned, so an incomplete view must never back an
    ack: the rows it fails to exclude would be served a second time by
    the coordinator's read tier."""

    def __init__(self, table, fns: frozenset) -> None:
        super().__init__(table)
        self._fns = fns
        v = table.view()
        units = v.scan_units()
        live = {fn for _ch, _z, seg in units
                if (fn := _seg_fn(seg)) is not None}
        self.complete = fns <= live
        kept = self._filter(units)
        # the construction-time moment: the completeness check and every
        # scan over this view see the same units
        self._view = TableView(v.name, v.columns, v.dicts,
                               [u[0] for u in kept], [u[1:] for u in kept])

    def _keep(self, seg) -> bool:
        fn = _seg_fn(seg)
        return fn is None or fn not in self._fns

    def scan_units(self) -> list:
        return self._view.scan_units()

    def view(self) -> TableView:
        return self._view


class PublishedExcludeDb:
    """Database facade returning PublishedExcludeViews for the tables
    with a published fn set."""

    def __init__(self, db, fn_sets: dict) -> None:
        self._db = db
        self._fns = fn_sets

    def table(self, name: str):
        t = self._db.table(name)
        fns = self._fns.get(name)
        return PublishedExcludeView(t, fns) if fns else t

    def tables(self) -> list:
        return self._db.tables()

    def __getattr__(self, name: str):
        return getattr(self._db, name)


class ShardExcludeView(_FilterTableView):
    """Coordinator side of a handshake MISS: a shard that answered
    without a publish ack (gen mismatch, a compaction's window, a peer
    without the read tier) covered its own sealed history in the
    scatter, so its remote segments must not be counted again here."""

    def __init__(self, table, shards) -> None:
        super().__init__(table)
        self._shards = {int(s) for s in shards}

    def _keep(self, seg) -> bool:
        return not (isinstance(seg, RemoteSegment)
                    and seg.shard in self._shards)


class ShardExcludeDb:
    """Database facade returning ShardExcludeViews: a querier's local
    half of the federated surfaces without a handshake (flame graphs,
    PromQL, Tempo, traces), where every answering shard answered for
    its whole history."""

    def __init__(self, db, shards) -> None:
        self._db = db
        self._shards = frozenset(int(s) for s in shards)

    def table(self, name: str):
        return ShardExcludeView(self._db.table(name), self._shards)

    def tables(self) -> list:
        return self._db.tables()

    def __getattr__(self, name: str):
        return getattr(self._db, name)
