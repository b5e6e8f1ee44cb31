"""Consistent-hash ownership: agent_id -> ordered [primary, replica...].

Own copy of ``deepflow_tpu/cluster/hashring.py``: placement is the
reference's bit for bit (md5 points, the same vnode and agent keys), so
a port server, a reference server and an agent agree on every owner
list. The claim views are the port's: its engine scans a ``TableView``
(``table.view()``), so ``ClaimTableView.view()`` hands it the claimed
rows of every scan unit, a tier segment's lazily decoded columns
included. A read tier's published segment (``store/segcache.py``) is
claimed as the shard that published it (its ``claim_as``), and only
once a scan touches it, so a segment the planner prunes is never
fetched.

Reference analog: the controller's Trisolaris agent->analyzer assignment
(controller/trisolaris + controller/monitor rebalance), upgraded from
rendezvous preference to a consistent-hash ring with virtual nodes so
membership changes move only ~1/N of the agents, plus replication: each
agent owns an ordered shard set of size R, ships HIGH/MID frames to all
of them, and queries dedup replica copies back down to exactly one.

Three pieces live here:

* ``HashRing`` — the ring itself. Deterministic (md5, not Python's
  seeded hash), epoch-versioned, carrying a bounded per-epoch membership
  history so rows tagged with an older ring_epoch are still claimed by
  an owner that actually HOLDS them after a rebalance. Adoption is
  fenced: a snapshot is adopted only if its (election token, epoch) pair
  is strictly newer, so a deposed leader's stale ring can never clobber
  the current one.
* ``claim_mask`` / ``ClaimTableView`` / ``ClaimDbView`` — query-time
  replica dedup. Every ingested row is tagged (owner_shard, ring_epoch);
  a row is REPORTED by exactly one shard: the first owner (in the ring
  order of the row's epoch) that is alive for this query. Rows with
  ring_epoch == 0 predate replication (or were written by a server-local
  sink) and exist in exactly one copy — their holder always reports
  them, which keeps healthy-cluster results byte-identical to the
  pre-replication single-copy behavior.
"""

from __future__ import annotations

import bisect
import hashlib
import struct
from collections.abc import Mapping

import numpy as np

from deepflow_tpu_torch.store.table import TableView

DEFAULT_VNODES = 64
DEFAULT_REPLICATION = 2
HISTORY_EPOCHS = 16      # per-epoch member sets kept for old-row claims


def _h64(key: str) -> int:
    return struct.unpack_from(">Q", hashlib.md5(key.encode()).digest())[0]


class HashRing:
    """Epoch-versioned consistent-hash ring over shard ids.

    members: {shard_id: {"addr": query_addr, "ingest": ingest_addr}}.
    Placement depends ONLY on shard ids (vnode keys are ``sid:i``), so
    every node that knows an epoch's member ids computes identical
    owner lists — the property the query-time claim filter relies on.
    """

    def __init__(self, members: dict, replication: int = DEFAULT_REPLICATION,
                 vnodes: int = DEFAULT_VNODES, epoch: int = 1,
                 token: int = 0, history: dict | None = None) -> None:
        self.members = {int(s): dict(m) for s, m in members.items()}
        self.replication = max(1, int(replication))
        self.vnodes = max(1, int(vnodes))
        self.epoch = int(epoch)
        self.token = int(token)
        self.history = {int(e): sorted(int(s) for s in ids)
                        for e, ids in (history or {}).items()}
        self.history[self.epoch] = sorted(self.members)
        self._points: dict[tuple, tuple[list, list]] = {}
        self._owner_cache: dict[tuple, list[int]] = {}

    # -- placement ----------------------------------------------------------

    def _ring_points(self, ids: tuple) -> tuple[list, list]:
        cached = self._points.get(ids)
        if cached is None:
            pts = sorted((_h64(f"{sid}:{i}"), sid)
                         for sid in ids for i in range(self.vnodes))
            cached = self._points[ids] = ([h for h, _ in pts],
                                          [s for _, s in pts])
        return cached

    def _owners_for(self, agent_id: int, ids: tuple) -> list[int]:
        if not ids:
            return []
        key = (agent_id, ids)
        owners = self._owner_cache.get(key)
        if owners is not None:
            return owners
        hashes, sids = self._ring_points(ids)
        i = bisect.bisect_right(hashes, _h64(f"agent:{agent_id}"))
        owners, seen = [], set()
        for step in range(len(sids)):
            sid = sids[(i + step) % len(sids)]
            if sid not in seen:
                seen.add(sid)
                owners.append(sid)
                if len(owners) >= min(self.replication, len(ids)):
                    break
        self._owner_cache[key] = owners
        return owners

    def owners(self, agent_id: int) -> list[int]:
        """Ordered [primary, replica...] shard ids under the CURRENT epoch."""
        return self._owners_for(int(agent_id), tuple(sorted(self.members)))

    def owners_at(self, agent_id: int, epoch: int) -> list[int]:
        """Owner order under a historical epoch's member set (rows keep
        the epoch they were ingested at). Unknown/evicted epochs fall
        back to the current members — the documented approximation for
        rows older than HISTORY_EPOCHS rebalances."""
        ids = self.history.get(int(epoch))
        if ids is None:
            return self.owners(agent_id)
        return self._owners_for(int(agent_id), tuple(ids))

    def ingest_addrs(self, agent_id: int) -> list[str]:
        """Owner ingest addresses in ring order — what the controller
        pushes down the synchronizer's analyzer_addrs path."""
        return [self.members[sid]["ingest"] for sid in self.owners(agent_id)
                if self.members.get(sid, {}).get("ingest")]

    def claimant(self, agent_id: int, epoch: int, alive: set) -> int | None:
        """The one shard that reports agent_id's epoch-tagged rows: its
        first ALIVE owner. None = every owner is dead (uncovered)."""
        for sid in self.owners_at(agent_id, epoch):
            if sid in alive:
                return sid
        return None

    # -- query-time claim filtering -----------------------------------------

    def claim_mask(self, agent_arr: np.ndarray, epoch_arr: np.ndarray,
                   self_shard: int, alive: set) -> np.ndarray:
        """Boolean row mask: rows this shard reports. ring_epoch == 0
        rows (single-copy, pre-replication) always pass; replicated rows
        pass iff this shard is their claimant."""
        mask = epoch_arr == 0
        if mask.all():
            return mask
        # one int64 key per (agent, epoch): agent ids are u16, epochs u32
        keys = (np.asarray(agent_arr).astype(np.int64) << 32) \
            | np.asarray(epoch_arr).astype(np.int64)
        mine = [k for k in np.unique(keys[~mask]).tolist()
                if self.claimant(k >> 32, k & 0xFFFFFFFF, alive)
                == self_shard]
        if mine:
            mask |= np.isin(keys, mine)
        return mask

    # -- coverage ------------------------------------------------------------

    def all_member_ids(self) -> set:
        ids = set(self.members)
        for hist in self.history.values():
            ids.update(hist)
        return ids

    def covers(self, dead: set) -> bool:
        """True when every agent still has >= 1 alive owner in EVERY
        epoch this ring remembers: any R-1 simultaneous failures among
        ring members are covered (each owner list holds R distinct
        shards). A dead shard the ring never knew holds only
        single-copy rows — never covered."""
        if not dead:
            return True
        if not dead <= self.all_member_ids():
            return False
        return len(dead) <= self.replication - 1

    # -- versioning / wire ---------------------------------------------------

    def newer_than(self, other: "HashRing | None") -> bool:
        """Fencing order: election token first (a deposed leader's ring
        loses to the new leader's regardless of epoch), epoch second."""
        if other is None:
            return True
        return (self.token, self.epoch) > (other.token, other.epoch)

    def snapshot(self) -> dict:
        return {
            "epoch": self.epoch, "token": self.token,
            "replication": self.replication, "vnodes": self.vnodes,
            "members": [{"shard_id": sid, **m}
                        for sid, m in sorted(self.members.items())],
            "history": {str(e): ids
                        for e, ids in sorted(self.history.items())},
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "HashRing":
        members = {int(m["shard_id"]): {"addr": m.get("addr", ""),
                                        "ingest": m.get("ingest", "")}
                   for m in snap.get("members", [])}
        return cls(members,
                   replication=int(snap.get("replication",
                                            DEFAULT_REPLICATION)),
                   vnodes=int(snap.get("vnodes", DEFAULT_VNODES)),
                   epoch=int(snap.get("epoch", 1)),
                   token=int(snap.get("token", 0)),
                   history=snap.get("history"))

    @classmethod
    def build(cls, prev: "HashRing | None", members: dict,
              replication: int, token: int,
              vnodes: int = DEFAULT_VNODES) -> "HashRing":
        """Leader-side (re)build: returns ``prev`` unchanged when the
        member set/addrs match (no spurious epoch bumps on heartbeats);
        otherwise a new ring at epoch+1 carrying ``prev``'s bounded
        history, stamped with the leader's fencing token."""
        norm = {int(s): {"addr": m.get("addr", ""),
                         "ingest": m.get("ingest", "")}
                for s, m in members.items()}
        if prev is not None and prev.members == norm \
                and prev.replication == int(replication):
            return prev
        epoch = (prev.epoch + 1) if prev is not None else 1
        history = dict(prev.history) if prev is not None else {}
        for e in sorted(history)[:max(0, len(history)
                                      - (HISTORY_EPOCHS - 1))]:
            del history[e]
        return cls(norm, replication=replication, vnodes=vnodes,
                   epoch=epoch, token=token, history=history)


class _ClaimedChunk(Mapping):
    """A scan chunk's claimed rows, gathered per column on first touch:
    a tier segment's columns stay undecoded until a scan reads them."""

    __slots__ = ("_ch", "_idx", "rows")

    def __init__(self, ch, idx: np.ndarray) -> None:
        self._ch = ch
        self._idx = idx
        self.rows = len(idx)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._ch[name][self._idx]

    def __iter__(self):
        return iter(self._ch)

    def __len__(self) -> int:
        return len(self._ch)

    def __contains__(self, name) -> bool:
        return name in self._ch


class _LazyClaimedChunk(Mapping):
    """A published segment's claimed rows: the claim is computed on the
    first touch (which fetches the segment), so a unit the planner
    prunes costs no fetch."""

    __slots__ = ("_ch", "_claim", "_idx")

    def __init__(self, ch, claim) -> None:
        self._ch = ch
        self._claim = claim
        self._idx = False  # not computed; None = every row claimed

    def _index(self):
        if self._idx is False:
            self._idx = self._claim(self._ch)
        return self._idx

    @property
    def rows(self) -> int:
        idx = self._index()
        return self._ch.rows if idx is None else len(idx)

    def __getitem__(self, name: str) -> np.ndarray:
        idx = self._index()
        a = self._ch[name]
        return a if idx is None else a[idx]

    def __iter__(self):
        return iter(self._ch)

    def __len__(self) -> int:
        return len(self._ch)

    def __contains__(self, name) -> bool:
        return name in self._ch


class ClaimTableView:
    """Read-only ColumnarTable facade that hides replica copies: only
    rows this shard claims (see HashRing.claim_mask) appear in
    view() / scan_units() / snapshot() / column_concat() / len(). Tables
    without the universal (agent_id, ring_epoch) tags pass through
    untouched. Everything else (name, columns, dicts, sync_state,
    bucket_marks) delegates to the wrapped table, so the DF-SQL, PromQL
    and Tempo readers and the query cache run on it unmodified; the
    cache keys a claim view's entries on the ring and alive set."""

    def __init__(self, table, ring: HashRing, self_shard: int,
                 alive: set) -> None:
        self._table = table
        self._ring = ring
        self._shard = int(self_shard)
        self._alive = set(alive)

    def _claimed_idx(self, ch, shard: int):
        """Row indexes ``shard`` claims in ch, None for every row."""
        if not ch or "agent_id" not in ch or "ring_epoch" not in ch:
            return None
        m = self._ring.claim_mask(ch["agent_id"], ch["ring_epoch"],
                                  shard, self._alive)
        return None if m.all() else np.flatnonzero(m)

    def _claim(self, ch, seg=None):
        shard = getattr(seg, "claim_as", None)
        if shard is not None:
            return _LazyClaimedChunk(
                ch, lambda c, s=int(shard): self._claimed_idx(c, s))
        idx = self._claimed_idx(ch, self._shard)
        return ch if idx is None else _ClaimedChunk(ch, idx)

    def scan_units(self) -> list:
        """Claim-filtered scan units. A segment's zone map and skip
        indexes stay attached: both are necessary conditions over the
        full chunk, so they stay sound for the claimed subset."""
        return [(self._claim(ch, seg), z, seg)
                for ch, z, seg in self._table.scan_units()]

    def view(self) -> TableView:
        """The engine's entry: one moment of the table, claimed."""
        v = self._table.view()
        units = [(self._claim(ch, seg), z, seg)
                 for ch, z, seg in v.scan_units()]
        return TableView(v.name, v.columns, v.dicts,
                         [u[0] for u in units], [u[1:] for u in units])

    def snapshot(self) -> list:
        return [u[0] for u in self.scan_units()]

    def column_concat(self, names) -> dict:
        chunks = self.snapshot()
        return {name: (np.concatenate([ch[name] for ch in chunks])
                       if chunks else np.empty(
                           0, dtype=self._table.columns[name].np_dtype))
                for name in names}

    def __len__(self) -> int:
        return len(self.view())

    def __getattr__(self, name: str):
        return getattr(self._table, name)


class ClaimDbView:
    """Database facade returning ClaimTableViews — handed to the query
    engines on the shard-exec path so every federated partial is
    replica-deduped at the source."""

    def __init__(self, db, ring: HashRing, self_shard: int,
                 alive: set) -> None:
        self._db = db
        self._ring = ring
        self._shard = int(self_shard)
        self._alive = set(alive)

    def table(self, name: str):
        return ClaimTableView(self._db.table(name), self._ring,
                              self._shard, self._alive)

    def tables(self) -> list:
        return self._db.tables()

    def __getattr__(self, name: str):
        return getattr(self._db, name)


def claim_db_from_body(body: dict, db, self_shard: int):
    """Shard-exec helper: when the coordinator shipped a ring snapshot
    and alive set in the op body, answer from the claim-filtered view;
    otherwise (no ring) answer raw."""
    snap = body.get("ring")
    if not snap:
        return db
    ring = HashRing.from_snapshot(snap)
    alive = set(int(s) for s in body.get("alive") or [])
    return ClaimDbView(db, ring, self_shard, alive)
