"""Cluster membership: seed-anchored join/heartbeat with gossip readback.

Own copy of ``deepflow_tpu/cluster/membership.py``, the adverts of the
cluster-wide partial cache (``cluster/partialcache.py``) that ride its
join exchange included.

Reference analog: controller node registration + the genesis sync that
lets every DeepFlow component read one authoritative node list. Peers
POST /v1/cluster/join to the seed (the leader controller's querier
port) on an interval; every join response carries the seed's full
versioned directory, which the joiner adopts — so any node, and dfctl,
can answer GET /v1/cluster/peers with the same picture after one
heartbeat round-trip.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from dataclasses import dataclass, field

log = logging.getLogger("df.cluster")

DEFAULT_TTL_S = 15.0          # peer considered dead after this silence
DEFAULT_HEARTBEAT_S = 2.0


@dataclass
class Peer:
    shard_id: int
    addr: str                 # "host:query_port" serving /v1/shard/exec
    epoch: int                # process start time (ns) — restarts bump it
    last_seen_ns: int = 0
    ingest_addr: str = ""     # "host:ingest_port" for agent frame traffic
    # "ingest" owns a slice of the agent fleet (hash ring + scatter
    # target); "querier" is a stateless read replica — it answers
    # coordinator queries but must NEVER be placed in the ingest ring
    # or scattered to for shard partials (satellite fix: every joiner
    # used to be assumed to own ingest). Peers from pre-role nodes
    # deserialize as ingest, preserving old behavior.
    role: str = "ingest"

    def to_dict(self) -> dict:
        return {"shard_id": self.shard_id, "addr": self.addr,
                "epoch": self.epoch, "last_seen_ns": self.last_seen_ns,
                "ingest_addr": self.ingest_addr, "role": self.role}

    @classmethod
    def from_dict(cls, d: dict) -> "Peer":
        return cls(shard_id=int(d["shard_id"]), addr=str(d["addr"]),
                   epoch=int(d.get("epoch", 0)),
                   last_seen_ns=int(d.get("last_seen_ns", 0)),
                   ingest_addr=str(d.get("ingest_addr", "")),
                   role=str(d.get("role") or "ingest"))


@dataclass
class PeerDirectory:
    """Versioned peer list. The version bumps only on membership CHANGE
    (new shard, address move, epoch bump = restart), not on heartbeats,
    so watchers can cheaply detect topology changes."""

    _peers: dict[int, Peer] = field(default_factory=dict)
    version: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def upsert(self, peer: Peer) -> bool:
        with self._lock:
            cur = self._peers.get(peer.shard_id)
            changed = (cur is None or cur.addr != peer.addr
                       or cur.epoch != peer.epoch
                       or cur.ingest_addr != peer.ingest_addr
                       or cur.role != peer.role)
            if changed:
                self.version += 1
            peer.last_seen_ns = peer.last_seen_ns or time.time_ns()
            self._peers[peer.shard_id] = peer
            return changed

    def adopt(self, snap: dict) -> None:
        """Replace local state with a (seed-authored) snapshot, keeping
        the freshest last_seen per shard."""
        with self._lock:
            if int(snap.get("version", 0)) < self.version:
                return
            incoming = {}
            for d in snap.get("peers", []):
                p = Peer.from_dict(d)
                cur = self._peers.get(p.shard_id)
                if cur is not None and cur.last_seen_ns > p.last_seen_ns:
                    p.last_seen_ns = cur.last_seen_ns
                incoming[p.shard_id] = p
            self._peers = incoming
            self.version = int(snap.get("version", 0))

    def snapshot(self) -> dict:
        with self._lock:
            return {"version": self.version,
                    "peers": [p.to_dict() for _, p in
                              sorted(self._peers.items())]}

    def alive(self, ttl_s: float = DEFAULT_TTL_S,
              exclude_shard: int | None = None) -> list[Peer]:
        horizon = time.time_ns() - int(ttl_s * 1e9)
        with self._lock:
            return [p for _, p in sorted(self._peers.items())
                    if p.last_seen_ns >= horizon
                    and p.shard_id != exclude_shard]


class ClusterMembership:
    """One node's view: local identity + join loop against the seed.

    A node with no seed (or whose advertise addr IS the seed) acts as
    the seed: its directory is authoritative and serves joins."""

    def __init__(self, shard_id: int, advertise: str,
                 seed: str | None = None,
                 heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 telemetry=None, role: str = "ingest") -> None:
        self.shard_id = shard_id
        self.advertise = advertise
        self.seed = (seed or "").strip() or None
        self.epoch = time.time_ns()
        self.role = role
        self.directory = PeerDirectory()
        self.heartbeat_s = heartbeat_s
        self.telemetry = telemetry
        self.stats = {"joins": 0, "join_errors": 0, "ring_adoptions": 0}
        self.ingest_addr = ""      # set by the server once receiver binds
        self.ring = None           # adopted/authored HashRing (replication)
        self._ring_lock = threading.Lock()
        # the partial cache's gossip: local warm-key digests ride the
        # join exchange in both directions; the seed merges every
        # joiner's adverts and the merged map rides every join response,
        # so any node knows who holds (table, sql, org) warm after one
        # heartbeat round-trip
        self.cache_adv_local = None      # zero-arg -> list[str] digests
        self._cache_advs: dict[str, tuple[int, str]] = {}
        self._adv_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def is_seed(self) -> bool:
        return self.seed is None or self.seed == self.advertise

    def self_peer(self) -> Peer:
        return Peer(shard_id=self.shard_id, addr=self.advertise,
                    epoch=self.epoch, last_seen_ns=time.time_ns(),
                    ingest_addr=self.ingest_addr, role=self.role)

    # -- the partial cache's adverts ----------------------------------
    def _local_advs(self) -> dict:
        fn = self.cache_adv_local
        if fn is None:
            return {}
        try:
            return {str(d): [self.shard_id, self.advertise]
                    for d in (fn() or [])}
        except Exception:
            return {}

    def _merge_advs(self, advs: dict | None) -> None:
        if not advs:
            return
        with self._adv_lock:
            for digest, ent in advs.items():
                try:
                    sid, addr = int(ent[0]), str(ent[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if sid != self.shard_id:
                    self._cache_advs[str(digest)] = (sid, addr)

    def cache_adverts(self) -> dict:
        """Everything known warm, the local keys included (the seed's
        view)."""
        with self._adv_lock:
            snap = dict(self._cache_advs)
        out = {d: [s, a] for d, (s, a) in snap.items()}
        out.update(self._local_advs())
        return out

    def advert_for(self, digest: str,
                   ttl_s: float = DEFAULT_TTL_S) -> tuple | None:
        """(shard_id, addr) of an ALIVE peer advertising this cache key
        digest, or None. Own adverts are left out: a local miss is a
        local miss."""
        with self._adv_lock:
            ent = self._cache_advs.get(digest)
        if ent is None:
            return None
        alive = {p.shard_id for p in self.directory.alive(ttl_s=ttl_s)}
        return ent if ent[0] in alive else None

    # -- replication ring ---------------------------------------------
    def adopt_ring(self, snap: dict | None) -> bool:
        """Fenced, forward-only ring adoption: a snapshot wins only if
        its (election token, epoch) pair is strictly newer than what we
        hold — a deposed leader's stale ring can never clobber the
        current one. Rings ride the join exchange in BOTH directions so
        one heartbeat round-trip converges seed and joiner."""
        if not snap:
            return False
        from deepflow_tpu_torch.cluster.hashring import HashRing
        ring = HashRing.from_snapshot(snap)
        with self._ring_lock:
            if not ring.newer_than(self.ring):
                return False
            self.ring = ring
            self.stats["ring_adoptions"] += 1
        log.info("cluster: adopted ring epoch %d (token %d, %d members)",
                 ring.epoch, ring.token, len(ring.members))
        return True

    def publish_ring(self, ring) -> bool:
        """Leader-side install of a freshly built ring (same fencing)."""
        with self._ring_lock:
            if not ring.newer_than(self.ring):
                return False
            self.ring = ring
        return True

    def ring_snapshot(self) -> dict | None:
        with self._ring_lock:
            return self.ring.snapshot() if self.ring is not None else None

    # -- seed side ----------------------------------------------------
    def handle_join(self, body: dict) -> dict:
        """Register/refresh one peer, answer with the full directory
        (and the replication ring, when one is active)."""
        peer = Peer.from_dict(body)
        peer.last_seen_ns = time.time_ns()
        if self.directory.upsert(peer):
            log.info("cluster: shard %d at %s joined (epoch %d)",
                     peer.shard_id, peer.addr, peer.epoch)
        self.adopt_ring(body.get("ring"))
        self._merge_advs(body.get("cache_adv"))
        self.directory.upsert(self.self_peer())
        out = self.directory.snapshot()
        ring = self.ring_snapshot()
        if ring is not None:
            out["ring"] = ring
        advs = self.cache_adverts()
        if advs:
            out["cache_adv"] = advs
        return out

    # -- joiner side --------------------------------------------------
    def _join_once(self) -> None:
        body = self.self_peer().to_dict()
        ring = self.ring_snapshot()
        if ring is not None:
            body["ring"] = ring
        advs = self._local_advs()
        if advs:
            body["cache_adv"] = advs
        req = urllib.request.Request(
            f"http://{self.seed}/v1/cluster/join",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=3.0) as resp:
            snap = json.loads(resp.read())
        self.directory.adopt(snap)
        self.adopt_ring(snap.get("ring"))
        self._merge_advs(snap.get("cache_adv"))
        self.stats["joins"] += 1

    def _loop(self) -> None:
        beat = (self.telemetry.heartbeat(
            "cluster.membership", interval_hint_s=self.heartbeat_s)
            if self.telemetry is not None else None)
        while not self._stop.is_set():
            if beat is not None:
                beat.beat()
            try:
                self._join_once()
            except Exception as e:
                self.stats["join_errors"] += 1
                log.debug("cluster join to %s failed: %s", self.seed, e)
            self._stop.wait(self.heartbeat_s)

    def start(self) -> "ClusterMembership":
        self.directory.upsert(self.self_peer())
        if not self.is_seed:
            self._thread = threading.Thread(
                target=self._loop, name="df-cluster-join", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def refresh_self(self) -> None:
        """Seed keeps its own last_seen fresh (joiners do via join)."""
        self.directory.upsert(self.self_peer())

    def peers(self, include_self: bool = True,
              ttl_s: float = DEFAULT_TTL_S,
              role: str | None = None) -> list[Peer]:
        self.refresh_self()
        alive = self.directory.alive(ttl_s=ttl_s)
        if role is not None:
            alive = [p for p in alive if p.role == role]
        if include_self:
            return alive
        return [p for p in alive if p.shard_id != self.shard_id]
