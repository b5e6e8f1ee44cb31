"""The port's server: receiver + decoders + store + querier in one process.

Own copy of the profile and flow paths of
``deepflow_tpu/server/server.py::Server``: PROFILE, TPU_SPAN,
STEP_METRICS, L4_LOG, L7_LOG, METRICS, DFSTATS and EVENT frames arrive
over TCP, decode into the profile, flow-log, flow-metric, self-stats and
event tables (with the file-I/O minute windows, flushed at stop)
through one shared dedup window, the receiver acks what was written, and
the querier answers DF-SQL and the profile queries over HTTP, each server with its own query cache and
query tracer, whose spans land in ``deepflow_system.query_trace`` (the
database makes every schema table at start, that one included). One
``Telemetry("server")`` holds the receiver's, the decoders' and the
querier's hop ledgers and heartbeats, and a
``DeadmanDetector`` watches them; ``GET /v1/health`` shows both, and the
agents' self-telemetry from their DFSTATS rows. A ``Janitor`` trims the
tables to their TTLs (``server/janitor.py``); its stats show there too.
A ``RollupJob`` rolls the 1 s flow-metric tables into their 1m, 1h and
1d tiers (``server/datasource.py``), and a ``TraceTreeBuilder`` turns
the L7 rows that carry a trace id into ``flow_log.trace_tree`` rows
(``server/tracetree.py``); both show in ``/v1/health``.
``selfmon=None`` honours DF_NO_SELFMON; DF_CHAOS reaches the receiver
and the tier.

With ``data_dir`` the server resumes what a clean stop saved and keeps
each agent's ack floor in ``ack_state.json`` (atomic; a torn file is
counted as ``state_corrupt`` on the ``storage`` hop and read as absent).
With ``storage`` too, the tables sit over an on-disk tier
(``store/tiered.py``): a ``Flusher`` commits their sealed chunks into
segments every ``flush_interval_s`` and releases a frame's ack only
after the manifest commit that made its rows durable, so an ack is a
durability receipt; a ``Compactor`` merges segments into sorted runs
every ``compact_interval_s``; the janitor evicts segments past the TTLs
and ``storage_max_bytes``. A restart recovers the tier and seeds the
receiver's ack tracker and the dedup floors from the persisted floors,
so the retransmit of a frame committed but not acked is a dup.
``/v1/health`` carries the ``storage`` block. A ``Scrubber``
(``store/scrub.py``) verifies the sealed segments' block checksums every
``scrub_interval_s`` at a byte-budgeted pace, quarantines a corrupt one
(its rows leave the answers, which say ``degraded``) and repairs it from
its published blob.

With ``objstore`` (a shared directory) an ingest server with storage
publishes its sealed segments and dictionary dumps there every
``publish_interval_s`` (``store/objstore.py``: a no-op tick when
nothing sealed, a final publish at stop). A ``role="querier"`` server is
a stateless read replica: no receiver, decoders, flusher, controller or
local storage; it adopts the published segments every
``readtier_poll_s`` into a byte-budgeted local segment cache
(``segcache_max_bytes`` under ``<data_dir>/segcache``, which it wipes at
start; ``store/segcache.py``), scrubs its cached copies, and, in a
cluster, answers every query surface with the ingest shards' live rows
(the publish-gen handshake) and shares warm bucket slices with the other
replicas (``cluster/partialcache.py``). Queriers stay out of the ingest
ring and the rollups. ``role="querier"`` without ``objstore`` fails the
start. With self-telemetry on, the server writes its own hop ledgers and
heartbeats (``Telemetry.stats_metrics``) into
``deepflow_system.deepflow_system`` every ``selfstats_interval_s``.

Every flow and metric row names its processes and its resources: the
flow decoders join each side against the controller's gpid table (the
agents' socket scans, ``agent/socket_scan.py``) for its gpid and
process name, and against the ``ResourceIndex`` that K8s genesis keeps
(``server/genesis.py``) for its pod, namespace, workload, service, node,
zone and subnet. ``start_genesis`` attaches the list-watch (the pod's
own cluster when called without an ``api_base``; the server calls it
itself when it runs in a cluster); a cluster it cannot reach leaves the
rows untagged and returns False. The recorder's resource-change events
land in ``event.event``, and ``/v1/health`` carries genesis's stats.
PCAP frames (the agents' pcap ACL captures) land in the pcap store that
``POST /v1/pcaps`` lists and serves.

The querier's integration routes (``server/integration.py``) take OTLP,
Prometheus remote-write, Telegraf, Datadog, SkyWalking, folded profiles
and app logs; remote-write ids come from this server's controller, or
with ``prom_encoder_controller`` (``--prom-encoder H:P``) from a remote
one. An ``ExporterManager`` (``server/exporters.py``) takes every
decoder's and integration route's writes; ``/v1/exporters`` attaches and
removes exporters, and the stop ships what the decoders' drain fed it.
The server touches no device and imports no torch; span, flow-log and
metric-document frames decode with the native library, which starting
the server builds (or raises).

With ``enable_controller`` (the entry point's default) the server runs
the controller (``server/controller.py``) on ``sync_port``: agents
register and take their ids there, upload their platform data and NTP
offsets (the tags and clock shift its decoders apply) and take their
group's config by poll and push; the querier serves ``/v1/agents``,
``/v1/agent-group-config``, ``/v1/orgs`` and ``/v1/analyzers`` from it.
A sync port that cannot be bound fails the start. With a lease
(``ha_lease_path``, a file on a shared volume, or ``ha_k8s_lease``, a
Kubernetes Lease's name) the singletons (the controller, the rollup job
and the janitor) run only while this server is the elected leader
(``server/election.py``); every server ingests and answers queries. A
Lease with no cluster to hold it fails the start (the reference runs the
singletons locally then).

Servers form a cluster (``cluster/``) with a shard id and a seed: each
stamps its rows with ``shard_id``, joins the seed's directory on its
query port (heartbeats every 2 s, gossiping its receiver port as
``ingest_addr``), and every query surface scatters to the alive shards
and merges (``server/querier.py``). With ``replication`` R > 0 the
elected leader (the seed when no lease is set) builds the consistent-
hash ring over the ingest shards, fenced by its election token, and
rebuilds it when the directory changes; the decoders tag each row with
its agent's ring coordinates, the controller hands each agent the
ring's owner order as its analyzers (primary first), the agents'
``ReplicatedSender`` ships HIGH and MID frames to all R owners, and a
query stays exact through R - 1 dead shards (``covered_shards``). A
cluster flag with a bad value fails the start.

    python -m deepflow_tpu_torch.server [--host H] [--ingest-port P]
        [--query-port Q] [--sync-port S] [--no-controller]
        [--ha-lease FILE | --ha-k8s-lease NAME]
        [--data-dir DIR [--storage] [--flush-interval-s S]
         [--compact-interval-s S] [--storage-max-mb MB]
         [--scrub-interval-s S]]
        [--shard-id N [--cluster-seed H:Q | --advertise H:Q]
         [--fanout-timeout-s S] [--replication R]]
        [--role {ingest,querier}] [--objstore DIR
         [--objstore-mirror DIR ...] [--publish-interval-s S]
         [--segcache-max-mb MB] [--readtier-poll-s S]]
        [--prom-encoder H:P]

Once it listens it prints one JSON line with the bound ports, so that a
parent process that asked for port 0 can find them. SIGTERM or SIGINT
stops it after the decoders have drained their queues.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
import time

from deepflow_tpu_torch.chaos import chaos_from_env
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.server.datasource import RollupJob
from deepflow_tpu_torch.server.decoders import (
    DedupWindow, EventDecoder, FlowLogDecoder, MetricsDecoder, PcapDecoder,
    ProfileDecoder, StatsDecoder, StepMetricsDecoder, TpuSpanDecoder)
from deepflow_tpu_torch.server.exporters import ExporterManager
from deepflow_tpu_torch.server.controller import Controller
from deepflow_tpu_torch.server.flusher import (
    Compactor, DurabilityGate, Flusher)
from deepflow_tpu_torch.server.janitor import Janitor
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable, \
    PodIpIndex, ResourceIndex
from deepflow_tpu_torch.server.querier import QuerierAPI, QuerierHTTP
from deepflow_tpu_torch.server.receiver import Receiver
from deepflow_tpu_torch.server.syncwire import DEFAULT_SYNC_PORT
from deepflow_tpu_torch.server.tracetree import TraceTreeBuilder
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.telemetry import DeadmanDetector, Telemetry

log = logging.getLogger("df.server")


class Server:
    def __init__(self, host: str = "127.0.0.1", ingest_port: int = 20033,
                 query_port: int = 20416,
                 selfmon: bool | None = None,
                 sync_port: int = DEFAULT_SYNC_PORT,
                 enable_controller: bool = False,
                 ha_lease_path: str | None = None,
                 ha_k8s_lease: str | None = None,
                 data_dir: str | None = None, storage: bool = False,
                 flush_interval_s: float = 1.0,
                 compact_interval_s: float = 60.0,
                 storage_max_bytes: int = 0,
                 shard_id: int = 0,
                 cluster_seed: str | None = None,
                 cluster_advertise: str | None = None,
                 fanout_timeout_s: float = 5.0,
                 replication: int = 0,
                 scrub_interval_s: float = 30.0,
                 role: str = "ingest",
                 objstore: str | None = None,
                 objstore_mirrors: list[str] | None = None,
                 segcache_max_bytes: int = 256 << 20,
                 publish_interval_s: float = 2.0,
                 readtier_poll_s: float = 2.0,
                 selfstats_interval_s: float = 10.0,
                 api_token: str | None = None,
                 prom_encoder_controller: str | None = None) -> None:
        # the read tier: an ingest server with an object store publishes
        # its sealed segments; a querier is a stateless read replica
        if role not in ("ingest", "querier"):
            raise ValueError(f"role must be ingest or querier, got {role!r}")
        if role == "querier" and not objstore:
            raise ValueError("role=querier requires an --objstore path")
        self.role = role
        self.objstore_path = objstore
        # read-only alternate roots: fetches fail over to them when the
        # primary copy is missing or fails its checksums
        self.objstore_mirrors = list(objstore_mirrors or [])
        self.segcache_max_bytes = max(1 << 20, int(segcache_max_bytes))
        self.publish_interval_s = publish_interval_s
        self.readtier_poll_s = readtier_poll_s
        self.scrub_interval_s = scrub_interval_s
        self.objstore = None
        self.publisher = None
        self.segcache = None
        self.readtier = None
        self.partial_cache = None
        self.scrubber = None
        self._loops: list[tuple[threading.Event, threading.Thread]] = []
        self._selfstats_interval_s = selfstats_interval_s
        # a querier's data_dir only roots its segment cache
        self._cache_root = data_dir if role == "querier" else None
        if role == "querier":
            data_dir, storage = None, False
        # cluster federation: this node's shard identity and how to find
        # the others; a seed (or an advertise address, even an empty
        # one) turns it on, and a lone seed is a working 1-node cluster
        self._cluster_on = (cluster_seed is not None
                            or cluster_advertise is not None)
        _check_cluster_args(self._cluster_on, shard_id, cluster_seed,
                            cluster_advertise, fanout_timeout_s, replication,
                            querier=role == "querier")
        self.shard_id = shard_id
        self.cluster_seed = cluster_seed
        self.cluster_advertise = cluster_advertise
        self._fanout_timeout_s = fanout_timeout_s
        # replicated ingest: R > 0 turns on the ring (cluster/hashring.py)
        self.replication = int(replication)
        self.membership = None
        self.fanout = None
        self.federation = None
        self._ring_stop = threading.Event()
        self._ring_thread: threading.Thread | None = None
        # acks are released only after the commit that made their rows
        # durable (server/flusher.py)
        self.storage = bool(storage and data_dir)
        self.flush_interval_s = flush_interval_s
        self.compact_interval_s = compact_interval_s
        self.db = Database(data_dir=data_dir, storage=self.storage,
                           shard_id=shard_id)
        self.durability = DurabilityGate() if self.storage else None
        self.flusher: Flusher | None = None
        self.compactor: Compactor | None = None
        self.platform = PlatformInfoTable()
        self.pod_index = PodIpIndex()  # K8s genesis's pods by IP
        # IP -> universal tags (pods, services, nodes, subnets), shared
        # by every ingest decoder
        self.resources = ResourceIndex(self.pod_index)
        self.genesis = None  # start_genesis()
        self.controller = (Controller(self.platform, host=host,
                                      port=sync_port,
                                      pod_index=self.pod_index,
                                      ring_provider=self._current_ring)
                           if enable_controller and role == "ingest"
                           else None)
        self.ha_lease_path = ha_lease_path
        self.ha_k8s_lease = ha_k8s_lease
        self.election = None
        # one registry per Server: the tests run several in one process
        self.telemetry = Telemetry("server", enabled=selfmon)
        self.deadman = DeadmanDetector(self.telemetry)
        self.receiver = Receiver(host=host, port=ingest_port,
                                 telemetry=self.telemetry)
        # one window for every decoder: the seq space is per agent, and a
        # resent frame must dedup whichever decoder it lands on
        self.dedup = DedupWindow()
        self.receiver.dedup = self.dedup
        self.decoders = []
        self.janitor = Janitor(self.db, telemetry=self.telemetry,
                               tier_max_bytes=storage_max_bytes)
        self.rollup = RollupJob(self.db)
        # ingest-time trace precompute (reference: tracetree_writer.go)
        self.trace_trees = TraceTreeBuilder(self.db)
        # re-export: every decoder's and integration route's writes feed it
        self.exporters = ExporterManager(telemetry=self.telemetry)
        # remote-write ids: this server's controller's allocator, or a
        # remote controller's (an ingest node without its own)
        prom_encoder = None
        if self.controller is None and prom_encoder_controller:
            from deepflow_tpu_torch.server.prom_encoder import \
                PromEncoderClient
            prom_encoder = PromEncoderClient(prom_encoder_controller)
        self.api = QuerierAPI(self.db, stats_provider=self._stats,
                              telemetry=self.telemetry, rollup=self.rollup,
                              trace_trees=self.trace_trees,
                              controller=self.controller,
                              storage_provider=self._storage_stats,
                              api_token=api_token, exporters=self.exporters,
                              prom_encoder=prom_encoder)
        self.http = QuerierHTTP(self.api, host=host, port=query_port)

    def start_genesis(self, api_base: str | None = None, token: str = "",
                      ca_path: str = "") -> bool:
        """Attach the K8s list-watch (the pod's own cluster when
        ``api_base`` is None). False when no cluster is reachable: the
        rows stay untagged and the server runs on."""
        from deepflow_tpu_torch.server.genesis import K8sGenesis

        def events(rows: list[dict]) -> None:
            self.db.table("event.event").append_rows(rows)
        try:
            self.genesis = K8sGenesis(
                self.pod_index, api_base=api_base, token=token,
                ca_path=ca_path, event_sink=events,
                resources=self.resources,
                telemetry=self.telemetry).start()
            return True
        except (RuntimeError, ValueError) as e:
            # ValueError: https without a CA (no ca.crt mounted)
            log.warning("k8s genesis not started: %s", e)
            return False

    def _stats(self) -> dict:
        return {
            "receiver": dict(self.receiver.stats),
            "decoders": {d.MSG_TYPE.name: dict(d.stats)
                         for d in self.decoders},
            "dedup": dict(self.dedup.stats),
            "janitor": dict(self.janitor.stats),
            "rollup": {**self.rollup.stats, "horizons": {
                f"{fam}.{sfx}": wm
                for (fam, sfx), wm in self.rollup.horizons().items()}},
            "trace_trees": dict(self.trace_trees.stats),
            "flusher": (dict(self.flusher.stats)
                        if self.flusher is not None else None),
            "compactor": (dict(self.compactor.stats)
                          if self.compactor is not None else None),
            "scrubber": (dict(self.scrubber.stats)
                         if self.scrubber is not None else None),
            "genesis": (dict(self.genesis.stats)
                        if self.genesis is not None else None),
            "integration": dict(self.api.integration.stats),
        }

    def _storage_stats(self) -> dict | None:
        """The /v1/health storage block: the tier's state, the gate's
        depth and the rollup horizons."""
        if self.db.tier_store is None:
            return None
        snap = self.db.tier_store.snapshot()
        snap["gate_pending"] = len(self.durability)
        if self.flusher is not None:
            snap["flush_consec_errors"] = self.flusher.consec_errors
            snap["commit_ms"] = self.flusher.commit_ms_quantiles()
        if self.scrubber is not None:
            snap["scrub"] = self.scrubber.snapshot()
        snap["rollup_horizons"] = {
            f"{fam}.{sfx}": wm
            for (fam, sfx), wm in self.rollup.horizons().items()}
        return snap

    def _write_selfstats(self) -> None:
        """The server's own hop ledgers and heartbeats as
        ``deepflow_system.deepflow_system`` rows (the server has no agent
        in front of it, so it writes them itself)."""
        tags = self.platform.tags_for(0)
        now = time.time_ns()
        rows = []
        for name, mtags, values in self.telemetry.stats_metrics():
            tag_json = json.dumps(mtags, sort_keys=True)
            for vname, v in values.items():
                rows.append({"time": now, "metric_name": name,
                             "tag_json": tag_json, "value_name": vname,
                             "value": v, **tags})
        if rows:
            self.db.table("deepflow_system.deepflow_system") \
                .append_rows(rows)

    def _start_loop(self, name: str, interval_s: float, tick,
                    beat: bool = False) -> None:
        """A daemon thread calling ``tick`` every ``interval_s`` (a
        failed tick is logged; the next one retries), with ``beat`` a
        heartbeat of its own; ``stop()`` ends it."""
        stop = threading.Event()
        hb = (self.telemetry.heartbeat(name, interval_hint_s=interval_s)
              if beat else None)

        def run() -> None:
            while not stop.wait(interval_s):
                if hb is not None:
                    hb.beat()
                try:
                    tick()
                except Exception:
                    log.exception("%s failed", name)
        t = threading.Thread(target=run, name=f"df-{name}", daemon=True)
        t.start()
        self._loops.append((stop, t))

    def _stop_loops(self) -> None:
        for stop, t in self._loops:
            stop.set()
            t.join(timeout=2.0)
        self._loops = []

    def _ack_state_path(self) -> str | None:
        return (os.path.join(self.db.data_dir, "ack_state.json")
                if self.db.data_dir else None)

    def _load_ack_state(self) -> dict[int, int]:
        """Persisted per-agent contiguous-seq floors. They seed the
        receiver's ack tracker and the dedup floors, so a retransmit of
        a frame from before the restart writes no second row. A torn
        file reads as absent (the tier's manifest keeps its own floors)
        and is counted as ``state_corrupt``."""
        path = self._ack_state_path()
        if not path or not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                raw = json.load(f)
            return {int(k): int(v) for k, v in raw.items()}
        except (OSError, ValueError, AttributeError):
            log.warning("ack state unreadable; starting fresh",
                        exc_info=True)
            self.telemetry.hop("storage").account(
                emitted=1, dropped=1, reason="state_corrupt")
            return {}

    def _save_ack_state(self) -> None:
        """temp file + fsync + rename: a crash leaves the old floors or
        the new, never a torn file."""
        path = self._ack_state_path()
        if not path:
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in
                           self.receiver.seq_tracker.snapshot().items()}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            log.warning("ack state save failed", exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def start(self) -> "Server":
        # the election first: a Lease with no cluster raises before
        # anything runs
        if self.ha_k8s_lease:
            from deepflow_tpu_torch.server.election import K8sLeaseElection
            self.election = K8sLeaseElection(
                self.ha_k8s_lease,
                namespace=os.environ.get("POD_NAMESPACE", "default"),
                on_elected=self._start_singletons,
                on_deposed=self._stop_singletons)
        elif self.ha_lease_path:
            from deepflow_tpu_torch.server.election import LeaderElection
            self.election = LeaderElection(
                self.ha_lease_path, on_elected=self._start_singletons,
                on_deposed=self._stop_singletons)
        if self.db.data_dir:
            self.db.load()  # resume the saved tables, adopt the tier
        # storage-scope chaos (DF_CHAOS tier_enospc / objstore_eio) hooks
        # into the tier commit and the blob publish
        chaos = chaos_from_env()
        if self.objstore_path is not None:
            from deepflow_tpu_torch.store.objstore import ObjStore
            self.objstore = ObjStore(self.objstore_path,
                                     mirrors=self.objstore_mirrors)
            self.objstore.chaos = chaos
        if self.role == "querier":
            self._start_readtier()
        else:
            self._start_ingest(chaos)
        self.trace_trees.start()
        self.deadman.start()
        if self.role == "ingest":
            self.receiver.start()
        self.http.start()
        if self._cluster_on:
            self._start_cluster()
        if self.telemetry.enabled:
            self._start_loop("selfstats", self._selfstats_interval_s,
                             self._write_selfstats, beat=True)
        if self.election is not None:
            self.election.start()
        else:
            self._start_singletons()
        if os.environ.get("KUBERNETES_SERVICE_HOST"):
            self.start_genesis()  # in a cluster: watch it
        log.info("server up: role %s ingest :%d query :%d%s", self.role,
                 self.ingest_port if self.role == "ingest" else 0,
                 self.query_port,
                 f" sync :{self.sync_port}" if self.controller else "")
        return self

    def _start_ingest(self, chaos) -> None:
        """The write path: decoders, the flusher, compactor and
        scrubber with storage, and the publisher with an object store."""
        floors = self._load_ack_state()
        parked: dict[int, list[int]] = {}
        if self.db.tier_store is not None:
            self.db.tier_store.chaos = chaos
            if self.db.tier_store.stats.get("manifest_corrupt"):
                # recovery met an unreadable MANIFEST.json and scavenged
                # the segment files instead
                self.telemetry.hop("storage").account(
                    emitted=1, dropped=1, reason="state_corrupt")
            # the manifest's floors were committed with the rows they
            # cover: after a SIGKILL they are ahead of ack_state.json,
            # which only a clean stop writes. Both describe durable rows
            for agent_id, contig in self.db.tier_store.ack_floors.items():
                if contig > floors.get(agent_id, -1):
                    floors[agent_id] = contig
            # committed seqs above a gap: durable too
            parked = {a: [q for q in seqs if q > floors.get(a, -1)]
                      for a, seqs in self.db.tier_store.ack_parked.items()}
        for agent_id, contig in floors.items():
            self.receiver.seq_tracker.seed(agent_id, contig)
        for agent_id, seqs in parked.items():
            for seq in seqs:
                self.receiver.seq_tracker.observe(agent_id, seq)
        self.dedup = DedupWindow(floors=floors, parked=parked)
        self.receiver.dedup = self.dedup
        # register every queue before listening: no frame finds none
        for cls, mtype in ((PcapDecoder, MessageType.PCAP),
                           (ProfileDecoder, MessageType.PROFILE),
                           (TpuSpanDecoder, MessageType.TPU_SPAN),
                           (StepMetricsDecoder, MessageType.STEP_METRICS),
                           (FlowLogDecoder, MessageType.L4_LOG),
                           (FlowLogDecoder, MessageType.L7_LOG),
                           (MetricsDecoder, MessageType.METRICS),
                           (StatsDecoder, MessageType.DFSTATS),
                           (EventDecoder, MessageType.EVENT)):
            q = self.receiver.register(mtype)
            kw = ({"trace_trees": self.trace_trees}
                  if cls is FlowLogDecoder else {})
            self.decoders.append(cls(
                q, self.db, self.platform, dedup=self.dedup,
                seq_tracker=self.receiver.seq_tracker,
                telemetry=self.telemetry, msg_type=mtype,
                durability=self.durability, pod_index=self.pod_index,
                resources=self.resources,
                gpid_table=(self.controller.gpids
                            if self.controller is not None else None),
                ring=self._current_ring, exporters=self.exporters, **kw))
        # a replicated shard tags every row with the ring: its decoders
        # start once it holds one (_start_cluster); frames wait queued,
        # unacked, until then
        if not (self._cluster_on and self.replication > 0):
            for d in self.decoders:
                d.start()
        if self.storage:
            self.flusher = Flusher(self.db, gate=self.durability,
                                   seq_tracker=self.receiver.seq_tracker,
                                   interval_s=self.flush_interval_s,
                                   telemetry=self.telemetry)
            self.flusher.seed_floors(floors, parked)
            self.flusher.start()
            if self.compact_interval_s > 0:
                self.compactor = Compactor(
                    self.db, interval_s=self.compact_interval_s,
                    telemetry=self.telemetry).start()
            if self.scrub_interval_s > 0:
                from deepflow_tpu_torch.store.scrub import Scrubber
                self.scrubber = Scrubber(
                    self.db, objstore=self.objstore,
                    shard_id=self.shard_id,
                    interval_s=self.scrub_interval_s,
                    telemetry=self.telemetry).start()
                self.api.scrubber = self.scrubber
            if self.objstore is not None:
                # publish the sealed state to the shared store, so that
                # stateless querier replicas can adopt it
                from deepflow_tpu_torch.store.objstore import \
                    SegmentPublisher
                self.publisher = SegmentPublisher(self.objstore,
                                                  self.shard_id)
                self.api.publisher = self.publisher
                self._start_loop(
                    "publish", self.publish_interval_s,
                    lambda: self.publisher.maybe_publish(self.db.tier_store))

    def _start_readtier(self) -> None:
        """The querier role: no receiver, decoders or flusher. The node
        adopts published segments from the object store into a
        byte-budgeted local cache and serves sealed history over them."""
        import tempfile
        from deepflow_tpu_torch.store.segcache import ReadTier, SegmentCache
        # a subdirectory, never data_dir itself: the cache wipes its root
        # at start, and a --data-dir naming an existing tier (an ingest
        # node's) must survive a querier started on it by mistake
        root = (os.path.join(self._cache_root, "segcache")
                if self._cache_root
                else tempfile.mkdtemp(prefix="df-segcache-"))
        self.segcache = SegmentCache(
            root, self.objstore, max_bytes=self.segcache_max_bytes,
            telemetry=self.telemetry)
        self.readtier = ReadTier(self.db, self.objstore, self.segcache,
                                 shard_id=self.shard_id)
        self.api.readtier = self.readtier
        if self.scrub_interval_s > 0:
            # a querier scrubs its CACHED copies: a corrupt one is
            # discarded and fetched again on the next pin
            from deepflow_tpu_torch.store.scrub import Scrubber
            self.scrubber = Scrubber(
                self.db, segcache=self.segcache, shard_id=self.shard_id,
                interval_s=self.scrub_interval_s,
                telemetry=self.telemetry).start()
            self.api.scrubber = self.scrubber
        try:
            self.readtier.poll()  # the first adoption before serving
        except Exception:
            log.exception("initial read-tier poll failed")
        self._start_loop("readtier", self.readtier_poll_s,
                         self.readtier.poll)

    def _start_cluster(self) -> None:
        """Membership, the fan-out client and the coordinator; the ring
        loop with replication. After the listeners bind: with
        ``--query-port 0`` the advertised address needs the real port."""
        from deepflow_tpu_torch.cluster.federation import \
            FederationCoordinator
        from deepflow_tpu_torch.cluster.membership import ClusterMembership
        from deepflow_tpu_torch.cluster.remote import FanOut
        adv = self.cluster_advertise or f"127.0.0.1:{self.http.port}"
        self.membership = ClusterMembership(
            self.shard_id, adv, seed=self.cluster_seed, role=self.role,
            telemetry=self.telemetry)
        if self.role == "ingest":
            # agents ship to the RECEIVER port: peers gossip it so the
            # ring can hand agent-facing ingest addresses around
            self.membership.ingest_addr = (
                f"{adv.rsplit(':', 1)[0]}:{self.receiver.port}")
        self.membership.start()
        self.fanout = FanOut(telemetry=self.telemetry,
                             timeout_s=self._fanout_timeout_s)
        self.federation = FederationCoordinator(
            self.db, self.membership, self.fanout, shard_id=self.shard_id)
        self.api.membership = self.membership
        self.api.federation = self.federation
        if self.readtier is not None:
            # a read-tier coordinator: freeze the adopted snapshot across
            # the scatter, send the publish-gen handshake, and join the
            # cluster-wide partial cache
            from deepflow_tpu_torch.cluster.partialcache import PartialCache
            self.federation.readtier = self.readtier
            self.federation.query_cache = self.api.query_cache
            self.partial_cache = PartialCache(
                self.api.query_cache, self.membership,
                self.federation.dict_sync, self.db,
                shard_id=self.shard_id, telemetry=self.telemetry,
                api_token=self.api.api_token or None)
            self.partial_cache.readtier = self.readtier
            self.api.partial_cache = self.partial_cache
        if self.replication > 0 and self.role == "ingest":
            self._ring_tick()  # a seed (or leader) holds its ring at once
            self._ring_stop.clear()
            self._ring_thread = threading.Thread(
                target=self._ring_loop, name="df-ring", daemon=True)
            self._ring_thread.start()

    def _start_decoders_with_ring(self) -> None:
        """The ring loop's first duty on a replicated shard: start the
        decoders once a ring is held (built, or adopted from the seed).
        A row decoded before would carry ring_epoch 0, the single-copy
        tag, and be counted once on each of its R owners."""
        if self.membership.ring is not None:
            for d in self.decoders:
                d.start()
            return
        log.info("replication: decoders wait for the ring")
        while not self._ring_stop.wait(0.02):
            if self.membership.ring is not None:
                log.info("replication: ring epoch %d held; decoders start",
                         self.membership.ring.epoch)
                for d in self.decoders:
                    d.start()
                return

    def _current_ring(self):
        """The adopted replication ring, or None (a zero-arg callable for
        the decoders and the controller, built before the membership)."""
        m = self.membership
        return m.ring if m is not None else None

    def _ring_tick(self) -> None:
        """The leader's ring maintenance: rebuild the ring when the peer
        directory changes (a join, an address move, a restart). A shard
        merely going silent bumps no epoch: failover is the query-time
        claim shift to the surviving replica, not a rebalance. Fenced:
        the ring carries the election token, and adoption everywhere is
        forward-only on (token, epoch)."""
        m = self.membership
        if m is None:
            return
        if self.election is not None:
            if not self.election.is_leader:
                return
            token = self.election.token
        elif not m.is_seed:
            return
        else:
            token = 0
        from deepflow_tpu_torch.cluster.hashring import HashRing
        snap = m.directory.snapshot()
        members = {p["shard_id"]: {"addr": p["addr"],
                                   "ingest": p.get("ingest_addr", "")}
                   for p in snap["peers"]
                   # the reference's queriers take no agent traffic
                   if p.get("role", "ingest") == "ingest"}
        ring = HashRing.build(m.ring, members, self.replication, token)
        if ring is not m.ring and m.publish_ring(ring):
            log.info("ring: epoch %d published (token %d, members %s)",
                     ring.epoch, ring.token, sorted(ring.members))

    def _ring_loop(self) -> None:
        self._start_decoders_with_ring()
        while not self._ring_stop.wait(1.0):
            try:
                self._ring_tick()
            except Exception:
                log.exception("ring maintenance failed")

    def _start_singletons(self) -> None:
        """The leader's components (each a no-op when running)."""
        if self.role == "ingest":
            self.rollup.start()
        self.janitor.start()
        if self.controller is not None and not self.controller.running():
            self.controller.start()

    def _stop_singletons(self) -> None:
        self.rollup.stop()
        self.janitor.stop()
        if self.controller is not None:
            self.controller.stop()

    def stop(self) -> None:
        self._stop_loops()
        if self.election is not None:
            self.election.stop()  # its resign stops the singletons
            self.election = None
        if self.genesis is not None:
            self.genesis.stop()
            self.genesis = None
        self._ring_stop.set()
        if self._ring_thread is not None:
            self._ring_thread.join(timeout=2.0)
            self._ring_thread = None
        if self.membership is not None:
            self.membership.stop()
        if self.fanout is not None:
            self.fanout.close()
        # the receiver first: once its handlers are gone nothing enqueues,
        # and each decoder's stop drains what is queued
        self.deadman.stop()
        self.receiver.stop()
        for d in self.decoders:
            d.stop()
            if isinstance(d, EventDecoder):
                d.flush()  # the file-I/O windows still open
        self.trace_trees.stop()  # writes the traces still pending
        self.exporters.stop()  # ships what the drain fed them
        if self.scrubber is not None:
            # before the final flush: a quarantine renames the manifest
            self.scrubber.stop()
            self.scrubber = None
        if self.compactor is not None:
            # before the final flush: both rename the manifest
            self.compactor.stop()
            self.compactor = None
        if self.flusher is not None:
            # after the decoders' drain: the final flush commits what they
            # wrote and parked, and releases the last gated seqs
            self.flusher.stop()
            self.flusher = None
        if self.publisher is not None:
            # after the final flush: publish what it sealed, so the
            # queriers hold the whole history across a clean restart
            try:
                self.publisher.maybe_publish(self.db.tier_store)
            except Exception:
                log.exception("final segment publish failed")
        # after the drain: every acked frame is in a table now
        self._save_ack_state()
        self._stop_singletons()
        self.http.stop()
        if self.db.data_dir:
            self.db.save()

    @property
    def ingest_port(self) -> int:
        return self.receiver.port

    @property
    def query_port(self) -> int:
        return self.http.port

    @property
    def sync_port(self) -> int | None:
        """The controller's bound port (None without a controller)."""
        return self.controller.port if self.controller is not None else None

    def wait_for_rows(self, table: str, n: int, timeout: float = 5.0) -> bool:
        """Block until a table holds >= n rows, or the timeout passes."""
        deadline = time.monotonic() + timeout
        t = self.db.table(table)
        while time.monotonic() < deadline:
            if len(t) >= n:
                return True
            time.sleep(0.02)
        return len(t) >= n


def _check_cluster_args(on: bool, shard_id, seed, advertise,
                        fanout_timeout_s, replication,
                        querier: bool = False) -> None:
    """A cluster flag with a bad value fails the start (ValueError). A
    standalone querier may carry a shard id (its read tier skips its own
    pointer)."""
    if isinstance(shard_id, bool) or not isinstance(shard_id, int) \
            or not 0 <= shard_id <= 0xFFFF:
        raise ValueError(f"shard id must be an int in 0..65535 (the "
                         f"rows' u16 shard_id), got {shard_id!r}")
    if isinstance(replication, bool) or not isinstance(replication, int) \
            or not 0 <= replication <= 8:
        raise ValueError(f"replication must be an int in 0..8 (0 = off), "
                         f"got {replication!r}")
    if not fanout_timeout_s > 0:
        raise ValueError(f"fanout timeout must be > 0 s, "
                         f"got {fanout_timeout_s!r}")
    if not on:
        if (shard_id and not querier) or replication:
            raise ValueError("a shard id or replication needs a cluster: "
                             "give --cluster-seed, or --advertise on the "
                             "seed")
        return
    if not shard_id:
        raise ValueError("a cluster member needs a shard id >= 1 "
                         "(0 stamps a standalone server's rows)")
    for what, addr in (("cluster seed", seed), ("advertise", advertise)):
        if addr:
            host, sep, port = addr.rpartition(":")
            if not sep or not host or not port.isdigit() \
                    or not 0 < int(port) < 65536:
                raise ValueError(f"{what} must be host:port, got {addr!r}")


def main(argv: list[str] | None = None, on_start=None) -> None:
    """Serve until SIGTERM or SIGINT. ``on_start(server)``, when given,
    runs once the server listens: a process that embeds the entry point
    keeps the server there, to read its tables after the drain."""
    parser = argparse.ArgumentParser(
        description="deepflow-tpu profile server (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address of both listeners (0.0.0.0 to "
                             "take frames from other hosts)")
    parser.add_argument("--ingest-port", type=int, default=20033)
    parser.add_argument("--query-port", type=int, default=20416)
    parser.add_argument("--sync-port", type=int, default=DEFAULT_SYNC_PORT,
                        help="the controller's port (agents' --controller)")
    parser.add_argument("--no-controller", action="store_true",
                        help="run no controller: agents keep their own ids "
                             "and configs")
    parser.add_argument("--ha-lease", default=None,
                        help="shared-volume lease FILE for leader election")
    parser.add_argument("--ha-k8s-lease", default=None,
                        help="Kubernetes Lease name for leader election")
    parser.add_argument("--data-dir", default=None,
                        help="persist the tables and the ack floors here")
    parser.add_argument("--storage", action="store_true",
                        help="persistent tiered storage: flush sealed "
                             "chunks into on-disk columnar segments "
                             "under <data-dir>/segments and release "
                             "ingest acks only after the commit that "
                             "makes their rows durable")
    parser.add_argument("--flush-interval-s", type=float, default=1.0,
                        help="tier flush cadence (storage mode)")
    parser.add_argument("--compact-interval-s", type=float, default=60.0,
                        help="tier compaction cadence (storage mode): "
                             "merge small sealed segments into sorted "
                             "format-v2 runs; 0 disables")
    parser.add_argument("--storage-max-mb", type=int, default=0,
                        help="on-disk tier size budget per node; the "
                             "janitor evicts oldest segments past it "
                             "(0 = TTL-only eviction)")
    parser.add_argument("--shard-id", type=int, default=0,
                        help="this node's cluster shard identity "
                             "(stamps ingested rows; 0 = standalone)")
    parser.add_argument("--cluster-seed", default=None,
                        help="seed node host:query_port to join (the "
                             "leader controller's querier)")
    parser.add_argument("--advertise", default=None,
                        help="host:port other shards reach THIS querier "
                             "at (default 127.0.0.1:<query-port>; an "
                             "empty value makes a seed)")
    parser.add_argument("--fanout-timeout-s", type=float, default=5.0,
                        help="per-shard scatter-gather call deadline; "
                             "slower shards degrade to missing_shards")
    parser.add_argument("--replication", type=int, default=0,
                        help="replication factor R for ingested HIGH/MID "
                             "frames (0 = off): each agent ships to R "
                             "ring owners; queries stay exact through "
                             "R-1 simultaneous shard failures")
    parser.add_argument("--scrub-interval-s", type=float, default=30.0,
                        help="background integrity-scrub cadence "
                             "(storage and querier modes): verify segment "
                             "block checksums, quarantine and repair "
                             "corrupt segments; 0 disables")
    parser.add_argument("--role", default="ingest",
                        choices=("ingest", "querier"),
                        help="ingest: the full write path (receiver, "
                             "decoders, flusher); querier: a stateless "
                             "read replica serving sealed history fetched "
                             "on demand from --objstore")
    parser.add_argument("--objstore", default=None,
                        help="shared object-store directory: ingest nodes "
                             "publish sealed segments and manifest "
                             "pointers there, queriers adopt them "
                             "(required for --role querier)")
    parser.add_argument("--objstore-mirror", action="append",
                        default=None, metavar="DIR",
                        help="read-only alternate object-store root "
                             "(repeatable): fetches fail over to it when "
                             "the primary copy is missing or corrupt")
    parser.add_argument("--segcache-max-mb", type=int, default=256,
                        help="querier segment-cache byte budget; least "
                             "recently used segments past it are evicted "
                             "(fetched again on demand)")
    parser.add_argument("--publish-interval-s", type=float, default=2.0,
                        help="ingest publish cadence to --objstore")
    parser.add_argument("--readtier-poll-s", type=float, default=2.0,
                        help="querier manifest-pointer poll cadence")
    parser.add_argument("--prom-encoder", default=None, metavar="H:P",
                        help="a remote controller's sync address: this "
                             "node's remote-write ingest takes its "
                             "SmartEncoding ids (with --no-controller)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server = Server(host=args.host, ingest_port=args.ingest_port,
                    query_port=args.query_port, sync_port=args.sync_port,
                    enable_controller=(not args.no_controller
                                       and args.role == "ingest"),
                    ha_lease_path=args.ha_lease,
                    ha_k8s_lease=args.ha_k8s_lease,
                    data_dir=args.data_dir, storage=args.storage,
                    flush_interval_s=args.flush_interval_s,
                    compact_interval_s=args.compact_interval_s,
                    storage_max_bytes=args.storage_max_mb << 20,
                    shard_id=args.shard_id,
                    cluster_seed=args.cluster_seed,
                    cluster_advertise=args.advertise,
                    fanout_timeout_s=args.fanout_timeout_s,
                    replication=args.replication,
                    scrub_interval_s=args.scrub_interval_s,
                    role=args.role, objstore=args.objstore,
                    objstore_mirrors=args.objstore_mirror,
                    segcache_max_bytes=args.segcache_max_mb << 20,
                    publish_interval_s=args.publish_interval_s,
                    readtier_poll_s=args.readtier_poll_s,
                    prom_encoder_controller=args.prom_encoder).start()
    try:
        print(json.dumps({"ingest_port": server.ingest_port,
                          "query_port": server.query_port,
                          "sync_port": server.sync_port}), flush=True)
        if on_start is not None:
            on_start(server)
        stop.wait()
    finally:
        server.stop()
