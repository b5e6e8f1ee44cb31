"""Controller: agent registry, ids, configs, clocks and orgs.

Own copy of ``deepflow_tpu/server/controller.py`` (trisolaris-lite) on
the port's sync transport (``server/syncwire.py``, HTTP/1.1 on asyncio
streams; the reference's is ``grpc.aio``, which the card's machine does
not have):

- ``AgentRegistry``: one entry per agent with its assigned id and its
  health (state, exception bitmap, CPU, memory, group, config version,
  NTP offset);
- ``GpidAllocator``: global process ids and the per-agent 5-tuple
  snapshots the ingest-side join reads (``name_lookup``);
- ``ConfigStore``: versioned agent-group configs, validated with the
  port's YAML reader and ``AgentConfig``, with a boot epoch and
  listeners;
- ``Controller``: ``Sync`` (registration, the group's config when the
  agent's version or epoch differs, the platform upload into the
  ingest tag table, the NTP offset, the analyzer list), ``Ntp``,
  ``GpidSync``, ``PromEncode``, ``PodMap``, ``Push`` (a long poll that
  answers on a version bump), the analyzers with rendezvous assignment,
  and the orgs (an agent group's org, which the group's rows carry).

One deliberate difference: the reference keys an agent by
``(ctrl_ip, hostname)``, because one JAX process owns a TPU host's chips.
Under ``torchrun`` a host runs one agent per GPU, and two jobs can share
a host; keyed by host, every rank of both jobs would take one id. The
port's key adds the request's ``launcher_id`` (``tpuprobe/ranks.py::
launcher_identity``: the job's run id or rendezvous address and the
global rank), so each rank has its own entry, a restarted rank gets its
id back, and a request without one (a node agent) registers exactly as
the reference's.

A second difference follows from it: the reference's ``GpidAllocator``
keys a process by ``(agent_id, pid)``. On a GPU host one training
process is seen by its own runner agent (``SyncRequest.processes``) and
by the host's node agent (its socket scan), and with several ranks by
every rank's agent, so the reference's key gives it as many gpids as
agents, and the last scan to sync flips its flows between them. The
port keys a process by the registry's host identity ``(ctrl_ip,
hostname)`` and the pid, so a pid has one gpid a host; an agent that
never registered keeps the reference's ``(agent_id, pid)``, and a node
agent alone on its host gets the reference's gpids.

``PodMap`` serves genesis's pod index (``server/genesis.py``) to the
agents' labelers: the entries only when the agent's version or epoch is
stale, so a steady-state fetch is a few bytes.

With a replication ring (``ring_provider``, the server's adopted
``cluster/hashring.py`` ring) each agent's analyzers are the ring's
owners of its id, primary first: the synchronizer hands them to the
agent's ``ReplicatedSender``, which completes a leader's rebalance.

Left out until their slices (ROADMAP Queue 1): ``PackageRepo``,
``CommandQueue``, ``FetchPackage`` and command delivery (the agent's
operations, item 15); the QoS directive (the ``qos/`` item).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import threading
import time

from deepflow_tpu_torch.agent import yamlcfg
from deepflow_tpu_torch.agent.config import AgentConfig, parse_addr
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.platform_info import AgentInfo, \
    PlatformInfoTable
from deepflow_tpu_torch.server.prom_encoder import PromEncoder
from deepflow_tpu_torch.server.syncwire import DEFAULT_SYNC_PORT, \
    PUSH_HOLD_S, SyncWireServer

log = logging.getLogger("df.controller")

DEFAULT_AGENT_CONFIG_YAML = b"""\
# deepflow-tpu rendered agent config (controller-pushed)
profiler:
  enabled: true
  sample_hz: 99.0
  emit_interval_s: 1.0
tpuprobe:
  enabled: true
  source: auto
  trace_interval_s: 10.0
  trace_duration_ms: 1000
stats_interval_s: 10.0
"""


class AgentRegistry:
    """Agent identity and health."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_key: dict[tuple, dict] = {}
        self._next_id = 1

    def register(self, ctrl_ip: str, hostname: str, agent_id: int,
                 request: wire.SyncRequest | None = None) -> dict:
        launcher = request.launcher_id if request is not None else ""
        key = (ctrl_ip, hostname, launcher)
        with self._lock:
            entry = self._by_key.get(key)
            if entry is None:
                entry = {
                    "agent_id": agent_id or self._next_id,
                    "ctrl_ip": ctrl_ip,
                    "hostname": hostname,
                    "launcher_id": launcher,
                    "first_seen_ns": time.time_ns(),
                    "syncs": 0,
                }
                if not agent_id:
                    self._next_id += 1
                else:
                    self._next_id = max(self._next_id, agent_id + 1)
                self._by_key[key] = entry
            entry["last_seen_ns"] = time.time_ns()
            entry["syncs"] = entry.get("syncs", 0) + 1
            if request is not None:
                entry["state"] = int(request.state)
                entry["exception_bitmap"] = int(request.exception_bitmap)
                entry["degraded"] = bool(request.exception_bitmap)
                entry["version"] = request.version
                entry["cpu_usage"] = round(float(request.cpu_usage), 2)
                entry["mem_bytes"] = int(request.mem_bytes)
                entry["agent_group"] = request.agent_group or "default"
                entry["config_version"] = int(request.config_version)
                if request.HasField("clock_offset_ns"):
                    entry["clock_offset_ms"] = round(
                        request.clock_offset_ns / 1e6, 3)
                else:
                    # unmeasured, not "0 ms skew"
                    entry["clock_offset_ms"] = None
            return entry

    def list(self) -> list[dict]:
        with self._lock:
            return [dict(v) for v in self._by_key.values()]

    def group_of(self, agent_id: int) -> str:
        with self._lock:
            for e in self._by_key.values():
                if e["agent_id"] == agent_id:
                    return e.get("agent_group", "default")
        return "default"


class GpidAllocator:
    """Global process ids: (host, pid) -> gpid, and the per-agent socket
    5-tuple snapshots behind the ingest-side join. An agent's host is
    the registry's ``(ctrl_ip, hostname)``, told by ``set_host`` at its
    Sync; until then the agent is its own host, ``(agent_id, pid)`` as
    in the reference. Each agent's sync is a full snapshot of its
    entries (the ones it stopped reporting go), and agents silent for
    ``ENTRY_TTL_S`` are swept every ``SWEEP_INTERVAL_S``."""

    ENTRY_TTL_S = 600.0
    SWEEP_INTERVAL_S = 60.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gpids: dict[tuple, int] = {}
        self._hosts: dict[int, tuple] = {}  # agent id -> host identity
        self._by_agent: dict[int, dict[tuple, wire.GpidEntry]] = {}
        self._agent_ts: dict[int, float] = {}
        self._flat: dict[tuple, wire.GpidEntry] = {}
        self._last_sweep = 0.0
        self._next = 1

    def set_host(self, agent_id: int, host: tuple) -> None:
        with self._lock:
            self._hosts[agent_id] = host

    def _key(self, agent_id: int, pid: int) -> tuple:
        return (self._hosts.get(agent_id, agent_id), pid)

    def gpid_for(self, agent_id: int, pid: int) -> int:
        with self._lock:
            key = self._key(agent_id, pid)
            return self._gpids.get(key) or self._alloc_locked(key)

    def gpid_of(self, agent_id: int, pid: int) -> int:
        """The pid's gpid as ``agent_id`` reports it, 0 when none was
        given (nothing is allocated)."""
        with self._lock:
            return self._gpids.get(self._key(agent_id, pid), 0)

    def entries(self) -> list:
        """Every endpoint the join reads now (one GpidEntry each)."""
        with self._lock:
            return list(self._flat.values())

    def sync(self, req: wire.GpidSyncRequest) -> wire.GpidSyncResponse:
        now = time.monotonic()
        with self._lock:
            bucket: dict[tuple, wire.GpidEntry] = {}
            for e in req.entries:
                e.agent_id = req.agent_id  # never trust the entry's own
                key = self._key(req.agent_id, e.pid)
                e.gpid = self._gpids.get(key, 0) or self._alloc_locked(key)
                bucket[(bytes(e.ip), e.port, int(e.proto), e.role)] = e
            old = self._by_agent.get(req.agent_id)
            if old:
                for k in old:
                    if k not in bucket:
                        cur = self._flat.get(k)
                        if cur is not None and cur.agent_id == req.agent_id:
                            del self._flat[k]
            self._by_agent[req.agent_id] = bucket
            self._agent_ts[req.agent_id] = now
            self._flat.update(bucket)
            if now - self._last_sweep >= self.SWEEP_INTERVAL_S:
                self._sweep_locked(now)
            # the requester's own entries, gpids filled in
            return wire.GpidSyncResponse(entries=req.entries)

    def _sweep_locked(self, now: float) -> None:
        self._last_sweep = now
        cutoff = now - self.ENTRY_TTL_S
        for aid in [a for a, ts in self._agent_ts.items() if ts < cutoff]:
            for k in self._by_agent.pop(aid, {}):
                cur = self._flat.get(k)
                if cur is not None and cur.agent_id == aid:
                    del self._flat[k]
            del self._agent_ts[aid]

    def _alloc_locked(self, key: tuple) -> int:
        g = self._next
        self._next += 1
        self._gpids[key] = g
        return g

    def lookup(self, ip: bytes, port: int, proto: int) -> int:
        """A flow endpoint's gpid: the server (listen) role's exact tuple
        first, then the client role's; 0 when unknown."""
        e = self.entry_for(ip, port, proto)
        return e.gpid if e is not None else 0

    def name_lookup(self, ip: bytes, port: int, proto: int
                    ) -> tuple[int, str]:
        e = self.entry_for(ip, port, proto)
        return (e.gpid, e.process_name) if e is not None else (0, "")

    def entry_for(self, ip: bytes, port: int, proto: int):
        """The endpoint's GpidEntry (its pid, gpid, name and reporting
        agent): the server (listen) role's first, then the client's;
        None when unknown."""
        flat = self._flat  # entries are never changed once inserted
        for role in (1, 0):
            e = flat.get((ip, port, proto, role))
            if e is not None:
                return e
        return None


class ConfigStore:
    """Versioned agent-group configs (YAML); an update gives the group
    the store's next version and tells the listeners.

    A deliberate difference: the reference counts versions per group, so
    a group's first config is version 1, the version its agents already
    hold from the default config; they are never sent it (until the
    controller restarts). The port counts versions across the store, so
    no config a group's agents could hold has the version of another."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._version = 1
        self._configs: dict[str, tuple[bytes, int]] = {
            "default": (DEFAULT_AGENT_CONFIG_YAML, self._version)}
        self._listeners: list = []  # callables(group, yaml, version)
        # boot nonce: versions restart with the process, so agents take
        # any version on an epoch change
        self.epoch = time.time_ns() & 0xFFFFFFFFFFFF

    def subscribe(self, fn) -> None:
        with self._lock:
            self._listeners.append(fn)

    def get(self, group: str = "default") -> tuple[bytes, int]:
        with self._lock:
            return self._configs.get(group, self._configs["default"])

    def update(self, group: str, yaml_bytes: bytes) -> int:
        self.validate(yaml_bytes)
        with self._lock:
            self._version += 1
            version = self._version
            self._configs[group] = (yaml_bytes, version)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(group, yaml_bytes, version)
            except Exception:
                log.exception("config listener failed")
        return version

    @staticmethod
    def validate(yaml_bytes: bytes) -> None:
        data = yamlcfg.load(yaml_bytes) or {}
        if not isinstance(data, dict):
            raise ValueError("agent config must be a YAML mapping")
        AgentConfig.from_dict(data).validate()


class Controller:
    """The Synchronizer service and the state it shares with the
    server (the ingest tag table, the querier's routes)."""

    def __init__(self, platform_table: PlatformInfoTable,
                 host: str = "127.0.0.1",
                 port: int = DEFAULT_SYNC_PORT, pod_index=None,
                 ring_provider=None) -> None:
        self.platform_table = platform_table
        self.pod_index = pod_index  # genesis's PodIpIndex, or None
        # zero-arg callable -> HashRing or None: an active ring's owner
        # order wins over the flat analyzer list below
        self.ring_provider = ring_provider
        self.registry = AgentRegistry()
        self.gpids = GpidAllocator()
        # agent group -> org (the group routes configs, so it is the
        # tenancy boundary too); unassigned groups are in org 1
        self._orgs: dict[str, int] = {}
        self._orgs_lock = threading.Lock()
        self.prom_encoder = PromEncoder()
        # ingest nodes for agent rebalance; never set = agents keep their
        # configured servers, set then cleared = agents revert to them
        self._analyzers: list[str] = []
        self._analyzers_managed = False
        self._analyzer_lock = threading.Lock()
        self.configs = ConfigStore()
        self.host = host
        self.port = port
        self._wire: SyncWireServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._loop_ready = threading.Event()
        self._start_error: BaseException | None = None
        self._stop_evt: asyncio.Event | None = None
        self._platform_lock = threading.Lock()
        self._platforms: dict[int, bytes] = {}  # agent id -> PlatformData
        self._platform_version = 1
        # push wake-ups: one asyncio.Condition per group, on the loop
        self._push_conds: dict[str, asyncio.Condition] = {}
        self.push_hold_s = PUSH_HOLD_S
        self.push_streams = 0
        self.configs.subscribe(self._on_config_update)

    # -- methods ---------------------------------------------------------------

    def Sync(self, request: wire.SyncRequest,  # noqa: N802 (rpc names)
             context=None) -> wire.SyncResponse:
        entry = self.registry.register(
            request.ctrl_ip, request.hostname, request.agent_id,
            request=request)
        agent_id = entry["agent_id"]
        # the agents of one host share its pids' gpids
        self.gpids.set_host(agent_id, (entry["ctrl_ip"], entry["hostname"]))
        resp = wire.SyncResponse(status=wire.SUCCESS, agent_id=agent_id)
        cfg, version = self.configs.get(request.agent_group or "default")
        # resend on a version OR epoch mismatch: a restarted store's
        # version can equal the agent's stale one with other content
        if request.config_version != version or \
                request.config_epoch != self.configs.epoch:
            resp.user_config_yaml = cfg
        resp.config_version = version
        resp.config_epoch = self.configs.epoch
        if request.HasField("platform"):
            self._ingest_platform(agent_id, request.platform)
        if request.HasField("clock_offset_ns"):
            # the decoders shift this agent's timestamps onto ours
            self.platform_table.set_clock_offset(agent_id,
                                                 request.clock_offset_ns)
        for proc in request.processes:
            self.gpids.gpid_for(agent_id, proc.pid)
        with self._platform_lock:
            resp.platform_version = self._platform_version
        addrs = self.assign_analyzers(agent_id)
        with self._analyzer_lock:
            resp.analyzer_assignment = self._analyzers_managed or \
                bool(addrs)
        resp.analyzer_addrs = addrs
        return resp

    def Ntp(self, request: wire.NtpRequest,  # noqa: N802
            context=None) -> wire.NtpResponse:
        """The 4-timestamp exchange: t2 on entry, t3 just before the
        answer is written."""
        resp = wire.NtpResponse(t1_ns=request.t1_ns)
        resp.t2_ns = time.time_ns()
        resp.t3_ns = time.time_ns()
        return resp

    def GpidSync(self, request: wire.GpidSyncRequest,  # noqa: N802
                 context=None) -> wire.GpidSyncResponse:
        return self.gpids.sync(request)

    def PodMap(self, request: wire.PodMapRequest,  # noqa: N802
               context=None) -> wire.PodMapResponse:
        """The cluster's pods for the agents' labelers: the entries only
        when the agent's version or epoch is stale (the epoch guards a
        restarted controller whose version counter met the agent's)."""
        resp = wire.PodMapResponse()
        if self.pod_index is None:
            return resp
        resp.version = self.pod_index.version
        resp.epoch = self.configs.epoch
        if request.version == resp.version and \
                request.epoch == resp.epoch:
            return resp
        resp.entries = [wire.PodMapEntry(
            cidr=f"{ip}/32" if ":" not in ip else f"{ip}/128",
            pod=pod.name, namespace=pod.namespace, workload=pod.workload,
            node=pod.node) for ip, pod in self.pod_index.items_copy()]
        return resp

    async def Push(self, request: wire.SyncRequest,  # noqa: N802
                   context=None) -> wire.SyncResponse | None:
        """The group's config once its version or epoch differs from the
        request's, or None after ``push_hold_s`` with no change. Each
        held push is a coroutine waiting on its group's condition."""
        group = request.agent_group or "default"
        cond = self._push_cond(group)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.push_hold_s
        self.push_streams += 1
        try:
            while True:
                cfg, version = self.configs.get(group)
                if version != request.config_version or \
                        request.config_epoch != self.configs.epoch:
                    return wire.SyncResponse(
                        status=wire.SUCCESS, user_config_yaml=cfg,
                        config_version=version,
                        config_epoch=self.configs.epoch)
                left = deadline - loop.time()
                if left <= 0:
                    return None
                async with cond:
                    try:  # the periodic re-check covers a missed wake
                        await asyncio.wait_for(cond.wait(),
                                               timeout=min(5.0, left))
                    except asyncio.TimeoutError:
                        pass
        finally:
            self.push_streams -= 1

    def _push_cond(self, group: str) -> asyncio.Condition:
        """Loop thread only."""
        cond = self._push_conds.get(group)
        if cond is None:
            cond = self._push_conds[group] = asyncio.Condition()
        return cond

    def _on_config_update(self, group: str, yaml_bytes: bytes,
                          version: int) -> None:
        """From any thread (the querier's): wake the group's pushes."""
        loop = self._loop
        if loop is None or not loop.is_running():
            return

        async def notify() -> None:
            cond = self._push_cond(group)
            async with cond:
                cond.notify_all()

        asyncio.run_coroutine_threadsafe(notify(), loop)

    # -- analyzers ---------------------------------------------------------------

    def set_analyzers(self, addrs: list[str]) -> None:
        for a in addrs:  # a bad address raises here, not per agent later
            parse_addr(a)
        with self._analyzer_lock:
            self._analyzers = list(dict.fromkeys(addrs))
            self._analyzers_managed = True

    def analyzers(self) -> list[str]:
        with self._analyzer_lock:
            return list(self._analyzers)

    def assign_analyzers(self, agent_id: int) -> list[str]:
        """The agent's ingest nodes in preference order. With a ring,
        its owners of the agent (primary first, then the replicas), the
        assignment the agent's sender adopts at its next sync. Else
        rendezvous hashing over the analyzer list (an even spread, and
        few agents move when a node joins or leaves)."""
        ring = self.ring_provider() if self.ring_provider else None
        if ring is not None:
            addrs = ring.ingest_addrs(agent_id)
            if addrs:
                return addrs
        with self._analyzer_lock:
            addrs = list(self._analyzers)
        if not addrs:
            return []

        def weight(addr: str) -> int:
            h = hashlib.blake2s(f"{agent_id}|{addr}".encode(),
                                digest_size=8)
            return int.from_bytes(h.digest(), "big")
        return sorted(addrs, key=weight, reverse=True)

    # -- orgs ------------------------------------------------------------------

    def assign_org(self, group: str, org_id: int) -> None:
        """An agent group's org, taken at the agents' next sync; org 1
        clears the assignment."""
        with self._orgs_lock:
            if int(org_id) == 1:
                self._orgs.pop(group, None)
            else:
                self._orgs[group] = int(org_id)

    def org_of_group(self, group: str) -> int:
        with self._orgs_lock:
            return self._orgs.get(group, 1)

    def org_assignments(self) -> dict:
        with self._orgs_lock:
            return dict(self._orgs)

    # -- platform ----------------------------------------------------------------

    def _ingest_platform(self, agent_id: int, p: wire.PlatformData) -> None:
        """The agent's upload into the platform snapshot and the ingest
        tag table."""
        body = p.SerializeToString()
        with self._platform_lock:
            if self._platforms.get(agent_id) != body:
                self._platforms[agent_id] = body
                self._platform_version += 1
        self.platform_table.update(AgentInfo(
            agent_id=agent_id,
            host=p.hostname,
            pod_name=p.pod_name,
            pod_ns=p.pod_namespace,
            tpu_pod=p.tpu_pod_name,
            tpu_worker=int(p.tpu_worker_id or 0),
            slice_id=p.devices[0].slice_id if p.devices else 0,
            org_id=self.org_of_group(self.registry.group_of(agent_id)),
        ))

    def platform_of(self, agent_id: int) -> wire.PlatformData | None:
        """The agent's last platform upload."""
        with self._platform_lock:
            body = self._platforms.get(agent_id)
        return None if body is None else wire.PlatformData.FromString(body)

    # -- lifecycle -----------------------------------------------------------------

    def running(self) -> bool:
        return self._loop_thread is not None and \
            self._loop_thread.is_alive()

    def start(self) -> "Controller":
        """Listen on ``host:port`` (0: any free port, then ``port``
        holds it); a port that cannot be bound raises."""
        self._start_error = None
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="df-controller-aio", daemon=True)
        self._loop_thread.start()
        if not self._loop_ready.wait(timeout=10):
            raise RuntimeError("controller event loop failed to start")
        if self._start_error is not None:
            self._loop_thread.join(timeout=5.0)
            self._loop_thread = None
            self._loop_ready.clear()
            raise self._start_error
        log.info("controller sync up on :%d", self.port)
        return self

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._serve())
        finally:
            loop.close()

    async def _serve(self) -> None:
        self._wire = SyncWireServer({
            "Sync": self.Sync, "Ntp": self.Ntp, "GpidSync": self.GpidSync,
            "PromEncode": self.prom_encoder.handle, "PodMap": self.PodMap,
            "Push": self.Push,
        }, host=self.host, port=self.port)
        try:
            await self._wire.start()
        except OSError as e:
            self._start_error = e
            self._loop_ready.set()
            return
        self.port = self._wire.port
        self._loop = asyncio.get_running_loop()
        self._stop_evt = asyncio.Event()
        self._loop_ready.set()
        await self._stop_evt.wait()
        await self._wire.stop()

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running() and \
                self._stop_evt is not None:
            loop.call_soon_threadsafe(self._stop_evt.set)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
            self._loop_thread = None
        self._loop = None
        self._push_conds.clear()  # bound to the loop that ended
        self._loop_ready.clear()
