"""Agent configuration: the sampler, the probe, the guard, the sender,
fault injection, self-telemetry, self-stats, flow capture and the
controller.

A subset of ``deepflow_tpu/agent/config.py`` with the reference's field
names, defaults and validation ranges for the fields kept: the OnCPU
sampler (``ProfilerConfig``), the device probe (``TpuProbeConfig``), the
resource guard (``GuardConfig``), the durable sender and its on-disk
spool (``SenderConfig``, ``SpoolConfig``), transport fault injection
(``ChaosConfig``), the self-telemetry spine (``SelfmonConfig``), live
packet capture into the flow path (``FlowConfig``), server-directed
backpressure (``BackpressureConfig``) and the agent's identity, ACLs,
controller, group and cadences (``AgentConfig``). The guard and
self-telemetry are on by default, the spool, fault injection and flow
capture off, and so is the integration listener (``IntegrationConfig``:
host, port 38086 and the server's querier address, not validated, as
the reference's). ``AgentConfig.from_dict`` builds one from a parsed YAML
mapping as the reference's does (a section's unknown key raises, an
unknown top-level key is ignored), and ``AgentConfig.load`` reads a
YAML file with the port's own reader (``agent/yamlcfg.py``). The ACLs
build the agent's labeler (``agent/labeler.py``), with ``npb_target``
and ``npb_vni`` for the ``npb`` action; ``socket_scan_interval_s`` (30 s,
0 off) paces the socket scan that gives every flow endpoint its process
(``agent/socket_scan.py``; it needs a controller). The ``qos`` block,
``profiler.memory`` and ``tpuprobe.source`` parse and validate, but
nothing in the port applies them yet: the backpressure and the memory
profiler are later slices, and the port's probe has one source, Kineto
(``auto``).

``AgentConfig.agent_id`` is 0, the reference's default ("assigned by the
controller"), outside a launcher. In a process a launcher started (``RANK`` and ``WORLD_SIZE`` in
its environment, as ``torchrun`` sets them) it defaults to the rank's own
nonzero id (``tpuprobe/ranks.py::agent_id_for_rank``), so the ranks of one
job ship under distinct ids into one server: with one shared id, each
sender's sequence numbers start from its own boot epoch and the server's
dedup window drops one rank's frames as duplicates of the other's. An
explicit ``agent_id`` (the runner's ``--agent-id``) wins. With a
``controller`` the id the controller assigns is the agent's
(``agent/synchronizer.py``).
"""

from __future__ import annotations

import dataclasses
import ipaddress
from dataclasses import dataclass, field

from deepflow_tpu_torch.agent import yamlcfg
from deepflow_tpu_torch.tpuprobe.ranks import MAX_AGENT_ID, launcher_agent_id

DEFAULT_INGEST_PORT = 20033


def default_agent_id() -> int:
    """The launcher rank's agent id, or 0 outside a launcher."""
    return launcher_agent_id() or 0


@dataclass
class ProfilerConfig:
    enabled: bool = True
    sample_hz: float = 99.0
    emit_interval_s: float = 1.0
    memory: bool = False            # tracemalloc flame graphs (not ported)
    memory_interval_s: float = 10.0


@dataclass
class TpuProbeConfig:
    enabled: bool = True
    source: str = "auto"          # auto | kineto: the port's one source
    trace_interval_s: float = 10.0  # fallback cadence before steps observed
    trace_duration_ms: int = 1000
    # step-adaptive duty cycle: windows sized to whole steps, gaps sized so
    # this fraction of ALL steps is captured
    target_coverage: float = 0.5
    steps_per_capture: int = 20
    # per-device memory sampling cadence (allocator statistics; ~free).
    # 0 disables.
    memory_poll_s: float = 5.0
    # continuous per-step rollups (STEP_METRICS records)
    step_metrics: bool = True
    step_topk: int = 5


@dataclass
class GuardConfig:
    enabled: bool = True
    max_cpu_pct: float = 50.0
    max_mem_mb: float = 2048.0
    check_interval_s: float = 10.0


@dataclass
class SpoolConfig:
    """On-disk overflow and replay spool of the durable sender
    (agent/spool.py): HIGH frames that would be dropped land in
    CRC-framed segment files and replay on reconnect."""
    enabled: bool = False
    dir: str = ""                 # "" = <tmpdir>/deepflow-spool-<agent_id>
    max_mb: int = 64              # oldest-segment eviction past this
    segment_mb: int = 4
    # age retention: closed segments older than this are evicted (0 =
    # size only); evictions ledger as dropped(spool_age_evict)
    max_age_s: float = 0.0


@dataclass
class SenderConfig:
    servers: list = field(default_factory=lambda: [("127.0.0.1",
                                                    DEFAULT_INGEST_PORT)])
    queue_size: int = 8192
    # sent-but-unacked frames kept for retransmit after a reconnect (the
    # transport is always durable: per-frame seq, server acks, dedup)
    ack_window: int = 1024
    # replication factor R: every HIGH/MID frame to the first R servers
    # (a seq space, ack window and spool each), so a dead primary's
    # frames are held on a replica; 1 = one copy (a plain UniformSender).
    # The controller's ring pushes the owners down analyzer_addrs
    replication: int = 1
    spool: SpoolConfig = field(default_factory=SpoolConfig)


@dataclass
class ChaosConfig:
    """Seeded transport fault injection (chaos.py). The DF_CHAOS
    environment knob overrides this block; probabilities are per call in
    [0, 1]. Never on in production: it exists to prove that delivery
    stays exactly-once under faults."""
    enabled: bool = False
    seed: int = 0
    conn_refuse: float = 0.0
    conn_reset: float = 0.0
    partial_write: float = 0.0
    latency_ms: float = 0.0
    disk_full: float = 0.0


@dataclass
class SelfmonConfig:
    """Self-telemetry: hop ledgers, heartbeats and the deadman
    (telemetry.py). DF_NO_SELFMON=1 turns it off as well."""
    enabled: bool = True
    # a stage with no heartbeat for this long is flagged wedged (its
    # stack is snapshotted and shipped in the DFSTATS batch)
    deadman_window_s: float = 15.0
    check_interval_s: float = 0.0   # 0 = deadman_window_s / 4


@dataclass
class FlowConfig:
    enabled: bool = False           # needs CAP_NET_RAW
    interface: str = ""             # "" = all interfaces
    # local: this host's own traffic (self-ports excluded to break the
    # telemetry feedback loop); mirror: a SPAN/mirror port carrying OTHER
    # hosts' traffic (promiscuous, exclusions kept); analyzer: a dedicated
    # analyzer NIC (promiscuous, no exclusions). Tunnels are decapsulated
    # either way.
    capture_mode: str = "local"     # local | mirror | analyzer
    exclude_ports: list = field(
        default_factory=lambda: [20033, 20035, 20416])


@dataclass
class IntegrationConfig:
    """The node-local integration listener (agent/integration_proxy.py):
    workloads post OTLP, remote-write, Telegraf, Datadog, SkyWalking,
    profiles and logs to it and it forwards them to ``server_http``."""
    enabled: bool = False
    host: str = "0.0.0.0"           # pods reach it by the node's address
    port: int = 38086
    server_http: str = "127.0.0.1:20416"


@dataclass
class BackpressureConfig:
    """Server-directed degradation: one factor per pressure level 0..3
    (SyncResponse.qos), applied to the configured value. Parsed and
    validated; the port applies no backpressure yet."""
    enabled: bool = True
    hz_scale: list = field(default_factory=lambda: [1.0, 0.5, 0.25, 0.1])
    emit_scale: list = field(default_factory=lambda: [1.0, 1.0, 2.0, 4.0])
    topk_scale: list = field(default_factory=lambda: [1.0, 1.0, 0.5, 0.2])
    trace_scale: list = field(default_factory=lambda: [1.0, 1.0, 2.0, 4.0])


@dataclass
class AgentConfig:
    agent_id: int = field(default_factory=default_agent_id)
    app_service: str = ""
    # policy rules [{cidr, port, protocol, action: trace|ignore|pcap|npb}];
    # pcap and npb also capture or forward the matched flows' packets
    acls: list = field(default_factory=list)
    # the NPB broker for action=npb: matched frames, VXLAN-encapsulated
    # with npb_vni, go to host:port over UDP; "" forwards nothing
    npb_target: str = ""
    npb_vni: int = 1
    group: str = "default"        # agent group: config routing and org
    controller: str = ""          # host:port; empty = no controller
    # the /proc socket-inode scan into GpidSync (a gpid and a process name
    # for every local flow endpoint); 0 = off; needs a controller
    socket_scan_interval_s: float = 30.0
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    tpuprobe: TpuProbeConfig = field(default_factory=TpuProbeConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)
    sender: SenderConfig = field(default_factory=SenderConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    selfmon: SelfmonConfig = field(default_factory=SelfmonConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    integration: IntegrationConfig = field(
        default_factory=IntegrationConfig)
    qos: BackpressureConfig = field(default_factory=BackpressureConfig)
    stats_interval_s: float = 10.0
    sync_interval_s: float = 10.0

    @classmethod
    def from_dict(cls, d: dict) -> "AgentConfig":
        """As the reference's: each section present replaces its
        defaults (an unknown key in it raises TypeError), the top-level
        fields present are set, other top-level keys are ignored."""
        cfg = cls()
        for name, section in _SECTIONS.items():
            sd = d.get(name)
            if not isinstance(sd, dict):
                continue
            if name == "sender":
                sd = dict(sd)
                if "servers" in sd:
                    sd["servers"] = [
                        tuple(x) if isinstance(x, (list, tuple))
                        else parse_addr(x) for x in sd["servers"]]
                if isinstance(sd.get("spool"), dict):
                    sd["spool"] = SpoolConfig(**sd["spool"])
            setattr(cfg, name, section(**sd))
        for f in dataclasses.fields(cls):
            if f.name not in _SECTIONS and f.name in d:
                setattr(cfg, f.name, d[f.name])
        return cfg

    @classmethod
    def load(cls, path: str | None = None) -> "AgentConfig":
        """Defaults, or the YAML file at ``path`` (a missing file raises:
        the reference's returns the defaults)."""
        if path is None:
            return cls()
        with open(path, "rb") as f:
            data = yamlcfg.load(f.read())
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise ValueError(f"{path}: an agent config is a YAML mapping")
        return cls.from_dict(data)

    def validate(self) -> "AgentConfig":
        """Type and range checks, the reference's for these fields."""
        def num(v, name, lo=None, hi=None):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{name} must be a number, got {v!r}")
            if lo is not None and v < lo:
                raise ValueError(f"{name} must be >= {lo}, got {v}")
            if hi is not None and v > hi:
                raise ValueError(f"{name} must be <= {hi}, got {v}")

        if isinstance(self.agent_id, bool) or not isinstance(
                self.agent_id, int) or not 0 <= self.agent_id <= MAX_AGENT_ID:
            raise ValueError(f"agent_id must be an int in 0..{MAX_AGENT_ID}, "
                             f"got {self.agent_id!r}")
        num(self.profiler.sample_hz, "profiler.sample_hz", 0.1, 10_000)
        num(self.profiler.emit_interval_s, "profiler.emit_interval_s", 0.01)
        num(self.profiler.memory_interval_s, "profiler.memory_interval_s", 1)
        num(self.tpuprobe.trace_interval_s, "tpuprobe.trace_interval_s", 0.1)
        num(self.tpuprobe.trace_duration_ms, "tpuprobe.trace_duration_ms", 1)
        num(self.tpuprobe.target_coverage, "tpuprobe.target_coverage",
            0.01, 0.95)
        num(self.tpuprobe.steps_per_capture, "tpuprobe.steps_per_capture",
            1, 10_000)
        num(self.tpuprobe.step_topk, "tpuprobe.step_topk", 1, 100)
        num(self.stats_interval_s, "stats_interval_s", 0.1)
        num(self.sync_interval_s, "sync_interval_s", 0.1)
        num(self.selfmon.deadman_window_s, "selfmon.deadman_window_s", 0.1)
        num(self.selfmon.check_interval_s, "selfmon.check_interval_s", 0)
        num(self.sender.queue_size, "sender.queue_size", 1)
        num(self.sender.ack_window, "sender.ack_window", 1)
        num(self.sender.replication, "sender.replication", 1, 8)
        num(self.sender.spool.max_mb, "sender.spool.max_mb", 1)
        num(self.sender.spool.segment_mb, "sender.spool.segment_mb", 1)
        if self.sender.spool.segment_mb > self.sender.spool.max_mb:
            raise ValueError(
                "sender.spool.segment_mb must be <= sender.spool.max_mb "
                "(the cap must hold at least one segment)")
        for p in ("conn_refuse", "conn_reset", "partial_write", "disk_full"):
            num(getattr(self.chaos, p), f"chaos.{p}", 0.0, 1.0)
        num(self.chaos.latency_ms, "chaos.latency_ms", 0)
        num(self.guard.max_cpu_pct, "guard.max_cpu_pct", 1)
        num(self.guard.max_mem_mb, "guard.max_mem_mb", 16)
        num(self.guard.check_interval_s, "guard.check_interval_s", 0.1)
        if not isinstance(self.qos.enabled, bool):
            raise ValueError(
                f"qos.enabled must be a bool, got {self.qos.enabled!r}")
        for sname in ("hz_scale", "emit_scale", "topk_scale",
                      "trace_scale"):
            scales = getattr(self.qos, sname)
            if not isinstance(scales, (list, tuple)) or len(scales) != 4:
                raise ValueError(
                    f"qos.{sname} must be 4 factors (levels 0..3), "
                    f"got {scales!r}")
            for i, v in enumerate(scales):
                num(v, f"qos.{sname}[{i}]", 0.001, 1000)
        for i, a in enumerate(self.acls):
            if not isinstance(a, dict):
                raise ValueError(f"acls[{i}] must be a mapping, got {a!r}")
            if a.get("action", "trace") not in ("trace", "ignore",
                                                "pcap", "npb"):
                raise ValueError(
                    f"acls[{i}].action must be trace|ignore|pcap|npb")
            if a.get("cidr"):
                try:
                    ipaddress.ip_network(a["cidr"], strict=False)
                except ValueError as e:
                    raise ValueError(f"acls[{i}].cidr invalid: {e}") from None
            num(a.get("port", 0), f"acls[{i}].port", 0, 65535)
            num(a.get("protocol", 0), f"acls[{i}].protocol", 0, 3)
        if self.tpuprobe.source not in ("auto", "kineto"):
            raise ValueError(
                f"tpuprobe.source must be auto|kineto (the port's probe "
                f"reads Kineto), got {self.tpuprobe.source!r}")
        if self.flow.capture_mode not in ("local", "mirror", "analyzer"):
            raise ValueError(
                f"flow.capture_mode must be local|mirror|analyzer, "
                f"got {self.flow.capture_mode!r}")
        if self.flow.capture_mode in ("mirror", "analyzer") and \
                not self.flow.interface:
            raise ValueError(
                f"flow.capture_mode={self.flow.capture_mode} needs "
                "flow.interface: promiscuous mode is per-NIC, and an "
                "analyzer NIC must be named (capturing 'all' would "
                "include this host's own telemetry with exclusions off)")
        for b, name in ((self.profiler.enabled, "profiler.enabled"),
                        (self.tpuprobe.enabled, "tpuprobe.enabled"),
                        (self.tpuprobe.step_metrics,
                         "tpuprobe.step_metrics"),
                        (self.sender.spool.enabled, "sender.spool.enabled"),
                        (self.chaos.enabled, "chaos.enabled"),
                        (self.selfmon.enabled, "selfmon.enabled"),
                        (self.flow.enabled, "flow.enabled")):
            if not isinstance(b, bool):
                raise ValueError(f"{name} must be a bool, got {b!r}")
        return self


# AgentConfig's nested blocks, as from_dict reads them
_SECTIONS = {"profiler": ProfilerConfig, "tpuprobe": TpuProbeConfig,
             "guard": GuardConfig, "flow": FlowConfig,
             "integration": IntegrationConfig,
             "sender": SenderConfig, "chaos": ChaosConfig,
             "selfmon": SelfmonConfig, "qos": BackpressureConfig}


def parse_addr(s: str) -> tuple[str, int]:
    """"host[:port]" -> (host, port); a missing port is the default
    ingest port, a missing host is 127.0.0.1."""
    host, sep, port = s.rpartition(":")
    if not sep:
        return (s or "127.0.0.1", DEFAULT_INGEST_PORT)
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        raise ValueError(f"bad server address {s!r}: expected host[:port]"
                         ) from None
