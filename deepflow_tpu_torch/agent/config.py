"""Agent configuration: the sampler, the probe, the guard, the sender,
fault injection, self-telemetry, self-stats and flow capture.

A subset of ``deepflow_tpu/agent/config.py`` with the reference's field
names, defaults and validation ranges for the fields kept: the OnCPU
sampler (``ProfilerConfig``), the device probe (``TpuProbeConfig``), the
resource guard (``GuardConfig``), the durable sender and its on-disk
spool (``SenderConfig``, ``SpoolConfig``), transport fault injection
(``ChaosConfig``), the self-telemetry spine (``SelfmonConfig``), live
packet capture into the flow path (``FlowConfig``) and the agent's
identity and stats cadence (``AgentConfig``). The guard and
self-telemetry are on by default, the spool, fault injection and flow
capture off.

``AgentConfig.agent_id`` is 0, the reference's default, outside a
launcher. In a process a launcher started (``RANK`` and ``WORLD_SIZE`` in
its environment, as ``torchrun`` sets them) it defaults to the rank's own
nonzero id (``tpuprobe/ranks.py::agent_id_for_rank``), so the ranks of one
job ship under distinct ids into one server: with one shared id, each
sender's sequence numbers start from its own boot epoch and the server's
dedup window drops one rank's frames as duplicates of the other's. An
explicit ``agent_id`` (the runner's ``--agent-id``) wins.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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


@dataclass
class TpuProbeConfig:
    enabled: bool = True
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
class AgentConfig:
    agent_id: int = field(default_factory=default_agent_id)
    app_service: str = ""
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    tpuprobe: TpuProbeConfig = field(default_factory=TpuProbeConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)
    sender: SenderConfig = field(default_factory=SenderConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    selfmon: SelfmonConfig = field(default_factory=SelfmonConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    stats_interval_s: float = 10.0

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
        num(self.tpuprobe.trace_interval_s, "tpuprobe.trace_interval_s", 0.1)
        num(self.tpuprobe.trace_duration_ms, "tpuprobe.trace_duration_ms", 1)
        num(self.tpuprobe.target_coverage, "tpuprobe.target_coverage",
            0.01, 0.95)
        num(self.tpuprobe.steps_per_capture, "tpuprobe.steps_per_capture",
            1, 10_000)
        num(self.tpuprobe.step_topk, "tpuprobe.step_topk", 1, 100)
        num(self.stats_interval_s, "stats_interval_s", 0.1)
        num(self.selfmon.deadman_window_s, "selfmon.deadman_window_s", 0.1)
        num(self.selfmon.check_interval_s, "selfmon.check_interval_s", 0)
        num(self.sender.queue_size, "sender.queue_size", 1)
        num(self.sender.ack_window, "sender.ack_window", 1)
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
