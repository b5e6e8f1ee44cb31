"""Agent configuration: the sampler, the probe, the sender and self-stats.

A subset of ``deepflow_tpu/agent/config.py`` with the reference's field
names, defaults and validation ranges for the fields kept: the OnCPU
sampler (``ProfilerConfig``), the device probe (``TpuProbeConfig``), the
durable sender without its spool (``SenderConfig``) and the agent's
identity and stats cadence (``AgentConfig``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_INGEST_PORT = 20033


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
class SenderConfig:
    servers: list = field(default_factory=lambda: [("127.0.0.1",
                                                    DEFAULT_INGEST_PORT)])
    queue_size: int = 8192
    # sent-but-unacked frames kept for retransmit after a reconnect (the
    # transport is always durable: per-frame seq, server acks, dedup)
    ack_window: int = 1024


@dataclass
class AgentConfig:
    agent_id: int = 0
    app_service: str = ""
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    tpuprobe: TpuProbeConfig = field(default_factory=TpuProbeConfig)
    sender: SenderConfig = field(default_factory=SenderConfig)
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
        num(self.sender.queue_size, "sender.queue_size", 1)
        num(self.sender.ack_window, "sender.ack_window", 1)
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
