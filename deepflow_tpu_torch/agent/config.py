"""Agent configuration: the probe's fields and where frames go.

A subset of ``deepflow_tpu/agent/config.py``: ``TpuProbeConfig`` keeps the
reference's probe fields that the Kineto source reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TpuProbeConfig:
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
class AgentConfig:
    tpuprobe: TpuProbeConfig = field(default_factory=TpuProbeConfig)
    # "host:port" of an ingester; "" keeps frames in memory
    sink_target: str = ""
