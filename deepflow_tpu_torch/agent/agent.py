"""Agent runtime: the OnCPU sampler, the device probe and self-stats over
the durable sender.

Own copy of the in-process parts of ``deepflow_tpu/agent/agent.py``:
``Agent`` wires ``OnCpuSampler`` (PROFILE frames), ``TpuProbe`` (TPU_SPAN
and STEP_METRICS frames) and a stats thread (DFSTATS frames every
``stats_interval_s``) into one ``UniformSender``. ``attach`` / ``detach``
start and stop one agent inside the current process; that is how
``python -m deepflow_tpu_torch.cli.runner`` profiles a script with no
change to its code.

The agent runs beside a workload on the card: ``device`` defaults to
"cuda" and a missing CUDA device is an error. With ``device="cpu"`` the
device probe (its Kineto and memory sources read CUDA only) is left out
and the startup log line says so.

    python -m deepflow_tpu_torch.agent [--server H:P] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import atexit
import logging
import os
import sys
import threading
import time

from deepflow_tpu_torch.agent.config import AgentConfig, parse_addr
from deepflow_tpu_torch.agent.profiler import OnCpuSampler, ProfileSample
from deepflow_tpu_torch.agent.sender import UniformSender
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.device import resolve_device
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.tpuprobe.probe import TpuProbe
from deepflow_tpu_torch.tpuprobe.sources import KinetoSource

log = logging.getLogger("df.agent")

_EVENT_TYPES = {
    "on-cpu": wire.ProfileEventType.ON_CPU,
    "off-cpu": wire.ProfileEventType.OFF_CPU,
    "mem-alloc": wire.ProfileEventType.MEM_ALLOC,
    "tpu-device": wire.ProfileEventType.TPU_DEVICE,
    "tpu-host": wire.ProfileEventType.TPU_HOST,
}


class Agent:
    def __init__(self, config: AgentConfig | None = None,
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        self.config = (config or AgentConfig()).validate()
        # read before a launcher rewrites sys.argv for its target
        self.process_name = os.path.basename(sys.argv[0]) or "python"
        self.app_service = self.config.app_service or self.process_name
        sc = self.config.sender
        self.sender = UniformSender(
            sc.servers, agent_id=self.config.agent_id,
            queue_size=sc.queue_size, ack_window=sc.ack_window)
        self.sampler: OnCpuSampler | None = None
        self.tpuprobe = None
        self._stats_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._components: list[str] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Agent":
        self.sender.start()
        self._components.append("sender")
        if self.config.profiler.enabled:
            self.sampler = OnCpuSampler(
                self._profile_sink, hz=self.config.profiler.sample_hz,
                emit_interval_s=self.config.profiler.emit_interval_s).start()
            self._components.append("oncpu-sampler")
        left_out = ""
        if self.config.tpuprobe.enabled:
            if self.device.type == "cuda":
                self.tpuprobe = TpuProbe(self).start()
                self._components.append("tpuprobe")
            else:
                left_out = (f"; left out on {self.device.type}: tpuprobe "
                            "(its Kineto and memory sources read CUDA only)")
        self._stats_thread = threading.Thread(
            target=self._stats_loop, name="df-agent-stats", daemon=True)
        self._stats_thread.start()
        self._components.append("stats")
        log.info("agent started: %s%s", ", ".join(self._components),
                 left_out)
        return self

    def stop(self) -> None:
        """Stop the sources, ship a last stats batch and flush the
        sender (up to its 5 s)."""
        self._stop.set()
        if self.sampler:
            self.sampler.stop()
        if self.tpuprobe:
            self.tpuprobe.stop()  # joins a capture still in its parse
        if self._stats_thread:
            self._stats_thread.join(timeout=2.0)
        self._emit_stats()  # the final stats
        self.sender.flush_and_stop()

    # -- sinks ---------------------------------------------------------------

    def _profile_sink(self, batch: list[ProfileSample]) -> None:
        out = wire.ProfileBatch([
            wire.Profile(
                process_name=self.process_name,
                app_service=self.app_service, pid=s.pid,
                tid=s.tid & 0xFFFFFFFF, thread_name=s.thread_name,
                event_type=_EVENT_TYPES.get(s.event_type,
                                            wire.ProfileEventType.ON_CPU),
                timestamp_ns=s.timestamp_ns, stack=s.stack.encode(),
                value=s.value_us, count=s.count, profiler=s.profiler)
            for s in batch])
        self.sender.send(MessageType.PROFILE, out.SerializeToString())

    def send_tpu_spans(self, payload: bytes) -> bool:
        """A serialized TpuSpanBatch (spans and/or memory samples)."""
        return self.sender.send(MessageType.TPU_SPAN, payload)

    def send_step_metrics(self, payload: bytes) -> bool:
        """A STEP_METRICS payload (JSON; see tpuprobe/stepmetrics.py)."""
        return self.sender.send(MessageType.STEP_METRICS, payload)

    # -- self-stats (DFSTATS -> deepflow_system) -----------------------------

    def _stats_loop(self) -> None:
        while not self._stop.wait(self.config.stats_interval_s):
            try:
                self._emit_stats()
            except Exception:
                log.exception("stats emit failed")  # never end the loop

    def _emit_stats(self) -> None:
        ts = time.time_ns()
        batch = wire.StatsBatch()

        def metric(name: str, values: dict) -> None:
            batch.metrics.append(wire.StatsMetric(
                name=name, timestamp_ns=ts,
                tags={"process": self.process_name},
                values={k: float(v) for k, v in values.items()}))

        metric("agent.sender", self.sender.stats)
        sampler, tpuprobe = self.sampler, self.tpuprobe
        if sampler is not None:
            st = sampler.stats
            metric("agent.oncpu_sampler", {
                "samples": st.samples, "emits": st.emits,
                "overruns": st.overruns})
        if tpuprobe is not None:
            metric("agent.tpuprobe", tpuprobe.stats)
            # the capture source's duty cycle and dead time (numbers only)
            for src in tpuprobe.sources:
                if isinstance(src, KinetoSource):
                    metric("agent.tpuprobe.kineto", {
                        k: v for k, v in src.stats.items()
                        if isinstance(v, (int, float))})
        self.sender.send(MessageType.DFSTATS, batch.SerializeToString())


class _Attached:
    """The process's one attached agent (attach / detach)."""

    agent: Agent | None = None
    atexit_registered = False


def attach(app_service: str = "", servers: list | None = None,
           device: str = "cuda", **overrides) -> Agent:
    """Start an agent inside the current process, once; later calls
    return the running one. ``overrides`` set AgentConfig fields."""
    if _Attached.agent is not None:
        return _Attached.agent
    cfg = AgentConfig()
    if app_service:
        cfg.app_service = app_service
    if servers:
        cfg.sender.servers = servers
    for k, v in overrides.items():
        setattr(cfg, k, v)
    _Attached.agent = Agent(cfg, device=device).start()
    # interpreter teardown with a capture still open can abort the
    # process: detach at exit (detach is idempotent)
    if not _Attached.atexit_registered:
        atexit.register(detach)
        _Attached.atexit_registered = True
    return _Attached.agent


def detach() -> None:
    agent, _Attached.agent = _Attached.agent, None
    if agent is not None:
        agent.stop()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="deepflow-tpu agent (PyTorch port), standalone")
    parser.add_argument("--server", default=None,
                        help="host:port of the ingester")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = AgentConfig()
    if args.server is not None:
        cfg.sender.servers = [parse_addr(args.server)]
    agent = Agent(cfg, device=args.device).start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        agent.stop()
