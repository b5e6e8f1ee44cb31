"""Agent runtime: the OnCPU sampler, the device probe, the flow path, the
resource guard, self-telemetry and self-stats over the durable sender.

Own copy of the in-process parts of ``deepflow_tpu/agent/agent.py``:
``Agent`` wires ``OnCpuSampler`` (PROFILE frames), ``TpuProbe``
(TPU_SPAN and STEP_METRICS frames), the flow path (``Dispatcher`` and
``LiveCapture``: L4_LOG, L7_LOG and METRICS frames, with
``flow.enabled``) and a stats thread (DFSTATS frames every
``stats_interval_s``) into one ``UniformSender``, with its spool and
fault injection when configured (with ``sender.replication`` above 1, a
``ReplicatedSender``: one sender and spool subdirectory a ring owner,
the controller's analyzers its owners). The ``Guard`` pauses the profilers
while the agent costs too much; the ``Telemetry`` registry (hop ledgers,
heartbeats) and its ``DeadmanDetector`` ride in every DFSTATS batch, and
a wedge ships one at once. ``attach`` / ``detach`` start and stop one
agent inside the current process; that is how ``python -m
deepflow_tpu_torch.cli.runner`` profiles a script with no change to its
code. With ``controller`` set the agent registers there while it is
built (``agent/synchronizer.py``: a bounded first sync, so its sender
ships under the assigned id from the first frame; an agent id of 0 asks
the controller for one, and one that cannot register falls back to the
id it would have without a controller), then keeps syncing and takes its
group's config by poll and push (reference: agent.py:378-389), and, with
``socket_scan_interval_s`` above 0 (30 s by default), runs the socket
scan that uploads every local socket's process to the controller
(``agent/socket_scan.py``), so the server names the process on each
side of a flow.

The ``Labeler`` (``agent/labeler.py``) is built from ``acls`` and fed the
controller's PodMap by the synchronizer: the dispatcher labels each
closed flow's pods and drops the flows an ACL ignores. With a ``pcap``
or ``npb`` ACL the dispatcher runs ``PacketActions``
(``agent/packet_actions.py``) on the frames of pcap replay and of the
SOCK_RAW capture; an agent started without a dispatcher builds one when
such ACLs are pushed (``ensure_packet_actions``), and the NPB target's
port is excluded from capture as the sender's are.

With ``integration.enabled`` the agent runs the node-local integration
listener (``agent/integration_proxy.py``, port 38086 by default): the
workload's sidecars post OTLP, remote-write, Telegraf, Datadog,
SkyWalking, profiles and logs to ``localhost`` and it forwards them to
the server's querier; its counters ride in ``agent.integration_proxy``
rows, and a port it cannot bind fails the start.

The agent runs beside a workload on the card: ``device`` defaults to
"cuda" and a missing CUDA device is an error. With ``device="cpu"`` the
device probe (its Kineto and memory sources read CUDA only) is left out
and the startup log line says so. With ``device=None`` the agent does no
device work at all and loads no torch: a node agent that only captures.
Live capture that cannot open (no CAP_NET_RAW, no such interface) raises
and names the cause; the agent does not run on without it.

    python -m deepflow_tpu_torch.agent [-f CONFIG.yaml] [--server H:P]
        [--device cuda|cpu] [--agent-id N] [--controller H:P] [--group G]
    python -m deepflow_tpu_torch.agent --server H:P --flow \
        [--interface IFACE] [--capture-mode local|mirror|analyzer]
"""

from __future__ import annotations

import argparse
import atexit
import errno
import logging
import os
import signal
import sys
import tempfile
import threading
import time

from deepflow_tpu_torch.agent.config import AgentConfig, default_agent_id, \
    parse_addr
from deepflow_tpu_torch.agent.guard import Guard, read_self_usage
from deepflow_tpu_torch.agent.labeler import Labeler, acl_rules, \
    has_packet_acls
from deepflow_tpu_torch.agent.profiler import OnCpuSampler, ProfileSample
from deepflow_tpu_torch.agent.sender import ReplicatedSender, UniformSender
from deepflow_tpu_torch.agent.spool import Spool
from deepflow_tpu_torch.chaos import ChaosConfig, ChaosInjector, chaos_from_env
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.telemetry import DeadmanDetector, Telemetry
from deepflow_tpu_torch.tpuprobe.probe import TpuProbe
from deepflow_tpu_torch.tpuprobe.ranks import global_rank
from deepflow_tpu_torch.tpuprobe.sources import KinetoSource, StepHook

log = logging.getLogger("df.agent")

_EVENT_TYPES = {
    "on-cpu": wire.ProfileEventType.ON_CPU,
    "off-cpu": wire.ProfileEventType.OFF_CPU,
    "mem-alloc": wire.ProfileEventType.MEM_ALLOC,
    "tpu-device": wire.ProfileEventType.TPU_DEVICE,
    "tpu-host": wire.ProfileEventType.TPU_HOST,
}


class CaptureError(RuntimeError):
    """Live capture asked for with ``flow.enabled`` cannot open."""


class Agent:
    def __init__(self, config: AgentConfig | None = None,
                 device: str | None = "cuda") -> None:
        if device is None:
            self.device = None  # no device work: torch stays unloaded
        else:
            from deepflow_tpu_torch.device import resolve_device
            self.device = resolve_device(device)
        self.config = (config or AgentConfig()).validate()
        # read before a launcher rewrites sys.argv for its target
        self.process_name = os.path.basename(sys.argv[0]) or "python"
        self.app_service = self.config.app_service or self.process_name
        # the launcher's rank (a workload may set up its process group
        # later; the stats read it then)
        self.rank = global_rank()
        sm = self.config.selfmon
        # config False forces it off; True still honours DF_NO_SELFMON
        self.telemetry = Telemetry(
            "agent", enabled=None if sm.enabled else False)
        self.deadman = DeadmanDetector(
            self.telemetry, window_s=sm.deadman_window_s,
            check_interval_s=sm.check_interval_s or None,
            on_wedge=self._on_wedge)
        self.guard: Guard | None = None
        self.labeler = Labeler()
        self.labeler.load_acls(acl_rules(self.config.acls))
        self.synchronizer = None
        self.socket_scanner = None
        if self.config.controller:
            # registered before the sender exists: every frame carries the
            # controller's id, so no stream splits at an id change
            from deepflow_tpu_torch.agent.synchronizer import Synchronizer
            self.synchronizer = Synchronizer(
                self, self.config.controller,
                interval_s=self.config.sync_interval_s)
            if not self.synchronizer.register() and \
                    not self.config.agent_id:
                self.config.agent_id = default_agent_id()
        sc = self.config.sender
        if sc.replication > 1:
            self.sender = ReplicatedSender(
                sc.servers, replication=sc.replication,
                agent_id=self.config.agent_id, queue_size=sc.queue_size,
                ack_window=sc.ack_window, telemetry=self.telemetry,
                spool_factory=self._build_spool_factory(),
                chaos=self._build_chaos())
        else:
            self.sender = UniformSender(
                sc.servers, agent_id=self.config.agent_id,
                queue_size=sc.queue_size, ack_window=sc.ack_window,
                telemetry=self.telemetry, spool=self._build_spool(),
                chaos=self._build_chaos())
        self.sampler: OnCpuSampler | None = None
        self.tpuprobe = None
        self.dispatcher = None
        self.live_capture = None
        self.integration_proxy = None
        # the probe's step hook is the agent's: installed with the first
        # probe, it counts on while the guard has the probe paused, so the
        # step numbers (the spans' run_id) of a resumed probe continue
        # instead of starting again at 1. Its first step sets the guard's
        # memory baseline, and its holds tell the guard what CPU took the
        # parked training thread's place.
        self.step_hook = (StepHook(on_first_step=self.note_first_step)
                          if self.config.tpuprobe.enabled
                          and self.device_type == "cuda" else None)
        self.first_step_rss: int | None = None
        # the counters of the probes the guard stopped: agent.tpuprobe
        # reports what the agent sent across pauses, not only since the
        # last resume
        self._stopped_probes: dict[str, float] = {}
        self._probe_stats_lock = threading.Lock()
        self._stats_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._components: list[str] = []
        # serializes the sampler's and the probe's lifecycle across the
        # guard's thread and the caller's
        self._profiler_lock = threading.RLock()

    @property
    def device_type(self) -> str:
        """"cuda", "cpu", or "none" for an agent that does no device
        work."""
        return self.device.type if self.device is not None else "none"

    def _build_spool(self) -> Spool | None:
        sc = self.config.sender.spool
        if not sc.enabled:
            return None
        directory = sc.dir or os.path.join(
            tempfile.gettempdir(), f"deepflow-spool-{self.config.agent_id}")
        return Spool(directory, max_bytes=sc.max_mb << 20,
                     segment_bytes=sc.segment_mb << 20,
                     max_age_s=sc.max_age_s)

    def _build_spool_factory(self):
        """The replicated sender's spools: one subdirectory a destination
        (each destination has its own seq space; a shared spool would
        interleave them and break the trim and replay marks)."""
        sc = self.config.sender.spool
        if not sc.enabled:
            return None
        base = sc.dir or os.path.join(
            tempfile.gettempdir(), f"deepflow-spool-{self.config.agent_id}")

        def factory(dest_key: str) -> Spool:
            return Spool(os.path.join(base, dest_key),
                         max_bytes=sc.max_mb << 20,
                         segment_bytes=sc.segment_mb << 20,
                         max_age_s=sc.max_age_s)
        return factory

    def _build_chaos(self) -> ChaosInjector | None:
        """DF_CHAOS wins over the config block."""
        env = chaos_from_env()
        if env is not None:
            return env
        cc = self.config.chaos
        if not cc.enabled:
            return None
        return ChaosInjector(ChaosConfig(
            enabled=True, seed=cc.seed, conn_refuse=cc.conn_refuse,
            conn_reset=cc.conn_reset, partial_write=cc.partial_write,
            latency_ms=cc.latency_ms, disk_full=cc.disk_full))

    # -- lifecycle -----------------------------------------------------------

    def start_sampler(self) -> None:
        with self._profiler_lock:
            if self.sampler is not None:
                return
            if self.guard is not None and self.guard.degraded:
                return  # paused by the guard; its resume restarts it
            self.sampler = OnCpuSampler(
                self._profile_sink, hz=self.config.profiler.sample_hz,
                emit_interval_s=self.config.profiler.emit_interval_s).start()

    def start_tpuprobe(self) -> None:
        with self._profiler_lock:
            if self.tpuprobe is not None or self.device_type != "cuda":
                return
            if self.guard is not None and self.guard.degraded:
                return
            self.tpuprobe = TpuProbe(self).start()

    def pause_profilers(self) -> None:
        """Stop the sampler and the device probe (the guard's breach).
        The probe's stop releases a step it holds and waits for its
        thread to leave the profiler session."""
        with self._profiler_lock:
            if self.sampler is not None:
                self.sampler.stop()
                self.sampler = None
            if self.tpuprobe is not None:
                self.tpuprobe.stop()
                with self._probe_stats_lock:  # counted once, in one place
                    for k, v in self.tpuprobe.stats.items():
                        self._stopped_probes[k] = \
                            self._stopped_probes.get(k, 0) + v
                    self.tpuprobe = None

    def resume_profilers(self) -> None:
        """Start them again as configured, the probe afresh on the
        agent's step hook, so its step numbers run on."""
        with self._profiler_lock:
            if self.config.profiler.enabled:
                self.start_sampler()
            if self.config.tpuprobe.enabled:
                self.start_tpuprobe()

    def note_first_step(self) -> None:
        """The workload's first optimizer step (the probe's step hook,
        on the training thread): the guard's memory baseline."""
        if self.first_step_rss is None:
            self.first_step_rss = read_self_usage()[1]

    def held_cpu_s(self) -> float:
        """CPU seconds the probe's thread spent while the step hook held
        the training thread (the guard leaves them out)."""
        return self.step_hook.held_cpu_s if self.step_hook else 0.0

    def agent_threads(self) -> list[threading.Thread]:
        """The threads this agent started (the guard's CPU reading)."""
        threads = (self.sender.threads()
                   if isinstance(self.sender, ReplicatedSender)
                   else [self.sender._thread])
        threads += [self._stats_thread, self.deadman._thread]
        if self.guard is not None:
            threads.append(self.guard._thread)
        sampler, tpuprobe = self.sampler, self.tpuprobe
        if sampler is not None:
            threads.append(sampler._thread)
        if tpuprobe is not None:
            threads += [src._thread for src in tpuprobe.sources]
        if self.dispatcher is not None:
            threads.append(self.dispatcher._thread)
        if self.live_capture is not None:
            threads += self.live_capture.threads
        if self.synchronizer is not None:
            threads += self.synchronizer.threads
        if self.socket_scanner is not None:
            threads += self.socket_scanner.threads
        return [t for t in threads if t is not None]

    def start(self) -> "Agent":
        self.deadman.start()
        self.sender.start()
        self._components.append("sender")
        if self.config.profiler.enabled:
            self.start_sampler()
            self._components.append("oncpu-sampler")
        left_out = ""
        if self.config.tpuprobe.enabled:
            if self.device_type == "cuda":
                self.start_tpuprobe()
                self._components.append("tpuprobe")
            else:
                left_out = (f"; left out on {self.device_type}: tpuprobe "
                            "(its Kineto and memory sources read CUDA only)")
        if self.config.flow.enabled:
            try:
                self.start_flow()
            except CaptureError:
                self._abort_start()
                raise
        elif has_packet_acls(self.config.acls):
            self.ensure_packet_actions()  # for pcap replay
        if self.config.integration.enabled:
            from deepflow_tpu_torch.agent.integration_proxy import \
                IntegrationProxy
            ic = self.config.integration
            try:
                self.integration_proxy = IntegrationProxy(
                    ic.server_http, host=ic.host, port=ic.port).start()
            except OSError:
                self._abort_start()
                raise
            self._components.append(
                f"integration-proxy (:{self.integration_proxy.port})")
        if self.config.guard.enabled:
            g = self.config.guard
            self.guard = Guard(
                self, max_cpu_pct=g.max_cpu_pct, max_mem_mb=g.max_mem_mb,
                check_interval_s=g.check_interval_s).start()
            self._components.append("guard")
        if self.synchronizer is not None:
            self.synchronizer.start()
            self._components.append(
                f"synchronizer (agent id {self.config.agent_id}"
                + ("" if self.synchronizer.registered else
                   ", not registered") + ")")
            if self.config.socket_scan_interval_s > 0:
                from deepflow_tpu_torch.agent.socket_scan import \
                    SocketScanner
                self.socket_scanner = SocketScanner(
                    self.synchronizer, agent_id=self.config.agent_id,
                    interval_s=self.config.socket_scan_interval_s).start()
                self._components.append("socket-scan")
        self._stats_thread = threading.Thread(
            target=self._stats_loop, name="df-agent-stats", daemon=True)
        self._stats_thread.start()
        self._components.append("stats")
        log.info("agent started: %s%s", ", ".join(self._components),
                 left_out)
        return self

    def start_flow(self) -> None:
        """The dispatcher (native engine) and live capture on
        ``flow.interface``. The agent's own sender ports are always
        excluded from capture, beside ``flow.exclude_ports`` (the
        analyzer mode keeps no exclusion). A capture that cannot open
        raises ``CaptureError`` naming the cause."""
        from deepflow_tpu_torch.agent.dispatcher import Dispatcher
        from deepflow_tpu_torch.agent.live_capture import LiveCapture
        fc = self.config.flow
        self.dispatcher = Dispatcher(
            sender=self.sender, agent_id=self.config.agent_id,
            labeler=self.labeler, telemetry=self.telemetry).start()
        self.dispatcher.packet_actions = self._packet_actions(self.config)
        self._components.append("dispatcher")
        exclude = set(fc.exclude_ports)
        exclude.update(p for _, p in self.sender.servers)
        npb_port = self.dispatcher.packet_actions.npb_port
        if npb_port:  # NPB's own datagrams are not traffic to forward
            exclude.add(npb_port)
        try:
            self.live_capture = LiveCapture(
                self.dispatcher, interface=fc.interface,
                exclude_ports=tuple(sorted(exclude)),
                capture_mode=fc.capture_mode).start()
        except (OSError, AttributeError) as e:
            self.dispatcher.stop()
            where = fc.interface or "all interfaces"
            if isinstance(e, AttributeError):
                cause = "this OS has no AF_PACKET"
            elif e.errno in (errno.EPERM, errno.EACCES):
                cause = (f"{errno.errorcode[e.errno]}: live capture needs "
                         "CAP_NET_RAW")
            elif e.errno == errno.ENODEV:
                cause = f"ENODEV: no interface {fc.interface!r}"
            else:
                cause = f"{errno.errorcode.get(e.errno, e.errno)}: {e}"
            raise CaptureError(
                f"live capture on {where} cannot open ({cause})") from e
        self._components.append(f"live-capture ({self.live_capture.mode})")

    def _packet_actions(self, cfg: AgentConfig):
        from deepflow_tpu_torch.agent.packet_actions import PacketActions
        return PacketActions(self.labeler, sender=self.sender,
                             agent_id=self.config.agent_id,
                             npb_target=cfg.npb_target,
                             npb_vni=cfg.npb_vni)

    def ensure_packet_actions(self, cfg: AgentConfig | None = None) -> None:
        """Pushed pcap or npb ACLs on an agent started without them: a
        dispatcher (for pcap replay) and the action executor, with
        ``cfg``'s NPB target, whose port the running capture then
        excludes."""
        cfg = cfg or self.config
        if self.dispatcher is None:
            from deepflow_tpu_torch.agent.dispatcher import Dispatcher
            self.dispatcher = Dispatcher(
                sender=self.sender, agent_id=self.config.agent_id,
                labeler=self.labeler, telemetry=self.telemetry).start()
            self._components.append("dispatcher")
        pa = self.dispatcher.packet_actions
        if pa is None or (cfg.npb_target and pa.npb_target != cfg.npb_target):
            if pa is not None:
                pa.stop()
            pa = self.dispatcher.packet_actions = self._packet_actions(cfg)
        if self.live_capture is not None and pa.npb_port:
            self.live_capture.exclude_port(pa.npb_port)

    def _abort_start(self) -> None:
        """Undo a start that failed part way: the sources, the deadman
        and the sender stop, with no final stats."""
        self._stop.set()
        if self.synchronizer is not None:
            self.synchronizer.stop()
        self.pause_profilers()
        self.deadman.stop()
        self.sender.flush_and_stop(0.5)

    def stop(self) -> None:
        """Stop the guard and the sources, flush the sender, ship a last
        stats batch and flush that too, within 5 s (and at least 0.5 s
        for the last batch). The last batch is built after the first
        flush, so its ledger shows what the flush left pending."""
        self._stop.set()
        self.deadman.stop()
        if self.socket_scanner is not None:
            self.socket_scanner.stop()
        if self.synchronizer is not None:  # no config applies from here
            self.synchronizer.stop()
        if self.guard:
            self.guard.stop()
        if self.live_capture is not None:
            self.live_capture.stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()  # closes every flow and ships it
        if self.integration_proxy is not None:
            self.integration_proxy.stop()
        with self._profiler_lock:  # after a pause or resume in progress
            if self.sampler:
                self.sampler.stop()
            if self.tpuprobe:
                self.tpuprobe.stop()  # joins a capture still in its parse
        if self.step_hook is not None:
            self.step_hook.remove()
        if self._stats_thread:
            self._stats_thread.join(timeout=2.0)
        deadline = time.monotonic() + 5.0
        self.sender.flush(5.0)
        self._emit_stats()  # the final stats
        self.sender.flush_and_stop(max(0.5, deadline - time.monotonic()))

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

    def _on_wedge(self, verdict: dict) -> None:
        """A deadman verdict ships at once, not at the next stats tick."""
        try:
            self._emit_stats()
        except Exception:
            log.exception("wedge stats emit failed")

    def _stats_loop(self) -> None:
        hb = self.telemetry.heartbeat(
            "stats", interval_hint_s=self.config.stats_interval_s)
        hb.beat()
        while not self._stop.wait(self.config.stats_interval_s):
            hb.beat()
            try:
                self._emit_stats()
            except Exception:
                log.exception("stats emit failed")  # never end the loop

    def _emit_stats(self) -> None:
        ts = time.time_ns()
        batch = wire.StatsBatch()

        base_tags = {"process": self.process_name}
        rank = self.rank if self.rank is not None else global_rank()
        if rank is not None:
            base_tags["rank"] = str(rank)  # one agent per rank

        def metric(name: str, values: dict,
                   extra_tags: dict | None = None) -> None:
            tags = dict(base_tags)
            if extra_tags:
                tags.update((k, str(v)) for k, v in extra_tags.items())
            batch.metrics.append(wire.StatsMetric(
                name=name, timestamp_ns=ts, tags=tags,
                values={k: float(v) for k, v in values.items()}))

        metric("agent.sender", self.sender.stats)
        with self._probe_stats_lock:
            sampler, tpuprobe = self.sampler, self.tpuprobe
            sent = dict(self._stopped_probes)
        if sampler is not None:
            st = sampler.stats
            metric("agent.oncpu_sampler", {
                "samples": st.samples, "emits": st.emits,
                "overruns": st.overruns})
        for k, v in (tpuprobe.stats.items() if tpuprobe is not None else ()):
            sent[k] = sent.get(k, 0) + v
        if sent:  # every probe's sends, those the guard stopped included
            metric("agent.tpuprobe", sent)
        if tpuprobe is not None:
            # the capture source's duty cycle and dead time (numbers only)
            for src in tpuprobe.sources:
                if isinstance(src, KinetoSource):
                    metric("agent.tpuprobe.kineto", {
                        k: v for k, v in src.stats.items()
                        if isinstance(v, (int, float))})
        if self.dispatcher is not None:
            metric("agent.dispatcher", self.dispatcher.stats)
            pa = self.dispatcher.packet_actions
            if pa is not None:
                metric("agent.packet_actions", pa.stats)
        metric("agent.labeler", self.labeler.stats)
        if self.integration_proxy is not None:
            metric("agent.integration_proxy", self.integration_proxy.stats)
        scanner = self.socket_scanner
        if scanner is not None:
            metric("agent.socket_scan", scanner.stats)
        if self.live_capture is not None:
            metric("agent.live_capture", {
                k: v for k, v in self.live_capture.stats.items()
                if isinstance(v, (int, float))},
                extra_tags={"mode": self.live_capture.mode})
        guard = self.guard
        sync = self.synchronizer
        if sync is not None:
            metric("agent.synchronizer", {
                **sync.stats, "registered": int(sync.registered),
                "config_version": sync.config_version,
                "clock_offset_ns": sync.clock_offset_ns,
                "ntp_rtt_ns": sync.ntp_rtt_ns})
        if guard is not None:
            metric("agent.guard", guard.snapshot())
            # which of the agent's threads the guard's reading comes from
            metric("agent.guard.threads", guard.thread_cpu_s)
        # hop ledgers, heartbeats and wedge verdicts ride the same batch
        for name, tags, values in self.telemetry.stats_metrics():
            metric(name, values, extra_tags=tags)
        self.sender.send(MessageType.DFSTATS, batch.SerializeToString())


class _Attached:
    """The process's one attached agent (attach / detach)."""

    agent: Agent | None = None
    atexit_registered = False


def attach(app_service: str = "", servers: list | None = None,
           device: str | None = "cuda", config: AgentConfig | None = None,
           **overrides) -> Agent:
    """Start an agent inside the current process, once; later calls
    return the running one. ``config`` (an agent config file's, say) is
    the base, the defaults without it; ``overrides`` set AgentConfig
    fields; with a ``controller`` and no ``agent_id`` the controller
    assigns the id."""
    if _Attached.agent is not None:
        return _Attached.agent
    cfg = config if config is not None else AgentConfig()
    if app_service:
        cfg.app_service = app_service
    if servers:
        cfg.sender.servers = servers
    for k, v in overrides.items():
        setattr(cfg, k, v)
    if cfg.controller and "agent_id" not in overrides:
        cfg.agent_id = 0
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
        description="deepflow-tpu agent (PyTorch port)")
    parser.add_argument("-f", "--config", default=None,
                        help="agent config YAML (the flags below win)")
    parser.add_argument("--server", default=None,
                        help="host:port of the ingester")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; ignored with --flow")
    parser.add_argument("--flow", action="store_true",
                        help="a node agent: live capture into flow logs "
                             "and metrics, no device work (needs "
                             "CAP_NET_RAW)")
    parser.add_argument("--interface", default="",
                        help="capture interface with --flow; empty = all")
    parser.add_argument("--capture-mode", default="local",
                        choices=("local", "mirror", "analyzer"))
    parser.add_argument("--agent-id", type=int, default=None,
                        help="this agent's id (default: the controller's, "
                             "else the launcher rank's, else 0)")
    parser.add_argument("--controller", default=None,
                        help="host:port of the controller's sync port")
    parser.add_argument("--group", default=None,
                        help="agent group: the controller's config and org")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = AgentConfig.load(args.config)
    if args.server is not None:
        cfg.sender.servers = [parse_addr(args.server)]
    if args.controller is not None:
        cfg.controller = args.controller
    if args.group is not None:
        cfg.group = args.group
    if args.agent_id is not None:
        cfg.agent_id = args.agent_id
    elif cfg.controller and args.config is None:
        cfg.agent_id = 0  # the controller assigns it
    device = args.device
    if args.flow:
        # a node agent profiles no process and touches no device
        cfg.flow.enabled = True
        cfg.flow.interface = args.interface
        cfg.flow.capture_mode = args.capture_mode
        cfg.profiler.enabled = False
        cfg.tpuprobe.enabled = False
        device = None
    agent = Agent(cfg, device=device).start()
    # SIGTERM stops the agent as ^C does: the flows still open are
    # closed and shipped
    signal.signal(signal.SIGTERM, lambda *_: _raise_interrupt())
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        agent.stop()


def _raise_interrupt() -> None:
    raise KeyboardInterrupt
