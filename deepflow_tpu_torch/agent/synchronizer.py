"""The agent's side of the control plane: registration, sync, push, NTP.

Own copy of ``deepflow_tpu/agent/synchronizer.py`` (reference analog:
agent/src/rpc/synchronizer.rs) over the port's sync transport
(``server/syncwire.py``; the reference calls gRPC):

- ``register`` is the first ``Sync``, bounded (5 s by default), made
  before the agent's sender exists, so every frame ships under the id
  the controller assigns; a registration that fails leaves the agent on
  its own id and counts ``register_failures``;
- ``sync_once`` every ``interval_s``: an NTP round first, then ``Sync``
  with the agent's state, Guard readings, group, config version and
  epoch, measured clock offset (only once measured: the field's presence
  carries meaning), platform data (``tpuprobe/topology.py``, collected
  again until the workload's CUDA devices show) and process;
- the push loop holds a ``Push`` long poll, so a config saved on the
  controller arrives within a second;
- ``_on_response`` adopts the assigned id, applies a newer config (or
  any on an epoch change) and the analyzer assignment, serialised
  between the poll and the push threads and only ever forward;
- ``_apply_config`` hot-applies the pushed YAML (the port's own reader):
  the sampler's rate and on/off, the probe's on/off and its
  ``KinetoSource`` cadence (taken between captures), the Guard's limits,
  and the ACLs into the labeler (pcap and npb ACLs build the packet
  actions, ``Agent.ensure_packet_actions``);
- ``_sync_pod_map`` after each Sync: the controller's ``PodMap`` into the
  agent's labeler (``Labeler.update_pod_map``), the entries only when the
  labeler's version or epoch is stale; a failure leaves the sync done;
- ``ntp_sync``: three 4-timestamp exchanges, the minimum-RTT one's offset
  folded into the median of the last five;
- ``gpid_sync``: a socket snapshot's gpids (the ``SocketScanner``'s
  uploads).

Left out: remote commands and their results (the agent's operations),
the QoS pressure (``Agent.apply_backpressure``); ``profiler.memory``
parses but nothing applies it (the memory profiler is not ported yet).
"""

from __future__ import annotations

import logging
import os
import socket
import statistics
import threading
import time
from collections import deque

from deepflow_tpu_torch.agent import yamlcfg
from deepflow_tpu_torch.agent.config import AgentConfig, parse_addr
from deepflow_tpu_torch.agent.labeler import acl_rules, has_packet_acls
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.syncwire import PUSH_HOLD_S, SyncClient, \
    SyncError
from deepflow_tpu_torch.tpuprobe.ranks import launcher_identity

log = logging.getLogger("df.sync")

AGENT_VERSION = "0.1.0"
REGISTER_TIMEOUT_S = 5.0


class Synchronizer:
    def __init__(self, agent, controller_addr: str,
                 interval_s: float = 10.0) -> None:
        self.agent = agent
        self.addr = controller_addr
        self.interval_s = interval_s
        self._client = SyncClient(controller_addr)
        self._push_client = SyncClient(controller_addr)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._push_thread: threading.Thread | None = None
        self.config_version = 0
        self.config_epoch = 0
        self.platform_version = 0
        self._platform_cache: wire.PlatformData | None = None
        # the servers the agent was configured with: an analyzer
        # assignment cleared on the controller reverts to them
        self._configured_servers = [
            parse_addr(s) if isinstance(s, str) else tuple(s)
            for s in agent.config.sender.servers]
        self._apply_lock = threading.Lock()  # poll and push both apply
        # which rank of which launcher job this is: the registry's key
        # beside the host (fixed for the process's life)
        self.launcher_id = launcher_identity()
        self.registered = False
        self.stats = {"syncs": 0, "errors": 0, "config_updates": 0,
                      "pushes": 0, "push_updates": 0, "ntp_syncs": 0,
                      "register_failures": 0, "rejected_configs": 0,
                      "rebalances": 0, "config_applied_ns": 0,
                      "config_applied_by_push": 0, "podmap_updates": 0,
                      "podmap_entries": 0, "podmap_errors": 0,
                      "gpid_syncs": 0}
        # NTP against the controller: the median over recent min-RTT
        # exchanges damps a GC pause or a queue
        self.clock_offset_ns = 0
        self.ntp_rtt_ns = 0
        self._ntp_samples: deque[int] = deque(maxlen=5)

    # -- lifecycle -------------------------------------------------------------

    def register(self, timeout_s: float = REGISTER_TIMEOUT_S) -> bool:
        """The first Sync, retried until ``timeout_s``: adopts the
        assigned id and nothing else (the poll loop's first sync applies
        the group's config to the started agent). False, and
        ``register_failures`` counted, when it never answered."""
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            try:
                self.sync_once(apply=False, timeout_s=max(0.2, left))
                self.registered = True
                return True
            except (SyncError, OSError) as e:
                if deadline - time.monotonic() < 0.2:
                    self.stats["register_failures"] += 1
                    log.warning("controller %s did not register this agent "
                                "within %.1f s (%s): it keeps agent id %d",
                                self.addr, timeout_s, e,
                                self.agent.config.agent_id)
                    return False
                time.sleep(0.2)

    def start(self) -> "Synchronizer":
        self._thread = threading.Thread(
            target=self._run, name="df-synchronizer", daemon=True)
        self._thread.start()
        self._push_thread = threading.Thread(
            target=self._push_loop, name="df-sync-push", daemon=True)
        self._push_thread.start()
        return self

    @property
    def threads(self) -> list[threading.Thread]:
        return [t for t in (self._thread, self._push_thread)
                if t is not None]

    def stop(self) -> None:
        self._stop.set()
        self._push_client.abort()
        for t in self.threads:
            t.join(timeout=2.0)
        self._client.close()
        self._push_client.close()

    def _run(self) -> None:
        while True:  # the first sync at once, then on the interval
            try:
                self.sync_once()
            except (SyncError, OSError) as e:
                self.stats["errors"] += 1
                log.debug("sync failed: %s", e)
            except Exception:  # the loop outlives one bad sync
                self.stats["errors"] += 1
                log.exception("sync failed")
            if self._stop.wait(self.interval_s):
                return

    def _push_loop(self) -> None:
        """Held pushes: a config saved on the controller arrives now,
        not at the next poll."""
        while not self._stop.is_set():
            req = wire.SyncRequest(
                agent_group=self.agent.config.group or "default",
                agent_id=self.agent.config.agent_id,
                # the version held: only a newer one answers (and the
                # epoch, else every hold looks stale and replays)
                config_version=self.config_version,
                config_epoch=self.config_epoch)
            try:
                resp = self._push_client.call("Push", req,
                                              timeout_s=PUSH_HOLD_S + 10)
            except (SyncError, OSError):
                if self._stop.wait(2.0):
                    return
                continue
            if resp is None or self._stop.is_set():
                continue
            self.stats["pushes"] += 1
            try:
                self._on_response(resp, by_push=True)
            except Exception:
                log.exception("pushed config apply failed")

    # -- one sync ----------------------------------------------------------------

    def ntp_sync(self, exchanges: int = 3, timeout_s: float = 5.0) -> int:
        """One NTP round: the offset of the minimum-RTT exchange, folded
        into the recent median; returns the smoothed offset (ns, the
        controller's clock less this host's)."""
        best_rtt = None
        best_off = 0
        deadline = time.monotonic() + timeout_s
        for _ in range(exchanges):
            t1 = time.time_ns()
            resp = self._client.call("Ntp", wire.NtpRequest(t1_ns=t1),
                                     timeout_s=_left(deadline))
            t4 = time.time_ns()
            if resp.t1_ns != t1:
                continue  # not our exchange
            rtt = (t4 - t1) - (resp.t3_ns - resp.t2_ns)
            off = ((resp.t2_ns - t1) + (resp.t3_ns - t4)) // 2
            if rtt >= 0 and (best_rtt is None or rtt < best_rtt):
                best_rtt, best_off = rtt, off
        if best_rtt is not None:
            self._ntp_samples.append(best_off)
            self.ntp_rtt_ns = best_rtt
            self.clock_offset_ns = int(statistics.median(self._ntp_samples))
            self.stats["ntp_syncs"] += 1
        return self.clock_offset_ns

    def _platform(self) -> wire.PlatformData:
        """Collected once, again while a device agent shows no device
        (the workload initialises CUDA after the agent starts)."""
        p = self._platform_cache
        if p is None or (not p.devices and
                         getattr(self.agent, "device_type", "") == "cuda"):
            from deepflow_tpu_torch.tpuprobe.topology import \
                collect_platform_data
            p = self._platform_cache = collect_platform_data(
                host_ip=self._client.local_ip())
        return p

    def sync_once(self, apply: bool = True,
                  timeout_s: float = 5.0) -> wire.SyncResponse:
        """NTP, then Sync, within ``timeout_s`` together."""
        deadline = time.monotonic() + timeout_s
        try:
            self.ntp_sync(timeout_s=timeout_s / 2)
        except (SyncError, OSError) as e:
            # best effort: a failed exchange must not block the sync
            log.debug("ntp sync failed: %s", e)
        agent = self.agent
        req = wire.SyncRequest(
            ctrl_ip=self._client.local_ip(_left(deadline)),
            hostname=socket.gethostname(),
            agent_id=agent.config.agent_id,
            config_version=self.config_version,
            config_epoch=self.config_epoch,
            platform_version=self.platform_version,
            version=AGENT_VERSION,
            agent_group=agent.config.group or "default",
            launcher_id=self.launcher_id)
        guard = agent.guard
        if guard is not None and guard.degraded:
            req.state = wire.DEGRADED
            req.exception_bitmap = guard.exception_bitmap
        else:
            req.state = wire.RUNNING
        if guard is not None:
            req.cpu_usage = guard.cpu_pct
            req.mem_bytes = int(guard.rss_mb * 1024 * 1024)
        # the controller's clock less this host's, only once measured: a
        # restarted agent must not clear a stored skew with an unmeasured 0
        if self._ntp_samples:
            req.clock_offset_ns = self.clock_offset_ns
        # re-sent every sync: a restarted controller rebuilds its
        # platform and gpid state from long-lived agents
        req.platform.CopyFrom(self._platform())
        req.processes.append(wire.ProcessInfo(pid=os.getpid(),
                                              name=agent.process_name))
        resp = self._client.call("Sync", req, timeout_s=_left(deadline))
        self.stats["syncs"] += 1
        self._on_response(resp, apply=apply)
        try:
            self._sync_pod_map(_left(deadline))
        except (SyncError, OSError) as e:
            # a PodMap that fails leaves an otherwise good sync done
            self.stats["podmap_errors"] += 1
            log.debug("pod map fetch failed: %s", e)
        return resp

    def _sync_pod_map(self, timeout_s: float = 5.0) -> None:
        """The controller's pods into the labeler, when it is stale."""
        labeler = getattr(self.agent, "labeler", None)
        if labeler is None:
            return
        resp = self._client.call("PodMap", wire.PodMapRequest(
            version=labeler.version, epoch=labeler.epoch),
            timeout_s=timeout_s)
        self.stats["podmap_entries"] += len(resp.entries)
        if labeler.update_pod_map(resp):
            self.stats["podmap_updates"] += 1

    def _on_response(self, resp: wire.SyncResponse, apply: bool = True,
                     by_push: bool = False) -> None:
        with self._apply_lock:  # forward only: a stale poll answer must
            # not undo a newer pushed config
            if resp.agent_id and \
                    resp.agent_id != self.agent.config.agent_id:
                self.agent.config.agent_id = resp.agent_id
                sender = getattr(self.agent, "sender", None)
                if sender is not None:
                    sender.agent_id = resp.agent_id
            if not apply:
                return
            epoch_changed = (resp.config_epoch
                             and resp.config_epoch != self.config_epoch)
            if resp.user_config_yaml and (
                    epoch_changed
                    or resp.config_version > self.config_version):
                self._apply_config(resp.user_config_yaml,
                                   resp.config_version)
                self.config_version = resp.config_version
                if resp.config_epoch:
                    self.config_epoch = resp.config_epoch
                self.stats["config_updates"] += 1
                self.stats["config_applied_ns"] = time.time_ns()
                self.stats["config_applied_by_push"] = int(by_push)
                if by_push:
                    self.stats["push_updates"] += 1
            if resp.platform_version:  # pushes leave it unset
                self.platform_version = resp.platform_version
            if resp.analyzer_assignment:
                self._apply_analyzers(list(resp.analyzer_addrs))

    def _apply_analyzers(self, addrs: list[str]) -> None:
        """Adopt the controller's ingest nodes in its order (the sender
        fails over down the list); an empty list reverts to the
        configured servers."""
        try:
            parsed = [parse_addr(a) for a in addrs]
        except ValueError as e:
            log.warning("bad analyzer list %r: %s", addrs, e)
            return
        if not parsed:
            parsed = list(self._configured_servers)
        sender = self.agent.sender
        if parsed and parsed != sender.servers:
            sender.servers = parsed
            self.stats["rebalances"] += 1
            log.info("analyzer assignment: %s", parsed)

    def _apply_config(self, yaml_bytes: bytes, version: int) -> None:
        """Hot-apply a pushed config; a config that does not parse or
        validate is refused and the running one stays."""
        try:
            data = yamlcfg.load(yaml_bytes) or {}
            if not isinstance(data, dict):
                raise ValueError("agent config must be a YAML mapping")
            new = AgentConfig.from_dict(data).validate()
        except (ValueError, TypeError) as e:
            self.stats["rejected_configs"] += 1
            log.warning("rejecting bad pushed config v%d: %s", version, e)
            return
        agent = self.agent
        cfg = agent.config
        cfg.profiler = new.profiler
        cfg.tpuprobe = new.tpuprobe
        cfg.stats_interval_s = new.stats_interval_s
        cfg.guard = new.guard
        cfg.acls = new.acls
        cfg.npb_target = new.npb_target
        cfg.npb_vni = new.npb_vni
        cfg.qos = new.qos
        labeler = getattr(agent, "labeler", None)
        if labeler is not None:  # pushed ACLs take effect at once
            labeler.load_acls(acl_rules(new.acls))
            if has_packet_acls(new.acls):
                # pushed packet actions are never silently inert
                agent.ensure_packet_actions(new)
        guard = agent.guard  # the controller's knob for a hot agent
        if guard is not None:
            guard.max_cpu_pct = new.guard.max_cpu_pct
            guard.max_mem_mb = new.guard.max_mem_mb
            guard.check_interval_s = new.guard.check_interval_s
        with agent._profiler_lock:
            sampler = agent.sampler
            if new.profiler.enabled and sampler is None:
                agent.start_sampler()  # a no-op while the guard degrades
            elif not new.profiler.enabled and sampler is not None:
                sampler.stop()
                agent.sampler = None
            elif sampler is not None:
                sampler.period_s = 1.0 / new.profiler.sample_hz
                sampler.period_us = int(1_000_000 / new.profiler.sample_hz)
                sampler.emit_interval_s = new.profiler.emit_interval_s
            probe = agent.tpuprobe
            if new.tpuprobe.enabled and probe is None:
                agent.start_tpuprobe()  # a device agent's only
            elif not new.tpuprobe.enabled and probe is not None:
                probe.stop()
                agent.tpuprobe = None
            elif probe is not None:
                tp = new.tpuprobe
                for src in probe.sources:
                    if hasattr(src, "retune"):  # the capture source
                        src.retune(tp.trace_interval_s, tp.trace_duration_ms,
                                   tp.target_coverage, tp.steps_per_capture)
        log.info("applied pushed config v%d", version)

    def gpid_sync(self, entries: list) -> wire.GpidSyncResponse:
        resp = self._client.call("GpidSync", wire.GpidSyncRequest(
            agent_id=self.agent.config.agent_id, entries=entries))
        self.stats["gpid_syncs"] += 1
        return resp


def _left(deadline: float) -> float:
    """Seconds to a monotonic deadline, at least 50 ms."""
    return max(0.05, deadline - time.monotonic())
