"""The port's control plane held against the reference.

- The control-plane messages: for the same field values the port's bytes
  are protobuf's, both ways (seeded values for every field of every
  message, a set 0 and an absent ``clock_offset_ns`` apart).
- The controllers: the same request bytes through the reference's
  ``Controller.Sync`` / ``GpidSync`` / ``PromEncode`` (called directly, no
  gRPC server) and the port's give the same response bytes (both stores
  on one epoch), ingest tags, stored offsets, orgs and gpids; ``Ntp``
  echoes and stamps; ``ConfigStore`` takes and refuses what the
  reference's does.
- Every case of ``tests/test_control_plane.py`` and
  ``tests/test_fleet_scale.py:43`` / ``:99`` over the port's transport
  (1,000 agents syncing and holding pushes at once), and dfctl's
  ``agent``, ``agent-group-config`` and ``org`` against the reference's.
- The faults the control plane closes: two launcher jobs of two ranks on
  one host take four ids (a restarted rank its own back), where the
  reference's registry gives them one and rank + 1 gives them two; two
  jobs' rank-0 agents lose frames in one server without a controller and
  none with it; rows carry ``host``, ``host_id`` and the group's org.
"""

import asyncio
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from deepflow_tpu.cli import dfctl as ref_dfctl
from deepflow_tpu.proto import pb
from deepflow_tpu.server import Server as RefServer
from deepflow_tpu.server import controller as ref_ctl
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.agent.profiler import OnCpuSampler
from deepflow_tpu_torch.cli import dfctl
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import controller as port_ctl
from deepflow_tpu_torch.server import syncwire
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.querier import QuerierAPI
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.tpuprobe import ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    return pred()


# -- the messages ------------------------------------------------------------------

MESSAGES = ["TpuDeviceInfo", "PlatformData", "ProcessInfo", "RemoteCommand",
            "CommandResult", "SyncRequest", "NtpRequest", "NtpResponse",
            "QosDirective", "GpidEntry", "SyncResponse", "GpidSyncRequest",
            "GpidSyncResponse", "PromEncodeRequest", "PromEncodeResponse"]
_ENUM_MAX = {"state": 3, "status": 3, "proto": 3}


def _text(rng) -> str:
    n = int(rng.integers(0, 6))
    return "".join(chr(int(c)) for c in rng.choice(
        [0x41, 0x7A, 0xE9, 0x4E2D, 0x1F600, 0x20, 0x30], size=n))


def _scalar(rng, name, kind):
    if rng.random() < 0.25:  # defaults are skipped on the wire
        return {"s": "", "b": b"", "f64": 0.0, "bool": False}.get(kind, 0)
    if kind == "s":
        return _text(rng)
    if kind == "b":
        return bytes(rng.integers(0, 256, size=int(rng.integers(1, 9)),
                                  dtype=np.uint8))
    if kind == "u32":
        return int(rng.integers(0, 1 << 32, dtype=np.uint64))
    if kind == "u64":
        return int(rng.integers(0, 1 << 63, dtype=np.uint64)) * 2 + 1
    if kind == "i32":
        return int(rng.integers(-(1 << 31), 1 << 31))
    if kind == "enum":
        return int(rng.integers(0, _ENUM_MAX[name] + 1))
    if kind == "f64":
        return float(rng.choice([-0.0, 1.5, -2.25e300, float("inf"),
                                 rng.standard_normal()]))
    if kind == "bool":
        return True
    if kind == "os64":
        return int(rng.integers(-(1 << 62), 1 << 62)) * 2
    raise AssertionError(kind)


def _fill(rng, cls, pbm, depth=0):
    """A port message and the same values set on the protobuf one."""
    msg = cls()
    for f in cls.FIELDS:
        name, _, kind = f[:3]
        if name == "launcher_id":  # the port's own field
            continue
        if kind == "msg":
            if rng.random() < 0.6 and depth < 3:
                sub = getattr(pbm, name)
                sub.SetInParent()
                port_sub = _fill(rng, f[3], sub, depth + 1)
                getattr(msg, name).CopyFrom(port_sub)
        elif kind == "rep":
            items = []
            for _ in range(int(rng.integers(0, 3)) if depth < 3 else 0):
                items.append(_fill(rng, f[3], getattr(pbm, name).add(),
                                   depth + 1))
            setattr(msg, name, items)
        elif kind in ("rs", "ru32", "ri32"):
            n = int(rng.integers(0, 4))
            vals = ([_text(rng) for _ in range(n)] if kind == "rs" else
                    [int(rng.integers(0, 1 << 32, dtype=np.uint64))
                     for _ in range(n)] if kind == "ru32" else
                    [int(rng.integers(-(1 << 31), 1 << 31))
                     for _ in range(n)])
            setattr(msg, name, vals)
            getattr(pbm, name).extend(vals)
        elif kind == "os64":
            if rng.random() < 0.6:
                v = 0 if rng.random() < 0.3 else _scalar(rng, name, kind)
                setattr(msg, name, v)
                setattr(pbm, name, v)
        else:
            v = _scalar(rng, name, kind)
            setattr(msg, name, v)
            setattr(pbm, name, v)
    return msg


@pytest.mark.parametrize("name", MESSAGES)
@pytest.mark.parametrize("seed", range(4))
def test_messages_are_protobufs_bytes_both_ways(name, seed):
    rng = np.random.default_rng(seed * 1000 + MESSAGES.index(name))
    ref = getattr(pb, name)()
    port = _fill(rng, getattr(wire, name), ref)
    data = ref.SerializeToString()
    assert port.SerializeToString() == data
    assert getattr(wire, name).FromString(data).SerializeToString() == data
    assert getattr(pb, name).FromString(port.SerializeToString()) == ref


def test_clock_offset_presence_and_zigzag():
    for v in (None, 0, 1, -1, 5_000_000_000, -(1 << 63), (1 << 63) - 1):
        ref, port = pb.SyncRequest(), wire.SyncRequest()
        if v is not None:
            ref.clock_offset_ns = v
            port.clock_offset_ns = v
        data = ref.SerializeToString()
        assert port.SerializeToString() == data
        back = wire.SyncRequest.FromString(data)
        assert back.HasField("clock_offset_ns") is (v is not None)
        assert back.clock_offset_ns == (v or 0)
    with pytest.raises(wire.WireError):
        wire.SyncRequest(clock_offset_ns=1 << 63).SerializeToString()


def test_launcher_id_is_the_ports_own_field():
    """The reference parses it as unknown and registers by host."""
    data = wire.SyncRequest(hostname="h", launcher_id="job/3") \
        .SerializeToString()
    assert pb.SyncRequest.FromString(data).hostname == "h"
    assert wire.SyncRequest.FromString(data).launcher_id == "job/3"
    assert wire.SyncRequest(hostname="h").SerializeToString() == \
        pb.SyncRequest(hostname="h").SerializeToString()


# -- the controllers on the same requests ----------------------------------------------

EPOCH = 0x1234_5678_9ABC


def _pair():
    port = port_ctl.Controller(PlatformInfoTable())
    ref = ref_ctl.Controller(RefPlatform())
    port.configs.epoch = ref.configs.epoch = EPOCH
    return port, ref


def _platform(host, worker="3", slice_id=2, devices=2):
    p = pb.PlatformData(hostname=host, host_ip="10.1.0.1", pod_name="pod-a",
                        pod_namespace="ns", tpu_pod_name="run-7",
                        tpu_worker_id=worker, slice_count=1,
                        accelerator_type="NVIDIA H100 80GB HBM3")
    for d in range(devices):
        p.devices.add(device_id=d, chip_id=d, slice_id=slice_id,
                      device_kind="NVIDIA H100 80GB HBM3",
                      hbm_bytes=85 << 30)
    return p


def _sync(port, ref, req: pb.SyncRequest, port_version=None) -> int:
    """Both controllers' answers to the same bytes: equal, but for the
    config version where the port's store-wide count differs
    (``port_version``)."""
    data = req.SerializeToString()
    a = port.Sync(wire.SyncRequest.FromString(data), None)
    b = ref.Sync(pb.SyncRequest.FromString(data), None)
    if port_version is not None:
        assert a.config_version == port_version
        a.config_version = b.config_version
    assert a.SerializeToString() == b.SerializeToString(), (a, b)
    return a.agent_id


def _same_state(port, ref, agent_ids):
    for aid in agent_ids:
        assert port.platform_table.tags_for(aid) == \
            ref.platform_table.tags_for(aid)
        assert port.platform_table.offset_for(aid) == \
            ref.platform_table.offset_for(aid)
    drop = ("first_seen_ns", "last_seen_ns", "launcher_id")
    assert [{k: v for k, v in e.items() if k not in drop}
            for e in port.registry.list()] == \
        [{k: v for k, v in e.items() if k not in drop}
         for e in ref.registry.list()]
    assert port.org_assignments() == ref.org_assignments()


def test_sync_answers_as_reference():
    port, ref = _pair()
    req = pb.SyncRequest(ctrl_ip="10.0.0.1", hostname="h1", state=1,
                         cpu_usage=12.5, mem_bytes=1 << 30, version="0.1.0",
                         clock_offset_ns=5_000_000_000)
    req.platform.CopyFrom(_platform("h1"))
    req.processes.add(pid=11, name="python")
    a1 = _sync(port, ref, req)
    a2 = _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.2", hostname="h2",
                                         agent_group="prod"))
    assert (a1, a2) == (1, 2)
    yaml_prod = b"profiler:\n  sample_hz: 42.0\n"
    # the store-wide version: the group's first is not the default's 1
    assert ref.configs.update("prod", yaml_prod) == 1
    assert port.configs.update("prod", yaml_prod) == 2
    for ctl in (port, ref):
        ctl.assign_org("prod", 2)
    req2 = pb.SyncRequest(ctrl_ip="10.0.0.2", hostname="h2", agent_id=a2,
                          agent_group="prod", exception_bitmap=3, state=3)
    req2.platform.CopyFrom(_platform("h2", worker="0", slice_id=0))
    _sync(port, ref, req2, port_version=2)
    # an up-to-date agent gets no config; a stale epoch gets it again
    _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.1", hostname="h1",
                                    agent_id=a1, config_version=1,
                                    config_epoch=EPOCH))
    _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.1", hostname="h1",
                                    agent_id=a1, config_version=1,
                                    config_epoch=7, clock_offset_ns=0))
    # an explicit id is adopted and moves the next one past it
    assert _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.3",
                                           hostname="h3", agent_id=40)) == 40
    assert _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.4",
                                           hostname="h4")) == 41
    for ctl in (port, ref):
        ctl.set_analyzers(["10.9.0.1:20033", "10.9.0.2:20033"])
    _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.1", hostname="h1",
                                    agent_id=a1))
    for ctl in (port, ref):
        ctl.set_analyzers([])  # managed and empty: agents revert
    _sync(port, ref, pb.SyncRequest(ctrl_ip="10.0.0.1", hostname="h1",
                                    agent_id=a1))
    _same_state(port, ref, [a1, a2, 40, 41, 99])
    tags = port.platform_table.tags_for(a2)
    assert (tags["host"], tags["org_id"], tags["tpu_pod"]) == \
        ("h2", 2, "run-7")
    assert port.platform_table.offset_for(a1) == 0  # the measured 0
    assert port.registry.group_of(a2) == "prod"


def test_gpid_and_prom_encode_answer_as_reference():
    port, ref = _pair()
    req = pb.GpidSyncRequest(agent_id=3)
    for pid, port_no, role in ((4242, 8080, 1), (4243, 40000, 0),
                               (4242, 9090, 1)):
        req.entries.add(agent_id=99, pid=pid, ip=b"\x0a\x00\x00\x01",
                        port=port_no, proto=1, role=role,
                        process_name="srv")
    for step in range(2):
        data = req.SerializeToString()
        a = port.GpidSync(wire.GpidSyncRequest.FromString(data), None)
        b = ref.GpidSync(pb.GpidSyncRequest.FromString(data), None)
        assert a.SerializeToString() == b.SerializeToString()
        assert {e.agent_id for e in a.entries} == {3}
        for key in ((b"\x0a\x00\x00\x01", 8080, 1),
                    (b"\x0a\x00\x00\x01", 40000, 1),
                    (b"\x0a\x00\x00\x01", 9090, 1),
                    (b"\x0a\x00\x00\x02", 8080, 1)):
            assert port.gpids.lookup(*key) == ref.gpids.lookup(*key)
            assert port.gpids.name_lookup(*key) == ref.gpids.name_lookup(*key)
        if step == 0:
            del req.entries[2]  # a snapshot: the next sync drops 9090
    assert port.gpids.lookup(b"\x0a\x00\x00\x01", 9090, 1) == 0
    assert port.gpids.gpid_for(3, 4242) == ref.gpids.gpid_for(3, 4242) == 1
    enc = pb.PromEncodeRequest(metric_names=["up", "rps", "up"],
                               label_sets=['{"a":"1"}', '{}', '{"a":"1"}'])
    data = enc.SerializeToString()
    a = port.prom_encoder.handle(wire.PromEncodeRequest.FromString(data))
    b = ref.prom_encoder.handle(pb.PromEncodeRequest.FromString(data))
    assert a.SerializeToString() == b.SerializeToString()
    assert list(a.metric_ids) == [1, 2, 1]
    for enc_ in (port.prom_encoder, ref.prom_encoder):
        enc_.seed({"old": 9}, {})
    assert port.prom_encoder.encode(["new"], []) == \
        ref.prom_encoder.encode(["new"], []) == ([10], [])


def test_ntp_echoes_and_stamps():
    port, _ = _pair()
    t0 = time.time_ns()
    resp = port.Ntp(wire.NtpRequest(t1_ns=123), None)
    assert resp.t1_ns == 123 and t0 <= resp.t2_ns <= resp.t3_ns


CONFIGS = [
    (port_ctl.DEFAULT_AGENT_CONFIG_YAML, True),
    (b"profiler:\n  sample_hz: 250.0\n  emit_interval_s: 0.5\n", True),
    (b"", True), (b"# nothing\n", True),
    (b"guard:\n  max_cpu_pct: 20\ntpuprobe:\n  steps_per_capture: 5\n",
     True),
    (b"acls: [{cidr: 10.0.0.0/8, action: ignore}]\n", True),
    (b"integration: {enabled: true}\nnot_a_field: 3\n", True),
    (b"- just\n- a list\n", False),
    (b"profiler:\n  sample_hz: not_a_number\n", False),
    (b"profiler:\n  sample_hz: 0.001\n", False),
    (b"guard:\n  max_cpu: 10\n", False),
    (b"tpuprobe:\n  target_coverage: 1.5\n", False),
    (b"acls: [{action: drop}]\n", False),
    (b"a: [1, 2\n", False),
]


@pytest.mark.parametrize("yaml_bytes,ok", CONFIGS)
def test_config_store_takes_what_the_reference_takes(yaml_bytes, ok):
    port, ref = _pair()
    versions = []
    for ctl in (port, ref):
        try:
            versions.append(ctl.configs.update("g", yaml_bytes))
        except Exception:  # yaml's errors, ValueError, TypeError
            versions.append(None)
    assert versions == ([2, 1] if ok else [None, None])


def test_a_new_groups_config_reaches_agents_on_the_default(server):
    """An agent of a group with no config of its own holds the default's
    version 1; the group's first config must reach it (the reference's
    per-group count gives it version 1 too, and the agent never gets
    it)."""
    agent = make_agent(server, group="fresh", sync_interval_s=3600).start()
    try:
        assert _wait(lambda: agent.synchronizer.config_version == 1)
        v = server.controller.configs.update(
            "fresh", b"profiler:\n  sample_hz: 77.0\n")
        assert v == 2
        assert _wait(lambda: agent.config.profiler.sample_hz == 77.0)
        assert agent.synchronizer.stats["config_applied_by_push"] == 1
    finally:
        agent.stop()
    ref = ref_ctl.Controller(RefPlatform())
    assert ref.configs.update("fresh", b"stats_interval_s: 5.0\n") == 1


def test_config_store_listeners_and_epoch():
    port, _ = _pair()
    seen = []
    port.configs.subscribe(lambda g, y, v: seen.append((g, v)))
    port.configs.update("a", b"stats_interval_s: 5.0\n")
    port.configs.update("a", b"stats_interval_s: 6.0\n")
    assert seen == [("a", 2), ("a", 3)]
    assert port.configs.get("nope") == port.configs.get("default")
    assert 0 < port_ctl.ConfigStore().epoch < 1 << 48


# -- the reference's control-plane cases on the port's transport --------------------------


@pytest.fixture
def server():
    s = Server(ingest_port=0, query_port=0, sync_port=0,
               selfstats_interval_s=3600,
               enable_controller=True).start()
    yield s
    s.stop()


def make_agent(server, **kw):
    cfg = AgentConfig(agent_id=0)
    cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
    cfg.controller = f"127.0.0.1:{server.sync_port}"
    cfg.profiler.enabled = False
    cfg.tpuprobe.enabled = False
    cfg.sync_interval_s = 0.2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return Agent(cfg, device="cpu")


def test_sync_assigns_agent_id_and_platform(server):
    agent = make_agent(server)
    # registered while built: the id is there before anything ships
    assert agent.synchronizer.registered
    assert agent.config.agent_id == 1 and agent.sender.agent_id == 1
    agent.start()
    try:
        assert _wait(lambda: agent.synchronizer.stats["syncs"] >= 2)
        info = server.platform.query(1)
        assert info.host and info.host_id >= 1
        agents = server.controller.registry.list()
        assert len(agents) == 1 and agents[0]["agent_id"] == 1
        assert agents[0]["state"] == wire.RUNNING
    finally:
        agent.stop()


def test_config_push_hot_applies(server):
    agent = make_agent(server, sync_interval_s=3600).start()  # push only
    agent.config.profiler.enabled = True  # a sampler that runs
    agent.sampler = OnCpuSampler(lambda b: None, hz=99.0)
    try:
        assert _wait(lambda: agent.synchronizer.config_version == 1)
        new_yaml = b"profiler:\n  sample_hz: 250.0\n  emit_interval_s: 0.5\n"
        t0 = time.time_ns()
        assert server.controller.configs.update("default", new_yaml) == 2
        assert _wait(lambda: agent.synchronizer.config_version == 2)
        st = agent.synchronizer.stats
        assert st["config_applied_by_push"] == 1
        assert st["config_applied_ns"] - t0 < 2_000_000_000
        assert agent.config.profiler.sample_hz == 250.0
        assert agent.sampler.period_us == 4000
        assert agent.sampler.emit_interval_s == 0.5
    finally:
        agent.stop()


def test_config_validation_rejects_garbage(server):
    with pytest.raises(Exception):
        server.controller.configs.update("default", b"- just\n- a list\n")
    with pytest.raises(Exception):
        server.controller.configs.update(
            "default", b"profiler:\n  sample_hz: not_a_number\n")
    assert server.controller.configs.get("default")[1] == 1


def test_gpid_sync(server):
    agent = make_agent(server).start()
    try:
        e = wire.GpidEntry(pid=4242, ip=b"\x0a\x00\x00\x01", port=8080,
                           proto=wire.TCP, role=1)
        resp = agent.synchronizer.gpid_sync([e])
        assert len(resp.entries) == 1 and resp.entries[0].gpid > 0
        assert resp.entries[0].agent_id == agent.config.agent_id
        resp2 = agent.synchronizer.gpid_sync([e])
        assert resp2.entries[0].gpid == resp.entries[0].gpid
        assert server.controller.gpids.lookup(b"\x0a\x00\x00\x01", 8080,
                                              wire.TCP) == \
            resp.entries[0].gpid
    finally:
        agent.stop()


def test_tag_injection_uses_sync_platform(server):
    """Rows ingested after the sync carry the platform's host tag."""
    agent = make_agent(server).start()
    try:
        batch = wire.StatsBatch([wire.StatsMetric(
            name="test", timestamp_ns=time.time_ns(), values={"v": 1.0})])
        agent.sender.send(MessageType.DFSTATS, batch.SerializeToString())
        assert server.wait_for_rows("deepflow_system.deepflow_system", 1)
        t = server.db.table("deepflow_system.deepflow_system")
        cols = t.column_concat(["host", "agent_id", "host_id"])
        assert t.dicts["host"].decode(int(cols["host"][0])) != ""
        assert cols["agent_id"].tolist()[0] == 1
        assert cols["host_id"].tolist()[0] >= 1
    finally:
        agent.stop()


def test_group_config_routing(server):
    server.controller.configs.update("prod", b"profiler:\n  sample_hz: 42.0\n")
    agent = make_agent(server, group="prod").start()
    try:
        assert _wait(lambda: agent.synchronizer.stats["config_updates"] > 0)
        assert agent.config.profiler.sample_hz == 42.0
        assert server.controller.registry.group_of(1) == "prod"
    finally:
        agent.stop()


def test_enable_flag_hot_applies(server):
    agent = make_agent(server).start()
    try:
        # the default config enables the profiler: a sampler starts
        assert _wait(lambda: agent.sampler is not None)
        server.controller.configs.update(
            "default", b"profiler:\n  enabled: false\n"
                       b"tpuprobe:\n  enabled: false\n")
        assert _wait(lambda: agent.sampler is None)
    finally:
        agent.stop()


def test_controller_restart_recovers_platform(server):
    agent = make_agent(server).start()
    try:
        assert _wait(lambda: agent.synchronizer.stats["syncs"] >= 1)
        server.controller._platforms.clear()  # the controller's state lost
        server.platform._agents.clear()
        assert _wait(lambda: bool(server.platform.query(1).host))
        assert server.controller.platform_of(1) is not None
    finally:
        agent.stop()


def test_bad_pushed_config_is_refused_and_the_agent_keeps_running(server):
    agent = make_agent(server).start()
    try:
        assert _wait(lambda: agent.synchronizer.config_version == 1)
        # valid for the store, refused by the agent's own validation:
        # a store of another version could push anything
        server.controller.configs._configs["default"] = (
            b"profiler:\n  sample_hz: 0.0001\n", 2)
        server.controller._on_config_update("default", b"", 2)
        assert _wait(lambda: agent.synchronizer.stats["rejected_configs"])
        assert agent.config.profiler.sample_hz == 99.0
    finally:
        agent.stop()


def test_registration_failure_keeps_the_agents_id(monkeypatch):
    """No controller listening: the bounded first sync fails, is counted,
    and a launcher rank keeps rank + 1."""
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    cfg = AgentConfig(agent_id=0, controller="127.0.0.1:1")
    t0 = time.monotonic()
    agent = Agent(cfg, device=None)
    assert time.monotonic() - t0 < 8
    assert not agent.synchronizer.registered
    assert agent.synchronizer.stats["register_failures"] == 1
    assert agent.config.agent_id == 3 and agent.sender.agent_id == 3


# -- the fleet -----------------------------------------------------------------------


async def _http(reader, writer, method: str, msg) -> tuple[int, bytes]:
    body = msg.SerializeToString()
    writer.write((f"POST {syncwire.method_path(method)} HTTP/1.1\r\n"
                  f"Host: x\r\nContent-Length: {len(body)}\r\n\r\n")
                 .encode() + body)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split(" ")[1])
    length = next(int(v) for k, _, v in (x.partition(":") for x in lines[1:])
                  if k.lower() == "content-length")
    return status, await reader.readexactly(length)


def test_thousand_agents_sync_and_push():
    """1,000 agents sync over 10 connections, then each holds a push on a
    connection of its own; one config bump answers every push."""
    ctrl = port_ctl.Controller(PlatformInfoTable(), port=0).start()
    n_agents = 1000

    async def fleet():
        t0 = time.monotonic()
        versions = []
        for c in range(10):
            r, w = await asyncio.open_connection("127.0.0.1", ctrl.port)
            for i in range(100):
                n = c * 100 + i
                status, body = await _http(r, w, "Sync", wire.SyncRequest(
                    ctrl_ip=f"10.{n >> 8}.{n & 255}.1", hostname=f"sim-{n}",
                    version="2.0", cpu_usage=1.5, mem_bytes=1 << 20))
                assert status == 200
                resp = wire.SyncResponse.FromString(body)
                assert resp.status == wire.SUCCESS
                versions.append((resp.config_version, resp.config_epoch))
            w.close()
        sync_wall = time.monotonic() - t0
        assert len(ctrl.registry.list()) == n_agents
        conns = [await asyncio.open_connection("127.0.0.1", ctrl.port)
                 for _ in range(n_agents)]
        pushes = [asyncio.ensure_future(_http(
            r, w, "Push", wire.SyncRequest(config_version=v, config_epoch=e)))
            for (r, w), (v, e) in zip(conns, versions)]
        deadline = time.monotonic() + 15
        while ctrl.push_streams < n_agents and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert ctrl.push_streams == n_agents
        t0 = time.monotonic()
        await asyncio.get_running_loop().run_in_executor(
            None, ctrl.configs.update, "default",
            b"profiler:\n  enabled: false\n")
        got = await asyncio.wait_for(asyncio.gather(*pushes), timeout=30)
        push_wall = time.monotonic() - t0
        for status, body in got:
            assert status == 200
            assert b"enabled: false" in \
                wire.SyncResponse.FromString(body).user_config_yaml
        for _, w in conns:
            w.close()
        return sync_wall, push_wall

    try:
        sync_wall, push_wall = asyncio.run(fleet())
        assert sync_wall < 60 and push_wall < 5, (sync_wall, push_wall)
        assert _wait(lambda: ctrl.push_streams == 0)
    finally:
        ctrl.stop()


def test_push_holds_then_answers_no_content():
    ctrl = port_ctl.Controller(PlatformInfoTable(), port=0)
    ctrl.push_hold_s = 0.3
    ctrl.start()
    client = syncwire.SyncClient(f"127.0.0.1:{ctrl.port}")
    try:
        v, e = ctrl.configs.get("default")[1], ctrl.configs.epoch
        t0 = time.monotonic()
        assert client.call("Push", wire.SyncRequest(
            config_version=v, config_epoch=e)) is None
        assert 0.25 < time.monotonic() - t0 < 3
        # a stale version answers at once, on the same connection
        resp = client.call("Push", wire.SyncRequest(config_version=0))
        assert resp.config_version == v and resp.user_config_yaml
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", ctrl.port, timeout=5)
        for verb, path, status in (
                ("POST", "/deepflow_tpu.Synchronizer/Nope", 404),
                ("GET", "/deepflow_tpu.Synchronizer/Sync", 405),
                ("POST", "/deepflow_tpu.Synchronizer/Sync", 400)):
            conn.request(verb, path, b"\xff\xff" if status == 400 else b"")
            r = conn.getresponse()
            r.read()
            assert r.status == status, (verb, path)
        conn.close()
    finally:
        client.close()
        ctrl.stop()
    assert not ctrl.running()


def test_sync_port_in_use_fails_the_start():
    a = port_ctl.Controller(PlatformInfoTable(), port=0).start()
    try:
        b = port_ctl.Controller(PlatformInfoTable(), port=a.port)
        with pytest.raises(OSError):
            b.start()
        assert not b.running()
    finally:
        a.stop()


def test_agents_health_fields():
    """/v1/agents: staleness, exception bitmap, degraded state; the
    port's also the clock offset and the platform's devices."""
    ctrl = port_ctl.Controller(PlatformInfoTable(), port=0).start()
    client = syncwire.SyncClient(f"127.0.0.1:{ctrl.port}")
    try:
        client.call("Sync", wire.SyncRequest(
            ctrl_ip="10.0.0.1", hostname="healthy", version="2.0",
            cpu_usage=2.5, clock_offset_ns=1_500_000))
        sick = wire.SyncRequest(ctrl_ip="10.0.0.2", hostname="sick",
                                exception_bitmap=3, state=wire.DEGRADED)
        sick.platform.CopyFrom(wire.PlatformData.FromString(
            _platform("sick").SerializeToString()))
        client.call("Sync", sick)
        api = QuerierAPI(Database(), controller=ctrl)
        agents = {a["hostname"]: a for a in api.agents()["agents"]}
        assert agents["healthy"]["degraded"] is False
        assert agents["healthy"]["cpu_usage"] == 2.5
        assert agents["healthy"]["staleness_s"] < 5
        assert agents["healthy"]["stale"] is False
        assert agents["healthy"]["clock_offset_ms"] == 1.5
        assert agents["healthy"]["platform"] is None  # none uploaded
        assert agents["sick"]["exception_bitmap"] == 3
        assert agents["sick"]["degraded"] is True
        assert agents["sick"]["state"] == wire.DEGRADED
        assert agents["sick"]["clock_offset_ms"] is None
        assert agents["sick"]["platform"]["devices"][1] == {
            "device_id": 1, "chip_id": 1,
            "device_kind": "NVIDIA H100 80GB HBM3", "hbm_bytes": 85 << 30}
    finally:
        client.close()
        ctrl.stop()
    assert QuerierAPI(Database()).agents() == {"agents": []}


# -- dfctl -------------------------------------------------------------------------


@pytest.fixture
def server_pair():
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    sync_port=0, enable_controller=True).start()
    port = Server(ingest_port=0, query_port=0, sync_port=0,
                  selfstats_interval_s=3600,
                  enable_controller=True).start()
    yield ref, port
    ref.stop()
    port.stop()


def _out(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def test_dfctl_fleet_commands_print_as_reference(server_pair, capsys,
                                                 tmp_path):
    ref, port = server_pair
    for srv, msgs in ((ref, pb), (port, wire)):
        for n in range(2):
            srv.controller.Sync(msgs.SyncRequest(
                ctrl_ip=f"10.0.0.{n}", hostname=f"h{n}", version="0.1.0"),
                None)
    cfg = tmp_path / "prod.yaml"
    cfg.write_text("profiler:\n  sample_hz: 42.0\n")
    bad = tmp_path / "bad.yaml"
    bad.write_text("profiler:\n  sample_hz: x\n")
    for argv in (["agent", "list"], ["org"], ["org", "--assign", "prod", "2"],
                 ["org", "--assign", "dev", "3"], ["org"],
                 ["org", "--assign", "prod", "1"], ["org"],
                 ["agent-group-config", "set", str(cfg), "--group", "prod"],
                 ["agent-group-config", "set", str(cfg), "--group", "prod"]):
        want = _out(ref_dfctl.main,
                    ["--server", f"127.0.0.1:{ref.query_port}"] + argv,
                    capsys)
        got = _out(dfctl.main,
                   ["--server", f"127.0.0.1:{port.query_port}"] + argv,
                   capsys)
        if argv[0] == "agent":  # STALE_S: seconds since each's sync
            want, got = [(rc, re.sub(r"\b\d+\.\d\b", "S", text))
                         for rc, text in (want, got)]
        if argv[0] == "agent-group-config":
            # the port counts versions across its store: one past the
            # reference's per-group count here
            v = int(want[1].rsplit(" ", 1)[1])
            want = (want[0], want[1].replace(f"version {v}",
                                             f"version {v + 1}"))
        assert got == want, argv
    # a refused config exits non-zero on both
    for main, srv in ((ref_dfctl.main, ref), (dfctl.main, port)):
        with pytest.raises(SystemExit) as e:
            main(["--server", f"127.0.0.1:{srv.query_port}",
                  "agent-group-config", "set", str(bad)])
        assert "error" in str(e.value.code)
    assert port.controller.org_assignments() == {"dev": 3}


def test_querier_routes_without_controller():
    api = QuerierAPI(Database())
    from deepflow_tpu_torch.query.engine import QueryError
    for fn, body in ((api.orgs_api, {}), (api.analyzers_api, None),
                     (api.update_agent_config, {"yaml": ""})):
        with pytest.raises(QueryError, match="no controller"):
            fn(body)


# -- the faults the control plane closes ----------------------------------------------


def test_two_jobs_of_two_ranks_on_one_host_get_four_ids():
    """The port keys ranks by the launcher's identity: four ids, and a
    restarted rank gets its own back. The reference's (ctrl_ip,
    hostname) key gives all four one."""
    port, ref = _pair()
    ids = {}
    for job in ("jobA", "jobB"):
        for rank in (0, 1):
            req = wire.SyncRequest(ctrl_ip="10.0.0.1", hostname="gpu-host",
                                   launcher_id=f"{job}/{rank}")
            ids[(job, rank)] = port.Sync(req, None).agent_id
            ref.Sync(pb.SyncRequest.FromString(req.SerializeToString()),
                     None)
    assert sorted(ids.values()) == [1, 2, 3, 4]
    assert [e["agent_id"] for e in ref.registry.list()] == [1]
    again = port.Sync(wire.SyncRequest(ctrl_ip="10.0.0.1",
                                       hostname="gpu-host",
                                       launcher_id="jobB/1"), None)
    assert again.agent_id == ids[("jobB", 1)]
    # a node agent (no launcher) registers as the reference's does
    node = port.Sync(wire.SyncRequest(ctrl_ip="10.0.0.1",
                                      hostname="gpu-host"), None)
    assert node.agent_id == 5
    assert len(port.registry.list()) == 5


@pytest.mark.parametrize("env,want", [
    ({}, ""),
    ({"RANK": "1", "WORLD_SIZE": "2", "TORCHELASTIC_RUN_ID": "r9",
      "MASTER_ADDR": "h", "MASTER_PORT": "1"}, "r9/1"),
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h",
      "MASTER_PORT": "29500"}, "h:29500/0"),
    ({"RANK": "3", "WORLD_SIZE": "4"}, f"ppid{os.getppid()}/3"),
])
def test_launcher_identity(monkeypatch, env, want):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "TORCHELASTIC_RUN_ID",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ranks.launcher_identity() == want


def _stats(n: int, who: str) -> bytes:
    return wire.StatsBatch([wire.StatsMetric(
        name=f"job.{who}", timestamp_ns=time.time_ns() + n,
        values={"n": float(n)})]).SerializeToString()


@pytest.mark.parametrize("controller", [False, True],
                         ids=["rank_plus_one", "controller"])
def test_two_jobs_rank0_agents_lose_no_frame_with_a_controller(
        monkeypatch, controller):
    """Two jobs' rank-0 agents ship 40 frames each into one server.
    Without a controller both are agent 1, and the shared dedup floor
    drops one's frames as the other's duplicates; with one, each has its
    own id and every frame lands."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    server = Server(ingest_port=0, query_port=0, sync_port=0,
                    selfstats_interval_s=3600,
                    enable_controller=controller).start()
    agents = []
    try:
        for job in ("jobA", "jobB"):
            monkeypatch.setenv("TORCHELASTIC_RUN_ID", job)
            cfg = AgentConfig(group=job)
            cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
            cfg.profiler.enabled = cfg.tpuprobe.enabled = False
            cfg.guard.enabled = False
            cfg.selfmon.enabled = False
            cfg.stats_interval_s = 3600
            if controller:
                cfg.controller = f"127.0.0.1:{server.sync_port}"
                cfg.agent_id = 0
            agents.append(Agent(cfg, device=None))
        ids = [a.config.agent_id for a in agents]
        assert ids == ([1, 2] if controller else [1, 1])
        for a in agents:
            a.sender.start()
        for n in range(40):
            for a, who in zip(agents, ("a", "b")):
                a.sender.send(MessageType.DFSTATS, _stats(n, who))
        for a in agents:
            assert a.sender.flush(10.0)
        t = server.db.table("deepflow_system.deepflow_system")
        _wait(lambda: len(t) >= 80, timeout=3)
        names = t.dicts["metric_name"].decode_many(
            t.column_concat(["metric_name"])["metric_name"])
        held = {w: names.count(f"job.{w}") for w in ("a", "b")}
        if controller:
            assert held == {"a": 40, "b": 40}
            assert server.dedup.stats["dups"] == 0
        else:
            assert sum(held.values()) < 80  # the fault
            assert server.dedup.stats["dups"] > 0
    finally:
        for a in agents:
            a.sender.flush_and_stop(1.0)
            if a.synchronizer is not None:
                a.synchronizer.stop()
        server.stop()


def test_rows_carry_host_host_id_and_the_groups_org(server, monkeypatch):
    """Two one-rank jobs in two groups, the second assigned org 2: every
    row carries the host and a nonzero host id, and its group's org;
    DF-SQL under org 2 sees only the second job's rows."""
    server.controller.assign_org("teamB", 2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    agents = []
    for g in ("teamA", "teamB"):
        monkeypatch.setenv("TORCHELASTIC_RUN_ID", g)
        agents.append(make_agent(server, group=g).start())
    try:
        for n, a in enumerate(agents):
            a.sender.send(MessageType.DFSTATS, _stats(n, a.config.group))
            assert a.sender.flush(10.0)
        table = "deepflow_system.deepflow_system"
        assert server.wait_for_rows(table, 2)
        t = server.db.table(table)
        cols = t.column_concat(["agent_id", "host", "host_id", "org_id",
                                "metric_name"])
        names = t.dicts["metric_name"].decode_many(cols["metric_name"])
        rows = {n: (a, t.dicts["host"].decode(int(h)), hid, org)
                for n, a, h, hid, org in zip(
                    names, cols["agent_id"].tolist(), cols["host"],
                    cols["host_id"].tolist(), cols["org_id"].tolist())
                if n.startswith("job.")}
        import socket
        assert rows["job.teamA"][1:] == (socket.gethostname(),
                                         rows["job.teamA"][2], 1)
        assert rows["job.teamB"][3] == 2
        assert rows["job.teamA"][2] >= 1 and rows["job.teamB"][2] >= 1
        assert rows["job.teamA"][2] != rows["job.teamB"][2]
        api = server.api
        sql = ("SELECT metric_name, agent_id FROM deepflow_system "
               "WHERE metric_name LIKE 'job.%'")
        got = api.query({"db": "deepflow_system", "sql": sql, "org_id": 2})
        assert got["result"]["values"] == [["job.teamB",
                                            agents[1].config.agent_id]]
    finally:
        for a in agents:
            a.stop()


def test_two_torchrun_jobs_on_one_host_take_four_ids(server, tmp_path):
    """Two launcher jobs of two ranks each, on one host, under the runner
    with --controller: four controller-assigned ids, one a rank, each
    rank's rows under its own, no frame a duplicate, each job's rows in
    its group's org."""
    server.controller.assign_org("jobB", 2)
    script = tmp_path / "job.py"
    script.write_text("import time\ntime.sleep(1.0)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "TORCHELASTIC_RUN_ID",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "deepflow_tpu_torch.cli.runner",
         "--device", "cpu", "--server", f"127.0.0.1:{server.ingest_port}",
         "--controller", f"127.0.0.1:{server.sync_port}", "--group", group,
         str(script)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for group in ("jobA", "jobB")]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
    reg = server.controller.registry.list()
    assert sorted(e["agent_id"] for e in reg) == [1, 2, 3, 4]
    by_group = {}
    for e in reg:
        job, rank = e["launcher_id"].rsplit("/", 1)
        by_group.setdefault(e["agent_group"], set()).add((job, rank))
    assert sorted(by_group) == ["jobA", "jobB"]
    assert all(len(v) == 2 and len({j for j, _ in v}) == 1
               for v in by_group.values())
    t = server.db.table("deepflow_system.deepflow_system")
    _wait(lambda: set(t.column_concat(["agent_id"])["agent_id"].tolist())
          == {1, 2, 3, 4})
    cols = t.column_concat(["agent_id", "org_id"])
    orgs = {}
    for aid, org in zip(cols["agent_id"].tolist(), cols["org_id"].tolist()):
        orgs.setdefault(aid, set()).add(org)
    group_of = {e["agent_id"]: e["agent_group"] for e in reg}
    assert orgs == {aid: {2 if group_of[aid] == "jobB" else 1}
                    for aid in (1, 2, 3, 4)}
    assert server.dedup.stats["dups"] == 0


def test_node_agent_registers_without_loading_torch():
    """A node agent (no device) on a controller: registered, synced and
    stopped with torch never imported."""
    code = (
        "import sys, time\n"
        "from deepflow_tpu_torch.server.server import Server\n"
        "from deepflow_tpu_torch.agent.agent import Agent\n"
        "from deepflow_tpu_torch.agent.config import AgentConfig\n"
        "srv = Server(ingest_port=0, query_port=0, sync_port=0,\n"
        "             enable_controller=True).start()\n"
        "cfg = AgentConfig(agent_id=0,\n"
        "                  controller=f'127.0.0.1:{srv.sync_port}')\n"
        "cfg.sender.servers = [('127.0.0.1', srv.ingest_port)]\n"
        "cfg.profiler.enabled = cfg.tpuprobe.enabled = False\n"
        "a = Agent(cfg, device=None).start()\n"
        "deadline = time.monotonic() + 10\n"
        "while a.synchronizer.stats['syncs'] < 2 and "
        "time.monotonic() < deadline:\n"
        "    time.sleep(0.05)\n"
        "a.stop(); srv.stop()\n"
        "print(a.config.agent_id, a.synchronizer.stats['syncs'] >= 2,\n"
        "      'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "True", "False"]


def test_registration_is_bounded_by_an_unanswering_controller():
    """A controller that accepts but never answers: the first sync gives
    up within its bound, the agent keeps its own id."""
    import socket as so
    silent = so.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(16)
    try:
        cfg = AgentConfig(
            agent_id=7, controller=f"127.0.0.1:{silent.getsockname()[1]}")
        t0 = time.monotonic()
        agent = Agent(cfg, device=None)
        took = time.monotonic() - t0
        assert not agent.synchronizer.registered
        assert 4.0 < took < 7.0, took
        assert agent.config.agent_id == 7
        agent.synchronizer.stop()
    finally:
        silent.close()
