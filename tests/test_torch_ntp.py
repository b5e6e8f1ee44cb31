"""NTP offsets over the control plane, held against the reference.

Every case of ``tests/test_ntp.py`` on the port: the 4-timestamp offset
math and the min-RTT median smoothing, both packages' ``ntp_sync``
driven by the same clock readings and answers; the Ntp method and the
Sync report end to end over the port's transport; the decoders' shift of
a skewed agent's rows (the port's rows against the reference's on the
same batches); a measured 0 clearing a stored skew and an absent field
keeping it (both controllers, same requests). And one the port had to
get: the offset an agent reports through the port's server's controller
shifts that agent's rows at ingest.
"""

import queue
import socket
import time
from collections import deque

import pytest

from deepflow_tpu.agent import synchronizer as ref_sync
from deepflow_tpu.codec import FrameHeader as RefHeader
from deepflow_tpu.codec import MessageType as RefType
from deepflow_tpu.proto import pb
from deepflow_tpu.server import controller as ref_ctl
from deepflow_tpu.server import decoders as ref_decoders
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch.agent import synchronizer as port_sync
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.agent.sender import UniformSender
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import controller as port_ctl
from deepflow_tpu_torch.server.decoders import FlowLogDecoder, StatsDecoder
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.server.syncwire import SyncClient
from deepflow_tpu_torch.store.db import Database


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    return pred()


class _Clock:
    """time.time_ns for one module: each read takes the next value."""

    def __init__(self, values):
        self.values = list(values)

    def __call__(self):
        return self.values.pop(0)


def _port_syncer(answers):
    s = port_sync.Synchronizer.__new__(port_sync.Synchronizer)
    s._ntp_samples = deque(maxlen=5)
    s.clock_offset_ns = s.ntp_rtt_ns = 0
    s.stats = {"ntp_syncs": 0}

    class Client:
        def call(self, method, req, timeout_s=None):
            assert method == "Ntp"
            t2, t3 = answers.pop(0)
            return wire.NtpResponse(t1_ns=req.t1_ns, t2_ns=t2, t3_ns=t3)
    s._client = Client()
    return s


def _ref_syncer(answers):
    s = ref_sync.Synchronizer.__new__(ref_sync.Synchronizer)
    s._ntp_samples = deque(maxlen=5)
    s.clock_offset_ns = s.ntp_rtt_ns = 0
    s.stats = {}

    class Channel:
        def unary_unary(self, path, request_serializer,
                        response_deserializer):
            def call(req, timeout=None):
                t2, t3 = answers.pop(0)
                return pb.NtpResponse(t1_ns=req.t1_ns, t2_ns=t2, t3_ns=t3)
            return call
    s._channel = Channel()
    return s


def _rounds(offsets, rtt=40):
    """Per round three exchanges, the second with the least RTT and the
    round's offset; (agent clock reads, controller answers)."""
    clock, answers = [], []
    t = 1_000_000
    for off in offsets:
        for k, extra in enumerate((30, 0, 50)):
            t1 = t
            t2 = t1 + off + rtt // 2 + extra
            t3 = t2 + 10
            t4 = t3 - off + rtt // 2 + extra
            if k != 1:  # a noisy exchange: another offset, a longer rtt
                t2 += 1000
            clock += [t1, t4]
            answers.append((t2, t3))
            t = t4 + 100
    return clock, answers


@pytest.mark.parametrize("offsets,want", [
    ([100], 100),
    ([100, 110, 9_000_000, 105, 95], 105),  # one GC-pause outlier
    ([-7_000, -7_200, -6_900], -7_000),
])
def test_ntp_offset_and_smoothing_match_reference(monkeypatch, offsets,
                                                  want):
    """offset = ((t2-t1)+(t3-t4))/2 of each round's minimum-RTT exchange,
    the median of the last five rounds; the same readings through both
    packages' ntp_sync."""
    got = {}
    for name, mod, make in (("port", port_sync, _port_syncer),
                            ("ref", ref_sync, _ref_syncer)):
        clock, answers = _rounds(offsets)
        monkeypatch.setattr(mod.time, "time_ns", _Clock(clock))
        s = make(answers)
        for _ in offsets:
            s.ntp_sync()
        got[name] = (s.clock_offset_ns, s.ntp_rtt_ns, list(s._ntp_samples))
    assert got["port"] == got["ref"]
    assert got["port"][0] == want and got["port"][1] == 40


def test_ntp_rpc_and_sync_report():
    """An agent on the port's transport measures a small offset and a
    positive RTT, and the registry shows clock_offset_ms."""
    server = Server(ingest_port=0, query_port=0, sync_port=0,
                    selfstats_interval_s=3600,
                    enable_controller=True).start()
    agent = None
    try:
        cfg = AgentConfig(controller=f"127.0.0.1:{server.sync_port}",
                          sync_interval_s=3600, agent_id=0)
        cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
        cfg.profiler.enabled = False
        cfg.tpuprobe.enabled = False
        agent = Agent(cfg, device="cpu").start()
        assert _wait(lambda: agent.synchronizer.stats["ntp_syncs"] >= 1)
        # one host, one clock
        assert abs(agent.synchronizer.clock_offset_ns) < 200_000_000
        assert agent.synchronizer.ntp_rtt_ns > 0
        agents = server.controller.registry.list()
        assert agents and agents[0]["clock_offset_ms"] is not None
        assert abs(agents[0]["clock_offset_ms"]) < 200
    finally:
        if agent:
            agent.stop()
        server.stop()


def _flow_batch() -> bytes:
    batch = pb.FlowLogBatch()
    f = batch.l4.add()
    f.flow_id = 1
    f.key.ip_src = bytes([10, 0, 0, 1])
    f.key.ip_dst = bytes([10, 0, 0, 2])
    f.key.proto = 1
    f.start_time_ns = 1_000_000_000_000
    f.end_time_ns = 1_000_500_000_000
    return batch.SerializeToString()


def _stats_batch() -> bytes:
    sb = pb.StatsBatch()
    m = sb.metrics.add()
    m.name = "agent.sender"
    m.timestamp_ns = 2_000_000_000_000
    m.values["sent"] = 1.0
    return sb.SerializeToString()


def test_ingest_normalizes_skewed_agent_as_reference():
    """Agent 7 is 5 s behind: its flow and stats rows move 5 s forward;
    agent 8's 0.4 ms is below the 1 ms noise floor and moves nothing."""
    times = {}
    for name, Db, Plat, Flow, Stats, Hdr, Typ in (
            ("port", Database, PlatformInfoTable, FlowLogDecoder,
             StatsDecoder, FrameHeader, MessageType),
            ("ref", RefDatabase, RefPlatform, ref_decoders.FlowLogDecoder,
             ref_decoders.StatsDecoder, RefHeader, RefType)):
        db, plat = Db(), Plat()
        plat.set_clock_offset(7, 5_000_000_000)
        plat.set_clock_offset(8, 400_000)
        flows = Flow(queue.Queue(), db, plat)
        flows.handle(Hdr(Typ.L4_LOG, agent_id=7), _flow_batch())
        flows.handle(Hdr(Typ.L4_LOG, agent_id=8), _flow_batch())
        Stats(queue.Queue(), db, plat).handle(
            Hdr(Typ.DFSTATS, agent_id=7), _stats_batch())
        times[name] = [
            sorted(int(x) for c in db.table(t).snapshot() if c
                   for x in c["time"])
            for t in ("flow_log.l4_flow_log",
                      "deepflow_system.deepflow_system")]
    assert times["port"] == times["ref"]
    assert times["port"] == [[1_000_500_000_000,
                              1_000_500_000_000 + 5_000_000_000],
                             [2_000_000_000_000 + 5_000_000_000]]


def test_measured_zero_offset_clears_stored_skew():
    """A present clock_offset_ns of 0 overwrites a stored offset, an
    absent one keeps it: both controllers on the same requests."""
    seen = {}
    for name, ctl_mod, table, msgs in (
            ("port", port_ctl, PlatformInfoTable(), wire),
            ("ref", ref_ctl, RefPlatform(), pb)):
        ctl = ctl_mod.Controller(table)
        req = msgs.SyncRequest(hostname="h", ctrl_ip="10.0.0.9",
                               clock_offset_ns=5_000_000_000)
        aid = ctl.Sync(req, None).agent_id
        got = [table.offset_for(aid)]
        req2 = msgs.SyncRequest(hostname="h", ctrl_ip="10.0.0.9",
                                agent_id=aid)
        ctl.Sync(req2, None)
        got.append(table.offset_for(aid))
        got.append(ctl.registry.list()[0]["clock_offset_ms"])
        req2.clock_offset_ns = 0
        ctl.Sync(req2, None)
        got += [table.offset_for(aid),
                ctl.registry.list()[0]["clock_offset_ms"]]
        seen[name] = got
    assert seen["port"] == seen["ref"] == [5_000_000_000, 5_000_000_000,
                                           None, 0, 0.0]


def test_reported_offset_shifts_rows_at_ingest():
    """An agent that reports a 3 s offset to the port server's controller
    has its rows moved 3 s at ingest; another agent's are not."""
    server = Server(ingest_port=0, query_port=0, sync_port=0,
                    selfstats_interval_s=3600,
                    enable_controller=True).start()
    client = SyncClient(f"127.0.0.1:{server.sync_port}")
    senders = []
    try:
        ids = []
        for host, off in (("skewed", 3_000_000_000), ("exact", None)):
            req = wire.SyncRequest(hostname=host, ctrl_ip="127.0.0.1")
            req.platform.hostname = host
            if off is not None:
                req.clock_offset_ns = off
            ids.append(client.call("Sync", req).agent_id)
        assert ids[0] != ids[1]
        for aid in ids:
            s = UniformSender([("127.0.0.1", server.ingest_port)],
                              agent_id=aid).start()
            senders.append(s)
            s.send(MessageType.DFSTATS, _stats_batch())
        for s in senders:
            s.flush(10.0)
        assert server.wait_for_rows("deepflow_system.deepflow_system", 2,
                                    timeout=10)
        t = server.db.table("deepflow_system.deepflow_system")
        cols = t.column_concat(["agent_id", "time", "host"])
        host = t.dicts["host"].decode_many(cols["host"])
        got = sorted(zip(cols["agent_id"].tolist(), cols["time"].tolist(),
                         host))
        assert got == sorted([(ids[0], 2_000_000_000_000 + 3_000_000_000,
                               "skewed"),
                              (ids[1], 2_000_000_000_000, "exact")])
    finally:
        for s in senders:
            s.flush_and_stop()
        client.close()
        server.stop()


def test_synchronizer_sends_no_offset_before_measuring(monkeypatch):
    """Until an exchange has measured it, a Sync carries no offset (a
    restarted agent must not clear the controller's stored skew)."""
    server = Server(ingest_port=0, query_port=0, sync_port=0,
                    selfstats_interval_s=3600,
                    enable_controller=True).start()
    try:
        server.platform.set_clock_offset(1, 7_000_000_000)
        monkeypatch.setattr(port_sync.Synchronizer, "ntp_sync",
                            lambda self, **kw: (_ for _ in ()).throw(
                                OSError("no ntp")))
        cfg = AgentConfig(controller=f"127.0.0.1:{server.sync_port}",
                          agent_id=1)
        cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
        agent = Agent(cfg, device=None)
        assert agent.synchronizer.registered
        assert server.platform.offset_for(1) == 7_000_000_000
        assert server.controller.registry.list()[0]["clock_offset_ms"] \
            is None
        assert socket.gethostname() == \
            server.controller.registry.list()[0]["hostname"]
    finally:
        server.stop()
