"""The agent's labeler and the controller's PodMap in the port, held
against the JAX package on the CPU.

The same resources and ACLs (from a numpy seed) give both packages'
labelers the same verdicts, fast path and first path alike; both
controllers answer the same PodMap requests with the same entries; and
through the dispatcher (both engines) the labels land on the L4 and L7
logs while an ignored flow leaves no log and no document. The reference's
cases (tests/test_labeler.py) run on the port, the PodMap over the
port's sync transport.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest

from deepflow_tpu.agent import labeler as ref_labeler
from deepflow_tpu.proto import pb
from deepflow_tpu.server.controller import Controller as RefController
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefTable
from deepflow_tpu.server.platform_info import PodInfo as RefPod
from deepflow_tpu.server.platform_info import PodIpIndex as RefPods
from deepflow_tpu_torch.agent import labeler
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.agent.dispatcher import Dispatcher
from deepflow_tpu_torch.agent.packet import TcpFlags, build_tcp
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.controller import Controller
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable, \
    PodInfo, PodIpIndex
from deepflow_tpu_torch.server.syncwire import SyncClient

from test_torch_packet_actions import pcap_of, seeded_frames


def ip(s):
    return socket.inet_aton(s)


def seeded_rules(seed: int):
    """(resources, ACLs) from a seed: /32 pods, /24 and /16 networks, and
    rules over CIDRs, ports and protocols with every action."""
    rng = np.random.default_rng(seed)
    res = [(f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 4))}.0/24",
            dict(pod="", namespace=f"net{k}")) for k in range(4)]
    res += [(f"10.{int(rng.integers(0, 3))}.0.0/16", dict(workload="wide"))]
    res += [(f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 4))}."
             f"{int(rng.integers(1, 9))}/32",
             dict(pod=f"pod-{k}", namespace="ns", workload=f"w{k % 3}",
                  node=f"n{k % 2}")) for k in range(12)]
    res += [("2001:db8::7/128", dict(pod="v6pod"))]
    acls = []
    for k in range(6):
        rule = {"action": ("ignore", "pcap", "npb", "trace")[k % 4]}
        if rng.random() < 0.5:
            rule["cidr"] = f"10.{int(rng.integers(0, 3))}.{k}.0/24"
        if rng.random() < 0.5:
            rule["port"] = int(rng.choice([22, 80, 443, 8080]))
        if rng.random() < 0.3:
            rule["protocol"] = int(rng.integers(1, 4))
        acls.append(rule)
    return res, acls


def _labelers(seed: int):
    res, acls = seeded_rules(seed)
    out = []
    for mod in (labeler, ref_labeler):
        lab = mod.Labeler()
        lab.load_resources([(c, mod.ResourceLabel(**kw)) for c, kw in res],
                           version=3)
        lab.load_acls([mod.AclRule(**a) for a in acls])
        out.append(lab)
    return out


def _verdict(v):
    src, dst, action = v
    return (src and dataclasses.asdict(src), dst and dataclasses.asdict(dst),
            action)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_labels_like_reference(seed):
    port, ref = _labelers(seed)
    rng = np.random.default_rng(seed + 9)
    tuples = [(ip(f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 5))}."
                  f"{int(rng.integers(1, 9))}"),
               ip(f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 5))}."
                  f"{int(rng.integers(1, 9))}"),
               int(rng.choice([22, 80, 5000])),
               int(rng.choice([443, 8080, 22, 9000])),
               int(rng.integers(1, 4))) for _ in range(200)]
    tuples += [(socket.inet_pton(socket.AF_INET6, "2001:db8::7"),
                socket.inet_pton(socket.AF_INET6, "2001:db8::8"), 1, 2, 1)]
    for t in tuples + tuples[:50]:   # the repeats take the fast path
        assert _verdict(port.label_flow(*t)) == _verdict(ref.label_flow(*t))
    assert port.stats == ref.stats
    assert port.stats["fast_path"] >= 50


def test_trie_longest_prefix_match():
    t = labeler.IpTrie()
    t.insert("10.0.0.0/8", "net")
    t.insert("10.244.0.0/16", "cluster")
    t.insert("10.244.1.5/32", "pod-a")
    assert t.lookup(ip("10.244.1.5")) == "pod-a"
    assert t.lookup(ip("10.244.9.9")) == "cluster"
    assert t.lookup(ip("10.9.9.9")) == "net"
    assert t.lookup(ip("192.168.0.1")) is None
    t.insert("2001:db8::1/128", "v6pod")
    assert t.lookup(socket.inet_pton(socket.AF_INET6, "2001:db8::1")) == \
        "v6pod"
    assert t.lookup(b"\x01\x02") is None


def test_labeler_fast_path_lru():
    lab = labeler.Labeler()
    lab.load_resources([("10.244.1.5/32", labeler.ResourceLabel(pod="web"))],
                       version=1)
    for _ in range(3):
        src, dst, action = lab.label_flow(
            ip("10.244.1.5"), ip("10.244.1.9"), 1000, 80, 1)
    assert src.pod == "web" and dst is None and action == "trace"
    assert lab.stats["first_path"] == 1 and lab.stats["fast_path"] == 2
    lab.load_resources([("10.244.1.9/32", labeler.ResourceLabel(pod="api"))],
                       version=2)
    src, dst, _ = lab.label_flow(ip("10.244.1.5"), ip("10.244.1.9"), 1000,
                                 80, 1)
    assert src is None and dst.pod == "api"
    assert lab.stats["first_path"] == 2


def test_acl_rules_match_and_order():
    lab = labeler.Labeler()
    lab.load_acls([labeler.AclRule(cidr="10.99.0.0/16", action="ignore"),
                   labeler.AclRule(port=22, action="ignore"),
                   labeler.AclRule(cidr="10.0.0/33", action="pcap")])
    assert len(lab._acls) == 2   # the bad CIDR is dropped, not raised
    assert lab.label_flow(ip("10.99.1.1"), ip("1.1.1.1"), 5, 80, 1)[2] == \
        "ignore"
    assert lab.label_flow(ip("1.1.1.1"), ip("2.2.2.2"), 5000, 22, 1)[2] == \
        "ignore"
    assert lab.label_flow(ip("1.1.1.1"), ip("2.2.2.2"), 5000, 80, 1)[2] == \
        "trace"


class _Frames:
    def __init__(self) -> None:
        self.sent: list[tuple] = []

    def send(self, mt, payload) -> bool:
        self.sent.append((mt, payload))
        return True

    def of(self, mt, cls, field):
        out = []
        for t, payload in self.sent:
            if t == mt:
                out.extend(getattr(cls.FromString(payload), field))
        return out


@pytest.mark.parametrize("engine", ["python", "native"])
def test_dispatcher_labels_and_acl_suppression(engine):
    lab = labeler.Labeler()
    lab.load_resources([
        ("10.244.1.5/32", labeler.ResourceLabel(pod="web-abc")),
        ("10.244.1.9/32", labeler.ResourceLabel(pod="api-xyz"))], version=1)
    lab.load_acls([labeler.AclRule(cidr="10.66.0.0/16", action="ignore")])
    sink = _Frames()
    disp = Dispatcher(sender=sink, engine=engine, labeler=lab)
    frames = [build_tcp("10.244.1.5", "10.244.1.9", 40000, 80, TcpFlags.SYN,
                        timestamp_ns=time.time_ns()),
              build_tcp("10.66.0.2", "1.1.1.1", 40001, 80, TcpFlags.SYN,
                        timestamp_ns=time.time_ns())]
    if engine == "python":
        for mp in frames:
            disp.inject(mp)
    else:
        from test_torch_packet_actions import frame_of
        disp.inject_frames([(frame_of(mp), mp.timestamp_ns)
                            for mp in frames])
    disp.flush(force=True)
    l4 = sink.of(MessageType.L4_LOG, wire.FlowLogBatch, "l4")
    assert len(l4) == 1
    assert (l4[0].pod_0, l4[0].pod_1) == ("web-abc", "api-xyz")
    assert lab.stats["ignored_flows"] == 1
    docs = sink.of(MessageType.METRICS, wire.DocumentBatch, "docs")
    assert docs and all(bytes(d.tag.ip_src) != ip("10.66.0.2")
                        and bytes(d.tag.ip_dst) != ip("10.66.0.2")
                        for d in docs)


def test_acl_ignore_suppresses_metrics_too():
    lab = labeler.Labeler()
    lab.load_acls([labeler.AclRule(cidr="10.66.0.0/16", action="ignore")])
    sink = _Frames()
    disp = Dispatcher(sender=sink, engine="python", labeler=lab)
    disp.inject(build_tcp("10.66.0.2", "1.1.1.1", 40001, 80, TcpFlags.SYN,
                          timestamp_ns=time.time_ns()))
    disp.flush(force=True)
    assert not sink.of(MessageType.METRICS, wire.DocumentBatch, "docs")
    assert not sink.of(MessageType.L4_LOG, wire.FlowLogBatch, "l4")


def test_replayed_labels_and_ignores_like_reference(tmp_path):
    """The same pcap through both packages' dispatchers with the same
    labeler feed: the same L4 and L7 logs, pods and suppressions."""
    from deepflow_tpu.agent.dispatcher import Dispatcher as RefDispatcher
    path = str(tmp_path / "in.pcap")
    frames = seeded_frames(4)
    pcap_of(path, [f for f, _ in frames])
    res = [("10.50.0.0/16", dict(pod="fifty")), ("10.60.0.1/32",
                                                 dict(pod="sixty-1"))]
    acls = [{"cidr": "10.70.0.0/16", "action": "ignore"}]
    out = []
    for mod, disp_cls, codec in ((labeler, Dispatcher, wire),
                                 (ref_labeler, RefDispatcher, pb)):
        lab = mod.Labeler()
        lab.load_resources([(c, mod.ResourceLabel(**kw)) for c, kw in res])
        lab.load_acls([mod.AclRule(**a) for a in acls])
        sink = _Frames()
        disp = disp_cls(sender=sink, engine="native", labeler=lab)
        disp.replay_pcap(path)
        l4 = sink.of(MessageType.L4_LOG, codec.FlowLogBatch, "l4")
        l7 = sink.of(MessageType.L7_LOG, codec.FlowLogBatch, "l7")
        out.append((sorted((bytes(f.key.ip_src), f.key.port_src, f.pod_0,
                            f.pod_1, f.packet_tx, f.packet_rx) for f in l4),
                    sorted((bytes(f.key.ip_src), f.pod_0, f.pod_1,
                            f.request_resource) for f in l7),
                    lab.stats["ignored_flows"]))
    assert out[0] == out[1]
    assert out[0][2] > 0 and any(r[2] == "fifty" for r in out[0][0])


# -- the PodMap ----------------------------------------------------------------

def _pods(mod_pods, mod_info):
    idx = mod_pods()
    idx.upsert("10.244.1.5", mod_info("web-abc", "prod", workload="web",
                                      node="n1"))
    idx.upsert("10.244.1.6", mod_info("db-0", "prod", workload="db"))
    return idx


def test_pod_map_answers_like_reference():
    port = Controller(PlatformInfoTable(), port=0,
                      pod_index=_pods(PodIpIndex, PodInfo))
    ref = RefController(RefTable(), port=0,
                        pod_index=_pods(RefPods, RefPod))
    port.configs.epoch = ref.configs.epoch
    empty = Controller(PlatformInfoTable(), port=0)
    assert empty.PodMap(wire.PodMapRequest(), None).entries == []
    first = None
    for version, epoch in ((0, 0), (2, ref.configs.epoch), (2, 1),
                           (1, ref.configs.epoch)):
        data = pb.PodMapRequest(version=version,
                                epoch=epoch).SerializeToString()
        a = port.PodMap(wire.PodMapRequest.FromString(data), None)
        b = ref.PodMap(pb.PodMapRequest.FromString(data), None)
        assert a.SerializeToString() == b.SerializeToString()
        first = first or a
    assert [e.cidr for e in first.entries] == ["10.244.1.5/32",
                                               "10.244.1.6/32"]


def test_pod_map_feed_over_the_sync_transport():
    """Entries only when stale; an unknown epoch ships them again."""
    idx = _pods(PodIpIndex, PodInfo)
    ctrl = Controller(PlatformInfoTable(), host="127.0.0.1", port=0,
                      pod_index=idx).start()
    client = SyncClient(f"127.0.0.1:{ctrl.port}")
    try:
        resp = client.call("PodMap", wire.PodMapRequest(version=0))
        assert len(resp.entries) == 2
        e = resp.entries[0]
        assert (e.cidr, e.pod, e.namespace, e.workload, e.node) == (
            "10.244.1.5/32", "web-abc", "prod", "web", "n1")
        resp2 = client.call("PodMap", wire.PodMapRequest(
            version=resp.version, epoch=resp.epoch))
        assert resp2.entries == [] and resp2.version == resp.version
        resp3 = client.call("PodMap", wire.PodMapRequest(
            version=resp.version, epoch=1))
        assert len(resp3.entries) == 2
    finally:
        client.close()
        ctrl.stop()


def test_synchronizer_feeds_the_labeler():
    """A controller-attached agent takes the PodMap once, then only
    versions; a pod gone from the cluster leaves the labels."""
    idx = _pods(PodIpIndex, PodInfo)
    ctrl = Controller(PlatformInfoTable(), host="127.0.0.1", port=0,
                      pod_index=idx).start()
    cfg = AgentConfig(controller=f"127.0.0.1:{ctrl.port}")
    cfg.profiler.enabled = cfg.tpuprobe.enabled = cfg.guard.enabled = False
    cfg.socket_scan_interval_s = 0
    cfg.sync_interval_s = 0.1
    agent = Agent(cfg, device=None).start()
    try:
        sync = agent.synchronizer
        deadline = time.monotonic() + 5
        while sync.stats["syncs"] < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sync.stats["podmap_updates"] == 1
        assert sync.stats["podmap_entries"] == 2   # once, not each sync
        src, _, _ = agent.labeler.label_flow(ip("10.244.1.5"),
                                             ip("8.8.8.8"), 1, 2, 1)
        assert src.pod == "web-abc" and src.node == "n1"
        idx.remove_ip("10.244.1.5")
        idx.remove_ip("10.244.1.6")
        deadline = time.monotonic() + 5
        while sync.stats["podmap_updates"] < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        src, _, _ = agent.labeler.label_flow(ip("10.244.1.5"),
                                             ip("8.8.8.8"), 1, 2, 1)
        assert src is None and agent.labeler.version == idx.version
    finally:
        agent.stop()
        ctrl.stop()


def test_empty_newer_pod_map_applies():
    lab = labeler.Labeler()
    lab.load_resources([("10.1.1.1/32", labeler.ResourceLabel(pod="dead"))],
                       version=5)
    assert lab.update_pod_map(wire.PodMapResponse(version=6)) is True
    assert lab.label_flow(ip("10.1.1.1"), ip("2.2.2.2"), 1, 2, 1)[0] is None
    assert lab.version == 6
    assert lab.update_pod_map(wire.PodMapResponse(version=6)) is False


def test_acl_config_validation():
    cfg = AgentConfig()
    cfg.acls = [{"cidr": "10.0.0/33", "action": "ignore"}]
    with pytest.raises(ValueError):
        cfg.validate()
    cfg.acls = [{"action": "reject"}]
    with pytest.raises(ValueError):
        cfg.validate()
    cfg.acls = [{"cidr": "10.0.0.0/8", "port": 22, "action": "ignore"}]
    cfg.validate()
    assert (cfg.npb_target, cfg.npb_vni, cfg.socket_scan_interval_s) == \
        ("", 1, 30.0)


def test_agent_builds_its_labeler_from_the_acls():
    cfg = AgentConfig(acls=[{"port": 22, "action": "ignore"}])
    cfg.profiler.enabled = cfg.tpuprobe.enabled = cfg.guard.enabled = False
    agent = Agent(cfg, device=None)
    assert [(r.port, r.action) for r in agent.labeler._acls] == \
        [(22, "ignore")]
    assert agent.dispatcher is None  # no packet ACL: no dispatcher
