"""Universal tags in the port, held against the JAX package on the CPU:
genesis's resource model (pods, services, endpoints, nodes) -> the
``ResourceIndex`` -> each side's tags on every flow and metric row at
ingest, with the socket scans' gpids and process names joined in.

The same seeded cluster (numpy) goes into both packages' indexes through
each package's genesis (``K8sGenesis._apply*``, the watch's entry
points): every address resolves to equal tags. The same FlowLogBatch and
DocumentBatch bytes (the reference's protobuf), the same gpid entries
and the same index give the reference's rows and the port's, on its
native path and on its pure path, equal exactly, enrichment columns
included, with the native path's ``pure_batches`` 0. The reference's own
cases (tests/test_universal_tags.py) run on the port.
"""

import dataclasses
import queue
import socket
import time

import numpy as np
import pytest

import chip_enrich as ce
from deepflow_tpu.codec import FrameHeader as RefHeader
from deepflow_tpu.proto import pb
from deepflow_tpu.server import decoders as ref_decoders
from deepflow_tpu.server import genesis as ref_genesis
from deepflow_tpu.server import platform_info as ref_pi
from deepflow_tpu.server.controller import GpidAllocator as RefGpids
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.server import genesis
from deepflow_tpu_torch.server import platform_info as pi
from deepflow_tpu_torch.server.controller import GpidAllocator
from deepflow_tpu_torch.server.datasource import RollupJob
from deepflow_tpu_torch.server.decoders import FlowLogDecoder, MetricsDecoder
from deepflow_tpu_torch.store.db import Database
from test_torch_retention import _table_rows

SEEDS = (0, 1, 2)
T0 = 1_760_000_000_000_000_000
FLOW_TABLES = ("flow_log.l4_flow_log", "flow_log.l7_flow_log")
DOC_TABLES = ("flow_metrics.network.1s", "flow_metrics.application.1s")
ENRICHED = tuple(f"{n}_{s}" for n in ("gprocess_id", "process_kname")
                 + ce.SIDE_TAGS for s in (0, 1))


# -- a seeded cluster in both packages --------------------------------------

def cluster(seed: int) -> dict[str, list[dict]]:
    """Nodes with pod CIDRs 10.244.<k>.0/24 (one with two), pods on them
    (some owned by ReplicaSets, StatefulSets or Jobs, some with no IP
    yet), services with ClusterIPs (one headless) and endpoints."""
    rng = np.random.default_rng(seed)
    nodes = [ce.k8s_node(f"n{k}", ce.ZONES[k % 3], f"10.0.0.{k + 1}",
                         [f"10.244.{k}.0/24"] + ([f"10.245.{k}.0/24"]
                                                 if k == 0 else []))
             for k in range(4)]
    owners = [("ReplicaSet", "web-6b7f9c"), ("StatefulSet", "db"),
              ("Job", "batch"), ("DaemonSet", "agent"), ()]
    pods = []
    for i in range(40):
        k = int(rng.integers(0, 4))
        ip = "" if i % 13 == 12 else f"10.244.{k}.{i + 2}"
        pods.append(ce.k8s_pod(f"p{i}", f"ns{i % 3}", ip, f"n{k}",
                               owner=owners[int(rng.integers(0, 5))]))
    ips = [p["status"]["podIP"] for p in pods if p["status"]]
    services, endpoints = [], []
    for s in range(8):
        cip = "None" if s == 7 else f"10.96.0.{s + 10}"
        services.append(ce.k8s_service(f"s{s}", f"ns{s % 3}", cip,
                                       ports=(80, 8000 + s)))
        endpoints.append(ce.k8s_endpoints(
            f"s{s}", f"ns{s % 3}",
            list(rng.choice(ips, size=int(rng.integers(0, 5)),
                            replace=False))))
    return {"pods": pods, "services": services, "endpoints": endpoints,
            "nodes": nodes}


def _apply(gen, objs: dict) -> None:
    for kind, fn in (("nodes", gen._apply_node),
                     ("services", gen._apply_service),
                     ("endpoints", gen._apply_endpoints),
                     ("pods", gen._apply)):
        for obj in objs[kind]:
            fn("ADDED", obj)


def indexes(seed: int):
    """(reference ResourceIndex, port ResourceIndex) of one cluster."""
    objs = cluster(seed)
    out = []
    for mod, gmod in ((ref_pi, ref_genesis), (pi, genesis)):
        r = mod.ResourceIndex()
        _apply(gmod.K8sGenesis(r.pod_index, api_base="http://127.0.0.1:1",
                               resources=r), objs)
        out.append(r)
    return out[0], out[1], objs


def addresses(objs: dict, seed: int) -> list[str]:
    """Every pod, ClusterIP and node address, addresses in the CIDRs
    that no object holds, and addresses nothing covers."""
    rng = np.random.default_rng(seed + 100)
    out = [p["status"]["podIP"] for p in objs["pods"] if p["status"]]
    out += [s["spec"]["clusterIP"] for s in objs["services"]]
    out += [n["status"]["addresses"][0]["address"] for n in objs["nodes"]]
    out += [f"10.{int(rng.choice([244, 245]))}.{int(rng.integers(0, 5))}."
            f"{int(rng.integers(100, 250))}" for _ in range(20)]
    out += ["192.168.1.1", "127.0.0.1", "", "::1", "10.96.0.99"]
    return out


def _tags(t) -> dict:
    return dataclasses.asdict(t)


@pytest.mark.parametrize("seed", SEEDS)
def test_resolve_like_reference(seed):
    ref, port, objs = indexes(seed)
    for ip in addresses(objs, seed):
        assert _tags(port.resolve(ip)) == _tags(ref.resolve(ip)), ip
    assert port.summary() == ref.summary()
    assert port.is_empty() == ref.is_empty() is False
    res, rres = port.batch_resolver(), ref.batch_resolver()
    for ip in addresses(objs, seed) * 2:
        assert _tags(res(ip)) == _tags(rres(ip))
    assert sorted(port.pod_index.items_copy(), key=lambda kv: kv[0]) and \
        [(k, dataclasses.asdict(v)) for k, v in sorted(
            port.pod_index.items_copy())] == \
        [(k, dataclasses.asdict(v)) for k, v in sorted(
            ref.pod_index.items_copy())]


# -- the reference's cases, on the port ---------------------------------------

def make_index(mod=pi):
    r = mod.ResourceIndex()
    r.pod_index.upsert("10.244.1.5", mod.PodInfo(
        "web-6b7f9c-abc", "prod", node="node-1", workload="web"))
    r.pod_index.upsert("10.244.2.7", mod.PodInfo(
        "api-0", "prod", node="node-2", workload="api"))
    r.upsert_service(mod.ServiceInfo("web-svc", "prod",
                                     cluster_ip="10.96.0.10", ports=(80,)))
    r.set_endpoints("prod", "web-svc", ["10.244.1.5"])
    r.upsert_node(mod.NodeInfo("node-1", az="us-east1-b",
                               internal_ip="10.0.0.4",
                               pod_cidrs=("10.244.1.0/24",)))
    r.upsert_node(mod.NodeInfo("node-2", az="us-east1-c",
                               internal_ip="10.0.0.5",
                               pod_cidrs=("10.244.2.0/24",)))
    return r


PROBES = ("10.244.1.5", "10.96.0.10", "10.0.0.4", "10.244.2.99",
          "10.244.2.7", "10.96.0.99", "10.0.0.5", "8.8.8.8")


def _same_resolve(port, ref) -> None:
    for ip in PROBES:
        assert _tags(port.resolve(ip)) == _tags(ref.resolve(ip)), ip


def test_resolve_pod_service_node_subnet():
    r = make_index()
    t = r.resolve("10.244.1.5")
    assert t.resource_type == "pod" and t.pod == "web-6b7f9c-abc"
    assert t.workload == "web" and t.service == "web-svc"
    assert t.az == "us-east1-b" and t.subnet == "10.244.1.0/24"
    t = r.resolve("10.96.0.10")
    assert t.resource_type == "service" and t.service == "web-svc"
    assert t.pod_ns == "prod"
    t = r.resolve("10.0.0.4")
    assert t.resource_type == "node" and t.node == "node-1"
    assert t.az == "us-east1-b"
    t = r.resolve("10.244.2.99")
    assert t.resource_type == "" and t.subnet == "10.244.2.0/24"
    assert r.resolve("10.244.2.7").service == ""
    _same_resolve(r, make_index(ref_pi))


def test_endpoints_update_and_service_churn():
    pair = (make_index(), make_index(ref_pi))
    for r, mod in zip(pair, (pi, ref_pi)):
        r.set_endpoints("prod", "web-svc", ["10.244.2.7"])
        assert r.resolve("10.244.1.5").service == ""
        assert r.resolve("10.244.2.7").service == "web-svc"
        r.upsert_service(mod.ServiceInfo("web-svc", "prod",
                                         cluster_ip="10.96.0.99"))
        assert r.resolve("10.96.0.10").resource_type == ""
        assert r.resolve("10.96.0.99").service == "web-svc"
    _same_resolve(*pair)
    for r in pair:
        r.remove_service("prod", "web-svc")
        assert r.resolve("10.96.0.99").resource_type == ""
        assert r.resolve("10.244.2.7").service == ""
    _same_resolve(*pair)


def test_reconciliation_evicts_stale():
    pair = (make_index(), make_index(ref_pi))
    for r in pair:
        r.retain_services(set())
        assert r.resolve("10.96.0.10").resource_type == ""
        r.retain_endpoints(set())
        assert r.resolve("10.244.1.5").service == ""
        r.retain_nodes({"node-2"})
        assert r.resolve("10.0.0.4").resource_type == ""
        assert r.resolve("10.244.1.5").az == ""
        assert r.resolve("10.244.1.5").subnet == ""
        assert r.resolve("10.244.2.99").subnet == "10.244.2.0/24"
    _same_resolve(*pair)
    assert pair[0].summary() == pair[1].summary()


def test_version_bumps_on_mutation():
    vs = []
    for mod in (pi, ref_pi):
        r = mod.ResourceIndex()
        v0 = r.summary()["version"]
        r.upsert_service(mod.ServiceInfo("s", "d", cluster_ip="10.96.0.1"))
        r.upsert_node(mod.NodeInfo("n", internal_ip="10.0.0.1"))
        r.set_endpoints("d", "s", ["10.244.0.1"])
        assert r.summary()["version"] > v0
        vs.append(r.summary()["version"])
    assert vs[0] == vs[1]


def test_genesis_watches_services_endpoints_nodes():
    """Both packages' genesis over one stub apiserver: the list, then a
    watch ADDED service; equal indexes."""
    stub = ce.StubApiServer({
        "pods": [ce.k8s_pod("web-6b7f9c-abc", "prod", "10.244.1.5",
                            "node-1", owner=("ReplicaSet", "web-6b7f9c"))],
        "services": [ce.k8s_service("web-svc", "prod", "10.96.0.10")],
        "endpoints": [ce.k8s_endpoints("web-svc", "prod", ["10.244.1.5"])],
        "nodes": [ce.k8s_node("node-1", "us-east1-b", "10.0.0.4",
                              ["10.244.1.0/24"])]})
    pair = []
    try:
        for mod, gmod in ((pi, genesis), (ref_pi, ref_genesis)):
            r = mod.ResourceIndex()
            g = gmod.K8sGenesis(r.pod_index, api_base=stub.base,
                                watch_timeout_s=5, resources=r).start()
            pair.append((r, g))
        deadline = time.monotonic() + 10
        while stub.requests["watch"] < 8 and time.monotonic() < deadline:
            time.sleep(0.02)  # every loop listed and watches
        stub.push("services", "ADDED",
                  ce.k8s_service("db-svc", "prod", "10.96.0.20"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(
                r.resolve("10.96.0.20").service != "db-svc"
                or r.resolve("10.244.1.5").service != "web-svc"
                or r.resolve("10.0.0.4").node != "node-1"
                for r, _ in pair):
            time.sleep(0.05)
        (r, g), (rr, rg) = pair
        t = r.resolve("10.244.1.5")
        assert t.pod == "web-6b7f9c-abc" and t.workload == "web"
        assert t.service == "web-svc" and t.az == "us-east1-b"
        assert t.subnet == "10.244.1.0/24"
        assert r.resolve("10.96.0.10").service == "web-svc"
        assert r.resolve("10.0.0.4").node == "node-1"
        assert r.resolve("10.96.0.20").service == "db-svc"
        assert g.stats["services"] == 1 and g.stats["nodes"] == 1
        _same_resolve(r, rr)
        for ip in ("10.96.0.20",):
            assert _tags(r.resolve(ip)) == _tags(rr.resolve(ip))
        assert r.summary()["services"] == rr.summary()["services"] == 2
        assert {k: g.stats[k] for k in ("pods", "services", "endpoints",
                                        "nodes", "relists", "errors")} == \
            {k: rg.stats[k] for k in ("pods", "services", "endpoints",
                                      "nodes", "relists", "errors")}
    finally:
        stub.close_watches()
        for _, g in pair:
            g.stop()
        stub.stop()


def test_universal_tags_genesis_to_query():
    """A flow between two pods, through the port's dispatcher, sender
    and server, carries both sides' pod, service and zone tags."""
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.agent.packet import TcpFlags, build_tcp
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.server.server import Server

    server = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    r = server.resources
    r.pod_index.upsert("10.244.1.5", pi.PodInfo(
        "web-abc", "prod", node="node-1", workload="web"))
    r.pod_index.upsert("10.244.2.7", pi.PodInfo(
        "api-xyz", "prod", node="node-2", workload="api"))
    r.upsert_service(pi.ServiceInfo("api-svc", "prod",
                                    cluster_ip="10.96.0.30"))
    r.set_endpoints("prod", "api-svc", ["10.244.2.7"])
    r.upsert_node(pi.NodeInfo("node-1", az="us-east1-b",
                              pod_cidrs=("10.244.1.0/24",)))
    r.upsert_node(pi.NodeInfo("node-2", az="us-east1-c",
                              pod_cidrs=("10.244.2.0/24",)))
    sender = UniformSender(
        servers=[("127.0.0.1", server.ingest_port)]).start()
    disp = Dispatcher(sender=sender, engine="python")
    try:
        disp.inject(build_tcp("10.244.1.5", "10.244.2.7", 40000, 80,
                              TcpFlags.SYN, timestamp_ns=time.time_ns()))
        disp.flush(force=True)
        assert server.wait_for_rows("flow_log.l4_flow_log", 1, timeout=10)
        res = engine.execute(server.db.table("flow_log.l4_flow_log"),
                             "SELECT pod_0, workload_0, az_0, subnet_0, "
                             "pod_1, service_1, az_1 FROM t")
        row = dict(zip(res.columns, res.values[0]))
        assert row == {"pod_0": "web-abc", "workload_0": "web",
                       "az_0": "us-east1-b", "subnet_0": "10.244.1.0/24",
                       "pod_1": "api-xyz", "service_1": "api-svc",
                       "az_1": "us-east1-c"}
    finally:
        sender.flush_and_stop()
        server.stop()


def _l4_to(dst: bytes) -> bytes:
    batch = pb.FlowLogBatch()
    f = batch.l4.add(flow_id=9)
    f.key.ip_src = bytes([10, 244, 1, 5])
    f.key.ip_dst = dst
    f.key.port_src, f.key.port_dst, f.key.proto = 41000, 80, 1
    f.start_time_ns = f.end_time_ns = T0
    return batch.SerializeToString()


def test_cluster_ip_flow_tagged_with_service():
    db = Database()
    dec = FlowLogDecoder(queue.Queue(), db, pi.PlatformInfoTable(),
                         resources=make_index())
    dec.handle(FrameHeader(MessageType.L4_LOG, agent_id=1),
               _l4_to(bytes([10, 96, 0, 10])))
    res = engine.execute(db.table("flow_log.l4_flow_log"),
                         "SELECT service_1, pod_ns_1, pod_1 FROM t")
    assert dict(zip(res.columns, res.values[0])) == {
        "service_1": "web-svc", "pod_ns_1": "prod", "pod_1": ""}
    assert dec.stats["pure_batches"] == 0


def test_metrics_rows_carry_side_tags_through_rollup():
    db = Database()
    now_s = 1_700_000_000
    batch = pb.DocumentBatch()
    for i in range(2):
        d = batch.docs.add(timestamp_s=now_s + i)
        d.tag.ip_src = bytes([10, 244, 1, 5])
        d.tag.ip_dst = bytes([10, 244, 2, 7])
        d.tag.port, d.tag.proto = 80, 1
        d.flow_meter.byte_tx, d.flow_meter.packet_tx = 100, 1
    dec = MetricsDecoder(queue.Queue(), db, pi.PlatformInfoTable(),
                         resources=make_index())
    dec.handle(FrameHeader(MessageType.METRICS, agent_id=1),
               batch.SerializeToString())
    res = engine.execute(db.table("flow_metrics.network.1s"),
                         "SELECT pod_0, service_0, az_1 FROM t")
    assert dict(zip(res.columns, res.values[0])) == {
        "pod_0": "web-6b7f9c-abc", "service_0": "web-svc",
        "az_1": "us-east1-c"}
    RollupJob(db, lateness_s=0).roll(now_s + 120)
    res = engine.execute(db.table("flow_metrics.network.1m"),
                         "SELECT pod_0, az_1, byte_tx FROM t")
    assert dict(zip(res.columns, res.values[0])) == {
        "pod_0": "web-6b7f9c-abc", "az_1": "us-east1-c", "byte_tx": 200}


def test_endpoints_without_subsets_clears_mapping():
    for mod, gmod in ((pi, genesis), (ref_pi, ref_genesis)):
        resources = make_index(mod)
        gen = gmod.K8sGenesis(resources.pod_index,
                              api_base="http://127.0.0.1:1",
                              watch_timeout_s=1, resources=resources)
        assert resources.resolve("10.244.1.5").service == "web-svc"
        gen._apply_endpoints("MODIFIED", {
            "metadata": {"name": "web-svc", "namespace": "prod"}})
        assert resources.resolve("10.244.1.5").service == ""
        # a pod object on the endpoints path is ignored
        assert gen._apply_endpoints(
            "MODIFIED", ce.k8s_pod("x", "prod", "10.244.9.9", "n")) == set()


# -- rows of both packages, the enrichment included ---------------------------

def _ipb(ip: str) -> bytes:
    return socket.inet_aton(ip) if ip else b""


def flows_and_entries(objs: dict, seed: int):
    """(FlowLogBatch bytes, DocumentBatch bytes, GpidSyncRequest bytes):
    flows between the cluster's addresses and others, some with the
    agent's gpid, pod or kernel thread name set; gpid entries for some
    of their endpoints (listeners and clients)."""
    rng = np.random.default_rng(seed + 7)
    pool = [a for a in addresses(objs, seed)
            if a and ":" not in a and a != "None"]

    def pick():
        return pool[int(rng.integers(0, len(pool)))]
    batch, docs = pb.FlowLogBatch(), pb.DocumentBatch()
    ends = []
    for i in range(120):
        key = pb.FlowKey(ip_src=_ipb(pick()), ip_dst=_ipb(pick()),
                         port_src=int(rng.integers(30000, 30020)),
                         port_dst=int(rng.choice([80, 443, 8080])),
                         proto=int(rng.choice([1, 1, 2])))
        ends += [(key.ip_src, key.port_src, key.proto),
                 (key.ip_dst, key.port_dst, key.proto)]
        if i % 2:
            f = batch.l4.add(flow_id=i, start_time_ns=T0 + i,
                             end_time_ns=T0 + i + 5)
        else:
            f = batch.l7.add(flow_id=i, start_time_ns=T0 + i,
                             end_time_ns=T0 + i + 5, l7_protocol=1,
                             request_type="GET", endpoint="/x")
            if rng.random() < 0.2:
                f.process_kname_0 = "sslthread"
        f.key.CopyFrom(key)
        if rng.random() < 0.15:
            f.gpid_0 = int(rng.integers(1000, 2000))
        if rng.random() < 0.15:
            f.pod_1 = "agent-pod"
        d = docs.docs.add(timestamp_s=T0 // 10**9 + i % 3)
        d.tag.ip_src, d.tag.ip_dst = key.ip_src, key.ip_dst
        d.tag.port, d.tag.proto = key.port_dst, key.proto
        if i % 3:
            d.flow_meter.byte_tx = i
        else:
            d.app_meter.request = i
    req = pb.GpidSyncRequest(agent_id=5)
    for j, k in enumerate(sorted(set(ends))):
        if rng.random() < 0.6:
            req.entries.add(pid=100 + j % 9, ip=k[0], port=k[1],
                            proto=k[2], role=int(k[1] < 30000),
                            process_name=f"proc{j % 9}")
    return (batch.SerializeToString(), docs.SerializeToString(),
            req.SerializeToString())


def _both(seed: int):
    ref_idx, port_idx, objs = indexes(seed)
    flows, docs, req = flows_and_entries(objs, seed)
    rg, pg = RefGpids(), GpidAllocator()
    rg.sync(pb.GpidSyncRequest.FromString(req))
    pg.sync(wire.GpidSyncRequest.FromString(req))
    return ref_idx, port_idx, rg, pg, flows, docs


def _port_decoder(cls, mtype, idx, gpids):
    return cls(queue.Queue(), Database(), pi.PlatformInfoTable(),
               msg_type=mtype, resources=idx, pod_index=idx.pod_index,
               gpid_table=gpids)


def _ref_decoder(cls, idx, gpids):
    return cls(queue.Queue(), RefDatabase(), ref_pi.PlatformInfoTable(),
               resources=idx, pod_index=idx.pod_index, gpid_table=gpids)


@pytest.mark.parametrize("path", ["native", "pure"])
@pytest.mark.parametrize("seed", SEEDS)
def test_flow_rows_equal_reference_with_enrichment(seed, path):
    ref_idx, port_idx, rg, pg, flows, _ = _both(seed)
    header = FrameHeader(MessageType.L4_LOG, agent_id=5)
    dec = _port_decoder(FlowLogDecoder, MessageType.L4_LOG, port_idx, pg)
    (dec.handle if path == "native" else dec.handle_pure)(header, flows)
    if path == "native":
        assert (dec.stats["native_batches"], dec.stats["pure_batches"]) \
            == (1, 0)
    ref = _ref_decoder(ref_decoders.FlowLogDecoder, ref_idx, rg)
    ref._handle_pb(pb.FlowLogBatch.FromString(flows),
                   RefHeader(MessageType.L4_LOG, agent_id=5))
    for name in FLOW_TABLES:
        got, want = dec.db.table(name), ref.db.table(name)
        assert _table_rows(got) == _table_rows(want), name
        cols = got.column_concat(list(ENRICHED))
        tagged = {c for c in ENRICHED
                  if (got.dicts[c].decode_many(cols[c]) if c in got.dicts
                      else cols[c].tolist()) != [0] * len(got)
                  and any(got.dicts[c].decode_many(cols[c])
                          if c in got.dicts else cols[c].tolist())}
        # every enrichment column carries something in this traffic
        assert tagged == set(ENRICHED), set(ENRICHED) - tagged


@pytest.mark.parametrize("path", ["native", "pure"])
@pytest.mark.parametrize("seed", SEEDS)
def test_doc_rows_equal_reference_with_enrichment(seed, path):
    ref_idx, port_idx, rg, pg, _, docs = _both(seed)
    header = FrameHeader(MessageType.METRICS, agent_id=5)
    dec = _port_decoder(MetricsDecoder, MessageType.METRICS, port_idx, pg)
    (dec.handle if path == "native" else dec.handle_pure)(header, docs)
    ref = _ref_decoder(ref_decoders.MetricsDecoder, ref_idx, rg)
    ref.handle(RefHeader(MessageType.METRICS, agent_id=5), docs)
    for name in DOC_TABLES:
        assert _table_rows(dec.db.table(name)) == \
            _table_rows(ref.db.table(name)), name
        assert len(dec.db.table(name)) > 0


@pytest.mark.parametrize("which", ["none", "empty_index", "pod_index_only",
                                   "gpids_only"])
def test_partial_sources_fill_like_reference(which):
    """Each rung of the ladder alone: no source, an empty index (the
    agent's pods kept, the other tags "" broadcast), a pod index with no
    ResourceIndex, gpids with no index."""
    ref_idx, port_idx, rg, pg, flows, docs = _both(0)
    kw = {"none": ({}, {}),
          "empty_index": ({"resources": ref_pi.ResourceIndex()},
                          {"resources": pi.ResourceIndex()}),
          "pod_index_only": ({"pod_index": ref_idx.pod_index},
                             {"pod_index": port_idx.pod_index}),
          "gpids_only": ({"gpid_table": rg}, {"gpid_table": pg})}[which]
    for ref_cls, cls, mtype, payload, tables in (
            (ref_decoders.FlowLogDecoder, FlowLogDecoder,
             MessageType.L4_LOG, flows, FLOW_TABLES),
            (ref_decoders.MetricsDecoder, MetricsDecoder,
             MessageType.METRICS, docs, DOC_TABLES)):
        ref = ref_cls(queue.Queue(), RefDatabase(),
                      ref_pi.PlatformInfoTable(), **kw[0])
        header = RefHeader(mtype, agent_id=5)
        if ref_cls is ref_decoders.FlowLogDecoder:
            ref._handle_pb(pb.FlowLogBatch.FromString(payload), header)
        else:
            ref.handle(header, payload)
        for pure in (False, True):
            dec = cls(queue.Queue(), Database(), pi.PlatformInfoTable(),
                      msg_type=mtype, **kw[1])
            h = FrameHeader(mtype, agent_id=5)
            (dec.handle_pure if pure else dec.handle)(h, payload)
            for name in tables:
                assert _table_rows(dec.db.table(name)) == \
                    _table_rows(ref.db.table(name)), (name, pure)


def test_both_servers_enrich_the_same_frames_alike():
    """The reference's server and the port's, each given the same index
    and gpid entries, take the same frames over TCP: their flow and
    metric rows are equal, enrichment columns included, and the port's
    batches all decode natively."""
    from deepflow_tpu.codec import encode_frame as ref_encode
    from deepflow_tpu.server import Server as RefServer
    from deepflow_tpu_torch.server.server import Server
    ref_idx, port_idx, rg, pg, flows, docs = _both(1)
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0).start()
    port = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    try:
        for srv, idx, gpids in ((ref, ref_idx, rg), (port, port_idx, pg)):
            for d in srv.decoders:
                d.resources, d.pod_index = idx, idx.pod_index
                d.gpid_table = gpids
            data = b"".join(ref_encode(RefHeader(mt, agent_id=5), p)
                            for mt, p in ((MessageType.L4_LOG, flows),
                                          (MessageType.METRICS, docs)))
            with socket.create_connection(("127.0.0.1",
                                           srv.ingest_port)) as c:
                c.sendall(data)
        for name in FLOW_TABLES + DOC_TABLES:
            n = len(ref.db.table(name)) if ref.wait_for_rows(name, 1) \
                else 0
            assert n > 0 and port.wait_for_rows(name, n), name
            time.sleep(0.2)
            assert _table_rows(port.db.table(name)) == \
                _table_rows(ref.db.table(name)), name
        stats = {d.MSG_TYPE.name: d.stats for d in port.decoders}
        assert stats["L4_LOG"]["native_batches"] == 1
        assert stats["METRICS"]["native_batches"] == 1
        assert stats["L4_LOG"]["pure_batches"] == \
            stats["METRICS"]["pure_batches"] == 0
    finally:
        ref.stop()
        port.stop()
