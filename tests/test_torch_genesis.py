"""K8s genesis and the resource recorder in the port, held against the JAX
package on the CPU.

Both packages' ``K8sGenesis`` list and watch one stub apiserver
(``chip_enrich.StubApiServer``: pages, ``resourceVersion``, a JSON line
an event) holding a seeded cluster, then take the same watch events and
a relist after a gap: their indexes resolve every address alike and
their recorders emit the same events apart from ``time``. The
reference's recorder cases (tests/test_recorder.py) and genesis cases
(tests/test_fleet_scale.py:164-258) run on the port, and the port's
server runs genesis into ``event.event`` and ``/v1/health``.
"""

import dataclasses
import json
import os
import socket
import time

import numpy as np
import pytest

import chip_enrich as ce
from deepflow_tpu.server import genesis as ref_genesis
from deepflow_tpu.server import platform_info as ref_pi
from deepflow_tpu.server import recorder as ref_recorder
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.server import election, genesis
from deepflow_tpu_torch.server import platform_info as pi
from deepflow_tpu_torch.server import recorder
from test_torch_universal_tags import addresses, cluster

PACKAGES = ((pi, genesis), (ref_pi, ref_genesis))


def _wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _start_both(stub, with_resources: bool = True):
    """[(index, genesis, event rows)] of the port's and the reference's
    genesis on the stub, once every loop listed and watches."""
    out = []
    for mod, gmod in PACKAGES:
        r = mod.ResourceIndex()
        rows: list[dict] = []
        g = gmod.K8sGenesis(r.pod_index, api_base=stub.base,
                            watch_timeout_s=30, event_sink=rows.extend,
                            resources=r if with_resources else None).start()
        out.append((r, g, rows))
    loops = 2 * (4 if with_resources else 1)
    assert _wait(lambda: stub.requests["watch"] >= loops)
    return out


def _stop_both(stub, pair) -> None:
    stub.close_watches()
    for _, g, _ in pair:
        g.stop()
    stub.stop()


def _events(rows: list[dict]) -> list[tuple]:
    """Recorder rows without their time, in a fixed order (the loops of
    the four kinds run concurrently)."""
    return sorted((r["event_type"], r["resource_type"], r["resource_name"],
                   r["description"], r["attrs"]) for r in rows)


def _same_index(pair, objs, seed) -> None:
    (r, _, _), (rr, _, _) = pair
    for ip in addresses(objs, seed) + ["10.244.3.200", "10.250.0.1"]:
        assert dataclasses.asdict(r.resolve(ip)) == \
            dataclasses.asdict(rr.resolve(ip)), ip
    assert r.summary()["pods"] == rr.summary()["pods"]
    for k in ("services", "endpoints", "nodes", "subnets"):
        assert r.summary()[k] == rr.summary()[k], k


def _watch_events(objs: dict, seed: int) -> list[tuple]:
    """(kind, type, object) events from a seed: pods deleted, changed
    node, a new pod on a new workload, a service's ports and ClusterIP
    changed, endpoints scaled to zero, a node that goes NotReady, one
    added and one deleted."""
    rng = np.random.default_rng(seed + 50)
    pods = [p for p in objs["pods"] if p["status"]]
    ev = []
    for p in rng.choice(len(pods), size=3, replace=False).tolist():
        ev.append(("pods", "DELETED", pods[p]))
    moved = json.loads(json.dumps(pods[-1]))
    moved["spec"]["nodeName"] = "n3"
    ev.append(("pods", "MODIFIED", moved))
    ev.append(("pods", "ADDED", ce.k8s_pod(
        "new-0", "ns9", "10.244.2.250", "n2", owner=("StatefulSet",
                                                      "fresh"))))
    svc = json.loads(json.dumps(objs["services"][0]))
    svc["spec"]["ports"].append({"port": 9999})
    svc["spec"]["clusterIP"] = "10.96.1.1"
    ev.append(("services", "MODIFIED", svc))
    ev.append(("endpoints", "MODIFIED", ce.k8s_endpoints(
        objs["endpoints"][1]["metadata"]["name"],
        objs["endpoints"][1]["metadata"]["namespace"], [])))
    ev.append(("nodes", "MODIFIED", ce.k8s_node(
        "n1", "zone-b", "10.0.0.2", ["10.244.1.0/24"], ready="False")))
    ev.append(("nodes", "ADDED", ce.k8s_node(
        "n9", "zone-c", "10.0.0.9", ["10.244.9.0/24"])))
    ev.append(("nodes", "DELETED", objs["nodes"][3]))
    return ev


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_list_and_watch_like_reference(seed):
    objs = cluster(seed)
    stub = ce.StubApiServer(json.loads(json.dumps(objs)))
    pair = _start_both(stub)
    try:
        assert _wait(lambda: all(g.stats["pods"] == len(objs["pods"])
                                 for _, g, _ in pair))
        _same_index(pair, objs, seed)
        assert all(not rows for _, _, rows in pair)  # a list emits nothing
        events = _watch_events(objs, seed)
        for kind, etype, obj in events:
            stub.push(kind, etype, obj)
        assert _wait(lambda: all(g.stats["events"] == len(events)
                                 for _, g, _ in pair))
        _same_index(pair, objs, seed)
        (_, g, rows), (_, rg, rrows) = pair
        assert _events(rows) == _events(rrows) and rows
        kinds = {r["event_type"] for r in rows}
        assert {"pod-deleted", "pod-modified", "pod-added",
                "workload-added", "service-modified", "node-modified",
                "node-added", "node-deleted"} <= kinds, kinds
        assert {k: g.stats[k] for k in ("pods", "services", "endpoints",
                                        "nodes", "events", "errors")} == \
            {k: rg.stats[k] for k in ("pods", "services", "endpoints",
                                      "nodes", "events", "errors")}
    finally:
        _stop_both(stub, pair)


def test_relist_after_a_gap_reconciles_state_and_recorder():
    """Objects that vanish while no watch runs: the next relist (an
    expired resourceVersion) evicts them and emits their deletions."""
    objs = cluster(3)
    stub = ce.StubApiServer(json.loads(json.dumps(objs)))
    pair = _start_both(stub)
    try:
        assert _wait(lambda: all(g.stats["pods"] == len(objs["pods"])
                                 for _, g, _ in pair))
        with stub._cond:  # gone without an event
            for kind, n in (("pods", 5), ("services", 2), ("nodes", 1),
                            ("endpoints", 2)):
                for key in list(stub._objs[kind])[:n]:
                    del stub._objs[kind][key]
        for kind in ce.KINDS:  # 410 Gone: each loop lists again
            stub.push(kind, "ERROR", {"metadata": {}, "code": 410})
        assert _wait(lambda: all(g.stats["relists"] >= 8   # each loop twice
                                 and g.stats["pods"] == len(objs["pods"]) - 5
                                 and g.stats["services"] == 6
                                 and g.stats["endpoints"] == 6
                                 and g.stats["nodes"] == 3
                                 for _, g, _ in pair))
        assert _wait(lambda: all(
            sum(r["event_type"] == "pod-deleted" for r in rows) == 5
            and sum(r["event_type"] == "node-deleted" for r in rows) == 1
            for _, _, rows in pair))
        _same_index(pair, objs, 3)
        assert _events(pair[0][2]) == _events(pair[1][2])
    finally:
        _stop_both(stub, pair)


def test_workload_of_like_reference():
    for owner in ((), ("ReplicaSet", "web-6b7f9c"), ("ReplicaSet", "x"),
                  ("StatefulSet", "db"), ("DaemonSet", "ds"), ("Job", "j"),
                  ("Node", "n1"), ("CronJob", "c")):
        pod = ce.k8s_pod("p", "ns", "10.0.0.1", "n", owner=owner)
        assert genesis.K8sGenesis._workload_of(pod) == \
            ref_genesis.K8sGenesis._workload_of(pod)


def test_one_copy_of_the_cluster_config_helpers(monkeypatch):
    """The lease election takes genesis's helpers, as in the reference."""
    assert election.in_cluster_config is genesis.in_cluster_config
    assert election.build_api_context is genesis.build_api_context
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert genesis.in_cluster_config() is None
    assert genesis.build_api_context("http://x") is None
    with pytest.raises(ValueError):
        genesis.build_api_context("https://x")
    with pytest.raises(RuntimeError):
        genesis.K8sGenesis(pi.PodIpIndex())


# -- the reference's recorder cases ------------------------------------------

def _pod(name, ns="prod", node="n1", ip="10.244.1.5", owner=None):
    return ce.k8s_pod(name, ns, ip, node,
                      owner=("StatefulSet", owner) if owner else ())


@pytest.mark.parametrize("mod", [recorder, ref_recorder],
                         ids=["port", "reference"])
def test_recorder_attr_diff_cycle(mod):
    rows = []
    rec = mod.ResourceRecorder(rows.extend)
    rec.observe("node", "n1", {"az": "us-a", "ready": "True"})
    rec.observe("node", "n1", {"az": "us-a", "ready": "True"})  # no-op
    rec.observe("node", "n1", {"az": "us-a", "ready": "False"})
    rec.observe("node", "n1", None, deleted=True)
    assert [r["event_type"] for r in rows] == [
        "node-added", "node-modified", "node-deleted"]
    changed = json.loads(rows[1]["attrs"])["changed"]
    assert changed == {"ready": {"before": "True", "after": "False"}}
    assert json.loads(rows[2]["attrs"])["before"]["az"] == "us-a"
    assert "ready: True->False" in rows[1]["description"]
    assert rec.stats == {"added": 1, "modified": 1, "deleted": 1,
                         "suppressed": 0}


def test_recorder_reconcile_emits_gap_deletions():
    out = []
    for mod in (recorder, ref_recorder):
        rows = []
        rec = mod.ResourceRecorder(rows.extend)
        rec.observe("service", "p/a", {"cluster_ip": "1.2.3.4"}, emit=False)
        rec.observe("service", "p/b", {"cluster_ip": "1.2.3.5"}, emit=False)
        rec.observe("service", "p/a", {"cluster_ip": "1.2.3.9"}, emit=False)
        assert rec.reconcile("service", {"p/a"}) == 1
        assert rec.snapshot_keys("service") == ["p/a"]
        out.append([(r["event_type"], r["resource_name"], r["attrs"])
                    for r in rows])
    assert out[0] == out[1]
    assert [e[:2] for e in out[0]] == [("service-modified", "p/a"),
                                       ("service-deleted", "p/b")]


def test_node_service_workload_events_through_genesis():
    got = []
    for mod, gmod in PACKAGES:
        rows = []
        gen = gmod.K8sGenesis(mod.PodIpIndex(), api_base="http://127.0.0.1:1",
                              event_sink=rows.extend,
                              resources=mod.ResourceIndex())
        node = ce.k8s_node("n1", "us-a", "10.0.0.1", ["10.244.0.0/24"])
        gen._apply_node("ADDED", node)
        node["status"]["conditions"][0]["status"] = "False"
        gen._apply_node("MODIFIED", node)
        svc = ce.k8s_service("web", "prod", "10.96.0.10")
        gen._apply_service("ADDED", svc)
        svc["spec"]["ports"] = [{"port": 80}, {"port": 443}]
        gen._apply_service("MODIFIED", svc)
        gen._apply("ADDED", _pod("db-0", owner="db"))
        gen._apply("ADDED", _pod("db-1", ip="10.244.1.6", owner="db"))
        gen._apply("DELETED", _pod("db-0", owner="db"))
        gen._apply("DELETED", _pod("db-1", ip="10.244.1.6", owner="db"))
        types = [r["event_type"] for r in rows]
        assert "node-added" in types and "node-modified" in types
        assert "service-modified" in types
        assert types.count("workload-added") == 1
        assert types.count("workload-deleted") == 1
        nm = next(r for r in rows if r["event_type"] == "node-modified")
        assert json.loads(nm["attrs"])["changed"]["ready"] == {
            "before": "True", "after": "False"}
        sm = next(r for r in rows if r["event_type"] == "service-modified")
        assert json.loads(sm["attrs"])["changed"]["ports"] == {
            "before": [80], "after": [80, 443]}
        got.append([(r["event_type"], r["resource_name"], r["description"],
                     r["attrs"]) for r in rows])
    assert got[0] == got[1]


def test_change_timeline_queryable():
    """The port's server: the recorder's events land in event.event and
    come back from DF-SQL and /v1/query."""
    from deepflow_tpu_torch.server.server import Server
    server = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    try:
        gen = genesis.K8sGenesis(
            pi.PodIpIndex(), api_base="http://127.0.0.1:1",
            event_sink=server.db.table("event.event").append_rows,
            resources=pi.ResourceIndex())
        node = ce.k8s_node("n1", "z", "10.0.0.1", ["10.244.0.0/24"])
        gen._apply_node("ADDED", node)
        node["status"]["conditions"][0]["status"] = "False"
        gen._apply_node("MODIFIED", node)
        assert server.wait_for_rows("event.event", 2, timeout=5)
        r = engine.execute(server.db.table("event.event"),
                           "SELECT time, event_type, resource_name, attrs "
                           "FROM t WHERE resource_type = 'node' "
                           "ORDER BY time")
        assert [row[1] for row in r.values] == ["node-added",
                                                "node-modified"]
        attrs = json.loads(r.values[-1][3])
        assert attrs["changed"]["ready"]["after"] == "False"
        ans = server.api.query({"db": "event", "sql": "SELECT time, "
                                "event_type FROM event ORDER BY time"})
        assert [v[1] for v in ans["result"]["values"]] == [
            "node-added", "node-modified"]
    finally:
        server.stop()


# -- the reference's genesis cases (test_fleet_scale.py:164-258) ---------------

def test_k8s_genesis_list_watch():
    pods = [ce.k8s_pod("web-6b7f9c-abc", "prod", "10.244.1.5", "node-1",
                       owner=("ReplicaSet", "web-6b7f9c")),
            ce.k8s_pod("db-0", "prod", "10.244.1.6", "node-1",
                       owner=("StatefulSet", "db"))]
    stub = ce.StubApiServer({"pods": json.loads(json.dumps(pods))})
    pair = _start_both(stub, with_resources=False)
    try:
        stub.push("pods", "ADDED", ce.k8s_pod("cache-1", "prod",
                                              "10.244.1.7", "node-1"))
        stub.push("pods", "DELETED", pods[1])
        assert _wait(lambda: all(
            r.pod_index.lookup("10.244.1.7") is not None
            and r.pod_index.lookup("10.244.1.6") is None
            for r, _, _ in pair))
        for r, g, _ in pair:
            web = r.pod_index.lookup("10.244.1.5")
            assert web.name == "web-6b7f9c-abc" and web.workload == "web"
            assert web.namespace == "prod" and web.node == "node-1"
            assert r.pod_index.lookup("10.244.1.7").name == "cache-1"
            assert g.stats["pods"] == 2
        assert _events(pair[0][2]) == _events(pair[1][2])
    finally:
        _stop_both(stub, pair)


def test_pod_tags_injected_into_flow_rows():
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.agent.packet import TcpFlags, build_tcp
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.server.server import Server

    server = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    server.pod_index.upsert("10.244.1.5", pi.PodInfo("web-abc", "prod"))
    server.pod_index.upsert("10.244.1.9", pi.PodInfo("api-xyz", "prod"))
    sender = UniformSender(
        servers=[("127.0.0.1", server.ingest_port)]).start()
    disp = Dispatcher(sender=sender, engine="python")
    try:
        disp.inject(build_tcp("10.244.1.5", "10.244.1.9", 40000, 80,
                              TcpFlags.SYN, timestamp_ns=time.time_ns()))
        disp.flush(force=True)
        assert server.wait_for_rows("flow_log.l4_flow_log", 1, timeout=10)
        r = engine.execute(server.db.table("flow_log.l4_flow_log"),
                           "SELECT pod_0, pod_1 FROM t")
        assert r.values[0] == ["web-abc", "api-xyz"]
    finally:
        sender.flush_and_stop()
        server.stop()


def test_genesis_relist_reconciles_deletions():
    for mod in (pi, ref_pi):
        idx = mod.PodIpIndex()
        idx.upsert("10.0.0.1", mod.PodInfo("alive", "ns"))
        idx.upsert("10.0.0.2", mod.PodInfo("dead", "ns"))
        v = idx.version
        assert idx.retain_ips({"10.0.0.1"}) == 1
        assert idx.lookup("10.0.0.1") is not None
        assert idx.lookup("10.0.0.2") is None
        assert idx.version == v + 1 and len(idx) == 1


def test_gpid_ingest_side_join():
    """Flows with no agent gpid get the controller table's."""
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.agent.packet import TcpFlags, build_tcp
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.proto import wire
    from deepflow_tpu_torch.server.server import Server

    server = Server(host="127.0.0.1", ingest_port=0, query_port=0,
                    sync_port=0, enable_controller=True).start()
    try:
        server.controller.gpids.sync(wire.GpidSyncRequest(
            agent_id=1, entries=[wire.GpidEntry(
                agent_id=1, pid=4242, ip=socket.inet_aton("10.244.1.9"),
                port=80, proto=1, role=1, process_name="api")]))
        expected = server.controller.gpids.gpid_for(1, 4242)
        sender = UniformSender(
            servers=[("127.0.0.1", server.ingest_port)]).start()
        disp = Dispatcher(sender=sender, engine="python")
        disp.inject(build_tcp("10.244.1.5", "10.244.1.9", 40000, 80,
                              TcpFlags.SYN, timestamp_ns=time.time_ns()))
        disp.flush(force=True)
        assert server.wait_for_rows("flow_log.l4_flow_log", 1, timeout=10)
        sender.flush_and_stop()
        r = engine.execute(server.db.table("flow_log.l4_flow_log"),
                           "SELECT gprocess_id_0, gprocess_id_1, "
                           "process_kname_1 FROM t")
        assert r.values[0] == [0, expected, "api"]
    finally:
        server.stop()


# -- the server's genesis ------------------------------------------------------

def test_server_start_genesis_into_event_table_and_health():
    import urllib.request

    from deepflow_tpu_torch.server.server import Server
    objs = cluster(4)
    stub = ce.StubApiServer(json.loads(json.dumps(objs)))
    server = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    try:
        assert server.start_genesis(api_base=stub.base)
        assert _wait(lambda: stub.requests["watch"] >= 4)
        stub.push("nodes", "ADDED", ce.k8s_node("n7", "zone-a", "10.0.0.7",
                                                ["10.244.7.0/24"]))
        assert server.wait_for_rows("event.event", 1, timeout=10)
        assert server.resources.resolve("10.244.7.9").subnet == \
            "10.244.7.0/24"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.query_port}/v1/health") as r:
            health = json.loads(r.read())
        gen = health["stats"]["genesis"]
        assert gen["pods"] == len(objs["pods"]) and gen["events"] == 1
        assert gen["nodes"] == 4 and gen["errors"] == 0
        ans = server.api.query({"db": "event", "sql": "SELECT event_type, "
                                "resource_name FROM event"})
        assert ans["result"]["values"] == [["node-added", "n7"]]
    finally:
        stub.close_watches()
        server.stop()
        stub.stop()
    assert server.genesis is None


def test_server_without_a_cluster_runs_untagged(monkeypatch, tmp_path):
    from deepflow_tpu_torch.server.server import Server
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    server = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    try:
        assert server.start_genesis() is False   # no cluster to watch
        assert server.start_genesis(api_base="https://127.0.0.1:1") is \
            False                                 # https and no CA
        assert server.genesis is None
        assert server._stats()["genesis"] is None
    finally:
        server.stop()
    assert not os.listdir(tmp_path)
