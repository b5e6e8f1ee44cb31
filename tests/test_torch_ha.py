"""Leader election, singletons and analyzer rebalance on the port.

The election cases of ``tests/test_ha.py`` run on both packages'
``LeaderElection`` and ``K8sLeaseElection`` (the lease against a local
fake Kubernetes API server with resourceVersion CAS), with the same
steps and the same expected tokens and flags. The port's server runs its
singletons (controller, rollup job, janitor) on the leader only and hands
them over on a resignation; the rendezvous assignment gives the
reference's order for every agent; an agent on the port's transport
adopts an analyzer list and reverts to its own servers when it is
cleared.
"""

import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from deepflow_tpu.server import controller as ref_ctl
from deepflow_tpu.server import election as ref_election
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.server import controller as port_ctl
from deepflow_tpu_torch.server import election as port_election
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = pytest.mark.parametrize("el", [port_election, ref_election],
                               ids=["port", "ref"])


@BOTH
def test_single_candidate_wins_and_renews(tmp_path, el):
    lease = str(tmp_path / "lease")
    e = el.LeaderElection(lease, holder="a")
    assert e.try_acquire() is True
    assert e.is_leader and e.token == 1
    assert e.try_acquire() is True       # renewal keeps the token
    assert e.token == 1
    assert e.stats["renewals"] == 1


@BOTH
def test_second_candidate_defers_then_takes_over(tmp_path, el):
    lease = str(tmp_path / "lease")
    a = el.LeaderElection(lease, holder="a")
    b = el.LeaderElection(lease, holder="b")
    assert a.try_acquire() is True
    assert b.try_acquire() is False       # the kernel lock is a's
    a.resign()
    assert b.try_acquire() is True
    assert b.token == 2                    # the fencing token advanced
    assert a.try_acquire() is False
    assert a.is_leader is False
    assert b.is_leader


@BOTH
def test_sigkilled_leader_flock_released_and_fencing_advances(tmp_path,
                                                              el):
    """A SIGKILLed leader never resigns, but its flock goes with the
    process: a follower wins within a renew interval, with a larger
    token."""
    lease = str(tmp_path / "lease")
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time\n"
         f"from {el.__name__} import LeaderElection\n"
         "e = LeaderElection(sys.argv[1], holder='child')\n"
         "assert e.try_acquire()\n"
         "print(e.token, flush=True)\n"
         "time.sleep(60)\n",
         lease],
        stdout=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        child_token = int(child.stdout.readline().strip())
        assert child_token >= 1
        follower = el.LeaderElection(lease, holder="follower",
                                     renew_interval_s=0.2)
        assert follower.try_acquire() is False
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)
        deadline = time.time() + follower.renew_interval_s + 5.0
        while time.time() < deadline and not follower.try_acquire():
            time.sleep(0.05)
        assert follower.is_leader
        assert follower.token > child_token
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()


@BOTH
def test_graceful_resign_hands_over(tmp_path, el):
    lease = str(tmp_path / "lease")
    a = el.LeaderElection(lease, holder="a", ttl_s=30.0)
    b = el.LeaderElection(lease, holder="b", ttl_s=30.0)
    assert a.try_acquire() is True
    a.resign()
    assert b.try_acquire() is True        # no TTL wait


def test_server_singletons_follow_leadership(tmp_path):
    """Two port servers, one lease: exactly one runs the controller, the
    rollup job and the janitor; the follower takes them over when the
    leader resigns, its controller answering on its own port."""
    lease = str(tmp_path / "lease")
    servers = [Server(ingest_port=0, query_port=0, sync_port=0,
                      enable_controller=True, ha_lease_path=lease).start()
               for _ in range(2)]
    try:
        leaders = [s.election.is_leader for s in servers]
        assert sorted(leaders) == [False, True]
        leader, follower = servers if leaders[0] else servers[::-1]
        assert leader.rollup.running() and leader.janitor.running()
        assert leader.controller.running()
        assert not follower.rollup.running()
        assert not follower.janitor.running()
        assert not follower.controller.running()
        leader.election.renew_interval_s = 0.2
        follower.election.renew_interval_s = 0.2
        leader.election.resign()
        deadline = time.time() + 10
        while time.time() < deadline and not follower.election.is_leader:
            follower.election.try_acquire()
            time.sleep(0.1)
        assert follower.election.is_leader
        assert follower.rollup.running() and follower.controller.running()
        assert not leader.controller.running()
        from deepflow_tpu_torch.proto import wire
        from deepflow_tpu_torch.server.syncwire import SyncClient
        client = SyncClient(f"127.0.0.1:{follower.sync_port}")
        try:
            resp = client.call("Sync", wire.SyncRequest(hostname="h"))
            assert resp.agent_id == 1
        finally:
            client.close()
    finally:
        for s in servers:
            s.stop()


def test_server_without_lease_runs_the_singletons():
    s = Server(ingest_port=0, query_port=0, sync_port=0,
               enable_controller=True).start()
    try:
        assert s.election is None
        assert s.rollup.running() and s.janitor.running()
        assert s.controller.running()
    finally:
        s.stop()
    assert not s.controller.running()


def test_k8s_lease_without_a_cluster_fails_the_start(monkeypatch):
    """The reference runs the singletons locally when no cluster holds
    the Lease; the port's server refuses to start."""
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    s = Server(ingest_port=0, query_port=0, ha_k8s_lease="df-leader")
    with pytest.raises(RuntimeError, match="not in a cluster"):
        s.start()
    assert s.election is None and not s.rollup.running()
    assert s.decoders == []  # nothing started


def test_analyzer_rendezvous_assignment_matches_reference():
    """Every agent's preference order is the reference's; the spread is
    even and a joining node takes only the agents it wins."""
    nodes = ["10.0.0.1:20033", "10.0.0.2:20033", "10.0.0.3:20033"]
    port = port_ctl.Controller(PlatformInfoTable())
    ref = ref_ctl.Controller(RefPlatform())
    for ctl in (port, ref):
        ctl.set_analyzers(nodes)
    first, counts = {}, {}
    for agent_id in range(300):
        order = port.assign_analyzers(agent_id)
        assert order == ref.assign_analyzers(agent_id)
        assert sorted(order) == sorted(port.analyzers())
        first[agent_id] = order[0]
        counts[order[0]] = counts.get(order[0], 0) + 1
    assert all(40 <= c <= 160 for c in counts.values()), counts
    for ctl in (port, ref):
        ctl.set_analyzers(nodes + ["10.0.0.4:20033"])
    moved = 0
    for a in range(300):
        order = port.assign_analyzers(a)
        assert order == ref.assign_analyzers(a)
        if order[0] != first[a]:
            moved += 1
            assert order[0] == "10.0.0.4:20033"
    assert moved < 150
    with pytest.raises(ValueError):
        port.set_analyzers(["10.0.0.1:notaport"])


def test_analyzer_assignment_revert():
    """Clearing the analyzer list reverts agents to their servers."""
    server = Server(ingest_port=0, query_port=0, sync_port=0,
                    enable_controller=True).start()
    cfg = AgentConfig(controller=f"127.0.0.1:{server.sync_port}",
                      sync_interval_s=0.2, agent_id=0)
    cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
    cfg.profiler.enabled = False
    cfg.tpuprobe.enabled = False
    cfg.guard.enabled = False
    agent = Agent(cfg, device="cpu").start()
    try:
        configured = list(agent.sender.servers)
        server.controller.set_analyzers(["10.9.9.9:20033"])
        deadline = time.time() + 10
        while time.time() < deadline and \
                agent.sender.servers == configured:
            time.sleep(0.1)
        assert agent.sender.servers == [("10.9.9.9", 20033)]
        server.controller.set_analyzers([])
        deadline = time.time() + 10
        while time.time() < deadline and \
                agent.sender.servers != configured:
            time.sleep(0.1)
        assert agent.sender.servers == configured
        assert agent.synchronizer.stats["rebalances"] == 2
    finally:
        agent.stop()
        server.stop()


class _FakeLeaseApi(http.server.BaseHTTPRequestHandler):
    """coordination.k8s.io/v1 Lease with resourceVersion CAS."""
    state = {"lease": None, "rv": 0}

    def log_message(self, *a):
        pass

    def _send(self, code, obj=None):
        body = json.dumps(obj or {}).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        st = self.state
        if st["lease"] is None:
            self._send(404, {"reason": "NotFound"})
        else:
            self._send(200, st["lease"])

    def do_POST(self):
        st = self.state
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))
        if st["lease"] is not None:
            self._send(409, {"reason": "AlreadyExists"})
            return
        st["rv"] += 1
        body.setdefault("metadata", {})["resourceVersion"] = str(st["rv"])
        st["lease"] = body
        self._send(201, body)

    def do_PUT(self):
        st = self.state
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))
        want = body.get("metadata", {}).get("resourceVersion", "")
        have = (st["lease"] or {}).get("metadata", {}).get(
            "resourceVersion", "")
        if st["lease"] is None or want != have:
            self._send(409, {"reason": "Conflict"})
            return
        st["rv"] += 1
        body["metadata"]["resourceVersion"] = str(st["rv"])
        st["lease"] = body
        self._send(200, body)


@BOTH
def test_k8s_lease_election_single_leader_and_takeover(el):
    """CAS arbitration, expiry takeover after a ttl by the observer's own
    clock, fencing transitions, and a resignation that frees the lease at
    once."""
    _FakeLeaseApi.state = {"lease": None, "rv": 0}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FakeLeaseApi)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        a = el.K8sLeaseElection("df-leader", api_base=base, holder="a",
                                ttl_s=1.0)
        b = el.K8sLeaseElection("df-leader", api_base=base, holder="b",
                                ttl_s=1.0)
        assert a.try_acquire() is True        # CREATE wins
        assert b.try_acquire() is False       # a fresh lease, a's
        assert a.try_acquire() is True        # renewal
        assert a.stats["renewals"] == 1
        deadline = time.time() + 5
        while time.time() < deadline and not b.try_acquire():
            time.sleep(0.2)
        assert b.is_leader is True            # expiry takeover via CAS PUT
        assert b.token_fencing == 2
        assert a.try_acquire() is False       # a steps down
        assert a.stats["depositions"] == 1
        b.resign()
        assert a.try_acquire() is True        # no ttl wait after resign
        assert a.token_fencing == 3
    finally:
        srv.shutdown()


def test_https_lease_needs_a_ca_as_reference():
    for el in (port_election, ref_election):
        with pytest.raises(ValueError, match="ca_path"):
            el.K8sLeaseElection("x", api_base="https://10.0.0.1:443")
