"""The smoke's enrich phase: every flow row names its process and its pod.

    python3 chip_phases.py enrich       # alone, after the device phase

Run by ``chip_smoke.enrich_phase``, on one card. Four parts, each printing
its numbers and failing on a missed check:

(a) identity: the port's server with its controller runs in this process
    (its ingest, query and sync ports free ones), a second server
    process without one takes the training child's frames, and the node
    agent (``python -m deepflow_tpu_torch.agent --flow --interface lo
    --controller``, its socket scan every SCAN_S by ``-f``) captures
    ``lo``. First it is checked, and printed, whether ``/proc/net/tcp``
    lists this process's listening socket with the inode its
    ``/proc/<pid>/fd`` holds. Beside them a stdlib HTTP server child
    takes HTTP_REQUESTS requests, and the runner's training child (the
    runner phase's Llama on the card, under ``--controller``) trains
    TRAIN_STEPS steps. Every ``l4_flow_log`` and ``l7_flow_log`` row of
    the HTTP traffic must carry on side 1 the HTTP child's gpid and its
    ``/proc/<pid>/comm``; the rows of the training child's frames to its
    server carry on side 0 the gpid the controller gave the child's pid
    through its own runner agent (``SyncRequest.processes``) and on side
    1 the server process's. A watcher thread stops the node agent as soon
    as its scan reports the child's connection to its server (found in
    ``/proc/net/tcp``), so that open connection ships while the scan
    still names the child; (b) runs meanwhile. The scan's ms and entries
    print.
(b) resource tags at cluster size: an in-process server whose genesis
    lists and watches ``StubApiServer``, which holds PODS pods (no more
    than NODE_PODS to a node, on nodes whose pod CIDRs cover them) and
    SERVICES services with ClusterIPs and endpoints, laid over the
    addresses of B_FLOWS flows of ``chip_flows.bench_frames``' shape:
    about half the client sides are pods, every server side is a
    service's ClusterIP, and the clients past the last node resolve to
    nothing. The agent's frames of those flows go through the server's
    native decode, once before genesis starts (the index empty) and once
    after: every row's pod, namespace, workload, service, node, zone and
    subnet on both sides must equal ``ResourceIndex.resolve`` of its
    address, with ``pure_batches`` 0, and a 1m rollup keeps them. Then
    the stub sends a pod DELETED, a service MODIFIED and a node ADDED:
    the frames decoded again follow the new index, and ``event.event``
    holds exactly ``pod-deleted``, ``service-modified`` and
    ``node-added`` with their attributes. Rows/s per table with the
    index empty and loaded print.
(c) the agent's view: the node agent, restarted, fetches the
    controller's PodMap (genesis on (a)'s server lists ``LO_POD`` at
    127.0.0.1): its L4 logs carry the pod on both sides (the frames are
    read as it sent them), and a second fetch at the version it holds
    returns no entries.
(d) ACL actions, pushed: ``dfctl agent-group-config`` pushes three ACLs
    to the node agent's group: ``ignore`` on one port (no L4, L7 or
    metric row for it), ``pcap`` on a second (``/v1/pcaps`` holds
    captures whose packets are exactly the frames of that port's flows:
    their count equals the flows' packet totals) and ``npb`` on a third
    to a UDP receiver on ``lo`` (every datagram VXLAN whose inner frame
    is one of that port's, as many as the flows' packets; the target's
    port is excluded from capture).

Every number prints beside the card's name and power limit.
``StubApiServer`` and the ``k8s_*`` object builders are the CPU tests'
apiserver too.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

import chip_smoke as cs

SCAN_S = 2.0             # the node agent's socket scan interval
HTTP_REQUESTS = 500
HTTP_CONNECTIONS = 10
TRAIN_STEPS = 60
TRAIN_GROUP = "enrich-train"
NODE_GROUP = "enrich-node"
NODE_AGENT_START_S = 60.0
WAIT_S = 120.0
LO_POD = ("enrich-lo", "smoke", "enrich-node-0")  # (pod, namespace, node)
# (b): the bench shape's flows, their cluster and its resources
B_FLOWS = 10_000
B_NET = 12
PODS = 10_000
NODE_PODS = 110          # Kubernetes' default limit a node
SERVICES = 1_000
ENDPOINTS_A_SERVICE = 10
NODE_CIDR_PREFIX = 17    # a node's pod CIDR: 128 of the bench's clients
UNCOVERED_CLIENTS = 512  # the last clients lie past every node's CIDR
ZONES = ("zone-a", "zone-b", "zone-c")
SIDE_TAGS = ("pod", "pod_ns", "workload", "service", "node", "az",
             "subnet")


# -- the apiserver stub -------------------------------------------------------

KINDS = ("pods", "services", "endpoints", "nodes")


def _meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


class StubApiServer:
    """A Kubernetes apiserver's list and watch of pods, services,
    endpoints and nodes over HTTP: ``GET /api/v1/<kind>?limit=N[&continue=
    T]`` pages the current objects with the current ``resourceVersion``;
    ``?watch=1&resourceVersion=R&timeoutSeconds=S`` streams each event
    after R as a JSON line, as they come, until S seconds pass or
    ``close_watches``. ``push`` makes an event (and applies it to the
    listed state)."""

    def __init__(self, items: dict[str, list[dict]]) -> None:
        self.rv = 100
        self._objs: dict[str, dict] = {k: {} for k in KINDS}
        self._events: dict[str, list] = {k: [] for k in KINDS}
        self._cond = threading.Condition()
        self._closing = False
        self.requests = {"list": 0, "watch": 0}
        for kind in KINDS:
            for obj in items.get(kind, []):
                self.rv += 1
                _meta(obj)["resourceVersion"] = str(self.rv)
                self._objs[kind][self._key(obj)] = obj
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass

            def do_GET(self) -> None:  # noqa: N802 (http.server's name)
                url = urlparse(self.path)
                kind = url.path.rstrip("/").rsplit("/", 1)[-1]
                if kind not in KINDS:
                    self.send_error(404)
                    return
                q = dict(parse_qsl(url.query))
                if q.get("watch") in ("1", "true"):
                    stub._watch(self, kind, q)
                else:
                    stub._list(self, kind, q)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self._httpd.serve_forever,
                         name="k8s-stub", daemon=True).start()

    @staticmethod
    def _key(obj: dict) -> tuple:
        m = obj.get("metadata", {})
        return (m.get("namespace", ""), m.get("name", ""))

    def push(self, kind: str, etype: str, obj: dict) -> None:
        """An ADDED, MODIFIED or DELETED event (applied to the listed
        state), or an ERROR (an expired resourceVersion: the watcher
        lists again)."""
        with self._cond:
            self.rv += 1
            _meta(obj)["resourceVersion"] = str(self.rv)
            if etype == "DELETED":
                self._objs[kind].pop(self._key(obj), None)
            elif etype in ("ADDED", "MODIFIED"):
                self._objs[kind][self._key(obj)] = obj
            self._events[kind].append((self.rv, {"type": etype,
                                                 "object": obj}))
            self._cond.notify_all()

    def _list(self, h, kind: str, q: dict) -> None:
        self.requests["list"] += 1
        with self._cond:
            objs = list(self._objs[kind].values())
            rv = self.rv
        start = int(q.get("continue") or 0)
        limit = int(q.get("limit") or len(objs) or 1)
        page = objs[start:start + limit]
        meta = {"resourceVersion": str(rv)}
        if start + limit < len(objs):
            meta["continue"] = str(start + limit)
        body = json.dumps({"kind": kind.capitalize() + "List",
                           "metadata": meta, "items": page}).encode()
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _watch(self, h, kind: str, q: dict) -> None:
        self.requests["watch"] += 1
        after = int(q.get("resourceVersion") or 0)
        deadline = time.monotonic() + float(q.get("timeoutSeconds") or 300)
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.end_headers()
        while True:
            with self._cond:
                while True:
                    pending = [(rv, ev) for rv, ev in self._events[kind]
                               if rv > after]
                    left = deadline - time.monotonic()
                    if pending or self._closing or left <= 0:
                        break
                    self._cond.wait(min(left, 0.5))
            if not pending:
                return  # closed or timed out: the client watches again
            try:
                for rv, ev in pending:
                    h.wfile.write((json.dumps(ev) + "\n").encode())
                    after = rv
                h.wfile.flush()
            except OSError:
                return

    def close_watches(self) -> None:
        """End every watch stream now and answer later ones at once."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()

    def stop(self) -> None:
        self.close_watches()
        self._httpd.shutdown()
        self._httpd.server_close()


def k8s_pod(name: str, ns: str, ip: str, node: str, owner: tuple = (),
            labels: dict | None = None) -> dict:
    """A Pod object; ``owner`` (kind, name), e.g. ("ReplicaSet",
    "web-6b7f9c")."""
    meta = {"name": name, "namespace": ns, "labels": labels or {}}
    if owner:
        meta["ownerReferences"] = [{"kind": owner[0], "name": owner[1]}]
    status = {"podIP": ip, "podIPs": [{"ip": ip}]} if ip else {}
    return {"metadata": meta, "spec": {"nodeName": node}, "status": status}


def k8s_service(name: str, ns: str, cluster_ip: str,
                ports: tuple = (80,)) -> dict:
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"clusterIP": cluster_ip, "type": "ClusterIP",
                     "ports": [{"port": p} for p in ports]}}


def k8s_endpoints(name: str, ns: str, ips: list) -> dict:
    obj = {"metadata": {"name": name, "namespace": ns}}
    if ips:  # a service scaled to zero has no subsets key at all
        obj["subsets"] = [{"addresses": [{"ip": ip} for ip in ips],
                           "ports": [{"port": 80}]}]
    return obj


def k8s_node(name: str, zone: str, internal_ip: str, pod_cidrs: list,
             ready: str = "True") -> dict:
    return {"metadata": {"name": name, "labels": {
                "topology.kubernetes.io/zone": zone,
                "topology.kubernetes.io/region": "region-1"}},
            "spec": {"podCIDR": pod_cidrs[0], "podCIDRs": list(pod_cidrs)},
            "status": {"addresses": [{"type": "InternalIP",
                                      "address": internal_ip}],
                       "conditions": [{"type": "Ready", "status": ready}]}}


def bench_cluster(n_flows: int, net: int) -> dict[str, list[dict]]:
    """PODS pods, SERVICES services and their endpoints, and the nodes,
    laid over ``chip_flows.bench_frames(n_flows, net)``'s addresses
    (client ``net.(i >> 8).(i & 255).2``, server ``net.9.9.(i % 64)``):
    the even clients below the last UNCOVERED_CLIENTS are pods, on the
    node whose pod CIDR (``net.(k >> 1).(k & 1) * 128.0/17``) covers
    them, 64 a node; the other pods sit on nodes of their own (pod CIDRs
    in 10.200/16, 100 pods a node) that no flow touches. The first 64
    services' ClusterIPs are the bench's servers, the others' in
    10.96/16; each service's endpoints are ENDPOINTS_A_SERVICE pods of
    its namespace."""
    from chip_flows import ENDPOINTS
    covered = n_flows - UNCOVERED_CLIENTS
    per_node = 1 << (32 - NODE_CIDR_PREFIX - 8)   # /17: 128 third octets
    pods, nodes = [], []

    def add_node(k: int, cidr: str) -> str:
        name = f"node-{k:04d}"
        nodes.append(k8s_node(name, ZONES[k % len(ZONES)],
                              f"10.250.{k >> 8}.{k & 255}", [cidr]))
        return name

    placed = []   # (ip, node)
    for k in range(-(-covered // per_node)):
        name = add_node(k, f"{net}.{k >> 1}.{(k & 1) * 128}.0/"
                           f"{NODE_CIDR_PREFIX}")
        placed += [(f"{net}.{i >> 8}.{i & 255}.2", name)
                   for i in range(k * per_node,
                                  min(covered, (k + 1) * per_node), 2)]
    extra_per_node = 100
    m = 0
    while len(placed) < PODS:
        name = add_node(len(nodes), f"10.200.{m}.0/24")
        placed += [(f"10.200.{m}.{j + 2}", name)
                   for j in range(min(extra_per_node, PODS - len(placed)))]
        m += 1
    by_ns: dict[str, list[str]] = {}
    for n, (ip, node) in enumerate(placed):
        ns = f"ns-{n % 20:02d}"
        wl = f"app-{n % 400:03d}"
        pods.append(k8s_pod(f"{wl}-{n:05d}", ns, ip, node,
                            owner=("ReplicaSet", f"{wl}-7d9f8c"),
                            labels={"app": wl}))
        by_ns.setdefault(ns, []).append(ip)
    services, endpoints = [], []
    for s in range(SERVICES):
        ns = f"ns-{s % 20:02d}"
        cip = (f"{net}.9.9.{s}" if s < ENDPOINTS
               else f"10.96.{s >> 8}.{s & 255}")
        name = f"svc-{s:04d}"
        services.append(k8s_service(name, ns, cip, ports=(8000 + s % 64,)))
        mine = by_ns[ns]
        start = (s // 20) * ENDPOINTS_A_SERVICE
        endpoints.append(k8s_endpoints(
            name, ns, [mine[(start + j) % len(mine)]
                       for j in range(ENDPOINTS_A_SERVICE)]))
    return {"pods": pods, "services": services, "endpoints": endpoints,
            "nodes": nodes}


# -- helpers ---------------------------------------------------------------------

NODE_YAML = f"""\
# the enrich phase's node agent
socket_scan_interval_s: {SCAN_S}
sync_interval_s: 1.0
stats_interval_s: 1.0
"""
HTTP_CHILD = """\
import http.server, sys
class H(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def do_GET(self):
        self.wfile.write(b"HTTP/1.1 200 OK\\r\\nContent-Length: 2\\r\\n\\r\\nok")
    def log_message(self, *a):
        pass
s = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
print(s.server_address[1], flush=True)
s.serve_forever()
"""
TCP = 1


def _lo(ip: str = "127.0.0.1") -> bytes:
    return socket.inet_aton(ip)


def _comm(pid: int) -> str:
    with open(f"/proc/{pid}/comm") as f:
        return f.read().strip()


def _wait(cond, what: str, limit_s: float = WAIT_S) -> float:
    t0 = time.perf_counter()
    while not cond():
        cs.check(time.perf_counter() - t0 < limit_s, what)
        time.sleep(0.1)
    return time.perf_counter() - t0


def _children(pid: int) -> list[int]:
    """The live processes whose parent is ``pid``."""
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid:
            out.append(int(p))
    return out


def proc_net_check() -> dict:
    """Whether /proc/net/tcp lists a socket of this process with the
    inode its /proc/<pid>/fd holds (the scan's join)."""
    from deepflow_tpu_torch.agent import socket_scan
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        try:
            with open("/proc/net/tcp") as f:
                socks = socket_scan.parse_proc_net(f.read())
        except OSError as e:
            socks, err = [], str(e)
        else:
            err = ""
        fds = socket_scan.scan_socket_inodes()
        listed = sorted(i for _, p, st, i in socks if p == port)
        mine = sorted(i for i, pid in fds.items() if pid == os.getpid())
    out = {"proc_net_tcp_rows": len(socks), "listed_inodes": listed,
           "own_fd_socket_inodes": len(mine),
           "inode_in_fds": bool(listed) and set(listed) <= set(mine),
           "error": err}
    cs.phase("enrich proc", **{k: json.dumps(v) if isinstance(v, list)
                               else v for k, v in out.items()})
    cs.check(out["inode_in_fds"], "/proc/net/tcp lists this process's "
             f"listener with the inode its fds hold ({out})")
    return out


class _NodeAgent:
    """The node agent on lo with the controller, its log in
    ``results/<name>.log``; running once it logs its capture."""

    def __init__(self, srv, name: str) -> None:
        self.log_path = os.path.join(cs.OUT_DIR, f"{name}.log")
        cfg = os.path.join(cs.OUT_DIR, "enrich_node_agent.yaml")
        with open(cfg, "w") as f:
            f.write(NODE_YAML)
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deepflow_tpu_torch.agent", "-f", cfg,
             "--server", f"127.0.0.1:{srv.ingest_port}", "--flow",
             "--interface", "lo", "--controller",
             f"127.0.0.1:{srv.sync_port}", "--group", NODE_GROUP],
            cwd=cs.ROOT, stdout=self._log, stderr=subprocess.STDOUT)

        def running() -> bool:
            cs.check(self.proc.poll() is None,
                     f"the node agent runs (see {self.log_path})")
            with open(self.log_path) as f:
                return "socket-scan" in f.read()
        try:
            self.start_s = _wait(running, "the node agent started with its "
                                 "capture and its scan", NODE_AGENT_START_S)
        except BaseException:
            self.proc.kill()
            self.proc.wait()
            self._log.close()
            raise
        ids = [a["agent_id"] for a in srv.controller.registry.list()
               if a.get("agent_group") == NODE_GROUP]
        cs.check(len(ids) == 1, f"the node agent registered ({ids})")
        self.agent_id = ids[0]
        with open(self.log_path) as f:
            self.mode = "ring" if "(ring," in f.read() else "socket"

    def stop(self) -> str:
        if self.proc.poll() is None:
            self.proc.send_signal(15)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        with open(self.log_path) as f:
            text = f.read()
        cs.check(self.proc.returncode == 0 and "Traceback" not in text,
                 f"the node agent stopped cleanly (exit "
                 f"{self.proc.returncode}; see {self.log_path})")
        return text


def _rows(srv, table: str, cols: list[str]) -> list[dict]:
    got = cs._table_rows(srv, table, cols)
    return [dict(zip(cols, r)) for r in zip(*(got[c] for c in cols))]


def _agent_stats(srv, agent_id: int, metric: str) -> dict:
    """The agent's latest value of each of a metric's values."""
    rows = cs._table_rows(srv, cs._SELFSTATS, [
        "agent_id", "metric_name", "time", "value_name", "value"])
    mine = {k: [v for a, v in zip(rows["agent_id"], rows[k])
                if a == agent_id] for k in rows}
    return cs._latest_and_max(mine, metric)[0]


def _get(url_port: int, n: int, conns: int, path: str = "/r") -> None:
    import http.client
    for c in range(conns):
        conn = http.client.HTTPConnection("127.0.0.1", url_port, timeout=30)
        for k in range(n // conns):
            conn.request("GET", f"{path}?c={c}&k={k}")
            resp = conn.getresponse()
            cs.check(resp.read() == b"ok" and resp.status == 200,
                     f"GET on :{url_port} answers 200")
        conn.close()


# -- (a) identity -------------------------------------------------------------

def _connections(pid: int, remote_port: int) -> list[int]:
    """The local ports of ``pid``'s TCP connections to 127.0.0.1:
    ``remote_port`` (/proc/net/tcp joined to its fds)."""
    from deepflow_tpu_torch.agent.socket_scan import scan_socket_inodes
    mine = {i for i, p in scan_socket_inodes().items() if p == pid}
    out = []
    with open("/proc/net/tcp") as f:
        for line in f.read().splitlines()[1:]:
            parts = line.split()
            if len(parts) < 10 or int(parts[9]) not in mine:
                continue
            local, remote = parts[1].split(":"), parts[2].split(":")
            if int(remote[1], 16) == remote_port:
                out.append(int(local[1], 16))
    return out


def identity_start(srv, dst, nums: dict) -> dict:
    """The node agent, the HTTP child and its requests, and the training
    child; a watcher thread stops the node agent as soon as its scan
    reports the child's connection to its server, so that connection's
    flow ships while the child trains (the rest of the phase runs
    meanwhile). Returns what ``identity_check`` reads."""
    http_child = subprocess.Popen([sys.executable, "-c", HTTP_CHILD],
                                  stdout=subprocess.PIPE, text=True)
    try:
        return _identity_start(srv, dst, nums, http_child)
    except BaseException:
        http_child.kill()   # the phase's cleanup never saw it
        http_child.wait()
        raise


def _identity_start(srv, dst, nums: dict, http_child) -> dict:
    gpids = srv.controller.gpids
    hport = int(http_child.stdout.readline())
    agent = _NodeAgent(srv, "enrich_node_agent")
    nums.update(node_agent_start_s=agent.start_s, capture_mode=agent.mode,
                node_agent_id=agent.agent_id, http_port=hport)

    def listener():
        e = gpids.entry_for(_lo(), hport, TCP)
        return e is not None and e.pid == http_child.pid
    nums["scan_saw_listener_s"] = _wait(
        listener, "the node agent's scan reported the HTTP child's "
        "listener to the controller")
    t0 = time.perf_counter()
    _get(hport, HTTP_REQUESTS, HTTP_CONNECTIONS)
    nums["http_s"] = time.perf_counter() - t0
    ctx = {"agent": agent, "http_child": http_child, "hport": hport,
           "run": {}}
    run = ctx["run"]
    pid_box: list[int] = []
    # under the launcher, as a job runs: the runner's agent has its own
    # registry entry (a launcher identity), apart from the node agent's
    args = ["-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", *cs.RUNNER,
            "--server", f"127.0.0.1:{dst.ingest_port}",
            "--controller", f"127.0.0.1:{srv.sync_port}", "--group",
            TRAIN_GROUP, "--service", TRAIN_GROUP, "-m", cs.EXAMPLE,
            *cs.EXAMPLE_ARGS, "--steps", str(TRAIN_STEPS)]

    def train() -> None:
        try:
            run.update(cs._train_child(args, "enrich_train",
                                       on_spawn=pid_box.append))
        except Exception as e:   # noqa: BLE001 (read by the phase)
            run["error"] = e
    out_path = os.path.join(cs.OUT_DIR, "enrich_train.out")

    def steps() -> int:
        try:
            with open(out_path) as f:
                return sum(1 for line in f if line.startswith("{"))
        except OSError:
            return 0

    def watch() -> None:
        t0 = time.perf_counter()
        try:
            _wait(lambda: pid_box or "error" in run, "the launcher started")
            state = {}

            def seen():
                cs.check("error" not in run and ctx["train"].is_alive(),
                         "the training child trains")
                kids = _children(pid_box[0])
                if len(kids) != 1:
                    return False
                state["child"] = kids[0]
                ports = _connections(kids[0], dst.ingest_port)
                state["ports"] = ports
                return bool(ports) and all(
                    (e := gpids.entry_for(_lo(), p, TCP)) is not None
                    and e.pid == kids[0] for p in ports)
            _wait(seen, "the scan reports the training child's connection "
                  "to its server while it trains")
            ctx.update(child=state["child"], child_ports=state["ports"],
                       steps_at_stop=steps(),
                       connected_s=time.perf_counter() - t0)
            # stopped while the child trains: its open connection ships
            # now, while the scan's entries still name the child
            agent.stop()
        except Exception as e:   # noqa: BLE001 (read by the phase)
            ctx["watch_error"] = e
    ctx["train"] = threading.Thread(target=train, name="enrich-train",
                                    daemon=True)
    ctx["watch"] = threading.Thread(target=watch, name="enrich-watch",
                                    daemon=True)
    ctx["train"].start()
    ctx["watch"].start()
    return ctx


def identity_check(srv, dst, ctx: dict, nums: dict) -> None:
    """(a)'s checks, once the watcher stopped the node agent."""
    gpids = srv.controller.gpids
    agent, http_child, hport = ctx["agent"], ctx["http_child"], ctx["hport"]
    ctx["watch"].join(WAIT_S + NODE_AGENT_START_S)
    cs.check(not ctx["watch"].is_alive() and "watch_error" not in ctx,
             f"the node agent stopped while the child trained "
             f"({ctx.get('watch_error')})")
    child = ctx["child"]
    nums.update(train_connected_s=ctx["connected_s"],
                train_steps_at_capture_stop=ctx["steps_at_stop"],
                train_ports=ctx["child_ports"])
    cs._ingest_settled(srv.query_port)
    runner_id = next(a["agent_id"] for a in srv.controller.registry.list()
                     if a.get("agent_group") == TRAIN_GROUP)
    child_gpid = gpids.gpid_of(runner_id, child)
    http_e = gpids.entry_for(_lo(), hport, TCP)
    dst_e = gpids.entry_for(_lo(), dst.ingest_port, TCP)
    cs.check(child_gpid > 0 and dst_e is not None and dst_e.pid == dst.pid,
             f"the controller holds the child's gpid ({child_gpid}) and "
             f"the server process's listener ({dst_e})")
    cols = ["agent_id", "port_src", "port_dst", "gprocess_id_0",
            "gprocess_id_1", "process_kname_0", "process_kname_1",
            "pod_0", "pod_1"]
    l4 = [r for r in _rows(srv, "flow_log.l4_flow_log",
                           cols + ["packet_tx", "packet_rx"])
          if r["agent_id"] == agent.agent_id]
    l7 = [r for r in _rows(srv, "flow_log.l7_flow_log", cols)
          if r["agent_id"] == agent.agent_id]
    http_comm, dst_comm, child_comm = (_comm(http_child.pid),
                                       _comm(dst.pid), _comm(child))
    web4 = [r for r in l4 if r["port_dst"] == hport]
    web7 = [r for r in l7 if r["port_dst"] == hport]
    train4 = [r for r in l4 if r["port_dst"] == dst.ingest_port
              and r["port_src"] in ctx["child_ports"]]
    nums.update(http_l4_rows=len(web4), http_l7_rows=len(web7),
                http_gpid=http_e.gpid, http_comm=http_comm,
                train_l4_rows=len(train4), child_gpid=child_gpid,
                child_comm=child_comm, dst_gpid=dst_e.gpid,
                dst_comm=dst_comm, runner_agent_id=runner_id)
    scan = _agent_stats(srv, agent.agent_id, "agent.socket_scan")
    nums.update({f"scan_{k}": v for k, v in scan.items()})
    cs.phase("enrich identity", **nums)
    cs.check(len(web4) == HTTP_CONNECTIONS and len(web7) == HTTP_REQUESTS,
             f"the HTTP traffic's rows ({len(web4)} L4, {len(web7)} L7)")
    for r in web4 + web7:
        cs.check((r["gprocess_id_1"], r["process_kname_1"])
                 == (http_e.gpid, http_comm) and http_e.gpid > 0,
                 f"an HTTP row names the HTTP child on side 1 ({r})")
    cs.check(train4, "the training child's frames to its server are "
             "flows")
    for r in train4:
        cs.check((r["gprocess_id_0"], r["process_kname_0"],
                  r["gprocess_id_1"], r["process_kname_1"])
                 == (child_gpid, child_comm, dst_e.gpid, dst_comm),
                 f"a training flow names the child (gpid {child_gpid} "
                 f"given through its runner agent) and its server "
                 f"({dst_e.gpid}) ({r})")
    cs.check(scan.get("scans", 0) >= 2 and scan.get("entries", 0) > 0,
             f"the node agent scanned ({scan})")


# -- (b) resource tags at cluster size -----------------------------------------

TABLES_B = ("flow_log.l4_flow_log", "flow_log.l7_flow_log",
            "flow_metrics.network.1s", "flow_metrics.application.1s")
TAG_COLS = [f"{n}_{s}" for n in SIDE_TAGS for s in (0, 1)]


def _feed(srv, frames: list, agent_id: int) -> dict:
    """The frames through the server's decoders in this thread: rows/s a
    message type over its own handle time."""
    from deepflow_tpu_torch.codec import FrameHeader, MessageType
    decs = {d.MSG_TYPE: d for d in srv.decoders}
    rows: dict = {}
    spent: dict = {}
    for mt, payload in frames:
        mt = MessageType(mt)
        t0 = time.perf_counter()
        n = decs[mt].handle(FrameHeader(mt, agent_id=agent_id), payload)
        spent[mt] = spent.get(mt, 0.0) + time.perf_counter() - t0
        rows[mt] = rows.get(mt, 0) + n
    return {mt.name.lower(): rows[mt] / spent[mt] for mt in rows}


def _check_tags(srv, agent_id: int, expect: dict, what: str) -> dict:
    """Every row of the agent in the four tables carries each side's
    tags of its address in ``expect``; the tagged shares."""
    shares = {}
    for table in TABLES_B:
        rows = [r for r in _rows(srv, table, ["agent_id", "ip_src",
                                              "ip_dst"] + TAG_COLS)
                if r["agent_id"] == agent_id]
        cs.check(rows, f"{what}: {table} has rows")
        bad = 0
        for r in rows:
            for side, ip in (("0", r["ip_src"]), ("1", r["ip_dst"])):
                want = expect[ip]
                if any(r[f"{n}_{side}"] != want[n] for n in SIDE_TAGS):
                    bad += 1
        cs.check(bad == 0, f"{what}: every {table} row's side tags equal "
                 f"ResourceIndex.resolve of its addresses ({bad} sides "
                 f"differ of {2 * len(rows)})")
        key = table.split(".", 1)[1].replace(".", "_")
        shares[f"{key}_pod_0_share"] = sum(
            bool(r["pod_0"]) for r in rows) / len(rows)
        shares[f"{key}_service_1_share"] = sum(
            bool(r["service_1"]) for r in rows) / len(rows)
        shares[f"{key}_untagged_0_share"] = sum(
            not any(r[f"{n}_0"] for n in SIDE_TAGS) for r in rows) / len(rows)
        shares[f"{key}_rows"] = len(rows)
    return shares


def _expect(srv, frames_ips: set) -> dict:
    res = srv.resources
    return {ip: {n: getattr(res.resolve(ip), n) for n in SIDE_TAGS}
            for ip in frames_ips}


def resources_part(nums: dict) -> None:
    from chip_flows import _Frames, bench_frames
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.server.datasource import RollupJob
    from deepflow_tpu_torch.server.server import Server
    t_part = time.perf_counter()
    data, offsets, ts, n_packets = bench_frames(B_FLOWS, net=B_NET,
                                                http=True)
    sink = _Frames()
    disp = Dispatcher(sender=sink)
    with disp._lock:
        disp.native_map.inject_batch(data, offsets, ts)
    disp.flush(now_ns=int(ts[-1]) + 1)
    disp.flush(force=True)
    frames = sink.frames
    del data, offsets, ts
    nums["frames_s"] = time.perf_counter() - t_part
    objs = bench_cluster(B_FLOWS, B_NET)
    n_nodes = len(objs["nodes"])
    stub = StubApiServer(objs)
    srv = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    srv.rollup.stop()   # this part rolls the 1 s rows itself
    srv.janitor.stop()
    try:
        ips: set = set()
        nums["empty_rows_per_s"] = _feed(srv, frames, agent_id=1)
        for table in TABLES_B:
            got = cs._table_rows(srv, table, ["ip_src", "ip_dst"])
            ips.update(got["ip_src"])
            ips.update(got["ip_dst"])
        empty = _check_tags(srv, 1, {ip: dict.fromkeys(SIDE_TAGS, "")
                                     for ip in ips}, "the empty index")
        t0 = time.perf_counter()
        cs.check(srv.start_genesis(api_base=stub.base), "genesis started")
        _wait(lambda: srv.genesis.stats["pods"] == PODS
              and srv.genesis.stats["services"] == SERVICES
              and srv.genesis.stats["endpoints"] == SERVICES
              and srv.genesis.stats["nodes"] == n_nodes
              and stub.requests["watch"] >= 4,
              f"genesis listed the cluster ({srv.genesis.stats})")
        nums["genesis_list_s"] = time.perf_counter() - t0
        nums["index"] = srv.resources.summary()
        nums["loaded_rows_per_s"] = _feed(srv, frames, agent_id=2)
        loaded = _check_tags(srv, 2, _expect(srv, ips), "the loaded index")
        nums["loaded_shares"] = loaded
        cs.check(0.35 <= loaded["l4_flow_log_pod_0_share"] <= 0.65
                 and loaded["l4_flow_log_service_1_share"] == 1.0
                 and loaded["l4_flow_log_untagged_0_share"] > 0,
                 f"about half the clients are pods, every server a "
                 f"service, some clients nothing ({loaded})")
        # the 1m tier keeps the tags: each key's rows carry the 1 s rows'
        keys = ["agent_id", "ip_src", "ip_dst", "server_port"] + TAG_COLS
        now_s = max(cs._table_rows(srv, "flow_metrics.network.1s",
                                   ["time"])["time"]) + 120
        RollupJob(srv.db, lateness_s=0).roll(now_s)
        for fam in ("network", "application"):
            one_s = {tuple(r[k] for k in keys) for r in _rows(
                srv, f"flow_metrics.{fam}.1s", keys)}
            one_m = {tuple(r[k] for k in keys) for r in _rows(
                srv, f"flow_metrics.{fam}.1m", keys)}
            cs.check(one_m == one_s and one_m,
                     f"the {fam} 1m rollup keeps every key's tags "
                     f"({len(one_m)} keys against {len(one_s)})")
        # the watch: a pod deleted, a service changed, a node added
        pod = next(p for p in objs["pods"]
                   if p["status"]["podIP"].startswith(f"{B_NET}.0."))
        svc = json.loads(json.dumps(objs["services"][0]))
        old_ip = svc["spec"]["clusterIP"]
        svc["spec"]["clusterIP"] = "10.96.200.1"
        k = -(-(B_FLOWS - UNCOVERED_CLIENTS) // 128)
        node = k8s_node("node-late", "zone-c", "10.250.200.1",
                        [f"{B_NET}.{k >> 1}.{(k & 1) * 128}.0/"
                         f"{NODE_CIDR_PREFIX}"])
        stub.push("pods", "DELETED", pod)
        stub.push("services", "MODIFIED", svc)
        stub.push("nodes", "ADDED", node)
        _wait(lambda: srv.genesis.stats["events"] == 3,
              "genesis took the three watch events")
        gone = srv.resources.resolve(pod["status"]["podIP"])
        cs.check(gone.pod == "" and srv.resources.resolve(old_ip).service
                 == "", "the index follows the watch")
        nums["after_rows_per_s"] = _feed(srv, frames, agent_id=3)
        after = _check_tags(srv, 3, _expect(srv, ips), "after the events")
        nums["after_shares"] = after
        cs.check(after["l4_flow_log_untagged_0_share"]
                 < loaded["l4_flow_log_untagged_0_share"],
                 "the added node tags clients that had nothing")
        ev = _rows(srv, "event.event", ["event_type", "resource_name",
                                        "attrs"])
        got = sorted((e["event_type"], e["resource_name"]) for e in ev)
        want = sorted([("pod-deleted", f"{pod['metadata']['namespace']}/"
                                       f"{pod['metadata']['name']}"),
                       ("service-modified", f"{svc['metadata']['namespace']}"
                                            f"/{svc['metadata']['name']}"),
                       ("node-added", "node-late")])
        cs.check(got == want, f"event.event holds exactly the three "
                 f"events ({got})")
        attrs = {e["event_type"]: json.loads(e["attrs"]) for e in ev}
        cs.check(attrs["pod-deleted"]["before"]["ips"]
                 == [pod["status"]["podIP"]]
                 and attrs["service-modified"]["changed"]["cluster_ip"]
                 == {"before": old_ip, "after": "10.96.200.1"}
                 and attrs["node-added"]["after"]["pod_cidrs"]
                 == node["spec"]["podCIDRs"],
                 f"the events carry their attributes ({attrs})")
        dec = {d.MSG_TYPE.name: d.stats for d in srv.decoders}
        cs.check(all(dec[k]["pure_batches"] == 0 and dec[k]["errors"] == 0
                      and dec[k]["native_batches"] > 0
                      for k in ("L4_LOG", "L7_LOG", "METRICS")),
                 f"every batch decoded natively ({dec})")
        nums["empty_shares"] = empty
        nums["frames"] = len(frames)
        nums["packets"] = n_packets
        nums["genesis"] = dict(srv.genesis.stats)
    finally:
        stub.close_watches()
        srv.stop()
        stub.stop()
    nums["part_s"] = time.perf_counter() - t_part
    cs.phase("enrich resources", **{k: json.dumps(v) if isinstance(
        v, dict) else v for k, v in nums.items()})


# -- (c) the agent's view, (d) ACL actions ---------------------------------------

def _pcap_frames(data: bytes) -> list[bytes]:
    import gzip
    import struct
    raw = gzip.decompress(data)
    out, i = [], 24
    while i + 16 <= len(raw):
        n = struct.unpack_from("<I", raw, i + 8)[0]
        out.append(raw[i + 16:i + 16 + n])
        i += 16 + n
    return out


def agent_part(srv, hport: int, nums: dict) -> None:
    """(c) and (d), on a node agent of its own."""
    import base64
    import struct

    from deepflow_tpu_torch.agent.packet import decode_ethernet
    from deepflow_tpu_torch.codec import MessageType
    from deepflow_tpu_torch.proto import wire
    from deepflow_tpu_torch.server.syncwire import SyncClient
    l4_dec = next(d for d in srv.decoders
                  if d.MSG_TYPE == MessageType.L4_LOG)
    sent: list[tuple] = []
    handle = l4_dec.handle

    def tap(header, payload):   # the L4 logs as the node agent sent them
        sent.append((header.agent_id, payload))
        return handle(header, payload)
    l4_dec.handle = tap
    agent = _NodeAgent(srv, "enrich_node_agent_acl")
    servers, udp = [], None
    try:
        # (c) the PodMap, once, then versions only
        _wait(lambda: _agent_stats(srv, agent.agent_id,
                                   "agent.synchronizer").get("syncs", 0) >= 3,
              "the node agent synced three times")
        sync = _agent_stats(srv, agent.agent_id, "agent.synchronizer")
        lab = _agent_stats(srv, agent.agent_id, "agent.labeler")
        client = SyncClient(f"127.0.0.1:{srv.sync_port}")
        try:
            full = client.call("PodMap", wire.PodMapRequest())
            again = client.call("PodMap", wire.PodMapRequest(
                version=full.version, epoch=full.epoch))
        finally:
            client.close()
        nums.update(podmap_updates=sync.get("podmap_updates"),
                    podmap_entries=sync.get("podmap_entries"),
                    podmap_syncs=sync.get("syncs"),
                    labeler_resources=lab.get("resources"),
                    podmap_full_entries=len(full.entries),
                    podmap_again_entries=len(again.entries))
        cs.check(sync.get("podmap_updates") == 1
                 and sync.get("podmap_entries") == len(full.entries) == 1
                 and lab.get("resources") == 1 and not again.entries,
                 f"the agent took the PodMap once and a fetch at its "
                 f"version is empty ({nums})")
        # (d) three ACLs pushed to the agent's group
        import http.server

        class Ok(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:  # noqa: N802
                self.wfile.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2"
                                 b"\r\n\r\nok")

            def log_message(self, *a) -> None:
                pass
        for _ in range(3):
            h = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Ok)
            threading.Thread(target=h.serve_forever, daemon=True).start()
            servers.append(h)
        p_ignore, p_pcap, p_npb = (h.server_address[1] for h in servers)
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        udp.bind(("127.0.0.1", 0))
        udp.settimeout(0.5)
        u_port = udp.getsockname()[1]
        pushed = os.path.join(cs.OUT_DIR, "enrich_acls.yaml")
        with open(pushed, "w") as f:
            f.write(f"profiler:\n  enabled: false\ntpuprobe:\n  enabled: "
                    f"false\nstats_interval_s: 1.0\nacls:\n"
                    f"  - {{port: {p_ignore}, action: ignore}}\n"
                    f"  - {{port: {p_pcap}, action: pcap}}\n"
                    f"  - {{port: {p_npb}, action: npb}}\n"
                    f"npb_target: \"127.0.0.1:{u_port}\"\n")
        from chip_control import _dfctl
        out = _dfctl(srv.query_port, "agent-group-config", "set", pushed,
                     "--group", NODE_GROUP).strip()
        version = int(out.rsplit(" ", 1)[1])
        _wait(lambda: any(a["agent_id"] == agent.agent_id
                          and a.get("config_version") == version
                          for a in srv.controller.registry.list()),
              "the node agent applied the pushed ACLs")
        time.sleep(1.5)   # past a sync: the synced version is applied
        for port in (p_ignore, p_pcap, p_npb, hport):
            _get(port, 20, 2, "/acl")
        time.sleep(1.5)   # a dispatcher tick closes the flows
        dgrams = []
        while True:
            try:
                dgrams.append(udp.recvfrom(65536)[0])
            except socket.timeout:
                break
        text = agent.stop()
        cs.check("Traceback" not in text, "the node agent raised nothing")
        cs._ingest_settled(srv.query_port)
        while True:   # the datagrams of the stop's flush
            try:
                dgrams.append(udp.recvfrom(65536)[0])
            except socket.timeout:
                break
    finally:
        l4_dec.handle = handle
        for h in servers:
            h.shutdown()
            h.server_close()
        if udp is not None:
            udp.close()
        if agent.proc.poll() is None:
            agent.stop()
    # (c) the agent-side pods on the L4 logs it sent
    lo_logs = [f for aid, p in sent if aid == agent.agent_id
               for f in wire.FlowLogBatch.FromString(p).l4
               if bytes(f.key.ip_src) == bytes(f.key.ip_dst) == _lo()]
    pods = {(f.pod_0, f.pod_1) for f in lo_logs}
    nums.update(agent_l4_logs_on_lo=len(lo_logs), agent_pods=sorted(pods))
    cs.check(lo_logs and pods == {(LO_POD[0], LO_POD[0])},
             f"every L4 log the agent sent on lo carries its pod on both "
             f"sides ({sorted(pods)})")
    cols = ["agent_id", "port_src", "port_dst", "packet_tx", "packet_rx"]
    mine = {t: [r for r in _rows(srv, t, cols if "l4" in t else cols[:3])
                if r["agent_id"] == agent.agent_id]
            for t in ("flow_log.l4_flow_log", "flow_log.l7_flow_log")}
    docs = [r for t in ("flow_metrics.network.1s",
                        "flow_metrics.application.1s")
            for r in _rows(srv, t, ["agent_id", "server_port"])
            if r["agent_id"] == agent.agent_id]

    def on(rows, port):
        return [r for r in rows if port in (r["port_src"], r["port_dst"])]
    lab = _agent_stats(srv, agent.agent_id, "agent.labeler")
    acts = _agent_stats(srv, agent.agent_id, "agent.packet_actions")
    ignored = (len(on(mine["flow_log.l4_flow_log"], p_ignore)),
               len(on(mine["flow_log.l7_flow_log"], p_ignore)),
               sum(r["server_port"] == p_ignore for r in docs))
    pcap_l4 = on(mine["flow_log.l4_flow_log"], p_pcap)
    npb_l4 = on(mine["flow_log.l4_flow_log"], p_npb)
    pcap_packets = sum(r["packet_tx"] + r["packet_rx"] for r in pcap_l4)
    npb_packets = sum(r["packet_tx"] + r["packet_rx"] for r in npb_l4)
    caps = [e for e in srv.api.pcaps()["pcaps"]
            if e["agent_id"] == agent.agent_id]
    frames = []
    for e in caps:
        ans = srv.api.pcaps({"name": e["name"]})
        frames += _pcap_frames(base64.b64decode(ans["pcap_gz_b64"]))
    metas = [decode_ethernet(f) for f in frames]
    inner = [decode_ethernet(d[8:]) for d in dgrams]
    nums.update(ignored_rows=ignored, ignored_flows=lab.get("ignored_flows"),
                pcap_flows=len(pcap_l4), pcap_flow_packets=pcap_packets,
                pcap_captures=len(caps), pcap_frames=len(frames),
                npb_flows=len(npb_l4), npb_flow_packets=npb_packets,
                npb_datagrams=len(dgrams), packet_actions=acts)
    cs.phase("enrich acls", **{k: json.dumps(v) if isinstance(
        v, (dict, list, tuple)) else v for k, v in nums.items()})
    cs.check(ignored == (0, 0, 0) and lab.get("ignored_flows", 0) > 0,
             f"no L4, L7 or metric row for the ignored port ({ignored})")
    cs.check(pcap_l4 and len(frames) == pcap_packets and all(
        m is not None and p_pcap in (m.port_src, m.port_dst) for m in metas),
        f"the captures hold exactly the pcap port's frames ({len(frames)} "
        f"frames, the flows' packets {pcap_packets})")
    cs.check(npb_l4 and len(dgrams) == npb_packets and all(
        struct.unpack(">I", d[:4])[0] >> 24 == 0x08 for d in dgrams)
        and all(m is not None and p_npb in (m.port_src, m.port_dst)
                for m in inner),
        f"every forwarded datagram is VXLAN of an npb port frame "
        f"({len(dgrams)} datagrams, the flows' packets {npb_packets})")


# -- the phase ---------------------------------------------------------------------

def enrich_phase(nums: dict) -> None:
    """(a) to (d), on one card; the numbers land in ``nums``."""
    from deepflow_tpu_torch.server.server import Server
    t_phase = time.perf_counter()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    nums["proc"] = proc_net_check()
    stub = StubApiServer({"pods": [k8s_pod(LO_POD[0], LO_POD[1],
                                           "127.0.0.1", LO_POD[2])]})
    srv = Server(host="127.0.0.1", ingest_port=0, query_port=0,
                 sync_port=0, enable_controller=True).start()
    dst = http_child = ctx = None
    try:
        cs.check(srv.start_genesis(api_base=stub.base),
                 "genesis started on the server")
        _wait(lambda: srv.pod_index.lookup("127.0.0.1") is not None,
              "genesis listed the lo pod")
        dst = cs._ServerProcess(os.path.join(cs.OUT_DIR,
                                             "enrich_dst_server.log"),
                                extra_args=["--no-controller"])
        nums["identity"] = {}
        ctx = identity_start(srv, dst, nums["identity"])
        http_child = ctx["http_child"]
        nums["resources"] = {}
        resources_part(nums["resources"])   # while the child starts
        identity_check(srv, dst, ctx, nums["identity"])
        nums["agent"] = {}
        agent_part(srv, ctx["hport"], nums["agent"])
        ctx["train"].join(cs.RUNNER_CHILD_S)
        run = ctx["run"]
        cs.check("error" not in run and run.get("steps") == TRAIN_STEPS,
                 f"the training child trained {TRAIN_STEPS} steps "
                 f"({run.get('error')})")
        nums["identity"].update(
            step_ms_median=run["step_ms_median"],
            step_ms_mean=run["step_ms_mean"], train_wall_s=run["wall_s"])
    finally:
        if http_child is not None:
            http_child.kill()
            http_child.wait()
        if ctx is not None and ctx["agent"].proc.poll() is None:
            ctx["agent"].proc.kill()   # a failed check left it running
        stub.close_watches()
        srv.stop()
        stub.stop()
        if dst is not None:
            dst.stop()
    nums["phase_s"] = time.perf_counter() - t_phase
    cs.phase("enrich", phase_s=nums["phase_s"],
             step_ms_median=nums["identity"]["step_ms_median"],
             step_ms_mean=nums["identity"]["step_ms_mean"])
