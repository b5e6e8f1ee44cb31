"""K8s genesis: list and watch the cluster's resource model into the
ingest-side tables.

Own copy of ``deepflow_tpu/server/genesis.py``, whole (reference analog:
agent/src/platform/kubernetes/api_watcher.rs and
server/controller/genesis/genesis.go:54). The watcher lives on the
server, one per cluster, and feeds the ``PodIpIndex`` and
``ResourceIndex`` (``server/platform_info.py``) the ingest decoders read
to tag both sides of every flow by IP: pods, service ClusterIPs,
endpoints, nodes and subnets. No Kubernetes client library: raw HTTP
against the apiserver with the pod's service-account token, one
``_ResourceLoop`` per kind (pods; services, endpoints and nodes when a
``ResourceIndex`` is given), each a list then a watch that resumes from
its ``resourceVersion``, with a bounded backoff (1 s doubling to 30 s)
after an error and a relist after an expired version. A relist is
authoritative: it evicts what it no longer reports from the index and,
through ``ResourceRecorder.reconcile``, emits the deletions the watch
missed. ``_workload_of`` names a pod's owner: its ReplicaSet's
Deployment, or its StatefulSet, DaemonSet or Job.

``in_cluster_config`` (the pod's service-account token and CA) and
``build_api_context`` (a TLS context that verifies, or skips
verification only when told to, with a warning) live here, as in the
reference; the lease election (``server/election.py``) imports them.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import urllib.request

from deepflow_tpu_torch.server.platform_info import (
    NodeInfo, PodInfo, PodIpIndex, ResourceIndex, ServiceInfo)

log = logging.getLogger("df.genesis")

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_config() -> tuple[str, str, str] | None:
    """(api_base, token, ca_path) from the pod environment, or None."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = os.path.join(_SA_DIR, "token")
    if not host or not os.path.exists(token_path):
        return None
    with open(token_path) as f:
        token = f.read().strip()
    ca = os.path.join(_SA_DIR, "ca.crt")
    return (f"https://{host}:{port}", token,
            ca if os.path.exists(ca) else "")


def build_api_context(api_base: str, ca_path: str = "",
                      insecure_skip_verify: bool = False):
    """Shared apiserver TLS context policy (genesis + lease election):
    verified CA, or EXPLICIT opt-out with a loud warning — never silent
    unverified TLS under a bearer token."""
    if not api_base.startswith("https"):
        return None
    if ca_path:
        return ssl.create_default_context(cafile=ca_path)
    if insecure_skip_verify:
        log.warning("k8s api: TLS verification DISABLED "
                    "(insecure_skip_verify)")
        return ssl._create_unverified_context()
    raise ValueError("https api_base needs ca_path "
                     "(or explicit insecure_skip_verify=True)")


class _ResourceLoop:
    """One list+watch loop for one resource kind. `apply(etype, obj,
    emit_events)` returns the reconcile keys the object contributes;
    `reconcile(seen)` evicts keys a relist no longer reports (a relist is
    authoritative, not additive)."""

    def __init__(self, genesis: "K8sGenesis", path: str, count_key: str,
                 apply, reconcile) -> None:
        self.g = genesis
        self.path = path
        self.count_key = count_key
        self.apply = apply
        self.reconcile = reconcile
        self.resource_version = ""
        self._thread: threading.Thread | None = None

    def list_once(self) -> int:
        n = 0
        cont = ""
        seen: set = set()
        while True:
            path = f"{self.path}?limit=500"
            if cont:
                path += f"&continue={cont}"
            with self.g._open(path, timeout=30) as r:
                data = json.load(r)
            for item in data.get("items", []):
                # relist reconciles STATE; it must not re-emit
                # resource-added events for survivors of a watch gap
                keys = self.apply("ADDED", item, emit_events=False)
                if keys:
                    seen.update(keys)
                n += 1
            meta = data.get("metadata", {})
            self.resource_version = meta.get("resourceVersion",
                                             self.resource_version)
            cont = meta.get("continue", "")
            if not cont:
                break
        self.reconcile(seen)
        self.g.stats[self.count_key] = n
        return n

    def watch_once(self) -> None:
        path = (f"{self.path}?watch=1&allowWatchBookmarks=true"
                f"&timeoutSeconds={self.g.watch_timeout_s}")
        if self.resource_version:
            path += f"&resourceVersion={self.resource_version}"
        with self.g._open(path, timeout=self.g.watch_timeout_s + 30) as r:
            for line in r:
                if self.g._stop.is_set():
                    return
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                etype = ev.get("type", "")
                obj = ev.get("object", {})
                rv = obj.get("metadata", {}).get("resourceVersion")
                if rv:
                    self.resource_version = rv
                if etype == "BOOKMARK":
                    continue
                if etype == "ERROR":
                    # expired resourceVersion: force a relist
                    self.resource_version = ""
                    return
                self.apply(etype, obj, True)
                self.g.stats["events"] += 1

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"df-k8s-{self.count_key}", daemon=True)
        self._thread.start()

    def join(self, timeout: float) -> None:
        if self._thread:
            self._thread.join(timeout=timeout)

    def _run(self) -> None:
        backoff = 1.0
        # a watch legitimately blocks up to watch_timeout_s between
        # beats — declare it so the deadman widens this stage's window
        hb = self.g.telemetry.heartbeat(
            f"genesis.{self.count_key}",
            interval_hint_s=float(self.g.watch_timeout_s))
        while not self.g._stop.is_set():
            hb.beat(progress=self.g.stats["events"])
            try:
                if not self.resource_version:
                    self.list_once()
                    self.g.stats["relists"] += 1
                self.watch_once()
                backoff = 1.0
            except Exception as e:
                self.g.stats["errors"] += 1
                # first failure (and every 50th) at WARNING: an RBAC/token
                # problem must be operator-visible, not debug-only
                if self.g.stats["errors"] == 1 or \
                        self.g.stats["errors"] % 50 == 0:
                    log.warning("genesis %s watch error (#%d): %s",
                                self.count_key, self.g.stats["errors"], e)
                else:
                    log.debug("genesis %s watch error: %s",
                              self.count_key, e)
                if self.g._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 30.0)


class K8sGenesis:
    """Pod (+ Service/Endpoints/Node when a ResourceIndex is attached)
    list-watch -> platform tables."""

    def __init__(self, pod_index: PodIpIndex, api_base: str | None = None,
                 token: str = "", ca_path: str = "",
                 watch_timeout_s: int = 300,
                 insecure_skip_verify: bool = False,
                 event_sink=None,
                 resources: ResourceIndex | None = None,
                 telemetry=None) -> None:
        # event_sink(rows) receives resource-change events through the
        # snapshot-diff recorder (reference: controller/recorder resource
        # diffs -> event tables): added/deleted AND attribute-level
        # modified events with before/after payloads
        from deepflow_tpu_torch.server.recorder import ResourceRecorder
        self.event_sink = event_sink
        self.recorder = ResourceRecorder(event_sink)
        self._workload_pods: dict[str, set] = {}
        if api_base is None:
            cfg = in_cluster_config()
            if cfg is None:
                raise RuntimeError("not in a cluster and no api_base given")
            api_base, token, ca_path = cfg
        self.api_base = api_base.rstrip("/")
        self.token = token
        self.watch_timeout_s = watch_timeout_s
        self.pod_index = pod_index
        self.resources = resources
        self._ctx = build_api_context(self.api_base, ca_path,
                                      insecure_skip_verify)
        self._stop = threading.Event()
        if telemetry is None:
            from deepflow_tpu_torch.telemetry import Telemetry
            telemetry = Telemetry("server", enabled=False)
        self.telemetry = telemetry
        self.stats = {"pods": 0, "events": 0, "relists": 0, "errors": 0,
                      "services": 0, "endpoints": 0, "nodes": 0}
        self._loops = [_ResourceLoop(
            self, "/api/v1/pods", "pods", self._apply,
            self._retain_pods)]
        if resources is not None:
            self._loops += [
                _ResourceLoop(self, "/api/v1/services", "services",
                              self._apply_service, self._retain_services),
                _ResourceLoop(self, "/api/v1/endpoints", "endpoints",
                              self._apply_endpoints,
                              resources.retain_endpoints),
                _ResourceLoop(self, "/api/v1/nodes", "nodes",
                              self._apply_node, self._retain_nodes),
            ]

    # -- relist reconciliation (state AND recorder) ---------------------------

    def _retain_pods(self, seen: set) -> None:
        # split the mixed reconcile set _apply returns: plain strings are
        # pod IPs, ("__pod__", key) tuples are live pod identities
        # (IP-less Pending pods appear ONLY as the latter)
        ips = {k for k in seen if isinstance(k, str)}
        live = {k[1] for k in seen if isinstance(k, tuple)}
        self.pod_index.retain_ips(ips)
        # objects that vanished during a watch gap get their deleted
        # events here — the relist is authoritative
        self.recorder.reconcile("pod", live)
        live_w: dict[str, set] = {}
        for wkey, members in self._workload_pods.items():
            kept = members & live
            if kept:
                live_w[wkey] = kept
        self._workload_pods = live_w
        self.recorder.reconcile("workload", set(live_w))

    def _retain_services(self, keys: set) -> None:
        self.resources.retain_services(keys)
        self.recorder.reconcile("service",
                                {f"{ns}/{n}" for ns, n in keys})

    def _retain_nodes(self, names: set) -> None:
        self.resources.retain_nodes(names)
        self.recorder.reconcile("node", set(names))

    # back-compat: tests poke gen.resource_version to force relists
    @property
    def resource_version(self) -> str:
        return self._loops[0].resource_version

    @resource_version.setter
    def resource_version(self, v: str) -> None:
        self._loops[0].resource_version = v

    # -- http -----------------------------------------------------------------

    def _open(self, path: str, timeout: float):
        req = urllib.request.Request(self.api_base + path)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(req, timeout=timeout,
                                      context=self._ctx)

    # -- pods ------------------------------------------------------------------

    @staticmethod
    def _workload_of(pod: dict) -> str:
        for ref in pod.get("metadata", {}).get("ownerReferences", []):
            name = ref.get("name", "")
            if ref.get("kind") == "ReplicaSet":
                # strip the replicaset hash -> deployment name
                return name.rsplit("-", 1)[0] if "-" in name else name
            if ref.get("kind") in ("StatefulSet", "DaemonSet", "Job"):
                return name
        return ""

    def _apply(self, event_type: str, pod: dict,
               emit_events: bool = True) -> set:
        meta = pod.get("metadata", {})
        status = pod.get("status", {})
        ips = [e.get("ip") for e in status.get("podIPs", [])
               if e.get("ip")]
        if not ips and status.get("podIP"):
            ips = [status["podIP"]]
        info = PodInfo(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            node=pod.get("spec", {}).get("nodeName", ""),
            workload=self._workload_of(pod),
            labels=meta.get("labels", {}) or {},
        )
        key = f"{info.namespace}/{info.name}"
        deleted = event_type == "DELETED"
        if deleted:
            for ip in ips:
                self.pod_index.remove_ip(ip)
        else:  # ADDED | MODIFIED
            for ip in ips:
                self.pod_index.upsert(ip, info)
        self.recorder.observe(
            "pod", key,
            None if deleted else {"node": info.node,
                                  "workload": info.workload,
                                  "ips": sorted(ips)},
            deleted=deleted, emit=emit_events)
        # derived workload lifecycle (reference records pod_group state):
        # first pod of a workload -> workload-added; last gone -> deleted
        if info.workload:
            wkey = f"{info.namespace}/{info.workload}"
            members = self._workload_pods.setdefault(wkey, set())
            if deleted:
                members.discard(key)
                if not members:
                    self._workload_pods.pop(wkey, None)
                    self.recorder.observe("workload", wkey, None,
                                          deleted=True, emit=emit_events)
            else:
                members.add(key)
                self.recorder.observe(
                    "workload", wkey, {"namespace": info.namespace},
                    emit=emit_events)
        # reconcile keys: the pod's IPs (pod_index retention) plus a
        # name marker — a Pending pod has NO ip yet but is still alive,
        # and the recorder's relist reconcile must not declare it dead
        return set(ips) | {("__pod__", key)}

    # -- services / endpoints / nodes -----------------------------------------

    def _apply_service(self, event_type: str, obj: dict,
                       emit_events: bool = True) -> set:
        meta = obj.get("metadata", {})
        spec = obj.get("spec", {})
        ns, name = meta.get("namespace", ""), meta.get("name", "")
        # defensive: ignore non-Service shapes (shared fake servers)
        if not name or ("clusterIP" not in spec and "ports" not in spec):
            return set()
        deleted = event_type == "DELETED"
        ports = tuple(p.get("port") for p in spec.get("ports", [])
                      if p.get("port"))
        if deleted:
            self.resources.remove_service(ns, name)
        else:
            self.resources.upsert_service(ServiceInfo(
                name=name, namespace=ns,
                cluster_ip=spec.get("clusterIP", "") or "",
                svc_type=spec.get("type", "ClusterIP"),
                ports=ports))
        self.recorder.observe(
            "service", f"{ns}/{name}",
            None if deleted else {
                "cluster_ip": spec.get("clusterIP", "") or "",
                "type": spec.get("type", "ClusterIP"),
                "ports": sorted(ports)},
            deleted=deleted, emit=emit_events)
        return {(ns, name)}

    def _apply_endpoints(self, event_type: str, obj: dict,
                         emit_events: bool = True) -> set:
        meta = obj.get("metadata", {})
        ns, name = meta.get("namespace", ""), meta.get("name", "")
        # K8s serializes subsets with omitempty: a service scaled to zero
        # arrives WITHOUT the key and must clear its stale pod-ip mappings.
        # Only objects that are clearly another kind (pods have spec/status;
        # Endpoints never do) are skipped.
        if not name or ("subsets" not in obj
                        and ("spec" in obj or "status" in obj)):
            return set()
        if event_type == "DELETED":
            self.resources.set_endpoints(ns, name, ())
            return set()
        ips = [a.get("ip")
               for s in (obj.get("subsets") or [])
               for a in (s.get("addresses") or [])
               if a.get("ip")]
        self.resources.set_endpoints(ns, name, ips)
        return {(ns, name)}

    def _apply_node(self, event_type: str, obj: dict,
                    emit_events: bool = True) -> set:
        meta = obj.get("metadata", {})
        name = meta.get("name", "")
        status = obj.get("status", {})
        if not name or "addresses" not in status:
            return set()
        if event_type == "DELETED":
            self.resources.remove_node(name)
            self.recorder.observe("node", name, None, deleted=True,
                                  emit=emit_events)
            return set()
        labels = meta.get("labels", {}) or {}
        spec = obj.get("spec", {})
        internal = ""
        for a in status.get("addresses") or []:
            if a.get("type") == "InternalIP":
                internal = a.get("address", "")
                break
        cidrs = spec.get("podCIDRs") or \
            ([spec["podCIDR"]] if spec.get("podCIDR") else [])
        node = NodeInfo(
            name=name,
            az=labels.get("topology.kubernetes.io/zone", ""),
            region=labels.get("topology.kubernetes.io/region", ""),
            internal_ip=internal, pod_cidrs=tuple(cidrs))
        self.resources.upsert_node(node)
        # node readiness is the attr ops ask about first ("did the node
        # go NotReady right before the regression?")
        ready = ""
        for cond in status.get("conditions") or []:
            if cond.get("type") == "Ready":
                ready = cond.get("status", "")
                break
        self.recorder.observe(
            "node", name,
            {"az": node.az, "region": node.region,
             "internal_ip": internal, "pod_cidrs": sorted(cidrs),
             "ready": ready},
            emit=emit_events)
        return {name}

    # -- back-compat single-loop entry points (tests drive these) -------------

    def list_once(self) -> int:
        return self._loops[0].list_once()

    def watch_once(self) -> None:
        self._loops[0].watch_once()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "K8sGenesis":
        for loop in self._loops:
            loop.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for loop in self._loops:
            loop.join(timeout=3.0)
