"""Agent id -> universal tags and clock offsets for ingest.

Own copy of ``deepflow_tpu/server/platform_info.py``, whole:

- ``AgentInfo`` and ``PlatformInfoTable``: the registry the controller
  (or a test, through ``update``) fills with each agent's platform data,
  read per frame to inject the universal tags. An unregistered agent's
  rows carry its agent_id in the default org; a registered one's also
  carry its host, pod and topology tags (``tpu_pod`` is the job,
  ``slice_id`` the group of hosts), so the stitcher host-qualifies its
  participants. Host ids are allocated on first registration and kept
  across re-registrations.
- The cluster's resource model that K8s genesis (``server/genesis.py``)
  keeps: ``PodInfo`` and the ``PodIpIndex`` (pod by IP, with a version
  that every change bumps), ``ServiceInfo``, ``NodeInfo``, and the
  ``ResourceIndex`` that resolves an IP to the ``EndpointTags`` the
  decoders write on each side of a flow or metric row: the pod, its
  namespace, workload, node and service, a ClusterIP's service, a node's
  IP, and the subnet by longest prefix over the nodes' pod CIDRs
  (reference analog: server/libs/grpc/grpc_platformdata.go:292).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class AgentInfo:
    agent_id: int
    host: str = ""
    host_id: int = 0
    pod_name: str = ""
    pod_ns: str = ""
    tpu_pod: str = ""
    tpu_worker: int = 0
    slice_id: int = 0
    org_id: int = 1   # multi-tenancy scope; 1 = default org

    def tags(self) -> dict:
        return {
            "org_id": self.org_id,
            "agent_id": self.agent_id,
            "host_id": self.host_id,
            "host": self.host,
            "pod_name": self.pod_name,
            "pod_ns": self.pod_ns,
            "tpu_pod": self.tpu_pod,
            "tpu_worker": self.tpu_worker,
            "slice_id": self.slice_id,
        }


_EMPTY = AgentInfo(agent_id=0)


class PlatformInfoTable:
    """Thread-safe agent registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._agents: dict[int, AgentInfo] = {}
        self._next_host_id = 1
        # measured per-agent clock skew against the server's clock; kept
        # apart from AgentInfo so a re-registration does not clobber it
        self._clock_offsets: dict[int, int] = {}

    def update(self, info: AgentInfo) -> None:
        with self._lock:
            prev = self._agents.get(info.agent_id)
            if info.host_id == 0:
                info.host_id = (prev.host_id if prev
                                else self._alloc_host_id_locked())
            self._agents[info.agent_id] = info

    def _alloc_host_id_locked(self) -> int:
        hid = self._next_host_id
        self._next_host_id += 1
        return hid

    def query(self, agent_id: int) -> AgentInfo:
        with self._lock:
            return self._agents.get(agent_id, _EMPTY)

    def tags_for(self, agent_id: int) -> dict:
        info = self.query(agent_id)
        if info is _EMPTY:
            # unknown agents land in the default org
            return {"agent_id": agent_id, "org_id": 1}
        return info.tags()

    def set_clock_offset(self, agent_id: int, offset_ns: int) -> None:
        with self._lock:
            self._clock_offsets[agent_id] = int(offset_ns)

    def offset_for(self, agent_id: int) -> int:
        """ns to ADD to this agent's absolute timestamps to land on the
        server's clock (the decoders normalize at ingest)."""
        with self._lock:
            return self._clock_offsets.get(agent_id, 0)


@dataclass
class PodInfo:
    """One K8s workload endpoint (genesis resource model entry)."""
    name: str
    namespace: str = ""
    node: str = ""
    workload: str = ""  # owning deployment/statefulset/daemonset name
    labels: dict = field(default_factory=dict)


class PodIpIndex:
    """IP -> pod resource map fed by K8s genesis; queried per flow row to
    tag BOTH sides of a connection (reference: genesis -> recorder ->
    grpc_platformdata IP lookups)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_ip: dict[str, PodInfo] = {}
        self.version = 0

    def upsert(self, ip: str, pod: PodInfo) -> None:
        if not ip:
            return
        with self._lock:
            self._by_ip[ip] = pod
            self.version += 1

    def remove_ip(self, ip: str) -> None:
        with self._lock:
            if self._by_ip.pop(ip, None) is not None:
                self.version += 1

    def retain_ips(self, ips: set) -> int:
        """Evict entries outside `ips` (relist reconciliation). Returns
        the number removed."""
        with self._lock:
            dead = [ip for ip in self._by_ip if ip not in ips]
            for ip in dead:
                del self._by_ip[ip]
            if dead:
                self.version += 1
            return len(dead)

    def lookup(self, ip: str) -> PodInfo | None:
        with self._lock:
            return self._by_ip.get(ip)

    def snapshot(self) -> dict:
        """Reference to the current mapping for batch POINT reads (.get)
        only — iteration over this dict races writers; use items_copy()
        to iterate. Writers always replace values, never mutate them."""
        return self._by_ip

    def items_copy(self) -> list:
        """Locked copy for safe iteration (PodMap serving etc.)."""
        with self._lock:
            return list(self._by_ip.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_ip)


@dataclass
class ServiceInfo:
    """One K8s Service (genesis resource model entry)."""
    name: str
    namespace: str = ""
    cluster_ip: str = ""
    svc_type: str = ""          # ClusterIP / NodePort / LoadBalancer
    ports: tuple = ()           # (port, ...) for catalog introspection


@dataclass
class NodeInfo:
    """One K8s Node: identity + the topology tags universal tagging needs
    (reference: controller/tagrecorder ch_az / ch_subnet catalogs are fed
    from node+cloud metadata; here the node object is the source)."""
    name: str
    az: str = ""                # topology.kubernetes.io/zone
    region: str = ""            # topology.kubernetes.io/region
    internal_ip: str = ""
    pod_cidrs: tuple = ()       # spec.podCIDRs


@dataclass(frozen=True)
class EndpointTags:
    """Resolution result for one IP — the per-side universal tag set
    injected into every flow/metric row (reference analog:
    server/libs/grpc/grpc_platformdata.go:292 QueryIPV4Infos -> Info)."""
    resource_type: str = ""     # pod | service | node | ''
    pod: str = ""
    pod_ns: str = ""
    workload: str = ""          # owning deployment/statefulset (pod_group)
    node: str = ""
    service: str = ""
    az: str = ""
    subnet: str = ""


_EMPTY_TAGS = EndpointTags()


def _cidr_key(cidr: str):
    """(net_int, prefix_len) for a v4 CIDR, or None."""
    import ipaddress
    try:
        net = ipaddress.ip_network(cidr, strict=False)
    except ValueError:
        return None
    if net.version != 4:
        return None
    return int(net.network_address), net.prefixlen


class ResourceIndex:
    """IP-keyed cluster resource model: ip -> EndpointTags covering pods,
    service ClusterIPs, nodes, and subnet attribution by longest-prefix
    match over node podCIDRs.

    Reference analog: the PlatformInfoTable IP queries
    (server/libs/grpc/grpc_platformdata.go:147,:292,:376) backed by the
    tagrecorder ch_* dictionaries (controller/tagrecorder/const.go:66).
    Epoch-versioned: every mutation bumps `version` so consumers (PodMap
    serving, caches) can detect staleness cheaply.
    """

    def __init__(self, pod_index: PodIpIndex | None = None) -> None:
        self.pod_index = pod_index if pod_index is not None else PodIpIndex()
        self._lock = threading.Lock()
        self._svc_by_cluster_ip: dict[str, ServiceInfo] = {}
        self._svc_by_key: dict[tuple, ServiceInfo] = {}   # (ns, name)
        self._eps_by_svc: dict[tuple, frozenset] = {}     # (ns,name)->pod ips
        self._svc_by_pod_ip: dict[str, tuple] = {}        # ip -> (ns, name)
        self._node_by_name: dict[str, NodeInfo] = {}
        self._node_by_ip: dict[str, NodeInfo] = {}
        # sorted longest-prefix-first [(net_int, prefixlen, cidr_str)]
        self._subnets: list[tuple] = []
        self.version = 0

    # -- services -------------------------------------------------------------

    def upsert_service(self, svc: ServiceInfo) -> None:
        key = (svc.namespace, svc.name)
        with self._lock:
            prev = self._svc_by_key.get(key)
            if prev is not None and prev.cluster_ip and \
                    prev.cluster_ip != svc.cluster_ip:
                self._svc_by_cluster_ip.pop(prev.cluster_ip, None)
            self._svc_by_key[key] = svc
            if svc.cluster_ip and svc.cluster_ip.lower() != "none":
                self._svc_by_cluster_ip[svc.cluster_ip] = svc
            self.version += 1

    def remove_service(self, namespace: str, name: str) -> None:
        key = (namespace, name)
        with self._lock:
            svc = self._svc_by_key.pop(key, None)
            if svc is not None and svc.cluster_ip:
                self._svc_by_cluster_ip.pop(svc.cluster_ip, None)
            if self._eps_by_svc.pop(key, None):
                self._rebuild_pod_ip_map_locked()
            self.version += 1

    def retain_services(self, keys: set) -> None:
        with self._lock:
            dead = [k for k in self._svc_by_key if k not in keys]
            for k in dead:
                svc = self._svc_by_key.pop(k)
                if svc.cluster_ip:
                    self._svc_by_cluster_ip.pop(svc.cluster_ip, None)
            if dead:
                self.version += 1

    # -- endpoints ------------------------------------------------------------

    def set_endpoints(self, namespace: str, name: str, pod_ips) -> None:
        """Replace the backing-pod IP set for one service."""
        key = (namespace, name)
        ips = frozenset(pod_ips)
        with self._lock:
            if self._eps_by_svc.get(key) == ips:
                return
            if ips:
                self._eps_by_svc[key] = ips
            else:
                self._eps_by_svc.pop(key, None)
            self._rebuild_pod_ip_map_locked()
            self.version += 1

    def retain_endpoints(self, keys: set) -> None:
        with self._lock:
            dead = [k for k in self._eps_by_svc if k not in keys]
            for k in dead:
                del self._eps_by_svc[k]
            if dead:
                self._rebuild_pod_ip_map_locked()
                self.version += 1

    def _rebuild_pod_ip_map_locked(self) -> None:
        m: dict[str, tuple] = {}
        for key, ips in self._eps_by_svc.items():
            for ip in ips:
                m[ip] = key
        self._svc_by_pod_ip = m

    # -- nodes ----------------------------------------------------------------

    def upsert_node(self, node: NodeInfo) -> None:
        with self._lock:
            prev = self._node_by_name.get(node.name)
            if prev is not None and prev.internal_ip and \
                    prev.internal_ip != node.internal_ip:
                self._node_by_ip.pop(prev.internal_ip, None)
            self._node_by_name[node.name] = node
            if node.internal_ip:
                self._node_by_ip[node.internal_ip] = node
            self._rebuild_subnets_locked()
            self.version += 1

    def remove_node(self, name: str) -> None:
        with self._lock:
            node = self._node_by_name.pop(name, None)
            if node is not None:
                if node.internal_ip:
                    self._node_by_ip.pop(node.internal_ip, None)
                self._rebuild_subnets_locked()
            self.version += 1

    def retain_nodes(self, names: set) -> None:
        with self._lock:
            dead = [n for n in self._node_by_name if n not in names]
            for n in dead:
                node = self._node_by_name.pop(n)
                if node.internal_ip:
                    self._node_by_ip.pop(node.internal_ip, None)
            if dead:
                self._rebuild_subnets_locked()
                self.version += 1

    def _rebuild_subnets_locked(self) -> None:
        subnets = []
        for node in self._node_by_name.values():
            for cidr in node.pod_cidrs:
                key = _cidr_key(cidr)
                if key is not None:
                    subnets.append((key[0], key[1], cidr))
        subnets.sort(key=lambda t: -t[1])   # longest prefix first
        self._subnets = subnets

    def _subnet_of_locked(self, ip: str) -> str:
        if not self._subnets or "." not in ip:
            return ""
        try:
            parts = ip.split(".")
            ip_int = (int(parts[0]) << 24) | (int(parts[1]) << 16) | \
                     (int(parts[2]) << 8) | int(parts[3])
        except (ValueError, IndexError):
            return ""
        for net, plen, cidr in self._subnets:
            if (ip_int >> (32 - plen)) << (32 - plen) == net:
                return cidr
        return ""

    # -- resolution -----------------------------------------------------------

    def resolve(self, ip: str) -> EndpointTags:
        pod = self.pod_index.lookup(ip)
        with self._lock:
            subnet = self._subnet_of_locked(ip)
            if pod is not None:
                svc_key = self._svc_by_pod_ip.get(ip)
                node = self._node_by_name.get(pod.node)
                return EndpointTags(
                    resource_type="pod", pod=pod.name, pod_ns=pod.namespace,
                    workload=pod.workload, node=pod.node,
                    service=svc_key[1] if svc_key else "",
                    az=node.az if node else "", subnet=subnet)
            svc = self._svc_by_cluster_ip.get(ip)
            if svc is not None:
                return EndpointTags(resource_type="service",
                                    pod_ns=svc.namespace, service=svc.name,
                                    subnet=subnet)
            node = self._node_by_ip.get(ip)
            if node is not None:
                return EndpointTags(resource_type="node", node=node.name,
                                    az=node.az, subnet=subnet)
            return EndpointTags(subnet=subnet) if subnet else _EMPTY_TAGS

    def is_empty(self) -> bool:
        """True when no resource can resolve to anything — decoders then
        skip per-row resolution entirely (the common standalone case)."""
        with self._lock:
            has_any = (self._svc_by_key or self._node_by_name
                       or self._subnets)
        return not has_any and len(self.pod_index) == 0

    def batch_resolver(self):
        """Per-batch memoized resolve: decoders call this once per batch so
        repeated IPs cost one dict hit, not a lock round-trip."""
        cache: dict[str, EndpointTags] = {}

        def resolve(ip: str) -> EndpointTags:
            t = cache.get(ip)
            if t is None:
                t = self.resolve(ip)
                cache[ip] = t
            return t
        return resolve

    # -- introspection (catalog / dfctl) --------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "pods": len(self.pod_index),
                "services": len(self._svc_by_key),
                "endpoints": len(self._eps_by_svc),
                "nodes": len(self._node_by_name),
                "subnets": len(self._subnets),
                "version": self.version + self.pod_index.version,
            }

    def services_copy(self) -> list:
        with self._lock:
            return list(self._svc_by_key.values())

    def nodes_copy(self) -> list:
        with self._lock:
            return list(self._node_by_name.values())
