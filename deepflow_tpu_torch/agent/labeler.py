"""The agent's labeler: a flow's endpoints -> pod labels, and its ACL
action.

Own copy of ``deepflow_tpu/agent/labeler.py``, whole, with the PodMap
rule of the reference's synchronizer (``agent/synchronizer.py:228-250``)
as ``update_pod_map`` and the config's ACL helpers (``acl_rules``,
``has_packet_acls``) beside it (reference analog:
agent/src/policy/first_path.rs and fast_path.rs). ``IpTrie`` is a
longest-prefix bit trie for IPv4 (exact hosts for IPv6), loaded from the
controller's PodMap (``update_pod_map``: the entries replace the trie
unless the map is the one held; an empty map with a newer version still
applies, the cluster's pods being gone). ``label_flow`` answers
(source label, destination label, action) from a per-5-tuple LRU of
``FAST_PATH_CAP`` entries, and on a miss walks the trie and the ACLs in
order (``AclRule``: a CIDR matching either side, a port either side, a
protocol; the first match's action, else ``trace``). Actions: ``trace``,
``ignore`` (the flow's L4 log, L7 logs and documents are dropped,
counted in ``ignored_flows``), ``pcap`` and ``npb`` (traced, and its
packets captured or forwarded: ``agent/packet_actions.py``). Loading
resources or ACLs clears the LRU.
"""

from __future__ import annotations

import ipaddress
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

log = logging.getLogger("df.labeler")


@dataclass(frozen=True)
class ResourceLabel:
    pod: str = ""
    namespace: str = ""
    workload: str = ""
    node: str = ""


@dataclass
class AclRule:
    """First-path rule. Empty fields match anything."""
    cidr: str = ""               # matches either endpoint
    port: int = 0                # matches either port
    protocol: int = 0            # 1 tcp / 2 udp / 3 icmp
    action: str = "trace"        # trace | ignore
    _net: object = field(default=None, repr=False)

    def net(self):
        if self._net is None and self.cidr:
            self._net = ipaddress.ip_network(self.cidr, strict=False)
        return self._net


class IpTrie:
    """Longest-prefix match for v4 (bit trie) + exact-host table for v6."""

    def __init__(self) -> None:
        self._root: list = [None, None, None]  # [child0, child1, value]
        self._v6: dict[bytes, object] = {}

    def insert(self, cidr: str, value) -> None:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version == 6:
            # fleet v6 is host-addressed; prefix support can follow need
            self._v6[net.network_address.packed] = value
            return
        bits = int(net.network_address)
        node = self._root
        for i in range(net.prefixlen):
            b = (bits >> (31 - i)) & 1
            if node[b] is None:
                node[b] = [None, None, None]
            node = node[b]
        node[2] = value

    def lookup(self, ip: bytes):
        """Longest-prefix value for a packed address, or None."""
        if len(ip) == 16:
            return self._v6.get(ip)
        if len(ip) != 4:
            return None
        bits = int.from_bytes(ip, "big")
        node = self._root
        best = node[2]
        for i in range(32):
            node = node[(bits >> (31 - i)) & 1]
            if node is None:
                break
            if node[2] is not None:
                best = node[2]
        return best


class Labeler:
    """first_path (trie + ACL scan) with a fast_path LRU over flow tuples."""

    FAST_PATH_CAP = 1 << 16

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._trie = IpTrie()
        self._acls: list[AclRule] = []
        self._fast: OrderedDict[tuple, tuple] = OrderedDict()
        self.version = 0
        self.epoch = 0
        self.acl_version = 0
        self.stats = {"first_path": 0, "fast_path": 0, "resources": 0,
                      "ignored_flows": 0}

    # -- feed (platform push / config) ----------------------------------------

    def load_resources(self, entries, version: int = 0) -> None:
        """entries: iterable of (cidr, ResourceLabel). Replaces the trie."""
        trie = IpTrie()
        n = 0
        for cidr, label in entries:
            trie.insert(cidr, label)
            n += 1
        with self._lock:
            self._trie = trie
            self._fast.clear()  # labels changed: cached verdicts are stale
            self.version = version
            self.stats["resources"] = n

    def update_pod_map(self, resp) -> bool:
        """A controller's PodMapResponse into the trie: False when it is
        the map already held (same version and epoch); an empty map with
        a newer version applies (the cluster's pods are gone)."""
        if resp.version == self.version and resp.epoch == self.epoch:
            return False
        self.load_resources(
            ((e.cidr, ResourceLabel(pod=e.pod, namespace=e.namespace,
                                    workload=e.workload, node=e.node))
             for e in resp.entries), version=resp.version)
        self.epoch = resp.epoch
        return True

    def load_acls(self, rules: list[AclRule]) -> None:
        ok = []
        for r in rules:
            try:
                r.net()  # pre-parse: a bad cidr must never reach the
                # flow hot path (the agent main() path skips validate())
            except ValueError as e:
                log.warning("dropping ACL with bad cidr %r: %s", r.cidr, e)
                continue
            ok.append(r)
        with self._lock:
            self._acls = ok
            self._fast.clear()
            self.acl_version += 1

    # -- lookup ----------------------------------------------------------------

    def label_flow(self, ip_src: bytes, ip_dst: bytes, port_src: int,
                   port_dst: int, protocol: int
                   ) -> tuple[ResourceLabel | None, ResourceLabel | None,
                              str]:
        """-> (src_label, dst_label, action)."""
        key = (ip_src, ip_dst, port_src, port_dst, protocol)
        with self._lock:
            hit = self._fast.get(key)
            if hit is not None:
                self._fast.move_to_end(key)
                self.stats["fast_path"] += 1
                return hit
            self.stats["first_path"] += 1
            src = self._trie.lookup(ip_src)
            dst = self._trie.lookup(ip_dst)
            action = self._acl_action_locked(ip_src, ip_dst, port_src,
                                             port_dst, protocol)
            verdict = (src, dst, action)
            self._fast[key] = verdict
            if len(self._fast) > self.FAST_PATH_CAP:
                self._fast.popitem(last=False)
            return verdict

    def _acl_action_locked(self, ip_src, ip_dst, port_src, port_dst,
                           protocol) -> str:
        for rule in self._acls:
            if rule.protocol and rule.protocol != protocol:
                continue
            if rule.port and rule.port not in (port_src, port_dst):
                continue
            if rule.cidr:
                net = rule.net()
                try:
                    a = ipaddress.ip_address(ip_src)
                    b = ipaddress.ip_address(ip_dst)
                except ValueError:
                    continue
                if a not in net and b not in net:
                    continue
            return rule.action
        return "trace"


def acl_rules(acls: list) -> list[AclRule]:
    """A config's ACL mappings (``AgentConfig.acls``) as rules."""
    return [AclRule(cidr=a.get("cidr", ""), port=int(a.get("port", 0)),
                    protocol=int(a.get("protocol", 0)),
                    action=a.get("action", "trace")) for a in acls]


def has_packet_acls(acls: list) -> bool:
    """Whether a config's ACLs capture or forward packets."""
    return any(a.get("action") in ("pcap", "npb") for a in acls)
