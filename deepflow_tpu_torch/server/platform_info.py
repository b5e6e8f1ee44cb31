"""Agent id -> universal tags and clock offsets for ingest.

Own copy of ``deepflow_tpu/server/platform_info.py``'s ``AgentInfo`` and
``PlatformInfoTable``: the registry the controller (or a test, through
``update``) fills with each agent's platform data, read per frame to
inject the universal tags. An unregistered agent's rows carry its
agent_id in the default org; a registered one's also carry its host, pod
and topology tags (``tpu_pod`` is the job, ``slice_id`` the group of
hosts), so the stitcher host-qualifies its participants. Host ids are
allocated on first registration and kept across re-registrations.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


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
