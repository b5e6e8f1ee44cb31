"""Agent id -> universal tags and clock offsets for ingest.

Own copy of the parts of ``deepflow_tpu/server/platform_info.py::
PlatformInfoTable`` that the profile ingest uses: with no platform data
registered, an agent's rows carry its agent_id in the default org.
"""

from __future__ import annotations

import threading


class PlatformInfoTable:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        # measured per-agent clock skew against the server's clock
        self._clock_offsets: dict[int, int] = {}

    def tags_for(self, agent_id: int) -> dict:
        # unknown agents land in the default org
        return {"agent_id": agent_id, "org_id": 1}

    def set_clock_offset(self, agent_id: int, offset_ns: int) -> None:
        with self._lock:
            self._clock_offsets[agent_id] = int(offset_ns)

    def offset_for(self, agent_id: int) -> int:
        """ns to ADD to this agent's absolute timestamps to land on the
        server's clock (the decoders normalize at ingest)."""
        with self._lock:
            return self._clock_offsets.get(agent_id, 0)
