"""Resource recorder: the cluster's resource changes as events with
their attributes before and after.

Own copy of ``deepflow_tpu/server/recorder.py``, whole (reference analog:
controller/recorder/, the cache and updaters that diff resource
snapshots into change events). One attribute-diff engine keyed by
(resource type, key): genesis's watch streams feed it, and each diff
lands in ``event.event`` with a JSON ``attrs`` payload.

A resync or relist re-ADD of an identical object is no event; an
attribute change, whatever the watch event's type, is one
``<type>-modified`` event carrying {attr: {before, after}} for exactly
the attributes that changed; ``<type>-added`` and ``<type>-deleted``
carry the whole attributes. ``reconcile`` after a relist emits the
deletions of the objects that vanished while the watch was down.
"""

from __future__ import annotations

import json
import logging
import threading
import time

log = logging.getLogger("df.recorder")


class ResourceRecorder:
    """Attr-diff engine over the live resource snapshot."""

    MAX_TRACKED = 200_000  # runaway-churn guard

    def __init__(self, sink=None) -> None:
        self.sink = sink  # sink(rows: list[dict]) -> None
        self._snap: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        self.stats = {"added": 0, "modified": 0, "deleted": 0,
                      "suppressed": 0}

    def _emit(self, rtype: str, key: str, verb: str, attrs_payload: dict,
              description: str) -> None:
        self.stats[verb] += 1
        if self.sink is None:
            return
        try:
            self.sink([{
                "time": time.time_ns(),
                "event_type": f"{rtype}-{verb}",
                "resource_type": rtype,
                "resource_name": key,
                "description": description,
                "attrs": json.dumps(attrs_payload, sort_keys=True),
            }])
        except Exception:
            log.debug("recorder sink failed", exc_info=True)

    @staticmethod
    def _describe(attrs: dict) -> str:
        parts = []
        for k, v in sorted(attrs.items()):
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            elif isinstance(v, dict):
                continue
            parts.append(f"{k}={v}")
        return " ".join(parts)

    def observe(self, rtype: str, key: str, attrs: dict | None,
                deleted: bool = False, emit: bool = True) -> None:
        """Feed one observed object state. attrs None == deleted."""
        skey = (rtype, key)
        with self._lock:
            old = self._snap.get(skey)
            if deleted or attrs is None:
                if old is None:
                    return  # deleting the unknown: nothing to report
                del self._snap[skey]
                if emit:
                    self._emit(rtype, key, "deleted", {"before": old},
                               self._describe(old))
                else:
                    self.stats["suppressed"] += 1
                return
            if len(self._snap) >= self.MAX_TRACKED and old is None:
                return
            self._snap[skey] = attrs
            if old is None:
                if emit:
                    self._emit(rtype, key, "added", {"after": attrs},
                               self._describe(attrs))
                else:
                    self.stats["suppressed"] += 1
            elif old != attrs:
                changed = {
                    k: {"before": old.get(k), "after": attrs.get(k)}
                    for k in set(old) | set(attrs)
                    if old.get(k) != attrs.get(k)}
                # modified events ALWAYS emit, emit flag notwithstanding:
                # emit=False marks resync/relist observations, and an
                # attr change discovered by a recovery relist (the watch
                # was down when it happened) is exactly the change the
                # forensics timeline must not lose
                self._emit(
                    rtype, key, "modified", {"changed": changed},
                    " ".join(f"{k}: {v['before']}->{v['after']}"
                             for k, v in sorted(changed.items())))

    def reconcile(self, rtype: str, live_keys: set, emit: bool = True
                  ) -> int:
        """A relist is authoritative: tracked objects of `rtype` missing
        from live_keys were deleted during a watch gap — emit their
        deleted events (with last-known attrs) and drop them."""
        dropped = 0
        with self._lock:
            for skey in [s for s in self._snap
                         if s[0] == rtype and s[1] not in live_keys]:
                old = self._snap.pop(skey)
                dropped += 1
                if emit:
                    self._emit(rtype, skey[1], "deleted", {"before": old},
                               self._describe(old))
        return dropped

    def snapshot_keys(self, rtype: str) -> list[str]:
        with self._lock:
            return [k for (t, k) in self._snap if t == rtype]
