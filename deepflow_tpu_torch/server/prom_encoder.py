"""Prometheus SmartEncoding: cluster-wide metric and label-set ids.

Own copy of the authoritative half of
``deepflow_tpu/server/prom_encoder.py``: ``PromEncoder`` hands out one
id per metric name and one per series label set (a canonical JSON
string), the same on every ingest node, and lives in the controller,
which serves it on the sync transport's ``PromEncode`` method. The
reference's ``GrpcPromEncoderClient`` (a remote ingest node's cached
view) is left out: its users are federation and the integrations
(ROADMAP Queue 1, items 12 and 13).
"""

from __future__ import annotations

import threading

from deepflow_tpu_torch.proto import wire


class PromEncoder:
    """The authoritative id allocator (controller-side)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metric_ids: dict[str, int] = {}
        self._set_ids: dict[str, int] = {}
        self._next_metric = 1
        self._next_set = 1

    def encode(self, metric_names: list[str],
               label_sets: list[str]) -> tuple[list[int], list[int]]:
        with self._lock:
            mids = []
            for name in metric_names:
                mid = self._metric_ids.get(name)
                if mid is None:
                    mid = self._metric_ids[name] = self._next_metric
                    self._next_metric += 1
                mids.append(mid)
            sids = []
            for ls in label_sets:
                sid = self._set_ids.get(ls)
                if sid is None:
                    sid = self._set_ids[ls] = self._next_set
                    self._next_set += 1
                sids.append(sid)
            return mids, sids

    def seed(self, metric_ids: dict[str, int],
             set_ids: dict[str, int]) -> None:
        """Restore the allocator from persisted ids at boot: an id once
        given is never given to another name."""
        with self._lock:
            self._metric_ids.update(metric_ids)
            self._set_ids.update(set_ids)
            if self._metric_ids:
                self._next_metric = max(self._next_metric,
                                        max(self._metric_ids.values()) + 1)
            if self._set_ids:
                self._next_set = max(self._next_set,
                                     max(self._set_ids.values()) + 1)

    def handle(self, request: wire.PromEncodeRequest
               ) -> wire.PromEncodeResponse:
        mids, sids = self.encode(list(request.metric_names),
                                 list(request.label_sets))
        return wire.PromEncodeResponse(metric_ids=mids, label_set_ids=sids)
