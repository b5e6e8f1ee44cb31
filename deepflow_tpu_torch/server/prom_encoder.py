"""Prometheus SmartEncoding: cluster-wide metric and label-set ids.

Own copy of ``deepflow_tpu/server/prom_encoder.py``: ``PromEncoder``
hands out one id per metric name and one per series label set (a
canonical JSON string), the same on every ingest node, and lives in the
controller, which serves it on the sync transport's ``PromEncode``
method. ``PromEncoderClient`` is a remote ingest node's view of it (the
reference's ``GrpcPromEncoderClient``, over the port's sync transport
instead of gRPC): a local cache, so steady-state ingest makes no call,
and one ``PromEncode`` call for the names and sets it has not seen. Both
answer ``encode(metric_names, label_sets) -> (metric_ids, set_ids)``;
the integrations' remote-write ingest (``server/integration.py``) uses
the controller's own allocator in a combined server, the client on a
remote ingest node, or a process-local ``PromEncoder`` standalone.
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


class PromEncoderClient:
    """An ingest node's view of the controller's allocator at
    ``controller`` (host:port of its sync port), with a local cache (an
    id once given never changes, so the cache never invalidates). A
    controller that cannot answer raises ``SyncError``."""

    def __init__(self, controller: str, timeout_s: float = 10.0) -> None:
        from deepflow_tpu_torch.server.syncwire import SyncClient
        self._client = SyncClient(controller, timeout_s=timeout_s)
        self._lock = threading.Lock()
        self._metric_cache: dict[str, int] = {}
        self._set_cache: dict[str, int] = {}

    def encode(self, metric_names: list[str],
               label_sets: list[str]) -> tuple[list[int], list[int]]:
        with self._lock:
            miss_names = [n for n in set(metric_names)
                          if n not in self._metric_cache]
            miss_sets = [s for s in set(label_sets)
                         if s not in self._set_cache]
        if miss_names or miss_sets:
            resp = self._client.call("PromEncode", wire.PromEncodeRequest(
                metric_names=miss_names, label_sets=miss_sets))
            with self._lock:
                for n, i in zip(miss_names, resp.metric_ids):
                    self._metric_cache[n] = i
                for s, i in zip(miss_sets, resp.label_set_ids):
                    self._set_cache[s] = i
        with self._lock:
            return ([self._metric_cache[n] for n in metric_names],
                    [self._set_cache[s] for s in label_sets])

    def close(self) -> None:
        self._client.close()
