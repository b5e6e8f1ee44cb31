"""Learned kernel/plan cost model for the encoded query path.

Own copy of ``deepflow_tpu/query/costmodel.py``. Instead of hand-tuned
size thresholds, keep a small online model of observed cost per kernel
and pick the cheapest prediction. Its consumers:

- query/engine.py: native hash-group vs numpy lexsort for GROUP BY
  (``_COST``), native index-list vs numpy mask filtering (``_FILT``), and
  serial vs morsel-parallel scan degree (``_DEGREE``, whose parallel
  overhead term is seeded with the pool dispatch cost, so small queries
  keep choosing the serial plan without a hand-tuned row threshold);
- query/cache.py: cache admission (a query whose observed cold cost is
  below the admission floor is not worth an entry);
- server/querier.py: per-stage costs observed by EXPLAIN ANALYZE.

Deliberately tiny: EWMA ns/row + a fixed per-call overhead term per
kernel, with periodic exploration so a kernel whose relative cost
changed (different data shapes) gets re-measured.
"""

from __future__ import annotations

import threading

_EWMA = 0.3          # weight of the newest observation
_EXPLORE_EVERY = 64  # re-measure the non-preferred kernel this often


class KernelCostModel:
    """Pick the cheapest kernel by predicted cost = coef*n + overhead."""

    def __init__(self, kernels: tuple[str, ...] = ("native", "numpy"),
                 overhead_ns: dict[str, float] | None = None) -> None:
        self.kernels = kernels
        self._lock = threading.Lock()
        self.coef: dict[str, float | None] = {k: None for k in kernels}
        self.overhead = dict(overhead_ns or {})  # fixed ns per call
        self.calls = 0
        self._last_used = {k: 0 for k in kernels}

    def predict(self, kernel: str, n: int) -> float | None:
        c = self.coef.get(kernel)
        if c is None:
            return None
        return c * max(n, 1) + self.overhead.get(kernel, 0.0)

    def choose(self, n: int) -> str:
        with self._lock:
            self.calls += 1
            # measure any still-unmeasured kernel first
            for k in self.kernels:
                if self.coef[k] is None:
                    return k
            # periodic exploration: the kernel least recently used gets a
            # fresh measurement so a stale coefficient can't pin the choice
            stale = min(self.kernels, key=lambda k: self._last_used[k])
            if self.calls - self._last_used[stale] >= _EXPLORE_EVERY:
                return stale
            return min(self.kernels,
                       key=lambda k: self.predict(k, n) or float("inf"))

    def observe(self, kernel: str, n: int, ns: float) -> None:
        per_row = float(ns) / max(n, 1)
        with self._lock:
            if kernel not in self._last_used:
                return
            self._last_used[kernel] = self.calls
            c = self.coef.get(kernel)
            self.coef[kernel] = (per_row if c is None
                                 else c * (1 - _EWMA) + per_row * _EWMA)

    def snapshot(self) -> dict:
        with self._lock:
            return {"calls": self.calls,
                    "ns_per_row": {k: (round(v, 2) if v is not None
                                       else None)
                                   for k, v in self.coef.items()},
                    "overhead_ns": {k: round(v, 1)
                                    for k, v in self.overhead.items()}}
