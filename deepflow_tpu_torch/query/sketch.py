"""Mergeable histogram sketch for partial percentiles.

Own copy of ``deepflow_tpu/cluster/sketch.py``. Exact percentiles do not
decompose over row sets, so PERCENTILE's partial aggregate
(``engine.execute_partial``) is a sketch, and merging partials is the
one approximate merge. The sketch is a log-scaled bucket histogram in the
DDSketch family: relative error is bounded by the bucket growth factor
(gamma), merge is bucket-wise addition, and the wire form is a sparse
{bucket_index: count} dict plus exact min/max so tail quantiles clamp
to observed bounds.
"""

from __future__ import annotations

import math

import numpy as np

_GAMMA = 1.02            # ~2% relative error per bucket
_LOG_GAMMA = math.log(_GAMMA)


class HistogramSketch:
    def __init__(self) -> None:
        self.buckets: dict[int, int] = {}   # log-bucket -> count
        self.zeros = 0                      # values <= 0 (durations: zero)
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def add_many(self, values: np.ndarray) -> None:
        a = np.asarray(values, dtype=np.float64)
        if not len(a):
            return
        self.count += int(len(a))
        self.min = min(self.min, float(a.min()))
        self.max = max(self.max, float(a.max()))
        pos = a[a > 0]
        self.zeros += int(len(a) - len(pos))
        if len(pos):
            idx = np.ceil(np.log(pos) / _LOG_GAMMA).astype(np.int64)
            for b, c in zip(*np.unique(idx, return_counts=True)):
                b = int(b)
                self.buckets[b] = self.buckets.get(b, 0) + int(c)

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        for b, c in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + c
        self.zeros += other.zeros
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        # nearest-rank over (zeros, then ascending log buckets); each hit
        # reports the bucket's geometric midpoint, clamped to true min/max
        rank = max(1, math.ceil(p / 100.0 * self.count))
        if rank <= self.zeros:
            return max(0.0, self.min)
        seen = self.zeros
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= rank:
                mid = 2.0 * (_GAMMA ** b) / (1.0 + _GAMMA)
                return float(min(max(mid, self.min), self.max))
        return float(self.max)

    def to_dict(self) -> dict:
        return {"b": {str(k): v for k, v in self.buckets.items()},
                "z": self.zeros, "n": self.count,
                "lo": (None if self.count == 0 else self.min),
                "hi": (None if self.count == 0 else self.max)}

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramSketch":
        s = cls()
        s.buckets = {int(k): int(v) for k, v in (d.get("b") or {}).items()}
        s.zeros = int(d.get("z", 0))
        s.count = int(d.get("n", 0))
        s.min = math.inf if d.get("lo") is None else float(d["lo"])
        s.max = -math.inf if d.get("hi") is None else float(d["hi"])
        return s
