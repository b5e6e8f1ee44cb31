"""Step health: host-partial merge, rolling baselines, critical-path
attribution, and the streaming EWMA+MAD regression scorer.

Own copy of ``deepflow_tpu/server/stephealth.py``, unchanged in
behaviour. One record in profile.tpu_step_metrics is a single host's view
of one (job, run_id, step); everything here rebuilds the pod-level view
from those partials with exact merges (min / max / sum).
"""

from __future__ import annotations

import json
from collections import deque
from statistics import median

BASELINE_LEN = 32        # healthy steps kept per job for attribution
EWMA_ALPHA = 0.3
MAD_K = 4.0              # fire past ewma + K * 1.4826 * MAD
MIN_STEPS = 5            # warmup before anything may fire
MAD_WINDOW = 64          # residuals kept for the MAD estimate
# relative floor on the threshold: sub-noise corpora (near-zero MAD after
# identical synthetic steps) must not fire on a 1ns wobble
REL_FLOOR = 0.05


def _top_hlos(val) -> list:
    """Rows carry top_hlos as a json string; agent records as a list."""
    if isinstance(val, str):
        try:
            val = json.loads(val) if val else []
        except json.JSONDecodeError:
            val = []
    return [list(h) for h in (val or []) if len(h) >= 2]


def merge_host_partials(rows: list[dict]) -> list[dict]:
    """Fold per-host tpu_step_metrics rows into one rollup per
    (job, run_id, step), time-ordered. Exact merges only: start=min,
    end=max, totals=sum; the cross-host device-end spread comes from each
    host's (end_ns, device_skew_ns) pair — end_ns - device_skew_ns is
    that host's EARLIEST device end, so the global spread needs no
    per-device data."""
    by_key: dict[tuple, dict] = {}
    for r in rows:
        key = (str(r.get("job") or ""), int(r.get("run_id") or 0),
               int(r.get("step") or 0))
        t0 = int(r.get("time") or 0)
        t1 = int(r.get("end_ns") or 0)
        first_end = t1 - int(r.get("device_skew_ns") or 0)
        cur = by_key.get(key)
        if cur is None:
            by_key[key] = cur = {
                "job": key[0], "run_id": key[1], "step": key[2],
                "time": t0, "end_ns": t1, "_first_end": first_end,
                "device_count": 0, "compute_ns": 0, "collective_ns": 0,
                "straggler_device": int(r.get("straggler_device") or 0),
                "straggler_host": str(r.get("host") or ""),
                "straggler_lag_ns": int(r.get("straggler_lag_ns") or 0),
                "hosts": [], "_hlos": {}, "records": 0,
            }
        else:
            cur["time"] = min(cur["time"], t0)
            cur["_first_end"] = min(cur["_first_end"], first_end)
            if t1 > cur["end_ns"]:
                cur["end_ns"] = t1
                # the straggler is wherever the LATEST device end lives
                cur["straggler_device"] = int(
                    r.get("straggler_device") or 0)
                cur["straggler_host"] = str(r.get("host") or "")
                cur["straggler_lag_ns"] = int(
                    r.get("straggler_lag_ns") or 0)
        cur["device_count"] += int(r.get("device_count") or 0)
        cur["compute_ns"] += int(r.get("compute_ns") or 0)
        cur["collective_ns"] += int(r.get("collective_ns") or 0)
        cur["records"] += 1
        host = str(r.get("host") or "")
        if host and host not in cur["hosts"]:
            cur["hosts"].append(host)
        for op, self_ns, *rest in _top_hlos(r.get("top_hlos")):
            cat = rest[0] if rest else ""
            h = cur["_hlos"].get(op)
            if h is None:
                cur["_hlos"][op] = [int(self_ns), cat]
            else:
                h[0] += int(self_ns)
    out = []
    for cur in by_key.values():
        cur["latency_ns"] = max(0, cur["end_ns"] - cur["time"])
        cur["device_skew_ns"] = max(
            0, cur["end_ns"] - cur.pop("_first_end"))
        hlos = sorted(cur.pop("_hlos").items(), key=lambda kv: -kv[1][0])
        cur["top_hlos"] = [[op, h[0], h[1]] for op, h in hlos]
        cur["hosts"].sort()
        out.append(cur)
    out.sort(key=lambda c: (c["time"], c["run_id"], c["step"]))
    return out


def baseline_of(rollups: list[dict]) -> dict | None:
    """Medians of recent HEALTHY steps: the 'what normal looks like' this
    step gets diffed against. None until there is at least one."""
    if not rollups:
        return None
    per_op: dict[str, list[int]] = {}
    for r in rollups:
        for op, self_ns, *_ in r.get("top_hlos", []):
            per_op.setdefault(op, []).append(int(self_ns))
    return {
        "n_steps": len(rollups),
        "latency_ns": int(median(r["latency_ns"] for r in rollups)),
        "compute_ns": int(median(r["compute_ns"] for r in rollups)),
        "collective_ns": int(median(r["collective_ns"] for r in rollups)),
        "device_skew_ns": int(
            median(r["device_skew_ns"] for r in rollups)),
        "hlo_ns": {op: int(median(v)) for op, v in per_op.items()},
    }


def attribute(step: dict, baseline: dict | None) -> dict:
    """Critical-path attribution: where did this step's latency go,
    relative to the baseline — per-device compute, collective wait, or
    device skew (straggler)? Components are normalized per device so a
    host joining/leaving between baseline and step doesn't masquerade as
    a compute regression."""
    ndev = max(1, int(step.get("device_count") or 1))
    comp = {
        "compute": step["compute_ns"] // ndev,
        "collective": step["collective_ns"] // ndev,
        "skew": step["device_skew_ns"],
    }
    if baseline:
        # baseline totals are medians of merged (all-device) sums, so the
        # same per-device normalization applies
        base = {
            "compute": baseline["compute_ns"] // ndev,
            "collective": baseline["collective_ns"] // ndev,
            "skew": baseline["device_skew_ns"],
        }
    else:
        base = {k: 0 for k in comp}
    deltas = {k: comp[k] - base[k] for k in comp}
    verdict = max(deltas, key=lambda k: deltas[k])
    base_hlos = (baseline or {}).get("hlo_ns", {})
    dom = []
    for op, self_ns, *rest in step.get("top_hlos", []):
        b = int(base_hlos.get(op, 0))
        dom.append({"hlo_op": op, "self_ns": int(self_ns),
                    "baseline_ns": b, "delta_ns": int(self_ns) - b,
                    "category": rest[0] if rest else ""})
    dom.sort(key=lambda d: -d["delta_ns"])
    return {
        "verdict": verdict,
        "latency_ns": step["latency_ns"],
        "baseline_latency_ns": (baseline or {}).get("latency_ns", 0),
        "delta_ns": step["latency_ns"]
        - (baseline or {}).get("latency_ns", 0),
        "components_ns": comp,
        "baseline_components_ns": base,
        "component_deltas_ns": deltas,
        "straggler_device": step.get("straggler_device", 0),
        "straggler_host": step.get("straggler_host", ""),
        "straggler_lag_ns": step.get("straggler_lag_ns", 0),
        "dominant_hlos": dom[:5],
        "baseline_steps": (baseline or {}).get("n_steps", 0),
    }


class EwmaMad:
    """Streaming EWMA mean + MAD spread over step latency for ONE job.

    feed() returns True when the step is a regression: warmup done AND
    latency > ewma + K * 1.4826 * MAD, with a relative floor so
    noise-free corpora don't fire on jitter. Regressed steps do NOT
    update the mean/spread/baseline — a slow plateau must keep firing
    against the healthy past, not get absorbed into it."""

    def __init__(self, alpha: float = EWMA_ALPHA, k: float = MAD_K,
                 min_steps: int = MIN_STEPS,
                 baseline_len: int = BASELINE_LEN) -> None:
        self.alpha = alpha
        self.k = k
        self.min_steps = min_steps
        self.ewma: float | None = None
        self.n = 0
        self.residuals: deque[float] = deque(maxlen=MAD_WINDOW)
        self.healthy: deque[dict] = deque(maxlen=baseline_len)
        self.last_threshold_ns = 0.0

    def threshold_ns(self) -> float:
        if self.ewma is None:
            return float("inf")
        mad = median(self.residuals) if self.residuals else 0.0
        return self.ewma + max(self.k * 1.4826 * mad,
                               REL_FLOOR * self.ewma)

    def feed(self, rollup: dict) -> bool:
        lat = float(rollup["latency_ns"])
        if self.ewma is None:
            self.ewma = lat
            self.n = 1
            self.healthy.append(rollup)
            self.last_threshold_ns = self.threshold_ns()
            return False
        thr = self.threshold_ns()
        self.last_threshold_ns = thr
        if self.n >= self.min_steps and lat > thr:
            return True
        self.residuals.append(abs(lat - self.ewma))
        self.ewma += self.alpha * (lat - self.ewma)
        self.n += 1
        self.healthy.append(rollup)
        return False

    def baseline(self) -> dict | None:
        return baseline_of(list(self.healthy))


def score_timeline(rollups: list[dict], alpha: float = EWMA_ALPHA,
                   k: float = MAD_K,
                   min_steps: int = MIN_STEPS) -> list[dict]:
    """Batch replay of the streaming detector over a merged timeline:
    annotates each rollup with regressed/threshold/verdict in place-order.
    This is the exact logic the StepRegressionDetector runs live, so the
    timeline a human reads agrees with the alerts that fired."""
    scorers: dict[str, EwmaMad] = {}
    out = []
    for r in rollups:
        sc = scorers.get(r["job"])
        if sc is None:
            scorers[r["job"]] = sc = EwmaMad(
                alpha=alpha, k=k, min_steps=min_steps)
        baseline = sc.baseline()
        regressed = sc.feed(r)
        ann = dict(r)
        ann["regressed"] = regressed
        ann["threshold_ns"] = int(sc.last_threshold_ns) \
            if sc.last_threshold_ns != float("inf") else 0
        att = attribute(r, baseline)
        ann["verdict"] = att["verdict"] if regressed else "ok"
        if regressed:
            ann["attribution"] = att
        out.append(ann)
    return out
