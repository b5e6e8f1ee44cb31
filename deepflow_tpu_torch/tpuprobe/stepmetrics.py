"""Per-step rollups: the STEP_METRICS record, its wire codec, and the
agent-side aggregator.

Own copy of ``deepflow_tpu/tpuprobe/stepmetrics.py``, unchanged in
behaviour and payload. The probe's span sink feeds every captured batch
to a StepAggregator that folds device spans into one record per
(job, run_id): step latency, per-device bounds, device skew,
collective-wait total and top-K op self-times. A record finalizes when a
NEWER run_id appears for its job, or on flush(). On CUDA the run_id is the
optimizer step number the capture source assigns (see sources.py).

Wire format: canonical JSON {"v": 1, "pid": ..., "process_name": ...,
"records": [...]}, zlib-compressed past 512B by the framed codec like every
other payload. Record keys mirror the profile.tpu_step_metrics columns.
"""

from __future__ import annotations

import json
import threading

from deepflow_tpu_torch.proto import wire

STEP_PAYLOAD_VERSION = 1
_HOST_KINDS = (wire.HOST_RUNTIME, wire.HOST_COMPILE)


def encode_step_payload(records: list[dict], pid: int = 0,
                        process_name: str = "") -> bytes:
    return json.dumps({
        "v": STEP_PAYLOAD_VERSION,
        "pid": pid,
        "process_name": process_name,
        "records": records,
    }, separators=(",", ":")).encode()


def decode_step_payload(payload: bytes) -> dict:
    """Raises ValueError on malformed payloads (decode_error for the
    decoder's ledger)."""
    try:
        # zero-copy receive hands decoders memoryviews; json wants bytes
        obj = json.loads(payload if isinstance(payload, (bytes, bytearray,
                                                         str))
                         else bytes(payload))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"bad STEP_METRICS payload: {e}") from None
    if not isinstance(obj, dict) or obj.get("v") != STEP_PAYLOAD_VERSION:
        raise ValueError(
            f"bad STEP_METRICS version {obj.get('v') if isinstance(obj, dict) else obj!r}")
    if not isinstance(obj.get("records"), list):
        raise ValueError("STEP_METRICS payload missing records list")
    return obj


class _StepAcc:
    """Accumulator for one (job, run_id) across possibly many span
    batches."""

    __slots__ = ("job", "run_id", "step", "devices", "hlos")

    def __init__(self, job: str, run_id: int) -> None:
        self.job = job
        self.run_id = run_id
        self.step = 0
        # device_id -> [start_ns, end_ns, compute_ns, collective_ns]
        self.devices: dict[int, list[int]] = {}
        # hlo_op -> [self_ns, category]
        self.hlos: dict[str, list] = {}

    def add(self, ev) -> None:
        start = int(ev.start_ns)
        end = start + int(ev.duration_ns)
        d = self.devices.get(ev.device_id)
        if d is None:
            self.devices[ev.device_id] = d = [start, end, 0, 0]
        else:
            if start < d[0]:
                d[0] = start
            if end > d[1]:
                d[1] = end
        dur = int(ev.duration_ns)
        if ev.collective:
            d[3] += dur
        elif ev.hlo_op:
            d[2] += dur
        if ev.step:
            self.step = int(ev.step)
        if ev.hlo_op:
            h = self.hlos.get(ev.hlo_op)
            if h is None:
                self.hlos[ev.hlo_op] = [dur, ev.hlo_category or ""]
            else:
                h[0] += dur

    def finalize(self, topk: int) -> dict:
        starts = [d[0] for d in self.devices.values()]
        ends = [d[1] for d in self.devices.values()]
        t0, t1 = min(starts), max(ends)
        ends_sorted = sorted(ends)
        median_end = ends_sorted[len(ends_sorted) // 2]
        straggler = max(self.devices, key=lambda k: self.devices[k][1])
        top = sorted(self.hlos.items(), key=lambda kv: -kv[1][0])[:topk]
        return {
            "time": t0,
            "end_ns": t1,
            "latency_ns": t1 - t0,
            "run_id": self.run_id,
            "step": self.step or self.run_id,
            "job": self.job,
            "device_count": len(self.devices),
            "device_skew_ns": ends_sorted[-1] - ends_sorted[0],
            "compute_ns": sum(d[2] for d in self.devices.values()),
            "collective_ns": sum(d[3] for d in self.devices.values()),
            "straggler_device": straggler,
            "straggler_lag_ns": max(
                0, self.devices[straggler][1] - median_end),
            "top_hlos": [[op, h[0], h[1]] for op, h in top],
        }


class StepAggregator:
    """Folds device span batches into per-(job, run_id) step records.

    emit(records) is called with FINALIZED records only: an accumulator
    closes when a strictly newer run_id shows up for its job, or when
    flush() runs (probe stop / end of a sim generation). Thread-safe —
    the capture thread and other sources may feed from different threads.
    """

    def __init__(self, emit, topk: int = 5) -> None:
        self._emit = emit
        self.topk = max(1, int(topk))
        self._lock = threading.Lock()
        self._pending: dict[tuple[str, int], _StepAcc] = {}
        self.stats = {"spans_seen": 0, "steps_emitted": 0}

    def feed(self, events) -> None:
        done: list[dict] = []
        with self._lock:
            for ev in events or ():
                rid = int(getattr(ev, "run_id", 0) or 0)
                kind = getattr(ev, "kind", 0)
                # host-plane spans have no device timeline; a step record
                # built from them would fabricate a device-0 plane
                if not rid or kind in _HOST_KINDS or (
                        getattr(ev, "hlo_category", "") == "host"):
                    continue
                self.stats["spans_seen"] += 1
                job = getattr(ev, "hlo_module", "") or ""
                acc = self._pending.get((job, rid))
                if acc is None:
                    self._pending[(job, rid)] = acc = _StepAcc(job, rid)
                    # a newer run_id closes this job's older steps
                    for key in [k for k in self._pending
                                if k[0] == job and k[1] < rid]:
                        done.append(
                            self._pending.pop(key).finalize(self.topk))
                acc.add(ev)
            self.stats["steps_emitted"] += len(done)
        if done:
            done.sort(key=lambda r: (r["run_id"], r["time"]))
            self._emit(done)

    def flush(self) -> None:
        with self._lock:
            done = [acc.finalize(self.topk)
                    for acc in self._pending.values() if acc.devices]
            self._pending.clear()
            self.stats["steps_emitted"] += len(done)
        if done:
            done.sort(key=lambda r: (r["run_id"], r["time"]))
            self._emit(done)
