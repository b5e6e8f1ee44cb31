#!/usr/bin/env python3
"""The read tier's storm, repeated: where its queries/s go on one host.

    python3 readtier_storm.py [RUNS]

Runs the smoke's phases 1-4 (the card's name and power limit, the model
and the profiled training that make the span frames), then
``chip_readtier.readtier_phase`` RUNS times (3 by default) in this
process, and prints for every storm window the queries/s, the CPU cores
this process used, and the CPU cores each of its child processes used
(the ingest shard, the four replicas and the storm clients, sorted),
from /proc over the window. Then one line a run: the storm's queries/s
through 1, 2 and 4 replicas, the speedup, the reference's verdict and
the phase's seconds. Everything lands in results/readtier_storm.json
too.
"""

import json
import os
import sys
import time


def _children() -> dict[int, float]:
    """CPU seconds of each child process of this one, from /proc."""
    me, out = os.getpid(), {}
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                st = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(st[1]) == me:
            out[int(p)] = ((int(st[11]) + int(st[12]))
                           / os.sysconf("SC_CLK_TCK"))
    return out


def main(runs: int) -> int:
    import torch
    if not torch.cuda.is_available():
        print("readtier_storm: CUDA is not available", file=sys.stderr)
        return 2
    import chip_phases
    import chip_readtier as rt
    import chip_smoke as cs
    cs.device_phase(torch)
    sink = chip_phases._span_sink(torch)
    storm, windows = rt._storm, []

    def measured(ports: list[int], seconds: float) -> float:
        c0, s0, t0 = _children(), sum(os.times()[:2]), time.perf_counter()
        qps = storm(ports, seconds)
        c1, s1 = _children(), sum(os.times()[:2])
        dt = time.perf_counter() - t0
        w = {"replicas": len(ports), "qps": qps,
             "client_cores": (s1 - s0) / dt,
             "child_cores": sorted(round((c1[p] - c0.get(p, 0.0)) / dt, 2)
                                   for p in c1)}
        print(json.dumps(w), flush=True)
        windows.append(w)
        return qps
    rt._storm = measured
    out = {"card": cs.CARD["line"], "runs": []}
    for i in range(runs):
        nums: dict = {}
        rt.readtier_phase(sink, nums)
        run = {k: nums.get(k) for k in ("storm_qps_1", "storm_qps_2",
                                        "storm_qps_4", "storm_speedup",
                                        "storm_meets_bar", "seconds",
                                        "host_cores")}
        print(json.dumps({"run": i + 1, **run}), flush=True)
        out["runs"].append(run)
    out["windows"] = windows
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "readtier_storm.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
