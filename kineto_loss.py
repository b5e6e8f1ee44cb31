#!/usr/bin/env python3
"""Count the Kineto captures that lose a launching thread's kernel records
under the attached agent, per Kineto setting.

    python3 kineto_loss.py [--steps N] REPEATS VARIANT [VARIANT ...]

Each variant runs the chip_smoke runner child REPEATS times, interleaved
with the other variants: the example (llama7b() widths, 4 layers, batch 4
x 1025, N steps, 300 by default) with the agent attached as the runner
attaches it, shipping into a port server in this process. Variants:

- default: the agent as it ships (sessions opened and closed while a
  step is held, CUPTI kept up between windows);
- no_hold: sessions opened and closed beside the running workload, as
  before step holds;
- teardown: TEARDOWN_CUPTI=1, Kineto's own default: CUPTI torn down after
  every session and set up again at the next;
- per_thread_off: CUPTI_PER_THREAD_BUFFER_ENABLED=false in a
  KINETO_CONFIG file given to the child;
- session_off: the same option in each session's custom_profiler_config.

For every capture the child records the most common kernel count per step,
the launches before the window's last step mark with no device record, by
launching thread, and CUPTI's per-thread-buffer attribute and dropped-record
count (read through ctypes from the libcupti the process loaded). A capture
whose steps are short of the whole step is printed as lost. Every number
lands in results/kineto_loss.json. Needs one CUDA device.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "results")
EXAMPLE_ARGS = ["--preset", "llama7b", "--layers", "4", "--seq", "1025",
                "--batch", "4"]
BUDGET_S = float(os.environ.get("KINETO_LOSS_BUDGET_S", "900"))

CHILD = r'''
import collections, ctypes, json, os, re, runpy, sys
variant, out_path, port = sys.argv[1], sys.argv[2], sys.argv[3]
from deepflow_tpu_torch.agent.agent import attach, detach
from deepflow_tpu_torch.tpuprobe import kineto, sources

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
_cupti = {}


def cupti_state():
    """CUPTI's per-thread-buffer attribute and dropped records, from the
    libcupti this process loaded (None where it cannot be read)."""
    if not _cupti:
        path = next((ln.split()[-1] for ln in open("/proc/self/maps")
                     if "libcupti" in ln), None)
        _cupti["lib"] = ctypes.CDLL(path) if path else None
        _cupti["attr"] = None
        heads = []
        if path:
            heads.append(os.path.join(os.path.dirname(os.path.dirname(path)),
                                      "include", "cupti_activity.h"))
        heads.append("/usr/local/cuda/extras/CUPTI/include/cupti_activity.h")
        for h in heads:
            if not os.path.exists(h):
                continue
            m = re.search(r"typedef enum\s*\{([^}]*)\}\s*"
                          r"CUpti_ActivityAttribute;", open(h).read())
            if not m:
                continue
            body = re.sub(r"/\*.*?\*/|//[^\n]*", "", m.group(1), flags=re.S)
            v = -1
            for ent in filter(None, (x.strip() for x in body.split(","))):
                name, _, val = ent.partition("=")
                val = val.strip()
                v = int(val, 0) if val[:1].isdigit() else v + 1
                if name.strip() == "CUPTI_ACTIVITY_ATTR_PER_THREAD_ACTIVITY_BUFFER":
                    _cupti["attr"] = v
            break
    lib, out = _cupti["lib"], {}
    if lib is None:
        return out
    if _cupti["attr"] is not None:
        # 255: a value CUPTI never writes, so an unwritten read shows
        size, val = ctypes.c_size_t(1), ctypes.c_uint8(255)
        if lib.cuptiActivityGetAttribute(_cupti["attr"], ctypes.byref(size),
                                         ctypes.byref(val)) == 0:
            out["per_thread"] = val.value
    dropped = ctypes.c_size_t(0)
    if lib.cuptiActivityGetNumDroppedRecords(None, 0,
                                             ctypes.byref(dropped)) == 0:
        out["dropped"] = dropped.value
    return out


captures = []
extract = kineto.extract_device_spans


def counted(trace, steps=()):
    events = trace.get("traceEvents", [])
    recorded = {(e.get("args") or {}).get("correlation") for e in events
                if e.get("cat") in kineto.DEVICE_CATS and e.get("ph") == "X"}
    base = int(trace.get("baseTimeNanoseconds", 0) or 0)
    last_mark = max((t for _, t in steps), default=0)
    launched, lost = collections.Counter(), collections.Counter()
    for e in events:
        if (e.get("cat") in kineto.LAUNCH_CATS and e.get("name") in LAUNCHES
                and kineto._ns(e["ts"], base) < last_mark):
            launched[e.get("tid")] += 1
            if (e.get("args") or {}).get("correlation") not in recorded:
                lost[e.get("tid")] += 1
    spans = extract(trace, steps)
    per_step = collections.Counter(s.run_id for s in spans if s.hlo_op)
    hist = collections.Counter(per_step.values())
    try:
        state = cupti_state()
    except Exception as e:  # a reading, never the capture's failure
        state = {"error": repr(e)}
    captures.append({"steps": len(per_step),
                     "mode": hist.most_common(1)[0][0] if hist else 0,
                     "hist": sorted(hist.items()),
                     "launched": {str(k): v for k, v in launched.items()},
                     "lost": {str(k): v for k, v in lost.items()},
                     "cupti": state})
    return spans


sources.extract_device_spans = counted
if variant == "no_hold":
    import contextlib

    @contextlib.contextmanager
    def unheld(self):
        yield
    sources.KinetoSource._at_step_boundary = unheld
if variant == "session_off":
    import torch.profiler as tp
    from torch._C._profiler import _ExperimentalConfig
    init = tp.profile.__init__

    def with_setting(self, *a, **kw):
        kw["experimental_config"] = _ExperimentalConfig(
            custom_profiler_config="CUPTI_PER_THREAD_BUFFER_ENABLED=false")
        init(self, *a, **kw)
    tp.profile.__init__ = with_setting
attach("llama-train", servers=[f"127.0.0.1:{port}"])
sys.argv = ["train_with_observability"] + sys.argv[4:]
try:
    runpy.run_module("deepflow_tpu_torch.examples.train_with_observability",
                     run_name="__main__", alter_sys=True)
finally:
    from deepflow_tpu_torch.agent.agent import _Attached
    agent = _Attached.agent
    detach()
    kineto_stats = {}
    if agent is not None and agent.tpuprobe is not None:
        kineto_stats = dict(agent.tpuprobe.sources[0].stats)
    with open(out_path, "w") as f:
        json.dump({"captures": captures, "kineto": kineto_stats}, f)
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kineto_loss: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    steps = "300"
    if args[:1] == ["--steps"]:
        steps, args = args[1], args[2:]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from deepflow_tpu_torch.server import Server
    repeats, variants = int(args[0]), args[1:]
    os.makedirs(OUT_DIR, exist_ok=True)
    conf = os.path.join(OUT_DIR, "kineto_per_thread_off.conf")
    with open(conf, "w") as f:
        f.write("CUPTI_PER_THREAD_BUFFER_ENABLED=false\n")
    t0 = time.perf_counter()
    runs = []
    for rep in range(repeats):
        for variant in variants:
            if time.perf_counter() - t0 > BUDGET_S:
                break
            srv = Server(ingest_port=0, query_port=0).start()
            out_path = os.path.join(OUT_DIR, f"kineto_loss_{variant}{rep}.json")
            env = dict(os.environ)
            if variant == "per_thread_off":
                env["KINETO_CONFIG"] = conf
            if variant == "teardown":
                env["TEARDOWN_CUPTI"] = "1"
            t_child = time.perf_counter()
            try:
                p = subprocess.run(
                    [sys.executable, "-c", CHILD, variant, out_path,
                     str(srv.ingest_port), *EXAMPLE_ARGS, "--steps", steps],
                    cwd=ROOT, env=env, capture_output=True, text=True,
                    timeout=600)
                rc, err = p.returncode, p.stderr
            except subprocess.TimeoutExpired as e:
                rc, err = "timeout", str(e.stderr or "")
            finally:
                srv.stop()
            caps, kineto_stats = [], {}
            if os.path.exists(out_path):
                with open(out_path) as f:
                    got = json.load(f)
                caps, kineto_stats = got["captures"], got["kineto"]
            modes = [c["mode"] for c in caps]
            whole = max(modes, default=0)
            # the last capture, cut by detach, may hold only edge steps
            lost = [i for i, c in enumerate(caps)
                    if c["mode"] < whole and (i < len(caps) - 1
                                              or c["steps"] >= 5)]
            run = {"variant": variant, "rep": rep, "rc": rc,
                   "seconds": time.perf_counter() - t_child,
                   "modes": modes, "steps": [c["steps"] for c in caps],
                   "lost_captures": lost, "captures": caps,
                   "kineto": kineto_stats, "stderr_tail": err[-800:]}
            runs.append(run)
            ks = {k: kineto_stats.get(k) for k in (
                "captures", "unheld", "dead_ms", "last_stop_ms")}
            print(f"{variant}{rep} rc={rc} seconds={run['seconds']:.1f} "
                  f"modes={modes} lost_captures={lost} kineto={ks} "
                  f"cupti_last={caps[-1]['cupti'] if caps else None}",
                  flush=True)
    summary = {}
    for v in variants:
        mine = [r for r in runs if r["variant"] == v]
        summary[v] = {"children": len(mine),
                      "children_with_loss": sum(bool(r["lost_captures"])
                                                for r in mine),
                      "captures": sum(len(r["modes"]) for r in mine),
                      "lost_captures": sum(len(r["lost_captures"])
                                           for r in mine),
                      "failed_children": sum(r["rc"] != 0 for r in mine),
                      "unheld": sum(r["kineto"].get("unheld", 0)
                                    for r in mine)}
    print(json.dumps({"summary": summary}), flush=True)
    with open(os.path.join(OUT_DIR, "kineto_loss.json"), "w") as f:
        json.dump({"summary": summary, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
