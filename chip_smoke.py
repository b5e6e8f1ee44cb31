#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi);
2. model: the Llama at llama7b() widths (vocab 32000, d_model 4096, 32
   heads, 8 KV heads, d_ff 11008) cut to 4 layers, bf16, batch 4 x 1025
   tokens, weights and tokens from torch.Generator seeds. Its initial loss
   is checked against ln(vocab), its bf16 loss against a float32 forward
   of the same weights, and a tiny float32 model on the card against the
   same model on the CPU;
3. profiled training: SGD steps without the probe, then with TpuProbe
   (Kineto capture, step records, memory samples) attached until the
   capture source has completed three captures, then without it again;
   step times are medians over steps each ended by a synchronize;
4. frames: the collected frames decode with the port's StreamDecoder and
   wire codec, their counts match what the probe and the sink counted, and
   the per-kernel device-time flame graph is built from them;
5. server: the port's server runs as its own process
   (python -m deepflow_tpu_torch.server), takes the same frame bytes over
   one TCP connection, and must hold every span, memory sample and step
   record with no decode error or bad frame; its TpuFlame answer must
   equal phase 4's flame graph, its step timeline the step records, and
   its memory view phase 4's largest sample. Ingest rows/s and each
   query's wall time are host numbers;
6. runner: zero-code profiling of an unmodified training script. Phase
   2's model is freed; a fresh server process starts; the example
   (deepflow_tpu_torch/examples/train_with_observability.py, phase 2's
   configuration) trains as a plain subprocess, then twice under
   python -m deepflow_tpu_torch.cli.runner, whose in-process agent
   (OnCPU sampler, Kineto probe, self-stats) ships over the durable
   sender: first with nothing listening at its server address (no
   ingest), then into the server while the child trains. Agent overhead
   % is the live child's median step against the plain one, live-ingest
   cost % the live child's against the no-ingest one (means and longest
   steps beside them). Kernels per step come from the server's step
   records: every capture's most common count must equal phase 4's (the
   last capture, which detach cuts, only when it holds five steps or
   more); every span row must lie in a step record; the four tables must
   hold rows, the CPU flame graph a stack through the example's main, the
   receiver must have acked, with no decode error, bad frame or dup. The
   children's peak RSS (/proc/<pid>/statm) and CPU-seconds
   (/proc/<pid>/stat), over their life and over the training loop, come
   from samples every 0.1 s; the ingest lag is the live child's exit to
   the last frame decoded.

The port has no hand-written kernels: the JAX package it ports has no
Pallas kernel, so the kernel list is empty. Any failed check raises and
the script exits non-zero; there is no CPU path. The last line is the
JSON result; results/chip_smoke.json keeps every number.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

BATCH, SEQ = 4, 1025
N_LAYERS = 4            # llama7b() has 32; widths are unchanged
BF16_VS_F32_LOSS_RTOL = 1e-2   # bf16 rounding of a 4-layer forward
TINY_CUDA_VS_CPU_ATOL = 1e-4   # float32, full-precision matmuls
BASE_STEPS = 20
CAPTURES = 3            # the first one pays CUPTI's start-up
PROBE_CAP_S = 60.0
SERVER_START_S = 120.0   # the server process imports and listens
SERVER_INGEST_S = 600.0  # first byte sent to the last row visible
EXAMPLE = "deepflow_tpu_torch.examples.train_with_observability"
EXAMPLE_ARGS = ["--preset", "llama7b", "--layers", str(N_LAYERS),
                "--seq", str(SEQ), "--batch", str(BATCH)]
RUNNER = ["-m", "deepflow_tpu_torch.cli.runner"]
PLAIN_STEPS = 60
RUNNER_STEPS = 300      # room for three or more captures
RUNNER_WARMUP = 3       # first steps of each child left out of its medians
RUNNER_CHILD_S = 600.0  # each training child's time limit
# the last capture, which detach cuts, is held to the whole step only when
# its interior steps outnumber its two edge steps
WHOLE_CAPTURE_STEPS = 5
OUT_DIR = "results"
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def device_phase(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return {"nvidia_smi": line, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def model_phase(torch, tl) -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    cfg = tl.LlamaConfig.llama7b(n_layers=N_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = tl.Llama(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        loss = float(tl.loss_fn(model, tokens))
        m32 = tl.Llama(dataclasses.replace(cfg, dtype=torch.float32),
                       device="cuda", generator=gen)
        m32.load_state_dict(model.state_dict())
        loss32 = float(tl.loss_fn(m32, tokens))
        del m32
        # the same tiny float32 model on the card and on the CPU
        tiny = tl.LlamaConfig.tiny(dtype=torch.float32)
        small_cpu = tl.Llama(tiny, device="cpu",
                             generator=torch.Generator().manual_seed(2))
        small_gpu = tl.Llama(tiny, device="cuda")
        small_gpu.load_state_dict(small_cpu.state_dict())
        tt = torch.randint(0, tiny.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(3))
        tiny_err = float((small_gpu(tt.cuda()).cpu() - small_cpu(tt))
                         .abs().max())
    torch.cuda.empty_cache()
    rel = abs(loss - loss32) / abs(loss32)
    phase("model", params=n_params, loss_bf16=loss, loss_f32=loss32,
          rel_diff=rel, ln_vocab=math.log(cfg.vocab),
          tiny_cuda_vs_cpu_max_abs=tiny_err)
    check(math.isfinite(loss), "initial loss is finite")
    check(abs(loss - math.log(cfg.vocab)) <= 0.2 * math.log(cfg.vocab),
          "initial loss within 20% of ln(vocab)")
    check(rel <= BF16_VS_F32_LOSS_RTOL,
          f"bf16 vs f32 loss rel diff {rel} <= {BF16_VS_F32_LOSS_RTOL}")
    check(tiny_err <= TINY_CUDA_VS_CPU_ATOL,
          f"tiny f32 logits cuda vs cpu {tiny_err} <= {TINY_CUDA_VS_CPU_ATOL}")
    return model, tokens, {"params": n_params, "loss_bf16": loss,
                           "loss_f32": loss32, "bf16_vs_f32_rel": rel,
                           "tiny_cuda_vs_cpu_max_abs": tiny_err}


def timed_step(torch, train_step, tokens) -> tuple[float, float]:
    t0 = time.perf_counter()
    loss = float(train_step(tokens))  # reads the loss: waits for the step
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0, loss


def training_phase(torch, tl, model, tokens) -> tuple:
    from deepflow_tpu_torch.agent.config import AgentConfig, TpuProbeConfig
    from deepflow_tpu_torch.agent.sink import FrameSink
    from deepflow_tpu_torch.tpuprobe.probe import TpuProbe

    train_step, _opt = tl.make_train_step(model)
    for _ in range(3):  # warm-up: allocator, cuBLAS heuristics
        timed_step(torch, train_step, tokens)
    torch.cuda.reset_peak_memory_stats()
    base = [timed_step(torch, train_step, tokens)[0]
            for _ in range(BASE_STEPS)]

    sink = FrameSink(AgentConfig(tpuprobe=TpuProbeConfig(memory_poll_s=1.0)),
                     process_name="chip_smoke")
    probe = TpuProbe(sink)
    wall0 = time.time_ns()
    probe.start()
    kineto, memsrc = probe.sources
    with_probe, losses, captures = [], [], []
    t0 = time.perf_counter()
    while (kineto.stats["captures"] < CAPTURES
           or memsrc.stats["samples"] < 1) \
            and time.perf_counter() - t0 < PROBE_CAP_S:
        ms, loss = timed_step(torch, train_step, tokens)
        with_probe.append(ms)
        losses.append(loss)
        if kineto.stats["captures"] > len(captures):  # one just ended
            captures.append({"after_step": len(with_probe), **{
                k: v for k, v in kineto.stats.items()
                if k.startswith("last_")}})
    wall_s = time.perf_counter() - t0
    probe.stop()
    wall1 = time.time_ns()
    peak = torch.cuda.max_memory_allocated()
    # the probe-free steps again: their spread against the first set
    after = [timed_step(torch, train_step, tokens)[0]
             for _ in range(BASE_STEPS)]
    ks, mst = dict(kineto.stats), dict(memsrc.stats)
    base_ms = statistics.median(base + after)
    probe_ms = statistics.median(with_probe)
    base_mean = statistics.mean(base + after)
    probe_mean = statistics.mean(with_probe)
    nums = {
        "step_ms_without_probe": base_ms, "step_ms_with_probe": probe_ms,
        "step_ms_without_probe_before": statistics.median(base),
        "step_ms_without_probe_after": statistics.median(after),
        "step_ms_with_probe_min_max": [min(with_probe), max(with_probe)],
        "step_ms_without_probe_min_max": [min(base + after),
                                          max(base + after)],
        "probe_overhead_pct": (probe_ms - base_ms) / base_ms * 100.0,
        "step_ms_mean_without_probe": base_mean,
        "step_ms_mean_with_probe": probe_mean,
        "probe_overhead_mean_pct": (probe_mean - base_mean) / base_mean
        * 100.0,
        "stalled_steps": [[i, ms] for i, ms in enumerate(with_probe)
                          if ms > 2 * base_ms],
        "captures": captures, "step_ms_with_probe_all": with_probe,
        "steps_without_probe": len(base) + len(after),
        "steps_with_probe": len(with_probe),
        "train_wall_s": wall_s, "loss_first": losses[0],
        "loss_last": losses[-1], "peak_memory_bytes": peak,
        "kineto": ks, "memory": mst, "probe": dict(probe.stats),
        "sink": dict(sink.stats)}
    phase("training", **{k: v for k, v in nums.items()
                         if not isinstance(v, (dict, list))})
    phase("kineto", **ks)
    phase("probe", **probe.stats, **{f"sink_{k}": v
                                     for k, v in sink.stats.items()})
    for c in captures:
        phase("capture", **c)
    check(ks["captures"] >= CAPTURES, f"at least {CAPTURES} captures")
    check(ks["errors"] == 0 and ks["contended"] == 0 and ks["skipped"] == 0,
          "no capture errors, contention or skips")
    check(mst["errors"] == 0, "no memory poll errors")
    check(ks["steps_seen"] >= 2, "at least two steps seen")
    check(ks["est_step_ms"] > 0, "step cadence estimated")
    check(probe.stats.get("steps_sent", 0) >= 1, "STEP_METRICS records sent")
    check(probe.stats.get("mem_samples_sent", 0) >= 1, "memory samples sent")
    check(all(math.isfinite(x) for x in losses), "training losses finite")
    return sink, probe, nums, (wall0, wall1, wall_s)


def frames_phase(sink, probe, window) -> tuple:
    from deepflow_tpu_torch.codec import MessageType, StreamDecoder
    from deepflow_tpu_torch.proto import wire
    from deepflow_tpu_torch.query.flamegraph import device_flame
    from deepflow_tpu_torch.tpuprobe.stepmetrics import decode_step_payload

    wall0, wall1, wall_s = window
    frames = StreamDecoder().feed(b"".join(sink.frames))
    spans, mem, records = [], [], []
    for header, payload in frames:
        if header.msg_type == MessageType.TPU_SPAN:
            batch = wire.TpuSpanBatch.FromString(payload)
            spans += batch.spans
            mem += batch.memory
        elif header.msg_type == MessageType.STEP_METRICS:
            records += decode_step_payload(payload)["records"]
    kernels = [s for s in spans if s.hlo_op]
    modules = [s for s in spans if not s.hlo_op]
    steps = sorted({s.run_id for s in modules})
    lat = [r["latency_ns"] / 1e6 for r in records]
    per_step: dict[int, int] = {}
    for s in kernels:
        per_step[s.run_id] = per_step.get(s.run_id, 0) + 1
    flame = device_flame(spans)
    leaves = []
    for mod in flame.children.values():
        for cat in mod.children.values():
            for op in cat.children.values():
                leaves.append((op.total_value, cat.name, op.name))
    leaves.sort(reverse=True)
    nums = {"frames": len(frames), "spans": len(spans),
            "kernel_spans": len(kernels),
            "kernel_spans_per_s": len(kernels) / wall_s,
            "memory_samples": len(mem), "step_records": len(records),
            "steps_in_spans": len(steps),
            # the largest count is a whole step's; window edges cut others
            "kernels_per_step_max": max(per_step.values(), default=0),
            "kernels_per_step_median": statistics.median(per_step.values())
            if per_step else 0,
            # the most common count: the whole step's
            "kernels_per_step_mode": statistics.mode(per_step.values())
            if per_step else 0,
            "median_step_device_ms": statistics.median(lat) if lat else 0.0,
            # kernel time over the steps' first-kernel-to-last-kernel spans
            "device_busy_pct": 100.0 * sum(s.duration_ns for s in kernels)
            / max(1, sum(s.duration_ns for s in modules)),
            "max_bytes_in_use": max((m.bytes_in_use for m in mem), default=0),
            "flame_total_ms": flame.total_value / 1e6}
    phase("frames", **nums)
    for ns, cat, name in leaves[:5]:
        print(f"  top kernel {ns / 1e6:10.3f} ms  {cat:10s} {name[:110]}",
              flush=True)
    check(len(frames) == sink.stats["frames"], "every frame decodes")
    check(len(spans) == probe.stats["spans_sent"],
          "decoded spans == spans the probe sent")
    check(len(mem) == probe.stats["mem_samples_sent"],
          "decoded memory samples == samples sent")
    check(len(records) == probe.stats["steps_sent"],
          "decoded step records == records sent")
    check(len(kernels) > 0, "kernel spans captured")
    check(len(steps) >= 2, "spans of at least two steps")
    check(any(m.bytes_in_use > 0 for m in mem), "memory in use sampled")
    check(all(wall0 <= s.start_ns <= wall1 for s in spans),
          "span times lie on the wall clock inside the probe's run")
    check(leaves and flame.total_value > 0, "device flame graph not empty")
    nums["top_kernels"] = [[n, c, ns] for ns, c, n in leaves[:5]]
    return nums, {"flame": flame.to_dict(), "records": records}


def _canon_flame(node: dict) -> dict:
    """Siblings in a fixed order: their order among equal totals is
    unspecified."""
    return {"name": node["name"], "total_value": node["total_value"],
            "self_value": node["self_value"],
            "children": sorted((_canon_flame(c) for c in node["children"]),
                               key=lambda c: (-c["total_value"], c["name"]))}


def _http(port: int, path: str, body: dict | None = None) -> tuple:
    """(status, answer, wall ms) of one GET (body None) or POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    return code, json.loads(data), (time.perf_counter() - t0) * 1000.0


def _server_ports(proc) -> dict:
    """The JSON line the server prints once it listens."""
    import select
    ready, _, _ = select.select([proc.stdout], [], [], SERVER_START_S)
    line = proc.stdout.readline() if ready else ""
    check(bool(line), "the server printed its ports")
    return json.loads(line)


def _start_server(log_path: str):
    """The port's server as its own process, its stderr into log_path."""
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "deepflow_tpu_torch.server",
             "--ingest-port", "0", "--query-port", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True)


def _stop_server(proc, log_path: str) -> None:
    """SIGTERM; the server must exit 0 with no exception in its log."""
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.stdout.close()
    with open(log_path) as f:
        log_text = f.read()
    check(proc.returncode == 0, f"server exit code {proc.returncode}")
    check("Traceback" not in log_text and " ERROR " not in log_text,
          f"server logged no exception (see {log_path})")


def server_phase(sink, probe, seen) -> dict:
    """The frames of phase 3 through the port's own server process."""
    import socket
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "server.log")
    want = {"deepflow_system.deepflow_system": 0,
            "profile.in_process_profile": 0,
            "profile.tpu_hlo_span": probe.stats["spans_sent"],
            "profile.tpu_memory": probe.stats["mem_samples_sent"],
            "profile.tpu_step_metrics": probe.stats["steps_sent"]}
    data = b"".join(sink.frames)
    proc = _start_server(log_path)
    try:
        ports = _server_ports(proc)
        qport = ports["query_port"]
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", ports["ingest_port"]),
                                      timeout=60) as conn:
            conn.sendall(data)
        while True:
            _, health, _ = _http(qport, "/v1/health")
            if health["tables"] == want \
                    or time.perf_counter() - t0 > SERVER_INGEST_S:
                break
            time.sleep(0.02)
        ingest_s = time.perf_counter() - t0
        stats = health["stats"]
        check(health["tables"] == want,
              f"server rows {health['tables']} == rows sent {want}")
        check(all(d["errors"] == 0 for d in stats["decoders"].values()),
              "no decode errors")
        check(stats["receiver"]["bad_frames"] == 0
              and stats["receiver"]["dropped"] == 0,
              "no bad or dropped frames")

        answers, query_ms = {}, {}
        for name, path, body in (
                ("flame", "/v1/profile/TpuFlame", {}),
                ("steps", "/v1/tpu/steps",
                 {"limit": len(seen["records"]) + 1}),
                ("critical_path", "/v1/tpu/steps/critical_path", {}),
                ("step_trace", "/v1/profile/TpuStepTrace", {}),
                ("memory", "/v1/profile/TpuMemory",
                 {"limit": probe.stats["mem_samples_sent"] + 1}),
                ("collectives", "/v1/profile/TpuCollectives", {})):
            code, ans, ms = _http(qport, path, body)
            check(code == 200, f"{path} answers 200 (got {code}: {ans})")
            answers[name], query_ms[f"{name}_ms"] = ans["result"], ms

        check(_canon_flame(answers["flame"])
              == _canon_flame(seen["flame"]),
              "TpuFlame equals the in-process device flame graph")
        # one rollup per (job, run_id, step): first start to last end
        spans: dict[tuple, list[int]] = {}
        for r in seen["records"]:
            k = (r["job"], r["run_id"], r["step"])
            b = spans.setdefault(k, [r["time"], r["end_ns"]])
            b[0], b[1] = min(b[0], r["time"]), max(b[1], r["end_ns"])
        steps = answers["steps"]
        check(steps["total_steps"] == len(spans),
              f"{steps['total_steps']} steps == {len(spans)} distinct")
        check({(s["job"], s["run_id"], s["step"]): s["latency_ns"]
               for s in steps["steps"]}
              == {k: max(0, b[1] - b[0]) for k, b in spans.items()},
              "step latencies equal the step records'")
        mem = answers["memory"]
        check(max((s["bytes_in_use"] for s in mem["timeline"]), default=0)
              == seen["max_bytes_in_use"],
              "largest bytes_in_use equals phase 4's")
        trace = answers["step_trace"]
        check(bool(trace["devices"]) and trace["run_id"] > 0,
              "step trace not empty")
        cp = answers["critical_path"]
        check(cp["step"]["step"] > 0 and cp["attribution"]["verdict"],
              "critical path not empty")
    finally:
        _stop_server(proc, log_path)
    rows = sum(want.values())
    dec = stats["decoders"]
    nums = {"rows": rows, **{t.split(".")[1] + "_rows": n
                             for t, n in want.items()},
            "frame_bytes": len(data), "ingest_s": ingest_s,
            "ingest_rows_per_s": rows / ingest_s,
            "recv_ms": stats["receiver"]["recv_ns"] / 1e6,
            "decode_ms": sum(d["handle_ns"] - d["append_ns"]
                             for d in dec.values()) / 1e6,
            "append_ms": sum(d["append_ns"] for d in dec.values()) / 1e6,
            "collectives": len(answers["collectives"]), **query_ms}
    phase("server", **nums)
    return nums

def _proc_sample(pid: int) -> tuple[float, int] | None:
    """(CPU seconds, resident bytes) of a live process, from /proc; None
    once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open(f"/proc/{pid}/statm") as f:
            resident_pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    # fields[11], fields[12]: utime, stime (stat fields 14 and 15)
    cpu_s = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return cpu_s, resident_pages * os.sysconf("SC_PAGE_SIZE")


def _train_child(args: list[str], name: str) -> dict:
    """Run one training child to its end while sampling its /proc every
    0.1 s (CPU time and resident memory; the last sample may be of the
    exited child, whose CPU time is final); parse its per-step JSON
    lines."""
    out_path = os.path.join(OUT_DIR, f"{name}.out")
    err_path = os.path.join(OUT_DIR, f"{name}.err")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                stdout=out, stderr=err)
    t0 = time.perf_counter()
    samples = []   # (seconds since start, CPU seconds, resident bytes)
    try:
        while True:
            got = _proc_sample(proc.pid)
            if got is not None:
                samples.append((time.perf_counter() - t0, *got))
            if proc.poll() is not None:
                break
            check(time.perf_counter() - t0 < RUNNER_CHILD_S,
                  f"{name} ended within {RUNNER_CHILD_S} s")
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    exit_t = time.perf_counter()
    with open(out_path) as f:
        steps = [json.loads(line) for line in f if line.startswith("{")]
    with open(err_path) as f:
        err_text = f.read()
    check(proc.returncode == 0,
          f"{name} exit code {proc.returncode} (see {err_path})")
    check("Traceback" not in err_text, f"{name} raised (see {err_path})")
    check(len(steps) > RUNNER_WARMUP, f"{name} printed its steps")
    ms = [st["ms"] for st in steps[RUNNER_WARMUP:]]
    train_s = sum(st["ms"] for st in steps) / 1000.0
    last_t, last_cpu, _ = samples[-1] if samples else (0.0, 0.0, 0)
    # CPU over the training loop: the last sample against the one
    # nearest the loop's start
    t_a, cpu_a, _ = min(samples, key=lambda x: abs(x[0] - (last_t
                                                           - train_s)),
                        default=(0.0, 0.0, 0))
    return {"steps": len(steps), "step_ms_median": statistics.median(ms),
            "step_ms_mean": statistics.mean(ms), "step_ms_max": max(ms),
            "samples": len(ms), "loss_last": steps[-1]["loss"],
            "wall_s": exit_t - t0, "train_s": train_s,
            "peak_rss_bytes": max((x[2] for x in samples), default=0),
            "cpu_s": last_cpu,
            "cpu_per_wall_s": last_cpu / last_t if last_t else 0.0,
            "cpu_per_wall_s_training": (last_cpu - cpu_a) / (last_t - t_a)
            if last_t > t_a else 0.0,
            "exit_t": exit_t, "step_ms_all": [st["ms"] for st in steps]}


def _ingest_settled(qport: int) -> dict:
    """/v1/health once every frame the receiver took is decoded and two
    polls 0.2 s apart agree."""
    t0, prev = time.perf_counter(), None
    while True:
        _, health, _ = _http(qport, "/v1/health")
        st = health["stats"]
        done = sum(d["batches"] + d["errors"] + d["dups"]
                   for d in st["decoders"].values())
        settled = done == st["receiver"]["frames"] - \
            st["receiver"]["dropped"]
        key = (st["receiver"]["frames"], done)
        if settled and key == prev:
            return health
        check(time.perf_counter() - t0 < SERVER_INGEST_S,
              "the server decoded every frame it took")
        prev = key if settled else None
        time.sleep(0.2)


def _closed_port() -> int:
    """A local TCP port with nothing listening on it."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flame_paths(node: dict, pre: tuple = ()):
    here = pre + (node["name"],)
    yield here
    for c in node["children"]:
        yield from _flame_paths(c, here)


def _cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names its first processor: vendor,
    family, model, model name, clock (some kernels report the name as
    "unknown")."""
    keys = ("vendor_id", "cpu family", "model", "model name", "cpu MHz")
    got: dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor only
                k, _, v = line.partition(":")
                if k.strip() in keys:
                    got[k.strip()] = v.strip()
    except OSError:
        pass
    return ", ".join(f"{k}={got[k]}" for k in keys if k in got) or "unknown"


def runner_phase(kernels_per_step_in_process: int, nums: dict) -> None:
    """The example, plain and under the zero-code runner, with the port's
    server ingesting live. kernels_per_step_in_process is phase 4's most
    common kernel count per step; the numbers land in ``nums`` before
    the checks run."""
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "runner_server.log")
    proc = _start_server(log_path)
    try:
        ports = _server_ports(proc)
        qport = ports["query_port"]
        plain = _train_child(
            ["-m", EXAMPLE, *EXAMPLE_ARGS, "--steps", str(PLAIN_STEPS)],
            "plain")
        # the same agent with nothing listening at its server address: no
        # frame leaves the process, so the live child's difference from
        # this one is what live ingest costs the loop
        quiet = _train_child(
            [*RUNNER, "--server", f"127.0.0.1:{_closed_port()}",
             "--service", "llama-train", "-m", EXAMPLE, *EXAMPLE_ARGS,
             "--steps", str(RUNNER_STEPS)], "runner_no_ingest")
        run = _train_child(
            [*RUNNER, "--server", f"127.0.0.1:{ports['ingest_port']}",
             "--service", "llama-train", "-m", EXAMPLE, *EXAMPLE_ARGS,
             "--steps", str(RUNNER_STEPS)], "runner")
        health = _ingest_settled(qport)
        ingest_lag_s = time.perf_counter() - run["exit_t"]
        stats, tables = health["stats"], health["tables"]
        _, steps, _ = _http(qport, "/v1/tpu/steps",
                            {"limit": RUNNER_STEPS + 1})
        steps = steps["result"]["steps"]
        kernels, spans_in_steps = [], 0
        for st in steps:
            code, ans, _ = _http(qport, "/v1/profile/TpuStepTrace", {
                "run_id": st["run_id"], "time_start": st["time"],
                "time_end": st["end_ns"] + 1})
            check(code == 200, f"TpuStepTrace answers 200 ({ans})")
            devs = ans["result"]["devices"]
            # each device's spans less its one module span
            kernels.append(sum(d["n_spans"] - 1 for d in devs.values()))
            spans_in_steps += sum(d["n_spans"] for d in devs.values())
        # consecutive run_ids are one capture's steps
        by_run = sorted(zip((st["run_id"] for st in steps), kernels))
        groups: list[list[int]] = []
        for i, (rid, n) in enumerate(by_run):
            if not i or rid - by_run[i - 1][0] > 1:
                groups.append([])
            groups[-1].append(n)
        captures = len(groups)
        capture_modes = [statistics.mode(g) for g in groups]
        capture_steps = [len(g) for g in groups]
        _, flame, flame_ms = _http(qport, "/v1/profile/TpuFlame", {})
        _, cpu, cpu_ms = _http(qport, "/v1/profile/ProfileTracing",
                               {"app_service": "llama-train"})
    finally:
        _stop_server(proc, log_path)
    flame, cpu = flame["result"], cpu["result"]
    through_main = [p for p in _flame_paths(cpu) if "runpy.run_module" in p
                    and "__main__.main" in p[p.index("runpy.run_module"):]]
    rec, dec = stats["receiver"], stats["decoders"]
    nums.update({
        "agent_overhead_pct": (run["step_ms_median"]
                               - plain["step_ms_median"])
        / plain["step_ms_median"] * 100.0,
        "agent_overhead_mean_pct": (run["step_ms_mean"]
                                    - plain["step_ms_mean"])
        / plain["step_ms_mean"] * 100.0,
        **{f"plain_{k}": v for k, v in plain.items()
           if k not in ("exit_t", "step_ms_all")},
        **{f"runner_{k}": v for k, v in run.items()
           if k not in ("exit_t", "step_ms_all")},
        "live_ingest_pct": (run["step_ms_median"]
                            - quiet["step_ms_median"])
        / quiet["step_ms_median"] * 100.0,
        "live_ingest_mean_pct": (run["step_ms_mean"] - quiet["step_ms_mean"])
        / quiet["step_ms_mean"] * 100.0,
        **{f"no_ingest_{k}": v for k, v in quiet.items()
           if k not in ("exit_t", "step_ms_all")},
        "kernels_per_step_max": max(kernels, default=0),
        "kernels_per_step_mode": statistics.mode(kernels) if kernels else 0,
        "capture_modes": capture_modes, "capture_steps": capture_steps,
        "kernels_per_step_in_process": kernels_per_step_in_process,
        "steps_recorded": len(steps), "captures_seen": captures,
        "spans_in_step_records": spans_in_steps,
        **{t.split(".")[1] + "_rows": n for t, n in tables.items()},
        "acks_sent": rec["acks_sent"], "seq_bases": rec["seq_bases"],
        "frames": rec["frames"], "payload_bytes": rec["bytes"],
        "bad_frames": rec["bad_frames"], "dropped": rec["dropped"],
        "decode_errors": sum(d["errors"] for d in dec.values()),
        "dups": sum(d["dups"] for d in dec.values()),
        "ingest_lag_s": ingest_lag_s, "tpu_flame_ms": flame_ms,
        "profile_tracing_ms": cpu_ms,
        "cpu_stacks_through_main": len(through_main),
        "host_cpu_count": os.cpu_count(), "host_cpu_model": _cpu_model()})
    phase("runner", **{k: v for k, v in nums.items()
                       if not isinstance(v, list)})
    print(f"  captures (most common kernels per step x steps): "
          f"{list(zip(capture_modes, capture_steps))}", flush=True)
    nums.update(runner_step_ms_all=run["step_ms_all"],
                plain_step_ms_all=plain["step_ms_all"],
                no_ingest_step_ms_all=quiet["step_ms_all"],
                kernels_per_step=kernels)
    check(tables["profile.tpu_hlo_span"] > 0, "kernel span rows")
    check(tables["profile.tpu_step_metrics"] > 0, "step record rows")
    check(tables["profile.in_process_profile"] > 0, "CPU profile rows")
    check(tables["deepflow_system.deepflow_system"] > 0, "self-stats rows")
    check(captures >= CAPTURES, f"at least {CAPTURES} captures' steps")
    # the last step of the last capture is recorded only by the probe's
    # stop inside detach: every span in a step record means it arrived
    check(spans_in_steps == tables["profile.tpu_hlo_span"],
          f"every span row ({tables['profile.tpu_hlo_span']}) lies in a "
          f"step record ({spans_in_steps})")
    # a step's count can differ at a window's edge (the loss read of the
    # step before is launched after its optimizer hook), so a capture's
    # whole step is its most common count. Every capture must see every
    # kernel of the step: one that lost a launching thread's device
    # records fails here
    short = [(i, m, n) for i, (m, n) in enumerate(zip(capture_modes,
                                                      capture_steps))
             if m != kernels_per_step_in_process
             and (i < captures - 1 or n >= WHOLE_CAPTURE_STEPS)]
    check(not short,
          f"every capture's whole step holds the in-process path's "
          f"{kernels_per_step_in_process} kernels (short: capture, kernels, "
          f"steps = {short})")
    check(flame["total_value"] > 0 and bool(flame["children"]),
          "TpuFlame has kernels")
    check(bool(through_main),
          "ProfileTracing holds a stack through the example's main")
    check(rec["acks_sent"] > 0, "the receiver acked")
    check(nums["decode_errors"] == 0 and rec["bad_frames"] == 0
          and nums["dups"] == 0 and rec["dropped"] == 0,
          "no decode error, bad or dropped frame, or dup")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from deepflow_tpu_torch.models import llama as tl
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result: dict = {}
    try:
        result["device"] = device_phase(torch)
        model, tokens, result["model"] = model_phase(torch, tl)
        sink, probe, result["training"], window = training_phase(
            torch, tl, model, tokens)
        result["frames"], seen = frames_phase(sink, probe, window)
        seen["max_bytes_in_use"] = result["frames"]["max_bytes_in_use"]
        result["server"] = server_phase(sink, probe, seen)
        # the card's memory to the children
        del model, tokens, sink, probe, seen
        gc.collect()
        torch.cuda.empty_cache()
        result["runner"] = {}
        runner_phase(result["frames"]["kernels_per_step_mode"],
                     result["runner"])
    finally:
        # every number so far, also when a check failed
        result["seconds"] = time.perf_counter() - t0
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(result, f, indent=1)
    # no hand-written kernels in this port yet: the reference has none
    print(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
