#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on the NVIDIA GPUs of one host
(one is enough: the dp, parallel and mp phases take every GPU they see).

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi); then the port's
   native library (the server's span decoder) built from the checkout's
   sources, with the compiler, its version and the build's seconds;
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
5. server: the port's server runs as its own process (the entry point
   of python -m deepflow_tpu_torch.server), takes the same frame bytes over
   one TCP connection, and must hold every span, memory sample and step
   record with no decode error or bad frame, every span frame decoded
   by the native decoder (no batch on the pure path); its TpuFlame
   answer must equal phase 4's flame graph, its step timeline the step
   records, and its memory view phase 4's largest sample. Then DF-SQL over POST
   /v1/query: the top ten ops by device time equal phase 4's per-op
   sums and flame graph, the spans per run_id less its module span
   equal phase 4's kernels per step, SHOW TABLES lists the port's
   tables (the five above, deepflow_system.query_trace, the flow tables
   with their rollups and trace trees, event.event and event.file_agg,
   and the integrations' application_log.log, prometheus.samples,
   prometheus.label_sets and ext_metrics.metrics, empty here, as
   the reference's server lists them), and org_id 1 keeps
   every row, 2
   none. Every query, the six profile
   queries included, must answer in under 1,000 ms; their times print
   beside the columnar stand-in's (PERF.md). In this process the span
   frames then decode both ways, natively and through the pure wire
   path, into rows that must be equal, and into a database of small
   chunks that a janitor sweep with a mid-window cutoff must trim by
   whole chunks: what stays is every row from the oldest kept chunk's
   first on, and TpuFlame over it equals a recount. Ingest rows/s (beside
   the pure decode's from earlier calls), both paths' decode ms and each
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
   the last frame decoded. The live child's default agent runs the guard
   and the deadman too: its agent.guard rows must show two checks or more
   and no degrade (the largest readings are printed: the guard's, the
   agent's threads with the work done while the training step was held,
   and the whole process; and each agent thread's CPU-seconds), no
   agent stage may be wedged, its sender hop must balance with nothing
   pending after the final flush and no HIGH-class frame dropped, and the
   server's own hop ledgers must balance. While the server runs, the
   agent.guard rows read through POST /v1/query must equal the table
   the server hands over after its drain, the spans per run_id of one
   grouped query must equal each step's TpuStepTrace count, and
   python -m deepflow_tpu_torch.cli.dfctl tpu-flame must exit 0 naming
   TpuFlame's top kernel;
7. resilience: phase 2's configuration trains in this process under
   Agent(device="cuda") with a 16-frame send queue, an on-disk spool and
   a guard that checks every second, while nothing listens at the
   agent's server address: HIGH frames overflow into the spool until
   two captures are sent. The port's server process then starts on that
   address; the sender reconnects and replays until every spooled record
   is acked. A guard limit set below any reading pauses the probe and
   the sampler within two checks, and no capture opens while degraded;
   restored limits bring a fresh probe whose first capture must hold
   phase 4's kernels a step. After detach the server must hold every
   step record, span and memory sample both probes sent exactly once,
   every span inside a step record, agent.guard at one degrade and one
   recovery, and a balanced sender hop with no wedge. Step ms during the
   outage, the replay and after it, the guard's readings at every check,
   the peak spool bytes and the time to drain are printed;
8. query (run right after phase 5, while phase 3's frames are at hand):
   DF-SQL at scale. Phase 3's span frames are replayed into a fresh
   server process, each replay re-stamped (times moved by the replay's
   index times the capture's span width, run_id and step by their
   ranges), until its span table holds QUERY_ROWS rows or more; this
   process builds the same rows through the port's span decoder. Three
   dashboard queries (the top ten device-compute kernels by time, the
   time per run_id, the top kernels of one name prefix in the last five
   minutes) run here serially (one scan thread: the expected answer) and
   morsel-parallel, then on the server: EXPLAIN ANALYZE with the cache
   bypassed must name the parallel degree and the morsels and sum its
   stages to within 20 % of its wall time; the cold answer (the cache's
   bucket fill) and the warm one (a cache hit, under 1,000 ms) must equal
   the serial answer; after one more replay, EXPLAIN ANALYZE must show
   only the touched 60 s buckets scanned again, and the answer must
   equal the serial one over the grown table. A native group or filter
   kernel must have run in this process. The rows, chunks, ingest rows/s
   at this size, the server's RSS, the cache's hit rate, each query's
   ms every way and the kernel choices are printed;
9. resnet: ResNet-50 (the reference's ResNetConfig(): stages (3, 4, 6,
   3), width 64, 1000 classes) at full width, bf16, channels_last,
   224 x 224, batch 128, SGD at the reference's lr 0.1, weights and
   images from torch.Generator seeds. Its initial loss is checked
   against ln(1000), its bf16 loss against a float32 forward of the same
   weights, and the tiny float32 ResNet on the card against the CPU;
   then phase 3's profiled steps (step ms without and with the probe,
   coverage, captures) and phase 4's frames (kernels per step, spans/s,
   top kernels, peak memory), whose per-kernel flame graph must equal
   the per-op sums;
10. dp: the example with --preset resnet50 (batch 128 per rank) under
   python -m torch.distributed.run --nproc-per-node N (N = the GPUs
   visible) and the zero-code runner with --controller, shipping live
   into a fresh server process. Every rank must train DP_STEPS steps with
   the same mean loss at each step, its span rows must land under the id
   the controller assigned it (one a rank) with
   device_id = chip_id = rank, exactly as many as its probe sent, its
   stats rows must carry its rank, and the server must see no dup. With
   N >= 2, each all-reduce group of a step every rank captured must have
   N participants, the groups per step must equal the step's all-reduce
   calls the ranks print, and /v1/tpu/steps must name a rank as the
   straggler; with N == 1 (NCCL runs a one-rank all-reduce without a
   kernel) it prints world=1 and the checks that need two GPUs;
11. parallel: chip_parallel.py under python -m torch.distributed.run on
   the N GPUs: the tiny float32 Llama sharded on the mp phase's mesh
   must give the unsharded port's losses and weights on the CPU after
   two steps; ring attention (llama7b() heads, bf16, S = 8192 cut over
   N), the pipeline (four llama7b() layers over N stages, 4
   microbatches) and expert-parallel MoE (d_model 4096, d_ff 11008, 8
   experts, 4096 tokens) must match their dense forms, each timed beside
   them; with N >= 2 a Kineto capture of each, parsed by the port with
   its call log, must classify its NCCL kernels as the collectives it
   issued (send-recvs, all-reduces), one a call;
12. mp: the example with --preset llama7b at MP_LAYERS layers, sharded
   on the (data, fsdp, tensor) mesh (2, 1, N / 2) from four GPUs on,
   else factor_devices(N), under python -m torch.distributed.run: plain,
   then under the runner shipping into a fresh server process. Every
   rank's loss must be equal at every step and its span rows land under
   agent rank + 1 exactly as its probe sent them, with no dup; with N >=
   2, in each step every rank captured each communicator's groups must
   be the calls the ranks printed for it, each with every rank in it and
   the communicator's size as replica_group_size, none mixing two
   communicators. Step ms without and with the agent, the top kernels
   and each rank's peak memory are printed. With N == 1 both phases
   print world=1 and the checks that need two GPUs;
13. flows: the flow/L7 agent on the card's host (chip_flows.py): the 29
   golden captures on both engines; the JAX package's bench traffic
   shape (12,000 flows, 1,188,000 packets) through the native flow map
   on one core, the Python map on a twentieth, and the dispatcher with
   HTTP in its payload slots; that run's L4 logs, L7 logs and documents
   into a server process (rows/s per table; every batch decoded
   natively, and in process both ways into equal rows) and three DF-SQL
   queries held to the in-process answers; the HTTP carries W3C trace
   headers (groups of four flows nest as the tiers of one service), and
   one trace is read through Tempo's /api/traces, found by /api/search
   and the trace-tree search; 256 of the metric documents, each sent
   again every 10 s over three hours, are rolled by a second server's
   rollup job, whose 1m and 1h tiers must fold each key's rows, and a
   two-hour DF-SQL query must take the 1m tier and equal the 1 s
   table's answer, and two PromQL range queries a DF-SQL recount; then,
   where AF_PACKET opens (checked
   first; else "flows live: not run (<errno>)"), the node agent
   (python -m deepflow_tpu_torch.agent --flow --interface lo) beside a
   stdlib HTTP server taking 2,000 requests, which must all land in
   l7_flow_log, and the runner phase's child without and with it: the
   flow-capture cost % and the Guard's readings of the node agent;
14. control: the control plane (chip_control.py). A server process with
   its controller; dfctl org puts job B's agent group in org 2; phase 2's
   configuration trains as two concurrent one-rank launcher jobs on the
   card under the runner with --controller, one group each. Once both
   shipped a long capture, dfctl agent-group-config pushes a new probe
   cadence to both groups. Two distinct controller-assigned ids; every
   span each agent sent held once under its id; every row with the host,
   a nonzero host id and its job's org, and DF-SQL under org 2 sees job
   B only; /v1/agents shows both RUNNING with the card's name and memory
   and a measured clock offset; the push applied by push within 2 s, and
   every capture after it holds at most six steps. Step medians, the
   Guard's readings and the synchronizer threads' CPU are printed.
15. storage (run right after phase 8, with phase 3's frames): the
   durable tier (chip_storage.py). Phase 3's span frames, re-stamped as
   phase 8 re-stamps them, to STORAGE_ROWS rows through the agent's own
   sender with its spool: the first half into a server process without
   storage and into one with --storage (a data directory on the
   checkout's filesystem, its type and free bytes printed, deleted at
   the end); that half's three dashboard queries; a quarter more until
   the acked seq passes the half, SIGKILL with frames in flight, the rest
   into the dead port. Every row of every frame acked before the kill
   must recover from disk; the server restarted on the same port and
   directory must answer the three queries as before the kill, take the
   sender's retransmits and spool, and after the drain hold every
   frame's spans exactly once (counted per frame seq, on disk after a
   clean stop); a compaction run, a ten-minute range that prunes
   segments with the whole range's answer filtered here, and every query
   under 1,000 ms cold (cache bypassed) and warm. Rows/s with storage on
   and off, commit ms, bytes a row, segments per codec, recovery s, the
   server's RSS and query ms are printed.
16. cluster (run right after phase 15, with phase 3's frames): the
   server as a three-shard cluster with --replication 2
   (chip_cluster.py). A solo server and three shards (shard 1 the seed
   with the controller, 2 and 3 joining it), each with --storage; eight
   agents take their analyzers from the seed controller's Sync and ship
   phase 3's span frames, re-stamped as phase 8 re-stamps them, to
   500,000 span rows through replicated senders, the same frames to the
   solo server. Every agent's rows on exactly its two owners; the three
   dashboard queries, an Avg, Count(DISTINCT), a Percentile (2 %),
   TpuFlame and the step timeline through each shard equal to the solo
   server's with no shard missing; after a SIGKILL of shard 3 the same
   through shards 1 and 2 with shard 3 covered; after its restart on its
   ingest port and data directory, the ring's new epoch, every frame
   acked with none dropped and the answers equal again. Rows/s at R = 2
   and R = 1, query ms, the kill-to-exact seconds, the fan-out hops'
   ledgers and each shard's RSS are printed.
18. readtier (run right after phase 16, with phase 3's frames;
   chip_readtier.py): storage that heals itself and reads that scale.
   One --storage ingest shard publishing into an object store every
   second and four --role querier replicas with 16 MiB segment caches;
   four agents ship 2,000,000 span rows; every replica adopts the newest
   pointer and answers the six profile queries and a storm of bucketable
   aggregates equal to the ingest node's; after the first replica warms
   the storm the others scan no bucket (served_buckets ==
   fetched_buckets); then a flipped published segment is quarantined and
   repaired from its blob while a trickle agent ships, a flipped blob is
   re-published, a segment with no healthy copy makes the answers
   degraded with its rows missing until its blob returns, a flipped
   cached copy is discarded and fetched again, fsck ends clean and every
   hop ledger balances. The publish lag, segment-cache counters, query
   ms, storm queries/s at 1, 2 and 4 replicas with the host's cores,
   ack p99 with and without the storm, the flip-to-quarantine and
   flip-to-repair seconds, fsck's MB/s and each replica's RSS are
   printed.
17. enrich (run after phase 14, chip_enrich.py): every flow row names its process
   and its pod. (a) The port's server with its controller in this
   process, the node agent on lo with its socket scan every 2 s, a stdlib
   HTTP server child taking 500 requests, and phase 6's child training
   60 steps under the runner with --controller: every HTTP row names the
   HTTP child (gpid and comm) on side 1, and the training child's flows
   to its server name the child by the gpid its own runner agent's
   registration gave its pid, and the server process; the scan's ms and
   entries are printed. (b) genesis over a stub apiserver of 10,000 pods
   (at most 110 a node) and 1,000 services laid over 10,000 flows of
   phase 13's shape: every row's side tags equal the index's, natively,
   the 1m rollup keeps them, and a pod deleted, a service changed and a
   node added are followed by later rows and land in event.event; rows/s
   with the index empty and loaded. (c) The node agent's labeler takes
   the controller's PodMap once. (d) ignore, pcap and npb ACLs pushed by
   dfctl: no row for the ignored port, captures holding exactly the pcap
   port's frames, VXLAN datagrams of the npb port's frames.

19. integrations (run last, chip_integrations.py): telemetry in and out.
   The server's entry point with its controller in a process of its own;
   phase 3's span frames through the agent's sender with no exporter,
   then with the four dfctl attaches (otlp-json, remote-write, kafka to
   a stub broker, json-lines of event.event), then with a json-lines
   exporter of the span tables too: acked rows/s each way. The node
   agent captures lo; phase 6's child trains 60 steps under the runner
   with -f, its config file turning on the integration proxy, while a
   client process posts a seeded corpus (OTLP traces and logs, app logs,
   remote-write, Telegraf, Datadog, SkyWalking, a folded profile) to the
   proxy and this process sends file-I/O events. Every step row is one
   step span at the OTLP sink, every 1 s flow-metric row reaches the
   remote-write sink, the Kafka messages and json-lines lines equal their
   tables' rows, the posted rows are held exactly, PromQL, Tempo and
   DF-SQL answer them, event.file_agg holds the events' windows, and
   every exporter's ledger balances through a 3 s outage of the OTLP
   sink.

The dp phase's ranks run with --controller too: their ids are the
controller's, one a rank (not rank + 1), found by the rank in each agent's
launcher identity. The runner's agents of phases 10, 14 and 16 run the
socket scan (every 30 s, the reference's default) beside their sync. The servers of phases 5-8, 10, 12-16 and 19 run
the server's entry point (its main(),
stopped by SIGTERM after its drain) in a process of their own
(multiprocessing, spawn) that then hands the smoke their tables' rows.
Every phase line carries the card's name and power limit.

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
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

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
RESILIENCE_QUEUE = 16         # send-queue frames: overflow reaches the spool
RESILIENCE_CAPTURES = 2       # captures sent while the server is away
RESILIENCE_OUTAGE_S = 120.0   # the outage's time limit
RESILIENCE_DRAIN_S = 90.0     # server start to every spooled record acked
RESILIENCE_AFTER_STEPS = 30   # steps timed after the drain
GUARD_CHECK_S = 1.0           # the guard's cadence in the resilience phase
# the resilience phase's CPU limit: that phase drives the pause and the
# resume; the default agent's budget is the runner phase's. A 1 s check
# reads a capture's parse alone near 100 %
GUARD_PHASE_CPU_PCT = 1000.0
# a pause waits for a capture in its parse; a check itself may wait
# seconds for the capture's interpreter lock, so "within two checks" is
# counted in checks, with this as the wall-clock limit
PAUSE_S = 30.0
DEGRADED_STEPS = 20           # steps trained while the guard has paused
OUT_DIR = "results"
RESNET_BATCH = 128            # images a step (a rank's in the dp phase)
RESNET_IMAGE = 224
RESNET_LR = 0.1               # the reference's make_pmap_train_step lr
RESNET_BF16_VS_F32_RTOL = 2e-2  # bf16 rounding through 53 convolutions
DP_STEPS = 300                # steps a rank in the dp phase: room for captures
QUERY_LIMIT_MS = 1000.0       # PERF.md section 2: a person waits for it
# the six TPU queries on the columnar stand-in the engine replaced
# (PERF.md, slice 2's run A), printed beside this run's
COLUMNAR_MS = {"flame": 32.0, "steps": 16.1, "critical_path": 4.5,
                   "step_trace": 453.9, "memory": 6.4, "collectives": 3.2}
# the server's ingest rate with the pure-Python span decode (PERF.md:
# slice 2's run A and slice 5's call 1), printed beside this run's
PURE_INGEST_ROWS_PER_S = {"slice2_run_a": 32021.6, "slice5_call1": 27987.9}
RETENTION_CHUNKS = 8          # the retention check's chunks over phase 3
QUERY_ROWS = 10_000_000       # query phase: span rows, ~39 min of a process
QUERY_WINDOW_NS = 300 * 10**9  # its third query's "last 5 minutes"
QUERY_STAGE_RTOL = 0.20       # EXPLAIN ANALYZE: stage sum against its wall
ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = {"line": ""}           # nvidia-smi's name and power limit


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **numbers) -> None:
    print(f"[{name}] card=\"{CARD['line']}\" "
          + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def device_phase(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    CARD["line"] = line
    print(line, flush=True)
    return {"nvidia_smi": line, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def native_phase() -> dict:
    """The port's native library (the server's span decoder and the query
    kernels), built from the checkout's sources as the server's first use
    would build it."""
    from deepflow_tpu_torch import native
    path = native.library_path()
    prebuilt = os.path.exists(path)
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    version = subprocess.run([native.CXX, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    nums = {"sources": json.dumps(",".join(native.SOURCES)),
            "compiler": json.dumps(" ".join((native.CXX,
                                              *native.CXXFLAGS))),
            "compiler_version": json.dumps(version), "build_s": build_s,
            "prebuilt": prebuilt,
            "library": os.path.relpath(path, ROOT)}
    phase("native", **nums)
    return nums


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


def timed_step(torch, train_step, *batch) -> tuple[float, float]:
    t0 = time.perf_counter()
    loss = float(train_step(*batch))  # reads the loss: waits for the step
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0, loss


def training_phase(torch, train_step, batch: tuple,
                   label: str = "training") -> tuple:
    """Steps of ``train_step(*batch)`` without the probe, with TpuProbe
    attached until CAPTURES captures, and without it again. The phase
    lines are ``label``'s (the Llama's keep their names: training,
    kineto, probe, capture)."""
    from deepflow_tpu_torch.agent.config import AgentConfig, TpuProbeConfig
    from deepflow_tpu_torch.agent.sink import FrameSink
    from deepflow_tpu_torch.tpuprobe.probe import TpuProbe

    pre = "" if label == "training" else f"{label}_"
    for _ in range(3):  # warm-up: allocator, cuBLAS heuristics
        timed_step(torch, train_step, *batch)
    torch.cuda.reset_peak_memory_stats()
    base = [timed_step(torch, train_step, *batch)[0]
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
        ms, loss = timed_step(torch, train_step, *batch)
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
    after = [timed_step(torch, train_step, *batch)[0]
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
    phase(label, **{k: v for k, v in nums.items()
                    if not isinstance(v, (dict, list))})
    phase(f"{pre}kineto", **ks)
    phase(f"{pre}probe", **probe.stats, **{f"sink_{k}": v
                                           for k, v in sink.stats.items()})
    for c in captures:
        phase(f"{pre}capture", **c)
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


def frames_phase(sink, probe, window, label: str = "frames") -> tuple:
    from deepflow_tpu_torch.codec import MessageType, StreamDecoder
    from deepflow_tpu_torch.proto import wire
    from deepflow_tpu_torch.query.flamegraph import DEVICE_KINDS, device_flame
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
    modules_per_step: dict[int, int] = {}
    for s in modules:
        modules_per_step[s.run_id] = modules_per_step.get(s.run_id, 0) + 1
    # device time per op name (module spans under ""), as the server's
    # GROUP BY hlo_op over the device kinds sums it
    op_ns: dict[str, int] = {}
    for s in spans:
        if s.kind in DEVICE_KINDS:
            op_ns[s.hlo_op] = op_ns.get(s.hlo_op, 0) + s.duration_ns
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
    phase(label, **nums)
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
    flame_ops: dict[str, int] = {}
    for name, ns in _kernel_leaves(flame.to_dict()):
        flame_ops[name] = flame_ops.get(name, 0) + ns
    return nums, {"flame": flame.to_dict(), "records": records,
                  "flame_ops": flame_ops, "op_ns": op_ns,
                  "kernels_per_step": per_step,
                  "modules_per_step": modules_per_step}


def _kernel_leaves(node: dict):
    """(name, total ns) of a device flame graph's kernels: its leaves,
    less the "module" leaves of the module spans (module;module)."""
    for c in node["children"]:
        if c["children"]:
            yield from _kernel_leaves(c)
        elif c["name"] != "module":
            yield c["name"], c["total_value"]


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


def _table_rows(srv, name: str, cols: list[str]) -> dict[str, list]:
    t = srv.db.table(name)
    data = t.column_concat(cols)
    return {c: t.dicts[c].decode_many(data[c]) if c in t.dicts
            else data[c].tolist() for c in cols}


def _env_control(ctl) -> None:
    """Apply each {name: value or None} that comes up the control pipe to
    this process's environment (the server reads its DF_QUERY_* knobs
    live), answering each with "ok"."""
    import threading

    def loop() -> None:
        while True:
            try:
                kv = ctl.recv()
            except EOFError:
                return
            for k, v in kv.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            ctl.send("ok")
    threading.Thread(target=loop, name="smoke-env", daemon=True).start()


def _server_child(conn, argv: list[str], log_path: str,
                  dump: dict[str, list[str]], ctl=None) -> None:
    """The server's entry point (deepflow_tpu_torch.server's main, with
    its own SIGTERM handling and drain) in this process, its output into
    log_path. Its ports go up the pipe once it listens, and the rows of
    the tables in ``dump`` once main has drained and returned. ``ctl``,
    when given, sets environment variables while it runs."""
    with open(log_path, "w") as log:
        sys.stdout = sys.stderr = log
        from deepflow_tpu_torch.server import server as server_mod
        started = []

        def on_start(srv) -> None:
            started.append(srv)
            if ctl is not None:
                _env_control(ctl)
            conn.send({"ingest_port": srv.ingest_port,
                       "query_port": srv.query_port,
                       "sync_port": srv.sync_port})
        server_mod.main(argv, on_start=on_start)
        conn.send({name: _table_rows(started[0], name, cols)
                   for name, cols in dump.items()})


class _ServerProcess:
    """The port's server in a process of its own (multiprocessing, spawn)
    on ``ingest_port`` (0: any free one), its log in ``log_path``, with
    the entry point's ``extra_args``; its stop hands back the rows of the
    tables in ``dump`` (name: columns)."""

    def __init__(self, log_path: str, ingest_port: int = 0,
                 dump: dict[str, list[str]] | None = None,
                 env_control: bool = False,
                 extra_args: list[str] | None = None) -> None:
        self.log_path = log_path
        self.dump = dump or {}
        self._stopped = False
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._ctl, child_ctl = ctx.Pipe() if env_control else (None, None)
        # the entry point's controller on a free port (phases run
        # servers side by side)
        argv = ["--ingest-port", str(ingest_port), "--query-port", "0",
                "--sync-port", "0"] + list(extra_args or ())
        self._proc = ctx.Process(target=_server_child,
                                 args=(child, argv, log_path, self.dump,
                                       child_ctl),
                                 name="df-smoke-server", daemon=True)
        t0 = time.perf_counter()
        self._proc.start()
        child.close()
        try:
            check(self._conn.poll(SERVER_START_S),
                  f"the server process listens (see {log_path})")
            try:
                ports = self._conn.recv()
            except EOFError:
                check(False, f"the server process exited before it "
                      f"listened (see {log_path})")
        except BaseException:
            self._proc.kill()
            self._proc.join()
            raise
        self.start_s = time.perf_counter() - t0
        self.ingest_port = ports["ingest_port"]
        self.query_port = ports["query_port"]
        self.sync_port = ports["sync_port"]
        self.pid = self._proc.pid

    def setenv(self, **kv) -> None:
        """Set (a str) or unset (None) environment variables of the
        running server: its DF_QUERY_* knobs are read live."""
        self._ctl.send(kv)
        check(self._ctl.poll(30) and self._ctl.recv() == "ok",
              f"the server took the environment {kv}")

    def kill(self) -> None:
        """SIGKILL: the server dies at once, with whatever it holds in
        flight; nothing is checked."""
        self._stopped = True
        self._proc.kill()
        self._proc.join(60)
        self._conn.close()
        if self._ctl is not None:
            self._ctl.close()

    def stop(self) -> dict[str, dict[str, list]]:
        """SIGTERM: the server drains its decoders, hands over its rows
        and must exit 0 with no exception logged. Once only; a second
        call returns nothing."""
        if self._stopped:
            return {}
        self._stopped = True
        self._proc.terminate()
        rows: dict = {}
        try:
            if self._conn.poll(60):
                rows = self._conn.recv()
        except EOFError:
            pass
        self._proc.join(60)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        self._conn.close()
        if self._ctl is not None:
            self._ctl.close()
        with open(self.log_path) as f:
            log_text = f.read()
        check(self._proc.exitcode == 0,
              f"server exit code {self._proc.exitcode}")
        check("Traceback" not in log_text and " ERROR " not in log_text,
              f"server logged no exception (see {self.log_path})")
        check(set(rows) == set(self.dump),
              f"the server handed over its rows ({sorted(rows)})")
        return rows


def _latest_and_max(rows: dict, metric: str) -> tuple[dict, dict]:
    """deepflow_system rows of one metric: per value name, the latest
    value and the largest."""
    latest: dict[str, tuple[int, float]] = {}
    most: dict[str, float] = {}
    for name, t, vname, v in zip(rows["metric_name"], rows["time"],
                                 rows["value_name"], rows["value"]):
        if name != metric:
            continue
        if vname not in latest or t >= latest[vname][0]:
            latest[vname] = (t, v)
        most[vname] = max(most.get(vname, v), v)
    return {k: v for k, (_, v) in latest.items()}, most


_SELFSTATS = "deepflow_system.deepflow_system"
_SELFSTATS_COLS = ["metric_name", "time", "value_name", "value"]


def server_phase(sink, probe, seen) -> dict:
    """The frames of phase 3 through the port's own server process."""
    import socket
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "server.log")
    want = {"deepflow_system.deepflow_system": 0,
            # the querier's own spans: no query has run yet
            "deepflow_system.query_trace": 0,
            # the flow tables (the flows phase fills them), their rollup
            # tiers and the trace trees the server derives from them
            "flow_log.l4_flow_log": 0, "flow_log.l7_flow_log": 0,
            "flow_log.trace_tree": 0,
            # the resource recorder's events (no cluster here), the
            # file-I/O windows and the integrations' tables (phase 19
            # fills them)
            "event.event": 0, "event.file_agg": 0,
            "application_log.log": 0, "prometheus.samples": 0,
            "prometheus.label_sets": 0, "ext_metrics.metrics": 0,
            **{f"flow_metrics.{fam}.{sfx}": 0
               for fam in ("application", "network")
               for sfx in ("1s", "1m", "1h", "1d")},
            "profile.in_process_profile": 0,
            "profile.tpu_hlo_span": probe.stats["spans_sent"],
            "profile.tpu_memory": probe.stats["mem_samples_sent"],
            "profile.tpu_step_metrics": probe.stats["steps_sent"]}
    data = b"".join(sink.frames)
    span_items = _span_frames(data)
    srv = _ServerProcess(log_path)
    try:
        qport = srv.query_port
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", srv.ingest_port),
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
        spans_dec = stats["decoders"]["TPU_SPAN"]
        check(spans_dec["pure_batches"] == 0
              and spans_dec["native_batches"] == len(span_items),
              f"every span frame ({len(span_items)}) decoded natively "
              f"({spans_dec})")
        check(stats["janitor"]["rows_trimmed"] == 0,
              f"the janitor kept this run's rows ({stats['janitor']})")

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
        sql_ms = _sql_checks(qport, seen, want)
    finally:
        srv.stop()
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
            "collectives": len(answers["collectives"]), **query_ms,
            **sql_ms, "span_frames": len(span_items),
            "native_batches": spans_dec["native_batches"],
            "pure_batches": spans_dec["pure_batches"],
            **decode_both_ways(span_items), **retention_check(span_items)}
    phase("server", **nums)
    phase("server ingest", ingest_rows_per_s=round(nums["ingest_rows_per_s"],
                                                    1),
          native_decode_ms=round(nums["native_decode_ms"], 3),
          pure_decode_ms=round(nums["pure_decode_ms"], 3),
          **{f"pure_ingest_rows_per_s_{k}": v
             for k, v in PURE_INGEST_ROWS_PER_S.items()})
    # the six TPU queries on the engine beside the columnar stand-in's
    # times (PERF.md, slice 2's run A: another call, no comparison)
    phase("server queries", **{f"{k}_ms": round(query_ms[f"{k}_ms"], 3)
                               for k in COLUMNAR_MS},
          **{f"{k}_columnar_ms": v for k, v in COLUMNAR_MS.items()},
          **{k: round(v, 3) for k, v in sql_ms.items()})
    slow = {k: v for k, v in {**query_ms, **sql_ms}.items()
            if k.endswith("_ms") and v >= QUERY_LIMIT_MS}
    check(not slow, f"every query under {QUERY_LIMIT_MS} ms ({slow})")
    return nums


def _span_frames(data: bytes) -> list:
    """(header, payload) of every TPU_SPAN frame in the byte stream."""
    from deepflow_tpu_torch.codec import MessageType, StreamDecoder
    return [(h, p) for h, p in StreamDecoder().feed(data)
            if h.msg_type == MessageType.TPU_SPAN]


def _db_rows(db, name: str) -> list:
    """A table's rows in storage order, strings decoded."""
    t = db.table(name)
    cols = t.column_concat(list(t.columns))
    return list(zip(*(t.dicts[c].decode_many(a) if c in t.dicts
                      else a.tolist() for c, a in cols.items())))


def decode_both_ways(items: list) -> dict:
    """Phase 3's span frames through the server's span decoder in this
    process, once natively and once through the pure ``wire`` path, each
    into a database of its own: the rows must be equal. Returns each
    path's decode ms (its wall time less its store appends), append ms
    and rows per second."""
    from deepflow_tpu_torch.server.decoders import TpuSpanDecoder
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.store.db import Database
    out, dbs = {}, {}
    for path in ("native", "pure"):
        dec = TpuSpanDecoder(None, Database(), PlatformInfoTable())
        handle = dec.handle if path == "native" else dec.handle_pure
        t0 = time.perf_counter_ns()
        rows = sum(handle(h, p) for h, p in items)
        wall_ns = time.perf_counter_ns() - t0
        out[f"{path}_decode_ms"] = (wall_ns - dec.stats["append_ns"]) / 1e6
        out[f"{path}_append_ms"] = dec.stats["append_ns"] / 1e6
        out[f"{path}_rows_per_s"] = rows / (wall_ns / 1e9)
        dbs[path] = dec.db
        if path == "native":
            check(dec.stats["pure_batches"] == 0, "in process, every span "
                  f"frame decodes natively ({dec.stats})")
    for name in ("profile.tpu_hlo_span", "profile.tpu_memory"):
        check(_db_rows(dbs["native"], name) == _db_rows(dbs["pure"], name),
              f"{name}: the native path's rows equal the pure path's")
    return out


def retention_check(items: list) -> dict:
    """Phase 3's span frames into a port Database whose chunks hold a
    RETENTION_CHUNKS-th of the span rows, and one janitor sweep whose
    cutoff falls mid-window: it drops whole sealed chunks only, so what
    stays is every row from the oldest kept chunk's first row on, and
    TpuFlame over it equals a recount of those spans."""
    from deepflow_tpu_torch.proto import wire
    from deepflow_tpu_torch.query.flamegraph import device_flame
    from deepflow_tpu_torch.server.decoders import TpuSpanDecoder
    from deepflow_tpu_torch.server.janitor import Janitor
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.server.querier import QuerierAPI
    from deepflow_tpu_torch.store.db import Database
    spans = [s for _, p in items
             for s in wire.TpuSpanBatch.FromString(p).spans]
    db = Database(chunk_rows=max(1, len(spans) // RETENTION_CHUNKS))
    dec = TpuSpanDecoder(None, db, PlatformInfoTable())
    for h, p in items:
        dec.handle(h, p)
    t = db.table("profile.tpu_hlo_span")
    before = t.column_concat(["time"])["time"]
    chunks = len(t.snapshot())
    ttl_s = 3600
    mid_ns = (int(before.min()) + int(before.max())) // 2
    now_s = mid_ns / 1e9 + ttl_s
    t0 = time.perf_counter()
    trimmed = Janitor(db, ttl_s={t.name: ttl_s}).sweep(now_s=now_s)
    sweep_ms = (time.perf_counter() - t0) * 1000.0
    cutoff = int((now_s - ttl_s) * 1e9)
    after = t.column_concat(["time"])["time"]
    check(0 < trimmed < len(before),
          f"the mid-window sweep trimmed {trimmed} of {len(before)} rows")
    check(len(after) == len(before) - trimmed == len(t),
          "the table's row count is its live rows")
    check(after.tolist() == before[trimmed:].tolist(),
          "what stays is every row from the oldest kept chunk's first on")
    check(int(before[:trimmed].max()) < cutoff,
          "every trimmed row is older than the cutoff")
    flame = QuerierAPI(db).tpu_flame({})["result"]
    check(_canon_flame(flame)
          == _canon_flame(device_flame(spans[trimmed:]).to_dict()),
          "TpuFlame over what stays equals a recount of those spans")
    return {"retention_chunks": chunks, "retention_rows": len(before),
            "retention_trimmed": trimmed, "retention_sweep_ms": sweep_ms}


def _sql_checks(qport: int, seen: dict, want: dict) -> dict:
    """DF-SQL over POST /v1/query on phase 4's rows: the top kernels by
    device time equal phase 4's flame graph, the spans per run_id less
    its module spans equal phase 4's kernels per step, SHOW TABLES lists
    the port's tables (the reference server's list cut to the port's:
    those of ``want``), and org 1 scoping keeps every row, org 2 none.
    Returns each query's wall ms and its table's rows."""
    from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
    kinds = ", ".join(f"'{k}'" for k in TPU_SPAN_KINDS
                      if k.startswith("device-"))
    per_run = ("SELECT run_id, Count(*) AS n FROM profile.tpu_hlo_span "
               "GROUP BY run_id")
    bodies = {
        "sql_top_kernels": {
            "sql": "SELECT hlo_op, Sum(duration_ns) AS d FROM "
                   f"profile.tpu_hlo_span WHERE kind IN ({kinds}) "
                   "GROUP BY hlo_op ORDER BY d DESC LIMIT 10"},
        "sql_per_step": {"sql": per_run},
        "sql_show_tables": {"sql": "SHOW tables"},
        "sql_per_step_org1": {"sql": per_run, "org_id": 1},
        "sql_per_step_org2": {"sql": per_run, "org_id": 2}}
    res, out = {}, {"sql_span_rows": want["profile.tpu_hlo_span"]}
    for name, body in bodies.items():
        code, ans, ms = _http(qport, "/v1/query", body)
        check(code == 200, f"/v1/query {name} answers 200 ({ans})")
        res[name], out[f"{name}_ms"] = ans["result"]["values"], ms
    top = res["sql_top_kernels"]
    op_ns, flame_ops = seen["op_ns"], seen["flame_ops"]
    check(len(top) == min(10, len(op_ns))
          and all(int(d) == op_ns[op] for op, d in top)
          and [int(d) for _, d in top]
          == sorted(op_ns.values(), reverse=True)[:len(top)],
          f"the SQL top kernels' device time equals phase 4's ({top})")
    check(all(int(d) == flame_ops[op] for op, d in top if op),
          "each SQL top kernel's time equals its flame graph leaves'")
    first = next(op for op, _ in top if op)
    check(flame_ops[first] == max(flame_ops.values()),
          f"the SQL's top kernel {first!r} tops phase 4's flame graph")
    counts = {int(r): int(n) for r, n in res["sql_per_step"]}
    mods = seen["modules_per_step"]
    kernels = {r: n - mods.get(r, 0) for r, n in counts.items()}
    check(kernels == seen["kernels_per_step"],
          "spans per run_id less its module spans == phase 4's kernels "
          "per step")
    out["sql_kernels_per_step_mode"] = statistics.mode(kernels.values())
    check(out["sql_kernels_per_step_mode"]
          == statistics.mode(seen["kernels_per_step"].values()),
          "the most common SQL count equals phase 4's kernels per step")
    check(sorted(r[0] for r in res["sql_show_tables"]) == sorted(want),
          f"SHOW tables lists the port's tables ({res['sql_show_tables']})")
    check(res["sql_per_step_org1"] == res["sql_per_step"]
          and res["sql_per_step_org2"] == [],
          "org_id 1 keeps every row, org_id 2 none")
    return out

# -- phase 8: DF-SQL at scale ----------------------------------------------

# TpuSpan field numbers (proto/wire.py declares fields in number order)
_START_F, _RUN_F, _STEP_F = 1, 14, 18
_RESTAMP_BASE = 1 << 14   # run_id and step move into 3-byte varints
_RESTAMP_LIMIT = 1 << 21  # ... and must stay there


def _varint_at(buf: bytes, i: int) -> tuple[int, int]:
    """(value, end) of the varint at i."""
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, i
        shift += 7


def _span_varints(data: bytes) -> dict[int, tuple[list, list, list]]:
    """Per re-stamped field number: the (offset, length, value) of its
    varint in every span of a serialized TpuSpanBatch, in span order."""
    out = {f: ([], [], []) for f in (_START_F, _RUN_F, _STEP_F)}
    i, n = 0, len(data)
    while i < n:
        tag, i = _varint_at(data, i)
        ln, i = _varint_at(data, i)
        end = i + ln
        if tag != (1 << 3 | 2):  # only spans: memory samples were dropped
            raise ValueError(f"unexpected batch field tag {tag}")
        seen = set()
        while i < end:
            tag, i = _varint_at(data, i)
            num, wt = tag >> 3, tag & 7
            if wt == 0:
                j = i
                v, i = _varint_at(data, i)
                if num in out:
                    seen.add(num)
                    for lst, x in zip(out[num], (j, i - j, v)):
                        lst.append(x)
            elif wt == 2:
                ln, i = _varint_at(data, i)
                i += ln
            else:
                raise ValueError(f"unexpected wire type {wt}")
        check(seen == set(out), "every re-stamped span carries start_ns, "
              "run_id and step")
    return out


def _put_varints(buf: np.ndarray, offs: np.ndarray, vals: np.ndarray,
                 width: int) -> None:
    """Write each value as a varint of exactly ``width`` bytes at its
    offset (the value must need no more)."""
    for k in range(width):
        byte = ((vals >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        if k < width - 1:
            byte |= np.uint8(0x80)
        buf[offs + k] = byte


class _Replays:
    """Phase 3's span frames, re-stamped per replay without re-encoding:
    replay r moves every span's start by r times the capture's span
    width, and its run_id and step by r times their own range, in place
    in fixed-width varints (start_ns takes 9 bytes; run_id and step are
    first moved up by 2**14 into 3 bytes). Memory samples are left out."""

    def __init__(self, items: list) -> None:
        from deepflow_tpu_torch.proto import wire
        self.headers, self.bases, self.fields = [], [], []
        end_ns = 0
        for h, p in items:
            batch = wire.TpuSpanBatch.FromString(p)
            if not batch.spans:
                continue
            for sp in batch.spans:
                sp.run_id += _RESTAMP_BASE
                sp.step += _RESTAMP_BASE
                end_ns = max(end_ns, sp.start_ns + sp.duration_ns)
            batch.memory = []
            data = batch.SerializeToString()
            found = _span_varints(data)
            self.headers.append(h)
            self.bases.append(np.frombuffer(data, dtype=np.uint8))
            self.fields.append({f: tuple(np.asarray(x, dtype=dt) for x, dt
                                         in zip(v, (np.int64, np.int64,
                                                    np.uint64)))
                                for f, v in found.items()})
        starts = np.concatenate([f[_START_F][2] for f in self.fields])
        runs = np.concatenate([f[_RUN_F][2] for f in self.fields])
        steps = np.concatenate([f[_STEP_F][2] for f in self.fields])
        self.rows = len(starts)
        self.width_ns = end_ns - int(starts.min()) + 10**6
        self.run_stride = int(runs.max() - runs.min()) + 1
        self.step_stride = int(steps.max() - steps.min()) + 1
        self._top = (int(starts.max()), int(runs.max()), int(steps.max()))
        for f in self.fields:
            check(bool((f[_START_F][1] == 9).all()
                       and (f[_RUN_F][1] == 3).all()
                       and (f[_STEP_F][1] == 3).all()),
                  "start_ns in 9-byte varints, run_id and step in 3")

    def check_room(self, replays: int) -> None:
        top_t, top_run, top_step = self._top
        check(top_t + replays * self.width_ns < 1 << 63
              and top_t >= 1 << 56
              and top_run + replays * self.run_stride < _RESTAMP_LIMIT
              and top_step + replays * self.step_stride < _RESTAMP_LIMIT,
              f"{replays} replays keep every re-stamped varint's width")

    def payloads(self, r: int):
        """(header, payload) of replay r's batches."""
        shift = {_START_F: r * self.width_ns, _RUN_F: r * self.run_stride,
                 _STEP_F: r * self.step_stride}
        for h, base, fields in zip(self.headers, self.bases, self.fields):
            buf = base.copy()
            for f, (offs, lens, vals) in fields.items():
                _put_varints(buf, offs, vals + np.uint64(shift[f]),
                             int(lens[0]))
            yield h, buf.tobytes()


def _query_sqls(table, kinds_label: str, top_op: str) -> dict[str, str]:
    """The three dashboard queries over the span table: the top kernels,
    the time per step, and the top kernels of one name prefix in the
    last five minutes."""
    t_max = int(table.column_concat(["time"])["time"].max())
    pat = top_op[:5].replace("%", "_") + "%"
    span = "profile.tpu_hlo_span"
    return {
        "top_kernels":
            "SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n FROM "
            f"{span} WHERE kind = '{kinds_label}' GROUP BY hlo_op "
            "ORDER BY d DESC LIMIT 10",
        "per_step":
            f"SELECT run_id, Sum(duration_ns) AS d, Count() AS n FROM "
            f"{span} GROUP BY run_id",
        "recent_prefix":
            "SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n FROM "
            f"{span} WHERE time >= {t_max - QUERY_WINDOW_NS} AND hlo_op "
            f"LIKE '{pat}' GROUP BY hlo_op ORDER BY d DESC LIMIT 10"}


def _count_kernels(engine) -> dict:
    """Count, in this process, each cost model's observations per kernel
    choice (one per kernel call): {"group.native": n, ...}."""
    counts: dict[str, int] = {}
    for name, model in (("group", engine._COST), ("filter", engine._FILT),
                        ("degree", engine._DEGREE)):
        def observe(kernel, n, ns, _orig=model.observe, _name=name):
            key = f"{_name}.{kernel}"
            counts[key] = counts.get(key, 0) + 1
            _orig(kernel, n, ns)
        model.observe = observe
    return counts


def _timed_local(engine, table, sql: str, env: dict) -> tuple:
    """(answer, ms) of one query in this process under env."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        res = engine.execute(table, sql)
        return res.to_dict(), (time.perf_counter() - t0) * 1000.0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _server_query(qport: int, sql: str) -> tuple[dict, float]:
    code, ans, ms = _http(qport, "/v1/query", {"sql": sql})
    check(code == 200, f"/v1/query answers 200 ({ans})")
    return ans, ms


def _send_frames(port: int, frames: list[bytes]) -> "threading.Thread":
    import socket
    import threading

    def run() -> None:
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=60) as conn:
            for fr in frames:
                conn.sendall(fr)
    th = threading.Thread(target=run, name="smoke-replay", daemon=True)
    th.start()
    return th


def _wait_rows(srv, table: str, n: int, t0: float) -> float:
    """Seconds from t0 to the server holding n rows of the table."""
    while True:
        _, health, _ = _http(srv.query_port, "/v1/health")
        if health["tables"][table] >= n:
            check(health["tables"][table] == n,
                  f"the server holds {n} {table} rows "
                  f"({health['tables'][table]})")
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < SERVER_INGEST_S,
              f"{n} rows reach the server")
        time.sleep(0.05)


def query_phase(sink) -> dict:
    """Phase 3's span frames replayed, re-stamped, into a fresh server
    until its span table holds QUERY_ROWS rows or more, and built the same
    way in this process; then three dashboard queries, each timed
    serially and morsel-parallel in this process (the serial answer is
    the expected one), as the server's cold EXPLAIN ANALYZE with the
    cache bypassed, its cold answer, its warm answer (a cache hit) and,
    after one more replay, its answer with only the touched 60 s buckets
    scanned again."""
    from deepflow_tpu_torch.codec import FrameHeader, MessageType, \
        encode_frame
    from deepflow_tpu_torch.query import engine
    from deepflow_tpu_torch.server.decoders import TpuSpanDecoder
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.store.db import Database
    from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
    span_t = "profile.tpu_hlo_span"
    t_setup = time.perf_counter()
    rep = _Replays(_span_frames(b"".join(sink.frames)))
    n_rep = -(-QUERY_ROWS // rep.rows)
    rep.check_room(n_rep + 1)

    def frames_of(r: int) -> list[bytes]:
        return [encode_frame(FrameHeader(MessageType.TPU_SPAN), p)
                for _, p in rep.payloads(r)]
    frames = [fr for r in range(n_rep) for fr in frames_of(r)]
    setup_s = time.perf_counter() - t_setup
    db = Database()
    local = db.table(span_t)
    dec = TpuSpanDecoder(None, db, PlatformInfoTable())
    os.makedirs(OUT_DIR, exist_ok=True)
    srv = _ServerProcess(os.path.join(OUT_DIR, "query_server.log"),
                         env_control=True)
    nums: dict = {}
    try:
        t0 = time.perf_counter()
        sender = _send_frames(srv.ingest_port, frames)
        t_local = time.perf_counter()
        for r in range(n_rep):
            for h, p in rep.payloads(r):
                dec.handle(h, p)
        local_build_s = time.perf_counter() - t_local
        rows = len(local)
        ingest_s = _wait_rows(srv, span_t, rows, t0)
        sender.join(60)
        del frames
        snap = local.snapshot()
        sizes = [len(ch["time"]) for ch in snap]
        chunks = len(sizes)
        table_bytes = sum(a.nbytes for ch in snap for a in ch.values())
        del snap
        # chunks seal at batch granularity: each sealed one holds
        # chunk_rows rows or more (the last may be the open buffer)
        check(rows >= QUERY_ROWS and min(sizes[:-1]) >= local.chunk_rows,
              f"{rows} span rows in {chunks} chunks of {local.chunk_rows} "
              f"rows or more")
        nums.update(rows=rows, chunks=chunks,
                    chunk_rows_max=max(sizes), table_bytes=table_bytes,
                    replays=n_rep,
                    rows_per_replay=rep.rows, replay_width_s=rep.width_ns
                    / 1e9, setup_s=setup_s, local_build_s=local_build_s,
                    ingest_s=ingest_s, ingest_rows_per_s=rows / ingest_s,
                    cpu_count=os.cpu_count(), host_cpu=_cpu_model())
        phase("query build", **nums)

        counts = _count_kernels(engine)
        top = engine.execute(local, "SELECT hlo_op, Sum(duration_ns) AS d "
                             f"FROM t WHERE kind = '{TPU_SPAN_KINDS[1]}' "
                             "AND hlo_op != '' GROUP BY hlo_op ORDER BY d "
                             "DESC LIMIT 1").values
        check(bool(top), "a device-compute kernel to filter on")
        sqls = _query_sqls(local, TPU_SPAN_KINDS[1], top[0][0])
        serial = {}
        for name, sql in sqls.items():
            want, s_ms = _timed_local(engine, local, sql,
                                      {"DF_QUERY_THREADS": "1"})
            got, p_ms = _timed_local(engine, local, sql,
                                     {"DF_QUERY_PARALLEL": "1"})
            check(got == want, f"{name}: the morsel-parallel answer in "
                  "this process equals the serial one")
            check(bool(want["values"]), f"{name} answers rows")
            serial[name] = want
            nums[name] = {"serial_ms": s_ms, "parallel_ms": p_ms,
                          "speedup": s_ms / p_ms,
                          "answer_rows": len(want["values"])}
        for name, sql in sqls.items():
            q = nums[name]
            # cold, cache bypassed: the morsel-parallel scan, traced
            srv.setenv(DF_QUERY_CACHE="0", DF_QUERY_PARALLEL="1")
            code, ex, q["explain_ms"] = _http(
                srv.query_port, "/v1/query",
                {"sql": f"EXPLAIN ANALYZE {sql}"})
            srv.setenv(DF_QUERY_CACHE=None, DF_QUERY_PARALLEL=None)
            check(code == 200, f"EXPLAIN ANALYZE {name} answers ({ex})")
            ex = ex["explain"]
            plan = ex["plan"]
            stage_ms = sum(st["wall_ms"] for st in ex["stages"])
            q.update(morsel_degree=plan.get("morsel_degree"),
                     morsels=plan.get("morsels"),
                     scan_mode=plan.get("scan_mode"),
                     explain_total_ms=ex["total_ms"],
                     explain_stage_ms=stage_ms)
            check(plan.get("scan_mode") == "parallel"
                  and plan.get("morsel_degree", 0) > 1
                  and plan.get("morsels", 0) >= chunks,
                  f"{name}: EXPLAIN ANALYZE names the parallel degree and "
                  f"the morsels ({plan})")
            check(abs(stage_ms - ex["total_ms"]) <= QUERY_STAGE_RTOL
                  * ex["total_ms"], f"{name}: stages sum to {stage_ms} ms "
                  f"of {ex['total_ms']} ms")
            check(ex["rows_returned"] == len(serial[name]["values"]),
                  f"{name}: EXPLAIN ANALYZE returned the serial rows")
            ans, q["cold_ms"] = _server_query(srv.query_port, sql)
            check(ans["result"] == serial[name],
                  f"{name}: the server's cold answer equals the serial one")
            ans, q["warm_ms"] = _server_query(srv.query_port, sql)
            check(ans["result"] == serial[name],
                  f"{name}: the server's warm answer equals the serial one")
        _, h_warm, _ = _http(srv.query_port, "/v1/health")
        check(h_warm["query_cache"]["hits"] == len(sqls),
              f"each warm answer was a cache hit ({h_warm['query_cache']})")

        # one more replay: a few buckets change
        before = local.bucket_marks()[1]
        t1 = time.perf_counter()
        _send_frames(srv.ingest_port, frames_of(n_rep)).join(60)
        for h, p in rep.payloads(n_rep):
            dec.handle(h, p)
        after = local.bucket_marks()[1]
        touched = sorted(b for b, m in after.items() if before.get(b) != m)
        _wait_rows(srv, span_t, len(local), t1)
        for name, sql in sqls.items():
            q = nums[name]
            want, _ = _timed_local(engine, local, sql,
                                   {"DF_QUERY_THREADS": "1"})
            code, ex, q["append_ms"] = _http(
                srv.query_port, "/v1/query",
                {"sql": f"EXPLAIN ANALYZE {sql}"})
            check(code == 200, f"EXPLAIN ANALYZE {name} answers ({ex})")
            ex = ex["explain"]
            detail = next(st["detail"] for st in ex["stages"]
                          if st["stage"] == "execute")
            q.update(buckets=detail.get("buckets"),
                     buckets_rescanned=detail.get("bucket_stale"),
                     append_cache=ex["plan"].get("cache_outcome"))
            check(ex["plan"].get("cache_outcome") == "stale"
                  and detail.get("buckets") == len(after)
                  and detail.get("bucket_stale") == len(touched),
                  f"{name}: after the append only the {len(touched)} "
                  f"touched buckets were scanned again ({detail})")
            ans, q["after_append_hit_ms"] = _server_query(srv.query_port,
                                                          sql)
            check(ans["result"] == want, f"{name}: the server's answer "
                  "over the grown table equals the serial one")
            phase(f"query {name}", **q)
        _, health, _ = _http(srv.query_port, "/v1/health")
        qc = health["query_cache"]
        lookups = qc["hits"] + qc["misses"] + qc["stale"] + qc["bypass"]
        sample = _proc_sample(srv.pid)
        nums.update(
            rows_after_append=len(local), touched_buckets=len(touched),
            buckets=len(after), cache_hits=qc["hits"],
            cache_lookups=lookups, cache_hit_rate=qc["hits"] / lookups,
            bucket_hits=qc["bucket_hits"], bucket_misses=qc["bucket_misses"],
            server_rss_bytes=sample[1] if sample else 0,
            server_degree=health["query"]["degree"],
            server_pool=[health["query"]["pool_threads"],
                         health["query"]["pool_dispatched"]],
            kernels=dict(counts))
    finally:
        srv.stop()
    check(counts.get("group.native", 0) + counts.get("filter.native", 0)
          > 0, f"a native group or filter kernel ran ({counts})")
    slow = {k: v["warm_ms"] for k, v in nums.items()
            if isinstance(v, dict) and "warm_ms" in v
            and v["warm_ms"] >= QUERY_LIMIT_MS}
    check(not slow, f"every warm answer under {QUERY_LIMIT_MS} ms ({slow})")
    phase("query", **{k: v for k, v in nums.items()
                      if not isinstance(v, dict)}, kernels=json.dumps(counts))
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


def _train_child(args: list[str], name: str, on_spawn=None) -> dict:
    """Run one training child to its end while sampling its /proc every
    0.1 s (CPU time and resident memory; the last sample may be of the
    exited child, whose CPU time is final); parse its per-step JSON
    lines. ``on_spawn(pid)``, when given, runs once the child exists."""
    out_path = os.path.join(OUT_DIR, f"{name}.out")
    err_path = os.path.join(OUT_DIR, f"{name}.err")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                stdout=out, stderr=err)
    if on_spawn is not None:
        on_spawn(proc.pid)
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
    srv = _ServerProcess(os.path.join(OUT_DIR, "runner_server.log"),
                         dump={_SELFSTATS: _SELFSTATS_COLS})
    try:
        qport = srv.query_port
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
            [*RUNNER, "--server", f"127.0.0.1:{srv.ingest_port}",
             "--service", "llama-train", "-m", EXAMPLE, *EXAMPLE_ARGS,
             "--steps", str(RUNNER_STEPS)], "runner")
        health = _ingest_settled(qport)
        ingest_lag_s = time.perf_counter() - run["exit_t"]
        stats, tables = health["stats"], health["tables"]
        # the agent's guard rows and the spans per run_id through DF-SQL,
        # while the server runs
        sql = {"guard": {"db": "deepflow_system", "sql":
                         "SELECT metric_name, time, value_name, value "
                         "FROM deepflow_system "
                         "WHERE metric_name = 'agent.guard'"},
               "per_step": {"sql": "SELECT run_id, Count(*) AS n FROM "
                                   "profile.tpu_hlo_span GROUP BY run_id"}}
        sql_rows, sql_ms = {}, {}
        for name, body in sql.items():
            code, ans, sql_ms[f"sql_{name}_ms"] = _http(qport, "/v1/query",
                                                        body)
            check(code == 200, f"/v1/query {name} answers 200 ({ans})")
            sql_rows[name] = ans["result"]["values"]
        _, steps, _ = _http(qport, "/v1/tpu/steps",
                            {"limit": RUNNER_STEPS + 1})
        steps = steps["result"]["steps"]
        kernels, spans_in_steps, trace_spans = [], 0, {}
        for st in steps:
            code, ans, _ = _http(qport, "/v1/profile/TpuStepTrace", {
                "run_id": st["run_id"], "time_start": st["time"],
                "time_end": st["end_ns"] + 1})
            check(code == 200, f"TpuStepTrace answers 200 ({ans})")
            devs = ans["result"]["devices"]
            # each device's spans less its one module span
            kernels.append(sum(d["n_spans"] - 1 for d in devs.values()))
            n = sum(d["n_spans"] for d in devs.values())
            spans_in_steps += n
            if n:
                trace_spans[st["run_id"]] = n
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
        t0 = time.perf_counter()
        dfctl = subprocess.run(
            [sys.executable, "-m", "deepflow_tpu_torch.cli.dfctl",
             "--server", f"127.0.0.1:{qport}", "tpu-flame"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        dfctl_s = time.perf_counter() - t0
        selfstats = srv.stop()[_SELFSTATS]
    finally:
        srv.stop()
    guard_last, guard_max = _latest_and_max(selfstats, "agent.guard")
    guard_rows = _guard_rows(selfstats)
    kineto_last, kineto_max = _latest_and_max(selfstats,
                                              "agent.tpuprobe.kineto")
    agents = health.get("agents_selfmon", {})
    sender_hop = agents.get("pipeline", {}).get("sender", {})
    steps_hop = agents.get("pipeline", {}).get("tpuprobe.steps", {})
    flame, cpu = flame["result"], cpu["result"]
    guard_dump = sorted(r for r in zip(selfstats["metric_name"],
                                       selfstats["time"],
                                       selfstats["value_name"],
                                       selfstats["value"])
                        if r[0] == "agent.guard")
    guard_sql = sorted(tuple(r) for r in sql_rows["guard"])
    sql_spans = {int(r): int(n) for r, n in sql_rows["per_step"]}
    flame_kernels = list(_kernel_leaves(flame))
    top_ns = max((ns for _, ns in flame_kernels), default=0)
    dfctl_top = _dfctl_top_kernel(dfctl.stdout)
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
        "native_batches": dec["TPU_SPAN"]["native_batches"],
        "pure_batches": dec["TPU_SPAN"]["pure_batches"],
        "dups": sum(d["dups"] for d in dec.values()),
        "ingest_lag_s": ingest_lag_s, "tpu_flame_ms": flame_ms,
        "profile_tracing_ms": cpu_ms,
        "cpu_stacks_through_main": len(through_main),
        "host_cpu_count": os.cpu_count(), "host_cpu_model": _cpu_model(),
        # the guard's readings (agent threads; RSS above the first step)
        # beside the whole process's, largest over its checks
        **{f"guard_{k}_max": guard_max.get(k) for k in (
            "cpu_pct", "threads_cpu_pct", "rss_mb", "proc_cpu_pct",
            "proc_rss_mb")},
        **{f"guard_{k}": guard_last.get(k) for k in (
            "checks", "degrades", "recoveries")},
        # the capture's phases (the longest of its stats rows)
        **{f"kineto_{k}_max": kineto_max.get(k) for k in (
            "last_start_ms", "last_stop_ms", "last_export_ms",
            "last_parse_ms", "dead_ms", "last_extract_cpu_ms",
            "last_unheld_cpu_ms", "last_trace_events")},
        # CPU seconds of each agent thread by the end of the run
        "agent_thread_cpu_s": _latest_and_max(
            selfstats, "agent.guard.threads")[0],
        **{f"kineto_{k}": kineto_last.get(k) for k in (
            "captures", "unheld", "coverage_pct")},
        "sender_hop": sender_hop, "steps_hop": steps_hop,
        "agent_wedges": agents.get("wedges"),
        "server_ledger_imbalance": health.get("ledger_imbalance"),
        "server_wedges": health.get("wedges"), "guard_rows": guard_rows,
        **sql_ms, "sql_guard_rows": len(guard_sql),
        "sql_span_rows": tables["profile.tpu_hlo_span"],
        "sql_selfstats_rows": tables["deepflow_system.deepflow_system"],
        "dfctl_tpu_flame_s": dfctl_s, "dfctl_top_kernel": dfctl_top})
    phase("runner", **{k: v for k, v in nums.items()
                       if not isinstance(v, list)})
    for row in guard_rows:
        phase("runner guard", **row)
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
    check(nums["pure_batches"] == 0 and nums["native_batches"] > 0,
          "every span frame decoded natively")
    # a check's CPU reading is over the time since the one before
    check((guard_last.get("checks") or 0) >= 2,
          f"the guard read the agent's CPU ({guard_last})")
    check(guard_last.get("degrades") == 0,
          f"the guard never degraded the default agent (largest reading "
          f"{guard_max.get('cpu_pct')} %, {guard_max.get('rss_mb')} MB)")
    check(agents.get("wedges") == [] and health.get("wedges") == [],
          "no wedged stage, agent or server")
    _check_sender_hop(sender_hop, steps_hop)
    check(health.get("ledger_imbalance") == 0,
          f"the server's hop ledgers balance ({health.get('pipeline')})")
    check(bool(guard_sql) and guard_sql == guard_dump,
          f"the agent.guard rows through /v1/query ({len(guard_sql)}) "
          f"equal the drained table's ({len(guard_dump)})")
    check(sql_spans == trace_spans,
          "spans per run_id through /v1/query equal each step's "
          "TpuStepTrace count")
    check(dfctl.returncode == 0, f"dfctl tpu-flame exit code "
          f"{dfctl.returncode} ({dfctl.stderr[-2000:]})")
    check((dfctl_top, top_ns) in flame_kernels,
          f"dfctl tpu-flame's top kernel {dfctl_top!r} is TpuFlame's")
    slow = {k: v for k, v in sql_ms.items() if v >= QUERY_LIMIT_MS}
    check(not slow, f"every /v1/query under {QUERY_LIMIT_MS} ms ({slow})")


def _dfctl_top_kernel(text: str) -> str | None:
    """The kernel with the most device time in dfctl tpu-flame's tree:
    lines "<2 spaces a level><name>  <total ns>,... (<pct>%) <bar>"; a
    line whose next line is no deeper is a leaf; module spans end in a
    "module" leaf."""
    nodes = []
    for line in text.splitlines():
        m = re.match(r"^( *)(.*)  ([\d,]+) \([\d.]+%\)", line)
        if m:
            nodes.append((len(m.group(1)) // 2, m.group(2),
                          int(m.group(3).replace(",", ""))))
    leaves = [(ns, name) for i, (depth, name, ns) in enumerate(nodes)
              if name != "module" and (i + 1 == len(nodes)
                                       or nodes[i + 1][0] <= depth)]
    return max(leaves)[1] if leaves else None


def _guard_rows(rows: dict) -> list[dict]:
    """The agent.guard rows, one per guard check, in time order."""
    by_time: dict[int, dict] = {}
    for name, t, vname, v in zip(rows["metric_name"], rows["time"],
                                 rows["value_name"], rows["value"]):
        if name == "agent.guard":
            by_time.setdefault(t, {})[vname] = v
    out: dict[float, dict] = {}
    for t in sorted(by_time):
        out.setdefault(by_time[t].get("checks", 0.0), by_time[t])
    return list(out.values())


def _check_sender_hop(hop: dict, steps_hop: dict) -> None:
    """The agent's last sender hop row: emitted = delivered + dropped +
    pending, nothing pending after the final flush, no HIGH-class frame
    dropped (HIGH drops: a full queue with no spool, a spool error or
    eviction), no step record dropped."""
    check(bool(hop) and hop["emitted"] == hop["delivered"] + hop["dropped"]
          + hop["in_flight"], f"the sender hop balances ({hop})")
    check(hop["in_flight"] == 0, f"nothing pending after the flush ({hop})")
    high = {r: n for r, n in hop.get("dropped_by_reason", {}).items()
            if r.endswith("_high") or r.startswith("spool")}
    check(not high, f"no HIGH-class frame dropped ({high})")
    check(steps_hop.get("dropped", 0) == 0, f"no step record dropped "
          f"({steps_hop})")


def _step_summary(steps: list[tuple[str, float]]) -> dict:
    out = {}
    for label in dict.fromkeys(lab for lab, _ in steps):
        ms = [m for lab, m in steps if lab == label]
        out[label] = {"n": len(ms), "median": statistics.median(ms),
                      "mean": statistics.mean(ms), "max": max(ms)}
    return out


def _spans_in_step_records(records: dict, spans: dict) -> int:
    """Span rows inside a step record of their run_id: time at or after
    the record's start and at or before its end."""
    by_run: dict[int, list[tuple[int, int]]] = {}
    for rid, t0, t1 in zip(records["run_id"], records["time"],
                           records["end_ns"]):
        by_run.setdefault(rid, []).append((t0, t1))
    return sum(1 for rid, t in zip(spans["run_id"], spans["time"])
               if any(t0 <= t <= t1 for t0, t1 in by_run.get(rid, ())))


def resilience_phase(torch, tl, kernels_per_step_in_process: int,
                     nums: dict) -> None:
    """A server outage, the spool's replay and a guard pause, in this
    process (see the module docstring, phase 7); the numbers land in
    ``nums`` before the checks run."""
    from deepflow_tpu_torch.agent.agent import Agent
    from deepflow_tpu_torch.agent.config import AgentConfig
    from deepflow_tpu_torch.agent.guard import EXC_CPU_LIMIT
    from torch.autograd import profiler as autograd_profiler

    cfg_m = tl.LlamaConfig.llama7b(n_layers=N_LAYERS)
    model = tl.Llama(cfg_m, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg_m.vocab, (BATCH, SEQ), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    train_step, _opt = tl.make_train_step(model)
    for _ in range(3):  # warm-up, before the agent
        timed_step(torch, train_step, tokens)
    spool_dir = os.path.join(OUT_DIR, "resilience_spool")
    shutil.rmtree(spool_dir, ignore_errors=True)
    port = _closed_port()
    cfg = AgentConfig(app_service="resilience", agent_id=7)
    cfg.sender.servers = [("127.0.0.1", port)]
    cfg.sender.queue_size = RESILIENCE_QUEUE
    cfg.sender.spool.enabled = True
    cfg.sender.spool.dir = spool_dir
    cfg.guard.check_interval_s = GUARD_CHECK_S
    cfg.guard.max_cpu_pct = GUARD_PHASE_CPU_PCT
    t0 = time.perf_counter()
    agent = Agent(cfg, device="cuda").start()
    guard, sender = agent.guard, agent.sender
    readings: list[dict] = []
    guard_check = guard.check

    def check_and_record(now=None) -> None:
        guard_check(now)
        readings.append({
            "t_s": round(time.perf_counter() - t0, 3),
            "cpu_pct": guard.cpu_pct, "rss_mb": guard.rss_mb,
            "threads_cpu_pct": guard.threads_cpu_pct,
            "proc_cpu_pct": guard.proc_cpu_pct,
            "proc_rss_mb": guard.proc_rss_mb,
            "degraded": guard.degraded, "bitmap": guard.exception_bitmap})
    guard.check = check_and_record
    probes = [agent.tpuprobe]
    steps: list[tuple[str, float]] = []
    # kept in the result also when a check fails
    nums.update(guard_readings=readings, step_ms_all=steps)
    peak = [0]
    srv = None
    stopped = False

    def step(label: str) -> None:
        steps.append((label, timed_step(torch, train_step, tokens)[0]))
        peak[0] = max(peak[0], sender.spool.pending_bytes())

    def train_until(label: str, cond, limit_s: float, what: str) -> float:
        t = time.perf_counter()
        while not cond():
            check(time.perf_counter() - t < limit_s,
                  f"{what} within {limit_s} s")
            step(label)
        return time.perf_counter() - t

    try:
        # 1. the outage: nothing listens, HIGH frames overflow to disk
        outage_s = train_until(
            "outage", lambda: probes[0].stats["batches"]
            >= RESILIENCE_CAPTURES and sender.stats["spooled"] > 0,
            RESILIENCE_OUTAGE_S,
            f"{RESILIENCE_CAPTURES} captures sent and a frame spooled with "
            "no server")
        step("outage")  # the last capture's frame reaches the sender
        spooled = sender.stats["spooled"]
        pending_records = sender.spool.pending_records()
        check(spooled > 0 and pending_records > 0,
              f"HIGH frames spooled ({spooled}, {pending_records} pending)")
        # 2. the server starts on that address: reconnect, replay, acks
        t_srv = time.perf_counter()
        srv = _ServerProcess(
            os.path.join(OUT_DIR, "resilience_server.log"), ingest_port=port,
            dump={_SELFSTATS: _SELFSTATS_COLS,
                  "profile.tpu_step_metrics": ["run_id", "time", "end_ns"],
                  "profile.tpu_hlo_span": ["run_id", "time"]})
        drain_s = time.perf_counter() - t_srv + train_until(
            "replay", lambda: sender.stats["replayed"] >= spooled
            and sender.stats["acked_seq"] >= sender.spool.max_seq(),
            RESILIENCE_DRAIN_S, "every spooled record replayed and acked")
        for _ in range(RESILIENCE_AFTER_STEPS):
            step("after")
        # 3. a limit below any reading: the guard pauses the profilers
        checks_at_trip = guard.stats["checks"]
        guard.max_cpu_pct = -1.0
        degrade_s = train_until(
            "degrading", lambda: guard.degraded, PAUSE_S,
            "the guard degraded")
        check(guard.stats["checks"] - checks_at_trip <= 2,
              f"degraded within two checks "
              f"({guard.stats['checks'] - checks_at_trip})")
        check(guard.exception_bitmap & EXC_CPU_LIMIT,
              f"the CPU bit is set ({guard.exception_bitmap})")
        pause_s = degrade_s + train_until(
            "pausing", lambda: agent.tpuprobe is None
            and agent.sampler is None, PAUSE_S,
            "the probe and the sampler stopped")
        captures_at_pause = probes[0].sources[0].stats["captures"]
        opened = 0
        for _ in range(DEGRADED_STEPS):
            step("degraded")
            opened += bool(autograd_profiler._is_profiler_enabled
                           or agent.tpuprobe is not None)
        check(opened == 0 and probes[0].sources[0].stats["captures"]
              == captures_at_pause, "no capture opened while degraded")
        # 4. the limits back: a recovery and a fresh probe
        checks_at_restore = guard.stats["checks"]
        guard.max_cpu_pct = cfg.guard.max_cpu_pct
        recover_s = train_until(
            "recovering", lambda: agent.tpuprobe is not None, PAUSE_S,
            "the guard recovered")
        check(guard.stats["checks"] - checks_at_restore <= 2,
              f"recovered within two checks "
              f"({guard.stats['checks'] - checks_at_restore})")
        probes.append(agent.tpuprobe)
        fresh = probes[1].sources[0]
        first: list = []
        sink = fresh.sink

        def tap(events) -> None:
            if not first:
                first.append(list(events))
            sink(events)
        fresh.sink = tap
        first_capture_s = train_until(
            "resumed", lambda: bool(first), RESILIENCE_OUTAGE_S,
            "the resumed probe's first capture")
        per_step: dict[int, int] = {}
        for e in first[0]:
            if e.hlo_op:
                per_step[e.run_id] = per_step.get(e.run_id, 0) + 1
        resumed_mode = statistics.mode(per_step.values()) if per_step else 0
        # 5. detach, and read the server
        agent.stop()
        stopped = True
        hop = agent.telemetry.hop("sender").snapshot()
        sent = {k: sum(p.stats.get(k, 0) for p in probes)
                for k in ("steps_sent", "spans_sent", "mem_samples_sent")}
        health = _ingest_settled(srv.query_port)
        dumped = srv.stop()
        selfstats = dumped[_SELFSTATS]
        records = dumped["profile.tpu_step_metrics"]
        spans = dumped["profile.tpu_hlo_span"]
    finally:
        if not stopped:
            agent.stop()
        if srv is not None:
            srv.stop()
        shutil.rmtree(spool_dir, ignore_errors=True)
        del model, tokens, train_step, _opt
        gc.collect()
        torch.cuda.empty_cache()
    tables, stats = health["tables"], health["stats"]
    guard_last, _ = _latest_and_max(selfstats, "agent.guard")
    agents = health.get("agents_selfmon", {})
    sender_hop = agents.get("pipeline", {}).get("sender", {})
    steps_hop = agents.get("pipeline", {}).get("tpuprobe.steps", {})
    in_steps = _spans_in_step_records(records, spans)
    nums.update({
        "outage_s": outage_s, "spooled_at_server_start": spooled,
        "spool_records_at_server_start": pending_records,
        "peak_spool_bytes": peak[0], "server_start_s": srv.start_s,
        "drain_s": drain_s, "degrade_s": degrade_s, "pause_s": pause_s,
        "recover_s": recover_s, "resumed_first_capture_s": first_capture_s,
        "resumed_kernels_per_step": resumed_mode,
        "resumed_first_capture_steps": len(per_step),
        "kernels_per_step_in_process": kernels_per_step_in_process,
        "sender": dict(sender.stats), "sender_hop_in_process": hop,
        "spool": dict(sender.spool.stats), **sent,
        **{t.split(".")[1] + "_rows": n for t, n in tables.items()},
        "spans_in_step_records": in_steps,
        "dups": sum(d["dups"] for d in stats["decoders"].values()),
        "decode_errors": sum(d["errors"]
                             for d in stats["decoders"].values()),
        "bad_frames": stats["receiver"]["bad_frames"],
        "guard_last": guard_last, "sender_hop": sender_hop,
        "steps_hop": steps_hop, "agent_wedges": agents.get("wedges"),
        "step_ms": _step_summary(steps), "guard_readings": readings})
    phase("resilience", **{k: v for k, v in nums.items()
                           if not isinstance(v, (dict, list))})
    for label, st in nums["step_ms"].items():
        phase("resilience step_ms", label=label, **st)
    for r in readings:
        phase("resilience guard", **r)
    phase("resilience sender", **nums["sender"])
    check(sender.stats["reconnects"] >= 1 and
          sender.stats["replayed"] >= spooled, "the sender replayed")
    check(resumed_mode == kernels_per_step_in_process,
          f"the resumed probe's first capture holds {resumed_mode} kernels "
          f"a step, phase 4's {kernels_per_step_in_process}")
    check(tables["profile.tpu_step_metrics"] == sent["steps_sent"],
          f"step records once each: {tables['profile.tpu_step_metrics']} "
          f"rows, {sent['steps_sent']} sent")
    check(tables["profile.tpu_hlo_span"] == sent["spans_sent"],
          f"spans once each: {tables['profile.tpu_hlo_span']} rows, "
          f"{sent['spans_sent']} sent")
    check(tables["profile.tpu_memory"] == sent["mem_samples_sent"],
          f"memory samples once each: {tables['profile.tpu_memory']} rows, "
          f"{sent['mem_samples_sent']} sent")
    check(in_steps == tables["profile.tpu_hlo_span"],
          f"every span row lies in a step record ({in_steps} of "
          f"{tables['profile.tpu_hlo_span']})")
    check(nums["decode_errors"] == 0 and nums["bad_frames"] == 0,
          "no decode error or bad frame")
    check(guard_last.get("degrades") == 1
          and guard_last.get("recoveries") == 1,
          f"agent.guard: one degrade, one recovery ({guard_last})")
    check(agents.get("wedges") == [], "no agent stage wedged")
    _check_sender_hop(sender_hop, steps_hop)


def resnet_phase(torch) -> dict:
    """ResNet-50 (the reference's ResNetConfig()) at full width, bf16,
    channels_last, 224 x 224, batch RESNET_BATCH, SGD at the reference's
    lr, weights and images from torch.Generator seeds: its initial loss
    against ln(1000) and a float32 forward of the same weights, the tiny
    float32 ResNet on the card against the CPU; then profiled steps as
    phase 3's and the frames as phase 4's."""
    from deepflow_tpu_torch.models import resnet as tr

    cfg = tr.ResNetConfig()
    dev = torch.device("cuda")
    model = tr.ResNet(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    images, labels = tr.synthetic_batch(
        cfg, RESNET_BATCH, RESNET_IMAGE,
        torch.Generator(device=dev).manual_seed(1), dev)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        loss = float(tr.loss_fn(model, images, labels))
        m32 = tr.ResNet(dataclasses.replace(cfg, dtype=torch.float32),
                        device=dev)
        m32.load_state_dict(model.state_dict())
        loss32 = float(tr.loss_fn(m32, images, labels))
        del m32
        tiny = tr.ResNetConfig.tiny(dtype=torch.float32)
        small_cpu = tr.ResNet(tiny, device="cpu",
                              generator=torch.Generator().manual_seed(2))
        small_gpu = tr.ResNet(tiny, device=dev)
        small_gpu.load_state_dict(small_cpu.state_dict())
        x, _ = tr.synthetic_batch(tiny, 4, 33, torch.Generator()
                                  .manual_seed(3), torch.device("cpu"))
        tiny_err = float((small_gpu(x.to(dev)).cpu() - small_cpu(x))
                         .abs().max())
    torch.cuda.empty_cache()
    rel = abs(loss - loss32) / abs(loss32)
    ln_classes = math.log(cfg.num_classes)
    phase("resnet_model", params=n_params, batch=RESNET_BATCH,
          image=RESNET_IMAGE, loss_bf16=loss, loss_f32=loss32,
          rel_diff=rel, ln_classes=ln_classes,
          tiny_cuda_vs_cpu_max_abs=tiny_err)
    check(math.isfinite(loss), "ResNet-50 initial loss is finite")
    check(abs(loss - ln_classes) <= 0.2 * ln_classes,
          "ResNet-50 initial loss within 20% of ln(1000)")
    check(rel <= RESNET_BF16_VS_F32_RTOL,
          f"ResNet-50 bf16 vs f32 loss rel diff {rel} <= "
          f"{RESNET_BF16_VS_F32_RTOL}")
    check(tiny_err <= TINY_CUDA_VS_CPU_ATOL,
          f"tiny f32 ResNet logits cuda vs cpu {tiny_err} <= "
          f"{TINY_CUDA_VS_CPU_ATOL}")
    opt = torch.optim.SGD(model.parameters(), lr=RESNET_LR)

    def train_step(images, labels):
        loss = tr.loss_fn(model, images, labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    sink, probe, nums, window = training_phase(
        torch, train_step, (images, labels), label="resnet")
    frames, seen = frames_phase(sink, probe, window, label="resnet_frames")
    kernel_ns = {k: v for k, v in seen["op_ns"].items() if k}
    check(seen["flame_ops"] == kernel_ns,
          "the ResNet's per-kernel flame graph equals the per-op sums")
    nums.update(params=n_params, loss_bf16=loss, loss_f32=loss32,
                bf16_vs_f32_rel=rel, tiny_cuda_vs_cpu_max_abs=tiny_err,
                frames=frames)
    del model, opt, images, labels, sink, probe, seen
    gc.collect()
    torch.cuda.empty_cache()
    return nums


# the cross-rank checks the dp phase makes only with two GPUs or more
DP_CROSS_RANK = (
    "each stitched all-reduce group has every rank as a participant",
    "groups per step equal the step's all-reduce calls",
    "/v1/tpu/steps names a rank as straggler_device")


def dp_phase(torch, nums: dict) -> None:
    """The data-parallel example under python -m torch.distributed.run,
    one rank per GPU, each under the zero-code runner shipping into a
    fresh server process: every rank's rows exactly once under its own
    agent id with device_id = rank, every rank's mean loss equal at each
    step; with two GPUs or more, one stitched group per all-reduce call
    with every rank in it and a straggler rank named."""
    os.makedirs(OUT_DIR, exist_ok=True)
    n = torch.cuda.device_count()
    span_cols = ["agent_id", "device_id", "chip_id", "hlo_op", "program_id",
                 "collective", "run_id", "time", "duration_ns", "core_id"]
    srv = _ServerProcess(
        os.path.join(OUT_DIR, "dp_server.log"),
        dump={"profile.tpu_hlo_span": span_cols,
              _SELFSTATS: ["agent_id", "metric_name", "tag_json", "time",
                           "value_name", "value"]})
    try:
        run = _train_child(
            ["-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), *RUNNER,
             "--server", f"127.0.0.1:{srv.ingest_port}",
             "--controller", f"127.0.0.1:{srv.sync_port}",
             "--service", "resnet-dp", "-m", EXAMPLE, "--preset", "resnet50",
             "--image", str(RESNET_IMAGE), "--batch", str(RESNET_BATCH),
             "--steps", str(DP_STEPS)], "dp")
        health = _ingest_settled(srv.query_port)
        _, groups, colls_ms = _http(srv.query_port,
                                    "/v1/profile/TpuCollectives", {})
        groups = groups["result"]
        _, steps, _ = _http(srv.query_port, "/v1/tpu/steps",
                            {"limit": DP_STEPS + 1})
        steps = steps["result"]["steps"]
        _, fleet, _ = _http(srv.query_port, "/v1/agents")
    finally:
        rows = srv.stop()
    # each rank's controller-assigned id, by the rank in its launcher id
    id_of_rank = {int(a["launcher_id"].rsplit("/", 1)[1]): a["agent_id"]
                  for a in fleet["agents"] if a["launcher_id"]}
    with open(os.path.join(OUT_DIR, "dp.out")) as f:
        lines = [json.loads(x) for x in f if x.startswith("{")]
    spans = rows["profile.tpu_hlo_span"]
    with open(os.path.join(OUT_DIR, "dp_collectives.json"), "w") as f:
        # the groups and the NCCL span rows they came from
        json.dump({"groups": groups, "nccl_rows": [
            dict(zip(span_cols, r)) for r in zip(*(spans[c]
                                                   for c in span_cols))
            if r[span_cols.index("collective")]]}, f)
    by_rank: dict[int, list] = {}
    for line in lines:
        by_rank.setdefault(line["rank"], []).append(line)
    pairs = set(zip(spans["agent_id"], spans["device_id"], spans["chip_id"]))
    per_agent: dict[int, int] = {}
    for a in spans["agent_id"]:
        per_agent[a] = per_agent.get(a, 0) + 1
    st = rows[_SELFSTATS]
    sent: dict[int, tuple[int, float]] = {}   # agent -> latest spans_sent
    rank_tags: dict[int, set] = {}
    for a, m, tag, t, vn, v in zip(st["agent_id"], st["metric_name"],
                                   st["tag_json"], st["time"],
                                   st["value_name"], st["value"]):
        rank_tags.setdefault(a, set()).add(json.loads(tag).get("rank"))
        if m == "agent.tpuprobe" and vn == "spans_sent" and \
                t >= sent.get(a, (-1, 0))[0]:
            sent[a] = (t, v)
    calls = {x["allreduce_calls"] for x in lines}
    # the steps every rank captured: the module span of each rank
    captured: dict[int, set] = {}
    for d, op, rid in zip(spans["device_id"], spans["hlo_op"],
                          spans["run_id"]):
        if not op and rid:
            captured.setdefault(rid, set()).add(d)
    whole = {rid for rid, devs in captured.items() if len(devs) == n}
    in_whole = [g for g in groups if g["run_id"] in whole]
    per_step: dict[int, int] = {}
    for g in in_whole:
        per_step[g["run_id"]] = per_step.get(g["run_id"], 0) + 1
    all_ranks = [s for s in steps if s["run_id"] in whole
                 and s["device_count"] == n]
    dec = health["stats"]["decoders"]
    nums.update(
        world=n, steps_per_rank={r: len(v) for r, v in by_rank.items()},
        allreduce_calls_per_step=sorted(calls),
        step_ms_median={r: statistics.median(x["ms"] for x in v[RUNNER_WARMUP:])
                        for r, v in by_rank.items()},
        step_ms_mean={r: statistics.mean(x["ms"] for x in v[RUNNER_WARMUP:])
                      for r, v in by_rank.items()},
        step_ms_max={r: max(x["ms"] for x in v[RUNNER_WARMUP:])
                     for r, v in by_rank.items()},
        loss_first=by_rank.get(0, [{}])[0].get("loss"),
        loss_last=by_rank.get(0, [{}])[-1].get("loss"),
        span_rows_per_agent=per_agent,
        spans_sent_per_agent={a: v for a, (_, v) in sent.items()},
        steps_captured_by_every_rank=len(whole), groups=len(groups),
        groups_in_whole_steps=len(in_whole),
        group_participants=sorted({g["n_participants"] for g in in_whole}),
        groups_per_whole_step=sorted(set(per_step.values())),
        straggler_devices=sorted({s["straggler_device"] for s in all_ranks}),
        collectives_query_ms=colls_ms, wall_s=run["wall_s"],
        dups=sum(d["dups"] for d in dec.values()),
        decode_errors=sum(d["errors"] for d in dec.values()))
    phase("dp", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                   for k, v in nums.items()})
    check(sorted(by_rank) == list(range(n)), f"every rank of {n} printed")
    check(all(len(v) == DP_STEPS for v in by_rank.values()),
          f"every rank trained {DP_STEPS} steps")
    check(len(calls) == 1, "one all-reduce count per step on every rank")
    for i in range(DP_STEPS):
        losses = {v[i]["loss"] for v in by_rank.values()}
        check(len(losses) == 1 and all(map(math.isfinite, losses)),
              f"every rank's mean loss equal at step {i} ({losses})")
    nums["agent_id_of_rank"] = id_of_rank
    check(sorted(id_of_rank) == list(range(n))
          and len(set(id_of_rank.values())) == n
          and len(fleet["agents"]) == n,
          f"the controller registered each rank under an id of its own "
          f"({id_of_rank})")
    check(pairs == {(id_of_rank[r], r, r) for r in range(n)},
          f"span rows under each rank's assigned id with device_id = "
          f"chip_id = rank ({sorted(pairs)})")
    check(all(per_agent.get(id_of_rank[r], 0)
              == sent.get(id_of_rank[r], (0, -1))[1] > 0 for r in range(n)),
          f"every rank's spans land exactly once ({per_agent} against "
          f"{ {a: v for a, (_, v) in sent.items()} })")
    check(all(rank_tags.get(id_of_rank[r]) == {str(r)} for r in range(n)),
          f"each agent's stats rows carry its rank ({rank_tags})")
    check(nums["dups"] == 0 and nums["decode_errors"] == 0,
          "no dup and no decode error in the server")
    if n == 1:
        print(f"[dp] world=1: one GPU; NCCL runs a one-rank all-reduce "
              f"without a kernel, so these checks need two GPUs or more "
              f"and did not run: {'; '.join(DP_CROSS_RANK)}", flush=True)
        nums["not_run_with_one_gpu"] = list(DP_CROSS_RANK)
        return
    check(len(whole) >= 1, "a step that every rank captured")
    check(nums["group_participants"] == [n],
          f"every all-reduce group of a whole step has {n} participants")
    check(nums["groups_per_whole_step"] == sorted(calls),
          f"groups per step {nums['groups_per_whole_step']} == the step's "
          f"all-reduce calls {sorted(calls)}")
    check(all_ranks and all(0 <= d < n for d in nums["straggler_devices"]),
          "/v1/tpu/steps names a rank as straggler_device")


# the cross-rank checks of the parallel and mp phases, which need two
# GPUs or more (a one-rank group issues no NCCL kernel)
PARALLEL_CROSS_RANK = (
    "ring attention's K/V blocks rotate over NCCL send-recvs",
    "the pipeline's activations pass stage to stage over NCCL send-recvs "
    "and its final all-reduce replicates them",
    "the MoE's experts are cut over ranks and an NCCL all-reduce combines "
    "them",
    "a Kineto capture of each classifies its NCCL kernels as collectives")
MP_CROSS_RANK = (
    "in every step each rank captured, each communicator's groups equal "
    "the calls the ranks printed for it",
    "each group has every rank as a participant and its communicator's "
    "size as replica_group_size",
    "no group mixes two communicators")
MP_LAYERS = 4            # llama7b() has 32; widths are unchanged
MP_BATCH = 4             # global, cut over data
MP_PLAIN_STEPS = 40
MP_STEPS = 200           # with the agent: room for windows at 40-59, ...
MP_CHILD_S = 900.0


def parallel_phase(torch, nums: dict) -> None:
    """chip_parallel.py under python -m torch.distributed.run, one rank
    per GPU: the tiny sharded Llama on the mp phase's mesh against the
    unsharded port on the CPU, and ring attention, the pipeline and MoE
    at llama7b() widths against their dense forms, each with a Kineto
    capture whose NCCL kernels the port classifies as collectives."""
    import chip_parallel as cp
    os.makedirs(OUT_DIR, exist_ok=True)
    n = torch.cuda.device_count()
    for f in os.listdir(OUT_DIR):
        if f.startswith("parallel_r"):
            os.remove(os.path.join(OUT_DIR, f))
    t0 = time.perf_counter()
    with open(os.path.join(OUT_DIR, "parallel.out"), "w") as out, \
            open(os.path.join(OUT_DIR, "parallel.err"), "w") as err:
        rc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), os.path.join(ROOT,
                                                      "chip_parallel.py"),
             OUT_DIR], cwd=ROOT, stdout=out, stderr=err,
            timeout=MP_CHILD_S).returncode
    ranks = {}
    for r in range(n):
        path = os.path.join(OUT_DIR, f"parallel_r{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks[r] = json.load(f)
    first = ranks.get(0, {})
    nums.update(world=n, wall_s=time.perf_counter() - t0,
                tiny=first.get("tiny"), peak_mb={
                    r: v.get("peak_mb") for r, v in ranks.items()},
                **{k: {r: {x: v[k].get(x) for x in (
                    "max_abs_err", "ms", "dense_ms", "sequential_ms",
                    "collectives", "calls", "kernels")
                    if x in v[k]} for r, v in ranks.items() if k in v}
                   for k in ("ring", "pipeline", "moe")})
    phase("parallel", **{k: json.dumps(v) if isinstance(v, (dict, list))
                         else v for k, v in nums.items()})
    check(rc == 0, f"chip_parallel.py exit code {rc} (see "
          f"{OUT_DIR}/parallel.err)")
    check(sorted(ranks) == list(range(n)) and all(
        all(k in v for k in ("tiny", "ring", "pipeline", "moe"))
        for v in ranks.values()), "every rank ran every check")
    check(all(v["tiny"]["losses"] == first["tiny"]["losses"]
              for v in ranks.values()),
          "every rank's tiny sharded loss equal")
    if n == 1:
        print(f"[parallel] world=1: one GPU; a one-rank group issues no "
              f"NCCL kernel, so these checks need two GPUs or more and did "
              f"not run: {'; '.join(PARALLEL_CROSS_RANK)}", flush=True)
        nums["not_run_with_one_gpu"] = list(PARALLEL_CROSS_RANK)
        return
    ticks = cp.PIPE_MICRO + n - 1
    for r, v in ranks.items():
        check(v["ring"]["collectives"] == {"send-recv": n - 1},
              f"rank {r}: the ring's send-recvs {v['ring']['collectives']}")
        check(v["pipeline"]["collectives"] == {"send-recv": ticks,
                                               "all-reduce": 1},
              f"rank {r}: the pipeline's collectives "
              f"{v['pipeline']['collectives']}")
        check(v["moe"]["collectives"] == {"all-reduce": 1},
              f"rank {r}: the MoE's all-reduce {v['moe']['collectives']}")


def _mp_args(shape) -> list[str]:
    return [EXAMPLE, "--preset", "llama7b", "--layers", str(MP_LAYERS),
            "--mesh", ",".join(map(str, shape)), "--seq", str(SEQ),
            "--batch", str(MP_BATCH)]


def _by_rank(name: str) -> dict[int, list]:
    with open(os.path.join(OUT_DIR, f"{name}.out")) as f:
        lines = [json.loads(x) for x in f if x.startswith("{")]
    out: dict[int, list] = {}
    for line in lines:
        out.setdefault(line["rank"], []).append(line)
    return out


def _step_stats(steps: list) -> dict:
    ms = [x["ms"] for x in steps[RUNNER_WARMUP:]]
    return {"median": statistics.median(ms), "mean": statistics.mean(ms),
            "max": max(ms)}


def mp_phase(torch, nums: dict) -> None:
    """The example with --preset llama7b sharded on the mesh under python
    -m torch.distributed.run, one rank per GPU: plain, then each rank
    under the zero-code runner shipping into a fresh server process.
    Every rank's loss equal at every step, its rows exactly once under
    agent rank + 1, no dup; with two GPUs or more, each communicator's
    calls stitched one group a call with every rank in it."""
    import chip_parallel as cp
    os.makedirs(OUT_DIR, exist_ok=True)
    n = torch.cuda.device_count()
    shape = cp.mp_shape(n)
    sizes = dict(zip(("data", "fsdp", "tensor"), shape))
    print(f"[mp] layers={MP_LAYERS} mesh={shape} world={n}", flush=True)
    launch = ["-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", str(n)]
    plain = _train_child([*launch, "-m", *_mp_args(shape), "--steps",
                          str(MP_PLAIN_STEPS)], "mp_plain")
    span_cols = ["agent_id", "device_id", "hlo_op", "program_id",
                 "collective", "run_id", "duration_ns",
                 "replica_group_size"]
    srv = _ServerProcess(
        os.path.join(OUT_DIR, "mp_server.log"),
        dump={"profile.tpu_hlo_span": span_cols,
              _SELFSTATS: ["agent_id", "metric_name", "time", "value_name",
                           "value"]})
    try:
        run = _train_child(
            [*launch, *RUNNER, "--server", f"127.0.0.1:{srv.ingest_port}",
             "--service", "llama-mp", "-m", *_mp_args(shape), "--steps",
             str(MP_STEPS)], "mp")
        health = _ingest_settled(srv.query_port)
        _, groups, colls_ms = _http(srv.query_port,
                                    "/v1/profile/TpuCollectives", {})
        groups = groups["result"]
    finally:
        rows = srv.stop()
    plain_by, by_rank = _by_rank("mp_plain"), _by_rank("mp")
    spans = rows["profile.tpu_hlo_span"]
    per_step: dict[int, dict] = {}   # run_id -> rank -> [spans, NCCL]
    for d, op, coll, rid in zip(spans["device_id"], spans["hlo_op"],
                                spans["collective"], spans["run_id"]):
        if op and rid:
            c = per_step.setdefault(rid, {}).setdefault(d, [0, 0])
            c[0] += 1
            c[1] += bool(coll)
    with open(os.path.join(OUT_DIR, "mp_steps.json"), "w") as f:
        json.dump(per_step, f)
    per_agent: dict[int, int] = {}
    for a in spans["agent_id"]:
        per_agent[a] = per_agent.get(a, 0) + 1
    st = rows[_SELFSTATS]
    sent: dict[int, tuple[int, float]] = {}
    for a, m, t, vn, v in zip(st["agent_id"], st["metric_name"], st["time"],
                              st["value_name"], st["value"]):
        if m == "agent.tpuprobe" and vn == "spans_sent" and \
                t >= sent.get(a, (-1, 0))[0]:
            sent[a] = (t, v)
    kernel_ns: dict[str, int] = {}
    for op, d in zip(spans["hlo_op"], spans["duration_ns"]):
        if op:
            kernel_ns[op] = kernel_ns.get(op, 0) + d
    top = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:5]
    whole, calls_of = _mp_calls(spans, n)
    modules: dict[int, set] = {}   # run_id -> ranks with its module span
    for d, op, rid in zip(spans["device_id"], spans["hlo_op"],
                          spans["run_id"]):
        if not op and rid:
            modules.setdefault(rid, set()).add(d)
    printed = {json.dumps(x["calls"], sort_keys=True)
               for v in by_rank.values() for x in v}
    in_whole = [g for g in groups if g["run_id"] in whole]
    dec = health["stats"]["decoders"]
    nums.update(
        world=n, mesh=list(shape), layers=MP_LAYERS,
        steps_per_rank={r: len(v) for r, v in by_rank.items()},
        step_ms_plain={r: _step_stats(v) for r, v in plain_by.items()},
        step_ms_agent={r: _step_stats(v) for r, v in by_rank.items()},
        peak_mb={r: v[-1].get("peak_mb") for r, v in by_rank.items()},
        calls_per_step=sorted(printed), loss_first=by_rank[0][0]["loss"],
        loss_last=by_rank[0][-1]["loss"],
        top_kernels_ms=[(op[:90], ns / 1e6) for op, ns in top],
        span_rows_per_agent=per_agent,
        spans_sent_per_agent={a: v for a, (_, v) in sent.items()},
        steps_captured_by_every_rank=sum(len(v) == n
                                         for v in modules.values()),
        steps_with_collectives_from_every_rank=len(whole),
        groups=len(groups),
        groups_in_whole_steps=len(in_whole),
        group_participants=sorted({g["n_participants"] for g in in_whole}),
        group_spans=sorted({g["n_spans"] for g in in_whole}),
        collectives_query_ms=colls_ms, plain_wall_s=plain["wall_s"],
        wall_s=run["wall_s"], dups=sum(d["dups"] for d in dec.values()),
        decode_errors=sum(d["errors"] for d in dec.values()))
    phase("mp", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                   for k, v in nums.items()})
    check(sorted(by_rank) == list(range(n)) and
          all(len(v) == MP_STEPS for v in by_rank.values()),
          f"every rank of {n} trained {MP_STEPS} steps")
    check(len(printed) == 1, f"one set of calls a step on every rank "
          f"({printed})")
    for name, got in (("plain", plain_by), ("agent", by_rank)):
        for i in range(len(got[0])):
            losses = {v[i]["loss"] for v in got.values()}
            check(len(losses) == 1 and all(map(math.isfinite, losses)),
                  f"every rank's loss equal at step {i} ({name}: {losses})")
    check(all(per_agent.get(r + 1, 0) == sent.get(r + 1, (0, -1))[1] > 0
              for r in range(n)) and set(per_agent) == {
                  r + 1 for r in range(n)},
          f"every rank's spans land exactly once under agent rank + 1 "
          f"({per_agent} against {({a: v for a, (_, v) in sent.items()})})")
    check(nums["dups"] == 0 and nums["decode_errors"] == 0,
          "no dup and no decode error in the server")
    if n == 1:
        print(f"[mp] world=1: one GPU; a one-rank group issues no NCCL "
              f"kernel, so these checks need two GPUs or more and did not "
              f"run: {'; '.join(MP_CROSS_RANK)}", flush=True)
        nums["not_run_with_one_gpu"] = list(MP_CROSS_RANK)
        return
    mp_cross_rank_checks(whole, calls_of, in_whole,
                         json.loads(printed.pop()), n, sizes)


def _mp_calls(spans: dict, n: int) -> tuple[set, dict]:
    """The steps every rank captured (NCCL spans from each of n ranks:
    every step of the sharded step issues collectives, and the capture
    that the runner's detach cuts may hold a step of a few trailing
    kernels and none) and their NCCL span rows by the stitcher's key
    (run_id, hlo_op, program_id): the ranks and replica_group_size of
    each."""
    captured: dict[int, set] = {}
    for d, coll, rid in zip(spans["device_id"], spans["collective"],
                            spans["run_id"]):
        if coll and rid:
            captured.setdefault(rid, set()).add(d)
    whole = {rid for rid, devs in captured.items() if len(devs) == n}
    calls_of: dict[tuple, dict] = {}
    for d, op, pid, coll, rid, rgs in zip(
            spans["device_id"], spans["hlo_op"], spans["program_id"],
            spans["collective"], spans["run_id"],
            spans["replica_group_size"]):
        if coll and rid in whole:
            g = calls_of.setdefault((rid, op, pid), {"ranks": [],
                                                     "rgs": set()})
            g["ranks"].append(d)
            g["rgs"].add(rgs)
    return whole, calls_of


def mp_cross_rank_checks(whole: set, calls_of: dict, in_whole: list,
                         calls: dict, n: int, sizes: dict) -> None:
    """MP_CROSS_RANK on the span rows of the steps every rank captured
    (``_mp_calls``) and the server's groups of those steps."""
    from deepflow_tpu_torch.tpuprobe.comms import CALL_STRIDE, comm_axis
    check(len(whole) >= 1, "a step that every rank captured")
    per_comm: dict[tuple, int] = {}
    for rid, _, pid in calls_of:
        key = (rid, comm_axis(pid // CALL_STRIDE))
        per_comm[key] = per_comm.get(key, 0) + 1
    for rid in whole:
        got = {a: k for (r, a), k in per_comm.items() if r == rid}
        check(got == calls, f"step {rid}: groups per communicator {got} "
              f"== the calls printed {calls}")
    for (rid, op, pid), g in calls_of.items():
        axis = comm_axis(pid // CALL_STRIDE)
        check(sorted(g["ranks"]) == list(range(n)),
              f"step {rid} call {pid}: every rank once ({g['ranks']})")
        check(g["rgs"] == {sizes[axis]}, f"step {rid} call {pid}: "
              f"replica_group_size {g['rgs']} == {axis} size {sizes[axis]}")
    check(len(in_whole) == len(calls_of) and
          {(g["n_participants"], g["n_spans"]) for g in in_whole}
          == {(n, n)},
          f"the server's groups in whole steps ({len(in_whole)}) are the "
          f"calls ({len(calls_of)}), each of {n} spans from {n} ranks: no "
          f"group mixes two communicators")


def flows_phase(nums: dict) -> None:
    """Phase 13 (chip_flows.py): the flow/L7 agent on the card's host."""
    import chip_flows
    # chip_flows imports this file as the module chip_smoke, a second
    # copy when this file runs as __main__: its phase lines need the card
    chip_flows.cs.CARD.update(CARD)
    chip_flows.flows_phase(nums)


def storage_phase(sink, nums: dict) -> None:
    """Phase 15 (chip_storage.py): the durable storage tier on the card's
    host, fed phase 3's span frames through the agent's sender."""
    import chip_storage
    chip_storage.cs.CARD.update(CARD)
    chip_storage.storage_phase(sink, nums)


def cluster_phase(sink, nums: dict) -> None:
    """Phase 16 (chip_cluster.py): three port servers as one cluster with
    replication 2, fed phase 3's span frames through eight agents'
    replicated senders, exact through a shard's SIGKILL and restart."""
    import chip_cluster
    chip_cluster.cs.CARD.update(CARD)
    chip_cluster.cluster_phase(sink, nums)


def readtier_phase(sink, nums: dict) -> None:
    """Phase 18 (chip_readtier.py): an ingest shard publishing into an
    object store and four querier replicas over it, fed phase 3's span
    frames; the scrubber's quarantine and repair, the cluster-wide
    partial cache."""
    import chip_readtier
    chip_readtier.cs.CARD.update(CARD)
    chip_readtier.readtier_phase(sink, nums)


def control_phase(nums: dict) -> None:
    """Phase 14 (chip_control.py): the control plane on the card's host."""
    import chip_control
    chip_control.cs.CARD.update(CARD)
    chip_control.control_phase(nums)


def enrich_phase(nums: dict) -> None:
    """Phase 17 (chip_enrich.py): every flow row names its process and
    its pod, on the card's host."""
    import chip_enrich
    chip_enrich.cs.CARD.update(CARD)
    chip_enrich.enrich_phase(nums)


def integrations_phase(frames: list, nums: dict,
                       runner_median_ms: float | None = None) -> None:
    """Phase 19 (chip_integrations.py): OTLP, remote-write, Telegraf,
    Datadog and SkyWalking in through the agent's proxy, the four
    exporters out, the event decoder's file-I/O windows; phase 3's span
    frames replayed with and without exporters."""
    import chip_integrations
    chip_integrations.cs.CARD.update(CARD)
    chip_integrations.integrations_phase(frames, nums, runner_median_ms)


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
        result["native"] = native_phase()
        model, tokens, result["model"] = model_phase(torch, tl)
        train_step, _opt = tl.make_train_step(model)
        sink, probe, result["training"], window = training_phase(
            torch, train_step, (tokens,))
        del train_step, _opt
        result["frames"], seen = frames_phase(sink, probe, window)
        seen["max_bytes_in_use"] = result["frames"]["max_bytes_in_use"]
        result["server"] = server_phase(sink, probe, seen)
        result["query"] = query_phase(sink)
        gc.collect()
        result["storage"] = {}
        storage_phase(sink, result["storage"])
        gc.collect()
        result["cluster"] = {}
        cluster_phase(sink, result["cluster"])
        gc.collect()
        result["readtier"] = {}
        readtier_phase(sink, result["readtier"])
        gc.collect()
        # the card's memory to the children; the span frames stay for
        # the integrations phase's replays
        span_frames = sink.frames
        del model, tokens, sink, probe, seen
        gc.collect()
        torch.cuda.empty_cache()
        result["runner"] = {}
        runner_phase(result["frames"]["kernels_per_step_mode"],
                     result["runner"])
        result["resilience"] = {}
        resilience_phase(torch, tl, result["frames"]["kernels_per_step_mode"],
                         result["resilience"])
        gc.collect()
        torch.cuda.empty_cache()
        result["resnet"] = resnet_phase(torch)
        result["dp"] = {}
        dp_phase(torch, result["dp"])
        result["parallel"] = {}
        parallel_phase(torch, result["parallel"])
        result["mp"] = {}
        mp_phase(torch, result["mp"])
        result["flows"] = {}
        flows_phase(result["flows"])
        result["control"] = {}
        control_phase(result["control"])
        result["enrich"] = {}
        enrich_phase(result["enrich"])
        result["integrations"] = {}
        integrations_phase(span_frames, result["integrations"],
                           result["runner"].get("runner_step_ms_median"))
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
