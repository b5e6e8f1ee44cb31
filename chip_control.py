"""The smoke's control phase: the port's control plane on the card's host.

    python3 chip_phases.py control       # alone, after the device phase

Run by ``chip_smoke.control_phase``. The port's server runs in a process
of its own with its controller (the entry point's default). ``dfctl org
--assign`` puts job B's agent group in org 2. Then configuration (1)
(``--preset llama7b --layers 4 --seq 1025 --batch 4``) trains as two
concurrent one-rank launcher jobs on the card, each under ``python -m
torch.distributed.run`` and the zero-code runner with ``--controller``
and a group of its own. Once each job's agent has shipped a capture of
ten steps or more, ``dfctl agent-group-config`` saves a new config for
both groups (``PUSHED_YAML``: ``tpuprobe.trace_interval_s`` 4 s, and 5
whole steps a capture at a 10 % coverage). Checks:

- two distinct controller-assigned ids, one a job, each with its
  launcher's identity;
- every span each job's agent sent (its ``agent.tpuprobe`` rows) is held
  once, under its own id; no dup;
- every span and stats row carries the host and a nonzero host id, and
  org 1 (job A) or 2 (job B); DF-SQL under org 2 sees only job B's spans;
- ``/v1/agents`` shows both RUNNING, with the card's name and memory in
  their platform and a measured ``clock_offset_ms``;
- the pushed config reached both agents by push within PUSH_LIMIT_S of
  the save (their ``agent.synchronizer`` rows: the group's new version,
  applied by the push, at the applied time), their capture source took it
  (``agent.tpuprobe.kineto``: ``interval_s`` 4, ``steps_per_capture``
  5), and every capture that opened after the agent applied it spans at
  most SPAN_AFTER_S of wall time, where one before the push spanned
  SPAN_BEFORE_S or more (steps a capture are printed beside: the other
  job's captures change how many steps fit a window).

Printed beside the card's name and power limit: each job's step medians
and means, its Guard's CPU readings and the synchronizer's and the
socket scan's threads' CPU-seconds (``agent.guard.threads``), the
scan's last ms, entries and count (``agent.socket_scan``: each runner
agent scans every 30 s, the reference's default, and must have scanned),
the push's lag, the NTP offsets, and the phase's seconds.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import time

import chip_smoke as cs

STEPS = 300                 # a job's steps: room for captures both sides
PUSH_LIMIT_S = 2.0          # the push reaches the agents within this
PUSH_AFTER_STEPS = 10       # a capture this long before the push
PUSHED_YAML = """\
# pushed mid-run by the smoke's control phase
profiler:
  enabled: true
tpuprobe:
  enabled: true
  trace_interval_s: 4.0
  steps_per_capture: 5
  target_coverage: 0.1
"""
GROUPS = ("ctl-a", "ctl-b")
SPAN_COLS = ["agent_id", "host", "host_id", "org_id", "hlo_op", "run_id",
             "time", "duration_ns"]
# a capture's wall span (its first step's start to its last step's end)
# under the old cadence (20 steps of ~190 ms, the window capped at 4 s)
# and under the pushed one (5 steps): a window is timed from the step
# time the agent measured, so its span is what the cadence sets; its
# step count is not, as the other job's captures stall that job and
# this one's steps run at twice the speed meanwhile
SPAN_BEFORE_S = 2.5
SPAN_AFTER_S = 2.0
STATS_COLS = ["agent_id", "host", "host_id", "org_id", "metric_name",
              "tag_json", "time", "value_name", "value"]
WAIT_S = 240.0


def _dfctl(qport: int, *argv: str) -> str:
    out = subprocess.run(
        [sys.executable, "-m", "deepflow_tpu_torch.cli.dfctl", "--server",
         f"127.0.0.1:{qport}", *argv], cwd=cs.ROOT, capture_output=True,
        text=True, timeout=60)
    cs.check(out.returncode == 0,
             f"dfctl {' '.join(argv)} exit {out.returncode}: {out.stderr}")
    return out.stdout


def _captures(run_ids) -> list[list[int]]:
    """A job's captures: its module spans' steps, split where a step is
    missing (the step held at a stop is left out, and gaps lie between
    windows)."""
    out: list[list[int]] = []
    for r in sorted(set(run_ids)):
        if out and r == out[-1][-1] + 1:
            out[-1].append(r)
        else:
            out.append([r])
    return out


def _module_steps(qport: int) -> dict[int, list[tuple[int, int]]]:
    """agent id -> (run_id, time) of each captured step so far."""
    _, ans, _ = cs._http(qport, "/v1/query", {
        "db": "profile", "sql": "SELECT agent_id, run_id, time FROM "
        "tpu_hlo_span WHERE hlo_op = '' AND run_id > 0"})
    out: dict[int, list] = {}
    for aid, rid, t in ans["result"]["values"]:
        out.setdefault(aid, []).append((rid, t))
    return out


def _latest(stats: dict, aid: int, metric: str) -> dict:
    rows = {k: [v for a, v in zip(stats["agent_id"], stats[k]) if a == aid]
            for k in STATS_COLS}
    return cs._latest_and_max(rows, metric)[0]


def control_phase(nums: dict) -> None:
    import torch
    t_phase = time.perf_counter()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    srv = cs._ServerProcess(
        os.path.join(cs.OUT_DIR, "control_server.log"),
        dump={"profile.tpu_hlo_span": SPAN_COLS, cs._SELFSTATS: STATS_COLS})
    pushed_at: dict[str, int] = {}
    saved_by: dict[str, int] = {}
    versions: dict[str, int] = {}   # each group's pushed config version
    try:
        _dfctl(srv.query_port, "org", "--assign", GROUPS[1], "2")
        orgs = cs._http(srv.query_port, "/v1/orgs", {})[1]["orgs"]
        cs.check(orgs == {GROUPS[1]: 2}, f"dfctl org assigned ({orgs})")
        cfg_path = os.path.join(cs.OUT_DIR, "control_pushed.yaml")
        with open(cfg_path, "w") as f:
            f.write(PUSHED_YAML)

        def job(group: str) -> dict:
            return cs._train_child(
                ["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "1", *cs.RUNNER,
                 "--server", f"127.0.0.1:{srv.ingest_port}",
                 "--controller", f"127.0.0.1:{srv.sync_port}",
                 "--group", group, "--service", group, "-m", cs.EXAMPLE,
                 *cs.EXAMPLE_ARGS, "--steps", str(STEPS)],
                f"control_{group}")

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = {g: pool.submit(job, g) for g in GROUPS}
            # mid-run: each job's agent has shipped a long capture
            t0 = time.perf_counter()
            while True:
                done = [f for f in futs.values() if f.done()]
                for f in done:
                    f.result()  # a failed child raises here
                cs.check(not done, "both jobs still training at the push")
                steps = _module_steps(srv.query_port)
                if len(steps) == 2 and all(
                        max(map(len, _captures(r for r, _ in v)))
                        >= PUSH_AFTER_STEPS for v in steps.values()):
                    break
                cs.check(time.perf_counter() - t0 < WAIT_S,
                         f"both jobs shipped a capture of "
                         f"{PUSH_AFTER_STEPS} steps ({ {a: len(v) for a, v in steps.items()} })")
                time.sleep(0.5)
            for g in GROUPS:
                pushed_at[g] = time.time_ns()
                out = _dfctl(srv.query_port, "agent-group-config", "set",
                             cfg_path, "--group", g).strip()
                saved_by[g] = time.time_ns()  # dfctl returned: saved
                head, _, v = out.rpartition(" ")
                cs.check(head == f"group {g} -> version" and int(v) > 1,
                         f"dfctl agent-group-config ({out})")
                versions[g] = int(v)
            runs = {g: f.result() for g, f in futs.items()}
        health = cs._ingest_settled(srv.query_port)
        _, agents_end, _ = cs._http(srv.query_port, "/v1/agents")
        b_sql = ("SELECT agent_id, Count() AS n FROM tpu_hlo_span "
                 "GROUP BY agent_id")
        _, org2, org2_ms = cs._http(srv.query_port, "/v1/query", {
            "db": "profile", "sql": b_sql, "org_id": 2})
        _, org1, _ = cs._http(srv.query_port, "/v1/query", {
            "db": "profile", "sql": b_sql, "org_id": 1})
    finally:
        rows = srv.stop()
    spans, stats = rows["profile.tpu_hlo_span"], rows[cs._SELFSTATS]
    # the agents' rows: the server writes its own telemetry there too
    mine = [i for i, m in enumerate(stats["metric_name"])
            if not m.startswith("server.")]
    stats = {c: [v[i] for i in mine] for c, v in stats.items()}

    agents = {a["agent_group"]: a for a in agents_end["agents"]}
    cs.check(sorted(agents) == sorted(GROUPS),
             f"one agent a job ({sorted(agents)})")
    ids = {g: agents[g]["agent_id"] for g in GROUPS}
    cs.check(len(set(ids.values())) == 2, f"two distinct ids ({ids})")
    cs.check(len({agents[g]["launcher_id"] for g in GROUPS}) == 2 and all(
        agents[g]["launcher_id"].endswith("/0") for g in GROUPS),
        "each agent registered with its job's launcher identity")
    kind = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    for g in GROUPS:
        a = agents[g]
        devs = (a["platform"] or {}).get("devices", [])
        cs.check(a["state"] == 1 and not a["degraded"],
                 f"{g}'s agent RUNNING ({a['state']})")
        cs.check(len(devs) == 1 and devs[0]["device_kind"] == kind
                 and devs[0]["hbm_bytes"] == total,
                 f"{g}'s platform shows the card ({devs})")
        cs.check(a["clock_offset_ms"] is not None,
                 f"{g}'s clock offset measured")
    host = socket.gethostname()
    per_agent: dict[int, int] = {}
    for a in spans["agent_id"]:
        per_agent[a] = per_agent.get(a, 0) + 1
    cs.check(set(per_agent) == set(ids.values()),
             f"span rows under the two ids only ({sorted(per_agent)})")
    for cols, what in ((spans, "span"), (stats, "stats")):
        tags = set(zip(cols["agent_id"], cols["host"],
                       [h > 0 for h in cols["host_id"]], cols["org_id"]))
        want = {(ids[GROUPS[0]], host, True, 1),
                (ids[GROUPS[1]], host, True, 2)}
        cs.check(tags == want, f"every {what} row carries its host, a "
                 f"host id and its job's org ({sorted(tags)})")
    org2_ids = {r[0] for r in org2["result"]["values"]}
    org1_ids = {r[0] for r in org1["result"]["values"]}
    cs.check(org2_ids == {ids[GROUPS[1]]} and org1_ids == {ids[GROUPS[0]]},
             f"DF-SQL under org 2 sees job B only ({org2_ids}, {org1_ids})")
    dec = health["stats"]["decoders"]
    cs.check(sum(d["dups"] + d["errors"] for d in dec.values()) == 0,
             "no dup and no decode error in the server")
    out: dict = {"agent_ids": ids, "org2_query_ms": org2_ms,
                 "steps": STEPS}
    for g in GROUPS:
        aid = ids[g]
        tp = _latest(stats, aid, "agent.tpuprobe")
        sync = _latest(stats, aid, "agent.synchronizer")
        kin = _latest(stats, aid, "agent.tpuprobe.kineto")
        guard_rows = {k: [v for a, v in zip(stats["agent_id"], stats[k])
                          if a == aid] for k in STATS_COLS}
        guard_latest, guard_max = cs._latest_and_max(guard_rows,
                                                     "agent.guard")
        threads = cs._latest_and_max(guard_rows, "agent.guard.threads")[0]
        scan = _latest(stats, aid, "agent.socket_scan")
        cs.check(scan.get("scans", 0) >= 1 and not scan.get("errors"),
                 f"{g}: the runner agent's socket scan ran ({scan})")
        cs.check(per_agent[aid] == tp.get("spans_sent", -1) > 0,
                 f"{g}: every span it sent held once ({per_agent[aid]} "
                 f"against {tp.get('spans_sent')})")
        # the save happened while dfctl ran: the apply lies after its
        # start and within PUSH_LIMIT_S of its end
        applied = sync.get("config_applied_ns", 0)
        lag_s = (applied - pushed_at[g]) / 1e9
        dfctl_s = (saved_by[g] - pushed_at[g]) / 1e9
        cs.check(sync.get("config_version") == versions[g]
                 and sync.get("config_applied_by_push") == 1
                 and 0 <= lag_s and lag_s - dfctl_s < PUSH_LIMIT_S,
                 f"{g}: the pushed config applied by push within "
                 f"{PUSH_LIMIT_S} s (lag {lag_s:.3f} s from dfctl's start, "
                 f"dfctl {dfctl_s:.3f} s; {sync})")
        cs.check(kin.get("interval_s") == 4.0
                 and kin.get("steps_per_capture") == 5
                 and kin.get("retunes", 0) >= 1,
                 f"{g}: the capture source took the pushed cadence ({kin})")
        steps = sorted((r, t, d) for a, op, r, t, d in zip(
            spans["agent_id"], spans["hlo_op"], spans["run_id"],
            spans["time"], spans["duration_ns"]) if a == aid and not op and r)
        t_of = {r: (t, t + d) for r, t, d in steps}
        caps = [(len(c), (t_of[c[-1]][1] - t_of[c[0]][0]) / 1e9, c[0])
                for c in _captures(r for r, _, _ in steps)]
        before = [(n, span) for n, span, r0 in caps
                  if t_of[r0][0] < pushed_at[g]]
        # a capture open at the apply ends with the old cadence; one whose
        # first step starts a second after the apply opened after it
        after = [(n, span) for n, span, r0 in caps
                 if t_of[r0][0] > applied + 1e9]
        cs.check(before and max(span for _, span in before) >= SPAN_BEFORE_S,
                 f"{g}: a capture spanning {SPAN_BEFORE_S}+ s before the "
                 f"push ((steps, s): {before})")
        cs.check(after and max(span for _, span in after) <= SPAN_AFTER_S,
                 f"{g}: every capture after the push spans <= "
                 f"{SPAN_AFTER_S} s ((steps, s): {after})")
        run = runs[g]
        out[g] = {
            "agent_id": aid, "spans": per_agent[aid],
            "step_ms_median": run["step_ms_median"],
            "step_ms_mean": run["step_ms_mean"],
            "step_ms_max": run["step_ms_max"], "wall_s": run["wall_s"],
            "push_lag_from_dfctl_start_ms": lag_s * 1000.0,
            "dfctl_set_ms": dfctl_s * 1000.0,
            "captures_before_steps": [n for n, _ in before],
            "captures_before_s": [round(x, 3) for _, x in before],
            "captures_after_steps": [n for n, _ in after],
            "captures_after_s": [round(x, 3) for _, x in after],
            "clock_offset_ms": agents[g]["clock_offset_ms"],
            "syncs": sync.get("syncs"), "pushes": sync.get("pushes"),
            "register_failures": sync.get("register_failures"),
            "guard_cpu_pct_latest": guard_latest.get("cpu_pct"),
            "guard_cpu_pct_max": guard_max.get("cpu_pct"),
            "synchronizer_thread_cpu_s": {
                k: v for k, v in threads.items() if "sync" in k},
            "socket_scan_thread_cpu_s": {
                k: v for k, v in threads.items() if "scan" in k},
            "socket_scans": scan.get("scans"),
            "socket_scan_ms_last": scan.get("scan_ms"),
            "socket_scan_entries": scan.get("entries")}
    out["phase_s"] = time.perf_counter() - t_phase
    nums.update(out)
    cs.phase("control", **{k: json.dumps(v) if isinstance(v, dict) else v
                           for k, v in nums.items()})
