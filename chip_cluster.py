"""The smoke's cluster phase: the port's server as a three-shard cluster
with replication R = 2 on the card's host.

    python3 chip_phases.py cluster      # alone, after phases 1-4

Run by ``chip_smoke.cluster_phase`` after the ``storage`` phase. Phase
3's span frames, re-stamped replay by replay as the query phase
re-stamps them (``chip_smoke._Replays``), and its step records:

(a) servers, each the entry point in a process of its own: a solo
    server, and three shards with ``--replication 2`` (shard 1 the seed,
    running the controller; shards 2 and 3 join it), until the seed's
    ring holds 3 members at an epoch of 1 or more and every shard holds
    that ring. Every server runs with ``--storage`` (a data directory on
    the checkout's filesystem, deleted at the end): a shard that comes
    back after a SIGKILL must hold the rows it acked, since the claim
    rule makes an alive owner the reporter of its rows (step (f));
(b) AGENTS agents each take their ``analyzer_addrs`` from the seed
    controller's ``Sync`` (the ring's owners of the agent, primary
    first) and ship their share of the replays, CLUSTER_ROWS span rows
    in all, through a ``ReplicatedSender``; the same frames go to the
    solo server through one ``UniformSender`` an agent, first. Acked
    rows/s at R = 2 against the solo server's at R = 1;
(c) placement: every agent's rows on exactly its two owners, counted
    per shard with ``/v1/shard/exec`` (``table_counts`` and a raw
    per-agent count), and the union equal to the solo server's;
(d) through each shard: the three dashboard DF-SQL queries, an Avg, a
    Count(DISTINCT), a Percentile (within 2 %), ``tpu_flame`` (its
    flame canonicalized) and ``tpu_steps``, each equal to the solo
    server's answer, with ``missing_shards == []``; each query's ms
    beside the solo server's;
(e) SIGKILL shard 3: the same answers through shards 1 and 2, with
    ``missing_shards == []`` and ``covered_shards == [3]``; the seconds
    from the kill to the first exact answer; one replay more an agent
    while it is down (its copies wait in the senders' windows);
(f) shard 3 restarted on its ingest port and data directory (a new
    query port): the directory bumps, the ring's epoch moves, every
    agent's next Sync names its sender's owners, every frame is acked
    on every destination with none dropped, and the answers through all
    three shards equal the solo server's again.

Printed beside the card's name and power limit: rows/s at R = 2 and
R = 1, each query's ms federated and solo, the kill-to-exact seconds,
the fan-out hops' emitted / delivered / dropped counts from each shard's
``/v1/health``, and each shard's RSS.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import threading
import time
import urllib.request

import chip_smoke as cs

CLUSTER_ROWS = 500_000   # span rows: a few minutes of eight processes
AGENTS = 8
REPLICATION = 2
WAIT_S = 120.0           # any one wait below
PERCENTILE_RTOL = 0.02   # the sketch's documented bound
SPAN = "profile.tpu_hlo_span"
CLUSTER_HOPS = ("cluster.sql", "cluster.flame", "cluster.promql",
                "cluster.tempo", "cluster.trace")


def _wait(what: str, cond, t0: float | None = None) -> float:
    t0 = time.perf_counter() if t0 is None else t0
    while not cond():
        cs.check(time.perf_counter() - t0 < WAIT_S, what)
        time.sleep(0.01)
    return time.perf_counter() - t0


def _in_parallel(*makers):
    """Run several calls at once (a server process's spawn imports the
    package, its stop drains it): their results in order; the first
    failure raises, after killing the servers the others started."""
    out, errs = [None] * len(makers), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(makers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        for srv in out:
            if isinstance(srv, cs._ServerProcess):
                srv.kill()
        raise errs[0]
    return out


def _shard_exec(qport: int, body: dict):
    """One raw /v1/shard/exec call (no ring in the body: this shard's own
    rows), its SHARD_RESULT frame decoded."""
    from deepflow_tpu_torch.cluster import wire
    req = urllib.request.Request(f"http://127.0.0.1:{qport}/v1/shard/exec",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return wire.decode_result(r.read())[0]


def _per_agent(qport: int) -> dict[int, int]:
    """This shard's raw span rows per agent id."""
    part = _shard_exec(qport, {
        "op": "sql_partial", "table": SPAN,
        "sql": f"SELECT agent_id, Count() AS n FROM {SPAN} "
               "GROUP BY agent_id"})
    cs.check(part.get("kind") == "agg", f"a per-agent partial ({part})")
    (counts,) = part["sites"].values()
    return {int(a): int(n) for a, n in zip(part["keys"][0], counts)}


def _acked(sender) -> bool:
    """Every frame handed to a UniformSender is acked."""
    return (sender._q.empty() and not sender._pending
            and sender._inflight is None
            and sender.stats["acked_seq"] >= sender._next_seq - 1)


def _all_acked(senders) -> bool:
    from deepflow_tpu_torch.agent.sender import ReplicatedSender
    for s in senders:
        inner = (list(s._senders.values())
                 if isinstance(s, ReplicatedSender) else [s])
        if not all(_acked(u) for u in inner):
            return False
    return True


def _ship(senders, frames_of) -> None:
    """Each agent's frames through its sender, from a thread an agent."""
    from deepflow_tpu_torch.codec import MessageType

    def run(sender, frames):
        for mt, p in frames:
            cs.check(sender.send(MessageType(mt), p),
                     "the sender queued the frame")
    threads = [threading.Thread(target=run, args=(s, frames_of[i]))
               for i, s in enumerate(senders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _sync(sync_port: int, i: int, agent_id: int):
    """Agent i's Sync with the seed's controller: (its id, its analyzers)."""
    from deepflow_tpu_torch.proto import wire
    from deepflow_tpu_torch.server.syncwire import SyncClient
    resp = SyncClient(f"127.0.0.1:{sync_port}").call(
        "Sync", wire.SyncRequest(
            ctrl_ip="127.0.0.1", hostname=f"smoke-cluster-{i}",
            agent_id=agent_id, agent_group="default",
            launcher_id=f"smoke-cluster:{i}"), timeout_s=10)
    return resp.agent_id, list(resp.analyzer_addrs)


def _canon(sql: str, result: dict) -> dict:
    """A query's answer; its rows sorted when the query orders none."""
    if "ORDER BY" in sql:
        return result
    return {"columns": result["columns"],
            "values": sorted(result["values"], key=json.dumps)}


def _query_set(solo_q: int) -> dict[str, str]:
    """The three dashboard queries (``chip_smoke._query_sqls``; their
    ORDER BY broken by the op's name, since two servers may order equal
    sums differently), an Avg, two Count(DISTINCT), the rows per agent
    and a Percentile."""
    from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
    kind = TPU_SPAN_KINDS[1]
    top = cs._server_query(solo_q, (
        f"SELECT hlo_op, Sum(duration_ns) AS d FROM {SPAN} WHERE kind = "
        f"'{kind}' AND hlo_op != '' GROUP BY hlo_op ORDER BY d DESC "
        "LIMIT 1"))[0]["result"]["values"]
    cs.check(bool(top), "a device-compute kernel to filter on")
    t_max = cs._server_query(solo_q, f"SELECT Max(time) AS t FROM {SPAN}"
                             )[0]["result"]["values"][0][0]
    pat = top[0][0][:5].replace("%", "_") + "%"
    return {
        "top_kernels":
            f"SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n FROM "
            f"{SPAN} WHERE kind = '{kind}' GROUP BY hlo_op ORDER BY d DESC, "
            "hlo_op LIMIT 10",
        "per_step":
            f"SELECT run_id, Sum(duration_ns) AS d, Count() AS n FROM "
            f"{SPAN} GROUP BY run_id",
        "recent_prefix":
            f"SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n FROM "
            f"{SPAN} WHERE time >= {int(t_max) - cs.QUERY_WINDOW_NS} AND "
            f"hlo_op LIKE '{pat}' GROUP BY hlo_op ORDER BY d DESC, hlo_op "
            "LIMIT 10",
        "avg":
            f"SELECT hlo_op, Avg(duration_ns) AS a FROM {SPAN} GROUP BY "
            "hlo_op ORDER BY a DESC, hlo_op LIMIT 10",
        "distinct":
            f"SELECT Count(DISTINCT hlo_op) AS ops, Count(DISTINCT run_id) "
            f"AS runs, Count() AS n FROM {SPAN}",
        "per_agent":
            f"SELECT agent_id, Count() AS n FROM {SPAN} GROUP BY agent_id "
            "ORDER BY agent_id",
        "percentile":
            f"SELECT Percentile(duration_ns, 95) AS p FROM {SPAN} WHERE "
            f"kind = '{kind}'"}


def _answers(qport: int, sqls: dict) -> tuple[dict, dict, dict]:
    """({name: answer}, {name: ms}, {name: federation}) over HTTP; the
    flame and the step timeline ride along."""
    ans, ms, fed = {}, {}, {}
    for name, sql in sqls.items():
        a, t = cs._server_query(qport, sql)
        ans[name] = _canon(sql, a["result"])
        ms[name], fed[name] = t, a.get("federation")
    for name, route, body in (("tpu_flame", "/v1/profile/TpuFlame", {}),
                              ("tpu_steps", "/v1/tpu/steps", {})):
        code, a, t = cs._http(qport, route, body)
        cs.check(code == 200, f"{route} answers 200 ({a})")
        ans[name] = (cs._canon_flame(a["result"]) if name == "tpu_flame"
                     else a["result"])
        ms[name], fed[name] = t, a.get("federation")
    return ans, ms, fed


def _check_equal(got: dict, want: dict, what: str) -> None:
    for name, w in want.items():
        g = got[name]
        if name == "percentile":
            gv, wv = g["values"][0][0], w["values"][0][0]
            cs.check(abs(gv - wv) <= PERCENTILE_RTOL * abs(wv),
                     f"{what}: Percentile {gv} within 2 % of {wv}")
        else:
            cs.check(g == w, f"{what}: {name} equals the solo server's")


def _check_fed(fed: dict, what: str, covered: list[int] | None) -> None:
    for name, f in fed.items():
        cs.check(f is not None and f["missing_shards"] == [],
                 f"{what}: {name} federated with no shard missing ({f})")
        cs.check(f.get("covered_shards") == covered,
                 f"{what}: {name} covered_shards {f.get('covered_shards')}"
                 f" == {covered}")


def _ring(qport: int) -> dict | None:
    return cs._http(qport, "/v1/cluster/status")[1].get("ring")


def cluster_phase(sink, nums: dict) -> None:
    from deepflow_tpu_torch.agent.sender import (ReplicatedSender,
                                                 UniformSender)
    from deepflow_tpu_torch.codec import MessageType, StreamDecoder
    t_phase = time.perf_counter()
    data = b"".join(sink.frames)
    rep = cs._Replays(cs._span_frames(data))
    steps = [(int(h.msg_type), p) for h, p in StreamDecoder().feed(data)
             if h.msg_type == MessageType.STEP_METRICS]
    # the shipped replays (a multiple of AGENTS), then one an agent more
    # while shard 3 is down
    n_a = AGENTS * max(1, math.ceil(CLUSTER_ROWS / rep.rows / AGENTS))
    rep.check_room(n_a + AGENTS)
    span = int(MessageType.TPU_SPAN)
    frames_a = [[] for _ in range(AGENTS)]
    frames_b = [[] for _ in range(AGENTS)]
    for r in range(n_a + AGENTS):
        dst = frames_a if r < n_a else frames_b
        dst[r % AGENTS].extend((span, p) for _h, p in rep.payloads(r))
    frames_a[0][:0] = steps  # the step records, from one agent
    rows_a = n_a * rep.rows
    root = tempfile.mkdtemp(prefix=".cluster-", dir=cs.ROOT)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    nums.update(rows=rows_a, replays=n_a, agents=AGENTS,
                frames=sum(len(f) for f in frames_a),
                setup_s=time.perf_counter() - t_phase)

    def store(name: str) -> list[str]:
        return ["--data-dir", os.path.join(root, name), "--storage",
                "--compact-interval-s", "0"]

    # the seed's query port is chosen here, so that all four servers
    # spawn at once
    seed_q = cs._closed_port()

    def shard_args(sid: int) -> list[str]:
        join = (["--query-port", str(seed_q), "--advertise", ""]
                if sid == 1 else
                ["--cluster-seed", f"127.0.0.1:{seed_q}", "--no-controller"])
        return (["--shard-id", str(sid), "--replication", str(REPLICATION)]
                + join + store(f"shard{sid}"))

    def log(name: str) -> str:
        return os.path.join(cs.OUT_DIR, f"cluster_{name}.log")

    servers: dict = {}
    senders, solo_senders = [], []
    solo = None
    try:
        # (a) the solo server and the three shards (the joiners retry
        # their join until the seed listens)
        solo, s1, s2, s3 = _in_parallel(
            lambda: cs._ServerProcess(log("solo"), extra_args=[
                "--no-controller"] + store("solo")),
            *((lambda sid=sid: cs._ServerProcess(
                log(f"shard{sid}"), extra_args=shard_args(sid)))
              for sid in (1, 2, 3)))
        servers.update({1: s1, 2: s2, 3: s3})
        cs.check(s1.query_port == seed_q, "the seed on its chosen port")

        def converged() -> bool:
            ring = _ring(s1.query_port)
            if not ring or sorted(ring["members"]) != [1, 2, 3] \
                    or ring["epoch"] < 1:
                return False
            return all((_ring(s.query_port) or {}).get("epoch")
                       == ring["epoch"] for s in servers.values())
        ring_s = _wait("the seed's ring holds 3 members on every shard",
                       converged)
        ring = _ring(s1.query_port)
        nums.update(servers_s=time.perf_counter() - t_phase - nums["setup_s"],
                    ring_converged_s=ring_s, ring_epoch=ring["epoch"])
        ingest_of = {f"127.0.0.1:{s.ingest_port}": sid
                     for sid, s in servers.items()}

        # (b) each agent's analyzers from the seed controller's Sync
        ids, owners = [], {}
        for i in range(AGENTS):
            aid, addrs = _sync(s1.sync_port, i, 201 + i)
            cs.check(len(addrs) == REPLICATION
                     and all(a in ingest_of for a in addrs),
                     f"agent {aid}'s analyzers are {REPLICATION} shards "
                     f"({addrs})")
            ids.append(aid)
            owners[aid] = [ingest_of[a] for a in addrs]
            senders.append(ReplicatedSender(
                addrs, replication=REPLICATION, agent_id=aid,
                queue_size=len(frames_a[i]) + len(frames_b[i]) + 16,
                ack_window=1 << 20))
            solo_senders.append(UniformSender(
                [("127.0.0.1", solo.ingest_port)], agent_id=aid,
                queue_size=len(frames_a[i]) + len(frames_b[i]) + 16,
                ack_window=1 << 20))
        cs.check(len(set(ids)) == AGENTS, f"one id an agent ({ids})")
        for s in senders + solo_senders:
            s.start()
        t0 = time.perf_counter()
        _ship(solo_senders, frames_a)
        solo_s = _wait("the solo server acked every frame",
                       lambda: _all_acked(solo_senders), t0)
        t0 = time.perf_counter()
        _ship(senders, frames_a)
        repl_s = _wait("every frame acked by both of its owners",
                       lambda: _all_acked(senders), t0)
        nums.update(solo_acked_rows_per_s=rows_a / solo_s,
                    r2_acked_rows_per_s=rows_a / repl_s,
                    solo_acked_s=solo_s, r2_acked_s=repl_s)

        # (c) placement: each agent's rows on exactly its two owners
        counts = {sid: _shard_exec(s.query_port, {"op": "table_counts"})
                  for sid, s in servers.items()}
        raw = sum(c[SPAN] for c in counts.values())
        cs.check(raw == REPLICATION * rows_a,
                 f"every span row on {REPLICATION} shards ({raw} raw rows "
                 f"for {rows_a})")
        per_shard = {sid: _per_agent(s.query_port)
                     for sid, s in servers.items()}
        want_agent = _per_agent(solo.query_port)
        cs.check(sum(want_agent.values()) == rows_a,
                 f"the solo server holds every row ({want_agent})")
        for aid in ids:
            held = {sid for sid, pa in per_shard.items() if pa.get(aid)}
            cs.check(held == set(owners[aid]) and all(
                per_shard[sid][aid] == want_agent[aid] for sid in held),
                f"agent {aid}'s rows on exactly its owners "
                f"{owners[aid]} ({held})")

        # (d) every query through every shard against the solo server
        sqls = _query_set(solo.query_port)
        want, solo_ms, _ = _answers(solo.query_port, sqls)
        cs.check(all(v for v in want.values()), "the solo server answers")
        for sid in (1, 2, 3):
            got, ms, fed = _answers(servers[sid].query_port, sqls)
            _check_equal(got, want, f"shard {sid}")
            _check_fed(fed, f"shard {sid}", None)
            for name, t in ms.items():
                nums[f"{name}_ms_shard{sid}"] = t
        for name, t in solo_ms.items():
            nums[f"{name}_ms_solo"] = t
        cs.phase("cluster healthy", **nums)

        # (e) SIGKILL shard 3: exact through shards 1 and 2
        rss = {sid: (cs._proc_sample(s.pid) or (0, 0))[1]
               for sid, s in servers.items()}
        port3 = servers[3].ingest_port
        t_kill = time.perf_counter()
        servers.pop(3).kill()
        first = "per_agent"
        while True:
            cs.check(time.perf_counter() - t_kill < WAIT_S,
                     "an exact answer after the kill")
            a, _t = cs._server_query(s1.query_port, sqls[first])
            if a["result"] == want[first] and \
                    a["federation"]["missing_shards"] == []:
                break
        nums["kill_to_exact_s"] = time.perf_counter() - t_kill
        for sid in (1, 2):
            got, ms, fed = _answers(servers[sid].query_port, sqls)
            _check_equal(got, want, f"shard {sid} after the kill")
            _check_fed(fed, f"shard {sid} after the kill", [3])
            nums[f"top_kernels_ms_shard{sid}_killed"] = ms["top_kernels"]
        _ship(senders, frames_b)
        _ship(solo_senders, frames_b)
        _wait("the solo server acked the outage's frames",
              lambda: _all_acked(solo_senders))
        cs.phase("cluster killed", **nums)

        # (f) shard 3 back on its ingest port and data directory
        epoch0 = ring["epoch"]
        version0 = cs._http(s1.query_port, "/v1/cluster/peers")[1]["version"]
        t0 = time.perf_counter()
        servers[3] = cs._ServerProcess(
            log("shard3_restart"), ingest_port=port3,
            extra_args=shard_args(3))
        _wait("the ring moved to a new epoch on every shard", lambda: all(
            (_ring(s.query_port) or {}).get("epoch", 0) > epoch0
            for s in servers.values()), t0)
        ring = _ring(s1.query_port)
        version = cs._http(s1.query_port, "/v1/cluster/peers")[1]["version"]
        cs.check(version > version0,
                 f"the directory bumped ({version0} -> {version})")
        for i, (aid, sender) in enumerate(zip(ids, senders)):
            got_id, addrs = _sync(s1.sync_port, i, aid)
            cs.check(got_id == aid, f"agent {aid} keeps its id")
            sender.servers = addrs  # the synchronizer's path
            cs.check([f"{h}:{p}" for h, p in sender.servers] == addrs,
                     f"agent {aid}'s sender holds the ring's owners "
                     f"({addrs})")
        drain_s = _wait("every frame acked by every owner after the "
                        "restart", lambda: _all_acked(senders), t0)
        for sender in senders:
            tot = sender.stat_totals()
            cs.check(tot["dropped"] == 0 and tot["unacked_evicted"] == 0,
                     f"agent {sender.agent_id} dropped nothing ({tot})")
        want, _ms, _ = _answers(solo.query_port, sqls)
        for sid in (1, 2, 3):
            got, _ms, fed = _answers(servers[sid].query_port, sqls)
            _check_equal(got, want, f"shard {sid} after the restart")
            _check_fed(fed, f"shard {sid} after the restart", None)
        nums.update(restart_to_drained_s=drain_s, ring_epoch_after=ring["epoch"],
                    directory_version=version,
                    retransmits=sum(s.stat_totals()["retransmits"]
                                    for s in senders),
                    rebalances=sum(s.stats["rebalances"] for s in senders))

        # the fan-out hops' ledgers, and each shard's RSS
        for sid, s in servers.items():
            health = cs._http(s.query_port, "/v1/health")[1]
            for h in health["pipeline"]:
                if h["hop"] not in CLUSTER_HOPS:
                    continue
                cs.check(h["emitted"] == h["delivered"] + h["dropped_total"]
                         + h["in_flight"],
                         f"shard {sid} {h['hop']} balances ({h})")
                key = f"shard{sid}_{h['hop'].replace('.', '_')}"
                nums[f"{key}_emitted"] = h["emitted"]
                nums[f"{key}_delivered"] = h["delivered"]
                nums[f"{key}_dropped"] = h["dropped_total"]
            rss[sid] = max(rss.get(sid, 0),
                           (cs._proc_sample(s.pid) or (0, 0))[1])
            nums[f"shard{sid}_rss_bytes"] = rss[sid]
        for s in senders + solo_senders:
            s.flush_and_stop()
        senders, solo_senders = [], []
        stopping = [servers.pop(sid) for sid in sorted(servers)] + [solo]
        solo = None
        _in_parallel(*(s.stop for s in stopping))
        nums["seconds"] = time.perf_counter() - t_phase
    finally:
        for s in senders + solo_senders:
            s.flush_and_stop(timeout=0)
        for s in list(servers.values()) + [solo]:
            if s is not None:
                s.kill()
        shutil.rmtree(root, ignore_errors=True)
    cs.phase("cluster", **nums)
