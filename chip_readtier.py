"""The smoke's readtier phase: storage that heals itself and reads that
scale, on the card's host.

    python3 chip_phases.py readtier     # alone, after phases 1-4

Run by ``chip_smoke.readtier_phase`` after the ``cluster`` phase: the
reference's read-tier deployment (docs/CLUSTER.md, "Read tier";
``cli/readtier_check.py``) with the corruption arms of
``cli/scrub_check.py``. Phase 3's span frames, re-stamped replay by
replay (``chip_smoke._Replays``), and its step records:

(a) one ingest shard (``--storage --objstore DIR``, 1 s flush, a publish
    every 0.5 s and a scrub cycle every second, no compaction) and
    REPLICAS querier replicas (``--role querier --segcache-max-mb 16``, a
    pointer poll every 0.5 s and a scrub cycle every second), each the
    entry point in a process of its own, spawned at once; every data
    directory and the object store on the checkout's filesystem (deleted
    at the end);
(b) AGENTS agents ship READTIER_ROWS span rows through their senders;
    every frame acked (after its commit), the pointer names every row
    (publish lag from the last ack to the swap) and every replica adopts
    it (the swap to the last adoption);
(c) each replica answers the six profile queries and the storm's
    bucketable DF-SQL aggregates equal to the ingest node's own;
(d) compute once: replica 0 warms the storm, the adverts reach the
    others, which then answer it with no bucket scan of their own, and
    ``served_buckets == fetched_buckets`` fleet-wide;
(e) storm queries/s through 1, 2 and all replicas over the published
    state, a client process a replica, and the reference's verdict where
    the host has the cores (through all four >= 3 times one replica's;
    printed, not gated: it moves with the host's load); then a trickle
    agent ships, and its
    frames' append-to-ack p99 is taken alone and beside the storm through
    all replicas (with storage an ack waits for the commit);
(f) integrity, on the ingest while the trickle flows: a bit flipped in a
    sealed, published segment is quarantined and repaired from its blob;
    a flipped blob is deleted and re-published from the local copy;
    then, quiesced: with the blob gone and the local copy flipped, the
    answers say ``degraded`` on the ingest and ``degraded_shards``
    through every replica, and the quarantined rows are missing; the
    blob restored, the retry repairs and every answer is whole again; a
    flipped cached copy on a replica is discarded and fetched again;
    ``GET /v1/fsck`` ends clean; every hop ledger of every server
    balances.

Printed beside the card's name and power limit: the publish lag, each
replica's segment-cache counters and RSS, query ms on a replica and on
the ingest, storm queries/s with the host's cores, the ack p99s, the
flip-to-quarantine and flip-to-repair seconds and fsck's MB/s. A failed
check raises.
"""

from __future__ import annotations

import glob
import json
import math
import os
import shutil
import tempfile
import threading
import time

import chip_smoke as cs
from chip_cluster import _all_acked, _in_parallel, _ship

READTIER_ROWS = 2_000_000  # span rows: minutes of eight processes
REPLICAS = 4
SEGCACHE_MB = 16           # below the published tier: evictions happen
AGENTS = 4
WAIT_S = 90.0              # any one wait below
STORM_S = 1.0              # each storm window
TRICKLE_EVERY_S = 0.05     # the trickle agent's frame cadence
TRICKLE_REPLAYS = 64       # the most replays the trickle may ship
SCALE_WANT = 3.0           # the reference's bar for the storm's speedup
                           # over all replicas, where the cores allow
SPAN = "profile.tpu_hlo_span"
STORM = {
    "by_op": f"SELECT hlo_op, Count() AS n, Sum(duration_ns) AS d FROM "
             f"{SPAN} GROUP BY hlo_op",
    "by_device": f"SELECT device_id, Max(duration_ns) AS mx, "
                 f"Min(duration_ns) AS mn FROM {SPAN} GROUP BY device_id",
    "by_run": f"SELECT run_id, Sum(duration_ns) AS d, Count() AS n FROM "
              f"{SPAN} GROUP BY run_id",
    "by_module": f"SELECT hlo_module, Count() AS n, Max(bytes_accessed) "
                 f"AS b FROM {SPAN} GROUP BY hlo_module"}
COUNT_SQL = f"SELECT Count() AS n FROM {SPAN}"


def _wait(what: str, cond, t0: float | None = None) -> float:
    t0 = time.perf_counter() if t0 is None else t0
    while not cond():
        cs.check(time.perf_counter() - t0 < WAIT_S, what)
        time.sleep(0.02)
    return time.perf_counter() - t0


def _health(port: int) -> dict:
    code, h, _ms = cs._http(port, "/v1/health")
    cs.check(code == 200, f"/v1/health answers 200 ({h})")
    return h


def _sorted(result: dict) -> dict:
    return {"columns": result["columns"],
            "values": sorted(result["values"], key=json.dumps)}


def _query(port: int, sql: str) -> tuple[dict, float]:
    code, a, ms = cs._http(port, "/v1/query", {"sql": sql})
    cs.check(code == 200, f"/v1/query answers 200 ({a})")
    return a, ms


def _count(port: int) -> tuple[int, dict]:
    a, _ms = _query(port, COUNT_SQL)
    return int(a["result"]["values"][0][0]), a


def _pointer(obj: str) -> dict:
    try:
        with open(os.path.join(obj, "ptr", "MANIFEST-1")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _published_rows(doc: dict) -> int:
    t = (doc.get("tables") or {}).get(SPAN) or {}
    return sum(int(s["rows"]) for s in t.get("segments", []))


def _profile_bodies(t_lo: int, t_hi: int) -> dict[str, tuple]:
    """The six profile routes; those that list rows over a window."""
    window = {"time_start": t_lo, "time_end": t_hi}
    return {"profile_tracing": ("/v1/profile/ProfileTracing", {}),
            "tpu_flame": ("/v1/profile/TpuFlame", {}),
            "tpu_memory": ("/v1/profile/TpuMemory", dict(window)),
            "tpu_collectives": ("/v1/profile/TpuCollectives", dict(window)),
            "tpu_step_trace": ("/v1/profile/TpuStepTrace", dict(window)),
            "tpu_steps": ("/v1/tpu/steps", {})}


def _canon(name: str, result):
    if name in ("profile_tracing", "tpu_flame"):
        return cs._canon_flame(result)
    if name == "tpu_collectives":
        return sorted(result, key=json.dumps)
    return result


def _answers(port: int, bodies: dict) -> tuple[dict, dict]:
    ans, ms = {}, {}
    for name, (route, body) in bodies.items():
        code, a, t = cs._http(port, route, body)
        cs.check(code == 200, f"{route} answers 200 ({a})")
        ans[name], ms[name] = _canon(name, a["result"]), t
    for name, sql in STORM.items():
        a, t = _query(port, sql)
        fed = a.get("federation")
        cs.check(fed is None or fed["missing_shards"] == [],
                 f"{name}: no shard missing ({fed})")
        ans[name], ms[name] = _sorted(a["result"]), t
    return ans, ms


def _check_replicas(replicas: list, bodies: dict, want: dict,
                    what: str) -> None:
    """Every replica's answers equal ``want``; the replicas answer at
    once (each is a process of its own)."""
    got = _in_parallel(*(lambda q=q: _answers(q.query_port, bodies)[0]
                         for q in replicas))
    for q, ans in zip(replicas, got):
        for name in want:
            cs.check(ans[name] == want[name],
                     f"replica :{q.query_port} {what}: {name} equals the "
                     "ingest node's")


class _Trickle:
    """One agent shipping a replay frame every TRICKLE_EVERY_S, each
    frame's append-to-ack ms sampled while a window is open."""

    def __init__(self, port: int, payloads, agent_id: int) -> None:
        from deepflow_tpu_torch.agent.sender import UniformSender
        self.sender = UniformSender([("127.0.0.1", port)],
                                    agent_id=agent_id, queue_size=4096,
                                    ack_window=1 << 20).start()
        self._payloads = payloads
        self._sent: dict[int, float] = {}
        self._window: list[float] | None = None
        self._stop = threading.Event()
        self.frames = 0
        self._threads = [threading.Thread(target=self._send, daemon=True),
                         threading.Thread(target=self._acks, daemon=True)]
        for t in self._threads:
            t.start()

    def _send(self) -> None:
        from deepflow_tpu_torch.codec import MessageType
        for mt, p in self._payloads:
            if self._stop.wait(TRICKLE_EVERY_S):
                return
            # the k-th frame takes seq seq_base + k
            self._sent[self.sender.seq_base + self.frames + 1] = \
                time.perf_counter()
            cs.check(self.sender.send(MessageType(mt), p),
                     "the trickle sender queued the frame")
            self.frames += 1

    def _acks(self) -> None:
        done = self.sender.seq_base
        while not self._stop.is_set():
            acked = self.sender.stats["acked_seq"]
            now = time.perf_counter()
            for seq in range(done + 1, acked + 1):
                t = self._sent.pop(seq, None)
                if t is not None and self._window is not None:
                    self._window.append((now - t) * 1000.0)
            done = max(done, acked)
            time.sleep(0.002)

    def window(self) -> None:
        self._window = []

    def p99(self) -> float | None:
        """The window's p99 ms (None: no frame acked in it)."""
        w, self._window = sorted(self._window or []), None
        return w[min(len(w) - 1, int(0.99 * len(w)))] if w else None

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join()
        _wait("the trickle's frames acked",
              lambda: _all_acked([self.sender]))
        self.sender.flush_and_stop()


# one storm client: a process of its own a replica (as dashboards on other
# hosts: the smoke's own interpreter stays out of the count), two threads,
# each on one kept-alive connection, from a start time to an end time
_STORM_CLIENT = """
import http.client, json, sys, threading, time
port, t0, t1 = int(sys.argv[1]), float(sys.argv[2]), float(sys.argv[3])
bodies = [json.dumps({"sql": s}).encode() for s in json.loads(sys.argv[4])]
done, bad = [0, 0], []
def run(k):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    i = k
    while time.time() < t0:
        time.sleep(0.001)
    while time.time() < t1:
        c.request("POST", "/v1/query", bodies[i % len(bodies)])
        r = c.getresponse()
        r.read()
        if r.status != 200:
            bad.append(r.status)
        done[k] += 1
        i += 1
ts = [threading.Thread(target=run, args=(k,)) for k in range(2)]
for t in ts:
    t.start()
for t in ts:
    t.join()
print(json.dumps({"queries": sum(done), "bad": bad[:3]}))
"""


def _storm(ports: list[int], seconds: float) -> float:
    """Queries/s of the storm set through the replicas: a client process
    a replica over the same window."""
    import subprocess
    import sys
    t0 = time.time() + 0.5  # every client up before the window opens
    sqls = json.dumps(list(STORM.values()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _STORM_CLIENT, str(p), repr(t0),
         repr(t0 + seconds), sqls], stdout=subprocess.PIPE, text=True)
        for p in ports]
    total = 0
    for proc in procs:
        out, _ = proc.communicate(timeout=60 + seconds)
        got = json.loads(out)
        cs.check(proc.returncode == 0 and not got["bad"],
                 f"a storm client answered 200 ({got})")
        total += got["queries"]
    return total / seconds


def _corrupt(path: str, seed: int) -> dict:
    from deepflow_tpu_torch import chaos
    return chaos.corrupt_segment(path, seed=seed, mode="bit_flip")


def _scrub(ingest: int) -> dict:
    return _health(ingest)["storage"]["scrub"]


def readtier_phase(sink, nums: dict) -> None:
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.codec import MessageType, StreamDecoder
    from deepflow_tpu_torch.store import objstore
    from deepflow_tpu_torch.store.segment import verify_buffer
    t_phase = time.perf_counter()
    data = b"".join(sink.frames)
    rep = cs._Replays(cs._span_frames(data))
    steps = [(int(h.msg_type), p) for h, p in StreamDecoder().feed(data)
             if h.msg_type == MessageType.STEP_METRICS]
    n_bulk = AGENTS * max(1, math.ceil(READTIER_ROWS / rep.rows / AGENTS))
    rep.check_room(n_bulk + TRICKLE_REPLAYS)
    span = int(MessageType.TPU_SPAN)
    bulk = [[] for _ in range(AGENTS)]
    for r in range(n_bulk):
        bulk[r % AGENTS].extend((span, p) for _h, p in rep.payloads(r))
    bulk[0][:0] = steps
    # re-stamped as they go, so the trickle never runs dry
    trickle = ((span, p) for r in range(n_bulk, n_bulk + TRICKLE_REPLAYS)
               for _h, p in rep.payloads(r))
    root = tempfile.mkdtemp(prefix=".readtier-", dir=cs.ROOT)
    obj = os.path.join(root, "obj")
    nums.update(rows=n_bulk * rep.rows, replays=n_bulk, agents=AGENTS,
                replicas=REPLICAS, segcache_max_mb=SEGCACHE_MB,
                host_cores=os.cpu_count(),
                setup_s=time.perf_counter() - t_phase)
    seed_q = cs._closed_port()

    def log(name: str) -> str:
        return os.path.join(cs.OUT_DIR, f"readtier_{name}.log")
    ingest_args = ["--no-controller", "--shard-id", "1", "--query-port",
                   str(seed_q), "--advertise", "",
                   "--data-dir", os.path.join(root, "ingest"), "--storage",
                   "--flush-interval-s", "1", "--compact-interval-s", "0",
                   "--objstore", obj, "--publish-interval-s", "0.5",
                   "--scrub-interval-s", "1"]

    def querier_args(i: int) -> list[str]:
        return ["--role", "querier", "--shard-id", str(11 + i),
                "--cluster-seed", f"127.0.0.1:{seed_q}", "--objstore", obj,
                "--data-dir", os.path.join(root, f"q{i}"),
                "--segcache-max-mb", str(SEGCACHE_MB),
                "--readtier-poll-s", "0.5", "--scrub-interval-s", "1"]

    os.makedirs(cs.OUT_DIR, exist_ok=True)
    servers: list = []
    senders: list = []
    trickle_agent = None
    try:
        # (a) the ingest shard and the replicas, spawned at once
        servers = _in_parallel(
            lambda: cs._ServerProcess(log("ingest"), extra_args=ingest_args),
            *((lambda i=i: cs._ServerProcess(log(f"q{i}"),
                                             extra_args=querier_args(i)))
              for i in range(REPLICAS)))
        ingest, qs = servers[0], servers[1:]
        ip = ingest.query_port
        cs.check(ip == seed_q, "the ingest shard on its chosen port")
        _wait("every replica joined the ingest shard", lambda: all(
            any(p["shard_id"] == 1 for p in cs._http(
                q.query_port, "/v1/cluster/peers")[1]["peers"])
            for q in qs))
        nums["servers_s"] = time.perf_counter() - t_phase - nums["setup_s"]

        # (b) the bulk rows, acked after their commit; published; adopted
        for i in range(AGENTS):
            senders.append(UniformSender(
                [("127.0.0.1", ingest.ingest_port)], agent_id=301 + i,
                queue_size=len(bulk[i]) + 16, ack_window=1 << 20).start())
        t0 = time.perf_counter()
        _ship(senders, bulk)
        acked_s = _wait("the ingest shard acked every frame",
                        lambda: _all_acked(senders), t0)
        total = _health(ip)["tables"][SPAN]
        cs.check(total == nums["rows"],
                 f"the ingest holds every row ({total})")
        _wait("the pointer names every row",
              lambda: _published_rows(_pointer(obj)) == total)
        gen = _pointer(obj)["publish_gen"]
        _wait("every replica adopts the newest pointer",
              lambda: all(_health(q.query_port)["readtier"]["adopted"]
                          .get("1", 0) >= gen for q in qs))
        t_adopted = time.time()
        # the lag on the files' own clock: the last commit (the tier's
        # manifest) to the pointer's swap, then to the last adoption seen
        t_commit = os.stat(os.path.join(root, "ingest", "segments",
                                        "MANIFEST.json")).st_mtime
        t_swap = os.stat(os.path.join(obj, "ptr", "MANIFEST-1")).st_mtime
        nums.update(acked_rows_per_s=total / acked_s, publish_gen=gen,
                    publish_lag_commit_to_swap_s=t_swap - t_commit,
                    publish_lag_swap_to_adopted_s=t_adopted - t_swap,
                    published_bytes=sum(
                        int(s["bytes"]) for s in _pointer(obj)["tables"]
                        [SPAN]["segments"]))

        # (c) every replica answers as the ingest node does
        t_max = int(_query(ip, f"SELECT Max(time) AS t FROM {SPAN}")[0]
                    ["result"]["values"][0][0])
        bodies = _profile_bodies(t_max - 10**9, t_max + 1)
        want, ingest_ms = _answers(ip, bodies)
        cs.check(want["by_op"]["values"] and want["tpu_steps"]["steps"],
                 "the ingest node answers with rows")
        for name, t in ingest_ms.items():
            nums[f"{name}_ms_ingest"] = t

        # (d) compute once: replica 0 warms the storm for the fleet
        got, ms = _answers(qs[0].query_port, bodies)
        for name in want:
            cs.check(got[name] == want[name],
                     f"replica 0: {name} equals the ingest node's")
        for name, t in ms.items():
            nums[f"{name}_ms_replica"] = t
        warm = _health(qs[0].query_port)["query_cache"]["bucket_misses"]
        cs.check(warm > 0, "replica 0 scanned the storm's buckets")
        # every bucketed query replica 0 holds warm, advertised to all
        n_warm = _health(qs[0].query_port)["query_cache"]["bucket_queries"]
        _wait("the warm adverts reach every replica", lambda: all(
            _health(q.query_port)["partial_cache"]["adverts_known"]
            >= n_warm for q in qs[1:]))
        _check_replicas(qs[1:], bodies, want, "cold, fetching")
        for i, q in enumerate(qs[1:], 1):
            qc = _health(q.query_port)["query_cache"]
            cs.check(qc["bucket_misses"] == 0 and qc["dist_hits"] >= warm,
                     f"replica {i} scanned no bucket ({qc})")
        pcs = [_health(q.query_port)["partial_cache"] for q in qs]
        served = sum(p["served_buckets"] for p in pcs)
        fetched = sum(p["fetched_buckets"] for p in pcs)
        cs.check(fetched > 0 and served == fetched,
                 f"served_buckets {served} == fetched_buckets {fetched}")
        cs.check(all(p["fetch_errors"] == p["remap_failures"] == 0
                     for p in pcs), f"no partial-cache errors ({pcs})")
        nums.update(warm_buckets=warm, served_buckets=served,
                    fetched_buckets=fetched)
        cs.phase("readtier replicas", **nums)

        # (e) the storm through 1, 2 and all replicas over the published
        # state (the ingest quiet: a publish a second would move every
        # replica's adopted gen mid-storm); then the trickle's ack p99
        # alone and beside the storm through all replicas
        for n in sorted({1, 2, REPLICAS}):
            nums[f"storm_qps_{n}"] = _storm(
                [q.query_port for q in qs[:n]], STORM_S)
        nums["storm_speedup"] = (nums[f"storm_qps_{REPLICAS}"]
                                 / max(nums["storm_qps_1"], 1e-9))
        # measured and printed, not gated: the reference's verdict where
        # the host has a core a replica (None where it has not)
        nums["storm_meets_bar"] = (
            nums["storm_speedup"] >= SCALE_WANT
            if (os.cpu_count() or 1) >= REPLICAS else None)
        # each window outlasts an ack's wait for its commit (the 1 s flush)
        trickle_agent = _Trickle(ingest.ingest_port, trickle, 399)
        trickle_agent.window()
        time.sleep(2 * STORM_S)
        nums["ack_p99_ms_no_storm"] = trickle_agent.p99()
        trickle_agent.window()
        nums[f"storm_qps_{REPLICAS}_ingesting"] = _storm(
            [q.query_port for q in qs], 2 * STORM_S)
        nums["ack_p99_ms_storm"] = trickle_agent.p99()

        # (f) integrity, while the trickle flows
        seg_dir = os.path.join(root, "ingest", "segments", SPAN)
        published = [s["fn"] for s in _pointer(obj)["tables"][SPAN]
                     ["segments"]]
        cs.check(len(published) >= 3, f"three published segments "
                 f"({len(published)})")
        fn_a, fn_b, fn_c = published[:3]
        before = _scrub(ip)
        t_flip = time.perf_counter()
        _corrupt(os.path.join(seg_dir, fn_a), seed=3)
        nums["flip_to_quarantine_s"] = _wait(
            "the flipped segment is quarantined", lambda: _scrub(ip)
            ["quarantined"] > before["quarantined"], t_flip)
        nums["flip_to_repair_s"] = _wait(
            "the flipped segment is repaired from its blob", lambda: _scrub(
                ip)["repaired"] > before["repaired"], t_flip)
        blob_b = os.path.join(obj, "blobs", *objstore.seg_key(
            1, SPAN, fn_b).split("/"))
        _corrupt(blob_b, seed=5)
        nums["blob_flip_to_republish_s"] = _wait(
            "the flipped blob is re-published from the local copy",
            lambda: _scrub(ip)["blobs_republished"]
            > before["blobs_republished"])
        with open(blob_b, "rb") as f:
            cs.check(verify_buffer(f.read())["ok"],
                     "the re-published blob verifies")
        trickle_agent.stop()
        trickle_agent = None
        total = _health(ip)["tables"][SPAN]

        def settled() -> bool:
            """Every row the ingest serves is published (a quarantined
            segment's rows leave both), and every replica adopted the
            pointer."""
            doc = _pointer(obj)
            return (_published_rows(doc) == _health(ip)["tables"][SPAN]
                    and all(_health(s.query_port)["readtier"]["adopted"]
                            .get("1", 0) >= doc.get("publish_gen", 0)
                            for s in qs))
        _wait("the trickle's rows published and adopted", settled)

        # with no healthy copy anywhere: degraded, the rows missing
        key_c = objstore.seg_key(1, SPAN, fn_c)
        blob_c = os.path.join(obj, "blobs", *key_c.split("/"))
        with open(blob_c, "rb") as f:
            stash = f.read()
        os.unlink(blob_c)
        _corrupt(os.path.join(seg_dir, fn_c), seed=7)
        _wait("the segment without a blob stays quarantined", lambda: (
            _count(ip)[1].get("degraded") or {}).get("segments", 0) >= 1)
        n_ing, a_ing = _count(ip)
        q_rows = a_ing["degraded"]["rows"]
        cs.check(n_ing == total - q_rows > 0,
                 f"the quarantined rows are missing on the ingest "
                 f"({n_ing} == {total} - {q_rows})")
        _wait("the replicas adopt the pointer without it", settled)
        for i, q in enumerate(qs):
            n, a = _count(q.query_port)
            deg = (a.get("federation") or {}).get("degraded_shards") or {}
            cs.check(n == n_ing and "1" in deg and a.get("warnings"),
                     f"replica {i}: degraded through the federation "
                     f"({n}, {a.get('federation')})")
        nums["quarantined_rows"] = q_rows
        # the blob back: the retry repairs, every answer whole again
        objstore.ObjStore(obj).put_if_absent(key_c, data=stash)
        _wait("the retry repairs the segment", lambda: "degraded"
              not in _count(ip)[1])
        _wait("the replicas adopt the repaired pointer", settled)
        for port in [ip] + [q.query_port for q in qs]:
            n, a = _count(port)
            cs.check(n == total and "degraded" not in a and not (
                a.get("federation") or {}).get("degraded_shards"),
                f"whole again on :{port} ({n} == {total})")
        want, _ms = _answers(ip, bodies)
        _check_replicas(qs, bodies, want, "after the repairs")

        # a flipped cached copy on a replica: discarded, fetched again
        cached = sorted(glob.glob(os.path.join(root, "q0", "segcache", "1",
                                               SPAN, "*.seg")))
        cs.check(bool(cached), "replica 0 holds cached segments")
        h0 = _health(qs[0].query_port)
        _corrupt(cached[0], seed=11)
        _wait("the replica's scrubber discards the flipped copy",
              lambda: _health(qs[0].query_port)["scrub"]["cache_corrupt"]
              > h0["scrub"]["cache_corrupt"])
        fetches0 = h0["readtier"]["segcache"]["fetches"]
        # a query text no cache holds: it scans every segment
        fresh = f"SELECT Count(DISTINCT duration_ns) AS fresh FROM {SPAN}"
        cs.check(_query(qs[0].query_port, fresh)[0]["result"]
                 == _query(ip, fresh)[0]["result"],
                 "replica 0 after a discarded copy equals the ingest")
        h0 = _health(qs[0].query_port)
        cs.check(h0["readtier"]["segcache"]["fetches"] > fetches0,
                 "replica 0 fetched the discarded copy again")

        # fsck ends clean; its pass times the verify
        code, fsck, fsck_ms = cs._http(ip, "/v1/fsck")
        cs.check(code == 200 and fsck["ok"], f"fsck ends clean ({fsck})")
        fbytes = sum(t["bytes"] for t in fsck["tables"].values())
        nums.update(fsck_ms=fsck_ms, fsck_bytes=fbytes,
                    fsck_mb_per_s=fbytes / 1e6 / (fsck_ms / 1000.0))

        # every ledger of every server balances; the replicas' numbers
        for name, srv in [("ingest", ingest)] + [
                (f"q{i}", q) for i, q in enumerate(qs)]:
            h = _health(srv.query_port)
            for hop in h["pipeline"]:
                cs.check(hop["emitted"] == hop["delivered"]
                         + hop["dropped_total"] + hop["in_flight"],
                         f"{name}: {hop['hop']} balances ({hop})")
                if hop["hop"] in ("storage.scrub", "storage.repair",
                                  "readtier.segcache",
                                  "cluster.partialcache"):
                    key = f"{name}_{hop['hop'].replace('.', '_')}"
                    nums[f"{key}_emitted"] = hop["emitted"]
                    nums[f"{key}_dropped"] = hop["dropped_total"]
            if name != "ingest":
                sc = h["readtier"]["segcache"]
                for k in ("fetches", "hits", "misses", "evictions",
                          "deferred_unlinks", "fetch_corrupt"):
                    nums[f"{name}_segcache_{k}"] = sc[k]
                nums[f"{name}_rss_bytes"] = (
                    cs._proc_sample(srv.pid) or (0, 0))[1]
        scrub = _scrub(ip)
        for k in ("segments_scanned", "bytes_scanned", "quarantined",
                  "repaired", "repair_failed", "blobs_republished"):
            nums[f"ingest_scrub_{k}"] = scrub[k]
        for s in senders:
            s.flush_and_stop()
        senders = []
        stopping, servers = servers, []
        _in_parallel(*(s.stop for s in stopping))
        nums["seconds"] = time.perf_counter() - t_phase
    finally:
        if trickle_agent is not None:
            trickle_agent.sender.flush_and_stop(timeout=0)
        for s in senders:
            s.flush_and_stop(timeout=0)
        for s in servers:
            s.kill()
        shutil.rmtree(root, ignore_errors=True)
    cs.phase("readtier", **nums)
