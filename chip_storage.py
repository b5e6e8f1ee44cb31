"""The smoke's storage phase: the port's durable tier on the card's host.

    python3 chip_phases.py storage      # alone, after phases 1-4

Run by ``chip_smoke.storage_phase`` after the ``query`` phase. Phase 3's
span frames, re-stamped replay by replay as the query phase re-stamps
them (``chip_smoke._Replays``), go to the port's server through the
agent's own durable sender (``agent/sender.py``) with its spool on, up
to STORAGE_ROWS span rows:

(a) the first half of the replays into a server without storage: its
    acked and visible rows/s;
(b) the same half into a server with ``--storage --flush-interval-s
    1.0 --compact-interval-s 10``, its data directory a temporary one
    on the filesystem of the checkout (outside ``results/``, which
    keeps a run's numbers and logs), deleted at the end: acked (durable) and
    visible rows/s, then the three dashboard queries over that half's
    time range;
(c) a quarter of the replays more, paced over three commits at least;
    once the sender's acked seq passes the first half, SIGKILL with
    frames in flight, then the rest sent into the dead port (window and
    spool). The data
    directory is recovered in this process: every row of every frame
    acked before the kill must be on disk;
(d) the server restarted on the same port and directory: the seconds
    from the restart to the first answer, the three queries equal to
    the answers before the kill, the sender drained (every frame acked,
    none dropped), the queries equal again, a compaction run built since
    the restart and the tier settled (the compactor's own rule finds
    nothing left to merge) with the answers of the whole range and of
    the first half equal across it, a ten-minute range pruning segments
    with the answer of the whole range filtered in this process, every
    query under QUERY_LIMIT_MS cold (cache bypassed) and warm;
(e) a clean stop, and the directory read once more in this process:
    every frame's spans held exactly once, counted per frame seq.

Numbers print beside the card's name and power limit: rows/s with
storage on and off, commit ms (p50, p99) and commits, bytes on disk a
row, segments and blocks per codec, recovery s, the server's RSS before
the kill and after recovery, and query ms on segments.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np

import chip_smoke as cs

STORAGE_ROWS = 3_000_000      # ~12 minutes of a process (cut from 10 M to
                              # leave the smoke's time to its readtier phase)
FLUSH_S = 1.0
COMPACT_S = 10
PRUNE_WINDOW_NS = 600 * 10**9  # the pruned query's ten minutes
AGENT_ID = 9
QUEUE = 256                   # the sender's queue at most: past it, the spool
WAIT_S = 300.0                # any one wait below
SPAN = "profile.tpu_hlo_span"


def _fs_of(path: str) -> tuple[str, str, int]:
    """(mount point, filesystem type, free bytes) of a path."""
    real = os.path.realpath(path)
    best = ("/", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0]):
                best = (mnt, parts[2])
    st = os.statvfs(real)
    return best[0], best[1], st.f_bavail * st.f_frsize


def _sender(port: int, spool_dir: str, seq_of: dict, queue: int):
    """The agent's durable sender with its spool, recording each frame's
    seq by the identity of its payload (``seq_of``: id -> seq) where
    the seq is born: at the first write, or at a spool append."""
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.agent.spool import Spool

    class _Spool(Spool):
        def append(self, msg_type, seq, payload):
            seq_of.setdefault(id(payload), seq)
            return super().append(msg_type, seq, payload)

    class _Sender(UniformSender):
        def _send_frame(self, f):
            fresh = f.seq is None
            super()._send_frame(f)
            if fresh and f.seq is not None:
                seq_of.setdefault(id(f.payload), f.seq)

    # a window that never evicts: past it delivery would be at most once
    return _Sender([("127.0.0.1", port)], agent_id=AGENT_ID,
                   queue_size=queue, ack_window=1 << 20,
                   spool=_Spool(spool_dir, max_bytes=16 << 30)).start()


def _send(sender, payload: bytes, wait: bool = True) -> None:
    """One frame to the sender; ``wait``: while the server is up the
    producer waits for room in the queue, so nothing spools out of
    order (a dead server's frames overflow into the spool)."""
    from deepflow_tpu_torch.codec import MessageType
    while wait and sender._q.qsize() >= sender._q.maxsize - 1:
        time.sleep(0.0005)
    sender.send(MessageType.TPU_SPAN, payload)


def _wait(what: str, cond, t0: float | None = None) -> float:
    t0 = time.perf_counter() if t0 is None else t0
    while not cond():
        cs.check(time.perf_counter() - t0 < WAIT_S, what)
        time.sleep(0.005)
    return time.perf_counter() - t0


def _rows(qport: int) -> int:
    return cs._http(qport, "/v1/health")[1]["tables"][SPAN]


def _runs(qport: int) -> int:
    return cs._http(qport, "/v1/health")[1]["storage"]["stats"]["runs_built"]


def _compactable(qport: int) -> int:
    """Groups the compactor would still merge, by its own rule: per
    hour of the segments' first rows, a v1 segment, or two segments or
    more that are not all one run."""
    groups: dict = {}
    for sg in cs._http(qport, f"/v1/segments?table={SPAN}")[1]["tables"][SPAN]:
        key = None if sg["tmin"] is None else sg["tmin"] // 3_600_000_000_000
        groups.setdefault(key, []).append(sg)
    return sum(1 for g in groups.values()
               if any(sg["format"] < 2 for sg in g)
               or (len(g) >= 2 and not (len({sg["run"] for sg in g}) == 1
                                        and g[0]["run"] is not None)))


def _answers(qport: int, sqls: dict) -> dict:
    out = {}
    for name, sql in sqls.items():
        ans, _ms = cs._server_query(qport, sql)
        out[name] = ans["result"]
    return out


_KEY_COLS = ("time", "duration_ns", "run_id", "step")


def _keys(cols: dict) -> np.ndarray:
    """One uint64 key a span row: its time, duration, run and step mixed
    (odd multipliers, wrapping); the sent keys are checked distinct."""
    k = np.zeros(len(cols["time"]), dtype=np.uint64)
    for mul, name in zip((1, 0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9), _KEY_COLS):
        k ^= cols[name].astype(np.uint64) * np.uint64(mul)
        k = (k << np.uint64(31)) | (k >> np.uint64(33))
    return k


def _disk_keys(data_dir: str) -> tuple[np.ndarray, float, dict]:
    """The span table's row keys as recovery reads them from the data
    directory, in this process; the seconds it took and the tier's
    recovery counters."""
    from deepflow_tpu_torch.store.db import Database
    t0 = time.perf_counter()
    db = Database(data_dir=data_dir, storage=True)
    keys = _keys(db.table(SPAN).column_concat(list(_KEY_COLS)))
    dt = time.perf_counter() - t0
    stats = dict(db.tier_store.stats)
    del db
    return keys, dt, stats


def _per_frame(disk: np.ndarray, keys: np.ndarray,
               frame_of: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(rows held a frame, copies beyond one a frame, foreign rows): each
    disk row matched to the sent span of its key (keys distinct)."""
    order = np.argsort(keys)
    sk = keys[order]
    pos = np.searchsorted(sk, disk)
    inb = pos < len(sk)
    hit = np.zeros(len(disk), dtype=bool)
    hit[inb] = sk[pos[inb]] == disk[inb]
    span = order[pos[hit]]
    copies = np.bincount(span, minlength=len(keys))
    n = int(frame_of.max()) + 1
    held = np.bincount(frame_of, weights=copies > 0, minlength=n)
    extra = np.bincount(frame_of, weights=np.maximum(copies - 1, 0),
                        minlength=n)
    return held.astype(np.int64), extra.astype(np.int64), int((~hit).sum())


def storage_phase(sink, nums: dict) -> None:
    from deepflow_tpu_torch.store.schema import TPU_SPAN_KINDS
    t_phase = time.perf_counter()
    rep = cs._Replays(cs._span_frames(b"".join(sink.frames)))
    n_rep = max(4, -(-STORAGE_ROWS // rep.rows))
    rep.check_room(n_rep)
    n_a, n_b1 = n_rep // 2, n_rep // 2 + n_rep // 4
    # (replay, payload) of every frame in send order, and the key of
    # every span it carries
    from deepflow_tpu_torch.proto import wire
    durs = [np.array([sp.duration_ns for sp in wire.TpuSpanBatch.FromString(
        b.tobytes()).spans], dtype=np.uint64) for b in rep.bases]
    frames, keys, frame_of = [], [], []
    t_base = int(min(f[cs._START_F][2].min() for f in rep.fields))
    for r in range(n_rep):
        for (h, p), fields, dur in zip(rep.payloads(r), rep.fields, durs):
            frame_of.append(np.full(len(dur), len(frames)))
            frames.append((r, p))
            keys.append(_keys({
                "time": fields[cs._START_F][2] + np.uint64(r * rep.width_ns),
                "duration_ns": dur,
                "run_id": fields[cs._RUN_F][2] + np.uint64(r * rep.run_stride),
                "step": fields[cs._STEP_F][2]
                + np.uint64(r * rep.step_stride)}))
    counts = np.array([len(k) for k in keys])
    keys, frame_of = np.concatenate(keys), np.concatenate(frame_of)
    cs.check(len(np.unique(keys)) == len(keys),
             "every sent span has a key of its own")
    reps = np.array([r for r, _ in frames])
    fa, fb1 = int((reps < n_a).sum()), int((reps < n_b1).sum())
    rows_a, total = int(counts[:fa].sum()), int(counts.sum())
    t_end_a = t_base + n_a * rep.width_ns  # every row of (a) lies below
    # a queue the frames sent into the dead port overflow
    queue = max(8, min(QUEUE, len(frames) // 16))
    setup_s = time.perf_counter() - t_phase
    root = tempfile.mkdtemp(prefix=".storage-", dir=cs.ROOT)
    data_dir, spool_dir = (os.path.join(root, "data"),
                           os.path.join(root, "spool"))
    mnt, fstype, free = _fs_of(root)
    nums.update(rows=total, frames=len(frames), replays=n_rep,
                rows_first_half=rows_a, setup_s=setup_s, fs_mount=mnt,
                fs_type=fstype, fs_free_bytes=free)
    cs.phase("storage setup", **nums)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    store_args = ["--data-dir", data_dir, "--storage", "--flush-interval-s",
                  str(FLUSH_S), "--compact-interval-s", str(COMPACT_S)]
    srv = sender = None
    try:
        # (a) storage off, the same sender and frames
        srv = cs._ServerProcess(os.path.join(cs.OUT_DIR,
                                             "storage_off_server.log"))
        seq_off: dict = {}
        sender = _sender(srv.ingest_port, os.path.join(root, "spool-off"),
                         seq_off, queue)
        t0 = time.perf_counter()
        for _r, p in frames[:fa]:
            _send(sender, p)
        acked_s = _wait("storage off: every frame acked",
                        lambda: len(seq_off) == fa and sender.stats[
                            "acked_seq"] >= max(seq_off.values()), t0)
        visible_s = _wait("storage off: every row visible",
                          lambda: _rows(srv.query_port) >= rows_a, t0)
        cs.check(_rows(srv.query_port) == rows_a,
                 "storage off: each row held once")
        sender.flush_and_stop()
        srv.stop()
        nums.update(off_acked_rows_per_s=rows_a / acked_s,
                    off_visible_rows_per_s=rows_a / visible_s)

        # (b) storage on: the first half, then its answers
        srv = cs._ServerProcess(os.path.join(cs.OUT_DIR,
                                             "storage_server.log"),
                                env_control=True, extra_args=store_args)
        port = srv.ingest_port
        seq_of: dict = {}
        sender = _sender(port, spool_dir, seq_of, queue)
        t0 = time.perf_counter()
        for _r, p in frames[:fa]:
            _send(sender, p)
        acked_s = _wait("storage on: the first half acked",
                        lambda: len(seq_of) == fa and sender.stats[
                            "acked_seq"] >= max(seq_of.values()), t0)
        visible_s = _wait("storage on: the first half visible",
                          lambda: _rows(srv.query_port) >= rows_a, t0)
        cs.check(_rows(srv.query_port) == rows_a,
                 "storage on: each row of the first half held once")
        nums.update(on_acked_rows_per_s=rows_a / acked_s,
                    on_visible_rows_per_s=rows_a / visible_s)
        kind = TPU_SPAN_KINDS[1]
        top = cs._server_query(srv.query_port, (
            f"SELECT hlo_op, Sum(duration_ns) AS d FROM {SPAN} WHERE "
            f"kind = '{kind}' AND hlo_op != '' GROUP BY hlo_op ORDER BY d "
            "DESC LIMIT 1"))[0]["result"]["values"]
        cs.check(bool(top), "a device-compute kernel to filter on")
        pat = top[0][0][:5].replace("%", "_") + "%"

        def sqls(lo: int | None, hi: int | None) -> dict:
            rng = " AND ".join(
                [f"time >= {lo}"] * (lo is not None)
                + [f"time < {hi}"] * (hi is not None))
            w = f" WHERE {rng}" if rng else ""
            a = f" AND {rng}" if rng else ""
            recent_hi = hi if hi is not None else \
                t_base + n_rep * rep.width_ns
            return {
                "top_kernels":
                    f"SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n "
                    f"FROM {SPAN} WHERE kind = '{kind}'{a} GROUP BY hlo_op "
                    "ORDER BY d DESC LIMIT 10",
                "per_step":
                    f"SELECT run_id, Sum(duration_ns) AS d, Count() AS n "
                    f"FROM {SPAN}{w} GROUP BY run_id",
                "recent_prefix":
                    f"SELECT hlo_op, Sum(duration_ns) AS d, Count() AS n "
                    f"FROM {SPAN} WHERE time >= "
                    f"{recent_hi - cs.QUERY_WINDOW_NS} AND time < "
                    f"{recent_hi} AND hlo_op LIKE '{pat}' GROUP BY hlo_op "
                    "ORDER BY d DESC LIMIT 10"}
        q_half = sqls(None, t_end_a)
        before = _answers(srv.query_port, q_half)
        cs.check(all(a["values"] for a in before.values()),
                 "the first half's queries answer rows")

        # (c) a quarter more, paced over three commits at least, until
        # the acked seq passes the first half; SIGKILL with frames in
        # flight; the rest into the dead port
        max_a = max(seq_of.values())
        gap = 3 * FLUSH_S / max(1, fb1 - fa)
        t0, k = time.perf_counter(), fa
        while sender.stats["acked_seq"] <= max_a:
            cs.check(time.perf_counter() - t0 < WAIT_S,
                     "the acked seq passes the first half")
            if k < fb1:
                _send(sender, frames[k][1])
                k += 1
            time.sleep(gap if k < fb1 else 0.005)
        acked_at_kill = sender.stats["acked_seq"]
        sent_at_kill = sender.stats["sent_frames"]
        health = cs._http(srv.query_port, "/v1/health")[1]
        rss_before = (cs._proc_sample(srv.pid) or (0, 0))[1]
        srv.kill()
        acked_ids = {k for k, s in seq_of.items() if s <= acked_at_kill}
        n_acked = sum(1 for _r, p in frames if id(p) in acked_ids)
        inflight = (len([s for s in seq_of.values() if s > acked_at_kill])
                    + (k - len(seq_of)))
        cs.check(inflight > 0, f"frames in flight at the kill ({inflight})")
        for _r, p in frames[k:]:
            _send(sender, p, wait=False)
        time.sleep(1.0)
        with open(srv.log_path) as f:
            log_text = f.read()
        cs.check("Traceback" not in log_text and " ERROR " not in log_text,
                 f"the killed server logged no exception ({srv.log_path})")
        disk, inproc_s, rstats = _disk_keys(data_dir)
        held, _extra, _foreign = _per_frame(disk, keys, frame_of)
        acked_f = np.array([id(p) in acked_ids for _r, p in frames])
        short = np.flatnonzero(acked_f & (held < counts))
        cs.check(not len(short), f"every row of the {n_acked} frames "
                 f"acked before the kill recovered from disk (short: "
                 f"seqs {[seq_of[id(frames[i][1])] for i in short[:10]]})")
        st = health.get("storage") or {}
        nums.update(acked_frames_at_kill=n_acked,
                    frames_sent_at_kill=sent_at_kill,
                    frames_in_flight_at_kill=inflight,
                    rows_recovered=len(disk),
                    rows_acked_at_kill=int(counts[acked_f].sum()),
                    recovery_inprocess_s=inproc_s,
                    torn_dropped=rstats["torn_dropped"],
                    manifest_corrupt=rstats["manifest_corrupt"],
                    server_rss_before_kill=rss_before,
                    spooled=sender.stats["spooled"])
        del disk
        cs.check(rstats["manifest_corrupt"] == 0, "the manifest read whole")
        cs.phase("storage kill", **nums)

        # (d) restart on the same port and directory
        t_restart = time.perf_counter()
        srv = cs._ServerProcess(os.path.join(cs.OUT_DIR,
                                             "storage_restart_server.log"),
                                ingest_port=port, env_control=True,
                                extra_args=store_args)
        first = next(iter(q_half))
        after = _answers(srv.query_port, {first: q_half[first]})
        recovery_s = time.perf_counter() - t_restart
        runs_restart = _runs(srv.query_port)
        after.update(_answers(srv.query_port, {
            k: v for k, v in q_half.items() if k != first}))
        cs.check(after == before, "the first half's answers after the "
                 "restart equal those before the kill")
        rss_recovered = (cs._proc_sample(srv.pid) or (0, 0))[1]
        drain_s = _wait("the sender drains: every frame acked", lambda:
                        len(seq_of) == len(frames) and sender.stats[
                            "acked_seq"] >= max(seq_of.values()))
        _wait("every row visible", lambda: _rows(srv.query_port) >= total)
        cs.check(_rows(srv.query_port) == total,
                 f"{total} rows held once after the drain "
                 f"({_rows(srv.query_port)})")
        cs.check(sender.stats["dropped"] == 0
                 and sender.stats["unacked_evicted"] == 0,
                 f"the sender dropped nothing ({sender.stats})")
        cs.check(_answers(srv.query_port, q_half) == before,
                 "the first half's answers after the drain equal those "
                 "before the kill")
        cs.check(sender.stats["spooled"] > 0,
                 "frames parked in the spool while the server was down")
        nums.update(recovery_s=recovery_s, server_rss_recovered=rss_recovered,
                    drain_s=drain_s, retransmits=sender.stats["retransmits"],
                    replayed=sender.stats["replayed"],
                    spooled=sender.stats["spooled"],
                    dups=cs._http(srv.query_port,
                                  "/v1/health")[1]["stats"]["dedup"]["dups"])

        # compaction: a run built since the restart, the tier settled
        # (nothing left to compact), and the answers equal across it
        q_all = sqls(None, None)
        full = _answers(srv.query_port, q_all)
        runs_full = _runs(srv.query_port)
        _wait("a compaction run since the restart and the tier settled",
              lambda: _runs(srv.query_port) > runs_restart
              and not _compactable(srv.query_port))
        cs.check(_answers(srv.query_port, q_all) == full
                 and _answers(srv.query_port, q_half) == before,
                 "the answers across the compactions are equal")
        nums["runs_after_drain"] = _runs(srv.query_port) - runs_full

        # pruning: ten minutes against the whole range filtered here
        lo = (t_base + n_rep * rep.width_ns // 2) // 60_000_000_000 \
            * 60_000_000_000
        hi = lo + PRUNE_WINDOW_NS
        bucket = (f"SELECT time(time, 60) AS m, Sum(duration_ns) AS d, "
                  f"Count() AS n FROM {SPAN}")
        tail = " GROUP BY time(time, 60) ORDER BY m"
        q_prune = {"pruned_window": f"{bucket} WHERE time >= {lo} AND "
                   f"time < {hi}{tail}"}
        pruned0 = cs._http(srv.query_port,
                           "/v1/health")[1]["query"]["pruned_segments"]
        srv.setenv(DF_QUERY_CACHE="0")
        ranged = _answers(srv.query_port, q_prune)["pruned_window"]
        whole = _answers(srv.query_port, {"w": bucket + tail})["w"]
        srv.setenv(DF_QUERY_CACHE=None)
        pruned = cs._http(srv.query_port,
                          "/v1/health")[1]["query"]["pruned_segments"] \
            - pruned0
        kept = [r for r in whole["values"]
                if lo // 10**9 <= r[0] < hi // 10**9]
        cs.check(pruned > 0, f"the ten-minute query pruned segments "
                 f"({pruned})")
        cs.check(bool(kept) and ranged["values"] == kept,
                 "the ten-minute answer equals the whole range's, "
                 "filtered in this process")
        srv.setenv(DF_QUERY_CACHE="0")
        _, ex, _ = cs._http(srv.query_port, "/v1/query", {
            "sql": "EXPLAIN ANALYZE " + q_prune["pruned_window"]})
        srv.setenv(DF_QUERY_CACHE=None)
        nums.update(pruned_segments=pruned, runs_built=_runs(srv.query_port),
                    explain_prune=json.dumps(
                        ex.get("explain", {}).get("plan", {}).get("prune"),
                        separators=(",", ":")))

        # every query cold (cache bypassed) and warm, on segments
        timed = {**q_all, **q_prune}
        slow = {}
        for name, sql in timed.items():
            srv.setenv(DF_QUERY_CACHE="0")
            _a, cold = cs._server_query(srv.query_port, sql)
            srv.setenv(DF_QUERY_CACHE=None)
            cs._server_query(srv.query_port, sql)
            _a, warm = cs._server_query(srv.query_port, sql)
            nums[f"{name}_cold_ms"], nums[f"{name}_warm_ms"] = cold, warm
            if max(cold, warm) >= cs.QUERY_LIMIT_MS:
                slow[name] = (cold, warm)
        cs.check(not slow, f"every query under {cs.QUERY_LIMIT_MS} ms cold "
                 f"and warm ({slow})")

        health = cs._http(srv.query_port, "/v1/health")[1]
        st = health["storage"]
        tab = st["tables"][SPAN]
        segs = cs._http(srv.query_port, f"/v1/segments?table={SPAN}")[1]
        per_codec: dict[str, int] = {}
        for seg in segs["tables"][SPAN]:
            for c in set(seg["codecs"].values()):
                per_codec[c] = per_codec.get(c, 0) + 1
        fl = health["stats"]["flusher"]
        cs.check(fl["errors"] == 0 and st["stats"]["manifest_corrupt"] == 0,
                 f"no failed commit ({fl})")
        nums.update(commits=st["stats"]["commits"],
                    flushes=fl["flushes"],
                    commit_ms_p50=st["commit_ms"]["p50"],
                    commit_ms_p99=st["commit_ms"]["p99"],
                    commit_ms_max=st["commit_ms"]["max"],
                    bytes_on_disk=tab["bytes"],
                    bytes_per_row=tab["bytes"] / max(1, tab["rows"]),
                    segments=tab["segments"],
                    segments_per_codec=json.dumps(per_codec,
                                                  separators=(",", ":")),
                    blocks_per_codec=json.dumps(tab["codec_counts"],
                                                separators=(",", ":")),
                    compact_bytes_before=st["stats"]["bytes_before"],
                    compact_bytes_after=st["stats"]["bytes_after"])
        srv.stop()
        srv = None
        sender.flush_and_stop()
        sender = None

        # (e) every frame's spans once, read from disk, per frame seq
        disk, _s, _st = _disk_keys(data_dir)
        held, extra, foreign = _per_frame(disk, keys, frame_of)
        bad = np.flatnonzero((held != counts) | (extra > 0))
        cs.check(len(disk) == total and not len(bad) and not foreign,
                 f"every frame's spans held exactly once on disk "
                 f"({len(disk)} of {total} rows, {foreign} foreign; "
                 f"frames off: seqs "
                 f"{[seq_of[id(frames[i][1])] for i in bad[:10]]})")
        nums["seconds"] = time.perf_counter() - t_phase
    finally:
        if sender is not None:
            sender.flush_and_stop(timeout=0)
        if srv is not None:
            srv.kill()
        shutil.rmtree(root, ignore_errors=True)
    cs.phase("storage", **nums)
