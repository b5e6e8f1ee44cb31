"""The port's durable storage held against the JAX package's.

The reference's tier cases (``tests/test_storage.py``: recovery, torn
tails, flush and restart, TTL and size eviction, cache tokens, the
durability gate, group commit, requeue) run on both packages with the
same outcomes. Beside them: the port's two repairs of the commit
protocol (the gate as a cut, and the parked seqs persisted beside the
floors), both servers in subprocesses under ``--storage`` fed the same
seq'd frames, SIGKILLed, restarted and drained (the same rows, each
once, and the same answers), pruned scans against unpruned ones on
hypothesis-drawn WHERE clauses, and ``dfctl segments`` / ``datasources
--zones`` against the reference's.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepflow_tpu.cli import dfctl as ref_dfctl
from deepflow_tpu.query import engine as ref_engine
from deepflow_tpu.query.cache import QueryCache as RefQueryCache
from deepflow_tpu.query.cache import change_token as ref_change_token
from deepflow_tpu.server.flusher import DurabilityGate as RefGate
from deepflow_tpu.server.flusher import Flusher as RefFlusher
from deepflow_tpu.server.janitor import Janitor as RefJanitor
from deepflow_tpu.server.receiver import SeqAckTracker as RefTracker
from deepflow_tpu.server.server import Server as RefServer
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu.store.segment import write_segment as ref_write_segment
from deepflow_tpu.store.tiered import TieredStore as RefTieredStore
from deepflow_tpu.telemetry import Telemetry as RefTelemetry
from deepflow_tpu_torch.cli import dfctl
from deepflow_tpu_torch.codec import (
    FrameHeader, MessageType, StreamDecoder, decode_ack, encode_frame,
    encode_seq_base)
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.query.cache import QueryCache, change_token
from deepflow_tpu_torch.server.decoders import DedupWindow
from deepflow_tpu_torch.server.flusher import DurabilityGate, Flusher
from deepflow_tpu_torch.server.janitor import Janitor
from deepflow_tpu_torch.server.receiver import SeqAckTracker
from deepflow_tpu_torch.server.server import Server
from deepflow_tpu_torch.store import schema
from deepflow_tpu_torch.store.db import Database
from deepflow_tpu_torch.store.segment import write_segment
from deepflow_tpu_torch.store.tiered import TieredStore
from deepflow_tpu_torch.telemetry import Telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = types.SimpleNamespace(
    name="ref", Database=RefDatabase, TieredStore=RefTieredStore,
    write_segment=ref_write_segment, Janitor=RefJanitor,
    Telemetry=RefTelemetry, QueryCache=RefQueryCache,
    change_token=ref_change_token, Gate=RefGate, Flusher=RefFlusher,
    Tracker=RefTracker, execute=ref_engine.execute)
PORT = types.SimpleNamespace(
    name="port", Database=Database, TieredStore=TieredStore,
    write_segment=write_segment, Janitor=Janitor, Telemetry=Telemetry,
    QueryCache=QueryCache, change_token=change_token, Gate=DurabilityGate,
    Flusher=Flusher, Tracker=SeqAckTracker, execute=engine.execute)
PKGS = [REF, PORT]
NET = "flow_metrics.network.1s"
SPAN = "profile.tpu_hlo_span"


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


# -- the reference's cases (tests/test_storage.py), on both packages ---------

def _chunk(n=100, t0=1000):
    return {"time": np.arange(t0, t0 + n, dtype=np.uint32),
            "v": np.arange(n, dtype=np.uint64),
            "tag": np.zeros(n, dtype=np.uint32)}


def _payload(n=100):
    return {"chunk": _chunk(n), "rows": n, "time_col": "time",
            "dicts": {}, "dict_state": {}}


def test_tiered_recover_drops_uncommitted(tmp_path, pkg):
    root = str(tmp_path / "segments")
    pkg.TieredStore(root).commit({"t": _payload()})
    orphan = os.path.join(root, "t", "seg_00000099.seg")
    pkg.write_segment(orphan, _chunk(50))
    open(os.path.join(root, "t", f"seg_x.seg.tmp.{os.getpid()}"),
         "wb").close()
    ts2 = pkg.TieredStore(root)
    ts2.recover()
    assert not os.path.exists(orphan)
    assert ts2.tier("t").rows == 100
    assert ts2.stats["torn_dropped"] == 2


def test_torn_listed_segment_dropped_on_recovery(tmp_path, pkg):
    root = str(tmp_path / "segments")
    ts = pkg.TieredStore(root)
    ts.commit({"t": _payload()})
    tt = ts.tier("t")
    path = os.path.join(tt.dir, tt.manifest_names()[0])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    ts2 = pkg.TieredStore(root)
    ts2.recover()
    assert ts2.tier("t").segment_count() == 0
    assert not os.path.exists(path)
    ts3 = pkg.TieredStore(root)
    ts3.recover()
    assert ts3.stats["torn_dropped"] == 0


def test_unreadable_manifest_scavenged(tmp_path, pkg):
    """A torn MANIFEST.json: every readable segment is adopted, counted
    as manifest_corrupt and segments_scavenged, and ids go on past them."""
    root = str(tmp_path / "segments")
    ts = pkg.TieredStore(root)
    ts.commit({"t": _payload(30)})
    ts.commit({"t": _payload(40)})
    with open(os.path.join(root, "MANIFEST.json"), "w") as f:
        f.write('{"version": 1, "tables": {"t": {"segm')
    ts2 = pkg.TieredStore(root)
    ts2.recover()
    assert ts2.tier("t").rows == 70
    assert ts2.stats["manifest_corrupt"] == 1
    assert ts2.stats["segments_scavenged"] == 2
    assert ts2.tier("t").next_id == 3


_NET_ROW = {"ip_src": "1.1.1.1", "ip_dst": "2.2.2.2", "server_port": 80,
            "protocol": 1, "host": "h1"}


def _fill_net(db, n=120, t0=6000):
    t = db.table(NET)
    t.append_rows([dict(_NET_ROW, time=t0 + i, byte_tx=i, packet_tx=1)
                   for i in range(n)])
    return t


def test_flush_restart_query_equality(tmp_path, pkg):
    d = str(tmp_path)
    db = pkg.Database(data_dir=d, storage=True)
    _fill_net(db)
    sql = ("SELECT ip_src, Sum(byte_tx) AS b, Count() AS c FROM t "
           "GROUP BY ip_src")
    before = pkg.execute(db.table(NET), sql).values
    assert db.flush_to_tier() == 120
    assert pkg.execute(db.table(NET), sql).values == before
    db2 = pkg.Database(data_dir=d, storage=True)
    db2.load()
    t2 = db2.table(NET)
    assert len(t2) == 120
    assert pkg.execute(t2, sql).values == before
    assert pkg.execute(t2, "SELECT host, Count() AS c FROM t GROUP BY host"
                       ).values == [["h1", 120.0]]


def test_flush_restart_torn_tail(tmp_path, pkg):
    d = str(tmp_path)
    db = pkg.Database(data_dir=d, storage=True)
    _fill_net(db, n=60)
    db.flush_to_tier()
    _fill_net(db, n=60, t0=7000)
    db.flush_to_tier()
    segs = db.tier_store.tier(NET).segments()
    assert len(segs) == 2
    with open(segs[1].path, "r+b") as f:
        f.truncate(os.path.getsize(segs[1].path) - 8)
    db2 = pkg.Database(data_dir=d, storage=True)
    db2.load()
    t2 = db2.table(NET)
    assert len(t2) == 60
    assert pkg.execute(t2, "SELECT Min(time) AS a, Max(time) AS b FROM t"
                       ).values == [[6000.0, 6059.0]]


def test_ttl_eviction_ledger_conserved(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    _fill_net(db, n=100, t0=6000)
    db.flush_to_tier()
    tele = pkg.Telemetry("server")
    jan = pkg.Janitor(db, ttl_s={NET: 100}, telemetry=tele)
    t = db.table(NET)
    assert len(t) == 100
    assert jan.sweep_tier(now=1_000_000.0) == 100
    assert len(t) == 0
    assert db.tier_store.snapshot()["tables"][t.name]["segments"] == 0
    hop = tele.hop("storage").snapshot()
    assert hop["dropped"] == {"segment_evict": 100}
    assert hop["emitted"] == 100
    assert jan.stats["tier_rows_evicted"] == 100
    assert jan.stats["tier_segments_evicted"] == 1


def test_size_budget_evicts_oldest_first(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    _fill_net(db, n=50, t0=6000)
    db.flush_to_tier()
    _fill_net(db, n=50, t0=9000)
    db.flush_to_tier()
    snap = db.tier_store.snapshot()["tables"][NET]
    assert snap["segments"] == 2
    jan = pkg.Janitor(db, ttl_s={}, tier_max_bytes=snap["bytes"] - 1)
    assert jan.sweep_tier(now=9100.0) == 50
    snap = db.tier_store.snapshot()["tables"][NET]
    assert snap["segments"] == 1 and snap["tmin"] == 9000
    assert len(db.table(NET)) == 50


def test_cache_invalidated_by_segment_evict(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    t = _fill_net(db, n=100, t0=6000)
    db.flush_to_tier()
    cache = pkg.QueryCache()
    sql = "SELECT Sum(byte_tx) AS b FROM t"
    full = float(sum(range(100)))
    assert cache.execute(t, sql).values == [[full]]
    assert cache.execute(t, sql).values == [[full]]
    assert cache.counters["hits"] == 1
    assert pkg.Janitor(db, ttl_s={t.name: 100}).sweep_tier(
        now=1_000_000.0) == 100
    res = cache.execute(t, sql)
    assert cache.counters["hits"] == 1
    assert res.values in ([[None]], [[0.0]], [])


def test_flush_gen_moves_cache_token(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    t = _fill_net(db, n=30)
    tok = pkg.change_token(t)
    db.flush_to_tier()
    assert pkg.change_token(t) != tok


def test_compaction_moves_cache_token_not_answers(tmp_path, pkg):
    """A compaction rebuilds the segment set: the token moves, the cached
    answer is recomputed, and it is the same answer."""
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    t = db.table(NET)
    for k in range(3):
        _fill_net(db, n=40, t0=6000 + 100 * k)
        db.flush_to_tier()
    cache = pkg.QueryCache()
    sql = "SELECT ip_src, Sum(byte_tx) AS b, Count() AS c FROM t GROUP BY ip_src"
    first = cache.execute(t, sql).values
    tok = pkg.change_token(t)
    assert db.compact_tier()["runs_built"] == 1
    assert pkg.change_token(t) != tok
    assert cache.execute(t, sql).values == first
    assert cache.counters["hits"] == 0


def test_gate_release_only_after_commit(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    _fill_net(db, n=10)
    gate = pkg.Gate()
    tracker = pkg.Tracker()
    tracker.seed(7, -1)
    for seq in range(3):
        gate.add(7, seq)
    fl = pkg.Flusher(db, gate=gate, seq_tracker=tracker)
    assert tracker.contiguous(7) == -1
    assert fl.flush_once() == 10
    assert tracker.contiguous(7) == 2
    assert len(gate) == 0
    ts = pkg.TieredStore(os.path.join(str(tmp_path), "segments"))
    ts.recover()
    assert ts.ack_floors == {7: 2}


def test_group_commit_seals_only_for_pending_acks(tmp_path, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    t = _fill_net(db, n=50)
    fl = pkg.Flusher(db, gate=pkg.Gate())
    assert fl.flush_once() == 0
    assert len(t) == 50
    snap = db.tier_store.snapshot()["tables"]
    assert snap.get(NET, {}).get("rows", 0) == 0
    fl.gate.add(9, 0)
    assert fl.flush_once() == 50
    assert db.tier_store.snapshot()["tables"][NET]["rows"] == 50
    assert len(t) == 50


def test_gate_requeues_on_commit_failure(tmp_path, monkeypatch, pkg):
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    _fill_net(db, n=5)
    gate = pkg.Gate()
    tracker = pkg.Tracker()
    tracker.seed(3, -1)
    gate.add(3, 0)
    fl = pkg.Flusher(db, gate=gate, seq_tracker=tracker)
    monkeypatch.setattr(db, "flush_to_tier", lambda *a, **kw: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        fl.flush_once()
    assert len(gate) == 1
    assert tracker.contiguous(3) == -1


# -- the port's repairs of the commit protocol --------------------------------

def _mid_batch_commit(pkg, tmp_path):
    """A decoder's pass writes rows, a flush runs before it parks the
    frame's seq, then the seq parks. Returns (rows on disk after the
    flush, the floors committed with them)."""
    db = pkg.Database(data_dir=str(tmp_path), storage=True)
    gate = pkg.Gate()
    fl = pkg.Flusher(db, gate=gate)
    gate.add(4, 1)
    _fill_net(db, n=10)          # frame 1's rows, parked: durable next
    wrote, parked = threading.Event(), threading.Event()

    def decoder_pass() -> None:
        ctx = gate.writing() if hasattr(gate, "writing") else None
        if ctx is not None:
            ctx.__enter__()
        _fill_net(db, n=5, t0=7000)  # frame 2's rows
        wrote.set()
        time.sleep(0.3)              # the pass is not done yet
        gate.add(4, 2)
        if ctx is not None:
            ctx.__exit__(None, None, None)
        parked.set()

    th = threading.Thread(target=decoder_pass)
    th.start()
    wrote.wait(5)
    fl.flush_once(seal=True)     # while frame 2's pass runs
    th.join(5)
    ts = pkg.TieredStore(os.path.join(str(tmp_path), "segments"))
    ts.recover()
    return sum(tt.rows for tt in ts.tables().values()), ts.ack_floors


def test_commit_never_holds_rows_its_floors_miss(tmp_path):
    """The port's flush waits for a decoder pass in progress: the rows it
    commits are those of the seqs its floors cover (frames 1 and 2). The
    reference drains first and seals after, so it committed frame 2's
    rows with floor 1: a restart took frame 2's retransmit as new and held
    its rows twice."""
    assert _mid_batch_commit(PORT, tmp_path / "port") == (15, {4: 2})
    assert _mid_batch_commit(REF, tmp_path / "ref") == (15, {4: 1})


def test_parked_seqs_persist_and_dedup_after_restart(tmp_path):
    """Seqs committed above a gap persist beside the floor: after a
    restart their retransmits are dups, and the gap's seq is not."""
    db = Database(data_dir=str(tmp_path), storage=True)
    gate = DurabilityGate()
    fl = Flusher(db, gate=gate)
    _fill_net(db, n=10)
    for seq in (1, 2, 4, 5):     # 3 is still on its way
        gate.add(8, seq)
    fl.flush_once()
    ts = TieredStore(os.path.join(str(tmp_path), "segments"))
    ts.recover()
    assert ts.ack_floors == {8: 2} and ts.ack_parked == {8: [4, 5]}
    dedup = DedupWindow(floors=ts.ack_floors, parked=ts.ack_parked)
    assert [dedup.seen(8, s) for s in (2, 4, 5, 3, 6)] == \
        [True, True, True, False, False]
    # the next commit with the gap filled drops the parked list
    fl2 = Flusher(db, gate=gate)
    fl2.seed_floors(ts.ack_floors, ts.ack_parked)
    gate.add(8, 3)
    fl2.flush_once()
    ts2 = TieredStore(os.path.join(str(tmp_path), "segments"))
    ts2.recover()
    assert ts2.ack_floors == {8: 5} and ts2.ack_parked == {}


# -- both servers under --storage: SIGKILL, restart, drain -------------------

AGENT = 5
N_FRAMES = 40
SPANS_A_FRAME = 50


def _span_frames() -> list[bytes]:
    rng = np.random.default_rng(13)
    frames = []
    for k in range(N_FRAMES):
        spans = [wire.TpuSpan(
            start_ns=1_760_000_000_000_000_000 + (k * SPANS_A_FRAME + j)
            * 1_000_000, duration_ns=int(rng.integers(1000, 900_000)),
            hlo_op=f"kernel_{(k + j) % 11}", hlo_module="train_step",
            kind=1, run_id=k // 4 + 1, step=k // 4 + 1, device_id=j % 2,
            pid=77, process_name="trainer") for j in range(SPANS_A_FRAME)]
        frames.append(encode_frame(
            FrameHeader(MessageType.TPU_SPAN, agent_id=AGENT, seq=k + 1),
            wire.TpuSpanBatch(spans=spans).SerializeToString()))
    return frames


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Proc:
    """One package's server entry point in a subprocess, with storage."""

    def __init__(self, which: str, data_dir: str, ingest: int,
                 query: int, log_path: str) -> None:
        args = ["--ingest-port", str(ingest), "--query-port", str(query),
                "--no-controller", "--data-dir", data_dir, "--storage",
                "--flush-interval-s", "0.2", "--compact-interval-s", "1"]
        if which == "ref":
            cmd = [sys.executable, "-c",
                   "from deepflow_tpu.server.server import main; main()",
                   "--host", "127.0.0.1", "--sync-port",
                   str(_free_port()), "--scrub-interval-s", "0", *args]
        else:
            cmd = [sys.executable, "-m", "deepflow_tpu_torch.server",
                   "--sync-port", "0", *args]
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
        self.qport = query
        self.log = open(log_path, "a")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=self.log, stderr=self.log)
        deadline = time.monotonic() + 90
        while True:
            assert self.proc.poll() is None, open(log_path).read()[-2000:]
            try:
                self.health()
                return
            except OSError:
                assert time.monotonic() < deadline, "server never listened"
                time.sleep(0.2)

    def health(self) -> dict:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.qport}/v1/health", timeout=10) as r:
            return json.loads(r.read())

    def query(self, sql: str) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.qport}/v1/query",
            data=json.dumps({"sql": sql}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())["result"]

    def kill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)
        self.log.close()

    def stop(self) -> None:
        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        self.log.close()


def _ship(ingest: int, frames: list[bytes], until: int,
          timeout: float = 60.0) -> tuple[socket.socket, int]:
    """Connect as the agent (SEQ_BASE 1), send the frames, and read acks
    until one reaches ``until``; returns the open socket and the ack."""
    conn = socket.create_connection(("127.0.0.1", ingest), timeout=5)
    conn.sendall(encode_seq_base(AGENT, 1) + b"".join(frames))
    dec, acked = StreamDecoder(), 0
    deadline = time.monotonic() + timeout
    while acked < until:
        assert time.monotonic() < deadline, f"acked {acked} of {until}"
        conn.settimeout(max(0.1, deadline - time.monotonic()))
        data = conn.recv(4096)
        assert data, "the server closed the connection"
        for h, p in dec.feed(data):
            if h.msg_type == MessageType.ACK:
                acked = max(acked, decode_ack(p))
    return conn, acked


KILL_SQL = [
    f"SELECT Count() AS n FROM {SPAN}",
    f"SELECT run_id, Count() AS n, Sum(duration_ns) AS d FROM {SPAN} "
    "GROUP BY run_id ORDER BY run_id",
    f"SELECT hlo_op, Sum(duration_ns) AS d, Max(time) AS t FROM {SPAN} "
    "GROUP BY hlo_op ORDER BY hlo_op",
]


def _kill_restart_drain(which: str, tmp_path) -> dict:
    frames = _span_frames()
    d = str(tmp_path / which)
    ingest, query = _free_port(), _free_port()
    log = str(tmp_path / f"{which}.log")
    srv = _Proc(which, d, ingest, query, log)
    half = N_FRAMES // 2
    try:
        conn, _ = _ship(ingest, frames[:half], half)
        conn.sendall(b"".join(frames[half:]))  # in flight at the kill
    finally:
        srv.kill()
    srv = _Proc(which, d, ingest, query, log)
    try:
        recovered = srv.query(KILL_SQL[0])["values"][0][0]
        # the agent sends every frame again: dedup keeps each once
        conn, acked = _ship(ingest, frames, N_FRAMES)
        conn.close()
        deadline = time.monotonic() + 30
        while srv.query(KILL_SQL[0])["values"][0][0] \
                < N_FRAMES * SPANS_A_FRAME:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        return {"recovered": recovered, "acked": acked,
                "answers": [srv.query(s) for s in KILL_SQL]}
    finally:
        srv.stop()


def test_both_servers_hold_each_row_once_after_sigkill(tmp_path):
    """Seq'd span frames into each package's server under --storage: the
    first half acked, the second in flight, SIGKILL; the restart
    recovers every acked row from disk, the agent sends every frame
    again, and both servers hold each row once with the same answers."""
    got = {w: _kill_restart_drain(w, tmp_path) for w in ("ref", "port")}
    for w, g in got.items():
        assert g["recovered"] >= N_FRAMES // 2 * SPANS_A_FRAME, w
        assert g["acked"] == N_FRAMES, w
        assert g["answers"][0]["values"] == [[N_FRAMES * SPANS_A_FRAME]], w
    assert got["port"]["answers"] == got["ref"]["answers"]


# -- pruned against unpruned scans -------------------------------------------

L7 = "flow_log.l7_flow_log"


def _l7_rows(k: int, n: int) -> list[dict]:
    return [{"time": (k * 1000 + j) * 1_000_000,
             "app_service": f"svc-{(k + j) % 5}",
             "request_id": (k * 7 + j) % 24 + 1,
             "trace_id": f"t{(k * 131 + j * 17) % 997:04d}",
             "endpoint": f"/e{j % 3}"} for j in range(n)]


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    """The same L7 rows in both packages: eight flushes, the first five
    compacted into a sorted run with skip indexes, and a RAM tail."""
    out = {}
    for pk in PKGS:
        db = pk.Database(data_dir=str(tmp_path_factory.mktemp(pk.name)),
                         storage=True, chunk_rows=100)
        t = db.table(L7)
        for k in range(8):
            t.append_rows(_l7_rows(k, 120))
            db.flush_to_tier()
            if k == 4:
                assert db.compact_tier()["runs_built"] == 1
        t.append_rows(_l7_rows(9, 50))
        out[pk.name] = t
    return out


_T_HI = 10_000 * 1_000_000
_conds = st.one_of(
    st.builds(lambda op, v: f"time {op} {v}",
              st.sampled_from(["=", "<", "<=", ">", ">="]),
              st.integers(-5, _T_HI // 1_000_000 + 5).map(
                  lambda x: x * 1_000_000)),
    st.builds(lambda op, k: f"app_service {op} 'svc-{k}'",
              st.sampled_from(["=", "<", "<=", ">", ">=", "!="]),
              st.integers(0, 7)),
    st.builds(lambda ks: "app_service IN (" + ", ".join(
        f"'svc-{k}'" for k in ks) + ")",
        st.lists(st.integers(0, 7), min_size=1, max_size=3)),
    st.builds(lambda op, v: f"request_id {op} {v}",
              st.sampled_from(["=", "<", ">="]), st.integers(0, 26)),
    st.builds(lambda v: f"trace_id = 't{v:04d}'", st.integers(0, 1100)),
    st.builds(lambda ks: "trace_id IN (" + ", ".join(
        f"'t{k:04d}'" for k in ks) + ")",
        st.lists(st.integers(0, 1100), min_size=1, max_size=3)),
    st.builds(lambda v: f"endpoint LIKE '/e{v}%'", st.integers(0, 4)),
)


@pytest.mark.parametrize("conds", [
    ["time = 0", "time = 1000000", "time = 0"],
    ["time >= 5000000000", "time < 1000000", "time <= 9000000000"],
    ["time = 7000000", "time > 8000000", "time = 7000000",
     "app_service = 'svc-1'"]])
def test_a_range_emptied_by_one_conjunct_stays_empty(tiers, conds):
    """Three conjuncts on one column whose first two leave no row: the
    third must not bring rows back (the range fold kept the third's
    interval over the empty one's), pruned or not."""
    sql = ("SELECT Count() AS c, Sum(request_id) AS s FROM t WHERE "
           + " AND ".join(conds))
    assert engine.execute(tiers["port"], sql).values \
        == ref_engine.execute(tiers["ref"], sql).values == []


@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(conds=st.lists(_conds, min_size=1, max_size=3))
def test_pruned_scans_answer_as_unpruned(tiers, monkeypatch, conds):
    """Segments pruned by zones, zstr zones and skip indexes never drop a
    matching row: the port's pruned answer equals its unpruned one and
    the reference's."""
    sql = ("SELECT Count() AS c, Sum(request_id) AS s, Min(time) AS t0, "
           "Max(time) AS t1 FROM t WHERE " + " AND ".join(conds))
    pruned = engine.execute(tiers["port"], sql).values
    want = ref_engine.execute(tiers["ref"], sql).values
    with monkeypatch.context() as m:
        m.setattr(engine, "_zone_constraints", lambda t, w: [])
        m.setattr(engine, "_index_constraints", lambda t, w: ([], []))
        unpruned = engine.execute(tiers["port"], sql).values
    assert pruned == unpruned == want


def test_pruning_counts_like_reference(tiers):
    """The same queries prune the same segments in both packages, counted
    in scan_stats() and the prune span."""
    for sql in ["SELECT Count() AS c FROM t WHERE time < 1000000000",
                "SELECT Count() AS c FROM t WHERE app_service = 'svc-9'",
                "SELECT Count() AS c FROM t WHERE trace_id = 't0000'",
                "SELECT Count() AS c FROM t WHERE app_service >= 'svc-4'"]:
        deltas = []
        for eng, t in ((ref_engine, tiers["ref"]),
                       (engine, tiers["port"])):
            s0 = eng.scan_stats()
            eng.execute(t, sql)
            s1 = eng.scan_stats()
            deltas.append({k: s1[k] - s0[k] for k in s1})
        assert deltas[0] == deltas[1], sql
    assert engine.scan_stats()["pruned_segments"] > 0


# -- dfctl segments and datasources --zones ----------------------------------

def _dfctl_out(main, qport: int, argv: list[str], capsys) -> str:
    capsys.readouterr()
    rc = main(["--server", f"127.0.0.1:{qport}", *argv])
    return capsys.readouterr().out + f"rc {rc or 0}"


@pytest.fixture(scope="module")
def storage_pair(tmp_path_factory):
    """A reference and a port server with storage, fed the same span
    frames, flushed once, and compacted."""
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    data_dir=str(tmp_path_factory.mktemp("ref")),
                    storage=True, flush_interval_s=3600,
                    compact_interval_s=0, scrub_interval_s=0,
                    selfstats_interval_s=3600).start()
    port = Server(ingest_port=0, query_port=0,
                  data_dir=str(tmp_path_factory.mktemp("port")),
                  storage=True, flush_interval_s=3600,
                  compact_interval_s=0).start()
    try:
        frames = [encode_frame(FrameHeader(MessageType.TPU_SPAN,
                                           agent_id=AGENT), p)
                  for _h, p in StreamDecoder().feed(b"".join(
                      _span_frames()))]
        for srv in (ref, port):
            for k in (1, 2):  # two flushes: two segments
                half = frames[(k - 1) * N_FRAMES // 2:k * N_FRAMES // 2]
                with socket.create_connection(("127.0.0.1",
                                               srv.ingest_port)) as c:
                    c.sendall(b"".join(half))
                assert srv.wait_for_rows(
                    SPAN, k * N_FRAMES // 2 * SPANS_A_FRAME, timeout=20)
                srv.flusher.flush_once(seal=True)
        yield ref, port
    finally:
        ref.stop()
        port.stop()


def _rows_of_port_tables(out: str) -> list[list[str]]:
    """datasources' lines as tokens, the root path and the tables the
    port's schema lacks left out (the reference's schema has more)."""
    rows = []
    for line in out.splitlines():
        tok = line.split()
        if tok and tok[0] == "root:":
            tok = tok[:1] + ["<root>"] + tok[2:]
        elif tok and "." in tok[0] and not tok[0].startswith("-") \
                and tok[0] not in schema.TABLES:
            continue
        rows.append(tok)
    return rows


@pytest.mark.parametrize("argv", [
    ["segments", SPAN], ["segments"], ["segments", "--v1"],
    ["segments", SPAN, "--json"], ["datasources", "--zones"],
    ["datasources"]], ids=lambda a: "_".join(a).replace(".", "-"))
def test_dfctl_storage_views_like_reference(storage_pair, capsys, argv):
    ref, port = storage_pair
    want = _dfctl_out(ref_dfctl.main, ref.query_port, argv, capsys)
    got = _dfctl_out(dfctl.main, port.query_port, argv, capsys)
    if argv[0] == "datasources":
        assert _rows_of_port_tables(got) == _rows_of_port_tables(want)
        assert "ZONES" in got or "--zones" not in argv
    elif argv == ["segments"]:
        # the reference's server holds segments of tables the port's
        # schema lacks (its own self-telemetry rows): compare the span
        # table's lines
        pick = [ln.split() for ln in want.splitlines() if SPAN in ln]
        assert [ln.split() for ln in got.splitlines() if SPAN in ln] == pick
        assert pick
    else:
        assert got == want
    assert got.endswith("rc 0")


def test_dfctl_storage_views_after_compaction(storage_pair, capsys):
    """After a compaction (one sorted v2 run with skip indexes) both
    print the same segment view."""
    ref, port = storage_pair
    for srv in (ref, port):
        assert srv.db.compact_tier(SPAN)["runs_built"] == 1
    argv = ["segments", SPAN]
    want = _dfctl_out(ref_dfctl.main, ref.query_port, argv, capsys)
    got = _dfctl_out(dfctl.main, port.query_port, argv, capsys)
    assert got == want and "v2" in got


def test_health_storage_block_and_segments_route(storage_pair):
    ref, port = storage_pair
    hr, hp = ref.api.health()["storage"], port.api.health()["storage"]
    for k in ("flush_gen", "evict_gen", "migrate_v1_remaining"):
        assert hp[k] == hr[k], k
    assert hp["tables"][SPAN] == hr["tables"][SPAN]
    assert hp["gate_pending"] == 0 and "commit_ms" in hp
    assert port.api.segments(SPAN) == ref.api.segments(SPAN)
