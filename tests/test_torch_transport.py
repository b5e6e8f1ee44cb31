"""The port's durable transport held against the JAX package's on the CPU:
the codec's ACK / SEQ_BASE frames and priority classes, the Profile and
Stats messages, the receiver's ack tracker and the decoders' dedup window
on the same operation sequences, and each package's UniformSender into
the other's server: the same rows, every frame acked."""

import json
import random
import socket
import struct
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepflow_tpu import codec as ref_codec
from deepflow_tpu.agent.sender import UniformSender as RefSender
from deepflow_tpu.proto import pb
from deepflow_tpu.server import Server as RefServer
from deepflow_tpu.server.decoders import DedupWindow as RefDedup
from deepflow_tpu.server.receiver import SeqAckTracker as RefTracker
from deepflow_tpu.tpuprobe.stepmetrics import encode_step_payload
from deepflow_tpu_torch import codec
from deepflow_tpu_torch.agent.sender import UniformSender
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.server.decoders import DedupWindow
from deepflow_tpu_torch.server.receiver import SeqAckTracker

MT = codec.MessageType
BASE_NS = 1_760_000_000_000_000_000
TABLES = ("profile.in_process_profile", "profile.tpu_hlo_span",
          "profile.tpu_memory", "profile.tpu_step_metrics",
          "deepflow_system.deepflow_system")


def _wait(cond, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# -- codec ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_ack_and_seq_base_frames_equal_reference(seed):
    rng = random.Random(seed)
    for _ in range(50):
        agent = rng.randrange(1 << 16)
        seq = rng.choice([0, 1, rng.randrange(1 << 64), (1 << 64) - 1])
        ack = codec.encode_ack(agent, seq)
        base = codec.encode_seq_base(agent, seq)
        assert ack == ref_codec.encode_ack(agent, seq)
        assert base == ref_codec.encode_seq_base(agent, seq)
        h, payload, _ = codec.decode_frame(ack)
        assert (h.msg_type, h.agent_id) == (MT.ACK, agent)
        assert codec.decode_ack(payload) == ref_codec.decode_ack(payload) \
            == seq
        h, payload, _ = codec.decode_frame(base)
        assert h.msg_type == MT.SEQ_BASE
        assert codec.decode_seq_base(payload) == seq
    for short in (b"", b"\x00" * 7):
        with pytest.raises(codec.FrameDecodeError):
            codec.decode_ack(short)
        with pytest.raises(codec.FrameDecodeError):
            codec.decode_seq_base(short)


def test_priority_classes_equal_reference():
    assert (codec.PRIORITY_HIGH, codec.PRIORITY_MID, codec.PRIORITY_LOW) == \
        (ref_codec.PRIORITY_HIGH, ref_codec.PRIORITY_MID,
         ref_codec.PRIORITY_LOW)
    assert [m.name for m in MT] == [m.name for m in ref_codec.MessageType]
    for m in MT:
        assert codec.priority_of(m) == \
            ref_codec.priority_of(ref_codec.MessageType(int(m))), m


# -- Profile and Stats messages -------------------------------------------------

def _random_profiles(rng, n):
    words = ["runpy._run_code", "__main__.main", "torch.autograd.backward",
             "m.step", "queue.get", "time.sleep", "x.ü", ""]
    out = []
    for _ in range(n):
        stack = ";".join(rng.choice(words[:-1])
                         for _ in range(rng.randrange(0, 6)))
        out.append(dict(
            process_name=rng.choice(["", "runner.py", "trainer"]),
            app_service=rng.choice(["", "llama-train"]),
            pid=rng.choice([0, rng.randrange(1 << 32)]),
            tid=rng.choice([0, (1 << 32) - 1, rng.randrange(1 << 32)]),
            thread_name=rng.choice(["", "MainThread", "loader"]),
            event_type=rng.randrange(6),
            timestamp_ns=rng.choice([0, rng.randrange(1 << 64)]),
            stack=stack.encode(), value=rng.randrange(1 << 40),
            count=rng.randrange(1 << 32), container_id=rng.choice(["", "c"]),
            profiler=rng.choice(["", "pysampler"])))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_profile_batch_bytes_equal_protobuf(seed):
    rng = random.Random(seed)
    fields = _random_profiles(rng, 30)
    mine = wire.ProfileBatch([wire.Profile(**f) for f in fields])
    ref = pb.ProfileBatch()
    for f in fields:
        ref.profiles.add(**f)
    data = ref.SerializeToString()
    assert mine.SerializeToString() == data
    assert wire.ProfileBatch.FromString(data) == mine


def _random_stats(rng):
    metrics = []
    for i in range(rng.randrange(1, 6)):
        tags = {f"t{j}": rng.choice(["", "x", "ü"])
                for j in range(rng.randrange(0, 4))}
        values = {f"v{j}": rng.choice([0.0, -1.5, 2.0 ** 63, 1e-300,
                                       rng.random()])
                  for j in range(rng.randrange(0, 5))}
        metrics.append((rng.choice(["", f"agent.m{i}"]),
                        rng.choice([0, rng.randrange(1 << 64)]), tags,
                        values))
    return metrics


@pytest.mark.parametrize("seed", range(4))
def test_stats_batch_parses_equal_protobuf(seed):
    """Map order on the wire is not fixed: each side parses the other's
    bytes into the same message."""
    rng = random.Random(seed)
    metrics = _random_stats(rng)
    mine = wire.StatsBatch([wire.StatsMetric(*m) for m in metrics])
    ref = pb.StatsBatch()
    for name, ts, tags, values in metrics:
        m = ref.metrics.add(name=name, timestamp_ns=ts)
        m.tags.update(tags)
        m.values.update(values)
    assert pb.StatsBatch.FromString(mine.SerializeToString()) == ref
    assert wire.StatsBatch.FromString(ref.SerializeToString()) == mine


# -- ack tracker and dedup window ------------------------------------------------

_OPS = st.lists(st.tuples(st.sampled_from(["observe", "advance"]),
                          st.integers(0, 2), st.integers(0, 40)),
                max_size=80)


@settings(max_examples=150, deadline=None)
@given(_OPS, st.sampled_from([2, 4, 4096]))
def test_seq_ack_tracker_matches_reference(ops, max_oos):
    """The same observe / advance sequence gives the same watermark after
    every step (small MAX_OOS values reach the overflow jump)."""
    mine, ref = SeqAckTracker(), RefTracker()
    mine.MAX_OOS = ref.MAX_OOS = max_oos
    for op, agent, seq in ops:
        getattr(mine, op)(agent, seq)
        getattr(ref, op)(agent, seq)
        assert mine.snapshot() == ref.snapshot()
        assert mine.contiguous(agent) == ref.contiguous(agent)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["seen", "advance_floor"]),
                          st.integers(0, 2), st.integers(0, 40)),
                max_size=80),
       st.sampled_from([2, 4, 65536]))
def test_dedup_window_matches_reference(ops, capacity):
    """The same seen / advance_floor sequence gives the same dup verdicts
    and counters."""
    mine, ref = DedupWindow(capacity=capacity), RefDedup(capacity=capacity)
    for op, agent, seq in ops:
        assert getattr(mine, op)(agent, seq) == getattr(ref, op)(agent, seq)
        assert mine.stats == ref.stats


# -- senders into servers ----------------------------------------------------------

def _payloads(n: int) -> list[tuple[MT, bytes]]:
    """n frames of each of the agent's four types, from a seed."""
    rng = random.Random(7)
    out = []
    for i in range(n):
        prof = pb.ProfileBatch()
        for f in _random_profiles(rng, 3):
            prof.profiles.add(**f)
        spans = pb.TpuSpanBatch()
        spans.spans.add(start_ns=BASE_NS + i, duration_ns=5 + i,
                        hlo_module="train_step", hlo_op=f"k{i % 3}", kind=1,
                        run_id=1 + i, step=1 + i, pid=7, process_name="t")
        spans.memory.add(timestamp_ns=BASE_NS + i, device_id=0,
                         bytes_in_use=i << 20, bytes_limit=80 << 30)
        step = encode_step_payload([{
            "time": BASE_NS + i, "end_ns": BASE_NS + i + 500,
            "latency_ns": 500, "run_id": 1 + i, "step": 1 + i, "job": "t",
            "device_count": 1, "device_skew_ns": 0, "compute_ns": 9,
            "collective_ns": 0, "straggler_device": 0,
            "straggler_lag_ns": 0, "top_hlos": [["k0", 9, "fusion"]]}],
            pid=7, process_name="t")
        stats = pb.StatsBatch()
        m = stats.metrics.add(name="agent.sender", timestamp_ns=BASE_NS + i)
        m.tags["process"] = "t"
        m.values["sent_frames"] = float(i)
        out += [(MT.PROFILE, prof.SerializeToString()),
                (MT.TPU_SPAN, spans.SerializeToString()),
                (MT.STEP_METRICS, step),
                (MT.DFSTATS, stats.SerializeToString())]
    return out


def _rows(table):
    names = list(table.columns)
    cols = table.column_concat(names)
    dec = [table.dicts[n].decode_many(cols[n]) if n in table.dicts
           else cols[n].tolist() for n in names]
    return names, sorted(zip(*dec))


def test_senders_cross_servers_same_rows_all_acked():
    """The port's sender into the reference server and the reference's
    sender into the port's server: the same rows, and each sender's acks
    reach seq_base + N."""
    payloads = _payloads(6)
    ref_srv = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                        selfstats_interval_s=3600).start()
    port_srv = Server(ingest_port=0, query_port=0,
                      selfstats_interval_s=3600).start()
    senders = []
    try:
        mine = UniformSender([("127.0.0.1", ref_srv.ingest_port)],
                             agent_id=3).start()
        theirs = RefSender([("127.0.0.1", port_srv.ingest_port)],
                           agent_id=3).start()
        senders = [mine, theirs]
        for mt, p in payloads:
            assert mine.send(mt, p)
            assert theirs.send(ref_codec.MessageType(int(mt)), p)
        n = len(payloads)
        for s in senders:
            assert _wait(lambda s=s: s.stats["acked_seq"] == s.seq_base + n)
            assert s.stats["sent_frames"] == n
            assert s.stats["retransmits"] == 0 and s.stats["dropped"] == 0
        for t in TABLES:
            assert _rows(port_srv.db.table(t)) == \
                _rows(ref_srv.db.table(t)), t
            assert len(port_srv.db.table(t)) > 0, t
        assert port_srv.receiver.stats["acks_sent"] >= 1
        assert port_srv.receiver.stats["seq_bases"] == 1
        assert all(d.stats["dups"] == 0 and d.stats["errors"] == 0
                   for d in port_srv.decoders)
    finally:
        for s in senders:
            s.flush_and_stop()
        ref_srv.stop()
        port_srv.stop()


@pytest.fixture
def server():
    s = Server(ingest_port=0, query_port=0,
               selfstats_interval_s=3600).start()
    yield s
    s.stop()


def _profile_payload(name: str) -> bytes:
    return wire.ProfileBatch([wire.Profile(
        process_name="p", app_service=name, timestamp_ns=time.time_ns(),
        stack=b"a;b", value=1, count=1)]).SerializeToString()


def test_dedup_under_forced_retransmit(server):
    """The same v2 frame written twice (a resend whose original did land)
    makes one row, and the copy counts in dups."""
    frame = codec.encode_frame(
        codec.FrameHeader(MT.PROFILE, agent_id=4, seq=1),
        _profile_payload("once"))
    s = socket.create_connection(("127.0.0.1", server.ingest_port))
    s.sendall(frame)
    s.sendall(frame)
    s.close()
    assert server.wait_for_rows("profile.in_process_profile", 1)
    dec = next(d for d in server.decoders if d.MSG_TYPE == MT.PROFILE)
    assert _wait(lambda: dec.stats["dups"] >= 1, 5)
    assert dec.stats["dups"] == 1
    assert len(server.db.table("profile.in_process_profile")) == 1


def _read_acks_until(s, buf, target, timeout=5.0):
    s.settimeout(timeout)
    acked = 0
    deadline = time.time() + timeout
    while acked < target and time.time() < deadline:
        buf += s.recv(4096)
        while True:
            h, payload, consumed = codec.decode_frame(buf)
            if not consumed:
                break
            assert h.msg_type == MT.ACK
            acked = codec.decode_ack(payload)
            buf = buf[consumed:]
    return acked, buf


def test_seq_base_fast_forwards_ack_watermark(server):
    """A SEQ_BASE (a restarted agent's fresh epoch seq space) moves the
    ack watermark past the never-sent gap."""
    s = socket.create_connection(("127.0.0.1", server.ingest_port))
    s.sendall(codec.encode_frame(
        codec.FrameHeader(MT.PROFILE, agent_id=8, seq=1),
        _profile_payload("old-boot")))
    acked, buf = _read_acks_until(s, b"", 1)
    assert acked == 1
    base = 1 << 32
    s.sendall(codec.encode_seq_base(8, base))
    s.sendall(codec.encode_frame(
        codec.FrameHeader(MT.PROFILE, agent_id=8, seq=base),
        _profile_payload("new-boot")))
    acked, _ = _read_acks_until(s, buf, base)
    s.close()
    assert acked == base
    assert server.wait_for_rows("profile.in_process_profile", 2)
    assert len(server.db.table("profile.in_process_profile")) == 2


def test_retransmit_on_reconnect_gives_rows_once(server, monkeypatch):
    """Frames written but never acked are sent again after a reconnect;
    the server's dedup window makes their copies into no second row, and
    the acks then cover every seq."""
    # the server writes no acks until the connection is cut
    monkeypatch.setattr(server.receiver, "_send_acks", lambda *a: None)
    sender = UniformSender([("127.0.0.1", server.ingest_port)],
                           agent_id=5).start()
    try:
        n = 8
        for i in range(n):
            assert sender.send(MT.PROFILE, _profile_payload(f"r{i}"))
        assert server.wait_for_rows("profile.in_process_profile", n)
        assert _wait(lambda: sender.stats["sent_frames"] == n)
        assert sender.stats["acked_seq"] == 0
        sender._sock.shutdown(socket.SHUT_RDWR)  # the connection drops
        assert _wait(lambda: sender.stats["retransmits"] == n)
        assert _wait(lambda: sum(d.stats["dups"] for d in server.decoders)
                     == n)
        monkeypatch.undo()  # acks flow again
        assert _wait(lambda: sender.stats["acked_seq"]
                     == sender.seq_base + n)
        assert sender.stats["retransmits"] == n
        assert sender.stats["reconnects"] == 2
        assert sum(d.stats["dups"] for d in server.decoders) == n
        assert len(server.db.table("profile.in_process_profile")) == n
    finally:
        sender.flush_and_stop()


def test_failover_to_the_next_server(server):
    """A dead first server: frames land on the second."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()  # nothing listens there
    sender = UniformSender([f"127.0.0.1:{dead_port}",
                            ("127.0.0.1", server.ingest_port)],
                           agent_id=6, connect_timeout=1.0).start()
    try:
        assert sender.send(MT.PROFILE, _profile_payload("f"))
        assert server.wait_for_rows("profile.in_process_profile", 1)
        assert _wait(lambda: sender.stats["acked_seq"]
                     == sender.seq_base + 1)
    finally:
        sender.flush_and_stop()


def test_priority_shedding_like_reference_no_seq_burned():
    """A full queue sheds the oldest lower-class frame; a frame with no
    lower class to shed is dropped. Neither sender allocates a seq before
    the wire, and both give the same verdicts and counts."""
    seq = [MT.DFSTATS, MT.DFSTATS, MT.PROFILE, MT.STEP_METRICS,
           MT.TPU_SPAN, MT.DFSTATS, MT.TPU_SPAN]
    results = []
    for cls, types in ((UniformSender, MT),
                       (RefSender, ref_codec.MessageType)):
        s = cls([("127.0.0.1", 1)], queue_size=2)  # never started
        first = s._next_seq
        verdicts = [s.send(types(int(m)), b"x") for m in seq]
        assert s._next_seq == first == s.seq_base + 1
        queued = [int(f.msg_type) for f in list(s._q.queue)]
        results.append((verdicts, s.stats["shed"], s.stats["dropped"],
                        queued))
    assert results[0] == results[1]
    assert results[0][1:] == (2, 5, [int(MT.PROFILE), int(MT.STEP_METRICS)])


def test_flush_and_stop_returns_promptly_without_server():
    sender = UniformSender([("127.0.0.1", 1)], connect_timeout=0.2).start()
    sender.send(MT.PROFILE, b"x")
    t0 = time.monotonic()
    sender.flush_and_stop(timeout=0.5)
    assert time.monotonic() - t0 < 4.0
    assert not sender._thread.is_alive()


def test_health_shows_acks_seq_bases_and_dups(server):
    """GET /v1/health carries the receiver's acks_sent and seq_bases and
    the decoders' and the window's dups."""
    import urllib.request
    frame = codec.encode_frame(
        codec.FrameHeader(MT.DFSTATS, agent_id=2, seq=9),
        wire.StatsBatch([wire.StatsMetric("m", 1, {}, {"v": 1.0})])
        .SerializeToString())
    s = socket.create_connection(("127.0.0.1", server.ingest_port))
    s.sendall(codec.encode_seq_base(2, 9) + frame + frame)
    acked, _ = _read_acks_until(s, b"", 9)
    s.close()
    assert acked == 9
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.query_port}/v1/health",
            timeout=10) as r:
        health = json.loads(r.read())
    st_ = health["stats"]
    assert st_["receiver"]["seq_bases"] == 1
    assert st_["receiver"]["acks_sent"] >= 1
    assert st_["decoders"]["DFSTATS"]["dups"] == 1
    assert st_["dedup"]["dups"] == 1
    assert health["tables"]["deepflow_system.deepflow_system"] == 1
    assert struct.calcsize(codec.SEQ_EXT_FMT) == 8


def test_ack_window_evicts_oldest_and_resends_the_rest(server, monkeypatch):
    """Past ack_window unacked frames the oldest leave the window (counted
    in unacked_evicted, never resent); after a reconnect only the window
    is sent again, and every frame's row is there once."""
    monkeypatch.setattr(server.receiver, "_send_acks", lambda *a: None)
    sender = UniformSender([("127.0.0.1", server.ingest_port)],
                           agent_id=9, ack_window=2).start()
    try:
        for i in range(5):
            assert sender.send(MT.PROFILE, _profile_payload(f"w{i}"))
        assert server.wait_for_rows("profile.in_process_profile", 5)
        assert _wait(lambda: sender.stats["sent_frames"] == 5)
        assert sender.stats["unacked_evicted"] == 3
        sender._sock.shutdown(socket.SHUT_RDWR)
        assert _wait(lambda: sender.stats["retransmits"] == 2)
        assert _wait(lambda: sum(d.stats["dups"] for d in server.decoders)
                     == 2)
        monkeypatch.undo()
        assert _wait(lambda: sender.stats["acked_seq"]
                     == sender.seq_base + 5)
        assert len(server.db.table("profile.in_process_profile")) == 5
    finally:
        sender.flush_and_stop()
