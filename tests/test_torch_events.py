"""The port's EVENT decoder held against the JAX package's.

Both servers, started in this process on port 0, take the same
``EventBatch`` frames (the port's ``wire`` bytes; the reference parses
them with protobuf) and must hold the same ``event.event`` rows and the
same ``event.file_agg`` minute windows: windows the watermark passed,
late events inside the grace period merged into their window and later
ones starting a fresh row, a final flush of the open windows at the
stop, the agent's clock offset on the event rows, the agent's tags on
both, and a resent seq'd frame written once. Every wait is bounded
(5 s or less).
"""

import socket
import time

import pytest

from deepflow_tpu.server.server import Server as RefServer
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.server import Server

W = 60 * 1_000_000_000       # the reducer's window
G = 5 * 1_000_000_000        # its grace period
T0 = 1_700_000_040_000_000_000 - 1_700_000_040_000_000_000 % W


def _io(ts: int, pid: int, path: str, op: str, latency: int,
        nbytes: int, **attrs) -> wire.Event:
    return wire.Event(timestamp_ns=ts, event_type=f"file-io-{op}",
                      resource_type="file", resource_name=path, pid=pid,
                      attrs={"latency_ns": str(latency),
                             "bytes": str(nbytes), **attrs})


def _frame(events: list, agent_id: int = 3, seq: int | None = None) -> bytes:
    return encode_frame(FrameHeader(MessageType.EVENT, agent_id=agent_id,
                                    seq=seq),
                        wire.EventBatch(events).SerializeToString())


def _rows(db, name: str) -> list:
    t = db.table(name)
    names = list(t.columns)
    cols = t.column_concat(names)
    dec = [t.dicts[n].decode_many(cols[n]) if n in t.dicts
           else cols[n].tolist() for n in names]
    return sorted(zip(*dec))


def _event_decoder(srv):
    return next(d for d in srv.decoders
                if d.MSG_TYPE == MessageType.EVENT)


class Pair:
    """A reference and a port server fed the same frames, one at a time
    (each decoded before the next is sent: the watermark is order)."""

    def __init__(self) -> None:
        self.ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                             selfstats_interval_s=3600).start()
        self.port = Server(ingest_port=0, query_port=0, sync_port=0,
                           selfstats_interval_s=3600).start()
        self.sent = 0

    def send(self, frame: bytes) -> None:
        self.sent += 1
        for srv in (self.ref, self.port):
            with socket.create_connection(("127.0.0.1", srv.ingest_port),
                                          timeout=5) as c:
                c.sendall(frame)
        for srv in (self.ref, self.port):
            dec = _event_decoder(srv)
            deadline = time.monotonic() + 5
            while (dec.stats["batches"] + dec.stats["dups"]
                   + dec.stats["errors"] < self.sent
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert dec.stats["batches"] + dec.stats["dups"] \
                + dec.stats["errors"] == self.sent

    def assert_same(self) -> list:
        for name in ("event.event", "event.file_agg"):
            assert _rows(self.port.db, name) == _rows(self.ref.db, name), \
                name
        return _rows(self.port.db, "event.file_agg")

    def stop(self) -> None:
        self.port.stop()
        self.ref.stop()


@pytest.fixture
def pair():
    p = Pair()
    try:
        yield p
    finally:
        p.stop()


def _agg(db) -> list[dict]:
    t = db.table("event.file_agg")
    names = ["time", "pid", "path", "op", "count", "bytes",
             "max_latency_ns", "sum_latency_ns"]
    cols = t.column_concat(names)
    dec = {n: (t.dicts[n].decode_many(cols[n]) if n in t.dicts
               else cols[n].tolist()) for n in names}
    op_labels = [c for c in t.columns.values() if c.name == "op"][0] \
        .enum_values
    rows = [dict(zip(names, vals)) for vals in zip(*dec.values())]
    for r in rows:
        if isinstance(r["op"], int):
            r["op"] = op_labels[r["op"]]
    return sorted(rows, key=lambda r: (r["time"], r["pid"], r["path"],
                                       r["op"], r["count"]))


def test_file_io_windows_like_the_reference(pair):
    events = [_io(T0 + i * 10**9, 10, "/data/a", "read", lat, 4096)
              for i, lat in enumerate((5_000_000, 9_000_000, 2_000_000))]
    events.append(_io(T0 + 5 * 10**9, 11, "/data/a", "write", 10**6, 100))
    events.append(wire.Event(timestamp_ns=T0 + 6 * 10**9,
                             event_type="process-start",
                             resource_type="process", resource_name="py",
                             pid=10, description="started"))
    # much later: the watermark passes the first window
    events.append(_io(T0 + 3 * W, 10, "/data/b", "read", 1, 1))
    pair.send(_frame(events))
    pair.assert_same()
    rows = _agg(pair.port.db)
    assert [(r["time"], r["pid"], r["op"], r["count"], r["bytes"],
             r["max_latency_ns"], r["sum_latency_ns"]) for r in rows] == [
        (T0, 10, "read", 3, 3 * 4096, 9_000_000, 16_000_000),
        (T0, 11, "write", 1, 100, 10**6, 10**6)]
    assert len(pair.port.db.table("event.event")) == 6


def test_late_events_inside_and_outside_the_grace_period(pair):
    pair.send(_frame([_io(T0 + 1, 1, "/f", "read", 10, 1)]))
    # past the window's end, inside the grace: the window stays open
    pair.send(_frame([_io(T0 + W + G - 10**9, 1, "/g", "read", 10, 1)]))
    assert pair.assert_same() == []
    # a late event of the first window merges into it
    pair.send(_frame([_io(T0 + 30 * 10**9, 1, "/f", "read", 30, 2)]))
    assert pair.assert_same() == []
    # the watermark passes window + grace: the first window is written
    pair.send(_frame([_io(T0 + W + G + 10**9, 1, "/g", "write", 5, 1)]))
    rows = pair.assert_same()
    assert len(rows) == 1
    first = _agg(pair.port.db)[0]
    assert (first["time"], first["path"], first["count"], first["bytes"],
            first["max_latency_ns"], first["sum_latency_ns"]) == \
        (T0, "/f", 2, 3, 30, 40)
    # later than the grace: a fresh row of the same window (a split)
    pair.send(_frame([_io(T0 + 45 * 10**9, 1, "/f", "read", 7, 9)]))
    pair.assert_same()
    split = [r for r in _agg(pair.port.db) if r["path"] == "/f"]
    assert [(r["time"], r["count"], r["bytes"]) for r in split] == \
        [(T0, 1, 9), (T0, 2, 3)]


def test_final_flush_writes_the_open_windows():
    p = Pair()
    try:
        p.send(_frame([_io(T0 + i * 10**9, 7, "/ckpt", "write", 100 * i,
                           1 << 20) for i in range(4)]
                      + [_io(T0 + W, 7, "/ckpt", "read", 3, 10)]))
        assert p.assert_same() == []
    finally:
        p.stop()
    rows = p.assert_same()
    assert len(rows) == 2
    agg = _agg(p.port.db)
    assert [(r["time"], r["op"], r["count"]) for r in agg] == \
        [(T0, "write", 4), (T0 + W, "read", 1)]


def test_clock_offset_tags_and_bad_attrs_like_the_reference(pair):
    """An agent's clock offset moves its event rows, not its windows
    (the reference's); each agent's windows keep its tags apart; attrs
    that are no numbers count as zero."""
    for srv in (pair.ref, pair.port):
        srv.platform.set_clock_offset(5, 7_000_000_000)
    pair.send(_frame([_io(T0 + 1, 2, "/x", "read", 10, 10),
                      _io(T0 + 2, 2, "/x", "read", "slow", 5)], agent_id=5))
    pair.send(_frame([_io(T0 + 3, 2, "/x", "read", 20, 20)], agent_id=6))
    pair.send(_frame([_io(T0 + 2 * W, 2, "/y", "write", 1, 1)],
                     agent_id=5))
    pair.assert_same()
    ev = pair.port.db.table("event.event")
    times = sorted(ev.column_concat(["time"])["time"].tolist())
    assert times[0] == T0 + 3 and T0 + 1 + 7_000_000_000 in times
    agg = _agg(pair.port.db)
    assert sorted((r["count"], r["bytes"], r["max_latency_ns"])
                  for r in agg if r["path"] == "/x") == \
        [(1, 20, 20), (2, 10, 10)]


def test_resent_frames_write_once(pair):
    frame = _frame([_io(T0 + 1, 4, "/z", "read", 1, 1),
                    _io(T0 + 2 * W, 4, "/z", "read", 1, 1)], seq=1)
    pair.send(frame)
    pair.send(frame)  # a retransmit: a dup on both
    pair.assert_same()
    assert len(pair.port.db.table("event.event")) == 2
    assert _event_decoder(pair.port).stats["dups"] == 1
    assert [r["count"] for r in _agg(pair.port.db)] == [1]
