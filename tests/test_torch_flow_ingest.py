"""The flow path's ingest: the same L4_LOG, L7_LOG and METRICS frames
into the JAX package's server and into the port's give the same rows in
flow_log.l4_flow_log, flow_log.l7_flow_log, flow_metrics.network.1s and
flow_metrics.application.1s, and the smoke's three DF-SQL queries
(chip_flows.FLOW_QUERIES) the same answers over /v1/query; resent
frames dedup, are acked and stay in their org. Then the user path:
``dfctl replay`` of every golden capture into a running port server
lands every L7 row, and loads no torch."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import chip_flows
import flow_traffic as ft
import test_torch_server as tsrv
from test_torch_retention import _table_rows
from deepflow_tpu_torch.agent.dispatcher import Dispatcher
from deepflow_tpu_torch.agent.packet import MetaPacket, TcpFlags
from deepflow_tpu_torch.cli import dfctl
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.store import schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "pcaps")
CASES = sorted(fn[:-5] for fn in os.listdir(FIXTURE_DIR)
               if fn.endswith(".pcap"))
TABLES = chip_flows.FLOW_TABLES
AGENT = 3


class _Sink:
    def __init__(self) -> None:
        self.frames: list[tuple[int, bytes]] = []

    def send(self, msg_type, payload: bytes) -> bool:
        self.frames.append((int(msg_type), payload))
        return True


def _v6_packets() -> list[MetaPacket]:
    """One IPv6 HTTP exchange, as MetaPackets (v6 rows take the
    printable-address path)."""
    a = b"\x20\x01\x0d\xb8" + b"\x00" * 11 + b"\x01"
    b = b"\x20\x01\x0d\xb8" + b"\x00" * 11 + b"\x02"
    req = b"GET /v6 HTTP/1.1\r\nHost: six\r\n\r\n"
    resp = b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n"
    t = ft.T0 + 5_000_000_000
    spec = [(a, b, 50000, 80, TcpFlags.SYN, b""),
            (b, a, 80, 50000, TcpFlags.SYN | TcpFlags.ACK, b""),
            (a, b, 50000, 80, TcpFlags.ACK, b""),
            (a, b, 50000, 80, TcpFlags.ACK | TcpFlags.PSH, req),
            (b, a, 80, 50000, TcpFlags.ACK | TcpFlags.PSH, resp),
            (a, b, 50000, 80, TcpFlags.FIN | TcpFlags.ACK, b""),
            (b, a, 80, 50000, TcpFlags.FIN | TcpFlags.ACK, b"")]
    return [MetaPacket(timestamp_ns=t + i * 1000, ip_src=s, ip_dst=d,
                       port_src=sp, port_dst=dp, protocol=1, tcp_flags=f,
                       payload=p, packet_len=74 + len(p), seq=i)
            for i, (s, d, sp, dp, f, p) in enumerate(spec)]


def flow_frames(seed: int = 2) -> list[tuple[int, bytes]]:
    """The dispatcher's frames over the synthetic traffic, an IPv6
    exchange and every golden capture."""
    sink = _Sink()
    disp = Dispatcher(sender=sink)
    for chunk, end in ft.windows(ft.synthetic(seed)):
        disp.inject_frames(chunk)
        disp.flush(now_ns=end)
    for p in _v6_packets():
        disp.inject(p)
    disp.flush(now_ns=ft.T0 + 400 * 10**9)
    for name in CASES:
        disp.replay_pcap(os.path.join(FIXTURE_DIR, f"{name}.pcap"),
                         tick=False)
    disp.flush(now_ns=ft.T0 + 800 * 10**9)
    disp.flush(force=True)
    return sink.frames


def _counts(frames) -> dict:
    n = dict.fromkeys(TABLES, 0)
    for mt, payload in frames:
        if mt in (MessageType.L4_LOG, MessageType.L7_LOG):
            b = wire.FlowLogBatch.FromString(payload)
            n["flow_log.l4_flow_log"] += len(b.l4)
            n["flow_log.l7_flow_log"] += len(b.l7)
        else:
            for d in wire.DocumentBatch.FromString(payload).docs:
                n["flow_metrics.network.1s"] += d.HasField("flow_meter")
                n["flow_metrics.application.1s"] += d.HasField("app_meter")
    return n


@pytest.fixture(scope="module", params=[None, 3_000_000_000],
                ids=["no-offset", "clock-offset"])
def pair(request):
    """A reference and a port server holding the same flow frames (with
    the agent's clock offset set on both, or none)."""
    ref, port = tsrv._start_pair()
    try:
        if request.param is not None:
            for srv in (ref, port):
                srv.platform.set_clock_offset(AGENT, request.param)
        frames = flow_frames()
        data = [encode_frame(FrameHeader(MessageType(mt), agent_id=AGENT,
                                         seq=i + 1), payload)
                for i, (mt, payload) in enumerate(frames)]
        counts = _counts(frames)
        tsrv._ingest((ref, port), data, counts)
        yield ref, port, counts
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("table", TABLES)
def test_rows_equal_reference(pair, table):
    ref, port, counts = pair
    cols = [c.name for c in schema.TABLES[table]]
    got, want = port.db.table(table), ref.db.table(table)
    assert len(got) == len(want) == counts[table] > 0
    rows = [dict(zip(cols, r)) for r in _table_rows(got)]
    ref_cols = list(want.columns)
    ref_rows = [dict(zip(ref_cols, r)) for r in _table_rows(want)]
    assert rows == [{c: r[c] for c in cols} for r in ref_rows]
    assert all(r["agent_id"] == AGENT for r in rows)


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/query/",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("name", sorted(chip_flows.FLOW_QUERIES))
def test_flow_queries_answer_as_reference(pair, name):
    ref, port, _ = pair
    db, sql = chip_flows.FLOW_QUERIES[name]
    got = _post(port.query_port, {"db": db, "sql": sql})["result"]
    want = _post(ref.query_port, {"db": db, "sql": sql})["result"]
    assert got["values"]
    assert tsrv.tsql._same(got, want), (got, want)
    assert got == chip_flows.local_answer(port.db, name)


def test_show_lists_the_flow_tables(pair):
    ref, port, _ = pair
    for what in ("tags", "metrics"):
        for table in ("l4_flow_log", "l7_flow_log", "network",
                      "application"):
            body = {"sql": f"SHOW {what} FROM {table}"}
            assert _post(port.query_port, body) == \
                _post(ref.query_port, body)


@pytest.fixture
def server():
    srv = Server(ingest_port=0, query_port=0).start()
    try:
        yield srv
    finally:
        srv.stop()


def _wait(srv, table: str, n: int) -> int:
    deadline = time.monotonic() + 30
    while len(srv.db.table(table)) < n and time.monotonic() < deadline:
        time.sleep(0.05)
    return len(srv.db.table(table))


def test_dfctl_replay_lands_every_l7_row(server, capsys):
    want = 0
    for name in CASES:
        with open(os.path.join(FIXTURE_DIR, f"{name}.result")) as f:
            want += json.load(f)["records"]
        assert dfctl.main(["replay", os.path.join(FIXTURE_DIR,
                                                  f"{name}.pcap"),
                           "--ingest",
                           f"127.0.0.1:{server.ingest_port}"]) == 0
        assert capsys.readouterr().out.startswith("replayed ")
    assert _wait(server, "flow_log.l7_flow_log", want) == want
    assert _wait(server, "flow_log.l4_flow_log", 1) > 0
    assert server.decoders[0].dedup.stats["dups"] == 0


def test_dfctl_replay_as_a_process_leaves_torch_unloaded(server):
    """python -m deepflow_tpu_torch.cli.dfctl replay, as a user runs it,
    and the same main in a fresh interpreter that then checks its
    modules: no torch."""
    path = os.path.join(FIXTURE_DIR, "http1.pcap")
    addr = f"127.0.0.1:{server.ingest_port}"
    out = subprocess.run([sys.executable, "-m", "deepflow_tpu_torch.cli.dfctl",
                          "replay", path, "--ingest", addr], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("replayed 7 packets")
    code = ("import sys\n"
            "from deepflow_tpu_torch.cli import dfctl\n"
            "from deepflow_tpu_torch.server import integration, exporters\n"
            f"dfctl.main(['replay', {path!r}, '--ingest', {addr!r}])\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert _wait(server, "flow_log.l7_flow_log", 2) == 2


def test_resent_flow_frames_dedup_and_ack(server):
    """Seq'd flow frames sent twice (a sender's retransmission after a
    reconnect) write their rows once; the second copies count as dups,
    and the receiver acks them; org 2 sees none of org 1's rows."""
    frames = flow_frames(seed=4)
    counts = _counts(frames)
    data = b"".join(encode_frame(FrameHeader(MessageType(mt), agent_id=5,
                                             seq=i + 1), payload)
                    for i, (mt, payload) in enumerate(frames))
    tsrv._send(server.ingest_port, data)
    for table, n in counts.items():
        assert _wait(server, table, n) == n, table
    tsrv._send(server.ingest_port, data)
    deadline = time.monotonic() + 30
    while server.dedup.stats["dups"] < len(frames) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert server.dedup.stats["dups"] == len(frames)
    assert {t: len(server.db.table(t)) for t in TABLES} == counts
    assert server.receiver.stats["acks_sent"] > 0
    sql = "SELECT Count() AS n FROM l7_flow_log"
    assert _post(server.query_port, {"db": "flow_log", "sql": sql,
                                     "org_id": 1})["result"]["values"] \
        == [[counts["flow_log.l7_flow_log"]]]
    assert _post(server.query_port, {"db": "flow_log", "sql": sql,
                                     "org_id": 2})["result"]["values"] \
        in ([], [[0]])
