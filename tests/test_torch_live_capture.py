"""Live capture (``agent/live_capture.py``) and the agent's flow wiring
(``agent/agent.py``, ``agent/config.py``): the SOCK_RAW loop on a
scripted socket (both engines, loopback copies, exclusions, batches),
the capture modes and their checks as the JAX package's, an agent asked
for ``--flow`` that raises and names the cause when capture cannot open,
and, where this host lets AF_PACKET open, the node agent on ``lo``
capturing real HTTP requests (through a TPACKET_V3 ring where one maps,
and through SOCK_RAW) with torch never loaded."""

import errno
import http.client
import http.server
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

from deepflow_tpu.agent import config as ref_config
from deepflow_tpu.agent import live_capture as ref_live_capture
from deepflow_tpu_torch.agent import agent as agent_mod
from deepflow_tpu_torch.agent import config, live_capture, native_flow
from deepflow_tpu_torch.agent.dispatcher import Dispatcher
from deepflow_tpu_torch.agent.packet import TcpFlags, encode_tcp_frame
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, S_ = "10.1.0.1", "10.1.0.2"


class _Sink:
    def __init__(self) -> None:
        self.frames: list[tuple[int, bytes]] = []

    def send(self, msg_type, payload: bytes) -> bool:
        self.frames.append((int(msg_type), payload))
        return True

    def l7(self) -> list:
        return [r for mt, p in self.frames if mt == MessageType.L7_LOG
                for r in wire.FlowLogBatch.FromString(p).l7]

    def l4(self) -> list:
        return [r for mt, p in self.frames if mt == MessageType.L4_LOG
                for r in wire.FlowLogBatch.FromString(p).l4]


def _http_frames(sport: int, dport: int = 80) -> list[bytes]:
    req = b"GET /scripted HTTP/1.1\r\nHost: x\r\n\r\n"
    resp = b"HTTP/1.1 503 Service Unavailable\r\nContent-Length: 0\r\n\r\n"
    f = TcpFlags
    return [encode_tcp_frame(C, S_, sport, dport, f.SYN, seq=1),
            encode_tcp_frame(S_, C, dport, sport, f.SYN | f.ACK, seq=9,
                             ack=2),
            encode_tcp_frame(C, S_, sport, dport, f.ACK, seq=2, ack=10),
            encode_tcp_frame(C, S_, sport, dport, f.ACK | f.PSH, req,
                             seq=2),
            encode_tcp_frame(S_, C, dport, sport, f.ACK | f.PSH, resp,
                             seq=10),
            encode_tcp_frame(C, S_, sport, dport, f.FIN | f.ACK),
            encode_tcp_frame(S_, C, dport, sport, f.FIN | f.ACK)]


class _ScriptedSocket:
    """Stands in for socket(AF_PACKET, SOCK_RAW): hands out the scripted
    (frame, address) pairs, then times out; PACKET_STATISTICS reads a
    fixed drop count once."""

    def __init__(self, script: list, drops: int = 0) -> None:
        self.script = list(script)
        self.drops = drops
        self.closed = False
        self.opts: dict = {}

    def bind(self, addr) -> None:
        self.bound = addr

    def setsockopt(self, level, opt, value) -> None:
        self.opts[(level, opt)] = value

    def getsockopt(self, level, opt, size=None):
        if (level, opt) == (live_capture.SOL_PACKET,
                            live_capture.PACKET_STATISTICS):
            out, self.drops = struct.pack("II", 0, self.drops), 0
            return out
        return 1 << 20

    def settimeout(self, t) -> None:
        pass

    def recvfrom(self, n):
        if self.script:
            return self.script.pop(0)
        time.sleep(0.01)
        raise socket.timeout

    def close(self) -> None:
        self.closed = True


def _refuse_ring(errno_: int):
    def refuse(self, interface="", block_size=0, block_nr=0):
        raise OSError(errno_, os.strerror(errno_), f"ring on {interface}")
    return refuse


@pytest.mark.parametrize("engine", ["native", "python"])
def test_socket_loop_feeds_the_flow_map(monkeypatch, engine):
    """The SOCK_RAW loop (a kernel with no ring): one copy of each
    loopback frame, the excluded port's frames dropped, kernel drops
    counted, and the flows and the L7 session out of the dispatcher."""
    lo_in, lo_out = ("lo", 3, socket.PACKET_HOST), ("lo", 3,
                                                    socket.PACKET_OUTGOING)
    script = []
    for fr in _http_frames(40001):
        script += [(fr, lo_out), (fr, lo_in)]    # lo's two copies
    for fr in _http_frames(40002, dport=20033):  # the agent's own port
        script.append((fr, lo_in))
    sock = _ScriptedSocket(script, drops=3)
    monkeypatch.setattr(native_flow.NativeRing, "__init__",
                        _refuse_ring(errno.EINVAL))
    real = socket.socket
    monkeypatch.setattr(live_capture.socket, "socket",
                        lambda family=-1, *a, **k: sock
                        if family == socket.AF_PACKET
                        else real(family, *a, **k))
    sink = _Sink()
    disp = Dispatcher(sender=sink, engine=engine)
    cap = live_capture.LiveCapture(disp, interface="lo").start()
    assert cap.mode == "socket" and len(cap.threads) == 2
    assert cap.stats["ring_unsupported"] == ("EINVAL" if engine == "native"
                                             else "")
    deadline = time.monotonic() + 10
    while sock.script and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.2)
    cap.stop()
    assert sock.closed and not any(t.is_alive() for t in cap.threads)
    disp.flush(force=True)
    assert cap.stats["frames"] == 14
    assert cap.stats["excluded"] == 7 and cap.stats["injected"] == 7
    assert cap.stats["drops"] == 3
    (l7,) = sink.l7()
    assert (l7.request_type, l7.request_resource, l7.response_code,
            l7.response_status) == ("GET", "/scripted", 503,
                                    wire.SERVER_ERROR)
    (l4,) = sink.l4()
    assert (l4.key.port_src, l4.packet_tx, l4.packet_rx, l4.close_type) \
        == (40001, 4, 3, "fin")


def test_ring_errors_other_than_unsupported_raise(monkeypatch):
    monkeypatch.setattr(native_flow.NativeRing, "__init__",
                        _refuse_ring(errno.EPERM))
    with pytest.raises(PermissionError):
        live_capture.LiveCapture(Dispatcher(), interface="lo").start()


@pytest.mark.parametrize("mode,iface,ports", [
    ("local", "", {20033, 20035, 20416}),
    ("mirror", "eth9", {20033, 20035, 20416}),
    ("analyzer", "eth9", set()),
])
def test_capture_modes_keep_the_references_exclusions(mode, iface, ports):
    cap = live_capture.LiveCapture(Dispatcher(engine="python"),
                                   interface=iface, capture_mode=mode)
    ref = ref_live_capture.LiveCapture(None, interface=iface,
                                       capture_mode=mode)
    assert cap.exclude_ports == ref.exclude_ports == ports
    with pytest.raises(ValueError, match="capture_mode must be one of"):
        live_capture.LiveCapture(Dispatcher(engine="python"),
                                 capture_mode="promisc")


@pytest.mark.parametrize("mode,iface", [
    ("local", ""), ("mirror", ""), ("analyzer", ""), ("mirror", "eth9"),
    ("analyzer", "eth9"), ("sniff", "eth9")])
def test_flow_config_checks_are_the_references(mode, iface):
    def outcome(mod):
        cfg = mod.AgentConfig()
        cfg.flow.capture_mode, cfg.flow.interface = mode, iface
        try:
            cfg.validate()
        except ValueError as e:
            return str(e)
        return "ok"
    assert outcome(config) == outcome(ref_config)
    assert config.FlowConfig().exclude_ports == \
        ref_config.FlowConfig().exclude_ports


def test_flow_agent_raises_when_capture_cannot_open(monkeypatch):
    """No CAP_NET_RAW: the ring's socket and the SOCK_RAW socket are
    refused. The agent raises, names the cause, and leaves nothing
    running; the standalone --flow entry point raises as well."""
    monkeypatch.setattr(native_flow.NativeRing, "__init__",
                        _refuse_ring(errno.EINVAL))

    real = socket.socket

    def refuse(family=-1, *a, **k):
        if family == socket.AF_PACKET:
            raise PermissionError(errno.EPERM, "Operation not permitted")
        return real(family, *a, **k)
    monkeypatch.setattr(live_capture.socket, "socket", refuse)
    cfg = config.AgentConfig()
    cfg.sender.servers = [("127.0.0.1", 1)]
    cfg.flow.enabled, cfg.flow.interface = True, "lo"
    cfg.profiler.enabled = cfg.tpuprobe.enabled = False
    agent = agent_mod.Agent(cfg, device=None)
    with pytest.raises(agent_mod.CaptureError,
                       match="EPERM: live capture needs CAP_NET_RAW"):
        agent.start()
    assert agent.sender._thread is None or not agent.sender._thread.is_alive()
    assert agent.dispatcher._thread is None or \
        not agent.dispatcher._thread.is_alive()
    with pytest.raises(agent_mod.CaptureError, match="on lo cannot open"):
        agent_mod.main(["--server", "127.0.0.1:1", "--flow", "--interface",
                        "lo"])


def _af_packet() -> str:
    """"ok" where this host opens AF_PACKET sockets, else the errno."""
    try:
        socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                      socket.htons(3)).close()
        return "ok"
    except OSError as e:
        return errno.errorcode.get(e.errno, str(e.errno))


def test_bad_interface_names_the_cause():
    cfg = config.AgentConfig()
    cfg.sender.servers = [("127.0.0.1", 1)]
    cfg.flow.enabled, cfg.flow.interface = True, "nosuchif9"
    cfg.profiler.enabled = cfg.tpuprobe.enabled = False
    want = ("ENODEV: no interface 'nosuchif9'" if _af_packet() == "ok"
            else "live capture needs CAP_NET_RAW")
    with pytest.raises(agent_mod.CaptureError, match=want):
        agent_mod.Agent(cfg, device=None).start()


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802
        code = 500 if self.path.endswith("=0") else 200
        self.wfile.write(f"HTTP/1.1 {code} X\r\nContent-Length: 2\r\n\r\nok"
                         .encode())

    def log_message(self, *a) -> None:
        pass


def _wait_rows(srv, table, where, n, timeout=30.0) -> int:
    deadline = time.monotonic() + timeout
    got = 0
    while time.monotonic() < deadline:
        got = sum(1 for v in srv.db.table(table).column_concat(
            [where[0]])[where[0]].tolist() if v == where[1])
        if got >= n:
            break
        time.sleep(0.1)
    return got


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "socket"])
def test_node_agent_on_lo_captures_http(tmp_path, ring):
    """python -m deepflow_tpu_torch.agent --flow --interface lo beside a
    stdlib HTTP server: every request lands in l7_flow_log with its
    path and status, no flow touches the agent's sender port, and the
    agent process never maps torch. Needs AF_PACKET on this host (and
    for the ring case a kernel that maps one)."""
    support = _af_packet()
    if support != "ok":
        pytest.skip(f"AF_PACKET does not open here ({support})")
    env = dict(os.environ)
    if not ring:  # the ring refused, as a kernel with no mmap rings does
        shim = tmp_path / "sitecustomize.py"
        shim.write_text(
            "import errno, os\n"
            "import deepflow_tpu_torch.agent.native_flow as nf\n"
            "def _refuse(self, interface='', block_size=0, block_nr=0):\n"
            "    raise OSError(errno.EINVAL, 'no ring', interface)\n"
            "nf.NativeRing.__init__ = _refuse\n")
        env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    srv = Server(ingest_port=0, query_port=0).start()
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    hport = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    log = tmp_path / "agent.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepflow_tpu_torch.agent", "--server",
             f"127.0.0.1:{srv.ingest_port}", "--flow", "--interface", "lo",
             "--agent-id", "9"], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while "live capture (" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.1)
        mode = "ring" if ring else "socket"
        assert f"live capture ({mode}, local mode)" in log.read_text()
        with open(f"/proc/{proc.pid}/maps") as f:
            assert "libtorch" not in f.read()
        conn = http.client.HTTPConnection("127.0.0.1", hport, timeout=10)
        for i in range(40):
            conn.request("GET", f"/item?id={i}")
            assert conn.getresponse().read() == b"ok"
        conn.close()
        time.sleep(1.5)
    finally:
        httpd.shutdown()
        httpd.server_close()
        proc.send_signal(signal.SIGTERM)
        proc.wait(60)
    try:
        assert proc.returncode == 0, log.read_text()
        assert _wait_rows(srv, "flow_log.l7_flow_log", ("port_dst", hport),
                          40) == 40
        t = srv.db.table("flow_log.l7_flow_log")
        cols = t.column_concat(["port_dst", "request_resource",
                                "response_code", "agent_id"])
        paths = t.dicts["request_resource"].decode_many(
            cols["request_resource"])
        rows = sorted((p, int(c)) for p, c, d in zip(
            paths, cols["response_code"].tolist(),
            cols["port_dst"].tolist()) if d == hport)
        assert rows == sorted((f"/item?id={i}", 500 if i == 0 else 200)
                              for i in range(40))
        l4 = srv.db.table("flow_log.l4_flow_log").column_concat(
            ["port_src", "port_dst", "agent_id"])
        assert not any(a == 9 and srv.ingest_port in (s, d) for s, d, a in
                       zip(l4["port_src"].tolist(), l4["port_dst"].tolist(),
                           l4["agent_id"].tolist()))
    finally:
        srv.stop()
