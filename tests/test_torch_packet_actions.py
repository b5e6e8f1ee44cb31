"""The ACL's packet actions in the port, held against the JAX package on
the CPU: rolling pcap captures shipped as PCAP frames into the server's
pcap store, and NPB forwarding as VXLAN over UDP.

The same frames (from a numpy seed) and the same ACLs through both
packages' ``PacketActions`` give the same PCAP uploads (their pcaps equal
once unzipped) and the same NPB datagrams; pcap replay runs them on both
engines. The reference's cases (tests/test_packet_actions.py) run on the
port, and the SOCK_RAW capture runs them on the frames it does not
exclude, the NPB target's port among the excluded, also live on ``lo``
where AF_PACKET opens.
"""

import errno
import gzip
import http.client
import http.server
import json
import os
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest

from deepflow_tpu.agent import labeler as ref_labeler
from deepflow_tpu.agent import packet_actions as ref_actions
from deepflow_tpu.proto import pb
from deepflow_tpu.server.decoders import PcapDecoder as RefPcapDecoder
from deepflow_tpu_torch.agent import labeler, live_capture, native_flow
from deepflow_tpu_torch.agent import packet_actions
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.agent.dispatcher import Dispatcher
from deepflow_tpu_torch.agent.packet import TcpFlags, decode_ethernet, \
    encode_tcp_frame
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.server import Server

_PCAP_HDR = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
T0 = 1_700_000_000_000_000_000


def pcap_of(path: str, frames: list[bytes], t0_s: int = 1_700_000_000):
    with open(path, "wb") as f:
        f.write(_PCAP_HDR)
        for i, frame in enumerate(frames):
            f.write(struct.pack("<IIII", t0_s + i, 0, len(frame),
                                len(frame)))
            f.write(frame)


def frame_of(mp) -> bytes:
    """A MetaPacket's Ethernet frame (TCP)."""
    return encode_tcp_frame(socket.inet_ntoa(mp.ip_src),
                            socket.inet_ntoa(mp.ip_dst), mp.port_src,
                            mp.port_dst, mp.tcp_flags, mp.payload,
                            seq=mp.seq, ack=mp.ack)


def seeded_frames(seed: int, flows: int = 24) -> list[tuple[bytes, int]]:
    """(frame, ts_ns) of TCP flows in 10.50/16, 10.60/16 and 10.70/16:
    a handshake, a GET and its answer, the FIN pair; flows interleaved."""
    rng = np.random.default_rng(seed)
    f = TcpFlags
    per_flow = []
    for k in range(flows):
        net = (50, 60, 70)[k % 3]
        c = f"10.{net}.{int(rng.integers(0, 4))}.{int(rng.integers(1, 250))}"
        s = f"10.{net}.9.{k % 5 + 1}"
        cp, sp = 30000 + k, int(rng.choice([80, 8080, 9090]))
        req = f"GET /k{k} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
        resp = b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"
        per_flow.append([
            encode_tcp_frame(c, s, cp, sp, f.SYN, seq=1),
            encode_tcp_frame(s, c, sp, cp, f.SYN | f.ACK, seq=9, ack=2),
            encode_tcp_frame(c, s, cp, sp, f.ACK, seq=2, ack=10),
            encode_tcp_frame(c, s, cp, sp, f.ACK | f.PSH, req, seq=2,
                             ack=10),
            encode_tcp_frame(s, c, sp, cp, f.ACK | f.PSH, resp, seq=10,
                             ack=2 + len(req)),
            encode_tcp_frame(c, s, cp, sp, f.FIN | f.ACK, seq=2 + len(req)),
            encode_tcp_frame(s, c, sp, cp, f.FIN | f.ACK, seq=10 + 40)])
    out = []
    for i in range(7):
        for k in rng.permutation(flows).tolist():
            out.append(per_flow[k][i])
    return [(fr, T0 + i * 1000) for i, fr in enumerate(out)]


ACLS = [{"cidr": "10.50.0.0/16", "action": "pcap"},
        {"cidr": "10.60.0.0/16", "action": "npb"},
        {"cidr": "10.70.9.0/24", "port": 8080, "action": "ignore"}]


class _Sink:
    def __init__(self) -> None:
        self.sent: list[tuple] = []

    def send(self, mt, payload) -> bool:
        self.sent.append((int(mt), payload))
        return True


def _udp_receiver():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(0.3)
    return s


def _drain(sock) -> list[bytes]:
    out = []
    while True:
        try:
            out.append(sock.recvfrom(65536)[0])
        except socket.timeout:
            return out


def _uploads(sent, codec) -> list[tuple]:
    return [(u.name, u.agent_id, u.start_ns, u.packet_count,
             gzip.decompress(u.pcap_gz))
            for u in (codec.PcapUpload.FromString(p)
                      for mt, p in sent if mt == int(MessageType.PCAP))]


@pytest.mark.parametrize("via", ["frames", "replay"])
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_pcap_and_npb_like_reference(tmp_path, seed, via):
    """The same frames and ACLs, handed to the actions one by one or
    replayed from a pcap through each package's dispatcher (native
    engine): equal uploads, datagrams and counts."""
    from deepflow_tpu.agent.dispatcher import Dispatcher as RefDispatcher
    frames = seeded_frames(seed)
    path = str(tmp_path / "in.pcap")
    pcap_of(path, [f for f, _ in frames])
    results = []
    for lab_mod, act_mod, disp_cls in (
            (labeler, packet_actions, Dispatcher),
            (ref_labeler, ref_actions, RefDispatcher)):
        lab = lab_mod.Labeler()
        lab.load_acls([lab_mod.AclRule(**a) for a in ACLS])
        rx, sink = _udp_receiver(), _Sink()
        pa = act_mod.PacketActions(
            lab, sender=sink, agent_id=7,
            npb_target=f"127.0.0.1:{rx.getsockname()[1]}", npb_vni=42)
        pa.MAX_BUFFERED = 25   # several rolling captures
        assert pa.enabled()
        if via == "frames":
            for frame, ts in frames:
                pa.handle_frame(frame, ts)
        else:
            disp = disp_cls(sender=_Sink(), engine="native", labeler=lab)
            disp.packet_actions = pa
            assert disp.replay_pcap(path) == len(frames)
        pa.stop()
        codec = wire if act_mod is packet_actions else pb
        results.append((_uploads(sink.sent, codec), sorted(_drain(rx)),
                        pa.stats))
        rx.close()
    (up, dgrams, stats), (rup, rdgrams, rstats) = results
    assert up == rup and dgrams == rdgrams and stats == rstats
    n_pcap = sum(decode_ethernet(f).ip_src[1] == 50 for f, _ in frames)
    assert sum(u[3] for u in up) == n_pcap == stats["pcap_frames"]
    assert len(up) > 1 and len(dgrams) == stats["npb_frames"] > 0
    for d in dgrams:
        flags, vni = struct.unpack(">II", d[:8])
        assert flags >> 24 == 0x08 and vni >> 8 == 42
        assert decode_ethernet(d[8:]).ip_src[1] == 60


def test_pcap_upload_bytes_equal_the_references():
    """An upload's message bytes, built by both, are equal."""
    up = pb.PcapUpload(name="acl-pcap-3-1", agent_id=3, start_ns=T0,
                       packet_count=2, pcap_gz=b"\x1f\x8bxyz")
    data = up.SerializeToString()
    mine = wire.PcapUpload.FromString(data)
    assert mine.SerializeToString() == data
    assert (mine.name, mine.agent_id, mine.start_ns, mine.packet_count,
            mine.pcap_gz) == ("acl-pcap-3-1", 3, T0, 2, b"\x1f\x8bxyz")


@pytest.mark.parametrize("engine", ["native", "python"])
def test_replay_runs_the_actions_on_both_engines(tmp_path, engine):
    frames = seeded_frames(3)
    path = str(tmp_path / "in.pcap")
    pcap_of(path, [f for f, _ in frames])
    lab = labeler.Labeler()
    lab.load_acls([labeler.AclRule(**a) for a in ACLS])
    sink, rx = _Sink(), _udp_receiver()
    disp = Dispatcher(sender=sink, engine=engine, labeler=lab)
    disp.packet_actions = packet_actions.PacketActions(
        lab, sender=sink, npb_target=f"127.0.0.1:{rx.getsockname()[1]}")
    assert disp.replay_pcap(path) == len(frames)
    disp.stop()  # the last rolling capture ships
    got = _uploads(sink.sent, wire)
    want = [f for f, _ in frames if decode_ethernet(f).ip_src[1] == 50]
    pcap = got[0][4]
    assert len(got) == 1 and got[0][3] == len(want)
    assert all(f in pcap for f in want)
    assert len(_drain(rx)) == sum(decode_ethernet(f).ip_src[1] == 60
                                  for f, _ in frames)
    rx.close()
    l4 = [f for mt, p in sink.sent if mt == int(MessageType.L4_LOG)
          for f in wire.FlowLogBatch.FromString(p).l4]
    ignored = {(m.ip_src, m.port_src) for m in map(decode_ethernet,
                                                   (f for f, _ in frames))
               if m.ip_src[1] == 70 and m.port_dst == 8080}
    assert ignored and lab.stats["ignored_flows"] >= len(ignored)
    assert len(l4) == 24 - len(ignored)
    assert not any(bytes(f.key.ip_dst)[1] == 70 and f.key.port_dst == 8080
                   for f in l4)


def test_pcap_and_npb_actions_end_to_end(tmp_path):
    """The reference's case: an agent with pcap and npb ACLs and no flow
    capture replays a pcap; the NPB receiver gets the matched frame as
    VXLAN, the server's pcap store the other, and plain traffic is still
    traced."""
    npb = _udp_receiver()
    npb.settimeout(5)
    server = Server(host="127.0.0.1", ingest_port=0, query_port=0).start()
    agent = None
    try:
        cfg = AgentConfig()
        cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
        cfg.profiler.enabled = cfg.tpuprobe.enabled = False
        cfg.guard.enabled = False
        cfg.acls = [{"cidr": "10.50.0.0/16", "action": "pcap"},
                    {"cidr": "10.60.0.0/16", "action": "npb"}]
        cfg.npb_target = f"127.0.0.1:{npb.getsockname()[1]}"
        cfg.npb_vni = 42
        agent = Agent(cfg, device=None).start()
        pa = agent.dispatcher.packet_actions
        assert pa is not None and pa.enabled()
        mk = encode_tcp_frame
        frames = {"pcap_match": mk("10.50.0.1", "10.50.0.2", 1111, 8080,
                                   TcpFlags.SYN, seq=1),
                  "npb_match": mk("10.60.0.1", "10.60.0.2", 2222, 9090,
                                  TcpFlags.SYN, seq=1),
                  "plain": mk("10.70.0.1", "10.70.0.2", 3333, 7070,
                              TcpFlags.SYN, seq=1)}
        path = str(tmp_path / "in.pcap")
        pcap_of(path, list(frames.values()))
        assert agent.dispatcher.replay_pcap(path) == 3
        assert pa.stats["pcap_frames"] == 1 and pa.stats["npb_frames"] == 1
        pa.flush()
        dgram, _ = npb.recvfrom(65536)
        flags, vni = struct.unpack(">II", dgram[:8])
        assert flags >> 24 == 0x08 and vni >> 8 == 42
        assert dgram[8:] == frames["npb_match"]
        deadline = time.monotonic() + 10
        entries = []
        while time.monotonic() < deadline and not entries:
            time.sleep(0.1)
            entries = list(getattr(server.db, "pcap_store",
                                   {"entries": []})["entries"])
        assert entries, "the capture never reached the server"
        e = entries[0]
        assert e["packet_count"] == 1 and e["agent_id"] == cfg.agent_id
        ans = _post(server.query_port, "/v1/pcaps", {"name": e["name"]})
        import base64
        data = gzip.decompress(base64.b64decode(ans["pcap_gz_b64"]))
        assert frames["pcap_match"] in data and frames["plain"] not in data
        listed = _post(server.query_port, "/v1/pcaps", {})["pcaps"]
        assert [x["name"] for x in listed] == [e["name"]]
        assert "data" not in listed[0]
        assert server.wait_for_rows("flow_log.l4_flow_log", 1, timeout=10)
    finally:
        if agent:
            agent.stop()
        server.stop()
        npb.close()


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_pcaps_land_on_disk_with_a_data_dir(tmp_path):
    """With a data dir the captures are files, named safely; past
    MAX_MEMORY the oldest go, files too."""
    import queue

    from deepflow_tpu_torch.codec import FrameHeader
    from deepflow_tpu_torch.server.decoders import PcapDecoder
    from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
    from deepflow_tpu_torch.store.db import Database
    db = Database(data_dir=str(tmp_path))
    dec = PcapDecoder(queue.Queue(), db, PlatformInfoTable())
    dec.MAX_MEMORY = 2
    for name in ("../../etc/x", "a b", ".hidden"):
        up = wire.PcapUpload(name=name, agent_id=0, packet_count=1,
                             pcap_gz=gzip.compress(b"x"))
        assert dec.handle(FrameHeader(MessageType.PCAP, agent_id=4),
                          up.SerializeToString()) == 1
    entries = db.pcap_store["entries"]
    assert [e["name"] for e in entries] == ["a_b", "hidden"]
    assert all(e["agent_id"] == 4 for e in entries)
    assert sorted(os.listdir(tmp_path / "pcaps")) == ["a_b.pcap.gz",
                                                      "hidden.pcap.gz"]
    for name in ("x", "../x", "", "...", "a/b c.pcap"):
        assert PcapDecoder._safe_name(name) == RefPcapDecoder._safe_name(name)


def test_actions_disabled_without_packet_acls():
    lab = labeler.Labeler()
    lab.load_acls([labeler.AclRule(cidr="10.0.0.0/8", action="ignore")])
    pa = packet_actions.PacketActions(lab)
    assert not pa.enabled() and pa.npb_port == 0
    lab.load_acls([labeler.AclRule(cidr="10.0.0.0/8", action="pcap")])
    assert pa.enabled()
    assert packet_actions.PacketActions(
        lab, npb_target="127.0.0.1").npb_port == 4789


def test_pushed_packet_acls_activate_actions():
    """Pushed pcap/npb ACLs build the dispatcher and executor on an agent
    that started with neither."""
    server = Server(host="127.0.0.1", ingest_port=0, query_port=0,
                    sync_port=0, enable_controller=True).start()
    agent = None
    try:
        cfg = AgentConfig()
        cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
        cfg.controller = f"127.0.0.1:{server.controller.port}"
        cfg.profiler.enabled = cfg.tpuprobe.enabled = False
        cfg.guard.enabled = False
        cfg.sync_interval_s = 0.2
        cfg.socket_scan_interval_s = 0
        agent = Agent(cfg, device=None).start()
        assert agent.dispatcher is None and agent.socket_scanner is None
        server.controller.configs.update(
            "default", b'profiler:\n  enabled: false\n'
                       b'acls:\n  - cidr: "10.50.0.0/16"\n    action: pcap\n'
                       b'  - port: 22\n    action: ignore\n'
                       b'npb_target: "127.0.0.1:4790"\n')
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline and not (
                agent.dispatcher is not None
                and agent.dispatcher.packet_actions is not None
                and agent.dispatcher.packet_actions.enabled()):
            time.sleep(0.1)
        assert agent.dispatcher.packet_actions.enabled()
        assert agent.dispatcher.packet_actions.npb_port == 4790
        assert agent.labeler.label_flow(b"\x01\x01\x01\x01",
                                        b"\x02\x02\x02\x02", 5, 22, 1)[2] \
            == "ignore"
        assert agent.sampler is None   # the pushed profiler: off
    finally:
        if agent:
            agent.stop()
        server.stop()


# -- the SOCK_RAW capture ------------------------------------------------------

class _ScriptedSocket:
    def __init__(self, script: list) -> None:
        self.script = list(script)

    def bind(self, addr) -> None:
        pass

    def setsockopt(self, *a) -> None:
        pass

    def getsockopt(self, level, opt, size=None):
        if opt == live_capture.PACKET_STATISTICS:
            return struct.pack("II", 0, 0)
        return 1 << 20

    def settimeout(self, t) -> None:
        pass

    def recvfrom(self, n):
        if self.script:
            return self.script.pop(0)
        time.sleep(0.01)
        raise socket.timeout

    def close(self) -> None:
        pass


def _refuse_ring(self, interface="", block_size=0, block_nr=0):
    raise OSError(errno.EINVAL, "no ring", interface)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_socket_capture_runs_actions_off_the_excluded_ports(monkeypatch,
                                                            engine):
    """The socket loop runs the actions on every frame it keeps: an NPB
    ACL over all of 127.0.0.0/8 forwards each kept frame once, and the
    NPB target's own datagrams (and the sender's port) are excluded, so
    nothing loops back."""
    rx = _udp_receiver()
    uport = rx.getsockname()[1]
    lo = ("lo", 3, socket.PACKET_HOST)
    kept = [encode_tcp_frame("127.0.0.1", "127.0.0.1", 41000 + i, 8080,
                             TcpFlags.ACK, seq=i) for i in range(6)]
    fed_back = [struct.pack(">II", 0x08 << 24, 1 << 8) + kept[0]]
    from deepflow_tpu_torch.agent.packet import encode_udp_frame
    script = [(f, lo) for f in kept]
    script += [(encode_udp_frame("127.0.0.1", "127.0.0.1", 50000, uport,
                                 fed_back[0]), lo)]
    script += [(encode_tcp_frame("127.0.0.1", "127.0.0.1", 42000, 20033,
                                 TcpFlags.ACK), lo)]
    sock = _ScriptedSocket(script)
    monkeypatch.setattr(native_flow.NativeRing, "__init__", _refuse_ring)
    real = socket.socket
    monkeypatch.setattr(live_capture.socket, "socket",
                        lambda family=-1, *a, **k: sock
                        if family == socket.AF_PACKET
                        else real(family, *a, **k))
    lab = labeler.Labeler()
    lab.load_acls([labeler.AclRule(cidr="127.0.0.0/8", action="npb")])
    disp = Dispatcher(sender=_Sink(), engine=engine, labeler=lab)
    disp.packet_actions = packet_actions.PacketActions(
        lab, npb_target=f"127.0.0.1:{uport}")
    cap = live_capture.LiveCapture(
        disp, interface="lo",
        exclude_ports=(20033, disp.packet_actions.npb_port)).start()
    deadline = time.monotonic() + 10
    while sock.script and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.3)
    cap.stop()
    disp.stop()
    got = _drain(rx)
    rx.close()
    assert sorted(d[8:] for d in got) == sorted(kept)
    assert cap.stats["excluded"] == 2 and cap.stats["injected"] == 6


def test_exclude_port_while_capturing(monkeypatch):
    monkeypatch.setattr(native_flow.NativeRing, "__init__", _refuse_ring)
    sock = _ScriptedSocket([])
    real = socket.socket
    monkeypatch.setattr(live_capture.socket, "socket",
                        lambda family=-1, *a, **k: sock
                        if family == socket.AF_PACKET
                        else real(family, *a, **k))
    disp = Dispatcher(sender=_Sink())
    cap = live_capture.LiveCapture(disp, interface="lo").start()
    try:
        cap.exclude_port(4789)
        assert 4789 in cap.exclude_ports
        sock.script.append((encode_tcp_frame("127.0.0.1", "127.0.0.1", 1,
                                             4789, TcpFlags.ACK),
                            ("lo", 3, socket.PACKET_HOST)))
        deadline = time.monotonic() + 5
        while cap.stats["excluded"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cap.stats["excluded"] == 1
    finally:
        cap.stop()
        disp.stop()
    analyzer = live_capture.LiveCapture(disp, interface="lo",
                                        capture_mode="analyzer")
    analyzer.exclude_port(4789)
    assert analyzer.exclude_ports == frozenset()


def _af_packet() -> bool:
    try:
        socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                      socket.htons(3)).close()
        return True
    except (OSError, AttributeError):
        return False


class _Ok(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802
        self.wfile.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")

    def log_message(self, *a) -> None:
        pass


def test_npb_on_lo_excludes_its_own_target(monkeypatch):
    """Live on lo (socket mode): NPB ACLs on the HTTP server's port and
    on the receiver's own port. The HTTP traffic is forwarded; the
    forwarded datagrams, were they captured, would match the second rule
    and be forwarded again without end. The target's port is excluded:
    none comes back and the count stops growing with the traffic."""
    if not _af_packet():
        pytest.skip("AF_PACKET does not open here")
    monkeypatch.setattr(native_flow.NativeRing, "__init__", _refuse_ring)
    rx = _udp_receiver()
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Ok)
    hport = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    cfg = AgentConfig()
    cfg.sender.servers = [("127.0.0.1", 1)]
    cfg.profiler.enabled = cfg.tpuprobe.enabled = cfg.guard.enabled = False
    cfg.flow.enabled, cfg.flow.interface = True, "lo"
    cfg.acls = [{"port": hport, "action": "npb"},
                {"port": rx.getsockname()[1], "action": "npb"}]
    cfg.npb_target = f"127.0.0.1:{rx.getsockname()[1]}"
    agent = Agent(cfg, device=None).start()
    try:
        assert agent.live_capture.mode == "socket"
        assert rx.getsockname()[1] in agent.live_capture.exclude_ports
        time.sleep(0.3)
        conn = http.client.HTTPConnection("127.0.0.1", hport, timeout=10)
        for i in range(20):
            conn.request("GET", f"/n{i}")
            assert conn.getresponse().read() == b"ok"
        conn.close()
        got = []
        for _ in range(3):   # until quiet
            more = _drain(rx)
            got += more
            if not more and got:
                break
        pa = agent.dispatcher.packet_actions
        sent = pa.stats["npb_frames"]
        time.sleep(0.5)
        assert pa.stats["npb_frames"] == sent   # no feedback loop
        inner = [decode_ethernet(d[8:]) for d in got]
        assert len(inner) == sent >= 20 * 2   # each request and answer
        assert all(hport in (m.port_src, m.port_dst) for m in inner)
    finally:
        agent.stop()
        httpd.shutdown()
        httpd.server_close()
        rx.close()
