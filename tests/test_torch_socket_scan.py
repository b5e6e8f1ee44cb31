"""The socket-inode scan and the gpid join in the port, held against the
JAX package on the CPU.

The same ``/proc/net/{tcp,tcp6,udp,udp6}`` text (made from a numpy seed,
malformed lines among them) parses alike in both packages; a fake
``/proc`` tree and this host's own live listeners give equal
``scan_entries``; both ``GpidAllocator``s take the same snapshots alike.
The reference's cases (tests/test_socket_scan.py) run on the port, a
plain child process's flows carry its gpid and name end to end, and a
process that its own runner agent and the host's node agent both report
takes one gpid (the reference gives it one an agent).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from deepflow_tpu.agent import socket_scan as ref_scan
from deepflow_tpu.proto import pb
from deepflow_tpu.server.controller import Controller as RefController
from deepflow_tpu.server.controller import GpidAllocator as RefGpids
from deepflow_tpu.server.platform_info import \
    PlatformInfoTable as RefPlatform
from deepflow_tpu_torch.agent import socket_scan
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.query import engine
from deepflow_tpu_torch.server.controller import Controller, GpidAllocator
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.server import Server

HEAD = ("  sl  local_address rem_address   st tx_queue rx_queue tr "
        "tm->when retrnsmt   uid  timeout inode\n")
FAMILIES = (("net/tcp", False), ("net/tcp6", True), ("net/udp", False),
            ("net/udp6", True))


def _hex_addr(rng, v6: bool) -> str:
    if v6:
        words = rng.integers(0, 1 << 32, size=4, dtype=np.uint64)
        if rng.random() < 0.3:
            words[:] = 0
        return "".join(f"{int(w):08X}" for w in words)
    if rng.random() < 0.3:
        return "00000000"
    if rng.random() < 0.3:
        return "0100007F"
    return f"{int(rng.integers(0, 1 << 32)):08X}"


def proc_net_text(seed: int, v6: bool, n: int = 40) -> str:
    """A /proc/net table: LISTEN (0A), ESTABLISHED (01), TIME_WAIT (06)
    and UDP-style rows with inodes, plus short and garbled lines."""
    rng = np.random.default_rng(seed)
    lines = [HEAD]
    for i in range(n):
        local = f"{_hex_addr(rng, v6)}:{int(rng.integers(1, 65536)):04X}"
        remote = f"{_hex_addr(rng, v6)}:{int(rng.integers(0, 65536)):04X}"
        st = ("0A", "01", "06", "07")[int(rng.integers(0, 4))]
        inode = int(rng.integers(0, 1 << 24))
        lines.append(f"{i:4d}: {local} {remote} {st} 00000000:00000000 "
                     f"00:00000000 00000000  1000        0 {inode} 1 "
                     f"ffff88810 100 0 0 10 0\n")
        if i % 11 == 5:
            lines.append("  bad line\n")
        if i % 13 == 7:
            lines.append(f"{i:4d}: ZZ:QQ {remote} 0A 0 0 0 0 0 12 1\n")
    return "".join(lines)


@pytest.mark.parametrize("family", [f for f, _ in FAMILIES])
@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_parse_proc_net_like_reference(family, seed):
    v6 = dict(FAMILIES)[family]
    text = proc_net_text(seed, v6)
    got = socket_scan.parse_proc_net(text, v6=v6)
    assert got == ref_scan.parse_proc_net(text, v6=v6)
    assert len(got) == 40


def test_parse_proc_net_tcp():
    text = (HEAD +
            "   0: 0100007F:1F90 00000000:0000 0A 00000000:00000000 "
            "00:00000000 00000000     0        0 12345 1 ffff8880 100 0 0 10 0\n"
            "   1: 0200000A:C350 0100007F:0050 01 00000000:00000000 "
            "00:00000000 00000000  1000        0 67890 1 ffff8881 20 4 30 10 -1\n")
    socks = socket_scan.parse_proc_net(text)
    assert socks[0] == (b"\x7f\x00\x00\x01", 8080, 0x0A, 12345)
    assert socks[1] == (b"\x0a\x00\x00\x02", 50000, 0x01, 67890)


def fake_proc(root: str, seed: int) -> None:
    """A /proc tree: pids with socket and other fds, comms, and the four
    net tables, some inodes owned by no pid."""
    rng = np.random.default_rng(seed)
    tables = {}
    for family, v6 in FAMILIES:
        tables[family] = proc_net_text(seed * 10 + len(family), v6, n=30)
    inodes = []
    for family, v6 in FAMILIES:
        inodes += [s[3] for s in ref_scan.parse_proc_net(tables[family],
                                                         v6=v6)]
    os.makedirs(os.path.join(root, "net"))
    for family, text in tables.items():
        with open(os.path.join(root, family), "w") as f:
            f.write(text)
    for k, pid in enumerate((101, 202, 303, 404)):
        fd = os.path.join(root, str(pid), "fd")
        os.makedirs(fd)
        with open(os.path.join(root, str(pid), "comm"), "w") as f:
            f.write(f"proc{k}\n")
        mine = rng.choice(len(inodes), size=20, replace=False).tolist()
        for j, i in enumerate(mine):
            os.symlink(f"socket:[{inodes[i]}]", os.path.join(fd, str(j)))
        os.symlink("/dev/null", os.path.join(fd, "99"))
        os.symlink("pipe:[77]", os.path.join(fd, "98"))
    os.makedirs(os.path.join(root, "self"))   # not a pid


def _entries(entries) -> list[tuple]:
    return sorted((e.agent_id, e.pid, bytes(e.ip), e.port, int(e.proto),
                   e.role, e.process_name) for e in entries)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_scan_entries_of_a_proc_tree_like_reference(tmp_path, seed):
    fake_proc(str(tmp_path), seed)
    assert socket_scan.scan_socket_inodes(str(tmp_path)) == \
        ref_scan.scan_socket_inodes(str(tmp_path))
    got = _entries(socket_scan.scan_entries(4, str(tmp_path)))
    assert got == _entries(ref_scan.scan_entries(4, str(tmp_path)))
    assert {e[6] for e in got} <= {"proc0", "proc1", "proc2", "proc3"}
    assert {e[5] for e in got} == {0, 1}   # both roles appear


def _readable() -> bool:
    return os.getpid() in socket_scan.scan_socket_inodes().values()


def test_scan_entries_of_live_listeners_like_reference():
    socks = []
    for fam, kind, addr in ((socket.AF_INET, socket.SOCK_STREAM, "0.0.0.0"),
                            (socket.AF_INET, socket.SOCK_STREAM,
                             "127.0.0.1"),
                            (socket.AF_INET, socket.SOCK_DGRAM, "127.0.0.1"),
                            (socket.AF_INET6, socket.SOCK_STREAM, "::1")):
        s = socket.socket(fam, kind)
        try:
            s.bind((addr, 0))
        except OSError:
            s.close()
            continue
        if kind == socket.SOCK_STREAM:
            s.listen(1)
        socks.append(s)
    try:
        if not _readable():
            pytest.skip("cannot read /proc fds (container restrictions)")
        mine = {s.getsockname()[1] for s in socks}

        def own(entries):
            return [e for e in _entries(entries)
                    if e[1] == os.getpid() and e[3] in mine]
        got = own(socket_scan.scan_entries(7))
        assert got == own(ref_scan.scan_entries(7))
        assert {e[3] for e in got} == mine
    finally:
        for s in socks:
            s.close()


def test_scan_finds_own_listener():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    try:
        if not _readable():
            pytest.skip("cannot read /proc fds (container restrictions)")
        mine = [e for e in socket_scan.scan_entries(agent_id=7)
                if e.port == port and e.pid == os.getpid()]
        assert mine, f"listener :{port} not attributed"
        e = mine[0]
        assert e.role == 1 and e.proto == wire.L4Protocol.TCP
        assert e.process_name and e.agent_id == 7
    finally:
        srv.close()


def test_wildcard_listen_expands_to_local_ips():
    wildcard = socket.socket()
    wildcard.bind(("0.0.0.0", 0))
    wildcard.listen(1)
    port = wildcard.getsockname()[1]
    try:
        if not _readable():
            pytest.skip("cannot read /proc fds (container restrictions)")
        ips = {bytes(e.ip) for e in socket_scan.scan_entries()
               if e.port == port and e.pid == os.getpid()}
        assert ips and b"\x00\x00\x00\x00" not in ips
        assert b"\x7f\x00\x00\x01" in ips
    finally:
        wildcard.close()


def test_gpid_snapshot_eviction_like_reference():
    ip = socket.inet_aton("10.0.0.5")
    other = socket.inet_aton("10.0.0.9")
    steps = [
        (3, [(42, ip, 9090, 1, "webserver"), (43, ip, 54321, 0, "curl")]),
        (3, [(42, ip, 9090, 1, "webserver")]),
        (9, [(7, other, 80, 1, "nginx")]),
        (3, []),
    ]
    port, ref = GpidAllocator(), RefGpids()
    for agent, entries in steps:
        req = pb.GpidSyncRequest(agent_id=agent)
        for pid, addr, p, role, name in entries:
            req.entries.add(pid=pid, ip=addr, port=p, proto=1, role=role,
                            process_name=name)
        data = req.SerializeToString()
        a = port.sync(wire.GpidSyncRequest.FromString(data))
        b = ref.sync(pb.GpidSyncRequest.FromString(data))
        assert a.SerializeToString() == b.SerializeToString()
        for key in ((ip, 54321, 1), (ip, 9090, 1), (other, 80, 1)):
            assert port.name_lookup(*key) == ref.name_lookup(*key)
    assert port.name_lookup(ip, 54321, 1) == (0, "")
    assert port.name_lookup(other, 80, 1)[1] == "nginx"


def test_scanner_uploads_through_the_synchronizer():
    calls = []

    class Sync:
        def gpid_sync(self, entries):
            calls.append(entries)

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        if not _readable():
            pytest.skip("cannot read /proc fds (container restrictions)")
        sc = socket_scan.SocketScanner(Sync(), agent_id=3, interval_s=0.2)
        assert sc.threads == []
        sc.start()
        deadline = time.monotonic() + 5
        while len(calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        sc.stop()
        assert len(calls) >= 2 and sc.stats["scans"] >= 2
        assert sc.stats["entries"] == len(calls[-1]) > 0
        assert sc.stats["scan_ms"] > 0 and sc.stats["errors"] == 0
        assert sc.threads and not sc.threads[0].is_alive()
    finally:
        srv.close()


def _wait(cond, timeout: float = 8.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_unpreloaded_process_flows_carry_identity():
    """A plain child listens; the agent's scan syncs it; an L4 log to
    its port gets its gpid and name at ingest."""
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import socket, sys, time\n"
         "s = socket.socket(); s.bind(('127.0.0.1', 0)); s.listen(4)\n"
         "sys.stdout.write(str(s.getsockname()[1]) + '\\n')\n"
         "sys.stdout.flush()\n"
         "time.sleep(60)\n"],
        stdout=subprocess.PIPE)
    server = Server(host="127.0.0.1", ingest_port=0, query_port=0,
                    sync_port=0, enable_controller=True).start()
    agent = None
    try:
        child_port = int(child.stdout.readline().strip())
        if not _readable():
            pytest.skip("cannot read /proc fds (container restrictions)")
        cfg = AgentConfig()
        cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
        cfg.controller = f"127.0.0.1:{server.controller.port}"
        cfg.profiler.enabled = False
        cfg.tpuprobe.enabled = False
        cfg.guard.enabled = False
        cfg.sync_interval_s = 0.2
        cfg.socket_scan_interval_s = 0.5
        agent = Agent(cfg, device=None).start()
        assert agent.socket_scanner is not None
        assert "socket-scan" in agent._components
        gpids = server.controller.gpids
        assert _wait(lambda: gpids.name_lookup(
            b"\x7f\x00\x00\x01", child_port, 1)[0] != 0)
        entry = gpids.entry_for(b"\x7f\x00\x00\x01", child_port, 1)
        assert entry.pid == child.pid
        batch = wire.FlowLogBatch()
        f = wire.L4FlowLog(flow_id=1, end_time_ns=time.time_ns())
        f.key.ip_src = f.key.ip_dst = socket.inet_aton("127.0.0.1")
        f.key.port_src, f.key.port_dst, f.key.proto = 55555, child_port, 1
        batch.l4.append(f)
        with socket.create_connection(("127.0.0.1",
                                       server.ingest_port)) as s:
            s.sendall(encode_frame(FrameHeader(MessageType.L4_LOG,
                                               agent_id=1),
                                   batch.SerializeToString()))
        assert server.wait_for_rows("flow_log.l4_flow_log", 1, timeout=10)
        r = engine.execute(server.db.table("flow_log.l4_flow_log"),
                           "SELECT gprocess_id_1, process_kname_1 FROM t "
                           f"WHERE port_dst = {child_port}")
        gpid, kname = r.values[0]
        assert gpid == entry.gpid != 0
        with open(f"/proc/{child.pid}/comm") as fh:
            assert kname == fh.read().strip()
    finally:
        if agent:
            agent.stop()
        server.stop()
        child.kill()
        child.wait()


# -- one gpid a process a host -----------------------------------------------

def _sync_req(mod, hostname: str, launcher: str, pid: int):
    """A SyncRequest of ``mod`` (the port's wire or the reference's pb)
    naming one process; ``launcher`` only for the port's."""
    req = pb.SyncRequest(ctrl_ip="10.0.0.1", hostname=hostname,
                         agent_group="default")
    req.processes.add(pid=pid, name="python")
    out = mod.SyncRequest.FromString(req.SerializeToString())
    if launcher:
        out.launcher_id = launcher
    return out


def _scan_req(mod, agent_id: int, pid: int, port: int):
    req = pb.GpidSyncRequest(agent_id=agent_id)
    req.entries.add(agent_id=agent_id, pid=pid,
                    ip=socket.inet_aton("127.0.0.1"), port=port, proto=1,
                    role=0, process_name="python")
    return mod.GpidSyncRequest.FromString(req.SerializeToString())


def test_one_process_seen_by_two_agents_of_a_host_has_one_gpid():
    """A training process reports itself through its runner agent
    (``processes``), and the host's node agent and the runner agent both
    scan it. The port's registry gives the two agents of one host two
    ids (the launcher identity), so the reference's key, (agent, pid),
    would give the pid two gpids and flip a flow's gpid with the last
    scan to sync (shown with the reference's allocator on the same ids).
    The port keys by the host: one gpid."""
    pid = 31337
    ctl = Controller(PlatformInfoTable(), port=0)
    runner = ctl.Sync(_sync_req(wire, "gpu-host", "job/0", pid), None)
    node = ctl.Sync(_sync_req(wire, "gpu-host", "", os.getpid()), None)
    assert runner.agent_id != node.agent_id
    from_runner = ctl.gpids.gpid_for(runner.agent_id, pid)
    by_node = ctl.GpidSync(_scan_req(wire, node.agent_id, pid, 41000), None)
    by_runner = ctl.GpidSync(_scan_req(wire, runner.agent_id, pid, 41000),
                             None)
    assert from_runner == by_node.entries[0].gpid == \
        by_runner.entries[0].gpid != 0
    assert ctl.gpids.name_lookup(socket.inet_aton("127.0.0.1"), 41000, 1) \
        == (from_runner, "python")
    ref = RefGpids()   # the reference's key on the same two agent ids
    assert ref.gpid_for(runner.agent_id, pid) != \
        ref.gpid_for(node.agent_id, pid)


def test_agents_of_two_hosts_keep_their_own_gpids():
    ctl = Controller(PlatformInfoTable(), port=0)
    h1 = ctl.Sync(_sync_req(wire, "host-1", "", 1), None)
    h2 = ctl.Sync(_sync_req(wire, "host-2", "", 1), None)
    assert ctl.gpids.gpid_for(h1.agent_id, 1) != \
        ctl.gpids.gpid_for(h2.agent_id, 1)


def test_a_node_agent_alone_gets_the_references_gpids():
    """One agent a host: the port's gpids are the reference's."""
    pids = [5, 9, 5, 12, 9, 40]
    out = []
    for ctl, mod in ((Controller(PlatformInfoTable(), port=0), wire),
                     (RefController(RefPlatform(), port=0), pb)):
        aid = ctl.Sync(_sync_req(mod, "host-a", "", 77), None).agent_id
        seq = [ctl.gpids.gpid_for(aid, 77)]
        for k, p in enumerate(pids):
            resp = ctl.GpidSync(_scan_req(mod, aid, p, 40000 + k), None)
            seq.append(resp.entries[0].gpid)
        out.append(seq)
    assert out[0] == out[1]


def test_gpid_is_kept_for_an_agent_that_never_registered():
    port, ref = GpidAllocator(), RefGpids()
    for pid in (3, 4, 3):
        assert port.gpid_for(6, pid) == ref.gpid_for(6, pid)
    port.set_host(6, ("10.0.0.1", "h"))
    assert port.gpid_for(6, 3) != ref.gpid_for(6, 3)  # now a host's pid
    port.set_host(8, ("10.0.0.1", "h"))
    assert port.gpid_for(8, 3) == port.gpid_for(6, 3)


def test_proc_net_inodes_match_this_process_fds():
    """The check the card's phase makes first: /proc/net/tcp lists this
    process's listener with the inode its /proc/<pid>/fd holds."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        with open("/proc/net/tcp") as f:
            socks = socket_scan.parse_proc_net(f.read())
        port = srv.getsockname()[1]
        listed = {inode for ip, p, st, inode in socks if p == port}
        fds = socket_scan.scan_socket_inodes()
        mine = {i for i, p in fds.items() if p == os.getpid()}
        if not mine:
            pytest.skip("cannot read /proc fds (container restrictions)")
        assert listed and listed <= mine
    finally:
        srv.close()
