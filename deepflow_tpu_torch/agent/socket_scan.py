"""Socket inodes -> processes: every flow endpoint on the host gets its
pid and process name, with no cooperation from the process.

Own copy of ``deepflow_tpu/agent/socket_scan.py``, whole (reference
analog: agent/src/platform/platform_synchronizer/linux_socket.rs:95).
``scan_socket_inodes`` walks ``/proc/<pid>/fd`` for socket inodes;
``parse_proc_net`` reads ``/proc/net/{tcp,tcp6,udp,udp6}``; and
``scan_entries`` joins them into ``GpidEntry`` 5-tuples carrying each
pid's ``/proc/<pid>/comm``. A LISTEN socket, and an established one on a
port its pid also listens on, is the server side (role 1); a bound UDP
socket serves its port; anything else is a client (role 0). A wildcard
bind (0.0.0.0 or ::) expands into the host's concrete local addresses,
so the controller's join stays an exact match. ``SocketScanner`` scans
on a thread of its own, first a second after its start and then every
``interval_s``, and uploads each scan through the synchronizer's
``gpid_sync``; ``stats["scan_ms"]`` is the last scan's wall time.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time

from deepflow_tpu_torch.proto import wire

log = logging.getLogger("df.socketscan")

_TCP, _UDP = int(wire.L4Protocol.TCP), int(wire.L4Protocol.UDP)

# /proc/net/tcp state column
_TCP_LISTEN = 0x0A


def _parse_hex_addr4(s: str) -> tuple[bytes, int]:
    """'0100007F:1F90' -> (b'\\x7f\\x00\\x00\\x01', 8080). The kernel
    prints the address as little-endian u32 hex."""
    ip_hex, port_hex = s.split(":")
    return struct.pack("<I", int(ip_hex, 16)), int(port_hex, 16)


def _parse_hex_addr6(s: str) -> tuple[bytes, int]:
    """v6 addresses print as 4 little-endian u32 words."""
    ip_hex, port_hex = s.split(":")
    words = [int(ip_hex[i:i + 8], 16) for i in range(0, 32, 8)]
    return struct.pack("<4I", *words), int(port_hex, 16)


def parse_proc_net(text: str, v6: bool = False
                   ) -> list[tuple[bytes, int, int, int]]:
    """Parse /proc/net/{tcp,tcp6,udp} content ->
    [(local_ip, local_port, state, inode)]."""
    out = []
    parse = _parse_hex_addr6 if v6 else _parse_hex_addr4
    for line in text.splitlines()[1:]:
        parts = line.split()
        if len(parts) < 10:
            continue
        try:
            ip, port = parse(parts[1])
            state = int(parts[3], 16)
            inode = int(parts[9])
        except (ValueError, IndexError):
            continue
        out.append((ip, port, state, inode))
    return out


def scan_socket_inodes(proc_root: str = "/proc") -> dict[int, int]:
    """inode -> pid for every socket fd on the host. Requires the same
    privileges the extprofiler already needs (root or same-user)."""
    out: dict[int, int] = {}
    try:
        pids = [p for p in os.listdir(proc_root) if p.isdigit()]
    except OSError:
        return out
    for p in pids:
        fd_dir = f"{proc_root}/{p}/fd"
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue  # raced exit or not ours
        for fd in fds:
            try:
                target = os.readlink(f"{fd_dir}/{fd}")
            except OSError:
                continue
            if target.startswith("socket:["):
                try:
                    out[int(target[8:-1])] = int(p)
                except ValueError:
                    pass
    return out


def _comm(pid: int, proc_root: str = "/proc") -> str:
    try:
        with open(f"{proc_root}/{pid}/comm") as f:
            return f.read().strip()
    except OSError:
        return ""


def scan_entries(agent_id: int = 0, proc_root: str = "/proc"
                 ) -> list[wire.GpidEntry]:
    """One full scan -> GpidEntry batch.

    Role assignment: LISTEN sockets are servers; an established socket
    whose local port is also LISTENed by the same pid is the accept()ed
    server side; everything else is a client endpoint. v6 entries ride
    with their 16-byte address (the ingester keys joins by raw ip bytes).
    """
    inode_pid = scan_socket_inodes(proc_root)
    entries: list[wire.GpidEntry] = []
    seen: set[tuple] = set()
    names: dict[int, str] = {}
    _ANY4, _ANY6 = b"\x00" * 4, b"\x00" * 16

    def add(ip: bytes, port: int, proto: int, role: int, pid: int) -> None:
        key = (ip, port, proto, role, pid)
        if key in seen:
            return
        seen.add(key)
        name = names.get(pid)
        if name is None:
            name = names[pid] = _comm(pid, proc_root)
        entries.append(wire.GpidEntry(
            agent_id=agent_id, pid=pid, ip=ip, port=port,
            proto=proto, role=role, process_name=name))

    # wildcard binds (0.0.0.0/::) are expanded into the CONCRETE local
    # addresses observed on this host's sockets, so the controller join
    # stays exact-match — a server-side "wildcard matches any ip"
    # fallback would misattribute flows toward REMOTE endpoints on the
    # same port to the local listener
    local4: set[bytes] = {struct.pack("<I", 0x0100007F)}   # 127.0.0.1
    local6: set[bytes] = {b"\x00" * 15 + b"\x01"}          # ::1
    families = (("net/tcp", _TCP, False), ("net/tcp6", _TCP, True),
                ("net/udp", _UDP, False), ("net/udp6", _UDP, True))
    parsed = []
    for path, proto, v6 in families:
        try:
            with open(f"{proc_root}/{path}") as f:
                socks = parse_proc_net(f.read(), v6=v6)
        except OSError:
            socks = []
        parsed.append(socks)
        for ip, _port, _state, _inode in socks:
            if v6 and ip != _ANY6:
                local6.add(ip)
            elif not v6 and ip != _ANY4:
                local4.add(ip)

    for (path, proto, v6), socks in zip(families, parsed):
        listen_ports: dict[int, set[int]] = {}  # pid -> listening ports
        if proto == _TCP:
            for ip, port, state, inode in socks:
                pid = inode_pid.get(inode)
                if pid is not None and state == _TCP_LISTEN:
                    listen_ports.setdefault(pid, set()).add(port)
        for ip, port, state, inode in socks:
            pid = inode_pid.get(inode)
            if pid is None:
                continue
            if proto == _TCP:
                role = 1 if (state == _TCP_LISTEN
                             or port in listen_ports.get(pid, ())) else 0
            else:
                role = 1  # bound UDP sockets serve their local port
            is_any = ip == (_ANY6 if v6 else _ANY4)
            if is_any:
                for addr in (local6 if v6 else local4):
                    add(bytes(addr), port, proto, role, pid)
            else:
                add(bytes(ip), port, proto, role, pid)
    return entries


class SocketScanner:
    """Periodic scan -> GpidSync upload over the sync plane."""

    def __init__(self, synchronizer, agent_id: int = 0,
                 interval_s: float = 30.0,
                 proc_root: str = "/proc") -> None:
        self.synchronizer = synchronizer
        self.agent_id = agent_id
        self.interval_s = interval_s
        self.proc_root = proc_root
        self.stats = {"scans": 0, "entries": 0, "errors": 0,
                      "scan_ms": 0.0}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def threads(self) -> list[threading.Thread]:
        """The scan's thread (the agent's Guard charges its CPU)."""
        return [self._thread] if self._thread is not None else []

    def start(self) -> "SocketScanner":
        self._thread = threading.Thread(
            target=self._run, name="df-socket-scan", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3.0)

    def scan_once(self) -> int:
        t0 = time.monotonic()
        entries = scan_entries(self.agent_id, self.proc_root)
        self.stats["scan_ms"] = (time.monotonic() - t0) * 1000.0
        self.stats["scans"] += 1
        self.stats["entries"] = len(entries)
        if entries:
            self.synchronizer.gpid_sync(entries)
        log.debug("socket scan: %d entries in %.0fms", len(entries),
                  self.stats["scan_ms"])
        return len(entries)

    def _run(self) -> None:
        # first scan quickly so fresh agents attribute flows within
        # seconds; then settle onto the configured cadence
        if self._stop.wait(1.0):
            return
        while not self._stop.is_set():
            try:
                self.scan_once()
            except Exception:
                self.stats["errors"] += 1
                log.exception("socket scan failed")
            if self._stop.wait(self.interval_s):
                return
