"""Live packet capture: a TPACKET_V3 mmap ring or an AF_PACKET SOCK_RAW
loop -> the dispatcher's flow map.

Own copy of ``deepflow_tpu/agent/live_capture.py``. With the native
engine the ring (``native_flow.NativeRing``) feeds the C++ map straight:
frames never become Python objects. A kernel that maps no ring on the
interface (``setsockopt`` answers EINVAL, ENOPROTOOPT or EOPNOTSUPP, as
some container runtimes' kernels do) gets the SOCK_RAW loop: one thread
receives frames into batches and a second hands them to the native map
(where L7 parsing holds the interpreter lock), so the socket is drained
while payloads parse; ``mode`` and ``stats["ring_unsupported"]`` say
which ran and why. Frames the kernel dropped for the socket, or a full
hand-off queue, count in ``stats["drops"]``. The Python engine takes the
SOCK_RAW loop into the Python map, as in the reference. Any other
failure to open (no CAP_NET_RAW, no such interface, no AF_PACKET on this
OS) raises: nothing degrades silently.

The feedback guard: the agent's own telemetry to the ingester and the
server's ports are excluded (``exclude_ports``), else capturing the
sender's traffic makes flows that make more sender traffic. The capture
modes are the reference's: ``local`` (this host's own traffic, exclusions
on), ``mirror`` (a SPAN port carrying other hosts' traffic: promiscuous,
exclusions on) and ``analyzer`` (a dedicated analyzer NIC fed by remote
TAPs: promiscuous, no exclusions). ``exclude_port`` adds a port while
the capture runs (an NPB target pushed with its ACL).

The SOCK_RAW loop runs the dispatcher's ``packet_actions`` (the ACL's
pcap and NPB actions) on each frame that is not excluded, before the
frame reaches the map; the ring's frames never surface in Python, so a
ring capture runs none (reference: live_capture.py:184-189). Reference analog:
agent/src/dispatcher/recv_engine (AF_PACKET capture, recv_engine/mod.rs:40).
This module loads no torch.
"""

from __future__ import annotations

import errno
import logging
import queue
import socket
import struct
import threading
import time

from deepflow_tpu_torch.agent.packet import decode_ethernet

log = logging.getLogger("df.live-capture")

ETH_P_ALL = 0x0003
SOL_PACKET = 263
PACKET_ADD_MEMBERSHIP = 1
PACKET_STATISTICS = 6
PACKET_MR_PROMISC = 1
CAPTURE_MODES = ("local", "mirror", "analyzer")
# errnos of a kernel that has AF_PACKET but maps no ring for it
RING_UNSUPPORTED = frozenset((errno.EINVAL, errno.ENOPROTOOPT,
                              errno.EOPNOTSUPP))
# the SOCK_RAW loop hands the native map a batch at this many frames, or
# after this long
SOCKET_BATCH = 256
SOCKET_BATCH_S = 0.05
SOCKET_QUEUE = 4096            # batches between the two socket threads
SOCKET_RCVBUF = 64 << 20       # asked for; the kernel may grant less
SO_RCVBUFFORCE = 33            # past rmem_max, with CAP_NET_ADMIN


class LiveCapture:
    def __init__(self, dispatcher, interface: str = "",
                 exclude_ports: tuple = (20033, 20035, 20416),
                 snaplen: int = 65535, capture_mode: str = "local") -> None:
        if capture_mode not in CAPTURE_MODES:
            raise ValueError(f"capture_mode must be one of {CAPTURE_MODES}, "
                             f"got {capture_mode!r}")
        self.dispatcher = dispatcher
        self.interface = interface  # "" = all interfaces
        self.capture_mode = capture_mode
        if capture_mode == "analyzer":
            if not interface:
                log.warning("analyzer mode without an interface captures "
                            "ALL NICs including this host's own; set "
                            "flow.interface to the analyzer port")
            # the analyzer NIC never carries this host's own telemetry,
            # and dropping the monitored fleet's port-20033 traffic would
            # blind it to the infrastructure it watches
            exclude_ports = ()
        self.exclude_ports = frozenset(exclude_ports)
        self.snaplen = snaplen
        self._sock: socket.socket | None = None
        self._ring = None
        self._thread: threading.Thread | None = None
        self._inject_thread: threading.Thread | None = None
        self._batches: queue.Queue = queue.Queue(SOCKET_QUEUE)
        self._stop = threading.Event()
        self.mode = "none"
        self.stats = {"frames": 0, "injected": 0, "excluded": 0,
                      "undecoded": 0, "drops": 0, "rcvbuf": 0,
                      "ring_unsupported": ""}

    @property
    def threads(self) -> list[threading.Thread]:
        """The capture's threads (the agent's Guard charges their CPU)."""
        return [t for t in (self._thread, self._inject_thread)
                if t is not None]

    def start(self) -> "LiveCapture":
        nfm = self.dispatcher.native_map
        if nfm is not None:
            from deepflow_tpu_torch.agent.native_flow import NativeRing
            try:
                self._ring = NativeRing(self.interface)
            except OSError as e:
                if e.errno not in RING_UNSUPPORTED:
                    raise
                self.stats["ring_unsupported"] = errno.errorcode[e.errno]
                log.info("no TPACKET_V3 ring on %r (%s): capturing with "
                         "SOCK_RAW into the native map",
                         self.interface or "all", e.strerror)
            for port in self.exclude_ports:
                nfm.exclude_port(port)
        if self._ring is not None:
            if self.capture_mode != "local" and self.interface and \
                    not self._ring.promisc(self.interface):
                log.warning("promiscuous mode failed on %r; %s capture "
                            "sees only local traffic", self.interface,
                            self.capture_mode)
            self.mode = "ring"
            target = self._run_ring
        else:
            self._sock = self._open_socket()
            self.mode = "socket"
            target = self._run_socket
            self._inject_thread = threading.Thread(
                target=self._run_inject, name="df-live-inject", daemon=True)
            self._inject_thread.start()
        self._thread = threading.Thread(
            target=target, name="df-live-capture", daemon=True)
        self._thread.start()
        log.info("live capture (%s, %s mode) on %r (excluding ports %s)",
                 self.mode, self.capture_mode, self.interface or "all",
                 sorted(self.exclude_ports))
        return self

    def _open_socket(self) -> socket.socket:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                          socket.htons(ETH_P_ALL))
        try:
            if self.interface:
                s.bind((self.interface, 0))
                if self.capture_mode != "local":
                    idx = socket.if_nametoindex(self.interface)
                    mreq = struct.pack("iHH8s", idx, PACKET_MR_PROMISC, 0,
                                       b"")
                    try:
                        s.setsockopt(SOL_PACKET, PACKET_ADD_MEMBERSHIP,
                                     mreq)
                    except OSError as e:
                        log.warning("promiscuous mode failed: %s", e)
            try:
                s.setsockopt(socket.SOL_SOCKET, SO_RCVBUFFORCE,
                             SOCKET_RCVBUF)
            except PermissionError:  # no CAP_NET_ADMIN: up to rmem_max
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                             SOCKET_RCVBUF)
            self.stats["rcvbuf"] = s.getsockopt(socket.SOL_SOCKET,
                                                socket.SO_RCVBUF)
            s.settimeout(SOCKET_BATCH_S)
        except BaseException:
            s.close()
            raise
        return s

    def _run_ring(self) -> None:
        nfm = self.dispatcher.native_map
        ring = self._ring
        # the dispatcher's flush loop ticks the same native map: every
        # map access holds its lock (the C++ side is single-threaded)
        lock = self.dispatcher._lock
        prev_excluded = nfm.stats["excluded"]
        while not self._stop.is_set():
            try:
                with lock:
                    n = nfm.ring_rx(ring, timeout_ms=0)
                if n == 0:
                    # poll outside the lock so a flush never waits on it
                    self._stop.wait(0.05)
                    continue
                excluded = nfm.stats["excluded"]
                self.stats["frames"] += n
                self.stats["injected"] += n - (excluded - prev_excluded)
                self.stats["excluded"] += excluded - prev_excluded
                prev_excluded = excluded
                self.stats["drops"] += ring.drops()
            except Exception:
                log.exception("ring rx failed")
                return

    def exclude_port(self, port: int) -> None:
        """Exclude one more port from capture, at once."""
        if port in self.exclude_ports or self.capture_mode == "analyzer":
            return
        self.exclude_ports = self.exclude_ports | {port}
        nfm = self.dispatcher.native_map
        if nfm is not None:
            with self.dispatcher._lock:
                nfm.exclude_port(port)

    def _packet_actions(self, batch: list) -> None:
        """The ACL's packet actions on a received batch's frames, the
        excluded ports' left out (an NPB target's own datagrams never
        loop back into the forwarding)."""
        pa = self.dispatcher.packet_actions
        if pa is None or not pa.enabled():
            return
        excluded = self.exclude_ports
        for frame, ts_ns in batch:
            mp = decode_ethernet(frame, timestamp_ns=ts_ns)
            if mp is None or mp.port_src in excluded or \
                    mp.port_dst in excluded:
                continue
            try:
                pa.handle_meta(mp, frame)
            except Exception:
                log.exception("packet action failed")

    def _socket_drops(self) -> int:
        """Frames the kernel dropped for this socket since the last read
        (struct tpacket_stats)."""
        try:
            raw = self._sock.getsockopt(SOL_PACKET, PACKET_STATISTICS, 8)
        except OSError as e:
            self.stats["drops_unreadable"] = errno.errorcode.get(
                e.errno, str(e.errno))
            return 0
        return struct.unpack("II", raw)[1]

    def _run_socket(self) -> None:
        """Receive frames into batches of (frame, ts_ns) for the inject
        thread: a batch goes at SOCKET_BATCH frames or SOCKET_BATCH_S."""
        sock = self._sock
        batch: list = []
        due = time.monotonic() + SOCKET_BATCH_S
        while not self._stop.is_set():
            frame = None
            try:
                frame, addr = sock.recvfrom(self.snaplen)
            except socket.timeout:
                pass
            except OSError:
                break
            if frame is not None:
                # keep both directions but one copy of loopback traffic
                # (lo delivers every frame as an in and an out copy)
                if addr[0] == "lo" and addr[2] == socket.PACKET_OUTGOING:
                    continue
                self.stats["frames"] += 1
                batch.append((frame, time.time_ns()))
            now = time.monotonic()
            if batch and (len(batch) >= SOCKET_BATCH or frame is None
                          or now >= due):
                try:
                    self._batches.put_nowait(batch)
                except queue.Full:
                    self.stats["drops"] += len(batch)
                batch = []
            if frame is None or now >= due:
                self.stats["drops"] += self._socket_drops()
                due = now + SOCKET_BATCH_S
        if batch:
            self._batches.put(batch)
        self._batches.put(None)  # the inject thread ends after the rest

    def _run_inject(self) -> None:
        """Hand each received batch to the flow map."""
        nfm = self.dispatcher.native_map
        prev_excluded = nfm.stats["excluded"] if nfm is not None else 0
        while True:
            batch = self._batches.get()
            if batch is None:
                return
            if nfm is None:
                for frame, ts_ns in batch:
                    self._inject_python(frame, ts_ns)
                continue
            self._packet_actions(batch)
            try:
                self.dispatcher.inject_frames(batch)
            except Exception:
                log.exception("native inject failed")
                return
            excluded = nfm.stats["excluded"]
            self.stats["injected"] += len(batch) - (excluded - prev_excluded)
            self.stats["excluded"] += excluded - prev_excluded
            prev_excluded = excluded

    def _inject_python(self, frame: bytes, ts_ns: int) -> None:
        mp = decode_ethernet(frame, timestamp_ns=ts_ns)
        if mp is None:
            self.stats["undecoded"] += 1
            return
        if mp.port_src in self.exclude_ports or \
                mp.port_dst in self.exclude_ports:
            self.stats["excluded"] += 1
            return
        pa = self.dispatcher.packet_actions
        if pa is not None and pa.enabled():
            try:
                pa.handle_meta(mp, frame)  # the decode above, reused
            except Exception:
                log.exception("packet action failed")
        self.dispatcher.inject(mp)
        self.stats["injected"] += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)
        if self._inject_thread:
            self._inject_thread.join(timeout=30.0)
        if self._ring is not None:
            if self._thread is not None and self._thread.is_alive():
                # never free the ring under a live rx thread (use after
                # free); leaking it is the safe failure
                log.warning("ring thread did not exit; leaking ring handle")
            else:
                self._ring.close()
            self._ring = None
        nfm = self.dispatcher.native_map
        if nfm is not None:
            for port in self.exclude_ports:  # don't bleed into a replay
                nfm.exclude_port(port, on=False)
        if self._sock:
            self._sock.close()
            self._sock = None
