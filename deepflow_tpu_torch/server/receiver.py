"""Framed TCP receiver with per-message-type decoder queues.

Own copy of the TCP path of ``deepflow_tpu/server/receiver.py::Receiver``:
one listener, one ``StreamDecoder`` per connection, and the frames of each
recv() handed to the queue that ``register`` returned for their message
type. A corrupt frame drops its connection and counts in
``stats["bad_frames"]``. There are no acks, sequence numbers, QoS or UDP.
"""

from __future__ import annotations

import logging
import queue
import socket
import socketserver
import threading
import time

from deepflow_tpu_torch.codec import (
    FrameDecodeError, FrameHeader, MessageType, StreamDecoder)

log = logging.getLogger("df.receiver")


class Receiver:
    """Listens on TCP and fans frames out to registered queues."""

    def __init__(self, host: str = "127.0.0.1", port: int = 20033,
                 queue_size: int = 4096) -> None:
        self.host = host
        self.port = port
        self._queues: dict[MessageType, queue.Queue] = {}
        self._queue_size = queue_size
        self._tcp: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None
        # live handler (thread, socket) pairs: stop() closes their sockets
        # and waits for them, so no handler enqueues after the decoders
        # drained
        self._handlers_lock = threading.Lock()
        self._handlers: dict[threading.Thread, socket.socket] = {}
        self._stopping = False
        # recv_ns: wall time parsing frames out of recv chunks and
        # enqueueing them
        self.stats = {"frames": 0, "bytes": 0, "dropped": 0, "bad_frames": 0,
                      "connections": 0, "recv_ns": 0}
        self._stats_lock = threading.Lock()

    def register(self, msg_type: MessageType) -> queue.Queue:
        """The decoder queue for one message type."""
        q = self._queues.get(msg_type)
        if q is None:
            q = self._queues[msg_type] = queue.Queue(maxsize=self._queue_size)
        return q

    def _count(self, **deltas: int) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def _dispatch_many(self, frames: list[tuple[FrameHeader, bytes]]) -> None:
        """Hand the frames of one recv() to their decoder queues with one
        put per message type. A frame with no registered decoder, or a
        full queue, is dropped and counted."""
        by_type: dict[MessageType, list] = {}
        for header, payload in frames:
            by_type.setdefault(header.msg_type, []).append((header, payload))
        dropped = 0
        for msg_type, group in by_type.items():
            q = self._queues.get(msg_type)
            try:
                if q is None:
                    raise queue.Full
                q.put_nowait(group)
            except queue.Full:
                dropped += len(group)
        self._count(frames=len(frames),
                    bytes=sum(len(p) for _, p in frames), dropped=dropped)

    def _serve(self, sock: socket.socket) -> None:
        dec = StreamDecoder()
        sock.settimeout(0.5)  # wake up to notice stop()
        idle_deadline = time.monotonic() + 60.0
        while not self._stopping:
            try:
                data = sock.recv(256 << 10)
            except socket.timeout:
                if time.monotonic() > idle_deadline:
                    return
                continue
            except OSError:
                return
            if not data:
                return
            idle_deadline = time.monotonic() + 60.0
            t0 = time.perf_counter_ns()
            try:
                frames = dec.feed(data)
                if frames:
                    self._dispatch_many(frames)
            except FrameDecodeError as e:
                self._count(bad_frames=1)
                log.warning("dropping connection: %s", e)
                return
            finally:
                self._count(recv_ns=time.perf_counter_ns() - t0)

    def start(self) -> "Receiver":
        recv = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                recv._count(connections=1)
                me = threading.current_thread()
                with recv._handlers_lock:
                    if recv._stopping:
                        return
                    recv._handlers[me] = self.request
                try:
                    recv._serve(self.request)
                finally:
                    with recv._handlers_lock:
                        recv._handlers.pop(me, None)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((self.host, self.port), Handler)
        self.port = self._tcp.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        name="df-receiver-tcp", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # no new handlers, kick the live ones off their sockets, then WAIT
        # for them: only then may the caller drain the decoder queues
        with self._handlers_lock:
            self._stopping = True
            live = list(self._handlers.items())
        if self._tcp:
            self._tcp.shutdown()
            self._tcp.server_close()
            self._tcp = None
        for _, sock in live:
            try:
                sock.close()
            except OSError:
                pass
        for t, _ in live:
            t.join(timeout=2.0)
