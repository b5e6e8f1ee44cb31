"""Framed TCP receiver with per-message-type decoder queues and acks.

Own copy of the TCP path of ``deepflow_tpu/server/receiver.py::Receiver``:
one listener, one ``StreamDecoder`` per connection, and the frames of each
recv() handed to the queue that ``register`` returned for their message
type. A corrupt frame drops its connection and counts in
``stats["bad_frames"]``.

Durable delivery: v2 frames carry a per-agent ``seq``. ``SeqAckTracker``
keeps the highest contiguous seq per agent; the decoders feed it after a
frame's rows are written, so an acked frame has reached the store (with
``--storage`` the flusher feeds it after the commit that made the rows
durable, and a restart ``seed``s it from the persisted floors). Each
connection writes an ACK frame back whenever an agent's watermark moved.
A SEQ_BASE control frame moves the watermark (and the dedup floor) up to
the base the agent announced. The ``receiver`` hop of the server's
``Telemetry`` accounts every frame (delivered to a decoder queue, or
dropped with its reason), the accept loop beats a ``receiver``
heartbeat, and DF_CHAOS may stall a new connection before its first
read. QoS and UDP are not part of this copy.
"""

from __future__ import annotations

import logging
import queue
import socket
import socketserver
import threading
import time

from deepflow_tpu_torch.chaos import chaos_from_env
from deepflow_tpu_torch.codec import (
    FrameDecodeError, FrameHeader, MessageType, StreamDecoder,
    decode_seq_base, encode_ack)
from deepflow_tpu_torch.telemetry import Telemetry

log = logging.getLogger("df.receiver")


class SeqAckTracker:
    """Per-agent highest-contiguous-seq bookkeeping.

    ``observe()`` is called for every decoded v2 frame; ``contiguous()``
    is what gets acked. Seqs above a gap park in a bounded set until the
    gap fills; if the set overflows, the gap is declared permanent and
    the watermark jumps to the oldest parked seq."""

    MAX_OOS = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # agent_id -> [contiguous seq, set of parked seqs above it]
        self._state: dict[int, list] = {}

    def seed(self, agent_id: int, contiguous: int) -> None:
        """Restore a persisted watermark (a restart with a data dir)."""
        with self._lock:
            st = self._state.get(agent_id)
            if st is None or contiguous > st[0]:
                self._state[agent_id] = [contiguous, set()]

    def advance(self, agent_id: int, contiguous: int) -> None:
        """Forward-only watermark jump (SEQ_BASE): parked seqs at or below
        it are absorbed, and parked seqs just above drain into it."""
        with self._lock:
            st = self._state.get(agent_id)
            if st is None:
                self._state[agent_id] = [contiguous, set()]
                return
            contig, oos = st
            if contiguous <= contig:
                return
            contig = contiguous
            oos.difference_update({s for s in oos if s <= contig})
            while contig + 1 in oos:
                contig += 1
                oos.discard(contig)
            st[0] = contig

    def observe(self, agent_id: int, seq: int) -> None:
        with self._lock:
            st = self._state.get(agent_id)
            if st is None:
                # an agent's first frame anchors its window
                self._state[agent_id] = [seq, set()]
                return
            contig, oos = st
            if seq <= contig:
                return  # dup or old
            if seq == contig + 1:
                contig += 1
                while contig + 1 in oos:
                    contig += 1
                    oos.discard(contig)
                st[0] = contig
                return
            oos.add(seq)
            if len(oos) > self.MAX_OOS:
                contig = min(oos)
                oos.discard(contig)
                while contig + 1 in oos:
                    contig += 1
                    oos.discard(contig)
                st[0] = contig

    def parked(self) -> dict[int, list[int]]:
        """Per agent, the seqs held above its watermark (a gap below)."""
        with self._lock:
            return {a: sorted(st[1]) for a, st in self._state.items()
                    if st[1]}

    def contiguous(self, agent_id: int) -> int | None:
        with self._lock:
            st = self._state.get(agent_id)
            return st[0] if st is not None else None

    def snapshot(self) -> dict[int, int]:
        with self._lock:
            return {a: st[0] for a, st in self._state.items()}


class Receiver:
    """Listens on TCP and fans frames out to registered queues."""

    def __init__(self, host: str = "127.0.0.1", port: int = 20033,
                 queue_size: int = 4096,
                 telemetry: Telemetry | None = None) -> None:
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
        self.seq_tracker = SeqAckTracker()
        # the server's shared DedupWindow: SEQ_BASE advances its floor too
        self.dedup = None
        # recv_ns: wall time parsing frames out of recv chunks and
        # enqueueing them
        self.stats = {"frames": 0, "bytes": 0, "dropped": 0, "bad_frames": 0,
                      "connections": 0, "acks_sent": 0, "seq_bases": 0,
                      "recv_ns": 0}
        self._stats_lock = threading.Lock()
        self._chaos = chaos_from_env()
        self.telemetry = telemetry or Telemetry("server", enabled=False)
        self._hop = self.telemetry.hop("receiver")

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
        full queue, is dropped and counted. A frame of no registered type
        is acked all the same (a resend would meet the same fate); a frame
        dropped on a full queue is not, so the agent sends it again."""
        by_type: dict[MessageType, list] = {}
        for header, payload in frames:
            by_type.setdefault(header.msg_type, []).append((header, payload))
        self._hop.account(emitted=len(frames))
        enq_ns = time.monotonic_ns()
        dropped = 0
        for msg_type, group in by_type.items():
            q = self._queues.get(msg_type)
            if q is None:
                dropped += len(group)
                self._hop.account(dropped=len(group), reason="no_handler")
                for header, _ in group:
                    if header.seq is not None:
                        self.seq_tracker.observe(header.agent_id, header.seq)
                continue
            try:
                q.put_nowait((enq_ns, group))
                self._hop.account(delivered=len(group))
            except queue.Full:
                dropped += len(group)
                self._hop.account(dropped=len(group), reason="queue_full")
        self._count(frames=len(frames),
                    bytes=sum(len(p) for _, p in frames), dropped=dropped)

    def _handle_seq_base(self, header: FrameHeader, payload: bytes) -> None:
        """SEQ_BASE: the agent will never (re)send a seq below base, so
        the watermark and the dedup floor move up to base - 1. Moving the
        floor is safe: acked means decoded, so nothing below the base
        still waits in a decoder queue."""
        try:
            base = decode_seq_base(payload)
        except FrameDecodeError:
            self._count(bad_frames=1)
            return
        self._count(seq_bases=1)
        if base <= 0:
            return
        self.seq_tracker.advance(header.agent_id, base - 1)
        if self.dedup is not None:
            self.dedup.advance_floor(header.agent_id, base - 1)

    def _send_acks(self, sock: socket.socket, agents: set[int],
                   last_sent: dict[int, int]) -> None:
        """One ACK frame per agent seen on this connection whose
        contiguous watermark moved since the last one."""
        for agent_id in agents:
            contig = self.seq_tracker.contiguous(agent_id)
            if contig is None or last_sent.get(agent_id) == contig:
                continue
            try:
                sock.sendall(encode_ack(agent_id, contig))
            except OSError:
                return  # peer gone; the read path notices and closes
            last_sent[agent_id] = contig
            self._count(acks_sent=1)

    def _serve(self, sock: socket.socket) -> None:
        if self._chaos is not None:
            self._chaos.on_accept()
        dec = StreamDecoder()
        # a short read timeout: wake up to notice stop(), and to write
        # acks while the peer is quiet
        sock.settimeout(0.5)
        agents: set[int] = set()      # agents with seq'd frames here
        acks_sent: dict[int, int] = {}
        idle_deadline = time.monotonic() + 60.0
        while not self._stopping:
            try:
                data = sock.recv(256 << 10)
            except socket.timeout:
                if time.monotonic() > idle_deadline:
                    return
                self._send_acks(sock, agents, acks_sent)
                continue
            except OSError:
                return
            if not data:
                return
            idle_deadline = time.monotonic() + 60.0
            t0 = time.perf_counter_ns()
            try:
                frames = []
                for h, p in dec.feed(data):
                    if h.msg_type == MessageType.SEQ_BASE:
                        # a control frame, handled here; the agent gets
                        # acks from now on
                        self._handle_seq_base(h, p)
                        agents.add(h.agent_id)
                        continue
                    frames.append((h, p))
                    if h.seq is not None:
                        agents.add(h.agent_id)
                if frames:
                    self._dispatch_many(frames)
            except FrameDecodeError as e:
                self._count(bad_frames=1)
                self._hop.account(emitted=1, dropped=1, reason="bad_frame")
                log.warning("dropping connection: %s", e)
                return
            finally:
                self._count(recv_ns=time.perf_counter_ns() - t0)
            # ack eagerly; the moved-watermark check limits the rate. A
            # seq-less (v1) peer is never written to.
            self._send_acks(sock, agents, acks_sent)

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

        # beaten from the accept loop, whose thread the deadman's stack
        # snapshot must name
        hb = self.telemetry.heartbeat("receiver", interval_hint_s=0.5)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def service_actions(self) -> None:
                # serve_forever calls this every poll (~0.5 s)
                hb.beat(progress=recv.stats["frames"])

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
