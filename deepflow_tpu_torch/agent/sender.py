"""UniformSender: the agent's durable, reconnecting TCP frame sender.

Own copy of ``deepflow_tpu/agent/sender.py::UniformSender`` with its
on-disk spool, fault injection and hop ledger. Every frame carries a
per-agent ``seq`` (codec v2). The server writes ACK frames (the highest
contiguous seq it has decoded) back down the same connection; the sender
keeps sent-but-unacked frames in a bounded window and sends them again
after a reconnect, and the server's dedup window drops the copies it
already holds: at-least-once frames, exactly-once rows.

Seq space:

* The counter starts from a per-boot epoch (``time_ns >> 20`` above a
  22-bit counter), or past a recovered spool's highest seq if that is
  higher, so a restarted agent's seqs lie above anything the server
  still holds for its agent_id.
* A seq is allocated at a frame's first write to the wire or the spool,
  never at ``send()``: a frame shed from a full queue owned no seq and
  leaves no gap that would stall the server's contiguous watermark.
* Every (re)connect, and every event that burns a seq (a spool eviction
  or disk error), announces ``SEQ_BASE``, the lowest seq this sender may
  still send; the server moves its watermark up to it.

Under a full queue, ``send()`` sheds the oldest queued frame of a lower
priority class (``codec.priority_of``: self-stats first); a HIGH frame
that still finds no room goes to the spool when there is one, and any
other frame is dropped. A failed write spools the frame too.

Ledger (the ``sender`` hop): ``emitted`` once per ``send()``,
``delivered`` once per frame at its first successful write (retransmits
count in ``stats`` only), every shed, evicted or undeliverable frame a
``dropped(reason)``, so ``emitted == delivered + dropped + in_flight``
holds, spool or no spool.

``ReplicatedSender`` (the reference's, ``agent/sender.py:614-796``) runs
one ``UniformSender`` per owner of the agent in the replication ring,
each with its own seq space, ack window and spool: HIGH and MID frames
go to every owner, LOW frames to the primary only. A new owner list
(the controller's analyzers after a ring epoch) keeps the retained
owners' senders as they are and re-ships a removed owner's unacked and
spooled frames (``UniformSender.drain_unsent``) to the owners added.
"""

from __future__ import annotations

import logging
import queue
import select
import socket
import threading
import time

from deepflow_tpu_torch.agent.config import parse_addr
from deepflow_tpu_torch.chaos import chaos_from_env
from deepflow_tpu_torch.codec import (
    FrameDecodeError, FrameHeader, MessageType, StreamDecoder, decode_ack,
    encode_frame, encode_seq_base, priority_of)
from deepflow_tpu_torch.telemetry import Telemetry

log = logging.getLogger("df.sender")

_PRIO_NAMES = {0: "high", 1: "mid", 2: "low"}


class _Frame:
    """One frame's transit state. ``seq`` stays None until the frame first
    reaches the wire or the spool; ``needs_account`` turns False at its
    first successful write (or its ack), so retransmits are never
    accounted twice. ``enq_ns`` is None for spool replays."""

    __slots__ = ("msg_type", "payload", "seq", "enq_ns", "needs_account")

    def __init__(self, msg_type: MessageType, payload: bytes,
                 seq: int | None = None, enq_ns: int | None = None) -> None:
        self.msg_type = msg_type
        self.payload = payload
        self.seq = seq
        self.enq_ns = enq_ns
        self.needs_account = True


class UniformSender:
    """One TCP connection shipping frames for all message types.

    ``send()`` is thread-safe and never blocks: it enqueues. A background
    thread frames and writes, reads acks, and reconnects with exponential
    backoff across the configured servers (failover)."""

    def __init__(self, servers: list, agent_id: int = 0,
                 queue_size: int = 8192, connect_timeout: float = 3.0,
                 ack_window: int = 1024, telemetry: Telemetry | None = None,
                 spool=None, chaos=None) -> None:
        if not servers:
            raise ValueError("need at least one server address")
        self.servers = [parse_addr(s) if isinstance(s, str) else tuple(s)
                        for s in servers]
        self.agent_id = agent_id
        self.connect_timeout = connect_timeout
        self.ack_window = max(1, ack_window)
        self.spool = spool
        self._chaos = chaos if chaos is not None else chaos_from_env()
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._sock: socket.socket | None = None
        self._server_idx = 0
        self._seq_lock = threading.Lock()
        # per-boot epoch in the high bits (~1 ms units) above a 22-bit
        # counter; a counter that outgrows 22 bits runs on into the epoch
        # bits and stays monotonic
        self._next_seq = ((time.time_ns() >> 20) << 22) | 1
        if spool is not None:
            # a recovered spool's seqs belong to an earlier boot: ours
            # start past them
            self._next_seq = max(self._next_seq, spool.max_seq() + 1)
        self.seq_base = self._next_seq - 1     # seqs are seq_base+1, +2, ...
        self._acked = 0                        # highest contiguous acked
        self._unacked: dict[int, _Frame] = {}  # sent, awaiting ack
        self._pending: list[_Frame] = []       # to send again, in order
        self._inflight: _Frame | None = None
        self._spool_replayed_through = 0       # highest seq handed to replay
        self._base_dirty = False  # re-announce SEQ_BASE on this connection
        # delivered frames evicted from the window before their ack: they
        # may still sit in a server decode queue, so SEQ_BASE stays below
        # them (the dedup floor would drop their rows)
        self._evicted_unacked: set[int] = set()
        self._ackdec = StreamDecoder()
        self.stats = {"sent_frames": 0, "sent_bytes": 0, "dropped": 0,
                      "reconnects": 0, "errors": 0, "retransmits": 0,
                      "spooled": 0, "replayed": 0, "acked_seq": 0,
                      "shed": 0, "unacked_evicted": 0, "seq_bases": 0}
        self._telemetry = telemetry or Telemetry("agent", enabled=False)
        self._hop = self._telemetry.hop("sender")
        if spool is not None:
            spool.on_evict = self._on_spool_evict
            # a recovered spool holds frames no send() of this process
            # emitted: account them in, so their replay keeps the ledger
            # balanced
            recovered = spool.pending_records()
            if recovered:
                self._hop.account(emitted=recovered)

    def _on_spool_evict(self, n: int, reason: str) -> None:
        self.stats["dropped"] += n
        self._hop.account(dropped=n, reason=reason)
        # the evicted records owned seqs that will never be sent
        self._base_dirty = True

    def start(self) -> "UniformSender":
        self._thread = threading.Thread(
            target=self._run, name="df-uniform-sender", daemon=True)
        self._thread.start()
        return self

    def _alloc_seq(self) -> int:
        with self._seq_lock:
            seq = self._next_seq
            self._next_seq += 1
            return seq

    def send(self, msg_type: MessageType, payload: bytes) -> bool:
        self._hop.account(emitted=1)
        f = _Frame(msg_type, payload, enq_ns=time.monotonic_ns())
        try:
            self._q.put_nowait(f)
            return True
        except queue.Full:
            pass
        # shed the oldest queued frame of a strictly lower class first
        mine = priority_of(msg_type)
        victim = self._shed_lower_than(mine)
        if victim is not None:
            self._drop("priority_shed_"
                       + _PRIO_NAMES[priority_of(victim.msg_type)])
            self.stats["shed"] += 1
            try:
                self._q.put_nowait(f)
                return True
            except queue.Full:
                pass  # raced with another sender: fall through
        if self.spool is not None and mine == 0:
            # a HIGH frame survives the overflow on disk
            f.seq = self._alloc_seq()
            if self.spool.append(int(msg_type), f.seq, f.payload):
                self.stats["spooled"] += 1
                return True
            self._drop("spool_error")
            self._base_dirty = True  # that seq is now a permanent gap
            return False
        self._drop(f"queue_full_{_PRIO_NAMES[mine]}")
        return False

    def _drop(self, reason: str) -> None:
        self.stats["dropped"] += 1
        self._hop.account(dropped=1, reason=reason)

    def _shed_lower_than(self, prio: int) -> _Frame | None:
        """Remove and return the oldest queued frame of a strictly lower
        priority class than ``prio`` (higher number = lower class)."""
        with self._q.mutex:
            dq = self._q.queue
            worst_i, worst_p = -1, prio
            for i, f in enumerate(dq):
                p = priority_of(f.msg_type)
                if p > worst_p:
                    worst_i, worst_p = i, p
                    if p == 2:
                        break  # none lower
            if worst_i < 0:
                return None
            victim = dq[worst_i]
            del dq[worst_i]
            self._q.not_full.notify()
            return victim

    # -- shutdown ------------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait up to ``timeout`` for the queue, the resend list, the
        frame in flight and the spool's unreplayed records to reach the
        wire; True when they did."""
        deadline = time.monotonic() + timeout
        while True:
            if self._q.empty() and self._inflight is None \
                    and not self._pending and not self._spool_backlog():
                return True
            if time.monotonic() >= deadline or self._stop.wait(0.02):
                return False

    def flush_and_stop(self, timeout: float = 5.0) -> None:
        """``flush``, then stop and close."""
        self.flush(timeout)
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self._close()
        if self.spool is not None:
            self.spool.close()

    def drain_unsent(self) -> list[tuple[MessageType, bytes]]:
        """Stop this sender and hand back every frame not yet acked, in
        seq order: the rebalance path, when this destination loses its
        ownership. Acked frames stay out (they are at the old owner);
        an unacked frame that did land may be reported once more after
        the ownership change (at-least-once across rebalances, exactly
        once within a ring). The undelivered frames leave this ledger as
        dropped(rebalance); sending them through another sender emits
        them on its hop again, so the ledger balances end to end."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None
        frames: dict[int, _Frame] = {}
        leftovers: list[_Frame] = []
        while True:
            try:
                f = self._q.get_nowait()
            except queue.Empty:
                break
            if f.seq is None:
                leftovers.append(f)
            else:
                frames.setdefault(f.seq, f)
        self._close()  # moves the window's frames into _pending
        for f in self._pending:
            if f.seq is None:
                leftovers.append(f)
            elif f.seq > self._acked:
                frames.setdefault(f.seq, f)
        self._pending = []
        if self.spool is not None:
            for mt, seq, payload in self.spool.replay(self._acked):
                if seq in frames:
                    continue
                try:
                    msg_type = MessageType(mt)
                except ValueError:
                    continue
                frames[seq] = _Frame(msg_type, payload, seq=seq)
            self.spool.close()
        out = []
        for f in sorted(frames.values(), key=lambda fr: fr.seq) + leftovers:
            if f.needs_account:
                self._drop("rebalance")
            out.append((f.msg_type, f.payload))
        return out

    def _spool_backlog(self) -> bool:
        """True while the spool holds records not yet handed to replay."""
        return (self.spool is not None
                and self.spool.max_seq() > max(self._acked,
                                               self._spool_replayed_through))

    def _close(self) -> None:
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._ackdec = StreamDecoder()
        # the server may or may not hold the unacked frames: send them
        # again (dedup makes that safe), HIGH class first, seq order
        # within a class
        if self._unacked:
            backlog = list(self._unacked.values())
            self._unacked.clear()
            self._pending = sorted(
                self._pending + backlog,
                key=lambda f: (priority_of(f.msg_type), f.seq))

    def _fail_over(self, what: str, err: Exception) -> None:
        log.warning("%s failed (%s); reconnecting", what, err)
        self.stats["errors"] += 1
        self._close()
        self._server_idx = (self._server_idx + 1) % len(self.servers)

    def _connect(self) -> bool:
        """Try the servers round-robin from the current one."""
        for i in range(len(self.servers)):
            idx = (self._server_idx + i) % len(self.servers)
            try:
                if self._chaos is not None:
                    self._chaos.on_connect()
                s = socket.create_connection(self.servers[idx],
                                             timeout=self.connect_timeout)
            except OSError:
                continue
            s.settimeout(10.0)
            self._sock = s
            self._server_idx = idx
            self.stats["reconnects"] += 1
            self._load_replay()
            return True
        return False

    def _load_replay(self) -> None:
        """Queue the spooled frames not yet handed to replay, HIGH class
        first (the unacked ones are already back in ``_pending``)."""
        if self.spool is None:
            return
        start = max(self._acked, self._spool_replayed_through)
        pending_seqs = {f.seq for f in self._pending}
        fresh = []
        for mt, seq, payload in self.spool.replay(start):
            if seq in pending_seqs:
                continue
            try:
                msg_type = MessageType(mt)
            except ValueError:
                continue
            fresh.append(_Frame(msg_type, payload, seq=seq))
            self._spool_replayed_through = max(
                self._spool_replayed_through, seq)
        if fresh:
            self.stats["replayed"] += len(fresh)
            self._pending = sorted(
                self._pending + fresh,
                key=lambda f: (priority_of(f.msg_type), f.seq))

    def _write(self, frame: bytes) -> None:
        if self._chaos is not None:
            self._chaos.on_send(self._sock, frame)
        else:
            self._sock.sendall(frame)

    # -- seq-base announcements ----------------------------------------------

    def _outstanding_base(self) -> int:
        """Lowest seq this sender may still (re)send; everything below it
        is acked or will never be sent. A too-low answer is harmless: the
        server only moves forward."""
        with self._seq_lock:
            cands = [self._next_seq]
        f = self._inflight
        if f is not None and f.seq is not None:
            cands.append(f.seq)
        cands.extend(fr.seq for fr in self._pending if fr.seq is not None)
        if self._unacked:
            cands.append(min(self._unacked))
        if self._evicted_unacked:
            cands.append(min(self._evicted_unacked))
        if self.spool is not None:
            s = self.spool.min_pending_seq()
            if s:
                cands.append(max(s, self._acked + 1))
        return min(cands)

    def _send_base(self) -> None:
        """Announce SEQ_BASE on the live connection (worker thread only)."""
        frame = encode_seq_base(self.agent_id, self._outstanding_base())
        try:
            self._write(frame)
        except OSError as e:
            self._fail_over("seq-base send", e)
            return
        self.stats["seq_bases"] += 1
        self.stats["sent_bytes"] += len(frame)
        self._base_dirty = False

    # -- ack processing ------------------------------------------------------

    def _read_acks(self) -> None:
        """Drain the ACK frames the server wrote back (non-blocking)."""
        sock = self._sock
        if sock is None:
            return
        try:
            while True:
                r, _, _ = select.select([sock], [], [], 0)
                if not r:
                    return
                data = sock.recv(4096)
                if not data:
                    raise OSError("server closed connection")
                for header, payload in self._ackdec.feed(data):
                    if header.msg_type == MessageType.ACK:
                        self._on_ack(decode_ack(payload))
        except (OSError, FrameDecodeError) as e:
            self._fail_over("ack channel", e)

    def _on_ack(self, seq: int) -> None:
        if seq <= self._acked:
            return
        self._acked = seq
        self.stats["acked_seq"] = seq
        for s in [s for s in self._unacked if s <= seq]:
            del self._unacked[s]
        kept = []
        for f in self._pending:
            if f.seq is None or f.seq > seq:
                kept.append(f)
            elif f.needs_account:
                # acked though its write failed (a partial write that
                # landed whole): it is delivered
                self._hop.account(delivered=1)
                f.needs_account = False
        self._pending = kept
        self._evicted_unacked = {s for s in self._evicted_unacked
                                 if s > seq}
        if self.spool is not None:
            self.spool.trim(seq)
        # everything below a gap of never-sent seqs is acked: announce the
        # jump so the server's watermark does not stall at the gap's edge
        if self._outstanding_base() > seq + 1:
            self._base_dirty = True

    # -- send loop -----------------------------------------------------------

    def _next_frame(self) -> _Frame | None:
        if self._pending:
            return self._pending.pop(0)
        try:
            return self._q.get(timeout=0.2)
        except queue.Empty:
            return None

    def _send_frame(self, f: _Frame) -> None:
        self._inflight = f
        if f.seq is None:
            # first wire write: the seq is born here, in write order
            f.seq = self._alloc_seq()
        frame = encode_frame(
            FrameHeader(f.msg_type, agent_id=self.agent_id, seq=f.seq),
            f.payload)
        try:
            self._write(frame)
        except OSError as e:
            # the frame is not lost: it goes to the spool, or first when
            # the connection is back (or to the next server)
            if self.spool is not None and f.needs_account \
                    and f.seq > self._spool_replayed_through \
                    and self.spool.append(int(f.msg_type), f.seq, f.payload):
                self.stats["spooled"] += 1
            else:
                self._pending.insert(0, f)
            self._fail_over("send", e)
            return
        finally:
            self._inflight = None
        self.stats["sent_frames"] += 1
        self.stats["sent_bytes"] += len(frame)
        if not f.needs_account:
            self.stats["retransmits"] += 1
        else:
            self._hop.account(
                delivered=1, wait_ns=None if f.enq_ns is None
                else time.monotonic_ns() - f.enq_ns)
            f.needs_account = False
        self._unacked[f.seq] = f
        self._cap_unacked()

    def _cap_unacked(self) -> None:
        """Bound the window's memory. An evicted frame was delivered; only
        the chance to send it again is lost, so past the window delivery
        is at-most-once. A server that acks never lets it fill."""
        while len(self._unacked) > self.ack_window:
            oldest = min(self._unacked)
            del self._unacked[oldest]
            self._evicted_unacked.add(oldest)
            self.stats["unacked_evicted"] += 1
        while len(self._evicted_unacked) > 4 * self.ack_window:
            self._evicted_unacked.discard(min(self._evicted_unacked))

    def _run(self) -> None:
        backoff = 0.1
        hb = self._telemetry.heartbeat("sender")
        while not self._stop.is_set():
            hb.beat(progress=self.stats["sent_frames"])
            if self._sock is None:
                if not self._connect():
                    # interruptible, so flush_and_stop returns promptly
                    if self._stop.wait(min(backoff, 5.0)):
                        return
                    backoff = min(backoff * 2, 5.0)
                    continue
                backoff = 0.1
                self._send_base()  # adopt this boot's seq space
                if self._sock is None:
                    continue
            self._read_acks()
            if self._sock is None:
                continue  # the ack channel died; reconnect first
            if self._base_dirty:
                self._send_base()
                if self._sock is None:
                    continue
            f = self._next_frame()
            if f is None:
                # idle: frames spooled while the connection was busy
                # drain now, without a reconnect
                self._load_replay()
                continue
            self._send_frame(f)


class ReplicatedSender:
    """One independent UniformSender per owner destination: HIGH and MID
    frames to all of them, LOW frames to the primary only (sheddable
    data does not earn R copies). Each destination has its own seq
    space, ack window and spool subdirectory, so a dead primary's frames
    sit durably in its replicas' senders, and the replicas' copies are
    what the query-time claim filter promotes when the primary dies.

    Duck-types the UniformSender surface the agent uses: send, start,
    flush, flush_and_stop, servers, agent_id, stats."""

    def __init__(self, servers: list, replication: int = 2,
                 agent_id: int = 0, queue_size: int = 8192,
                 connect_timeout: float = 3.0, ack_window: int = 1024,
                 telemetry: Telemetry | None = None, spool_factory=None,
                 chaos=None) -> None:
        if not servers:
            raise ValueError("need at least one server address")
        parsed = [parse_addr(s) if isinstance(s, str) else tuple(s)
                  for s in servers]
        self.replication = max(1, int(replication))
        self._agent_id = agent_id
        self._kw = dict(queue_size=queue_size,
                        connect_timeout=connect_timeout,
                        ack_window=ack_window, telemetry=telemetry,
                        chaos=chaos)
        # spool_factory(dest_key) -> Spool | None: one directory per
        # destination (their seq spaces are unrelated; a shared spool
        # would interleave them and break the trim and replay marks)
        self._spool_factory = spool_factory or (lambda key: None)
        self._lock = threading.Lock()
        self._senders: dict[tuple, UniformSender] = {}
        self._order: list[tuple] = []
        self._started = False
        self.stats = {"rebalances": 0, "reshipped": 0}
        for dest in parsed[:self.replication]:
            self._add_dest(dest)

    @staticmethod
    def _dest_key(dest: tuple) -> str:
        return f"{dest[0]}_{dest[1]}".replace(":", "_")

    def _add_dest(self, dest: tuple) -> None:
        s = UniformSender([dest], agent_id=self._agent_id,
                          spool=self._spool_factory(self._dest_key(dest)),
                          **self._kw)
        self._senders[dest] = s
        self._order.append(dest)
        if self._started:
            s.start()

    # -- the UniformSender surface --------------------------------------------

    @property
    def agent_id(self) -> int:
        return self._agent_id

    @agent_id.setter
    def agent_id(self, v: int) -> None:
        self._agent_id = v
        with self._lock:
            for s in self._senders.values():
                s.agent_id = v

    @property
    def servers(self) -> list:
        with self._lock:
            return list(self._order)

    @servers.setter
    def servers(self, addrs: list) -> None:
        self.set_destinations(addrs)

    def threads(self) -> list:
        """Every destination's worker thread (the guard's CPU reading)."""
        with self._lock:
            return [s._thread for s in self._senders.values()]

    def start(self) -> "ReplicatedSender":
        with self._lock:
            self._started = True
            for s in self._senders.values():
                s.start()
        return self

    def send(self, msg_type: MessageType, payload: bytes) -> bool:
        with self._lock:
            if not self._order:
                return False
            if priority_of(msg_type) >= 2:  # LOW: the primary only
                targets = [self._senders[self._order[0]]]
            else:
                targets = [self._senders[d] for d in self._order]
        ok = False
        for s in targets:
            ok = s.send(msg_type, payload) or ok
        return ok

    def flush(self, timeout: float = 5.0) -> bool:
        """Every destination's ``flush`` within one shared deadline."""
        deadline = time.monotonic() + timeout
        with self._lock:
            senders = list(self._senders.values())
        return all([s.flush(max(0.0, deadline - time.monotonic()))
                    for s in senders])

    def flush_and_stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            senders = list(self._senders.values())
        threads = [threading.Thread(
            target=s.flush_and_stop, kwargs={"timeout": timeout},
            daemon=True) for s in senders]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 2.0)

    # -- rebalance -------------------------------------------------------------

    def set_destinations(self, addrs: list) -> None:
        """Adopt a new owner list (ring order, primary first). Retained
        destinations' senders run on untouched: their windows, spools and
        seq spaces survive the rebalance, so no frame is dropped."""
        parsed = [parse_addr(a) if isinstance(a, str) else tuple(a)
                  for a in addrs][:self.replication]
        with self._lock:
            if parsed == self._order or not parsed:
                return
            removed = [d for d in self._order if d not in parsed]
            added = [d for d in parsed if d not in self._senders]
            harvested: list[tuple] = []
            for dest in removed:
                harvested.extend(self._senders.pop(dest).drain_unsent())
            for dest in added:
                self._add_dest(dest)
            self._order = parsed
            new_targets = [self._senders[d] for d in added]
            self.stats["rebalances"] += 1
        # a lost owner's outstanding frames go to the NEW owners only: a
        # retained one holds its own copy, and a second would be a row
        # twice on one shard (each sender's seq space is its own, so the
        # server's dedup window cannot catch it)
        if harvested and new_targets:
            for mt, payload in harvested:
                for s in new_targets:
                    s.send(mt, payload)
            self.stats["reshipped"] += len(harvested)

    # -- diagnostics -----------------------------------------------------------

    def stat_totals(self) -> dict:
        """The destinations' UniformSender stats, summed."""
        out: dict = {}
        with self._lock:
            senders = list(self._senders.values())
        for s in senders:
            for k, v in s.stats.items():
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        return out

    def per_destination(self) -> dict:
        with self._lock:
            return {f"{h}:{p}": dict(s.stats)
                    for (h, p), s in self._senders.items()}
