"""Segmented on-disk spool: the sender's overflow and replay buffer.

Own copy of ``deepflow_tpu/agent/spool.py``, with the same on-disk
format, so a spool one package wrote the other recovers. Frames the
sender would otherwise drop (a HIGH frame on a full queue, a failed
in-flight write) land in an append-only spool and replay on reconnect:
a server outage shorter than the spool's capacity loses nothing.

Layout: ``<dir>/spool-<first_seq>.seg`` segment files, each a run of
CRC-framed records::

    u32 payload_len | u32 crc32(payload) | u8 msg_type | u64 seq | payload

Records are immutable once written. The spool rotates to a new segment
at ``segment_bytes`` and holds ``max_bytes`` by deleting the OLDEST
segment; evicted records go to ``on_evict`` so the sender ledgers them
as ``dropped(spool_evict)``. ``trim(acked)`` deletes segments the server
has acknowledged whole. A directory that already holds segments is
recovered on construction: torn tail records (a crash mid-append) are
cut off and the records before them replay, so an agent restart loses
no spooled frame.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib

log = logging.getLogger("df.spool")

_REC_FMT = ">IIBQ"
_REC_SIZE = struct.calcsize(_REC_FMT)  # 17
_SEG_PREFIX = "spool-"
_SEG_SUFFIX = ".seg"
# refuse obviously-insane records when recovering a damaged file
_MAX_RECORD = 64 << 20


class _Segment:
    """first_seq/last_seq are the MIN/MAX seq in the segment — appends
    are not guaranteed in seq order (the sender's OSError respool path
    can write an older in-flight seq after newer overflow spills), so
    trim/replay decisions must use the true range, not arrival order."""

    __slots__ = ("path", "first_seq", "last_seq", "records", "bytes",
                 "mtime")

    def __init__(self, path: str, first_seq: int) -> None:
        self.path = path
        self.first_seq = first_seq
        self.last_seq = first_seq
        self.records = 0
        self.bytes = 0
        self.mtime = time.time()  # wall clock of the last append

    def note(self, seq: int) -> None:
        if self.records == 0:
            self.first_seq = self.last_seq = seq
        else:
            self.first_seq = min(self.first_seq, seq)
            self.last_seq = max(self.last_seq, seq)
        self.records += 1


class Spool:
    """Thread-safe (send() callers and the sender thread both touch it)."""

    def __init__(self, directory: str, max_bytes: int = 64 << 20,
                 segment_bytes: int = 4 << 20, on_evict=None,
                 chaos=None, max_age_s: float = 0) -> None:
        self.dir = directory
        self.max_bytes = max_bytes
        # age-based retention (0 = size-only): whole CLOSED segments
        # older than this are evicted — stale spooled frames describe a
        # past the operator may no longer want replayed after a long
        # outage. Checked on append and trim; visible as spool_age_evict.
        self.max_age_s = max(0.0, float(max_age_s))
        # a segment must be well under the cap or eviction (whole
        # oldest segments, never the open writer) could not enforce it
        self.segment_bytes = max(4096, min(segment_bytes, max_bytes // 2))
        self.on_evict = on_evict  # callback(n_records, reason)
        self._chaos = chaos
        self._lock = threading.Lock()
        self._segments: list[_Segment] = []
        self._fh = None  # open handle on the newest segment
        self.stats = {"appended": 0, "replayed": 0, "evicted": 0,
                      "trimmed": 0, "corrupt": 0, "disk_errors": 0,
                      "recovered": 0}
        os.makedirs(self.dir, exist_ok=True)
        self._recover()

    # -- recovery ------------------------------------------------------------

    def _recover(self) -> None:
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith(_SEG_PREFIX)
                       and n.endswith(_SEG_SUFFIX))
        for name in names:
            path = os.path.join(self.dir, name)
            seg = _Segment(path, 0)
            good_end = 0
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                self.stats["disk_errors"] += 1
                continue
            off = 0
            while off + _REC_SIZE <= len(data):
                ln, crc, _mt, seq = struct.unpack_from(_REC_FMT, data, off)
                end = off + _REC_SIZE + ln
                if ln > _MAX_RECORD or end > len(data):
                    break  # torn tail: a crash mid-append
                if zlib.crc32(data[off + _REC_SIZE:end]) & 0xFFFFFFFF != crc:
                    self.stats["corrupt"] += 1
                    break  # no resync marker: discard the rest
                seg.note(seq)
                good_end = end
                off = end
            if good_end < len(data):
                try:  # truncate the torn tail so appends stay framed
                    with open(path, "r+b") as f:
                        f.truncate(good_end)
                except OSError:
                    self.stats["disk_errors"] += 1
            if seg.records == 0:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            seg.bytes = good_end
            try:  # restart: age continues from the file's last write
                seg.mtime = os.path.getmtime(path)
            except OSError:
                pass
            self._segments.append(seg)
            self.stats["recovered"] += seg.records
        self._segments.sort(key=lambda s: s.first_seq)

    # -- append --------------------------------------------------------------

    def append(self, msg_type: int, seq: int, payload: bytes) -> bool:
        """Append one record; False on a disk error (the caller drops and
        ledgers the frame — the spool never throws on the send path)."""
        rec = struct.pack(_REC_FMT, len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF,
                          int(msg_type), seq) + payload
        with self._lock:
            try:
                if self._chaos is not None:
                    self._chaos.on_spool_write()
                fh = self._writer(len(rec), seq)
                fh.write(rec)
                fh.flush()
            except OSError as e:
                self.stats["disk_errors"] += 1
                log.warning("spool append failed: %s", e)
                return False
            seg = self._segments[-1]
            seg.note(seq)
            seg.bytes += len(rec)
            seg.mtime = time.time()
            self.stats["appended"] += 1
            self._enforce_cap()
            return True

    def _writer(self, need: int, seq: int):
        """Open segment with room for `need` bytes, rotating as needed."""
        if (self._fh is None or not self._segments
                or self._segments[-1].bytes + need > self.segment_bytes):
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            path = os.path.join(self.dir,
                                f"{_SEG_PREFIX}{seq:020d}{_SEG_SUFFIX}")
            self._fh = open(path, "ab")
            if not self._segments or self._segments[-1].path != path:
                self._segments.append(_Segment(path, seq))
        return self._fh

    def _enforce_cap(self) -> None:
        """Oldest-segment eviction: bounded disk, bounded (visible) loss."""
        total = sum(s.bytes for s in self._segments)
        while total > self.max_bytes and len(self._segments) > 1:
            total -= self._evict_oldest("spool_evict")
        self._enforce_age()

    def _enforce_age(self) -> None:
        if not self.max_age_s:
            return
        cutoff = time.time() - self.max_age_s
        # never the open writer (last segment): its mtime still moves
        while len(self._segments) > 1 and \
                self._segments[0].mtime < cutoff:
            self._evict_oldest("spool_age_evict")

    def _evict_oldest(self, reason: str) -> int:
        victim = self._segments.pop(0)
        self.stats["evicted"] += victim.records
        try:
            os.unlink(victim.path)
        except OSError:
            self.stats["disk_errors"] += 1
        if self.on_evict is not None:
            self.on_evict(victim.records, reason)
        return victim.bytes

    # -- replay / trim -------------------------------------------------------

    def replay(self, after_seq: int) -> list[tuple[int, int, bytes]]:
        """All surviving records with seq > after_seq, oldest first, as
        (msg_type, seq, payload). Corrupt records are skipped+counted."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            segments = [s for s in self._segments
                        if s.last_seq > after_seq]
            paths = [s.path for s in segments]
        out: list[tuple[int, int, bytes]] = []
        for path in paths:
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                self.stats["disk_errors"] += 1
                continue
            off = 0
            while off + _REC_SIZE <= len(data):
                ln, crc, mt, seq = struct.unpack_from(_REC_FMT, data, off)
                end = off + _REC_SIZE + ln
                if ln > _MAX_RECORD or end > len(data):
                    break
                payload = data[off + _REC_SIZE:end]
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    self.stats["corrupt"] += 1
                    break
                if seq > after_seq:
                    out.append((mt, seq, payload))
                off = end
        self.stats["replayed"] += len(out)
        return out

    def trim(self, acked_seq: int) -> int:
        """Delete segments fully covered by the server's ack; returns the
        number of records released."""
        released = 0
        with self._lock:
            while self._segments and \
                    self._segments[0].last_seq <= acked_seq:
                seg = self._segments[0]
                # never unlink the segment the writer holds open
                if self._fh is not None and seg is self._segments[-1]:
                    break
                self._segments.pop(0)
                released += seg.records
                try:
                    os.unlink(seg.path)
                except OSError:
                    self.stats["disk_errors"] += 1
            self.stats["trimmed"] += released
            # acks arrive while appends may have stopped (idle agent):
            # trim is the other periodic touch point for age retention
            self._enforce_age()
        return released

    # -- introspection -------------------------------------------------------

    def max_seq(self) -> int:
        """Highest seq still spooled (0 when empty) — lets the sender's
        flush path know whether unreplayed records remain. Max across
        ALL segments: out-of-order appends mean the newest segment does
        not necessarily hold the highest seq."""
        with self._lock:
            return max((s.last_seq for s in self._segments), default=0)

    def min_pending_seq(self) -> int:
        """Lowest seq still spooled (0 when empty): a safe lower bound
        for the sender's SEQ_BASE announcement."""
        with self._lock:
            return min((s.first_seq for s in self._segments), default=0)

    def pending_records(self) -> int:
        with self._lock:
            return sum(s.records for s in self._segments)

    def pending_bytes(self) -> int:
        with self._lock:
            return sum(s.bytes for s in self._segments)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
