"""Seeded fault injection for the transport and the storage tier.

Own copy of ``deepflow_tpu/chaos.py``: a seeded ``ChaosInjector``
behind narrow hook points in the sender, the receiver, the spool and
the tier,

  * ``on_connect``     refuse the connection (ECONNREFUSED);
  * ``on_send``        inject latency, reset before a write, or write a
                       PARTIAL frame and then reset;
  * ``on_accept``      accept, then stall before the first read;
  * ``on_spool_write`` disk full (ENOSPC) on a spool append;
  * ``on_tier_write``  disk full (ENOSPC) on a tier flush commit;
  * ``on_objstore_write`` an I/O error (EIO) on an object-store blob
                       write, before any byte lands,

and ``corrupt_segment``, which rots a sealed segment file on purpose.

Every fault is drawn from one seeded ``random.Random``, so a run
replays exactly with the same seed: the same ``DF_CHAOS`` spec gives the
same schedule here and in the reference. The spec is a comma-separated
k=v list,

    DF_CHAOS="seed=42,conn_reset=0.05,partial_write=0.1,latency_ms=2"

Probabilities are per call in [0, 1]; absent keys are 0 (off).
``chaos_from_env()`` returns None when DF_CHAOS is unset, and the hot
paths then pay one ``is None`` check.
"""

from __future__ import annotations

import errno
import logging
import os
import random
import socket
import threading
import time
from dataclasses import dataclass, fields

log = logging.getLogger("df.chaos")


@dataclass
class ChaosConfig:
    """Fault probabilities/magnitudes; all zero = no faults."""

    enabled: bool = False
    seed: int = 0
    conn_refuse: float = 0.0    # P(connect() refused)
    conn_reset: float = 0.0     # P(reset before a frame write)
    partial_write: float = 0.0  # P(write a frame PREFIX, then reset)
    latency_ms: float = 0.0     # added before each frame write
    stall_s: float = 0.0        # accept-then-stall duration (receiver)
    stall_p: float = 0.0        # P(stall on accept)
    disk_full: float = 0.0      # P(ENOSPC on a spool append)
    tier_enospc: float = 0.0    # P(ENOSPC on a tier flush commit)
    objstore_eio: float = 0.0   # P(EIO on an objstore blob write)

    @classmethod
    def parse(cls, spec: str) -> "ChaosConfig":
        """Parse a DF_CHAOS spec; unknown keys raise (a typoed knob that
        silently disables a fault would invalidate the whole harness)."""
        cfg = cls(enabled=True)
        valid = {f.name: f.type for f in fields(cls)}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in valid:
                raise ValueError(f"unknown DF_CHAOS knob {key!r}")
            cur = getattr(cfg, key)
            if isinstance(cur, bool):
                setattr(cfg, key, val.strip() not in ("", "0", "false"))
            elif isinstance(cur, int):
                setattr(cfg, key, int(val))
            else:
                setattr(cfg, key, float(val))
        return cfg


class ChaosInjector:
    """Seeded fault source. Thread-safe: one rng guarded by a lock (the
    sender thread, receiver handler threads and callers' send() paths
    all consult the same injector)."""

    def __init__(self, config: ChaosConfig) -> None:
        self.config = config
        self._rng = random.Random(config.seed)
        self._lock = threading.Lock()
        self.stats = {"conn_refused": 0, "conn_reset": 0,
                      "partial_writes": 0, "stalls": 0, "disk_full": 0,
                      "latency_injections": 0, "tier_enospc": 0,
                      "objstore_eio": 0}

    def _hit(self, p: float) -> bool:
        if p <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < p

    # -- hook points ---------------------------------------------------------

    def on_connect(self) -> None:
        """Called by the sender before using a fresh connection."""
        if self._hit(self.config.conn_refuse):
            self.stats["conn_refused"] += 1
            raise ConnectionRefusedError(
                errno.ECONNREFUSED, "chaos: connection refused")

    def on_send(self, sock: socket.socket, frame: bytes) -> None:
        """Called instead of sendall(). Either delivers the whole frame
        or raises after delivering a (possibly empty) prefix."""
        cfg = self.config
        if cfg.latency_ms > 0.0:
            self.stats["latency_injections"] += 1
            time.sleep(cfg.latency_ms / 1e3)
        if self._hit(cfg.conn_reset):
            self.stats["conn_reset"] += 1
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionResetError(
                errno.ECONNRESET, "chaos: reset before write")
        if self._hit(cfg.partial_write) and len(frame) > 1:
            with self._lock:
                cut = self._rng.randrange(1, len(frame))
            self.stats["partial_writes"] += 1
            try:
                sock.sendall(frame[:cut])
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionResetError(
                errno.ECONNRESET, "chaos: reset mid-frame")
        sock.sendall(frame)

    def on_accept(self) -> None:
        """Called by the receiver handler before its first read."""
        if self._hit(self.config.stall_p) and self.config.stall_s > 0:
            self.stats["stalls"] += 1
            time.sleep(self.config.stall_s)

    def on_spool_write(self) -> None:
        """Called by the spool before each record append."""
        if self._hit(self.config.disk_full):
            self.stats["disk_full"] += 1
            raise OSError(errno.ENOSPC, "chaos: no space left on device")

    def on_tier_write(self) -> None:
        """Called by TieredStore.commit before writing segments: a full
        data disk fails the WHOLE commit (no manifest rename, no acks) —
        the flusher requeues and backs off, agents keep retransmitting."""
        if self._hit(self.config.tier_enospc):
            self.stats["tier_enospc"] += 1
            raise OSError(errno.ENOSPC,
                          "chaos: no space left on device (tier)")

    def on_objstore_write(self) -> None:
        """Called by ObjStore.put_if_absent before staging a blob: an
        I/O error on the shared store fails the publish (the pointer
        never names a blob that is not there), never tears it."""
        if self._hit(self.config.objstore_eio):
            self.stats["objstore_eio"] += 1
            raise OSError(errno.EIO, "chaos: I/O error (objstore)")


def corrupt_segment(path: str, seed: int = 0,
                    mode: str = "bit_flip") -> dict:
    """Inject silent data corruption into a sealed segment file — a
    test's fault, not a runtime hook.

    ``bit_flip`` parses the footer to find a column block and flips one
    bit INSIDE it: the footer (and its crc) stay valid, the file still
    opens, only the block checksum can catch it — exactly the disk-rot
    shape the scrubber exists for. ``truncate`` cuts the file mid-byte
    (torn-file shape: Segment.open refuses it outright).

    Returns {"mode", "column", "offset"} describing the damage."""
    import json as _json
    import struct as _struct
    rng = random.Random(seed)
    size = os.path.getsize(path)
    if mode == "truncate":
        cut = max(1, size // 2 + rng.randrange(-size // 4 or 1,
                                               size // 4 or 2))
        with open(path, "rb+") as f:
            f.truncate(min(cut, size - 1))
        return {"mode": "truncate", "column": None, "offset": cut}
    tail = _struct.Struct("<II8s")
    with open(path, "rb+") as f:
        f.seek(size - tail.size)
        flen, _, magic = tail.unpack(f.read(tail.size))
        if magic != b"DFSEGEND":
            raise ValueError(f"{path}: not a sealed segment")
        f.seek(size - tail.size - flen)
        footer = _json.loads(f.read(flen))
        cols = {k: v for k, v in footer.get("cols", {}).items()
                if v.get("nbytes", 0) > 0}
        if not cols:
            raise ValueError(f"{path}: no non-empty column block")
        name = rng.choice(sorted(cols))
        c = cols[name]
        off = c["off"] + rng.randrange(c["nbytes"])
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ (1 << rng.randrange(8))]))
        f.flush()
        os.fsync(f.fileno())
    return {"mode": "bit_flip", "column": name, "offset": off}


def chaos_from_env() -> ChaosInjector | None:
    """DF_CHAOS -> injector, or None (the default, and the fast path)."""
    spec = os.environ.get("DF_CHAOS", "")
    if not spec:
        return None
    try:
        cfg = ChaosConfig.parse(spec)
    except ValueError as e:
        # a malformed knob must not take the agent down — but it must
        # be LOUD, because the operator thinks chaos is running
        log.error("DF_CHAOS ignored: %s", e)
        return None
    log.warning("chaos injection ENABLED: %s", spec)
    return ChaosInjector(cfg)
