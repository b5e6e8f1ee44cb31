"""Background scrubber: paced checksum verification and self-healing.

Own copy of ``deepflow_tpu/store/scrub.py``, whole (the analog of
ClickHouse's part checksums, ``CHECK TABLE`` and replica repair: a
corrupt part is detached and re-fetched). Every v2 segment block carries
a crc32 (``store/segment.py``); this module walks the three places
sealed bytes live and verifies them at a byte-budgeted pace on a thread:

  * the LOCAL TIER's sealed segments (the authoritative copies),
  * the SEGCACHE's fetched copies (a stateless querier's working set),
  * this shard's OWNED OBJSTORE BLOBS (the published copies that every
    repair and every replica's adoption depends on).

A local segment that fails verification leaves service through the one
manifest commit point (``TieredStore.quarantine``: never served again,
across restarts), its rows ledgered under ``segment_quarantine``; repair
then fetches the published blob (the object store's primary, else a
mirror), re-verifies the WHOLE file, swaps it back in atomically and
re-commits the manifest (``unquarantine``). Queries in the gap carry the
``degraded`` annotation, as federation marks a missing shard: a short
answer is reported, never silent. A corrupt CACHED copy is discarded
(the next pin re-fetches and re-verifies); a corrupt PUBLISHED blob is
deleted and re-uploaded from the local segment when that one is healthy.
CRC verification is ``zlib.crc32`` on the host, as the reference's.

The ``storage.scrub`` hop ledger conserves per unit scanned: emitted ==
delivered (clean, or pre-checksum and so unverifiable) + dropped (reason
``corrupt``). Unverifiable units are also counted in
``stats["unverifiable"]``, so fsck can tell "clean" from "unverifiable".
"""

from __future__ import annotations

import logging
import os
import threading

from deepflow_tpu_torch.store import objstore as _objstore
from deepflow_tpu_torch.store import segment as _segment
from deepflow_tpu_torch.store.segment import Segment, SegmentError

log = logging.getLogger("df.scrub")

# default pacing: verify at most this many bytes per scrub cycle — on a
# 30s cadence that is ~128 MiB/min of background crc, far below what a
# laptop-class disk notices (crc32 itself runs at GB/s)
_DEFAULT_CYCLE_BYTES = 64 << 20


class Scrubber:
    """Periodic integrity walk + quarantine/repair for one shard."""

    def __init__(self, db, objstore=None, segcache=None, shard_id: int = 0,
                 interval_s: float = 30.0,
                 cycle_bytes: int = _DEFAULT_CYCLE_BYTES,
                 telemetry=None) -> None:
        self.db = db
        self.objstore = objstore
        self.segcache = segcache
        self.shard_id = shard_id
        self.interval_s = interval_s
        self.cycle_bytes = cycle_bytes
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # run loop vs fsck/scrub_once
        # resume cursor: (source, table, fn) of the last unit verified —
        # a byte-budgeted cycle picks up where the previous one stopped
        # instead of re-verifying the head of the walk forever
        self._cursor: tuple | None = None
        self.stats = {"cycles": 0, "segments_scanned": 0,
                      "bytes_scanned": 0, "clean": 0, "unverifiable": 0,
                      "corrupt": 0, "quarantined": 0, "repaired": 0,
                      "repair_failed": 0, "cache_scanned": 0,
                      "cache_corrupt": 0, "blobs_scanned": 0,
                      "blobs_corrupt": 0, "blobs_republished": 0,
                      "errors": 0}
        if telemetry is None:
            from deepflow_tpu_torch.telemetry import Telemetry
            telemetry = Telemetry("server", enabled=False)
        self._telemetry = telemetry
        self._hop = telemetry.hop("storage.scrub")

    # -- walk units -----------------------------------------------------------

    def _units(self) -> list[tuple]:
        """The full walk, in a stable order the cursor can resume into:
        ("tier", table, fn, seg) | ("cache", key, fn, ent) |
        ("blob", table, fn, key)."""
        units: list[tuple] = []
        store = getattr(self.db, "tier_store", None)
        if store is not None:
            for name, tt in sorted(store.tables().items()):
                for seg in tt.segments():
                    units.append(("tier", name,
                                  os.path.basename(seg.path), seg))
        if self.segcache is not None:
            for key, ent in self.segcache.entries():
                units.append(("cache", str(key), key[2], ent))
        if self.objstore is not None:
            prefix = f"seg/{self.shard_id}"
            try:
                for key in self.objstore.list_keys(prefix):
                    parts = key.split("/")
                    units.append(("blob", parts[2] if len(parts) > 3
                                  else "", parts[-1], key))
            except OSError:
                pass
        return units

    def scrub_once(self, max_bytes: int | None = None) -> dict:
        """One byte-budgeted verification cycle (also the fsck entry
        point with max_bytes=None = unbounded). Returns the cycle's
        counters; cumulative totals live in ``self.stats``."""
        with self._lock:
            budget = self.cycle_bytes if max_bytes is None else max_bytes
            out = {"scanned": 0, "bytes": 0, "clean": 0, "corrupt": 0,
                   "unverifiable": 0, "repaired": 0, "repair_failed": 0}
            # quarantined segments left the serving set, so the walk
            # below never meets them again — retry their repair first
            # (the blob may have been published, or a mirror attached,
            # since the last attempt)
            self._retry_quarantined(out)
            units = self._units()
            if not units:
                self.stats["cycles"] += 1
                return out
            start = 0
            if self._cursor is not None:
                tags = [(u[0], u[1], u[2]) for u in units]
                try:
                    start = (tags.index(self._cursor) + 1) % len(units)
                except ValueError:
                    start = 0
            for i in range(len(units)):
                u = units[(start + i) % len(units)]
                self._cursor = (u[0], u[1], u[2])
                try:
                    nbytes = self._scrub_unit(u, out)
                except Exception:
                    self.stats["errors"] += 1
                    log.exception("scrub unit %s failed", u[:3])
                    nbytes = 0
                out["bytes"] += nbytes
                if max_bytes != 0 and out["bytes"] >= budget > 0:
                    break
            self.stats["cycles"] += 1
            return out

    def _scrub_unit(self, unit: tuple, out: dict) -> int:
        kind = unit[0]
        if kind == "tier":
            return self._scrub_tier_segment(unit[1], unit[3], out)
        if kind == "cache":
            return self._scrub_cache_entry(unit[3], out)
        return self._scrub_blob(unit[1], unit[3], out)

    # -- local tier: verify -> quarantine -> repair ---------------------------

    def _scrub_tier_segment(self, name: str, seg: Segment,
                            out: dict) -> int:
        v = seg.verify()
        out["scanned"] += 1
        self.stats["segments_scanned"] += 1
        self.stats["bytes_scanned"] += v["bytes"]
        if v["corrupt"]:
            out["corrupt"] += 1
            self.stats["corrupt"] += 1
            self._hop.account(emitted=1, dropped=1, reason="corrupt")
            if self.quarantine_and_repair(
                    name, seg, f"crc:{','.join(v['corrupt'])}"):
                out["repaired"] += 1
            else:
                out["repair_failed"] += 1
            return v["bytes"]
        if not v["verifiable"]:
            out["unverifiable"] += 1
            self.stats["unverifiable"] += 1
        else:
            out["clean"] += 1
            self.stats["clean"] += 1
        self._hop.account(emitted=1, delivered=1)
        return v["bytes"]

    def quarantine_and_repair(self, name: str, seg: Segment,
                              reason: str) -> bool:
        """Pull a corrupt segment from service and attempt repair —
        shared by the background walk and the on-demand fsck path.
        Returns True when the segment was repaired and re-admitted."""
        store = self.db.tier_store
        fn = os.path.basename(seg.path)
        q = store.quarantine(name, seg, reason)
        if not q.get("already"):
            self.stats["quarantined"] += 1
            # rows leave service: same bookkeeping + ledger contract as
            # eviction — drops are attributed, never silent
            try:
                self.db.table(name).note_tier_evict(
                    q["rows"], q.get("tmin"), q.get("tmax"))
            except KeyError:
                pass
            self._telemetry.hop("storage").account(
                emitted=q["rows"], dropped=q["rows"],
                reason="segment_quarantine")
        return self.repair(name, fn)

    def _retry_quarantined(self, out: dict) -> None:
        store = getattr(self.db, "tier_store", None)
        if store is None or self.objstore is None:
            return
        for name, files in store.quarantined().items():
            for fn in list(files):
                if self.repair(name, fn):
                    out["repaired"] += 1

    def repair(self, name: str, fn: str) -> bool:
        """Fetch a healthy published copy of a quarantined segment,
        re-verify the WHOLE file, swap it back in (one manifest commit)
        and restore the table bookkeeping. Returns True on success;
        False leaves the segment quarantined (degraded annotation stays
        up) for a later cycle — the blob may not be published yet, or
        every copy may be gone."""
        store = self.db.tier_store
        if self.objstore is None:
            self.stats["repair_failed"] += 1
            return False
        tt = store.tier(name)
        dst = os.path.join(tt.dir, fn)
        side = f"{dst}.tmp.repair"  # ".tmp." => recovery sweeps a crash
        key = _objstore.seg_key(self.shard_id, name, fn)
        try:
            # fetch() itself falls over to mirror roots on a primary
            # miss — "else from a replica's published copy"
            self.objstore.fetch(key, side)
        except OSError:
            self.stats["repair_failed"] += 1
            return False
        try:
            with open(side, "rb") as f:
                v = _segment.verify_buffer(f.read(), name=side)
            if not v["ok"]:
                raise SegmentError(f"repair copy corrupt: {v['reason']}")
            os.replace(side, dst)
            seg = Segment.open(dst)
            check = seg.verify()
            if check["corrupt"]:
                raise SegmentError(
                    f"repaired file re-failed verify: {check['corrupt']}")
        except (OSError, SegmentError) as e:
            log.warning("repair of %s/%s failed: %s", name, fn, e)
            try:
                os.unlink(side)
            except OSError:
                pass
            self.stats["repair_failed"] += 1
            return False
        info = store.unquarantine(name, seg)
        if info is not None:
            try:
                self.db.table(name).note_tier_publish(
                    seg.rows, seg.tmin, seg.tmax)
            except KeyError:
                pass
            # repaired rows re-enter service: the quarantine drop stays
            # on the ledger (those serves WERE lost during the gap); the
            # repair is its own conserved event
            self._telemetry.hop("storage.repair").account(
                emitted=seg.rows, delivered=seg.rows)
        self.stats["repaired"] += 1
        return True

    # -- segcache: verify -> discard (next pin re-fetches) --------------------

    def _scrub_cache_entry(self, ent: dict, out: dict) -> int:
        seg = ent.get("seg")
        if seg is None:
            return 0
        v = seg.verify()
        out["scanned"] += 1
        self.stats["cache_scanned"] += 1
        self.stats["bytes_scanned"] += v["bytes"]
        if v["corrupt"]:
            out["corrupt"] += 1
            self.stats["cache_corrupt"] += 1
            self._hop.account(emitted=1, dropped=1, reason="corrupt")
            # a cached copy is never authoritative: drop it and let the
            # next pin re-fetch + re-verify from the objstore
            if self.segcache is not None:
                self.segcache.discard(ent.get("key"))
            out["repaired"] += 1
            return v["bytes"]
        if v["verifiable"]:
            out["clean"] += 1
            self.stats["clean"] += 1
        else:
            out["unverifiable"] += 1
            self.stats["unverifiable"] += 1
        self._hop.account(emitted=1, delivered=1)
        return v["bytes"]

    # -- objstore blobs: verify -> re-publish from local ----------------------

    def _scrub_blob(self, name: str, key: str, out: dict) -> int:
        try:
            data = self.objstore.get_bytes(key)
        except OSError:
            return 0  # GC'd between list and read — not a fault
        v = _segment.verify_buffer(data, name=key)
        out["scanned"] += 1
        self.stats["blobs_scanned"] += 1
        self.stats["bytes_scanned"] += len(data)
        if v["ok"]:
            if v["verifiable"]:
                out["clean"] += 1
                self.stats["clean"] += 1
            else:
                out["unverifiable"] += 1
                self.stats["unverifiable"] += 1
            self._hop.account(emitted=1, delivered=1)
            return len(data)
        out["corrupt"] += 1
        self.stats["blobs_corrupt"] += 1
        self._hop.account(emitted=1, dropped=1, reason="corrupt")
        # the published copy rotted: delete it and re-publish from the
        # local authoritative segment when that one is still healthy —
        # this shard IS the healthy peer for its own blobs
        self.objstore.delete(key)
        fn = key.split("/")[-1]
        store = getattr(self.db, "tier_store", None)
        tt = store.tables().get(name) if store is not None else None
        local = None
        if tt is not None:
            local = next((s for s in tt.segments()
                          if os.path.basename(s.path) == fn), None)
        if local is not None and not local.verify()["corrupt"]:
            try:
                self.objstore.put_if_absent(key, src_path=local.path)
                self.stats["blobs_republished"] += 1
                out["repaired"] += 1
            except OSError as e:
                log.warning("re-publish of %s failed: %s", key, e)
                out["repair_failed"] += 1
        else:
            out["repair_failed"] += 1
        return len(data)

    # -- thread ---------------------------------------------------------------

    def start(self) -> "Scrubber":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="df-scrub", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        hb = self._telemetry.heartbeat(
            "scrub", interval_hint_s=max(1.0, self.interval_s))
        hb.beat()
        while not self._stop.wait(self.interval_s):
            hb.beat(progress=self.stats["cycles"])
            try:
                self.scrub_once()
            except Exception:
                self.stats["errors"] += 1
                log.exception("scrub cycle failed")

    def snapshot(self) -> dict:
        """Health-block view (/v1/health storage.scrub)."""
        out = dict(self.stats)
        out["interval_s"] = self.interval_s
        out["cycle_bytes"] = self.cycle_bytes
        return out
