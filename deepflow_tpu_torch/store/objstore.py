"""Shared object store: the substrate of the disaggregated read tier.

Own copy of ``deepflow_tpu/store/objstore.py``, whole. The tier is
immutable after commit (a sealed segment file never changes; one
manifest rename is the only mutation), so the shared-storage half needs
exactly two primitives of a filesystem-backed S3-alike:

  - ``put_if_absent``: immutable blobs under content-stable keys.
    Re-publishing an already-published segment is a stat, not a
    re-upload, and a writer that dies mid-put leaves no torn blob.
  - an atomic **pointer swap**: one small mutable document per shard
    (``MANIFEST-<shard>``) naming the blob set that IS that shard's
    published state. Readers see the old pointer or the new one, never
    a half-published mix (tmp + fsync + rename, as the tier manifest).

Layout (``root`` is any shared filesystem path: NFS, a bind mount, or a
local directory in tests), the reference's key for key, so a store
written by either package is read by the other:

    <root>/
      blobs/
        seg/<shard>/<table>/seg_00000007.seg     <- immutable
        dicts/<shard>/<table>/<col>.g1.v42.json  <- immutable (versioned)
      ptr/
        MANIFEST-3                               <- atomic swap

``SegmentPublisher`` is the shard-side producer: after a tier commit
point (flush, compaction, eviction) it uploads the delta of ADOPTED
segments and dictionary dumps and swaps the pointer. Staged-but-unadopted
segments are not published: their rows are still served from the
shard's RAM copy, so a querier adopting them would count them twice.
Blob GC runs after the swap (never before: a reader of the old pointer
may still be fetching), and a querier that loses the race to a GC'd
blob skips it and re-polls the pointer. Read-only mirror roots back the
fetches (an immutable blob's copy elsewhere is byte-identical), and the
``objstore_eio`` chaos knob fails a blob write before any byte lands.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading

log = logging.getLogger("df.objstore")

_PTR_DIR = "ptr"
_BLOB_DIR = "blobs"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ObjStore:
    """Filesystem-backed object store: immutable blobs + pointer swaps.

    Keys are ``/``-separated paths (``seg/3/l7_flow_log/seg_...``);
    every write is tmp + fsync + rename so a concurrent reader never
    observes a torn blob, and two racing put_if_absent calls for the
    same key converge (the content is immutable by contract, so either
    rename winning yields the same bytes)."""

    def __init__(self, root: str,
                 mirrors: list[str] | None = None) -> None:
        self.root = root
        self._blobs = os.path.join(root, _BLOB_DIR)
        self._ptrs = os.path.join(root, _PTR_DIR)
        os.makedirs(self._blobs, exist_ok=True)
        os.makedirs(self._ptrs, exist_ok=True)
        # read-only alternate replica roots (a second NFS mount, a
        # backup bucket): fetch/get_bytes fall over to them when the
        # primary blob is missing or unreadable — the segcache/repair
        # paths' "alternate replica's published copy"
        self.mirrors = list(mirrors or [])
        self._mirror_blob_dirs = [os.path.join(m, _BLOB_DIR)
                                  for m in self.mirrors]
        # fault injection (chaos.ChaosInjector or None): consulted
        # before staging a blob write
        self.chaos = None
        self._lock = threading.Lock()
        self.stats = {"puts": 0, "put_skipped": 0, "gets": 0,
                      "deletes": 0, "pointer_swaps": 0,
                      "bytes_up": 0, "bytes_down": 0, "mirror_hits": 0}

    # -- blobs ---------------------------------------------------------------

    def _blob_path(self, key: str) -> str:
        if key.startswith(("/", "..")) or "/../" in key:
            raise ValueError(f"bad object key {key!r}")
        return os.path.join(self._blobs, *key.split("/"))

    def _mirror_paths(self, key: str) -> list[str]:
        parts = key.split("/")
        return [os.path.join(d, *parts) for d in self._mirror_blob_dirs]

    def exists(self, key: str) -> bool:
        return os.path.exists(self._blob_path(key))

    def put_if_absent(self, key: str, src_path: str | None = None,
                      data: bytes | None = None) -> bool:
        """Upload an immutable blob. Returns True when this call wrote
        it, False when it already existed (the common re-publish case).
        """
        path = self._blob_path(key)
        if os.path.exists(path):
            with self._lock:
                self.stats["put_skipped"] += 1
            return False
        if self.chaos is not None:
            # I/O fault injection: the put fails BEFORE any bytes land,
            # so a failed publish can never leave a torn blob behind
            self.chaos.on_objstore_write()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            if src_path is not None:
                shutil.copyfile(src_path, tmp)
            else:
                with open(tmp, "wb") as f:
                    f.write(data or b"")
            with open(tmp, "rb+") as f:
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _fsync_dir(os.path.dirname(path))
        size = os.path.getsize(path)
        with self._lock:
            self.stats["puts"] += 1
            self.stats["bytes_up"] += size
        return True

    def get_bytes(self, key: str) -> bytes:
        try:
            with open(self._blob_path(key), "rb") as f:
                data = f.read()
        except OSError:
            data = None
            for alt in self._mirror_paths(key):
                try:
                    with open(alt, "rb") as f:
                        data = f.read()
                    break
                except OSError:
                    continue
            if data is None:
                raise
            with self._lock:
                self.stats["mirror_hits"] += 1
        with self._lock:
            self.stats["gets"] += 1
            self.stats["bytes_down"] += len(data)
        return data

    def fetch(self, key: str, dst: str) -> int:
        """Copy a blob to a local path (the segcache fill). Returns the
        byte size. Raises FileNotFoundError when the blob was GC'd
        between pointer read and fetch — the caller skips and re-polls.
        A primary miss/error falls over to the mirror roots first: the
        alternate replica's copy of an immutable blob is byte-identical
        by contract (and the caller checksum-verifies it anyway)."""
        tmp = f"{dst}.tmp.{os.getpid()}.{threading.get_ident()}"
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        sources = [self._blob_path(key)] + self._mirror_paths(key)
        err: OSError | None = None
        for i, path in enumerate(sources):
            try:
                shutil.copyfile(path, tmp)
                os.replace(tmp, dst)
            except OSError as e:
                err = err or e
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                continue
            size = os.path.getsize(dst)
            with self._lock:
                if i:
                    self.stats["mirror_hits"] += 1
                self.stats["gets"] += 1
                self.stats["bytes_down"] += size
            return size
        raise err if err is not None else FileNotFoundError(key)

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._blob_path(key))
        except OSError:
            return False
        with self._lock:
            self.stats["deletes"] += 1
        return True

    def list_keys(self, prefix: str = "") -> list[str]:
        """All blob keys under a prefix (GC enumerates its shard's)."""
        base = self._blob_path(prefix) if prefix else self._blobs
        out = []
        for dirpath, _dirs, files in os.walk(base):
            rel = os.path.relpath(dirpath, self._blobs)
            for fn in files:
                if ".tmp." in fn:
                    continue
                out.append(fn if rel == "." else
                           "/".join(rel.split(os.sep) + [fn]))
        return sorted(out)

    # -- pointers ------------------------------------------------------------

    def _ptr_path(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad pointer name {name!r}")
        return os.path.join(self._ptrs, name)

    def set_pointer(self, name: str, doc: dict) -> None:
        """Atomic pointer swap: readers see the old doc or the new one."""
        path = self._ptr_path(name)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self._ptrs)
        with self._lock:
            self.stats["pointer_swaps"] += 1

    def get_pointer(self, name: str) -> dict | None:
        try:
            with open(self._ptr_path(name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def list_pointers(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self._ptrs)
                          if ".tmp." not in n)
        except OSError:
            return []


def seg_key(shard_id: int, table: str, fn: str) -> str:
    return f"seg/{shard_id}/{table}/{fn}"


def dict_key(shard_id: int, table: str, col: str,
             gen: int, version: int) -> str:
    return f"dicts/{shard_id}/{table}/{col}.g{gen}.v{version}.json"


def pointer_name(shard_id: int) -> str:
    return f"MANIFEST-{shard_id}"


class SegmentPublisher:
    """Shard-side producer: mirror the tier's adopted state into the
    object store and swap this shard's pointer.

    Runs strictly AFTER the local commit point (a published segment is
    always also durable locally), serialized by its own lock (flusher,
    compactor and janitor may all trigger a publish). Each publish:

      1. snapshot adopted segments + dict-dump states under the tier
         store lock (dump bytes are read under the same lock so a
         concurrent ``persist_dicts`` replace cannot interleave)
      2. upload new blobs (put_if_absent — already-published segments
         cost one stat each)
      3. bump ``publish_gen`` and swap ``MANIFEST-<shard>``
      4. GC this shard's blobs the new pointer no longer references

    The pointer doc is the read tier's whole contract:

        {"publish_gen": G, "shard_id": S,
         "tables": {name: {
             "segments": [{"fn","rows","tmin","tmax","bytes",
                           "time_col"}, ...],
             "dicts": {col: [gen, version]}}}}
    """

    def __init__(self, store: ObjStore, shard_id: int) -> None:
        self.store = store
        self.shard_id = shard_id
        self._lock = threading.Lock()
        ptr = store.get_pointer(pointer_name(shard_id)) or {}
        # survive restarts monotonic: a querier compares gens to detect
        # staleness, so a restarted shard must not reuse old gen numbers
        self.publish_gen = int(ptr.get("publish_gen", 0))
        self.stats = {"publishes": 0, "segments_uploaded": 0,
                      "dicts_uploaded": 0, "blobs_gced": 0,
                      "upload_errors": 0}
        # (gen, {table: frozenset(fns)}) of the CURRENT pointer — ONE
        # reference, swapped in a single assignment so the shard-exec
        # handshake (which must not block on the publish lock mid-
        # upload) always reads a gen with ITS fn sets. The handshake
        # excludes these segments from the shard's own answer when the
        # coordinator's adopted gen matches — the read tier serves
        # them; see store/segcache.py PublishedExcludeView.
        # Gen 0 until this process publishes: a restarted shard's last
        # pointer names segments it has not listed here, so it must not
        # ack a querier that adopted that pointer (the reference starts
        # at the pointer's gen, and its empty fn sets would ack with
        # nothing excluded and count those rows twice)
        self.current: tuple[int, dict[str, frozenset]] = (0, {})
        # signature of the last published state ({table: (fns, dict
        # states)}) — maybe_publish() compares against the live tier so
        # the server's publish loop costs one lock-guarded listdir-free
        # scan per tick when nothing sealed. None => never published
        # this process, so the first tick always publishes (restart
        # recovery: re-publishing an unchanged state is cheap, every
        # blob put is a stat).
        self._last_sig: dict | None = None

    def _tier_sig(self, tier_store) -> dict:
        """Cheap change signature of the adopted tier state: per table,
        the sorted segment basenames + persisted dict-dump states. Any
        flush confirm, compaction, eviction or dict persist changes it;
        heartbeat ticks with no commit in between do not."""
        sig: dict[str, tuple] = {}
        with tier_store._lock:
            for name, tt in tier_store.tables().items():
                fns = tuple(sorted(os.path.basename(s.path)
                                   for s in tt.segments() if s.rows))
                dicts = tuple(sorted(
                    (col, gen, ver)
                    for col, (gen, ver) in tt._dict_dumped.items()))
                if fns or dicts:
                    sig[name] = (fns, dicts)
        return sig

    def maybe_publish(self, tier_store) -> dict | None:
        """Publish only when the tier's adopted state changed since the
        last successful publish. Returns the publish round stats, or
        None for a no-op tick. A round with upload errors leaves the
        recorded signature derived from what actually made it into the
        pointer, so the next tick retries automatically."""
        sig = self._tier_sig(tier_store)
        with self._lock:
            if self._last_sig is not None and sig == self._last_sig:
                return None
        return self.publish(tier_store)

    def _snapshot(self, tier_store) -> dict:
        """Adopted-only view of the tier + dict dump bytes, captured
        under the tier store lock so it is internally consistent (the
        dumps listed cover every id the listed segments use)."""
        snap: dict[str, dict] = {}
        with tier_store._lock:
            for name, tt in tier_store.tables().items():
                segs = tt.segments()
                if not segs and not tt._dict_dumped:
                    continue
                dicts = {}
                for col, (gen, ver) in tt._dict_dumped.items():
                    try:
                        with open(tt.dict_path(col), "rb") as f:
                            raw = f.read()
                    except OSError:
                        continue
                    dicts[col] = (gen, ver, raw)
                snap[name] = {
                    "segments": [
                        {"fn": os.path.basename(s.path), "path": s.path,
                         "rows": s.rows, "tmin": s.tmin, "tmax": s.tmax,
                         "bytes": s.nbytes, "time_col": s.time_col}
                        for s in segs if s.rows],
                    "dicts": dicts,
                }
        return snap

    def publish(self, tier_store) -> dict:
        """One pointer-swap round. Returns per-round counters."""
        with self._lock:
            snap = self._snapshot(tier_store)
            round_stats = {"segments_uploaded": 0, "dicts_uploaded": 0,
                           "blobs_gced": 0}
            tables_doc: dict[str, dict] = {}
            referenced: set[str] = set()
            for name, ent in snap.items():
                seg_docs = []
                for sd in ent["segments"]:
                    key = seg_key(self.shard_id, name, sd["fn"])
                    try:
                        if self.store.put_if_absent(
                                key, src_path=sd.pop("path")):
                            round_stats["segments_uploaded"] += 1
                    except OSError:
                        # local file vanished (evict/compact raced the
                        # snapshot) or the share hiccuped: publish what
                        # made it, the next round converges
                        self.stats["upload_errors"] += 1
                        continue
                    referenced.add(key)
                    seg_docs.append(sd)
                dict_doc = {}
                for col, (gen, ver, raw) in ent["dicts"].items():
                    key = dict_key(self.shard_id, name, col, gen, ver)
                    try:
                        if self.store.put_if_absent(key, data=raw):
                            round_stats["dicts_uploaded"] += 1
                    except OSError:
                        self.stats["upload_errors"] += 1
                        continue
                    referenced.add(key)
                    dict_doc[col] = [gen, ver]
                tables_doc[name] = {"segments": seg_docs,
                                    "dicts": dict_doc}
            self.publish_gen += 1
            self._last_sig = {
                name: (tuple(sorted(sd["fn"] for sd in ent["segments"])),
                       tuple(sorted(
                           (c, g, v)
                           for c, (g, v) in ent["dicts"].items())))
                for name, ent in tables_doc.items()
                if ent["segments"] or ent["dicts"]}
            self.current = (self.publish_gen, {
                name: frozenset(sd["fn"] for sd in ent["segments"])
                for name, ent in tables_doc.items() if ent["segments"]})
            self.store.set_pointer(pointer_name(self.shard_id), {
                "publish_gen": self.publish_gen,
                "shard_id": self.shard_id,
                "tables": tables_doc,
            })
            # GC AFTER the swap: blobs only this shard's old pointers
            # referenced. A racing reader of the old pointer that loses
            # a blob skips it and re-polls — never a wrong answer. A
            # quarantined segment's blob is kept: it is the copy its
            # repair fetches (the reference deletes it when a publish
            # runs between the quarantine and the repair)
            for name, fns in tier_store.quarantined().items():
                referenced.update(seg_key(self.shard_id, name, fn)
                                  for fn in fns)
            for prefix in (f"seg/{self.shard_id}",
                           f"dicts/{self.shard_id}"):
                for key in self.store.list_keys(prefix):
                    if key not in referenced and self.store.delete(key):
                        round_stats["blobs_gced"] += 1
            self.stats["publishes"] += 1
            for k, v in round_stats.items():
                self.stats[k] += v
            round_stats["publish_gen"] = self.publish_gen
            return round_stats
