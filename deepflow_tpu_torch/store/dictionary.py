"""String <-> small-int id dictionaries for string columns.

Own copy of ``deepflow_tpu/store/dictionary.py::Dictionary``, with its
native mirror for ``encode_arena`` (the columnar span decoder's string
cells interned in C++), the query side's ``match_ids`` and collation
ranks, the JSON ``dump`` / ``load`` the storage tier persists, and the
change counters of ``sync_state`` that the query cache
validates against. Id 0 is always the empty string.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from deepflow_tpu_torch.native import NativeDict


class Dictionary:
    """Append-only string dictionary. Thread-safe encode; decode reads the
    append-only list without a lock."""

    def __init__(self, name: str = "", strings: list[str] | None = None
                 ) -> None:
        """``strings``, when given, are the entries in id order, the first
        of them ""."""
        self.name = name
        self._lock = threading.Lock()
        self._strings: list[str] = list(strings) if strings else [""]
        self._str_to_id = {s: i for i, s in enumerate(self._strings)}
        # C++ twin for encode_arena: entry i of the native table is the
        # UTF-8 of _strings[i] for every i < _native_synced. Built at the
        # first encode_arena; entries added in Python since then are
        # loaded before each native batch, and the native batch's new
        # strings are fetched back, all under _lock.
        self._native: NativeDict | None = None
        self._native_synced = 0
        # change counters for exact cache invalidation (query/cache.py):
        #   version — bumped on every insert; equal versions => equal content
        #   gen     — bumped when id->string bindings are REPLACED (the
        #             table's compaction builds the next gen). Same gen and
        #             a longer dictionary is a pure append: ids handed out
        #             before stay valid.
        self.version = 0
        self.gen = 0

    def __len__(self) -> int:
        return len(self._strings)

    def encode(self, s: str) -> int:
        sid = self._str_to_id.get(s)
        if sid is not None:
            return sid
        with self._lock:
            sid = self._str_to_id.get(s)
            if sid is None:
                sid = len(self._strings)
                self._strings.append(s)
                self._str_to_id[s] = sid
                self.version += 1
            return sid

    def encode_batch(self, values) -> np.ndarray:
        """uint32 ids for a sequence of strings: one dict lookup per cell,
        and one lock acquisition for all the strings not seen before."""
        get = self._str_to_id.get
        out = [get(s) for s in values]
        if None in out:
            with self._lock:
                for i, sid in enumerate(out):
                    if sid is None:
                        s = values[i]
                        sid = get(s)  # may have raced in since the scan
                        if sid is None:
                            sid = len(self._strings)
                            self._strings.append(s)
                            self._str_to_id[s] = sid
                            self.version += 1
                        out[i] = sid
        return np.fromiter(out, dtype=np.uint32, count=len(out))

    def encode_arena(self, arena: np.ndarray, offs: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
        """uint32 ids of string cells given as (off, len) in a byte arena
        of UTF-8, interned by the C++ mirror under one lock acquisition:
        a cell becomes a Python string only when it is new to the
        dictionary."""
        out = np.empty(len(offs), dtype=np.uint32)
        with self._lock:
            try:
                nd = self._native
                if nd is None:
                    nd = self._native = NativeDict()
                    self._native_synced = 1  # "" is id 0 on both sides
                if self._native_synced < len(self._strings):
                    # surrogatepass: a str no UTF-8 arena cell can equal
                    nd.load_entries(
                        [s.encode("utf-8", "surrogatepass")
                         for s in self._strings[self._native_synced:]])
                    if len(nd) != len(self._strings):
                        raise RuntimeError(
                            f"{self.name}: native dictionary misaligned")
                before = len(self._strings)
                after = nd.encode_arena(arena, offs, lens, out)
                for sid in range(before, after):
                    s = nd.get(sid).decode("utf-8")
                    if s in self._str_to_id:
                        raise RuntimeError(
                            f"{self.name}: native dictionary misaligned")
                    self._str_to_id[s] = sid
                    self._strings.append(s)
                    self.version += 1
                self._native_synced = after
            except BaseException:
                # the twin may hold entries Python never adopted: the
                # next batch builds a fresh one
                self._native = None
                raise
        return out

    def decode(self, sid: int) -> str:
        strings = self._strings
        return strings[sid] if 0 <= sid < len(strings) else ""

    def decode_many(self, ids: np.ndarray) -> list[str]:
        strings = self._strings
        n = len(strings)
        return [strings[i] if 0 <= i < n else "" for i in ids.tolist()]

    def lookup(self, s: str) -> int | None:
        """The id of s without inserting it (query side)."""
        return self._str_to_id.get(s)

    def sync_state(self) -> tuple[int, int, int]:
        """(gen, len, version): the id-validity token the query cache and
        the encoded partials carry."""
        with self._lock:
            return (self.gen, len(self._strings), self.version)

    def snapshot(self) -> list[str]:
        with self._lock:
            return list(self._strings)

    def strings_slice(self, start: int, end: int) -> list[str]:
        """Entries [start:end), a federation dict-sync delta
        (``cluster/dictsync.py``). The list only grows within a gen, so
        a bounded slice needs no lock."""
        return self._strings[start:end]

    def match_ids(self, predicate) -> np.ndarray:
        """Ids of all entries satisfying predicate(str): LIKE and ordered
        string filters resolve over the (small) dictionary, not the
        rows."""
        return np.fromiter(
            (i for i, s in enumerate(self.snapshot()) if predicate(s)),
            dtype=np.uint32)

    # -- persistence ---------------------------------------------------------

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f)

    @classmethod
    def load(cls, path: str, name: str = "") -> "Dictionary":
        with open(path) as f:
            d = cls(name, json.load(f))
        d.version = len(d._strings)
        d.gen = 1  # ids from any process before the load are not comparable
        return d

    def collation_ranks(self) -> np.ndarray:
        """int64 rank of every id in the strings' sort order. Ids follow
        insertion order, so ORDER BY over a str column sorts by these."""
        strs = np.asarray(self.snapshot(), dtype=object)
        rank = np.empty(len(strs), dtype=np.int64)
        rank[np.argsort(strs, kind="stable")] = np.arange(
            len(strs), dtype=np.int64)
        return rank
