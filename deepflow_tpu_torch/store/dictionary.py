"""String <-> small-int id dictionaries for string columns.

Own copy of ``deepflow_tpu/store/dictionary.py::Dictionary`` (without the
native mirror that serves the reference's C++ decode path), with the
query side's ``match_ids`` and collation ranks. Id 0 is always the empty
string.
"""

from __future__ import annotations

import threading

import numpy as np


class Dictionary:
    """Append-only string dictionary. Thread-safe encode; decode reads the
    append-only list without a lock."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._str_to_id: dict[str, int] = {"": 0}
        self._strings: list[str] = [""]

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
                        out[i] = sid
        return np.fromiter(out, dtype=np.uint32, count=len(out))

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

    def _snapshot(self) -> list[str]:
        with self._lock:
            return list(self._strings)

    def match_ids(self, predicate) -> np.ndarray:
        """Ids of all entries satisfying predicate(str): LIKE and ordered
        string filters resolve over the (small) dictionary, not the
        rows."""
        return np.fromiter(
            (i for i, s in enumerate(self._snapshot()) if predicate(s)),
            dtype=np.uint32)

    def collation_ranks(self) -> np.ndarray:
        """int64 rank of every id in the strings' sort order. Ids follow
        insertion order, so ORDER BY over a str column sorts by these."""
        strs = np.asarray(self._snapshot(), dtype=object)
        rank = np.empty(len(strs), dtype=np.int64)
        rank[np.argsort(strs, kind="stable")] = np.arange(
            len(strs), dtype=np.int64)
        return rank
