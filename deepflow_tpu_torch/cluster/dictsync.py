"""Cross-shard dictionary synchronization for int-key federation.

Own copy of ``deepflow_tpu/cluster/dictsync.py``.

SmartEncoding ids are shard-local: "svc-a" may be id 7 on one shard and
id 91 on another. To merge encoded partials without decoding every group
key to strings, the coordinator mirrors each shard dictionary's string
prefix and keeps a memoized remap table shard-id -> LOCAL-dict-id. Merge
space is always the coordinator's own table dictionaries, so the
presentation edge decodes exactly as it does for local queries.

Protocol (rides the sql_partial scatter, see server/querier.py and
cluster/federation.py):

- coordinator request carries ``"dict_known": {shard: {col: [gen, len]}}``
  — the prefix of each shard dictionary it already mirrors;
- shard reply carries ``"dict_sync": {col: {"gen", "len", "base",
  "delta": [strings]}}`` — only the strings past ``base``; a gen change
  (shard-side compaction/reload rebinds ids) ships ``base=0``, a full
  resync;
- the coordinator applies deltas, then remaps every id column in the
  partial before engine.merge_partials().

Dictionaries grow append-only within a gen, so a delta is a pure
extension and previously-built remap entries stay valid; only the new
tail is encoded into the local dictionary.
"""

from __future__ import annotations

import threading

import numpy as np


class DictSyncError(Exception):
    """Shard partial references ids the mirror cannot cover (malformed
    delta or gen race) — the caller treats the shard result as failed."""


class DictSync:
    """Coordinator-side shard-dictionary mirrors + id remap tables."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (shard_id, table, col) -> {"gen": int, "strings": [str, ...]}
        self._mirrors: dict[tuple, dict] = {}
        # (shard_id, table, col) -> {"gen", "local_id", "local_gen",
        #                            "n", "arr"}: shard id -> local id
        self._remaps: dict[tuple, dict] = {}
        self.counters = {"deltas_applied": 0, "strings_synced": 0,
                         "full_resyncs": 0, "remap_rebuilds": 0,
                         "ids_remapped": 0}

    def known_state(self, shard_id: int, table: str) -> dict:
        """{col: [gen, len]} of mirrored prefixes, for the request body."""
        with self._lock:
            return {col: [m["gen"], len(m["strings"])]
                    for (sh, tb, col), m in self._mirrors.items()
                    if sh == shard_id and tb == table}

    def apply_sync(self, shard_id: int, table: str, col: str,
                   sync: dict) -> bool:
        """Fold one shard dict_sync delta into the mirror."""
        try:
            gen, ln = int(sync["gen"]), int(sync["len"])
            base = int(sync["base"])
            delta = list(sync.get("delta") or [])
        except (KeyError, TypeError, ValueError):
            return False
        k = (shard_id, table, col)
        with self._lock:
            m = self._mirrors.get(k)
            if m is None or m["gen"] != gen or base != len(m["strings"]):
                if base != 0:
                    # delta against a prefix we don't hold — drop the
                    # mirror so the next round requests a full resync
                    self._mirrors.pop(k, None)
                    self._remaps.pop(k, None)
                    return False
                if m is not None:
                    self.counters["full_resyncs"] += 1
                m = self._mirrors[k] = {"gen": gen, "strings": []}
                self._remaps.pop(k, None)
            m["strings"].extend(delta)
            if len(m["strings"]) != ln:
                self._mirrors.pop(k, None)
                self._remaps.pop(k, None)
                return False
            self.counters["deltas_applied"] += 1
            self.counters["strings_synced"] += len(delta)
            return True

    def _remap_array(self, shard_id: int, table: str, col: str,
                     local_dict, want_gen: int, need_len: int):
        """shard-id -> local-id uint32 table covering the mirror, or None
        when the mirror is absent/short/stale for `want_gen`."""
        k = (shard_id, table, col)
        with self._lock:
            m = self._mirrors.get(k)
            if m is None or m["gen"] != want_gen or \
                    len(m["strings"]) < need_len:
                return None
            strings = m["strings"]
            lgen = local_dict.gen
            r = self._remaps.get(k)
            if (r is None or r["gen"] != m["gen"]
                    or r["local_id"] != id(local_dict)
                    or r["local_gen"] != lgen):
                r = self._remaps[k] = {
                    "gen": m["gen"], "local_id": id(local_dict),
                    "local_gen": lgen, "n": 0,
                    "arr": np.empty(0, dtype=np.uint32)}
                self.counters["remap_rebuilds"] += 1
            if r["n"] < len(strings):
                ext = np.fromiter(
                    (local_dict.encode(s) for s in strings[r["n"]:]),
                    dtype=np.uint32, count=len(strings) - r["n"])
                r["arr"] = np.concatenate([r["arr"], ext])
                r["n"] = len(strings)
            return r["arr"]

    def remap_partial(self, shard_id: int, table: str, partial: dict,
                      local_dicts: dict) -> dict:
        """Map every dictionary-id column of an encoded partial into the
        coordinator's local dictionaries (captured `local_dicts` snapshot
        so a concurrent local compaction can't skew the merge). Returns a
        new partial ready for the vectorized merge; partials with no
        encoded dict columns pass through untouched."""
        dicts = partial.get("dicts") or {}
        for col, sync in (partial.get("dict_sync") or {}).items():
            self.apply_sync(shard_id, table, col, sync)
        if not dicts or partial.get("kind") != "agg":
            out = dict(partial)
            out.pop("dict_sync", None)
            return out

        def map_ids(col: str, ids: np.ndarray) -> np.ndarray:
            local = local_dicts.get(col)
            if local is None:
                raise DictSyncError(
                    f"no local dictionary for column {col!r}")
            gen, ln = (int(x) for x in dicts.get(col, (0, 0)))
            need = max(ln, int(ids.max(initial=0)) + 1 if len(ids) else 0)
            arr = self._remap_array(shard_id, table, col, local, gen, need)
            if arr is None:
                raise DictSyncError(
                    f"mirror for shard {shard_id} col {col!r} does not "
                    f"cover gen {gen} len {need}")
            out = arr[ids.astype(np.int64)]
            with self._lock:
                self.counters["ids_remapped"] += len(out)
            return out

        def map_col(c):
            if isinstance(c, dict) and "e" in c:
                ids = np.asarray(c["ids"], dtype=np.uint32)
                return {"e": c["e"], "ids": map_ids(c["e"], ids)}
            return c

        out = dict(partial)
        out["keys"] = [map_col(c) for c in partial.get("keys", [])]
        out["items"] = {k: map_col(v)
                        for k, v in partial.get("items", {}).items()}
        sites = {}
        for sk, st in partial.get("sites", {}).items():
            if isinstance(st, dict) and "ed" in st:
                sets = st["sets"]
                flat = np.asarray([i for g in sets for i in g],
                                  dtype=np.uint32)
                mapped = (map_ids(st["ed"], flat) if len(flat)
                          else flat)
                splits = np.cumsum([len(g) for g in sets])[:-1]
                sites[sk] = {"ed": st["ed"],
                             "sets": [p.astype(np.int64).tolist()
                                      for p in np.split(mapped, splits)]}
            else:
                sites[sk] = st
        out["sites"] = sites
        out.pop("dict_sync", None)
        out.pop("dicts", None)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"mirrors": len(self._mirrors), **self.counters}


def build_sync(table, cols: dict, known: dict) -> dict | None:
    """Shard-side half: delta of each used dictionary past what the
    coordinator says it knows. `cols` is the partial's {col: [gen, len]}
    manifest; `known` the coordinator's {col: [gen, len]} claim. Returns
    the dict_sync payload, or None if a dictionary flipped gen since the
    partial was built (caller re-runs decoded)."""
    out = {}
    for col, (pgen, plen) in cols.items():
        d = table.dicts.get(col)
        if d is None:
            return None
        gen, ln, _ver = d.sync_state()
        if gen != int(pgen):
            return None  # compaction landed between build and reply
        kgen, klen = (int(x) for x in (known.get(col) or (-1, 0)))
        base = klen if kgen == gen and klen <= ln else 0
        out[col] = {"gen": gen, "len": ln, "base": base,
                    "delta": d.strings_slice(base, ln)}
    return out
