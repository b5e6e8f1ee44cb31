"""Columnar table with dictionary-encoded string columns, in memory.

Own copy of the parts of ``deepflow_tpu/store/table.py`` that the
profile tables use: ``ColumnSpec`` and a ``ColumnarTable`` that appends
row batches or column batches as immutable chunks (dict column name ->
np.ndarray) and hands readers a snapshot of the chunk list. Values are
cast to the column's numpy dtype with ``astype``, so a value outside the
column's width wraps, as the reference's columnar decode path does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from deepflow_tpu_torch.store.dictionary import Dictionary

_DTYPES = {
    "u8": np.uint8, "u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
    "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
    "f32": np.float32, "f64": np.float64,
    "str": np.uint32,   # dictionary-encoded
    "enum": np.uint16,  # index into the spec's enum_values
}


def _cast(values: list, dtype) -> np.ndarray:
    """A list of Python numbers cast to dtype as astype casts. Integers
    never pass through float64, which np.asarray takes for ints past
    2**63 mixed with smaller ones."""
    if not np.issubdtype(dtype, np.integer):
        return np.asarray(values).astype(dtype)
    try:
        a = np.asarray(values, dtype=np.int64)
    except OverflowError:  # ints of 2**63 and up (none negative)
        a = np.asarray(values, dtype=np.uint64)
    return a.astype(dtype)


@dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str                      # key of _DTYPES
    enum_values: tuple[str, ...] = ()  # for kind == "enum": index -> label
    default: object = 0

    @property
    def np_dtype(self):
        return _DTYPES[self.kind]

    def enum_of(self, label: str) -> int:
        return self.enum_values.index(label)


class ColumnarTable:
    """Append-only columnar table; one string dictionary per str column.

    Appends and snapshots take one lock; a snapshot merges the chunks
    appended since the last one, so readers scan one chunk per table."""

    def __init__(self, name: str, columns: list[ColumnSpec]) -> None:
        self.name = name
        self.columns = {c.name: c for c in columns}
        self.dicts: dict[str, Dictionary] = {
            c.name: Dictionary(f"{name}.{c.name}")
            for c in columns if c.kind == "str"}
        self._chunks: list[dict[str, np.ndarray]] = []
        self._lock = threading.Lock()
        self.rows_written = 0
        # per-table fill overrides: the value a column takes when a write
        # omits it, instead of the schema default (Database stamps
        # shard_id through this)
        self.fills: dict[str, object] = {}

    def _fill(self, name: str, spec: ColumnSpec):
        return self.fills.get(name, "" if spec.kind == "str"
                              else spec.default)

    def _column(self, name: str, spec: ColumnSpec, v, n: int) -> np.ndarray:
        """One column's values (a sequence of n, or a scalar meaning "this
        value in every row") in the column's stored form."""
        if spec.kind == "str":
            d = self.dicts[name]
            if isinstance(v, (list, np.ndarray)):
                return d.encode_batch(v)
            return np.full(n, d.encode(v), dtype=np.uint32)
        if isinstance(v, np.ndarray):
            return v.astype(spec.np_dtype)
        if isinstance(v, list):
            return _cast(v, spec.np_dtype)
        return np.full(n, _cast([v], spec.np_dtype)[0])

    def append_rows(self, rows: list[dict]) -> None:
        """Append a batch of row dicts. Missing columns take the fill."""
        if not rows:
            return
        cols = {name: [r.get(name, self._fill(name, spec)) for r in rows]
                for name, spec in self.columns.items()}
        self.append_columns(cols, len(rows))

    def append_columns(self, cols: dict[str, list | np.ndarray],
                       n: int | None = None) -> None:
        """Column-oriented append. A column value may be a scalar, meaning
        "this value for every row in the batch"; a missing column takes
        the fill."""
        if n is None:
            n = len(next(iter(cols.values())))
        for name, v in cols.items():
            if isinstance(v, (list, np.ndarray)) and len(v) != n:
                raise ValueError(
                    f"{self.name}: column {name!r} has {len(v)} values, "
                    f"expected {n}")
        if n == 0:
            return
        chunk = {name: self._column(name, spec,
                                    cols.get(name, self._fill(name, spec)),
                                    n)
                 for name, spec in self.columns.items()}
        with self._lock:
            self._chunks.append(chunk)
            self.rows_written += n

    def snapshot(self) -> list[dict[str, np.ndarray]]:
        with self._lock:
            if len(self._chunks) > 1:
                self._chunks = [{
                    name: np.concatenate([ch[name] for ch in self._chunks])
                    for name in self.columns}]
            return list(self._chunks)

    def column_concat(self, names: list[str]) -> dict[str, np.ndarray]:
        """The named columns over every row, from one snapshot."""
        chunks = self.snapshot()
        return {name: (np.concatenate([ch[name] for ch in chunks]) if chunks
                       else np.empty(0, dtype=self.columns[name].np_dtype))
                for name in names}

    def __len__(self) -> int:
        return self.rows_written
