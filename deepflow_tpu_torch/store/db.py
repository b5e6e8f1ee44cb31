"""In-memory database: the named profile tables of schema.py.

Own copy of ``deepflow_tpu/store/db.py::Database`` without persistence,
storage tiers or migration.
"""

from __future__ import annotations

import threading

from deepflow_tpu_torch.store import schema
from deepflow_tpu_torch.store.table import ColumnarTable, ColumnSpec


class Database:
    """A set of named ColumnarTables, one per schema table."""

    def __init__(self, shard_id: int = 0, chunk_rows: int = 1 << 16) -> None:
        self.chunk_rows = chunk_rows
        # every ingested row with a shard_id column is stamped with the
        # receiving server's shard identity (0 = standalone)
        self.shard_id = shard_id
        self._tables: dict[str, ColumnarTable] = {}
        self._lock = threading.Lock()
        for name, cols in schema.TABLES.items():
            self.create_table(name, cols)

    def create_table(self, name: str,
                     columns: list[ColumnSpec]) -> ColumnarTable:
        with self._lock:
            if name in self._tables:
                return self._tables[name]
            t = ColumnarTable(name, columns, self.chunk_rows)
            if self.shard_id and "shard_id" in t.columns:
                t.fills["shard_id"] = self.shard_id
            self._tables[name] = t
            return t

    def table(self, name: str) -> ColumnarTable:
        try:
            return self._tables[name]
        except KeyError:
            raise KeyError(
                f"no such table {name!r}; known: {sorted(self._tables)}")

    def tables(self) -> list[str]:
        return sorted(self._tables)
