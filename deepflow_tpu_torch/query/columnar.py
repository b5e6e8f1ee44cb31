"""Columnar query helpers over a table's numpy columns.

The reference server computes its TPU queries in DF-SQL
(``deepflow_tpu/query/sql.py`` + ``engine.py``). The port answers the
same queries with these helpers: a filter of (column, op, value)
conditions joined by AND, a plain row select with an optional ascending
sort, and a group-by with Sum and Count, ORDER BY and LIMIT. Conditions
and results speak decoded values: strings for str columns, labels for
enum columns, ints for the rest.

Sums add in uint64: exact below 2**64, wrapping past it as the column
widths do. The reference adds in float64, which agrees while a sum stays
below 2**53. Rows that tie on the sort key keep their
table order (select) or their key order (group); the reference leaves
that order unspecified.
"""

from __future__ import annotations

import numpy as np

from deepflow_tpu_torch.store.table import ColumnarTable, ColumnSpec

OPS = ("=", "!=", "<", "<=", ">", ">=", "in")


def _encode(spec: ColumnSpec, table: ColumnarTable, value):
    """The stored form of a decoded value, or None when no stored value
    can equal it (a string the dictionary never saw, an unknown label)."""
    if spec.kind == "str":
        return table.dicts[spec.name].lookup(str(value))
    if spec.kind == "enum":
        return (spec.enum_of(value) if value in spec.enum_values
                else None)
    return int(value)


def _coded(spec: ColumnSpec) -> bool:
    """Stored as ids whose order is not the values' order."""
    return spec.kind in ("str", "enum")


def _condition(table: ColumnarTable, a: np.ndarray, cond) -> np.ndarray:
    name, op, value = cond
    spec = table.columns[name]
    if op == "in":
        ids = [i for i in (_encode(spec, table, v) for v in value)
               if i is not None]
        return np.isin(a, np.asarray(ids, dtype=a.dtype))
    if _coded(spec) and op not in ("=", "!="):
        raise ValueError(f"{name} {op} {value!r}: {spec.kind} columns "
                         "take =, != and in")
    v = _encode(spec, table, value)
    if v is None:  # a string or label the column never held
        return np.full(len(a), op == "!=")
    return {"=": np.equal, "!=": np.not_equal, "<": np.less,
            "<=": np.less_equal, ">": np.greater,
            ">=": np.greater_equal}[op](a, v)


def _scan(table: ColumnarTable, names: list[str], where
          ) -> dict[str, np.ndarray]:
    """The named columns of the rows that pass every condition."""
    for name, op, _ in where:
        if name not in table.columns:
            raise KeyError(f"{table.name} has no column {name!r}")
        if op not in OPS:
            raise ValueError(f"unknown operator {op!r}")
    need = list(dict.fromkeys([*names, *(c[0] for c in where)]))
    cols = table.column_concat(need)
    if not where:
        return cols
    mask = np.ones(len(cols[need[0]]), dtype=bool)
    for cond in where:
        mask &= _condition(table, cols[cond[0]], cond)
    return {n: cols[n][mask] for n in names}


def _decode(table: ColumnarTable, name: str, a: np.ndarray) -> list:
    spec = table.columns[name]
    if spec.kind == "str":
        return table.dicts[name].decode_many(a)
    if spec.kind == "enum":
        labels = spec.enum_values
        return [labels[i] for i in a.tolist()]
    return a.tolist()


def select(table: ColumnarTable, names: list[str], where=(),
           order_by: str | None = None) -> list[list]:
    """Rows of the named columns, decoded, that pass every condition; in
    table order, or stably sorted ascending by order_by, a numeric
    column."""
    cols = _scan(table, [*names, *([order_by] if order_by else [])], where)
    if order_by:
        if _coded(table.columns[order_by]):
            raise ValueError(f"select sorts by numeric columns, not "
                             f"{order_by!r}")
        idx = np.argsort(cols[order_by], kind="stable")
        cols = {n: a[idx] for n, a in cols.items()}
    return [list(r) for r in zip(*(_decode(table, n, cols[n])
                                   for n in names))]


def group(table: ColumnarTable, keys: list[str], sums: list[str] = (),
          count: bool = False, where=(), order_by: str | None = None,
          desc: bool = False, limit: int | None = None) -> list[list]:
    """One row per distinct key tuple among the rows passing every
    condition: the decoded keys, Sum of each column in sums, then the
    row count if count. order_by names a key, a summed column or
    "count"; limit keeps the first rows after the sort."""
    cols = _scan(table, [*keys, *sums], where)
    n = len(cols[keys[0]])
    if n == 0:
        return []
    order = np.lexsort([cols[k] for k in reversed(keys)])
    ks = [cols[k][order] for k in keys]
    change = np.zeros(n, dtype=bool)
    change[0] = True
    for k in ks:
        change[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(change)
    out = [_decode(table, k, a[starts]) for k, a in zip(keys, ks)]
    for s in sums:
        vals = cols[s][order].astype(np.uint64)
        out.append(np.add.reduceat(vals, starts).tolist())
    if count:
        out.append(np.diff(np.append(starts, n)).tolist())
    rows = [list(r) for r in zip(*out)]
    if order_by is not None:
        names = [*keys, *sums, *(["count"] if count else [])]
        i = names.index(order_by)
        # sorted() is stable both ways: ties keep their key order
        rows.sort(key=lambda r: r[i], reverse=desc)
    return rows[:limit] if limit is not None else rows
