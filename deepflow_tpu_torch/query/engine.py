"""Vectorized DF-SQL executor over ColumnarTables.

Own copy of ``deepflow_tpu/query/engine.py`` over the port's store: the
AST compiles to numpy ops over one view of the table (its chunks and the
dictionaries that decode them), with LIKE, IN and string comparisons
resolved over the (small) dictionaries rather than the rows. Execution
stays dictionary-ENCODED end to end: the WHERE filters ids, grouping,
HAVING, ORDER BY and LIMIT run on int columns (ORDER BY over a str
column through the dictionary's collation ranks), and only the final
rows are decoded to strings. DF_QUERY_ENCODED=0 selects the
decode-then-Python-sort path the reference keeps for parity checks.

The native kernels of ``native/qexec.cpp`` do the filter (index lists),
the GROUP BY (one hash pass) and the aggregates (a fused gather and
segmented reduce), each chosen per call against its numpy path by a
learned cost model (``query/costmodel.py``); both give the same bytes.
Aggregate queries over two morsels or more may run morsel-parallel on
the scan pool (``query/pool.py``; DF_QUERY_PARALLEL, DF_QUERY_THREADS,
DF_QUERY_MORSEL_ROWS), each morsel folding into an encoded partial
(``execute_partial`` / ``combine_partials`` / ``merge_partials``), with
the serial scan's bytes. Every scan reports its spans to the active
query trace (``query/qtrace.py``).

Aggregates add in float64, as the reference's do: a Sum of integers is
exact while it stays below 2**53. Groups come out in ascending key
order; rows that tie on every ORDER BY key have no specified order.

Scans over a table with a storage tier prune its segments first, as
the reference's do (``_scan_plan``): zone maps, zstr collation-order
zones and the v2 skip indexes, counted in ``scan_stats()``, on the
``query.scan`` hop and in the ``prune`` span that EXPLAIN reads. RAM
chunks keep no zones and are always scanned.

Left out: federation's use of the partials (the distributed partial
cache and the wire context of a query trace).
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass

import numpy as np

from deepflow_tpu_torch import native
from deepflow_tpu_torch.query import catalog
from deepflow_tpu_torch.query import pool as qpool
from deepflow_tpu_torch.query import qtrace
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.query.costmodel import KernelCostModel
from deepflow_tpu_torch.query.sketch import HistogramSketch
from deepflow_tpu_torch.store.table import ColumnarTable, TableView

# Shared group-kernel cost model: native hash-group vs numpy lexsort.
# Initial overheads seed the choice before observations exist (ctypes
# marshalling makes the native call more expensive per invocation).
_COST = KernelCostModel(overhead_ns={"native": 15_000.0, "numpy": 2_000.0})

# Index-list filtering: native kernels vs numpy masks. The native kernels
# win on selective predicates (survivors come back as positions, later
# conjuncts touch only them); numpy wins on tiny chunks where ctypes
# dispatch dominates.
_FILT = KernelCostModel(overhead_ns={"native": 15_000.0, "numpy": 1_000.0})

# Serial vs morsel-parallel scan degree. The parallel kernel pays pool
# dispatch plus a partial-combine pass, seeded here as fixed overhead so
# small queries keep choosing the serial plan before any observation
# exists; the coefficients are then learned per machine like _COST's.
_DEGREE = KernelCostModel(kernels=("serial", "parallel"),
                          overhead_ns={"parallel": 500_000.0})

_MORSEL_ROWS = 1 << 16  # fixed-row morsel size: one sealed chunk


def _morsel_rows() -> int:
    env = os.environ.get("DF_QUERY_MORSEL_ROWS", "").strip()
    if env:
        try:
            return max(256, int(env))
        except ValueError:
            pass
    return _MORSEL_ROWS


@dataclass
class QueryResult:
    columns: list[str]
    values: list[list]

    def to_dict(self) -> dict:
        return {"columns": self.columns, "values": self.values}


class QueryError(Exception):
    """A query that cannot be answered as asked (HTTP 400)."""


@dataclass
class _Val:
    """Evaluated vector + decode metadata."""
    arr: np.ndarray
    kind: str = "num"           # num | str | enum | bool | obj
    dict_ = None                # Dictionary when kind == 'str'
    labels: tuple = ()          # when kind == 'enum'
    unit: str | None = None     # 'ns' | 's' for time columns

    def decoded(self) -> list:
        if self.kind == "str":
            return self.dict_.decode_many(self.arr)
        if self.kind == "enum":
            lab = self.labels
            return [lab[i] for i in self.arr.tolist()]
        if self.kind == "bool":
            return self.arr.astype(bool).tolist()
        # 'obj': python values (CASE branches mixing literals)
        return self.arr.tolist()


def _col_val(table: ColumnarTable, name: str, arr: np.ndarray) -> _Val:
    spec = table.columns[name]
    if spec.kind == "str":
        v = _Val(arr, "str")
        v.dict_ = table.dicts[name]
        return v
    if spec.kind == "enum":
        return _Val(arr, "enum", labels=spec.enum_values)
    unit = None
    if name in ("time", "start_time", "end_time"):
        unit = "ns" if spec.kind == "u64" else "s"
    return _Val(arr, "num", unit=unit)


def _collect_cols(e, out: set) -> None:
    if isinstance(e, S.Col):
        out.add(e.name)
    elif isinstance(e, S.Func):
        for a in e.args:
            _collect_cols(a, out)
    elif isinstance(e, S.BinOp):
        _collect_cols(e.left, out)
        if not isinstance(e.right, tuple):
            _collect_cols(e.right, out)
    elif isinstance(e, S.Not):
        _collect_cols(e.expr, out)
    elif isinstance(e, S.Case):
        for c, v in e.whens:
            _collect_cols(c, out)
            _collect_cols(v, out)
        if e.default is not None:
            _collect_cols(e.default, out)


def _like_to_pred(pattern: str):
    """SQL LIKE: % and _ are wildcards, everything else literal."""
    parts = []
    for ch in pattern:
        if ch == "%":
            parts.append(".*")
        elif ch == "_":
            parts.append(".")
        else:
            parts.append(re.escape(ch))
    rx = re.compile("^" + "".join(parts) + "$", re.DOTALL)
    return lambda s: rx.match(s) is not None


def _isin(arr: np.ndarray, vals) -> np.ndarray:
    """np.isin, routed through the native hash-set kernel when the column
    is dictionary-id shaped (uint32) and the literal set is pure ints:
    the encoded-predicate path for IN / LIKE pushdown."""
    if arr.dtype == np.uint32 and len(arr):
        vl = np.asarray(vals)
        if (vl.ndim == 1 and vl.dtype.kind in "iu" and len(vl)
                and int(vl.min()) >= 0
                and int(vl.max()) <= 0xFFFFFFFF):
            return native.qx_isin_u32(arr, vl.astype(np.uint32))
    return np.isin(arr, vals)


def _case_select(conds, vals, default, shape) -> _Val:
    """Shared CASE combination for the row-level and aggregate paths.
    All-numeric branches stay float64; any non-numeric branch coerces
    EVERY branch to strings (one consistent dtype — a mixed str/num
    object array would crash GROUP BY/ORDER BY comparisons)."""
    branch_vals = vals + ([default] if default is not None else [])
    if all(v.kind == "num" and v.arr.dtype.kind in "fiub"
           for v in branch_vals):
        choices = [np.broadcast_to(v.arr.astype(np.float64), shape)
                   for v in vals]
        dflt = (default.arr.astype(np.float64) if default is not None
                else np.nan)
        if getattr(dflt, "ndim", 0):
            dflt = np.broadcast_to(dflt, shape)
        return _Val(np.select(conds, choices, default=dflt))

    def as_str(v: _Val):
        dec = v.decoded()
        if not isinstance(dec, list):
            return dec if isinstance(dec, str) else str(dec)
        return np.asarray([x if isinstance(x, str) else str(x)
                           for x in dec], dtype=object)
    choices = [np.broadcast_to(np.asarray(as_str(v), dtype=object), shape)
               for v in vals]
    dflt = as_str(default) if default is not None else ""
    if not isinstance(dflt, str) and getattr(dflt, "ndim", 0):
        dflt = np.broadcast_to(dflt, shape)
    return _Val(np.select(conds, choices, default=dflt), "obj")


class _Env:
    """Column arrays for one evaluation scope."""

    def __init__(self, table: ColumnarTable, cols: dict[str, np.ndarray]):
        self.table = table
        self.cols = cols

    def eval(self, e) -> _Val:
        if isinstance(e, S.Lit):
            return _Val(np.asarray(e.value), "num")
        if isinstance(e, S.Col):
            if e.name not in self.cols:
                raise QueryError(f"unknown column {e.name!r} in "
                                 f"{self.table.name}")
            return _col_val(self.table, e.name, self.cols[e.name])
        if isinstance(e, S.Not):
            v = self.eval(e.expr)
            return _Val(~v.arr.astype(bool), "bool")
        if isinstance(e, S.Func):
            return self._eval_func(e)
        if isinstance(e, S.BinOp):
            return self._eval_binop(e)
        if isinstance(e, S.Case):
            return self._eval_case(e)
        if isinstance(e, S.Star):
            raise QueryError("* only valid inside Count()")
        raise QueryError(f"cannot evaluate {e!r}")

    def _eval_case(self, e: "S.Case") -> _Val:
        conds = [self.eval(c).arr.astype(bool) for c, _ in e.whens]
        vals = [self.eval(v) for _, v in e.whens]
        default = self.eval(e.default) if e.default is not None else None
        return _case_select(conds, vals, default, conds[0].shape)

    def _eval_func(self, e: S.Func) -> _Val:
        if e.name in S.AGG_FUNCS:
            raise QueryError(f"aggregate {e.name} outside aggregation")
        if e.name == "TIME":
            if len(e.args) != 2:
                raise QueryError("time(col, interval_s) takes 2 args")
            v = self.eval(e.args[0])
            iv = self.eval(e.args[1]).arr
            interval = int(iv)
            t = v.arr.astype(np.int64)
            if v.unit == "ns":
                t = t // 1_000_000_000
            return _Val((t // interval) * interval, "num", unit="s")
        raise QueryError(f"unknown function {e.name}")

    def _eval_binop(self, e: S.BinOp) -> _Val:
        op = e.op
        if op in ("AND", "OR"):
            lv = self.eval(e.left).arr.astype(bool)
            rv = self.eval(e.right).arr.astype(bool)
            return _Val(lv & rv if op == "AND" else lv | rv, "bool")
        if op == "IN":
            lv = self.eval(e.left)
            vals = [self._coerce_lit(lv, lit.value) for lit in e.right]
            return _Val(_isin(lv.arr, vals), "bool")
        if op == "LIKE":
            lv = self.eval(e.left)
            if lv.kind == "str":
                ids = lv.dict_.match_ids(_like_to_pred(e.right.value))
                return _Val(_isin(lv.arr, ids), "bool")
            if lv.kind == "enum":
                pred = _like_to_pred(e.right.value)
                ids = [i for i, s in enumerate(lv.labels) if pred(s)]
                return _Val(np.isin(lv.arr, ids), "bool")
            raise QueryError("LIKE requires a string column")
        lv = self.eval(e.left)
        if op in ("=", "!=", "<", "<=", ">", ">="):
            rv_raw = e.right
            if isinstance(rv_raw, S.Lit) and isinstance(rv_raw.value, str):
                if op not in ("=", "!="):
                    # dictionary codes reflect insertion order, not
                    # collation — resolve the predicate over the (small)
                    # dictionary in STRING space, then membership-test
                    # the ids (same pushdown shape as LIKE)
                    pred = _ORD_PREDS[op](rv_raw.value)
                    if lv.kind == "str":
                        ids = lv.dict_.match_ids(pred)
                        return _Val(_isin(lv.arr, ids), "bool")
                    if lv.kind == "enum":
                        ids = [i for i, s in enumerate(lv.labels)
                               if pred(s)]
                        return _Val(np.isin(lv.arr, ids), "bool")
                    raise QueryError(
                        "ordered comparison against a string requires "
                        "a string or enum column")
                code = self._coerce_lit(lv, rv_raw.value)
                l, r = lv.arr, np.asarray(code)
            else:
                rv = self.eval(rv_raw)
                l, r = self._align_encoded(lv, rv, op)
            res = {"=": l.__eq__, "!=": l.__ne__, "<": l.__lt__,
                   "<=": l.__le__, ">": l.__gt__, ">=": l.__ge__}[op](r)
            return _Val(res, "bool")
        # arithmetic
        rv = self.eval(e.right)
        l = lv.arr.astype(np.float64)
        r = rv.arr.astype(np.float64)
        if op == "+":
            return _Val(l + r)
        if op == "-":
            return _Val(l - r)
        if op == "*":
            return _Val(l * r)
        if op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.where(r != 0, l / np.where(r == 0, 1, r), 0.0)
            return _Val(out)
        raise QueryError(f"unknown op {op}")

    def _align_encoded(self, lv: _Val, rv: _Val, op: str):
        """Align two columns for comparison. Dictionary-encoded codes from
        *different* dictionaries are not comparable — remap the right side's
        ids into the left dictionary via the (small) unique-id set."""
        enc_l = lv.kind in ("str", "enum")
        enc_r = rv.kind in ("str", "enum")
        if not (enc_l or enc_r):
            return lv.arr, rv.arr
        if op not in ("=", "!="):
            raise QueryError(
                "ordered comparison between string columns is not supported")
        if lv.kind == "str" and rv.kind == "str":
            if lv.dict_ is rv.dict_:
                return lv.arr, rv.arr
            uniq = np.unique(rv.arr)
            sentinel = np.uint32(0xFFFFFFFF)
            remap = {int(u): (lambda s: np.uint32(s) if s is not None
                              else sentinel)(lv.dict_.lookup(rv.dict_.decode(int(u))))
                     for u in uniq}
            mapped = np.array([remap[int(c)] for c in rv.arr],
                              dtype=np.uint32)
            return lv.arr, mapped
        if lv.kind == "enum" and rv.kind == "enum":
            if lv.labels == rv.labels:
                return lv.arr, rv.arr
            remap = {i: (rv.labels.index(s) if s in rv.labels else 0xFFFF)
                     for i, s in enumerate(lv.labels)}
            mapped = np.array([remap[int(c)] for c in lv.arr],
                              dtype=np.uint16)
            return mapped, rv.arr
        raise QueryError(
            f"cannot compare {lv.kind} column with {rv.kind} column")

    def _coerce_lit(self, lv: _Val, value):
        """Translate a literal to the column's encoded space."""
        if lv.kind == "str" and isinstance(value, str):
            sid = lv.dict_.lookup(value)
            return np.uint32(sid) if sid is not None else np.uint32(0xFFFFFFFF)
        if lv.kind == "enum" and isinstance(value, str):
            try:
                return np.uint16(lv.labels.index(value))
            except ValueError:
                return np.uint16(0xFFFF)
        return value


_ORD_PREDS = {
    "<": lambda val: lambda s: s < val,
    "<=": lambda val: lambda s: s <= val,
    ">": lambda val: lambda s: s > val,
    ">=": lambda val: lambda s: s >= val,
}


# -- aggregation ------------------------------------------------------------

_SEG_OPS = {"SUM": 0, "MIN": 1, "MAX": 2}


def _group_reduce(name: str, af: np.ndarray, order: np.ndarray,
                  bounds_full: np.ndarray) -> np.ndarray:
    """Fused gather + segmented reduce over float64 values (native
    df_qx_agg_f64). It accumulates in row order within each group, as
    ufunc.reduceat over the gathered array does, so the two give the
    same bits; it runs outside the interpreter lock, which is where the
    morsel pool's parallelism comes from."""
    if len(bounds_full) <= 1:
        return np.empty(0, dtype=np.float64)
    return native.qx_agg_f64(af, order, bounds_full, _SEG_OPS[name])


def _agg_eval(e, env: _Env, order: np.ndarray, bounds: np.ndarray) -> _Val:
    """Evaluate expr containing aggregates; per-group output.

    order: row permutation grouping rows; bounds: group start indices into
    order (len == n_groups, implicit end at len(order)).
    """
    starts = bounds
    ends = np.append(bounds[1:], len(order))
    if isinstance(e, S.Func) and e.name in S.AGG_FUNCS:
        if e.distinct and e.name != "COUNT":
            raise QueryError(
                f"DISTINCT is only supported in Count(), not {e.name}")
        if e.name == "COUNT" and e.distinct:
            if len(e.args) != 1 or isinstance(e.args[0], S.Star):
                raise QueryError(
                    "COUNT(DISTINCT) takes exactly one column")
            v = env.eval(e.args[0])
            a = v.arr[order]  # encoded ids / numerics both hash fine
            if not len(a):
                return _Val(np.zeros(len(starts), dtype=np.float64))
            # one lexsort total instead of one np.unique per group:
            # sort (group, value), count within-group value changes
            grp = np.repeat(np.arange(len(starts)), ends - starts)
            idx = np.lexsort((a, grp))
            sa, sg = a[idx], grp[idx]
            fresh = np.append(True, (sa[1:] != sa[:-1]) |
                              (sg[1:] != sg[:-1]))
            return _Val(np.add.reduceat(
                fresh.astype(np.float64), starts))
        if e.name == "COUNT":
            return _Val((ends - starts).astype(np.float64))
        arg = e.args[0] if e.args else S.Star()
        if isinstance(arg, S.Star):
            return _Val((ends - starts).astype(np.float64))
        v = env.eval(arg)
        if v.kind in ("str", "enum", "obj") and e.name != "LAST":
            raise QueryError(
                f"{e.name} over string column {S.expr_name(arg)!r}")
        af = v.arr.astype(np.float64)
        bounds_full = np.append(starts, len(order))
        if e.name == "SUM":
            return _Val(_group_reduce("SUM", af, order, bounds_full))
        if e.name == "AVG":
            s = _group_reduce("SUM", af, order, bounds_full)
            n = (ends - starts)
            return _Val(s / np.maximum(n, 1))
        if e.name == "MIN":
            return _Val(_group_reduce("MIN", af, order, bounds_full))
        if e.name == "MAX":
            return _Val(_group_reduce("MAX", af, order, bounds_full))
        a = af[order]
        if e.name == "LAST":
            out = a[ends - 1] if len(a) else a
            v2 = _Val(out, v.kind, labels=v.labels)
            v2.dict_ = v.dict_
            if v.kind in ("str", "enum"):
                v2.arr = v.arr[order][ends - 1] if len(a) else v.arr
            return v2
        if e.name == "PERCENTILE":
            if len(e.args) != 2:
                raise QueryError("Percentile(col, p) takes 2 args")
            p = float(env.eval(e.args[1]).arr)
            out = np.empty(len(starts), dtype=np.float64)
            for i, (s0, e0) in enumerate(zip(starts, ends)):
                out[i] = np.percentile(a[s0:e0], p) if e0 > s0 else 0.0
            return _Val(out)
        raise QueryError(f"unknown aggregate {e.name}")
    if isinstance(e, S.Not):
        v = _agg_eval(e.expr, env, order, bounds)
        return _Val(~v.arr.astype(bool), "bool")
    if isinstance(e, S.BinOp):
        # logical / comparison ops appear here via HAVING
        if e.op in ("AND", "OR"):
            lv = _agg_eval(e.left, env, order, bounds).arr.astype(bool)
            rv = _agg_eval(e.right, env, order, bounds).arr.astype(bool)
            return _Val(lv & rv if e.op == "AND" else lv | rv, "bool")
        if e.op == "IN":
            lv = _agg_eval(e.left, env, order, bounds)
            vals = [lit.value for lit in e.right]
            if lv.kind in ("str", "enum"):
                dec = np.asarray(lv.decoded(), dtype=object)
                return _Val(np.isin(dec, vals), "bool")
            return _Val(np.isin(lv.arr, vals), "bool")
        lv = _agg_eval(e.left, env, order, bounds)
        rv = _agg_eval(e.right, env, order, bounds)
        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            if lv.kind in ("str", "enum") or rv.kind in ("str", "enum"):
                # HAVING over group-key strings: compare decoded values
                l = np.asarray(lv.decoded(), dtype=object)
                r = (np.asarray(rv.decoded(), dtype=object)
                     if rv.kind in ("str", "enum") else rv.arr)
            else:
                l, r = lv.arr, rv.arr
            res = {"=": l.__eq__, "!=": l.__ne__, "<": l.__lt__,
                   "<=": l.__le__, ">": l.__gt__, ">=": l.__ge__}[e.op](r)
            return _Val(np.asarray(res), "bool")
        l, r = lv.arr.astype(np.float64), rv.arr.astype(np.float64)
        if e.op == "+":
            return _Val(l + r)
        if e.op == "-":
            return _Val(l - r)
        if e.op == "*":
            return _Val(l * r)
        if e.op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                return _Val(np.where(r != 0, l / np.where(r == 0, 1, r), 0.0))
        raise QueryError(f"op {e.op} not valid over aggregates")
    if isinstance(e, S.Lit):
        return _Val(np.asarray(e.value))
    if isinstance(e, S.Case) and S.contains_agg(e):
        # CASE over aggregates (per-group labels from per-group stats)
        conds = [_agg_eval(c, env, order, bounds).arr.astype(bool)
                 for c, _ in e.whens]
        vals = [_agg_eval(v, env, order, bounds) for _, v in e.whens]
        default = (_agg_eval(e.default, env, order, bounds)
                   if e.default is not None else None)
        return _case_select(conds, vals, default, (len(bounds),))
    if isinstance(e, (S.Col, S.Func, S.Case)):
        # group-key expression: first value per group
        v = env.eval(e)
        out = _Val(v.arr[order][bounds], v.kind, labels=v.labels, unit=v.unit)
        out.dict_ = v.dict_
        return out
    raise QueryError(f"cannot aggregate {e!r}")


def _normalize(table: ColumnarTable, query: S.Select) -> S.Select:
    """Derived-metric rewrite + GROUP BY alias substitution."""
    # derived metrics before column validation, so the virtual names
    # never hit the store. Display names and ORDER BY matching use the
    # PRE-rewrite expressions: the user asked for the metric, not the
    # implementation ratio.
    try:
        tcols = set(table.columns)
        # alias defaults to the PRE-rewrite display name, which also lets
        # ORDER BY <metric> match its SELECT item by name below
        query_items = [
            S.SelectItem(catalog.rewrite_derived(i.expr, table.name, tcols),
                         i.alias or S.expr_name(i.expr))
            for i in query.items]
        having = (catalog.rewrite_derived(query.having, table.name, tcols)
                  if query.having is not None else None)
    except catalog.DerivedError as e:
        raise QueryError(str(e)) from None
    # GROUP BY <alias>: substitute the SELECT item's expression (the
    # alias names no real column)
    alias_map = {i.alias: i.expr for i in query_items if i.alias}
    group_by = [
        alias_map[g.name]
        if isinstance(g, S.Col) and g.name not in table.columns
        and g.name in alias_map else g
        for g in query.group_by]
    return S.Select(items=query_items, table=query.table,
                    where=query.where, group_by=group_by,
                    having=having, order_by=query.order_by,
                    limit=query.limit)


def _split_conjuncts(e) -> list:
    """Flatten top-level ANDs into conjuncts."""
    if isinstance(e, S.BinOp) and e.op == "AND":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _needed_cols(table: ColumnarTable, query: S.Select,
                 extra_cols: set[str] | None = None) -> set[str]:
    """Every store column the query references, validated against the
    schema. extra_cols: more columns the caller needs (a partial's LAST
    wants `time` beside the value)."""
    needed: set[str] = set(extra_cols or ())
    for item in query.items:
        _collect_cols(item.expr, needed)
    for g in query.group_by:
        _collect_cols(g, needed)
    if query.having is not None:
        _collect_cols(query.having, needed)
    aliases = {i.alias for i in query.items if i.alias}
    for e, _ in query.order_by:
        if isinstance(e, S.Col) and e.name in aliases:
            continue  # refers to a SELECT alias, not a table column
        if S.expr_name(e) in aliases:
            continue  # matches a SELECT item (possibly a derived metric)
        _collect_cols(e, needed)
    if query.where is not None:
        _collect_cols(query.where, needed)
    unknown = needed - set(table.columns)
    if unknown:
        raise QueryError(f"unknown columns {sorted(unknown)} in {table.name}")
    return needed


def _lit_id(table: ColumnarTable, col: str, value: str) -> int | None:
    """The stored id of a string literal in a str or enum column; None
    when no row can hold it (a string the dictionary never saw, a label
    the enum lacks)."""
    spec = table.columns[col]
    if spec.kind == "str":
        return table.dicts[col].lookup(value)
    return (spec.enum_values.index(value) if value in spec.enum_values
            else None)


def _filter_prims(table: ColumnarTable, where) -> list[tuple] | None:
    """Compile the WHERE into filter primitives, or None when any
    conjunct falls outside the primitive forms (the generic mask path
    then evaluates the whole WHERE — never a partial split, so both
    paths always agree).

    Primitive forms, each provably equivalent to its _Env evaluation:
      ("range", col, lo, hi)  — integer column between two in-dtype
                                bounds (= / < / <= / > / >= with an int
                                literal; one-sided ops use dtype min/max)
      ("isin",  col, ids, _)  — dict/enum column id in a resolved set
                                (= / IN / LIKE / ordered string literal,
                                same id resolution as _eval_binop)
      ("never", col, _, _)    — literal provably out of the column's
                                value space: no row matches
    Float literals are NOT compiled: numpy compares int columns to float
    literals in float space, and mirroring that with integer bounds would
    diverge at the float64-precision edge for u64 timestamps."""
    prims: list[tuple] = []
    for c in _split_conjuncts(where):
        if not (isinstance(c, S.BinOp) and isinstance(c.left, S.Col)
                and c.left.name in table.columns):
            return None
        col = c.left.name
        spec = table.columns[col]
        if c.op == "IN":
            if spec.kind not in ("str", "enum") \
                    or not isinstance(c.right, tuple):
                return None
            ids = []
            for lit in c.right:
                if not isinstance(lit, S.Lit) \
                        or not isinstance(lit.value, str):
                    return None
                v = _lit_id(table, col, lit.value)
                if v is not None:
                    ids.append(v)
            prims.append(("isin", col,
                          np.asarray(sorted(set(ids)), dtype=np.uint32),
                          None))
            continue
        if c.op == "LIKE":
            if not (isinstance(c.right, S.Lit)
                    and isinstance(c.right.value, str)):
                return None
            pred = _like_to_pred(c.right.value)
            if spec.kind == "str":
                ids = table.dicts[col].match_ids(pred)
            elif spec.kind == "enum":
                ids = [i for i, s in enumerate(spec.enum_values)
                       if pred(s)]
            else:
                return None
            prims.append(("isin", col, np.asarray(ids, dtype=np.uint32),
                          None))
            continue
        if c.op not in ("=", "<", "<=", ">", ">=") \
                or not isinstance(c.right, S.Lit):
            return None
        val = c.right.value
        if spec.kind in ("str", "enum"):
            if not isinstance(val, str):
                return None
            if c.op == "=":
                v = _lit_id(table, col, val)
                ids = [] if v is None else [v]
            else:
                pred = _ORD_PREDS[c.op](val)
                if spec.kind == "str":
                    ids = table.dicts[col].match_ids(pred)
                else:
                    ids = [i for i, s in enumerate(spec.enum_values)
                           if pred(s)]
            prims.append(("isin", col, np.asarray(ids, dtype=np.uint32),
                          None))
            continue
        dt = np.dtype(spec.np_dtype)
        if dt.kind not in "iu":
            return None
        if isinstance(val, bool):
            val = int(val)
        if not isinstance(val, int):
            return None
        info = np.iinfo(dt)
        lo, hi = int(info.min), int(info.max)
        if c.op == "=":
            lo = hi = val
        elif c.op == "<":
            hi = val - 1
        elif c.op == "<=":
            hi = val
        elif c.op == ">":
            lo = val + 1
        else:
            lo = val
        if lo > int(info.max) or hi < int(info.min):
            prims.append(("never", col, 0, 0))
            continue
        lo = max(lo, int(info.min))
        hi = min(hi, int(info.max))
        prims.append(("range", col, lo, hi))
    return _fold_ranges(prims)


def _fold_ranges(prims: list[tuple]) -> list[tuple]:
    """One range per column: the conjuncts' ranges on a column intersect
    into one primitive at the first one's place (one that is empty is
    "never"), so a scan passes over that column once. The query cache's
    per-bucket scans add a bucket's range to the query's own time range:
    folded, the bucket's narrow range is what the first pass selects."""
    out: list[tuple] = []
    at: dict[str, int] = {}
    for p in prims:
        kind, col, lo, hi = p
        if kind != "range":
            out.append(p)
        elif col not in at:
            at[col] = len(out)
            out.append(p)
        else:
            kind0, _, lo0, hi0 = out[at[col]]
            if kind0 == "never":
                continue  # an empty intersection stays empty
            lo, hi = max(lo, lo0), min(hi, hi0)
            out[at[col]] = ("range", col, lo, hi) if lo <= hi \
                else ("never", col, 0, 0)
    return out


def _select_rows(get_col, sz: int, prims: list[tuple]) -> np.ndarray:
    """Ascending survivor positions (uint64) for an all-primitive WHERE.
    The first primitive selects over the full column; each later one
    gathers only the current survivors and refines (`idx = idx[sub]`),
    so a selective leading conjunct makes the rest near-free. Ascending
    positions make `arr[idx]` equal `arr[mask]` on the generic path. The
    native index kernels or numpy's nonzero, chosen per size by _FILT."""
    idx = None  # None = every row still alive
    for kind, col, a, b in prims:
        if kind == "never":
            return np.empty(0, dtype=np.uint64)
        if idx is not None and not len(idx):
            return idx
        arr = get_col(col)
        n = sz if idx is None else len(idx)
        kern = _FILT.choose(n)
        t0 = time.perf_counter_ns()
        if kern == "native":
            sub = arr if idx is None else native.qx_gather(arr, idx)
            out = (native.qx_sel_range(sub, a, b) if kind == "range"
                   else native.qx_sel_isin(sub, a))
        else:
            sub = arr if idx is None else arr[idx]
            m = (_isin(sub, a) if kind == "isin"
                 else (sub >= a) & (sub <= b))
            out = np.nonzero(m)[0].astype(np.uint64)
        _FILT.observe(kern, n, time.perf_counter_ns() - t0)
        idx = out if idx is None else idx[out]
    if idx is None:
        idx = np.arange(sz, dtype=np.uint64)
    return idx


# -- segment pruning -----------------------------------------------------------
#
# A tier segment carries per-column zone maps (min/max over the ENCODED
# values), a zstr collation-order zone for string columns of a v2 run,
# and v2 skip indexes (an inline id list or a bloom filter). WHERE
# conjuncts become NECESSARY conditions: a segment whose zone is
# disjoint from an interval, or whose index lacks every id of an
# equality, holds no matching row, and its columns never decode. Only
# top-level AND conjuncts of the forms `col <op> literal` and `col IN
# (...)` yield conditions; anything else does not prune, which is
# always sound. Intervals are closed (`<` widens to `<=`), and a
# string no dictionary holds prunes every unit, RAM chunks too. Each
# decision is counted in _SCAN_STATS and on the query.scan hop, and
# traced as the prune span.

_SCAN_LOCK = threading.Lock()
_SCAN_STATS = {"scanned_segments": 0, "pruned_segments": 0,
               "bloom_checked": 0, "bloom_pruned": 0}
_SCAN_HOP = None


def set_scan_telemetry(telemetry) -> None:
    """Wire the query.scan hop (emitted = candidate segments, delivered
    = scanned, dropped = pruned)."""
    global _SCAN_HOP
    _SCAN_HOP = telemetry.hop("query.scan") if telemetry else None


def scan_stats() -> dict:
    with _SCAN_LOCK:
        return dict(_SCAN_STATS)


def _note_scan(candidates: int, pruned: int, bloom_checked: int = 0,
               bloom_pruned: int = 0) -> None:
    if not candidates:
        return
    scanned = candidates - pruned - bloom_pruned
    with _SCAN_LOCK:
        _SCAN_STATS["scanned_segments"] += scanned
        _SCAN_STATS["pruned_segments"] += pruned
        _SCAN_STATS["bloom_checked"] += bloom_checked
        _SCAN_STATS["bloom_pruned"] += bloom_pruned
    hop = _SCAN_HOP
    if hop is not None:
        hop.account(emitted=candidates, delivered=scanned,
                    dropped=pruned, reason="pruned")
        if bloom_pruned:
            hop.account(dropped=bloom_pruned, reason="bloom_pruned")


_NO_ROW = object()   # the literal provably matches no row (absent string)
_NEVER_CON = (None, 0, 0)  # constraint: the WHERE matches nothing


def _zone_coerce(table: TableView, col: str, value):
    """A literal in the column's encoded number space: None = not
    comparable with zones, _NO_ROW = matches no row. Ints stay ints (a
    u64 time past 2**53 must not round)."""
    spec = table.columns[col]
    if isinstance(value, str):
        if spec.kind in ("str", "enum"):
            sid = _lit_id(table, col, value)
            return _NO_ROW if sid is None else int(sid)
        return None
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, (int, float)):
        return value
    return None


def _zone_constraints(table: TableView, where) -> list[tuple]:
    """[(col, lo, hi)] closed-interval necessary conditions (None =
    unbounded on that side); _NEVER_CON when the WHERE matches
    nothing."""
    cons: list[tuple] = []
    for c in _split_conjuncts(where):
        if not (isinstance(c, S.BinOp) and isinstance(c.left, S.Col)
                and c.left.name in table.columns):
            continue
        col = c.left.name
        if c.op == "IN" and isinstance(c.right, tuple) and c.right:
            vals, dead, skip = [], False, False
            for lit in c.right:
                v = (_zone_coerce(table, col, lit.value)
                     if isinstance(lit, S.Lit) else None)
                if v is None:
                    skip = True
                    break
                if v is _NO_ROW:
                    dead = True
                else:
                    vals.append(v)
            if skip:
                continue
            if vals:
                cons.append((col, min(vals), max(vals)))
            elif dead:
                cons.append(_NEVER_CON)
            continue
        if (c.op not in ("=", "<", "<=", ">", ">=")
                or not isinstance(c.right, S.Lit)):
            continue
        if (c.op != "=" and isinstance(c.right.value, str)
                and table.columns[col].kind in ("str", "enum")):
            # ordered string predicates follow collation order, not id
            # order: the zstr zone checks them (_str_pruned)
            continue
        v = _zone_coerce(table, col, c.right.value)
        if v is None:
            continue
        if v is _NO_ROW:
            if c.op == "=":
                cons.append(_NEVER_CON)
            continue
        if c.op == "=":
            cons.append((col, v, v))
        elif c.op in ("<", "<="):
            cons.append((col, None, v))
        else:
            cons.append((col, v, None))
    return cons


def _index_constraints(table: TableView, where) -> tuple[list, list]:
    """(idcons, strcons): [(col, [encoded ids])] from `col = 'lit'` and
    `col IN (...)` over str and enum columns, checked against a
    segment's id list or bloom filter, and [(col, op, value)] from
    ordered string predicates over str columns, checked against its
    zstr zone."""
    idcons: list[tuple] = []
    strcons: list[tuple] = []
    for c in _split_conjuncts(where):
        if not (isinstance(c, S.BinOp) and isinstance(c.left, S.Col)
                and c.left.name in table.columns):
            continue
        col = c.left.name
        spec = table.columns[col]
        if spec.kind not in ("str", "enum"):
            continue
        if c.op == "IN" and isinstance(c.right, tuple) and c.right:
            ids, ok = [], True
            for lit in c.right:
                v = (_zone_coerce(table, col, lit.value)
                     if isinstance(lit, S.Lit) else None)
                if v is None or isinstance(v, float):
                    ok = False
                    break
                if v is not _NO_ROW:
                    ids.append(int(v))
            if ok:
                idcons.append((col, ids))
            continue
        if not isinstance(c.right, S.Lit):
            continue
        if c.op == "=":
            v = _zone_coerce(table, col, c.right.value)
            if v is _NO_ROW:
                idcons.append((col, []))
            elif v is not None and not isinstance(v, float):
                idcons.append((col, [int(v)]))
        elif c.op in ("<", "<=", ">", ">=") and spec.kind == "str" \
                and isinstance(c.right.value, str):
            strcons.append((col, c.op, c.right.value))
    return idcons, strcons


def _str_pruned(seg, strcons: list) -> bool:
    """True when the segment's zstr zone proves no row meets an ordered
    string predicate (a truncated upper bound is None: no pruning)."""
    for col, op, val in strcons:
        z = seg.str_zone(col)
        if z is None:
            continue
        lo, hi = z
        if op in (">", ">=") and hi is not None:
            if hi < val or (op == ">" and hi <= val):
                return True
        elif op in ("<", "<="):
            if lo > val or (op == "<" and lo >= val):
                return True
    return False


def _zone_pruned(zones: dict | None, cons: list) -> bool:
    """True when the unit provably holds no matching row. A unit without
    zones (a RAM chunk) prunes only on _NEVER_CON."""
    for col, lo, hi in cons:
        if col is None:
            return True
        zb = (zones or {}).get(col)
        if zb is None:
            continue
        zmin, zmax = zb
        if (lo is not None and zmax < lo) or \
                (hi is not None and zmin > hi):
            return True
    return False


def _scan_plan(table: TableView, query: S.Select) -> list[dict]:
    """One scan's chunk list, pruned and counted: shared by the serial
    and morsel-parallel paths, so both skip the same segments. Zone maps
    (and zstr zones) first, then the skip indexes for equality and IN
    over dictionary columns. A pruned segment decodes no byte."""
    prune_sp = qtrace.span(f"prune {table.name}")
    cons = idcons = strcons = ()
    if query.where is not None:
        cons = _zone_constraints(table, query.where)
        idcons, strcons = _index_constraints(table, query.where)
    chunks = []
    zoned = pruned = bchecked = bpruned = 0
    for ch, zones, seg in table.scan_units():
        if zones is not None:
            zoned += 1
        if cons and _zone_pruned(zones, cons):
            if zones is not None:
                pruned += 1
            continue
        if seg is not None and (idcons or strcons):
            if strcons and _str_pruned(seg, strcons):
                pruned += 1
                continue
            hit, checked = True, False
            for col, ids in idcons:
                if not seg.has_index(col):
                    continue
                checked = True
                if not seg.maybe_contains(col, ids):
                    hit = False
                    break
            if checked:
                bchecked += 1
            if not hit:
                bpruned += 1
                continue
        chunks.append(ch)
    _note_scan(zoned, pruned, bchecked, bpruned)
    prune_sp.annotate(candidates=zoned, zone_pruned=pruned,
                      bloom_checked=bchecked, bloom_pruned=bpruned,
                      scanned=len(chunks))
    prune_sp.finish()
    return chunks


def _chunk_rows(ch) -> int:
    """Rows of a scan chunk without decoding a column: a segment's
    LazyChunk carries ``rows``; a RAM chunk pays one len()."""
    rows = getattr(ch, "rows", None)
    if rows is not None:
        return rows
    return len(next(iter(ch.values()))) if ch else 0


def _materialize(table: TableView, query: S.Select,
                 extra_cols: set[str] | None = None) -> tuple[_Env, int]:
    """WHERE-filter each chunk of the table's view, and materialize every
    referenced column of the surviving rows, in chunk order, into one
    _Env. Rows appended while the query runs are not in the view."""
    needed = _needed_cols(table, query, extra_cols)
    # no chunk: the WHERE still runs once, over empty columns, so a bad
    # condition fails on an empty table too
    chunks = _scan_plan(table, query) or [
        {name: np.empty(0, dtype=table.columns[name].np_dtype)
         for name in needed}]
    prims = None if query.where is None else _filter_prims(table,
                                                           query.where)
    parts: dict[str, list[np.ndarray]] = {name: [] for name in needed}
    n = 0
    for cols in chunks:
        m = _chunk_rows(cols)
        if query.where is None:
            idx = slice(None)
            n += m
        else:
            if prims is not None:
                idx = _select_rows(cols.__getitem__, m, prims)
            else:
                mask = _Env(table, cols).eval(query.where).arr
                if mask.ndim == 0:  # WHERE with no column refs
                    mask = np.full(m, bool(mask))
                idx = np.flatnonzero(mask.astype(bool))
            if not len(idx):
                # no survivor: a segment's other columns never decode
                continue
            n += len(idx)
        for name in needed:
            parts[name].append(cols[name][idx])
    return _Env(table, {
        name: (p[0] if len(p) == 1 else np.concatenate(p) if p
               else np.empty(0, dtype=table.columns[name].np_dtype))
        for name, p in parts.items()}), n


# -- grouping ---------------------------------------------------------------

def _sort_ranks(a: np.ndarray) -> np.ndarray:
    """int64 view of one key column that sorts identically to its values.
    Ints pass through; floats/objects are rank-encoded via np.unique
    (ranks are monotone in the values, so lexicographic order over ranks
    == lexicographic order over values)."""
    if a.dtype.kind == "b":
        return a.astype(np.int64)
    if a.dtype.kind in "iu":
        if a.dtype == np.uint64 and len(a) and int(a.max()) > 2**63 - 1:
            _, inv = np.unique(a, return_inverse=True)
            return inv.astype(np.int64)
        return a.astype(np.int64)
    _, inv = np.unique(a, return_inverse=True)
    return inv.astype(np.int64)


def _group_rows(arrs: list[np.ndarray], first_occurrence: bool):
    """Group rows by the composite key over `arrs`.

    -> (order, bounds_full, n_groups): order is a row permutation with
    groups contiguous and original row order within each group;
    bounds_full has n_groups+1 entries. Group order is first-occurrence
    when `first_occurrence` else ascending-lexicographic over the keys.

    The native O(n) hash-group kernel or numpy's lexsort, chosen by the
    learned cost model; both are reshaped to the requested group order,
    so callers see one deterministic layout."""
    ranks = [_sort_ranks(np.ascontiguousarray(a)) for a in arrs]
    n = len(ranks[0]) if ranks else 0
    if n == 0:
        return (np.empty(0, dtype=np.int64), np.zeros(1, dtype=np.int64), 0)
    kernel = _COST.choose(n)
    t0 = time.perf_counter_ns()
    if kernel == "native":
        order, bounds_full, ng = native.qx_group(ranks)
        if not first_occurrence:
            # reorder first-occurrence groups to ascending key order:
            # lexsort the (one-per-group) representatives, then gather
            reps = order[bounds_full[:-1]]
            perm = np.lexsort([r[reps] for r in ranks][::-1])
            order, bounds_full = _apply_group_perm(order, bounds_full, perm)
        _COST.observe("native", n, time.perf_counter_ns() - t0)
        return order, bounds_full, ng
    order = np.lexsort(ranks[::-1]).astype(np.int64)
    changed = np.zeros(n, dtype=bool)
    changed[0] = True
    for r in ranks:
        sr = r[order]
        changed[1:] |= sr[1:] != sr[:-1]
    starts = np.flatnonzero(changed)
    bounds_full = np.append(starts, n).astype(np.int64)
    ng = len(starts)
    if first_occurrence:
        # stable argsort over each group's earliest row restores
        # first-occurrence discovery order
        perm = np.argsort(order[starts], kind="stable")
        order, bounds_full = _apply_group_perm(order, bounds_full, perm)
    _COST.observe("numpy", n, time.perf_counter_ns() - t0)
    return order, bounds_full, ng


def _apply_group_perm(order: np.ndarray, bounds_full: np.ndarray,
                      perm: np.ndarray):
    """Permute whole groups of `order` by `perm` without a Python loop:
    gather each group's segment to its new contiguous position."""
    starts = bounds_full[:-1]
    lengths = (bounds_full[1:] - starts)[perm]
    new_bounds = np.concatenate(
        ([0], np.cumsum(lengths))).astype(np.int64)
    offsets = starts[perm] - new_bounds[:-1]
    idx = np.repeat(offsets, lengths) + np.arange(len(order))
    return order[idx], new_bounds


def _group_order(env: _Env, query: S.Select,
                 n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (order, bounds) group permutation for the aggregate path.
    Groups come out in ascending key order, so the encoded and decoded
    paths emit identical row order."""
    if query.group_by:
        key_vals = [env.eval(g) for g in query.group_by]
        if n_rows == 0:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        arrs = []
        for kv in key_vals:
            a = kv.arr
            if a.ndim == 0:  # GROUP BY a literal: one group
                a = np.broadcast_to(a, (n_rows,))
            arrs.append(a)
        order, bounds_full, _ = _group_rows(arrs, first_occurrence=False)
        return order, bounds_full[:-1]
    # one group over all rows; zero rows -> zero groups
    return (np.arange(n_rows),
            np.zeros(1 if n_rows else 0, dtype=np.int64))


def _is_agg_query(query: S.Select) -> bool:
    return bool(query.group_by) or query.having is not None or any(
        S.contains_agg(i.expr) for i in query.items)


# -- columnar ORDER BY / LIMIT ----------------------------------------------

def _slice_val(v: _Val, idx) -> _Val:
    w = _Val(v.arr[idx], v.kind, labels=v.labels, unit=v.unit)
    w.dict_ = v.dict_
    return w


def _sort_key(v: _Val) -> np.ndarray:
    """Sortable int64/float64 column matching Python-row-sort semantics.
    Dictionary ids are NOT collation-ordered, so string columns sort by a
    rank table built once over the (small) dictionary, never the rows."""
    a = v.arr
    if v.kind == "str" and v.dict_ is not None:
        return v.dict_.collation_ranks().take(a.astype(np.int64),
                                              mode="clip")
    if v.kind == "enum":
        if not v.labels:
            return a.astype(np.int64)
        labs = np.asarray(v.labels, dtype=object)
        rank = np.empty(len(labs), dtype=np.int64)
        rank[np.argsort(labs, kind="stable")] = np.arange(
            len(labs), dtype=np.int64)
        return rank.take(a.astype(np.int64), mode="clip")
    if v.kind == "obj":
        # _case_select guarantees all-string object arrays
        _, inv = np.unique(a, return_inverse=True)
        return inv.astype(np.int64)
    if a.dtype.kind == "f":
        return a.astype(np.float64)
    return a.astype(np.int64)


def _order_index(names: list[str], e) -> int:
    """The output column an ORDER BY expression names."""
    key_name = S.expr_name(e)
    if key_name in names:
        return names.index(key_name)
    if isinstance(e, S.Col) and e.name in names:
        return names.index(e.name)
    raise QueryError(f"ORDER BY {key_name!r} must appear in SELECT")


def _order_limit_idx(query: S.Select, names: list[str],
                     outs: list[_Val]) -> np.ndarray | None:
    """Encoded ORDER BY + LIMIT: index array selecting/ordering the final
    rows, or None for 'keep everything as is'. The same name resolution
    as _order_limit, one lexsort over the keys."""
    n = max((len(v.arr) for v in outs), default=0)
    if not query.order_by:
        if query.limit is not None and query.limit < n:
            return np.arange(query.limit)
        return None
    keys = []
    for e, desc in query.order_by:
        k = _sort_key(outs[_order_index(names, e)])
        if desc:
            k = -k
        keys.append(k)
    order = np.lexsort(keys[::-1])
    if query.limit is not None:
        order = order[:query.limit]
    return order


def _finish_columnar(query: S.Select, names: list[str],
                     outs: list[_Val]) -> QueryResult:
    """Sort/limit on encoded columns, decode only the surviving rows."""
    idx = _order_limit_idx(query, names, outs)
    if idx is not None:
        outs = [_slice_val(v, idx) for v in outs]
    decoded = [v.decoded() for v in outs]
    n_out = max((len(d) for d in decoded), default=0)
    rows = [list(r) for r in zip(*decoded)] if n_out else []
    return QueryResult(columns=names, values=rows)


# -- execution --------------------------------------------------------------

# -- morsel-parallel scan ----------------------------------------------------

def _int_exact(table: TableView, e) -> bool:
    """True when the expression is guaranteed integer-valued, so
    re-adding per-morsel float64 partial sums is bit-exact regardless
    of the split."""
    if isinstance(e, S.Lit):
        return isinstance(e.value, (bool, int))
    if isinstance(e, S.Col):
        spec = table.columns.get(e.name)
        return spec is not None and spec.kind[0] in "iu"
    if isinstance(e, S.Func) and e.name == "TIME":
        return True
    if isinstance(e, S.BinOp) and e.op in ("+", "-", "*"):
        return (not isinstance(e.right, tuple)
                and _int_exact(table, e.left)
                and _int_exact(table, e.right))
    return False


def _parallel_sites_ok(table: TableView, query: S.Select,
                       sites: list) -> bool:
    """Aggregates whose morsel split is provably byte-identical to the
    serial scan. LAST is out (cross-morsel timestamp ties), PERCENTILE
    is out (the combine folds sketches, the serial path np.percentile),
    SUM/AVG over float-valued expressions are out (re-association)."""
    for s in sites:
        if s.name == "COUNT" and s.distinct:
            if len(s.args) != 1 or not isinstance(s.args[0], S.Col):
                return False
            spec = table.columns.get(s.args[0].name)
            if spec is None or spec.kind != "str":
                return False  # only dict-id sets union encoded-exactly
            continue
        if s.name in ("COUNT", "MIN", "MAX"):
            continue
        if s.name in ("SUM", "AVG"):
            if (s.args and not isinstance(s.args[0], S.Star)
                    and not _int_exact(table, s.args[0])):
                return False
            continue
        return False
    return True


def _plan_parallel(table: TableView, query: S.Select):
    """-> (kernel, sites, est_rows) when the morsel path applies to this
    query, else None. DF_QUERY_PARALLEL=1/0 forces the choice; otherwise
    the learned degree model decides, behind a hard floor so queries
    smaller than two morsels never pay pool dispatch."""
    if qpool.in_worker():
        return None
    force = os.environ.get("DF_QUERY_PARALLEL", "").strip()
    if force == "0" or qpool.configured_threads() <= 1:
        return None
    if not _is_agg_query(query):
        return None
    try:
        sites = _agg_sites(query)
    except QueryError:
        return None
    if not _parallel_sites_ok(table, query, sites):
        return None
    est = len(table)
    if force != "1":
        if est < 2 * _morsel_rows():
            return None
        kernel = _DEGREE.choose(est)
    else:
        kernel = "parallel"
    return kernel, sites, est


def _execute_parallel(table: TableView, query: S.Select,
                      sites: list) -> QueryResult | None:
    """Morsel-parallel aggregate scan. Fixed-row morsels over the view's
    chunks fan out on the shared pool; each worker filters, groups and
    reduces its slice into an encoded partial (the native kernels run
    concurrently, outside the interpreter lock), and the partials fold
    through the exact combine machinery.

    Byte-identity: morsels preserve row order, so the per-group state
    each one emits starts from the same row order the serial scan sees;
    combine_partials(ascending=True) yields ONE partial whose groups
    are ascending-unique — re-grouping that in merge_partials is a
    fixed point, its per-site folds run over single-element groups
    (identity), and ascending group order is exactly the serial
    executor's _group_order contract. Returns None to fall back when
    the pool is unavailable.

    The reference also returns None when a dictionary was compacted
    mid-scan, since its morsels encode against the table's live
    dictionaries. Every partial here encodes against the view's
    dictionaries, which a compaction never changes (it swaps in new
    ones and new chunks together), so that check has nothing to catch."""
    p = qpool.get_pool()
    if p is None:
        return None
    needed = _needed_cols(table, query)
    chunks = _scan_plan(table, query)
    mrows = _morsel_rows()
    morsels: list[tuple[dict, int, int]] = []
    for ch in chunks:
        sz = _chunk_rows(ch)
        for lo in range(0, sz, mrows):
            morsels.append((ch, lo, min(lo + mrows, sz)))
    dict_names = {id(d): cn for cn, d in table.dicts.items()}
    qtrace.annotate(morsels=len(morsels), degree=p.threads)
    where = query.where
    prims = _filter_prims(table, where) if where is not None else None

    def scan_one(m):
        ch, lo, hi = m
        n = hi - lo
        if prims is not None:
            idx = _select_rows(lambda c: ch[c][lo:hi], n, prims)
            cols = {name: ch[name][lo:hi][idx] for name in needed}
            n = len(idx)
        elif where is not None:
            cols = {name: ch[name][lo:hi] for name in needed}
            mask = _Env(table, cols).eval(where).arr
            if mask.ndim == 0:  # no column refs: scalar condition
                mask = np.full(n, bool(mask))
            mask = mask.astype(bool)
            cols = {k: v[mask] for k, v in cols.items()}
            n = int(mask.sum())
        else:
            cols = {name: ch[name][lo:hi] for name in needed}
        return _partial_from_env(table, query, sites, _Env(table, cols),
                                 n, encoded=True, dict_names=dict_names,
                                 used={})

    parts = p.map(scan_one, morsels) if morsels else []
    combined = combine_partials(table, query, parts, ascending=True)
    return merge_partials(table, query, [combined])


# -- execution --------------------------------------------------------------

def execute(table: ColumnarTable | TableView,
            query: S.Select | str) -> QueryResult:
    """Run one query over one view of the table: its chunks and the
    dictionaries that decode them, as of one moment."""
    table = table.view()
    if isinstance(query, str):
        query = S.parse(query)
    query = _normalize(table, query)
    with qtrace.span(f"scan {table.name}") as tsp:
        return _execute_traced(table, query, tsp)


def _execute_traced(table: TableView, query: S.Select,
                    tsp) -> QueryResult:
    if os.environ.get("DF_QUERY_ENCODED", "1") == "0":
        tsp.annotate(mode="decoded")
        return _execute_decoded(table, query)
    plan = _plan_parallel(table, query)
    t0 = time.perf_counter_ns() if plan is not None else 0
    if plan is not None and plan[0] == "parallel":
        try:
            res = _execute_parallel(table, query, plan[1])
        except _FastUnsupported:
            res = None
        if res is not None:
            _DEGREE.observe("parallel", plan[2],
                            time.perf_counter_ns() - t0)
            tsp.annotate(mode="parallel", est_rows=plan[2])
            return res
        plan = None  # fell back; don't skew the serial coefficient
    tsp.annotate(mode="serial")
    res = _execute_encoded(table, query)
    if plan is not None:
        _DEGREE.observe("serial", plan[2], time.perf_counter_ns() - t0)
    return res


def _outputs(query: S.Select, env: _Env, n_rows: int):
    """-> (per-item values, group order, group bounds); order and bounds
    are None for a query with no aggregate. A bare literal broadcasts
    over the rows, or over the groups."""
    if not _is_agg_query(query):
        order = bounds = None
        vals = [env.eval(i.expr) for i in query.items]
        n_out = n_rows
    else:
        order, bounds = _group_order(env, query, n_rows)
        vals = [_agg_eval(i.expr, env, order, bounds) for i in query.items]
        n_out = len(bounds)
    outs = [_Val(np.full(n_out, v.arr.item()), v.kind) if v.arr.ndim == 0
            else v for v in vals]
    return outs, order, bounds


def _having_mask(query: S.Select, env: _Env, order, bounds) -> np.ndarray:
    mask = _agg_eval(query.having, env, order, bounds).arr
    if mask.ndim == 0:
        mask = np.full(len(bounds), bool(mask))
    return mask.astype(bool)


def _execute_encoded(table: TableView, query: S.Select) -> QueryResult:
    env, n_rows = _materialize(table, query)
    names = [i.alias or S.expr_name(i.expr) for i in query.items]
    outs, order, bounds = _outputs(query, env, n_rows)
    if query.having is not None:
        mask = _having_mask(query, env, order, bounds)
        outs = [_slice_val(v, mask) for v in outs]
    return _finish_columnar(query, names, outs)


def _execute_decoded(table: TableView, query: S.Select) -> QueryResult:
    """Decode-then-Python-sort tail (DF_QUERY_ENCODED=0). Kept as the
    parity reference the encoded path must match."""
    env, n_rows = _materialize(table, query)
    names = [i.alias or S.expr_name(i.expr) for i in query.items]
    outs, order, bounds = _outputs(query, env, n_rows)
    decoded = [v.decoded() for v in outs]
    n_out = max((len(d) for d in decoded), default=0)
    rows = [list(r) for r in zip(*decoded)] if n_out else []
    if query.having is not None:
        mask = _having_mask(query, env, order, bounds)
        rows = [r for r, keep in zip(rows, mask) if keep]
    return QueryResult(columns=names, values=_order_limit(query, names,
                                                           rows))


def _order_limit(query: S.Select, names: list[str],
                 rows: list[list]) -> list[list]:
    """ORDER BY over decoded output rows (one stable sort per key, last
    key first), then LIMIT."""
    for e, desc in reversed(query.order_by):
        idx = _order_index(names, e)
        rows.sort(key=lambda r: r[idx], reverse=desc)
    if query.limit is not None:
        rows = rows[:query.limit]
    return rows


# -- partial aggregates + merge reduce --------------------------------------
#
# execute_partial() runs a query's aggregates over one set of rows into
# per-group mergeable states; combine_partials() folds partials of
# disjoint row sets into one; merge_partials() applies HAVING / ORDER BY
# / LIMIT over them. Every side derives the partial's layout from the
# same _normalize()d query, so a partial carries no schema. The morsel-
# parallel scan (one partial per morsel) and the query cache (one per
# 60 s bucket) are built on them; the reference's federation is too.
# Distributive aggregates (SUM/COUNT/MIN/MAX) fold exactly, AVG travels
# as (sum, count), COUNT(DISTINCT) as per-group distinct values, LAST as
# (value, time) pairs resolved by max time, PERCENTILE as a mergeable
# histogram sketch (the one approximate merge).
#
# execute_partial(encoded=True) keeps dictionary/enum columns as INT id
# arrays plus a {"dicts": {col: [gen, len]}} manifest, valid against the
# dictionaries of the view it scanned; encoded=False keys groups by
# DECODED values. _inflate_partial() lowers any mix of the two forms to
# decoded values, and the generic merge reduces them.

def _agg_sites(query: S.Select) -> list[S.Func]:
    """Unique aggregate call sites (by display name) across SELECT items
    and HAVING, in discovery order."""
    sites: list[S.Func] = []
    seen: set[str] = set()

    def walk(e) -> None:
        if isinstance(e, S.Func):
            if e.name in S.AGG_FUNCS:
                k = S.expr_name(e)
                if k not in seen:
                    seen.add(k)
                    sites.append(e)
                return
            for a in e.args:
                walk(a)
        elif isinstance(e, S.BinOp):
            walk(e.left)
            if not isinstance(e.right, tuple):
                walk(e.right)
        elif isinstance(e, S.Not):
            walk(e.expr)
        elif isinstance(e, S.Case):
            for c, v in e.whens:
                walk(c)
                walk(v)
            if e.default is not None:
                walk(e.default)

    for item in query.items:
        walk(item.expr)
    if query.having is not None:
        walk(query.having)
    return sites


def _decode_slice(v: _Val, arr: np.ndarray) -> list:
    w = _Val(arr, v.kind, labels=v.labels)
    w.dict_ = v.dict_
    return w.decoded()


def _partial_state(site: S.Func, env: _Env, order: np.ndarray,
                   starts: np.ndarray, ends: np.ndarray) -> list:
    """Per-group mergeable state for one aggregate site (JSON-able,
    decoded — the cross-version compat form)."""
    n_groups = len(starts)
    if n_groups == 0:
        return []
    name = site.name
    if name == "COUNT" and site.distinct:
        if len(site.args) != 1 or isinstance(site.args[0], S.Star):
            raise QueryError("COUNT(DISTINCT) takes exactly one column")
        v = env.eval(site.args[0])
        a = v.arr[order]
        return [_decode_slice(v, np.unique(a[s0:e0]))
                for s0, e0 in zip(starts, ends)]
    if site.distinct:
        raise QueryError(
            f"DISTINCT is only supported in Count(), not {name}")
    if name == "COUNT" or not site.args or isinstance(site.args[0], S.Star):
        return (ends - starts).astype(np.float64).tolist()
    v = env.eval(site.args[0])
    if name == "LAST":
        idx = order[ends - 1]
        vals = _decode_slice(v, v.arr[idx])
        # pair with the row's timestamp so the merge picks the globally
        # newest candidate; without a time column the pick is arbitrary
        t = (env.cols["time"][idx].astype(np.int64).tolist()
             if "time" in env.cols else [0] * n_groups)
        return [[val, int(tt)] for val, tt in zip(vals, t)]
    if v.kind in ("str", "enum", "obj"):
        raise QueryError(
            f"{name} over string column {S.expr_name(site.args[0])!r}")
    a = v.arr.astype(np.float64)[order]
    if name == "SUM":
        return np.add.reduceat(a, starts).tolist()
    if name == "AVG":
        s = np.add.reduceat(a, starts)
        return [[float(x), int(c)] for x, c in zip(s, ends - starts)]
    if name == "MIN":
        return np.minimum.reduceat(a, starts).tolist()
    if name == "MAX":
        return np.maximum.reduceat(a, starts).tolist()
    if name == "PERCENTILE":
        out = []
        for s0, e0 in zip(starts, ends):
            sk = HistogramSketch()
            sk.add_many(a[s0:e0])
            out.append(sk.to_dict())
        return out
    raise QueryError(f"unknown aggregate {name}")


def _partial_state_enc(site: S.Func, env: _Env, order: np.ndarray,
                       starts: np.ndarray, ends: np.ndarray,
                       dict_names: dict, used: dict):
    """Encoded per-site state: float64 arrays for the distributive
    aggregates, dictionary-id sets for COUNT(DISTINCT str). LAST and
    PERCENTILE keep their decoded forms (value+timestamp pairs and
    sketches merge on decoded/abstract state anyway)."""
    n_groups = len(starts)
    if n_groups == 0:
        return []
    name = site.name
    if name == "COUNT" and site.distinct:
        if len(site.args) != 1 or isinstance(site.args[0], S.Star):
            raise QueryError("COUNT(DISTINCT) takes exactly one column")
        v = env.eval(site.args[0])
        key = dict_names.get(id(v.dict_)) if v.kind == "str" else None
        if key is not None:
            used[key] = v.dict_
            a = v.arr[order]
            return {"ed": key,
                    "sets": [np.unique(a[s0:e0]).astype(np.int64).tolist()
                             for s0, e0 in zip(starts, ends)]}
        return _partial_state(site, env, order, starts, ends)
    if site.distinct:
        raise QueryError(
            f"DISTINCT is only supported in Count(), not {name}")
    if name == "COUNT" or not site.args or isinstance(site.args[0], S.Star):
        return {"a": (ends - starts).astype(np.float64)}
    if name in ("LAST", "PERCENTILE"):
        return _partial_state(site, env, order, starts, ends)
    v = env.eval(site.args[0])
    if v.kind in ("str", "enum", "obj"):
        raise QueryError(
            f"{name} over string column {S.expr_name(site.args[0])!r}")
    af = v.arr.astype(np.float64)
    bounds_full = np.append(starts, len(order))
    if name == "SUM":
        return {"a": _group_reduce("SUM", af, order, bounds_full)}
    if name == "AVG":
        return {"avg": [_group_reduce("SUM", af, order, bounds_full),
                        (ends - starts).astype(np.float64)]}
    if name == "MIN":
        return {"a": _group_reduce("MIN", af, order, bounds_full)}
    if name == "MAX":
        return {"a": _group_reduce("MAX", af, order, bounds_full)}
    raise QueryError(f"unknown aggregate {name}")


def _enc_col(v: _Val, arr: np.ndarray, dict_names: dict, used: dict):
    """Self-describing encoded column form for a group-key/item slice, or
    None when only the decoded list form can represent it ('obj')."""
    if v.kind == "str" and v.dict_ is not None:
        key = dict_names.get(id(v.dict_))
        if key is not None:
            used[key] = v.dict_
            return {"e": key,
                    "ids": np.ascontiguousarray(arr, dtype=np.uint32)}
        return None
    if v.kind == "enum":
        return {"n": arr.astype(np.int64), "labels": list(v.labels)}
    if v.kind == "bool":
        return {"a": arr.astype(np.uint8), "k": "bool"}
    if v.kind == "num":
        return {"a": np.ascontiguousarray(arr)}
    return None


def _partial_from_env(table: TableView, query: S.Select, sites: list,
                      env: _Env, n_rows: int, *, encoded: bool,
                      dict_names: dict, used: dict) -> dict:
    """Group one materialized scope (a whole table scan or a single
    morsel) and build its per-group partial states. The dicts manifest
    is NOT attached here — the caller reads gen/len once after every
    scope it built is done (see execute_partial)."""
    order, bounds = _group_order(env, query, n_rows)
    starts = bounds
    ends = np.append(bounds[1:], len(order))
    n_groups = len(bounds)
    keys = []
    for g in query.group_by:
        v = env.eval(g)
        arr = v.arr[order][bounds] if n_groups else v.arr[:0]
        col = _enc_col(v, arr, dict_names, used) if encoded else None
        keys.append(col if col is not None else _decode_slice(v, arr))
    items: dict[str, object] = {}
    for idx, item in enumerate(query.items):
        if S.contains_agg(item.expr):
            continue
        v = env.eval(item.expr)
        if v.arr.ndim == 0:   # bare literal: broadcast over groups
            if encoded and v.kind == "num":
                items[str(idx)] = {"a": np.full(n_groups, v.arr.item())}
            else:
                items[str(idx)] = [v.arr.item()] * n_groups
            continue
        arr = v.arr[order][bounds] if n_groups else v.arr[:0]
        col = _enc_col(v, arr, dict_names, used) if encoded else None
        items[str(idx)] = col if col is not None else _decode_slice(v, arr)
    if encoded:
        site_states = {S.expr_name(s): _partial_state_enc(
            s, env, order, starts, ends, dict_names, used) for s in sites}
    else:
        site_states = {S.expr_name(s): _partial_state(s, env, order,
                                                      starts, ends)
                       for s in sites}
    return {"kind": "agg", "n_groups": n_groups, "keys": keys,
            "items": items, "sites": site_states}


def execute_partial(table: ColumnarTable | TableView, query: S.Select | str,
                    *, encoded: bool = False) -> dict:
    """One row set's half of a partial-aggregate query, over one view of
    the table. Row queries run fully (ORDER/LIMIT pushed down: a top-k of
    one row set is a superset of its share of the global top-k);
    aggregate queries return per-group partial states.

    encoded=False keys groups by DECODED values. encoded=True keeps
    dictionary ids plus a {"dicts": {col: [gen, len]}} manifest instead,
    valid against the dictionaries of the view it scanned."""
    table = table.view()
    if isinstance(query, str):
        query = S.parse(query)
    if not _is_agg_query(_normalize(table, query)):
        res = execute(table, query)
        return {"kind": "rows", "columns": res.columns,
                "values": res.values}
    query = _normalize(table, query)
    if encoded and os.environ.get("DF_QUERY_ENCODED", "1") == "0":
        encoded = False
    sites = _agg_sites(query)
    needs_time = (any(s.name == "LAST" for s in sites)
                  and "time" in table.columns)
    with qtrace.span(f"scan.partial {table.name}", encoded=encoded) as sp:
        return _execute_partial_traced(table, query, sites, needs_time,
                                       encoded, sp)


def _execute_partial_traced(table: TableView, query: S.Select,
                            sites, needs_time: bool, encoded: bool,
                            sp) -> dict:
    env, n_rows = _materialize(
        table, query, extra_cols={"time"} if needs_time else None)
    sp.annotate(rows=n_rows)
    dict_names = ({id(d): cn for cn, d in table.dicts.items()}
                  if encoded else {})
    used: dict = {}  # dict-columns actually shipped as ids
    out = _partial_from_env(table, query, sites, env, n_rows,
                            encoded=encoded, dict_names=dict_names,
                            used=used)
    if used:
        # The reference re-reads the table's dictionaries here and redoes
        # the partial decoded when a compaction swapped one mid-build. A
        # view pins its dictionaries with its chunks, so the ids above
        # are the view's; gen/len are read AFTER building, and len covers
        # every id shipped (dictionaries only grow within a gen).
        out["dicts"] = {key: list(d.sync_state()[:2])
                        for key, d in used.items()}
    return out


def _merge_site(site: S.Func, states: list) -> object:
    """Combine one aggregate site's per-partial states into the final
    scalar for one group."""
    name = site.name
    if name == "COUNT" and site.distinct:
        u: set = set()
        for s in states:
            u.update(s)
        return float(len(u))
    if name in ("COUNT", "SUM"):
        return float(sum(states))
    if name == "MIN":
        return float(min(states))
    if name == "MAX":
        return float(max(states))
    if name == "AVG":
        tot = sum(s for s, _ in states)
        n = sum(c for _, c in states)
        return float(tot) / max(n, 1)
    if name == "LAST":
        return max(states, key=lambda vt: vt[1])[0]
    if name == "PERCENTILE":
        merged = HistogramSketch()
        for d in states:
            merged.merge(HistogramSketch.from_dict(d))
        p_arg = site.args[1] if len(site.args) == 2 else None
        if not isinstance(p_arg, S.Lit):
            raise QueryError(
                "Percentile(col, p) needs a literal p to federate")
        return merged.percentile(float(p_arg.value))
    raise QueryError(f"unknown aggregate {name}")


_CMP = {"=": lambda l, r: l == r, "!=": lambda l, r: l != r,
        "<": lambda l, r: l < r, "<=": lambda l, r: l <= r,
        ">": lambda l, r: l > r, ">=": lambda l, r: l >= r}


def _scalar_eval(e, agg_vals: dict, named: dict):
    """Evaluate one merged group's output expression: aggregate sites
    resolve to their merged values, everything else must be a group key
    (or shipped non-agg item) looked up by display name."""
    if isinstance(e, S.Lit):
        return e.value
    if isinstance(e, S.Func) and e.name in S.AGG_FUNCS:
        return agg_vals[S.expr_name(e)]
    if not S.contains_agg(e):
        key = S.expr_name(e)
        if key in named:
            return named[key]
        if isinstance(e, (S.Col, S.Func)):
            raise QueryError(
                f"federated merge cannot evaluate {key!r}: "
                "not a group key or aggregate")
    if isinstance(e, S.Not):
        return not _scalar_eval(e.expr, agg_vals, named)
    if isinstance(e, S.Case):
        for c, v in e.whens:
            if _scalar_eval(c, agg_vals, named):
                return _scalar_eval(v, agg_vals, named)
        return (_scalar_eval(e.default, agg_vals, named)
                if e.default is not None else None)
    if isinstance(e, S.BinOp):
        op = e.op
        if op == "AND":
            return bool(_scalar_eval(e.left, agg_vals, named)) and \
                bool(_scalar_eval(e.right, agg_vals, named))
        if op == "OR":
            return bool(_scalar_eval(e.left, agg_vals, named)) or \
                bool(_scalar_eval(e.right, agg_vals, named))
        if op == "IN":
            lv = _scalar_eval(e.left, agg_vals, named)
            return lv in tuple(lit.value for lit in e.right)
        if op == "LIKE":
            lv = _scalar_eval(e.left, agg_vals, named)
            return _like_to_pred(e.right.value)(str(lv))
        left = _scalar_eval(e.left, agg_vals, named)
        right = _scalar_eval(e.right, agg_vals, named)
        if op in _CMP:
            return _CMP[op](left, right)
        lf, rf = float(left), float(right)
        if op == "+":
            return lf + rf
        if op == "-":
            return lf - rf
        if op == "*":
            return lf * rf
        if op == "/":
            return lf / rf if rf else 0.0
        raise QueryError(f"unknown op {op}")
    raise QueryError(f"cannot merge-evaluate {e!r}")


# -- encoded merge: vectorized fast path with decoded fallback --------------

class _FastUnsupported(Exception):
    """Internal: the vectorized merge/combine can't represent this query
    or partial form exactly — fall back to the decoded generic path."""


def _table_dict(table: ColumnarTable | TableView, key: str):
    d = table.dicts.get(key)
    if d is None:
        raise QueryError(f"unknown dictionary column {key!r} in partial")
    return d


def _col_form(c, size: int):
    """-> (values_arr, int64_key_arr, meta) for an encoded partial column;
    raises _FastUnsupported for decoded lists / float keys / unknown
    forms (those take the generic merge)."""
    if isinstance(c, dict):
        if "e" in c:
            a = np.asarray(c["ids"])
            if len(a) != size:
                raise _FastUnsupported
            return a, a.astype(np.int64), ("e", c["e"])
        if "n" in c:
            a = np.asarray(c["n"])
            if len(a) != size:
                raise _FastUnsupported
            return a, a.astype(np.int64), ("n", tuple(c["labels"]))
        if "a" in c:
            a = np.asarray(c["a"])
            if len(a) != size or a.dtype.kind not in "iub":
                raise _FastUnsupported
            return a, a.astype(np.int64), ("a", c.get("k", "num"))
    raise _FastUnsupported


def _form_val(cat: np.ndarray, meta: tuple, sel, decoder) -> _Val:
    """Rebuild a _Val from a concatenated encoded column at `sel`."""
    kindm, info = meta
    a = cat[sel]
    if kindm == "e":
        v = _Val(a.astype(np.uint32), "str")
        v.dict_ = decoder(info)
        return v
    if kindm == "n":
        return _Val(a, "enum", labels=tuple(info))
    if info == "bool":
        return _Val(a, "bool")
    return _Val(a)


def _as_bool(a: np.ndarray, n: int) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 0:
        return np.full(n, bool(a))
    return a.astype(bool)


def _vec_eval(e, aggs: dict, named: dict, n: int) -> _Val:
    """Vectorized mirror of _scalar_eval over merged group columns.
    Raises _FastUnsupported wherever array semantics could diverge from
    the scalar path (CASE without vectorizable shape, cross-dictionary
    string compares, LIKE over non-strings) so exactness is preserved by
    falling back rather than approximating."""
    if isinstance(e, S.Lit):
        if isinstance(e.value, str):
            raise _FastUnsupported
        return _Val(np.asarray(e.value, dtype=np.float64))
    if isinstance(e, S.Func) and e.name in S.AGG_FUNCS:
        k = S.expr_name(e)
        if k not in aggs:
            raise _FastUnsupported
        return _Val(aggs[k])
    if not S.contains_agg(e):
        k = S.expr_name(e)
        if k in named:
            return named[k]
        if isinstance(e, (S.Col, S.Func)):
            raise QueryError(
                f"federated merge cannot evaluate {k!r}: "
                "not a group key or aggregate")
    if isinstance(e, S.Not):
        v = _vec_eval(e.expr, aggs, named, n)
        return _Val(~_as_bool(v.arr, n), "bool")
    if isinstance(e, S.BinOp):
        op = e.op
        if op in ("AND", "OR"):
            l = _as_bool(_vec_eval(e.left, aggs, named, n).arr, n)
            r = _as_bool(_vec_eval(e.right, aggs, named, n).arr, n)
            return _Val(l & r if op == "AND" else l | r, "bool")
        if op == "IN":
            lv = _vec_eval(e.left, aggs, named, n)
            vals = tuple(lit.value for lit in e.right)
            if lv.kind == "str":
                ids = [lv.dict_.lookup(s) for s in vals
                       if isinstance(s, str)]
                ids = np.asarray([i for i in ids if i is not None],
                                 dtype=np.uint32)
                return _Val(_isin(lv.arr, ids), "bool")
            if lv.kind == "enum":
                ids = [i for i, s in enumerate(lv.labels) if s in vals]
                return _Val(np.isin(lv.arr, ids), "bool")
            if lv.kind == "obj":
                raise _FastUnsupported
            return _Val(np.isin(lv.arr, vals), "bool")
        if op == "LIKE":
            lv = _vec_eval(e.left, aggs, named, n)
            pred = _like_to_pred(e.right.value)
            if lv.kind == "str":
                return _Val(_isin(lv.arr, lv.dict_.match_ids(pred)),
                            "bool")
            if lv.kind == "enum":
                ids = [i for i, s in enumerate(lv.labels) if pred(s)]
                return _Val(np.isin(lv.arr, ids), "bool")
            raise _FastUnsupported
        if op in _CMP:
            rv_raw = e.right
            if isinstance(rv_raw, S.Lit) and isinstance(rv_raw.value, str):
                if op not in ("=", "!="):
                    raise _FastUnsupported
                lv = _vec_eval(e.left, aggs, named, n)
                if lv.kind == "str":
                    sid = lv.dict_.lookup(rv_raw.value)
                    code = (np.uint32(sid) if sid is not None
                            else np.uint32(0xFFFFFFFF))
                elif lv.kind == "enum":
                    try:
                        code = lv.labels.index(rv_raw.value)
                    except ValueError:
                        code = -1
                else:
                    raise _FastUnsupported
                res = lv.arr == code if op == "=" else lv.arr != code
                return _Val(np.asarray(res), "bool")
            lv = _vec_eval(e.left, aggs, named, n)
            rv = _vec_eval(rv_raw, aggs, named, n)
            if (lv.kind in ("str", "enum", "obj")
                    or rv.kind in ("str", "enum", "obj")):
                if (lv.kind == "str" and rv.kind == "str"
                        and lv.dict_ is rv.dict_ and op in ("=", "!=")):
                    res = (lv.arr == rv.arr if op == "="
                           else lv.arr != rv.arr)
                    return _Val(res, "bool")
                raise _FastUnsupported
            return _Val(np.asarray(_CMP[op](lv.arr, rv.arr)), "bool")
        lv = _vec_eval(e.left, aggs, named, n)
        rv = _vec_eval(e.right, aggs, named, n)
        if lv.kind not in ("num", "bool") or rv.kind not in ("num", "bool"):
            raise _FastUnsupported
        l = lv.arr.astype(np.float64)
        r = rv.arr.astype(np.float64)
        if op == "+":
            return _Val(l + r)
        if op == "-":
            return _Val(l - r)
        if op == "*":
            return _Val(l * r)
        if op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                return _Val(np.where(r != 0, l / np.where(r == 0, 1, r),
                                     0.0))
        raise _FastUnsupported
    raise _FastUnsupported


def _merge_fast(table: TableView, query: S.Select, names: list[str],
                sites: list, site_keys: list[str], parts: list[dict],
                decoder) -> QueryResult:
    """Vectorized merge over fully-encoded partials: concatenate group-key
    int columns, one hash-group pass, reduceat the site arrays. Any form
    it can't fold exactly raises _FastUnsupported (caller falls back)."""
    live = [p for p in parts if int(p.get("n_groups", 0)) > 0]
    if not live:
        return QueryResult(columns=names, values=[])
    sizes = [int(p["n_groups"]) for p in live]
    K = len(query.group_by)
    # group-key columns, concatenated across partials
    key_vals: list[tuple[np.ndarray, tuple]] = []
    key_ints: list[np.ndarray] = []
    for ki in range(K):
        vals, ints, metas = [], [], set()
        for p, sz in zip(live, sizes):
            cols = p.get("keys", [])
            if ki >= len(cols):
                raise _FastUnsupported
            a, ia, m = _col_form(cols[ki], sz)
            vals.append(a)
            ints.append(ia)
            metas.add(m)
        if len(metas) != 1:
            raise _FastUnsupported  # mixed encoded and decoded forms
        key_vals.append((np.concatenate(vals), metas.pop()))
        key_ints.append(np.concatenate(ints))
    # shipped non-aggregate item columns
    item_cols: dict[str, tuple[np.ndarray, tuple]] = {}
    for idx, item in enumerate(query.items):
        if S.contains_agg(item.expr):
            continue
        si = str(idx)
        vals, metas = [], set()
        for p, sz in zip(live, sizes):
            c = p.get("items", {}).get(si)
            if c is None:
                raise _FastUnsupported
            a, _ia, m = _col_form(c, sz)
            vals.append(a)
            metas.add(m)
        if len(metas) != 1:
            raise _FastUnsupported
        item_cols[si] = (np.concatenate(vals), metas.pop())
    # site states: only plain-array and (sum,count) forms vectorize
    site_states: dict[str, tuple[str, list]] = {}
    for s, sk in zip(sites, site_keys):
        form = None
        acc = []
        for p, sz in zip(live, sizes):
            st = p.get("sites", {}).get(sk)
            if not isinstance(st, dict):
                raise _FastUnsupported
            if "a" in st:
                f = "a"
                a = np.asarray(st["a"], dtype=np.float64)
                if len(a) != sz:
                    raise _FastUnsupported
                acc.append((a,))
            elif "avg" in st:
                f = "avg"
                ss = np.asarray(st["avg"][0], dtype=np.float64)
                cc = np.asarray(st["avg"][1], dtype=np.float64)
                if len(ss) != sz or len(cc) != sz:
                    raise _FastUnsupported
                acc.append((ss, cc))
            else:
                raise _FastUnsupported
            if form is None:
                form = f
            elif form != f:
                raise _FastUnsupported
        site_states[sk] = (form, acc)

    total = sum(sizes)
    if K == 0:
        order = np.arange(total, dtype=np.int64)
        bounds_full = np.array([0, total], dtype=np.int64)
        ng = 1
    else:
        # first-occurrence order == the generic merge's discovery order
        order, bounds_full, ng = _group_rows(key_ints,
                                             first_occurrence=True)
    starts = bounds_full[:-1]
    rep = order[starts]

    aggs: dict[str, np.ndarray] = {}
    for s, sk in zip(sites, site_keys):
        form, acc = site_states[sk]
        if form == "a":
            cat = np.concatenate([a for (a,) in acc])[order]
            if s.name in ("COUNT", "SUM"):
                aggs[sk] = np.add.reduceat(cat, starts)
            elif s.name == "MIN":
                aggs[sk] = np.minimum.reduceat(cat, starts)
            elif s.name == "MAX":
                aggs[sk] = np.maximum.reduceat(cat, starts)
            else:
                raise _FastUnsupported
        else:
            if s.name != "AVG":
                raise _FastUnsupported
            ssum = np.concatenate([x for x, _c in acc])[order]
            scnt = np.concatenate([c for _x, c in acc])[order]
            ms = np.add.reduceat(ssum, starts)
            mc = np.add.reduceat(scnt, starts)
            aggs[sk] = ms / np.maximum(mc, 1)

    named: dict[str, _Val] = {}
    for gexpr, (cat, meta) in zip(query.group_by, key_vals):
        named[S.expr_name(gexpr)] = _form_val(cat, meta, rep, decoder)
    item_vals: dict[str, _Val] = {}
    for idx, item in enumerate(query.items):
        si = str(idx)
        if si in item_cols:
            cat, meta = item_cols[si]
            v = _form_val(cat, meta, rep, decoder)
            item_vals[si] = v
            named[S.expr_name(item.expr)] = v
            if item.alias:
                named[item.alias] = v
    n_cur = ng
    if query.having is not None:
        hv = _vec_eval(query.having, aggs, named, n_cur)
        mask = _as_bool(hv.arr, n_cur)
        aggs = {k: v[mask] for k, v in aggs.items()}
        named = {k: _slice_val(v, mask) for k, v in named.items()}
        item_vals = {k: _slice_val(v, mask) for k, v in item_vals.items()}
        n_cur = int(mask.sum())
    outs = []
    for idx, item in enumerate(query.items):
        if not S.contains_agg(item.expr):
            outs.append(item_vals[str(idx)])
            continue
        v = _vec_eval(item.expr, aggs, named, n_cur)
        if v.arr.ndim == 0:
            v = _Val(np.full(n_cur, v.arr.item()), v.kind)
        outs.append(v)
    return _finish_columnar(query, names, outs)


def _col_decoded(c, decoder) -> list:
    """Lower any partial column form to the decoded list form."""
    if isinstance(c, list):
        return c
    if isinstance(c, dict):
        if "e" in c:
            ids = np.asarray(c["ids"], dtype=np.uint32)
            return decoder(c["e"]).decode_many(ids)
        if "n" in c:
            lab = list(c["labels"])
            return [lab[int(i)] for i in np.asarray(c["n"]).tolist()]
        if "a" in c:
            a = np.asarray(c["a"])
            if c.get("k") == "bool":
                return a.astype(bool).tolist()
            return a.tolist()
    raise QueryError("unrecognized partial column form")


def _inflate_partial(p: dict, decoder) -> dict:
    """Lower an encoded partial to the decoded form so the generic merge
    can join it against decoded partials."""
    if not p or p.get("kind") != "agg":
        return p
    q = dict(p)
    q["keys"] = [_col_decoded(c, decoder) for c in p.get("keys", [])]
    q["items"] = {k: _col_decoded(v, decoder)
                  for k, v in p.get("items", {}).items()}
    sites = {}
    for sk, st in p.get("sites", {}).items():
        if isinstance(st, dict):
            if "a" in st:
                sites[sk] = np.asarray(st["a"], dtype=np.float64).tolist()
            elif "avg" in st:
                s_arr = np.asarray(st["avg"][0], dtype=np.float64)
                c_arr = np.asarray(st["avg"][1], dtype=np.float64)
                sites[sk] = [[float(x), int(c)]
                             for x, c in zip(s_arr.tolist(),
                                             c_arr.tolist())]
            elif "ed" in st:
                d = decoder(st["ed"])
                sites[sk] = [d.decode_many(np.asarray(g, dtype=np.uint32))
                             for g in st["sets"]]
            else:
                raise QueryError("unrecognized partial site form")
        else:
            sites[sk] = st
    q["sites"] = sites
    return q


def merge_partials(table: ColumnarTable | TableView,
                   query: S.Select | str, partials: list[dict], *,
                   decoder=None) -> QueryResult:
    """Reduce step over execute_partial() results. HAVING / ORDER BY /
    LIMIT apply only here, at the top.

    Fully-encoded partials (ids in the decoder's dictionaries) merge on
    the vectorized int-key fast path; anything else is lowered to
    decoded values and joins on the generic per-group path. decoder maps
    a dict column name to a Dictionary; it defaults to the dictionaries
    of ``table`` (pass the view the partials scanned)."""
    with qtrace.span("merge.partials", partials=len(partials)):
        return _merge_partials_impl(table, query, partials,
                                    decoder=decoder)


def _merge_partials_impl(table: ColumnarTable | TableView,
                         query: S.Select | str,
                         partials: list[dict], *,
                         decoder=None) -> QueryResult:
    if isinstance(query, str):
        query = S.parse(query)
    query = _normalize(table, query)
    names = [i.alias or S.expr_name(i.expr) for i in query.items]
    parts = [p for p in partials if p]
    if not _is_agg_query(query):
        rows = []
        for p in parts:
            if p.get("kind") != "rows":
                raise QueryError("shard returned mismatched partial kind")
            rows.extend(list(r) for r in p.get("values", []))
        return QueryResult(columns=names,
                           values=_order_limit(query, names, rows))
    for p in parts:
        if p.get("kind") != "agg":
            raise QueryError("shard returned mismatched partial kind")
    sites = _agg_sites(query)
    site_keys = [S.expr_name(s) for s in sites]
    if decoder is None:
        decoder = lambda key: _table_dict(table, key)  # noqa: E731
    if os.environ.get("DF_QUERY_ENCODED", "1") != "0":
        try:
            return _merge_fast(table, query, names, sites, site_keys,
                               parts, decoder)
        except _FastUnsupported:
            pass
    parts = [_inflate_partial(p, decoder) for p in parts]
    groups: dict[tuple, dict] = {}
    group_seq: list[tuple] = []
    for p in parts:
        keys = p.get("keys", [])
        for gi in range(int(p.get("n_groups", 0))):
            kt = tuple(col[gi] for col in keys)
            g = groups.get(kt)
            if g is None:
                g = groups[kt] = {
                    "items": {k: v[gi]
                              for k, v in p.get("items", {}).items()},
                    "sites": {sk: [] for sk in site_keys}}
                group_seq.append(kt)
            for sk in site_keys:
                g["sites"][sk].append(p["sites"][sk][gi])
    rows = []
    for kt in group_seq:
        g = groups[kt]
        merged = {sk: _merge_site(s, g["sites"][sk])
                  for s, sk in zip(sites, site_keys)}
        named: dict[str, object] = {}
        for gexpr, kv in zip(query.group_by, kt):
            named[S.expr_name(gexpr)] = kv
        for idx, item in enumerate(query.items):
            if not S.contains_agg(item.expr):
                v = g["items"].get(str(idx))
                named[S.expr_name(item.expr)] = v
                if item.alias:
                    named[item.alias] = v
        if query.having is not None and \
                not _scalar_eval(query.having, merged, named):
            continue
        rows.append([
            (g["items"].get(str(idx))
             if not S.contains_agg(item.expr)
             else _scalar_eval(item.expr, merged, named))
            for idx, item in enumerate(query.items)])
    return QueryResult(columns=names,
                       values=_order_limit(query, names, rows))


def combine_partials(table: ColumnarTable | TableView,
                     query: S.Select | str,
                     parts: list[dict], *, ascending: bool = False) -> dict:
    """Fold several ENCODED partials over disjoint row sets (per-time-
    bucket cache slices, per-morsel scan results) into ONE partial equal
    to a single scan of their union. Exact for every supported site form
    — including PERCENTILE, whose histogram-sketch merge is bin-exact
    (only the percentile() readout approximates). LAST is excluded:
    cross-bucket timestamp ties could resolve differently than a single
    scan. Raises _FastUnsupported for anything it can't fold exactly.

    ascending=True emits groups in ascending key order instead of
    first-occurrence — the morsel-parallel path needs the combined
    partial to match the serial executor's _group_order layout so the
    final merge is byte-identical."""
    if isinstance(query, str):
        query = S.parse(query)
    query = _normalize(table, query)
    if not _is_agg_query(query):
        raise _FastUnsupported
    sites = _agg_sites(query)
    site_keys = [S.expr_name(s) for s in sites]
    if any(s.name == "LAST" for s in sites):
        raise _FastUnsupported
    for p in parts:
        if not p or p.get("kind") != "agg":
            raise _FastUnsupported
    live = [p for p in parts if int(p.get("n_groups", 0)) > 0]
    K = len(query.group_by)
    item_ids = [str(i) for i, it in enumerate(query.items)
                if not S.contains_agg(it.expr)]
    if not live:
        return {"kind": "agg", "n_groups": 0,
                "keys": [[] for _ in range(K)],
                "items": {si: [] for si in item_ids},
                "sites": {sk: [] for sk in site_keys}}
    sizes = [int(p["n_groups"]) for p in live]
    key_vals, key_ints = [], []
    for ki in range(K):
        vals, ints, metas = [], [], set()
        for p, sz in zip(live, sizes):
            a, ia, m = _col_form(p.get("keys", [])[ki], sz)
            vals.append(a)
            ints.append(ia)
            metas.add(m)
        if len(metas) != 1:
            raise _FastUnsupported
        key_vals.append((np.concatenate(vals), metas.pop()))
        key_ints.append(np.concatenate(ints))
    item_cols = {}
    for si in item_ids:
        vals, metas = [], set()
        for p, sz in zip(live, sizes):
            c = p.get("items", {}).get(si)
            if c is None:
                raise _FastUnsupported
            a, _ia, m = _col_form(c, sz)
            vals.append(a)
            metas.add(m)
        if len(metas) != 1:
            raise _FastUnsupported
        item_cols[si] = (np.concatenate(vals), metas.pop())

    total = sum(sizes)
    if K == 0:
        order = np.arange(total, dtype=np.int64)
        bounds_full = np.array([0, total], dtype=np.int64)
        ng = 1
    else:
        order, bounds_full, ng = _group_rows(
            key_ints, first_occurrence=not ascending)
    starts = bounds_full[:-1]
    ends = bounds_full[1:]
    rep = order[starts]

    def rebuild(cat, meta):
        kindm, info = meta
        a = cat[rep]
        if kindm == "e":
            return {"e": info, "ids": a.astype(np.uint32)}
        if kindm == "n":
            return {"n": a.astype(np.int64), "labels": list(info)}
        if info == "bool":
            return {"a": a, "k": "bool"}
        return {"a": a}

    out_keys = [rebuild(cat, meta) for cat, meta in key_vals]
    out_items = {si: rebuild(cat, meta)
                 for si, (cat, meta) in item_cols.items()}
    out_sites = {}
    for s, sk in zip(sites, site_keys):
        states = [p["sites"].get(sk) for p in live]
        if s.name == "PERCENTILE":
            if not all(isinstance(st, list) for st in states):
                raise _FastUnsupported
            cat = [d for st in states for d in st]
            merged = []
            for s0, e0 in zip(starts.tolist(), ends.tolist()):
                hs = HistogramSketch()
                for m in order[s0:e0].tolist():
                    hs.merge(HistogramSketch.from_dict(cat[m]))
                merged.append(hs.to_dict())
            out_sites[sk] = merged
            continue
        if all(isinstance(st, dict) and "a" in st for st in states):
            cat = np.concatenate(
                [np.asarray(st["a"], dtype=np.float64)
                 for st in states])[order]
            if s.name in ("COUNT", "SUM"):
                out_sites[sk] = {"a": np.add.reduceat(cat, starts)}
            elif s.name == "MIN":
                out_sites[sk] = {"a": np.minimum.reduceat(cat, starts)}
            elif s.name == "MAX":
                out_sites[sk] = {"a": np.maximum.reduceat(cat, starts)}
            else:
                raise _FastUnsupported
            continue
        if all(isinstance(st, dict) and "avg" in st for st in states):
            if s.name != "AVG":
                raise _FastUnsupported
            ssum = np.concatenate(
                [np.asarray(st["avg"][0], dtype=np.float64)
                 for st in states])[order]
            scnt = np.concatenate(
                [np.asarray(st["avg"][1], dtype=np.float64)
                 for st in states])[order]
            out_sites[sk] = {"avg": [np.add.reduceat(ssum, starts),
                                     np.add.reduceat(scnt, starts)]}
            continue
        if all(isinstance(st, dict) and "ed" in st for st in states):
            ed_keys = {st["ed"] for st in states}
            if len(ed_keys) != 1:
                raise _FastUnsupported
            cat = [g for st in states for g in st["sets"]]
            merged = []
            for s0, e0 in zip(starts.tolist(), ends.tolist()):
                u: set = set()
                for m in order[s0:e0].tolist():
                    u.update(int(x) for x in cat[m])
                merged.append(sorted(u))
            out_sites[sk] = {"ed": ed_keys.pop(), "sets": merged}
            continue
        raise _FastUnsupported

    out = {"kind": "agg", "n_groups": int(ng), "keys": out_keys,
           "items": out_items, "sites": out_sites}
    dicts: dict[str, list] = {}
    for p in live:
        for key, (g, ln) in (p.get("dicts") or {}).items():
            cur = dicts.get(key)
            if cur is None:
                dicts[key] = [int(g), int(ln)]
            elif cur[0] != int(g):
                raise _FastUnsupported  # gen flip between slices
            else:
                cur[1] = max(cur[1], int(ln))
    if dicts:
        out["dicts"] = dicts
    return out
