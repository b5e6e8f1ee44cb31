"""Vectorized DF-SQL executor over ColumnarTables.

Own copy of the serial path of ``deepflow_tpu/query/engine.py``: the AST
compiles to numpy ops over the table's columns, with LIKE, IN and
string comparisons resolved over the (small) dictionaries rather than
the rows. Execution stays dictionary-ENCODED end to end: the WHERE
filters ids, grouping, HAVING, ORDER BY and LIMIT run on int columns
(ORDER BY over a str column through the dictionary's collation ranks),
and only the final rows are decoded to strings. DF_QUERY_ENCODED=0
selects the decode-then-Python-sort path the reference keeps for parity
checks.

Aggregates add in float64, as the reference's do: a Sum of integers is
exact while it stays below 2**53. Groups come out in ascending key
order; rows that tie on every ORDER BY key have no specified order.

Left out: the native hash-group and filter kernels with their learned
cost model, morsel-parallel scans, zone and bloom pruning (the port's
chunks keep no zone maps), the partial aggregates of federation, and the
query-trace spans.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

from deepflow_tpu_torch.query import catalog
from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.store.table import ColumnarTable, TableView


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
            return _Val(np.isin(lv.arr, vals), "bool")
        if op == "LIKE":
            lv = self.eval(e.left)
            if lv.kind == "str":
                ids = lv.dict_.match_ids(_like_to_pred(e.right.value))
                return _Val(np.isin(lv.arr, ids), "bool")
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
                        return _Val(np.isin(lv.arr, ids), "bool")
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

def _group_reduce(name: str, af: np.ndarray, order: np.ndarray,
                  bounds_full: np.ndarray) -> np.ndarray:
    """Gather + segmented reduce over float64 values: each group's values
    accumulate in row order."""
    if len(bounds_full) <= 1:
        return np.empty(0, dtype=np.float64)
    g = af.astype(np.float64)[order]
    ufn = {"SUM": np.add, "MIN": np.minimum, "MAX": np.maximum}[name]
    return ufn.reduceat(g, bounds_full[:-1])


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


def _needed_cols(table: ColumnarTable, query: S.Select) -> set[str]:
    """Every store column the query references, validated against the
    schema."""
    needed: set[str] = set()
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
    return prims


def _select_rows(cols: dict[str, np.ndarray], n: int,
                 prims: list[tuple]) -> np.ndarray:
    """Ascending survivor positions for an all-primitive WHERE. The
    first primitive selects over the full column; each later one gathers
    only the current survivors and refines (`idx = idx[sub_idx]`), so a
    selective leading conjunct makes the rest near-free. Ascending
    positions make `arr[idx]` equal `arr[mask]` on the generic path."""
    idx = None  # None = every row still alive
    for kind, col, a, b in prims:
        if kind == "never":
            return np.empty(0, dtype=np.int64)
        if idx is not None and not len(idx):
            return idx
        sub = cols[col] if idx is None else cols[col][idx]
        m = np.isin(sub, a) if kind == "isin" else (sub >= a) & (sub <= b)
        out = np.flatnonzero(m)
        idx = out if idx is None else idx[out]
    return np.arange(n) if idx is None else idx


def _materialize(table: TableView,
                 query: S.Select) -> tuple[_Env, int]:
    """WHERE-filter each chunk of the table's view, and materialize every
    referenced column of the surviving rows, in chunk order, into one
    _Env. Rows appended while the query runs are not in the view."""
    needed = _needed_cols(table, query)
    # no chunk: the WHERE still runs once, over empty columns, so a bad
    # condition fails on an empty table too
    chunks = table.chunks or [
        {name: np.empty(0, dtype=table.columns[name].np_dtype)
         for name in needed}]
    prims = None if query.where is None else _filter_prims(table,
                                                           query.where)
    parts: dict[str, list[np.ndarray]] = {name: [] for name in needed}
    n = 0
    for cols in chunks:
        m = len(next(iter(cols.values()), ()))
        if query.where is None:
            idx = slice(None)
            n += m
        else:
            if prims is not None:
                idx = _select_rows(cols, m, prims)
            else:
                mask = _Env(table, cols).eval(query.where).arr
                if mask.ndim == 0:  # WHERE with no column refs
                    mask = np.full(m, bool(mask))
                idx = np.flatnonzero(mask.astype(bool))
            n += len(idx)
        for name in needed:
            parts[name].append(cols[name][idx])
    return _Env(table, {name: p[0] if len(p) == 1 else np.concatenate(p)
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


def _group_rows(arrs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Group rows by the composite key over `arrs` (at least one row).

    -> (order, starts): order is a row permutation with groups contiguous
    in ascending-lexicographic key order and original row order within
    each group; starts are the groups' first positions in order."""
    ranks = [_sort_ranks(np.ascontiguousarray(a)) for a in arrs]
    n = len(ranks[0])
    order = np.lexsort(ranks[::-1]).astype(np.int64)
    changed = np.zeros(n, dtype=bool)
    changed[0] = True
    for r in ranks:
        sr = r[order]
        changed[1:] |= sr[1:] != sr[:-1]
    return order, np.flatnonzero(changed).astype(np.int64)


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
        return _group_rows(arrs)
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

def execute(table: ColumnarTable, query: S.Select | str) -> QueryResult:
    """Run one query over one view of the table: its chunks and the
    dictionaries that decode them, as of one moment."""
    table = table.view()
    if isinstance(query, str):
        query = S.parse(query)
    query = _normalize(table, query)
    if os.environ.get("DF_QUERY_ENCODED", "1") == "0":
        return _execute_decoded(table, query)
    return _execute_encoded(table, query)


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
