"""The port's columnar query helpers held against the reference's DF-SQL
engine: random tables of u16 / u64 / dictionary-string columns, filled
with the same rows in a reference table and a port table, must give the
same rows for a filtered group-by with Sum and Count, ORDER BY and
LIMIT, and for a filtered, sorted select."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepflow_tpu.query import execute
from deepflow_tpu.store.table import ColumnarTable as RefTable
from deepflow_tpu.store.table import ColumnSpec as RefSpec
from deepflow_tpu_torch.query import columnar
from deepflow_tpu_torch.store.table import ColumnarTable, ColumnSpec

COLS = [("k16", "u16"), ("k64", "u64"), ("ks", "str"), ("v16", "u16"),
        ("v64", "u64")]
WORDS = ("", "a", "b", "gemm", "nccl")
# the reference adds in float64: keep every sum of up to 40 summands
# below 2**53, where float64 addition of integers is exact
V64_MAX = (1 << 40) - 1

_row = st.fixed_dictionaries({
    "k16": st.integers(0, 3) | st.integers(0, 65535),
    "k64": st.sampled_from([0, 1, (1 << 63) + 5, (1 << 64) - 1]),
    "ks": st.sampled_from(WORDS),
    "v16": st.integers(0, 65535),
    "v64": st.integers(0, V64_MAX),
})

# (port condition, DF-SQL text); values include ones the data never holds
_cond = st.one_of(
    st.integers(0, 65535).map(
        lambda x: (("k16", ">=", x), f"k16 >= {x}")),
    st.sampled_from([0, 1, 1 << 63, (1 << 64) - 1]).map(
        lambda x: (("k64", "<", x), f"k64 < {x}")),
    st.sampled_from(WORDS + ("absent",)).map(
        lambda w: (("ks", "=", w), f"ks = '{w}'")),
    st.sampled_from(WORDS + ("absent",)).map(
        lambda w: (("ks", "!=", w), f"ks != '{w}'")),
    st.lists(st.sampled_from(WORDS + ("absent",)), min_size=1,
             max_size=3, unique=True).map(
        lambda ws: (("ks", "in", tuple(ws)),
                    "ks IN (" + ", ".join(f"'{w}'" for w in ws) + ")")),
    st.integers(0, V64_MAX).map(
        lambda x: (("v64", ">", x), f"v64 > {x}")),
)

_keys = st.lists(st.sampled_from(["k16", "k64", "ks"]), min_size=1,
                 max_size=3, unique=True)


def _tables(rows):
    ref = RefTable("t", [RefSpec(n, k) for n, k in COLS])
    port = ColumnarTable("t", [ColumnSpec(n, k) for n, k in COLS])
    # two appends: the port merges chunks, the reference keeps stripes
    for t in (ref, port):
        t.append_rows(rows[:len(rows) // 2])
        t.append_rows(rows[len(rows) // 2:])
    return ref, port


def _where_sql(conds):
    return (" WHERE " + " AND ".join(sql for _, sql in conds)) if conds \
        else ""


@settings(max_examples=40, deadline=None)
@given(rows=st.lists(_row, min_size=1, max_size=40), keys=_keys,
       conds=st.lists(_cond, max_size=2),
       limit=st.integers(1, 6), desc=st.booleans(),
       sum_col=st.sampled_from(["v16", "v64"]))
def test_group_sum_count_like_reference(rows, keys, conds, limit, desc,
                                        sum_col):
    ref, port = _tables(rows)
    where = [c for c, _ in conds]
    sql = (f"SELECT {', '.join(keys)}, Sum({sum_col}) AS s, Count() AS n "
           f"FROM t{_where_sql(conds)} GROUP BY {', '.join(keys)}")
    nk = len(keys)

    def ints(res):  # the reference's Sum and Count come back as floats
        return [tuple(r[:nk]) + tuple(int(x) for x in r[nk:])
                for r in res.values]

    full = ints(execute(ref, sql))
    got = columnar.group(port, keys, [sum_col], count=True, where=where)
    assert sorted(map(tuple, got)) == sorted(full)
    assert all(isinstance(x, int) for r in got for x in r[nk:])

    # ORDER BY the sum, LIMIT: ties may pick different groups, so hold the
    # ranked sums equal and every returned group to the full answer
    top = ints(execute(ref, sql + f" ORDER BY s {'DESC' if desc else 'ASC'}"
                            f" LIMIT {limit}"))
    mine = columnar.group(port, keys, [sum_col], count=True, where=where,
                          order_by=sum_col, desc=desc, limit=limit)
    assert [r[nk] for r in mine] == [r[nk] for r in top]
    assert set(map(tuple, mine)) <= set(full)


@settings(max_examples=40, deadline=None)
@given(rows=st.lists(_row, max_size=40), conds=st.lists(_cond, max_size=2))
def test_select_sorted_like_reference(rows, conds):
    ref, port = _tables(rows) if rows else (None, None)
    if ref is None:  # an empty table answers no rows in both
        ref = RefTable("t", [RefSpec(n, k) for n, k in COLS])
        port = ColumnarTable("t", [ColumnSpec(n, k) for n, k in COLS])
    names = ["k16", "ks", "k64", "v64"]
    sql = f"SELECT {', '.join(names)} FROM t{_where_sql(conds)} ORDER BY v64"
    want = execute(ref, sql).values
    got = columnar.select(port, names, where=[c for c, _ in conds],
                          order_by="v64")
    assert [r[3] for r in got] == [r[3] for r in want]
    assert sorted(map(tuple, got)) == sorted(map(tuple, want))
    # without ORDER BY: table order, as the reference scans it
    plain = columnar.select(port, names, where=[c for c, _ in conds])
    assert plain == [list(r) for r in execute(
        ref, f"SELECT {', '.join(names)} FROM t{_where_sql(conds)}").values]


def test_sums_wrap_in_uint64_and_enum_labels():
    """Sums past 2**64 wrap (the port adds in uint64; the reference's
    float64 would round), and enum columns filter and decode by label."""
    t = ColumnarTable("t", [ColumnSpec("k", "enum", ("x", "y", "z")),
                            ColumnSpec("v", "u64")])
    big = (1 << 64) - 1
    t.append_rows([{"k": 1, "v": big}, {"k": 1, "v": 2}, {"k": 2, "v": 7}])
    assert columnar.group(t, ["k"], ["v"], count=True) == \
        [["y", 1, 2], ["z", 7, 1]]
    assert columnar.group(t, ["k"], ["v"], where=[("k", "in", ("z", "w"))]) \
        == [["z", 7]]
    assert columnar.select(t, ["k"], where=[("k", "!=", "w")]) == \
        [["y"], ["y"], ["z"]]
    assert columnar.group(t, ["k"], ["v"], where=[("v", ">", 1 << 70)]) == []
    # ids are not ordered like the strings or labels they stand for
    for bad in (lambda: columnar.select(t, ["v"], where=[("k", "<", "z")]),
                lambda: columnar.select(t, ["v"], order_by="k")):
        with pytest.raises(ValueError):
            bad()
    assert np.asarray(t.column_concat(["v"])["v"]).dtype == np.uint64
