"""Tag/metric catalog + derived-metric registry.

Own copy of ``deepflow_tpu/query/catalog.py`` over the port's
``store/schema.py::TABLES``: ``show`` answers SHOW DATABASES, TABLES,
TAGS and METRICS from the live schema, and ``rewrite_derived`` turns an
aggregate of a derived metric into its definition over real columns: the
reference's rules over the flow-metric tables (``rtt`` of
``flow_metrics.network``, ``rrt`` and ``error`` of
``flow_metrics.application``).
"""

from __future__ import annotations

from deepflow_tpu_torch.query import sql as S
from deepflow_tpu_torch.store import schema

# Columns that are dimensions even though numeric
_NUMERIC_TAGS = {
    "agent_id", "host_id", "tpu_worker", "slice_id", "pid", "tid",
    "server_port", "port_src", "port_dst", "direction", "flow_id",
    "gprocess_id_0", "gprocess_id_1", "request_id", "tap_port",
    "tunnel_id", "device_id", "chip_id", "core_id", "program_id",
    "run_id", "step", "metric_id", "label_set_id", "time", "start_time",
    "end_time", "end_ns", "straggler_device",
}

# metric name -> per-aggregate rewrite, per table family (longest prefix
# wins). Shapes:
#   ("ratio", num, den): Avg(m) = Sum(num)/Sum(den)
#   ("col", c):          Agg(m) = Agg(c)
#   ("sum2", a, b):      Sum(m) = Sum(a)+Sum(b)
DERIVED: dict[str, dict[str, dict[str, tuple]]] = {
    "flow_metrics.network": {
        "rtt": {"AVG": ("ratio", "rtt_sum", "rtt_count")},
    },
    "flow_metrics.application": {
        "rrt": {"AVG": ("ratio", "rrt_sum", "rrt_count"),
                "MAX": ("col", "rrt_max")},
        "error": {"SUM": ("sum2", "error_client", "error_server")},
    },
}


def derived_for(table_name: str) -> dict:
    best = {}
    for prefix, metrics in DERIVED.items():
        if table_name.startswith(prefix):
            best = metrics
    return best


class DerivedError(Exception):
    """An aggregate the derived metric has no definition for."""


def rewrite_derived(expr, table_name: str, columns: set):
    """AST rewrite: Agg(derived_metric) -> its definition over the real
    columns. Only rewrites names that are NOT real columns of the table,
    so a raw table with a real column of that name is untouched."""
    metrics = derived_for(table_name)
    if not metrics:
        return expr

    def walk(e):
        if isinstance(e, S.Func):
            if (e.name in S.AGG_FUNCS and e.args
                    and isinstance(e.args[0], S.Col)
                    and e.args[0].name not in columns
                    and e.args[0].name in metrics):
                rules = metrics[e.args[0].name]
                rule = rules.get(e.name)
                if rule is None:
                    raise DerivedError(
                        f"{e.name} is not defined for derived metric "
                        f"{e.args[0].name!r} (supported: "
                        f"{', '.join(sorted(rules))})")
                if rule[0] == "ratio":
                    return S.BinOp("/", S.Func("SUM", (S.Col(rule[1]),)),
                                   S.Func("SUM", (S.Col(rule[2]),)))
                if rule[0] == "col":
                    return S.Func(e.name, (S.Col(rule[1]),))
                if rule[0] == "sum2":
                    return S.BinOp("+", S.Func("SUM", (S.Col(rule[1]),)),
                                   S.Func("SUM", (S.Col(rule[2]),)))
            return S.Func(e.name, tuple(walk(a) for a in e.args),
                          distinct=e.distinct)
        if isinstance(e, S.BinOp):
            right = (e.right if isinstance(e.right, tuple)
                     else walk(e.right))
            return S.BinOp(e.op, walk(e.left), right)
        if isinstance(e, S.Not):
            return S.Not(walk(e.expr))
        if isinstance(e, S.Case):
            return S.Case(
                tuple((walk(c), walk(v)) for c, v in e.whens),
                walk(e.default) if e.default is not None else None)
        return e

    return walk(expr)


# -- show tags / metrics ----------------------------------------------------

def _split(cols: list) -> tuple[list, list]:
    tags, metrics = [], []
    for c in cols:
        if c.kind in ("str", "enum") or c.name in _NUMERIC_TAGS:
            tags.append(c)
        else:
            metrics.append(c)
    return tags, metrics


def _resolve(table_name: str) -> tuple[str, list]:
    if table_name in schema.TABLES:
        return table_name, schema.TABLES[table_name]
    for cand in (f"{table_name}.1s", f"flow_metrics.{table_name}.1s",
                 f"flow_log.{table_name}", f"profile.{table_name}",
                 f"event.{table_name}"):
        if cand in schema.TABLES:
            return cand, schema.TABLES[cand]
    raise KeyError(table_name)


def show(what: str, table: str | None = None) -> dict:
    """Execute a SHOW statement against the schema catalog. Returns the
    querier wire shape {columns, values}."""
    if what == "databases":
        dbs = sorted({t.split(".")[0] for t in schema.TABLES})
        return {"columns": ["name"], "values": [[d] for d in dbs]}
    if what == "tables":
        return {"columns": ["name"],
                "values": [[t] for t in sorted(schema.TABLES)]}
    name, cols = _resolve(table)
    tags, metrics = _split(cols)
    if what == "tags":
        values = []
        for c in tags:
            typ = ("enum" if c.kind == "enum"
                   else "string" if c.kind == "str" else "int")
            enum_vals = ",".join(c.enum_values) if c.kind == "enum" else ""
            values.append([c.name, typ, enum_vals])
        return {"columns": ["name", "type", "enum_values"],
                "values": values, "table": name}
    if what == "metrics":
        values = [[c.name, "counter", c.kind] for c in metrics]
        for m, rules in derived_for(name).items():
            if m not in {c.name for c in cols}:
                values.append(
                    [m, "derived(" + ",".join(sorted(rules)) + ")", "f64"])
        return {"columns": ["name", "category", "type"],
                "values": values, "table": name}
    raise KeyError(what)
