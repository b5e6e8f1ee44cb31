"""Own copy of ``deepflow_tpu/query/promql.py``. Remote-write series
(``prometheus.samples``, written by ``server/integration.py``) and
Telegraf's ``ext_metrics_<measurement>_<field>`` (``ext_metrics.metrics``)
resolve as in the reference; a name with no rows there answers "unknown
metric", as the reference's does.

PromQL engine over the metric tables.

Reference analog: server/querier/app/prometheus (the reference embeds the
full upstream promql engine over DeepFlow storage,
querier/app/prometheus/router/router.go:40-41). This is a from-scratch
engine with the upstream language surface Grafana panels and alert rules
actually use:

- selectors with =, !=, =~, !~ matchers, [range], offset
- binary ops between vectors with vector matching: on/ignoring,
  group_left/group_right, bool modifier; and/or/unless set ops;
  arithmetic + - * / % ^ and comparisons == != > < >= <=
- aggregations: sum avg min max count group stddev stdvar topk bottomk
  quantile count_values, with by/without
- range functions: rate irate increase delta idelta deriv predict_linear
  changes resets absent_over_time and the *_over_time family
  (avg/min/max/sum/count/last/present/stddev/stdvar/quantile)
- instant functions: histogram_quantile, clamp*, abs/ceil/floor/round,
  exp/ln/log2/log10/sqrt/sgn, scalar/vector/time/timestamp, absent,
  label_replace/label_join, sort/sort_desc
- subqueries expr[range:step]

Counter semantics are storage-aware: remote-write `prometheus.samples` and
`deepflow_system` snapshots hold CUMULATIVE counters (Prometheus-style
extrapolated rate with reset detection), while the internal flow_metrics
tables hold per-interval DELTA samples (rate = sum/range). Subquery results
feed rate() with cumulative semantics, matching upstream.

Metric naming: <family>_<column>, e.g. flow_metrics_network_byte_tx, plus
any remote-write metric name and deepflow_system self-telemetry.
"""

from __future__ import annotations

import json as _json
import math
import re
from dataclasses import dataclass, field

import numpy as np

from deepflow_tpu_torch.store.db import Database

_DUR_PART = re.compile(r"(\d+)(ms|s|m|h|d|w|y)")
_DUR_FULL = re.compile(r"^(?:\d+(?:ms|s|m|h|d|w|y))+$")
_DUR_S = {"ms": 0.001, "s": 1, "m": 60, "h": 3600, "d": 86400,
          "w": 604800, "y": 31536000}

_LOOKBACK_S = 300  # Prometheus staleness lookback

# metric prefix -> (table, tag label columns)
_NETWORK_TAGS = ["ip_src", "ip_dst", "server_port", "protocol", "host",
                 "pod_name", "tpu_pod", "slice_id", "agent_id"]
_APP_TAGS = ["ip_src", "ip_dst", "server_port", "l7_protocol", "app_service",
             "host", "pod_name", "tpu_pod", "slice_id", "agent_id"]

_FAMILIES = {
    "flow_metrics_network_": ("flow_metrics.network.1s", _NETWORK_TAGS),
    "flow_metrics_application_": ("flow_metrics.application.1s", _APP_TAGS),
}

# narrow-format (metric_name/value_name/value) sources served by prefix:
# self-telemetry and telegraf/external metrics share one storage shape
_NARROW_TABLES = (
    ("deepflow_system_", "deepflow_system.deepflow_system"),
    ("ext_metrics_", "ext_metrics.metrics"),
)


class PromqlError(Exception):
    pass


class UnknownMetricError(PromqlError):
    """A selector naming a metric nothing has ingested — matches nothing
    (metadata endpoints treat this as empty, not as a bad request)."""


def parse_duration_s(s: str) -> float:
    if not _DUR_FULL.match(s):
        raise PromqlError(f"bad duration {s!r}")
    return sum(int(n) * _DUR_S[u] for n, u in _DUR_PART.findall(s))


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"',
            "'": "'", "a": "\a", "b": "\b", "f": "\f", "v": "\v", "0": "\0"}


def _unquote(raw: str) -> str:
    """Strip quotes and process Go-style escape sequences (\\n, \\\",
    \\xHH, \\uHHHH) — Grafana emits escaped regexes like "ns\\\\.svc"
    routinely."""
    body = raw[1:-1]
    if "\\" not in body:
        return body
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\" or i + 1 >= len(body):
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e == "x" and i + 3 < len(body):
            try:
                out.append(chr(int(body[i + 2:i + 4], 16)))
                i += 4
            except ValueError:
                raise PromqlError(f"bad escape in string: \\x"
                                  f"{body[i + 2:i + 4]!r}") from None
        elif e == "u" and i + 5 < len(body):
            try:
                out.append(chr(int(body[i + 2:i + 6], 16)))
                i += 6
            except ValueError:
                raise PromqlError(f"bad escape in string: \\u"
                                  f"{body[i + 2:i + 6]!r}") from None
        else:
            # unknown escape: keep verbatim (lenient where upstream errors)
            out.append(c)
            out.append(e)
            i += 2
    return "".join(out)


# -- AST ---------------------------------------------------------------------

@dataclass
class VectorSelector:
    metric: str
    matchers: list = field(default_factory=list)  # (label, op, value)
    offset_s: float = 0.0


@dataclass
class MatrixSelector:
    vs: VectorSelector
    range_s: float


@dataclass
class Subquery:
    expr: object
    range_s: float
    step_s: float  # 0 -> default resolution
    offset_s: float = 0.0


@dataclass
class Num:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Call:
    fn: str
    args: list


@dataclass
class Agg:
    op: str
    expr: object
    grouping: list = field(default_factory=list)
    without: bool = False
    param: object = None


@dataclass
class VectorMatching:
    on: bool = False
    labels: list = field(default_factory=list)
    card: str = "one-to-one"  # one-to-one | many-to-one | one-to-many
    include: list = field(default_factory=list)


@dataclass
class BinOp:
    op: str
    lhs: object
    rhs: object
    bool_mod: bool = False
    matching: VectorMatching | None = None


@dataclass
class Unary:
    op: str
    expr: object


_AGG_OPS = {"sum", "avg", "min", "max", "count", "group", "stddev", "stdvar",
            "topk", "bottomk", "quantile", "count_values"}
_PARAM_AGGS = {"topk", "bottomk", "quantile", "count_values"}

_RANGE_FNS = {
    "rate", "irate", "increase", "delta", "idelta", "deriv",
    "predict_linear", "changes", "resets", "absent_over_time",
    "avg_over_time", "min_over_time", "max_over_time", "sum_over_time",
    "count_over_time", "last_over_time", "present_over_time",
    "stddev_over_time", "stdvar_over_time", "quantile_over_time",
}
_MATH_FNS = {"abs": np.abs, "ceil": np.ceil, "floor": np.floor,
             "exp": np.exp, "ln": np.log, "log2": np.log2,
             "log10": np.log10, "sqrt": np.sqrt, "sgn": np.sign}
_INSTANT_FNS = _MATH_FNS.keys() | {
    "round", "clamp", "clamp_min", "clamp_max", "histogram_quantile",
    "scalar", "vector", "time", "timestamp", "absent", "label_replace",
    "label_join", "sort", "sort_desc"}
_FNS = _RANGE_FNS | _INSTANT_FNS

_CMP_OPS = {"==", "!=", ">", "<", ">=", "<="}
_SET_OPS = {"and", "or", "unless"}

# precedence (binding power), upstream promql/parser
_PRECEDENCE = {"or": 1, "and": 2, "unless": 2,
               "==": 3, "!=": 3, "<=": 3, "<": 3, ">=": 3, ">": 3,
               "+": 4, "-": 4, "*": 5, "/": 5, "%": 5, "^": 6}
_RIGHT_ASSOC = {"^"}


# -- lexer -------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)
  | (?P<lbrace>\{) | (?P<rbrace>\})
  | (?P<lparen>\() | (?P<rparen>\))
  | (?P<lbrack>\[) | (?P<rbrack>\])
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+|\.\d+|\d+)
  | (?P<op>==|!=|<=|>=|=~|!~|<|>|=|,|\*|/|%|\^|\+|-|:|@)
  | (?P<ws>\s+)
""", re.VERBOSE)


def _tokens(q: str):
    out, i = [], 0
    while i < len(q):
        m = _TOKEN.match(q, i)
        if not m:
            raise PromqlError(f"bad token at {i}: {q[i:i+10]!r}")
        i = m.end()
        if m.lastgroup != "ws":
            out.append((m.lastgroup, m.group()))
    return out


# -- parser ------------------------------------------------------------------

class _Parser:
    def __init__(self, q: str):
        self.toks = _tokens(q)
        self.pos = 0

    def peek(self, k: int = 0):
        i = self.pos + k
        return self.toks[i] if i < len(self.toks) else ("eof", "")

    def next_(self):
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, kind: str, text: str | None = None):
        t = self.next_()
        if t[0] != kind or (text is not None and t[1] != text):
            raise PromqlError(f"expected {text or kind}, got {t[1]!r}")
        return t

    def at_name(self, *names: str) -> bool:
        t = self.peek()
        return t[0] == "name" and t[1] in names

    def _split_colon_names(self) -> None:
        """Metric names may contain ':' (recording rules), so the lexer
        folds ':' into name tokens — but inside [range:step] the ':' is a
        separator. Re-split name tokens containing ':' up to the next ']'."""
        i = self.pos
        while i < len(self.toks) and self.toks[i][0] != "rbrack":
            kind, text = self.toks[i]
            if kind == "name" and ":" in text:
                repl = []
                for j, part in enumerate(text.split(":")):
                    if j:
                        repl.append(("op", ":"))
                    if part:
                        repl.extend(_tokens(part))
                self.toks[i:i + 1] = repl
                i += len(repl)
            else:
                i += 1

    # duration: "5m" lexes as num+name, "1h30m" as num+name("h30m");
    # join adjacent tokens while the concatenation is a valid duration
    def parse_duration(self) -> float:
        parts = [self.expect("num")[1]]
        while True:
            t = self.peek()
            cand = "".join(parts) + t[1]
            if t[0] in ("name", "num") and (
                    _DUR_FULL.match(cand)
                    or (t[0] == "num" and _DUR_FULL.match(cand + "s"))):
                parts.append(self.next_()[1])
                if t[0] == "num":
                    continue
                if _DUR_FULL.match("".join(parts)) and not (
                        self.peek()[0] == "num"):
                    break
            else:
                break
        return parse_duration_s("".join(parts))

    def parse_label_list(self) -> list[str]:
        self.expect("lparen")
        out = []
        while self.peek()[0] != "rparen":
            out.append(self.expect("name")[1])
            if self.peek() == ("op", ","):
                self.next_()
        self.expect("rparen")
        return out

    def parse_matchers(self) -> list:
        matchers = []
        self.expect("lbrace")
        while self.peek()[0] != "rbrace":
            lbl = self.expect("name")[1]
            op = self.expect("op")[1]
            if op == "==":  # tolerate common typo? no: strict
                raise PromqlError("bad matcher op ==")
            if op not in ("=", "!=", "=~", "!~"):
                raise PromqlError(f"bad matcher op {op}")
            val = _unquote(self.expect("str")[1])
            if op in ("=~", "!~"):
                _compile(val)  # bad regex fails at parse time (upstream)
            matchers.append((lbl, op, val))
            if self.peek() == ("op", ","):
                self.next_()
        self.expect("rbrace")
        return matchers

    def parse_expr(self, min_prec: int = 0):
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            op = None
            if t[0] == "op" and t[1] in _PRECEDENCE:
                op = t[1]
            elif t[0] == "name" and t[1] in _SET_OPS:
                op = t[1]
            if op is None:
                break
            prec = _PRECEDENCE[op]
            if prec < min_prec:
                break
            self.next_()
            bool_mod = False
            if self.at_name("bool"):
                self.next_()
                bool_mod = True
                if op not in _CMP_OPS:
                    raise PromqlError("bool modifier on non-comparison")
            matching = None
            if self.at_name("on", "ignoring"):
                on = self.next_()[1] == "on"
                matching = VectorMatching(on=on, labels=self.parse_label_list())
                if self.at_name("group_left", "group_right"):
                    gl = self.next_()[1] == "group_left"
                    matching.card = "many-to-one" if gl else "one-to-many"
                    if self.peek()[0] == "lparen":
                        matching.include = self.parse_label_list()
            next_min = prec + (0 if op in _RIGHT_ASSOC else 1)
            rhs = self.parse_expr(next_min)
            lhs = BinOp(op=op, lhs=lhs, rhs=rhs, bool_mod=bool_mod,
                        matching=matching)
        return lhs

    def parse_unary(self):
        t = self.peek()
        # ^ binds tighter than unary: -2^2 == -(2^2), per upstream
        if t == ("op", "-"):
            self.next_()
            return Unary("-", self.parse_expr(_PRECEDENCE["^"]))
        if t == ("op", "+"):
            self.next_()
            return self.parse_expr(_PRECEDENCE["^"])
        return self.parse_postfix(self.parse_atom())

    def parse_postfix(self, expr):
        while True:
            t = self.peek()
            if t[0] == "lbrack":
                self.next_()
                self._split_colon_names()
                range_s = self.parse_duration()
                if self.peek() == ("op", ":"):
                    self.next_()
                    step_s = 0.0
                    if self.peek()[0] != "rbrack":
                        step_s = self.parse_duration()
                    self.expect("rbrack")
                    expr = Subquery(expr=expr, range_s=range_s, step_s=step_s)
                else:
                    self.expect("rbrack")
                    if not isinstance(expr, VectorSelector):
                        raise PromqlError(
                            "[range] is only valid on a selector "
                            "(use [range:step] for subqueries)")
                    expr = MatrixSelector(vs=expr, range_s=range_s)
            elif self.at_name("offset"):
                self.next_()
                neg = False
                if self.peek() == ("op", "-"):
                    self.next_()
                    neg = True
                off = self.parse_duration() * (-1 if neg else 1)
                if isinstance(expr, VectorSelector):
                    expr.offset_s = off
                elif isinstance(expr, MatrixSelector):
                    expr.vs.offset_s = off
                elif isinstance(expr, Subquery):
                    expr.offset_s = off
                else:
                    raise PromqlError("offset on non-selector")
            else:
                break
        return expr

    def parse_atom(self):
        t = self.peek()
        if t[0] == "lparen":
            self.next_()
            inner = self.parse_expr()
            self.expect("rparen")
            return inner
        if t[0] == "num":
            self.next_()
            return Num(float(t[1]))
        if t[0] == "str":
            self.next_()
            return Str(_unquote(t[1]))
        if t[0] == "op" and t[1] in ("+", "-"):
            return self.parse_unary()
        if t[0] != "name":
            raise PromqlError(f"unexpected {t[1]!r}")
        name = t[1]
        if name in ("Inf", "inf", "+Inf"):
            self.next_()
            return Num(math.inf)
        if name in ("NaN", "nan"):
            self.next_()
            return Num(math.nan)
        if name in _AGG_OPS and self.peek(1)[0] in ("lparen", "name"):
            return self.parse_agg()
        if name in _FNS and self.peek(1)[0] == "lparen":
            self.next_()
            self.expect("lparen")
            args = []
            while self.peek()[0] != "rparen":
                args.append(self.parse_expr())
                if self.peek() == ("op", ","):
                    self.next_()
            self.expect("rparen")
            return Call(fn=name, args=args)
        # plain selector
        self.next_()
        sel = VectorSelector(metric=name)
        if self.peek()[0] == "lbrace":
            sel.matchers = self.parse_matchers()
        return sel

    def parse_agg(self):
        op = self.next_()[1]
        grouping, without = [], False
        if self.at_name("by", "without"):
            without = self.next_()[1] == "without"
            grouping = self.parse_label_list()
        self.expect("lparen")
        first = self.parse_expr()
        param = None
        if self.peek() == ("op", ","):
            self.next_()
            param = first
            first = self.parse_expr()
        self.expect("rparen")
        if param is None and op in _PARAM_AGGS:
            raise PromqlError(f"{op}() needs a parameter")
        if self.at_name("by", "without"):
            without = self.next_()[1] == "without"
            grouping = self.parse_label_list()
        return Agg(op=op, expr=first, grouping=grouping, without=without,
                   param=param)


# fn -> (min_args, max_args); None max = unbounded
_ARITY = {"histogram_quantile": (2, 2), "label_replace": (5, 5),
          "clamp": (3, 3), "clamp_min": (2, 2), "clamp_max": (2, 2),
          "quantile_over_time": (2, 2), "predict_linear": (2, 2),
          "vector": (1, 1), "scalar": (1, 1), "time": (0, 0),
          "round": (1, 2), "label_join": (3, None)}
_DEFAULT_ARITY = (1, 1)


def _validate(node) -> None:
    if isinstance(node, Call):
        lo, hi = _ARITY.get(node.fn, _DEFAULT_ARITY)
        if len(node.args) < lo or (hi is not None and len(node.args) > hi):
            raise PromqlError(
                f"{node.fn}() takes "
                f"{lo if lo == hi else f'{lo}+' if hi is None else f'{lo}-{hi}'}"
                f" argument(s), got {len(node.args)}")
        if node.fn in _RANGE_FNS:
            idx = 1 if node.fn == "quantile_over_time" else 0
            if idx >= len(node.args):
                raise PromqlError(f"{node.fn}() needs a range argument")
            arg = node.args[idx]
            if not isinstance(arg, (MatrixSelector, Subquery)):
                raise PromqlError(
                    f"{node.fn}() needs a [range] selector or subquery")
        for a in node.args:
            _validate(a)
    elif isinstance(node, Agg):
        _validate(node.expr)
        if node.param is not None:
            _validate(node.param)
    elif isinstance(node, BinOp):
        _validate(node.lhs)
        _validate(node.rhs)
    elif isinstance(node, Unary):
        _validate(node.expr)
    elif isinstance(node, Subquery):
        _validate(node.expr)


def parse(q: str):
    p = _Parser(q)
    ast = p.parse_expr()
    if p.peek()[0] != "eof":
        raise PromqlError(f"trailing input: {p.peek()[1]!r}")
    _validate(ast)
    return ast


# -- storage layer -----------------------------------------------------------

def _mangle(s: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in s)


def _resolve_metric(db: Database, name: str):
    """-> (table, value_column, tag_columns, pre_filters, labels_col).

    pre_filters: [(column, code), ...] row filters identifying the metric;
    labels_col: json-encoded label column (series identity) or None.
    """
    # narrow-format tables: <prefix><metric>_<value> with dots mangled,
    # e.g. deepflow_system_agent_sender_sent_frames, ext_metrics_cpu_usage
    for prefix, tname in _NARROW_TABLES:
        if not name.startswith(prefix):
            continue
        try:
            table = db.table(tname)
        except KeyError:  # a table the port does not have yet
            continue
        suffix = name[len(prefix):]
        mdict, vdict = table.dicts["metric_name"], table.dicts["value_name"]
        # longest metric-name match first: mangling can make one name a
        # prefix of another, and first-match would be ingest-order dependent
        candidates = sorted(enumerate(mdict.snapshot()),
                            key=lambda kv: -len(kv[1]))
        for mi, mn in candidates:
            if not mn or not suffix.startswith(_mangle(mn) + "_"):
                continue
            rest = suffix[len(_mangle(mn)) + 1:]
            for vi, vn in enumerate(vdict.snapshot()):
                if vn and _mangle(vn) == rest:
                    # host/agent_id stay real columns: series split per
                    # agent and matchable alongside the json tags
                    return (table, "value", ["tag_json", "host", "agent_id"],
                            [("metric_name", mi), ("value_name", vi)],
                            "tag_json")
        # fall through: a remote-write metric may share the prefix
    for prefix, (tname, tags) in _FAMILIES.items():
        if name.startswith(prefix):
            col = name[len(prefix):]
            table = db.table(tname)
            if col in table.columns:
                return table, col, tags, None, None
            break  # fall through: maybe a remote-write metric with a
            # name that happens to share the family prefix
    # remote-write samples: any metric name, labels in labels_json
    try:
        table = db.table("prometheus.samples")
    except KeyError:  # not in the port yet: no remote-write metric
        raise UnknownMetricError(f"unknown metric {name!r}") from None
    code = table.dicts["metric_name"].lookup(name)
    if code is None:
        raise UnknownMetricError(f"unknown metric {name!r}")
    return (table, "value", ["labels_json"], [("metric_name", code)],
            "labels_json")


def _compile(pattern: str):
    try:
        return re.compile(pattern)  # PromQL regexes are anchored (fullmatch)
    except re.error as e:
        raise PromqlError(f"bad regex {pattern!r}: {e}") from None


def _compile_matchers(table, matchers, labels_col):
    """Precompute chunk-independent matcher state -> per-chunk appliers.
    Dictionary scans and regex compilation happen ONCE, not per chunk."""
    appliers = []
    for lbl, op, val in matchers:
        negate = op in ("!=", "!~")
        # json-labeled metrics: remote-write user labels ALWAYS match via
        # the json column (they'd be shadowed by same-named universal tag
        # columns); self-telemetry prefers real columns (host/agent_id) and
        # falls back to the json tags. Exception: org_id is the tenancy
        # boundary — it must always hit the ingest-injected real column,
        # never a user-supplied label
        if labels_col is not None and lbl != "org_id" and (
                labels_col == "labels_json" or lbl not in table.columns):
            ids = _labels_json_ids(table, lbl, op, val, labels_col)
            appliers.append(("isin", labels_col, ids, negate))
            continue
        if lbl not in table.columns:
            raise PromqlError(f"unknown label {lbl!r}")
        spec = table.columns[lbl]
        if spec.kind == "str":
            if op in ("=", "!="):
                code = table.dicts[lbl].lookup(val)
                appliers.append((
                    "eq", lbl,
                    code if code is not None else 0xFFFFFFFF, negate))
            else:
                rx = _compile(val)
                ids = table.dicts[lbl].match_ids(
                    lambda s: rx.fullmatch(s) is not None)
                appliers.append(("isin", lbl, ids, negate))
        elif spec.kind == "enum":
            if op in ("=~", "!~"):
                rx = _compile(val)
                ids = np.asarray(
                    [i for i, s in enumerate(spec.enum_values)
                     if rx.fullmatch(s)], dtype=np.uint16)
                appliers.append(("isin", lbl, ids, negate))
            else:
                try:
                    idx = spec.enum_values.index(val)
                except ValueError:
                    idx = 0xFFFF
                appliers.append(("eq", lbl, idx, negate))
        else:
            code = int(val) if val.isdigit() else None
            appliers.append(("eq", lbl, code, negate))
    return appliers


def _apply_matchers(appliers, ch) -> np.ndarray | None:
    mask = None
    for kind, lbl, data, negate in appliers:
        arr = ch[lbl]
        if kind == "eq":
            m = (np.zeros(len(arr), bool) if data is None
                 else arr == arr.dtype.type(data))
        else:
            m = np.isin(arr, data)
        if negate:
            m = ~m
        mask = m if mask is None else (mask & m)
    return mask


def _labels_json_ids(table, lbl: str, op: str, val: str,
                     labels_col: str = "labels_json") -> np.ndarray:
    """Matching dictionary ids for a matcher over a json label set.
    (Negation is applied by the caller.)"""

    def get(s: str) -> str:
        try:
            return str(_json.loads(s or "{}").get(lbl, ""))
        except ValueError:
            return ""

    if op in ("=", "!="):
        pred = lambda s: get(s) == val  # noqa: E731
    else:
        rx = _compile(val)
        pred = lambda s: rx.fullmatch(get(s)) is not None  # noqa: E731
    return table.dicts[labels_col].match_ids(pred)


@dataclass
class RawSeries:
    """One series' raw samples: sorted times (s) and float values."""
    labels: dict
    t: np.ndarray
    v: np.ndarray
    counter: bool  # cumulative counter vs per-interval delta samples


def fetch_raw(db: Database, vs: VectorSelector, lo_s: float,
              hi_s: float) -> list[RawSeries]:
    """All samples in [lo_s, hi_s] for the selector, split into series by
    the full tag set (series identity is always the full tag set; any
    grouping happens later across evaluated series)."""
    # cluster federation hook: a federated db-shim intercepts selector
    # materialization here (BEFORE local metric resolution — a remote
    # shard may know a metric this node has never seen) and hands back
    # local + remote series merged by label set. The whole PromQL AST
    # then evaluates at the coordinator, so federated results are EXACT
    # for every function (Thanos-style raw-selector fan-out).
    hook = getattr(db, "promql_fetch_raw", None)
    if hook is not None:
        return hook(vs, lo_s, hi_s)
    table, col, tags, pre_filters, labels_col = _resolve_metric(db, vs.metric)
    appliers = _compile_matchers(table, vs.matchers, labels_col)
    # remote-write clients send CUMULATIVE counters (standard Prometheus),
    # dfstats self-telemetry snapshots cumulative process counters, and the
    # Telegraf fields people rate() (net/disk totals) are cumulative too;
    # internal flow_metrics tables hold per-interval DELTA samples.
    counter_mode = table.name in ("prometheus.samples",
                                  "deepflow_system.deepflow_system",
                                  "ext_metrics.metrics")
    chunks = table.snapshot()
    times, values, tag_arrays = [], [], {t: [] for t in tags}
    for ch in chunks:
        if not ch or not len(ch["time"]):
            continue
        t = ch["time"].astype(np.int64)
        # schema convention (same as engine._col_val): u64 time columns are
        # nanoseconds, u32 are epoch seconds
        if table.columns["time"].kind == "u64":
            t = t // 1_000_000_000
        mask = (t >= lo_s) & (t <= hi_s)
        for pf_col, pf_code in (pre_filters or []):
            mask &= ch[pf_col] == pf_code
        m = _apply_matchers(appliers, ch)
        if m is not None:
            mask &= m
        idx = np.flatnonzero(mask)
        if not len(idx):
            continue
        times.append(t[idx])
        values.append(ch[col][idx].astype(np.float64))
        for lbl in tags:
            tag_arrays[lbl].append(ch[lbl][idx])
    if not times:
        return []
    t_all = np.concatenate(times)
    v_all = np.concatenate(values)
    tag_all = {lbl: np.concatenate(tag_arrays[lbl]) for lbl in tags}

    group_labels = [g for g in tags if g in tag_all]
    key = np.zeros(len(t_all), dtype=np.int64)
    for lbl in group_labels:
        _, inv = np.unique(tag_all[lbl], return_inverse=True)
        # re-densify after every fold: key stays < n_rows, so the product
        # is bounded by n_rows^2 and can't overflow int64 even with many
        # high-cardinality labels
        _, key = np.unique(key * (int(inv.max(initial=0)) + 1) + inv,
                           return_inverse=True)

    out = []
    for gk in np.unique(key):
        gmask = key == gk
        gt, gv = t_all[gmask], v_all[gmask]
        order = np.argsort(gt, kind="stable")
        gt, gv = gt[order], gv[order]
        labels = {"__name__": vs.metric}
        gi = np.flatnonzero(gmask)[0]
        for lbl in group_labels:
            spec = table.columns[lbl]
            raw = tag_all[lbl][gi]
            if lbl == labels_col and spec.kind == "str":
                try:
                    labels.update(_json.loads(
                        table.dicts[lbl].decode(int(raw)) or "{}"))
                except ValueError:
                    pass
            elif spec.kind == "str":
                labels[lbl] = table.dicts[lbl].decode(int(raw))
            elif spec.kind == "enum":
                labels[lbl] = spec.enum_values[int(raw)]
            else:
                labels[lbl] = str(int(raw))
        out.append(RawSeries(labels=labels, t=gt, v=gv,
                             counter=counter_mode))
    return out


# -- evaluation --------------------------------------------------------------

@dataclass
class Series:
    """An evaluated series: one value per step (NaN = no sample)."""
    labels: dict
    vals: np.ndarray


def _sig(labels: dict, matching: VectorMatching | None) -> tuple:
    if matching is None:
        keep = sorted(k for k in labels if k != "__name__")
    elif matching.on:
        keep = sorted(matching.labels)
    else:
        drop = set(matching.labels) | {"__name__"}
        keep = sorted(k for k in labels if k not in drop)
    return tuple((k, labels.get(k, "")) for k in keep)


def _drop_name(labels: dict) -> dict:
    return {k: v for k, v in labels.items() if k != "__name__"}


def _group_key(labels: dict, grouping: list[str], without: bool) -> tuple:
    """Aggregation group signature for by(...)/without(...)."""
    if without:
        drop = set(grouping) | {"__name__"}
        return tuple(sorted((k, v) for k, v in labels.items()
                            if k not in drop))
    return tuple((k, labels.get(k, "")) for k in grouping)


def _counter_rate(wt: np.ndarray, wv: np.ndarray, fn: str, range_s: float,
                  range_lo: float, range_hi: float) -> float | None:
    """Prometheus counter semantics over one series window: monotonic
    cumulative values with reset detection (a drop means the counter
    restarted at ~0, so the post-reset value IS the increase), and the
    upstream extrapolatedRate window-boundary extrapolation."""
    if len(wt) < 2:
        return None
    if fn == "irate":
        # dedup to distinct timestamps (remote-write retries re-send batches;
        # last value wins for a cumulative counter), then take the last pair
        uts = np.unique(wt)
        if len(uts) < 2:
            return None
        # last row at each of the two last distinct timestamps
        i_last = int(np.searchsorted(wt, uts[-1], side="right")) - 1
        i_prev = int(np.searchsorted(wt, uts[-2], side="right")) - 1
        dv = float(wv[i_last] - wv[i_prev])
        if dv < 0:  # reset between the two points
            dv = float(wv[i_last])
        dt = float(uts[-1] - uts[-2])
        return dv / dt
    diffs = np.diff(wv)
    # increase = sum of positive deltas; at a reset the post-reset value is
    # the delta (counter restarted from ~0)
    increase = float(np.where(diffs >= 0, diffs, wv[1:]).sum())
    # extrapolate to the window bounds (promql/functions.go extrapolatedRate):
    # extend by up to half the average sample spacing, or to the boundary if
    # it's closer than 1.1x spacing; never extrapolate past the counter's
    # implied zero crossing
    sampled = float(wt[-1] - wt[0])
    if sampled <= 0:
        return None
    avg_spacing = sampled / (len(wt) - 1)
    threshold = avg_spacing * 1.1
    to_start = float(wt[0]) - range_lo
    to_end = range_hi - float(wt[-1])
    if to_start >= threshold:
        to_start = avg_spacing / 2
    if increase > 0 and wv[0] >= 0:
        to_zero = sampled * (float(wv[0]) / increase)
        to_start = min(to_start, to_zero)
    if to_end >= threshold:
        to_end = avg_spacing / 2
    increase *= (sampled + to_start + to_end) / sampled
    if fn == "increase":
        return increase
    return increase / max(range_s, 1e-9)


def _delta_rate(wt: np.ndarray, wv: np.ndarray, fn: str,
                range_s: float) -> float | None:
    """Delta-sample semantics for the internal flow_metrics tables: each row
    already holds the increase over its interval."""
    if not len(wt):
        return None
    if fn == "irate":
        # instantaneous: the last two DISTINCT timestamps in the window,
        # with co-timestamped rows summed (a series can hold several rows
        # per second)
        uts, inv = np.unique(wt, return_inverse=True)
        if len(uts) < 2:
            return None
        sums = np.bincount(inv, weights=wv)
        dt = float(uts[-1] - uts[-2])
        return float(sums[-1]) / dt
    total = float(wv.sum())
    if fn == "rate":
        return total / max(range_s, 1e-9)
    return total  # increase


def _range_fn_value(fn: str, wt: np.ndarray, wv: np.ndarray, counter: bool,
                    range_s: float, lo: float, hi: float,
                    phi: float = 0.0, horizon: float = 0.0) -> float | None:
    """Apply a range function to one series' window (lo, hi]."""
    n = len(wt)
    if fn in ("rate", "irate", "increase"):
        if counter:
            return _counter_rate(wt, wv, fn, range_s, lo, hi)
        return _delta_rate(wt, wv, fn, range_s)
    if fn in ("absent_over_time", "present_over_time"):
        raise AssertionError("handled by caller")
    if n == 0:
        return None
    if fn == "avg_over_time":
        return float(wv.mean())
    if fn == "min_over_time":
        return float(wv.min())
    if fn == "max_over_time":
        return float(wv.max())
    if fn == "sum_over_time":
        return float(wv.sum())
    if fn == "count_over_time":
        return float(n)
    if fn == "last_over_time":
        return float(wv[-1])
    if fn == "stddev_over_time":
        return float(wv.std())
    if fn == "stdvar_over_time":
        return float(wv.var())
    if fn == "quantile_over_time":
        return float(np.quantile(wv, min(max(phi, 0.0), 1.0)))
    if fn == "changes":
        return float(np.count_nonzero(np.diff(wv))) if n > 1 else 0.0
    if fn == "resets":
        return float(np.count_nonzero(np.diff(wv) < 0)) if n > 1 else 0.0
    if fn == "idelta":
        uts = np.unique(wt)
        if len(uts) < 2:
            return None
        i_last = int(np.searchsorted(wt, uts[-1], side="right")) - 1
        i_prev = int(np.searchsorted(wt, uts[-2], side="right")) - 1
        return float(wv[i_last] - wv[i_prev])
    if fn in ("delta", "deriv", "predict_linear"):
        if n < 2:
            return None
        sampled = float(wt[-1] - wt[0])
        if sampled <= 0:
            return None
        if fn == "delta":
            # gauge delta with the same boundary extrapolation as rate
            d = float(wv[-1] - wv[0])
            avg_spacing = sampled / (n - 1)
            threshold = avg_spacing * 1.1
            to_start = float(wt[0]) - lo
            to_end = hi - float(wt[-1])
            if to_start >= threshold:
                to_start = avg_spacing / 2
            if to_end >= threshold:
                to_end = avg_spacing / 2
            return d * (sampled + to_start + to_end) / sampled
        # least-squares slope (upstream uses simple linear regression
        # anchored at the window's first timestamp for stability)
        x = (wt - wt[0]).astype(np.float64)
        xm, ym = x.mean(), wv.mean()
        denom = float(((x - xm) ** 2).sum())
        if denom == 0:
            return None
        slope = float(((x - xm) * (wv - ym)).sum()) / denom
        if fn == "deriv":
            return slope
        # predict_linear: value at hi + horizon
        intercept = ym - slope * xm
        return intercept + slope * (hi - float(wt[0]) + horizon)
    raise PromqlError(f"unsupported range function {fn}()")


class _Evaluator:
    def __init__(self, db: Database, steps: np.ndarray,
                 default_res_s: float = 15.0):
        self.db = db
        self.steps = steps.astype(np.float64)
        self.default_res_s = default_res_s

    # -- selector eval -----------------------------------------------------

    def instant_vector(self, vs: VectorSelector) -> list[Series]:
        off = vs.offset_s
        lo = float(self.steps[0]) - off - _LOOKBACK_S
        hi = float(self.steps[-1]) - off
        out = []
        for rs in fetch_raw(self.db, vs, lo, hi):
            q = self.steps - off
            idx = np.searchsorted(rs.t, q, side="right") - 1
            valid = idx >= 0
            safe = np.where(valid, idx, 0)
            age = q - rs.t[safe]
            valid &= age <= _LOOKBACK_S
            vals = np.where(valid, rs.v[safe], np.nan)
            if np.isnan(vals).all():
                continue
            out.append(Series(labels=rs.labels, vals=vals))
        return out

    def range_series(self, node) -> tuple[list[RawSeries], float, float]:
        """-> (raw series, range_s, offset_s) for a matrix selector or
        subquery argument of a range function."""
        if isinstance(node, MatrixSelector):
            off = node.vs.offset_s
            lo = float(self.steps[0]) - off - node.range_s
            hi = float(self.steps[-1]) - off
            return fetch_raw(self.db, node.vs, lo, hi), node.range_s, off
        if isinstance(node, Subquery):
            return (self.eval_subquery(node), node.range_s, node.offset_s)
        raise PromqlError("expected a range expression (selector[d] or "
                          "subquery[d:s])")

    def eval_subquery(self, sq: Subquery) -> list[RawSeries]:
        res = sq.step_s or self.default_res_s
        off = sq.offset_s
        lo = float(self.steps[0]) - off - sq.range_s
        hi = float(self.steps[-1]) - off
        # subquery steps align to absolute multiples of the resolution
        first = math.ceil(lo / res) * res
        sub_steps = np.arange(first, hi + res / 2, res)
        if not len(sub_steps):
            return []
        sub = _Evaluator(self.db, sub_steps, self.default_res_s)
        vec = sub.eval_vector(sq.expr, "subquery")
        out = []
        for s in vec:
            keep = ~np.isnan(s.vals)
            if not keep.any():
                continue
            # subquery output samples are treated as cumulative by the
            # counter-aware range functions, matching upstream rate() over
            # subqueries
            out.append(RawSeries(labels=s.labels, t=sub_steps[keep],
                                 v=s.vals[keep], counter=True))
        return out

    # -- generic eval ------------------------------------------------------

    def eval(self, node):
        """-> Series list (vector) or np.ndarray (scalar-per-step)."""
        if isinstance(node, Num):
            return np.full(len(self.steps), node.value)
        if isinstance(node, Str):
            return node
        if isinstance(node, VectorSelector):
            return self.instant_vector(node)
        if isinstance(node, (MatrixSelector, Subquery)):
            raise PromqlError("range expression must be wrapped in a "
                              "range function like rate()")
        if isinstance(node, Unary):
            val = self.eval(node.expr)
            if isinstance(val, Str):
                raise PromqlError("cannot negate a string")
            if isinstance(val, np.ndarray):
                return -val
            return [Series(labels=_drop_name(s.labels), vals=-s.vals)
                    for s in val]
        if isinstance(node, Call):
            return self.eval_call(node)
        if isinstance(node, Agg):
            return self.eval_agg(node)
        if isinstance(node, BinOp):
            return self.eval_binop(node)
        raise PromqlError(f"cannot evaluate {type(node).__name__}")

    def eval_vector(self, node, ctx: str) -> list[Series]:
        v = self.eval(node)
        if isinstance(v, np.ndarray):
            raise PromqlError(f"{ctx} expects an instant vector, got scalar")
        if isinstance(v, Str):
            raise PromqlError(f"{ctx} expects an instant vector, got string")
        return v

    def eval_scalar(self, node, ctx: str) -> np.ndarray:
        v = self.eval(node)
        if not isinstance(v, np.ndarray):
            raise PromqlError(f"{ctx} expects a scalar")
        return v

    # -- functions ---------------------------------------------------------

    def eval_call(self, node: Call):
        fn = node.fn
        if fn in _RANGE_FNS:
            return self.eval_range_fn(node)
        if fn == "time":
            return self.steps.copy()
        if fn == "scalar":
            vec = self.eval_vector(node.args[0], "scalar()")
            out = np.full(len(self.steps), np.nan)
            if len(vec) == 1:
                out = vec[0].vals.copy()
            return out
        if fn == "vector":
            s = self.eval_scalar(node.args[0], "vector()")
            return [Series(labels={}, vals=s)]
        if fn == "absent":
            vec = self.eval(node.args[0]) if not isinstance(
                node.args[0], VectorSelector) else None
            labels = {}
            if isinstance(node.args[0], VectorSelector):
                try:
                    vec = self.instant_vector(node.args[0])
                except UnknownMetricError:
                    vec = []  # unknown metric is definitionally absent
                labels = {lbl: val for lbl, op, val
                          in node.args[0].matchers if op == "="}
            if isinstance(vec, (np.ndarray, Str)):
                raise PromqlError("absent() expects an instant vector")
            present = np.zeros(len(self.steps), dtype=bool)
            for s in (vec or []):
                present |= ~np.isnan(s.vals)
            vals = np.where(present, np.nan, 1.0)
            if np.isnan(vals).all():
                return []
            return [Series(labels=labels, vals=vals)]
        if fn in _MATH_FNS:
            vec = self.eval(node.args[0])
            op = _MATH_FNS[fn]
            with np.errstate(all="ignore"):
                if isinstance(vec, np.ndarray):
                    return op(vec)
                return [Series(labels=_drop_name(s.labels),
                               vals=op(s.vals)) for s in vec]
        if fn == "round":
            vec = self.eval_vector(node.args[0], "round()")
            to = np.ones(len(self.steps))
            if len(node.args) > 1:
                to = self.eval_scalar(node.args[1], "round()")
            if np.any(to <= 0):
                raise PromqlError("round() nearest must be positive")
            # Prometheus rounds half toward +Inf, not half-to-even;
            # `to` applies per step (it can be a varying scalar expr)
            return [Series(labels=_drop_name(s.labels),
                           vals=np.floor(s.vals / to + 0.5) * to)
                    for s in vec]
        if fn in ("clamp", "clamp_min", "clamp_max"):
            vec = self.eval_vector(node.args[0], fn)
            if fn == "clamp":
                lo = self.eval_scalar(node.args[1], fn)
                hi = self.eval_scalar(node.args[2], fn)
                return [Series(labels=_drop_name(s.labels),
                               vals=np.clip(s.vals, lo, hi)) for s in vec]
            bound = self.eval_scalar(node.args[1], fn)
            f = np.maximum if fn == "clamp_min" else np.minimum
            return [Series(labels=_drop_name(s.labels),
                           vals=f(s.vals, bound)) for s in vec]
        if fn == "timestamp":
            vec = self.eval_vector(node.args[0], fn)
            return [Series(labels=_drop_name(s.labels),
                           vals=np.where(np.isnan(s.vals), np.nan,
                                         self.steps)) for s in vec]
        if fn == "histogram_quantile":
            phi_arr = self.eval_scalar(node.args[0], fn)
            vec = self.eval_vector(node.args[1], fn)
            return self._histogram_quantile(phi_arr, vec)
        if fn == "label_replace":
            vec = self.eval_vector(node.args[0], fn)
            dst, repl, src, regex = (self._str_arg(a) for a in node.args[1:5])
            rx = _compile(regex)
            out = []
            for s in vec:
                labels = dict(s.labels)
                m = rx.fullmatch(labels.get(src, ""))
                if m:
                    val = m.expand(re.sub(r"\$(\d+)", r"\\\1", repl))
                    if val:
                        labels[dst] = val
                    else:
                        labels.pop(dst, None)
                out.append(Series(labels=labels, vals=s.vals))
            return out
        if fn == "label_join":
            vec = self.eval_vector(node.args[0], fn)
            dst = self._str_arg(node.args[1])
            sep = self._str_arg(node.args[2])
            srcs = [self._str_arg(a) for a in node.args[3:]]
            out = []
            for s in vec:
                labels = dict(s.labels)
                labels[dst] = sep.join(labels.get(k, "") for k in srcs)
                out.append(Series(labels=labels, vals=s.vals))
            return out
        if fn in ("sort", "sort_desc"):
            vec = self.eval_vector(node.args[0], fn)
            def last_val(s):
                ok = s.vals[~np.isnan(s.vals)]
                return float(ok[-1]) if len(ok) else -math.inf
            return sorted(vec, key=last_val, reverse=(fn == "sort_desc"))
        raise PromqlError(f"unsupported function {fn}()")

    def _str_arg(self, node) -> str:
        if not isinstance(node, Str):
            raise PromqlError("expected a string literal argument")
        return node.value

    def eval_range_fn(self, node: Call) -> list[Series]:
        fn = node.fn
        phi_arr = None
        horizon_arr = None
        if fn == "quantile_over_time":
            phi_arr = self.eval_scalar(node.args[0], fn)
            range_arg = node.args[1]
        elif fn == "predict_linear":
            horizon_arr = self.eval_scalar(node.args[1], fn)
            range_arg = node.args[0]
        else:
            if len(node.args) != 1:
                raise PromqlError(f"{fn}() takes one range argument")
            range_arg = node.args[0]
        raw, range_s, off = self.range_series(range_arg)
        if fn in ("rate", "irate", "increase") and isinstance(
                range_arg, MatrixSelector) and range_s <= 0:
            raise PromqlError(f"{fn}() needs a [range]")
        steps = self.steps
        if fn == "absent_over_time":
            present = np.zeros(len(steps), dtype=bool)
            for rs in raw:
                for i, ts in enumerate(steps):
                    hi = float(ts) - off
                    lo = hi - range_s
                    i0 = int(np.searchsorted(rs.t, lo, side="right"))
                    i1 = int(np.searchsorted(rs.t, hi, side="right"))
                    if i1 > i0:
                        present[i] = True
            vals = np.where(present, np.nan, 1.0)
            if np.isnan(vals).all():
                return []
            labels = {}
            if isinstance(range_arg, MatrixSelector):
                labels = {lbl: val for lbl, op, val
                          in range_arg.vs.matchers if op == "="}
            return [Series(labels=labels, vals=vals)]
        out = []
        # every step's window (lo, hi] at once; a function of an empty
        # window has no value, so only the steps with samples are visited
        his = np.asarray(steps, dtype=np.float64) - off
        los = his - range_s
        for rs in raw:
            vals = np.full(len(steps), np.nan)
            i0s = np.searchsorted(rs.t, los, side="right")
            i1s = np.searchsorted(rs.t, his, side="right")
            for i in np.flatnonzero(i1s > i0s).tolist():
                hi, lo = float(his[i]), float(los[i])
                i0, i1 = int(i0s[i]), int(i1s[i])
                if fn == "present_over_time":
                    vals[i] = 1.0
                    continue
                phi = (float(phi_arr[i]) if phi_arr is not None else 0.0)
                # the horizon scalar applies per step (it can vary)
                horizon = (float(horizon_arr[i])
                           if horizon_arr is not None else 0.0)
                v = _range_fn_value(fn, rs.t[i0:i1], rs.v[i0:i1], rs.counter,
                                    range_s, lo, hi, phi=phi,
                                    horizon=horizon)
                if v is not None:
                    vals[i] = v
            if np.isnan(vals).all():
                continue
            out.append(Series(labels=_drop_name(rs.labels), vals=vals))
        return out

    def _histogram_quantile(self, phi_arr: np.ndarray,
                            vec: list[Series]) -> list[Series]:
        groups: dict[tuple, list[tuple[float, Series]]] = {}
        for s in vec:
            le = s.labels.get("le")
            if le is None:
                continue
            try:
                bound = float(le)
            except ValueError:
                continue
            key = tuple(sorted((k, v) for k, v in s.labels.items()
                               if k not in ("le", "__name__")))
            groups.setdefault(key, []).append((bound, s))
        out = []
        for key, buckets in groups.items():
            buckets.sort(key=lambda bs: bs[0])
            bounds = np.array([b for b, _ in buckets])
            mat = np.vstack([s.vals for _, s in buckets])
            vals = np.full(len(self.steps), np.nan)
            for i in range(len(self.steps)):
                col = mat[:, i]
                ok = ~np.isnan(col)
                if not ok.any():
                    continue
                b = bounds[ok]
                c = np.maximum.accumulate(col[ok])  # enforce monotonicity
                if len(b) < 2 or not math.isinf(b[-1]):
                    continue  # need an +Inf bucket to anchor the total
                total = c[-1]
                if total <= 0:
                    continue
                phi = float(phi_arr[i])
                if phi < 0:
                    vals[i] = -math.inf
                    continue
                if phi > 1:
                    vals[i] = math.inf
                    continue
                rank = phi * total
                j = int(np.searchsorted(c, rank, side="left"))
                j = min(j, len(b) - 1)
                if j == len(b) - 1:  # falls in the +Inf bucket
                    vals[i] = float(b[-2])
                    continue
                lo_bound = float(b[j - 1]) if j > 0 else 0.0
                if j == 0 and b[0] <= 0:
                    lo_bound = float(b[0])
                lo_count = float(c[j - 1]) if j > 0 else 0.0
                span = float(c[j]) - lo_count
                if span <= 0:
                    vals[i] = float(b[j])
                    continue
                vals[i] = lo_bound + (float(b[j]) - lo_bound) * (
                    (rank - lo_count) / span)
            if np.isnan(vals).all():
                continue
            out.append(Series(labels=dict(key), vals=vals))
        return out

    # -- aggregation -------------------------------------------------------

    def eval_agg(self, node: Agg) -> list[Series]:
        vec = self.eval_vector(node.expr, node.op)
        if node.op == "count_values":
            return self._count_values(node, vec)
        param = None
        if node.param is not None:
            param = self.eval_scalar(node.param, node.op)

        groups: dict[tuple, list[Series]] = {}
        for s in vec:
            groups.setdefault(
                _group_key(s.labels, node.grouping, node.without),
                []).append(s)
        out = []
        for key, members in groups.items():
            mat = np.vstack([s.vals for s in members])
            valid = ~np.isnan(mat)
            any_valid = valid.any(axis=0)
            with np.errstate(all="ignore"):
                if node.op == "sum":
                    vals = np.nansum(mat, axis=0)
                elif node.op == "avg":
                    vals = np.nanmean(mat, axis=0)
                elif node.op == "min":
                    vals = np.nanmin(
                        np.where(valid, mat, np.inf), axis=0)
                elif node.op == "max":
                    vals = np.nanmax(
                        np.where(valid, mat, -np.inf), axis=0)
                elif node.op == "count":
                    vals = valid.sum(axis=0).astype(np.float64)
                elif node.op == "group":
                    vals = np.ones(mat.shape[1])
                elif node.op == "stddev":
                    vals = np.nanstd(mat, axis=0)
                elif node.op == "stdvar":
                    vals = np.nanvar(mat, axis=0)
                elif node.op == "quantile":
                    phi = np.clip(param, 0.0, 1.0)
                    vals = np.full(mat.shape[1], np.nan)
                    for i in range(mat.shape[1]):
                        col = mat[:, i][valid[:, i]]
                        if len(col):
                            vals[i] = float(np.quantile(col, float(phi[i])))
                elif node.op in ("topk", "bottomk"):
                    # per-step selection: members keep their own labels
                    k_arr = param
                    keep = np.zeros_like(mat, dtype=bool)
                    sign = -1.0 if node.op == "topk" else 1.0
                    for i in range(mat.shape[1]):
                        k = int(k_arr[i]) if not math.isnan(k_arr[i]) else 0
                        if k <= 0:
                            continue
                        col = np.where(valid[:, i], sign * mat[:, i], np.inf)
                        order = np.argsort(col, kind="stable")
                        chosen = [j for j in order[:k] if valid[j, i]]
                        keep[chosen, i] = True
                    for j, s in enumerate(members):
                        vals_j = np.where(keep[j], mat[j], np.nan)
                        if not np.isnan(vals_j).all():
                            # topk/bottomk keep the member's own labels
                            out.append(Series(labels=dict(s.labels),
                                              vals=vals_j))
                    continue
                else:
                    raise PromqlError(f"unsupported aggregate {node.op}")
            vals = np.where(any_valid, vals, np.nan)
            if np.isnan(vals).all():
                continue
            out.append(Series(labels=dict(key), vals=vals))
        return out

    def _count_values(self, node: Agg, vec: list[Series]) -> list[Series]:
        if not isinstance(node.param, Str):
            raise PromqlError("count_values() needs a string label")
        dst = node.param.value
        counts: dict[tuple, np.ndarray] = {}
        for s in vec:
            base = _group_key(s.labels, node.grouping, node.without)
            for i, v in enumerate(s.vals):
                if math.isnan(v):
                    continue
                sval = (_fmt_num(v) if not math.isfinite(v)
                        else repr(v) if v != int(v) else str(int(v)))
                key = base + ((dst, sval),)
                if key not in counts:
                    counts[key] = np.full(len(self.steps), np.nan)
                cur = counts[key][i]
                counts[key][i] = 1.0 if math.isnan(cur) else cur + 1.0
        return [Series(labels=dict(key), vals=vals)
                for key, vals in counts.items()]

    # -- binary operators --------------------------------------------------

    def eval_binop(self, node: BinOp):
        lhs = self.eval(node.lhs)
        rhs = self.eval(node.rhs)
        l_scalar = isinstance(lhs, np.ndarray)
        r_scalar = isinstance(rhs, np.ndarray)
        op = node.op
        if op in _SET_OPS:
            if l_scalar or r_scalar:
                raise PromqlError(f"{op} requires vectors on both sides")
            return self._set_op(op, lhs, rhs, node.matching)
        if l_scalar and r_scalar:
            if op in _CMP_OPS and not node.bool_mod:
                raise PromqlError(
                    "comparison between scalars needs the bool modifier")
            with np.errstate(all="ignore"):
                return self._apply_op(op, lhs, rhs, bool_mod=True)
        if l_scalar or r_scalar:
            vec, sc, flip = ((rhs, lhs, True) if l_scalar
                             else (lhs, rhs, False))
            out = []
            for s in vec:
                a, b = (sc, s.vals) if flip else (s.vals, sc)
                with np.errstate(all="ignore"):
                    vals = self._apply_op(op, a, b, bool_mod=node.bool_mod)
                if op in _CMP_OPS and not node.bool_mod:
                    # filter: keep the vector's own value where true
                    vals = np.where(np.isnan(vals), np.nan, s.vals)
                if np.isnan(vals).all():
                    continue
                labels = (_drop_name(s.labels)
                          if (op not in _CMP_OPS or node.bool_mod)
                          else dict(s.labels))
                out.append(Series(labels=labels, vals=vals))
            return out
        return self._vector_binop(node, lhs, rhs)

    def _apply_op(self, op: str, a, b, bool_mod: bool) -> np.ndarray:
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return np.where(b == 0, np.where(
                np.isnan(np.asarray(a, dtype=float)), np.nan,
                np.sign(a) * np.inf), a / np.where(b == 0, 1, b))
        if op == "%":
            return np.where(b == 0, np.nan, np.fmod(a, np.where(b == 0, 1, b)))
        if op == "^":
            return np.power(a, b)
        cmp = {"==": np.equal, "!=": np.not_equal, ">": np.greater,
               "<": np.less, ">=": np.greater_equal,
               "<=": np.less_equal}[op](a, b)
        # NaN on either side -> no result
        nan = np.isnan(np.asarray(a, dtype=float)) | np.isnan(
            np.asarray(b, dtype=float))
        if bool_mod:
            return np.where(nan, np.nan, cmp.astype(np.float64))
        return np.where(nan | ~cmp, np.nan, 1.0)

    def _set_op(self, op: str, lhs: list[Series], rhs: list[Series],
                matching: VectorMatching | None) -> list[Series]:
        # per-step presence matters: `and` keeps lhs points whose signature
        # has a present rhs point at that step
        rsig: dict[tuple, np.ndarray] = {}
        for s in rhs:
            sig = _sig(s.labels, matching)
            present = ~np.isnan(s.vals)
            rsig[sig] = rsig.get(sig, np.zeros(len(self.steps),
                                               dtype=bool)) | present
        out = []
        if op in ("and", "unless"):
            for s in lhs:
                mask = rsig.get(_sig(s.labels, matching),
                                np.zeros(len(self.steps), dtype=bool))
                if op == "unless":
                    mask = ~mask
                vals = np.where(mask, s.vals, np.nan)
                if not np.isnan(vals).all():
                    out.append(Series(labels=s.labels, vals=vals))
            return out
        # or: all of lhs, plus rhs points whose signature has no lhs point
        lsig: dict[tuple, np.ndarray] = {}
        for s in lhs:
            sig = _sig(s.labels, matching)
            present = ~np.isnan(s.vals)
            lsig[sig] = lsig.get(sig, np.zeros(len(self.steps),
                                               dtype=bool)) | present
            out.append(s)
        for s in rhs:
            lmask = lsig.get(_sig(s.labels, matching),
                             np.zeros(len(self.steps), dtype=bool))
            vals = np.where(lmask, np.nan, s.vals)
            if not np.isnan(vals).all():
                out.append(Series(labels=s.labels, vals=vals))
        return out

    def _vector_binop(self, node: BinOp, lhs: list[Series],
                      rhs: list[Series]) -> list[Series]:
        matching = node.matching or VectorMatching()
        card = matching.card
        # normalize to a uniform (many, one) walk; lhs_is_many records which
        # operand order a matched pair evaluates in
        if card == "one-to-many":
            many, one, lhs_is_many = rhs, lhs, False
        else:
            many, one, lhs_is_many = lhs, rhs, True
        one_by_sig: dict[tuple, Series] = {}
        for s in one:
            sig = _sig(s.labels, matching)
            if sig in one_by_sig:
                raise PromqlError(
                    "many-to-many matching: duplicate series on the "
                    f"{'left' if lhs_is_many else 'right'} side "
                    f"for signature {dict(sig)!r}")
            one_by_sig[sig] = s
        if card == "one-to-one":
            seen: set[tuple] = set()
            for s in many:
                sig = _sig(s.labels, matching)
                if sig in seen:
                    raise PromqlError(
                        "many-to-many matching: duplicate series on the "
                        f"left side for signature {dict(sig)!r}")
                seen.add(sig)
        out = []
        for s in many:
            other = one_by_sig.get(_sig(s.labels, matching))
            if other is None:
                continue
            a, b = ((s.vals, other.vals) if lhs_is_many
                    else (other.vals, s.vals))
            with np.errstate(all="ignore"):
                vals = self._apply_op(node.op, a, b,
                                      bool_mod=node.bool_mod)
            if node.op in _CMP_OPS and not node.bool_mod:
                # filter comparisons keep the LEFT operand's value
                vals = np.where(np.isnan(vals), np.nan, a)
            if np.isnan(vals).all():
                continue
            # result labels
            if card == "one-to-one":
                if node.op in _CMP_OPS and not node.bool_mod:
                    # filter keeps the lhs series labels as-is
                    labels = dict(s.labels)
                elif matching.on:
                    labels = dict(_sig(s.labels, matching))
                else:
                    # drop __name__ AND the ignored labels (upstream
                    # resultMetric deletes ignoring(...) labels)
                    drop = set(matching.labels) | {"__name__"}
                    labels = {k: v for k, v in s.labels.items()
                              if k not in drop}
            else:
                labels = _drop_name(dict(s.labels))
                for lbl in matching.include:
                    if lbl in other.labels:
                        labels[lbl] = other.labels[lbl]
                    else:
                        labels.pop(lbl, None)
            out.append(Series(labels=labels, vals=vals))
        return out


# -- public API --------------------------------------------------------------

def scope_to_org(node, org_id: int):
    """Enforce tenancy on a parsed query: append an org_id matcher to
    every vector selector (org_id is a universal-tag column on every
    table, so the numeric-eq matcher path applies it). Returns the same
    AST, mutated."""
    if isinstance(node, VectorSelector):
        node.matchers = [m for m in node.matchers if m[0] != "org_id"]
        node.matchers.append(("org_id", "=", str(int(org_id))))
        return node
    if isinstance(node, MatrixSelector):
        scope_to_org(node.vs, org_id)
        return node
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, list):
            for item in v:
                if hasattr(item, "__dataclass_fields__"):
                    scope_to_org(item, org_id)
        elif hasattr(v, "__dataclass_fields__"):
            scope_to_org(v, org_id)
    return node


def evaluate(db: Database, query, start_s: int, end_s: int,
             step_s: int = 15) -> list[dict]:
    """Range evaluation -> prometheus matrix result
    [{"metric": labels, "values": [(ts, value), ...]}, ...]."""
    if isinstance(query, str):
        query = parse(query)
    steps = np.arange(start_s, end_s + 1, step_s, dtype=np.int64)
    if not len(steps):
        return []
    ev = _Evaluator(db, steps, default_res_s=float(step_s))
    result = ev.eval(query)
    if isinstance(result, Str):
        raise PromqlError("query evaluates to a string, not a vector")
    if isinstance(result, np.ndarray):
        vals = [(int(t), _json_num(v)) for t, v in zip(steps, result)
                if not math.isnan(v)]
        return [{"metric": {}, "values": vals}] if vals else []
    out = []
    for s in result:
        vals = [(int(t), _json_num(v)) for t, v in zip(steps, s.vals)
                if not math.isnan(v)]
        if vals:
            out.append({"metric": s.labels, "values": vals})
    return out


def _json_num(v: float):
    """Finite floats stay numbers; +/-Inf must not reach json.dumps (it
    emits the invalid-JSON token Infinity), so they go out as the
    prometheus string spelling."""
    v = float(v)
    return v if math.isfinite(v) else _fmt_num(v)


def evaluate_instant(db: Database, query, time_s: int) -> dict:
    """Instant evaluation -> {"resultType": "vector"|"scalar", "result": ...}
    in the prometheus HTTP API shape."""
    if isinstance(query, str):
        query = parse(query)
    steps = np.asarray([time_s], dtype=np.int64)
    ev = _Evaluator(db, steps)
    result = ev.eval(query)
    if isinstance(result, Str):
        return {"resultType": "string", "result": [time_s, result.value]}
    if isinstance(result, np.ndarray):
        v = float(result[0])
        return {"resultType": "scalar", "result": [time_s, _fmt_num(v)]}
    vec = []
    for s in result:
        v = float(s.vals[0])
        if math.isnan(v):
            continue
        vec.append({"metric": s.labels, "value": [time_s, _fmt_num(v)]})
    return {"resultType": "vector", "result": vec}


def _fmt_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


# -- metadata API (Grafana variable queries) ---------------------------------

_JSON_LABEL_SCAN_CAP = 50_000  # labels_json dict entries parsed per table


def _codes_in_range(table, col: str, lo_s: float, hi_s: float) -> set[int]:
    """Distinct dictionary/enum codes of `col` among rows in the time
    range. Chunk-scanned, NOT dictionary-snapshotted: dictionaries retain
    every string ever encoded, so a snapshot would resurrect TTL-trimmed
    values and ignore the range."""
    codes: set[int] = set()
    ns = table.columns["time"].kind == "u64"
    for ch in table.snapshot():
        if not ch or not len(ch.get(col, ())):
            continue
        t = ch["time"].astype(np.int64)
        if ns:
            t = t // 1_000_000_000
        mask = (t >= lo_s) & (t <= hi_s)
        if not mask.any():
            continue
        codes.update(int(c) for c in np.unique(ch[col][mask]))
    return codes


def metric_names(db: Database, start_s: float = 0,
                 end_s: float = 1 << 62) -> list[str]:
    """Every queryable metric name (the /prom/api/v1/label/__name__/values
    answer): <family>_<meter> for the flow tables (schema-derived),
    observed deepflow_system metric/value pairs, and remote-write names —
    the observed sets chunk-scanned within [start_s, end_s] so
    retention-trimmed metrics don't linger."""
    out: set[str] = set()
    for prefix, (tname, _tags) in _FAMILIES.items():
        try:
            table = db.table(tname)
        except KeyError:
            continue
        for col, spec in table.columns.items():
            if spec.kind == "u64":  # meters are u64; tags are str/enum/ints
                out.add(prefix + col)
    for prefix, tname in _NARROW_TABLES:
        try:
            table = db.table(tname)
            pairs: set[tuple[int, int]] = set()
            for ch in table.snapshot():
                if not ch or not len(ch.get("metric_name", ())):
                    continue
                t = ch["time"].astype(np.int64) // 1_000_000_000
                mask = (t >= start_s) & (t <= end_s)
                if not mask.any():
                    continue
                for mi, vi in zip(*np.unique(np.stack(
                        [ch["metric_name"][mask], ch["value_name"][mask]]),
                        axis=1)):
                    pairs.add((int(mi), int(vi)))
            mdict = table.dicts["metric_name"]
            vdict = table.dicts["value_name"]
            for mi, vi in pairs:
                mn, vn = mdict.decode(mi), vdict.decode(vi)
                if mn and vn:
                    out.add(f"{prefix}{_mangle(mn)}_{_mangle(vn)}")
        except (KeyError, IndexError):
            pass
    try:
        table = db.table("prometheus.samples")
        d = table.dicts["metric_name"]
        for c in _codes_in_range(table, "metric_name", start_s, end_s):
            try:
                name = d.decode(c)
            except IndexError:
                continue
            if name:
                out.add(name)
    except KeyError:
        pass
    return sorted(out)


def series(db: Database, matches: list[str], start_s: int,
           end_s: int) -> list[dict]:
    """GET /prom/api/v1/series: label sets of series matching any of the
    match[] selectors in the time range."""
    seen: set[tuple] = set()
    out: list[dict] = []
    for m in matches:
        ast = parse(m)
        if not isinstance(ast, VectorSelector):
            raise PromqlError("series match[] must be a plain selector")
        try:
            raw = fetch_raw(db, ast, start_s, end_s)
        except UnknownMetricError:
            continue  # never-ingested metric matches nothing; any OTHER
            # PromqlError (bad regex, unknown label) propagates as 400
        for rs in raw:
            key = tuple(sorted(rs.labels.items()))
            if key not in seen:
                seen.add(key)
                out.append(rs.labels)
    return out


def _all_label_names(db: Database, start_s: int, end_s: int) -> set[str]:
    names = {"__name__"}
    for _prefix, (tname, tags) in _FAMILIES.items():
        try:
            db.table(tname)
        except KeyError:
            continue
        names.update(tags)
    for tname, json_col in (("prometheus.samples", "labels_json"),
                            ("deepflow_system.deepflow_system", "tag_json")):
        try:
            table = db.table(tname)
        except KeyError:
            continue
        d = table.dicts[json_col]
        for i, code in enumerate(_codes_in_range(table, json_col,
                                                 start_s, end_s)):
            if i > _JSON_LABEL_SCAN_CAP:
                break
            try:
                names.update(_json.loads(d.decode(code) or "{}").keys())
            except (ValueError, IndexError):
                pass
    names.update(("host", "agent_id"))
    return names


def label_names(db: Database, matches: list[str], start_s: int,
                end_s: int) -> list[str]:
    """GET /prom/api/v1/labels."""
    if matches:
        names: set[str] = set()
        for s in series(db, matches, start_s, end_s):
            names.update(s.keys())
        return sorted(names)
    return sorted(_all_label_names(db, start_s, end_s))


def label_values(db: Database, label: str, matches: list[str],
                 start_s: int, end_s: int) -> list[str]:
    """GET /prom/api/v1/label/<name>/values. Values come from rows in the
    time range (chunk scan), not dictionary snapshots — retention-trimmed
    values must not haunt Grafana dropdowns."""
    if label == "__name__":
        if matches:
            return sorted({s.get("__name__", "")
                           for s in series(db, matches, start_s, end_s)}
                          - {""})
        return metric_names(db, start_s, end_s)
    if matches:
        return sorted({s[label] for s in series(db, matches, start_s, end_s)
                       if label in s})
    values: set[str] = set()
    for _prefix, (tname, tags) in _FAMILIES.items():
        if label not in tags:
            continue
        try:
            table = db.table(tname)
        except KeyError:
            continue
        spec = table.columns.get(label)
        if spec is None:
            continue
        codes = _codes_in_range(table, label, start_s, end_s)
        if spec.kind == "str":
            d = table.dicts[label]
            for c in codes:
                try:
                    s = d.decode(c)
                except IndexError:
                    continue
                if s:
                    values.add(s)
        elif spec.kind == "enum":
            for c in codes:
                if 0 <= c < len(spec.enum_values) and spec.enum_values[c]:
                    values.add(spec.enum_values[c])
        else:
            # numeric tags (server_port, agent_id, ...) render the same
            # way series() does: str(int)
            values.update(str(c) for c in codes)
    for tname, json_col in (("prometheus.samples", "labels_json"),
                            ("deepflow_system.deepflow_system", "tag_json")):
        try:
            table = db.table(tname)
        except KeyError:
            continue
        if label in table.columns and table.columns[label].kind == "str":
            d = table.dicts[label]
            for c in _codes_in_range(table, label, start_s, end_s):
                try:
                    s = d.decode(c)
                except IndexError:
                    continue
                if s:
                    values.add(s)
            continue
        d = table.dicts[json_col]
        for i, code in enumerate(_codes_in_range(table, json_col,
                                                 start_s, end_s)):
            if i > _JSON_LABEL_SCAN_CAP:
                break
            try:
                v = _json.loads(d.decode(code) or "{}").get(label)
            except (ValueError, IndexError):
                continue
            if v is not None and str(v):
                values.add(str(v))
    return sorted(values)
