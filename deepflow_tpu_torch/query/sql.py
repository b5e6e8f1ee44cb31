"""DF-SQL: tokenizer + recursive-descent parser.

Own copy of ``deepflow_tpu/query/sql.py``, whole: the same tokens, AST
and grammar, so a statement parses to the same tree in both packages.

Dialect (subset mirroring the reference querier's surface,
server/querier/engine/clickhouse/parse.go):

    SELECT expr [AS alias], ... FROM table
    [WHERE cond] [GROUP BY expr, ...] [HAVING cond]
    [ORDER BY expr [ASC|DESC], ...] [LIMIT n]

    SHOW DATABASES | SHOW TABLES | SHOW TAGS FROM t | SHOW METRICS FROM t

Aggregates: Sum, Avg, Min, Max, Count, Last, Percentile(x, p).
Scalars: time(time, interval_s) — time bucketing.
Conditions: = != <> < <= > >= IN (...) LIKE 'pat%' AND OR NOT ( ).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

KEYWORDS = {"SELECT", "FROM", "WHERE", "GROUP", "ORDER", "BY", "LIMIT",
            "AS", "AND", "OR", "NOT", "IN", "LIKE", "ASC", "DESC",
            "HAVING", "SHOW", "DISTINCT", "CASE", "WHEN", "THEN",
            "ELSE", "END"}
AGG_FUNCS = {"SUM", "AVG", "MIN", "MAX", "COUNT", "LAST", "PERCENTILE"}
SCALAR_FUNCS = {"TIME"}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'(?:[^'\\]|\\.)*')
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|\*|/|\+|-)
""", re.VERBOSE)


@dataclass(frozen=True)
class Token:
    kind: str  # num | str | ident | kw | op | eof
    value: str
    pos: int


class SqlError(Exception):
    pass


def tokenize(sql: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlError(f"bad token at {pos}: {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "ident" and val.upper() in KEYWORDS:
            out.append(Token("kw", val.upper(), m.start()))
        elif kind == "str":
            out.append(Token("str", val[1:-1].replace("\\'", "'"), m.start()))
        else:
            out.append(Token(kind, val, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


# -- AST --------------------------------------------------------------------

@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Lit:
    value: object  # int | float | str


@dataclass(frozen=True)
class Case:
    """CASE WHEN cond THEN expr [WHEN ...] [ELSE expr] END."""
    whens: tuple     # ((cond, expr), ...)
    default: object = None


@dataclass(frozen=True)
class Func:
    name: str      # upper-cased
    args: tuple
    distinct: bool = False   # COUNT(DISTINCT col)


@dataclass(frozen=True)
class BinOp:
    op: str        # = != < <= > >= + - * / AND OR IN LIKE
    left: object
    right: object


@dataclass(frozen=True)
class Not:
    expr: object


@dataclass(frozen=True)
class Star:
    pass


@dataclass
class SelectItem:
    expr: object
    alias: str | None = None


@dataclass
class Select:
    items: list[SelectItem]
    table: str
    where: object | None = None
    group_by: list = field(default_factory=list)
    having: object | None = None
    order_by: list = field(default_factory=list)  # (expr, desc: bool)
    limit: int | None = None


@dataclass
class Show:
    """SHOW DATABASES | TABLES | TAGS FROM t | METRICS FROM t
    (reference: querier `show tags/metrics` introspection backed by
    db_descriptions/)."""
    what: str                 # databases | tables | tags | metrics
    table: str | None = None


@dataclass
class Explain:
    """EXPLAIN [ANALYZE] <select>.  Carries the parsed inner select AND
    its original text slice — federation and the query cache key on the
    SQL text, so the explain path must hand them the text the planner
    would have seen for a plain query."""
    select: Select
    analyze: bool = False
    sql: str = ""             # inner SELECT text, sliced from the input


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, value: str | None = None) -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise SqlError(f"expected {value or kind}, got {t.value!r} at {t.pos}")
        return t

    def accept_kw(self, *kws: str) -> Token | None:
        t = self.peek()
        if t.kind == "kw" and t.value in kws:
            return self.next()
        return None

    # select := SELECT items FROM ident [WHERE ...] ...
    def parse_select(self) -> Select:
        self.expect("kw", "SELECT")
        items = [self.parse_select_item()]
        while self.peek().kind == "op" and self.peek().value == ",":
            self.next()
            items.append(self.parse_select_item())
        self.expect("kw", "FROM")
        table = self.expect("ident").value
        sel = Select(items=items, table=table)
        if self.accept_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.accept_kw("GROUP"):
            self.expect("kw", "BY")
            sel.group_by.append(self.parse_expr())
            while self.peek().value == ",":
                self.next()
                sel.group_by.append(self.parse_expr())
        if self.accept_kw("HAVING"):
            sel.having = self.parse_expr()
        if self.accept_kw("ORDER"):
            self.expect("kw", "BY")
            sel.order_by.append(self.parse_order_item())
            while self.peek().value == ",":
                self.next()
                sel.order_by.append(self.parse_order_item())
        if self.accept_kw("LIMIT"):
            sel.limit = int(self.expect("num").value)
        if self.peek().kind != "eof":
            t = self.peek()
            raise SqlError(f"trailing input at {t.pos}: {t.value!r}")
        return sel

    def parse_select_item(self) -> SelectItem:
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect("ident").value
        return SelectItem(expr, alias)

    def parse_order_item(self):
        expr = self.parse_expr()
        desc = False
        if self.accept_kw("DESC"):
            desc = True
        else:
            self.accept_kw("ASC")
        return (expr, desc)

    # precedence: OR < AND < NOT < cmp/IN/LIKE < add < mul < unary < primary
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.accept_kw("OR"):
            left = BinOp("OR", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept_kw("AND"):
            left = BinOp("AND", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept_kw("NOT"):
            return Not(self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_add()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return BinOp(op, left, self.parse_add())
        if t.kind == "kw" and t.value in ("IN", "LIKE"):
            return self.parse_cmp_tail(left)
        if t.kind == "kw" and t.value == "NOT":
            # x NOT IN (...) / NOT LIKE
            save = self.i
            self.next()
            t2 = self.peek()
            if t2.kind == "kw" and t2.value in ("IN", "LIKE"):
                self.i = save
                self.next()  # NOT
                inner = self.parse_cmp_tail(left)
                return Not(inner)
            self.i = save
        return left

    def parse_cmp_tail(self, left):
        t = self.peek()
        if t.kind == "kw" and t.value == "IN":
            self.next()
            self.expect("op", "(")
            vals = [self.parse_literal()]
            while self.peek().value == ",":
                self.next()
                vals.append(self.parse_literal())
            self.expect("op", ")")
            return BinOp("IN", left, tuple(vals))
        if t.kind == "kw" and t.value == "LIKE":
            self.next()
            pat = self.expect("str").value
            return BinOp("LIKE", left, Lit(pat))
        raise SqlError(f"expected IN or LIKE at {t.pos}")

    def parse_literal(self) -> Lit:
        t = self.next()
        if t.kind == "num":
            return Lit(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "str":
            return Lit(t.value)
        raise SqlError(f"expected literal at {t.pos}")

    def parse_add(self):
        left = self.parse_mul()
        while self.peek().kind == "op" and self.peek().value in ("+", "-"):
            op = self.next().value
            left = BinOp(op, left, self.parse_mul())
        return left

    def parse_mul(self):
        left = self.parse_unary()
        while self.peek().kind == "op" and self.peek().value in ("*", "/"):
            op = self.next().value
            left = BinOp(op, left, self.parse_unary())
        return left

    def parse_unary(self):
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            return BinOp("-", Lit(0), self.parse_unary())
        return self.parse_primary()

    def parse_primary(self):
        t = self.next()
        if t.kind == "num":
            return Lit(float(t.value) if "." in t.value else int(t.value))
        if t.kind == "str":
            return Lit(t.value)
        if t.kind == "op" and t.value == "(":
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "op" and t.value == "*":
            return Star()
        if t.kind == "kw" and t.value == "CASE":
            whens = []
            while self.accept_kw("WHEN"):
                cond = self.parse_or()
                self.expect("kw", "THEN")
                whens.append((cond, self.parse_expr()))
            if not whens:
                raise SqlError(f"CASE needs at least one WHEN at {t.pos}")
            default = None
            if self.accept_kw("ELSE"):
                default = self.parse_expr()
            self.expect("kw", "END")
            return Case(tuple(whens), default)
        if t.kind == "ident":
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                args = []
                distinct = False
                if self.accept_kw("DISTINCT"):
                    distinct = True
                if not (self.peek().kind == "op" and self.peek().value == ")"):
                    args.append(self.parse_expr())
                    while self.peek().value == ",":
                        self.next()
                        args.append(self.parse_expr())
                self.expect("op", ")")
                return Func(t.value.upper(), tuple(args),
                            distinct=distinct)
            return Col(t.value)
        raise SqlError(f"unexpected {t.value!r} at {t.pos}")


    def parse_show(self) -> Show:
        self.expect("kw", "SHOW")
        t = self.next()
        if t.kind != "ident":
            raise SqlError(f"expected SHOW target at {t.pos}")
        what = t.value.lower()
        if what in ("databases", "tables"):
            stmt = Show(what)
        elif what in ("tags", "metrics"):
            self.expect("kw", "FROM")
            stmt = Show(what, self.expect("ident").value)
        else:
            raise SqlError(f"cannot SHOW {t.value!r}")
        if self.peek().kind != "eof":
            t2 = self.peek()
            raise SqlError(f"trailing input at {t2.pos}: {t2.value!r}")
        return stmt


def parse(sql: str) -> Select:
    return _Parser(tokenize(sql)).parse_select()


def parse_statement(sql: str) -> Select | Show | Explain:
    """Entry point that also accepts SHOW and EXPLAIN statements."""
    toks = tokenize(sql)
    if toks and toks[0].kind == "kw" and toks[0].value == "SHOW":
        return _Parser(toks).parse_show()
    # EXPLAIN/ANALYZE are not reserved words (they tokenize as idents so
    # columns may use the names); only the statement head position is
    # sniffed, exactly like real dialects treat soft keywords
    if (toks and toks[0].kind == "ident"
            and toks[0].value.upper() == "EXPLAIN"):
        k = 1
        analyze = (len(toks) > 1 and toks[1].kind == "ident"
                   and toks[1].value.upper() == "ANALYZE")
        if analyze:
            k = 2
        if k >= len(toks) or toks[k].kind == "eof":
            raise SqlError("EXPLAIN needs a SELECT statement")
        inner = _Parser(toks[k:]).parse_select()
        return Explain(inner, analyze=analyze, sql=sql[toks[k].pos:])
    return _Parser(toks).parse_select()


def expr_name(e) -> str:
    """Canonical display name of an expression."""
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Star):
        return "*"
    if isinstance(e, Func):
        inner = ", ".join(expr_name(a) for a in e.args)
        if e.distinct:
            inner = f"DISTINCT {inner}"
        return f"{e.name}({inner})"
    if isinstance(e, Case):
        parts = " ".join(
            f"WHEN {expr_name(c)} THEN {expr_name(v)}"
            for c, v in e.whens)
        tail = f" ELSE {expr_name(e.default)}" if e.default is not None \
            else ""
        return f"CASE {parts}{tail} END"
    if isinstance(e, BinOp):
        return f"{expr_name(e.left)} {e.op} {expr_name(e.right)}"
    if isinstance(e, Not):
        return f"NOT {expr_name(e.expr)}"
    return str(e)


def contains_agg(e) -> bool:
    if isinstance(e, Func):
        if e.name in AGG_FUNCS:
            return True
        return any(contains_agg(a) for a in e.args)
    if isinstance(e, BinOp):
        return contains_agg(e.left) or (
            not isinstance(e.right, tuple) and contains_agg(e.right))
    if isinstance(e, Not):
        return contains_agg(e.expr)
    if isinstance(e, Case):
        return any(contains_agg(c) or contains_agg(v)
                   for c, v in e.whens) or (
            e.default is not None and contains_agg(e.default))
    return False
