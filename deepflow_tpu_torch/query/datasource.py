"""Transparent rollup datasource selection.

Own copy of ``deepflow_tpu/query/datasource.py``, on the port's engine
and its ``query/sketch.py``.

Reference analog: the querier's datasource auto-selection over the
ingester's 1m/1h/1d rollup tables (server/querier picks the coarsest
datasource whose interval divides the query's grouping). A query over a
raw `flow_metrics.*.1s` table is answered from a rollup tier instead —
byte-identically — when four things hold:

  1. every aggregate call site is the SAME decomposable aggregator the
     rollup applied to that column (Sum/Max/Min partials re-aggregate
     to the raw answer; Count/Last/Percentile do not decompose),
  2. every non-aggregate column reference is a rollup group-by tag (or
     `time` inside an aligned time() bucket),
  3. the GROUP BY is tags plus time() buckets that are multiples of
     the tier's bucket, and
  4. the WHERE is a conjunction of tag-only filters and tier-aligned
     time bounds whose upper bound closes under the rollup job's
     completeness horizon (late rows past the horizon would otherwise
     be missing from the rollup answer).

The rollup tables share the raw tables' column names, so selection is
a pure TABLE SWAP: the SQL text runs unchanged, and the query cache
keys on the table object — raw and rollup answers never collide.

Avg() and Count() reject for the same reason: rolling collapses rows,
so their denominators change — Avg over 1m rows divides by minutes,
not raw rows. The DeepFlow-style recipe (Sum(rrt_sum)/Sum(rrt_count)
over pre-summed meter pairs) stays selectable because both sides are
Sums.

PERCENTILE() takes a separate path (`sketch_percentile`): rollup tiers
carry a mergeable DDSketch state column, and a percentile over a
covered range is answered by merging those states per group — the one
documented-approximate rollup (relative error bounded by the sketch
gamma, exactly like federated percentile merges).
"""

from __future__ import annotations

import json
import logging

from deepflow_tpu_torch.query import engine as qengine
from deepflow_tpu_torch.query import sql as S

log = logging.getLogger("df.qdatasource")

# selectable tiers, coarsest first (a coarser answer scans fewer rows)
_TIERS = [("1d", 86400), ("1h", 3600), ("1m", 60)]

_AGG_MATCH = {"SUM": "Sum", "MAX": "Max", "MIN": "Min"}


def _family(table_name: str):
    """(family, spec) when `table_name` is a raw 1s rollup source."""
    from deepflow_tpu_torch.server.datasource import FAMILIES
    if not table_name.endswith(".1s"):
        return None
    family = table_name[:-len(".1s")]
    spec = FAMILIES.get(family)
    return None if spec is None else (family, spec)


def _collect_nonagg_cols(e, out: set) -> None:
    """Column refs OUTSIDE aggregate call sites (agg args are validated
    against the rollup aggregators separately)."""
    if isinstance(e, S.Col):
        out.add(e.name)
    elif isinstance(e, S.Func):
        if e.name in S.AGG_FUNCS:
            return
        # an aligned time() bucket is the rollup's own grouping key, not
        # a raw-timestamp reference (_time_buckets validates its width)
        if (e.name == "TIME" and len(e.args) == 2
                and isinstance(e.args[0], S.Col)
                and e.args[0].name == "time"
                and isinstance(e.args[1], S.Lit)):
            return
        for a in e.args:
            _collect_nonagg_cols(a, out)
    elif isinstance(e, S.BinOp):
        _collect_nonagg_cols(e.left, out)
        if not isinstance(e.right, tuple):
            _collect_nonagg_cols(e.right, out)
    elif isinstance(e, S.Not):
        _collect_nonagg_cols(e.expr, out)
    elif isinstance(e, S.Case):
        for c, v in e.whens:
            _collect_nonagg_cols(c, out)
            _collect_nonagg_cols(v, out)
        if e.default is not None:
            _collect_nonagg_cols(e.default, out)


# top-level AND flattening is shared with the engine's zone-map
# constraint extraction — one definition of "conjunct" for both the
# rollup classifier and segment pruning
_conjuncts = qengine._split_conjuncts


def _time_bound(e):
    """(op, seconds) for a `time >= lo` / `time < hi` conjunct, else
    None. Only these two forms are accepted: anything else touching
    `time` disqualifies selection (mid-bucket bounds would slice rolled
    buckets that cannot be sliced)."""
    if (isinstance(e, S.BinOp) and e.op in (">=", "<")
            and isinstance(e.left, S.Col) and e.left.name == "time"
            and isinstance(e.right, S.Lit)
            and isinstance(e.right.value, int)):
        return e.op, int(e.right.value)
    return None


def _time_buckets(query: S.Select) -> list[int] | None:
    """Every time(time, N) bucket width used by the query, or None when
    some group-by entry is neither a plain column nor an aligned time
    bucket."""
    widths: list[int] = []
    for g in query.group_by:
        if isinstance(g, S.Col):
            continue
        if (isinstance(g, S.Func) and g.name == "TIME"
                and len(g.args) == 2 and isinstance(g.args[0], S.Col)
                and g.args[0].name == "time"
                and isinstance(g.args[1], S.Lit)):
            try:
                widths.append(int(g.args[1].value))
            except (TypeError, ValueError):
                return None
            continue
        return None
    # time() in SELECT items must appear in GROUP BY for an aggregate
    # query, so group_by widths are the complete set
    return widths


def _classify(table, query: S.Select, spec):
    """Shared eligibility analysis. Returns (tag_cols_ok, widths,
    lo, hi) or None when the query shape can never select a rollup:
    widths — every time() bucket used; hi — the exclusive upper time
    bound (REQUIRED: without it the window extends past any horizon)."""
    for item in query.items:
        if isinstance(item.expr, S.Star):
            return None
    if any(i.distinct for i in qengine._agg_sites(query)
           if isinstance(i, S.Func)):
        return None
    widths = _time_buckets(query)
    if widths is None:
        return None
    nonagg: set[str] = set()
    for item in query.items:
        _collect_nonagg_cols(item.expr, nonagg)
    for g in query.group_by:
        _collect_nonagg_cols(g, nonagg)
    if query.having is not None:
        _collect_nonagg_cols(query.having, nonagg)
    aliases = {i.alias for i in query.items if i.alias}
    for e, _ in query.order_by:
        if isinstance(e, S.Col) and e.name in aliases:
            continue
        if S.expr_name(e) in aliases:
            continue
        _collect_nonagg_cols(e, nonagg)
    allowed = set(spec.tags)
    # `time` outside time()/WHERE-bounds (e.g. SELECT time) would leak
    # bucket-start values where raw timestamps were asked for
    if not nonagg <= allowed:
        return None
    lo = hi = None
    if query.where is not None:
        for c in _conjuncts(query.where):
            cols: set[str] = set()
            _collect_nonagg_cols(c, cols)
            if "time" not in cols:
                if not cols <= allowed:
                    return None
                continue
            tb = _time_bound(c)
            if tb is None:
                return None
            if tb[0] == ">=":
                lo = tb[1] if lo is None else max(lo, tb[1])
            else:
                hi = tb[1] if hi is None else min(hi, tb[1])
    if hi is None:
        return None
    return widths, lo, hi


def _pick_tier(db, family: str, widths, lo, hi, horizons):
    """Coarsest tier that answers exactly, or None."""
    for sfx, bucket in _TIERS:
        if any(w % bucket for w in widths):
            continue
        if hi % bucket or (lo is not None and lo % bucket):
            continue
        if hi > horizons.get((family, sfx), 0):
            continue  # late rows past the horizon not yet rolled
        try:
            return db.table(f"{family}.{sfx}"), sfx, bucket
        except KeyError:
            continue
    return None


def select_rollup(db, table, query: S.Select, horizons):
    """(rollup_table, info) when `query` over raw `table` is answered
    byte-identically by a rollup tier; None otherwise (caller keeps the
    raw table). `horizons` is RollupJob.horizons()."""
    fam = _family(table.name)
    if fam is None:
        return None
    family, spec = fam
    try:
        query = qengine._normalize(table, query)
    except qengine.QueryError:
        return None  # let the raw path raise the real error
    sites = qengine._agg_sites(query)
    if not sites:
        return None  # row-level query: raw timestamps must survive
    for site in sites:
        fn = _AGG_MATCH.get(site.name)
        if (fn is None or site.distinct or len(site.args) != 1
                or not isinstance(site.args[0], S.Col)
                or spec.aggs.get(site.args[0].name) != fn):
            return None
    shape = _classify(table, query, spec)
    if shape is None:
        return None
    picked = _pick_tier(db, family, *shape, horizons)
    if picked is None:
        return None
    rtable, sfx, bucket = picked
    return rtable, {"datasource": rtable.name, "bucket_s": bucket,
                    "tier": sfx}


def sketch_percentile(db, table, query: S.Select, horizons):
    """(QueryResult, info) for a PERCENTILE query answered from rollup
    DDSketch state; None when the query must run raw. Approximate
    within the sketch's gamma bound — mirrors the documented federated
    percentile merge semantics."""
    from deepflow_tpu_torch.query.sketch import HistogramSketch
    fam = _family(table.name)
    if fam is None or not fam[1].sketches:
        return None
    family, spec = fam
    sketch_of = {src: sc for sc, src in spec.sketches.items()}
    try:
        query = qengine._normalize(table, query)
    except qengine.QueryError:
        return None
    if query.having is not None or query.order_by or query.limit:
        return None
    # every item must be a group key or exactly PERCENTILE(<covered>, p)
    sites: list[tuple[int, str, float]] = []  # (item idx, sketch col, p)
    group_keys = list(query.group_by)
    for idx, item in enumerate(query.items):
        e = item.expr
        if (isinstance(e, S.Func) and e.name == "PERCENTILE"
                and len(e.args) == 2 and isinstance(e.args[0], S.Col)
                and e.args[0].name in sketch_of
                and isinstance(e.args[1], S.Lit)):
            sites.append((idx, sketch_of[e.args[0].name],
                          float(e.args[1].value)))
            continue
        if e in group_keys:
            continue
        return None
    if not sites:
        return None
    shape = _classify(table, query, spec)
    if shape is None:
        return None
    picked = _pick_tier(db, family, *shape, horizons)
    if picked is None:
        return None
    rtable, sfx, bucket = picked
    need_sketches = sorted({sc for _, sc, _ in sites})
    if any(sc not in rtable.columns for sc in need_sketches):
        return None
    # fetch the group keys + sketch states as plain rows, merge states
    # per group in the sketch domain, then emit in the query's layout
    fetch = S.Select(
        items=([S.SelectItem(g, f"k{j}")
                for j, g in enumerate(group_keys)]
               + [S.SelectItem(S.Col(sc), sc) for sc in need_sketches]),
        table=query.table, where=query.where)
    res = qengine.execute(rtable, fetch)
    nk = len(group_keys)
    merged: dict[tuple, dict] = {}
    for row in res.values:
        key = tuple(row[:nk])
        cur = merged.get(key)
        if cur is None:
            cur = merged[key] = {sc: HistogramSketch()
                                 for sc in need_sketches}
        for j, sc in enumerate(need_sketches):
            state = row[nk + j]
            if state:
                try:
                    cur[sc].merge(
                        HistogramSketch.from_dict(json.loads(state)))
                except (ValueError, TypeError):
                    log.warning("undecodable sketch state skipped")
    names = [i.alias or S.expr_name(i.expr) for i in query.items]
    key_idx = {repr(g): j for j, g in enumerate(group_keys)}
    site_by_item = {idx: (sc, p) for idx, sc, p in sites}
    rows = []
    for key in sorted(merged, key=repr):
        sk = merged[key]
        row = []
        for idx, item in enumerate(query.items):
            if idx in site_by_item:
                sc, p = site_by_item[idx]
                row.append(sk[sc].percentile(p))
            else:
                row.append(key[key_idx[repr(item.expr)]])
        rows.append(row)
    result = qengine.QueryResult(columns=names, values=rows)
    return result, {"datasource": rtable.name, "bucket_s": bucket,
                    "tier": sfx, "approx": "ddsketch",
                    "sites": len(sites)}
