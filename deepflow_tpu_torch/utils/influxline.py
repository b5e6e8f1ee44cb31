"""InfluxDB line-protocol parser (Telegraf's wire format).

Own copy of ``deepflow_tpu/utils/influxline.py``: pure byte code,
the same bytes in and out.

Reference analog: agent/src/integration_collector.rs:757 accepts Telegraf
posts on /api/v1/telegraf and the server's ext_metrics ingester decodes
them. Format, per the public line-protocol spec:

    measurement[,tag=v...] field=v[,field=v...] [timestamp_ns]

Escaping: measurement escapes ',' and ' '; tag/field keys and tag values
escape ',', '=', ' '; string field values are double-quoted with '\\'
escapes. Field types: float (default), int ("42i"), uint ("42u"),
bool (t/true/T/f/false/F), string ("...").
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


class LineProtocolError(ValueError):
    pass


@dataclass
class Point:
    measurement: str
    tags: dict = field(default_factory=dict)
    fields: dict = field(default_factory=dict)
    timestamp_ns: int | None = None


def _split_unescaped(s: str, sep: str, quotes: bool = False) -> list[str]:
    """Split on unescaped sep; backslash escapes the next char. With
    quotes=True the separator is also ignored inside double-quoted strings
    (field VALUES may contain it) — quotes have no special meaning in
    measurements/tags per the line-protocol spec, so callers there keep
    the default."""
    out, cur, i, in_quote = [], [], 0, False
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(s[i:i + 2])
            i += 2
            continue
        if quotes and c == '"':
            in_quote = not in_quote
            cur.append(c)
        elif c == sep and not in_quote:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


def _partition_unescaped(s: str, sep: str = "=") -> tuple[str, str | None]:
    """Split at the first unescaped sep; None if absent. partition() would
    split spec-legal escaped separators in keys (e.g. tag key 'a\\=b')."""
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            i += 2
            continue
        if s[i] == sep:
            return s[:i], s[i + 1:]
        i += 1
    return s, None


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _split_line(line: str) -> tuple[str, str, str | None]:
    """-> (measurement+tags, field set, timestamp or None). The head is cut
    at the first unescaped space (quotes are literal there); the remainder
    splits on unescaped spaces outside quoted field values."""
    i, in_head = 0, True
    while i < len(line):
        if line[i] == "\\" and i + 1 < len(line):
            i += 2
            continue
        if line[i] == " ":
            break
        i += 1
    else:
        raise LineProtocolError("missing field set")
    head, rest = line[:i], line[i + 1:].strip()
    if not rest:
        raise LineProtocolError("missing field set")
    in_quote, j = False, 0
    while j < len(rest):
        if rest[j] == "\\" and j + 1 < len(rest):
            j += 2
            continue
        if rest[j] == '"':
            in_quote = not in_quote
        j += 1
    if in_quote:
        raise LineProtocolError("unterminated string value")
    parts = [p for p in _split_unescaped(rest, " ", quotes=True) if p]
    if len(parts) > 2:
        raise LineProtocolError(f"expected 2-3 segments, got {len(parts) + 1}")
    return head, parts[0], parts[1] if len(parts) == 2 else None


def _parse_field_value(v: str):
    if not v:
        raise LineProtocolError("empty field value")
    if v[0] == '"':
        if len(v) < 2 or v[-1] != '"':
            raise LineProtocolError(f"bad string value {v!r}")
        return _unescape(v[1:-1])
    if v in ("t", "T", "true", "True", "TRUE"):
        return True
    if v in ("f", "F", "false", "False", "FALSE"):
        return False
    if v[-1] in "iu":
        return int(v[:-1])
    f = float(v)
    # line protocol has no NaN/inf literal; float() accepting 'nan'/'inf'
    # would otherwise poison sum/avg aggregations over the stored series
    if not math.isfinite(f):
        raise LineProtocolError(f"non-finite field value {v!r}")
    return f


def parse_line(line: str) -> Point:
    head, fieldset, ts = _split_line(line)
    keyparts = _split_unescaped(head, ",")
    p = Point(measurement=_unescape(keyparts[0]))
    if not p.measurement:
        raise LineProtocolError("empty measurement")
    for kv in keyparts[1:]:
        k, v = _partition_unescaped(kv)
        if v is None or not k:
            raise LineProtocolError(f"bad tag {kv!r}")
        p.tags[_unescape(k)] = _unescape(v)
    for kv in _split_unescaped(fieldset, ",", quotes=True):
        k, v = _partition_unescaped(kv)
        if v is None or not k:
            raise LineProtocolError(f"bad field {kv!r}")
        p.fields[_unescape(k)] = _parse_field_value(v)
    if not p.fields:
        raise LineProtocolError("no fields")
    if ts is not None:
        p.timestamp_ns = int(ts)
    return p


def parse_lines(text: str) -> tuple[list[Point], int]:
    """Parse a Telegraf POST body. Returns (points, n_bad_lines) — one bad
    line doesn't poison the batch (Telegraf batches many measurements)."""
    points, bad = [], 0
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            points.append(parse_line(line))
        except (LineProtocolError, ValueError):
            bad += 1
    return points, bad
