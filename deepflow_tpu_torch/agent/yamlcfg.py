"""A YAML reader for the agent's configs, with no yaml package.

The card's machine has no PyYAML, and the agent's config is YAML: a file
(``AgentConfig.load``, the agent's ``-f``) and the controller's pushed
group configs (``SyncResponse.user_config_yaml``), which the reference
reads with ``yaml.safe_load`` (``deepflow_tpu/agent/synchronizer.py:321``,
``server/controller.py:316``). ``load`` reads the subset those configs use
and gives what ``safe_load`` gives for it:

- one document (an optional ``---`` first), ``#`` comments;
- block mappings and block sequences, compact ones (``- a: 1``) and a
  sequence at its key's own indentation (``key:\\n- x``);
- flow sequences and flow mappings (``servers: [["127.0.0.1", 20033]]``,
  ``{a: 1, b}``), across lines too;
- plain, single-quoted and double-quoted scalars, folded across lines
  as YAML 1.1 folds them, with the double-quoted escapes;
- plain scalars resolved as PyYAML's YAML 1.1 resolver resolves them:
  ``yes`` / ``no`` / ``on`` / ``off`` / ``true`` / ``false`` in their three
  cases are bools, ``~``, ``null`` and an empty value are None, ints
  include ``0b``, ``0x``, octal ``0..`` and base 60 (``1:30``), floats
  need a dot (``1.0e+3`` is a float, ``1e3`` a string), ``.inf`` and
  ``.nan``; a duplicate key keeps its last value.

Explicit keys (``? key`` then ``: value``, as ``safe_dump`` writes an
empty or a long key) are read when the key is a scalar. Anything else
(anchors and aliases, tags, block scalars ``|`` and ``>``, collections
as keys, the merge key ``<<``, dates, directives, several documents, a
single-pair mapping inside a flow sequence, tabs in indentation) raises
``YamlError`` with its line number; the reader never guesses.
"""

from __future__ import annotations

import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# a plain scalar may not start with these (``-``, ``?`` and ``:`` may,
# when a non-space follows)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_FLOW_INDICATORS = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlError(ValueError):
    """Input outside the reader's subset, or not YAML."""


def load(text) -> object:
    """The one document in ``text`` (str or UTF-8 bytes) as
    ``yaml.safe_load`` reads it; None for an empty document."""
    if isinstance(text, (bytes, bytearray)):
        text = bytes(text).decode("utf-8")
    return _Reader(text).document()


def _resolve(s: str) -> object:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if s[0] in "-+0123456789." and _FLOAT.match(s):
        return _to_float(s)
    if s[0] in "-+0123456789" and _INT.match(s):
        return _to_int(s)
    return s


def _sign(v: str) -> tuple[int, str]:
    sign = -1 if v[0] == "-" else 1
    return sign, v[1:] if v[0] in "+-" else v


def _base60(v: str, cast) -> object:
    total = cast(0)
    for part in v.split(":"):
        total = total * 60 + cast(part)
    return total


def _to_int(s: str) -> int:
    sign, v = _sign(s.replace("_", ""))
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _base60(v, int)
    return sign * int(v)


def _to_float(s: str) -> float:
    sign, v = _sign(s.replace("_", "").lower())
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _base60(v, float)
    return sign * float(v)


class _Reader:
    def __init__(self, text: str) -> None:
        if text.startswith("﻿"):
            text = text[1:]
        text = text.replace("\r\n", "\n").replace("\r", "\n") + "\n"
        # YAML 1.1's other line breaks: NEL folds as a newline does, the
        # line and paragraph separators fold into themselves
        self.breaks = {i: c for i, c in enumerate(text)
                       if c in "\x85\u2028\u2029"}
        for c in "\x85\u2028\u2029":
            text = text.replace(c, "\n")
        self.s = text
        self.i = 0

    # -- positions -----------------------------------------------------------

    def take_breaks(self) -> list[str] | None:
        """From the line break at the cursor: each break up to the next
        non-blank content (what it folds from: "\\n", or a separator),
        the cursor after the last one's indentation; None and the cursor
        kept when no break is at the cursor (past inline spaces)."""
        save = self.i
        out = []
        while True:
            self.skip_inline_space()
            if self.ch() != "\n":
                break
            c = self.breaks.get(self.i, "\n")
            out.append("\n" if c == "\x85" else c)
            self.i += 1
        if not out:
            self.i = save
            return None
        return out

    @staticmethod
    def fold(breaks: list[str]) -> str:
        """A run of line breaks inside a scalar, as YAML 1.1 folds it: a
        lone newline is a space, a separator stays itself, each further
        break is kept."""
        first, rest = breaks[0], breaks[1:]
        if first != "\n":
            return first + "".join(rest)
        return "".join(rest) if rest else " "

    def fail(self, msg: str, i: int | None = None):
        i = self.i if i is None else i
        raise YamlError(f"line {self.s.count(chr(10), 0, i) + 1}: {msg}")

    def col(self, i: int | None = None) -> int:
        i = self.i if i is None else i
        return i - (self.s.rfind("\n", 0, i) + 1)

    def ch(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def at_end(self) -> bool:
        return self.i >= len(self.s)

    def comment_at(self, i: int) -> bool:
        return self.s[i] == "#" and (i == 0 or self.s[i - 1] in " \t\n")

    def skip_inline_space(self) -> None:
        while self.ch() in (" ", "\t"):
            self.i += 1

    def line_rest_empty(self) -> bool:
        """Only spaces and a comment are left on this line."""
        j = self.i
        while self.s[j] in " \t":
            j += 1
        return self.s[j] == "\n" or self.comment_at(j)

    def skip_to_content(self) -> None:
        """To the next character that is not space, comment or line
        break; a tab in a line's indentation raises."""
        s = self.s
        while self.i < len(s):
            c = s[self.i]
            if c == " ":
                self.i += 1
            elif c == "\t":
                if s[self.s.rfind("\n", 0, self.i) + 1:self.i].strip(" ") \
                        == "":
                    self.fail("a tab in indentation")
                self.i += 1
            elif c == "\n":
                self.i += 1
            elif self.comment_at(self.i):
                self.i = s.index("\n", self.i)
            else:
                return

    def is_seq_entry(self, i: int | None = None) -> bool:
        i = self.i if i is None else i
        return self.s[i] == "-" and self.s[i + 1] in " \t\n"

    def doc_marker(self) -> str:
        """"---" or "..." when one stands at the start of this line."""
        i = self.i
        if self.col(i) == 0 and self.s[i:i + 3] in ("---", "...") and \
                self.s[i + 3] in " \t\n":
            return self.s[i:i + 3]
        return ""

    # -- the document --------------------------------------------------------

    def document(self) -> object:
        self.skip_to_content()
        if not self.at_end() and self.ch() == "%":
            self.fail("directives are not supported")
        if not self.at_end() and self.doc_marker() == "---":
            self.i += 3
        node = self.block(-1)
        self.skip_to_content()
        if not self.at_end() and self.doc_marker() == "...":
            self.i += 3
            self.skip_to_content()
        if not self.at_end():
            if self.doc_marker() == "---":
                self.fail("only one document is supported")
            self.fail(f"unexpected {self.ch()!r}")
        return node

    def block(self, parent: int) -> object:
        """The block node that starts at the next content, if it is
        indented deeper than ``parent``; else an empty node (None)."""
        self.skip_to_content()
        if self.at_end() or self.doc_marker() or self.col() <= parent:
            return None
        return self.node_here(parent)

    def node_here(self, parent: int) -> object:
        """The node that starts at the cursor (at the start of its line or
        after a sequence entry's dash), inside a block indented at
        ``parent``."""
        c = self.col()
        if self.is_seq_entry():
            return self.block_sequence(c)
        key_end = self.key_ahead()
        if key_end is not None:
            return self.block_mapping(c)
        return self.inline_value(parent)

    def explicit_key_here(self) -> bool:
        return self.ch() == "?" and self.ch(1) in " \t\n"

    def key_ahead(self) -> int | None:
        """The index of the ``:`` after a single-line key that starts at
        the cursor (of the ``?`` of an explicit key), or None when no key
        starts here."""
        s, i = self.s, self.i
        if self.explicit_key_here():
            return i
        c = s[i]
        if c in "[{":
            save = self.i
            self.flow_node()
            self.skip_inline_space()
            is_key = self.ch() == ":" and self.ch(1) in " \t\n"
            self.i = save
            if is_key:
                self.fail("collections as keys are not supported")
            return None
        if c in "'\"":
            save = self.i
            self.quoted()
            self.skip_inline_space()
            j = self.i if self.ch() == ":" and self.ch(1) in " \t\n" \
                else None
            self.i = save
            return j
        self.check_plain_start(i)
        j = i
        while s[j] != "\n":
            if s[j] == ":" and s[j + 1] in " \t\n":
                return j
            if s[j] == "#" and s[j - 1] in " \t":
                return None
            j += 1
        return None

    def check_plain_start(self, i: int) -> None:
        c = self.s[i]
        if c in "&*":
            self.fail("anchors and aliases are not supported", i)
        if c == "!":
            self.fail("tags are not supported", i)
        if c in "|>":
            self.fail("block scalars ('|', '>') are not supported", i)
        if c in "%@`":
            self.fail(f"a plain scalar cannot start with {c!r}", i)

    def block_mapping(self, c: int) -> dict:
        out: dict = {}
        while True:
            if self.explicit_key_here():
                self.i += 1
                key = self.explicit_key(c)
                self.skip_to_content()
                value = None  # an explicit key may have no value line
                if not self.at_end() and not self.doc_marker() and \
                        self.col() == c and self.ch() == ":" and \
                        self.ch(1) in " \t\n":
                    value = self.mapping_value(c, compact=True)
            else:
                key = self.mapping_key()
                value = self.mapping_value(c)
            out[key] = value
            self.skip_to_content()
            if self.at_end() or self.doc_marker() or self.col() < c:
                return out
            if self.col() > c:
                self.fail("bad indentation of a mapping entry")
            if self.is_seq_entry():
                self.fail("a sequence entry where a mapping key belongs")
            if self.key_ahead() is None:
                self.fail("expected a mapping key ('key: value')")

    def mapping_value(self, c: int, compact: bool = False) -> object:
        """The value after a key's ``:`` (at the cursor) of a mapping
        at column ``c``; after an explicit key's ``:`` a block sequence
        or mapping may start on the same line (``compact``)."""
        self.i += 1
        self.skip_inline_space()
        if not self.line_rest_empty():
            return self.node_here(c) if compact else self.inline_value(c)
        self.skip_to_content()
        if not self.at_end() and not self.doc_marker() and \
                self.col() == c and self.is_seq_entry():
            return self.block_sequence(c)  # at the key's own indent
        return self.block(c)

    def explicit_key(self, c: int) -> object:
        """The scalar after a ``?`` (at the cursor's line or below)."""
        self.skip_inline_space()
        start = self.i
        if self.line_rest_empty():
            key = self.block(c)
        else:
            key = self.inline_value(c)
        self.check_key(key, start)
        return key

    def check_key(self, key, i: int) -> None:
        if isinstance(key, (list, dict)):
            self.fail("collections as keys are not supported", i)
        if key == "<<":
            self.fail("the merge key '<<' is not supported", i)

    def mapping_key(self) -> object:
        if self.ch() in "'\"":
            key = self.quoted()
            self.skip_inline_space()
        else:
            start = self.i
            while not (self.ch() == ":" and self.ch(1) in " \t\n"):
                self.i += 1
            key = self.plain_text(self.s[start:self.i].rstrip(" \t"),
                                  start)
        if self.ch() != ":":
            self.fail("expected ':' after a mapping key")
        self.check_key(key, self.i)
        return key

    def block_sequence(self, c: int) -> list:
        out = []
        while True:
            self.i += 1  # the '-'
            self.skip_inline_space()
            if self.line_rest_empty():
                out.append(self.block(c))
            else:
                out.append(self.node_here(c))
            self.skip_to_content()
            if self.at_end() or self.doc_marker() or self.col() < c:
                return out
            if self.col() > c:
                self.fail("bad indentation of a sequence entry")
            if not self.is_seq_entry():
                return out  # the mapping this sequence is a value of

    def inline_value(self, parent: int) -> object:
        """A scalar or flow collection that starts on this line, with
        nothing after it on its last line but a comment."""
        c = self.ch()
        if c in "[{":
            value = self.flow_node()
        elif c in "'\"":
            value = self.quoted()
        else:
            if self.is_seq_entry():
                self.fail("a sequence entry is not allowed here")
            self.check_plain_start(self.i)
            return self.plain_block(parent)
        self.skip_inline_space()
        if self.ch() == ":" and self.ch(1) in " \t\n":
            self.fail("mapping values are not allowed here")
        if not self.line_rest_empty():
            self.fail(f"unexpected {self.ch()!r} after a value")
        return value

    # -- plain scalars -------------------------------------------------------

    def plain_text(self, text: str, start: int) -> object:
        if text and text[0] in _INDICATORS and not (
                text[0] in "-?:" and len(text) > 1 and text[1] not in " \t"):
            self.fail(f"a plain scalar cannot start with {text[0]!r}", start)
        if _TIMESTAMP.match(text):
            self.fail(f"dates are not supported ({text!r})", start)
        if text == "=":
            self.fail("the value key '=' is not supported", start)
        return _resolve(text)

    def plain_block(self, parent: int) -> object:
        """A plain scalar in block context: it runs to a comment or the
        line's end and folds in the following lines indented deeper than
        ``parent``."""
        start = self.i
        lines = [self.plain_line(flow=False)]
        while True:
            save = self.i
            breaks = self.take_breaks()  # to the next line's content
            if breaks is None or self.at_end() or self.col() <= parent or \
                    self.comment_at(self.i) or self.doc_marker():
                self.i = save
                break
            lines.append(self.fold(breaks))
            lines.append(self.plain_line(flow=False))
        return self.plain_text("".join(lines), start)

    def plain_line(self, flow: bool) -> str:
        """A plain scalar's text on this line, up to a comment, the line's
        end, ``: `` (which raises outside a key) or, in flow context, a
        flow indicator; trailing spaces dropped."""
        s = self.s
        start = self.i
        while True:
            c = s[self.i]
            if c == "\n" or (c == "#" and s[self.i - 1] in " \t"):
                break
            if c == ":" and (s[self.i + 1] in " \t\n" or flow and
                             s[self.i + 1] in _FLOW_INDICATORS):
                if flow:
                    break
                self.fail("mapping values are not allowed here")
            if flow and c in _FLOW_INDICATORS:
                break
            self.i += 1
        text = s[start:self.i]
        stripped = text.rstrip(" \t")
        self.i = start + len(stripped)
        return stripped

    # -- quoted scalars ------------------------------------------------------

    def quoted(self) -> str:
        s = self.s
        q = s[self.i]
        start = self.i
        self.i += 1
        out: list[str] = []
        while True:
            c = s[self.i] if self.i < len(s) else ""
            if c == "":
                self.fail("unterminated quoted scalar", start)
            if c == q:
                if q == "'" and self.ch(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if c == "\\" and q == '"':
                self.i += 1
                e = self.ch()
                if e == "\n":  # an escaped break folds to nothing
                    breaks = self.quoted_breaks(start)
                    out.append("".join(breaks[1:]))
                elif e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 1
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = s[self.i + 1:self.i + 1 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.i += 1 + n
                else:
                    self.fail(f"unknown escape \\{e}")
                continue
            if c in " \t":
                j = self.i
                while s[j] in " \t":
                    j += 1
                if s[j] == "\n":  # spaces before a break are dropped
                    self.i = j
                    continue
                out.append(s[self.i:j])
                self.i = j
                continue
            if c == "\n":
                out.append(self.fold(self.quoted_breaks(start)))
                continue
            out.append(c)
            self.i += 1

    def quoted_breaks(self, start: int) -> list[str]:
        """The line breaks at the cursor inside a quoted scalar, and the
        next line's indentation; the scalar must go on."""
        j = self.i
        breaks = self.take_breaks()
        for k in range(j, self.i):
            if self.s[k] == "\n" and self.s[k + 1:k + 4] in ("---", "...") \
                    and self.s[k + 4] in " \t\n":
                self.fail("a document marker inside a quoted scalar", k + 1)
        if self.at_end():
            self.fail("unterminated quoted scalar", start)
        return breaks

    # -- flow collections ----------------------------------------------------

    def flow_skip(self) -> None:
        self.skip_to_content()
        if self.at_end():
            self.fail("unterminated flow collection")

    def flow_node(self) -> object:
        c = self.ch()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        if c in "'\"":
            return self.quoted()
        if c in "]},":
            self.fail(f"unexpected {c!r}")
        self.check_plain_start(self.i)
        return self.plain_flow()

    def plain_flow(self) -> object:
        start = self.i
        lines = [self.plain_line(flow=True)]
        while self.ch() == "\n" or self.ch() in " \t":
            save = self.i
            breaks = self.take_breaks()
            c = self.ch()
            if breaks is None or c in _FLOW_INDICATORS or c == ":" or \
                    self.at_end() or self.comment_at(self.i):
                self.i = save
                break
            lines.append(self.fold(breaks))
            lines.append(self.plain_line(flow=True))
        return self.plain_text("".join(lines), start)

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.flow_skip()
            if self.ch() == "]":
                self.i += 1
                return out
            out.append(self.flow_node())
            self.flow_skip()
            if self.ch() == ":":
                self.fail("single-pair mappings in a flow sequence are "
                          "not supported")
            if self.ch() == ",":
                self.i += 1
            elif self.ch() != "]":
                self.fail(f"expected ',' or ']', found {self.ch()!r}")

    def flow_mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.flow_skip()
            if self.ch() == "}":
                self.i += 1
                return out
            if self.explicit_key_here():
                self.i += 1
                self.flow_skip()
            start = self.i
            key = self.flow_node()
            self.check_key(key, start)
            self.flow_skip()
            value = None
            if self.ch() == ":":
                self.i += 1
                self.flow_skip()
                if self.ch() not in ",}":
                    value = self.flow_node()
                    self.flow_skip()
            out[key] = value
            if self.ch() == ",":
                self.i += 1
            elif self.ch() != "}":
                self.fail(f"expected ',' or '}}', found {self.ch()!r}")
