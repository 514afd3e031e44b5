"""A YAML reader for WDL parameter files on the standard library alone.

It reads the part of YAML 1.1 that parameter studies are written in and
gives the value ``yaml.safe_load`` (PyYAML) gives for it:

* block mappings and sequences, a sequence also at its key's
  indentation, and the compact forms ``- key: value`` and ``- - item``;
* flow sequences ``[...]`` and mappings ``{...}`` over any number of
  lines (a ``key: value`` entry of a flow sequence is a one-pair
  mapping, as in YAML);
* plain, single-quoted and double-quoted scalars, folded over lines as
  YAML folds them, with every escape of double quotes;
* ``|`` and ``>`` block scalars with their chomping (``-``/``+``) and
  indentation indicators;
* comments, ``#`` inside quotes and after a value included;
* every line break YAML knows (``\\r\\n``, ``\\r``, ``\\x85``, ``\\u2028``,
  ``\\u2029``) and a leading byte order mark.

Plain scalars resolve by the YAML 1.1 rules of the safe loader:
``1e-3`` stays a string (a float needs a dot), ``1.0e-3`` is 0.001,
``1:30`` is 90 (base 60), ``010`` is 8, ``0o10`` a string, ``0x1F`` 31,
``1_000`` 1000, ``yes``/``On`` True, ``~`` None, ``.inf`` a float and
``2018-01-01`` a :class:`datetime.date`.

What lies outside that part is refused with :class:`YAMLError` naming the
line, never read some other way: anchors, aliases, tags, merge keys,
directives, document markers (so any second document), complex (``?``)
keys, empty keys, and tabs where YAML reads structure (PyYAML refuses
those too).  The reader works as PyYAML's scanner does where the two
could differ (the folding of lines, the end of a plain scalar, the
indentation of a block scalar), so a document it accepts reads the same.
"""
from __future__ import annotations

import bisect
import datetime
import re
from typing import Any

#: line breaks once "\r\n", "\r" and "\x85" are read as "\n" (which is what
#: YAML makes of them); the other two stay themselves in a folded value
_BREAKS = "\n\u2028\u2029"
_END = " \t\0" + _BREAKS       # what may follow a block indicator ("- ", ": ")
_EOL = "\0" + _BREAKS
_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010FFFF]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0A", "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B",
            " ": "\x20", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xA0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_MAX_KEY = 1024               # a simple key ends within this many characters


class YAMLError(ValueError):
    """A document the reader does not read, with its 1-based line."""

    def __init__(self, message: str, line: int | None = None) -> None:
        super().__init__(f"line {line}: {message}" if line else message)
        self.message = message
        self.line = line


class Node:
    """A scalar (``value`` its text), a sequence (a list of nodes) or a
    mapping (a list of (key, value) node pairs); ``line`` is 0-based."""
    __slots__ = ("kind", "value", "line", "plain")

    def __init__(self, kind: str, value: Any, line: int, plain: bool = False):
        self.kind, self.value, self.line, self.plain = kind, value, line, plain


class _Reader:
    def __init__(self, text: str) -> None:
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace("\x85", "\n")
        self.t = text + "\0" * 4      # the end, and room to look past it
        self.i = 1 if text.startswith("\ufeff") else 0
        self.starts = [0] + [m.end() for m in re.finditer("[\n\u2028\u2029]", text)]
        bad = _NON_PRINTABLE.search(text)
        if bad:
            self.fail(f"non-printable character {bad.group()!r}", bad.start())
        self.end = 0          # where the last token ended: the next entry of a
        #                       block collection starts on a later line

    # -- positions -----------------------------------------------------------
    def line(self, i: int | None = None) -> int:
        return bisect.bisect_right(self.starts, self.i if i is None else i) - 1

    def col(self, i: int | None = None) -> int:
        i = self.i if i is None else i
        return i - self.starts[self.line(i)]

    def fail(self, message: str, i: int | None = None):
        raise YAMLError(message, self.line(i) + 1)

    def at_end(self) -> bool:
        return self.t[self.i] == "\0"

    def empty(self) -> Node:
        return Node("scalar", "", self.line(), plain=True)

    # -- whitespace and comments --------------------------------------------
    def spaces(self) -> None:
        """Spaces on this line; a tab where YAML reads structure refuses."""
        t = self.t
        while t[self.i] == " ":
            self.i += 1
        if t[self.i] == "\t":
            self.fail("tab character where YAML reads structure")

    def skip(self) -> None:
        """To the next token: spaces, comments and line breaks."""
        t = self.t
        while True:
            self.spaces()
            if t[self.i] == "#":
                while t[self.i] not in _EOL:
                    self.i += 1
            if t[self.i] not in _BREAKS:
                break
            self.i += 1
        if self.col() == 0:
            head = t[self.i:self.i + 3]
            if head in ("---", "...") and t[self.i + 3] in _END:
                self.fail("document markers are outside the subset "
                          "(one document a file)")
            if t[self.i] == "%":
                self.fail("directives are outside the subset")

    def next_entry(self) -> None:
        """To the token after a block collection's entry, which must stand
        on a later line than the entry's end."""
        self.skip()
        if not self.at_end() and self.line() == self.line(self.end):
            self.fail("unexpected content after a value on its line")

    # -- structure ---------------------------------------------------------------
    def document(self) -> Node | None:
        self.skip()
        if self.at_end():
            return None
        node = self.block_node(-1)
        self.skip()
        if not self.at_end():
            self.fail("content after the document's end (bad indentation?)")
        return node

    def refuse_props(self) -> None:
        ch, nxt = self.t[self.i], self.t[self.i + 1]
        if ch == "&":
            self.fail("anchors are outside the subset")
        if ch == "*":
            self.fail("aliases are outside the subset")
        if ch == "!":
            self.fail("tags are outside the subset")
        if ch == "?" and nxt in _END:
            self.fail("complex (?) keys are outside the subset")

    def block_node(self, indent: int, inline: bool = False) -> Node:
        """The node at the cursor, inside a block collection at column
        ``indent``; ``inline``: the value on its key's line, which can
        start no block collection."""
        t = self.t
        ch, nxt = t[self.i], t[self.i + 1]
        if ch == "-" and nxt in _END:
            if inline:
                self.fail("sequence entries are not allowed here")
            return self.block_seq(self.col())
        self.refuse_props()
        if ch in "|>":
            return self.block_scalar(indent)
        start, line0 = self.i, self.line()
        if ch in "[{":
            node = self.flow_node()
        else:
            node = self.scalar(indent, flow=False)
        self.spaces()
        if t[self.i] == ":" and t[self.i + 1] in _END:
            if inline:
                self.fail("mapping values are not allowed here")
            self.check_key(node, start, line0)
            return self.block_map(self.col(start), node)
        return node

    def check_key(self, node: Node, start: int, line0: int) -> None:
        if node.kind != "scalar":
            self.fail("complex (collection) keys are outside the subset", start)
        if self.line() != line0:
            self.fail("an implicit key must stand on one line", start)
        if self.i - start > _MAX_KEY:
            self.fail(f"an implicit key is limited to {_MAX_KEY} characters", start)

    def block_map(self, c: int, key: Node) -> Node:
        pairs = []
        while True:
            self.i += 1                                   # the ':'
            self.end = self.i
            pairs.append((key, self.map_value(c)))
            self.next_entry()
            if self.at_end() or self.col() < c:
                break
            if self.col() > c:
                self.fail("bad indentation of a mapping entry")
            key = self.map_key(c)
        return Node("map", pairs, pairs[0][0].line)

    def map_key(self, c: int) -> Node:
        t = self.t
        ch, nxt = t[self.i], t[self.i + 1]
        if ch == ":" and nxt in _END:
            self.fail("empty keys are outside the subset")
        if ch == "-" and nxt in _END:
            self.fail("a sequence entry where a mapping key was expected")
        self.refuse_props()
        if ch in "[{":
            self.fail("complex (collection) keys are outside the subset")
        if ch in "|>":
            self.fail("a block scalar at its key's indentation is outside the subset")
        start, line0 = self.i, self.line()
        node = self.scalar(c, flow=False)
        self.spaces()
        if not (t[self.i] == ":" and t[self.i + 1] in _END):
            self.fail("could not find the expected ':' after a key", start)
        self.check_key(node, start, line0)
        return node

    def map_value(self, c: int) -> Node:
        t = self.t
        self.spaces()
        if t[self.i] in "#" + _EOL:
            self.skip()
            if self.at_end():
                return self.empty()
            if self.col() > c:
                return self.block_node(c)
            if self.col() == c and t[self.i] == "-" and t[self.i + 1] in _END:
                return self.block_seq(c, indentless=True)
            return self.empty()
        return self.block_node(c, inline=True)

    def block_seq(self, c: int, indentless: bool = False) -> Node:
        t = self.t
        items, line0 = [], self.line()
        while True:
            self.i += 1                                   # the '-'
            self.end = self.i
            self.spaces()
            if t[self.i] in "#" + _EOL:
                self.skip()
                if not self.at_end() and self.col() > c:
                    items.append(self.block_node(c))
                else:
                    items.append(self.empty())
            else:
                items.append(self.block_node(c))
            self.next_entry()
            if self.at_end() or self.col() < c:
                break
            if self.col() > c:
                self.fail("bad indentation of a sequence entry")
            if t[self.i] == "-" and t[self.i + 1] in _END:
                continue
            if indentless:
                break
            self.fail("expected a sequence entry ('- ')")
        return Node("seq", items, line0)

    # -- flow collections ------------------------------------------------------
    def flow_node(self) -> Node:
        t = self.t
        ch = t[self.i]
        if ch == "[":
            return self.flow_seq()
        if ch == "{":
            return self.flow_map()
        self.refuse_props()
        if ch == "?":
            self.fail("complex (?) keys are outside the subset")
        return self.scalar(-1, flow=True)

    def flow_seq(self) -> Node:
        t = self.t
        line0 = self.line()
        self.i += 1
        items = []
        while True:
            self.skip()
            if t[self.i] == "]":
                self.i += 1
                break
            if t[self.i] in ",:":
                self.fail(f"expected a flow sequence entry, found {t[self.i]!r}")
            start, kline = self.i, self.line()
            node = self.flow_node()
            self.skip()
            if t[self.i] == ":":                         # a one-pair mapping
                self.check_key(node, start, kline)
                self.i += 1
                self.skip()
                value = self.empty() if t[self.i] in ",]" else self.flow_node()
                node = Node("map", [(node, value)], kline)
                self.skip()
            items.append(node)
            if t[self.i] == ",":
                self.i += 1
            elif t[self.i] == "]":
                self.i += 1
                break
            else:
                self.fail("expected ',' or ']' in a flow sequence")
        self.end = self.i
        return Node("seq", items, line0)

    def flow_map(self) -> Node:
        t = self.t
        line0 = self.line()
        self.i += 1
        pairs = []
        while True:
            self.skip()
            if t[self.i] == "}":
                self.i += 1
                break
            if t[self.i] in ",:":
                self.fail(f"expected a flow mapping key, found {t[self.i]!r}")
            start, kline = self.i, self.line()
            key = self.flow_node()
            self.skip()
            if t[self.i] == ":":
                self.check_key(key, start, kline)
                self.i += 1
                self.skip()
                value = self.empty() if t[self.i] in ",}" else self.flow_node()
                self.skip()
            else:
                if key.kind != "scalar":
                    self.fail("complex (collection) keys are outside the subset",
                              start)
                value = self.empty()
            pairs.append((key, value))
            if t[self.i] == ",":
                self.i += 1
            elif t[self.i] == "}":
                self.i += 1
                break
            else:
                self.fail("expected ',' or '}' in a flow mapping")
        self.end = self.i
        return Node("map", pairs, line0)

    # -- scalars ------------------------------------------------------------------
    def scalar(self, indent: int, flow: bool) -> Node:
        ch = self.t[self.i]
        if ch in "'\"":
            return self.quoted()
        nxt = self.t[self.i + 1]
        starts_plain = (ch not in _END + "-?:,[]{}#&*!|>'\"%@`"
                        or (nxt not in _END and (ch == "-" or (not flow and ch in "?:"))))
        if not starts_plain:
            self.fail(f"found character {ch!r} that cannot start any token")
        return self.plain(indent, flow)

    def plain(self, indent: int, flow: bool) -> Node:
        """A plain scalar, folded over the lines indented past ``indent``
        (any line inside a flow collection)."""
        t = self.t
        line0 = self.line()
        stop_after_colon = _END + (",[]{}" if flow else "")
        chunks: list[str] = []
        spaces: list[str] = []
        end = self.i
        while t[self.i] != "#":
            n = self.i
            while True:
                ch = t[n]
                if (ch in _END or (ch == ":" and t[n + 1] in stop_after_colon)
                        or (flow and ch in ",?[]{}")):
                    break
                n += 1
            if n == self.i:
                break
            chunks.extend(spaces)
            chunks.append(t[self.i:n])
            self.i = end = n
            spaces = self.plain_spaces()
            if not spaces or t[self.i] == "#" or (not flow and self.col() <= indent):
                break
        self.i = self.end = end     # the spaces and breaks after it are the next skip's
        return Node("scalar", "".join(chunks), line0, plain=True)

    def plain_spaces(self) -> list[str]:
        t = self.t
        n = self.i
        while t[n] == " ":
            n += 1
        whitespace = t[self.i:n]
        self.i = n
        if t[self.i] not in _BREAKS:
            return [whitespace] if whitespace else []
        line_break = t[self.i]
        self.i += 1
        if self.marker():
            return []
        breaks = []
        while t[self.i] in " " + _BREAKS:
            if t[self.i] == " ":
                self.i += 1
            else:
                breaks.append(t[self.i])
                self.i += 1
                if self.marker():
                    return []
        return _folded(line_break, breaks)

    def marker(self) -> bool:
        return self.t[self.i:self.i + 3] in ("---", "...") and self.t[self.i + 3] in _END

    def quoted(self) -> Node:
        t = self.t
        line0 = self.line()
        quote = t[self.i]
        double = quote == '"'
        self.i += 1
        chunks = self.quoted_non_spaces(double)
        while t[self.i] != quote:
            chunks += self.quoted_spaces(double)
            chunks += self.quoted_non_spaces(double)
        self.i += 1
        self.end = self.i
        return Node("scalar", "".join(chunks), line0)

    def quoted_non_spaces(self, double: bool) -> list[str]:
        t = self.t
        chunks = []
        while True:
            n = self.i
            while t[n] not in "'\"\\ \t" + _EOL:
                n += 1
            if n > self.i:
                chunks.append(t[self.i:n])
                self.i = n
            ch = t[self.i]
            if not double and ch == "'" and t[self.i + 1] == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = t[self.i]
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _ESCAPE_CODES:
                    width = _ESCAPE_CODES[ch]
                    self.i += 1
                    digits = t[self.i:self.i + width]
                    if len(digits) != width or any(
                            d not in "0123456789ABCDEFabcdef" for d in digits):
                        self.fail(f"expected {width} hex digits after \\{ch}")
                    chunks.append(chr(int(digits, 16)))
                    self.i += width
                elif ch in _BREAKS:
                    self.i += 1
                    chunks += self.quoted_breaks()
                else:
                    self.fail(f"unknown escape character {ch!r}")
            else:
                return chunks

    def quoted_spaces(self, double: bool) -> list[str]:
        t = self.t
        n = self.i
        while t[n] in " \t":
            n += 1
        whitespace = t[self.i:n]
        self.i = n
        if t[self.i] == "\0":
            self.fail("unexpected end of the document in a quoted scalar")
        if t[self.i] not in _BREAKS:
            return [whitespace]
        line_break = t[self.i]
        self.i += 1
        return _folded(line_break, self.quoted_breaks())

    def quoted_breaks(self) -> list[str]:
        t = self.t
        chunks = []
        while True:
            if self.marker():
                self.fail("a document marker inside a quoted scalar")
            while t[self.i] in " \t":
                self.i += 1
            if t[self.i] not in _BREAKS:
                return chunks
            chunks.append(t[self.i])
            self.i += 1

    def block_scalar(self, indent: int) -> Node:
        """``|`` or ``>``: the lines indented past ``indent`` (at least the
        first content line's indentation), chomped."""
        t = self.t
        line0 = self.line()
        folded = t[self.i] == ">"
        self.i += 1
        chomping, increment = None, None
        for _ in range(2):
            ch = t[self.i]
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
                self.i += 1
            elif ch in "0123456789" and increment is None:
                if ch == "0":
                    self.fail("a block scalar's indentation indicator is 1 to 9")
                increment = int(ch)
                self.i += 1
        if t[self.i] not in " " + _EOL:
            self.fail("expected chomping or indentation indicators")
        while t[self.i] == " ":
            self.i += 1
        if t[self.i] == "#":
            while t[self.i] not in _EOL:
                self.i += 1
        if t[self.i] not in _EOL:
            self.fail("expected a comment or a line break after a block "
                      "scalar's header")
        if t[self.i] in _BREAKS:
            self.i += 1
        min_indent = max(indent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while t[self.i] in " " + _BREAKS:
                if t[self.i] != " ":
                    breaks.append(t[self.i])
                else:
                    max_indent = max(max_indent, self.col() + 1)
                self.i += 1
            ind = max(min_indent, max_indent)
        else:
            ind = min_indent + increment - 1
            breaks = self.block_breaks(ind)
        chunks: list[str] = []
        line_break = ""
        while self.col() == ind and t[self.i] != "\0":
            chunks += breaks
            leading_non_space = t[self.i] not in " \t"
            n = self.i
            while t[n] not in _EOL:
                n += 1
            chunks.append(t[self.i:n])
            self.i = n
            line_break = ""
            if t[self.i] in _BREAKS:
                line_break = t[self.i]
                self.i += 1
            breaks = self.block_breaks(ind)
            if self.col() == ind and t[self.i] != "\0":
                if folded and line_break == "\n" and leading_non_space \
                        and t[self.i] not in " \t":
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks += breaks
        self.end = max(t.rfind(b, 0, self.i) for b in _BREAKS)  # the last break read
        return Node("scalar", "".join(chunks), line0)

    def block_breaks(self, ind: int) -> list[str]:
        t = self.t
        chunks = []
        while self.col() < ind and t[self.i] == " ":
            self.i += 1
        while t[self.i] in _BREAKS:
            chunks.append(t[self.i])
            self.i += 1
            while self.col() < ind and t[self.i] == " ":
                self.i += 1
        return chunks


def _folded(line_break: str, breaks: list[str]) -> list[str]:
    """What a line break and the empty lines after it fold to inside a
    scalar: a space, or the breaks of the empty lines (a break other than
    a newline stays as it is)."""
    if line_break != "\n":
        return [line_break, *breaks]
    return breaks or [" "]


# -- the YAML 1.1 resolution of plain scalars (the safe loader's) --------------
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE = re.compile(r"^(?:=)$")
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
    -(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])
    :(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?
    (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
    (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
# by first character, in the safe loader's order of registration
_RESOLVERS: dict[str, list[tuple[str, re.Pattern]]] = {}
for _tag, _regex, _first in (("bool", _BOOL, "yYnNtTfFoO"),
                             ("float", _FLOAT, "-+0123456789."),
                             ("int", _INT, "-+0123456789"),
                             ("merge", _MERGE, "<"),
                             ("null", _NULL, "~nN"),
                             ("timestamp", _TIMESTAMP, "0123456789"),
                             ("value", _VALUE, "=")):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _regex))


def _tag(text: str) -> str:
    if text == "":
        return "null"
    for tag, regex in _RESOLVERS.get(text[0], ()):
        if regex.match(text):
            return tag
    return "str"


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        total = 0
        for digit in value.split(":"):
            total = total * 60 + int(digit)
        return sign * total
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        parts = [float(p) for p in value.split(":")]
        total, base = 0.0, 1
        for part in reversed(parts):
            total += part * base
            base *= 60
        return sign * total
    return sign * float(value)


def _timestamp(text: str) -> datetime.date:
    v = _TIMESTAMP_PARTS.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                   minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tzinfo)


def _scalar(node: Node, key: bool = False) -> Any:
    if not node.plain:
        return node.value
    tag = _tag(node.value)
    try:
        if tag == "null":
            return None
        if tag == "bool":
            return node.value.lower() in ("yes", "true", "on")
        if tag == "int":
            return _int(node.value)
        if tag == "float":
            return _float(node.value)
        if tag == "timestamp":
            return _timestamp(node.value)
    except ValueError as e:
        raise YAMLError(f"{node.value!r}: {e}", node.line + 1) from None
    if tag == "merge":
        raise YAMLError("merge keys (<<) are outside the subset", node.line + 1)
    if tag == "value" and not key:
        raise YAMLError("'=' (the YAML value tag) has no value", node.line + 1)
    return node.value


def construct(node: Node | None) -> Any:
    """The Python value of a node tree, as the safe loader builds it."""
    if node is None:
        return None
    if node.kind == "scalar":
        return _scalar(node)
    if node.kind == "seq":
        return [construct(item) for item in node.value]
    out: dict[Any, Any] = {}
    for knode, vnode in node.value:
        out[_scalar(knode, key=True)] = construct(vnode)
    return out


def compose(text: str) -> Node | None:
    """The node tree of ``text`` (None for an empty document)."""
    return _Reader(text).document()


def safe_load(text: str) -> Any:
    """``yaml.safe_load(text)`` for the subset; raises :class:`YAMLError`
    on anything outside it."""
    return construct(compose(text))
