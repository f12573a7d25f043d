"""A reader and a writer for the YAML that the scene files use, for hosts
without PyYAML (``config.load_config`` and ``config.dump_config`` use
PyYAML when it is importable, and these otherwise).

:func:`load` gives the object that ``yaml.safe_load`` gives for this
subset: block mappings and block sequences (a sequence may sit at its
key's indent or deeper; ``- key: value`` opens a mapping inside an item),
flow lists and flow mappings over any number of lines with trailing
commas, plain, single- and double-quoted scalars, ``#`` comments and a
leading ``---``.  Plain scalars resolve as PyYAML's YAML 1.1 resolver
resolves them: null (``~``, ``null``, empty), booleans (``true``, ``yes``,
``on`` and their opposites), decimal ints and floats (a float needs a
dot, so ``1e-3`` stays a string), ``.inf`` and ``.nan``.  What PyYAML
would read otherwise (octal, hex, binary and sexagesimal numbers,
timestamps, anchors, aliases, tags, block scalars, a second document) is
not in the subset and raises ``ValueError`` rather than being read
differently.

:func:`dump` writes nested dicts, lists and scalars as block YAML (lists
of scalars and lists in flow style) that :func:`load` and PyYAML read back
unchanged.
"""

from __future__ import annotations

import json
import math
import re

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# Forms that PyYAML resolves to other types or values, outside the subset.
_OTHER = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$"
)
_PLAIN_SAFE = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*$")


def _resolve(text: str, where: str):
    """A plain scalar's value, as PyYAML's resolver reads it."""
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER.match(text):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset")
    return text


def _quoted(s: str, i: int, where: str) -> tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index past it)."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == "'" and s[j] == "'":
            if s[j + 1:j + 2] == "'":
                j += 2
                continue
            return s[i + 1:j].replace("''", "'"), j + 1
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if q == '"' and s[j] == '"':
            try:
                return json.loads(s[i:j + 1]), j + 1
            except json.JSONDecodeError as e:
                raise ValueError(f"{where}: escape outside the YAML subset in {s[i:j + 1]}") from e
        j += 1
    raise ValueError(f"{where}: unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a # at the start or after a space,
    outside quotes."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            try:
                i = _quoted(line, i, "line")[1]
            except ValueError:  # a quote that is not closed on this line
                return line
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _depth(text: str) -> int:
    """Open flow brackets left at the end of ``text`` (quotes skipped)."""
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            i = _quoted(text, i, "line")[1]
            continue
        depth += (c in "[{") - (c in "]}")
        i += 1
    return depth


class _Flow:
    """Recursive descent over one flow collection (or scalar) in ``s``."""

    def __init__(self, s: str, where: str) -> None:
        self.s, self.i, self.where = s, 0, where

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _expect(self, chars: str) -> str:
        self._ws()
        c = self.s[self.i:self.i + 1]
        if not c or c not in chars:
            raise ValueError(f"{self.where}: expected one of {chars!r} at {self.s[self.i:]!r}")
        self.i += 1
        return c

    def _plain(self, stops: str) -> str:
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            if self.s[self.i] == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", ",", "]", "}"):
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def value(self):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            self.i += 1
            out = []
            while True:
                self._ws()
                if self.s[self.i:self.i + 1] == "]":
                    self.i += 1
                    return out
                out.append(self.value())
                if self._expect(",]") == "]":
                    return out
        if c == "{":
            self.i += 1
            out = {}
            while True:
                self._ws()
                if self.s[self.i:self.i + 1] == "}":
                    self.i += 1
                    return out
                key = self.value()
                self._expect(":")
                self._ws()
                out[key] = None if self.s[self.i:self.i + 1] in (",", "}") else self.value()
                if self._expect(",}") == "}":
                    return out
        if c in ("'", '"'):
            v, self.i = _quoted(self.s, self.i, self.where)
            return v
        return _resolve(self._plain(",]}"), self.where)

    def whole(self):
        v = self.value()
        self._ws()
        if self.i != len(self.s):
            raise ValueError(f"{self.where}: trailing text {self.s[self.i:]!r}")
        return v


def _node(text: str, where: str):
    """A value written on one logical line: flow, quoted or plain."""
    if text[:1] in ("[", "{", "'", '"'):
        return _Flow(text, where).whole()
    return _resolve(text, where)


def _split_key(text: str, where: str):
    """(key, rest) of a ``key: rest`` line, or None if it is no mapping entry."""
    if text[:1] in ("'", '"'):
        key, j = _quoted(text, 0, where)
        rest = text[j:].lstrip()
        if rest[:1] != ":" or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    if text[:1] in ("[", "{"):
        return None
    m = re.search(r":(?: |$)", text)
    if not m:
        return None
    return _resolve(text[:m.start()].strip(), where), text[m.end():].strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Lines:
    """Logical lines: (indent, text, line number), comments stripped, blank
    lines dropped and a flow collection's continuation lines joined."""

    def __init__(self, text: str) -> None:
        self.rows: list[list] = []
        open_depth = 0
        for no, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            lead = body[:len(body) - len(body.lstrip())]
            if "\t" in lead:
                raise ValueError(f"line {no}: a tab in the indentation")
            if open_depth:
                self.rows[-1][1] += " " + body.strip()
            else:
                if body.strip() in ("---", "..."):
                    if self.rows:
                        raise ValueError(f"line {no}: a second document is outside the YAML subset")
                    continue
                self.rows.append([len(lead), body.strip(), no])
            open_depth = _depth(self.rows[-1][1])
            if open_depth < 0:
                raise ValueError(f"line {no}: unbalanced ']' or '}}'")
        if open_depth:
            raise ValueError("unterminated flow collection at the end of the text")


def _block(rows, i: int, indent: int):
    """The block node whose first line is rows[i] (at ``indent``)."""
    if _is_item(rows[i][1]):
        return _sequence(rows, i, indent)
    return _mapping(rows, i, indent)


def _mapping(rows, i: int, indent: int):
    out = {}
    while i < len(rows) and rows[i][0] == indent and not _is_item(rows[i][1]):
        where = f"line {rows[i][2]}"
        kv = _split_key(rows[i][1], where)
        if kv is None:
            raise ValueError(f"{where}: expected 'key: value', got {rows[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _node(rest, where)
        elif i < len(rows) and (rows[i][0] > indent or (rows[i][0] == indent and _is_item(rows[i][1]))):
            out[key], i = _block(rows, i, rows[i][0])
        else:
            out[key] = None
    if i < len(rows) and rows[i][0] > indent:
        raise ValueError(f"line {rows[i][2]}: unexpected indentation")
    return out, i


def _sequence(rows, i: int, indent: int):
    out = []
    while i < len(rows) and rows[i][0] == indent and _is_item(rows[i][1]):
        where = f"line {rows[i][2]}"
        rest = rows[i][1][1:].lstrip()
        if not rest:
            i += 1
            if i < len(rows) and rows[i][0] > indent:
                value, i = _block(rows, i, rows[i][0])
            else:
                value = None
        elif _is_item(rest) or _split_key(rest, where) is not None:
            # "- key: v" (or "- - v") opens a node at the column of its text.
            col = indent + len(rows[i][1]) - len(rest)
            rows[i] = [col, rest, rows[i][2]]
            value, i = _block(rows, i, col)
        else:
            value = _node(rest, where)
            i += 1
        out.append(value)
    return out, i


def load(text: str):
    """The object ``yaml.safe_load(text)`` gives, for the subset above."""
    rows = _Lines(text).rows
    if not rows:
        return None
    if len(rows) == 1 and rows[0][0] == 0 and not _is_item(rows[0][1]) \
            and _split_key(rows[0][1], "line 1") is None:
        return _node(rows[0][1], f"line {rows[0][2]}")
    value, i = _block(rows, 0, rows[0][0])
    if i != len(rows):
        raise ValueError(f"line {rows[i][2]}: unexpected indentation")
    return value


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:  # 1e-05 -> 1.0e-05: a float needs a dot
            mantissa, exp = r.split("e")
            r = f"{mantissa}.0e{exp}"
        return r
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and _resolve(v, "dump") == v:
            return v
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _has_block(v) -> bool:
    """Whether ``v`` is written as a block (a non-empty mapping, or a list
    holding one)."""
    if isinstance(v, dict):
        return bool(v)
    return isinstance(v, (list, tuple)) and any(_has_block(x) for x in v)


def _dump(v, indent: int):
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            if _has_block(x):
                yield f"{pad}{_scalar(k)}:\n"
                yield from _dump(x, indent + 2)
            else:
                yield f"{pad}{_scalar(k)}: {_flow(x)}\n"
    else:
        for x in v:
            if _has_block(x):
                lines = list(_dump(x, indent + 2))
                yield f"{pad}- {lines[0][indent + 2:]}"
                yield from lines[1:]
            else:
                yield f"{pad}- {_flow(x)}\n"


def dump(data) -> str:
    """``data`` (nested dicts, lists and scalars) as YAML text that
    :func:`load` reads back unchanged."""
    if not _has_block(data):
        return _flow(data) + "\n"
    return "".join(_dump(data, 0))
