"""A reader for the YAML subset that ``experiments/conf/*.yaml`` uses.

The machine with the card has no YAML parser, so the port reads its configs
with this one. It reads:

- block mappings, nested by indentation (spaces only);
- ``#`` comments, whole-line or after a value;
- flow lists ``[a, b, ...]`` of scalars, on one line;
- scalars typed as ``yaml.safe_load`` types them (YAML 1.1): decimal ints,
  floats with a dot (``80.0``, ``80.``, ``1.0e-3``; ``1e-3`` has no dot and is
  the string ``"1e-3"`` there too), ``.inf``/``.nan``, the booleans
  ``true/false/yes/no/on/off`` in their three spellings, ``null``/``~``/empty,
  plain, single- and double-quoted strings; ``${...}`` stays a string.

Anything else raises ``ValueError`` with the line number: anchors and
aliases, tags, block scalars, flow mappings, block sequences, tabs,
multi-line scalars, document markers, and the scalar forms that
``yaml.safe_load`` would read as something this reader does not produce
(octal, hex, binary and sexagesimal numbers, underscores in numbers, dates).
It raises rather than guess, so a config it reads is a config it read right.
"""

from __future__ import annotations

import re
from typing import Any, Optional

_BOOLS = {
    **dict.fromkeys(("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"), True),
    **dict.fromkeys(("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"), False),
}
_NULLS = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# what yaml.safe_load reads as a number or a date in forms this reader does
# not produce: PyYAML's int and float resolvers (underscores, octal, hex,
# binary, sexagesimal) and the start of its timestamp resolver
_OTHER_NUMBER = re.compile(
    r"[-+]?0b[01_]+\Z|[-+]?0[0-7_]+\Z|[-+]?(?:0|[1-9][0-9_]*)\Z|[-+]?0x[0-9a-fA-F_]+\Z"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+\Z"
    r"|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?\Z|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?\Z"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*\Z|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}"
)
_KEY = re.compile(r"([A-Za-z0-9_][A-Za-z0-9_.\-]*)[ ]*:(?:[ ]+(.*))?\Z")
# characters that cannot start a plain scalar (YAML indicators), with what
# they would start
_INDICATORS = {
    "&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar", ">": "a block scalar",
    "{": "a flow mapping", "%": "a directive", "@": "a reserved indicator", "`": "a reserved indicator",
    "?": "a complex key", "-": "a block sequence", ",": "a flow indicator", "]": "a flow indicator",
    "}": "a flow indicator", ":": "a mapping indicator", "#": "a comment",
}
_ESCAPES = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}


def _error(lineno: int, msg: str) -> ValueError:
    return ValueError(f"line {lineno}: {msg}" if lineno else msg)


def resolve_scalar(text: str, lineno: int = 0) -> Any:
    """A plain (unquoted) scalar, typed as ``yaml.safe_load`` types it."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _OTHER_NUMBER.match(text) or text in ("<<", "="):
        raise _error(lineno, f"{text!r} is a YAML 1.1 form this reader does not read")
    return text


def _plain(text: str, lineno: int, flow: bool) -> Any:
    """A plain scalar from ``text`` (comment already removed)."""
    text = text.strip()
    if text[:1] in _INDICATORS and not (text[:1] in "-?:" and len(text) > 1 and text[1] != " "):
        raise _error(lineno, f"{text!r} starts {_INDICATORS[text[0]]}, which this reader does not read")
    if ": " in text or text.endswith(":"):
        raise _error(lineno, f"{text!r}: a mapping inside a value")
    if flow and re.search(r"[\[\]{}]", text):
        raise _error(lineno, f"{text!r}: nested flow collections are not read")
    return resolve_scalar(text, lineno)


def _quoted(text: str, lineno: int) -> tuple[str, str]:
    """(the string of the quoted scalar at the start of ``text``, the rest)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1 :]
        if quote == '"' and c == "\\":
            esc = text[i + 1 : i + 2]
            if esc not in _ESCAPES:
                raise _error(lineno, f"escape \\{esc} is not read")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), text[i + 1 :]
        out.append(c)
        i += 1
    raise _error(lineno, "unterminated quoted scalar (multi-line scalars are not read)")


def _strip_comment(rest: str, lineno: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise _error(lineno, f"unexpected {rest!r} after a quoted scalar")


def _flow_list(text: str, lineno: int) -> list:
    items: list = []
    body = text[1:]
    expect_item = True
    while True:
        body = body.lstrip(" ")
        if not body:
            raise _error(lineno, "unterminated flow list (multi-line flow lists are not read)")
        if body[0] == "]":
            _strip_comment(body[1:], lineno)
            return items
        if not expect_item:
            if body[0] != ",":
                raise _error(lineno, f"expected ',' or ']' in a flow list at {body!r}")
            body = body[1:]
            expect_item = True
            continue
        if body[0] in "'\"":
            value, body = _quoted(body, lineno)
        else:
            m = re.match(r"[^,\]]*", body)
            raw = m.group(0)
            if " #" in raw:
                raise _error(lineno, "comment inside a flow list")
            value, body = _plain(raw, lineno, flow=True), body[m.end():]
        items.append(value)
        expect_item = False


def _value(text: str, lineno: int) -> Any:
    """The value after ``key:`` (or a whole override), comment included."""
    text = text.strip()
    if text.startswith("["):
        return _flow_list(text, lineno)
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        _strip_comment(rest, lineno)
        return value
    m = re.search(r"(^|\s)#", text)
    if m:
        text = text[: m.start()]
    return _plain(text, lineno, flow=False)


def parse_value(raw: str) -> Any:
    """One override value, as ``yaml.safe_load(raw)`` reads it: a scalar or
    a flow list of scalars."""
    if "\n" in raw or "\t" in raw:
        raise ValueError(f"override value {raw!r}: newlines and tabs are not read")
    return _value(raw, 0)


def loads(text: str) -> Optional[dict]:
    """The mapping that ``yaml.safe_load(text)`` gives for a config in the
    subset (None for a file of comments only); ``ValueError`` naming the line
    for anything outside it."""
    lines = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if "\t" in line:
            raise _error(lineno, "tab character (indentation and values use spaces only)")
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise _error(lineno, "document markers and directives are not read")
        lines.append((lineno, len(line) - len(line.lstrip(" ")), stripped))
    if not lines:
        return None
    root, pos = _mapping(lines, 0, lines[0][1])
    if pos != len(lines):
        lineno = lines[pos][0]
        raise _error(lineno, "indentation does not match any enclosing mapping")
    return root


def _mapping(lines: list, pos: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while pos < len(lines):
        lineno, ind, text = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise _error(lineno, "unexpected indentation (multi-line scalars are not read)")
        m = _KEY.match(text)
        if not m:
            what = "a block sequence" if text.startswith("-") else f"{text!r}"
            raise _error(lineno, f"{what} is not a 'key: value' line this reader reads")
        key, rest = m.group(1), m.group(2)
        key = resolve_scalar(key, lineno)
        pos += 1
        if rest is None or not rest.strip() or rest.startswith("#"):
            if pos < len(lines) and lines[pos][1] > indent:
                out[key], pos = _mapping(lines, pos, lines[pos][1])
            else:
                out[key] = None
        else:
            out[key] = _value(rest, lineno)
    return out, pos
