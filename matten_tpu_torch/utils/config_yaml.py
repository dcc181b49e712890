"""A reader for the YAML subset of the train scripts' config files.

pyyaml is not on the GPU machine; `load_config(path)` reads what the files
in `scripts/configs/` use and gives what `yaml.safe_load` gives for them:

- block mappings nested by indentation, and block lists (of mappings, as
  `callbacks`, or of scalars), also at their key's own indentation;
- plain, single-quoted and double-quoted scalars; comments;
- the YAML 1.1 scalars as pyyaml resolves them: null (`~`, `null`, empty),
  booleans (`true`/`false`, `yes`/`no`, `on`/`off`), ints (decimal, `0x`,
  `0b`, `0`-octal, `_` separators), floats only with a dot (`0.` and
  `0.00001` are floats; `1e-5` has no dot and stays a string; an exponent
  needs its sign), `.inf` and `.nan`;
- the empty flow collections `[]` and `{}`.

Anything else raises `ValueError` naming the line: anchors and aliases,
tags, block scalars (`|`, `>`), other flow collections, multi-line plain
scalars, directives and document markers, base-60 numbers and timestamps,
escapes in double quotes but those of a backslash, a double quote, a
newline and a tab, and tabs in the indentation.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

__all__ = ["load_config", "loads"]

# pyyaml's implicit resolvers (resolver.py, YAML 1.1)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_TIMESTAMP = re.compile(
    r"^(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?|[0-9]{4}-[0-9]{2}-[0-9]{2})$"
)
_TRUE = {"yes", "true", "on"}
_ESCAPES = {"t": "\t", "n": "\n", '"': '"', "\\": "\\"}
# characters that begin a YAML construct the subset does not cover
_UNSUPPORTED_START = "&*!|>%@`{[?"


class _Line:
    __slots__ = ("indent", "text", "number")

    def __init__(self, indent: int, text: str, number: int):
        self.indent, self.text, self.number = indent, text, number


def _fail(line: _Line, what: str) -> ValueError:
    return ValueError(f"config line {line.number}: {what} (outside the YAML subset this reader takes)")


def _resolve(plain: str, line: _Line) -> Any:
    """A plain scalar as pyyaml's SafeLoader constructs it."""
    if _TIMESTAMP.match(plain) or ((_INT.match(plain) or _FLOAT.match(plain)) and ":" in plain):
        raise _fail(line, f"the timestamp or base-60 number {plain!r}")
    if _NULL.match(plain):
        return None
    if _BOOL.match(plain):
        return plain.lower() in _TRUE
    if _INT.match(plain):
        v = plain.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(plain):
        v = plain.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    return plain


def _quoted(text: str, line: _Line) -> Tuple[str, str]:
    """(the value of the quoted scalar that starts `text`, the rest)."""
    q, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if text[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), text[i + 1 :]
        elif c == '"':
            return "".join(out), text[i + 1 :]
        elif c == "\\":
            esc = text[i + 1 : i + 2]
            if esc not in _ESCAPES:
                raise _fail(line, f"the escape \\{esc}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise _fail(line, "a quoted scalar that does not close on its line")


def _comment_start(text: str) -> int:
    """Index of a comment in a plain-scalar text, or len(text)."""
    if text.startswith("#"):
        return 0
    m = re.search(r"[ \t]#", text)
    return m.start() if m else len(text)


def _scalar(text: str, line: _Line) -> Any:
    """The value of a scalar text (comment included) on one line."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, line)
        rest = rest.strip()
        if rest and not rest.startswith("#"):
            raise _fail(line, f"text after a quoted scalar: {rest!r}")
        return value
    text = text[: _comment_start(text)].rstrip()
    if text in ("[]", "{}"):
        return [] if text == "[]" else {}
    if text[:1] and text[0] in _UNSUPPORTED_START:
        raise _fail(line, f"{text!r}: anchors, aliases, tags, block scalars and flow collections")
    if text.startswith("- ") or text == "-":
        raise _fail(line, "a block sequence where a scalar belongs")
    if re.search(r":(?:\s|$)", text):
        raise _fail(line, f"a mapping value inside the plain scalar {text!r}")
    return _resolve(text, line)


def _split_key(text: str, line: _Line):
    """(key, rest) if `text` is a mapping entry, else None."""
    if text[:1] in ("'", '"'):
        key, rest = _quoted(text, line)
        rest = rest.lstrip(" ")
        if rest == ":" or rest.startswith((": ", ":\t")):
            return key, rest[1:]
        return None
    head = text[: _comment_start(text)]
    m = re.search(r":(?:[ \t]|$)", head)
    if m is None:
        return None
    key = head[: m.start()].rstrip()
    if key[:1] and key[0] in _UNSUPPORTED_START + "-#":
        raise _fail(line, f"the key {key!r}")
    if key == "<<":
        raise _fail(line, "a merge key")
    return _resolve(key, line), text[m.end() :]


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Parser:
    def __init__(self, source: str):
        self.lines: List[_Line] = []
        for number, raw in enumerate(source.splitlines(), 1):
            body = raw.lstrip(" ")
            line = _Line(len(raw) - len(body), body.rstrip(), number)
            if body.startswith("\t"):
                raise _fail(line, "a tab in the indentation")
            if not line.text or line.text.startswith("#"):
                continue
            if line.indent == 0 and line.text.startswith(("---", "...", "%")):
                raise _fail(line, "directives and document markers")
            self.lines.append(line)
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def document(self) -> Any:
        first = self.peek()
        if first is None:
            return None
        value = self.block(first.indent)
        extra = self.peek()
        if extra is not None:
            raise _fail(extra, "indentation that closes no block")
        return value

    def block(self, indent: int) -> Any:
        line = self.peek()
        if _is_item(line.text):
            return self.sequence(indent)
        if _split_key(line.text, line) is not None:
            return self.mapping(indent)
        self.i += 1
        value = _scalar(line.text, line)
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise _fail(nxt, "a plain scalar over more than one line")
        return value

    def nested(self, indent: int, allow_same_indent_list: bool) -> Any:
        """The block under an entry with no value on its own line (None if
        there is none)."""
        nxt = self.peek()
        if nxt is None or nxt.indent < indent:
            return None
        if nxt.indent > indent:
            return self.block(nxt.indent)
        if allow_same_indent_list and _is_item(nxt.text):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line, "unexpected indentation")
            if _is_item(line.text):
                raise _fail(line, "a list item among mapping entries")
            entry = _split_key(line.text, line)
            if entry is None:
                raise _fail(line, f"{line.text!r} is not a `key: value` entry")
            key, rest = entry
            self.i += 1
            if rest.strip() and not rest.strip().startswith("#"):
                out[key] = _scalar(rest, line)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise _fail(nxt, "a plain scalar over more than one line")
            else:
                out[key] = self.nested(indent, allow_same_indent_list=True)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line, "unexpected indentation")
            if not _is_item(line.text):
                return out
            rest = line.text[1:]
            body = rest.lstrip(" \t")
            if not body or body.startswith("#"):
                self.i += 1
                out.append(self.nested(indent, allow_same_indent_list=False))
                continue
            # the item's content continues at its own column: parse it as a
            # block that starts there
            self.lines[self.i] = _Line(indent + 1 + len(rest) - len(body), body, line.number)
            out.append(self.block(self.lines[self.i].indent))


def loads(source: str) -> Any:
    """The value of a YAML document in the subset (see the module docstring)."""
    return _Parser(source).document()


def load_config(path) -> Any:
    """Read a config file in the YAML subset (see the module docstring)."""
    with open(path) as f:
        return loads(f.read())
