"""Protobuf text-format parser (pure Python, no generated code).

The PyTorch port's own copy of `singa_tpu/config/textproto.py`.

Parses the reference's text-format config files (e.g.
SINGA's examples/mnist/mlp.conf, conv.conf — schema at
src/proto/model.proto, cluster.proto) into plain nested
dicts.  Every field value is accumulated into a list; the schema layer
(`singa_tpu_torch.config.schema`) decides which fields are singular vs repeated.

Grammar handled (the subset protobuf text-format actually uses here):

    message   := field*
    field     := IDENT ':' scalar | IDENT ':'? '{' message '}'
    scalar    := NUMBER | STRING | IDENT        (IDENT covers enums + bools)
    comments  := '#' .. end-of-line
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<punct>[{}:])
  | (?P<number>[-+]?(?:\.\d+|\d+\.?\d*)(?:[eE][-+]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    """,
    re.VERBOSE,
)


class TextProtoError(ValueError):
    pass


def _tokenize(text: str) -> List[Tuple[str, str, int]]:
    tokens = []
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise TextProtoError(
                f"line {line}: unexpected character {text[pos]!r}")
        kind = m.lastgroup
        value = m.group()
        line += value.count("\n")
        if kind not in ("ws", "comment"):
            tokens.append((kind, value, line))
        pos = m.end()
    return tokens


def _unquote(s: str) -> str:
    body = s[1:-1]

    def sub(m):
        e = m.group(1)
        if e.startswith("x"):
            return chr(int(e[1:], 16))
        if e[0] in "01234567":
            return chr(int(e, 8))   # protoc emits octal \NNN escapes
        return {"n": "\n", "t": "\t", "r": "\r"}.get(e, e)

    return re.sub(r"\\([0-7]{1,3}|x[0-9a-fA-F]{1,2}|.)", sub, body)


def _escape(v: str) -> str:
    """Protobuf text-format string escaping: backslash, quote, the
    common control characters, and \\xNN for other non-printables —
    so dump() output always re-tokenizes (the tokenizer's string
    pattern cannot cross a raw newline)."""
    out = []
    for ch in v:
        if ch == "\\":
            out.append("\\\\")
        elif ch == '"':
            out.append('\\"')
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        elif ord(ch) < 0x20:
            out.append(f"\\x{ord(ch):02x}")
        else:
            out.append(ch)
    return "".join(out)


def _coerce_scalar(kind: str, value: str) -> Any:
    if kind == "string":
        return _unquote(value)
    if kind == "number":
        try:
            return int(value)
        except ValueError:
            return float(value)
    # ident: bool literals or enum symbol (kept as string)
    if value == "true":
        return True
    if value == "false":
        return False
    return value


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self):
        tok = self.peek()
        if tok is None:
            raise TextProtoError("unexpected end of input")
        self.i += 1
        return tok

    def parse_message(self, toplevel: bool = False) -> Dict[str, List[Any]]:
        msg: Dict[str, List[Any]] = {}
        while True:
            tok = self.peek()
            if tok is None:
                if not toplevel:
                    raise TextProtoError("unexpected end of input, missing '}'")
                return msg
            kind, value, line = tok
            if kind == "punct" and value == "}":
                if toplevel:
                    raise TextProtoError(f"line {line}: stray '}}'")
                return msg
            if kind != "ident":
                raise TextProtoError(
                    f"line {line}: expected field name, got {value!r}")
            self.next()
            name = value
            tok = self.peek()
            if tok is None:
                raise TextProtoError(f"line {line}: dangling field {name!r}")
            kind, value, line = tok
            if kind == "punct" and value == ":":
                self.next()
                tok = self.peek()
                kind, value, line = tok if tok else (None, None, line)
            if kind == "punct" and value == "{":
                self.next()
                field_value: Any = self.parse_message()
                ktok = self.next()
                if ktok[1] != "}":
                    raise TextProtoError(
                        f"line {ktok[2]}: expected '}}', got {ktok[1]!r}")
            elif kind in ("string", "number", "ident"):
                self.next()
                field_value = _coerce_scalar(kind, value)
            else:
                raise TextProtoError(
                    f"line {line}: bad value for field {name!r}: {value!r}")
            msg.setdefault(name, []).append(field_value)


def parse(text: str) -> Dict[str, List[Any]]:
    """Parse protobuf text format into {field: [values...]} nested dicts."""
    return _Parser(_tokenize(text)).parse_message(toplevel=True)


def parse_file(path: str) -> Dict[str, List[Any]]:
    with open(path, "r") as f:
        return parse(f.read())


def dump(msg: Dict[str, Any], indent: int = 0) -> str:
    """Serialize a {field: [values...]} dict back to text format."""
    out = []
    pad = "  " * indent
    for name, values in msg.items():
        if not isinstance(values, list):
            values = [values]
        for v in values:
            if isinstance(v, dict):
                out.append(f"{pad}{name} {{")
                out.append(dump(v, indent + 1))
                out.append(f"{pad}}}")
            elif isinstance(v, bool):
                out.append(f"{pad}{name}: {'true' if v else 'false'}")
            elif isinstance(v, str) and not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", v):
                out.append(f'{pad}{name}: "{_escape(v)}"')
            elif isinstance(v, str):
                # enum symbol — unquoted only if it looks like one that the
                # schema declares; plain strings (e.g. layer type "kReLU")
                # round-trip fine either way, quote to be safe.
                out.append(f'{pad}{name}: "{v}"')
            else:
                out.append(f"{pad}{name}: {v}")
    return "\n".join(out)
