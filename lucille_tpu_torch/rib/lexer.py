"""RIB tokenizer.

Token classes mirror the reference lexer (src/lsh/lexrib.l): identifiers
(RIB commands), quoted strings, numbers, and brackets.  Comments run from
'#' to end of line.  Includes gzip transparent decompression — the
reference shells out to gunzip (src/lsh/main.c:167-179); we use the gzip
module.

The port's copy of lucille_tpu/rib/lexer.py: the same code, with its
imports pointed at lucille_tpu_torch's own host modules.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass
from enum import Enum
from pathlib import Path


class TokenKind(Enum):
    ID = "id"  # RIB command name, e.g. WorldBegin
    STRING = "string"
    NUMBER = "number"
    LBRACKET = "lbracket"
    RBRACKET = "rbracket"


@dataclass(frozen=True)
class Token:
    kind: TokenKind
    value: object  # str for ID/STRING, float for NUMBER, None for brackets
    line: int


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<lbracket>\[)
  | (?P<rbracket>\])
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<ws>[\s]+)
""",
    re.VERBOSE,
)

_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "r": "\r"}


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append(_ESCAPES.get(s[i + 1], s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(text: str):
    """Yield Tokens from RIB source text.

    Unrecognized characters are skipped with the same tolerance the
    reference lexer shows (it relies on the parser's unknown-command
    recovery rather than dying in the lexer).
    """
    line = 1
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            # skip one unknown character
            if text[pos] == "\n":
                line += 1
            pos += 1
            continue
        pos = m.end()
        kind = m.lastgroup
        val = m.group()
        nl = val.count("\n")
        if kind == "ws" or kind == "comment":
            line += nl
            continue
        if kind == "string":
            yield Token(TokenKind.STRING, _unescape(val[1:-1]), line)
        elif kind == "number":
            yield Token(TokenKind.NUMBER, float(val), line)
        elif kind == "lbracket":
            yield Token(TokenKind.LBRACKET, None, line)
        elif kind == "rbracket":
            yield Token(TokenKind.RBRACKET, None, line)
        elif kind == "id":
            yield Token(TokenKind.ID, val, line)
        line += nl


def read_rib_text(path: str | Path) -> str:
    """Read a RIB file, transparently decompressing .gz/.rib.gz."""
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":  # gzip magic, matches any compressed name
        raw = gzip.decompress(raw)
    return raw.decode("utf-8", errors="replace")


def tokenize_file(path: str | Path):
    return tokenize(read_rib_text(path))
