""".pbrt tokenizer (counterpart of src/core/parser.cpp:98-252 Tokenizer).

Hand-written scanner over the scene text: whitespace/comment skipping,
quoted strings, bracketed numeric lists; `Include` is handled by the loader.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple


class Token(NamedTuple):
    text: str
    filename: str
    line: int


def tokenize(text: str, filename: str = "<string>") -> Iterator[Token]:
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "#":
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                if text[j] == "\n":
                    raise SyntaxError(f"{filename}:{line}: newline in quoted string")
                j += 1
            if j >= n:
                raise SyntaxError(f"{filename}:{line}: unterminated string")
            yield Token(text[i : j + 1], filename, line)
            i = j + 1
        elif c in "[]":
            yield Token(c, filename, line)
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            yield Token(text[i:j], filename, line)
            i = j


def tokenize_file(path: str) -> Iterator[Token]:
    with open(path, "r", errors="replace") as f:
        return tokenize(f.read(), os.path.basename(path))
