"""Tokenizer for the TLA+ subset exercised by the reference corpus.

Covers the constructs inventoried in SURVEY.md §2.6: junction lists
(column-sensitive /\\ and \\/ bullets — columns are recorded on every
token and the parser enforces the alignment rules), backslash operators
(\\in, \\notin, \\E, \\A, \\div, \\union, and bare \\ set difference),
nested block comments, module separator lines, primes, EXCEPT paths, and
the temporal tokens ([], <>, ~>) used by the liveness specs.

A copy of ``tpuvsr/frontend/lexer.py``: the port keeps its own, so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Token:
    kind: str   # 'ID', 'NUM', 'STR', 'OP', 'SEP' (---- line), 'END' (==== line), 'EOF'
    text: str
    line: int   # 1-based
    col: int    # 1-based

    def __repr__(self) -> str:
        return f"{self.kind}({self.text!r}@{self.line}:{self.col})"


# Longest-match-first symbol table.
_SYMBOLS = [
    "|->", "<=>", "==", "=>", "<=", ">=", "~>", "..", "@@", ":>",
    "<<", ">>", "[]", "<>", "/\\", "\\/", "->",
    "=", "#", "<", ">", "+", "-", "%", "*",
    "(", ")", "[", "]", "{", "}", ",", ":", ".", "'", "!", "@", "~", "_", ";",
]

# \word operators that are meaningful in the corpus.
_BACKSLASH_WORDS = {
    "in", "notin", "union", "cup", "intersect", "cap", "div", "o",
    "E", "A", "X", "subseteq", "subset",
}

_KEYWORDS = {
    "MODULE", "EXTENDS", "CONSTANT", "CONSTANTS", "VARIABLE", "VARIABLES",
    "RECURSIVE", "LET", "IN", "IF", "THEN", "ELSE", "CASE", "OTHER",
    "CHOOSE", "LAMBDA", "DOMAIN", "SUBSET", "UNION", "UNCHANGED", "EXCEPT",
    "ENABLED", "ASSUME", "ASSUMPTION", "THEOREM", "INSTANCE", "LOCAL",
    "TRUE", "FALSE", "BOOLEAN", "OTHER",
}


class LexError(Exception):
    pass


def tokenize(src: str) -> list:
    toks = []
    line = 1
    col = 1
    i = 0
    n = len(src)

    def error(msg):
        raise LexError(f"{msg} at line {line}, col {col}")

    while i < n:
        c = src[i]
        if c == "\n":
            i += 1
            line += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        # line comment
        if c == "\\" and i + 1 < n and src[i + 1] == "*":
            while i < n and src[i] != "\n":
                i += 1
            continue
        # block comment (nested)
        if c == "(" and i + 1 < n and src[i + 1] == "*":
            depth = 1
            i += 2
            col += 2
            while i < n and depth > 0:
                if src[i] == "(" and i + 1 < n and src[i + 1] == "*":
                    depth += 1
                    i += 2
                    col += 2
                elif src[i] == "*" and i + 1 < n and src[i + 1] == ")":
                    depth -= 1
                    i += 2
                    col += 2
                elif src[i] == "\n":
                    i += 1
                    line += 1
                    col = 1
                else:
                    i += 1
                    col += 1
            continue
        # separator lines: runs of 4+ '-' or '='
        if c == "-" and src.startswith("----", i):
            j = i
            while j < n and src[j] == "-":
                j += 1
            toks.append(Token("SEP", src[i:j], line, col))
            col += j - i
            i = j
            continue
        if c == "=" and src.startswith("====", i):
            j = i
            while j < n and src[j] == "=":
                j += 1
            toks.append(Token("END", src[i:j], line, col))
            col += j - i
            i = j
            continue
        # number
        if c.isdigit():
            j = i
            while j < n and src[j].isdigit():
                j += 1
            toks.append(Token("NUM", src[i:j], line, col))
            col += j - i
            i = j
            continue
        # identifier / keyword (may start with _ if followed by alnum)
        if c.isalpha() or (c == "_" and i + 1 < n and (src[i + 1].isalnum() or src[i + 1] == "_")):
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            text = src[i:j]
            toks.append(Token("ID", text, line, col))
            col += j - i
            i = j
            continue
        # string
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\n":
                    error("unterminated string")
                buf.append(src[j])
                j += 1
            if j >= n:
                error("unterminated string")
            toks.append(Token("STR", "".join(buf), line, col))
            col += j + 1 - i
            i = j + 1
            continue
        # backslash operators ('\/' must win over backslash-word scanning)
        if c == "\\":
            if src.startswith("\\/", i):
                toks.append(Token("OP", "\\/", line, col))
                col += 2
                i += 2
                continue
            j = i + 1
            while j < n and src[j].isalpha():
                j += 1
            word = src[i + 1:j]
            if word:
                if word not in _BACKSLASH_WORDS:
                    error(f"unknown operator \\{word}")
                toks.append(Token("OP", "\\" + word, line, col))
                col += j - i
                i = j
            else:
                toks.append(Token("OP", "\\", line, col))
                col += 1
                i += 1
            continue
        # symbols, longest first
        for sym in _SYMBOLS:
            if src.startswith(sym, i):
                toks.append(Token("OP", sym, line, col))
                col += len(sym)
                i += len(sym)
                break
        else:
            error(f"unexpected character {c!r}")
    toks.append(Token("EOF", "", line, col))
    return toks
