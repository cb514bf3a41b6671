"""Recursive-descent / Pratt parser for the TLA+ subset in the corpus.

Junction lists (the column-sensitive /\\ and \\/ bullet lists that
structure every action in the reference, e.g. VSR.tla:366-394) are
handled with a ``min_col`` threshold threaded through expression parsing:
a bullet list started at column c parses each item with ``min_col = c``,
and any token at column <= c terminates the item — which is exactly the
TLA+ alignment rule for well-formed specs.  Tokens inside brackets are
exempt (we reset min_col to 0 inside (), [], {}, <<>>), which is a
conservative relaxation.

Top-level definition boundaries are pre-scanned (a token at column 1
starting ``Name ==``, ``Name(..) ==``, or a section keyword) so a
definition body can never swallow the next definition.

A copy of ``tpuvsr/frontend/parser.py``: the port keeps its own, so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

from .lexer import Token, tokenize
from .tla_ast import Def, Module


class ParseError(Exception):
    pass


_SECTION_KEYWORDS = {
    "EXTENDS", "CONSTANT", "CONSTANTS", "VARIABLE", "VARIABLES",
    "RECURSIVE", "ASSUME", "ASSUMPTION", "THEOREM", "INSTANCE", "LOCAL",
}

# infix operator -> (binding power, ast op tag); follows the TLA+ operator
# precedence table (Specifying Systems, ch. 15): = (5) binds looser than
# @@ (6) / :> (7), set ops at 8, .. at 9, arithmetic at 10/13.
_INFIX = {
    "=>": (1, "implies"), "<=>": (2, "equiv"), "~>": (2, "leadsto"),
    "\\/": (3, "or"), "/\\": (4, "and"),
    "=": (5, "eq"), "#": (5, "ne"),
    "<": (5, "lt"), ">": (5, "gt"), "<=": (5, "le"), ">=": (5, "ge"),
    "\\in": (5, "in"), "\\notin": (5, "notin"), "\\subseteq": (5, "subseteq"),
    "@@": (6, "merge"), ":>": (7, "mapsto"),
    "\\union": (8, "union"), "\\cup": (8, "union"),
    "\\intersect": (8, "intersect"), "\\cap": (8, "intersect"),
    "\\": (8, "setdiff"),
    "..": (9, "range"),
    "+": (10, "plus"), "-": (10, "minus"),
    "\\o": (13, "concat"),
    "%": (13, "mod"), "\\div": (13, "div"), "*": (13, "times"),
}


class Parser:
    def __init__(self, src: str, filename: str = "<string>"):
        self.toks = tokenize(src)
        self.pos = 0
        self.filename = filename
        self.unit_starts = self._scan_unit_starts()

    # ------------------------------------------------------------------
    def _scan_unit_starts(self):
        starts = set()
        toks = self.toks
        n = len(toks)
        for i, t in enumerate(toks):
            if t.kind in ("SEP", "END", "EOF"):
                starts.add(i)
                continue
            if t.col != 1:
                continue
            if t.kind == "ID":
                if t.text in _SECTION_KEYWORDS:
                    starts.add(i)
                    continue
                # Name ==   or   Name(params) ==
                if i + 1 < n and toks[i + 1].kind == "OP":
                    if toks[i + 1].text == "==":
                        starts.add(i)
                    elif toks[i + 1].text == "(":
                        j = i + 2
                        depth = 1
                        while j < n and depth > 0:
                            if toks[j].kind == "OP" and toks[j].text == "(":
                                depth += 1
                            elif toks[j].kind == "OP" and toks[j].text == ")":
                                depth -= 1
                            j += 1
                        if j < n and toks[j].kind == "OP" and toks[j].text == "==":
                            starts.add(i)
        return starts

    # ------------------------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        return self.toks[min(self.pos + off, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "EOF":
            self.pos += 1
        return t

    def at_op(self, text: str, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == "OP" and t.text == text

    def at_id(self, text: str = None, off: int = 0) -> bool:
        t = self.peek(off)
        return t.kind == "ID" and (text is None or t.text == text)

    def expect_op(self, text: str) -> Token:
        t = self.next()
        if t.kind != "OP" or t.text != text:
            self.err(f"expected {text!r}, got {t}")
        return t

    def expect_id(self, text: str = None) -> Token:
        t = self.next()
        if t.kind != "ID" or (text is not None and t.text != text):
            self.err(f"expected identifier {text or ''}, got {t}")
        return t

    def err(self, msg: str):
        t = self.peek()
        raise ParseError(f"{self.filename}:{t.line}:{t.col}: {msg}")

    def _at_boundary(self) -> bool:
        return self.pos in self.unit_starts or self.peek().kind in ("END", "EOF")

    # ------------------------------------------------------------------
    # Module structure
    # ------------------------------------------------------------------
    def parse_module(self) -> Module:
        # ---- MODULE Name ----
        while self.peek().kind == "SEP":
            self.next()
            break
        self.expect_id("MODULE")
        name = self.expect_id().text
        if self.peek().kind == "SEP":
            self.next()
        mod = Module(name=name)
        recursive_decls = set()
        while True:
            if self.peek().kind in ("END", "EOF"):
                break
            if self.peek().kind == "SEP":
                self.next()
                continue
            t = self.peek()
            if t.kind == "ID" and t.text == "EXTENDS":
                self.next()
                mod.extends.append(self.expect_id().text)
                while self.at_op(","):
                    self.next()
                    mod.extends.append(self.expect_id().text)
            elif t.kind == "ID" and t.text in ("CONSTANTS", "CONSTANT"):
                self.next()
                mod.constants.append(self.expect_id().text)
                while self.at_op(","):
                    self.next()
                    mod.constants.append(self.expect_id().text)
            elif t.kind == "ID" and t.text in ("VARIABLES", "VARIABLE"):
                self.next()
                mod.variables.append(self.expect_id().text)
                while self.at_op(","):
                    self.next()
                    mod.variables.append(self.expect_id().text)
            elif t.kind == "ID" and t.text == "RECURSIVE":
                self.next()
                while True:
                    rname = self.expect_id().text
                    recursive_decls.add(rname)
                    if self.at_op("("):
                        self.next()
                        while not self.at_op(")"):
                            self.next()
                        self.next()
                    if self.at_op(","):
                        self.next()
                        continue
                    break
            elif t.kind == "ID" and t.text in ("ASSUME", "ASSUMPTION"):
                self.next()
                mod.assumes.append(self.parse_expr(0, 0))
            elif t.kind == "ID" and t.text == "LOCAL":
                self.next()  # treat LOCAL defs as ordinary defs
            elif t.kind == "ID":
                d = self.parse_definition()
                d.module = mod.name
                d.recursive = d.name in recursive_decls
                mod.defs[d.name] = d
            else:
                self.err(f"unexpected token at module level: {t}")
        return mod

    def parse_definition(self) -> Def:
        t0 = self.peek()
        name = self.expect_id().text
        params = []
        if self.at_op("("):
            self.next()
            while True:
                p = self.next()
                if p.kind == "ID":
                    params.append(p.text)
                elif p.kind == "OP" and p.text == "_":
                    params.append("_")
                else:
                    self.err(f"bad parameter {p}")
                if self.at_op(","):
                    self.next()
                    continue
                break
            self.expect_op(")")
        self.expect_op("==")
        body = self.parse_expr(0, 0)
        t1 = self.toks[self.pos - 1]
        return Def(name=name, params=params, body=body,
                   line0=t0.line, col0=t0.col, line1=t1.line,
                   col1=t1.col + len(t1.text) - 1)

    # ------------------------------------------------------------------
    # Expressions
    # ------------------------------------------------------------------
    def parse_expr(self, min_col: int, rbp: int):
        left = self.parse_primary(min_col)
        while True:
            if self._at_boundary():
                break
            t = self.peek()
            if t.kind != "OP":
                break
            info = _INFIX.get(t.text)
            if info is None:
                break
            lbp, tag = info
            if lbp <= rbp or t.col <= min_col:
                break
            self.next()
            right = self.parse_expr(min_col, lbp)
            if tag == "and":
                items = left[1] if left[0] == "and" else [left]
                left = ("and", items + [right])
            elif tag == "or":
                items = left[1] if left[0] == "or" else [left]
                left = ("or", items + [right])
            else:
                left = ("binop", tag, left, right)
        return left

    def parse_primary(self, min_col: int):
        if self._at_boundary():
            self.err("unexpected end of definition")
        t = self.peek()

        # junction lists
        if t.kind == "OP" and t.text in ("/\\", "\\/"):
            return self.parse_junction(min_col)

        if t.kind == "NUM":
            self.next()
            return self.postfix(("num", int(t.text)), min_col)
        if t.kind == "STR":
            self.next()
            return self.postfix(("str", t.text), min_col)

        if t.kind == "ID":
            return self.parse_id_led(min_col)

        if t.kind != "OP":
            self.err(f"unexpected token {t}")

        txt = t.text
        if txt == "~":
            self.next()
            return ("not", self.parse_expr(min_col, 4))
        if txt == "-":
            self.next()
            return ("neg", self.parse_expr(min_col, 12))
        if txt == "[]":
            self.next()
            if self.at_op("["):
                # [][A]_vars
                self.next()
                act = self.parse_expr(0, 0)
                self.expect_op("]")
                sub = self._parse_subscript()
                return ("boxaction", act, sub)
            return ("box", self.parse_expr(min_col, 4))
        if txt == "<>":
            self.next()
            return ("diamond", self.parse_expr(min_col, 4))
        if txt == "(":
            self.next()
            e = self.parse_expr(0, 0)
            self.expect_op(")")
            return self.postfix(e, min_col)
        if txt == "{":
            return self.postfix(self.parse_set(), min_col)
        if txt == "[":
            return self.postfix(self.parse_bracket(), min_col)
        if txt == "<<":
            self.next()
            items = []
            if not self.at_op(">>"):
                items.append(self.parse_expr(0, 0))
                while self.at_op(","):
                    self.next()
                    items.append(self.parse_expr(0, 0))
            self.expect_op(">>")
            return self.postfix(("tuple", items), min_col)
        if txt == "@":
            self.next()
            return self.postfix(("at",), min_col)
        if txt in ("\\E", "\\A"):
            self.next()
            groups = self.parse_bound_groups()
            self.expect_op(":")
            body = self.parse_expr(min_col, 0)
            return ("exists" if txt == "\\E" else "forall", groups, body)
        self.err(f"unexpected operator {txt!r}")

    def _parse_subscript(self):
        # the `_vars` after `[][Next]` — lexed as a single identifier
        t = self.next()
        if t.kind != "ID" or not t.text.startswith("_"):
            self.err(f"expected _subscript after ]: got {t}")
        return ("id", t.text[1:])

    def parse_id_led(self, min_col: int):
        t = self.next()
        name = t.text
        if name == "IF":
            cond = self.parse_expr(min_col, 0)
            self.expect_id("THEN")
            then = self.parse_expr(min_col, 0)
            self.expect_id("ELSE")
            els = self.parse_expr(min_col, 0)
            return ("if", cond, then, els)
        if name == "CASE":
            arms = []
            other = None
            while True:
                if self.at_id("OTHER"):
                    self.next()
                    self.expect_op("->")
                    other = self.parse_expr(min_col, 0)
                    break
                guard = self.parse_expr(min_col, 0)
                self.expect_op("->")
                val = self.parse_expr(min_col, 0)
                arms.append((guard, val))
                if self.at_op("[]"):
                    self.next()
                    continue
                break
            return ("case", arms, other)
        if name == "LET":
            defs = []
            while not self.at_id("IN"):
                if self.at_id("RECURSIVE"):
                    # RECURSIVE decl inside LET
                    self.next()
                    rn = self.expect_id().text
                    if self.at_op("("):
                        self.next()
                        while not self.at_op(")"):
                            self.next()
                        self.next()
                    defs.append(("__recursive__", rn))
                    continue
                d = self.parse_definition_inline()
                defs.append(d)
            self.expect_id("IN")
            body = self.parse_expr(min_col, 0)
            rec_names = {x[1] for x in defs if isinstance(x, tuple)}
            real_defs = [d for d in defs if isinstance(d, Def)]
            for d in real_defs:
                if d.name in rec_names:
                    d.recursive = True
            return ("let", real_defs, body)
        if name == "CHOOSE":
            var = self.expect_id().text
            self.expect_op("\\in")
            s = self.parse_expr(min_col, 0)
            self.expect_op(":")
            body = self.parse_expr(min_col, 0)
            return ("choose", var, s, body)
        if name == "LAMBDA":
            params = [self.expect_id().text]
            while self.at_op(","):
                self.next()
                params.append(self.expect_id().text)
            self.expect_op(":")
            body = self.parse_expr(min_col, 0)
            return ("lambda", params, body)
        if name == "DOMAIN":
            return ("domain", self.parse_expr(min_col, 15))
        if name == "SUBSET":
            return ("powerset", self.parse_expr(min_col, 15))
        if name == "UNION":
            return ("bigunion", self.parse_expr(min_col, 15))
        if name == "UNCHANGED":
            return ("unchanged", self.parse_expr(min_col, 15))
        if name == "ENABLED":
            return ("enabled", self.parse_expr(min_col, 15))
        if name == "TRUE":
            return self.postfix(("bool", True), min_col)
        if name == "FALSE":
            return self.postfix(("bool", False), min_col)
        if name.startswith("WF_") or name.startswith("SF_"):
            sub = ("id", name[3:])
            self.expect_op("(")
            act = self.parse_expr(0, 0)
            self.expect_op(")")
            return ("wf" if name.startswith("WF_") else "sf", sub, act)
        # plain identifier or operator call
        if self.at_op("(") and self.peek().col > min_col:
            self.next()
            args = [self.parse_expr(0, 0)]
            while self.at_op(","):
                self.next()
                args.append(self.parse_expr(0, 0))
            self.expect_op(")")
            return self.postfix(("call", name, args), min_col)
        return self.postfix(("id", name), min_col)

    def parse_definition_inline(self) -> Def:
        """A definition inside LET (no column-1 constraint)."""
        t0 = self.peek()
        name = self.expect_id().text
        params = []
        if self.at_op("("):
            self.next()
            while True:
                p = self.next()
                if p.kind == "ID":
                    params.append(p.text)
                elif p.kind == "OP" and p.text == "_":
                    params.append("_")
                else:
                    self.err(f"bad parameter {p}")
                if self.at_op(","):
                    self.next()
                    continue
                break
            self.expect_op(")")
        self.expect_op("==")
        body = self.parse_expr(t0.col, 0)
        t1 = self.toks[self.pos - 1]
        return Def(name=name, params=params, body=body, line0=t0.line,
                   col0=t0.col, line1=t1.line, col1=t1.col + len(t1.text) - 1)

    def parse_junction(self, min_col: int):
        t = self.peek()
        op = t.text
        col = t.col
        items = []
        while self.at_op(op) and self.peek().col == col and not self._at_boundary():
            self.next()
            items.append(self.parse_expr(col, 0))
        tag = "and" if op == "/\\" else "or"
        if len(items) == 1:
            return items[0] if tag == "and" else ("or", items)
        return (tag, items)

    def parse_bound_groups(self):
        """``x, y \\in S, m \\in T`` -> [([x, y], S), ([m], T)]"""
        groups = []
        while True:
            names = [self.expect_id().text]
            while self.at_op(","):
                # could be another name in this group or a new group; a new
                # group also starts with ID, so look for the \in that closes
                # this group: names continue while the token after the ID is
                # ',' or '\in'.
                if self.at_id(off=1) and (self.at_op(",", off=2) or self.at_op("\\in", off=2)):
                    self.next()
                    names.append(self.expect_id().text)
                else:
                    break
            self.expect_op("\\in")
            s = self.parse_expr(0, 0)
            groups.append((names, s))
            if self.at_op(","):
                self.next()
                continue
            break
        return groups

    def parse_set(self):
        self.expect_op("{")
        if self.at_op("}"):
            self.next()
            return ("setenum", [])
        # try {x \in S : p}
        if self.at_id() and self.at_op("\\in", off=1):
            save = self.pos
            var = self.expect_id().text
            self.expect_op("\\in")
            s = self.parse_expr(0, 0)
            if self.at_op(":"):
                self.next()
                p = self.parse_expr(0, 0)
                self.expect_op("}")
                return ("setfilter", var, s, p)
            self.pos = save  # it was an enumeration of a membership test
        e = self.parse_expr(0, 0)
        if self.at_op(":"):
            self.next()
            groups = self.parse_bound_groups()
            self.expect_op("}")
            return ("setmap", e, groups)
        items = [e]
        while self.at_op(","):
            self.next()
            items.append(self.parse_expr(0, 0))
        self.expect_op("}")
        return ("setenum", items)

    def parse_bracket(self):
        self.expect_op("[")
        # function constructor [x \in S |-> e] (possibly multiple groups)
        if self.at_id() and (self.at_op("\\in", off=1) or
                             (self.at_op(",", off=1) and self.at_id(off=2))):
            save = self.pos
            try:
                groups = self.parse_bound_groups()
                if self.at_op("|->"):
                    self.next()
                    body = self.parse_expr(0, 0)
                    self.expect_op("]")
                    return ("fnctor", groups, body)
            except ParseError:
                pass
            self.pos = save
        # record literal [f |-> e, ...]
        if self.at_id() and self.at_op("|->", off=1):
            fields = []
            while True:
                fname = self.expect_id().text
                self.expect_op("|->")
                fields.append((fname, self.parse_expr(0, 0)))
                if self.at_op(","):
                    self.next()
                    continue
                break
            self.expect_op("]")
            return ("record", fields)
        # record set [f : S, ...]
        if self.at_id() and self.at_op(":", off=1):
            fields = []
            while True:
                fname = self.expect_id().text
                self.expect_op(":")
                fields.append((fname, self.parse_expr(0, 0)))
                if self.at_op(","):
                    self.next()
                    continue
                break
            self.expect_op("]")
            return ("recordset", fields)
        e = self.parse_expr(0, 0)
        if self.at_id("EXCEPT"):
            self.next()
            specs = []
            while True:
                self.expect_op("!")
                path = []
                while True:
                    if self.at_op("["):
                        self.next()
                        idx = self.parse_expr(0, 0)
                        self.expect_op("]")
                        path.append(("idx", idx))
                    elif self.at_op("."):
                        self.next()
                        path.append(("fld", self.expect_id().text))
                    else:
                        break
                if not path:
                    self.err("empty EXCEPT path")
                self.expect_op("=")
                val = self.parse_expr(0, 0)
                specs.append((path, val))
                if self.at_op(","):
                    self.next()
                    continue
                break
            self.expect_op("]")
            return ("except", e, specs)
        if self.at_op("->"):
            self.next()
            rng = self.parse_expr(0, 0)
            self.expect_op("]")
            return ("fnset", e, rng)
        if self.at_op("]"):
            # [A]_vars action form
            self.next()
            sub = self._parse_subscript()
            return ("boxaction_inner", e, sub)
        self.err("cannot parse [ ... ] form")

    def postfix(self, e, min_col: int):
        while True:
            if self._at_boundary():
                return e
            t = self.peek()
            if t.kind != "OP" or t.col <= min_col:
                return e
            if t.text == "'":
                self.next()
                e = ("prime", e)
            elif t.text == "[":
                self.next()
                idx = self.parse_expr(0, 0)
                while self.at_op(","):
                    self.next()
                    idx2 = self.parse_expr(0, 0)
                    idx = ("tuple", [idx, idx2]) if idx[0] != "tuple" else ("tuple", idx[1] + [idx2])
                self.expect_op("]")
                e = ("apply", e, idx)
            elif t.text == "." and self.peek(1).kind == "ID":
                self.next()
                e = ("dot", e, self.expect_id().text)
            else:
                return e


def parse_module_text(src: str, filename: str = "<string>") -> Module:
    return Parser(src, filename).parse_module()


def parse_module_file(path: str) -> Module:
    with open(path) as f:
        return parse_module_text(f.read(), path)


def parse_expr_text(src: str):
    p = Parser(src)
    return p.parse_expr(0, 0)
