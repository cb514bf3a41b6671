"""AST node definitions for the TLA+ frontend.

Expressions are plain tuples ``(tag, ...)`` for fast dispatch in the
evaluator; definitions and modules are small classes.  Source locations
are tracked per-definition (and per-action via the definition) so the
trace reconstructor can emit TLC-style ``_TEAction`` annotations
(reference: state_transfer_violation_trace.txt:3-7).

Expression tags:
  ('num', int) ('str', s) ('bool', b) ('id', name)
  ('call', name, [args])
  ('and', [e..]) ('or', [e..]) ('not', e) ('neg', e)
  ('binop', op, a, b)   op in: in notin union setdiff intersect div mod
                        plus minus times concat lt le gt ge eq ne range
                        merge mapsto implies equiv subseteq
  ('exists', groups, body) / ('forall', groups, body)
        groups = [([names], set_expr), ...]
  ('choose', name, set_expr, body)
  ('lambda', [params], body)
  ('setenum', [e..]) ('setfilter', name, set_expr, pred)
  ('setmap', elem_expr, groups)
  ('tuple', [e..])
  ('fnctor', groups, body) ('record', [(name, e)..]) ('fnset', dom, rng)
  ('recordset', [(name, set_expr)..])
  ('except', f, [ (path, val) ])   path = [('idx', e) | ('fld', name)]
  ('at',)                           the @ inside EXCEPT values
  ('apply', f, arg) ('dot', e, field) ('prime', e)
  ('if', c, t, e) ('case', [(guard, val)..], other_or_None)
  ('let', [Def..], body)
  ('unchanged', e) ('enabled', e) ('domain', e) ('powerset', e)
  ('box', e) ('diamond', e) ('boxaction', act, sub) ('wf', sub, act)
  ('sf', sub, act)

A copy of ``tpuvsr/frontend/tla_ast.py``: the port keeps its own, so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Def:
    name: str
    params: list           # parameter names ([] for constant operators)
    body: Any              # expression tuple
    recursive: bool = False
    # Source span of the whole definition (for _TEAction location output).
    line0: int = 0
    col0: int = 0
    line1: int = 0
    col1: int = 0
    module: str = ""


@dataclass
class Module:
    name: str
    extends: list = field(default_factory=list)
    constants: list = field(default_factory=list)
    variables: list = field(default_factory=list)
    defs: dict = field(default_factory=dict)      # name -> Def (ordered)
    assumes: list = field(default_factory=list)

    def get(self, name: str) -> Optional[Def]:
        return self.defs.get(name)
