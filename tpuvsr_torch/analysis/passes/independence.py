"""Pass 7 — static action independence.

Symmetry (pass 4) and bounds (pass 6) attack value relabeling and
domain blowup; the remaining blowup axis is INTERLEAVING — actions
that touch disjoint state commute, and BFS explores every ordering of
them anyway.  This pass computes the conservative static independence
relation the engines' ample-set filter (``engine/por.py``) consumes:

* **read/write access sets** — per action, the state variables its
  guard and updates read and the variables its updates prime, at
  plane/column granularity: a write through ``v' = [v EXCEPT ![c] = e]``
  with a constant-foldable index records the single column ``c``
  instead of the whole plane (the EXCEPT copy of the other columns is
  the identity and commutes with any column-disjoint write, so it is
  deliberately NOT a read); an indexed read ``v[c]`` with a foldable
  index records one column.  Anything else widens to the full plane.
* **the independence matrix** — actions ``a``, ``b`` are independent
  only when ``W(a) ∩ (R(b) ∪ W(b)) = ∅`` AND
  ``W(b) ∩ (R(a) ∪ W(a)) = ∅`` at that granularity.  Disjoint frames
  in both directions mean the two updates commute as state
  transformers AND neither can change the other's guard — exactly the
  (strong) independence the ample-set theorems need, including
  enabledness preservation (C1): no action can toggle an independent
  action's guard, so an independent action's enabled LANE SET is
  constant along paths that do not fire it.
* **invariant visibility** — an action is *invisible* when its write
  set is disjoint from every cfg invariant's read set (C2: taking it
  cannot change any invariant's truth value).
* **monotone progress witnesses** — per action, a variable ``x`` whose
  only update anywhere in the action is a top-level conjunct
  ``x' = x + c`` with constant ``c >= 1``, and whose reachable
  interval (bounds pass) is finite.  The sharded engine's fully-static
  cycle proviso (engine/por.py) needs these: summed over the eligible
  actions, the witnesses form a bounded measure that strictly
  increases on every ample transition, so no cycle can consist of
  ample shortcuts only.

Refusal discipline (mirrors the bounds pass): any expression shape the
walker cannot attribute — a prime applied to a compound expression, an
unresolvable UNCHANGED frame — POISONS that action to
dependent-with-everything (its matrix row and column go False and it
is never an ample candidate), with the reason journaled.  Poisoning is
per-action, not whole-spec: one exotic action costs its own
reduction, not the corpus's.

Bounds facts prune first: statically dead actions (pass 6) are
excluded from the matrix entirely — the engines prune them from the
kernel lane tables, so the facts and the kernel agree on the action
universe; an engine running ``-bounds off`` keeps dead actions in the
kernel, which then miss from the facts and are treated as
dependent-with-all (sound).

Soundness boundary: the analysis reads the SPEC's guarded commands;
the engines run hand kernels.  The drift pass (pass 5) is the bridge
— it proves the kernel's per-action semantics match the lowered spec,
which is what licenses applying spec-level independence to kernel
lanes.

The facts are cached per spec object like bounds, surfaced through
``LintReport.extras["independence"]`` (``-lint -json``), and carry a
sha digest recorded in checkpoint manifests (a resume under a flipped
``-por`` or changed facts is a policy error, mirroring pack/canon/
bounds).

A copy of ``tpuvsr/analysis/passes/independence.py``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from ..report import SEV_INFO, SEV_WARN
from .bounds import _decompose, analyze as _bounds_analyze
from .vacuity import _fold, _is_int

PASS = "independence"

#: column sentinel: the whole plane (any column)
ALL_COLS = None

_NOFOLD = object()


class _Poison(Exception):
    """This action's access sets cannot be attributed statically; it
    becomes dependent-with-everything (reason journaled)."""


# ----------------------------------------------------------------------
@dataclass
class IndependenceFacts:
    """The facts one bound spec yields — what engine/por.py consumes."""
    module: str
    action_names: list = field(default_factory=list)   # live (post-prune)
    reads: dict = field(default_factory=dict)    # name -> sorted access strs
    writes: dict = field(default_factory=dict)   # name -> sorted access strs
    poisoned: dict = field(default_factory=dict)  # name -> reason
    visible: dict = field(default_factory=dict)  # name -> bool (C2 fails)
    monotone: dict = field(default_factory=dict)  # name -> witness var|None
    matrix: list = field(default_factory=list)   # n x n bool, diag True
    pruned_dead: list = field(default_factory=list)  # bounds-dead, excluded
    inv_refused: str = None   # invariant read sets unresolvable -> all visible

    @property
    def independent_pairs(self):
        n = len(self.action_names)
        return sum(1 for i in range(n) for j in range(i + 1, n)
                   if self.matrix[i][j])

    def to_dict(self):
        return {"module": self.module,
                "actions": list(self.action_names),
                "reads": {k: list(v) for k, v in sorted(self.reads.items())},
                "writes": {k: list(v)
                           for k, v in sorted(self.writes.items())},
                "poisoned": dict(sorted(self.poisoned.items())),
                "visible": dict(sorted(self.visible.items())),
                "monotone": dict(sorted(self.monotone.items())),
                "matrix": [[bool(x) for x in row] for row in self.matrix],
                "independent_pairs": self.independent_pairs,
                "digest": self.digest}

    @property
    def digest(self):
        """Stable identity of the consumed facts — recorded in
        checkpoint manifests so a resume under a flipped ``-por`` (or
        changed facts) is a policy error, mirroring bounds/pack/canon."""
        canon = {"module": self.module,
                 "actions": list(self.action_names),
                 "matrix": [[bool(x) for x in row] for row in self.matrix],
                 "poisoned": sorted(self.poisoned),
                 "visible": sorted(k for k, v in self.visible.items() if v),
                 "monotone": sorted((k, v) for k, v in self.monotone.items()
                                    if v)}
        return hashlib.sha256(
            json.dumps(canon, sort_keys=True).encode()).hexdigest()[:12]

    def journal_doc(self):
        """The compact ``independence`` summary inside the run_start
        ``por`` object."""
        return {"independent_pairs": self.independent_pairs,
                "poisoned": sorted(self.poisoned),
                "digest": self.digest}


# ----------------------------------------------------------------------
# access-set machinery: dict var -> ALL_COLS | frozenset(columns)
# ----------------------------------------------------------------------
def _add(acc, var, cols):
    cur = acc.get(var, frozenset())
    if cols is ALL_COLS or cur is ALL_COLS:
        acc[var] = ALL_COLS
    else:
        acc[var] = cur | cols


def _cols_overlap(a, b):
    if a is ALL_COLS or b is ALL_COLS:
        return True
    return bool(a & b)


def _sets_overlap(wa, *others):
    """W(a) against a union of access sets: any shared plane with
    overlapping columns."""
    for var, cols in wa.items():
        for other in others:
            oc = other.get(var)
            if var in other and _cols_overlap(cols, oc):
                return True
    return False


def _const(e, spec):
    """Fold an index expression to a hashable constant, or _NOFOLD."""
    try:
        v = _fold(e, spec, set())
    except Exception:  # noqa: BLE001 — fold helpers raise on exotic AST
        return _NOFOLD
    if _is_int(v) or isinstance(v, (str, bool)):
        return v
    # ModelValues are interned and hashable; anything else is opaque
    from ...core.values import ModelValue
    if isinstance(v, ModelValue):
        return v
    return _NOFOLD


def _col_str(c):
    return getattr(c, "name", None) or str(c)


def _access_strs(acc):
    out = []
    for var in sorted(acc):
        cols = acc[var]
        if cols is ALL_COLS:
            out.append(var)
        else:
            out.append(f"{var}[{','.join(sorted(_col_str(c) for c in cols))}]")
    return out


def _iter_children(e):
    for x in e[1:]:
        if isinstance(x, tuple):
            yield x
        elif isinstance(x, list):
            for y in x:
                if isinstance(y, tuple):
                    yield y


def _is_prime_of_var(e, varnames):
    return (isinstance(e, tuple) and e and e[0] == "prime"
            and isinstance(e[1], tuple) and e[1]
            and e[1][0] == "id" and e[1][1] in varnames)


def _scan_expr(e, spec, varnames, reads, writes, seen):
    """One walker for guards, updates and invariants: collect column-
    refined reads and writes, inlining operator definitions, raising
    :class:`_Poison` on unattributable shapes."""
    if not isinstance(e, tuple) or not e or not isinstance(e[0], str):
        return
    tag = e[0]
    if tag == "prime":
        inner = e[1]
        if _is_prime_of_var(e, varnames):
            _add(writes, inner[1], ALL_COLS)
            return
        raise _Poison(
            f"prime applied to a "
            f"{inner[0] if isinstance(inner, tuple) and inner else inner!r} "
            f"expression — which planes it constrains is not static")
    if tag == "unchanged":
        # x' = x is the identity on every plane: no read, no write
        # (an unresolvable frame still frames SOMETHING unknown)
        try:
            spec.ev.collect_state_vars(e[1], _empty_env())
        except Exception:  # noqa: BLE001
            raise _Poison(
                "UNCHANGED frame does not resolve to a tuple of state "
                "variables") from None
        return
    if tag == "binop" and e[1] == "eq" and _is_prime_of_var(e[2], varnames):
        var = e[2][1][1]
        rhs = e[3]
        if isinstance(rhs, tuple) and rhs and rhs[0] == "except" \
                and isinstance(rhs[1], tuple) and rhs[1] \
                and rhs[1][0] == "id" and rhs[1][1] == var:
            # v' = [v EXCEPT ![c1] = e1, ...]: the untouched-column
            # copy is the identity (commutes with any column-disjoint
            # write), so only the written columns, the index
            # expressions and the replacement values count
            cols, exact = set(), True
            for path, val in rhs[2]:
                if len(path) == 1 and path[0][0] == "idx":
                    c = _const(path[0][1], spec)
                    if c is _NOFOLD:
                        exact = False
                    else:
                        cols.add(c)
                else:
                    exact = False
                for seg in path:
                    if len(seg) > 1 and isinstance(seg[1], tuple):
                        _scan_expr(seg[1], spec, varnames, reads, writes,
                                   seen)
                _scan_expr(val, spec, varnames, reads, writes, seen)
            _add(writes, var, frozenset(cols) if exact else ALL_COLS)
            return
        _add(writes, var, ALL_COLS)
        _scan_expr(rhs, spec, varnames, reads, writes, seen)
        return
    if tag == "apply" and isinstance(e[1], tuple) and e[1] \
            and e[1][0] == "id" and e[1][1] in varnames:
        c = _const(e[2], spec)
        _add(reads, e[1][1],
             ALL_COLS if c is _NOFOLD else frozenset([c]))
        _scan_expr(e[2], spec, varnames, reads, writes, seen)
        return
    if tag == "except":
        # EXCEPT in read position (not the v' = [v EXCEPT ...] shape):
        # conservative — base fully read, paths and values walked
        _scan_expr(e[1], spec, varnames, reads, writes, seen)
        for path, val in e[2]:
            for seg in path:
                if len(seg) > 1 and isinstance(seg[1], tuple):
                    _scan_expr(seg[1], spec, varnames, reads, writes, seen)
            _scan_expr(val, spec, varnames, reads, writes, seen)
        return
    if tag == "id":
        name = e[1]
        if name in varnames:
            _add(reads, name, ALL_COLS)
            return
        d = spec.module.defs.get(name)
        if d is not None and name not in seen:
            _scan_expr(d.body, spec, varnames, reads, writes,
                       seen | {name})
        return
    if tag == "call":
        d = spec.module.defs.get(e[1])
        if d is not None and e[1] not in seen:
            _scan_expr(d.body, spec, varnames, reads, writes,
                       seen | {e[1]})
    for c in _iter_children(e):
        _scan_expr(c, spec, varnames, reads, writes, seen)


def _empty_env():
    from ...interp.evalr import EMPTY_ENV
    return EMPTY_ENV


# ----------------------------------------------------------------------
def _count_primes_of(e, spec, var, seen):
    """Occurrences of ``var'`` anywhere in the action (through defs)."""
    if not isinstance(e, tuple) or not e or not isinstance(e[0], str):
        return 0
    if e[0] == "prime" and isinstance(e[1], tuple) and e[1] \
            and e[1][0] == "id" and e[1][1] == var:
        return 1
    n = 0
    if e[0] in ("call", "id"):
        d = spec.module.defs.get(e[1])
        if d is not None and e[1] not in seen:
            n += _count_primes_of(d.body, spec, var, seen | {e[1]})
    for c in _iter_children(e):
        n += _count_primes_of(c, spec, var, seen)
    return n


def _monotone_witness(action, spec, varnames, bfacts):
    """A strict-progress witness variable, or None.

    Accepted only when the action has exactly one update of ``x``
    anywhere, it is a TOP-LEVEL conjunct ``x' = x + c`` (so it holds
    on every firing), ``c`` folds to an int >= 1, and the bounds pass
    proved a finite reachable interval for ``x``."""
    if bfacts is None or not bfacts.tightened:
        return None
    _binders, _guards, updates = _decompose(action.expr, spec)
    cands = {}
    for u in updates:
        if not (isinstance(u, tuple) and u and u[0] == "binop"
                and u[1] == "eq" and _is_prime_of_var(u[2], varnames)):
            continue
        x = u[2][1][1]
        rhs = u[3]
        if not (isinstance(rhs, tuple) and rhs and rhs[0] == "binop"
                and rhs[1] == "plus"):
            continue
        a_, b_ = rhs[2], rhs[3]
        if isinstance(a_, tuple) and a_ and a_[0] == "id" and a_[1] == x:
            c = _const(b_, spec)
        elif isinstance(b_, tuple) and b_ and b_[0] == "id" and b_[1] == x:
            c = _const(a_, spec)
        else:
            continue
        if c is not _NOFOLD and _is_int(c) and c >= 1:
            cands[x] = cands.get(x, 0) + 1
    for x in sorted(cands):
        if cands[x] != 1:
            continue
        if x not in bfacts.intervals:
            continue
        if _count_primes_of(action.expr, spec, x, set()) != 1:
            continue
        return x
    return None


def _invariant_reads(spec, varnames):
    """(reads access set, refusal reason|None) over every cfg
    invariant, transitively through definitions.  Unresolvable shapes
    widen to every plane (all actions become visible)."""
    reads = {}
    for name in spec.cfg.invariants:
        d = spec.module.defs.get(name)
        if d is None:
            return ({v: ALL_COLS for v in varnames},
                    f"invariant {name} is not defined in the module")
        scratch_w = {}
        try:
            _scan_expr(d.body, spec, varnames, reads, scratch_w,
                       frozenset([name]))
        except _Poison as p:
            return ({v: ALL_COLS for v in varnames},
                    f"invariant {name}: {p}")
        if scratch_w:
            return ({v: ALL_COLS for v in varnames},
                    f"invariant {name} primes state")
    return reads, None


# ----------------------------------------------------------------------
def analyze(spec) -> IndependenceFacts:
    """Compute (and cache per spec object) the independence facts."""
    cached = getattr(spec, "_indep_facts", None)
    if cached is not None:
        return cached
    facts = _analyze(spec)
    spec._indep_facts = facts
    return facts


def _analyze(spec) -> IndependenceFacts:
    varnames = set(spec.module.variables)
    facts = IndependenceFacts(module=spec.module.name)
    bfacts = _bounds_analyze(spec)

    # dead actions never fire: exclude them from the matrix (the
    # engines prune them from the kernel under the same facts)
    dead = set(bfacts.dead_actions)
    live = [a for a in spec.actions if a.name not in dead]
    facts.pruned_dead = sorted(dead)
    facts.action_names = [a.name for a in live]

    inv_reads, inv_refused = _invariant_reads(spec, varnames)
    facts.inv_refused = inv_refused

    access = {}
    for action in live:
        reads, writes = {}, {}
        try:
            _binders, guards, updates = _decompose(action.expr, spec)
            for g in guards:
                _scan_expr(g, spec, varnames, reads, writes, frozenset())
            for u in updates:
                _scan_expr(u, spec, varnames, reads, writes, frozenset())
        except _Poison as p:
            facts.poisoned[action.name] = str(p)
            reads = {v: ALL_COLS for v in varnames}
            writes = {v: ALL_COLS for v in varnames}
        access[action.name] = (reads, writes)
        facts.reads[action.name] = _access_strs(reads)
        facts.writes[action.name] = _access_strs(writes)
        facts.visible[action.name] = _sets_overlap(writes, inv_reads)
        facts.monotone[action.name] = (
            None if action.name in facts.poisoned
            else _monotone_witness(action, spec, varnames, bfacts))

    n = len(live)
    mat = [[False] * n for _ in range(n)]
    for i, ai in enumerate(live):
        mat[i][i] = True
        ri, wi = access[ai.name]
        for j in range(i + 1, n):
            aj = live[j]
            if ai.name in facts.poisoned or aj.name in facts.poisoned:
                continue
            rj, wj = access[aj.name]
            indep = not _sets_overlap(wi, rj, wj) and \
                not _sets_overlap(wj, ri, wi)
            mat[i][j] = mat[j][i] = indep
    facts.matrix = mat
    return facts


# ----------------------------------------------------------------------
# the lint pass
# ----------------------------------------------------------------------
def run(spec, report):
    facts = analyze(spec)
    report.extras["independence"] = facts.to_dict()
    for name, why in sorted(facts.poisoned.items()):
        report.add(PASS, SEV_WARN, name,
                   f"access sets unattributable ({why}); treated as "
                   f"dependent with every action (never an ample "
                   f"candidate)")
    if facts.inv_refused:
        report.add(PASS, SEV_WARN, spec.module.name,
                   f"invariant read sets unresolvable "
                   f"({facts.inv_refused}); every action is treated "
                   f"as visible — POR stands down")
    n = len(facts.action_names)
    report.add(PASS, SEV_INFO, spec.module.name,
               f"{facts.independent_pairs} independent pair(s) over "
               f"{n} live action(s) "
               f"({len(facts.poisoned)} poisoned, "
               f"{sum(1 for v in facts.visible.values() if not v)} "
               f"invariant-invisible, "
               f"{sum(1 for v in facts.monotone.values() if v)} with "
               f"monotone witnesses)")
