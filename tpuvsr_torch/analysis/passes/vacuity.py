"""Pass 3 — vacuity / dead-action lint.

Constant-folds every action's guard conjuncts and every registered
invariant under the bound cfg constants.  A guard that folds to FALSE
means the action can never fire under this configuration (dead action
— WARN, because config-gating an action via a zero limit is sometimes
intentional, e.g. CrashLimit = 0); an invariant that folds to TRUE is
vacuous (WARN — it checks nothing); one that folds to FALSE would fail
on every state (ERROR).  IF conditions that fold constant mark an
unreachable branch.

Folding is a partial evaluator: literals, bound integer/boolean/
model-value constants, parameterless operator definitions, boolean and
arithmetic operators over folded operands.  State variables fold to
"unknown" — EXCEPT for the monotone aux counters (aux_svc,
aux_restart, no_progress_ctr), which are known nonnegative from their
Init/update discipline, so ``counter < K`` folds to FALSE whenever the
limit K folds to a value <= 0.  That is exactly the corpus's
config-gating idiom (TimerSendSVC under StartViewOnTimerLimit,
RestartEmpty under RestartEmptyLimit, NoProgressChange under
NoProgressChangeLimit).

A copy of ``tpuvsr/analysis/passes/vacuity.py``.
"""

from __future__ import annotations

from ...core.values import ModelValue
from ..report import SEV_ERROR, SEV_INFO, SEV_WARN

PASS = "vacuity"

# scalar state counters provably >= 0 (established at Init = 0 and only
# ever incremented); used to kill `ctr < K` guards for K <= 0
NONNEG_COUNTERS = ("aux_svc", "aux_restart", "no_progress_ctr")

_UNKNOWN = object()


def run(spec, report):
    for action in spec.actions:
        dead = False
        for conj in _guard_conjuncts(action.expr, spec):
            v = _fold(conj, spec, set())
            if v is False and not dead:
                dead = True
                report.add(PASS, SEV_WARN, action.name,
                           "guard conjunct is statically FALSE under "
                           "the bound cfg constants — the action can "
                           "never fire (dead action)")
            elif v is True:
                report.add(PASS, SEV_INFO, action.name,
                           "guard conjunct is trivially TRUE under the "
                           "bound cfg constants")
        _scan_branches(action.expr, spec, action.name, report, set())

    # the port's SpecModel.invariants holds the cfg's names
    for inv_name in spec.invariants:
        v = _fold(spec.module.defs[inv_name].body, spec, set())
        if v is True:
            report.add(PASS, SEV_WARN, inv_name,
                       "invariant folds to TRUE under the bound cfg "
                       "constants — it is vacuous and checks nothing")
        elif v is False:
            report.add(PASS, SEV_ERROR, inv_name,
                       "invariant folds to FALSE under the bound cfg "
                       "constants — every state would violate it")


# ----------------------------------------------------------------------
def _guard_conjuncts(e, spec):
    """Top-level non-priming conjuncts, descending through the leading
    existential chain (the uniform corpus action shape)."""
    from ...lower.ir import contains_prime
    out = []

    def walk(x):
        if not isinstance(x, tuple) or not x:
            return
        if x[0] == "exists":
            walk(x[2])
        elif x[0] == "and":
            for item in x[1]:
                walk(item)
        elif not contains_prime(x, spec.module):
            out.append(x)
    walk(e)
    return out


def _scan_branches(e, spec, action_name, report, seen):
    """Flag IF conditions that fold constant (unreachable branch)."""
    if not isinstance(e, tuple) or not e:
        return
    if e[0] == "if":
        v = _fold(e[1], spec, set())
        if v in (True, False):
            report.add(PASS, SEV_WARN, action_name,
                       f"IF condition folds to {v} under the bound cfg "
                       f"constants — the "
                       f"{'ELSE' if v else 'THEN'} branch is "
                       f"unreachable")
    if e[0] in ("call", "id"):
        d = spec.module.defs.get(e[1])
        if d is not None and e[1] not in seen \
                and spec.ev.touches_primes(e[1]):
            _scan_branches(d.body, spec, action_name, report,
                           seen | {e[1]})
    for x in e[1:]:
        if isinstance(x, tuple):
            _scan_branches(x, spec, action_name, report, seen)
        elif isinstance(x, list):
            for y in x:
                if isinstance(y, tuple):
                    _scan_branches(y, spec, action_name, report, seen)


# ----------------------------------------------------------------------
# partial evaluator
# ----------------------------------------------------------------------
def _fold(e, spec, seen):
    """Fold to a Python value, or _UNKNOWN."""
    return _fold_inner(e, spec, seen)


def _fold_inner(e, spec, seen):
    if not isinstance(e, tuple) or not e:
        return _UNKNOWN
    tag = e[0]
    if tag == "num":
        return e[1]
    if tag == "bool":
        return e[1]
    if tag == "str":
        return e[1]
    if tag == "id":
        name = e[1]
        c = spec.ev.constants.get(name)
        if isinstance(c, (int, bool, str, frozenset, ModelValue)):
            return c
        d = spec.module.defs.get(name)
        if d is not None and not d.params and name not in seen:
            return _fold_inner(d.body, spec, seen | {name})
        return _UNKNOWN
    if tag == "not":
        v = _fold_inner(e[1], spec, seen)
        return (not v) if isinstance(v, bool) else _UNKNOWN
    if tag == "neg":
        v = _fold_inner(e[1], spec, seen)
        return -v if _is_int(v) else _UNKNOWN
    if tag == "and":
        vals = [_fold_inner(x, spec, seen) for x in e[1]]
        if any(v is False for v in vals):
            return False
        if all(v is True for v in vals):
            return True
        return _UNKNOWN
    if tag == "or":
        vals = [_fold_inner(x, spec, seen) for x in e[1]]
        if any(v is True for v in vals):
            return True
        if all(v is False for v in vals):
            return False
        return _UNKNOWN
    if tag == "if":
        c = _fold_inner(e[1], spec, seen)
        if c is True:
            return _fold_inner(e[2], spec, seen)
        if c is False:
            return _fold_inner(e[3], spec, seen)
        return _UNKNOWN
    if tag == "binop":
        return _fold_binop(e, spec, seen)
    return _UNKNOWN


def _fold_binop(e, spec, seen):
    op = e[1]
    a = _fold_inner(e[2], spec, seen)
    b = _fold_inner(e[3], spec, seen)

    # nonneg-counter special case: `ctr < K` / `ctr >= K` with K folded
    if a is _UNKNOWN and _is_counter(e[2]) and _is_int(b):
        if op == "lt" and b <= 0:
            return False
        if op == "le" and b < 0:
            return False
        if op == "ge" and b <= 0:
            return True
        if op == "gt" and b < 0:
            return True
        return _UNKNOWN
    if a is _UNKNOWN or b is _UNKNOWN:
        return _UNKNOWN

    if op in ("plus", "minus", "times", "div", "mod") and _is_int(a) \
            and _is_int(b):
        if op == "plus":
            return a + b
        if op == "minus":
            return a - b
        if op == "times":
            return a * b
        if op == "div" and b != 0:
            return a // b
        if op == "mod" and b != 0:
            return a % b
        return _UNKNOWN
    if op in ("lt", "le", "gt", "ge") and _is_int(a) and _is_int(b):
        return {"lt": a < b, "le": a <= b,
                "gt": a > b, "ge": a >= b}[op]
    if op == "eq":
        return _const_eq(a, b)
    if op == "ne":
        v = _const_eq(a, b)
        return (not v) if isinstance(v, bool) else _UNKNOWN
    if op == "in" and isinstance(b, frozenset):
        return a in b
    if op == "notin" and isinstance(b, frozenset):
        return a not in b
    return _UNKNOWN


def _const_eq(a, b):
    if isinstance(a, ModelValue) or isinstance(b, ModelValue):
        # TLC model-value semantics: equal only to itself; comparison
        # with a different *kind* of value is an error, not False —
        # stay unknown unless both are model values
        if isinstance(a, ModelValue) and isinstance(b, ModelValue):
            return a is b or a.name == b.name
        return _UNKNOWN
    if type(a) is type(b):
        return a == b
    return _UNKNOWN


def _is_int(v):
    return isinstance(v, int) and not isinstance(v, bool)


def _is_counter(e):
    return isinstance(e, tuple) and e and e[0] == "id" \
        and e[1] in NONNEG_COUNTERS
