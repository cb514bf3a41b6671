"""Pass 1 — frame completeness.

The reference corpus's only frame discipline is TLC failing at runtime
with "successor state not completely specified", hours into a run.
This pass proves the same property statically, per action:

* every declared state variable is PRIMED or in the UNCHANGED frame on
  every execution path through the action (ERROR when a variable is
  constrained nowhere at all — the interpreter's ActionEnumerator
  raises exactly then; WARN when it is primed on some paths but not
  provably on all, since path-insensitive analysis over-approximates);
* no double prime (``x''`` — always a typo);
* priming a non-variable identifier is flagged (a primed operator is
  legal TLA+ but outside the corpus subset the lowerer accepts);
* a variable both primed and UNCHANGED across sibling conjuncts of one
  action is flagged (legal TLA+ — it degenerates to an equality guard
  — but in this corpus it is always an editing mistake);
* guard/update classification soundness: a disjunction whose branches
  disagree about priming (some branches update, some are pure guards)
  is flagged, because the lowerer compiles disjunctions of updates
  branch-exclusively (lower/compile.py docstring).

The assignment analysis mirrors interp/actions.ActionEnumerator's
semantics: ``x' = e`` binds, UNCHANGED binds the flattened tuple,
conjunction is sequential, disjunction/IF/CASE fork paths, operator
calls inline when they (transitively) touch primes.

A copy of ``tpuvsr/analysis/passes/frames.py``.
"""

from __future__ import annotations

from ...interp.evalr import EMPTY_ENV
from ..report import SEV_ERROR, SEV_INFO, SEV_WARN

PASS = "frames"


def run(spec, report):
    varnames = set(spec.module.variables)
    if not varnames:
        report.add(PASS, SEV_INFO, spec.module.name,
                   "module declares no VARIABLES; nothing to frame")
        return
    for action in spec.actions:
        _check_action(spec, action, varnames, report)


# ----------------------------------------------------------------------
def _check_action(spec, action, varnames, report):
    ev = spec.ev
    defs = spec.module.defs
    name = action.name

    # liberal over-approximation: every variable primed anywhere in the
    # action (including through called operators and all branches)
    primed_any = set()
    unchanged_any = set()
    notes = {"double_prime": [], "nonvar_prime": set(),
             "bad_frame": set()}
    _scan(action.expr, ev, defs, varnames, primed_any, unchanged_any,
          notes, set(), under_prime=False)

    for sub in notes["double_prime"]:
        report.add(PASS, SEV_ERROR, name,
                   f"double prime on {sub!r} (x'' is never meaningful)")
    for sub in sorted(notes["nonvar_prime"]):
        report.add(PASS, SEV_WARN, name,
                   f"prime applied to {sub!r}, which is not a declared "
                   f"state variable")
    for sub in sorted(notes["bad_frame"]):
        report.add(PASS, SEV_WARN, name,
                   f"UNCHANGED frame {sub!r} does not resolve to a "
                   f"tuple of state variables; coverage assumed from "
                   f"the variables it mentions")

    # strict under-approximation: variables assigned on EVERY path
    assigned_all = _assigned(action.expr, ev, defs, varnames, set())

    for v in sorted(varnames - primed_any - unchanged_any):
        report.add(PASS, SEV_ERROR, name,
                   f"state variable {v!r} is neither primed nor in the "
                   f"UNCHANGED frame (successor under-specified; the "
                   f"interpreter would fail at the first enabled step)")
    for v in sorted((varnames - assigned_all)
                    & (primed_any | unchanged_any)):
        report.add(PASS, SEV_WARN, name,
                   f"state variable {v!r} is framed on some paths but "
                   f"not provably on all execution paths")

    # double frame across sibling conjuncts of the (binder-stripped)
    # top-level conjunction — path-insensitive, so restricted to the
    # one level where it cannot false-positive on IF/\/ branch splits
    conjuncts = _top_conjuncts(action.expr)
    if len(conjuncts) > 1:
        per = [(_primes_direct(c, ev, defs, varnames, set()),
                _unchanged_direct(c, ev, varnames)) for c in conjuncts]
        for i, (pi, _ui) in enumerate(per):
            for j, (_pj, uj) in enumerate(per):
                if i == j:
                    continue
                for v in sorted(pi & uj):
                    report.add(
                        PASS, SEV_WARN, name,
                        f"{v!r} is primed in one conjunct and UNCHANGED "
                        f"in a sibling conjunct (degenerates to an "
                        f"equality guard — almost certainly a stale "
                        f"frame)")

    # guard/update classification: disjunction with mixed branches
    _check_mixed_disjunctions(action.expr, ev, defs, varnames, name,
                              report, set())


# ----------------------------------------------------------------------
# walkers
# ----------------------------------------------------------------------
def _iter_children(e):
    for x in e[1:]:
        if isinstance(x, tuple):
            yield x
        elif isinstance(x, list):
            for y in x:
                if isinstance(y, tuple):
                    yield y
                elif isinstance(y, (list,)):
                    for z in y:
                        if isinstance(z, tuple):
                            yield z


def _scan(e, ev, defs, varnames, primed, unchanged, notes, seen,
          under_prime):
    """Collect primed/UNCHANGED variables anywhere in the expression,
    inlining operator definitions that touch primes."""
    if not isinstance(e, tuple) or not e:
        return
    tag = e[0]
    if tag == "prime":
        inner = e[1]
        if under_prime or _contains_tag(inner, "prime"):
            notes["double_prime"].append(_describe(inner))
        if inner[0] == "id":
            if inner[1] in varnames:
                primed.add(inner[1])
            else:
                notes["nonvar_prime"].add(inner[1])
        else:
            # prime of a compound expression: every state var inside is
            # potentially constrained — treat them as primed (liberal)
            for v in _ids_in(inner, varnames):
                primed.add(v)
            notes["nonvar_prime"].add(_describe(inner))
        _scan(inner, ev, defs, varnames, primed, unchanged, notes, seen,
              under_prime=True)
        return
    if tag == "unchanged":
        try:
            unchanged.update(ev.collect_state_vars(e[1], EMPTY_ENV))
        except Exception:  # noqa: BLE001 — unresolvable frame expr
            # stay liberal: treat every state var mentioned inside the
            # frame as covered, so an exotic-but-correct frame cannot
            # produce a false unframed ERROR (it gets a WARN instead)
            unchanged.update(_ids_in(e[1], varnames))
            notes["bad_frame"].add(_describe(e[1]))
        return
    if tag in ("call", "id"):
        dname = e[1]
        d = defs.get(dname)
        if d is not None and dname not in seen and ev.touches_primes(dname):
            seen = seen | {dname}
            _scan(d.body, ev, defs, varnames, primed, unchanged, notes,
                  seen, under_prime)
    for c in _iter_children(e):
        _scan(c, ev, defs, varnames, primed, unchanged, notes, seen,
              under_prime)


def _assigned(e, ev, defs, varnames, seen):
    """Variables definitely framed on EVERY path (under-approximation:
    mirrors ActionEnumerator's binding forms)."""
    if not isinstance(e, tuple) or not e:
        return frozenset()
    tag = e[0]
    if tag == "and":
        out = set()
        for x in e[1]:
            out |= _assigned(x, ev, defs, varnames, seen)
        return frozenset(out)
    if tag == "or":
        branches = [_assigned(x, ev, defs, varnames, seen) for x in e[1]]
        return frozenset.intersection(*branches) if branches \
            else frozenset()
    if tag == "exists":
        return _assigned(e[2], ev, defs, varnames, seen)
    if tag == "binop" and e[1] == "eq" and e[2][0] == "prime" \
            and e[2][1][0] == "id" and e[2][1][1] in varnames:
        return frozenset((e[2][1][1],))
    if tag == "unchanged":
        try:
            return frozenset(ev.collect_state_vars(e[1], EMPTY_ENV))
        except Exception:  # noqa: BLE001
            return frozenset()
    if tag == "if":
        return _assigned(e[2], ev, defs, varnames, seen) \
            & _assigned(e[3], ev, defs, varnames, seen)
    if tag == "case":
        branches = [_assigned(v, ev, defs, varnames, seen)
                    for _g, v in e[1]]
        if e[2] is not None:
            branches.append(_assigned(e[2], ev, defs, varnames, seen))
        return frozenset.intersection(*branches) if branches \
            else frozenset()
    if tag in ("call", "id"):
        dname = e[1]
        d = defs.get(dname)
        if d is not None and dname not in seen and ev.touches_primes(dname):
            return _assigned(d.body, ev, defs, varnames, seen | {dname})
        return frozenset()
    if tag == "let":
        return _assigned(e[2], ev, defs, varnames, seen)
    return frozenset()


def _top_conjuncts(e):
    """Flatten the top-level conjunction, descending through the
    leading existential chain (the lane-binder shape, lower/ir.py)."""
    if not isinstance(e, tuple):
        return []
    if e[0] == "exists":
        return _top_conjuncts(e[2])
    if e[0] == "and":
        out = []
        for x in e[1]:
            if isinstance(x, tuple) and x[0] == "exists":
                out.extend(_top_conjuncts(x))
            else:
                out.append(x)
        return out
    return [e]


def _primes_direct(e, ev, defs, varnames, seen):
    out, unch = set(), set()
    notes = {"double_prime": [], "nonvar_prime": set(),
             "bad_frame": set()}
    _scan(e, ev, defs, varnames, out, unch, notes, seen,
          under_prime=False)
    return out


def _unchanged_direct(e, ev, varnames):
    out = set()
    if isinstance(e, tuple) and e and e[0] == "unchanged":
        try:
            out.update(ev.collect_state_vars(e[1], EMPTY_ENV))
        except Exception:  # noqa: BLE001
            pass
    return out


def _check_mixed_disjunctions(e, ev, defs, varnames, action_name,
                              report, seen):
    if not isinstance(e, tuple) or not e:
        return
    if e[0] == "or" and len(e[1]) > 1:
        priming = [bool(_primes_direct(x, ev, defs, varnames, set()))
                   for x in e[1]]
        if any(priming) and not all(priming):
            report.add(
                PASS, SEV_WARN, action_name,
                f"disjunction mixes updating and guard-only branches "
                f"({sum(priming)}/{len(priming)} branches prime state); "
                f"the lowerer requires branch-exclusive update "
                f"disjunctions")
    if e[0] in ("call", "id"):
        dname = e[1]
        d = defs.get(dname)
        if d is not None and dname not in seen and ev.touches_primes(dname):
            _check_mixed_disjunctions(d.body, ev, defs, varnames,
                                      action_name, report,
                                      seen | {dname})
    for c in _iter_children(e):
        _check_mixed_disjunctions(c, ev, defs, varnames, action_name,
                                  report, seen)


# ----------------------------------------------------------------------
def _contains_tag(e, tag):
    if not isinstance(e, tuple) or not e:
        return False
    if e[0] == tag:
        return True
    return any(_contains_tag(c, tag) for c in _iter_children(e))


def _ids_in(e, varnames):
    out = set()
    if not isinstance(e, tuple) or not e:
        return out
    if e[0] == "id" and e[1] in varnames:
        out.add(e[1])
    for c in _iter_children(e):
        out |= _ids_in(c, varnames)
    return out


def _describe(e):
    if isinstance(e, tuple) and e and e[0] == "id":
        return e[1]
    if isinstance(e, tuple) and e and e[0] == "call":
        return f"{e[1]}(...)"
    return f"<{e[0]} expression>" if isinstance(e, tuple) and e \
        else repr(e)
