"""Pass 6 — symbolic interval analysis ("bounds"): the Apalache-style
pre-pass over the cfg-instantiated spec (the TLA+ Trifecta framing,
arxiv 2211.07216).

Every other speclint pass proves a property and stops; this one
computes FACTS the engines consume:

* **reachable intervals** — a least fixpoint of interval/finite-domain
  transfer functions over the state variables, starting from Init and
  joining every action's guarded updates.  The result is a sound
  over-approximation of the reachable values, so a ``plane_bounds``
  budget intersected with it still round-trips every reachable state
  EXACTLY — ``engine/pack.build_pack_spec(tighten=...)`` packs
  *reachable* ranges instead of declared ones (fewer bits/state,
  bit-identical results);
* **statically dead actions** — a guard conjunct that constant-folds
  to FALSE under the bound constants (the vacuity pass's partial
  evaluator), or whose interval refinement against the reachable
  fixpoint is empty, can never fire: the engines drop the action from
  the kernel's lane tables (``engine/bounds.prune_kernel``), shrinking
  the fused commit's guard matrix;
* **per-action fanout** — the product of the action's lane-binder
  domain cardinalities is an upper bound on simultaneously enabled
  lanes per state (exact when no guard mentions a binder): the fused
  commit seeds its per-action expansion caps from it, so exact-bounds
  fixtures run with ZERO growth redraws;
* **state-space upper bound** — ``|S| <= prod(var domain sizes)``
  after dead-variable elimination; the dispatch service's admission
  gate compares it against the requested tier's capacity and rejects
  provably oversized submissions before any device time.

Trust contract: the facts are only consumed when the speclint gate is
live — ``-lint=off`` / ``TPUVSR_LINT=off`` also disables bounds
consumption (``-bounds on`` under a disabled gate is a CLI conflict),
and every engine guards the tightened configuration with the
"bit-identical verdict and counts vs untightened" oracles in
``tests/test_bounds.py``.

Refusal policy: the transfer functions cover the corpus's guarded-
command arithmetic (literals, bound constants, ``+``/``-``, constant
scaling, IF, comparisons and set membership against foldable values).
A guard conjunct that mentions a state variable in a shape the
abstract domain cannot interpret (e.g. a NONLINEAR guard ``x * x < K``)
makes the pass REFUSE tightening outright — ``tightened: false`` is
journaled, engines fall back to declared plane bounds and full action
lists (dead actions proven by pure constant folding are still safe to
prune).  Refusing is deliberately blunter than soundness requires
(ignoring an uninterpretable guard would still over-approximate); the
blunt rule keeps "what did the engines trust" a one-bit answer.

The declared-range side of every comparison comes from ONE source —
``widths.derive_ranges`` — the same table ``plane_bounds``/
``build_pack_spec`` read (a codec width edit cannot silently diverge
from the lint table; the drift pass round-trips the tightened packing
too).

A copy of ``tpuvsr/analysis/passes/bounds.py``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from ...core.values import ModelValue
from ...lower.ir import contains_prime
from ..report import SEV_INFO, SEV_WARN
from .vacuity import _fold, _is_int

PASS = "bounds"

#: fixpoint iteration cap; non-convergence refuses tightening (the
#: corpus's monotone counters converge in O(limit) joins)
MAX_ITERS = 64

_INF = float("inf")


class _Refuse(Exception):
    """Tightening must be refused (uninterpretable guard, divergent
    fixpoint); carries the reason journaled as bounds{tightened:false}."""


class _Unsupported(Exception):
    """One expression is outside the abstract domain (poisons its
    target variable, does not refuse the whole analysis)."""


# ----------------------------------------------------------------------
# abstract values: ("ival", lo, hi) closed int interval |
#                  ("set", frozenset) finite value domain |
#                  TOP (unknown/poisoned) — None is bottom (unassigned)
# ----------------------------------------------------------------------
TOP = ("top",)


def _ival(lo, hi):
    return ("ival", int(lo), int(hi))


def _hull(av):
    """Interval hull of an abstract value, or None when not integer."""
    if av is TOP:
        return None
    if av[0] == "ival":
        return av
    if all(_is_int(x) for x in av[1]):
        if not av[1]:
            return None
        return _ival(min(av[1]), max(av[1]))
    return None


def _size(av):
    if av is TOP:
        return None
    if av[0] == "set":
        return len(av[1])
    return av[2] - av[1] + 1


def _as_set(av, limit=64):
    """Promote a small interval to an explicit set (mixed int /
    model-value domains — e.g. an int-0 "unset" slot joined with a
    symmetric value set)."""
    if av[0] == "set":
        return av
    if av[2] - av[1] + 1 <= limit:
        return ("set", frozenset(range(av[1], av[2] + 1)))
    return None


def _join(a, b):
    if a is TOP or b is TOP:
        return TOP
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == "set" or b[0] == "set":
        sa, sb = _as_set(a), _as_set(b)
        if sa is not None and sb is not None:
            merged = sa[1] | sb[1]
            if all(_is_int(x) for x in merged):
                return _ival(min(merged), max(merged))
            return ("set", merged)
    ha, hb = _hull(a), _hull(b)
    if ha is None or hb is None:
        return TOP
    return _ival(min(ha[1], hb[1]), max(ha[2], hb[2]))


def _meet_ival(av, lo, hi):
    """Meet an abstract value with [lo, hi]; returns the new value or
    False when empty (the guard is unsatisfiable)."""
    if av is TOP:
        return TOP                 # unknown var: refinement is a no-op
    if av[0] == "ival":
        nlo, nhi = max(av[1], lo), min(av[2], hi)
        return _ival(nlo, nhi) if nlo <= nhi else False
    kept = frozenset(x for x in av[1]
                     if not _is_int(x) or lo <= x <= hi)
    return ("set", kept) if kept else False


# ----------------------------------------------------------------------
@dataclass
class BoundsFacts:
    """The facts one bound spec yields — what the engines consume."""
    module: str
    tightened: bool
    refused: str = None            # why tightening was refused
    intervals: dict = field(default_factory=dict)   # var -> (lo, hi)
    domain_sizes: dict = field(default_factory=dict)  # var -> |domain|
    dead_actions: list = field(default_factory=list)
    dead_reasons: dict = field(default_factory=dict)
    fanout: dict = field(default_factory=dict)      # action -> int
    fanout_exact: dict = field(default_factory=dict)
    state_bound: int = None

    def to_dict(self):
        return {"module": self.module, "tightened": self.tightened,
                "refused": self.refused,
                "intervals": {k: list(v)
                              for k, v in sorted(self.intervals.items())},
                "dead_actions": list(self.dead_actions),
                "fanout": dict(sorted(self.fanout.items())),
                "state_bound": self.state_bound,
                "digest": self.digest}

    @property
    def digest(self):
        """Stable identity of the consumed facts — recorded in
        checkpoint manifests so a resume under a flipped ``-bounds``
        (or a changed facts table) is a policy error, mirroring the
        pack/canon rules."""
        canon = {"module": self.module, "tightened": self.tightened,
                 "intervals": sorted((k, int(v[0]), int(v[1]))
                                     for k, v in self.intervals.items()),
                 "dead": sorted(self.dead_actions),
                 "state_bound": self.state_bound}
        return hashlib.sha256(
            json.dumps(canon, sort_keys=True).encode()).hexdigest()[:12]

    def plane_tighten(self):
        """The per-plane tightening map ``build_pack_spec`` intersects
        with the codec's declared ``plane_bounds``: reachable int
        intervals keyed by state-variable name (codecs whose plane keys
        are the variable names — the stub family — tighten directly;
        the registered corpus layouts read the shared
        ``widths.derive_ranges`` quantity table instead)."""
        return dict(self.intervals) if self.tightened else {}

    def journal_doc(self):
        """The compact ``bounds`` object journaled on run_start."""
        return {"tightened": self.tightened,
                "dead_actions": list(self.dead_actions),
                "state_bound": self.state_bound}


# ----------------------------------------------------------------------
# expression-level helpers
# ----------------------------------------------------------------------
def _mentions(e, names):
    """Does `e` mention any identifier in `names` (direct, no operator
    expansion — guards hidden behind definitions refine nothing and
    refuse nothing: ignoring them only widens the over-approximation)."""
    if not isinstance(e, tuple) or not e:
        return False
    if e[0] == "id":
        return e[1] in names
    for x in e[1:]:
        if isinstance(x, tuple) and _mentions(x, names):
            return True
        if isinstance(x, list):
            for y in x:
                if isinstance(y, tuple) and _mentions(y, names):
                    return True
    return False


def _primed_vars(e, spec, out, _seen=None):
    """Collect state variables primed (transitively) by `e`."""
    if _seen is None:
        _seen = set()
    if not isinstance(e, tuple) or not e:
        return
    if e[0] == "prime":
        inner = e[1]
        if isinstance(inner, tuple) and inner and inner[0] == "id":
            out.add(inner[1])
        else:
            out.update(spec.module.variables)     # conservative
        return
    if e[0] in ("call", "id"):
        d = spec.module.defs.get(e[1])
        if d is not None and e[1] not in _seen:
            _seen.add(e[1])
            _primed_vars(d.body, spec, out, _seen)
    for x in e[1:]:
        if isinstance(x, tuple):
            _primed_vars(x, spec, out, _seen)
        elif isinstance(x, list):
            for y in x:
                if isinstance(y, tuple):
                    _primed_vars(y, spec, out, _seen)


def _aeval(e, spec, env, benv):
    """Abstract evaluation of an integer/value expression under the
    variable environment `env` and binder domains `benv`."""
    if not isinstance(e, tuple) or not e:
        raise _Unsupported(repr(e))
    tag = e[0]
    if tag == "num":
        return _ival(e[1], e[1])
    if tag == "id":
        name = e[1]
        if name in benv:
            dv = benv[name]
            if dv is None:
                raise _Unsupported(f"binder {name} domain")
            return dv
        if name in env:
            av = env[name]
            if av is TOP or av is None:
                raise _Unsupported(f"variable {name} is unbounded")
            return av
        v = _fold(e, spec, set())
        if _is_int(v):
            return _ival(v, v)
        if isinstance(v, (ModelValue, str, bool)):
            return ("set", frozenset([v]))
        raise _Unsupported(name)
    if tag == "neg":
        h = _hull(_aeval(e[1], spec, env, benv))
        if h is None:
            raise _Unsupported("neg of non-integer")
        return _ival(-h[2], -h[1])
    if tag == "if":
        c = _fold(e[1], spec, set())
        if c is True:
            return _aeval(e[2], spec, env, benv)
        if c is False:
            return _aeval(e[3], spec, env, benv)
        j = _join(_aeval(e[2], spec, env, benv),
                  _aeval(e[3], spec, env, benv))
        if j is TOP:
            raise _Unsupported("if-join")
        return j
    if tag == "binop":
        op = e[1]
        if op in ("plus", "minus", "times"):
            a = _hull(_aeval(e[2], spec, env, benv))
            b = _hull(_aeval(e[3], spec, env, benv))
            if a is None or b is None:
                raise _Unsupported(op)
            if op == "plus":
                return _ival(a[1] + b[1], a[2] + b[2])
            if op == "minus":
                return _ival(a[1] - b[2], a[2] - b[1])
            # times: constant scaling only — general interval products
            # are where precision (and the corpus) ends
            if a[1] == a[2]:
                c, iv = a[1], b
            elif b[1] == b[2]:
                c, iv = b[1], a
            else:
                raise _Unsupported("nonlinear times")
            lo, hi = c * iv[1], c * iv[2]
            return _ival(min(lo, hi), max(lo, hi))
    raise _Unsupported(tag)


def _domain_value(dom, spec):
    """A binder's domain expression -> abstract value (or None when it
    is not statically enumerable)."""
    v = _fold(dom, spec, set())
    if isinstance(v, frozenset):
        return ("set", v) if v else None
    if isinstance(dom, tuple) and dom and dom[0] == "binop" \
            and dom[1] == "range":
        lo = _fold(dom[2], spec, set())
        hi = _fold(dom[3], spec, set())
        if _is_int(lo) and _is_int(hi) and lo <= hi:
            return _ival(lo, hi)
    return None


# ----------------------------------------------------------------------
# action decomposition
# ----------------------------------------------------------------------
def _decompose(expr, spec):
    """(binders, guards, updates) of one action body: the top-level
    existential chain (any statically enumerable domain, not just the
    lane-liftable corpus tags), the non-priming conjuncts, and the
    priming ones."""
    binders, guards, updates = [], [], []

    def walk(e):
        if not isinstance(e, tuple) or not e:
            return
        if e[0] == "and":
            for x in e[1]:
                walk(x)
        elif e[0] == "exists":
            for names, dom in e[1]:
                dv = _domain_value(dom, spec)
                for n in names:
                    binders.append((n, dv))
            walk(e[2])
        elif e[0] == "unchanged":
            pass                    # x' = x: joins nothing new
        elif contains_prime(e, spec.module):
            updates.append(e)
        else:
            guards.append(e)

    walk(expr)
    return binders, guards, updates


_CMP = {"lt": lambda c: (-_INF, c - 1), "le": lambda c: (-_INF, c),
        "gt": lambda c: (c + 1, _INF), "ge": lambda c: (c, _INF),
        "eq": lambda c: (c, c)}
_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _refine(g, spec, env, benv, varnames):
    """Refine `env` in place by one guard conjunct.  Returns False when
    the guard is unsatisfiable under `env`, True otherwise.  Raises
    :class:`_Refuse` on a state-variable guard outside the domain."""
    v = _fold(g, spec, set())
    if v is False:
        return False
    if v is True:
        return True
    if isinstance(g, tuple) and g and g[0] == "binop":
        op, lhs, rhs = g[1], g[2], g[3]
        if isinstance(rhs, tuple) and rhs[0] == "id" \
                and rhs[1] in varnames and not (
                isinstance(lhs, tuple) and lhs[0] == "id"
                and lhs[1] in varnames):
            lhs, rhs = rhs, lhs
            op = _SWAP.get(op, op)
        if isinstance(lhs, tuple) and lhs[0] == "id" \
                and lhs[1] in varnames:
            var = lhs[1]
            c = _fold(rhs, spec, set())
            if op in _CMP and _is_int(c):
                lo, hi = _CMP[op](c)
                lo = -(1 << 62) if lo == -_INF else lo
                hi = (1 << 62) if hi == _INF else hi
                m = _meet_ival(env.get(var, TOP), lo, hi)
                if m is False:
                    return False
                env[var] = m
                return True
            if op == "eq" and isinstance(c, (ModelValue, str, bool)):
                av = env.get(var, TOP)
                if av is not TOP and av is not None and av[0] == "set":
                    kept = frozenset(
                        x for x in av[1]
                        if isinstance(x, type(c))
                        and (x is c or getattr(x, "name", x)
                             == getattr(c, "name", c)))
                    if not kept:
                        return False
                    env[var] = ("set", kept)
                return True
            if op == "in":
                # the SAME domain logic Init and binder chains use
                # (_domain_value understands folded sets AND lo..hi
                # range expressions), so `x \in 0..K` guards refine
                # instead of triggering the blunt whole-spec refusal
                dv = _domain_value(rhs, spec)
                if dv is None:
                    return True if not _mentions(rhs, varnames) \
                        else _refuse_guard(g)
                av = env.get(var, TOP)
                if av is TOP or av is None:
                    env[var] = dv
                    return True
                if dv[0] == "ival":
                    m = _meet_ival(av, dv[1], dv[2])
                    if m is False:
                        return False
                    env[var] = m
                    return True
                if av[0] == "set":
                    kept = av[1] & dv[1]       # ModelValues interned
                    if not kept:
                        return False
                    env[var] = ("set", kept)
                    return True
                ints = [x for x in dv[1] if _is_int(x)]
                if ints:
                    m = _meet_ival(av, min(ints), max(ints))
                    if m is False:
                        return False
                    env[var] = m
                return True
    if _mentions(g, varnames):
        _refuse_guard(g)
    return True                     # constants/binders only: no-op


def _refuse_guard(g):
    raise _Refuse(
        f"guard conjunct outside the interval domain: {g[0]!r} "
        f"expression over state variables (e.g. nonlinear "
        f"arithmetic) — falling back to declared bounds")


def _init_env(spec, varnames):
    """Abstract environment of Init.  Unassigned / uninterpretable
    variables start TOP (declared bounds); an Init body outside plain
    conjunct shape refuses tightening."""
    d = spec.module.defs.get(spec.init_name)
    if d is None:
        raise _Refuse(f"INIT {spec.init_name} not defined")
    env = {v: None for v in varnames}

    def walk(e):
        if not isinstance(e, tuple) or not e:
            return
        if e[0] == "and":
            for x in e[1]:
                walk(x)
            return
        if e[0] == "binop" and e[1] in ("eq", "in") and \
                isinstance(e[2], tuple) and e[2][0] == "id" \
                and e[2][1] in varnames:
            var, rhs = e[2][1], e[3]
            if e[1] == "eq":
                v = _fold(rhs, spec, set())
                if _is_int(v):
                    env[var] = _join(env[var], _ival(v, v))
                    return
                if isinstance(v, (ModelValue, str, bool)):
                    env[var] = _join(env[var],
                                     ("set", frozenset([v])))
                    return
            else:
                dv = _domain_value(rhs, spec)
                if dv is not None:
                    env[var] = _join(env[var], dv)
                    return
            env[var] = TOP
            return
        # any other conjunct: every variable it mentions is unknown
        for v in varnames:
            if _mentions(e, {v}):
                env[v] = TOP

    walk(d.body)
    for v in varnames:
        if env[v] is None:
            env[v] = TOP
    return env


# ----------------------------------------------------------------------
# the analysis
# ----------------------------------------------------------------------
def analyze(spec) -> BoundsFacts:
    """Compute (and cache per spec object) the bounds facts."""
    cached = getattr(spec, "_bounds_facts", None)
    if cached is not None:
        return cached
    facts = _analyze(spec)
    spec._bounds_facts = facts
    return facts


def _fold_dead(action, spec):
    """Reason string when a guard conjunct constant-folds to FALSE
    (sound independent of the interval fixpoint)."""
    from .vacuity import _guard_conjuncts
    for conj in _guard_conjuncts(action.expr, spec):
        if _fold(conj, spec, set()) is False:
            return "guard conjunct folds to FALSE under the cfg"
    return None


def _analyze(spec) -> BoundsFacts:
    varnames = set(spec.module.variables)
    facts = BoundsFacts(module=spec.module.name, tightened=False)

    # dead-by-folding first: sound even when tightening is refused
    live = []
    for action in spec.actions:
        why = _fold_dead(action, spec)
        if why is not None:
            facts.dead_actions.append(action.name)
            facts.dead_reasons[action.name] = why
        else:
            live.append(action)

    # fanout upper bounds from the statically enumerable binder chain
    for action in live:
        binders, guards, _updates = _decompose(action.expr, spec)
        if any(dv is None for _n, dv in binders):
            continue
        prod = 1
        for _n, dv in binders:
            prod *= _size(dv)
        bnames = {n for n, _dv in binders}
        facts.fanout[action.name] = prod
        facts.fanout_exact[action.name] = not any(
            _mentions(g, bnames) for g in guards)

    # interval fixpoint (refusal falls through with tightened=False)
    try:
        env = _fixpoint(spec, varnames, live, facts)
    except _Refuse as e:
        facts.refused = str(e)
        return facts

    facts.tightened = True
    for v in sorted(varnames):
        av = env.get(v)
        h = _hull(av) if av is not TOP and av is not None else None
        if h is not None:
            facts.intervals[v] = (h[1], h[2])
        sz = _size(av) if av is not TOP and av is not None else None
        if sz is not None:
            facts.domain_sizes[v] = sz
    if varnames and all(v in facts.domain_sizes for v in varnames):
        bound = 1
        for v in varnames:
            bound *= facts.domain_sizes[v]
        facts.state_bound = bound
    return facts


def _fixpoint(spec, varnames, live, facts):
    env = _init_env(spec, varnames)
    for _it in range(MAX_ITERS):
        changed = False
        for action in live:
            out = _transfer(action, spec, env, varnames)
            if out is None:
                continue
            for v, av in out.items():
                j = _join(env.get(v), av)
                if j != env.get(v):
                    env[v] = j
                    changed = True
        if not changed:
            break
    else:
        raise _Refuse(f"interval fixpoint did not converge within "
                      f"{MAX_ITERS} iterations")

    # interval-proven dead actions: guard refinement empty at fixpoint
    for action in live:
        binders, guards, _updates = _decompose(action.expr, spec)
        benv = dict(binders)
        ref = dict(env)
        sat = True
        for g in guards:
            if not _refine(g, spec, ref, benv, varnames):
                sat = False
                break
        if not sat and action.name not in facts.dead_actions:
            facts.dead_actions.append(action.name)
            facts.dead_reasons[action.name] = \
                "guard unsatisfiable against the reachable intervals"
    return env


def _transfer(action, spec, env, varnames):
    """One action's contribution to the next environment: the guarded
    updates evaluated under the guard-refined env, or None when the
    guard is unsatisfiable this iteration."""
    binders, guards, updates = _decompose(action.expr, spec)
    benv = dict(binders)
    ref = dict(env)
    for g in guards:
        if not _refine(g, spec, ref, benv, varnames):
            return None
    out = {}
    for upd in updates:
        if isinstance(upd, tuple) and upd[0] == "binop" \
                and upd[1] == "eq" and isinstance(upd[2], tuple) \
                and upd[2][0] == "prime" \
                and isinstance(upd[2][1], tuple) \
                and upd[2][1][0] == "id" \
                and upd[2][1][1] in varnames:
            var = upd[2][1][1]
            try:
                out[var] = _aeval(upd[3], spec, ref, benv)
            except _Unsupported:
                out[var] = TOP
        else:
            primed = set()
            _primed_vars(upd, spec, primed)
            for v in primed & varnames:
                out[v] = TOP
    return out


# ----------------------------------------------------------------------
# the lint pass
# ----------------------------------------------------------------------
def run(spec, report):
    facts = analyze(spec)
    report.extras["bounds"] = facts.to_dict()
    for name in facts.dead_actions:
        report.add(PASS, SEV_INFO, name,
                   f"statically dead under the cfg "
                   f"({facts.dead_reasons.get(name)}); the engines "
                   f"prune it from the kernel lane tables")
    if not facts.tightened:
        report.add(PASS, SEV_WARN, spec.module.name,
                   f"interval tightening refused: {facts.refused} — "
                   f"engines run declared plane bounds "
                   f"(bounds{{tightened:false}})")
        return
    tight = ", ".join(f"{k}=[{lo},{hi}]"
                      for k, (lo, hi) in sorted(facts.intervals.items()))
    report.add(PASS, SEV_INFO, spec.module.name,
               f"reachable intervals: {tight or '(none)'}; "
               f"state bound "
               f"{facts.state_bound if facts.state_bound is not None else 'unbounded'}; "
               f"{len(facts.dead_actions)} dead action(s)")
