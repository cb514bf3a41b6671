"""Next-state enumeration: the interpreter-side getNextStates.

Evaluates an action formula as a nondeterministic program over a mutable
trail of primed-variable bindings with backtracking:

  * conjunction  -> sequential composition (left-to-right, lazy)
  * disjunction  -> branch (fork the enumeration)
  * \\E           -> iterate the bound set in canonical order
  * x' = e       -> bind x's next value (or test, if already bound)
  * UNCHANGED t  -> bind every variable in the flattened tuple
  * operator call-> inline the definition when it (transitively) assigns
                    primes (Send/Broadcast/Discard wrappers, VSR.tla:247-270)

Each successful path yields once; the caller snapshots ``ctx.primes`` as
the successor state.  This reproduces TLC's action semantics including
the load-bearing laziness of SURVEY.md §2.7.1.

A copy of ``tpuvsr/interp/actions.py``: the port keeps its own, so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

from ..core.values import TLAError, tla_eq
from .evalr import Closure, EMPTY_ENV, Env, EvalCtx, Evaluator, _MISSING


class ActionEnumerator:
    def __init__(self, ev: Evaluator):
        self.ev = ev

    # ------------------------------------------------------------------
    def successors(self, expr, state):
        """Yield successor states (dict) for one action expr from state."""
        ctx = EvalCtx(state)
        for _ in self._enum(expr, EMPTY_ENV, ctx):
            primes = ctx.primes
            missing = self.ev.varnames - primes.keys()
            if missing:
                raise TLAError(
                    f"action left variables unassigned: {sorted(missing)}")
            yield dict(primes)

    def init_states(self, expr):
        """Enumerate initial states from an Init predicate."""
        ctx = EvalCtx({})
        for _ in self._enum_init(expr, EMPTY_ENV, ctx):
            missing = self.ev.varnames - ctx.state.keys()
            if missing:
                raise TLAError(f"Init left variables unassigned: {sorted(missing)}")
            yield dict(ctx.state)

    # ------------------------------------------------------------------
    def _enum(self, e, env: Env, ctx: EvalCtx):
        ev = self.ev
        tag = e[0]
        if tag == "and":
            yield from self._enum_seq(e[1], 0, env, ctx)
            return
        if tag == "or":
            saved = dict(ctx.primes)
            for item in e[1]:
                ctx.primes.clear()
                ctx.primes.update(saved)
                yield from self._enum(item, env, ctx)
            ctx.primes.clear()
            ctx.primes.update(saved)
            return
        if tag == "exists":
            saved = dict(ctx.primes)
            for binding in ev._group_bindings(e[1], env, ctx):
                ctx.primes.clear()
                ctx.primes.update(saved)
                yield from self._enum(e[2], env.extend(binding), ctx)
            ctx.primes.clear()
            ctx.primes.update(saved)
            return
        if tag == "binop" and e[1] == "eq" and e[2][0] == "prime" \
                and e[2][1][0] == "id":
            var = e[2][1][1]
            val = ev.eval(e[3], env, ctx)
            if var in ctx.primes:
                if tla_eq(ctx.primes[var], val):
                    yield
                return
            ctx.primes[var] = val
            yield
            ctx.primes.pop(var, None)
            return
        if tag == "unchanged":
            names = ev.collect_state_vars(e[1], env)
            added = []
            ok = True
            for name in names:
                cur = ctx.state[name]
                if name in ctx.primes:
                    if not tla_eq(ctx.primes[name], cur):
                        ok = False
                        break
                else:
                    ctx.primes[name] = cur
                    added.append(name)
            if ok:
                yield
            for name in added:
                ctx.primes.pop(name, None)
            return
        if tag == "call":
            name = e[1]
            if ev.touches_primes(name):
                d = ev.defs.get(name)
                args = [ev._arg_value(a, env, ctx) for a in e[2]]
                new_env = EMPTY_ENV.extend(dict(zip(d.params, args)))
                yield from self._enum(d.body, new_env, ctx)
                return
        if tag == "id":
            name = e[1]
            if ev.touches_primes(name):
                d = ev.defs.get(name)
                yield from self._enum(d.body, EMPTY_ENV, ctx)
                return
            v = env.lookup(name)
            if isinstance(v, tuple):
                # LET-bound action fragment
                yield from self._enum(v, env, ctx)
                return
        if tag == "if":
            c = ev.eval(e[1], env, ctx)
            yield from self._enum(e[2] if c is True else e[3], env, ctx)
            return
        if tag == "case":
            for guard, val in e[1]:
                if ev.eval(guard, env, ctx) is True:
                    yield from self._enum(val, env, ctx)
                    return
            if e[2] is not None:
                yield from self._enum(e[2], env, ctx)
                return
            raise TLAError("CASE: no arm matched in action")
        if tag == "let":
            new_env = ev._force_let(ev._let_env(e[1], env), ctx)
            yield from self._enum(e[2], new_env, ctx)
            return
        if tag == "not":
            # guard; cannot contain prime assignments
            if ev.eval(e, env, ctx) is True:
                yield
            return
        # default: pure guard
        v = ev.eval(e, env, ctx)
        if v is True:
            yield
        elif v is not False:
            raise TLAError(f"non-boolean conjunct in action: {e!r}")

    def _enum_seq(self, items, i, env, ctx):
        if i == len(items):
            yield
            return
        for _ in self._enum(items[i], env, ctx):
            yield from self._enum_seq(items, i + 1, env, ctx)

    # ------------------------------------------------------------------
    def _enum_init(self, e, env, ctx):
        ev = self.ev
        tag = e[0]
        if tag == "and":
            yield from self._enum_init_seq(e[1], 0, env, ctx)
            return
        if tag == "or":
            saved = dict(ctx.state)
            for item in e[1]:
                ctx.state.clear()
                ctx.state.update(saved)
                yield from self._enum_init(item, env, ctx)
            ctx.state.clear()
            ctx.state.update(saved)
            return
        if tag == "exists":
            saved = dict(ctx.state)
            for binding in ev._group_bindings(e[1], env, ctx):
                ctx.state.clear()
                ctx.state.update(saved)
                yield from self._enum_init(e[2], env.extend(binding), ctx)
            ctx.state.clear()
            ctx.state.update(saved)
            return
        if tag == "binop" and e[1] == "eq" and e[2][0] == "id" \
                and e[2][1] in ev.varnames:
            var = e[2][1]
            val = ev.eval(e[3], env, ctx)
            if var in ctx.state:
                if tla_eq(ctx.state[var], val):
                    yield
                return
            ctx.state[var] = val
            yield
            ctx.state.pop(var, None)
            return
        if tag == "binop" and e[1] == "in" and e[2][0] == "id" \
                and e[2][1] in ev.varnames and e[2][1] not in ctx.state:
            var = e[2][1]
            s = ev.eval(e[3], env, ctx)
            from .evalr import _sorted_set
            for x in _sorted_set(s):
                ctx.state[var] = x
                yield
            ctx.state.pop(var, None)
            return
        if tag == "let":
            new_env = ev._force_let(ev._let_env(e[1], env), ctx)
            yield from self._enum_init(e[2], new_env, ctx)
            return
        if tag == "call":
            d = ev.defs.get(e[1])
            if d is not None:
                args = [ev._arg_value(a, env, ctx) for a in e[2]]
                yield from self._enum_init(d.body, EMPTY_ENV.extend(dict(zip(d.params, args))), ctx)
                return
        if tag == "id":
            d = ev.defs.get(e[1])
            if d is not None and not d.params:
                yield from self._enum_init(d.body, EMPTY_ENV, ctx)
                return
        if tag == "if":
            c = ev.eval(e[1], env, ctx)
            yield from self._enum_init(e[2] if c is True else e[3], env, ctx)
            return
        v = ev.eval(e, env, ctx)
        if v is True:
            yield

    def _enum_init_seq(self, items, i, env, ctx):
        if i == len(items):
            yield
            return
        for _ in self._enum_init(items[i], env, ctx):
            yield from self._enum_init_seq(items, i + 1, env, ctx)
