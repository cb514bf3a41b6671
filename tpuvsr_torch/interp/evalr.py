"""TLA+ expression evaluator and next-state enumerator (the oracle engine).

This is the semantic core replacing TLC's ``Tool``/``Worker`` expression
machinery (SURVEY.md §1.2): lazy left-to-right conjunct evaluation (the
reference depends on it — the dead ``m.commit`` field access at
VSR.tla:421 must never be evaluated eagerly, SURVEY.md §2.7.1),
existential enumeration, primed-variable binding during action
evaluation, UNCHANGED frame expansion through tuple-valued definitions
(``vars``/``rep_state_vars`` at VSR.tla:140-147), and deterministic
CHOOSE (SURVEY.md §2.7.5 — we pick the least satisfying element under
``value_key``'s canonical total order).

The enumerator yields one successor binding per nondeterministic branch:
disjunctions fork, ``\\E`` iterates its (sorted) domain, and ``x' = e``
binds x's next-state value.  This mirrors TLC's getNextStates and is the
behavior the transition kernels are differentially tested against.

A copy of ``tpuvsr/interp/evalr.py``: the port keeps its own, so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import itertools

from ..core.values import (FnVal, ModelValue, TLAError, fmt, mk_seq,
                           tla_eq, value_key)
from ..frontend.tla_ast import Def, Module


class SymbolicSet:
    """Nat / Int / record-set / function-set: membership without enumeration."""

    def __init__(self, name, contains):
        self.name = name
        self.contains = contains

    def __repr__(self):
        return self.name


NAT = SymbolicSet("Nat", lambda v: isinstance(v, int) and not isinstance(v, bool) and v >= 0)
INT = SymbolicSet("Int", lambda v: isinstance(v, int) and not isinstance(v, bool))


class Closure:
    __slots__ = ("params", "body", "env", "evaluator", "name")

    def __init__(self, params, body, env, name="LAMBDA"):
        self.params = params
        self.body = body
        self.env = env
        self.name = name


class Env:
    """Immutable chained environment for bound variables and LET defs."""
    __slots__ = ("mapping", "parent")

    def __init__(self, mapping=None, parent=None):
        self.mapping = mapping if mapping is not None else {}
        self.parent = parent

    def lookup(self, name):
        env = self
        while env is not None:
            v = env.mapping.get(name, _MISSING)
            if v is not _MISSING:
                return v
            env = env.parent
        return _MISSING

    def extend(self, mapping):
        return Env(mapping, self)

    def is_empty(self):
        return not self.mapping and (
            self.parent is None or self.parent.is_empty())


_MISSING = object()
EMPTY_ENV = Env()


class EvalCtx:
    """Per-evaluation mutable context: current state and primed bindings."""
    __slots__ = ("state", "primes")

    def __init__(self, state, primes=None):
        self.state = state
        self.primes = primes if primes is not None else {}


def _sorted_set(s):
    if isinstance(s, frozenset):
        return sorted(s, key=value_key)
    raise TLAError(f"cannot enumerate non-finite set {s!r}")


class Evaluator:
    def __init__(self, module: Module, constants: dict):
        self.module = module
        self.constants = dict(constants)
        self.varnames = set(module.variables)
        self.defs = module.defs
        self._prime_touch = {}
        self.cur_ctx = None
        self._builtins = _make_builtins(self)

    # ------------------------------------------------------------------
    # static analysis: does a definition (transitively) assign primes?
    # ------------------------------------------------------------------
    def touches_primes(self, name: str) -> bool:
        cached = self._prime_touch.get(name)
        if cached is not None:
            return cached
        d = self.defs.get(name)
        if d is None:
            self._prime_touch[name] = False
            return False
        self._prime_touch[name] = False  # cycle guard (RECURSIVE defs)
        res = self._expr_touches(d.body)
        self._prime_touch[name] = res
        return res

    def _expr_touches(self, e) -> bool:
        if isinstance(e, Def):
            return self._expr_touches(e.body)
        if isinstance(e, list):
            return any(self._expr_touches(x) for x in e)
        if not isinstance(e, tuple):
            return False
        if not e or not isinstance(e[0], str):
            return any(self._expr_touches(x) for x in e)
        tag = e[0]
        if tag in ("prime", "unchanged"):
            return True
        if tag == "call":
            return self.touches_primes(e[1]) or \
                any(self._expr_touches(a) for a in e[2])
        if tag == "id":
            return self.touches_primes(e[1])
        return any(self._expr_touches(x) for x in e[1:])

    # ------------------------------------------------------------------
    # plain (state-level) evaluation
    # ------------------------------------------------------------------
    def eval(self, e, env: Env, ctx: EvalCtx):
        self.cur_ctx = ctx
        tag = e[0]
        m = getattr(self, "_eval_" + tag, None)
        if m is None:
            raise TLAError(f"cannot evaluate {tag} expression: {e!r}")
        return m(e, env, ctx)

    def _eval_num(self, e, env, ctx):
        return e[1]

    def _eval_str(self, e, env, ctx):
        return e[1]

    def _eval_bool(self, e, env, ctx):
        return e[1]

    def _eval_at(self, e, env, ctx):
        v = env.lookup("@")
        if v is _MISSING:
            raise TLAError("@ used outside EXCEPT")
        return v

    def resolve_id(self, name, env, ctx):
        v = env.lookup(name)
        if v is not _MISSING:
            if isinstance(v, _LazyThunk):
                return v.force()
            return v
        d = self.defs.get(name)
        if d is not None:
            if d.params:
                return Closure(d.params, d.body, EMPTY_ENV, name)
            return self.eval(d.body, EMPTY_ENV, ctx)
        if name in self.constants:
            return self.constants[name]
        if name in self.varnames:
            if name not in ctx.state:
                raise TLAError(f"variable {name} unbound")
            return ctx.state[name]
        b = self._builtins.get(name)
        if b is not None:
            return b
        raise TLAError(f"unknown identifier {name}")

    def _eval_id(self, e, env, ctx):
        return self.resolve_id(e[1], env, ctx)

    def _eval_prime(self, e, env, ctx):
        inner = e[1]
        if inner[0] != "id":
            raise TLAError("prime applied to non-variable")
        name = inner[1]
        if name in ctx.primes:
            return ctx.primes[name]
        raise TLAError(f"primed variable {name}' read before assignment")

    def apply_op(self, fn, args, env, ctx):
        if isinstance(fn, Closure):
            if len(fn.params) != len(args):
                raise TLAError(f"arity mismatch calling {fn.name}")
            return self.eval(fn.body, fn.env.extend(dict(zip(fn.params, args))), ctx)
        if callable(fn):
            return fn(*args)
        raise TLAError(f"not an operator: {fn!r}")

    def _arg_value(self, a, env, ctx):
        """Evaluate a call argument; operator-valued args become closures."""
        if a[0] == "lambda":
            return Closure(a[1], a[2], env)
        if a[0] == "id":
            # identifier naming an operator with params -> closure
            name = a[1]
            if env.lookup(name) is _MISSING and name not in self.constants \
                    and name not in self.varnames:
                d = self.defs.get(name)
                if d is not None and d.params:
                    return Closure(d.params, d.body, EMPTY_ENV, name)
                b = self._builtins.get(name)
                if b is not None and name not in ("Nat", "Int"):
                    return b
        return self.eval(a, env, ctx)

    def _eval_call(self, e, env, ctx):
        name = e[1]
        args = [self._arg_value(a, env, ctx) for a in e[2]]
        fn = env.lookup(name)
        if fn is _MISSING:
            d = self.defs.get(name)
            if d is not None:
                fn = Closure(d.params, d.body, EMPTY_ENV, name)
            else:
                fn = self._builtins.get(name)
                if fn is None:
                    raise TLAError(f"unknown operator {name}")
        return self.apply_op(fn, args, env, ctx)

    def _eval_lambda(self, e, env, ctx):
        return Closure(e[1], e[2], env)

    def _eval_and(self, e, env, ctx):
        for item in e[1]:
            v = self.eval(item, env, ctx)
            if v is not True:
                if v is False:
                    return False
                raise TLAError(f"non-boolean in conjunction: {fmt(v)}")
        return True

    def _eval_or(self, e, env, ctx):
        for item in e[1]:
            v = self.eval(item, env, ctx)
            if v is not False:
                if v is True:
                    return True
                raise TLAError(f"non-boolean in disjunction: {fmt(v)}")
        return False

    def _eval_not(self, e, env, ctx):
        v = self.eval(e[1], env, ctx)
        if not isinstance(v, bool):
            raise TLAError("~ applied to non-boolean")
        return not v

    def _eval_neg(self, e, env, ctx):
        return -self.eval(e[1], env, ctx)

    def _eval_binop(self, e, env, ctx):
        op = e[1]
        if op == "implies":
            a = self.eval(e[2], env, ctx)
            if a is False:
                return True
            return self.eval(e[3], env, ctx) is True
        a = self.eval(e[2], env, ctx)
        b = self.eval(e[3], env, ctx)
        if op == "eq":
            return tla_eq(a, b)
        if op == "ne":
            return not tla_eq(a, b)
        if op == "in":
            return _member(a, b)
        if op == "notin":
            return not _member(a, b)
        if op == "lt":
            return a < b
        if op == "le":
            return a <= b
        if op == "gt":
            return a > b
        if op == "ge":
            return a >= b
        if op == "plus":
            return a + b
        if op == "minus":
            return a - b
        if op == "times":
            return a * b
        if op == "div":
            return a // b
        if op == "mod":
            return a % b
        if op == "range":
            return frozenset(range(a, b + 1))
        if op == "union":
            return a | b
        if op == "intersect":
            return a & b
        if op == "setdiff":
            return a - b
        if op == "subseteq":
            return a <= b
        if op == "merge":
            return a.merge_left(b)
        if op == "mapsto":
            return FnVal([(a, b)])
        if op == "equiv":
            return a == b
        if op == "concat":
            return mk_seq(a.seq_elems() + b.seq_elems())
        raise TLAError(f"unknown binop {op}")

    def _eval_tuple(self, e, env, ctx):
        return mk_seq(self.eval(x, env, ctx) for x in e[1])

    def _eval_setenum(self, e, env, ctx):
        return frozenset(self.eval(x, env, ctx) for x in e[1])

    def _eval_setfilter(self, e, env, ctx):
        _, var, sexpr, pred = e
        s = self.eval(sexpr, env, ctx)
        out = []
        for x in _sorted_set(s):
            if self.eval(pred, env.extend({var: x}), ctx) is True:
                out.append(x)
        return frozenset(out)

    def _eval_setmap(self, e, env, ctx):
        _, elem, groups = e
        out = []
        for binding in self._group_bindings(groups, env, ctx):
            out.append(self.eval(elem, env.extend(binding), ctx))
        return frozenset(out)

    def _group_bindings(self, groups, env, ctx):
        """Iterate bindings for [(names, set_expr)...] quantifier groups."""
        evaluated = []
        for names, sexpr in groups:
            s = self.eval(sexpr, env, ctx)
            elems = _sorted_set(s)
            for n in names:
                evaluated.append((n, elems))
        names = [n for n, _ in evaluated]
        for combo in itertools.product(*[el for _, el in evaluated]):
            yield dict(zip(names, combo))

    def _eval_fnctor(self, e, env, ctx):
        _, groups, body = e
        if len(groups) == 1 and len(groups[0][0]) == 1:
            var = groups[0][0][0]
            s = self.eval(groups[0][1], env, ctx)
            return FnVal((x, self.eval(body, env.extend({var: x}), ctx))
                         for x in _sorted_set(s))
        # multi-binder functions map tuples -> value
        pairs = []
        for binding in self._group_bindings(groups, env, ctx):
            key = mk_seq(binding.values())
            pairs.append((key, self.eval(body, env.extend(binding), ctx)))
        return FnVal(pairs)

    def _eval_record(self, e, env, ctx):
        return FnVal((name, self.eval(v, env, ctx)) for name, v in e[1])

    def _eval_recordset(self, e, env, ctx):
        fields = [(n, self.eval(v, env, ctx)) for n, v in e[1]]

        def contains(v):
            if not isinstance(v, FnVal):
                return False
            if v.domain() != frozenset(n for n, _ in fields):
                return False
            return all(_member(v.apply(n), s) for n, s in fields)
        return SymbolicSet("[record set]", contains)

    def _eval_fnset(self, e, env, ctx):
        dom = self.eval(e[1], env, ctx)
        rng = self.eval(e[2], env, ctx)

        def contains(v):
            if not isinstance(v, FnVal):
                return False
            if isinstance(dom, frozenset) and v.domain() != dom:
                return False
            return all(_member(x, rng) for _, x in v.items)
        return SymbolicSet("[fn set]", contains)

    def _eval_except(self, e, env, ctx):
        f = self.eval(e[1], env, ctx)
        for path, valexpr in e[2]:
            keys = []
            for kind, x in path:
                keys.append(x if kind == "fld" else self.eval(x, env, ctx))
            f = self._except_update(f, keys, valexpr, env, ctx)
        return f

    def _except_update(self, f, keys, valexpr, env, ctx):
        if not isinstance(f, FnVal):
            raise TLAError("EXCEPT applied to non-function")
        k = keys[0]
        old = f.apply(k)
        if len(keys) == 1:
            new = self.eval(valexpr, env.extend({"@": old}), ctx)
        else:
            new = self._except_update(old, keys[1:], valexpr, env, ctx)
        return f.updated(k, new)

    def _eval_apply(self, e, env, ctx):
        f = self.eval(e[1], env, ctx)
        k = self.eval(e[2], env, ctx)
        if isinstance(f, FnVal):
            return f.apply(k)
        raise TLAError(f"applying non-function {fmt(f)}")

    def _eval_dot(self, e, env, ctx):
        f = self.eval(e[1], env, ctx)
        if isinstance(f, FnVal):
            return f.apply(e[2])
        raise TLAError(f"field access on non-record {fmt(f)}.{e[2]}")

    def _eval_domain(self, e, env, ctx):
        f = self.eval(e[1], env, ctx)
        if isinstance(f, FnVal):
            return f.domain()
        raise TLAError("DOMAIN of non-function")

    def _eval_powerset(self, e, env, ctx):
        s = self.eval(e[1], env, ctx)
        elems = _sorted_set(s)
        out = []
        for r in range(len(elems) + 1):
            for combo in itertools.combinations(elems, r):
                out.append(frozenset(combo))
        return frozenset(out)

    def _eval_bigunion(self, e, env, ctx):
        s = self.eval(e[1], env, ctx)
        out = frozenset()
        for x in s:
            out |= x
        return out

    def _eval_if(self, e, env, ctx):
        c = self.eval(e[1], env, ctx)
        if c is True:
            return self.eval(e[2], env, ctx)
        if c is False:
            return self.eval(e[3], env, ctx)
        raise TLAError("IF condition not boolean")

    def _eval_case(self, e, env, ctx):
        for guard, val in e[1]:
            if self.eval(guard, env, ctx) is True:
                return self.eval(val, env, ctx)
        if e[2] is not None:
            return self.eval(e[2], env, ctx)
        raise TLAError("CASE: no arm matched and no OTHER")

    def _let_env(self, defs, env):
        mapping = {}
        new_env = env.extend(mapping)
        for d in defs:
            if d.params:
                mapping[d.name] = Closure(d.params, d.body, new_env, d.name)
            else:
                mapping[d.name] = _LazyLet(d, new_env)
        return new_env

    def _eval_let(self, e, env, ctx):
        return self.eval(e[2], self._force_let(self._let_env(e[1], env), ctx), ctx)

    def _force_let(self, env, ctx):
        # resolve 0-ary LET defs lazily on first lookup
        for k, v in list(env.mapping.items()):
            if isinstance(v, _LazyLet):
                env.mapping[k] = _LazyThunk(self, v, ctx)
        return env

    def _eval_exists(self, e, env, ctx):
        for binding in self._group_bindings(e[1], env, ctx):
            if self.eval(e[2], env.extend(binding), ctx) is True:
                return True
        return False

    def _eval_forall(self, e, env, ctx):
        for binding in self._group_bindings(e[1], env, ctx):
            if self.eval(e[2], env.extend(binding), ctx) is not True:
                return False
        return True

    def _eval_choose(self, e, env, ctx):
        _, var, sexpr, body = e
        s = self.eval(sexpr, env, ctx)
        for x in _sorted_set(s):
            if self.eval(body, env.extend({var: x}), ctx) is True:
                return x
        raise TLAError("CHOOSE: no element satisfies predicate")

    def _eval_unchanged(self, e, env, ctx):
        # boolean context (e.g. evaluating [Next]_vars stutter check)
        for name in self.collect_state_vars(e[1], env):
            if name not in ctx.primes or not tla_eq(ctx.primes[name], ctx.state[name]):
                return False
        return True

    # ------------------------------------------------------------------
    # UNCHANGED frame expansion
    # ------------------------------------------------------------------
    def collect_state_vars(self, e, env):
        """Flatten a tuple/def/var expression into state-variable names
        (handles the nested tuples-of-vars idiom at VSR.tla:140-147)."""
        out = []
        self._collect_vars(e, env, out)
        return out

    def _collect_vars(self, e, env, out):
        tag = e[0]
        if tag == "tuple":
            for x in e[1]:
                self._collect_vars(x, env, out)
            return
        if tag == "id":
            name = e[1]
            if name in self.varnames:
                out.append(name)
                return
            d = self.defs.get(name)
            if d is not None and not d.params:
                self._collect_vars(d.body, env, out)
                return
            v = env.lookup(name)
            if isinstance(v, tuple):
                self._collect_vars(v, env, out)
                return
            raise TLAError(f"UNCHANGED operand {name} is not a variable tuple")
        raise TLAError(f"cannot flatten UNCHANGED operand {e!r}")


class _LazyLet:
    __slots__ = ("d", "env")

    def __init__(self, d, env):
        self.d = d
        self.env = env


class _LazyThunk:
    """Memoized 0-ary LET binding (evaluated on first use, per TLC)."""
    __slots__ = ("ev", "lazy", "ctx", "_val", "_done")

    def __init__(self, ev, lazy, ctx):
        self.ev = ev
        self.lazy = lazy
        self.ctx = ctx
        self._done = False
        self._val = None

    def force(self):
        if not self._done:
            self._val = self.ev.eval(self.lazy.d.body, self.lazy.env, self.ctx)
            self._done = True
        return self._val


def _member(a, b):
    if isinstance(b, frozenset):
        return a in b
    if isinstance(b, SymbolicSet):
        return b.contains(a)
    raise TLAError(f"\\in applied to non-set {b!r}")


# ----------------------------------------------------------------------
# Builtin operator library (the EXTENDS closure: Naturals, FiniteSets,
# FiniteSetsExt, Sequences, SequencesExt, TLC, TLCExt — VSR.tla:89)
# ----------------------------------------------------------------------
def _make_builtins(ev: Evaluator):
    def _len(s):
        if not isinstance(s, FnVal):
            raise TLAError("Len of non-sequence")
        return len(s)

    def _append(s, x):
        return s.seq_append(x)

    def _head(s):
        return s.apply(1)

    def _tail(s):
        return mk_seq(s.seq_elems()[1:])

    def _subseq(s, a, b):
        return mk_seq(s.seq_elems()[a - 1:b])

    def _card(s):
        if isinstance(s, frozenset):
            return len(s)
        raise TLAError("Cardinality of non-finite set")

    def _quantify(s, pred):
        n = 0
        ctx = ev.cur_ctx
        for x in _sorted_set(s):
            if ev.apply_op(pred, [x], EMPTY_ENV, ctx) is True:
                n += 1
        return n

    def _max(s):
        return max(s)

    def _min(s):
        return min(s)

    def _permutations(s):
        elems = _sorted_set(s)
        perms = []
        for p in itertools.permutations(elems):
            perms.append(FnVal(zip(elems, p)))
        return frozenset(perms)

    def _assert(cond, msg):
        if cond is not True:
            raise TLAError(f"Assert failed: {msg}")
        return True

    def _print(val, out=True):
        print(fmt(val))
        return out

    def _tostring(v):
        return fmt(v)

    def _isfiniteset(s):
        return isinstance(s, frozenset)

    def _range(f):
        return frozenset(v for _, v in f.items)

    def _settoseq(s):
        return mk_seq(_sorted_set(s))

    def _fold_set(op, base, s):
        acc = base
        for x in _sorted_set(s):
            acc = ev.apply_op(op, [x, acc], EMPTY_ENV, ev.cur_ctx)
        return acc

    return {
        "Nat": NAT, "Int": INT,
        "Len": _len, "Append": _append, "Head": _head, "Tail": _tail,
        "SubSeq": _subseq, "Seq": lambda s: SymbolicSet("Seq", lambda v: isinstance(v, FnVal) and v.is_sequence()),
        "Cardinality": _card, "IsFiniteSet": _isfiniteset,
        "Quantify": _quantify, "Max": _max, "Min": _min,
        "FoldSet": _fold_set, "Range": _range, "SetToSeq": _settoseq,
        "Permutations": _permutations,
        "Assert": _assert, "Print": _print, "PrintT": lambda v: _print(v, True),
        "ToString": _tostring,
    }
