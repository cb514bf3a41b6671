"""The spec the engines consume: a parsed module bound to a cfg
(``SpecModel``, a copy of ``tpuvsr/engine/spec.py``), or a binding read
from a cfg alone (``SpecBinding``).

``SpecModel`` binds a module parsed by the port's frontend to a cfg,
decomposes SPECIFICATION formulas and offers the interpreter's interface
(initial states, successors by action, invariants, the VIEW projection,
symmetry).  The `.tla` files of VSR and of its analysis family are not
in this repository, so those models are bound from a cfg alone: a
``SpecBinding`` holds the module name, the cfg, the invariant names in
cfg order, a function that builds the dense initial states for a codec
(VSR.tla's ``Init`` through ``VSRCodec.init_dense``) and the evaluated
SYMMETRY set.  Of the definitions a cfg may name, the binding knows one:
``symmValues == Permutations(Values)`` (VSR.tla:151), for VSR and for
the seven models of its analysis family (``_SYMMETRY_DEFS``).

Both offer what the device engines read (``registry.make_model``,
``DeviceBFS``, ``PagedBFS``, the simulators): ``module_name``, ``cfg``,
``invariants`` (names), ``init_dense(codec)`` and ``symmetry_perms``.
``InitShim`` is the validator's spec over a ``SpecBinding``: its one
initial state is a parsed one.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable

from ..core.values import FnVal, TLAError, permute_value, value_key
from ..frontend.cfg import CfgModel, parse_cfg_file
from ..frontend.tla_ast import Module
from ..interp.actions import ActionEnumerator
from ..interp.evalr import EMPTY_ENV, EvalCtx, Evaluator

# (module, SYMMETRY name) -> the constant whose Permutations it is.  The
# family's .tla files are not in this repository: their symmValues is
# taken as VSR's Permutations(Values) (VSR.tla:151), as the JAX package's
# tests bind it for them (tests/test_st03_kernel.py:36-37).
_SYMMETRY_DEFS = {(module, "symmValues"): "Values" for module in (
    "VSR", "VR_STATE_TRANSFER", "VR_ASSUME_NEWVIEWCHANGE", "VR_INC_RESEND",
    "VR_APP_STATE", "VR_REPLICA_RECOVERY", "VR_REPLICA_RECOVERY_ASYNC_LOG",
    "VR_REPLICA_RECOVERY_CP")}


@dataclass
class SpecBinding:
    module: str
    cfg: CfgModel
    init: Callable            # codec -> list of dense state dicts
    invariants: list = field(default_factory=list)
    # the SYMMETRY set as ModelValue -> ModelValue maps, identity dropped
    symmetry_perms: list = field(default_factory=list)

    @property
    def module_name(self):
        return self.module

    def init_dense(self, codec):
        return list(self.init(codec))


class InitShim:
    """A spec for the validator over a cfg-only binding (a module whose
    `.tla` is not at hand, as VSR's is not in this repository): the
    binding's module name and cfg, and one
    initial state, an interpreter state dict (the first state of a parsed
    trace).  It has no next-state relation, so the interpreter cannot
    confirm a divergence: validate with ``confirm=False``."""

    actions = ()

    def __init__(self, binding, init_state):
        self.module_name = binding.module_name
        self.cfg = binding.cfg
        self._init = dict(init_state)

    def init_states(self):
        yield dict(self._init)


def permutations(values) -> list:
    """TLC's ``Permutations(values)`` as maps with the identity pairs (and
    the identity map) dropped, in the order ``SpecModel._symmetry_perms``
    of ``tpuvsr/engine/spec.py`` yields them: the iteration order of the
    frozenset the interpreter's ``Permutations`` builds
    (``tpuvsr/interp/evalr.py:_permutations``), which the values' hashes
    decide."""
    elems = sorted(values, key=value_key)
    perms = frozenset(FnVal(zip(elems, p))
                      for p in itertools.permutations(elems))
    out = []
    for p in perms:
        mapping = {k: v for k, v in p.items if k is not v}
        if mapping:
            out.append(mapping)
    return out


def symmetry_perms(module: str, cfg: CfgModel) -> list:
    """The cfg's SYMMETRY set evaluated for ``module`` ([] without one);
    a definition the port does not know is a loud error."""
    if not cfg.symmetry:
        return []
    const = _SYMMETRY_DEFS.get((module, cfg.symmetry))
    if const is None:
        raise TLAError(f"SYMMETRY {cfg.symmetry} not defined for module "
                       f"{module} (the port knows "
                       f"{sorted(n for m, n in _SYMMETRY_DEFS if m == module)})")
    return permutations(cfg.constants[const])


def load_binding(cfg_path: str, module: str) -> SpecBinding:
    """Bind a cfg file to the TLA+ module ``module`` (the name its spec
    declares; a cfg does not name it).  A SYMMETRY the port does not know
    for the module is a loud error (``symmetry_perms``);
    ``registry.make_model`` refuses a module with no hand model kernel (the
    port has VSR's and the analysis family's, ``models/registry._resolve``)."""
    cfg = parse_cfg_file(cfg_path)
    return SpecBinding(module=module, cfg=cfg,
                       init=lambda codec: [codec.init_dense()],
                       invariants=list(cfg.invariants),
                       symmetry_perms=symmetry_perms(module, cfg))


@dataclass
class Action:
    name: str
    expr: tuple
    location: str   # "line a, col b to line c, col d of module M"


class SpecModel:
    """A parsed module bound to a cfg (``tpuvsr/engine/spec.py:29``).
    ``invariants`` holds the cfg's invariant names (as a binding's does);
    ``check_invariants`` evaluates their definitions."""

    def __init__(self, module: Module, cfg: CfgModel):
        self.module = module
        self.cfg = cfg
        missing = [c for c in module.constants if c not in cfg.constants]
        if missing:
            raise TLAError(f"cfg leaves constants unbound: {missing}")
        self.ev = Evaluator(module, cfg.constants)
        self.enum = ActionEnumerator(self.ev)

        self.init_name = cfg.init
        self.next_name = cfg.next
        self.fairness = []          # list of (subscript_expr, action_expr)
        self.temporal_props = list(cfg.properties)
        if cfg.specification:
            self._decompose_spec(cfg.specification)
        if not self.init_name or not self.next_name:
            raise TLAError("cfg must provide INIT/NEXT or SPECIFICATION")

        self.actions = self._action_list()
        for name in cfg.invariants:
            if name not in module.defs:
                raise TLAError(f"INVARIANT {name} not defined")
        self.invariants = list(cfg.invariants)
        self.view_def = module.defs.get(cfg.view) if cfg.view else None
        self.symmetry_perms = self._symmetry_perms(cfg.symmetry)

    @property
    def module_name(self):
        return self.module.name

    def init_dense(self, codec):
        """The initial states encoded by ``codec`` (dense numpy dicts)."""
        return [codec.encode(st) for st in self.init_states()]

    # ------------------------------------------------------------------
    def _decompose_spec(self, spec_name: str):
        d = self.module.defs.get(spec_name)
        if d is None:
            raise TLAError(f"SPECIFICATION {spec_name} not defined")
        conjuncts = []

        def flatten(e):
            if e[0] == "and":
                for x in e[1]:
                    flatten(x)
            else:
                conjuncts.append(e)
        flatten(d.body)

        def contains_temporal(e):
            if isinstance(e, list):
                return any(contains_temporal(x) for x in e)
            if not isinstance(e, tuple):
                return False
            if e and isinstance(e[0], str) and e[0] in (
                    "boxaction", "wf", "sf", "box", "diamond"):
                return True
            if e and e[0] == "binop" and e[1] == "leadsto":
                return True
            return any(contains_temporal(x) for x in e
                       if isinstance(x, (tuple, list)))

        for c in conjuncts:
            if c[0] == "boxaction":
                act, _sub = c[1], c[2]
                if act[0] == "id":
                    self.next_name = act[1]
                else:
                    self.next_name = "__Next__"
                    self.module.defs["__Next__"] = _synth_def(
                        "__Next__", act, self.module.name)
            elif c[0] in ("wf", "sf"):
                self.fairness.append((c[0], c[1], c[2]))
            elif c[0] == "id":
                sub = self.module.defs.get(c[1])
                if sub is not None and contains_temporal(sub.body):
                    # e.g. `Liveness`: a named conjunction of WF formulas
                    saved_init = self.init_name
                    self._decompose_into(sub.body)
                    if self.init_name is None:
                        self.init_name = saved_init
                elif self.init_name is None:
                    self.init_name = c[1]
            else:
                raise TLAError(f"cannot decompose spec conjunct {c!r}")

    def _decompose_into(self, body):
        def flatten(e, out):
            if e[0] == "and":
                for x in e[1]:
                    flatten(x, out)
            else:
                out.append(e)
        items = []
        flatten(body, items)
        for c in items:
            if c[0] in ("wf", "sf"):
                self.fairness.append((c[0], c[1], c[2]))
            elif c[0] == "boxaction":
                if c[1][0] == "id":
                    self.next_name = c[1][1]

    # ------------------------------------------------------------------
    def _action_list(self):
        d = self.module.defs.get(self.next_name)
        if d is None:
            raise TLAError(f"NEXT {self.next_name} not defined")
        actions = []

        def flatten_or(e):
            if e[0] == "or":
                for x in e[1]:
                    flatten_or(x)
            elif e[0] == "id" and e[1] in self.module.defs \
                    and not self.module.defs[e[1]].params:
                sub = self.module.defs[e[1]]
                actions.append(Action(
                    name=e[1], expr=sub.body,
                    location=f"line {sub.line0}, col {sub.col0} to line "
                             f"{sub.line1}, col {sub.col1} of module "
                             f"{sub.module}"))
            else:
                actions.append(Action(
                    name=self.next_name, expr=e,
                    location=f"line {d.line0}, col {d.col0} to line "
                             f"{d.line1}, col {d.col1} of module {d.module}"))
        flatten_or(d.body)
        return actions

    def _symmetry_perms(self, symm_name):
        """Evaluate the SYMMETRY definition to permutation dicts (TLC
        Permutations semantics, VSR.tla:151).  Identity is dropped."""
        if not symm_name:
            return []
        d = self.module.defs.get(symm_name)
        if d is None:
            raise TLAError(f"SYMMETRY {symm_name} not defined")
        val = self.ev.eval(d.body, EMPTY_ENV, EvalCtx({}))
        perms = []
        for p in val:
            if not isinstance(p, FnVal):
                raise TLAError("SYMMETRY must evaluate to a set of functions")
            mapping = {k: v for k, v in p.items if k is not v}
            if mapping:
                perms.append(mapping)
        return perms

    # ------------------------------------------------------------------
    # checkable interface
    # ------------------------------------------------------------------
    def init_states(self):
        d = self.module.defs[self.init_name]
        yield from self.enum.init_states(d.body)

    def successors(self, state):
        """Yield (action, successor_state) pairs."""
        for action in self.actions:
            for succ in self.enum.successors(action.expr, state):
                yield action, succ

    def check_invariants(self, state):
        """Return the name of the first violated invariant, or None."""
        ctx = EvalCtx(state)
        for name in self.invariants:
            if self.ev.eval(self.module.defs[name].body, EMPTY_ENV,
                            ctx) is not True:
                return name
        return None

    def eval_predicate(self, name, state):
        d = self.module.defs[name]
        return self.ev.eval(d.body, EMPTY_ENV, EvalCtx(state)) is True

    def view_value(self, state):
        """Project the state through VIEW (fingerprint identity), fold
        symmetry by taking the least permuted image."""
        if self.view_def is not None:
            v = self.ev.eval(self.view_def.body, EMPTY_ENV, EvalCtx(state))
        else:
            v = FnVal(sorted(state.items()))
        if self.symmetry_perms:
            best = v
            best_key = value_key(v)
            for p in self.symmetry_perms:
                pv = permute_value(v, p)
                pk = value_key(pv)
                if pk < best_key:
                    best, best_key = pv, pk
            v = best
        return v


def _synth_def(name, body, modname):
    from ..frontend.tla_ast import Def
    return Def(name=name, params=[], body=body, module=modname)


def load_spec(tla_path: str, cfg_path: str) -> SpecModel:
    """Parse a module and its cfg (``tpuvsr/engine/spec.py:217``)."""
    from ..frontend.parser import parse_module_file
    return SpecModel(parse_module_file(tla_path), parse_cfg_file(cfg_path))
