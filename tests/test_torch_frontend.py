"""Parity of the port's TLA+ frontend, interpreter and host engines
(``tpuvsr_torch/frontend``, ``interp``, ``engine/{spec,bfs,trace}``)
with the JAX package's, on every inline spec of ``tpuvsr/testing.py``
(the counter and its variants, SymPair, the Ticker, the frames-failing
counter) and on the constants-only VSR module that parses
``examples/found_violation_trace.txt``.  Tokens, parse trees (by a
structural dump), initial states, successors, ``bfs_check`` counts and
levels and the golden trace's states are compared exactly."""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import pytest

import tpuvsr.testing as jt
from tpuvsr.engine.bfs import bfs_check as j_bfs_check
from tpuvsr.engine.spec import SpecModel as JSpecModel
from tpuvsr.engine.trace import format_trace_te as j_format_te
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg_file
from tpuvsr.frontend.cfg import parse_cfg_text as j_cfg_text
from tpuvsr.frontend.lexer import tokenize as j_tokenize
from tpuvsr.frontend.parser import parse_expr_text as j_parse_expr
from tpuvsr.frontend.parser import parse_module_text as j_parse
from tpuvsr.frontend.trace_parse import parse_trace_file as j_trace_file
from tpuvsr.interp.evalr import Evaluator as JEvaluator
from tpuvsr_torch.core.values import TLAError, fmt, value_key
from tpuvsr_torch.engine.bfs import bfs_check
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.spec import SpecModel, load_spec
from tpuvsr_torch.engine.trace import format_trace, format_trace_te
from tpuvsr_torch.frontend.cfg import parse_cfg_file, parse_cfg_text
from tpuvsr_torch.frontend.lexer import tokenize
from tpuvsr_torch.frontend.parser import parse_expr_text, parse_module_text
from tpuvsr_torch.frontend.trace_parse import (parse_trace_file,
                                               parse_trace_text,
                                               replay_trace)
from tpuvsr_torch.interp.evalr import EMPTY_ENV, EvalCtx, Evaluator
from tpuvsr_torch.testing import (STUB_DISTINCT, STUB_LEVELS,
                                  SYMPAIR_DISTINCT, SYMPAIR_LEVELS,
                                  SYMPAIR_ORBIT_LEVELS, SYMPAIR_ORBITS,
                                  counter_spec, stub_model_factory,
                                  stub_sym_factory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")


def _texts(make):
    """(module text, cfg text) of a JAX fixture spec: its two parse
    calls recorded."""
    seen = {}
    mod, cfg = jt.parse_module_text, jt.parse_cfg_text
    jt.parse_module_text = lambda s: (seen.__setitem__("tla", s), mod(s))[1]
    jt.parse_cfg_text = lambda s: (seen.__setitem__("cfg", s), cfg(s))[1]
    try:
        make()
    finally:
        jt.parse_module_text, jt.parse_cfg_text = mod, cfg
    return seen["tla"], seen["cfg"]


def _vsr_shim_text():
    cfg = j_cfg_file(DEFECT)
    return ("---- MODULE VSR ----\nCONSTANTS " + ", ".join(cfg.constants)
            + "\n====\n")


SPECS = {
    "counter": lambda: jt.counter_spec(),
    "counter_inv_bound": lambda: jt.counter_spec(inv_bound=4),
    "counter_inv_x_bound": lambda: jt.counter_spec(inv_x_bound=2),
    "counter_por": lambda: jt.counter_spec(inv_free=True),
    "counter_dead_action": lambda: jt.counter_spec(dead_action=True),
    "counter_nonlinear": lambda: jt.counter_spec(nonlinear_guard=True),
    "bad_counter": jt.bad_counter_spec,
    "sympair": lambda: jt.sym_pair_spec(),
    "sympair_nopair": lambda: jt.sym_pair_spec(inv_pair=True),
    "sympair_nosym": lambda: jt.sym_pair_spec(symmetry=False),
    "ticker": lambda: jt.ticker_spec(),
    "ticker_nostop": lambda: jt.ticker_spec(stop=False, modulus=4),
}


@pytest.fixture(scope="module")
def texts():
    out = {k: _texts(f) for k, f in SPECS.items()}
    out["vsr_shim"] = (_vsr_shim_text(), None)
    return out


def dump(x):
    """A structural dump of tokens and parse trees: dataclasses by their
    class name and fields, containers element by element."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, dump(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict",) + tuple((dump(k), dump(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(dump(e) for e in x)
    if isinstance(x, (frozenset, set)):
        return ("set",) + tuple(sorted(repr(dump(e)) for e in x))
    return (type(x).__name__, repr(x))


def _state(st):
    return tuple(sorted((k, fmt(v)) for k, v in st.items()))


def _pair(texts, name):
    tla, cfg = texts[name]
    return (JSpecModel(j_parse(tla), j_cfg_text(cfg)),
            SpecModel(parse_module_text(tla), parse_cfg_text(cfg)))


CASES = sorted(list(SPECS) + ["vsr_shim"])


@pytest.mark.parametrize("name", CASES)
def test_tokens_match(texts, name):
    tla = texts[name][0]
    assert dump(tokenize(tla)) == dump(j_tokenize(tla))


@pytest.mark.parametrize("name", CASES)
def test_parse_trees_match(texts, name):
    tla = texts[name][0]
    assert dump(parse_module_text(tla)) == dump(j_parse(tla))


@pytest.mark.parametrize("expr", [
    "[a |-> 1, b |-> <<2, 3>>]", "{x \\in 1..4 : x % 2 = 0}",
    "\\E v \\in {1, 2} : v > 1", "CHOOSE x \\in {3, 1, 2} : TRUE",
    "[i \\in 1..3 |-> i * i]", "(1 :> 2) @@ (2 :> 3)",
    "IF 1 < 2 THEN \"a\" ELSE \"b\"", "SubSeq(<<1, 2, 3>>, 2, 3)"])
def test_expressions_parse_and_evaluate_alike(expr):
    assert dump(parse_expr_text(expr)) == dump(j_parse_expr(expr))
    mod = "---- MODULE E ----\nEXTENDS Naturals, Sequences, TLC\n====\n"
    pv = Evaluator(parse_module_text(mod), {}).eval(
        parse_expr_text(expr), EMPTY_ENV, EvalCtx({}))
    from tpuvsr.core.values import fmt as j_fmt
    from tpuvsr.interp.evalr import EMPTY_ENV as J_ENV
    from tpuvsr.interp.evalr import EvalCtx as JCtx
    jv = JEvaluator(j_parse(mod), {}).eval(j_parse_expr(expr), J_ENV,
                                           JCtx({}))
    assert fmt(pv) == j_fmt(jv)


def _succs(spec, st, show):
    """(action, location, state) of each successor, or the error's
    message where enumerating them raises."""
    try:
        return [(a.name, a.location, show(s)) for a, s in
                spec.successors(st)]
    except Exception as e:  # noqa: BLE001 (compared across packages)
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("name", sorted(SPECS))
def test_init_states_and_successors_match(texts, name):
    """Every reachable state (at most 64 of them): the same initial
    states, and the same (action, successor) lists in order."""
    js, ps = _pair(texts, name)
    from tpuvsr.core.values import fmt as j_fmt

    def jstate(st):
        return tuple(sorted((k, j_fmt(v)) for k, v in st.items()))

    pi = [_state(s) for s in ps.init_states()]
    assert pi == [jstate(s) for s in js.init_states()]
    frontier, seen = list(ps.init_states()), set(pi)
    jfrontier = list(js.init_states())
    n = 0
    while frontier and n < 64:
        st, jst = frontier.pop(0), jfrontier.pop(0)
        n += 1
        got = _succs(ps, st, _state)
        assert got == _succs(js, jst, jstate)
        assert ps.check_invariants(st) == js.check_invariants(jst)
        if isinstance(got, str):
            continue            # the frames-failing counter raises alike
        for (_a, s), (_b, jsucc) in zip(ps.successors(st),
                                        js.successors(jst)):
            if _state(s) not in seen:
                seen.add(_state(s))
                frontier.append(s)
                jfrontier.append(jsucc)


@pytest.mark.parametrize("name", sorted(set(SPECS) - {"bad_counter"}))
def test_bfs_check_matches(texts, name):
    js, ps = _pair(texts, name)
    r, jr = bfs_check(ps), j_bfs_check(js)
    assert (r.ok, r.distinct_states, r.states_generated, r.diameter,
            r.levels, r.violated_invariant, r.error) == \
        (jr.ok, jr.distinct_states, jr.states_generated, jr.diameter,
         jr.levels, jr.violated_invariant, jr.error)
    assert [(e.position, e.action_name, e.location, _state(e.state))
            for e in r.trace] == \
        [(e.position, e.action_name, e.location,
          tuple(sorted((k, fmt(v)) for k, v in e.state.items())))
         for e in jr.trace]
    if r.trace:
        assert format_trace_te(r.trace) == j_format_te(jr.trace)


def test_bfs_check_oracles():
    assert (lambda r: (r.distinct_states, r.levels))(
        bfs_check(counter_spec())) == (STUB_DISTINCT, STUB_LEVELS)
    sym = jt.SYMPAIR_CFG.replace("{inv}", "AllOk")
    on = SpecModel(parse_module_text(jt.SYMPAIR), parse_cfg_text(sym))
    off = SpecModel(parse_module_text(jt.SYMPAIR),
                    parse_cfg_text(sym.replace("SYMMETRY Symm\n", "")))
    assert len(on.symmetry_perms) == 5
    r_on, r_off = bfs_check(on), bfs_check(off)
    assert (r_on.distinct_states, r_on.levels) == (SYMPAIR_ORBITS,
                                                   SYMPAIR_ORBIT_LEVELS)
    assert (r_off.distinct_states, r_off.levels) == (SYMPAIR_DISTINCT,
                                                     SYMPAIR_LEVELS)
    dead = bfs_check(counter_spec(), check_deadlock=True)
    assert not dead.ok and dead.error == "deadlock"
    assert _state(dead.deadlock_state) == (("x", "3"), ("y", "3"))
    assert bfs_check(counter_spec(), max_states=5).error == \
        "state limit 5 reached"


def test_violation_trace_prints_parses_and_replays():
    spec = counter_spec(inv_bound=4)
    r = bfs_check(spec)
    assert not r.ok and r.violated_invariant == "Bound"
    text = format_trace_te(r.trace)
    back = parse_trace_text(text, spec)
    assert [(e.position, e.action_name, e.location, _state(e.state))
            for e in back] == [(e.position, e.action_name, e.location,
                                _state(e.state)) for e in r.trace]
    replayed = replay_trace(spec, back)
    assert [_state(s) for s in replayed] == [_state(e.state)
                                             for e in r.trace]
    assert format_trace(r.trace).startswith(
        "State 1: <Initial predicate>\n/\\ x = 0\n/\\ y = 0\n")
    bad = [dataclasses.replace(e) for e in back]
    bad[-1] = dataclasses.replace(bad[-1], state={"x": 0, "y": 0})
    with pytest.raises(TLAError, match="does not replay"):
        replay_trace(spec, bad)


def test_golden_trace_parses_to_the_same_states():
    """examples/found_violation_trace.txt through the port's trace
    parser, on the constants-only VSR shim: the JAX package's 30 states,
    compared by fmt."""
    cfg = parse_cfg_file(DEFECT)
    mod = parse_module_text(_vsr_shim_text())
    shim = SimpleNamespace(cfg=cfg, ev=Evaluator(mod, cfg.constants))
    got = parse_trace_file(TRACE, shim)
    jcfg = j_cfg_file(DEFECT)
    jmod = j_parse(_vsr_shim_text())
    want = j_trace_file(TRACE, SimpleNamespace(
        cfg=jcfg, ev=JEvaluator(jmod, jcfg.constants)))
    from tpuvsr.core.values import fmt as j_fmt
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        assert (g.position, g.action_name, g.location) == \
            (w.position, w.action_name, w.location)
        assert sorted((k, fmt(v)) for k, v in g.state.items()) == \
            sorted((k, j_fmt(v)) for k, v in w.state.items())
    assert got[-1].action_name == "ReceiveSV"
    # the canonical order of values is the JAX package's
    assert sorted(got[0].state, key=lambda k: value_key(
        got[0].state[k])) == sorted(want[0].state, key=lambda k: value_key(
            got[0].state[k]))


def test_load_spec_reads_a_module_and_its_cfg(tmp_path):
    (tmp_path / "C.tla").write_text(jt.COUNTER)
    (tmp_path / "C.cfg").write_text(jt.COUNTER_CFG)
    spec = load_spec(str(tmp_path / "C.tla"), str(tmp_path / "C.cfg"))
    assert spec.module_name == "ObsCounter"
    assert spec.invariants == ["Bound"]
    assert bfs_check(spec).levels == STUB_LEVELS
    with pytest.raises(TLAError, match="unbound"):
        SpecModel(parse_module_text(jt.COUNTER),
                  parse_cfg_text("INIT Init\nNEXT Next\n"))
    with pytest.raises(TLAError, match="INIT/NEXT or SPECIFICATION"):
        SpecModel(parse_module_text(jt.COUNTER),
                  parse_cfg_text("CONSTANTS\n    Limit = 3\n"))


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_engines_take_a_parsed_spec(entry):
    """A SpecModel offers what the engines read from a binding (module
    name, cfg, invariant names, init_dense, symmetry_perms)."""
    spec = counter_spec()
    eng = DeviceBFS(spec, model_factory=stub_model_factory(), tile_size=4,
                    fpset_capacity=1 << 8, next_capacity=1 << 6,
                    device="cpu")
    r = getattr(eng, entry)()
    assert (r.distinct_states, r.levels) == (STUB_DISTINCT, STUB_LEVELS)
    v = DeviceBFS(counter_spec(inv_bound=4),
                  model_factory=stub_model_factory(inv_bound=4),
                  tile_size=4, fpset_capacity=1 << 8, next_capacity=1 << 6,
                  device="cpu")
    r = getattr(v, entry)()
    want = bfs_check(counter_spec(inv_bound=4))
    assert not r.ok and r.violated_invariant == "Bound"
    assert len(r.trace) == len(want.trace)
    sym = SpecModel(parse_module_text(jt.SYMPAIR),
                    parse_cfg_text(jt.SYMPAIR_CFG.replace("{inv}", "AllOk")))
    s = getattr(DeviceBFS(sym, model_factory=stub_sym_factory(),
                          tile_size=4, fpset_capacity=1 << 8,
                          next_capacity=1 << 6, device="cpu"), entry)()
    assert (s.distinct_states, s.levels) == (SYMPAIR_ORBITS,
                                             SYMPAIR_ORBIT_LEVELS)


def test_simulators_take_a_parsed_spec():
    from tpuvsr_torch.engine.device_sim import DeviceSimulator
    from tpuvsr_torch.sim.fleet import FleetSimulator
    for cls in (FleetSimulator, DeviceSimulator):
        sim = cls(counter_spec(inv_x_bound=2), walkers=16, chunk_steps=4,
                  model_factory=stub_model_factory(inv_x_bound=2),
                  device="cpu")
        r = sim.run(num=64, depth=8, seed=7)
        assert not r.ok and r.violated_invariant == "Bound"
        assert r.trace[-1].state["x"] == 3
