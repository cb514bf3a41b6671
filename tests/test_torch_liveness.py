"""The port's liveness checker (``tpuvsr_torch/engine/liveness.py``)
against the JAX package's, on the same inputs, on the CPU.

* ``liveness_check`` on the interpreter's graph of the parsed Ticker in
  five cases (``CASES``: FairSpec and Spec with []<>AtZero, FairSpec with
  AtZero ~> Hit, and the stop-free FairSpec with each property), against
  JAX's: verdict, property name, lasso (actions and states) and
  ``cycle_start`` (the contracts of ``tests/test_liveness.py:58``, ``:68``,
  ``:76``);
* the same cases through the port's ``DeviceGraph(device="cpu")`` in
  both modes, against JAX's streamed ``DeviceGraph``: the CSR under
  ``canon_csr``, the states by gid, and the verdict and lasso; and the
  streamed battery of ``tests/test_device_liveness.py:135`` (tile 2,
  tiny buffers, the per-action commit) against JAX's default graph
  (``:67``, ``:79``, ``:100``, ``:114``, ``:246``);
* ``_tarjan_sccs`` on numpy-seeded random graphs (the same components in
  the same order), ``_fairness_groups`` on three inline modules, and
  ``_collect_props`` on a quantified property;
* the refusals: SYMMETRY on, and an observer (the port has none yet).

Exact results throughout: tolerance 0."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tpuvsr.core.values import TLAError as JTLAError  # noqa: E402
from tpuvsr.engine import liveness as jl  # noqa: E402
from tpuvsr.engine.device_liveness import DeviceGraph as JGraph  # noqa: E402
from tpuvsr.engine.spec import SpecModel as JSpec  # noqa: E402
from tpuvsr.frontend.cfg import parse_cfg_text as j_cfg  # noqa: E402
from tpuvsr.frontend.parser import parse_module_text as j_parse  # noqa: E402
from tpuvsr.testing import canon_csr as j_canon_csr  # noqa: E402
from tpuvsr.testing import stub_ticker_factory as j_ticker  # noqa: E402
from tpuvsr.testing import sym_pair_spec as j_sym_pair  # noqa: E402
from tpuvsr.testing import ticker_spec as j_ticker_spec  # noqa: E402
from tpuvsr_torch.core.values import TLAError  # noqa: E402
from tpuvsr_torch.engine import liveness as pl  # noqa: E402
from tpuvsr_torch.engine.device_liveness import DeviceGraph  # noqa: E402
from tpuvsr_torch.engine.spec import SpecModel  # noqa: E402
from tpuvsr_torch.frontend.cfg import parse_cfg_text  # noqa: E402
from tpuvsr_torch.frontend.parser import parse_module_text  # noqa: E402
from tpuvsr_torch.testing import (canon_csr, stub_ticker_factory,  # noqa: E402
                                  sym_pair_spec, ticker_spec)

MOD = 6
# (spec name, properties, stop): the five Ticker cases
CASES = {
    "fair-gf": ("FairSpec", ("AlwaysEventuallyZero",), True),
    "spec-gf": ("Spec", ("AlwaysEventuallyZero",), True),
    "fair-leadsto": ("FairSpec", ("EventuallyHit",), True),
    "stopfree-leadsto": ("FairSpec", ("EventuallyHit",), False),
    "stopfree-gf": ("FairSpec", ("AlwaysEventuallyZero",), False),
}
# the JAX harness's graph settings (tests/test_device_liveness.py:30)
GRAPH_KW = dict(tile_size=4, chunk_tiles=2, next_capacity=32,
                fpset_capacity=1 << 8)


def specs(case):
    name, props, stop = CASES[case]
    kw = dict(spec_name=name, props=props, modulus=MOD, stop=stop)
    return ticker_spec(**kw), j_ticker_spec(**kw)


def verdict(res):
    """What a liveness run reports: verdict, property, lasso (action and
    state a step), cycle start, states, error."""
    return (res.ok, res.property_name,
            [(e.action_name, dict(e.state)) for e in res.trace],
            res.cycle_start, res.distinct_states, res.error)


def graph_states(g):
    return [dict(g.states[s]) for s in range(g.n)]


@pytest.fixture(scope="module")
def jax_graphs():
    """JAX's streamed DeviceGraph of each case, and its liveness
    verdict."""
    out = {}
    for case in CASES:
        _p, js = specs(case)
        stop = CASES[case][2]
        g = JGraph(js, mode="stream", hash_mode="full",
                   model_factory=j_ticker(modulus=MOD, stop=stop),
                   **GRAPH_KW)
        out[case] = (g, verdict(jl.liveness_check(js, graph=g)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_interpreter_liveness_matches_jax(case):
    ps, js = specs(case)
    got, want = verdict(pl.liveness_check(ps)), verdict(
        jl.liveness_check(js))
    assert got == want
    # the JAX tests' expectations (tests/test_liveness.py:58-88)
    assert got[0] is case.startswith("stopfree")
    if not got[0]:
        assert got[1] == CASES[case][1][0]


@pytest.mark.parametrize("mode", ["stream", "two-pass"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_graph_liveness_matches_jax(case, mode, jax_graphs):
    ps, js = specs(case)
    g = DeviceGraph(ps, mode=mode, device="cpu",
                    model_factory=stub_ticker_factory(
                        modulus=MOD, stop=CASES[case][2]), **GRAPH_KW)
    jg, want = jax_graphs[case]
    assert g.mode == mode and g.n == jg.n and g.inits == jg.inits
    assert canon_csr(g) == [[(int(a), int(t)) for a, t in seg]
                            for seg in j_canon_csr(jg)]
    assert graph_states(g) == graph_states(jg)
    got = verdict(pl.liveness_check(ps, graph=g))
    assert got == want
    # and JAX's verdict through its graph is its interpreter's
    assert want == verdict(jl.liveness_check(js))


@pytest.mark.parametrize("over", [
    dict(tile_size=2, chunk_tiles=1),
    dict(edge_capacity=16, fpset_capacity=1 << 4, next_capacity=1 << 4),
    dict(commit="per-action", edge_capacity=16),
], ids=["tile2", "tiny-buffers", "per-action"])
def test_streamed_battery_matches_jax(over, jax_graphs):
    ps, _js = specs("fair-gf")
    g = DeviceGraph(ps, mode="stream", device="cpu",
                    model_factory=stub_ticker_factory(modulus=MOD),
                    **dict(GRAPH_KW, **over))
    jg, want = jax_graphs["fair-gf"]
    assert canon_csr(g) == [[(int(a), int(t)) for a, t in seg]
                            for seg in j_canon_csr(jg)]
    assert graph_states(g) == graph_states(jg)
    assert verdict(pl.liveness_check(ps, graph=g)) == want


def test_engine_handover_and_graph_health():
    """A finished edge run hands its CSR over (JAX :246); the graph's
    health attributes are JAX's; the Ticker's leaves are definitions of
    a parsed spec, which ``batch_expr`` leaves to the interpreter."""
    from tpuvsr_torch.testing import stub_graph_engine
    ps, _js = specs("fair-gf")
    eng = stub_graph_engine(binding=ps, modulus=MOD, device="cpu")
    res = eng.run()
    g = DeviceGraph(ps, engine=eng, result=res)
    assert g.mode == "stream" and g.n == res.distinct_states == 2 * MOD
    assert int(g.csr[1].shape[0]) == 3 * MOD
    assert g.edges_per_s > 0 and g.graph_overhead_ratio >= 0
    assert g.batch_predicate("AtZero") is None
    assert g.batch_predicate("NoSuchName") is None
    lines = []
    r = pl.liveness_check(ps, graph=g, log=lines.append)
    assert not r.ok and r.metrics is None and r.elapsed > 0
    assert any(line.startswith("device graph: mode stream")
               for line in lines)


@pytest.mark.parametrize("seed", range(4))
def test_tarjan_sccs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 200))
    m = int(rng.integers(n, 4 * n))
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    adj = [[] for _ in range(n)]
    for s, d in zip(src, dst):
        adj[s].append(int(d))
    succ = lambda u: adj[u]
    got, want = pl._tarjan_sccs(n, succ), jl._tarjan_sccs(n, succ)
    assert got == want
    assert sorted(v for c in got for v in c) == list(range(n))


FAIR_MODULE = """---- MODULE Fair ----
EXTENDS Naturals
VARIABLES x, y

Init == x = 0 /\\ y = 0
A == x < 2 /\\ x' = x + 1 /\\ UNCHANGED y
B == y < 2 /\\ y' = y + 1 /\\ UNCHANGED x
C == x = 2 /\\ x' = 0 /\\ UNCHANGED y
Next == A \\/ B \\/ C
AB == A \\/ B
Both == AB \\/ C
vars == <<x, y>>
{spec}
AllZero == x = 0 /\\ y = 0
Quant == \\A v \\in {{0, 1}} : []<>(x = v)
====
"""
FAIRNESS = {
    "per-action": "Spec == Init /\\ [][Next]_vars /\\ WF_vars(A) "
                  "/\\ WF_vars(C)",
    "disjunction": "Spec == Init /\\ [][Next]_vars /\\ WF_vars(Both)",
    "strong": "Spec == Init /\\ [][Next]_vars /\\ SF_vars(A)",
}


def fair_specs(kind, props=("Quant",)):
    text = FAIR_MODULE.replace("{spec}", FAIRNESS[kind]).replace(
        "{{", "{").replace("}}", "}")
    cfg = "SPECIFICATION Spec\nPROPERTY\n" + "\n".join(props) + "\n"
    return (SpecModel(parse_module_text(text), parse_cfg_text(cfg)),
            JSpec(j_parse(text), j_cfg(cfg)))


@pytest.mark.parametrize("kind", ["per-action", "disjunction"])
def test_fairness_groups_match_jax(kind):
    ps, js = fair_specs(kind)
    got, want = pl._fairness_groups(ps), jl._fairness_groups(js)
    assert got == want
    assert got == ([("A", frozenset({"A"})), ("C", frozenset({"C"}))]
                   if kind == "per-action"
                   else [("Both", frozenset({"A", "B", "C"}))])
    assert verdict(pl.liveness_check(ps)) == verdict(jl.liveness_check(js))


def test_strong_fairness_refused_by_both():
    ps, js = fair_specs("strong")
    with pytest.raises(TLAError, match="weak fairness"):
        pl._fairness_groups(ps)
    with pytest.raises(JTLAError, match="weak fairness"):
        jl._fairness_groups(js)


def test_collect_props_quantified_matches_jax():
    """``\\A v \\in {0, 1} : []<>(x = v)``: one []<> leaf a value, each
    with its binding, and the same verdict and lasso."""
    ps, js = fair_specs("per-action")
    got, want = pl._collect_props(ps, "Quant"), jl._collect_props(js, "Quant")
    assert [(k, p, q, pl._flatten_env(e)) for k, p, q, e in got] == \
        [(k, p, q, jl._flatten_env(e)) for k, p, q, e in want]
    assert [k for k, *_ in got] == ["gf", "gf"]
    assert sorted(pl._flatten_env(e)["v"] for *_, e in got) == [0, 1]
    assert verdict(pl.liveness_check(ps)) == verdict(jl.liveness_check(js))


def test_symmetry_and_observer_refused():
    """Liveness needs SYMMETRY off in both packages; the port has no run
    observer and refuses one."""
    got = pl.liveness_check(sym_pair_spec())
    want = jl.liveness_check(j_sym_pair())
    assert (got.ok, got.error) == (want.ok, want.error) == (
        False, "liveness checking requires SYMMETRY off (reference cfg "
               "guidance, A01 cfg:22-24)")
    with pytest.raises(TLAError, match="SYMMETRY off"):
        DeviceGraph(sym_pair_spec(), device="cpu")
    with pytest.raises(TLAError, match="observer"):
        pl.liveness_check(specs("fair-gf")[0], obs=object())
