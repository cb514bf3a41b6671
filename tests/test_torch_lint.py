"""speclint in the port against the JAX package, on the CPU.

The same inline modules, parsed by each package's own frontend, go
through ``tpuvsr.analysis.run_lint`` and ``tpuvsr_torch.analysis.run_lint``:
the reports must be equal as findings (pass, severity, subject, message)
and as the report's JSON, and the bounds and independence facts (pass 6
and pass 7) equal field by field, digests included.  Every value compared
is a string, an integer or a boolean: the results are bit-identical, no
tolerance.  The modules are the counter with its variants, SymPair,
the Ticker, and the inline modules of ``tests/test_analysis.py`` and
``tests/test_cli.py``.  A cfg-only binding has no module text: its
report says that no pass ran.
"""

import numpy as np
import pytest

import tpuvsr.testing as J
import tpuvsr_torch.testing as P
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr.analysis import run_lint as jax_lint
from tpuvsr.analysis.passes.bounds import analyze as jax_bounds
from tpuvsr.analysis.passes.independence import analyze as jax_indep
from tpuvsr.engine.spec import SpecModel as JSpec
from tpuvsr.frontend.cfg import parse_cfg_text as jcfg
from tpuvsr.frontend.parser import parse_module_text as jmod
from tpuvsr_torch.analysis import LintError, preflight
from tpuvsr_torch.analysis import run_lint as port_lint
from tpuvsr_torch.analysis.passes.bounds import analyze as port_bounds
from tpuvsr_torch.analysis.passes.independence import analyze as port_indep
from tpuvsr_torch.engine.spec import SpecModel as PSpec
from tpuvsr_torch.frontend.cfg import parse_cfg_text as pcfg
from tpuvsr_torch.frontend.parser import parse_module_text as pmod

# ---------------------------------------------------------------------
# the inline modules of tests/test_analysis.py and tests/test_cli.py
# ---------------------------------------------------------------------
_PLAIN = "INIT Init\nNEXT Next\n"

WIDTH_MOD = """---- MODULE VR_REPLICA_RECOVERY ----
EXTENDS Naturals
CONSTANTS ReplicaCount, Values, StartViewOnTimerLimit, CrashLimit
VARIABLES x
Init == x = 0
Step == x' = x
Next == Step
====
"""


def _width_cfg(values="{v1}", timer=1):
    return (f"CONSTANTS\n ReplicaCount = 3\n Values = {values}\n"
            f" StartViewOnTimerLimit = {timer}\n CrashLimit = 1\n"
            f"INIT Init\nNEXT Next\n")


def _family(name):
    return WIDTH_MOD.replace("VR_REPLICA_RECOVERY ", f"{name} ")


_V62 = "{" + ", ".join(f"v{i}" for i in range(1, 63)) + "}"
_V63 = "{" + ", ".join(f"v{i}" for i in range(1, 64)) + "}"

INLINE = {
    "BF-unframed": ("""---- MODULE BF ----
EXTENDS Naturals
VARIABLES x, y
Init == x = 0 /\\ y = 0
Step == x' = x + 1
Next == Step
====
""", _PLAIN),
    "DP": ("""---- MODULE DP ----
EXTENDS Naturals
VARIABLES x, y
Init == x = 0 /\\ y = 0
Step == /\\ x'' = x
        /\\ IF x = 0 THEN y' = 1 ELSE TRUE
Next == Step
====
""", _PLAIN),
    "OK": ("""---- MODULE OK ----
EXTENDS Naturals
VARIABLES x, y
vars == <<x, y>>
Init == x = 0 /\\ y = 0
Step == x' = x + 1 /\\ UNCHANGED y
Reset == x' = 0 /\\ UNCHANGED << y >>
Next == Step \\/ Reset
====
""", _PLAIN),
    "DG-dead": ("""---- MODULE DG ----
EXTENDS Naturals
CONSTANTS Limit
VARIABLES aux_svc
Init == aux_svc = 0
Tick == /\\ aux_svc < Limit
        /\\ aux_svc' = aux_svc + 1
Noop == aux_svc' = aux_svc
Next == Tick \\/ Noop
AlwaysTrue == Limit >= 0
====
""", "CONSTANTS\n Limit = 0\nINIT Init\nNEXT Next\nINVARIANT AlwaysTrue\n"),
    "DG-live": ("""---- MODULE DG ----
EXTENDS Naturals
CONSTANTS Limit
VARIABLES aux_svc
Init == aux_svc = 0
Tick == /\\ aux_svc < Limit
        /\\ aux_svc' = aux_svc + 1
Next == Tick
====
""", "CONSTANTS\n Limit = 2\nINIT Init\nNEXT Next\n"),
    "FI": ("""---- MODULE FI ----
EXTENDS Naturals
CONSTANTS Limit
VARIABLES x
Init == x = 0
Step == x' = x
Next == Step
Broken == Limit > Limit
====
""", "CONSTANTS\n Limit = 1\nINIT Init\nNEXT Next\nINVARIANT Broken\n"),
    "BS": ("""---- MODULE BS ----
EXTENDS Naturals, TLC
CONSTANTS Values
VARIABLES s
BadSym == {[v \\in Values |-> CHOOSE w \\in Values : TRUE]}
Init == s = 0
Step == s' = s
Next == Step
====
""", "CONSTANTS\n Values = {v1, v2}\nINIT Init\nNEXT Next\n"
         "SYMMETRY BadSym\n"),
    "OS": ("""---- MODULE OS ----
EXTENDS Naturals, TLC
CONSTANTS Values
VARIABLES s
Sym == Permutations(Values)
Init == s = 0
Step == \\E v \\in Values : /\\ v < v \\/ TRUE
                           /\\ s' = s
Next == Step
====
""", "CONSTANTS\n Values = {v1, v2}\nINIT Init\nNEXT Next\n"
         "SYMMETRY Sym\n"),
    "GS": ("""---- MODULE GS ----
EXTENDS Naturals, TLC
CONSTANTS Values, Nil
VARIABLES slot
Sym == Permutations(Values)
Init == slot = Nil
Assign == \\E v \\in Values : slot' = v
Next == Assign
====
""", "CONSTANTS\n Values = {v1, v2}\n Nil = Nil\n"
         "INIT Init\nNEXT Next\nSYMMETRY Sym\n"),
    "Toy": ("""---- MODULE Toy ----
EXTENDS Naturals
VARIABLES x
Init == x = 0
A == x' = x + 1
B == x' = x
Next == A \\/ B
====
""", _PLAIN),
    "BF-broken-frame": ("""---- MODULE BF ----
EXTENDS Naturals
VARIABLES x, y
Init == x = 0 /\\ y = 0
Step == x' = x + 1
Next == Step
====
""", _PLAIN),
    "rr05-timer1": (WIDTH_MOD, _width_cfg()),
    "rr05-timer254": (WIDTH_MOD, _width_cfg(timer=254)),
    "rr05-timer255": (WIDTH_MOD, _width_cfg(timer=255)),
    "al05": (_family("VR_REPLICA_RECOVERY_ASYNC_LOG"), _width_cfg()),
    "al05-values-v1": (_family("VR_REPLICA_RECOVERY_ASYNC_LOG"),
                       _width_cfg(values="v1")),
    "al05-timer255": (_family("VR_REPLICA_RECOVERY_ASYNC_LOG"),
                      _width_cfg(timer=255)),
    "cp06": (_family("VR_REPLICA_RECOVERY_CP"), _width_cfg()),
    "cp06-values-v1": (_family("VR_REPLICA_RECOVERY_CP"),
                       _width_cfg(values="v1")),
    "cp06-v62": (_family("VR_REPLICA_RECOVERY_CP"), _width_cfg(values=_V62)),
    "cp06-v63": (_family("VR_REPLICA_RECOVERY_CP"), _width_cfg(values=_V63)),
    "cli-Tk": ("""---- MODULE Tk ----
EXTENDS Naturals
VARIABLES x
Init == x = 0
Incr == x' = (x + 1) % 3
Next == Incr
vars == <<x>>
AtZero == x = 0
Prop == []<>AtZero
Spec == Init /\\ [][Next]_vars
FairSpec == Init /\\ [][Next]_vars /\\ WF_vars(Incr)
====
""", "SPECIFICATION FairSpec\nPROPERTY Prop\n"),
    "cli-Po": ("""---- MODULE Po ----
EXTENDS Naturals
VARIABLES x
Init == x = 0
Incr == x' = (x + 1) % 3
Next == Incr
vars == <<x>>
AtZero == x = 0
Prop == []<>AtZero
Spec == Init /\\ [][Next]_vars
====
""", "SPECIFICATION Spec\nPROPERTY Prop\n"),
    "cli-Ed": ("""---- MODULE Ed ----
EXTENDS Naturals
VARIABLES x
Init == x = 0
Incr == x' = (x + 1) % 3
Next == Incr
vars == <<x>>
====
""", _PLAIN),
    "cli-Sy": ("""---- MODULE Sy ----
EXTENDS Naturals
VARIABLES x
Init == x = 0
Incr == x' = (x + 1) % 3
Next == Incr
vars == <<x>>
AtZero == x = 0
Prop == []<>AtZero
Spec == Init /\\ [][Next]_vars
====
""", "SPECIFICATION Spec\nPROPERTY Prop\n"),
}

# the stub fixtures, built by each package's own testing module
FIXTURES = {f"counter{kw}": ("counter_spec", kw) for kw in [
    {}, {"inv_free": True}, {"dead_action": True}, {"nonlinear_guard": True},
    {"inv_x_bound": 2}, {"inv_bound": 3}, {"limit": 0}]}
FIXTURES.update({f"sympair{kw}": ("sym_pair_spec", kw) for kw in [
    {}, {"inv_pair": True}, {"symmetry": False}]})
FIXTURES.update({f"ticker{kw}": ("ticker_spec", kw) for kw in [
    {}, {"stop": False}, {"spec_name": "Spec"}]})


def _pair(case):
    """(JAX spec, port spec) of one case."""
    if case in INLINE:
        src, cfg = INLINE[case]
        return (JSpec(jmod(src), jcfg(cfg)), PSpec(pmod(src), pcfg(cfg)))
    fn, kw = FIXTURES[case]
    return getattr(J, fn)(**kw), getattr(P, fn)(**kw)


def _findings(report):
    return [(f.passname, f.severity, f.subject, f.message)
            for f in report.findings]


@pytest.mark.parametrize("case", list(FIXTURES) + list(INLINE))
def test_lint_reports_equal_jax(case):
    """Every pass's findings and the report's JSON are those of the JAX
    package, bit for bit (strings, counts and flags).  The one module
    named VR_REPLICA_RECOVERY differs by design in one finding: the
    drift pass's packed size, since the port derives no recovery-nonce
    bound for it (ROADMAP queue 3 item 5), so its nonce planes keep 32
    bits."""
    js, ps = _pair(case)
    jr, pr = jax_lint(js), port_lint(ps)
    jf, pf = _findings(jr), _findings(pr)
    jd, pd = jr.to_dict(), pr.to_dict()
    if ps.module.name == "VR_REPLICA_RECOVERY":
        drift = [i for i, (a, b) in enumerate(zip(jf, pf)) if a != b]
        if drift:
            assert len(drift) == 1 and len(jf) == len(pf)
            i = drift[0]
            assert jf[i][:3] == pf[i][:3] == ("drift", "info",
                                             "VR_REPLICA_RECOVERY")
            assert "packed layout" in jf[i][3]
            pf[i] = jf[i]
            pd["findings"][i] = jd["findings"][i]
    assert pf == jf
    assert pd == jd
    assert pr.to_json() == jr.to_json() or \
        ps.module.name == "VR_REPLICA_RECOVERY"


_FACT_CASES = [c for c in FIXTURES if not c.startswith("ticker")] + [
    "Toy", "OK", "DG-dead", "DG-live", "cli-Ed"]


@pytest.mark.parametrize("case", _FACT_CASES)
def test_bounds_and_independence_facts_equal_jax(case):
    """Pass 6's facts (intervals, dead actions and their reasons,
    fanout, state bound, refusal, ``plane_tighten``, digest) and pass
    7's (access sets, matrix, visibility, monotone witnesses, poisoning,
    digest) equal JAX's, bit for bit."""
    js, ps = _pair(case)
    jb, pb = jax_bounds(js), port_bounds(ps)
    for k in ("intervals", "dead_actions", "dead_reasons", "fanout",
              "fanout_exact", "state_bound", "tightened", "refused",
              "digest"):
        assert getattr(pb, k) == getattr(jb, k), k
    assert pb.plane_tighten() == jb.plane_tighten()
    assert pb.journal_doc() == jb.journal_doc()
    ji, pi = jax_indep(js), port_indep(ps)
    for k in ("action_names", "reads", "writes", "matrix", "visible",
              "monotone", "poisoned", "inv_refused", "independent_pairs",
              "pruned_dead", "digest"):
        assert getattr(pi, k) == getattr(ji, k), k
    assert pi.journal_doc() == ji.journal_doc()


@pytest.mark.parametrize("fixture,kw", [
    ("counter", {"inv_free": True}), ("counter", {}),
    ("counter", {"inv_x_bound": 2}), ("counter", {"dead_action": True}),
    ("sympair", {})])
@pytest.mark.parametrize("sharded", [False, True])
def test_por_filter_tables_equal_jax(fixture, kw, sharded):
    """``PORFilter.amat``, ``eligible`` and the journal document over the
    stub kernels equal JAX's (booleans and integers, bit for bit), with
    the sharded static proviso too."""
    from tpuvsr.engine.por import PORFilter as JF
    from tpuvsr_torch.engine.por import PORFilter as PF
    if fixture == "counter":
        js, ps = J.counter_spec(**kw), P.counter_spec(**kw)
        dead = kw.get("dead_action", False)
        _, jk = J.stub_model_factory(dead_action=dead)(js)
        _, pk = P.stub_model_factory(dead_action=dead)(ps)
    else:
        js, ps = J.sym_pair_spec(**kw), P.sym_pair_spec(**kw)
        _, jk = J.stub_sym_factory()(js)
        _, pk = P.stub_sym_factory()(ps)
    jf = JF(jax_indep(js), jk, sharded=sharded)
    pf = PF(port_indep(ps), pk, sharded=sharded)
    assert np.array_equal(pf.amat, jf.amat)
    assert np.array_equal(pf.eligible, jf.eligible)
    assert (pf.n_eligible, pf.any_eligible, pf.digest) == \
        (jf.n_eligible, jf.any_eligible, jf.digest)
    assert pf.journal_doc() == jf.journal_doc()
    assert pf.manifest() == jf.manifest()


def test_cfg_only_binding_runs_no_pass():
    """A cfg-only binding has no module text: ``run_lint`` and
    ``preflight`` report that no pass ran, and an error-free gate."""
    b = P.counter_binding()
    r = port_lint(b)
    assert r.passes_run == [] and r.ok
    assert "no pass ran" in r.findings[0].message
    assert preflight(b).passes_run == []


def test_preflight_caches_and_raises_like_jax(monkeypatch):
    """``preflight`` caches its report on the spec, raises ``LintError``
    on an error finding (the unframed module), and returns None under
    ``TPUVSR_LINT=off``, as JAX's does."""
    from tpuvsr.analysis import LintError as JLintError
    from tpuvsr.analysis import preflight as jax_preflight
    good = P.counter_spec()
    r = preflight(good)
    assert preflight(good) is r and r.ok
    js, ps = _pair("BF-unframed")
    with pytest.raises(JLintError) as je:
        jax_preflight(js)
    with pytest.raises(LintError) as pe:
        preflight(ps)
    assert str(pe.value) == str(je.value)
    monkeypatch.setenv("TPUVSR_LINT", "off")
    assert preflight(P.counter_spec()) is None
