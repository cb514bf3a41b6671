"""Parity of the port's walker fleet (tpuvsr_torch/sim) with the JAX
package's (tpuvsr/sim) on the CPU.

* the counter-stub fleet: clean-walk counts, the Bound violation trace
  (identical across walker counts) and a guided run, against
  ``tpuvsr.testing.stub_fleet``;
* ``hunt_score`` on the 30 states of examples/found_violation_trace.txt;
* one guided VSR fleet round on examples/VSR_defect.cfg (64 walkers,
  depth 16, seed 2, the defect hunt's weights, swarm and splitter)
  through both packages: histories, event arrays, steps, and the
  splitter's fresh counts and novelty, compared exactly;
* that round's step is one ``successors`` call over every walker (K10
  on the card, its plain version here), never the grouped dispatch;
* one guided round on the shipped model
  (tpuvsr_torch/configs/VSR_shipped.cfg, SYMMETRY symmValues): the
  seen-set holds canonical fingerprints in both packages;
* the fleet's guard matrix (K6's plain version) against the guard loop,
  and its CUDA-graph path warming up on the current stream;
* the novelty seen-set carried from JAX into the port.

The JAX side binds the defect cfg through a constants-only shim spec (a
VSR module that declares only the cfg's CONSTANTS, plus an Evaluator),
which needs no reference corpus; its invariant check is the JAX
kernel's own.  Everything compared is integer or float64 computed from
integers: tolerance 0.

Run as a script, this file prints the JAX CPU records that
chip_smoke.py holds the card against:
  python tests/test_torch_fleet.py hunt 4096 40 2    # the guided hunt
  python tests/test_torch_fleet.py stub               # the stub fleet
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg  # noqa: E402
from tpuvsr.frontend.parser import parse_module_text  # noqa: E402
from tpuvsr.frontend.trace_parse import parse_trace_file  # noqa: E402
from tpuvsr.engine.spec import SpecModel  # noqa: E402
from tpuvsr.interp.evalr import Evaluator  # noqa: E402
from tpuvsr.models.registry import make_model as j_make_model  # noqa: E402
from tpuvsr.obs import RunObserver  # noqa: E402
from tpuvsr.sim.fleet import FleetSimulator as JFleet  # noqa: E402
from tpuvsr.sim.splitting import NoveltySplitter as JSplitter  # noqa: E402
from tpuvsr.testing import stub_fleet as j_stub_fleet  # noqa: E402

from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tpuvsr_torch.engine.carry import table_from_numpy  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.models.registry import make_model  # noqa: E402
from tpuvsr_torch.sim import NoveltySplitter, rng  # noqa: E402
from tpuvsr_torch.sim.defect_hunt import WEIGHTS, make_fleet  # noqa: E402
from tpuvsr_torch.sim.fleet import (FleetSimulator,  # noqa: E402
                                    fleet_simulate)
from tpuvsr_torch.testing import (counter_binding, stub_fleet,  # noqa: E402
                                  stub_model_factory)

DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
SHIPPED = os.path.join(ROOT, "tpuvsr_torch", "configs", "VSR_shipped.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")
HUNT = dict(chunk_steps=8, max_msgs=48, action_weights=WEIGHTS,
            swarm_sigma=1.0)
SPLIT = dict(frac=0.25, decay=0.5, hunt_beta=1.5)


def sig(res):
    """Comparable identity of a violation trace."""
    return [(e.position, e.action_name, tuple(sorted(e.state.items())))
            for e in res.trace]


def jax_shim():
    """The defect cfg as a spec the JAX fleet can run: constants-only
    module, init state = state 1 of the golden trace (VSR.tla's Init),
    invariants checked by the JAX kernel."""
    cfg = j_cfg(DEFECT)
    mod = parse_module_text("---- MODULE VSR ----\nCONSTANTS "
                            + ", ".join(cfg.constants) + "\n====\n")
    shim = SimpleNamespace(cfg=cfg, module=mod,
                           ev=Evaluator(mod, cfg.constants),
                           symmetry_perms=[], actions=[])
    entries = parse_trace_file(TRACE, shim)
    codec, kern = j_make_model(shim, max_msgs=48, fold_symmetry=False)
    inv = jax.jit(kern.invariant_fn(list(cfg.invariants)))
    shim.init_states = lambda: [entries[0].state]
    shim.check_invariants = lambda st: (
        None if bool(inv(codec.encode(st))) else cfg.invariants[0])
    return shim, entries, codec, kern


def jax_shipped_shim():
    """The shipped model as a spec the JAX fleet can run: a
    constants-only VSR module that also defines symmValues ==
    Permutations(Values), init = VSR.tla's Init, the SYMMETRY set
    evaluated by the JAX SpecModel."""
    cfg = j_cfg(SHIPPED)
    mod = parse_module_text(
        "---- MODULE VSR ----\nCONSTANTS " + ", ".join(cfg.constants)
        + "\nsymmValues == Permutations(Values)\n====\n")
    shim = SimpleNamespace(cfg=cfg, module=mod,
                           ev=Evaluator(mod, cfg.constants), actions=[])
    shim.symmetry_perms = SpecModel._symmetry_perms(shim, "symmValues")
    codec, kern = j_make_model(shim, max_msgs=48, fold_symmetry=False)
    init = codec.zero_state()
    init["view"][:] = 1
    init["ct"][:, :, 2] = 1
    inv = jax.jit(kern.invariant_fn(list(cfg.invariants)))
    shim.init_states = lambda: [codec.decode(init)]
    shim.check_invariants = lambda st: (
        None if bool(inv(codec.encode(st))) else cfg.invariants[0])
    return shim


# ----------------------------------------------------------------------
# the counter stub
# ----------------------------------------------------------------------
def test_stub_clean_walks_match_jax():
    want = j_stub_fleet(walkers=16, n_devices=1).run(num=32, depth=6,
                                                     seed=0)
    got = stub_fleet(walkers=16, device="cpu").run(num=32, depth=6, seed=0)
    one = fleet_simulate(counter_binding(), num=32, depth=6, seed=0,
                         walkers=16, chunk_steps=4, device="cpu",
                         model_factory=stub_model_factory())
    assert got.ok and want.ok and one.ok
    assert (one.walks, one.steps) == (got.walks, got.steps)
    assert (got.walks, got.steps, got.deadlocks, got.walkers) == \
        (want.walks, want.steps, want.deadlocks, want.walkers) == \
        (32, 32 * 6, 0, 16)


@pytest.fixture(scope="module")
def stub_violation():
    res = j_stub_fleet(walkers=64, n_devices=1, inv_x_bound=2).run(
        num=1024, depth=8, seed=7)
    assert not res.ok and res.violated_invariant == "Bound"
    return res


@pytest.mark.parametrize("walkers", [64, 4096])
def test_stub_violation_trace_matches_jax(stub_violation, walkers):
    """Walk i is a pure function of (seed, i): the minimum violating
    walk id, and so the trace, is the same at any walker count."""
    res = stub_fleet(walkers=walkers, inv_x_bound=2, device="cpu").run(
        num=65536, depth=8, seed=7)
    assert not res.ok and res.violated_invariant == "Bound"
    assert sig(res) == sig(stub_violation)
    if walkers == 64:
        assert (res.walks, res.steps) == (stub_violation.walks,
                                          stub_violation.steps)


def test_stub_guided_run_matches_jax():
    want = j_stub_fleet(walkers=32, n_devices=1, inv_x_bound=2,
                        split=JSplitter(frac=0.25, hunt_beta=1.0)).run(
        num=64, depth=8, seed=1)
    got = stub_fleet(walkers=32, inv_x_bound=2, device="cpu",
                     split=NoveltySplitter(frac=0.25, hunt_beta=1.0)).run(
        num=64, depth=8, seed=1)
    assert not got.ok and got.violated_invariant == "Bound"
    assert sig(got) == sig(want)
    assert (got.walks, got.steps) == (want.walks, want.steps)
    for g in ("novelty_best", "split_efficiency"):
        assert got.metrics["gauges"][g] == want.metrics["gauges"][g]


# ----------------------------------------------------------------------
# the VSR kernel's hunt score
# ----------------------------------------------------------------------
def test_hunt_score_matches_jax_on_the_golden_trace():
    _shim, entries, jcodec, jkern = jax_shim()
    dense = [jcodec.encode(e.state) for e in entries]
    batch = {k: np.stack([d[k] for d in dense]) for k in dense[0]}
    want = np.asarray(jax.vmap(jkern.hunt_score)(batch))
    _codec, kern = make_model(load_binding(DEFECT, "VSR"), max_msgs=48)
    got = kern.hunt_score({k: torch.from_numpy(v)
                           for k, v in batch.items()})
    assert len(entries) == 30 and want.max() > 0
    assert np.array_equal(want, got.numpy())


# ----------------------------------------------------------------------
# one guided VSR round through both packages
# ----------------------------------------------------------------------
class _RecordJ(JSplitter):
    def resample(self, states, alive, violated_at, dead_at, hists,
                 init_states, obs=None):
        before = self.fresh_total
        self.log = getattr(self, "log", [])
        self.log.append({"alive": np.asarray(alive),
                         "hists": [np.asarray(h) for pair in hists
                                   for h in pair]})
        out = super().resample(states, alive, violated_at, dead_at, hists,
                               init_states, obs=obs)
        self.log[-1].update(fresh=self.fresh_total - before,
                            novelty=self.novelty.copy())
        return out


class _RecordP(NoveltySplitter):
    def resample(self, states, alive, hists, init_states):
        before = self.fresh_total
        self.log = getattr(self, "log", [])
        self.log.append({"alive": alive.numpy(),
                         "hists": [h.numpy() for pair in hists
                                   for h in pair]})
        out = super().resample(states, alive, hists, init_states)
        self.log[-1].update(fresh=self.fresh_total - before,
                            novelty=self.novelty.copy())
        return out


@pytest.fixture(scope="module")
def vsr_round():
    shim, entries, _c, _k = jax_shim()
    jsplit = _RecordJ(**SPLIT)
    jsim = JFleet(shim, walkers=64, n_devices=1, split=jsplit, **HUNT)
    jout = jsim.run_round(base=0, active=64, depth=16,
                          key=jax.random.PRNGKey(2), obs=RunObserver())
    psplit = _RecordP(**SPLIT)
    psim = FleetSimulator(load_binding(DEFECT, "VSR"), walkers=64, split=psplit,
                          device="cpu", **HUNT)
    pout = psim.run_round(base=0, active=64, depth=16, key=rng.prng_key(2))
    return SimpleNamespace(jout=jout, pout=pout, jsplit=jsplit,
                           psplit=psplit, entries=entries, psim=psim)


def test_guided_vsr_round_histories_match_jax(vsr_round):
    jv, jd, jh, ji, jsteps, jdone, jchunks = vsr_round.jout
    pv, pd, ph, pi, psteps, pdone, pchunks = vsr_round.pout
    assert (psteps, pdone, pchunks) == (jsteps, jdone, jchunks) \
        and jsteps > 0
    assert len(ph) == len(jh) == 2
    for (ja, jp), (pa, pp) in zip(jh, ph):
        assert np.array_equal(np.asarray(ja), pa.numpy())
        assert np.array_equal(np.asarray(jp), pp.numpy())
    assert np.array_equal(jv, pv) and np.array_equal(jd, pd)
    for k, v in ji.items():
        assert np.array_equal(np.asarray(v), pi[k]), k


def test_guided_vsr_round_splitter_matches_jax(vsr_round):
    jl, pl = vsr_round.jsplit.log, vsr_round.psplit.log
    assert len(jl) == len(pl) == 1
    for j, p in zip(jl, pl):
        assert np.array_equal(j["alive"], p["alive"])
        for a, b in zip(j["hists"], p["hists"]):
            assert np.array_equal(a, b)
        assert j["fresh"] == p["fresh"] > 0
        assert np.array_equal(j["novelty"], p["novelty"])
    assert vsr_round.psplit.best == vsr_round.jsplit.best


def _same_round(jout, pout):
    jv, jd, jh, ji, jsteps, jdone, jchunks = jout
    pv, pd, ph, pi, psteps, pdone, pchunks = pout
    assert (psteps, pdone, pchunks) == (jsteps, jdone, jchunks) \
        and jsteps > 0
    assert len(ph) == len(jh)
    for (ja, jp), (pa, pp) in zip(jh, ph):
        assert np.array_equal(np.asarray(ja), pa.numpy())
        assert np.array_equal(np.asarray(jp), pp.numpy())
    assert np.array_equal(jv, pv) and np.array_equal(jd, pd)
    for k, v in ji.items():
        assert np.array_equal(np.asarray(v), pi[k]), k


def _same_splits(jl, pl):
    assert len(jl) == len(pl) >= 1
    for j, p in zip(jl, pl):
        assert np.array_equal(j["alive"], p["alive"])
        for a, b in zip(j["hists"], p["hists"]):
            assert np.array_equal(a, b)
        assert j["fresh"] == p["fresh"] > 0
        assert np.array_equal(j["novelty"], p["novelty"])


def test_guided_vsr_round_single_queue_matches_jax(vsr_round, monkeypatch):
    """The VSR fleet steps through one ``successors`` call over every
    walker (K10 on the card, its plain version here), never through the
    grouped dispatch and its caps, and gives the JAX round."""
    from tpuvsr_torch.models.vsr_kernel import VSRKernel

    def no_grouped(*_a, **_k):
        raise AssertionError("the VSR fleet ran the grouped dispatch")

    calls, succ = [], VSRKernel.successors

    def counted(kern, flat, pidx, *a, **k):
        calls.append(int(pidx.shape[0]))
        return succ(kern, flat, pidx, *a, **k)

    monkeypatch.setattr(FleetSimulator, "_apply_grouped", no_grouped)
    monkeypatch.setattr(VSRKernel, "successors", counted)
    psplit = _RecordP(**SPLIT)
    psim = FleetSimulator(load_binding(DEFECT, "VSR"), walkers=64,
                          split=psplit, device="cpu", **HUNT)
    pout = psim.run_round(base=0, active=64, depth=16, key=rng.prng_key(2))
    assert calls and set(calls) == {64}
    _same_round(vsr_round.jout, pout)
    _same_splits(vsr_round.jsplit.log, psplit.log)
    assert "grow_dispatch_group" not in psim.counters


@pytest.fixture(scope="module")
def shipped_round():
    """One guided round on the shipped model (SYMMETRY symmValues)
    through both packages, symmetry auto: the seen-set is keyed by the
    fingerprints of canonical images."""
    jsplit = _RecordJ(**SPLIT)
    jsim = JFleet(jax_shipped_shim(), walkers=64, n_devices=1,
                  split=jsplit, **HUNT)
    assert jsim._canon is not None
    jout = jsim.run_round(base=0, active=64, depth=16,
                          key=jax.random.PRNGKey(2), obs=RunObserver())
    out = {}
    for symmetry in ("auto", False):
        psplit = _RecordP(**SPLIT)
        psim = FleetSimulator(load_binding(SHIPPED, "VSR"), walkers=64,
                              split=psplit, device="cpu",
                              symmetry=symmetry, **HUNT)
        pout = psim.run_round(base=0, active=64, depth=16,
                              key=rng.prng_key(2))
        out[symmetry] = (psim, pout, psplit)
    return SimpleNamespace(jout=jout, jsplit=jsplit, port=out)


def test_shipped_guided_round_matches_jax(shipped_round):
    psim, pout, psplit = shipped_round.port["auto"]
    assert psim._canon is not None and psim._canon.perms == 2
    _same_round(shipped_round.jout, pout)
    _same_splits(shipped_round.jsplit.log, psplit.log)
    assert psplit.best == shipped_round.jsplit.best


def test_shipped_round_digest_is_the_port_round(shipped_round):
    """The record chip_smoke.py pins (round_digest of the JAX round) is
    the port's round's digest too."""
    psim, pout, psplit = shipped_round.port["auto"]
    jv, jd, jh, _ji, jsteps, _jd, jchunks = shipped_round.jout
    js = shipped_round.jsplit
    pv, pd, ph, _pi, psteps, _pd, pchunks = pout
    assert round_digest(jv, jd, jh, jsteps, jchunks, js.fresh_total,
                        js.novelty) == \
        round_digest(pv, pd, [(a.numpy(), p.numpy()) for a, p in ph],
                     psteps, pchunks, psplit.fresh_total, psplit.novelty)


def test_shipped_seen_set_counts_orbits(shipped_round):
    """Without the canonical images the seen-set counts orbit-mates as
    novel: more fresh walkers than JAX's, on the same first chunk."""
    psim, _pout, psplit = shipped_round.port[False]
    assert psim._canon is None
    j = shipped_round.jsplit.log[0]
    p = psplit.log[0]
    assert np.array_equal(j["alive"], p["alive"])
    assert p["fresh"] > j["fresh"]


def test_fleet_guard_matrix_is_the_guard_loop(vsr_round):
    """The fleet's guard matrix (K6 on the card, its plain version
    here) equals the plain guard loop on the round's rows, lane for
    lane in the lane table's order."""
    psim = vsr_round.psim
    states = psim._bufs["states"]
    st = psim.kern.pk.unflatten(states)
    loop = torch.cat([g(st) for g in psim.kern._guard_fns()], dim=1)
    got = psim._guard_all(states)
    assert got.shape == (64, psim.kern.n_lanes) and got.any()
    assert torch.equal(got, loop)


def test_fleet_graph_warm_up_runs_on_the_current_stream(monkeypatch):
    """The fleet's CUDA-graph path (rehearsed on the CPU with a capture
    that just calls the step) warms up on the current stream: it makes
    no side stream, and gives the eager round."""
    from tpuvsr_torch import kernels as K

    def no_stream(*a, **k):
        raise AssertionError("a side stream was made")
    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    monkeypatch.setattr(K, "capture", lambda fn: fn)
    runs = []
    for graphs in (False, True):
        sim = stub_fleet(walkers=16, inv_x_bound=2, device="cpu")
        sim.graphs = graphs
        runs.append(sim.run_round(base=0, active=16, depth=8,
                                  key=rng.prng_key(7)))
        if graphs:
            assert sim.counters["graph_captures"] >= 1
    (v0, d0, h0, _i0, s0, _c, _k), (v1, d1, h1, _i1, s1, _c1, _k1) = runs
    assert s0 == s1 and np.array_equal(v0, v1) and np.array_equal(d0, d1)
    for (a0, p0), (a1, p1) in zip(h0, h1):
        assert torch.equal(a0, a1) and torch.equal(p0, p1)


def test_make_fleet_is_the_hunt_configuration(vsr_round):
    sim = make_fleet(walkers=64, device="cpu")
    assert np.array_equal(sim.log_w, vsr_round.psim.log_w)
    assert (sim.chunk, sim.codec.shape.MAX_MSGS, sim.swarm_sigma) == \
        (8, 48, 1.0)
    s = sim.splitter
    assert (s.frac, s.decay, s.hunt_beta) == (0.25, 0.5, 1.5)


def test_seen_set_carries_from_jax(vsr_round):
    """A JAX splitter's seen-set loads into the port's through
    carry.table_from_numpy; both then name the same fresh walkers on
    one batch (the golden trace's states, each twice, half of them
    masked)."""
    slots = np.asarray(vsr_round.jsplit.state_arrays()["slots"])
    _shim, entries, jcodec, jkern = jax_shim()
    dense = [jcodec.encode(e.state) for e in entries] * 2
    batch = {k: np.stack([d[k] for d in dense]) for k in dense[0]}
    alive = np.arange(60) % 4 != 3
    j = JSplitter(frac=0.0)         # observe only: novelty = fresh
    j.bind(jkern)
    j.reset(60)
    j.table = {"slots": jax.numpy.asarray(slots)}
    j.resample({k: jax.numpy.asarray(v) for k, v in batch.items()},
               jax.numpy.asarray(alive), jax.numpy.full(60, -1),
               jax.numpy.full(60, -1), [], {k: v for k, v in batch.items()})
    p = NoveltySplitter()
    _c, pk = make_model(load_binding(DEFECT, "VSR"), max_msgs=48)
    p.bind(pk)
    p.reset(60, "cpu")
    p.table = table_from_numpy(slots, device="cpu")
    fresh = p.observe(pk.pk.flatten({k: torch.from_numpy(v)
                                     for k, v in batch.items()}),
                      torch.from_numpy(alive))
    assert np.array_equal(j.novelty, fresh.astype(np.float64))
    assert 0 < fresh.sum() < alive.sum()


def test_defect_hunt_cli_refuses_an_unknown_mode(capsys):
    from tpuvsr_torch.sim import defect_hunt
    assert defect_hunt.main(["defect_hunt", "8", "4", "1", "2", "1.0",
                             "greedy"]) == 2
    assert "unknown mode" in capsys.readouterr().err


# ----------------------------------------------------------------------
# the records chip_smoke.py holds the card against
# ----------------------------------------------------------------------
def _record_hunt(walkers, depth, seed):
    """The JAX CPU record of the guided defect hunt (the run of
    scripts/defect_hunt.py in guided mode, through the shim spec)."""
    shim, _e, _c, _k = jax_shim()
    sim = JFleet(shim, walkers=walkers, split=JSplitter(**SPLIT), **HUNT)
    picked = {}
    pick = sim._pick_event

    def record(*a, **k):
        picked["event"] = pick(*a, **k)
        return picked["event"]
    sim._pick_event = record
    t0 = time.time()
    res = sim.run(num=10**9, depth=depth, seed=seed)
    return {"ok": res.ok, "violated": res.violated_invariant,
            "walks": res.walks, "steps": res.steps,
            "trace_len": len(res.trace),
            "actions": [e.action_name for e in res.trace[1:]],
            "event": picked.get("event"), "cpu_s": time.time() - t0}


def _record_stub():
    res = j_stub_fleet(walkers=64, inv_x_bound=2).run(num=1024, depth=8,
                                                       seed=7)
    return {"violated": res.violated_invariant, "walks": res.walks,
            "steps": res.steps,
            "trace": [[e.action_name, e.state["x"], e.state["y"]]
                      for e in res.trace]}


def round_digest(violated, dead, hists, steps, chunks, fresh, novelty):
    """The comparable record of one guided round: its steps and chunks,
    sha256 digests of its event arrays and histories (int32 bytes), and
    the splitter's fresh count and novelty digest (float64 bytes)."""
    import hashlib

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
        return h.hexdigest()[:16]
    return {"steps": int(steps), "chunks": int(chunks),
            "events": sha(np.asarray(violated, np.int32),
                          np.asarray(dead, np.int32)),
            "hists": sha(*[np.asarray(h, np.int32) for pair in hists
                           for h in pair]),
            "fresh": int(fresh),
            "novelty": sha(np.asarray(novelty, np.float64))}


def _record_shipped():
    """The JAX CPU record of one guided round on the shipped model, 64
    walkers, depth 16, seed 2, the hunt's parameters (chip_smoke.py
    SHIPPED_ROUND)."""
    jsplit = JSplitter(**SPLIT)
    jsim = JFleet(jax_shipped_shim(), walkers=64, n_devices=1,
                  split=jsplit, **HUNT)
    v, d, h, _i, steps, _done, chunks = jsim.run_round(
        base=0, active=64, depth=16, key=jax.random.PRNGKey(2),
        obs=RunObserver())
    return round_digest(v, d, h, steps, chunks, jsplit.fresh_total,
                        jsplit.novelty)


if __name__ == "__main__":
    if sys.argv[1] == "hunt":
        print(json.dumps(_record_hunt(*(int(a) for a in sys.argv[2:5]))))
    elif sys.argv[1] == "shipped":
        print(json.dumps(_record_shipped()))
    else:
        print(json.dumps(_record_stub()))
