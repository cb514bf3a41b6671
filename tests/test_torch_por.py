"""Bounds facts and ample-set partial-order reduction in the port against
the JAX package, on the CPU.

The same stub specs and configs go through JAX's ``DeviceBFS.run()`` and
the port's ``run()``, ``run_fused()`` and ``PagedBFS`` (``device="cpu"``,
the K17 plain versions): distinct and generated counts, levels, the
reduction's kept/full/amp counters and gauges, verdicts, deadlocks,
violation traces and the trace-pointer tables.  Every value compared is
an integer (or a string): bit-identical, no tolerance.  JAX engines are
run once per config and shared through a module-scoped fixture.

Also here: K17's plain versions (``engine/tile.por_cand_plain``,
``por_probe_plain``, ``por_keep_plain``) against the JAX body's
expressions on numpy-seeded random inputs, over a table built by JAX's
``insert_core`` and ``store_gids``; the blocker and lint-gate refusals;
a paused re-entry against large capacities; cfg-only bindings; and the
port's ``PrunedKernel`` over its VSR kernel against JAX's on the golden
trace's states.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpuvsr.testing as J
import tpuvsr_torch.testing as P
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr.core.values import TLAError as JTLAError
from tpuvsr.engine.device_bfs import DeviceBFS as JBFS
from tpuvsr.engine.fpset import empty_table as j_empty_table
from tpuvsr.engine.fpset import insert_core as j_insert_core
from tpuvsr.engine.fpset import lookup_gids as j_lookup_gids
from tpuvsr.engine.fpset import store_gids as j_store_gids
from tpuvsr.engine.paged_bfs import PagedBFS as JPaged
from tpuvsr_torch.core.values import TLAError
from tpuvsr_torch.engine import tile as TL
from tpuvsr_torch.engine.bounds import PrunedKernel, resolve_bounds
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.paged_bfs import PagedBFS
from tpuvsr_torch.engine.por import resolve_por

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYM_POR_DISTINCT = 13
SYM_POR_LEVELS = [1, 3, 9]


# ---------------------------------------------------------------------
# the JAX side: one run per config, shared by the tests
# ---------------------------------------------------------------------
_CONFIGS = {
    # name: (spec kwargs, factory kwargs, engine kwargs, run kwargs)
    "inv_free_on": ({"inv_free": True}, {}, {"por": "on"},
                    {"check_deadlock": True}),
    "inv_free_off": ({"inv_free": True}, {}, {"por": "off"},
                     {"check_deadlock": True}),
    "bound_on": ({}, {}, {"por": "on"}, {}),
    "x2_on": ({"inv_x_bound": 2}, {"inv_x_bound": 2}, {"por": "on"}, {}),
    "dead_on": ({"dead_action": True, "inv_bound": 3},
                {"dead_action": True, "inv_bound": 3}, {}, {}),
}


def _jax_engine(name, cls=JBFS, **over):
    skw, fkw, ekw, _ = _CONFIGS[name]
    kw = dict(hash_mode="full", tile_size=4, fpset_capacity=1 << 8,
              next_capacity=1 << 6)
    kw.update(ekw)
    kw.update(over)
    return cls(J.counter_spec(**skw),
               model_factory=J.stub_model_factory(**fkw), **kw)


def _port_engine(name, cls=DeviceBFS, **over):
    skw, fkw, ekw, _ = _CONFIGS[name]
    kw = dict(tile_size=4, fpset_capacity=1 << 8, next_capacity=1 << 6,
              device="cpu")
    kw.update(ekw)
    kw.update(over)
    return cls(P.counter_spec(**skw),
               model_factory=P.stub_model_factory(**fkw), **kw)


def _summary(eng, res):
    g = res.metrics["gauges"]
    trace = [(t.action_name, tuple(sorted(t.state.items())))
             for t in (res.trace or [])]
    return {"ok": res.ok, "error": res.error,
            "violated": res.violated_invariant,
            "distinct": res.distinct_states,
            "generated": res.states_generated, "levels": list(res.levels),
            "kept": int(eng._por_kept), "full": int(eng._por_full),
            "amp": int(eng._por_amp),
            "deadlock": (None if res.deadlock_state is None
                         else sorted(res.deadlock_state.items())),
            "trace": trace,
            "gauges": {k: g.get(k) for k in (
                "por_cut_ratio", "ample_states", "por_eligible_actions",
                "state_bound", "dead_actions", "bound_tightening_ratio")}}


def _pointers(eng):
    if hasattr(eng, "_flush_pointers"):
        eng._flush_pointers()           # JAX fetches levels async
    return [np.concatenate(x).astype(np.int64)
            for x in (eng._h_parent, eng._h_action, eng._h_param)]


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, (_s, _f, _e, rkw) in _CONFIGS.items():
        eng = _jax_engine(name)
        res = eng.run(**rkw)
        out[name] = (_summary(eng, res), _pointers(eng))
    # the paged engine and the symmetric fixture
    eng = _jax_engine("inv_free_on", cls=JPaged, chunk_tiles=1)
    out["paged"] = (_summary(eng, eng.run(check_deadlock=True)),
                    _pointers(eng))
    eng = J.stub_sym_engine(symmetry=False, por="on")
    out["sym"] = (_summary(eng, eng.run()), _pointers(eng))
    eng = J.stub_sym_engine(symmetry=False, por="on",
                            fpset_capacity=1 << 3, next_capacity=1 << 3)
    out["sym_paused"] = (_summary(eng, eng.run()), _pointers(eng))
    return out


@pytest.mark.parametrize("name", list(_CONFIGS))
@pytest.mark.parametrize("entry", ["run", "run_fused", "paged"])
def test_engines_equal_jax(jax_runs, name, entry):
    """Each config through the port's run(), run_fused() and PagedBFS
    gives JAX run()'s counts, levels, kept/full/amp, gauges, verdict,
    deadlock, trace and pointer tables, bit for bit."""
    rkw = _CONFIGS[name][3]
    if entry == "paged":
        eng = _port_engine(name, cls=PagedBFS, chunk_tiles=1)
        res = eng.run(**rkw)
    else:
        eng = _port_engine(name)
        res = getattr(eng, entry)(**rkw)
    want, ptr = jax_runs[name]
    assert _summary(eng, res) == want
    for a, b in zip(_pointers(eng), ptr):
        assert np.array_equal(a, b)


def test_reduction_oracles(jax_runs):
    """The stub oracles: inv_free 16 -> 7 states, levels [1]*7, cut 6/9,
    three ample rows, and the (3, 3) deadlock both ways; the default
    Bound keeps POR inert (bit-identical to off, generated included)."""
    on, off = jax_runs["inv_free_on"][0], jax_runs["inv_free_off"][0]
    assert (on["distinct"], on["levels"]) == (P.POR_STUB_DISTINCT,
                                              P.POR_STUB_LEVELS)
    assert (on["kept"], on["full"], on["amp"]) == (P.POR_STUB_KEPT,
                                                   P.POR_STUB_FULL, 3)
    assert (off["distinct"], off["levels"]) == (P.STUB_DISTINCT,
                                                P.STUB_LEVELS)
    assert on["error"] == off["error"] == "deadlock"
    assert on["deadlock"] == off["deadlock"] == [("x", 3), ("y", 3)]
    b_on = jax_runs["bound_on"][0]
    off = _port_engine("bound_on", por="off")
    b_off = _summary(off, off.run())
    for k in ("distinct", "generated", "levels"):
        assert b_on[k] == b_off[k]
    assert b_on["gauges"]["por_cut_ratio"] == 1.0
    assert b_on["gauges"]["ample_states"] == 0
    x2 = jax_runs["x2_on"][0]
    # the first-found witness may differ from the unreduced run's (trace
    # honesty); the verdict may not
    assert x2["violated"] == "Bound" and dict(x2["trace"][-1][1])["x"] == 3


@pytest.mark.parametrize("entry", ["run", "run_fused", "paged"])
def test_paged_and_sympair_equal_jax(jax_runs, entry):
    """JAX's PagedBFS (chunks of one tile) and SymPair with symmetry off
    (16 -> 13 states, levels [1, 3, 9]) through each port entry point."""
    want, ptr = jax_runs["paged"]
    eng = _port_engine("inv_free_on", cls=PagedBFS, chunk_tiles=1)
    assert _summary(eng, eng.run(check_deadlock=True)) == want
    for a, b in zip(_pointers(eng), ptr):
        assert np.array_equal(a, b)
    want, ptr = jax_runs["sym"]
    if entry == "paged":
        eng = P.stub_sym_engine(symmetry=False, por="on", device="cpu",
                                spec=P.sym_pair_spec(), cls=PagedBFS)
        res = eng.run()
    else:
        eng = P.stub_sym_engine(symmetry=False, por="on", device="cpu",
                                spec=P.sym_pair_spec())
        res = getattr(eng, entry)()
    assert _summary(eng, res) == want
    assert (res.distinct_states, res.levels) == (SYM_POR_DISTINCT,
                                                 SYM_POR_LEVELS)
    for a, b in zip(_pointers(eng), ptr):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_bounds_on_and_off_bit_identical(entry):
    """Bounds facts change nothing a run reports: the dead-action
    fixture's pruned kernel (Jump gone) gives the unpruned counts,
    levels and violation trace, and the counter's tightened pack holds 6
    bits a state against the declared 8 (JAX's numbers)."""
    on = _port_engine("dead_on")
    off = _port_engine("dead_on", bounds="off")
    assert list(on.kern.action_names) == ["IncX", "IncY"]
    assert list(off.kern.action_names) == ["IncX", "IncY", "Jump"]
    r_on, r_off = getattr(on, entry)(), getattr(off, entry)()
    a, b = _summary(on, r_on), _summary(off, r_off)
    a.pop("gauges"), b.pop("gauges")
    assert a == b and not r_on.ok
    e = P.stub_device_engine(spec=P.counter_spec(), device="cpu")
    assert (e._pk.total_bits, e._pk_decl.total_bits) == (6, 8)
    j = J.stub_device_engine()
    assert (j._pk.total_bits, j._pk_decl.total_bits) == (6, 8)
    assert e._pk.version == j._pk.version
    r = getattr(e, entry)()
    assert r.metrics["gauges"]["bound_tightening_ratio"] == round(8 / 6, 4)
    assert (r.distinct_states, r.levels) == (P.STUB_DISTINCT, P.STUB_LEVELS)


def test_fanout_caps_and_refused_tightening():
    """SymPair's exact fanout (3 lanes an action) seeds the caps: no
    expansion-growth redraw with bounds on, some with it off; a
    nonlinear guard refuses tightening and runs the declared widths."""
    on = P.stub_sym_engine(symmetry=False, tile_size=8, device="cpu",
                           spec=P.sym_pair_spec())
    off = P.stub_sym_engine(symmetry=False, tile_size=8, device="cpu",
                            spec=P.sym_pair_spec(), bounds="off")
    r_on, r_off = on.run(), off.run()
    assert r_on.distinct_states == r_off.distinct_states == 16
    assert r_on.metrics["counters"].get("grow_expand_buffer", 0) == 0
    assert r_off.metrics["counters"].get("grow_expand_buffer", 0) > 0
    e = P.stub_device_engine(spec=P.counter_spec(nonlinear_guard=True),
                             device="cpu")
    assert e._facts is not None and not e._facts.tightened
    assert e._pk.total_bits == e._pk_decl.total_bits
    assert e.run().metrics["gauges"]["bound_tightening_ratio"] == 1.0


@pytest.mark.parametrize("fixture", ["counter", "sympair"])
@pytest.mark.parametrize("entry", ["run", "run_fused", "paged"])
def test_paused_reentry_bit_identical(jax_runs, entry, fixture):
    """A reduced run that pauses re-enters its tiles with the same C3
    decisions (a paused tile's own inserts carry marker pdepth + 1 and
    read as fresh): its counts, levels, kept/full/amp, verdict and
    deadlock are those of a run at large capacities.  SymPair (symmetry
    off) fills an FPSet of 2^3 slots mid-level (a probe overflow after
    some inserts) and a next buffer of 2^3 rows; the counter a next
    buffer of 2^2 rows.  A mid-level pause keeps the inserts made before
    it, so the paused run's next-buffer order, and so its pointer
    tables, differ from the unpaused run's, as in the JAX engine: they
    are held to JAX's paused run instead."""
    def run(small):
        if fixture == "counter":
            kw = dict(fpset_capacity=1 << 4, next_capacity=1 << 2) \
                if small else dict(fpset_capacity=1 << 12,
                                   next_capacity=1 << 10)
            if entry == "paged":
                e = _port_engine("inv_free_on", cls=PagedBFS,
                                 chunk_tiles=1, **kw)
                return e, e.run(check_deadlock=True)
            e = _port_engine("inv_free_on", **kw)
            return e, getattr(e, entry)(check_deadlock=True)
        kw = dict(fpset_capacity=1 << 3, next_capacity=1 << 3) if small \
            else dict(fpset_capacity=1 << 12, next_capacity=1 << 10)
        e = P.stub_sym_engine(symmetry=False, por="on", device="cpu",
                              spec=P.sym_pair_spec(),
                              cls=PagedBFS if entry == "paged" else None,
                              **kw)
        return e, (e.run() if entry == "paged" else getattr(e, entry)())
    small, rs = run(True)
    big, rb = run(False)
    grown = {k: v for k, v in rs.metrics["counters"].items()
             if k.startswith("grow_") or k in ("drains", "growth_pauses")}
    assert sum(grown.values()) > 0
    if fixture == "sympair" and entry != "paged":
        assert rs.metrics["counters"].get("grow_fpset", 0) > 0
    assert _summary(small, rs) == _summary(big, rb)
    if fixture == "counter":
        for a, b in zip(_pointers(small), _pointers(big)):
            assert np.array_equal(a, b)
    else:
        want, ptr = jax_runs["sym_paused"]
        assert _summary(small, rs) == want
        for a, b in zip(_pointers(small), ptr):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------
# refusals and cfg-only bindings
# ---------------------------------------------------------------------
@pytest.mark.parametrize("blocker,match", [
    ({"temporal": True}, "temporal"), ({"edges": True}, "edges"),
    ({"commit": "per-action"}, "fused")],
    ids=["temporal", "edges", "per-action"])
def test_por_blockers_refuse_like_jax(blocker, match):
    """``resolve_por``: under a blocker "auto" stands down and "on"
    raises, with JAX's message."""
    from tpuvsr.engine.por import resolve_por as j_resolve
    ps, js = P.counter_spec(inv_free=True), J.counter_spec(inv_free=True)
    assert resolve_por(ps, "auto", **blocker) is None
    with pytest.raises(TLAError, match=match) as pe:
        resolve_por(ps, "on", **blocker)
    with pytest.raises(JTLAError) as je:
        j_resolve(js, "on", **blocker)
    assert str(pe.value) == str(je.value)
    with pytest.raises(TLAError, match="fused"):
        _port_engine("inv_free_on", commit="per-action")
    e = _port_engine("inv_free_on", por="auto", commit="per-action")
    assert e._por_facts is None
    assert e.run().distinct_states == P.STUB_DISTINCT


def test_gate_off_refusals(monkeypatch):
    """With ``TPUVSR_LINT=off`` "auto" consumes no facts and "on" raises
    (bounds and POR), and the engine runs the declared 8-bit layout."""
    monkeypatch.setenv("TPUVSR_LINT", "off")
    spec = P.counter_spec(inv_free=True)
    assert resolve_bounds(spec, "auto") is None
    assert resolve_por(spec, "auto") is None
    with pytest.raises(TLAError, match="speclint gate"):
        resolve_bounds(spec, "on")
    with pytest.raises(TLAError, match="speclint gate"):
        resolve_por(spec, "on")
    e = _port_engine("inv_free_on", por="auto")
    assert e._facts is None and e._pk.total_bits == 8
    assert e.run(check_deadlock=True).distinct_states == P.STUB_DISTINCT


def test_cfg_only_binding():
    """A cfg-only binding has no module text: under "auto" bounds and POR
    resolve to None and the run is the one without them; under "on"
    each raises a ``TLAError`` that names the missing module text."""
    e = P.stub_device_engine(device="cpu", por="auto")
    assert e._facts is None and e._por_facts is None
    r = e.run()
    assert (r.distinct_states, r.levels) == (P.STUB_DISTINCT, P.STUB_LEVELS)
    assert "por_cut_ratio" not in r.metrics["gauges"]
    for kw in ({"bounds": "on"}, {"por": "on"}):
        with pytest.raises(TLAError, match="module text"):
            P.stub_device_engine(device="cpu", **kw)


# ---------------------------------------------------------------------
# K17's plain versions against the JAX body's expressions
# ---------------------------------------------------------------------
def _k17_case(seed, T, n_act, lanes, total, cap, density):
    """Random K17 inputs: a guard matrix of ``density``, a matrix whose
    eligible rows are nearly all True and whose other rows are all
    False, a queue that is the guard matrix's compaction (action-major,
    (row, lane) order, ``total`` items, filler items not ok), a table
    half full with markers from -1 to pdepth + 1, and half the queue's
    fingerprints in it."""
    rng = np.random.default_rng(seed)
    n_lanes = int(sum(lanes))
    en = rng.random((T, n_lanes)) < density
    valid = rng.random(T) < 0.9
    amat = rng.random((n_act, n_act)) < 0.97
    amat[rng.random(n_act) < 0.3] = False         # ineligible rows
    for a in range(n_act):
        if amat[a].any():
            amat[a, a] = True
    items = []
    lo = np.concatenate([[0], np.cumsum(lanes)[:-1]])
    for a, (l0, L) in enumerate(zip(lo, lanes)):
        r, ln = np.nonzero(en[:, l0:l0 + L] & valid[:, None])
        items += [(int(x), a, int(y)) for x, y in zip(r, ln)]
    items = items[:total]
    ok = np.zeros(total, bool)
    ok[:len(items)] = True
    items += [(T - 1, n_act - 1, 0)] * (total - len(items))
    pidx, aid, lane = (np.asarray(x, np.int32) for x in zip(*items))
    pdepth = 5
    n_in = cap // 2
    fps_in = rng.integers(0, 1 << 32, (n_in, 4), dtype=np.uint32)
    marks = rng.integers(pdepth - 2, pdepth + 2, n_in).astype(np.int32)
    marks[rng.random(n_in) < 0.1] = -1
    tbl = j_empty_table(cap)
    tbl, fresh, _ = j_insert_core(tbl, jnp.asarray(fps_in),
                                  jnp.ones((n_in,), bool))
    gids = j_store_gids(tbl["slots"], jnp.zeros((cap,), jnp.int32),
                        jnp.asarray(fps_in), jnp.asarray(marks), fresh)
    q_fps = rng.integers(0, 1 << 32, (total, 4), dtype=np.uint32)
    hit = rng.random(total) < 0.5
    q_fps[hit] = fps_in[rng.integers(0, n_in, int(hit.sum()))]
    return SimpleNamespace(
        en=en, valid=valid, amat=amat, pdepth=pdepth, lanes=lanes,
        slots=np.array(tbl["slots"]), gids=np.array(gids), fps=q_fps,
        pidx=pidx, aid=aid, lane=lane,
        en2=(rng.random(total) < 0.9) & ok, ok=ok)


def _jax_k17(c):
    """The JAX body's POR block (device_bfs.py:783-799, :909-931,
    :989-1013) on the case's inputs."""
    lo = np.concatenate([[0], np.cumsum(c.lanes)[:-1]])
    en = jnp.asarray(c.en) & jnp.asarray(c.valid)[:, None]
    en_act = jnp.stack([en[:, l0:l0 + L].any(axis=1)
                        for l0, L in zip(lo, c.lanes)], axis=1)
    conflict = (en_act.astype(jnp.int32)
                @ (~jnp.asarray(c.amat)).astype(jnp.int32).T) > 0
    cand = en_act & ~conflict
    has_cand = cand.any(axis=1)
    aid_star = jnp.argmax(cand, axis=1).astype(jnp.int32)
    pidx, aid = jnp.asarray(c.pidx), jnp.asarray(c.aid)
    en_q = jnp.asarray(c.en2) & jnp.asarray(c.ok)
    is_amp = en_q & has_cand[pidx] & (aid == aid_star[pidx])
    g = j_lookup_gids({"slots": jnp.asarray(c.slots)}, jnp.asarray(c.gids),
                      jnp.asarray(c.fps), is_amp)
    old_i = is_amp & (g >= 0) & (g <= c.pdepth)
    T = c.en.shape[0]
    amp_bad = jnp.zeros((T,), bool).at[pidx].max(old_i)
    take = has_cand & ~amp_bad
    keep_q = en_q & (~take[pidx] | (aid == aid_star[pidx]))
    n_act = c.amat.shape[0]
    kept = jnp.zeros((n_act,), jnp.int32).at[aid].add(
        keep_q.astype(jnp.int32))
    amp = (take & (en_act.sum(axis=1) > 1)).sum()
    return {k: np.asarray(v) for k, v in dict(
        has_cand=has_cand, aid_star=aid_star,
        n_en=en_act.sum(axis=1), amp_bad=amp_bad, keep=keep_q,
        kept=kept, amp=amp).items()}


@pytest.mark.parametrize("seed,T,n_act,lanes,total,cap,density", [
    (0, 8, 2, [1, 1], 16, 1 << 6, 0.5),
    (2, 256, 64, [1] * 64, 1024, 1 << 12, 0.04),
], ids=["stub", "stress"])
def test_k17_plain_equals_jax(seed, T, n_act, lanes, total, cap, density):
    """``por_cand_plain``, ``por_probe_plain`` and ``por_keep_plain``
    give the JAX expressions' candidates, C3 verdicts, keep mask, kept
    counts and amp count on random inputs (ineligible all-False rows
    included, markers from -1 to pdepth + 1, half the queue present),
    bit for bit."""
    c = _k17_case(seed, T, n_act, lanes, total, cap, density)
    want = _jax_k17(c)
    lo = np.concatenate([[0], np.cumsum(lanes)[:-1]])
    segs = TL.Segments(lo, lanes, [0] * n_act, "cpu")
    pt = TL.por_tables(c.amat, "cpu")
    Pb = TL.por_buffers(T, total, n_act, "cpu")
    q = {"pidx": torch.from_numpy(c.pidx), "aid": torch.from_numpy(c.aid),
         "lane": torch.from_numpy(c.lane), "ok": torch.from_numpy(c.ok)}
    pdepth = torch.tensor([c.pdepth], dtype=torch.int64)
    en2 = torch.from_numpy(c.en2)
    TL.por_cand(torch.from_numpy(c.en), torch.from_numpy(c.valid), segs,
                pt, Pb)
    table = {"slots": torch.from_numpy(c.slots.view(np.int32))}
    TL.por_probe(table, torch.from_numpy(c.gids),
                 torch.from_numpy(c.fps.view(np.int32)), en2, q, Pb, pdepth)
    TL.por_keep(en2, q, Pb, pdepth)
    got = {k: Pb[k].numpy() for k in ("has_cand", "aid_star", "n_en",
                                      "amp_bad", "keep", "kept")}
    for k in ("has_cand", "aid_star", "n_en", "keep", "kept"):
        assert np.array_equal(got[k].astype(np.int64),
                              want[k].astype(np.int64)), k
    assert np.array_equal(got["amp_bad"] != 0, want["amp_bad"])
    assert int(Pb["amp"][0]) == int(want["amp"])
    assert (Pb["mark"] == c.pdepth + 1).all()
    # the conflict masks the kernel reads: bit b of conf[a] = ~amat[a, b]
    conf = pt["conf"].numpy().view(np.uint64)
    for a in range(n_act):
        bits = [(int(conf[a]) >> b) & 1 for b in range(n_act)]
        assert bits == [int(not x) for x in c.amat[a]]
    if T >= 64:         # the stress shapes meet both C3 outcomes
        assert want["amp_bad"].any()
        assert (~want["amp_bad"] & want["has_cand"]).any()


# ---------------------------------------------------------------------
# the pruned VSR kernel
# ---------------------------------------------------------------------
def test_pruned_vsr_kernel_equals_jax():
    """``PrunedKernel`` over the port's VSR kernel, with every action but
    ExecuteOp dead (base id 11, pruned id 0), gives JAX
    ``PrunedKernel``'s lane tables and ``step_all`` lanes (its kept
    actions' lanes, the base kernel's columns) on the golden trace's 30
    states; the port's mapped
    ``guard_matrix`` and ``successors`` give the same lanes, and the
    base kernel's lane-indexed tables are refused."""
    from tpuvsr.engine.bounds import PrunedKernel as JPruned
    from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
    from tpuvsr.frontend.parser import parse_module_text
    from tpuvsr.frontend.trace_parse import parse_trace_file
    from tpuvsr.interp.evalr import Evaluator
    from tpuvsr.models.vsr import VSRCodec as JCodec
    from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.models.registry import make_model
    defect = os.path.join(ROOT, "examples", "VSR_defect.cfg")
    cfg = j_cfg(defect)
    mod = parse_module_text("---- MODULE VSR ----\nCONSTANTS "
                            + ", ".join(cfg.constants) + "\n====\n")
    shim = SimpleNamespace(cfg=cfg, ev=Evaluator(mod, cfg.constants))
    entries = parse_trace_file(
        os.path.join(ROOT, "examples", "found_violation_trace.txt"), shim)
    jcodec = JCodec(cfg.constants, max_msgs=48)
    jk = JKernel(jcodec)
    keep = ["ExecuteOp"]
    dead = [n for n in jk.action_names if n not in keep]
    jp = JPruned(jk, dead)
    codec, kern = make_model(load_binding(defect, "VSR"), max_msgs=48)
    pp = PrunedKernel(kern, dead)
    assert list(pp.action_names) == list(jp.action_names) == keep
    assert pp.n_lanes == jp.n_lanes
    assert np.array_equal(pp.lane_action, jp.lane_action)
    assert np.array_equal(pp.lane_param, jp.lane_param)
    dense = [jcodec.encode(e.state) for e in entries]
    batch = {k: np.stack([d[k] for d in dense]) for k in dense[0]}
    # JAX PrunedKernel.step_all = the kept actions' lanes, in order
    want_s, want_e = [], []
    for name, fn in zip(jp.action_names, jp._action_fns()):
        lanes = jnp.arange(jk._lane_count(name), dtype=jnp.int32)
        s, e = jax.jit(jax.vmap(lambda st: jax.vmap(
            lambda ln, fn=fn: fn(st, ln))(lanes)))(batch)
        want_s.append({k: np.asarray(v) for k, v in s.items()})
        want_e.append(np.asarray(e))
    want_e = np.concatenate(want_e, axis=1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_s, got_e = pp.step_all(tb)
    assert np.array_equal(got_e.numpy(), want_e)
    en_rows, en_lanes = np.nonzero(want_e)
    for k, v in got_s.items():
        w = np.concatenate([s[k] for s in want_s], axis=1)
        assert np.array_equal(v.numpy()[en_rows, en_lanes],
                              w[en_rows, en_lanes]), k
    flat = kern.pk.flatten(tb).contiguous()
    en, en_any = pp.guard_matrix(flat)
    assert np.array_equal(en.numpy(), want_e) and en.any()
    # K10's queue with the pruned ids gives the base kernel's successors
    rows, lanes_i = torch.nonzero(en, as_tuple=True)
    aid = torch.as_tensor(pp.lane_action, dtype=torch.int32)[lanes_i]
    prm = torch.as_tensor(pp.lane_param, dtype=torch.int32)[lanes_i]
    o = pp.successors(flat, rows.to(torch.int32), aid, prm, 0)
    base_aid = torch.as_tensor([kern.action_names.index(n) for n in keep],
                               dtype=torch.int32)[aid.long()]
    b = kern.successors(flat, rows.to(torch.int32), base_aid, prm, 0)
    assert torch.equal(o["succ"], b["succ"]) and o["en2"].all()
    with pytest.raises(TLAError, match="renumbered"):
        pp.guard_tables("cpu")
