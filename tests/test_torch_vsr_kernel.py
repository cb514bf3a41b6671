"""Parity of the port's VSR kernel (guards, actions, K3 fingerprints,
invariants) with the JAX VSRKernel on the CPU, on all 30 states of
examples/found_violation_trace.txt at MAX_MSGS=48, the fingerprints on
rows of random 32-bit words (``testing.fp_wide_case``), and K10's plain
version on the work queues of ``testing.actions_case``.

The trace is parsed through a constants-only shim spec (a VSR module
that declares only the cfg's CONSTANTS, plus an Evaluator), which needs
no reference corpus.  Everything compared is integer: tolerance 0."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.frontend.parser import parse_module_text
from tpuvsr.frontend.trace_parse import parse_trace_file
from tpuvsr.interp.evalr import Evaluator
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models.registry import make_model
from tpuvsr_torch.models.vsr_kernel import ACTION_NAMES
from tpuvsr_torch.testing import (ACTIONS_CASES, ACTIONS_CONSTANTS,
                                  ACTIONS_MAX_MSGS, FP_TOUCHED,
                                  actions_case, fp_wide_case)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")


@pytest.fixture(scope="module")
def golden():
    cfg = j_cfg(DEFECT)
    mod = parse_module_text("---- MODULE VSR ----\nCONSTANTS "
                            + ", ".join(cfg.constants) + "\n====\n")
    shim = SimpleNamespace(cfg=cfg, ev=Evaluator(mod, cfg.constants))
    entries = parse_trace_file(TRACE, shim)
    jcodec = JCodec(cfg.constants, max_msgs=48)
    jk = JKernel(jcodec)
    dense = [jcodec.encode(e.state) for e in entries]
    batch = {k: np.stack([d[k] for d in dense]) for k in dense[0]}
    codec, kern = make_model(load_binding(DEFECT, "VSR"), max_msgs=48)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    js, je = jk.step_batch(batch)
    ps, pe = kern.step_all(tb)
    return SimpleNamespace(entries=entries, jk=jk, kern=kern, codec=codec,
                           dense=dense, batch=batch, tb=tb,
                           js={k: np.asarray(v) for k, v in js.items()},
                           je=np.asarray(je), ps=ps, pe=pe.numpy())


def _lanes(kern, name):
    a = ACTION_NAMES.index(name)
    off = sum(kern._lane_count(n) for n in ACTION_NAMES[:a])
    return off, off + kern._lane_count(name)


def test_trace_has_30_states(golden):
    assert len(golden.entries) == 30
    assert golden.kern.n_lanes == golden.jk.n_lanes == 699


def test_init_dense_is_trace_state_1(golden):
    init = golden.codec.init_dense()
    for k, v in golden.dense[0].items():
        assert np.array_equal(init[k], v), k


@pytest.mark.parametrize("name", ACTION_NAMES)
def test_guard_matches_jax(golden, name):
    jk, kern = golden.jk, golden.kern
    a = ACTION_NAMES.index(name)
    g = jk._guard_fns()[a]
    lanes = jnp.arange(jk._lane_count(name))
    want = jax.vmap(lambda st: jax.vmap(lambda ln: g(st, ln))(lanes))(
        golden.batch)
    got = kern._guard_fns()[a](golden.tb)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", ACTION_NAMES)
def test_successors_match_jax(golden, name):
    """Enabled masks and successors of every lane (disabled lanes
    included: the totally computed successors agree too)."""
    lo, hi = _lanes(golden.kern, name)
    assert np.array_equal(golden.je[:, lo:hi], golden.pe[:, lo:hi])
    for k, v in golden.js.items():
        assert np.array_equal(v[:, lo:hi], golden.ps[k][:, lo:hi].numpy()), k


def test_guards_agree_with_actions(golden):
    guards = torch.cat([g(golden.tb) for g in golden.kern._guard_fns()],
                       dim=1)
    assert np.array_equal(guards.numpy(), golden.pe)


def test_full_fingerprints_match_jax(golden):
    kern, jk = golden.kern, golden.jk
    want = np.asarray(jk.fingerprint_batch(golden.batch))
    got = kern.fingerprint_batch(golden.tb).numpy().view(np.uint32)
    assert np.array_equal(want, got)
    # and the enabled successors'
    en = golden.je
    succ = {k: v[en] for k, v in golden.js.items()}
    want = np.asarray(jk.fingerprint_batch(succ))
    got = kern.fingerprint_batch(
        {k: torch.from_numpy(v) for k, v in succ.items()})
    assert np.array_equal(want, got.numpy().view(np.uint32))


def test_parent_parts_match_jax(golden):
    jr, js, jt = jax.vmap(golden.jk.parent_parts)(golden.batch)
    kern = golden.kern
    pr, ps, pt = kern.parent_parts(kern.pk.flatten(golden.tb))
    assert np.array_equal(np.asarray(jr)[:, 0], pr.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(js)[:, 0], ps.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(jt)[:, 0], pt.numpy().view(np.uint32))


def test_incremental_fingerprints_match_jax(golden):
    """fingerprint_incremental of every enabled (state, lane) item, as
    the fused body computes it, equals the JAX kernel's, for every
    action enabled somewhere on the trace."""
    jk, kern, pk = golden.jk, golden.kern, golden.kern.pk
    parts = jax.vmap(jk.parent_parts)(golden.batch)
    flat = pk.flatten(golden.tb)
    pparts = kern.parent_parts(flat)
    checked = []
    for a, name in enumerate(ACTION_NAMES):
        lo, hi = _lanes(kern, name)
        st_i, ln = np.nonzero(golden.je[:, lo:hi])
        if len(st_i) == 0:
            continue
        fn = jk._action_fns()[a]

        def one(st, parts_one, lane, fn=fn, name=name):
            succ, _en = fn(jk.seed_touch(st), lane)
            ri = jk.lane_replica(name, st, lane)
            return jk.fingerprint_incremental(succ, ri, parts_one, st)
        sel = {k: v[st_i] for k, v in golden.batch.items()}
        psel = jax.tree_util.tree_map(lambda v: v[st_i], parts)
        want = np.asarray(jax.jit(jax.vmap(one))(sel, psel,
                                                 jnp.asarray(ln)))
        pidx = torch.from_numpy(st_i)
        lane = torch.from_numpy(ln)
        st_sel = pk.unflatten(flat[pidx])
        succ, _en = kern._action_fns()[a](kern.seed_touch(st_sel), lane)
        sflat = pk.flatten({k: v for k, v in succ.items()
                            if not k.startswith("_")})
        got = kern.fingerprint_incremental(
            sflat, kern.lane_replica(name, st_sel, lane).to(torch.int32),
            succ["_ts"], pidx.to(torch.int32), flat, pparts)
        assert np.array_equal(want, got.numpy().view(np.uint32)), name
        checked.append(name)
    assert len(checked) >= 12, checked


def perm_lanes(jk, pk):
    """The flat lanes the JAX fingerprint relabels through its identity
    permutation table (value ids), found as the lanes that change when a
    row of ids past every table is relabelled (JAX clamps such an id).
    A wide-word row keeps them in 0..V, where the table is the
    identity."""
    big = torch.full((1, pk.lanes), 0x7FFF0000, dtype=torch.int32)
    st = {k: jnp.asarray(v[0].numpy()) for k, v in pk.unflatten(big).items()}
    out = jk._permuted(st, jnp.asarray(jk.perms[0]))
    flat = pk.flatten({k: torch.as_tensor(np.array(out[k]))[None]
                       for k in st})
    assert flat.shape == big.shape
    return np.nonzero((flat != big).numpy()[0])[0]


def wide_word_check(jk, kern, what, seed):
    """The plain parts, full and incremental fingerprints against JAX on
    ``testing.fp_wide_case`` rows (words over all 2^32 values; the
    relabelled lanes in 0..V): ``what`` is "parts", "full" or
    "incremental_<touched>" (``testing.FP_TOUCHED``)."""
    pk = kern.pk
    touched = what.split("_")[1] if what.startswith("incr") else "mixed"
    c = fp_wide_case(kern, seed=seed, touched=touched,
                     small_lanes=perm_lanes(jk, pk),
                     small_max=jk.perms.shape[1] - 1)
    parent = torch.from_numpy(c.parent)
    dense = lambda rows: {k: v.numpy() for k, v in
                          pk.unflatten(torch.from_numpy(rows)).items()}
    jparts = jax.jit(jax.vmap(jk.parent_parts))
    u32 = lambda t: t.numpy().view(np.uint32)
    if what == "parts":
        want = jparts(dense(c.parent))
        got = kern.parent_parts(parent)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w)[:, 0], u32(g))
        assert (c.parent.view(np.uint32) >= 2**31).any()
        return
    if what == "full":
        want = np.asarray(jax.jit(jax.vmap(jk.fingerprint))(dense(c.succ)))
        assert np.array_equal(want, u32(kern.fingerprint(
            torch.from_numpy(c.succ))))
        return
    parts = jparts(dense(c.parent))
    succ = dense(c.succ)
    succ["_ts"] = c.ts
    want = np.asarray(jax.jit(jax.vmap(jk.fingerprint_incremental))(
        succ, c.ri, jax.tree_util.tree_map(lambda v: v[c.pidx], parts),
        {k: v[c.pidx] for k, v in dense(c.parent).items()}))
    got = kern.fingerprint_incremental(
        torch.from_numpy(c.succ), torch.from_numpy(c.ri),
        torch.from_numpy(c.ts), torch.from_numpy(c.pidx), parent,
        kern.parent_parts(parent))
    assert np.array_equal(want, u32(got))
    n_ts = (c.ts >= 0).sum(axis=1)
    assert {"none": n_ts.max() == 0,
            "all": (n_ts == kern.R + 1).all(),
            "mixed": 0 < n_ts.mean() < kern.R + 1}[touched]


WIDE_WORDS = ["parts", "full"] + [f"incremental_{t}" for t in FP_TOUCHED]


@pytest.mark.parametrize("what", WIDE_WORDS)
def test_fingerprints_of_wide_words_match_jax(golden, what):
    """Words at and past 2^31 (wrapping sums, the logical shifts of
    mix32), no touched slot and R + 1 of them."""
    wide_word_check(golden.jk, golden.kern, what, seed=17)


def test_invariants_match_jax(golden):
    jk, kern = golden.jk, golden.kern
    for names in (["AcknowledgedWriteNotLost"],
                  ["AcknowledgedWritesExistOnMajority"],
                  ["NoLogDivergence", "AcknowledgedWriteNotLost"]):
        want = np.asarray(jax.vmap(jk.invariant_fn(names))(golden.batch))
        got = kern.invariant_fn(names)(golden.tb).numpy()
        assert np.array_equal(want, got)
    ok = kern.invariant_fn(["AcknowledgedWriteNotLost"])(golden.tb)
    assert ok[:-1].all() and not ok[-1]


def test_recorded_transitions_reproduced(golden):
    """Each of the 29 recorded steps is an enabled lane of the recorded
    action whose successor has the recorded state's fingerprint."""
    kern = golden.kern
    fps = kern.fingerprint_batch(golden.tb).numpy()
    for i, e in enumerate(golden.entries[1:]):
        lo, hi = _lanes(kern, e.action_name)
        en = golden.pe[i, lo:hi]
        succ = {k: v[i, lo:hi][en] for k, v in golden.ps.items()}
        sfp = kern.fingerprint_batch(succ).numpy()
        assert (sfp == fps[i + 1]).all(axis=1).any(), (i, e.action_name)


# ----------------------------------------------------------------------
# K10's edge cases (testing.actions_case): the plain version against the
# JAX act_*, lane_replica and invariants, item by item
# ----------------------------------------------------------------------
ACTIONS_FIELDS = ("succ", "en2", "err", "ts", "tn", "ri", "iok")


@pytest.fixture(scope="module")
def actions_jax():
    """jit(vmap) of every lane of every JAX action over a fixed batch of
    parent rows, at ``testing.actions_case``'s constants and layout."""
    from tests.test_torch_actions import _jax_all_lanes
    cfg = j_cfg(DEFECT)
    cfg.constants.update(ACTIONS_CONSTANTS)
    return _jax_all_lanes(JKernel(JCodec(cfg.constants,
                                         max_msgs=ACTIONS_MAX_MSGS)))


@pytest.mark.parametrize("name", ACTIONS_CASES)
def test_actions_case_matches_jax(actions_jax, name):
    """Every output of K10's plain version (``successors_plain``) on the
    case's queue, fill items included, equals the JAX action of the
    item's (row, lane) from ``seed_touch``, its ``lane_replica`` and the
    invariants; under a set halt word it writes nothing."""
    from tests.test_torch_actions import _jax_outputs
    c = actions_case(name)
    kern = c.kern
    rows = torch.as_tensor(c.rows)
    T = rows.shape[0]
    pad = torch.cat([rows, rows[:1].repeat(17 - T, 1)])
    st = kern.pk.unflatten(pad)
    dense = [{k: v[r].numpy() for k, v in st.items()} for r in range(17)]
    want = _jax_outputs(kern, actions_jax, dense)
    first = {a: int(np.argmax(kern.lane_action == a))
             for a in range(len(ACTION_NAMES))}
    g = np.asarray([first[a] for a in c.aid]) + c.lane
    assert (kern.lane_param[g] == c.lane).all()
    args = [torch.as_tensor(x) for x in (c.pidx, c.aid, c.lane)]
    got = kern.successors_plain(rows, *args, c.inv_mask)
    assert c.inv_mask == 31
    for k in ACTIONS_FIELDS:
        w = want[k][c.pidx, g]
        assert np.array_equal(got[k].numpy(), w.astype(got[k].numpy().dtype)
                              ), (name, k)
    if c.ok is not None:
        assert not c.ok.all()       # fill items, held above like the rest
    if c.halt:
        out = kern.successor_buffers(len(c.pidx), "cpu")
        for v in out.values():
            v.fill_(1)
        kern.successors(rows, *args, c.inv_mask, out,
                        halt=torch.ones((1,), dtype=torch.int64))
        assert all(bool((v == 1).all()) for v in out.values())
