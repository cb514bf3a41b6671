"""The port's guard matrix (K6's plain version) against the JAX engine's
``_guard_matrix`` closure, and the work-queue compaction (K7's plain
version) against ``jnp.nonzero(size=E, fill_value=T*L)``, on the CPU
(the cases of ``tpuvsr_torch.testing.compact_case``).

Guard inputs: the 30 states of examples/found_violation_trace.txt and
their enabled successors, plus 256 numpy-seeded rows drawn inside each
lane's packing range, at MAX_MSGS 32 and 48.  Everything compared is
integer: tolerance 0."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvsr.engine.device_bfs import DeviceBFS as JDeviceBFS
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.frontend.parser import parse_module_text
from tpuvsr.frontend.trace_parse import parse_trace_file
from tpuvsr.interp.evalr import Evaluator
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.engine import tile as TL
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models.registry import make_model
from tpuvsr_torch.models.vsr_kernel import GUARD_PLANES
from tpuvsr_torch.testing import COMPACT_CASES, compact_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")


@pytest.fixture(scope="module")
def trace_entries():
    cfg = j_cfg(DEFECT)
    mod = parse_module_text("---- MODULE VSR ----\nCONSTANTS "
                            + ", ".join(cfg.constants) + "\n====\n")
    shim = SimpleNamespace(cfg=cfg, ev=Evaluator(mod, cfg.constants))
    return cfg, parse_trace_file(TRACE, shim)


def _random_rows(pk, n, seed):
    """``n`` flat rows, each lane uniform in its packing range (raw
    32-bit lanes, the bag counts, in 0..2)."""
    rng = np.random.default_rng(seed)
    raw = pk._bits >= 32
    lo = np.where(raw, 0, pk._lo.astype(np.int64))
    hi = np.where(raw, 2, lo + (1 << np.minimum(pk._bits, 31)) - 1)
    return rng.integers(lo, hi + 1, size=(n, pk.lanes)).astype(np.int32)


@pytest.fixture(scope="module", params=[32, 48])
def rows(request, trace_entries):
    """Golden states, their enabled successors and random rows, as the
    JAX dense batch and the port's flat rows, at one MAX_MSGS."""
    m = request.param
    cfg, entries = trace_entries
    jk = JKernel(JCodec(cfg.constants, max_msgs=m))
    dense = [jk.codec.encode(e.state) for e in entries]
    batch = {k: np.stack([d[k] for d in dense]) for k in dense[0]}
    succ, en = jk.step_batch(batch)
    en = np.asarray(en).reshape(-1)
    succ = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])[en]
            for k, v in succ.items()}
    _codec, kern = make_model(load_binding(DEFECT, "VSR"), max_msgs=m)
    pk = kern.pk
    flat = torch.cat([
        pk.flatten({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()}) for b in (batch, succ)]
        + [torch.from_numpy(_random_rows(pk, 256, 7 + m))])
    st = pk.unflatten(flat)
    jbatch = {k: np.asarray(v) for k, v in st.items()}
    return SimpleNamespace(m=m, jk=jk, kern=kern, flat=flat, jbatch=jbatch,
                           n_golden=len(dense), n_succ=int(en.sum()))


def test_rows_cover_the_guards(rows):
    """The inputs enable every action somewhere (SendGetState's SendOnce
    scan included: the golden trace sends a GetState)."""
    en, _any = rows.kern.guard_matrix_plain(rows.flat)
    aid = torch.as_tensor(rows.kern.lane_action).long()
    per = torch.zeros(19, dtype=torch.int64).index_add_(
        0, aid, en.sum(dim=0))
    hit = [n for n, c in zip(rows.kern.action_names, per.tolist()) if c]
    assert len(hit) >= 15, hit
    assert "SendGetState" in hit
    assert rows.n_succ > 29


def test_guard_matrix_matches_jax(rows):
    mat = JDeviceBFS._guard_matrix(None, rows.jk)
    want = np.concatenate([np.asarray(s) for s in mat(rows.jbatch)], axis=1)
    en, en_any = rows.kern.guard_matrix(rows.flat)
    assert en.shape == (rows.flat.shape[0], rows.kern.n_lanes)
    assert np.array_equal(en.numpy(), want)
    assert np.array_equal(en_any.numpy(), want.any(axis=1))


def test_guard_matrix_is_the_guard_loop(rows):
    st = rows.kern.pk.unflatten(rows.flat)
    loop = torch.cat([g(st) for g in rows.kern._guard_fns()], dim=1)
    en, _ = rows.kern.guard_matrix(rows.flat)
    assert torch.equal(en, loop)


def test_guard_matrix_halt_leaves_outputs(rows):
    kern = rows.kern
    out = (torch.zeros((rows.flat.shape[0], kern.n_lanes), dtype=torch.bool),
           torch.ones((rows.flat.shape[0],), dtype=torch.bool))
    kern.guard_matrix(rows.flat, out, torch.ones((1,), dtype=torch.int64))
    assert not out[0].any() and out[1].all()
    kern.guard_matrix(rows.flat, out, torch.zeros((1,), dtype=torch.int64))
    assert torch.equal(out[0], kern.guard_matrix(rows.flat)[0])


def test_guard_plane_table_matches_the_kernel_source():
    src = open(os.path.join(ROOT, "tpuvsr_torch", "csrc",
                            "vsr_guards.cu")).read()
    body = src[src.index("enum Plane {"):]
    names = body[body.index("{") + 1:body.index("}")].replace(
        "\n", " ").split(",")
    names = [n.strip() for n in names if n.strip()]
    assert names[-1] == "N_PLANES"
    assert [n[2:].lower() for n in names[:-1]] == list(GUARD_PLANES)


# ----------------------------------------------------------------------
# K7: the work-queue compaction
# ----------------------------------------------------------------------
def _jax_queue(en, valid, segs):
    """What the JAX body computes per action: jnp.nonzero(en_f, size=E,
    fill_value=T*L) split into (row clipped, lane), and sel < T*L."""
    T = en.shape[0]
    out = []
    for lo, L, E, _qo in segs:
        TL = T * L
        en_f = (en[:, lo:lo + L] & valid[:, None]).reshape(TL)
        (sel,) = jnp.nonzero(jnp.asarray(en_f), size=E, fill_value=TL)
        sel = np.asarray(sel)
        out.append((np.clip(sel // L, 0, T - 1), sel % L, sel < TL,
                    int(en_f.sum())))
    return out


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_matches_jnp_nonzero(case):
    """K7's plain version against jnp.nonzero on each case of
    ``testing.compact_case``; with ``action`` set only that segment is
    written, and the others keep their zeros and their need."""
    c = compact_case(case)
    T, n_act = c.en.shape[0], len(c.lanes)
    segs = TL.Segments(c.lane_off, c.lanes, c.caps, "cpu")
    q = TL.queue_buffers(segs.total, n_act, "cpu")
    carry = TL.new_carry(n_act, "cpu")
    carry[TL.C_NEED:TL.C_NEED + n_act] = torch.tensor(c.need)
    TL.compact(torch.from_numpy(c.en), torch.from_numpy(c.valid), segs, q,
               carry, action=c.action)
    per = []
    for a, ((pidx, lane, ok, cnt), (lo, L, E, qo)) in enumerate(
            zip(_jax_queue(c.en, c.valid, segs.host), segs.host)):
        per.append(cnt)
        if c.action is not None and a != c.action:
            assert not q["pidx"][qo:qo + E].any()
            assert not q["ok"][qo:qo + E].any()
            assert int(q["cnts"][a]) == 0 and not bool(q["ovf"][a])
            assert int(carry[TL.C_NEED + a]) == c.need[a]
            continue
        assert np.array_equal(q["pidx"][qo:qo + E].numpy(), pidx)
        assert np.array_equal(q["lane"][qo:qo + E].numpy(), lane)
        assert np.array_equal(q["ok"][qo:qo + E].numpy(), ok)
        assert (q["aid"][qo:qo + E] == a).all()
        assert int(q["cnts"][a]) == cnt
        assert bool(q["ovf"][a]) == (cnt > E)
        assert int(carry[TL.C_NEED + a]) == max(cnt, c.need[a])
    if case in ("overflow", "cap1", "rows37", "rows128", "rows1100"):
        assert q["ovf"].any()
    if case == "exact_fit":
        assert not q["ovf"].any() and bool(q["ok"].all()) == all(per)
    if case == "cap1":
        assert all(p > 1 for p in per) and bool(q["ok"].all())
    if case == "all_invalid":
        assert not any(per) and not q["ok"].any()


def test_compact_halted_carry_leaves_the_queue():
    en = torch.ones((2, 3), dtype=torch.bool)
    segs = TL.Segments([0], [3], [4], "cpu")
    q = TL.queue_buffers(segs.total, 1, "cpu")
    carry = TL.new_carry(1, "cpu", halt=1)
    TL.compact(en, torch.ones(2, dtype=torch.bool), segs, q, carry)
    assert not q["ok"].any() and int(q["cnts"][0]) == 0
    assert int(carry[TL.C_NEED]) == 0
