"""The port's symmetry reduction (``tpuvsr_torch/engine/canon.py``, K9's
plain version) against ``tpuvsr.engine.canon`` and the JAX VSRKernel, on
the CPU.

Rows: the 30 states of examples/found_violation_trace.txt with their
enabled successors (|Values| = 3, the defect cfg with SYMMETRY
symmValues added), states reachable in three steps of the shipped model
(|Values| = 2, tpuvsr_torch/configs/VSR_shipped.cfg), and numpy-seeded
rows drawn inside each lane's packing range, at MAX_MSGS 24, 32 and 48.
The JAX group comes from ``tpuvsr/engine/spec.py:_symmetry_perms`` over
a constants-only shim VSR module.  Everything compared is integer:
tolerance 0."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuvsr.engine import canon as JC
from tpuvsr.engine.spec import SpecModel
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.frontend.parser import parse_module_text
from tpuvsr.frontend.trace_parse import parse_trace_file
from tpuvsr.interp.evalr import Evaluator
from tpuvsr.models.registry import value_perm_table as j_value_perm_table
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
from tpuvsr.testing import stub_sym_factory as j_sym_factory
from tpuvsr.testing import sym_pair_spec
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.core.values import ModelValue, TLAError
from tpuvsr_torch.engine import canon as C
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.spec import load_binding, symmetry_perms
from tpuvsr_torch.models.registry import make_model, value_perm_table
from tpuvsr_torch.models.vsr import E_OPER, NENT
from tpuvsr_torch.models.vsr_kernel import VSRKernel
from tpuvsr_torch.testing import stub_sym_factory, sympair_binding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
SHIPPED = os.path.join(ROOT, "tpuvsr_torch", "configs", "VSR_shipped.cfg")
TRACE = os.path.join(ROOT, "examples", "found_violation_trace.txt")


def _jax_shim(cfg):
    """A constants-only VSR module that defines symmValues as VSR.tla:151
    does, with the cfg's constants bound."""
    mod = parse_module_text(
        "---- MODULE VSR ----\nCONSTANTS " + ", ".join(cfg.constants)
        + "\nsymmValues == Permutations(Values)\n====\n")
    return SimpleNamespace(cfg=cfg, module=mod,
                           ev=Evaluator(mod, cfg.constants))


def _port_binding(cfg_path):
    """The port's binding of a cfg, with SYMMETRY symmValues declared."""
    b = load_binding(cfg_path, "VSR")
    b.cfg.symmetry = "symmValues"
    b.symmetry_perms = symmetry_perms("VSR", b.cfg)
    return b


def _random_rows(pk, n, seed):
    """``n`` flat rows, each lane uniform in its packing range (raw
    32-bit lanes, the bag counts, in 0..2)."""
    rng = np.random.default_rng(seed)
    raw = pk._bits >= 32
    lo = np.where(raw, 0, pk._lo.astype(np.int64))
    hi = np.where(raw, 2, lo + (1 << np.minimum(pk._bits, 31)) - 1)
    return rng.integers(lo, hi + 1, size=(n, pk.lanes)).astype(np.int32)


def _enabled_successors(kern, flat):
    succ, en = kern.step_all(kern.pk.unflatten(flat))
    return kern.pk.flatten({k: v[en] for k, v in succ.items()})


CASES = [("shipped", 24), ("shipped", 48), ("defect", 32), ("defect", 48)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    which, m = request.param
    path = SHIPPED if which == "shipped" else DEFECT
    jcfg = j_cfg(path)
    shim = _jax_shim(jcfg)
    jperms = SpecModel._symmetry_perms(shim, "symmValues")
    jcodec = JCodec(jcfg.constants, max_msgs=m)
    jk = JKernel(jcodec)
    jgroup = JC.group_table(SimpleNamespace(symmetry_perms=jperms), jcodec)
    jcanon = JC.CanonSpec(jgroup, JC.orbit_planes(jk), jk)
    binding = _port_binding(path)
    codec, kern = make_model(binding, max_msgs=m)
    canon = C.build_canon_spec(binding, codec, kern)
    pk = kern.pk
    if which == "defect":
        entries = parse_trace_file(TRACE, shim)
        dense = [jcodec.encode(e.state) for e in entries]
        states = pk.flatten({k: torch.from_numpy(np.stack([d[k] for d in dense]))
                             for k in dense[0]})
    else:
        states = pk.flatten({k: torch.as_tensor(v)[None]
                             for k, v in codec.init_dense().items()})
        level = states
        for _ in range(3):
            level = _enabled_successors(kern, level)
            states = torch.cat([states, level])
    flat = torch.cat([states, _enabled_successors(kern, states),
                      torch.from_numpy(_random_rows(pk, 192, 11 + m))])
    jbatch = {k: jnp.asarray(v.numpy())
              for k, v in pk.unflatten(flat).items()}
    return SimpleNamespace(which=which, m=m, jperms=jperms, jk=jk,
                           jcanon=jcanon, binding=binding, codec=codec,
                           kern=kern, canon=canon, flat=flat, jbatch=jbatch)


def _j_flat(case, jst):
    return case.kern.pk.flatten({k: torch.from_numpy(np.array(v))
                                 for k, v in jst.items()})


def test_group_and_version_match_jax(case):
    assert [{k.name: v.name for k, v in p.items()}
            for p in case.binding.symmetry_perms] == \
        [{k.name: v.name for k, v in p.items()} for p in case.jperms]
    assert C.group_closed(case.binding.symmetry_perms)
    assert JC.group_closed(case.jperms)
    assert np.array_equal(case.canon.group,
                          np.asarray(case.jcanon.group))
    assert case.canon.perms == (2 if case.which == "shipped" else 6)
    assert np.array_equal(
        value_perm_table(case.binding, case.codec, fold_symmetry=True),
        j_value_perm_table(SimpleNamespace(symmetry_perms=case.jperms),
                           case.jk.codec))
    assert C.orbit_planes(VSRKernel) == JC.orbit_planes(JKernel)
    assert C.kernel_fold_order(case.kern) == \
        JC.kernel_fold_order(case.jk) == 1
    assert case.canon.version == case.jcanon.version
    assert case.canon.manifest() == case.jcanon.manifest()


def test_key_positions_match_jax_key(case):
    """The K9 position table lists, in the order of JAX's ``_key``, the
    key lanes a permutation relabels (the E_OPER columns)."""
    jkey = np.asarray(jax.vmap(case.jcanon._key)(case.jbatch))
    relabelled = np.concatenate([
        np.arange(int(np.prod(np.asarray(case.jbatch[k]).shape[1:])))
        % NENT == E_OPER for k in sorted(case.canon.planes)])
    got = case.flat[:, torch.as_tensor(case.canon.pos).long()]
    assert got.shape[1] == int(relabelled.sum())
    assert np.array_equal(got.numpy().astype(np.uint32),
                          jkey[:, relabelled])


def test_canonicalize_matches_jax(case):
    want = _j_flat(case, jax.jit(jax.vmap(case.jcanon.canonicalize))(
        case.jbatch))
    got = case.canon.canonicalize_plain(case.flat)
    assert torch.equal(got, want)
    assert torch.equal(case.canon.canonicalize(case.flat), want)
    assert not torch.equal(got, case.flat)     # some rows were relabelled


def test_canonical_fingerprint_matches_jax(case):
    want = np.asarray(jax.jit(jax.vmap(
        case.jcanon.fingerprint_fn(case.jk)))(case.jbatch)).view(np.int32)
    got = case.canon.fingerprint_fn(case.kern)(case.flat)
    assert np.array_equal(got.numpy(), want)


def test_idempotent_and_orbit_invariant(case):
    c = case.canon.canonicalize(case.flat)
    assert torch.equal(case.canon.canonicalize(c), c)
    pk = case.kern.pk
    for g in torch.as_tensor(case.canon.group):
        moved = pk.flatten(case.kern._permuted(pk.unflatten(case.flat), g))
        assert torch.equal(case.canon.canonicalize(moved), c)


def test_sympair_table_action_matches_jax():
    """SymPair's kernel has no ``_permuted``: the SYM_PLANES table
    action canonicalizes its 16 states as JAX's does."""
    jspec = sym_pair_spec()
    jcodec, jkern = j_sym_factory()(jspec)
    jcanon = JC.build_canon_spec(jspec, jcodec, jkern)
    binding = sympair_binding()
    codec, kern = stub_sym_factory()(binding)
    canon = C.build_canon_spec(binding, codec, kern)
    assert not hasattr(kern, "_permuted")
    assert canon.version == jcanon.version and canon.perms == 6
    assert np.array_equal(canon.group, jcanon.group)
    ab = np.array([(a, b) for a in range(4) for b in range(4)], np.int32)
    z = np.zeros(len(ab), np.int32)
    batch = {"status": z, "a": ab[:, 0], "b": ab[:, 1], "err": z}
    want = jax.vmap(jcanon.canonicalize)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = canon.canonicalize(kern.pk.flatten(
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert torch.equal(got, kern.pk.flatten(
        {k: torch.from_numpy(np.array(v)) for k, v in want.items()}))
    assert len({tuple(r) for r in got.tolist()}) == 5       # 5 orbits


# ----------------------------------------------------------------------
# loud errors
# ----------------------------------------------------------------------
def test_non_closed_group_is_refused():
    v1, v2, v3 = (ModelValue(n) for n in ("v1", "v2", "v3"))
    cycle = [{v1: v2, v2: v3, v3: v1}]            # its inverse is missing
    assert not C.group_closed(cycle)
    binding = _port_binding(DEFECT)
    binding.symmetry_perms = cycle
    codec, kern = make_model(binding)
    with pytest.raises(TLAError, match="not closed"):
        C.build_canon_spec(binding, codec, kern)
    from tpuvsr.core.values import ModelValue as JMV
    j1, j2, j3 = (JMV(n) for n in ("v1", "v2", "v3"))
    assert not JC.group_closed([{j1: j2, j2: j3, j3: j1}])


def test_unknown_symmetry_name_is_refused(tmp_path):
    cfg = tmp_path / "VSR_other.cfg"
    cfg.write_text(open(SHIPPED).read().replace("SYMMETRY symmValues",
                                                "SYMMETRY symmOther"))
    with pytest.raises(TLAError, match="symmOther"):
        load_binding(str(cfg), "VSR")


def test_symmetry_on_without_a_symmetry_cfg_is_refused():
    with pytest.raises(TLAError, match="declares no SYMMETRY"):
        DeviceBFS(load_binding(DEFECT, "VSR"), device="cpu", symmetry=True)


def test_kernel_refuses_a_folded_table():
    binding = load_binding(SHIPPED, "VSR")
    codec, _kern = make_model(binding)
    with pytest.raises(ValueError, match="identity"):
        VSRKernel(codec, perms=value_perm_table(binding, codec,
                                                fold_symmetry=True))
