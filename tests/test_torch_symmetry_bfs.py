"""Symmetry reduction through the port's two BFS entry points, on the CPU:
SymPair against the JAX package's ``stub_sym_engine`` (5 orbits with
symmetry on, 16 states off, the NoPair trace), and the shipped VSR model
(tpuvsr_torch/configs/VSR_shipped.cfg, SYMMETRY symmValues) against a
host level BFS over the JAX VSRKernel whose fingerprint is the JAX
CanonSpec's.  Integer results: tolerance 0.

Run as a script (``python tests/test_torch_symmetry_bfs.py N``) it
prints the JAX level sizes of the shipped model with symmetry on to
depth N and off to depth N - 1, the record ``chip_smoke.py`` phase 8
holds the card against (N = 10: about three minutes on 8 CPU
cores)."""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

from tpuvsr.engine.canon import CanonSpec as JCanon  # noqa: E402
from tpuvsr.engine.canon import group_table as j_group_table  # noqa: E402
from tpuvsr.engine.canon import orbit_planes as j_orbit_planes  # noqa: E402
from tpuvsr.engine.spec import SpecModel  # noqa: E402
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg  # noqa: E402
from tpuvsr.frontend.parser import parse_module_text  # noqa: E402
from tpuvsr.interp.evalr import Evaluator  # noqa: E402
from tpuvsr.models.vsr import VSRCodec as JCodec  # noqa: E402
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel  # noqa: E402
from tpuvsr.testing import stub_sym_engine as j_sym_engine  # noqa: E402
from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.testing import (  # noqa: E402
    SYMPAIR_DISTINCT, SYMPAIR_LEVELS, SYMPAIR_ORBIT_LEVELS, SYMPAIR_ORBITS,
    stub_sym_engine)

DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
SHIPPED = os.path.join(ROOT, "tpuvsr_torch", "configs", "VSR_shipped.cfg")
ON_LEVELS = [1, 3, 10, 35, 124, 403]
OFF_LEVELS = [1, 4, 14, 48, 168, 558]


def _names(v):
    return v if isinstance(v, int) else repr(v)


def _trace(res):
    return [(t.position, t.action_name,
             {k: _names(v) for k, v in t.state.items()}) for t in res.trace]


@pytest.mark.parametrize("symmetry, inv_pair", [
    ("auto", False), (False, False), ("auto", True), (False, True)])
@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_sympair_matches_jax(entry, symmetry, inv_pair):
    je = j_sym_engine(symmetry=symmetry, inv_pair=inv_pair, pipeline=1)
    pe = stub_sym_engine(symmetry=symmetry, inv_pair=inv_pair, device="cpu")
    jr, pr = je.run(), getattr(pe, entry)()
    assert (pr.ok, pr.distinct_states, pr.states_generated) == \
        (jr.ok, jr.distinct_states, jr.states_generated)
    assert pe.level_sizes == je.level_sizes
    assert pr.violated_invariant == jr.violated_invariant
    assert _trace(pr) == _trace(jr)
    pg, jg = pr.metrics["gauges"], jr.metrics["gauges"]
    assert pg["symmetry_perms"] == jg["symmetry_perms"] == \
        (6 if symmetry == "auto" else 1)
    assert pg["orbit_ratio"] == jg["orbit_ratio"]
    if not inv_pair:
        on = symmetry == "auto"
        assert pr.distinct_states == (SYMPAIR_ORBITS if on
                                      else SYMPAIR_DISTINCT)
        assert pe.level_sizes == (SYMPAIR_ORBIT_LEVELS if on
                                  else SYMPAIR_LEVELS)
    else:
        assert not pr.ok and pr.violated_invariant == "NoPair"


def _jax_level_bfs(depth, symmetry, batch=64):
    """Host-driven level BFS of the shipped model with the JAX VSRKernel
    from the dense Init, the frontier padded to one fixed batch so JAX
    compiles once; with symmetry the stored fingerprint is the JAX
    CanonSpec's."""
    cfg = j_cfg(SHIPPED)
    codec = JCodec(cfg.constants)
    kern = JKernel(codec)
    fp_one = kern.fingerprint
    if symmetry:
        mod = parse_module_text(
            "---- MODULE VSR ----\nCONSTANTS " + ", ".join(cfg.constants)
            + "\nsymmValues == Permutations(Values)\n====\n")
        shim = SimpleNamespace(module=mod, ev=Evaluator(mod, cfg.constants))
        perms = SpecModel._symmetry_perms(shim, "symmValues")
        canon = JCanon(j_group_table(SimpleNamespace(symmetry_perms=perms),
                                     codec), j_orbit_planes(kern), kern)
        fp_one = canon.fingerprint_fn(kern)
    fp_all = jax.jit(jax.vmap(fp_one))
    init = codec.zero_state()
    init["view"][:] = 1
    init["ct"][:, :, 2] = 1
    seen = {tuple(np.asarray(fp_all({k: v[None] for k, v in init.items()}))[0])}
    frontier, levels = [init], [1]
    for _ in range(depth):
        nxt = []
        for off in range(0, len(frontier), batch):
            part = frontier[off:off + batch]
            b = {k: np.stack([p[k] for p in part]
                             + [part[0][k]] * (batch - len(part)))
                 for k in init}
            succ, en = kern.step_batch(b)
            en = np.asarray(en)[:len(part)]
            flat = {k: np.asarray(v)[:len(part)].reshape(
                (-1,) + np.asarray(v).shape[2:]) for k, v in succ.items()}
            pad = batch * kern.n_lanes - en.size
            fps = np.asarray(fp_all({k: np.concatenate(
                [v, np.repeat(v[:1], pad, axis=0)]) for k, v in flat.items()}))
            for i in np.nonzero(en.reshape(-1))[0]:
                key = tuple(fps[i])
                if key not in seen:
                    seen.add(key)
                    nxt.append({k: v[i] for k, v in flat.items()})
        levels.append(len(nxt))
        frontier = nxt
    return levels


def _engine(symmetry="auto", **kw):
    return DeviceBFS(load_binding(SHIPPED, "VSR"), tile_size=32, chunk_tiles=4,
                     fpset_capacity=1 << 14, next_capacity=1 << 10,
                     device="cpu", symmetry=symmetry, **kw)


def _pointers(eng):
    return [np.concatenate(getattr(eng, k))
            for k in ("_h_parent", "_h_action", "_h_param")]


@pytest.fixture(scope="module", params=["auto", False], ids=["on", "off"])
def shipped_depth5(request):
    """run() and run_fused() of the shipped model to depth 5."""
    eng = _engine(request.param)
    res = eng.run(max_depth=5)
    feng = _engine(request.param)
    fres = feng.run_fused(max_depth=5)
    return SimpleNamespace(symmetry=request.param, eng=eng, res=res,
                           feng=feng, fres=fres)


def test_shipped_levels_match_jax_canon_level_bfs(shipped_depth5):
    s = shipped_depth5
    want = ON_LEVELS if s.symmetry == "auto" else OFF_LEVELS
    assert s.res.levels == want and s.res.ok
    assert s.res.distinct_states == sum(want)
    assert _jax_level_bfs(5, s.symmetry == "auto") == want


def test_shipped_run_fused_equals_run(shipped_depth5):
    s = shipped_depth5
    assert s.fres.levels == s.res.levels
    assert (s.fres.distinct_states, s.fres.states_generated) == \
        (s.res.distinct_states, s.res.states_generated)
    assert s.fres.metrics["gauges"]["action_expansions"] == \
        s.res.metrics["gauges"]["action_expansions"]
    assert all(np.array_equal(a, b) for a, b in
               zip(_pointers(s.feng), _pointers(s.eng)))


def test_shipped_gauges_and_hash_path(shipped_depth5):
    s = shipped_depth5
    on = s.symmetry == "auto"
    for eng, res in ((s.eng, s.res), (s.feng, s.fres)):
        g = res.metrics["gauges"]
        assert g["symmetry_perms"] == (2 if on else 1)
        assert g["orbit_ratio"] == round(
            res.states_generated / res.distinct_states, 4)
        assert g["orbit_ratio"] > 1
        # the least image's hash is taken in full
        assert eng._incremental is not on
        assert (eng._canon is not None) is on


def test_defect_cfg_keeps_symmetry_off():
    eng = DeviceBFS(load_binding(DEFECT, "VSR"), device="cpu")
    assert eng._canon is None and eng._incremental


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_shipped_bag_growth_keeps_levels(entry):
    """Starting at MAX_MSGS=4 drives R_BAG_GROW (the layout, the key
    positions of the canonicalization and, in run_fused, the captured
    tile are rebuilt); levels and counts are those of the MAX_MSGS=24
    run."""
    ref = _engine().run(max_depth=5)
    eng = _engine(max_msgs=4)
    res = getattr(eng, entry)(max_depth=5)
    assert res.metrics["counters"]["grow_message_table"] >= 1
    assert eng.codec.shape.MAX_MSGS > 4
    assert eng._canon.pos.shape[0] > 0
    assert res.levels == ref.levels == ON_LEVELS
    assert (res.distinct_states, res.states_generated) == \
        (ref.distinct_states, ref.states_generated)


if __name__ == "__main__":
    n = int(sys.argv[1])
    print(json.dumps({"on": _jax_level_bfs(n, True, batch=256),
                      "off": _jax_level_bfs(n - 1, False, batch=256)}))
