"""The port's DeviceBFS (fused commit, packed frontier) against the JAX
package's, on the CPU: the counter stub's fixpoint, traces and growth
pauses, and the VSR defect config's first levels.  Also the port's
isolation from the JAX package and its refusal to run on a CPU it was
not asked for.  Integer results: tolerance 0."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tpuvsr.engine.device_bfs import DeviceBFS as JDeviceBFS
from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg
from tpuvsr.models.vsr import VSRCodec as JCodec
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel
from tpuvsr.testing import counter_spec
from tpuvsr.testing import stub_model_factory as j_stub_factory
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.engine.device_bfs import DeviceBFS, device_bfs_check
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models.registry import make_model
from tpuvsr_torch.testing import (STUB_DISTINCT, STUB_LEVELS,
                                  stub_device_engine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")


def _jax_stub(limit=3, inv_bound=None, **kw):
    spec = counter_spec(inv_bound, limit=None if limit == 3 else limit)
    eng = JDeviceBFS(spec, model_factory=j_stub_factory(
        limit=limit, inv_bound=inv_bound), hash_mode="full",
        tile_size=kw.pop("tile_size", 4),
        fpset_capacity=kw.pop("fpset_capacity", 1 << 8),
        next_capacity=kw.pop("next_capacity", 1 << 6), pipeline=1, **kw)
    return eng


def _port_stub(**kw):
    return stub_device_engine(device="cpu", **kw)


def _trace(res):
    return [(t.position, t.action_name, t.state) for t in res.trace]


def _same(jr, pr, je, pe):
    assert (pr.ok, pr.distinct_states, pr.states_generated) == \
        (jr.ok, jr.distinct_states, jr.states_generated)
    assert pe.level_sizes == je.level_sizes
    assert pr.metrics["gauges"]["action_expansions"] == \
        jr.metrics["gauges"]["action_expansions"]
    assert pr.violated_invariant == jr.violated_invariant
    assert pr.error == jr.error
    assert _trace(pr) == _trace(jr)


def test_stub_fixpoint_matches_jax():
    je, pe = _jax_stub(), _port_stub()
    jr, pr = je.run(), pe.run()
    assert pr.distinct_states == STUB_DISTINCT
    assert pe.level_sizes == STUB_LEVELS
    _same(jr, pr, je, pe)


def test_stub_violation_trace_matches_jax():
    je, pe = _jax_stub(inv_bound=4), _port_stub(inv_bound=4)
    jr, pr = je.run(), pe.run()
    assert not pr.ok and pr.violated_invariant == "Bound"
    _same(jr, pr, je, pe)


@pytest.mark.parametrize("case", [
    dict(tile_size=2, next_capacity=4),          # R_NEXT_GROW
    dict(fpset_capacity=4),                      # R_FPSET_GROW
    dict(tile_size=1, chunk_tiles=1),
])
def test_stub_growth_pauses_match_jax(case):
    je, pe = _jax_stub(**case), _port_stub(**case)
    jr, pr = je.run(), pe.run()
    _same(jr, pr, je, pe)
    assert pr.distinct_states == STUB_DISTINCT


def test_stub_next_and_fpset_growth_happen():
    r = _port_stub(tile_size=2, next_capacity=4).run()
    assert r.metrics["counters"].get("grow_next_buffer", 0) > 0
    r = _port_stub(fpset_capacity=4).run()
    assert r.metrics["counters"].get("grow_fpset", 0) > 0


def test_stub_expand_growth_matches_jax():
    """Caps forced below the per-tile need (Limit 10: up to 11 states a
    level in one 16-wide tile) drive R_EXPAND_GROW in both engines."""
    je = _jax_stub(limit=10, tile_size=16)
    je.expand_caps = [8, 8]
    je._level = jax.jit(je._make_level(),
                        donate_argnums=(0, 4, 5, 6, 7, 10))
    pe = _port_stub(limit=10, tile_size=16)
    pe.expand_caps = [8, 8]
    jr, pr = je.run(), pe.run()
    _same(jr, pr, je, pe)
    assert pr.metrics["counters"]["grow_expand_buffer"] > 0
    assert jr.metrics["counters"]["grow_expand_buffer"] > 0
    assert pe.expand_caps == je.expand_caps


def test_stub_deadlock_matches_jax():
    je, pe = _jax_stub(), _port_stub()
    jr = je.run(check_deadlock=True)
    pr = pe.run(check_deadlock=True)
    assert pr.error == "deadlock" and pr.deadlock_state == {"x": 3, "y": 3}
    assert pr.deadlock_state == jr.deadlock_state
    _same(jr, pr, je, pe)


def _jax_level_bfs(depth, batch=64):
    """Host-driven level BFS with the JAX VSRKernel from the dense
    Init, the frontier padded to one fixed batch so JAX compiles
    once."""
    cfg = j_cfg(DEFECT)
    codec = JCodec(cfg.constants)
    kern = JKernel(codec)
    init = codec.zero_state()
    init["view"][:] = 1
    init["ct"][:, :, 2] = 1
    fp_all = jax.jit(lambda s: jax.vmap(kern.fingerprint)(s))
    seen = {tuple(np.asarray(fp_all({k: v[None] for k, v in init.items()}))[0])}
    frontier = [init]
    levels = [1]
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


@pytest.fixture(scope="module")
def port_defect_depth4():
    eng = DeviceBFS(load_binding(DEFECT, "VSR"), tile_size=32, chunk_tiles=4,
                    fpset_capacity=1 << 14, next_capacity=1 << 10,
                    device="cpu")
    return eng, eng.run(max_depth=4)


def test_defect_depth4_matches_jax_level_bfs(port_defect_depth4):
    eng, res = port_defect_depth4
    assert eng.level_sizes == [1, 5, 18, 62, 226]
    assert res.distinct_states == 312 and res.ok
    assert _jax_level_bfs(4) == eng.level_sizes


def test_defect_bag_growth_keeps_levels(port_defect_depth4):
    """Starting at MAX_MSGS=4 drives R_BAG_GROW (re-layout of the
    packed buffers, padded messages); levels and counts are those of
    the MAX_MSGS=32 run."""
    ref_eng, ref = port_defect_depth4
    eng = DeviceBFS(load_binding(DEFECT, "VSR"), max_msgs=4, tile_size=32,
                    chunk_tiles=4, fpset_capacity=1 << 14,
                    next_capacity=1 << 10, device="cpu")
    res = eng.run(max_depth=4)
    assert res.metrics["counters"]["grow_message_table"] >= 1
    assert eng.codec.shape.MAX_MSGS > 4
    assert eng.level_sizes == ref_eng.level_sizes
    assert (res.distinct_states, res.states_generated) == \
        (ref.distinct_states, ref.states_generated)
    assert res.metrics["gauges"]["action_expansions"] == \
        ref.metrics["gauges"]["action_expansions"]


def test_binding_names_its_module():
    """A cfg bound to a module the registry has no hand kernel for (here
    the CP06 example cfg under a name no spec declares) reaches the
    registry's refusal by name, not a VSR codec that lacks its
    constants; the family's models, CP06 among them, each bind to their
    own codec and kernel."""
    cfg = os.path.join(ROOT, "examples", "VR_REPLICA_RECOVERY_CP_small.cfg")
    b = load_binding(cfg, "VR_NO_SUCH_MODULE")
    assert b.module == "VR_NO_SUCH_MODULE"
    with pytest.raises(KeyError, match="no hand model kernel for module "
                       "'VR_NO_SUCH_MODULE'"):
        make_model(b)
    with pytest.raises(KeyError, match="no hand model kernel"):
        DeviceBFS(b, device="cpu")
    assert load_binding(DEFECT, "VSR").module == "VSR"
    # the family's models each bind to their own codec and kernel
    from tpuvsr_torch.models.a01 import A01Codec
    from tpuvsr_torch.models.a01_kernel import A01Kernel
    from tpuvsr_torch.models.as04 import AS04Codec
    from tpuvsr_torch.models.as04_kernel import AS04Kernel
    from tpuvsr_torch.models.cp06 import CP06Codec
    from tpuvsr_torch.models.cp06_kernel import CP06Kernel
    from tpuvsr_torch.models.i01 import I01Codec
    from tpuvsr_torch.models.i01_kernel import I01Kernel
    for module, codec_cls, kern_cls in (
            ("VR_ASSUME_NEWVIEWCHANGE", A01Codec, A01Kernel),
            ("VR_INC_RESEND", I01Codec, I01Kernel),
            ("VR_APP_STATE", AS04Codec, AS04Kernel),
            ("VR_REPLICA_RECOVERY_CP", CP06Codec, CP06Kernel)):
        fb = load_binding(os.path.join(ROOT, "tpuvsr_torch", "configs",
                                       f"{module}_small.cfg"), module)
        assert fb.module == module and not fb.symmetry_perms
        codec, kern = make_model(fb, max_msgs=8)
        assert type(codec) is codec_cls and type(kern) is kern_cls
        assert kern.pk is not None and kern.M == 8


def test_make_model_resolves_st03():
    """VR_STATE_TRANSFER binds to the port's ST03 codec and kernel, with
    the pack spec the JAX package builds for the same codec; a module
    with no hand kernel is still refused by name."""
    from tpuvsr_torch.models.st03 import ST03Codec
    from tpuvsr_torch.models.st03_kernel import ST03Kernel
    cfg = os.path.join(ROOT, "tpuvsr_torch", "configs",
                       "VR_STATE_TRANSFER_small.cfg")
    b = load_binding(cfg, "VR_STATE_TRANSFER")
    codec, kern = make_model(b, max_msgs=16)
    assert isinstance(codec, ST03Codec) and isinstance(kern, ST03Kernel)
    assert kern.pk is not None and kern.M == 16
    assert b.invariants == ["NoLogDivergence", "AcknowledgedWriteNotLost",
                            "CommitNumberNeverHigherThanOpNumber"]
    assert not b.symmetry_perms
    with pytest.raises(KeyError, match="no hand model kernel for module "
                       "'VR_NO_SUCH_MODULE'"):
        make_model(load_binding(cfg, "VR_NO_SUCH_MODULE"))


def test_device_bfs_check_entry_point_on_cpu():
    res = device_bfs_check(load_binding(DEFECT, "VSR"), max_depth=2,
                           tile_size=16, chunk_tiles=2,
                           fpset_capacity=1 << 12, next_capacity=1 << 8,
                           device="cpu")
    assert res.levels == [1, 5, 18]


# ----------------------------------------------------------------------
# isolation and device choice
# ----------------------------------------------------------------------
def test_import_loads_no_jax():
    code = ("import sys, tpuvsr_torch, tpuvsr_torch.engine.device_bfs, "
            "tpuvsr_torch.testing, tpuvsr_torch.engine.carry, "
            "tpuvsr_torch.sim.fleet, tpuvsr_torch.sim.splitting, "
            "tpuvsr_torch.sim.defect_hunt, tpuvsr_torch.sim.rng, "
            "tpuvsr_torch.models.st03_kernel, tpuvsr_torch.models.registry, "
            "tpuvsr_torch.models.a01_kernel, tpuvsr_torch.models.i01_kernel, "
            "tpuvsr_torch.models.as04_kernel, "
            "tpuvsr_torch.models.rr05_kernel, "
            "tpuvsr_torch.models.al05_kernel, "
            "tpuvsr_torch.frontend.lexer, tpuvsr_torch.frontend.parser, "
            "tpuvsr_torch.frontend.trace_parse, tpuvsr_torch.interp.evalr, "
            "tpuvsr_torch.interp.actions, tpuvsr_torch.engine.spec, "
            "tpuvsr_torch.engine.bfs, tpuvsr_torch.engine.trace, "
            "tpuvsr_torch.validate, tpuvsr_torch.validate.batch, "
            "tpuvsr_torch.validate.host, tpuvsr_torch.validate.traces, "
            "tpuvsr_torch.analysis, tpuvsr_torch.analysis.passes, "
            "tpuvsr_torch.analysis.passes.bounds, "
            "tpuvsr_torch.analysis.passes.independence, "
            "tpuvsr_torch.analysis.passes.drift, tpuvsr_torch.lower.ir, "
            "tpuvsr_torch.engine.bounds, tpuvsr_torch.engine.por, "
            "tpuvsr_torch.engine.paged_bfs, "
            "tpuvsr_torch.engine.device_liveness, "
            "tpuvsr_torch.engine.liveness\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tpuvsr' or "
            "m.startswith('tpuvsr.')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_tpuvsr_import_in_the_port():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "torch_kernel_ab.py")]
    for d, _s, names in os.walk(os.path.join(ROOT, "tpuvsr_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "tpuvsr")]
    assert not bad and len(files) > 15


def test_entry_points_refuse_a_cpu_not_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBFS(load_binding(DEFECT, "VSR"))
    with pytest.raises(RuntimeError, match="CUDA"):
        stub_device_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_bfs_check(load_binding(DEFECT, "VSR"), max_depth=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBFS(load_binding(DEFECT, "VSR")).run_fused(max_depth=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        stub_device_engine().run_fused()
    from tpuvsr_torch.sim.defect_hunt import make_fleet
    from tpuvsr_torch.testing import stub_fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        stub_fleet()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fleet(walkers=8)
