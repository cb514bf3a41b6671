"""The port's host-paged BFS (``PagedBFS``) on the CPU: against the
port's own resident ``run()`` on the VSR defect config (drains of a full
next buffer mid-chunk, the disk tier, message-table growth), against the
JAX package's ``PagedBFS`` on the counter stub, and through SymPair's
symmetry seam.  Integer results: tolerance 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuvsr.engine.paged_bfs import PagedBFS as JPagedBFS
from tpuvsr.testing import counter_spec
from tpuvsr.testing import stub_device_engine as j_stub_engine
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.core.values import TLAError
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.fpset import query_core
from tpuvsr_torch.engine.paged_bfs import PagedBFS
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.testing import (STUB_DISTINCT, STUB_LEVELS,
                                  SYMPAIR_ORBIT_LEVELS, SYMPAIR_ORBITS,
                                  counter_binding, stub_model_factory,
                                  stub_sym_factory, sympair_binding)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
DEFECT_LEVELS = [1, 5, 18, 62, 226, 833]
PTRS = ("_h_parent", "_h_action", "_h_param")


def _pointers(eng):
    return [np.concatenate(getattr(eng, k)) for k in PTRS]


def _defect(cls, **kw):
    args = dict(tile_size=32, chunk_tiles=4, fpset_capacity=1 << 14,
                next_capacity=1 << 10, device="cpu")
    args.update(kw)
    return cls(load_binding(DEFECT, "VSR"), **args)


@pytest.fixture(scope="module")
def resident_depth5():
    eng = _defect(DeviceBFS)
    res = eng.run(max_depth=5)
    assert res.levels == DEFECT_LEVELS
    return eng, res


def _same_as_resident(eng, res, resident_depth5):
    ref_eng, ref = resident_depth5
    assert res.ok and res.error == "depth limit 5 reached"
    assert res.levels == ref.levels == DEFECT_LEVELS
    assert (res.distinct_states, res.states_generated) == \
        (ref.distinct_states, ref.states_generated)
    assert res.metrics["gauges"]["action_expansions"] == \
        ref.metrics["gauges"]["action_expansions"]
    for a, b in zip(_pointers(eng), _pointers(ref_eng)):
        assert np.array_equal(a, b)


def test_paged_drains_mid_chunk_match_run(resident_depth5):
    """The next buffer at its floor (total_E + a tile): full-buffer
    drains pause tiles mid-chunk, and levels, counts and trace pointer
    tables are run()'s."""
    eng = _defect(PagedBFS, next_capacity=1)
    res = eng.run(max_depth=5)
    _same_as_resident(eng, res, resident_depth5)
    c = res.metrics["counters"]
    assert c["spill_count"] > 0 and eng.spill_count == c["spill_count"]
    assert c["spill_rows"] == res.distinct_states - 1
    assert c["drains"] > c["chunks"] - 1


def test_paged_disk_tier_matches_run(resident_depth5, tmp_path):
    """The disk tier with a RAM budget of 40 rows: level pages go to
    ``L<level>_<seq>.npz`` files (the JAX layout: one uint32 ``rows``
    array) and come back for the next level; the results are run()'s
    and the files are gone when the run ends."""
    d = str(tmp_path / "spill")
    seen = []
    from tpuvsr_torch.engine import spill as S
    flush = S.SpillTier._flush

    def spy(self):
        flush(self)
        if self._pages:
            path = self._pages[-1][0]
            with np.load(path) as z:
                seen.append((os.path.basename(path), z.files,
                             z["rows"].dtype, z["rows"].shape))
    S.SpillTier._flush = spy
    try:
        eng = _defect(PagedBFS, next_capacity=1, spill_dir=d,
                      spill_ram_rows=40)
        res = eng.run(max_depth=5)
    finally:
        S.SpillTier._flush = flush
    _same_as_resident(eng, res, resident_depth5)
    assert res.metrics["counters"]["spill_tier_flushes"] == len(seen) > 3
    assert res.metrics["gauges"]["spill_tier_bytes"] > 0
    name, files, dtype, shape = seen[0]
    assert name.startswith("L0000") and files == ["rows"]
    assert dtype == np.uint32 and shape[1] == eng._pk.words
    assert os.listdir(d) == []


def test_paged_message_table_growth_keeps_run(resident_depth5):
    """Starting at MAX_MSGS 4 drives R_BAG_GROW mid-level: host pages,
    drained rows and the chunk are re-packed in the grown layout."""
    eng = _defect(PagedBFS, max_msgs=4, next_capacity=1)
    res = eng.run(max_depth=5)
    assert res.metrics["counters"]["grow_message_table"] >= 1
    assert eng.codec.shape.MAX_MSGS > 4
    _same_as_resident(eng, res, resident_depth5)


def test_retain_levels_keeps_dense_levels():
    """``retain_levels`` keeps each expanded level as dense planes in
    gid order: re-packed, they fingerprint to the states the run
    inserted, level by level."""
    eng = _defect(PagedBFS, retain_levels=True)
    res = eng.run(max_depth=3)
    assert [b["status"].shape[0] for b in eng.level_blocks] == \
        DEFECT_LEVELS[:3]
    pk = eng._pk
    for blk in eng.level_blocks:
        flat = pk.flatten({k: torch.as_tensor(v) for k, v in blk.items()})
        fresh, _o = query_core(eng.table,
                               eng.kern.fingerprint(flat.contiguous()),
                               torch.ones(flat.shape[0], dtype=torch.bool))
        assert not fresh.any()
    assert res.levels == DEFECT_LEVELS[:4]
    with pytest.raises(TLAError, match="disk spill tier"):
        _defect(PagedBFS, retain_levels=True, spill_dir="x")


# ----------------------------------------------------------------------
# the counter stub against the JAX package's PagedBFS
# ----------------------------------------------------------------------
def _p_paged(inv_bound=None, **kw):
    args = dict(tile_size=4, fpset_capacity=1 << 8, next_capacity=1 << 6,
                device="cpu")
    args.update(kw)
    return PagedBFS(counter_binding(),
                    model_factory=stub_model_factory(inv_bound=inv_bound),
                    **args)


def _trace(res):
    return [(t.position, t.action_name, t.state) for t in res.trace]


@pytest.mark.parametrize("case", [
    {},
    dict(tile_size=2, next_capacity=1),          # drains mid-chunk
    dict(fpset_capacity=4),                      # R_FPSET_GROW
    dict(tile_size=1, chunk_tiles=1),
])
def test_stub_matches_jax_paged(case):
    je = j_stub_engine(cls=JPagedBFS, pipeline=1, **case)
    pe = _p_paged(**case)
    jr, pr = je.run(), pe.run()
    assert pr.distinct_states == STUB_DISTINCT and pe.level_sizes == \
        STUB_LEVELS
    assert (pr.ok, pr.distinct_states, pr.states_generated, pr.error) == \
        (jr.ok, jr.distinct_states, jr.states_generated, jr.error)
    assert pe.level_sizes == je.level_sizes
    assert pr.metrics["gauges"]["action_expansions"] == \
        jr.metrics["gauges"]["action_expansions"]
    assert pe.spill_rows == je.spill_rows
    for a, b in zip(_pointers(pe), _pointers(je)):
        assert np.array_equal(a, b)


def test_stub_violation_and_deadlock_match_jax_paged():
    je = j_stub_engine(cls=JPagedBFS, pipeline=1, inv_bound=4,
                       spec=counter_spec(4))
    pe = _p_paged(inv_bound=4)
    jr, pr = je.run(), pe.run()
    assert not pr.ok and pr.violated_invariant == jr.violated_invariant \
        == "Bound"
    assert _trace(pr) == _trace(jr)
    jr = j_stub_engine(cls=JPagedBFS, pipeline=1).run(check_deadlock=True)
    pr = _p_paged().run(check_deadlock=True)
    assert pr.error == jr.error == "deadlock"
    assert pr.deadlock_state == jr.deadlock_state == {"x": 3, "y": 3}
    assert _trace(pr) == _trace(jr)


@pytest.mark.parametrize("symmetry,distinct,levels", [
    ("auto", SYMPAIR_ORBITS, SYMPAIR_ORBIT_LEVELS),
    (False, 16, [1, 6, 9])])
def test_sympair_through_paged(symmetry, distinct, levels):
    """SymPair's inserts go through ``_fp``: 5 orbits with symmetry on,
    16 states with it off, each with a drain per tile."""
    eng = PagedBFS(sympair_binding(), model_factory=stub_sym_factory(),
                   symmetry=symmetry, tile_size=2, chunk_tiles=1,
                   fpset_capacity=1 << 8, next_capacity=1, device="cpu")
    res = eng.run()
    assert res.ok and res.distinct_states == distinct
    assert res.levels == levels


def test_paged_device_choice():
    res = PagedBFS(load_binding(DEFECT, "VSR"), tile_size=16,
                   chunk_tiles=2, fpset_capacity=1 << 12,
                   next_capacity=1 << 8, device="cpu").run(max_depth=2)
    assert res.levels == [1, 5, 18]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedBFS(load_binding(DEFECT, "VSR"))


def test_new_modules_load_no_jax():
    code = ("import sys, tpuvsr_torch.engine.paged_bfs, "
            "tpuvsr_torch.engine.device_liveness, "
            "tpuvsr_torch.engine.spill, tpuvsr_torch.engine.edges, "
            "tpuvsr_torch.testing\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tpuvsr' or "
            "m.startswith('tpuvsr.')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
