"""The port's per-action commit against the JAX package's, live, on the
VSR defect config: the JAX DeviceBFS with ``commit="per-action"`` (its
per-action body, run on the CPU through the constants-only shim of
tests/test_torch_fleet.py) and the port's ``run()`` and ``run_fused()``
with ``commit="per-action"``, at tile 128 to depth 5, give the same
levels, counts, per-action counters and trace-pointer tables.  The JAX
body compiles for about a minute, so this file holds the one live run
(tests/test_torch_per_action.py holds the port to the committed record of
the same runs at depth 6).  Integer results: tolerance 0."""

import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tests.test_torch_per_action import (  # noqa: E402
    DEFECT, DEFECT_KW, _acts, pointers)
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402

DEPTH = 5


@pytest.fixture(scope="module")
def jax_run():
    """The JAX per-action run, once for the module."""
    os.environ["TPUVSR_LINT"] = "off"       # the shim has no .tla to lint
    from tests.test_torch_fleet import jax_shim
    from tpuvsr.engine.device_bfs import DeviceBFS as JDeviceBFS
    from tpuvsr.models.registry import make_model as jm
    shim, _e, _c, _k = jax_shim()
    shim.temporal_props = ()
    eng = JDeviceBFS(shim, model_factory=lambda s, max_msgs=None: jm(
        s, max_msgs=32, fold_symmetry=False), pipeline=1, bounds=False,
        commit="per-action", expand_mult=32,
        **{k: v for k, v in DEFECT_KW.items() if k != "next_capacity"},
        next_capacity=1 << 16)
    res = eng.run(max_depth=DEPTH)
    return eng, res, pointers(eng)


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_defect_per_action_matches_jax_live(jax_run, entry):
    je, jr, jt = jax_run
    eng = DeviceBFS(load_binding(DEFECT, "VSR"), device="cpu",
                    commit="per-action", **DEFECT_KW)
    res = getattr(eng, entry)(max_depth=DEPTH)
    assert eng.level_sizes == [int(x) for x in je.level_sizes]
    assert (res.distinct_states, res.states_generated) == \
        (jr.distinct_states, jr.states_generated)
    assert list(_acts(res).values()) == [int(x) for x in je._act_counts]
    for a, b in zip(pointers(eng), jt):
        assert np.array_equal(a, b)
