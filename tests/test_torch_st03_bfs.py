"""The port's breadth-first search on VR_STATE_TRANSFER (ST03) against
the JAX package's ST03Kernel, on the CPU: ``DeviceBFS.run()`` and
``run_fused()`` with ``device="cpu"`` (the plain versions of K13, K14
and K3 on every call) give the levels of a host-driven level BFS over
the JAX kernel from the same Init, on both cfgs of
``tpuvsr_torch/configs`` (the small one to depth 8, the shipped one to
depth 5), and a run that grows its message table gives the same levels.
The fixpoint itself (scripts/fixpoints.json's 42,753 states) is checked
on the card (chip_smoke.py phase 10).  Integer results: tolerance 0."""

import functools
import os
import sys

import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tests.test_torch_st03 import (  # noqa: E402
    MODULE, PAD, SHIPPED, SMALL, _batch, _fps, _jax, _run)
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402

# the JAX-kernel host BFS's levels (below); the small cfg's are the
# first levels of the fixpoint run scripts/fixpoints.json records
SMALL_LEVELS = [1, 3, 8, 24, 68, 163, 332, 595, 968]
SHIPPED_LEVELS = [1, 4, 17, 63, 238, 851]


@functools.lru_cache(maxsize=None)
def _jax_level_bfs(name, depth):
    return level_bfs(_jax(name), depth)


def level_bfs(J, depth, on_level=None):
    """Host-driven level BFS with a JAX kernel of the family (``J``, a
    ``jax_fns_of`` namespace) from init_dense, the frontier stepped PAD
    states at a time; no enabled successor may set an error flag.
    ``on_level(new states, enabled successors)``, when given, sees each
    level."""
    init = J.jk.codec.zero_state()
    init["view"][:] = 1
    seen = {_fps(J, {k: v[None] for k, v in init.items()})[0].tobytes()}
    frontier, levels = [init], [1]
    for _ in range(depth):
        nxt, n_en = [], 0
        for lo in range(0, len(frontier), PAD):
            clean, en = _run(J.step, _batch(frontier[lo:lo + PAD]))[:2]
            en = en.reshape(-1)
            n_en += int(en.sum())
            if not en.any():
                continue
            flat = {k: v.reshape((-1,) + v.shape[2:])[en]
                    for k, v in clean.items()}
            assert not flat["err"].any()
            fps = _fps(J, flat)
            for i in range(len(fps)):
                key = fps[i].tobytes()
                if key not in seen:
                    seen.add(key)
                    nxt.append({k: v[i] for k, v in flat.items()})
        if on_level is not None:
            on_level(nxt, n_en)
        levels.append(len(nxt))
        frontier = nxt
    return levels


def _engine(path, **kw):
    return DeviceBFS(load_binding(path, MODULE), tile_size=64, chunk_tiles=8,
                     fpset_capacity=1 << 14, next_capacity=1 << 10,
                     device="cpu", **kw)


CFGS = {"small": (SMALL, 8, SMALL_LEVELS),
        "shipped": (SHIPPED, 5, SHIPPED_LEVELS)}


@pytest.mark.parametrize("name", list(CFGS))
def test_jax_level_bfs_record(name):
    _path, depth, levels = CFGS[name]
    assert _jax_level_bfs(name, depth) == levels


@pytest.mark.parametrize("entry", ["run", "run_fused"])
@pytest.mark.parametrize("name", list(CFGS))
def test_bfs_levels_match_jax(name, entry):
    path, depth, levels = CFGS[name]
    eng = _engine(path)
    res = getattr(eng, entry)(max_depth=depth)
    assert res.ok and res.levels == _jax_level_bfs(name, depth)
    assert res.distinct_states == sum(levels)
    assert res.error == f"depth limit {depth} reached"


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_bag_growth_keeps_levels(entry):
    """From MAX_MSGS 4 the small cfg grows its bag (re-layout of the
    packed buffers and a rebuilt kernel with its K13/K14/K3 tables); the
    levels are the record's."""
    eng = _engine(SMALL, max_msgs=4)
    res = getattr(eng, entry)(max_depth=6)
    assert res.metrics["counters"]["grow_message_table"] >= 1
    assert eng.codec.shape.MAX_MSGS > 4
    assert eng.kern.M == eng.codec.shape.MAX_MSGS
    assert res.levels == SMALL_LEVELS[:7]


def test_entry_points_refuse_a_cpu_not_asked_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBFS(load_binding(SMALL, MODULE))


if __name__ == "__main__":
    # python tests/test_torch_st03_bfs.py {small|shipped} DEPTH prints the
    # JAX-kernel host BFS's levels (the records chip_smoke.py holds the
    # card's runs against)
    import time
    t0 = time.time()
    print(_jax_level_bfs(sys.argv[1], int(sys.argv[2])),
          f"{time.time() - t0:.1f}s", flush=True)

