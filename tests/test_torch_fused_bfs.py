"""The port's fused BFS (``DeviceBFS.run_fused``) on the CPU: against the
JAX package's ``run_fused`` on the counter stub (fixpoint, violation,
deadlock, growth pauses mid-level, depth and state limits, one level a
host read), and against the port's own chunked ``run()`` on the VSR
defect config (levels, counts and trace-pointer tables, also across a
message-table growth).  Integer results: tolerance 0."""

import os

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_device_bfs import _jax_stub, _port_stub, _same
from tpuvsr_torch.engine import tile as TL
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.testing import STUB_DISTINCT, STUB_LEVELS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")


def _pointers(eng):
    return [np.concatenate(getattr(eng, k))
            for k in ("_h_parent", "_h_action", "_h_param")]


def _same_fused(jr, pr, je, pe):
    _same(jr, pr, je, pe)
    assert pr.diameter == jr.diameter
    for a, b in zip(_pointers(pe), _pointers(je)):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("case, run_kw", [
    (dict(), dict()),                                   # fixpoint
    (dict(inv_bound=4), dict()),                        # violation
    (dict(), dict(check_deadlock=True)),                # deadlock
    (dict(), dict(max_depth=0)),
    (dict(), dict(max_depth=2)),
    (dict(), dict(max_states=5)),
    (dict(), dict(levels_per_dispatch=1)),
    (dict(tile_size=1, fpset_capacity=4, next_capacity=4), dict()),
    (dict(tile_size=2, next_capacity=4), dict()),
], ids=["fixpoint", "violation", "deadlock", "depth0", "depth2",
        "max_states", "one_level_a_read", "fpset_and_next_grow",
        "next_grow"])
def test_stub_run_fused_matches_jax(case, run_kw):
    je, pe = _jax_stub(**case), _port_stub(**case)
    jr, pr = je.run_fused(**run_kw), pe.run_fused(**run_kw)
    _same_fused(jr, pr, je, pe)


def test_stub_run_fused_growth_pauses_happen():
    """Tiny caps pause the fused pass mid-level for the FPSet and the
    next buffer, and it re-enters to the same fixpoint."""
    pe = _port_stub(tile_size=1, fpset_capacity=4, next_capacity=4)
    r = pe.run_fused()
    c = r.metrics["counters"]
    assert c["grow_fpset"] >= 1 and c["grow_next_buffer"] >= 1
    assert c["growth_pauses"] == c["grow_fpset"] + c["grow_next_buffer"]
    assert (r.distinct_states, pe.level_sizes) == (STUB_DISTINCT,
                                                   STUB_LEVELS)


def test_stub_run_fused_expand_growth_matches_jax():
    """Caps forced below the per-tile need (Limit 10, a 16-wide tile)
    pause both fused passes for R_EXPAND_GROW."""
    je = _jax_stub(limit=10, tile_size=16)
    je.expand_caps = [8, 8]
    je._ml = None
    pe = _port_stub(limit=10, tile_size=16)
    pe.expand_caps = [8, 8]
    jr, pr = je.run_fused(), pe.run_fused()
    _same_fused(jr, pr, je, pe)
    assert pr.metrics["counters"]["grow_expand_buffer"] > 0
    assert pe.expand_caps == je.expand_caps


def test_stub_run_fused_reads_once_a_quantum():
    """One host read per quantum of tile replays: 4 replays, then 16;
    the level-per-read run reads once a level and replays no tile
    after a stop."""
    r = _port_stub().run_fused()
    c = r.metrics["counters"]
    assert c["host_reads"] == c["quanta"] == 2
    assert c["graph_replays"] == 4 + 16
    assert c["tiles"] == len(STUB_LEVELS)
    assert c["replays_after_stop"] == c["graph_replays"] - c["tiles"]
    r = _port_stub().run_fused(levels_per_dispatch=1)
    c = r.metrics["counters"]
    assert c["host_reads"] == c["graph_replays"] == len(STUB_LEVELS)
    assert c["replays_after_stop"] == 0


def test_carry_and_tile_layouts_match_the_kernel_source():
    src = open(os.path.join(ROOT, "tpuvsr_torch", "csrc",
                            "tile_commit.cu")).read()

    def enum(name):
        body = src[src.index(f"enum {name} {{"):]
        items = body[body.index("{") + 1:body.index("}")].replace(
            "\n", " ").split(",")
        return [i.split("=")[0].strip() for i in items if i.strip()]
    assert enum("Carry") == ["C_" + f.upper() for f in TL.CARRY_FIELDS] \
        + ["C_NEED"]
    assert enum("Tile") == ["F_" + f.upper() for f in TL.TILE_FIELDS] \
        + ["F_AFLAGS"]
    reasons = dict(zip(enum("Reason"), (
        TL.RUNNING, TL.R_VIOLATION, TL.R_BAG_GROW, TL.R_FPSET_GROW,
        TL.R_NEXT_GROW, TL.R_SLOT_ERR, TL.R_DEADLOCK, TL.R_EXPAND_GROW)))
    for name, val in reasons.items():
        assert f"{name} = {val}" in src


# ----------------------------------------------------------------------
# the VSR defect config: run_fused against run()
# ----------------------------------------------------------------------
_KW = dict(chunk_tiles=4, fpset_capacity=1 << 14, next_capacity=1 << 10,
           device="cpu")
_RUNS = {}


def _run_at(tile):
    """The port's run() to depth 4 at one tile width (cached)."""
    if tile not in _RUNS:
        eng = DeviceBFS(load_binding(DEFECT, "VSR"), tile_size=tile, **_KW)
        _RUNS[tile] = (eng, eng.run(max_depth=4))
    return _RUNS[tile]


def _same_as_run(ref_eng, ref, eng, res):
    assert eng.level_sizes == ref_eng.level_sizes == [1, 5, 18, 62, 226]
    assert (res.ok, res.distinct_states, res.states_generated,
            res.diameter, res.error) == \
        (ref.ok, ref.distinct_states, ref.states_generated, ref.diameter,
         ref.error)
    assert res.metrics["gauges"]["action_expansions"] == \
        ref.metrics["gauges"]["action_expansions"]
    for a, b in zip(_pointers(eng), _pointers(ref_eng)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("tile, fits", [(32, 0), (8, 1)])
def test_defect_run_fused_equals_run(tile, fits):
    """Tile 8 makes the 62-state frontier large enough (four tiles) to be
    fitted before it runs; tile 32 runs every level unfitted."""
    ref_eng, ref = _run_at(tile)
    eng = DeviceBFS(load_binding(DEFECT, "VSR"), tile_size=tile, **_KW)
    res = eng.run_fused(max_depth=4)
    _same_as_run(ref_eng, ref, eng, res)
    c = res.metrics["counters"]
    assert c.get("level_fits", 0) == fits
    assert c["host_reads"] == c["quanta"] + c.get("level_fits", 0)


def test_defect_run_fused_bag_growth_keeps_levels():
    """MAX_MSGS 4 pauses the fused pass for R_BAG_GROW mid-level (the
    packed buffers are laid out again); levels, counts and pointer
    tables are those of run() at MAX_MSGS 32."""
    ref_eng, ref = _run_at(32)
    eng = DeviceBFS(load_binding(DEFECT, "VSR"), max_msgs=4, tile_size=32, **_KW)
    res = eng.run_fused(max_depth=4)
    assert res.metrics["counters"]["grow_message_table"] >= 1
    assert eng.codec.shape.MAX_MSGS > 4
    _same_as_run(ref_eng, ref, eng, res)


def test_captured_graph_keeps_its_tensors_alive(monkeypatch):
    """A CUDA graph holds the addresses of the tensors its function
    touched (the fused tile's queue, K10's outputs, ...): the replay
    function ``kernels.capture`` returns must keep them alive, or their
    memory goes to the next allocation while replays still write it.
    Rehearsed on the CPU with a stand-in for the graph."""
    import gc
    import weakref

    import torch

    from tpuvsr_torch import kernels

    class Graph:
        def replay(self):
            pass

    class Capturing:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capturing)
    def tile_function():
        buf = torch.zeros(4)
        return weakref.ref(buf), lambda: buf.add_(1)

    alive, fn = tile_function()
    replay = kernels.capture(fn)
    del fn
    gc.collect()
    assert alive() is not None and alive().tolist() == [1.0] * 4
    replay()
    del replay
    gc.collect()
    assert alive() is None
