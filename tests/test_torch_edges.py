"""The port's streamed behaviour graph (``PagedBFS(edges=True)``: K11's
gid column and K12's edge emission, plain versions on the CPU) and its
``DeviceGraph`` in both modes: the Ticker stub's CSR against the JAX
package's and the port's own two-pass oracle, forced edge flushes and
FPSet growth, and the VSR defect config's edges against a host BFS over
the JAX ``VSRKernel``, labelled by fingerprint so that gid order does
not enter.  Integer results: tolerance 0.

Run as a script, ``python tests/test_torch_edges.py record 7`` prints
the count and digest of the defect config's fingerprint-labelled edge
multiset from the JAX-kernel host BFS expanding levels 0-6 (the record
``chip_smoke.py`` holds the card's edge run to)."""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from tpuvsr.frontend.cfg import parse_cfg_file as j_cfg  # noqa: E402
from tpuvsr.models.vsr import VSRCodec as JCodec  # noqa: E402
from tpuvsr.models.vsr_kernel import VSRKernel as JKernel  # noqa: E402
from tpuvsr.testing import canon_csr as j_canon_csr  # noqa: E402
from tpuvsr.testing import stub_graph_engine as j_graph_engine  # noqa: E402
from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401
from tpuvsr_torch.core.values import TLAError  # noqa: E402
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.device_liveness import (  # noqa: E402
    DeviceGraph, two_pass_prefix)
from tpuvsr_torch.engine.edges import (EdgeBuffers,  # noqa: E402
                                       emit_edges)
from tpuvsr_torch.engine.paged_bfs import PagedBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.testing import (canon_csr, stub_graph_engine,  # noqa: E402
                                  stub_sym_factory, stub_ticker_factory,
                                  sympair_binding, ticker_binding)

DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
DEFECT_LEVELS = [1, 5, 18, 62, 226, 833]


# ----------------------------------------------------------------------
# fingerprint-labelled edge multisets
# ----------------------------------------------------------------------
def _keyed(fps):
    k = np.array(fps, np.uint32).reshape(-1, 4).copy()
    k[:, 0] = np.where(k[:, 0] == 0, 1, k[:, 0])
    return k


def triple_rows(src_fp, aid, dst_fp):
    """[m, 9] uint32 rows (src fp keyed, action, dst fp keyed), sorted:
    the canonical form of an edge multiset labelled by fingerprint."""
    rows = np.concatenate([_keyed(src_fp),
                           np.asarray(aid, np.uint32).reshape(-1, 1),
                           _keyed(dst_fp)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def triple_digest(rows):
    return hashlib.sha256(np.ascontiguousarray(
        rows, np.uint32).tobytes()).hexdigest()[:16]


def jax_edge_bfs(depth, batch=64):
    """Host-driven BFS with the JAX VSRKernel from the dense Init
    (``_jax_level_bfs`` of tests/test_torch_device_bfs.py), recording
    (source fp, action, destination fp) for every enabled lane of every
    state of levels 0..depth-1.  Returns (levels, sorted triple rows)."""
    cfg = j_cfg(DEFECT)
    codec = JCodec(cfg.constants)
    kern = JKernel(codec)
    init = codec.zero_state()
    init["view"][:] = 1
    init["ct"][:, :, 2] = 1
    fp_all = jax.jit(lambda s: jax.vmap(kern.fingerprint)(s))
    fp0 = np.asarray(fp_all({k: v[None] for k, v in init.items()}))[0]
    seen = {tuple(fp0)}
    frontier, front_fp = [init], [fp0]
    levels = [1]
    src, act, dst = [], [], []
    lane_action = np.asarray(kern.lane_action)
    for _ in range(depth):
        nxt, nxt_fp = [], []
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
                row, lane = divmod(int(i), kern.n_lanes)
                src.append(front_fp[off + row])
                act.append(lane_action[lane])
                dst.append(fps[i])
                key = tuple(fps[i])
                if key not in seen:
                    seen.add(key)
                    nxt.append({k: v[i] for k, v in flat.items()})
                    nxt_fp.append(fps[i])
        levels.append(len(nxt))
        frontier, front_fp = nxt, nxt_fp
    return levels, triple_rows(np.array(src), np.array(act), np.array(dst))


def gid_fingerprints(table, n):
    """[n, 4] keyed fingerprint of every gid, from the gid column."""
    s = table["slots"].cpu().numpy().view(np.uint32)
    g = table["gids"].cpu().numpy()
    occ = (s[:, 0] != 0) & (g >= 0)
    out = np.zeros((n, 4), np.uint32)
    out[g[occ]] = s[occ, :4]
    assert occ.sum() == n and len(np.unique(g[occ])) == n
    return out


def _labelled(eng, res, csr):
    fp = gid_fingerprints(eng.table, res.distinct_states)
    s, a, d = csr_triples(csr)
    return triple_rows(fp[s], a, fp[d])


def csr_triples(csr):
    indptr, aid, tid = csr
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return src, np.asarray(aid), np.asarray(tid)


# ----------------------------------------------------------------------
# the VSR defect config
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_edges_depth4():
    return jax_edge_bfs(4)


def _defect_edges(**kw):
    args = dict(tile_size=32, chunk_tiles=4, fpset_capacity=1 << 14,
                next_capacity=1 << 10, device="cpu", edges=True)
    args.update(kw)
    eng = PagedBFS(load_binding(DEFECT, "VSR"), **args)
    res = eng.run(max_depth=4)
    assert res.ok and res.levels == DEFECT_LEVELS[:5]
    return eng, res, eng.edge_sink.finalize(res.distinct_states)


@pytest.fixture(scope="module")
def defect_edges():
    return _defect_edges()


def test_defect_edges_match_jax_kernel_bfs(defect_edges, jax_edges_depth4):
    """Every enabled lane of levels 0-3 is one edge, with the JAX
    kernel's successor: the fingerprint-labelled multisets are equal."""
    levels, want = jax_edges_depth4
    eng, res, csr = defect_edges
    assert levels == res.levels
    s, a, d = csr_triples(csr)
    assert (d >= 0).all() and (d < res.distinct_states).all()
    got = _labelled(eng, res, csr)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert res.metrics["gauges"]["edge_rows"] == len(a)
    assert s.max() < sum(DEFECT_LEVELS[:4])


def test_defect_edges_through_drains_and_flushes(defect_edges, tmp_path):
    """The next buffer at its floor (drains mid-chunk, re-entered
    tiles), the edge buffers at theirs (R_EDGE_FLUSH), drained edges
    past 64 rows in the host CSR's disk tier, and expansion caps that
    start small (R_EXPAND_GROW pauses that commit a prefix of the tile):
    those pauses keep commit order, so the CSR is the one of the run
    without them, edge for edge."""
    eng0, res0, csr0 = defect_edges
    d = str(tmp_path / "edges")
    eng, res, csr = _defect_edges(next_capacity=1, edge_capacity=1,
                                  edge_spill_dir=d, edge_ram_rows=64)
    assert len(os.listdir(os.path.join(d, "edges"))) > 1
    c = res.metrics["counters"]
    assert c["spill_count"] > 0 and c["edge_flushes"] > 0
    assert c["grow_expand_buffer"] > 0
    for x, y in zip(csr, csr0):
        assert np.array_equal(x, y)


def test_defect_edges_through_fpset_growth(defect_edges):
    """A 256-slot FPSet grown mid-run (the gid column rebuilt): a probe
    overflow commits the lanes that resolved before the pause, so gid
    order may change (as in the JAX engine), but the fingerprint-
    labelled edge multiset is the same."""
    eng0, res0, csr0 = defect_edges
    eng, res, csr = _defect_edges(fpset_capacity=1 << 8)
    assert res.metrics["counters"]["grow_fpset"] > 0
    assert np.array_equal(_labelled(eng, res, csr),
                          _labelled(eng0, res0, csr0))


def test_pointer_table_edges_are_edges(defect_edges):
    """For every gid >= n0, (parent, action, gid) of the trace pointer
    table is an edge of the graph."""
    eng, res, csr = defect_edges
    s, a, d = csr_triples(csr)
    par = np.concatenate(eng._h_parent)
    act = np.concatenate(eng._h_action)
    n0 = res.levels[0]
    key = lambda p, q, r: (np.asarray(p, np.int64) << 32) \
        | (np.asarray(q, np.int64) << 24) | np.asarray(r, np.int64)
    have = key(s, a, d)
    g = np.arange(n0, res.distinct_states)
    assert np.isin(key(par[n0:], act[n0:], g), have).all()


def test_out_degree_is_enabled_lanes(defect_edges):
    """Each expanded state's out-degree is its count of enabled lanes in
    the guard matrix; the last level has none."""
    eng, res, csr = defect_edges
    indptr = csr[0]
    deg = np.diff(indptr)
    n_exp = sum(DEFECT_LEVELS[:4])
    eng2 = PagedBFS(load_binding(DEFECT, "VSR"), tile_size=32,
                    chunk_tiles=4, fpset_capacity=1 << 14,
                    retain_levels=True, device="cpu")
    eng2.run(max_depth=4)
    want = []
    for blk in eng2.level_blocks:
        flat = eng2._pk.flatten({k: torch.as_tensor(v)
                                 for k, v in blk.items()}).contiguous()
        en, _any = eng2._guards(flat)
        want.append(en.sum(dim=1).numpy())
    assert np.array_equal(deg[:n_exp], np.concatenate(want))
    assert (deg[n_exp:] == 0).all()


def test_defect_two_pass_prefix_is_the_streamed_graph():
    """The two-pass graph of a run cut at depth 4 (fingerprint index
    over levels 0-3 by insert_gids, edge pass over levels 0-2 with
    lookup_gids) equals the streamed edges out of levels 0-2, gid for
    gid, up to the order within a source; later states have no edges."""
    eng, res, csr = _defect_edges(retain_levels=True)
    n = sum(DEFECT_LEVELS[:3])
    two = two_pass_prefix(eng, 3)
    assert len(two[0]) == sum(DEFECT_LEVELS[:4]) + 1    # retained levels
    assert not np.diff(two[0])[n:].any()

    def rows(csr_):
        t = np.stack([np.asarray(x, np.int64) for x in csr_triples(csr_)],
                     axis=1)
        t = t[t[:, 0] < n]
        return t[np.lexsort(t.T[::-1])]
    got, want = rows(two), rows(csr)
    assert got.shape[0] > 0 and np.array_equal(got, want)


# ----------------------------------------------------------------------
# the Ticker stub: streamed == JAX streamed == two-pass
# ----------------------------------------------------------------------
@pytest.mark.parametrize("modulus,stop,tile,chunk", [
    (3, True, 4, 64), (6, True, 4, 2), (6, True, 2, 1), (8, True, 1, 1),
    (5, False, 4, 2)])
def test_ticker_csr_matches_jax_and_two_pass(modulus, stop, tile, chunk):
    kw = dict(tile_size=tile, chunk_tiles=chunk, next_capacity=32)
    je = j_graph_engine(modulus=modulus, stop=stop, **kw)
    jr = je.run()
    want = [sorted((int(a), int(t)) for a, t in seg)
            for seg in j_canon_csr(je.edge_sink.finalize(jr.distinct_states))]
    pe = stub_graph_engine(modulus=modulus, stop=stop, device="cpu", **kw)
    pr = pe.run()
    assert (pr.distinct_states, pr.levels) == (jr.distinct_states,
                                               jr.levels)
    got = canon_csr(pe.edge_sink.finalize(pr.distinct_states))
    assert got == want
    gt = DeviceGraph(ticker_binding(modulus=modulus, stop=stop),
                     mode="two-pass", device="cpu",
                     model_factory=stub_ticker_factory(modulus, stop), **kw)
    assert gt.mode == "two-pass" and canon_csr(gt) == want
    assert pr.distinct_states == (2 if stop else 1) * modulus


def test_ticker_edge_flush_and_fpset_growth_keep_the_csr():
    """edge_capacity 16 with one 2-wide tile a chunk (the edge buffers
    drained after every chunk; a Ticker level holds at most two states,
    too few to fill them, so the R_EDGE_FLUSH pause itself is forced on
    the defect config above) and a 4-slot FPSet grown mid-run (the gid
    column rebuilt): the CSR is unchanged, and so is the streamed
    DeviceGraph's."""
    base = stub_graph_engine(modulus=8, tile_size=2, chunk_tiles=1,
                             device="cpu")
    rb = base.run()
    want = base.edge_sink.finalize(rb.distinct_states)
    eng = stub_graph_engine(modulus=8, tile_size=2, chunk_tiles=1,
                            edge_capacity=16, fpset_capacity=4,
                            device="cpu")
    res = eng.run()
    c = res.metrics["counters"]
    assert c["edge_drains"] > 8 and c["grow_fpset"] > 0
    assert res.metrics["gauges"]["edge_buf_high_water"] <= 16
    got = eng.edge_sink.finalize(res.distinct_states)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    gs = DeviceGraph(ticker_binding(modulus=8), mode="stream",
                     tile_size=2, chunk_tiles=1, edge_capacity=16,
                     fpset_capacity=4, device="cpu",
                     model_factory=stub_ticker_factory(8))
    assert canon_csr(gs) == canon_csr(want)


def test_device_graph_states_and_engine_handover():
    """The graph decodes its states lazily from the retained levels, in
    gid order, and a finished edge run hands its CSR over."""
    eng = stub_graph_engine(modulus=6, device="cpu")
    res = eng.run()
    g = DeviceGraph(ticker_binding(modulus=6), engine=eng, result=res)
    assert g.mode == "stream" and g.n == 12 and g.inits == [0]
    assert g.states[0] == {"x": 0, "stopped": False}
    assert sorted((s["x"], s["stopped"]) for s in
                  (g.states[i] for i in range(g.n))) == \
        sorted((x, s) for x in range(6) for s in (False, True))
    names = g.edges[0]
    assert sorted(names) == [("Stop", 2), ("Tick", 1)]
    with pytest.raises(TLAError, match="fixpoint"):
        DeviceGraph(ticker_binding(modulus=6), max_states=3, device="cpu",
                    model_factory=stub_ticker_factory(6))


def test_edges_refused_under_symmetry_and_off_the_paged_loop():
    with pytest.raises(TLAError, match="symmetry off"):
        PagedBFS(sympair_binding(), model_factory=stub_sym_factory(),
                 tile_size=4, retain_levels=True, edges=True, device="cpu")
    with pytest.raises(TLAError, match="PagedBFS"):
        DeviceBFS(ticker_binding(), model_factory=stub_ticker_factory(),
                  edges=True, device="cpu")
    with pytest.raises(TLAError, match="run_fused"):
        stub_graph_engine(device="cpu").run_fused()
    with pytest.raises(TLAError, match="SYMMETRY off"):
        DeviceGraph(sympair_binding(), device="cpu",
                    model_factory=stub_sym_factory())


@pytest.mark.parametrize("seed", range(4))
def test_emit_edges_plain_is_the_jax_edge_block(seed):
    """K12's plain version against a numpy transcription of the JAX
    block (device_bfs.py:1036-1047): edst = where(emit, edge_n +
    cumsum(emit) - 1, E_cap), scattered with mode="drop"."""
    rng = np.random.default_rng(seed)
    n, cap = int(rng.integers(1, 300)), int(rng.integers(50, 400))
    en = rng.random(n) < 0.6
    pidx = rng.integers(0, 128, n).astype(np.int32)
    aid = rng.integers(0, 19, n).astype(np.int32)
    dst = rng.integers(0, 10**6, n).astype(np.int32)
    for commit in (True, False):
        eb = EdgeBuffers(cap, "cpu")
        eb.n = int(rng.integers(0, 40))
        init = [t.numpy().copy() for t in (eb.src, eb.aid, eb.dst)]
        k = emit_edges(eb, torch.from_numpy(en), torch.from_numpy(pidx),
                       torch.from_numpy(aid), torch.from_numpy(dst),
                       torch.tensor(commit), 1000 + seed)
        emit = en & commit
        edst = np.where(emit, eb.n + np.cumsum(emit) - 1, cap)
        keep = edst < cap
        want = [x.copy() for x in init]
        want[0][edst[keep]] = 1000 + seed + pidx[keep]
        want[1][edst[keep]] = aid[keep]
        want[2][edst[keep]] = dst[keep]
        assert int(k) == int(emit.sum())
        for w, t in zip(want, (eb.src, eb.aid, eb.dst)):
            assert np.array_equal(w, t.numpy())


if __name__ == "__main__":
    if sys.argv[1:2] == ["record"]:
        d = int(sys.argv[2]) if len(sys.argv) > 2 else 7
        lv, rows = jax_edge_bfs(d)
        print({"depth": d, "levels": lv, "edges": int(rows.shape[0]),
               "digest": triple_digest(rows)})
