"""The port's per-action commit (``DeviceBFS(commit="per-action")``:
K15's plain twin, ``engine/tile.action_gate``/``action_finish``, around
K7, K10, K3, K2, K1 and K4 an action) against the JAX package's
per-action commit on the CPU, and against the port's own fused commit.

* the counter stub, both packages at ``commit="per-action"``
  (``tpuvsr.testing.stub_device_engine``): counts, levels, per-action
  counters, trace-pointer tables, the Bound violation trace, the
  next-buffer, FPSet and expansion growth pauses (the expansion caps
  doubled as JAX doubles them), deadlock, through the port's ``run()``
  and ``run_fused()`` (against the JAX ``run()``, which its
  ``run_fused()`` equals); and the port's per-action equal to its fused
  commit there;
* the VSR defect config at tile 128 to depth 6: the port's per-action
  pointer tables are the JAX per-action record's
  (``tpuvsr_torch/configs/records/per_action_defect.json``), its fused
  ones the JAX fused record's, and the two commits agree on counts,
  levels and per-action counters.  The JAX per-action body compiles
  for about a minute and its fused body for three, which this file's
  budget has no room for: the live comparison with the JAX per-action
  run, at depth 5, is tests/test_torch_per_action_jax.py's;
* one action's batch holding equal successors (the defect config's
  level 2): the JAX insert names the last lane fresh, the fused commit's
  dedup the first, and the port does each as JAX does;
* ``PagedBFS(commit="per-action", edges=True)``: the same edges as the
  fused paged run, with levels and pointer tables of the per-action
  ``run()``;
* K15's plain twin against a direct loop over random carries.

Integer results: tolerance 0.

Run as a script, this file writes the JAX record (about three minutes
of CPU):
  python tests/test_torch_per_action.py record
"""

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from tpuvsr.testing import stub_device_engine as j_stub_engine  # noqa: E402

from tests.test_torch_threads import one_torch_thread  # noqa: E402,F401

from tpuvsr_torch.engine import tile as TL  # noqa: E402
from tpuvsr_torch.engine.device_bfs import DeviceBFS, _Bufs  # noqa: E402
from tpuvsr_torch.engine.paged_bfs import PagedBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.core.values import TLAError  # noqa: E402
from tpuvsr_torch.testing import (STUB_DISTINCT, STUB_LEVELS,  # noqa: E402
                                  canon_csr, stub_device_engine)

DEFECT = os.path.join(ROOT, "examples", "VSR_defect.cfg")
RECORD = os.path.join(ROOT, "tpuvsr_torch", "configs", "records",
                      "per_action_defect.json")
# the record's engine: chip_smoke.py's tile and chunk
DEFECT_KW = dict(tile_size=128, chunk_tiles=64, fpset_capacity=1 << 16,
                 next_capacity=1 << 14)
DEPTH = 6


def pointers(eng):
    """The trace-pointer tables (parent int64, action and lane int32)."""
    if hasattr(eng, "_flush_pointers"):
        eng._flush_pointers()
    return [np.concatenate([np.asarray(x) for x in getattr(eng, k)])
            .astype(dt) for k, dt in (("_h_parent", np.int64),
                                      ("_h_action", np.int32),
                                      ("_h_param", np.int32))]


def digest(tables):
    h = hashlib.sha256()
    for t in tables:
        h.update(np.ascontiguousarray(t).tobytes())
    return h.hexdigest()


def _trace(res):
    return [(t.position, t.action_name, t.state) for t in res.trace]


def _acts(res):
    return res.metrics["gauges"]["action_expansions"]


def _jax_acts(eng):
    return [int(x) for x in eng._act_counts]


# ----------------------------------------------------------------------
# the counter stub against the JAX per-action commit
# ----------------------------------------------------------------------
def _jax(**kw):
    kw.setdefault("pipeline", 1)
    return j_stub_engine(commit="per-action", **kw)


def _port(**kw):
    kw.pop("pipeline", None)
    kw.pop("pack", None)
    return stub_device_engine(device="cpu", commit="per-action", **kw)


def _same(je, jr, pe, pr):
    assert (pr.ok, pr.distinct_states, pr.states_generated,
            pr.violated_invariant, pr.error, pr.diameter) == \
        (jr.ok, jr.distinct_states, jr.states_generated,
         jr.violated_invariant, jr.error, jr.diameter)
    assert pe.level_sizes == list(je.level_sizes)
    assert list(_acts(pr).values()) == _jax_acts(je)
    assert _trace(pr) == _trace(jr)
    for a, b in zip(pointers(pe), pointers(je)):
        assert np.array_equal(a, b)
    g = pr.metrics["gauges"]
    assert (g["commit_mode"], g["inserts_per_tile"]) == ("per-action", 2)


STUB_CASES = {
    "fixpoint": (dict(), dict()),
    "violation": (dict(inv_bound=4), dict()),
    "deadlock": (dict(), dict(check_deadlock=True)),
    "next_grow_mid_chunk": (dict(next_capacity=8, pack=False), dict()),
    "next_grow_tile2": (dict(tile_size=2, next_capacity=4), dict()),
    "fpset_grow": (dict(fpset_capacity=4), dict()),
    "one_tile_chunks": (dict(tile_size=1, chunk_tiles=1), dict()),
    "depth2": (dict(), dict(max_depth=2)),
}


_JAX = {}


def jax_run(case, make, rkw):
    """The JAX per-action run() of a case, run once for both of the
    port's entry points (JAX's run_fused gives its run()'s results,
    tests/test_commit.py)."""
    if case not in _JAX:
        je = make()
        _JAX[case] = (je, je.run(**rkw))
    return _JAX[case]


@pytest.mark.parametrize("entry", ["run", "run_fused"])
@pytest.mark.parametrize("case", sorted(STUB_CASES))
def test_stub_per_action_matches_jax(case, entry):
    ekw, rkw = STUB_CASES[case]
    je, jr = jax_run(case, lambda: _jax(**ekw), rkw)
    pe = _port(**ekw)
    pr = getattr(pe, entry)(**rkw)
    _same(je, jr, pe, pr)
    if case == "fixpoint":
        assert pr.distinct_states == STUB_DISTINCT
        assert pe.level_sizes == STUB_LEVELS
    if case == "violation":
        assert not pr.ok and pr.violated_invariant == "Bound"
    if case == "next_grow_tile2":
        assert pr.metrics["counters"]["grow_next_buffer"] > 0
    if case == "fpset_grow":
        assert pr.metrics["counters"]["grow_fpset"] > 0


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_stub_per_action_expand_growth_matches_jax(entry):
    """A 128-wide tile over a counter of limit 70 (up to 71 states a
    level) at a tile multiple of 1/4 overflows the per-action floor of 64
    lanes: both packages double the action's multiple and re-enter the
    tile, twice."""
    from tests.test_torch_device_bfs import _jax_stub
    kw = dict(limit=70, tile_size=128, next_capacity=1 << 10)
    # entry against entry: the two JAX entry points grow the FPSet at
    # other moments (run() at level ends too), and a probe-overflow
    # pause commits an action's resolved inserts first, so their
    # pointer tables differ here, each the port's twin's
    je = _jax_stub(commit="per-action", expand_mult=0.25, **kw)
    pe = _port(**kw)
    pe.expand_mults = [0.25, 0.25]
    jr, pr = getattr(je, entry)(), getattr(pe, entry)()
    _same(je, jr, pe, pr)
    assert pr.metrics["counters"]["grow_expand_buffer"] > 0
    assert pe.expand_mults == list(je.expand_mults)


@pytest.mark.parametrize("case", ["fixpoint", "violation", "deadlock",
                                  "fpset_grow", "next_grow_tile2"])
def test_stub_per_action_equals_port_fused(case):
    """On the counter no action's batch holds equal successors, so the
    two commits agree on the pointer tables too."""
    ekw, rkw = STUB_CASES[case]
    pe, fe = _port(**ekw), stub_device_engine(device="cpu", **{
        k: v for k, v in ekw.items() if k != "pack"})
    for entry in ("run", "run_fused"):
        pr, fr = getattr(pe, entry)(**rkw), getattr(fe, entry)(**rkw)
        assert (pr.ok, pr.distinct_states, pr.states_generated,
                pr.violated_invariant, pr.error) == \
            (fr.ok, fr.distinct_states, fr.states_generated,
             fr.violated_invariant, fr.error)
        assert _acts(pr) == _acts(fr) and _trace(pr) == _trace(fr)
        for a, b in zip(pointers(pe), pointers(fe)):
            assert np.array_equal(a, b)
        assert fr.metrics["gauges"]["inserts_per_tile"] == 1


def test_commit_argument_is_checked():
    with pytest.raises(TLAError, match="commit must be"):
        stub_device_engine(device="cpu", commit="batched")


# ----------------------------------------------------------------------
# the VSR defect config
# ----------------------------------------------------------------------
_DEFECT = {}


def defect_run(commit, entry):
    key = (commit, entry)
    if key not in _DEFECT:
        eng = DeviceBFS(load_binding(DEFECT, "VSR"), device="cpu",
                        commit=commit, **DEFECT_KW)
        res = getattr(eng, entry)(max_depth=DEPTH)
        _DEFECT[key] = (eng, res, pointers(eng))
    return _DEFECT[key]


@pytest.fixture(scope="module")
def record():
    return json.load(open(RECORD))


@pytest.mark.parametrize("commit, entry", [("per-action", "run"),
                                           ("per-action", "run_fused"),
                                           ("fused", "run")])
def test_defect_matches_the_jax_record(record, commit, entry):
    eng, res, tables = defect_run(commit, entry)
    want = record[commit]
    assert eng.level_sizes == record["levels"]
    assert (res.distinct_states, res.states_generated) == \
        (want["distinct"], want["generated"])
    assert list(_acts(res).values()) == want["action_expansions"]
    assert digest(tables) == want["digest"]
    assert [t[:len(record["level2"]["parent"])].tolist()
            for t in tables] == [record["level2"][k] for k in (
                "parent", "action", "param")] or commit == "fused"


def test_defect_per_action_against_the_fused_commit(record):
    """Counts, levels and per-action counters agree; the pointer tables
    differ where an action's batch holds equal successors, by as many
    rows as the JAX package's two commits differ."""
    pe, pr, pt = defect_run("per-action", "run")
    fe, fr, ft = defect_run("fused", "run")
    assert (pr.distinct_states, pr.states_generated) == \
        (fr.distinct_states, fr.states_generated)
    assert pe.level_sizes == fe.level_sizes
    assert _acts(pr) == _acts(fr)
    diff = [int((a != b).sum()) for a, b in zip(pt, ft)]
    assert diff == record["per_action_vs_fused_rows"] and diff[0] > 0
    # run_fused's per-action tables are run()'s
    _e, _r, ptf = defect_run("per-action", "run_fused")
    for a, b in zip(pt, ptf):
        assert np.array_equal(a, b)


def test_equal_successors_in_one_action_batch(record):
    """Level 2 of the defect config: the first action batch that holds
    two equal successors (of different level-1 parents, in one tile).
    The per-action commit keeps the last of them (the JAX insert's
    fresh lane), the fused commit the first; both name the same state
    and action, and the per-action table is the JAX record's."""
    pe, _pr, pt = defect_run("per-action", "run")
    fe, _fr, ft = defect_run("fused", "run")
    lv2 = slice(6, 24)
    assert pt[0][lv2].tolist() == record["level2"]["parent"][6:24]
    rows = np.nonzero(pt[0][lv2] != ft[0][lv2])[0] + 6
    assert len(rows) > 0
    for r in rows:
        assert pt[1][r] == ft[1][r]              # same action
        assert pt[0][r] > ft[0][r]               # the later parent
        sp = pe._trace(int(r))[-1].state
        sf = fe._trace(int(r))[-1].state
        assert sp == sf                          # the same successor


def test_paged_per_action_edges_match_the_fused_paged_run():
    """``PagedBFS(commit="per-action", edges=True)``: K11 stores each
    action's fresh gids after its insert, one K12 emission a tile on
    the final commit; the graph is the fused paged run's (as (source
    state, action, destination state) edges) and the levels and pointer
    tables are the per-action run()'s."""
    b = load_binding(DEFECT, "VSR")
    kw = dict(tile_size=32, chunk_tiles=2, fpset_capacity=1 << 14,
              next_capacity=1 << 9, edge_capacity=1 << 12, device="cpu")
    pe = PagedBFS(b, edges=True, commit="per-action", **kw)
    pr = pe.run(max_depth=3)
    fe = PagedBFS(b, edges=True, **kw)
    fr = fe.run(max_depth=3)
    ref = DeviceBFS(b, commit="per-action", tile_size=32, chunk_tiles=2,
                    fpset_capacity=1 << 14, next_capacity=1 << 9,
                    device="cpu")
    rr = ref.run(max_depth=3)
    assert pe.level_sizes == fe.level_sizes == ref.level_sizes
    assert (pr.distinct_states, pr.states_generated) == \
        (fr.distinct_states, fr.states_generated) == \
        (rr.distinct_states, rr.states_generated)
    for a, c in zip(pointers(pe), pointers(ref)):
        assert np.array_equal(a, c)

    def edges(eng, res):
        """The edge multiset with each gid named by its state."""
        names = [repr(sorted(eng._trace(g)[-1].state.items()))
                 for g in range(res.distinct_states)]
        indptr, aid, tid = eng.edge_sink.finalize(res.distinct_states)
        return sorted((names[u], int(a), names[v])
                      for u, row in enumerate(canon_csr((indptr, aid, tid)))
                      for a, v in row)
    ep = edges(pe, pr)
    assert ep == edges(fe, fr)
    # one edge an enabled item of the expanded levels 0-2
    assert len(ep) == pr.states_generated - 1


# ----------------------------------------------------------------------
# K15's plain twin against a direct loop
# ----------------------------------------------------------------------
def _loop_tile(c0, actions, T, total_e, cnts, valid, en_any, fresh_of):
    """A direct transcription of the JAX per-action body's commit
    (device_bfs.py:500-667) over prepared per-action inputs: returns the
    carry after the tile, the fresh rows and each action's mask."""
    c = list(c0)
    n_act = len(actions)
    room = c[TL.C_NEXT_CAP] - c[TL.C_NN] >= total_e
    commit = room
    viol_any = slot_err = bag_err = ovf_e = ovf_i = False
    viol = None
    grow = -1
    masks, rows = [], []
    for a, it in enumerate(actions):
        ok = [e and k for e, k in zip(it["en2"], it["ok"])]
        errv = [e if k else 0 for e, k in zip(it["err"], ok)]
        vl = [k and not i and e == 0 for k, i, e in
              zip(ok, it["iok"], errv)]
        a_bag = any(e & 1 for e in errv)
        a_slot = any(e & ~1 for e in errv)
        have_v = any(vl)
        if have_v and viol is None:
            i = vl.index(True)
            viol = (it["pidx"][i], a, it["lane"][i])
        if it["ovf"] and not ovf_e:
            grow = a
        viol_any |= have_v
        bag_err |= a_bag
        slot_err |= a_slot
        ovf_e |= it["ovf"]
        commit_a = (commit and not have_v and not a_slot and not a_bag
                    and not it["ovf"] and not c[TL.C_HALT])
        m = [k and commit_a for k in ok]
        masks.append(m)
        fresh, oi = fresh_of(a, m)
        if c[TL.C_HALT]:
            rows.append([-1] * len(m))
            continue
        r, nn = [], c[TL.C_NN]
        for f in fresh:
            r.append(nn if f else -1)
            nn += bool(f)
        rows.append(r)
        c[TL.C_FP_COUNT] += nn - c[TL.C_NN]
        c[TL.C_NN] = nn
        ovf_i |= oi
        commit = commit_a and not oi
    if c[TL.C_HALT]:
        c[TL.C_IDLE] += 1
        return c, rows, masks
    t = c[TL.C_T]
    reason = (TL.R_NEXT_GROW if not room else TL.R_VIOLATION if viol_any
              else TL.R_SLOT_ERR if slot_err else TL.R_BAG_GROW if bag_err
              else TL.R_EXPAND_GROW if ovf_e else TL.R_FPSET_GROW if ovf_i
              else TL.RUNNING)
    dead = [v and not e for v, e in zip(valid, en_any)]
    if reason == TL.RUNNING and c[TL.C_WANT_DEADLOCK] and commit \
            and any(dead):
        reason = TL.R_DEADLOCK
        c[TL.C_DEAD] = t * T + dead.index(True)
    if reason == TL.R_VIOLATION:
        c[TL.C_VIOL_ROW] = t * T + viol[0]
        c[TL.C_VIOL_AID], c[TL.C_VIOL_LANE] = viol[1], viol[2]
    if ovf_e:
        c[TL.C_GROW_AID] = grow
    if commit:
        c[TL.C_GEN] += sum(cnts)
        for b in range(n_act):
            c[TL.C_NEED + n_act + b] += cnts[b]
        if reason == TL.RUNNING:
            c[TL.C_T] = t + 1
            c[TL.C_TILES] += 1
    c[TL.C_REASON] = reason
    if reason != TL.RUNNING:
        c[TL.C_HALT] = 1
    return c, rows, masks


@pytest.mark.parametrize("seed", range(40))
def test_k15_plain_matches_a_direct_loop(seed):
    """Random per-action inputs (enabled bits, invariant failures, bag
    and slot flags, cap overflows, probe overflows, a short next buffer,
    a halted carry): K15's plain twin, action by action, leaves the
    carry, the rows and the masks the direct loop does.  A paused action
    commits nothing, and the reason follows its priority."""
    g = np.random.default_rng(seed)
    n_act, T = int(g.integers(1, 5)), 8
    E = [int(g.integers(1, 7)) for _ in range(n_act)]
    p = g.uniform(0.0, 0.3, 5)
    actions = []
    for a in range(n_act):
        e = E[a]
        actions.append({
            "en2": (g.random(e) < 0.7).tolist(),
            "ok": (g.random(e) < 0.9).tolist(),
            "iok": (g.random(e) >= p[0]).tolist(),
            "err": [int(x) for x in np.where(
                g.random(e) < p[1], g.choice([1, 2, 3], e), 0)],
            "pidx": g.integers(0, T, e).tolist(),
            "lane": g.integers(0, 3, e).tolist(),
            "ovf": bool(g.random() < p[2])})
    ovf_i = [bool(g.random() < p[3]) for _ in range(n_act)]
    fresh_bits = [(g.random(e) < 0.6).tolist() for e in E]
    cnts = g.integers(0, 9, n_act).tolist()
    valid = (g.random(T) < 0.8).tolist()
    en_any = (g.random(T) < 0.85).tolist()
    total_e = sum(E)
    nn = int(g.integers(0, 6))
    cap = nn + total_e + (0 if g.random() < 0.2 else 5)
    if g.random() < 0.2:
        cap = nn + total_e - 1                  # the headroom gate fails
    c0 = TL.new_carry(n_act, "cpu", t=int(g.integers(0, 3)), nn=nn,
                      next_cap=cap, want_deadlock=int(g.random() < 0.5),
                      halt=int(g.random() < 0.1)).tolist()

    def fresh_of(a, m):
        return [f and k for f, k in zip(fresh_bits[a], m)], ovf_i[a]
    want_c, want_rows, want_masks = _loop_tile(
        c0, actions, T, total_e, cnts, valid, en_any, fresh_of)

    carry = torch.tensor(c0, dtype=torch.int64)
    pa = torch.zeros(len(TL.PA_FIELDS), dtype=torch.int64)
    bufs = _Bufs(cap + 8, 1, "cpu")
    cnt_t = torch.tensor(cnts, dtype=torch.int64)
    va = torch.tensor(valid)
    ea = torch.tensor(en_any)
    for a, it in enumerate(actions):
        e = E[a]
        q = {"pidx": torch.tensor(it["pidx"], dtype=torch.int32),
             "lane": torch.tensor(it["lane"], dtype=torch.int32),
             "aid": torch.full((e,), a, dtype=torch.int32),
             "ok": torch.tensor(it["ok"]),
             "ovf": torch.tensor([it["ovf"]])}
        o = {"en2": torch.tensor(it["en2"]), "iok": torch.tensor(it["iok"]),
             "err": torch.tensor(it["err"], dtype=torch.int32)}
        m = torch.zeros(e, dtype=torch.bool)
        TL.action_gate(carry, pa, q, o, a, total_e, m)
        assert m.tolist() == want_masks[a]
        fresh = torch.tensor(fresh_bits[a]) & m
        dest = torch.zeros(e, dtype=torch.int32)
        TL.action_finish(carry, pa, q, fresh, torch.tensor(
            int(ovf_i[a]), dtype=torch.int32), a, cnt_t, ea, va, bufs, dest)
        assert dest.tolist() == want_rows[a]
        for i in torch.nonzero(fresh)[:, 0].tolist():
            r = int(dest[i])
            assert (int(bufs.par[r]), int(bufs.act[r]), int(bufs.prm[r])) \
                == (c0[TL.C_T] * T + it["pidx"][i], a, it["lane"][i])
    assert carry.tolist() == want_c


def test_pa_layout_matches_the_kernel_source():
    src = open(os.path.join(ROOT, "tpuvsr_torch", "csrc",
                            "tile_commit.cu")).read()
    body = src[src.index("enum PaTile {"):]
    items = body[body.index("{") + 1:body.index("}")].replace(
        "\n", " ").split(",")
    assert [i.strip() for i in items if i.strip()] == \
        ["P_" + f.upper() for f in TL.PA_FIELDS] + ["P_FIELDS"]


# ----------------------------------------------------------------------
def record_jax():
    """The JAX package's DeviceBFS on the defect config (the
    constants-only shim of tests/test_torch_fleet.py) at tile 128 to
    depth 6, under each commit."""
    os.environ["TPUVSR_LINT"] = "off"       # the shim has no .tla to lint
    from tests.test_torch_fleet import jax_shim
    from tpuvsr.engine.device_bfs import DeviceBFS as JDeviceBFS
    from tpuvsr.models.registry import make_model as jm
    shim, _e, _c, _k = jax_shim()
    shim.temporal_props = ()
    doc = {"config": "examples/VSR_defect.cfg, MAX_MSGS 32", "depth": DEPTH,
           "engine": DEFECT_KW}
    tables = {}
    for commit in ("per-action", "fused"):
        t0 = time.time()
        eng = JDeviceBFS(shim, model_factory=lambda s, max_msgs=None: jm(
            s, max_msgs=32, fold_symmetry=False), pipeline=1, bounds=False,
            commit=commit, expand_mult=32,
            **{k: v for k, v in DEFECT_KW.items()
               if k != "next_capacity"}, next_capacity=1 << 16)
        res = eng.run(max_depth=DEPTH)
        tables[commit] = pointers(eng)
        doc["levels"] = [int(x) for x in eng.level_sizes]
        doc[commit] = {"distinct": res.distinct_states,
                       "generated": res.states_generated,
                       "action_expansions": [int(x)
                                             for x in eng._act_counts],
                       "digest": digest(tables[commit]),
                       "cpu_s": round(time.time() - t0, 1)}
        print(commit, doc[commit], flush=True)
    pt = tables["per-action"]
    doc["level2"] = {k: t[:24].tolist() for k, t in
                     zip(("parent", "action", "param"), pt)}
    doc["per_action_vs_fused_rows"] = [
        int((a != b).sum()) for a, b in zip(pt, tables["fused"])]
    return doc


if __name__ == "__main__":
    if sys.argv[1:2] != ["record"]:
        sys.exit(__doc__)
    doc = record_jax()
    with open(RECORD, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
