"""Parity of the port's VR_REPLICA_RECOVERY (RR05) model with the JAX
package's on the CPU: the checks of tests/test_torch_a01.py (codec,
guards, every lane's successor, invariants, the three fingerprints, the
host tables of K13 and K14, and the BFS levels of ``run()`` and
``run_fused()``) on RR05's cases, bit for bit (tolerance 0), on walked
rows that enable every recovery action (Crash, ReceiveRecoveryMsg,
ReceiveRecoveryResponseMsg, CompleteRecovery, RetryRecovery).

Besides, the recovery nonce: RetryRecovery re-mints it without bound,
so the port packs it in raw 32-bit lanes where the JAX package's pack
bound (1 + CrashLimit) wraps a nonce of 4 to 0; a value past any
plane's bound makes the port's pack fail, on the CPU at once and in the
engines through K4's flag.  With CrashLimit 0 the model is VR_APP_STATE
(its levels).  And the first counterexample of the small cfg: the 17
steps the port's ``run()`` reports for NoLogDivergence, replayed through
both packages' kernels, give the same states, and the JAX kernel's last
one violates the invariant too.

Run as a script it prints the JAX-kernel host BFS's records that
``chip_smoke.py`` phase 12 holds the card to:
``python tests/test_torch_rr05.py record CRASHLIMIT DEPTH`` (the small
cfg: levels, cumulative generated counts with Init, and the largest
nonce by depth) and ``... wide DEPTH``."""

import functools
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_a01 import (  # noqa: E402
    FAMILY, binding, check_bag_growth, check_bfs, check_codec_layout,
    check_covers, check_fingerprints, check_guard_matrix, check_incremental,
    check_invariants, check_pack_round_trip, check_parent_parts,
    check_plain_calls, check_round_trip, check_successors, check_tables,
    check_counterexample, engine, family_case, jax_codec, jax_fns,
    one_torch_thread)
from tests.test_torch_st03 import _batch, _fps, _run  # noqa: E402
from tests.test_torch_st03_bfs import level_bfs  # noqa: E402
from tpuvsr.analysis.passes.widths import (  # noqa: E402
    derive_ranges_from as j_ranges)
from tpuvsr.engine.pack import build_pack_spec as j_pack_spec  # noqa: E402
from tpuvsr.models.rr05_kernel import RR05Kernel as JRR05Kernel  # noqa: E402
from tpuvsr_torch.core.values import TLAError  # noqa: E402
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.engine.spec import load_binding  # noqa: E402
from tpuvsr_torch.models.rr05 import M_RECOVERY  # noqa: E402
from tpuvsr_torch.models.vsr import H_SRC, H_TYPE, H_X  # noqa: E402

KEY = "RR05"
MODEL = FAMILY[KEY]
STATE_TRANSFER = ["SendGetState", "ReceiveGetState", "ReceiveNewState"]
# the first counterexample of the small cfg (CrashLimit 1): the (action,
# lane) steps of the trace run() reports, NoLogDivergence at depth 17
COUNTEREXAMPLE = [
    ("Crash", 1), ("ReceiveRecoveryMsg", 0), ("ReceiveRecoveryMsg", 1),
    ("ReceiveClientRequest", 0), ("ReceivePrepareMsg", 5),
    ("TimerSendSVC", 2), ("ReceivePrepareOkMsg", 6),
    ("PrimaryExecuteOp", 0), ("ReceiveHigherSVC", 7), ("SendDVC", 0),
    ("ReceiveRecoveryResponseMsg", 2), ("ReceiveRecoveryResponseMsg", 3),
    ("CompleteRecovery", 1), ("ReceiveHigherSVC", 8),
    ("ReceiveMatchingDVC", 11), ("SendDVC", 1), ("SendSV", 1)]


@pytest.fixture(scope="module", params=list(MODEL.cases))
def case(request):
    return family_case(KEY, request.param)


@pytest.mark.parametrize("name", list(MODEL.cases))
def test_codec_layout_matches_jax(name):
    check_codec_layout(KEY, name)


def test_codec_round_trip_matches_jax(case):
    check_round_trip(case)


def test_pack_round_trip(case):
    check_pack_round_trip(case)


def test_inputs_cover_the_actions(case):
    """Every recovery action is enabled on some row of every case; with
    one value SendGetState never fires (as for ST03), and
    NoProgressChange needs its limit."""
    off = [] if case.name == "wide" else STATE_TRANSFER
    check_covers(case, off + ([] if case.name == "small_np1"
                              else ["NoProgressChange"]))


def test_guard_matrix_matches_jax(case):
    check_guard_matrix(case)


@pytest.mark.parametrize("action", JRR05Kernel.action_names)
def test_successors_plain_matches_jax(case, action):
    check_successors(case, action)


def test_invariants_match_jax(case):
    check_invariants(case)


def test_fingerprints_match_jax(case):
    check_fingerprints(case)


def test_parent_parts_match_jax(case):
    check_parent_parts(case)


def test_incremental_fingerprints_match_jax(case):
    check_incremental(case)


def test_tables_match_the_kernel_source():
    check_tables(KEY)


def test_plain_calls_are_counted():
    check_plain_calls(KEY)


@pytest.mark.parametrize("entry", ["run", "run_fused"])
@pytest.mark.parametrize("name", ["small", "wide"])
def test_bfs_levels_match_jax(name, entry):
    check_bfs(KEY, name, entry)


def test_bag_growth_keeps_levels():
    check_bag_growth(KEY, "run")


# ----------------------------------------------------------------------
# CrashLimit 0: VR_APP_STATE's levels
# ----------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_crash_limit_zero_gives_app_state_levels(entry):
    b = binding(MODEL, MODEL.small, 0)
    b.cfg.constants["CrashLimit"] = 0
    eng = DeviceBFS(b, tile_size=64, chunk_tiles=8, fpset_capacity=1 << 14,
                    next_capacity=1 << 10, device="cpu")
    res = getattr(eng, entry)(max_depth=8)
    assert res.ok and res.levels == FAMILY["AS04"].bfs["small"][2]


# ----------------------------------------------------------------------
# the recovery nonce and the pack's range check
# ----------------------------------------------------------------------
def _nonce_row(case, nonce):
    """A walked row holding a RecoveryMsg, with that message's nonce and
    its sender's rec_number set to ``nonce``: (row, slot, sender)."""
    for row in case.walked:
        h = row["m_hdr"]
        k = np.nonzero((row["m_present"] == 1)
                       & (h[:, H_TYPE] == M_RECOVERY))[0]
        if len(k):
            k, i = int(k[0]), int(h[k[0], H_SRC]) - 1
            t = {key: np.array(v) for key, v in row.items()}
            t["m_hdr"][k, H_X] = nonce
            t["rec_number"][i] = nonce
            return t, k, i
    raise AssertionError("no walked row holds a RecoveryMsg")


def test_a_nonce_of_four_round_trips_where_jax_wraps_it():
    """The port's pack keeps a nonce of 4 in H_X and rec_number; the JAX
    package's pack of the same row, with its widths pass's bound of 1 +
    CrashLimit (2 bits), returns 0 there: the reference fault ROADMAP
    queue 3 records."""
    case = family_case(KEY, "small")
    row, k, i = _nonce_row(case, 4)
    pk = case.kern.pk
    flat = pk.flatten({key: torch.as_tensor(v)[None]
                       for key, v in row.items()})
    assert torch.equal(pk.unpack(pk.pack(flat)), flat)
    back = pk.unflatten(pk.unpack(pk.pack(flat)))
    assert int(back["rec_number"][0, i]) == 4
    assert int(back["m_hdr"][0, k, H_X]) == 4
    jc = jax_codec(MODEL, MODEL.small, 0, case.kern.M)
    jpk = j_pack_spec(jc, ranges=j_ranges(jc.constants, MODEL.module))
    jback = jpk.unpack(jpk.pack(row))
    assert int(np.asarray(jback["rec_number"])[i]) == 0
    assert int(np.asarray(jback["m_hdr"])[k, H_X]) == 0


def test_a_value_past_its_bound_fails_the_pack():
    """Each bounded plane in turn, one lane set one past its bound: the
    port's pack raises, naming the plane, where the JAX package's would
    wrap it."""
    case = family_case(KEY, "small")
    pk = case.kern.pk
    flat = case.flat[:1].clone()
    pk.pack(flat)
    hi = pk._lo.astype(np.int64) + pk._mask.astype(np.int64)
    n = 0
    for key, _shape, a, e in pk._splits:
        lanes = [x for x in range(a, e) if pk._bits[x] < 32]
        if not lanes:
            continue
        bad = flat.clone()
        bad[0, lanes[-1]] = int(hi[lanes[-1]]) + 1
        with pytest.raises(TLAError, match=f"plane {key!r}"):
            pk.pack(bad)
        n += 1
    assert n >= 20


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_the_range_flag_fails_the_run(entry):
    """The engines read K4's range flag with their host reads and stop
    the run when it is set (here set by hand after each pack, as the
    kernel sets it on the card)."""
    eng = engine(MODEL, MODEL.small)
    pk = eng._pk
    pack = pk.pack

    def flagged(flat, out=None, dest=None):
        res = pack(flat, out, dest)
        pk.range_flag(flat.device)[0] = 1
        return res
    pk.pack = flagged
    with pytest.raises(TLAError, match="outside its plane's pack bound"):
        getattr(eng, entry)(max_depth=3)


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_a_nonce_past_a_narrowed_bound_stops_the_run(entry, monkeypatch):
    """Packed under a manifest that gives the nonce one bit (bound 0..1),
    the small cfg's first nonce of 2 (depth 6) stops both engines with
    the pack's range error after depth 5, as the JAX package's 2-bit
    manifest stops them at depth 16 on the card (chip_smoke.py 12f)."""
    from tpuvsr_torch.models import registry

    def narrowed(constants, module):
        rng = j_free_ranges(constants, module)
        rng["recovery_nonce"] = (0, 1)
        return rng
    j_free_ranges = registry.derive_ranges_from
    monkeypatch.setattr(registry, "derive_ranges_from", narrowed)
    b = binding(MODEL, MODEL.small, 0)
    b.invariants = []
    eng = DeviceBFS(b, tile_size=64, chunk_tiles=8, fpset_capacity=1 << 14,
                    next_capacity=1 << 10, device="cpu")
    assert eng._pk._bits[next(a for k, _s, a, _e in eng._pk._splits
                              if k == "rec_number")] == 1
    lines = []
    with pytest.raises(TLAError, match="outside its plane's pack bound"):
        getattr(eng, entry)(max_depth=8, log=lines.append)
    if entry == "run":
        done = [m for m in lines if m.startswith("depth ")]
        assert done[-1].startswith("depth 5:")


# ----------------------------------------------------------------------
# the small cfg's first counterexample
# ----------------------------------------------------------------------
def test_counterexample_replays_in_both_packages():
    """The 17 steps of the NoLogDivergence trace, from Init, in both
    packages (a recovered replica's empty log, its lnv 1 from the
    recovery, chosen over a committed one with Init's lnv 0)."""
    check_counterexample(KEY, COUNTEREXAMPLE)


# ----------------------------------------------------------------------
# the engines' order: the counterexample each commit reports
# ----------------------------------------------------------------------
RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpuvsr_torch", "configs", "records",
    "rr05_counterexamples.json")


def ordered_bfs(J, depth, commit, tile):
    """Host BFS over a JAX kernel of the family (``J``: its ``jk`` and
    ``fp``, and ``step``, the all-lanes step whose last output is the
    conjunction of the cfg's invariants) in the order of the port's
    DeviceBFS at ``tile`` rows a tile: the frontier tile by tile, a
    tile's actions in order, an action's enabled (row, lane) items row
    by row (K7's work queue).  A successor is new where its fingerprint
    was not seen before; among equal ones the fused commit makes the
    first of the tile new (its dedup), the per-action commit the last of
    the action's batch (the JAX insert's scatter on the CPU).  The
    first tile holding a successor that fails an invariant ends the
    search, at its first such action and that action's first such item
    (both commits' record of a violation).  Returns (levels, the pointer
    tables (parent gid, action, lane) of every state, Init's -1, -1, 0,
    and the violating (action, lane) steps from Init, or None)."""
    jk = J.jk
    acts = [np.nonzero(jk.lane_action == a)[0]
            for a in range(len(jk.action_names))]
    init = jk.codec.zero_state()
    init["view"][:] = 1
    seen = {_fps(J, {k: v[None] for k, v in init.items()})[0].tobytes()}
    par, act, prm = [-1], [-1], [0]
    frontier, levels, base = [init], [1], 0
    for _ in range(depth):
        nxt = []
        for lo in range(0, len(frontier), tile):
            out = _run(J.step, _batch(frontier[lo:lo + tile]))
            clean, en, ok = out[0], out[1], out[-1]
            groups = [np.nonzero(en[:, la]) for la in acts]
            rows = np.concatenate([r for r, _j in groups])
            lanes = np.concatenate([la[j] for la, (_r, j)
                                    in zip(acts, groups)])
            if not len(rows):
                continue
            succ = {k: v[rows, lanes] for k, v in clean.items()}
            assert not succ["err"].any()
            keys = [f.tobytes() for f in _fps(J, succ)]
            bad = ~ok[rows, lanes]
            at = 0
            for a, (r, _j) in enumerate(groups):
                idx = range(at, at + len(r))
                at += len(r)
                hit = [i for i in idx if bad[i]]
                if hit:
                    i = hit[0]
                    steps = [(a, int(jk.lane_param[lanes[i]]))]
                    g = base + lo + int(rows[i])
                    while act[g] >= 0:
                        steps.append((act[g], prm[g]))
                        g = par[g]
                    return levels, (par, act, prm), steps[::-1]
                if commit == "fused":
                    new = []
                    for i in idx:
                        if keys[i] not in seen:
                            seen.add(keys[i])
                            new.append(i)
                else:
                    last = {keys[i]: i for i in idx if keys[i] not in seen}
                    new = sorted(last.values())
                    seen.update(last)
                for i in new:
                    par.append(base + lo + int(rows[i]))
                    act.append(a)
                    prm.append(int(jk.lane_param[lanes[i]]))
                    nxt.append({k: v[i] for k, v in succ.items()})
        base += len(frontier)
        levels.append(len(nxt))
        frontier = nxt
    return levels, (par, act, prm), None


@functools.lru_cache(maxsize=None)
def _ordered_jax():
    """The small cfg's JAX kernel (MAX_MSGS 32) with its all-lanes step
    checking the cfg's four invariants."""
    from tests.test_torch_st03 import _jax_all_lanes, jax_fns_of
    jc = jax_codec(MODEL, MODEL.small, 0, 32)
    J = jax_fns_of(JRR05Kernel(jc))
    J.step = _jax_all_lanes(J.jk, load_binding(
        MODEL.small, MODEL.module).invariants)
    return J


@functools.lru_cache(maxsize=None)
def _ordered(commit):
    """ordered_bfs and the port's run() under ``commit``, small cfg,
    depth 6, tile 64: (levels, pointer tables) of each, and the
    counterexample ordered_bfs met."""
    levels, tables, steps = ordered_bfs(_ordered_jax(), 6, commit, 64)
    eng = engine(MODEL, MODEL.small, commit=commit)
    res = eng.run(max_depth=6)
    return (levels, tables), (res.levels, [
        np.concatenate(getattr(eng, k)).tolist()
        for k in ("_h_parent", "_h_action", "_h_param")]), steps


@pytest.mark.parametrize("commit", ["per-action", "fused"])
def test_engine_order_is_the_ordered_jax_bfs(commit):
    """The port's run() on the small cfg to depth 6 at tile 64 has the
    pointer tables of ordered_bfs over the JAX kernel, under each commit:
    so the record of each commit's first counterexample that ordered_bfs
    writes (RECORD, at tile 128) is what the engines must report, and
    chip_smoke.py holds the card's runs to it."""
    want, got, steps = _ordered(commit)
    assert got[0] == want[0] == MODEL.bfs["small"][2] and steps is None
    assert got[1] == list(want[1])


def test_the_two_commits_order_differently():
    """There the two commits' pointer tables differ (equal successors in
    one action's batch), so the test above tells them apart."""
    pa, fu = _ordered("per-action")[0][1], _ordered("fused")[0][1]
    assert [sum(x != y for x, y in zip(a, b)) for a, b in zip(pa, fu)] \
        == [914, 64, 768]


def test_counterexample_record():
    """The record's fused trace is the one run() and run_fused() report
    with the fused commit (COUNTEREXAMPLE, phase 12 on the card); the
    per-action trace differs from it and replays in both packages to a
    state that fails the invariants."""
    import json
    rec = json.load(open(RECORD))
    assert [tuple(x) for x in rec["fused"]["steps"]] == COUNTEREXAMPLE
    pa = [tuple(x) for x in rec["per-action"]["steps"]]
    assert len(pa) == len(COUNTEREXAMPLE) and pa != COUNTEREXAMPLE
    check_counterexample(KEY, pa)


def _record_counterexamples():
    """Both commits' first counterexample of the small cfg at tile 128
    (chip_smoke.py's), and where their pointer tables and traces first
    differ (run as a script: ``record-counterexamples``)."""
    import json
    import time
    J = _ordered_jax()
    doc = {"config": "tpuvsr_torch/configs/VR_REPLICA_RECOVERY_small.cfg"
                     " (CrashLimit 1), MAX_MSGS 32", "tile": 128}
    tables = {}
    for commit in ("fused", "per-action"):
        t0 = time.time()
        levels, tab, steps = ordered_bfs(J, 17, commit, 128)
        names = [(J.jk.action_names[a], p) for a, p in steps]
        doc[commit] = {"levels": levels, "steps": names,
                       "cpu_s": round(time.time() - t0, 1)}
        tables[commit] = tab
        print(commit, doc[commit], flush=True)
    f, p = doc["fused"]["steps"], doc["per-action"]["steps"]
    doc["first_step_unlike"] = next(
        (i + 1 for i, (x, y) in enumerate(zip(f, p)) if x != y), None)
    ends = np.cumsum(doc["fused"]["levels"])
    n = int(ends[-1])
    diff = np.zeros(n, bool)
    for x, y in zip(tables["fused"], tables["per-action"]):
        diff |= np.asarray(x[:n]) != np.asarray(y[:n])
    doc["first_level_unlike"] = int(np.searchsorted(
        ends, int(np.argmax(diff)), side="right")) if diff.any() else None
    with open(RECORD, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def _records(argv):
    """The JAX-kernel host BFS's records (run as a script)."""
    import time
    if argv[0] == "record-counterexamples":
        return _record_counterexamples()
    t0 = time.time()
    if argv[0] == "wide":
        print(level_bfs(jax_fns(KEY, "wide"), int(argv[1])),
              f"{time.time() - t0:.1f}s", flush=True)
        return
    crash, depth = int(argv[1]), int(argv[2])
    jc = jax_codec(MODEL, MODEL.small, 0, 32)
    jc.constants["CrashLimit"] = crash
    from tests.test_torch_st03 import jax_fns_of
    J = jax_fns_of(JRR05Kernel(jc))
    gen, nonce = [1], []

    def on_level(states, n_en):
        gen.append(gen[-1] + n_en)
        x = [max(int(s["rec_number"].max()), int(np.where(
            s["m_present"] == 1, s["m_hdr"][:, H_X], 0).max()))
             for s in states]
        nonce.append(max([nonce[-1] if nonce else 0] + x))
    levels = level_bfs(J, depth, on_level)
    print("levels", levels)
    print("generated", gen)
    print("largest nonce by depth", nonce, f"{time.time() - t0:.1f}s",
          flush=True)


if __name__ == "__main__":
    # python tests/test_torch_rr05.py record CRASHLIMIT DEPTH | wide DEPTH
    #   | record-counterexamples
    _records(sys.argv[1:])
