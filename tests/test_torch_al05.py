"""Parity of the port's VR_REPLICA_RECOVERY_ASYNC_LOG (AL05) model with
the JAX package's on the CPU: the checks of tests/test_torch_a01.py
(codec, guards, every lane's successor, invariants, the three
fingerprints, the host tables of K13 and K14, and the BFS levels of
``run()`` and ``run_fused()``) on AL05's cases, bit for bit (tolerance
0), on walked rows that enable every recovery action (Crash over its
R x (MAX_OPS + 1) lanes, ReceiveRecoveryMsg, ReceiveRecoveryResponseMsg,
CompleteRecovery).

AL05 has no RetryRecovery: only Crash mints a nonce, the widths pass's
bound holds, and the port packs AL05 states as the JAX package does
(the same manifest digest).  The small cfg's levels to depth 6 are the
JAX-kernel host BFS's.  That BFS, run to its fixpoint as a script
(``python tests/test_torch_al05.py record 30``), gives 2,298,063
distinct, 5,089,047 generated, diameter 30
(``tpuvsr_torch/configs/records/AL05_small_host_bfs.log``), which
``chip_smoke.py`` phase 12 checks on the card; the JAX package's record
(scripts/recovery_fixpoints.json, 2,316,959) parts from it at depth 16."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import pytest  # noqa: E402

from tests.test_torch_a01 import (  # noqa: E402
    FAMILY, check_bag_growth, check_bfs, check_codec_layout, check_covers,
    check_fingerprints, check_guard_matrix, check_incremental,
    check_invariants, check_pack_round_trip, check_parent_parts,
    check_counterexample, check_plain_calls, check_round_trip,
    check_successors, check_tables, family_case, jax_fns, jax_level_bfs,
    one_torch_thread)
from tpuvsr.models.al05_kernel import AL05Kernel as JAL05Kernel  # noqa: E402

KEY = "AL05"
MODEL = FAMILY[KEY]
STATE_TRANSFER = ["SendGetState", "ReceiveGetState", "ReceiveNewState"]
# the small cfg's first counterexample: the (action, lane) steps of the
# trace run() reports, NoLogDivergence at depth 17 (Crash lane 2:
# replica 2, no surviving prefix)
COUNTEREXAMPLE = [
    ("Crash", 2), ("ReceiveRecoveryMsg", 0), ("ReceiveRecoveryMsg", 1),
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
    """Every recovery action is enabled on some row of every case, and
    on the wide constants Crash with a surviving prefix (a lane with
    last_op > 0) among them; with one value SendGetState never fires,
    and NoProgressChange needs its limit."""
    off = [] if case.name == "wide" else STATE_TRANSFER
    check_covers(case, off + ([] if case.name == "small_np1"
                              else ["NoProgressChange"]))
    kern = case.kern
    crash = kern.lane_action == kern.action_names.index("Crash")
    assert crash.sum() == kern.R * (kern.MAX_OPS + 1)
    if case.name == "wide":
        kept = crash & (kern.lane_param % (kern.MAX_OPS + 1) > 0)
        assert case.got["en2"][:, kept].any()


def test_guard_matrix_matches_jax(case):
    check_guard_matrix(case)


@pytest.mark.parametrize("action", JAL05Kernel.action_names)
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
    check_bag_growth(KEY, "run_fused")


def test_counterexample_replays_in_both_packages():
    """The 17 steps of the small cfg's first counterexample (RR05's, with
    a Crash that keeps no prefix) in both packages: NoLogDivergence,
    NoAppStateDivergence and CommitNumberNeverHigherThanOpNumber fail on
    the last state in both."""
    check_counterexample(KEY, COUNTEREXAMPLE)


def _record(depth, tiled=False, size=256):
    """The JAX-kernel host BFS of the small cfg with no invariant, the
    order of ``level_bfs`` (parents in order, lanes in order, the first
    of equal fingerprints kept) in batches of ``size`` parents: a line a
    depth with the level, the cumulative distinct and generated counts
    (Init counted) and the new states that violate the cfg's invariants,
    then the levels.  ``tiled`` takes the order of the JAX engine that
    made scripts/recovery_fixpoints.json's record (tiles of 512 parents,
    within a tile action by action, and of equal fingerprints in one
    action's batch the last kept)."""
    import time
    import numpy as np
    from tests.test_torch_st03 import _fps, _run
    from tpuvsr.frontend.cfg import parse_cfg_file
    J = jax_fns(KEY, "small")
    jk = J.jk
    names = list(jk.INVARIANT_FNS)
    cfg_inv = [names.index(n) for n in parse_cfg_file(MODEL.small).invariants]
    init = jk.codec.zero_state()
    init["view"][:] = 1
    batch = {k: v[None] for k, v in init.items()}
    seen = {_fps(J, batch)[0].tobytes()}
    size = 512 if tiled else size
    offs = np.cumsum([0] + [jk._lane_count(n) for n in jk.action_names])
    levels, gen, t0 = [1], 1, time.time()
    for d in range(1, depth + 1):
        parts = []
        for lo in range(0, len(batch["view"]), size):
            part = {k: v[lo:lo + size] for k, v in batch.items()}
            clean, en = _run(J.step, part, size)[:2]
            gen += int(en.sum())
            groups = [np.nonzero(en.reshape(-1))[0]]
            if tiled:
                groups = [p * en.shape[1] + offs[a] + ln for a in range(
                    len(offs) - 1) for p, ln in [np.nonzero(
                        en[:, offs[a]:offs[a + 1]])]]
            for sel in groups:
                flat = {k: v.reshape((-1,) + v.shape[2:])[sel]
                        for k, v in clean.items()}
                if not len(sel):
                    continue
                assert not flat["err"].any()
                fps = _fps(J, flat)
                win = {}
                for i in range(len(fps)):
                    key = fps[i].tobytes()
                    if key not in seen and (tiled or key not in win):
                        win[key] = i
                seen.update(win)
                if win:
                    keep = sorted(win.values())
                    parts.append({k: v[keep] for k, v in flat.items()})
        if not parts:
            break
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        invs = _run(J.invs, batch, size)
        bad = ~np.logical_and.reduce([invs[i] for i in cfg_inv])
        levels.append(len(batch["view"]))
        print(f"depth {d}: level {levels[-1]} cum {sum(levels)} gen {gen} "
              f"violating {int(bad.sum())} "
              f"{[names[i] for i in cfg_inv if not invs[i].all()]} "
              f"t {time.time() - t0:.0f}s", flush=True)
    print(levels, flush=True)


if __name__ == "__main__":
    # python tests/test_torch_al05.py record DEPTH [tiled] prints the
    # JAX-kernel host BFS of the small cfg with no invariant (to the
    # fixpoint at DEPTH 30, about 40 min of CPU; its output is
    # tpuvsr_torch/configs/records/AL05_small_host_bfs.log); ... wide
    # DEPTH the wide cfg's levels: the records chip_smoke.py phase 12
    # holds
    if sys.argv[1] == "record":
        _record(int(sys.argv[2]), tiled=sys.argv[3:] == ["tiled"])
    else:
        print("levels", jax_level_bfs(KEY, sys.argv[1], int(sys.argv[2])),
              flush=True)
