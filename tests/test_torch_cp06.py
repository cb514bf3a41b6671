"""Parity of the port's VR_REPLICA_RECOVERY_CP (CP06) model with the JAX
package's on the CPU: the checks of tests/test_torch_a01.py (codec,
guards, every lane's successor, invariants, the three fingerprints, the
host tables of K13 and K14, and the BFS levels of ``run()`` and
``run_fused()``) on CP06's cases, bit for bit (tolerance 0).

The rows: Init, rows met on walks of the JAX kernel (its walkers crash
seldom, ``CP06_GUIDE``), and three hand-built rows no short walk meets:
a Normal primary whose first op is garbage-collected (NoOp) answering a
RecoveryMsg and a GetState in the checkpoint form (flag 1, one lane per
cp), a StateTransfer replica with a flag-1 NewState, a Recovering
replica with flag-1, Nil and first_op responses (CompleteRecovery's
checkpoint path; a second, different response from one source sets
ERR_REC_OVERFLOW), a NewCheckpoint and a GetCheckpoint; a view change
whose two DoViewChange slots tie on (lnv, op) and part on their
checkpoints (WinningDVC), a higher DoViewChange and a StartView with
checkpoints, a different second DoViewChange from one source
(ERR_DVC_OVERFLOW) and, with two values, a Prepare that opens state
transfer; and a NoOp-prefix row whose invariants hold through ``OpOf``
where the raw-log ones fail.

The recovery nonce: CP06 mints it in Crash and in each
ReceiveNewCheckpointMsg, but Crash's SendOnce GetCheckpoint lets each
replica crash once and each GetCheckpoint is answered once, so the
largest nonce is CrashLimit and the widths pass's bound, 1 + CrashLimit,
holds: CP06 is not in ``NONCE_UNBOUNDED``, and the port packs it as the
JAX package does.  The JAX codec's DoViewChange rows raise NameError
(``H_LNV`` is not imported in ``tpuvsr/models/cp06.py``); the round
trip supplies the name to the JAX module for its decode.

Run as a script it prints the JAX-kernel host BFS's records that
``chip_smoke.py`` phase 13 holds the card to: ``python
tests/test_torch_cp06.py record DEPTH`` (the small cfg: levels,
cumulative generated counts with Init, and the largest nonce by depth)
and ``... wide DEPTH``."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import tpuvsr.models.cp06 as jcp06  # noqa: E402
from tests.test_torch_a01 import (  # noqa: E402
    FAMILY, binding, check_bag_growth, check_bfs, check_codec_layout,
    check_covers, check_fingerprints, check_guard_matrix, check_incremental,
    check_invariants, check_pack_round_trip, check_parent_parts,
    check_plain_calls, check_round_trip, check_successors, check_tables,
    family_case, jax_fns, one_torch_thread)
from tests.test_torch_st03 import _run  # noqa: E402
from tests.test_torch_st03_bfs import level_bfs  # noqa: E402
from tpuvsr.models.cp06_kernel import CP06Kernel as JCP06Kernel  # noqa: E402
from tpuvsr.models.st03_kernel import ST03Kernel as JST03Kernel  # noqa: E402
from tpuvsr_torch.analysis.widths import (  # noqa: E402
    NONCE_UNBOUNDED, derive_ranges_from)
from tpuvsr_torch.engine.device_bfs import DeviceBFS  # noqa: E402
from tpuvsr_torch.models import st03_kernel as psk  # noqa: E402
from tpuvsr_torch.models.rr05 import M_RECOVERY  # noqa: E402
from tpuvsr_torch.models.st03 import M_DVC  # noqa: E402
from tpuvsr_torch.models.vsr import H_LNV, H_TYPE, H_X  # noqa: E402
from tpuvsr_torch.testing import checkpoint_rows  # noqa: E402

KEY = "CP06"
MODEL = FAMILY[KEY]


def _cp_rows(case, rows):
    """The three hand-built rows (``tpuvsr_torch.testing.checkpoint_rows``,
    module docstring)."""
    return checkpoint_rows(case.kern.codec)


@pytest.fixture(scope="module", params=list(MODEL.cases))
def case(request):
    return family_case(KEY, request.param, _cp_rows)


@pytest.fixture
def jax_h_lnv(monkeypatch):
    """The JAX codec module with the H_LNV name its DoViewChange rows
    need (ROADMAP queue 3)."""
    monkeypatch.setattr(jcp06, "H_LNV", H_LNV, raising=False)


# ----------------------------------------------------------------------
# the family checks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MODEL.cases))
def test_codec_layout_matches_jax(name):
    check_codec_layout(KEY, name)


def test_codec_round_trip_matches_jax(case, jax_h_lnv):
    check_round_trip(case)


def test_jax_codec_lacks_h_lnv(case):
    """The reference fault: the JAX codec's decode of a DoViewChange row
    raises NameError, where the port's decodes it."""
    b = case.info["built"][1]
    row = case.rows[b]
    assert row["m_hdr"][0, H_TYPE] == M_DVC
    with pytest.raises(NameError, match="H_LNV"):
        case.jk.codec.decode(row)
    st = case.kern.codec.decode(row)
    dvc = [m for m, _n in st["messages"].items
           if m.apply("type") == case.kern.codec.mtype_mv[M_DVC]]
    assert sorted(m.apply("last_normal_vn") for m in dvc) == [0, 1]


def test_pack_round_trip(case):
    check_pack_round_trip(case)


def _lanes(kern, action, cp=None):
    a = kern.action_names.index(action)
    m = kern.lane_action == a
    if cp is not None:
        m &= (kern.lane_param % (kern.MAX_OPS + 1) > 0) == cp
    return m


def test_inputs_cover_the_actions(case):
    """Every action is enabled on some row of every case but, on one
    value, SendGetState (a Prepare two ops ahead needs two) and
    ReceiveGetState (a GC'd slot leaves no cp in HighestGCedOp+1..commit
    when all is committed at one op), and NoProgressChange without its
    limit.  On two values the checkpoint (flag-1) lanes of
    ReceiveGetState and ReceiveRecoveryMsg are among them, with their
    log-suffix ones; on every case the flag-1 NewState, response and
    CompleteRecovery."""
    wide = case.name == "wide"
    off = [] if wide else ["SendGetState", "ReceiveGetState"]
    check_covers(case, off + ([] if case.name == "small_np1"
                              else ["NoProgressChange"]))
    kern, en = case.kern, case.got["en2"]
    for action in ("ReceiveGetState", "ReceiveRecoveryMsg"):
        for cp in (True, False):
            hit = en[:, _lanes(kern, action, cp)].any()
            assert hit == (wide or action == "ReceiveRecoveryMsg"
                           and not cp), (action, cp)
    a = case.info["built"][0]
    for action in ("ReceiveNewState", "ReceiveRecoveryResponseMsg",
                   "CompleteRecovery", "ReceiveNewCheckpointMsg",
                   "ReceiveGetCheckpointMsg"):
        assert en[a, _lanes(kern, action)].any(), action
    # the second, different response from replica 2 sets ERR_REC_OVERFLOW
    errs = case.got["err"][a][_lanes(kern, "ReceiveRecoveryResponseMsg")
                              & case.got["en2"][a]]
    assert (errs & 4).any()


def test_guard_matrix_matches_jax(case):
    check_guard_matrix(case)


@pytest.mark.parametrize("action", JCP06Kernel.action_names)
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


# ----------------------------------------------------------------------
# CP06's own checks
# ----------------------------------------------------------------------
def test_winning_dvc_breaks_the_tie_on_the_checkpoint():
    """Two DoViewChange slots with equal (lnv, op): the one whose
    checkpoint is the least wins (replica 3's, no checkpoint), and SendSV
    installs its log in both packages (the successor parity above)."""
    case = family_case(KEY, "small", _cp_rows)
    kern = case.kern
    b = case.info["built"][1]
    st = {k: torch.as_tensor(v[b:b + 1]) for k, v in case.batch.items()}
    j, new_cn = kern._winning_dvc(st, torch.tensor([1]))
    assert int(j[0]) == 2 and int(new_cn[0]) == kern.MAX_OPS
    col = np.nonzero(_lanes(kern, "SendSV"))[0][1]
    assert case.want["en2"][b, col]
    sv = kern.pk.unflatten(torch.as_tensor(case.want["succ"][b, col][None]))
    assert sv["log"][0, 1].tolist() == list(range(1, kern.MAX_OPS + 1))


def test_noop_prefix_invariants_go_through_op_of():
    """On the NoOp-prefix row (replica 1's committed slot GC'd, its app
    holding v1) NoLogDivergence and AcknowledgedWritesExistOnMajority
    hold through OpOf in both packages; on the raw logs, as the family's
    ST03 forms read them, the logs diverge and v1 is on one replica
    only, in both."""
    case = family_case(KEY, "small", _cp_rows)
    kern, J = case.kern, case.J
    c = case.info["built"][2]
    st = {k: torch.as_tensor(v[c:c + 1]) for k, v in case.batch.items()}
    assert (st["log"][0, 0, 0] == kern.NOOP) and st["app"][0, 0, 0] == 1
    names = list(kern.INVARIANT_FNS)
    want = _run(J.invs, {k: v[c:c + 1] for k, v in case.batch.items()})
    for inv in ("NoLogDivergence", "AcknowledgedWritesExistOnMajority",
                "NoAppStateDivergence", "CommitNumberMatchesAppState"):
        assert bool(getattr(kern, kern.INVARIANT_FNS[inv])(st)[0]), inv
        assert bool(want[names.index(inv)][0]), inv
    # the raw forms: NoLogDivergence on the logs, and v1 found in one
    # replica's log where OpOf finds it in two (a majority)
    raw = psk.ST03Kernel
    assert not bool(raw.inv_no_log_divergence(kern, st)[0])
    assert int(raw._replica_has_op(kern, st)[0, :, 0].sum()) == 1
    assert int(kern._replica_has_op(st)[0, :, 0].sum()) == 2
    one = {k: v[c] for k, v in case.batch.items()}
    assert not bool(JST03Kernel.inv_no_log_divergence(J.jk, one))
    assert int(np.asarray(JST03Kernel._replica_has_op(J.jk, one))[:, 0]
               .sum()) == 1
    assert int(np.asarray(J.jk._replica_has_op(one))[:, 0].sum()) == 2


def _nonce_run(depth):
    """The port's run() of the small cfg to ``depth`` with no invariant,
    and the largest recovery nonce (rec_number, RecoveryMsg x) over the
    enabled successors of each level."""
    b = binding(MODEL, MODEL.small, 0)
    b.invariants = []
    eng = DeviceBFS(b, tile_size=64, chunk_tiles=8, fpset_capacity=1 << 15,
                    next_capacity=1 << 12, device="cpu")
    kern = eng.kern
    seen = []
    orig = kern.successors

    def succs(flat, pidx, aid, lane, mask, out=None, halt=None):
        o = orig(flat, pidx, aid, lane, mask, out, halt)
        st = kern.pk.unflatten(o["succ"][o["en2"]])
        if st["view"].shape[0]:
            x = torch.where((st["m_present"] == 1)
                            & (st["m_hdr"][:, :, H_TYPE] == M_RECOVERY),
                            st["m_hdr"][:, :, H_X], 0)
            seen.append(max(int(st["rec_number"].max()), int(x.max())))
        return o
    kern.successors = succs
    res = eng.run(max_depth=depth)
    return res, max(seen)


def test_the_nonce_stays_within_its_bound():
    """CP06 keeps the widths pass's nonce bound (1 + CrashLimit): it is
    not in NONCE_UNBOUNDED, the pack bounds rec_number, aux_restart and
    the H_X column by it, and the small cfg's run to depth 12 (where the
    record's first recoveries complete) mints no nonce above CrashLimit,
    the largest the JAX-kernel host BFS meets to the fixpoint
    (``record``)."""
    assert MODEL.module not in NONCE_UNBOUNDED
    case = family_case(KEY, "small", _cp_rows)
    crash = case.kern.crash_limit
    rng = derive_ranges_from(case.kern.codec.constants, MODEL.module)
    assert rng["recovery_nonce"] == (0, 1 + crash)
    pk = case.kern.pk
    bits = {k: int(pk._bits[a]) for k, _s, a, _e in pk._splits}
    assert bits["rec_number"] == bits["aux_restart"] == 2
    res, nonce = _nonce_run(12)
    assert res.ok and res.levels[:8] == MODEL.bfs["small"][2]
    assert nonce == crash


# ----------------------------------------------------------------------
# the records (run as a script)
# ----------------------------------------------------------------------
def _records(argv):
    import time
    t0 = time.time()
    if argv[0] == "wide":
        print(level_bfs(jax_fns(KEY, "wide"), int(argv[1])),
              f"{time.time() - t0:.1f}s", flush=True)
        return
    depth = int(argv[1])
    J = jax_fns(KEY, "record:small")
    gen, nonce = [1], []

    def on_level(states, n_en):
        gen.append(gen[-1] + n_en)
        x = [max(int(s["rec_number"].max()), int(np.where(
            (s["m_present"] == 1) & (s["m_hdr"][:, H_TYPE] == M_RECOVERY),
            s["m_hdr"][:, H_X], 0).max())) for s in states]
        nonce.append(max([nonce[-1] if nonce else 0] + x))
        print(f"depth {len(gen) - 1}: level {len(states)} generated "
              f"{gen[-1]} nonce {nonce[-1]} t {time.time() - t0:.0f}s",
              flush=True)
    levels = level_bfs(J, depth, on_level)
    print("levels", levels)
    print("generated", gen)
    print("largest nonce by depth", nonce, f"{time.time() - t0:.1f}s",
          flush=True)


if __name__ == "__main__":
    # python tests/test_torch_cp06.py record DEPTH | wide DEPTH
    _records(sys.argv[1:])
