"""Parity of the port's VR_INC_RESEND (I01) model with the JAX package's
on the CPU: the checks of tests/test_torch_a01.py (codec, guards, every
lane's successor, invariants, the three fingerprints, the host tables
of K13 and K14, and the BFS levels of ``run()`` and ``run_fused()``) on
I01's cases, bit for bit (tolerance 0).

Besides Init and the walked rows, the hand-built rows pin what shallow
walks never reach: rows whose DVC tracker holds entries of mixed views,
grafted as tests/test_i01_kernel.py (:82-126) grafts them (a reachable
row with a tracker entry, plus an entry of another view from a source
the tracker lacks).  On them ``_highest_tracker`` (SendSV's CHOOSE over
the valid entries) and ReceivedDVCsAllSameView see a mixed tracker, and
the invariant fails where the replica is in a view change."""

import numpy as np
import pytest
import torch

from tests.test_torch_a01 import (
    _run, check_bag_growth, check_bfs, check_codec_layout, check_covers,
    check_fingerprints, check_guard_matrix, check_incremental,
    check_invariants, check_pack_round_trip, check_parent_parts,
    check_plain_calls, check_round_trip, check_successors, check_tables,
    family_case, FAMILY, one_torch_thread)
from tpuvsr_torch.models import st03 as pst
from tpuvsr.models.i01_kernel import I01Kernel as JI01Kernel

KEY = "I01"


def _mixed_tracker_rows(case, rows, n=8):
    """Walked rows with a tracker entry at replica i, plus an entry from a
    source the tracker lacks, one view above the first entry's (below
    it where that would leave the view's packing range), with an empty
    log, last normal view 1 and op and commit 0."""
    max_view = case.kern.shape.MAX_VIEW
    built = []
    for row in case.walked:
        for i in range(case.kern.R):
            have = np.nonzero(row["dvc"][i])[0]
            free = np.nonzero(row["dvc"][i] == 0)[0]
            if not len(have) or not len(free):
                continue
            v0 = int(row["dvc_view"][i][have[0]])
            t = {k: np.array(v) for k, v in row.items()}
            j = int(free[0])
            t["dvc"][i][j] = 1
            t["dvc_view"][i][j] = v0 + 1 if v0 < max_view else v0 - 1
            t["dvc_lnv"][i][j] = 1
            t["dvc_op"][i][j] = 0
            t["dvc_commit"][i][j] = 0
            t["dvc_log"][i][j] = 0
            built.append(t)
            break
        if len(built) >= n:
            break
    assert built, "no walked row holds a tracker entry"
    return built


@pytest.fixture(scope="module", params=["small", "small_np1", "shipped"])
def case(request):
    return family_case(KEY, request.param,
                       None if request.param == "small_np1"
                       else _mixed_tracker_rows)


@pytest.mark.parametrize("name", list(FAMILY[KEY].cases))
def test_codec_layout_matches_jax(name):
    check_codec_layout(KEY, name)


def test_codec_round_trip_matches_jax(case):
    check_round_trip(case)


def test_pack_round_trip(case):
    check_pack_round_trip(case)


def test_inputs_cover_the_actions(case):
    """ResendSVC needs a replica two views ahead of a peer (the peer's
    increment then answers in another view): the small cfg's fixpoint
    never enables it (0 expansions in the port's run() to the fixpoint),
    the shipped constants' rows do."""
    off = [] if case.name == "shipped" else ["ResendSVC"]
    check_covers(case, off + ([] if case.name == "small_np1"
                              else ["NoProgressChange"]))


def test_guard_matrix_matches_jax(case):
    check_guard_matrix(case)


@pytest.mark.parametrize("action", JI01Kernel.action_names)
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


@pytest.mark.parametrize("name", ["small", "shipped"])
def test_mixed_view_tracker(name):
    """The grafted rows hold mixed-view trackers: ReceivedDVCsAllSameView
    fails on one whose replica is in a view change (both packages say
    so); with the shipped constants (views up to 3) SendSV's CHOOSE runs
    over a mixed valid set on one."""
    case = family_case(KEY, name, _mixed_tracker_rows)
    kern = case.kern
    rows = case.info["built"]
    b = {k: v[rows] for k, v in case.batch.items()}
    st = {k: torch.as_tensor(v) for k, v in b.items()}
    pres = b["dvc"] == 1
    mixed = np.array([len(set(b["dvc_view"][r][i][pres[r][i]])) > 1
                      for r in range(len(rows)) for i in range(kern.R)])
    assert mixed.any()
    names = list(kern.INVARIANT_FNS)
    got = kern.inv_received_dvcs_all_same_view(st).numpy()
    want = _run(case.J.invs, b)[names.index("ReceivedDVCsAllSameView")]
    assert np.array_equal(got, want) and not got.all()
    a = kern.action_names.index("SendSV")
    en = case.got["en2"][rows][:, kern.lane_action == a]
    valid = (pres & (b["dvc_view"] >= b["view"][:, :, None]))
    views = [len(set(b["dvc_view"][r][i][valid[r][i]])) > 1
             for r in range(len(rows)) for i in range(kern.R)
             if en[r][i]]
    assert any(views) or name == "small", \
        "no SendSV lane over a mixed valid set"
    assert (b["status"] == pst.VIEWCHANGE).any()


def test_tables_match_the_kernel_source():
    check_tables(KEY)


def test_plain_calls_are_counted():
    check_plain_calls(KEY)


@pytest.mark.parametrize("entry", ["run", "run_fused"])
@pytest.mark.parametrize("name", ["small", "shipped"])
def test_bfs_levels_match_jax(name, entry):
    check_bfs(KEY, name, entry)


def test_bag_growth_keeps_levels():
    check_bag_growth(KEY, "run")
