"""Parity of the port's VR_APP_STATE (AS04) model with the JAX package's
on the CPU: the checks of tests/test_torch_a01.py (codec, guards, every
lane's successor, invariants, the three fingerprints, the host tables
of K13 and K14, and the BFS levels of ``run()`` and ``run_fused()``) on
AS04's cases, bit for bit (tolerance 0).

Besides Init and the walked rows, hand-built rows pin what shallow walks
never reach: DVC slot collisions.  On a walked row where a
ReceiveMatchingDVC lane is enabled, the receiver's slot for the sender
already holds a different DoViewChange record; that lane's successor
sets ``ERR_DVC_OVERFLOW`` in both packages, and ``run()`` and
``run_fused()`` started from such a row stop on it with the error JAX's
engines raise (``tpuvsr/engine/device_bfs.py:573-574``, ``:1984``)."""

import numpy as np
import pytest
import torch

from tests.test_torch_a01 import (
    check_bag_growth, check_bfs, check_codec_layout, check_covers,
    check_fingerprints, check_guard_matrix, check_incremental,
    check_invariants, check_pack_round_trip, check_parent_parts,
    check_plain_calls, check_round_trip, check_successors, check_tables,
    family_case, FAMILY, one_torch_thread)
from tpuvsr.models.as04_kernel import AS04Kernel as JAS04Kernel
from tpuvsr_torch.core.values import TLAError
from tpuvsr_torch.engine.device_bfs import DeviceBFS
from tpuvsr_torch.engine.spec import load_binding
from tpuvsr_torch.models import st03 as pst
from tpuvsr_torch.models.as04 import ERR_DVC_OVERFLOW

KEY = "AS04"


def _collision_rows(case, rows, n=4):
    """Walked rows with an enabled ReceiveMatchingDVC lane (a DVC from j
    to i in i's view), with slot [i, j] already holding a record from j
    that differs from the message in its last normal view."""
    kern = case.kern
    max_view = kern.shape.MAX_VIEW
    built = []
    for row in case.walked:
        h = row["m_hdr"]
        for k in range(kern.M):
            if not (row["m_present"][k] == 1 and row["m_count"][k] > 0
                    and h[k, pst.H_TYPE] == pst.M_DVC):
                continue
            i, j = h[k, pst.H_DEST] - 1, h[k, pst.H_SRC] - 1
            if not (row["status"][i] == pst.VIEWCHANGE
                    and h[k, pst.H_VIEW] == row["view"][i]
                    and row["no_prog"][i] == 0 and row["dvc"][i][j] == 0):
                continue
            t = {key: np.array(v) for key, v in row.items()}
            t["dvc"][i][j] = 1
            lnv = h[k, pst.H_LNV]
            t["dvc_lnv"][i][j] = lnv + 1 if lnv < max_view else lnv - 1
            t["dvc_op"][i][j] = h[k, pst.H_OP]
            t["dvc_commit"][i][j] = h[k, pst.H_COMMIT]
            t["dvc_log"][i][j] = row["m_log"][k]
            built.append(t)
            break
        if len(built) >= n:
            break
    assert built, "no walked row enables ReceiveMatchingDVC"
    return built


@pytest.fixture(scope="module", params=["small", "small_np1", "shipped"])
def case(request):
    return family_case(KEY, request.param,
                       _collision_rows if request.param == "small"
                       else None)


@pytest.mark.parametrize("name", list(FAMILY[KEY].cases))
def test_codec_layout_matches_jax(name):
    check_codec_layout(KEY, name)


def test_codec_round_trip_matches_jax(case):
    check_round_trip(case)


def test_pack_round_trip(case):
    check_pack_round_trip(case)


STATE_TRANSFER = ["SendGetState", "ReceiveGetState", "ReceiveNewState"]


def test_inputs_cover_the_actions(case):
    """As for ST03: with one value SendGetState (a Prepare two ops ahead)
    never fires, so the state-transfer era opens on the shipped
    constants only; NoProgressChange needs its limit."""
    off = [] if case.name == "shipped" else STATE_TRANSFER
    check_covers(case, off + ([] if case.name == "small_np1"
                              else ["NoProgressChange"]))
    assert case.info["era"] >= (4 if case.name == "shipped" else 0)


def test_guard_matrix_matches_jax(case):
    check_guard_matrix(case)


@pytest.mark.parametrize("action", JAS04Kernel.action_names)
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


def _collision_lanes(case):
    """(built row, lane) of each enabled ReceiveMatchingDVC lane on the
    collision rows."""
    kern = case.kern
    a = kern.action_names.index("ReceiveMatchingDVC")
    out = []
    for b in case.info["built"]:
        for c in np.nonzero((kern.lane_action == a)
                            & case.want["en2"][b])[0]:
            out.append((b, c))
    return out


def test_dvc_slot_collision_sets_the_error_flag():
    """The enabled ReceiveMatchingDVC successor of each collision row
    carries ERR_DVC_OVERFLOW in both packages (the successor parity test
    holds the rest of the row)."""
    case = family_case(KEY, "small", _collision_rows)
    lanes = _collision_lanes(case)
    assert lanes
    hit = 0
    for b, c in lanes:
        w, g = case.want["err"][b, c], case.got["err"][b, c]
        assert w == g
        hit += bool(g & ERR_DVC_OVERFLOW)
    assert hit >= len(case.info["built"])


@pytest.mark.parametrize("entry", ["run", "run_fused"])
def test_engines_stop_on_a_slot_collision(entry):
    """run() and run_fused() from a collision row stop at its first level
    with the JAX engines' slot-collision error, not a wrong count."""
    case = family_case(KEY, "small", _collision_rows)
    row = case.rows[case.info["built"][0]]
    b = load_binding(FAMILY[KEY].small, FAMILY[KEY].module)
    b.init = lambda codec: [row]
    eng = DeviceBFS(b, max_msgs=case.kern.M, tile_size=64, chunk_tiles=8,
                    fpset_capacity=1 << 12, next_capacity=1 << 10,
                    device="cpu")
    with pytest.raises(TLAError, match="slot collision"):
        getattr(eng, entry)(max_depth=2)


def test_app_plane_follows_commit():
    """On every enabled successor of every case the app plane holds the
    log's committed prefix and nothing past commit (AppendOps), as the
    codec's Len(app) = commit requires."""
    for name in FAMILY[KEY].cases:
        case = family_case(KEY, name, _collision_rows if name == "small"
                           else None)
        en = case.want["en2"] & (case.want["err"] == 0)
        app, commit = case.jsucc["app"][en], case.jsucc["commit"][en]
        pos = np.arange(app.shape[-1])
        past = pos[None, None, :] >= commit[:, :, None]
        assert not (app * past).any()
        got = case.kern.pk.unflatten(torch.as_tensor(case.got["succ"][en]))
        assert np.array_equal(got["app"].numpy(), app)


def test_tables_match_the_kernel_source():
    check_tables(KEY)


def test_plain_calls_are_counted():
    check_plain_calls(KEY)


@pytest.mark.parametrize("entry", ["run", "run_fused"])
@pytest.mark.parametrize("name", ["small", "shipped"])
def test_bfs_levels_match_jax(name, entry):
    check_bfs(KEY, name, entry)


def test_bag_growth_keeps_levels():
    check_bag_growth(KEY, "run_fused")
