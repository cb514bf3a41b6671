"""The parity tests of tests/test_torch_st03.py (the port's ST03 codec,
guards, successors, invariants and fingerprints against the JAX
package's, bit for bit) on the shipped cfg,
tpuvsr_torch/configs/VR_STATE_TRANSFER_shipped.cfg (Values={v1,v2},
StartViewOnTimerLimit=2), with NoProgressChangeLimit 0 and 1: the cases
where the state-transfer era opens (SendGetState, ReceiveGetState and
ReceiveNewState are enabled on their rows).  A file of its own so that
the two halves run side by side."""

import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_st03 import (  # noqa: F401  (the tests run here)
    _case, test_codec_round_trip_matches_jax, test_fingerprints_match_jax,
    test_guard_matrix_matches_jax, test_incremental_fingerprints_match_jax,
    test_inputs_cover_the_actions, test_invariants_match_jax,
    test_pack_round_trip, test_parent_parts_match_jax,
    test_successors_plain_matches_jax)


@pytest.fixture(scope="module", params=["shipped", "shipped_np1"])
def case(request):
    return _case(request.param)
