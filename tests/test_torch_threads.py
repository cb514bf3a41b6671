"""The port's test modules share one fixture: torch on one thread.

The plain versions run small batches, where torch's intra-op thread pool
costs more than it gives, and the test workers share the cores (the
suite runs under six xdist workers: with torch's default of a thread a
core, a module's plain versions ran up to 50 times slower there than
alone).  A module that imports ``one_torch_thread`` runs its tests on one
thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a module's tests, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_torch_thread_is_in_force():
    """A module that imports the fixture runs its tests on one thread."""
    assert torch.get_num_threads() == 1
