"""One intra-op thread for the port's CPU tests.

The tier-1 run puts six pytest workers on the host's cores. PyTorch's
default of one OpenMP thread a core in each worker oversubscribes the
host, and the threads' spin-waits around the many small operators of the
tiny models slowed the port's test files several times over: six of them
took 398 s on an 8-core host with six workers, and 104 s with one thread
a worker. Every port test file but the card's imports `one_torch_thread`,
an autouse fixture that runs the file's tests and module fixtures with
one intra-op thread and restores the count after the file (module scope,
so that a module fixture's computation and a test's run alike: a resumed
trajectory compared bit for bit with an uninterrupted one must sum in one
order); what the tests check is unchanged.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    """Run the block with one PyTorch intra-op thread, then restore the
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with one_thread():
        yield


def test_one_thread_sets_and_restores_the_count():
    assert torch.get_num_threads() == 1    # the autouse fixture's
    torch.set_num_threads(3)
    with one_thread():
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == 3
