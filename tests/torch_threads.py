"""A module fixture for the port's CPU tests.  A test file takes it with

    from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

and pytest then runs it once around that file's tests."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread_and_warm_sqrt():
    """One intra-op thread while the module runs: its tensors are small,
    and several test processes that each spin up a thread pool per op
    slow one another down many times over.  Also take the first
    vectorized sqrt here: it has been seen to return a 12-bit
    approximation (relative error 3e-4 over one pool thread's chunk, in
    one process of ten), which a test that compares bits cannot take."""
    n = torch.get_num_threads()
    torch.sqrt(torch.rand(1 << 20))
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
