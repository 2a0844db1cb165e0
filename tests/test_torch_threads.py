"""One torch intra-op thread for each of the port's test modules.

Tier-1 runs six pytest worker processes on the host's cores. PyTorch's
default intra-op pool takes every core in each of them, and the pools then
spin against each other (ROADMAP records `test_torch_streamed.py` at 579 s
so and ~13-17 s with one thread); the port's tests use small tensors that
gain nothing from more threads. Each `tests/test_torch_*.py` imports
`one_torch_thread`, an autouse module fixture, which pins the pool to one
thread for the module and restores it after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
