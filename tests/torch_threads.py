"""One intra-op thread for the port's CPU tests.

The suite runs under ``pytest -n 6`` on a machine with few cores.  With
torch's default of one OpenMP thread per core, every worker's torch ops
fan out over all cores, and the workers' threads spin against one
another; the port's small eager ops gain nothing from the extra threads.
Each ``tests/test_torch_*.py`` imports this module-scoped autouse fixture,
which runs the module's tests on one thread and restores the count after.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
