"""A fixture shared by the port's CPU test files: `from torch_threads
import one_torch_thread` makes it autouse in the importing module."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: the suite runs several
    worker processes on the host's cores, and PyTorch's default of a thread
    per core in each makes the small CPU ops of these models contend and
    run many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
