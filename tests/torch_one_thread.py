"""The port's test files' one-thread fixture: ``from torch_one_thread
import one_thread`` in a test file runs its tests, and its module-scoped
fixtures, on one intra-op thread. The suite runs several worker processes
on a few cores, where torch's thread pool spends its time waiting at
barriers on the many small ops of the port's CPU paths."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
