"""Shared fixtures of the port's CPU tests (``tests/test_torch_*.py``).

A test module takes ``one_thread`` by importing it:
``from torch_support import one_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for the module's tests, restored after: the suite
    runs in several processes at once, and torch's default of a thread per
    core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
