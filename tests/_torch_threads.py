"""The one-thread fixture of the port's tests. Imports no JAX, so the card
tests (`tests/test_torch_cuda.py`) use it as the CPU tests do."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for a module that imports this fixture: under
    the suite's parallel workers torch's default of a thread a core
    oversubscribes the machine, and its small ops then wait on each
    other's spinning threads (a train step ran ~45x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
