"""Shared fixture of the port's test modules (tests/test_torch_*.py).

The suite runs several test processes side by side, and PyTorch gives
each one an intra-op thread pool as wide as the machine: at the port
tests' small shapes those pools only contend with each other and with
the JAX tests next door.  Each port test module imports
``one_torch_thread`` (autouse) so its tests run single-threaded, and
passes :data:`CHILD_ENV` to the processes it starts.
"""

import os

import pytest
import torch

# environment for child interpreters the port tests start
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)
