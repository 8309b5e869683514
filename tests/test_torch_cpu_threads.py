"""Holds no tests: a fixture that the port's CPU test modules import, one
torch intra-op thread per test module. The tier-1 run shares the machine's
cores among several pytest workers; torch's default of one OpenMP thread
per core in every worker oversubscribes them, and its spinning threads then
slow every worker many times over. Results do not depend on the thread
count beyond f32 summation order, which the tests' tolerances cover."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
