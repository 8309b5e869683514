"""Tests of the benchmark harness. They run on the CPU at small sizes; a
test marked ``cuda`` needs a card and skips inside the test without one.
Run with ``python -m pytest benchmark/tests -q`` from the repository
root."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# several test processes share the host's cores
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips inside the test "
                   "without one")
