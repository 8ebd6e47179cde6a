"""Tests of the benchmark harness, on the CPU at a tiny size.

Each run of the harness goes to a subprocess working in a temporary copy
of `BENCHMARK.json` and `portbench/` that holds a tiny cell (`tiny_copy`),
with the port imported from this checkout.  Tests that need the card carry
the `cuda` marker and decide inside the test whether there is one.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
