"""Tests of the benchmark harness (run them with
`python -m pytest zkbench/tests -q` from the root of the repository).

Most run on the CPU.  Those marked `chip` need a CUDA card: they decide
in a fixture whether there is one, and skip without it."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda:0"
