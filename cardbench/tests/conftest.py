"""The benchmark's own tests: ``python -m pytest cardbench/tests -q`` from the
repository root.  Tests marked ``cuda`` need a card and skip without one;
the fixture ``cuda_card`` decides, never an import."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason where there is none")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
