"""The benchmark's own tests: CPU checks of the harness and the reference,
and card checks (marked ``cuda``) that skip where no card is present."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
