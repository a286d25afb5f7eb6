"""The benchmark's own tests (not the repository's tier-1 suite):

    python3 -m pytest -q port_bench/tests

On the CPU the cases marked `cuda` skip; on the card they run."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where torch sees none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
