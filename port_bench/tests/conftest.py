"""The benchmark's own tests: ``pytest port_bench/tests`` from the repository root.

Tests marked ``card`` need an NVIDIA GPU; each decides inside its fixture
whether one is there and skips otherwise.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on a machine with one")
    return torch.device("cuda")
