"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them, with the reason, where torch sees no card.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no "
                    "interpret mode")
    return torch.device("cuda", 0)
