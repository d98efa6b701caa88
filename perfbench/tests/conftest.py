"""Settings of the benchmark's own tests (``python -m pytest perfbench/tests -q``).

Tests that need a CUDA card carry the ``cuda`` marker (the repository's
marker for such tests, registered here too so that these tests run on
their own) and decide inside the test, through the ``card`` fixture,
whether there is one.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where torch sees none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
