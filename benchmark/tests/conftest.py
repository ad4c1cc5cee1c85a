"""The benchmark's own tests. Run them from the repository's root:

    python -m pytest -q benchmark/tests

Tests marked ``cuda`` need the card and skip elsewhere; the fixture
``cuda_device`` decides, when a test runs, never at import."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
