"""The benchmark's CPU tests: run from the checkout's root with
`python -m pytest portbench/tests`. Tests marked `cuda` need an NVIDIA
GPU and skip without one (decided inside the test, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def need_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the lower-precision control is "
                    "TF32, which only the card has)")
