"""The benchmark's own tests: CPU tests of the harness, and tests marked
``cuda`` that skip without a card (run them on the card with
``python -m pytest benchmark/tests -p no:cacheprovider -n 0``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch
    torch.set_num_threads(2)     # several workers share the host's cores
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def require_cuda():
    """Skip the test without a CUDA device (decided in the test, never at
    import, so that every worker collects the same tests)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
