"""Tests of the benchmark (run them with ``python -m pytest bench/tests``
from the root of the repository). A test that needs a CUDA card carries
the ``card`` marker and its ``card`` fixture skips it without one: the
decision is made inside the test, never at import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
