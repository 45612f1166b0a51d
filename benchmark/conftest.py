"""Pytest settings of the benchmark's own tests (``benchmark/tests``).

Tests marked ``card`` need a CUDA card; each decides inside the
``card`` fixture, at run time, and skips on a machine without one.
Run them on the card with ``python3 -m pytest benchmark/tests -m card``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
