"""Tests of the benchmark harness. Run from the repository's root:
`python -m pytest port_bench/tests`. Tests marked `cuda` need a card and
skip without one; the decision is made inside the `card` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
