"""Shared fixtures of the benchmark's own tests (CPU, and ``cuda``-marked
ones that need a card and decide so inside the fixture)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


# sizes at which the CPU tests drive a cell: a pool of one tiny batch (two
# slots, or one capture) and a sample of all of it
TINY = {
    "standard.busy": {"traffic": {"batch": 2, "pool_batches": 1, "sample": 2}},
    "deep.weak": {"traffic": {"batch": 2, "pool_batches": 1, "sample": 2}},
    "standard.station": {"traffic": {"batch": 1, "sample": 1}},
}
