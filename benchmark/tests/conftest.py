"""CPU tests of the benchmark (run them with `python -m pytest benchmark/tests`);
the tests marked `card` run a cell on a CUDA card and skip elsewhere:
`python -m pytest benchmark/tests -m card` on the card's machine."""

from __future__ import annotations

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

#: the traffic cut to a size the CPU holds: B = 2, 3-field segments
SMALL = {"batch": 2, "ring_fields": 4, "segment_fields": 3, "warmup_fields": 1,
         "sample_fields": 2}
CELLS = ("pool384.tx", "band23.tx_mux", "pool384.rx_soft", "pool384.rx_hard")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the card only")
    return torch.device("cuda", 0)
