"""A short run of every cell on the card, correct and with its end-to-end
metrics (skips without a CUDA card)."""

from __future__ import annotations

import pytest

import harness
import run
from conftest import CELLS


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = run.execute(harness.Cell(name), 12345, 2.0, False, device=card)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {m["name"] for m in harness.Cell(name).metrics("end_to_end")}
