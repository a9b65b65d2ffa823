"""Each cell's driver at B = 2 over a few fields on the CPU, with the
program's plain twins: the result line's keys and a true `correct`."""

from __future__ import annotations

import json

import pytest

import harness
import run
from conftest import CELLS, SMALL

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    cell = harness.Cell(name)
    out = run.execute(cell, 2**31 + 101, 1.0, False, device="cpu", max_fields=4,
                      overrides=SMALL)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in cell.metrics("end_to_end")}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


@pytest.mark.parametrize("name", ["pool384.tx", "pool384.rx_hard"])
def test_traced_run_reads_the_host_spans(name):
    """--trace 1 on the CPU: the profiler runs and the readers that find no
    device kernel stay silent (no 0 for a device number)."""
    cell = harness.Cell(name)
    out = run.execute(cell, 7, 1.0, True, device="cpu", max_fields=3, overrides=SMALL)
    assert out["correct"] is True
    assert set(out["metrics"]) <= {m["name"] for m in cell.metrics("per_layer")}
    assert not any(n.endswith("roofline.tx") or n.endswith("roofline.rx")
                   or n.startswith("device_idle") for n in out["metrics"])
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
