#!/usr/bin/env python3
"""The controls of the comparison that decides `correct`: the plain
reference, computed at the precision below the one the configuration
states, put in the program's place, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--precision P]

For each seed it makes the cell's inputs as a run does, draws the fields
to check as a run of `--fields` fields would, and prints the numbers that a
run compares, each beside its limit. The default precision is the cell's
`control` (workloads/<cell>.json): tf32 for the float32 transmitter and
multiplex, fp8 for the bf16 equalizer (its levels, and its hard
decisions). A control has done its job when `correct` is false.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import numpy as np  # noqa: E402

import harness  # noqa: E402
from run import Ctx  # noqa: E402


def keys_for(cell: harness.Cell, ctx: Ctx, fields: int) -> list[int]:
    """As many fields as a run checks, drawn from the seed among a run of
    `fields` fields (for the receiver: the emitted windows of a segment)."""
    n = int(ctx.traffic["sample_fields"])
    rng = np.random.default_rng([ctx.seed, 0xC0])
    pool = (np.arange(1, int(ctx.traffic["segment_fields"]))
            if cell.traffic["entry"] == "decode" else np.arange(fields))
    return sorted(int(k) for k in rng.choice(pool, size=min(n, pool.size), replace=False))


def control_run(cell: harness.Cell, seed: int, precision: str | None, fields: int,
                device, overrides: dict | None = None) -> dict:
    import torch

    ctx = Ctx(cell, seed, 0.0, False, torch.device(device), overrides)
    driver = cell.driver()
    st = driver.inputs(ctx)
    prec = precision or ctx.traffic["control"]
    keys = keys_for(cell, ctx, fields)
    numbers = driver.numbers(ctx, st, driver.control(ctx, st, keys, prec))
    return {"workload": cell.name, "seed": seed, "precision": prec, "fields": keys,
            "correct": all(v <= lim for _, v, lim in numbers),
            "numbers": {n: {"value": v, "limit": lim} for n, v, lim in numbers}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--precision", default=None)
    ap.add_argument("--fields", type=int, default=600,
                    help="the length of the run whose sample is drawn (transmit cells)")
    args = ap.parse_args(argv)
    try:
        cell = harness.Cell(args.workload)
        harness.require_cuda(cell.chips)
    except harness.Refused as exc:
        print(f"control: {exc}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_run(cell, seed, args.precision, args.fields, "cuda:0")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
