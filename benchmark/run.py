#!/usr/bin/env python3
"""The benchmark of atsc_tpu_torch on one CUDA card: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration and traffic are
the files BENCHMARK.json names; its driver feeds the program field after
field, one field in flight, for --seconds seconds (--trace 0: the cell's
end-to-end metrics) or through a traced stretch of the traffic's
`trace_fields` fields (--trace 1: its per-layer metrics, with the device's
busy time and a breakdown). Then the answers of a seeded sample of the
window's fields are compared with the plain reference under
benchmark/reference, each number printed beside its limit. The last line of
standard output is the result as one JSON object. A machine without a CUDA
card, or with fewer cards than the cell asks for, gets no result and a
non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# load from one process with one host thread: no BLAS or OpenMP pool
# competes with the loop that feeds the card (set before numpy and torch load)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))   # the checkout's root: the program under test

import harness  # noqa: E402
from harness import Cell, Refused  # noqa: E402


class Ctx:
    """What a driver is given: the cell, the run's arguments, the device and
    the spans; `overrides` (tests only) shrink the traffic."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 overrides: dict | None = None):
        import devtrace

        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.config = cell.config
        self.traffic = dict(cell.traffic, **(overrides or {}))
        self.batch = int(self.traffic.get("batch", cell.config["channels"]))
        self.spans = devtrace.Spans(trace)
        self.t_start = time.perf_counter()

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        return self.spans.span(name)

    def mark(self, what: str) -> None:
        """A set-up phase's end, on standard error, in seconds from the start."""
        print(f"setup: {what} at {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device=None,
            t_start: float | None = None, max_fields: int | None = None,
            overrides: dict | None = None) -> dict:
    """One run of `cell`; returns the result line as a dict (checks last)."""
    import torch

    import devtrace

    torch.set_num_threads(1)
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = Ctx(cell, seed, seconds, trace, device, overrides)
    ctx.t_start = t_start
    driver = cell.driver()
    print(f"setup: imports done at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - t_start
    if trace:
        window = harness.Window(None, int(ctx.traffic["trace_fields"]) if max_fields is None
                                else max_fields)
    else:
        window = harness.Window(seconds, max_fields)

    def step(i: int) -> None:
        with ctx.span("field"):
            driver.step(ctx, state, i)

    with devtrace.profiled(trace) as held:
        window.run(step)
    ctx.sync()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"memory_peak_bytes {peak}", file=sys.stderr, flush=True)
    found = harness.forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")
    attempted, failed = driver.counts(ctx, state, window)
    values = dict(driver.rates(ctx, state, window), setup_s=setup_s,
                  field_p95_ms=window.percentile_ms(95))
    print("field latency ms: " + " ".join(f"p{q} {window.percentile_ms(q):.3f}"
                                          for q in (50, 90, 95, 99, 100)), file=sys.stderr)
    driver.release(ctx, state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(ctx, state)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for _, v, lim in checks), "attempted": attempted,
           "failed": failed}
    if trace:
        view = held.view
        reading = Reading(ctx, view, window, driver.shape(ctx))
        metrics = {}
        for m in cell.metrics("per_layer"):
            mod = harness.load_module(os.path.join(cell.bench, "metrics", m["name"] + ".py"),
                                      "bench_metric_" + m["name"].replace(".", "_"))
            v = mod.read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = view.busy_s() if view is not None else 0.0
        dev_info["window_s"] = view.window_s if view is not None else window.seconds_used
        out["metrics"] = metrics
        out["device"] = dev_info
        if view is not None:
            out["breakdown"] = view.breakdown()
        print(f"traced {window.fields} fields; card {harness.power_limit()}; "
              f"{view.by_correlation if view else 0} of {len(view.ops) if view else 0} device "
              "operations placed by their launch", file=sys.stderr, flush=True)
    else:
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.metrics("end_to_end")}
        out["device"] = dev_info
    print(f"window {window.fields} fields in {window.seconds_used:.6f} s", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr, flush=True)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out


class Reading:
    """What a per-layer metric reads: the trace, the host spans, the number
    of traced fields and the cell's shapes."""

    def __init__(self, ctx: Ctx, view, window, shape: dict):
        self.trace = view
        self.host_s = ctx.spans.host_s
        self.fields = window.fields
        self.shape = shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        harness.require_cuda(cell.chips)
        out = execute(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except Refused as exc:
        print(f"benchmark: {exc}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
