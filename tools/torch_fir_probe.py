#!/usr/bin/env python3
"""Design variants of the fused offset+FIR (cf32) on the PyTorch port,
head to head at B=384: the counterpart of tools/fir_probe.py.

  base           the port's offset_fir_fused (csrc/offset_fir.cu, the
                 direct 111-tap form)
  base_chunksN   the banded-matmul form (csrc/fir_variants.cu), each
                 operand modulated on its own, two K=128 products, with
                 2040/N output rows per block
  onedot         one K=256 product of [U[j] | U[j+1]] and [W_lo; W_hi]
  sharedmod      the shifted operand read from the same modulated tile
  combo(_chunks15)  sharedmod + onedot

One JSON line per run, {"variant", "ms", "max_err"}, max_err the largest
difference from the base line over the valid [0, 260416); the exit code is
1 when a run fails or differs by more than 2e-6. On a CUDA device
the times are CUDA events (TF32 matmuls off); with --device cpu the plain
twins run and the times are the host clock.

Usage: python tools/torch_fir_probe.py [--iters 30] [--batch 384]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.ops.cuda.fir_variants import run_variant  # noqa: E402
from atsc_tpu_torch.ops.cuda.offset_fir import offset_fir_fused  # noqa: E402

#: the JAX probe's runs: (line name, variant, nchunk); "base" is offset_fir_fused
RUNS = (
    ("base", None, None),
    ("base_chunks15", "base", 15),
    ("base_chunks17", "base", 17),
    ("onedot", "onedot", 5),
    ("sharedmod", "sharedmod", 5),
    ("combo", "combo", 5),
    ("combo_chunks15", "combo", 15),
)
TOL = 2e-6  # max_err allowed against base: float32 sums in another order


def mean_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean ms of fn() over iters calls after one warm call: CUDA events on
    a CUDA device, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b = args.batch

    rng = np.random.default_rng(0)
    field = torch.tensor(rng.integers(0, 8, size=(b, P.PADDED_SYMBOLS), dtype=np.int8),
                         device=dev)
    phasor = torch.tensor([[0.8, 0.6]], dtype=torch.float32, device=dev).repeat(b, 1)
    n = P.SYMBOLS_PER_FIELD

    want = None
    ok_all = True
    for name, variant, nchunk in RUNS:
        try:
            if variant is None:
                def fn():
                    return offset_fir_fused(field, phasor)
            else:
                def fn(v=variant, c=nchunk):
                    return run_variant(field, phasor, v, c)

            out = fn()[..., :n]
            if variant is None:
                want = out
            err = None if want is None else float((out - want).abs().max())
            ok_all &= err is not None and err <= TOL
            ms = mean_ms(fn, args.iters, dev)
            print(json.dumps({"variant": name, "ms": ms, "max_err": err}), flush=True)
        except Exception as e:  # one line per run, as the JAX probe prints
            ok_all = False
            print(json.dumps({"variant": name, "error": repr(e)[:300]}), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
