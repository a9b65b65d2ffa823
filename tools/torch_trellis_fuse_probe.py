#!/usr/bin/env python3
"""The 12-way trellis encoder as one kernel, on the PyTorch port: the
counterpart of tools/trellis_fuse_probe.py.

The port's trellis_encode_field (ops/trellis.py) is some 20 elementwise
int32 passes and three cumsums. atsc_tpu_torch/csrc/trellis_fused.cu does
the whole encoder in one pass: read the padded bytes once, one XOR scan,
write int8 symbols. Both output layouts are probed:

  interleaved - the kernel writes stream-order symbols (B, 12, 22016)
  planemajor  - the kernel writes (B, 12, 4, 5504); a transpose follows

Each line holds the layout's time to stream order (kernel plus the cut to
(B, 12, 21528), and the transpose for planemajor) and whether it equals
trellis_encode_field bit for bit; the last line times trellis_encode_field
itself. On a CUDA device the times are CUDA events; with --device cpu the
plain twin runs and the times are the host clock.

Usage: python tools/torch_trellis_fuse_probe.py [--batch 384] [--iters 30]
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
from atsc_tpu_torch.ops.cuda.trellis_fused import (  # noqa: E402
    PAD_BYTES,
    to_stream,
    trellis_fused,
)
from atsc_tpu_torch.ops.trellis import trellis_encode_field  # noqa: E402


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
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch

    rng = np.random.default_rng(0)
    nb = P.TRELLIS_BYTES_PER_ENCODER
    il = rng.integers(0, 256, size=(b, P.TRELLIS_ENCODERS, nb), dtype=np.uint8)
    il_pad = np.zeros((b, P.TRELLIS_ENCODERS, PAD_BYTES), np.uint8)
    il_pad[..., :nb] = il
    d, d1, d2 = (torch.tensor(rng.integers(0, 2, size=(b, P.TRELLIS_ENCODERS),
                                           dtype=np.int32), device=dev)
                 for _ in range(3))
    il, il_pad = torch.tensor(il, device=dev), torch.tensor(il_pad, device=dev)

    want = trellis_encode_field(il, d, d1, d2)[0]
    ok_all = True
    for interleaved in (True, False):
        name = "interleaved" if interleaved else "planemajor"
        try:
            def stream(lay=interleaved):
                return to_stream(trellis_fused(il_pad, d, d1, d2, interleaved=lay), lay)

            ok = bool(torch.equal(stream(), want))
            ms = mean_ms(stream, args.iters, dev)
            print(json.dumps({"layout": name, "ms_to_stream": ms, "bit_exact": ok}),
                  flush=True)
        except Exception as e:  # one line per layout, as the JAX probe prints
            ok = False
            print(json.dumps({"layout": name, "error": repr(e)[:400]}), flush=True)
        ok_all &= ok

    ms = mean_ms(lambda: trellis_encode_field(il, d, d1, d2)[0], args.iters, dev)
    print(json.dumps({"layout": "torch_reference", "ms_to_stream": ms}), flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
