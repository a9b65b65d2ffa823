#!/usr/bin/env python3
"""Per-stage device time of atsc_tpu_torch's encode_field on one CUDA GPU.

    python3 tools/torch_stage_budget.py [--batch 384] [--trace trace.json]

Times each stage alone with CUDA events (warm, its input made by the stage
before it), then the whole encode_field per output format, then traces
three whole cf32 fields with torch.profiler: device time by kernel and the
device's busy share of the traced window. One JSON line per measurement;
the card's name and power limit (nvidia-smi) come first. Needs a CUDA
device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from atsc_tpu import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.models.encoder import encode_field, init_state  # noqa: E402
from atsc_tpu_torch.ops import (  # noqa: E402
    advance_phasor,
    assemble_field_structured,
    interleave_field_enc_major,
    randomize_field,
    rs_encode_field,
    trellis_encode_field,
)
from atsc_tpu_torch.ops.cuda.offset_fir import offset_fir_fused  # noqa: E402


REPS = 10  # timed calls per measurement, after 2 warm ones


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps back-to-back calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--trace", default=None,
                    help="write the profiler's chrome trace to this path")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[dev.index]
    emit(device=torch.cuda.get_device_name(dev), nvidia_smi=smi,
         torch=torch.__version__, batch=args.batch)

    b = args.batch
    rng = np.random.default_rng(0)
    ts_np = rng.integers(0, 256, size=(b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts_np[:, :: P.MPEG2_BYTES] = 0x47
    ts = torch.tensor(ts_np, device=dev)
    state, _ = encode_field(init_state(b, device=dev), ts)  # a non-zero prev_rs

    rand = randomize_field(ts)
    rs_flat = rs_encode_field(rand).reshape(b, -1)
    il = interleave_field_enc_major(rs_flat, state.prev_rs)
    sym = trellis_encode_field(il, state.trellis_d, state.trellis_d1,
                               state.trellis_d2)[0]
    field = assemble_field_structured(sym, state.parity, state.saved)[0]
    stages = {
        "randomize": lambda: randomize_field(ts),
        "rs_encode": lambda: rs_encode_field(rand),
        "interleave": lambda: interleave_field_enc_major(rs_flat, state.prev_rs),
        "trellis": lambda: trellis_encode_field(
            il, state.trellis_d, state.trellis_d1, state.trellis_d2),
        "assemble": lambda: assemble_field_structured(sym, state.parity, state.saved),
        "offset_fir_cf32": lambda: offset_fir_fused(field, state.phasor),
        "offset_fir_cs16": lambda: offset_fir_fused(field, state.phasor, "cs16"),
        "offset_fir_cs8_wire": lambda: offset_fir_fused(field, state.phasor, "cs8", True),
        "advance_phasor": lambda: advance_phasor(state.phasor),
    }
    for name, fn in stages.items():
        emit(stage=name, ms=event_ms(fn, REPS))
    for fmt, wire in (("cf32", False), ("cs16", False), ("cs8", True)):
        ms = event_ms(lambda: encode_field(state, ts, fmt, wire), REPS)
        emit(whole=fmt + ("_wire" if wire else ""), ms=ms,
             realtime_channels=b / (ms / 1e3 * P.FIELD_RATE))

    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        encode_field(state, ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            encode_field(state, ts)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    for us, key, count in rows[:25]:
        emit(kernel=key[:120], device_ms_per_field=us / 1e3 / 3, calls_per_field=count / 3)
    emit(traced_fields=3, window_ms=window_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / window_ms,
         kernels_per_field=sum(r[2] for r in rows) / 3)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
