#!/usr/bin/env python3
"""Per-stage device time of atsc_tpu_torch's encode and receive paths on
one CUDA GPU.

    python3 tools/torch_stage_budget.py [--batch 384] [--trace trace.json]

Transmit: times each stage of encode_field alone with CUDA events (warm,
its input made by the stage before it), then the whole encode_field per
output format, then traces three whole cf32 fields with torch.profiler:
device time by kernel and the device's busy share of the traced window.
Receive: the same for the hard-decision receive step (eq_fir kernel, fast
profile, on a cf32 / cs16 / cs8 window of a clean loopback field;
decommutate; trellis decode; round-major relayout + deinterleave;
syndromes; derandomize), the composed step per window format, and a trace
of three composed cf32 steps. One JSON line per measurement; the card's
name and power limit (nvidia-smi) come first. Needs a CUDA device and
fails without one.
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

from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.models.decoder import decode_field, init_decoder_state  # noqa: E402
from atsc_tpu_torch.models.encoder import encode_field, init_state  # noqa: E402
from atsc_tpu_torch.models.receiver import (  # noqa: E402
    _osc_planar,
    device_eq_step,
    eq_window_bounds,
)
from atsc_tpu_torch.ops import (  # noqa: E402
    advance_phasor,
    assemble_field_structured,
    interleave_field_enc_major,
    randomize_field,
    rs_encode_field,
    trellis_encode_field,
)
from atsc_tpu_torch.ops.cuda.offset_fir import offset_fir_fused  # noqa: E402
from atsc_tpu_torch.ops.decode import (  # noqa: E402
    decommutate_field,
    deinterleave_field,
    derandomize_field,
    enc_major_to_round_major,
    trellis_decode_field,
)
from atsc_tpu_torch.ops.quantize import quantize_scale  # noqa: E402
from atsc_tpu_torch.ops.rs_decode import syndrome_field  # noqa: E402


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

    prof = trace(lambda: encode_field(state, ts), "encode")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    del state, rand, rs_flat, il, sym, field

    # -- receive: the hard-decision step on a clean loopback field ------------
    n = P.SYMBOLS_PER_FIELD
    lo_off, wlen = eq_window_bounds("fast")
    windows = {}
    for fmt in ("cf32", "cs16", "cs8"):
        enc_state = init_state(b, device=dev)
        parts = []
        for _ in range(3):
            enc_state, iq = encode_field(enc_state, ts, fmt)
            parts.append(iq[..., :n])
        stream = torch.cat(parts, dim=-1)   # fields 0-2; field 1 is timed
        windows[fmt] = stream[..., n + lo_off : n + lo_off + wlen].contiguous()
        del parts, stream, enc_state
    osc = torch.tensor(_osc_planar(n + lo_off, n + lo_off + wlen, 0), device=dev)
    steps = {fmt: device_eq_step(False, 1.0 if fmt == "cf32" else 1.0 / quantize_scale(fmt),
                                 "fast") for fmt in windows}
    rx_state = init_decoder_state(b, device=dev)
    sym_rx = steps["cf32"](windows["cf32"], osc)
    rx_state, _, _ = decode_field(rx_state, sym_rx)    # a non-zero prev_il
    syms = decommutate_field(sym_rx)
    bytes_enc, _ = trellis_decode_field(syms, rx_state.z2_prev)
    cur_il = enc_major_to_round_major(bytes_enc)
    codewords = deinterleave_field(cur_il, rx_state.prev_il).reshape(
        b, P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES)
    rx_stages = {
        "eq_fir_cf32": lambda: steps["cf32"](windows["cf32"], osc),
        "eq_fir_cs16": lambda: steps["cs16"](windows["cs16"], osc),
        "eq_fir_cs8": lambda: steps["cs8"](windows["cs8"], osc),
        "decommutate": lambda: decommutate_field(sym_rx),
        "trellis_decode": lambda: trellis_decode_field(syms, rx_state.z2_prev),
        "deinterleave": lambda: deinterleave_field(
            enc_major_to_round_major(bytes_enc), rx_state.prev_il),
        "syndromes": lambda: syndrome_field(codewords),
        "derandomize": lambda: derandomize_field(codewords),
    }
    for name, fn in rx_stages.items():
        emit(rx_stage=name, ms=event_ms(fn, REPS))

    def rx_step(fmt: str):
        _, cw, _ = decode_field(rx_state, steps[fmt](windows[fmt], osc))
        return derandomize_field(cw)

    for fmt in windows:
        ms = event_ms(lambda: rx_step(fmt), REPS)
        emit(rx_whole=fmt, ms=ms, realtime_channels=b / (ms / 1e3 * P.FIELD_RATE))
    trace(lambda: rx_step("cf32"), "receive")
    return 0


def trace(step, path: str):
    """Trace three calls of step() with torch.profiler: device time by
    kernel, and the device's busy share of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
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
        emit(path=path, kernel=key[:120], device_ms_per_field=us / 1e3 / 3,
             calls_per_field=count / 3)
    emit(path=path, traced_fields=3, window_ms=window_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / window_ms,
         kernels_per_field=sum(r[2] for r in rows) / 3)
    return prof


if __name__ == "__main__":
    sys.exit(main())
