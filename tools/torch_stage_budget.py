#!/usr/bin/env python3
"""Per-stage device time of atsc_tpu_torch's encode and receive paths, and
of `analyze`, on one CUDA GPU.

    python3 tools/torch_stage_budget.py [--batch 384] [--trace trace.json]

Transmit: times each stage of encode_field alone with CUDA events (warm,
its input made by the stage before it), then the whole encode_field per
output format, then traces three whole cf32 fields with torch.profiler:
device time by kernel and the device's busy share of the traced window.
Receive: the same for the hard-decision receive step (eq_fir kernel, fast
profile, on a cf32 / cs16 / cs8 window of a clean loopback field;
decommutate; trellis decode; round-major relayout + deinterleave;
syndromes; derandomize), the composed step per window format, and a trace
of three composed cf32 steps. Then the same for the other receive steps of
the same field (the counterparts of tools/rx_stage_budget.py's probes):
soft (cf32 window), soft-i8 (cs8 window) and NTSC comb (eq soft levels,
[comb], decommutate, the Viterbi search (forward and traceback kernels,
bit packing), the RS stage of relayout + deinterleave + syndromes,
derandomize); adaptive and
adaptive-dd (the trained equalizer's step, decode_field, derandomize); zf
+ RS erasures with an impulse burst in the window (eq, burst detector,
slice, decode_field, flag propagation, erasure corrector, derandomize).
Each: its stages alone, the composed step, and a trace of three composed
steps with device time by kernel and the busy share.

Last, `analyze` (cli._analyze_iq) stage by stage on the host clock, each
device stage waited for: impulse blanking, both field-sync searches, the
SRO estimate, the resampler (timed on the channel whether or not the SRO
gate calls it), the CFO estimate and derotation, the zf or adaptive MER
field, and the burst and NTSC triage; on one clean channel (4 fields, as
`analyze cap.iq`) and on a B=23 FDM band (UHF channels 14-36 at 138 MS/s,
as `analyze band.iq --demux 23 --fields 3`: the demux, then every slot),
beside the whole `_analyze_iq` per channel. One JSON line per
measurement; the card's name and power limit (nvidia-smi) come first.
Needs a CUDA device and fails without one.
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

from atsc_tpu_torch import cli  # noqa: E402
from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.models.decoder import (  # noqa: E402
    _rs_stage,
    decode_field,
    init_decoder_state,
    init_ntsc_decoder_state,
    init_soft_decoder_state,
    ntsc_decode_field,
    soft_decode_field,
)
from atsc_tpu_torch.models.encoder import (  # noqa: E402
    Encoder,
    encode_field,
    init_state,
    iq_to_complex,
)
from atsc_tpu_torch.models.receiver import (  # noqa: E402
    _osc_planar,
    device_eq_step,
    eq_window_bounds,
    equalize_field_device,
    estimate_cfo,
    estimate_sro,
    field_window,
    find_field_sync_iq,
    mer_db,
    resample_stream,
)
from atsc_tpu_torch.ops import adaptive_eq as ae  # noqa: E402
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
    propagate_erasure_flags,
    trellis_decode_field,
)
from atsc_tpu_torch.ops.erasures import burst_erasure_flags, burst_erasure_flags_dev  # noqa: E402
from atsc_tpu_torch.ops.mux import FdmDemuxer, FdmMuxer  # noqa: E402
from atsc_tpu_torch.ops.ntsc import comb_field, detect_ntsc, viterbi_pr_decode_field  # noqa: E402
from atsc_tpu_torch.ops.quantize import quantize_scale  # noqa: E402
from atsc_tpu_torch.ops.rs_decode import rs_correct_field_erasures, syndrome_field  # noqa: E402
from atsc_tpu_torch.ops.slicer import slice_symbols  # noqa: E402
from atsc_tpu_torch.ops.viterbi import viterbi_decode_field  # noqa: E402


REPS = 10  # timed calls per measurement, after 2 warm ones
# the impulse burst of chip_smoke.py phase 22: BURST_LEN samples of complex
# Gaussian noise x BURST_SCALE, BURST_AT samples into the field
BURST_AT, BURST_LEN, BURST_SCALE = 40_000, 3000, 6.0
BAND_SLOTS, BAND_FIELDS = 23, 5   # the analyze band: 138 MS/s, UHF 14-36


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
    m = ae.WINDOW_MARGIN
    windows = {}
    for fmt in ("cf32", "cs16", "cs8"):
        enc_state = init_state(b, device=dev)
        parts = []
        for _ in range(3):
            enc_state, iq = encode_field(enc_state, ts, fmt)
            parts.append(iq[..., :n])
        stream = torch.cat(parts, dim=-1)   # fields 0-2; field 1 is timed
        windows[fmt] = stream[..., n + lo_off : n + lo_off + wlen].contiguous()
        if fmt == "cf32":   # the adaptive equalizer's window of field 1
            awin = stream[..., n - m : 2 * n + m].contiguous()
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
    del rx_state, sym_rx, syms, bytes_enc, cur_il, codewords

    aosc = torch.tensor(_osc_planar(n - m, 2 * n + m, 0), device=dev)
    for tier, fmt in (("soft", "cf32"), ("soft-i8", "cs8"), ("ntsc", "cf32")):
        receive_tier(tier, soft_eq_step(tier, fmt), windows[fmt], osc, b, dev)
    for tier in ("adaptive", "adaptive-dd"):
        receive_adaptive(tier, awin, aosc, b, dev)
    receive_erasures(windows["cf32"], osc, -lo_off, b, dev)
    del windows, awin
    torch.cuda.empty_cache()
    analyze_budget(dev)
    return 0


def soft_eq_step(tier: str, fmt: str):
    """The eq step of a soft tier: soft levels (float32, or int8 codes for
    soft-i8) from a window of `fmt`."""
    dq = 1.0 if fmt == "cf32" else 1.0 / quantize_scale(fmt)
    return device_eq_step(True, dq, "fast", soft_q=tier == "soft-i8")


def report(path: str, stages: dict, step, b: int) -> None:
    """Each stage alone, the composed step, and a trace of three of them."""
    for name, fn in stages.items():
        emit(path=path, rx_stage=name, ms=event_ms(fn, REPS))
    ms = event_ms(step, REPS)
    emit(rx_whole=path, ms=ms, realtime_channels=b / (ms / 1e3 * P.FIELD_RATE))
    trace(step, path)


def receive_tier(tier: str, eq, win, osc, b: int, dev) -> None:
    """The soft, soft-i8 or NTSC receive step of one field at batch b."""
    ntsc = tier == "ntsc"
    state = (init_ntsc_decoder_state if ntsc else init_soft_decoder_state)(b, device=dev)
    decode = ntsc_decode_field if ntsc else soft_decode_field
    search = viterbi_pr_decode_field if ntsc else viterbi_decode_field
    lev = eq(win, osc)
    stages = {"eq": lambda: eq(win, osc)}
    if ntsc:
        stages["comb"] = lambda: comb_field(lev)
        lev = comb_field(lev)
    elif lev.dtype != torch.int8:
        lev = lev.to(torch.float32)
    stages["decommutate"] = lambda: decommutate_field(lev)
    obs = decommutate_field(lev)
    stages["viterbi"] = lambda: search(obs, state.z2_prev, state.metrics)
    bytes_enc = search(obs, state.z2_prev, state.metrics)[0]
    stages["rs_stage"] = lambda: _rs_stage(bytes_enc, state.prev_il)
    codewords = _rs_stage(bytes_enc, state.prev_il)[1]
    stages["derandomize"] = lambda: derandomize_field(codewords)
    report(tier, stages, lambda: derandomize_field(decode(state, eq(win, osc))[1]), b)


def receive_adaptive(tier: str, win, osc, b: int, dev) -> None:
    """The adaptive (or adaptive-dd) receive step of field 1 at batch b:
    train + solve + apply, decode_field, derandomize."""
    eq = ae.AdaptiveEqualizer(batch=b, apply_precision="default",
                              decision_directed=tier == "adaptive-dd", device=dev)
    sym = eq.process_field(win, osc, 1)
    state = init_decoder_state(b, device=dev)
    codewords = decode_field(state, sym)[1]
    stages = {"equalizer": lambda: eq.process_field(win, osc, 1),
              "decode_field": lambda: decode_field(state, sym),
              "derandomize": lambda: derandomize_field(codewords)}
    report(tier, stages, lambda: derandomize_field(
        decode_field(state, eq.process_field(win, osc, 1))[1]), b)


def receive_erasures(win, osc, at: int, b: int, dev) -> None:
    """The zf + RS erasure receive step of one field at batch b, with an
    impulse burst `at` + BURST_AT samples into the window in every channel."""
    gen = torch.Generator(dev).manual_seed(22)
    win = win.clone()
    s0 = at + BURST_AT
    win[..., s0 : s0 + BURST_LEN] += BURST_SCALE / 2 ** 0.5 * torch.randn(
        (b, 2, BURST_LEN), generator=gen, device=dev)
    eq = device_eq_step(True, 1.0, "fast")
    state = init_decoder_state(b, device=dev)
    carry = torch.zeros((b, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev)
    lev = eq(win, osc)
    flags = burst_erasure_flags_dev(lev)
    sym = slice_symbols(lev)
    _, cw, syn = decode_field(state, sym)
    cw_flags = propagate_erasure_flags(flags, carry)[0]

    def step():
        lv = eq(win, osc)
        fl = burst_erasure_flags_dev(lv)
        _, c, sy = decode_field(state, slice_symbols(lv))
        out, _ = rs_correct_field_erasures(c, sy, propagate_erasure_flags(fl, carry)[0])
        return derandomize_field(out)

    stages = {"eq": lambda: eq(win, osc),
              "detector": lambda: burst_erasure_flags_dev(lev),
              "slice": lambda: slice_symbols(lev),
              "decode_field": lambda: decode_field(state, sym),
              "flag_propagation": lambda: propagate_erasure_flags(flags, carry),
              "rs_erasures": lambda: rs_correct_field_erasures(cw, syn, cw_flags),
              "derandomize": lambda: derandomize_field(cw)}
    report("erasures", stages, step, b)


def _clock(times: dict, name: str, fn):
    """fn() on the host clock, the card waited for after it; the seconds
    add to times[name]."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0
    return out


def analyze_stages(iq: np.ndarray, force_adaptive: bool, resampled: bool, dev,
                   times: dict) -> None:
    """cli._analyze_iq's steps in its order, each on the host clock into
    `times` (seconds); the resampler is also timed where its gate does not
    call it ("resample_stream_if_gated")."""
    n = P.SYMBOLS_PER_FIELD
    rms = float(np.sqrt(np.mean(np.abs(iq) ** 2)))

    def blank():
        amp = np.abs(iq)
        nz = amp[amp > 0]
        base = max(float(np.median(nz)) if nz.size else 0.0, 0.25 * rms)
        hot = amp > 4.0 * base
        return np.where(hot, 0, iq) if hot.any() else iq

    iq = _clock(times, "blanking", blank)
    off, _ = _clock(times, "field_sync_1", lambda: find_field_sync_iq(iq))
    if iq.size - off >= int(2.2 * n):
        rate = _clock(times, "estimate_sro", lambda: float(estimate_sro(iq[off:])))
        resampled_iq = _clock(times, "resample_stream_if_gated",
                              lambda: resample_stream(iq, rate)[0])
        if abs((rate - 1.0) * 1e6) > (5.0 if resampled else 2.0):
            iq = resampled_iq
    cfo = _clock(times, "estimate_cfo", lambda: float(estimate_cfo(iq)))
    if abs(cfo) > 0.5:
        iq = _clock(times, "cfo_derotate", lambda: iq * np.exp(
            -2j * np.pi * cfo / P.SAMPLE_RATE * np.arange(iq.size)))
    off, parity = _clock(times, "field_sync_2", lambda: find_field_sync_iq(iq))
    lev, mer = None, None
    if off == 0 and parity == 0 and not force_adaptive:
        lev = _clock(times, "mer_zf", lambda: equalize_field_device(
            iq[None], 0, soft=True, device=dev).cpu().numpy())
        mer = float(mer_db(lev)[0])
    if mer is None or mer < 20.0:
        def adaptive():
            win, osc = field_window(iq[None], off, first_field=parity)
            return ae.AdaptiveEqualizer(batch=1, device=dev).process_field(
                win, osc, parity, soft=True).cpu().numpy()

        lev = _clock(times, "mer_adaptive", adaptive)
    _clock(times, "burst_triage", lambda: burst_erasure_flags(lev)[:, :n])
    _clock(times, "ntsc_triage", lambda: detect_ntsc(lev[:, :n]))


def analyze_budget(dev) -> None:
    """`analyze`'s stages on one clean channel and on a B=23 band."""
    n = P.SYMBOLS_PER_FIELD
    rng = np.random.default_rng(28)
    fields = 4   # analyze's default --fields

    ts = rng.integers(0, 256, size=(fields + 1, 1, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc = Encoder(batch=1, device=dev)
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k]))[0] for k in range(fields + 1)])
    iq = iq[: (fields + 1) * n + 2 * P.SYMBOLS_PER_SEGMENT]
    for _ in range(2):   # the first run warms the caches
        times: dict = {}
        analyze_stages(iq, False, False, dev, times)
        whole = _clock(times, "whole", lambda: cli._analyze_iq(iq, 3000.0, device=dev))
    emit(analyze="one_channel", fields=fields, samples=int(iq.size),
         whole_s=times.pop("whole"), stages_s=times, mer_method=whole["mer_method"],
         mer_db=whole["mer_db"])

    # the band: BAND_FIELDS fields of 23 channels multiplexed on the card,
    # the analyze grab of --fields 3 demultiplexed, then every slot
    b = BAND_SLOTS
    ts = rng.integers(0, 256, size=(BAND_FIELDS, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc, mux = Encoder(batch=b, device=dev), FdmMuxer(b, device=dev)
    band = np.concatenate([mux.push(enc.encode(ts[k])[..., :n]) for k in range(BAND_FIELDS)]
                          + [mux.flush()], axis=-1)
    demux = FdmDemuxer(b, device=dev)
    per_field_wb = int(np.ceil(n * demux.rate_hz / P.SAMPLE_RATE))
    grab = band[:, : (3 + 1) * per_field_wb + 8192]
    grab = (grab[0] + 1j * grab[1]).astype(np.complex64)
    del enc, mux, band
    times = {}
    bb = _clock(times, "demux", lambda: np.concatenate([demux.push(grab), demux.flush()],
                                                       axis=-1))
    whole_s, mers = [], []
    for s in range(b):
        analyze_stages(bb[s], True, True, dev, times)
        t0 = time.perf_counter()
        rep = cli._analyze_iq(bb[s], 3000.0, force_adaptive=True, resampled=True, device=dev)
        whole_s.append(time.perf_counter() - t0)
        mers.append(rep["mer_db"])
    emit(analyze="band", slots=b, band_mhz=6 * b, grab_samples=int(grab.size),
         stages_s=times, stages_s_per_slot={k: v / b for k, v in times.items()
                                           if k != "demux"},
         whole_s_per_slot=whole_s, whole_s_sum=sum(whole_s),
         mer_db_min=min(mers), mer_db_max=max(mers))


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
