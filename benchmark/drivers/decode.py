"""The receiver's traffic: captures already on the card, decoded through the
device composition that `IqReceiver` uses for a cs8 stream: per field, the
oscillator span built by the port's receiver, `device_eq_step` (the fast
tier) on the field's window, then `Decoder.decode` (hard) or
`SoftDecoder.decode` (soft), whose TS arrive in host memory. One field in
flight (closed loop).

The capture is made in set-up by the plain reference encoder, not by the
program: `segment_fields` consecutive fields of B channels of seeded TS from
a cold encoder, seeded AWGN at `snr_db` (none when null) over the signal's
mean power, quantized to cs8 as the transmitter quantizes. Field k's window
(stream [kN - K, kN - K + L), as `eq_window_bounds` gives it) is a
contiguous view of the capture. Each segment is decoded from a cold
decoder; its first output, the pre-start field, is dropped as
`IqReceiver` drops it (its RS counters rolled back).

Traffic keys: segment_fields, snr_db, trellis ("hard" | "soft"),
warmup_fields, trace_fields, sample_fields, limits.

Checked, on a seeded sample of the window's emitted fields:
the TS against the TS sent, and the equalizer's output against the float64
reference equalizer's on the same window (hard: the share of its symbol
decisions that differ from the reference's slices; soft: the gaps of its
levels); over the whole window, the decoder's uncorrectable segment count.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from harness import Sampler
from reference import equalizer as E
from reference import tables as T
from reference.encoder import RefEncoder, modulate, quantize_cs8


class State:
    pass


def _bounds() -> tuple[int, int]:
    from atsc_tpu_torch.models.receiver import eq_window_bounds

    return eq_window_bounds("auto")


def _ts(ctx, gen: torch.Generator, fields: int) -> torch.Tensor:
    ts = torch.randint(0, 256, (fields, ctx.batch, T.FIELD_TS_BYTES), generator=gen,
                       dtype=torch.uint8, device=ctx.device)
    ts[:, :, ::T.MPEG2_BYTES] = 0x47
    return ts


def inputs(ctx) -> State:
    """The seeded capture, as (F, B, 2, L) int8 windows on the device."""
    st = State()
    tr = ctx.traffic
    f = int(tr["segment_fields"])
    lo, wl = _bounds()
    st.lo, st.wl, st.f = lo, wl, f
    st.eq_k = int(ctx.config["eq_support"])
    gen = torch.Generator(ctx.device).manual_seed(ctx.seed)
    ts = _ts(ctx, gen, f + 1)           # field f gives the last window its right context
    ref = RefEncoder(ctx.batch, ctx.device)
    st.capture = torch.empty((f, ctx.batch, 2, wl), dtype=torch.int8, device=ctx.device)
    prev = torch.zeros((ctx.batch, 2, T.N), dtype=torch.int8, device=ctx.device)
    sigma = None
    for k in range(f + 1):
        x = modulate(ref.step(ts[k]), k)
        if tr.get("snr_db") is not None:
            if sigma is None:
                p_sig = float(x.pow(2).sum(dim=1).mean())
                sigma = (p_sig / 10 ** (float(tr["snr_db"]) / 10) / 2) ** 0.5
            x += torch.randn(x.shape, generator=gen, dtype=torch.float32,
                             device=ctx.device).to(torch.float64) * sigma
        codes = quantize_cs8(x)
        del x
        if k < f:
            st.capture[k, :, :, :-lo] = prev[:, :, T.N + lo:]
            st.capture[k, :, :, -lo:-lo + T.N] = codes
        if k >= 1:
            st.capture[k - 1, :, :, -lo + T.N:] = codes[:, :, :wl + lo - T.N]
        prev = codes
    del ts, ref, prev
    st.sampler = Sampler(int(tr["sample_fields"]), ctx.seed)
    st.emitted = st.failed = 0
    st.corrected = st.uncorrectable = 0
    st.dec = None
    return st


def _program(ctx):
    from atsc_tpu_torch.models.decoder import Decoder, SoftDecoder
    from atsc_tpu_torch.models.receiver import _osc_planar, device_eq_step
    from atsc_tpu_torch.ops.quantize import quantize_scale

    soft = ctx.traffic["trellis"] == "soft"
    step = device_eq_step(soft, 1.0 / quantize_scale("cs8"))
    new = (lambda: SoftDecoder(batch=ctx.batch, device=ctx.device)) if soft else (
        lambda: Decoder(batch=ctx.batch, device=ctx.device))
    return step, new, _osc_planar


def _field(ctx, st: State, dec, k: int):
    """Window k of the capture through the program: (ts, n_errors, eq out).
    The oscillator span is built as `IqReceiver` builds it, per field."""
    g0 = k * T.N
    with ctx.span("osc"):
        osc = torch.from_numpy(st.osc(g0 + st.lo, g0 + st.lo + st.wl, 0)).to(ctx.device)
    with ctx.span("eq"):
        lev = st.eq(st.capture[k], osc)
    with ctx.span("decode"):
        ts, nerr = dec.decode(lev)
    return ts, nerr, lev


def setup(ctx) -> State:
    st = inputs(ctx)
    ctx.mark("capture on the card")
    st.eq, st.new_decoder, st.osc = _program(ctx)
    dec = st.new_decoder()
    ctx.mark("program built")
    for k in range(int(ctx.traffic["warmup_fields"])):
        _field(ctx, st, dec, k % st.f)
    ctx.sync()
    ctx.mark("warmed up")
    return st


def _close_decoder(st: State) -> None:
    if st.dec is not None:
        st.corrected += st.dec.segments_corrected
        st.uncorrectable += st.dec.segments_uncorrectable
        st.dec = None


def step(ctx, st: State, i: int) -> None:
    seg, k = divmod(i, st.f)
    if k == 0:
        _close_decoder(st)
        st.dec = st.new_decoder()
        before = (st.dec.segments_corrected, st.dec.segments_uncorrectable)
    ts, nerr, lev = _field(ctx, st, st.dec, k)
    if k == 0:   # the pre-start field: dropped, its counts rolled back
        st.dec.segments_corrected, st.dec.segments_uncorrectable = before
        return
    st.emitted += 1
    st.failed += int((nerr < 0).any(axis=1).sum())
    st.sampler.offer((seg, k), lambda: (ts, lev))


def counts(ctx, st, window) -> tuple[int, int]:
    return ctx.batch * st.emitted, st.failed


def rates(ctx, st, window) -> dict:
    return {"rx_channels": ctx.batch * st.emitted / window.seconds_used / T.FIELD_RATE}


def shape(ctx) -> dict:
    return {"batch": ctx.batch, "soft": ctx.traffic["trellis"] == "soft",
            "eq_k": int(ctx.config["eq_support"]), "win_bytes": 1}


def release(ctx, st: State) -> None:
    _close_decoder(st)
    st.eq = st.new_decoder = st.osc = None


def _sent(ctx, st: State, keys) -> dict:
    """The TS sent in the windows `keys` (window k emits field k - 1),
    replayed from the seed as `inputs` drew it."""
    ts = _ts(ctx, torch.Generator(ctx.device).manual_seed(ctx.seed), st.f + 1)
    return {k: ts[k - 1] for k in keys}


def numbers(ctx, st: State, answers: list) -> list[tuple[str, float, float]]:
    """answers: [(k, (ts or None, eq output))] of windows k (k >= 1)."""
    lim = ctx.traffic["limits"]
    out = []
    if all(ts is not None for _, (ts, _) in answers):
        ts_sent = _sent(ctx, st, {k for k, _ in answers})
        bad = sum(int((torch.from_numpy(np.ascontiguousarray(ts)).to(ctx.device)
                       != ts_sent[k]).sum()) for k, (ts, _) in answers)
        out += [("ts_bad_bytes", float(bad), lim["ts_bad_bytes"]),
                ("uncorrectable", float(st.uncorrectable), lim["uncorrectable"])]
    dq = 1.0 / float(T.cs8_scale())
    if ctx.traffic["trellis"] == "hard":
        off = total = 0
        for k, (_, sym) in answers:
            r = E.slice_symbols(E.levels(st.capture[k], k * T.N, st.eq_k, dq))
            off += int((sym.to(ctx.device) != r).sum())
            total += r.numel()
        return out + [("eq_slice_off_share", off / total, lim["eq_slice_off_share"])]
    sq = n = 0.0
    worst = 0.0
    for k, (_, lev) in answers:
        r = E.levels(st.capture[k], k * T.N, st.eq_k, dq)
        d = lev.to(ctx.device, torch.float64) - r
        sq += float(d.pow(2).sum())
        n += d.numel()
        worst = max(worst, float(d.abs().max()))
    return out + [("eq_rms_gap", (sq / n) ** 0.5, lim["eq_rms_gap"]),
                  ("eq_max_gap", worst, lim["eq_max_gap"])]


def check(ctx, st: State) -> list[tuple[str, float, float]]:
    print(f"segments corrected {st.corrected}, uncorrectable {st.uncorrectable}",
          file=sys.stderr)
    return numbers(ctx, st, [(k, answer) for (_, k), answer in st.sampler.items()])


def control(ctx, st: State, keys, precision: str):
    """The reference equalizer in the program's place, its operands rounded
    to `precision`: its levels (soft) or their slices (hard)."""
    dq = 1.0 / float(T.cs8_scale())
    out = []
    for k in sorted(keys):
        lev = E.levels(st.capture[k], k * T.N, st.eq_k, dq, precision)
        out.append((k, (None, E.slice_symbols(lev) if ctx.traffic["trellis"] == "hard" else lev)))
    return out
