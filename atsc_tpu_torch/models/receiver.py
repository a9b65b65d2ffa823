"""IQ-domain 8VSB receiver: equalizer + field decoder.

Counterpart of atsc_tpu/models/receiver.py with all four equalizer
backends and every trellis tier: hard decisions, soft Viterbi on float32
levels or int8 soft-level codes, and NTSC comb rejection. It starts at the
transmitted complex baseband and recovers transport-stream bytes:

1. **Derotate** by the known oscillator (tables/oscillator.py, with the
   reference's float32-argument phase quirk and the per-field phasor
   drift). After derotation the chain is one stationary anti-causal
   complex-tap FIR.
2. **Zero forcing with conjugate combining** (backend "device", zf). The
   level sequence is real, so every spectral bin is observed twice,
   through C(f) and conj(C(-f)), and |C(f)|^2 + |C(-f)|^2 is flat by the
   RRC pair's root-Nyquist complementarity. The least-squares combiner
   (`_equalizer_dft`) has a compactly supported time response, so it
   collapses to two short real FIRs on the planar I/Q (`_wl_eq_taps`):
   lev = p (*) Re(u) + q (*) Im(u). The hand kernel csrc/eq_fir.cu
   (ops/cuda/eq_fir.py) derotates, filters and slices in one pass.
   Backend "numpy" is the same combiner in float64 on the host, by FFT
   (`equalize_span`), the high-precision reference path.
3. **Slice** to 3-bit symbols and feed models/decoder.py, whose RS stage
   absorbs residual or noise-induced symbol errors; or, with
   trellis="soft"/"soft-i8" or ntsc="comb"/"auto", keep the soft levels
   for the maximum-likelihood decoders (SoftDecoder, NtscDecoder).

For captures that passed through an unknown linear channel (multipath,
front-end ripple, complex gain/phase, DC offset) the zf inverse no longer
applies; backend="adaptive" trains a widely-linear least-squares equalizer
on the known sync symbols of every field (ops/adaptive_eq.py), and
"adaptive-dd" adds a decision-directed second pass. erasures="burst" runs
the slicer-residual burst detector (ops/erasures.py) on the equalized
levels and hands its flags to the decoder's errors-and-erasures RS tier.

Capture conditioning runs on the host in float64 numpy, as in the JAX
package, so both give the same offsets, parities, rates and Hz on the same
bytes: `find_field_sync_iq` locates a field boundary in a raw capture
(phase- and gain-robust PN511 correlation), `estimate_sro` measures the
sample-rate offset from sync-peak drift and `resample_stream` undoes it,
`estimate_cfo` reads the carrier offset off the pilot, and `CfoCorrector`
derotates a stream phase-continuously (retunable mid-stream).
`IqReceiver(resync="auto")` re-acquires the field boundary after an
unknown sample slip. `viterbi_chunks > 1` decodes the soft and NTSC
trellis tiers chunk-parallel (ops/viterbi.py).
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.decoder import Decoder, NtscDecoder, SoftDecoder
from atsc_tpu_torch.ops.adaptive_eq import AdaptiveEqualizer
from atsc_tpu_torch.ops.cuda.eq_fir import WIN_LEN, eq_fir_fused
from atsc_tpu_torch.ops.erasures import burst_erasure_flags_dev
from atsc_tpu_torch.ops.ntsc import detect_ntsc
from atsc_tpu_torch.ops.quantize import quantize_scale
from atsc_tpu_torch.ops.slicer import ideal_levels, slice_symbols
from atsc_tpu_torch.tables.oscillator import (
    oscillator_table,
    phase_increment,
    phasor_for_field,
)
from atsc_tpu_torch.tables.rrc import rrc_taps
from atsc_tpu_torch.tables.sync import sync_symbol_templates

_N = P.SYMBOLS_PER_FIELD
_MARGIN = 8192  # numpy backend: context per side of a field window (>> the
#                 ~112-sample effective equalizer span; FFT cost is negligible)
_EQ_K = 256                # one-sided support of the full equalizer taps
# samples past a field the receiver waits for before equalizing it (more
# than the K <= 256 samples of right context a window's FIR reads)
_DEV_MARGIN = 384


@functools.lru_cache(maxsize=4)
def _equalizer_dft(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(weights w_a, w_b) with LEV = w_a*U + w_b*conj(flip(U)) on an FFT
    grid of `length` bins (flip(X)[m] = X[-m mod L])."""
    taps = rrc_taps().astype(np.float64)
    ctil = taps * np.exp(1j * phase_increment() * np.arange(taps.size))
    # anti-causal FIR u[i] = sum_k h[k] x[i+k]  =>  U(f) = H(-f) X(f)
    a = np.conj(np.fft.fft(np.conj(ctil), length))
    b = _flip(np.conj(a))  # conj(A(-f)), the mirrored observation's gain
    den = np.abs(a) ** 2 + np.abs(b) ** 2
    return np.conj(a) / den, np.conj(b) / den


def _flip(x: np.ndarray) -> np.ndarray:
    """X(f) -> X(-f) on the DFT grid (last axis)."""
    return np.roll(x[..., ::-1], 1, axis=-1)


def _oscillator_for_span(g0: int, g1: int, first_field: int) -> np.ndarray:
    """Global quirky oscillator osc_g[g] = osc_table[g mod N] * phasor_k
    for stream samples [g0, g1) (g counted from field `first_field`'s
    start; negative g uses the pre-stream extrapolation)."""
    osc = oscillator_table().astype(np.complex128)[:_N]
    out = np.empty(g1 - g0, np.complex128)
    g = g0
    while g < g1:
        k, i = divmod(g, _N)  # floor div: negative g lands in field k<0
        n = min(g1 - g, _N - i)
        out[g - g0 : g - g0 + n] = osc[i : i + n] * phasor_for_field(
            first_field + k
        )
        g += n
    return out


def equalize_span(
    iq: np.ndarray, g0: int, first_field: int = 0, n_out: int = _N,
    margin: int = _MARGIN, stream_offset: int = 0,
) -> np.ndarray:
    """Recover `n_out` symbol levels starting at stream sample g0, in
    float64 on the host (the numpy backend).

    iq: (B, n_samples) complex baseband covering stream samples
    [stream_offset, stream_offset + n_samples); g0 is an absolute stream
    index (sample 0 = start of field `first_field`). Context missing at
    either edge is zero-filled (perturbs only ~112 boundary samples).
    Returns (B, n_out) float64 levels.
    """
    iq = np.atleast_2d(iq)
    g1 = g0 + n_out
    lo, hi = g0 - margin, g1 + margin
    avail_lo = max(lo, stream_offset)
    avail_hi = min(hi, stream_offset + iq.shape[1])
    win = np.zeros((iq.shape[0], hi - lo), np.complex128)
    if avail_hi > avail_lo:
        win[:, avail_lo - lo : avail_hi - lo] = iq[
            :, avail_lo - stream_offset : avail_hi - stream_offset
        ]
    osc = _oscillator_for_span(lo, hi, first_field)
    u = win * np.conj(osc) / (P.OSC_AMPLITUDE ** 2)

    w_a, w_b = _equalizer_dft(u.shape[1])
    uf = np.fft.fft(u, axis=-1)
    levf = w_a * uf + w_b * np.conj(_flip(uf))
    lev = np.real(np.fft.ifft(levf, axis=-1))
    return lev[:, margin : margin + n_out]


def slice_levels(levels: np.ndarray) -> np.ndarray:
    """Hard-decision levels -> (B, >=260416) int8 3-bit symbol values
    (host)."""
    sym = np.rint((levels - P.PILOT_OFFSET + 7.0) / 2.0)
    return np.clip(sym, 0, 7).astype(np.int8)


#: receive accuracy tiers: profile -> (one-sided tap support K, exact).
#: The taps decay geometrically: truncating at K=128 leaves a worst-case
#: level error ~0.03 against the 1.0 decision margin, and bf16 operands add
#: ~0.01-0.05. "exact" (K=256, fp32) is the golden-regression tier, "fast"
#: (K=128, bf16 operands / f32 sums) the production one.
EQ_PROFILES: dict[str, tuple[int, bool]] = {
    "exact": (256, True),
    "fast": (128, False),
}
DEFAULT_EQ_PROFILE = "fast"


@functools.lru_cache(maxsize=4)
def _wl_eq_taps(eq_k: int = _EQ_K) -> tuple[np.ndarray, np.ndarray]:
    """(p, q) float32 forward-FIR taps of length 2K+1: tap j applies to
    input sample i + j with the window already shifted by -K."""
    length = 1 << 16
    w_a, w_b = _equalizer_dft(length)
    ga = np.fft.ifft(w_a)  # lev = ga (*) u + gb (*) conj(u), circular
    gb = np.fft.ifft(w_b)
    p = np.real(ga) + np.real(gb)
    q = np.imag(gb) - np.imag(ga)
    # circular kernel -> linear taps: lev[i] = sum_k g[(-k) mod L] u[i+k]
    k = (eq_k - np.arange(2 * eq_k + 1)) % length
    return p[k].astype(np.float32), q[k].astype(np.float32)


def _profile(profile: str) -> tuple[int, bool]:
    key = DEFAULT_EQ_PROFILE if profile == "auto" else profile
    if key not in EQ_PROFILES:
        raise ValueError(f"unknown eq profile {profile!r}")
    return EQ_PROFILES[key]


def eq_window_bounds(profile: str = "auto") -> tuple[int, int]:
    """(lo_offset, length) of the equalizer's input window relative to the
    field's first stream sample g0: request stream[g0 + lo_offset,
    g0 + lo_offset + length) and the matching oscillator span. Always
    (-K, WIN_LEN): the window starts at the first sample the K-support FIR
    reads."""
    eq_k, _ = _profile(profile)
    return -eq_k, WIN_LEN


def device_eq_step(soft: bool = False, dequant: float = 1.0,
                   profile: str = "auto", soft_q: bool = False):
    """The equalizer step for windows shaped per eq_window_bounds(profile):
    (B, 2, WIN_LEN), (2, WIN_LEN) -> (B, 260416) int8 symbols / float32
    soft levels (soft_q=True: int8 soft-level codes at SOFT_LEVEL_SCALE),
    through the eq_fir kernel (its plain twin for CPU tensors)."""
    eq_k, exact = _profile(profile)
    return functools.partial(eq_fir_fused, eq_k=eq_k, soft=soft,
                             dequant=dequant, exact=exact, soft_q=soft_q)


def _osc_planar(lo: int, hi: int, first_field: int) -> np.ndarray:
    """(2, hi-lo) float32 planar oscillator for stream span [lo, hi)."""
    osc = _oscillator_for_span(lo, hi, first_field)
    return np.stack(
        [osc.real.astype(np.float32), osc.imag.astype(np.float32)]
    )


def field_window(
    iq: np.ndarray, g0: int, first_field: int = 0, stream_offset: int = 0,
    margin: int = _DEV_MARGIN, length: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Assemble one field's planar IQ window + matching oscillator span.

    Returns (win (B, 2, L) float32, osc (2, L) float32) covering stream
    samples [g0 - margin, g0 - margin + L) where L = length or
    N + 2*margin; context missing from `iq` at either edge is zero-filled.
    Pass margin/length from eq_window_bounds() to feed device_eq_step.
    """
    iq = np.atleast_2d(iq)
    lo = g0 - margin
    hi = lo + length if length is not None else g0 + _N + margin
    avail_lo = max(lo, stream_offset)
    avail_hi = min(hi, stream_offset + iq.shape[1])
    win = np.zeros((iq.shape[0], 2, hi - lo), np.float32)
    if avail_hi > avail_lo:
        src = iq[:, avail_lo - stream_offset : avail_hi - stream_offset]
        win[:, 0, avail_lo - lo : avail_hi - lo] = src.real
        win[:, 1, avail_lo - lo : avail_hi - lo] = src.imag
    return win, _osc_planar(lo, hi, first_field)


class _PlanarStream:
    """Chunked planar sample buffer for the streaming receiver (host).

    Chunks are converted to planar float32 once on append and windows are
    assembled with one bounded copy; nothing is ever re-concatenated. For
    quantized wire formats (cs16/cs8) the stream holds the integer codes
    verbatim (`dtype=int16/int8`, append_codes), so windows stay 2-4x
    smaller all the way onto the device; the equalizer kernel dequantizes.
    """

    def __init__(self, batch: int, dtype: np.dtype = np.float32):
        self.batch = batch
        self.dtype = np.dtype(dtype)
        self._chunks: list[np.ndarray] = []   # (B, 2, n) `dtype` each
        self._starts: list[int] = []          # stream index of chunk start
        self.base = 0   # trim watermark: reads below this are undefined
        self.end = 0    # one past the last buffered stream index

    def _check_batch(self, got: int) -> None:
        if got != self.batch:
            raise ValueError(
                f"pushed batch {got} != receiver batch {self.batch}"
            )

    def append(self, iq: np.ndarray) -> None:
        """iq: (B, n) or (n,) complex samples (float streams only)."""
        if self.dtype.kind != "f":
            raise ValueError("quantized stream wants push_codes(), "
                             "not complex samples")
        iq = np.atleast_2d(iq)
        self._check_batch(iq.shape[0])
        ch = np.empty((iq.shape[0], 2, iq.shape[1]), self.dtype)
        ch[:, 0] = iq.real
        ch[:, 1] = iq.imag
        self._chunks.append(ch)
        self._starts.append(self.end)
        self.end += iq.shape[1]

    def append_codes(self, codes: np.ndarray) -> None:
        """codes: (B, n, 2) or (n, 2) integer wire samples (I, Q last),
        dtype matching the stream exactly (no silent re-quantization)."""
        codes = np.asarray(codes)
        if codes.dtype != self.dtype:
            raise ValueError(
                f"codes dtype {codes.dtype} != stream dtype {self.dtype}"
            )
        if codes.ndim == 2:
            codes = codes[None]
        self._check_batch(codes.shape[0])
        ch = np.ascontiguousarray(codes.transpose(0, 2, 1))
        self._chunks.append(ch)
        self._starts.append(self.end)
        self.end += codes.shape[1]

    def append_zeros(self, n: int) -> None:
        """Insert n zero samples (a known-length gap in a live stream:
        keeps field tracking aligned; the span decodes as noise)."""
        if n <= 0:
            return
        self._chunks.append(np.zeros((self.batch, 2, n), self.dtype))
        self._starts.append(self.end)
        self.end += n

    def window(self, lo: int, hi: int) -> np.ndarray:
        """(B, 2, hi-lo) `dtype` covering stream span [lo, hi); samples
        outside the buffered range are zero."""
        out = np.zeros((self.batch, 2, hi - lo), self.dtype)
        for s, ch in zip(self._starts, self._chunks):
            e = s + ch.shape[-1]
            a, b = max(lo, s), min(hi, e)
            if b > a:
                out[:, :, a - lo : b - lo] = ch[:, :, a - s : b - s]
        return out

    def trim(self, keep_from: int) -> None:
        """Drop whole chunks entirely below stream index keep_from."""
        while (self._chunks
               and self._starts[0] + self._chunks[0].shape[-1] <= keep_from):
            self._starts.pop(0)
            self._chunks.pop(0)
        self.base = max(self.base, min(keep_from, self.end))


def equalize_field_device(
    iq: np.ndarray, g0: int, first_field: int = 0, stream_offset: int = 0,
    soft: bool = False, eq_profile: str = "auto", *,
    device: str | torch.device,
) -> torch.Tensor:
    """Equalize one field starting at stream sample g0 of the complex
    capture `iq` ((B, n), starting at stream sample stream_offset) on
    `device`: (B, 260416) int8 hard symbols, or float32 soft levels with
    soft=True, as a tensor on the device."""
    dev = resolve_device(device)
    lo_off, wlen = eq_window_bounds(eq_profile)
    win, osc = field_window(iq, g0, first_field, stream_offset,
                            margin=-lo_off, length=wlen)
    step = device_eq_step(soft, profile=eq_profile)
    return step(torch.from_numpy(win).to(dev), torch.from_numpy(osc).to(dev))


def _mer_components(levels) -> tuple[np.ndarray, np.ndarray]:
    """(B,) signal power and (B,) residual-to-nearest-symbol power of a
    soft level field (numpy, or a tensor on any device) in float64 on the
    host: the two accumulands of a running MER estimate."""
    if isinstance(levels, torch.Tensor):
        levels = levels[..., :_N].cpu().numpy()
    lev = np.asarray(levels, np.float64)[..., :_N]
    x = lev - P.PILOT_OFFSET
    ideal = np.clip(np.rint((x + 7) / 2) * 2 - 7, -7, 7)
    return np.mean(ideal**2, axis=-1), np.mean((x - ideal) ** 2, axis=-1)


def mer_db(levels) -> np.ndarray:
    """(B, >=260416) soft levels -> (B,) modulation error ratio in dB
    (signal power over residual-to-nearest-symbol power, the broadcast
    monitoring metric; ~15.2 dB is the 8VSB white-noise decode
    threshold)."""
    sig, err = _mer_components(levels)
    return 10 * np.log10(sig / np.maximum(err, 1e-30))


def _mer_components_dev(levels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of _mer_components: (B,) signal power and (B,)
    residual power reduced on the levels' device, in float32; only two
    scalars per channel come back to the host."""
    lev = levels[..., :_N].to(torch.float32)
    x = lev - P.PILOT_OFFSET
    ideal = ideal_levels(lev)
    return (ideal ** 2).mean(dim=-1), ((x - ideal) ** 2).mean(dim=-1)


# -- capture conditioning: host float64 numpy, the JAX package's arithmetic --


def find_field_sync(levels: np.ndarray) -> tuple[int, int]:
    """Locate a field boundary in an equalized level stream.

    levels: (n,) with n >= 2 fields. Returns (offset, parity): the stream
    index where a field starts, and that field's sync parity (the middle
    PN63's sign). Correlates against the zero-mean PN511+PN63 portion of
    the sync template (symbols 4..704, identical for both parities)."""
    probe = _sync_probe()
    x = np.asarray(levels, np.float64)
    # one field period of probe positions => exactly one sync occurrence
    corr = np.correlate(x[: _N + probe.size + 3], probe, mode="valid")
    offset = int(np.argmax(corr)) - 4
    if offset < 0:
        offset += _N
    # parity from the middle PN63 (symbols 578..640): inverted on odd fields
    template, _ = sync_symbol_templates()
    mid = x[offset + 578 : offset + 641]
    ref = template[0, 578:641].astype(np.float64) * 2.0 - 7.0
    parity = 0 if np.dot(mid - mid.mean(), ref - ref.mean()) > 0 else 1
    return offset, parity


def _ssb_levels(iq: np.ndarray, start: int, n_out: int,
                margin: int = 2048) -> np.ndarray:
    """Complex levels of the single-sideband equalizer branch alone,
    ifft(w_a * U), over capture samples [start, start + n_out): its PN
    correlation magnitude is invariant to any complex channel gain.
    Missing edge context is zero-filled; derotation treats capture sample
    0 as field 0's start (an epoch mismatch is a constant phase,
    irrelevant to |corr|)."""
    iq = np.atleast_2d(np.asarray(iq))[:1]
    lo, hi = start - margin, start + n_out + margin
    win = np.zeros((hi - lo,), np.complex128)
    a0, a1 = max(lo, 0), min(hi, iq.shape[1])
    if a1 > a0:
        win[a0 - lo : a1 - lo] = iq[0, a0:a1]
    u = win * np.conj(_oscillator_for_span(lo, hi, 0)) / (P.OSC_AMPLITUDE ** 2)
    w_a, _ = _equalizer_dft(u.shape[0])
    return np.fft.ifft(w_a * np.fft.fft(u))[margin : margin + n_out]


def _sync_probe() -> np.ndarray:
    """(700,) zero-mean known levels of field-sync symbols 4..704."""
    template, _ = sync_symbol_templates()
    probe = template[0, 4:704].astype(np.float64) * 2.0 - 7.0
    return probe - probe.mean()


def _corr_peak_refined(corr: np.ndarray, k: int) -> float:
    """Parabolic sub-sample refinement of |corr| around integer peak k."""
    if k <= 0 or k >= corr.size - 1:
        return float(k)
    a, b, c = np.abs(corr[k - 1 : k + 2])
    den = a - 2 * b + c
    return float(k + (0.5 * (a - c) / den if abs(den) > 1e-12 else 0.0))


def find_field_sync_iq(iq: np.ndarray) -> tuple[int, int]:
    """Locate a field boundary directly in a raw complex capture, robust
    to an unknown channel (gain, phase rotation, moderate multipath).

    Correlates the *complex* levels of the single-sideband branch
    (_ssb_levels) and resolves the parity by phase-referencing the
    middle-PN63 correlation to the PN511 peak (both see the same channel
    phase); a real-projection correlator nulls under a ~90 deg rotation.

    iq: (n,) or (B, n) complex samples, n >= one field + sync length;
    only the first stream is used. Returns (offset, parity): feed
    iq[offset:] to IqReceiver(first_field=parity, backend="adaptive").
    """
    n_probe = 704
    n_out = _N + n_probe + 3
    clev = _ssb_levels(iq, 0, n_out)

    probe = _sync_probe()
    corr = np.correlate(clev, probe, mode="valid")  # conjugates probe (real)
    corr = corr[: _N + 4]  # one field period => exactly one sync occurrence
    peak = int(np.argmax(np.abs(corr)))
    c0 = corr[peak]
    offset = peak - 4
    if offset < 0:
        offset += _N
    template, _ = sync_symbol_templates()
    mid = clev[offset + 578 : offset + 641]
    ref = template[0, 578:641].astype(np.float64) * 2.0 - 7.0
    m = np.dot(mid - mid.mean(), ref - ref.mean())
    parity = 0 if np.real(m * np.conj(c0)) > 0 else 1
    return offset, parity


def estimate_sro(iq: np.ndarray) -> float:
    """Estimate the capture's sample-rate offset from sync-peak drift.

    Correlates the PN511 sync in the first and in the last complete field
    of the capture (sub-sample peak positions by parabolic interpolation
    of |corr| on the single-sideband branch); their spacing over m fields
    gives the rate. iq: (n,) or (B, n) complex samples, n >= 2 fields.
    Returns `rate` = capture samples per nominal symbol-rate sample (1.0 =
    no offset, 1+20e-6 = capture clock 20 ppm fast); feed it to
    resample_stream.
    """
    iq = np.atleast_2d(np.asarray(iq))[:1]
    n_probe, slack = 704, 1024
    probe = _sync_probe()

    clev0 = _ssb_levels(iq, 0, _N + n_probe + 3)
    corr0 = np.correlate(clev0, probe, mode="valid")[: _N + 4]
    k0 = int(np.argmax(np.abs(corr0)))
    t0 = _corr_peak_refined(corr0, k0)            # sync at sample t0 - 4

    # farthest field whose sync window fits the capture (the first sync
    # may itself be up to a field in, e.g. a capture cut mid-field)
    m = (iq.shape[1] - int(t0) - n_probe - slack) // _N
    if m < 1:
        raise ValueError("estimate_sro needs at least 2 complete fields")
    # the same sync lands near t0 + m*N, drifted by (rate-1)*m*N; search
    # +-slack around it
    guess = int(round(t0)) + m * _N
    clevm = _ssb_levels(iq, guess - slack, n_probe + 2 * slack)
    corrm = np.correlate(clevm, probe, mode="valid")
    km = int(np.argmax(np.abs(corrm)))
    tm = _corr_peak_refined(corrm, km) + (guess - slack)
    return (tm - t0) / (m * _N)


def resample_stream(
    iq: np.ndarray, rate: float, taps: int = 32, phases: int = 512,
) -> np.ndarray:
    """Polyphase Kaiser-sinc resampling of a whole capture to the nominal
    rate, in float64 on the host.

    out[n] = iq(rate * n) via a `taps`-point windowed-sinc interpolator
    with `phases` fractional-delay phases (ops/resample.py streams the same
    interpolator). iq: (n,) or (B, n); returns (B, floor(n/rate) - taps)
    samples.
    """
    iq = np.atleast_2d(np.asarray(iq, np.complex128))
    half = taps // 2
    n_out = int((iq.shape[1] - taps - 2) / rate)
    pos = rate * np.arange(n_out) + half   # output n taps input at pos[n]
    # (the constant `half`-sample bulk delay is re-absorbed by alignment)
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    ph = np.minimum((frac * phases + 0.5).astype(np.int64), phases - 1)
    # kernel h[p, j] = kaiser(beta=10)-windowed sinc(j - (half-1) - p/phases)
    j = np.arange(taps)[None, :]
    t = j - (half - 1) - np.arange(phases)[:, None] / phases
    x = np.clip(t / (half + 1), -1.0, 1.0)
    h = np.sinc(t) * np.i0(10.0 * np.sqrt(1.0 - x * x)) / np.i0(10.0)
    h /= h.sum(axis=1, keepdims=True)
    out = np.zeros((iq.shape[0], n_out), np.complex128)
    for jj in range(taps):
        out += iq[:, base - (half - 1) + jj] * h[ph, jj]
    return out


def estimate_cfo(iq: np.ndarray, search_hz: float = 3000.0) -> float:
    """Estimate the capture's carrier frequency offset from the pilot.

    The 8VSB pilot is a strong coherent tone at a known baseband frequency
    (P.OSC_FREQUENCY); any tuner/clock offset moves it. Windowed-FFT peak
    search within +-search_hz of the nominal pilot, refined by quadratic
    interpolation of the log-magnitude.

    iq: (n,) or (B, n) complex samples (first stream used; >= ~1 field
    recommended). Returns the offset in Hz: multiply the capture by
    exp(-2j*pi*cfo*n/P.SAMPLE_RATE) to correct it.
    """
    x = np.asarray(np.atleast_2d(iq)[0], np.complex128)
    n = min(x.size, 4 * _N)
    x = x[:n] * np.hanning(n)
    spec = np.abs(np.fft.fft(x))
    freqs = np.fft.fftfreq(n, 1.0 / P.SAMPLE_RATE)
    nominal = P.OSC_FREQUENCY
    band = np.nonzero(np.abs(freqs - nominal) <= search_hz)[0]
    k = band[np.argmax(spec[band])]
    # quadratic interpolation on log|X| around the peak bin
    a, b, c = np.log(spec[[(k - 1) % n, k, (k + 1) % n]] + 1e-30)
    denom = a - 2 * b + c
    delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
    return float(freqs[k] + delta * P.SAMPLE_RATE / n - nominal)


class CfoCorrector:
    """Streaming e^{-j*2*pi*cfo*n/fs} derotation with an accumulated phase
    (host-side conditioning before the receiver). The phase is carried
    explicitly so the frequency can be *retuned* mid-stream
    phase-continuously: the CFO-tracking loop's update step. `phi` starts
    the accumulated phase (radians) at sample 0, e.g. one carried from a
    JAX CfoCorrector's `_phi`."""

    def __init__(self, cfo_hz: float, phi: float = 0.0):
        self.cfo_hz = float(cfo_hz)
        self._n = 0        # samples consumed
        self._phi = float(phi)  # accumulated phase at sample _n (radians)

    def _w(self) -> float:
        return -2.0 * np.pi * self.cfo_hz / P.SAMPLE_RATE

    def __call__(self, iq: np.ndarray) -> np.ndarray:
        iq = np.atleast_2d(iq)
        n = iq.shape[-1]
        if self.cfo_hz == 0.0 and self._phi == 0.0:
            self._n += n
            return iq
        w = self._w()
        rot = np.exp(1j * (self._phi + w * np.arange(n)))
        self._phi = (self._phi + w * n) % (2.0 * np.pi)
        self._n += n
        return iq * rot

    def skip(self, n: int) -> None:
        """Advance past n already-consumed samples (checkpoint resume)."""
        self._phi = (self._phi + self._w() * n) % (2.0 * np.pi)
        self._n += n

    def retune(self, cfo_hz: float) -> None:
        """Change the frequency phase-continuously at the current sample:
        downstream sees a frequency step but no phase jump (the adaptive
        equalizer re-trains through the step within one field)."""
        self.cfo_hz = float(cfo_hz)


#: equalizer profile -> apply precision of the adaptive equalizer's FIRs
_ADAPTIVE_PRECISION = {"exact": "highest", "fast": "default"}


class IqReceiver:
    """Streaming IQ -> TS: push complex baseband, collect decoded fields.

    backend: "device" (the zf inverse of the known TX chain through the
    eq_fir kernel — ideal channel), "numpy" (float64 host reference of the
    same), "adaptive" (per-field sync-trained widely-linear RLS — unknown
    linear channels; forgetting, ridge and the train_every retrain cadence
    as AdaptiveEqualizer takes them) or "adaptive-dd" (adaptive + a
    decision-directed second pass per field, ~1 dB more sensitivity near
    threshold). The numpy backend equalizes on the host; everything else
    runs on `device`.

    Assumes the stream begins at a field boundary with the oscillator
    epoch of `first_field`. Emits (ts (B, 58656) uint8, n_errors (B, 312)
    int32) host numpy per decoded field, with the decoder's one-field
    interleaver latency; the first (pre-start) output field is dropped
    internally, and its RS statistics are rolled back.

    trellis: "hard" slices the equalized levels; "soft" decodes float32
    levels by maximum likelihood (Viterbi); "soft-i8" the same on int8
    soft-level codes straight out of the equalizer kernel. ntsc: "comb"
    decodes through the 12-symbol comb and the 16-state partial-response
    Viterbi; "auto" lets the first field's levels vote per channel
    (detect_ntsc, `ntsc_votes`) and engages the comb (`ntsc_active`) when a
    majority wants it, warning on stderr when the channels disagree.
    erasures="burst": the slicer-residual burst detector flags the
    equalized levels and RS treats the flagged bytes as erasures
    (`decoder.segments_erasure_assisted` counts the segments it helped).
    wire_format cs16/cs8 (device backend only): push_codes() buffers the
    integer codes verbatim; the equalizer kernel dequantizes.
    measure_mer=True accumulates the MER of the equalized levels on the
    device.

    Fields are tracked by counting samples from the stream epoch, so a
    source that silently drops samples desynchronizes the decode.
    `notify_gap(n)` zero-fills a drop of known length. resync="auto"
    (adaptive backends only): once `resync_after` emitted fields in a row
    each have at least `resync_threshold` of their segments uncorrectable,
    the receiver stops decoding, re-locates the next field boundary in the
    buffered stream of channel 0 (find_field_sync_iq), re-bases every
    channel's epoch and parity there, and starts a fresh decoder (RS
    counters carried) and equalizer. Fields emitted between the slip and
    its detection are garbage; `resyncs` counts the events and
    `resync_log` records where they landed.
    """

    def __init__(self, batch: int = 1, first_field: int = 0,
                 margin: int | None = None, backend: str = "device",
                 forgetting: float = 1.0, ridge: float = 1e-4,
                 trellis: str = "hard", erasures: str | None = None,
                 wire_format: str = "cf32", eq_profile: str = "auto",
                 ntsc: str | None = None, viterbi_chunks: int = 1,
                 measure_mer: bool = False, resync: str | None = None,
                 resync_after: int = 2, resync_threshold: float = 0.5,
                 train_every: int = 1, *, device: str | torch.device):
        # the JAX package's validation, in its order
        if backend not in ("device", "numpy", "adaptive", "adaptive-dd"):
            raise ValueError(f"unknown equalizer backend {backend!r}")
        if eq_profile != "auto" and eq_profile not in EQ_PROFILES:
            raise ValueError(f"unknown eq profile {eq_profile!r}")
        if trellis not in ("hard", "soft", "soft-i8"):
            raise ValueError(f"unknown trellis mode {trellis!r}")
        if trellis == "soft-i8":
            # the quantized-levels tier moves int8 codes end to end; the
            # float-level consumers cannot read them
            if measure_mer or erasures is not None or ntsc is not None:
                raise ValueError("trellis='soft-i8' is the quantized "
                                 "throughput tier: incompatible with "
                                 "measure_mer/erasures/ntsc (they consume "
                                 "float levels) — use trellis='soft'")
            if backend != "device":
                raise ValueError("trellis='soft-i8' needs the device "
                                 "equalizer backend (the quantization "
                                 "happens in its kernel)")
        if erasures not in (None, "burst"):
            raise ValueError(f"unknown erasure mode {erasures!r}")
        if ntsc not in (None, "comb", "auto"):
            raise ValueError(f"unknown ntsc mode {ntsc!r}")
        if ntsc is not None and erasures is not None:
            raise ValueError("ntsc rejection and burst erasures are "
                             "mutually exclusive (the burst detector "
                             "assumes the plain 8-level slicer)")
        if wire_format not in ("cf32", "cs16", "cs8"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        if wire_format != "cf32" and backend != "device":
            raise ValueError("quantized wire input needs backend='device' "
                             "(dequantize on the host for other backends)")
        if resync not in (None, "auto"):
            raise ValueError(f"unknown resync mode {resync!r}")
        if resync is not None and not backend.startswith("adaptive"):
            raise ValueError("resync='auto' needs an adaptive backend: a "
                             "re-acquired epoch carries an unknown phase "
                             "offset only a trained equalizer absorbs")
        self.device = resolve_device(device)
        self.batch = batch
        self.first_field = first_field
        self.backend = backend
        self.trellis = trellis
        self.erasures = erasures
        self.wire_format = wire_format
        self.eq_profile = eq_profile
        if wire_format == "cf32":
            self._dequant = 1.0
            # the numpy backend is the high-precision reference path: it
            # keeps float64 planes (the device paths are float32 anyway)
            stream_dtype = np.float64 if backend == "numpy" else np.float32
        else:
            self._dequant = 1.0 / quantize_scale(wire_format)
            stream_dtype = np.int16 if wire_format == "cs16" else np.int8
        self.margin = margin if margin is not None else (
            _MARGIN if backend == "numpy" else _DEV_MARGIN)
        if backend != "numpy" and self.margin != _DEV_MARGIN:
            raise ValueError("device/adaptive backends use a fixed window; "
                             "leave margin unset or use backend='numpy'")
        if train_every != 1 and not backend.startswith("adaptive"):
            raise ValueError("train_every is the adaptive equalizer's "
                             "retrain cadence — zf/numpy backends do "
                             "not train")
        self.train_every = train_every
        self._adaptive = None
        if backend.startswith("adaptive"):
            key = DEFAULT_EQ_PROFILE if eq_profile == "auto" else eq_profile
            self._adaptive = AdaptiveEqualizer(
                batch=batch, forgetting=forgetting, ridge=ridge,
                apply_precision=_ADAPTIVE_PRECISION[key],
                decision_directed=backend == "adaptive-dd",
                train_every=train_every, device=self.device)
        self.ntsc = ntsc
        self.viterbi_chunks = viterbi_chunks
        self.measure_mer = measure_mer
        self.ntsc_votes: np.ndarray | None = None
        self._mer_sig = np.zeros(batch)   # accumulated signal power
        self._mer_err = np.zeros(batch)   # accumulated residual power
        self._mer_fields = 0
        # "auto" decides from the first field's levels (detect_ntsc),
        # before any decoder state exists, then sticks
        self._ntsc_pending = ntsc == "auto"
        self.ntsc_active = ntsc == "comb"
        self._decoder = self._make_decoder()
        self._stream = _PlanarStream(batch, dtype=stream_dtype)
        self._next_field = 0  # next un-equalized field (epoch-relative)
        self._epoch = 0       # stream sample index of field 0 of this lock
        self._primed = False
        self.resync = resync
        self.resync_after = resync_after
        self.resync_threshold = resync_threshold
        self._bad_streak = 0
        self._acquiring = False
        self._acquire_from = 0
        self.resyncs = 0
        self.resync_log: list[dict] = []
        self.fields_emitted = 0  # total fields ever returned (all locks)

    def _make_decoder(self) -> Decoder:
        if self.ntsc_active:
            return NtscDecoder(batch=self.batch, viterbi_chunks=self.viterbi_chunks,
                               device=self.device)
        if self.trellis.startswith("soft"):
            return SoftDecoder(batch=self.batch, viterbi_chunks=self.viterbi_chunks,
                               device=self.device)
        return Decoder(batch=self.batch, device=self.device)

    @property
    def decoder(self) -> Decoder:
        return self._decoder

    @property
    def adaptive(self) -> AdaptiveEqualizer | None:
        """The adaptive backends' equalizer (its taps and carried state)."""
        return self._adaptive

    @property
    def mer(self) -> np.ndarray | None:
        """(B,) running modulation-error-ratio estimate in dB over every
        equalized field so far; None until the first measured field
        (enable with measure_mer=True)."""
        if self._mer_fields == 0:
            return None
        return 10 * np.log10(
            self._mer_sig / np.maximum(self._mer_err, 1e-30)
        )

    def _try_reacquire(self, final: bool) -> bool:
        """Search the buffered stream for the next field boundary (channel
        0); on success re-base every channel's epoch/parity there and reset
        the decode state, carrying the RS counters."""
        s0 = self._acquire_from
        need = _N + 704 + 3      # minimum span find_field_sync_iq wants
        want = need + 4096       # slack so the peak is never edge-clipped
        avail = self._stream.end - s0
        if avail < (need if final else want):
            return False
        w = self._stream.window(s0, min(self._stream.end, s0 + want))
        cplx = w[0, 0].astype(np.float64) + 1j * w[0, 1].astype(np.float64)
        offset, parity = find_field_sync_iq(cplx)
        self._epoch = s0 + offset
        self.first_field = int(parity)
        self._next_field = 0
        self._primed = False
        self._bad_streak = 0
        self._acquiring = False
        old = self._decoder
        self._decoder = self._make_decoder()  # carried state is garbage
        self._decoder.segments_corrected = old.segments_corrected
        self._decoder.segments_uncorrectable = old.segments_uncorrectable
        self._decoder.segments_erasure_assisted = old.segments_erasure_assisted
        if self._adaptive is not None:
            self._adaptive.reset()  # new epoch = new derotation phase
        self.resyncs += 1
        self.resync_log.append(
            {"stream_sample": int(self._epoch), "parity": int(parity)}
        )
        return True

    def _equalize(self, rel0: int, g0: int, want_levels: bool):
        """Field `rel0 / N` (stream sample g0) through the backend: int8
        symbols, or float32 soft levels (int8 codes for soft-i8) when
        want_levels — a tensor on the device, or host numpy for the numpy
        backend."""
        if self.backend == "numpy":
            w = self._stream.window(g0 - self.margin, g0 + _N + self.margin)
            cplx = w[:, 0].astype(np.complex128)
            cplx += 1j * w[:, 1]
            # oscillator coordinates are epoch-relative (rel0), the
            # buffered stream's absolute (g0)
            lev = equalize_span(cplx, rel0, first_field=self.first_field,
                                margin=self.margin, stream_offset=rel0 - self.margin)
            return lev.astype(np.float32) if want_levels else slice_levels(lev)
        if self._adaptive is not None:
            win = self._stream.window(g0 - _DEV_MARGIN, g0 + _N + _DEV_MARGIN)
            osc = _osc_planar(rel0 - _DEV_MARGIN, rel0 + _N + _DEV_MARGIN,
                              self.first_field)
            parity = (self.first_field + self._next_field) % 2
            return self._adaptive.process_field(win, osc, parity, soft=want_levels)
        lo_off, wlen = eq_window_bounds(self.eq_profile)
        win = self._stream.window(g0 + lo_off, g0 + lo_off + wlen)
        osc = _osc_planar(rel0 + lo_off, rel0 + lo_off + wlen, self.first_field)
        step = device_eq_step(want_levels, self._dequant, self.eq_profile,
                              soft_q=self.trellis == "soft-i8")
        return step(torch.from_numpy(win).to(self.device),
                    torch.from_numpy(osc).to(self.device))

    def _decode_available(self, final: bool) -> list[tuple[np.ndarray, np.ndarray]]:
        out = []
        while True:
            if self._acquiring:
                if not self._try_reacquire(final):
                    break
                continue
            rel0 = self._next_field * _N
            g0 = self._epoch + rel0
            need = g0 + _N if final else g0 + _N + self.margin
            if self._stream.end < need:
                break
            soft = self.trellis.startswith("soft")
            want_levels = (soft or self.erasures is not None
                           or self._ntsc_pending or self.ntsc_active
                           or self.measure_mer)
            field = self._equalize(rel0, g0, want_levels)
            if want_levels and isinstance(field, np.ndarray):
                field = torch.from_numpy(field).to(self.device)
            if self.measure_mer:
                sig, err = _mer_components_dev(field)
                self._mer_sig += sig.cpu().numpy().astype(np.float64)
                self._mer_err += err.cpu().numpy().astype(np.float64)
                self._mer_fields += 1
            if self._ntsc_pending:
                self._ntsc_pending = False
                votes = detect_ntsc(field, per_channel=True)
                self.ntsc_votes = votes
                if 0 < votes.sum() < votes.size:
                    print("warning: ntsc auto-detection disagrees across "
                          f"channels ({int(votes.sum())}/{votes.size} want "
                          "the comb); the decode mode is batch-global — "
                          "majority wins (split the batch to mix modes)",
                          file=sys.stderr)
                if votes.mean() > 0.5:
                    self.ntsc_active = True
                    self._decoder = self._make_decoder()
            flags = None
            if self.erasures is not None:
                # detector -> slice for the hard path -> decode with flags
                flags = burst_erasure_flags_dev(field)
                if not soft:
                    field = slice_symbols(field)
            elif not soft and want_levels and not self.ntsc_active:
                field = slice_symbols(field)   # the hard decoder wants symbols
            corrected = self._decoder.segments_corrected
            uncorrectable = self._decoder.segments_uncorrectable
            assisted = self._decoder.segments_erasure_assisted
            ts, nerr = self._decoder.decode(field, erasure_flags=flags)
            if self._primed:
                out.append((ts, nerr))
                self.fields_emitted += 1
                if self.resync is not None:
                    bad = float((nerr < 0).mean()) >= self.resync_threshold
                    self._bad_streak = self._bad_streak + 1 if bad else 0
                    if self._bad_streak >= self.resync_after:
                        # sync lost: stop decoding and re-acquire from the
                        # oldest still-buffered sample (no trim: the
                        # search needs those samples)
                        self._acquiring = True
                        self._acquire_from = self._stream.base
                        continue
            else:
                # the pre-start virtual field is discarded — roll its RS
                # stats back so summaries reflect *emitted* fields only
                self._decoder.segments_corrected = corrected
                self._decoder.segments_uncorrectable = uncorrectable
                self._decoder.segments_erasure_assisted = assisted
            self._primed = True
            self._next_field += 1
            # drop samples no window will touch again
            self._stream.trim(
                max(self._epoch + self._next_field * _N - self.margin, 0)
            )
        return out

    def push(self, iq: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        """iq: (B, n) or (n,) complex samples. Returns newly decoded
        fields (possibly empty)."""
        self._stream.append(np.asarray(iq))
        return self._decode_available(final=False)

    def push_codes(self, codes: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        """Quantized wire input: (B, n, 2) or (n, 2) int16/int8 I,Q codes
        matching `wire_format`, stored and uploaded verbatim and
        dequantized inside the equalizer kernel. Returns newly decoded
        fields."""
        if self.wire_format == "cf32":
            raise ValueError("push_codes needs wire_format='cs16'/'cs8'")
        self._stream.append_codes(codes)
        return self._decode_available(final=False)

    def notify_gap(self, n_samples: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """The source dropped exactly n_samples: insert that many zero
        samples so field tracking stays aligned (the gap decodes as noise
        and RS absorbs what it can). Returns newly decoded fields."""
        if n_samples < 0:
            raise ValueError(f"negative gap {n_samples}")
        self._stream.append_zeros(n_samples)
        return self._decode_available(final=False)

    def flush(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """End of stream: decode any complete buffered fields (the final
        field sees no right context; its last ~112 symbols may need RS
        correction)."""
        return self._decode_available(final=True)
