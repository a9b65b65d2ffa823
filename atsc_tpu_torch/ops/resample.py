"""Streaming arbitrary-rate polyphase resampler.

Counterpart of atsc_tpu/ops/resample.py. Real SDRs rarely run at exactly
the ATSC symbol rate (10,762,237.76 Hz): receivers prefer round rates like
16 or 20 MS/s, and every capture clock has ppm-scale error on top.
`StreamResampler` consumes capture-rate chunks of any size and emits
nominal-rate samples (the receive side: `decode --rate`, numeric `--sro`),
or takes symbol-rate fields to an SDR's clock (the transmit side: `encode
--rate/--ppm`).

* The position is carried as an **exact rational**, so an unbounded live
  run never accumulates timing drift: `capture_rate(sps)` builds the exact
  capture-samples-per-output ratio for any integer capture rate, the ATSC
  symbol rate being exactly 1,539,000,000/143 Hz. Float rates are snapped
  to the best rational with denominator <= 2**32.
* The interpolator is a 32-point Kaiser-windowed sinc (beta=10, 512
  fractional-delay phases), the same as models/receiver.py's
  `resample_stream`. Per output block the host computes the integer
  base-index and phase vectors from the rational position (numpy int64);
  `_resample_block` gathers the 32 taps of each output on the resampler's
  device and sums them in the reference's order, tap 0 to 31, in float32.
  It is plain torch: in the JAX package this step is a jitted gather and
  multiply-add outside any Pallas kernel.
* Blocks are padded to a power-of-two bucket and every output lane's
  arithmetic is independent of its neighbours, so any chunking of the
  input emits bit-identical samples on a given device.

The input buffer stays in host memory; only one block's window goes to
the device at a time, and `push`/`flush` return host numpy, as in the JAX
package. Checkpoint state is (out_next, in_base), two integers (`state` /
`load_state`), or those plus the buffered window (`full_state` /
`load_full_state`) for a stream whose input cannot be re-read.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from atsc_tpu_torch import resolve_device

TAPS = 32
PHASES = 512
_HALF = TAPS // 2
_OUT_BLOCK = 1 << 16          # outputs per block

# The ATSC symbol rate 4.5 MHz / 286 * 684 as an exact rational (Hz).
SYMBOL_RATE_FRACTION = Fraction(4_500_000 * 684, 286)  # == 1539000000/143


def capture_rate(sps) -> Fraction:
    """Exact `rate` (capture samples per nominal-rate output sample) for a
    capture clocked at `sps` samples/s, e.g. capture_rate(20e6) for a
    20 MS/s SDR. Accepts int/float/Fraction; exact when sps is."""
    return Fraction(sps) / SYMBOL_RATE_FRACTION


def output_rate(sps) -> Fraction:
    """Exact `rate` (nominal-rate input samples consumed per emitted output
    sample) for an *output* stream clocked at `sps` samples/s: the transmit
    side's mirror of `capture_rate` (`encode --rate 20e6`)."""
    return SYMBOL_RATE_FRACTION / Fraction(sps)


@functools.lru_cache(maxsize=1)
def _kernel_table() -> np.ndarray:
    """(PHASES, TAPS) float32 kaiser(beta=10)-windowed sinc fractional-delay
    bank, rows normalized to unit DC gain (models/receiver.py's
    resample_stream kernel)."""
    j = np.arange(TAPS)[None, :]
    t = j - (_HALF - 1) - np.arange(PHASES)[:, None] / PHASES
    x = np.clip(t / (_HALF + 1), -1.0, 1.0)
    h = np.sinc(t) * np.i0(10.0 * np.sqrt(1.0 - x * x)) / np.i0(10.0)
    h /= h.sum(axis=1, keepdims=True)
    return h.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_kernel_table()).to(device)


def _resample_block(win: torch.Tensor, base: torch.Tensor,
                    ph: torch.Tensor) -> torch.Tensor:
    """win (B, 2, n_win) float32; base/ph (M,) int64 window-relative, all
    on one device. Returns (B, 2, M) float32:
    out[.., m] = sum_j win[.., base[m] + j] * h[ph[m], j], summed from zero
    in tap order 0..31 with one rounding per product and per sum."""
    hp = _table_on(win.device)[ph]                                  # (M, TAPS)
    idx = base[:, None] + torch.arange(TAPS, device=win.device)     # (M, TAPS)
    prod = win[..., idx] * hp                                       # (B, 2, M, TAPS)
    out = torch.zeros(prod.shape[:-1], dtype=torch.float32, device=win.device)
    for j in range(TAPS):
        out = out + prod[..., j]
    return out


class StreamResampler:
    """Streaming capture-rate -> nominal-rate converter on `device`.

    rate: input samples consumed per output sample (e.g. capture_rate(20e6)
    for a 20 MS/s capture), any positive value; held internally as an
    exact rational (a Fraction or (num, den) stays exact). batch: leading
    channel axis of every chunk.

    push(iq (B, n) complex or (n,)) -> (B, m) complex64 of whatever is
    computable; flush() -> final tail (pads TAPS+2 zeros, mirroring
    resample_stream's edge handling). Output sample k interpolates input
    position rate*k + TAPS/2, the same constant bulk delay as
    resample_stream, re-absorbed downstream by field alignment.
    """

    def __init__(self, rate, batch: int = 1, *,
                 device: str | torch.device = "cuda"):
        if isinstance(rate, tuple):
            rate = Fraction(*rate)
        if isinstance(rate, Fraction):
            frac = rate
        else:
            frac = Fraction(float(rate)).limit_denominator(1 << 32)
        if frac <= 0:
            raise ValueError(f"resample rate must be positive, got {rate}")
        if frac.denominator > 1 << 40:
            # keep block position math int64-safe (see _drain)
            frac = frac.limit_denominator(1 << 40)
        self.device = resolve_device(device)
        self.num, self.den = frac.numerator, frac.denominator
        self.rate = float(frac)
        self.batch = batch
        self.out_next = 0          # next output index to emit
        self.in_base = 0           # stream index of _buf[..., 0]
        self._buf = np.zeros((batch, 2, 0), np.float32)
        self._flushed = False

    # -- state (two integers; the buffer tail is re-readable from input) --

    def state(self) -> dict:
        return {"num": self.num, "den": self.den, "out_next": self.out_next,
                "in_base": self.in_base, "batch": self.batch}

    @classmethod
    def load_state(cls, st: dict, *,
                   device: str | torch.device = "cuda") -> "StreamResampler":
        rs = cls((int(st["num"]), int(st["den"])), int(st["batch"]), device=device)
        rs.out_next = int(st["out_next"])
        rs.in_base = int(st["in_base"])
        return rs

    def full_state(self) -> dict:
        """Complete state including the buffered input window, for resuming
        a stream whose input cannot be re-read (the transmit side). Ints
        and numpy arrays only. A post-flush save carries flushed=1, which
        load_full_state refuses: the TAPS+2 zero tail pad is in the buffer,
        so a resume would emit spurious near-zero samples at the seam."""
        return dict(self.state(), buf=self._buf.copy(),
                    flushed=int(self._flushed))

    @classmethod
    def load_full_state(cls, st: dict, *,
                        device: str | torch.device = "cuda") -> "StreamResampler":
        if int(st.get("flushed", 0)):
            raise ValueError(
                "resampler state was saved after the final flush; a "
                "flushed stream cannot be resumed — re-encode from the "
                "start (or checkpoint before EOF with --max-fields)"
            )
        rs = cls.load_state({k: int(st[k]) for k in
                             ("num", "den", "out_next", "in_base", "batch")},
                            device=device)
        rs._buf = np.asarray(st["buf"], np.float32)
        return rs

    @property
    def in_consumed(self) -> int:
        """Total input samples ingested so far (for input re-seeking)."""
        return self.in_base + self._buf.shape[-1]

    # ---------------------------------------------------------------------

    def _pos(self, n: int) -> tuple[int, int]:
        """Output n's (floor position, phase index), exact integers."""
        t = n * self.num + self.den * _HALF
        base, rem = divmod(t, self.den)
        ph = min((rem * PHASES + self.den // 2) // self.den, PHASES - 1)
        return base, ph

    def push(self, iq: np.ndarray) -> np.ndarray:
        """Complex (B, n) / (n,) in -> complex64 (B, m) out."""
        iq = np.atleast_2d(np.asarray(iq))
        ch = np.empty((iq.shape[0], 2, iq.shape[-1]), np.float32)
        ch[:, 0] = iq.real
        ch[:, 1] = iq.imag
        out = self.push_planar(ch)
        return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)

    def push_planar(self, ch) -> np.ndarray:
        """Planar (B, 2, n) float32 in (numpy, or a tensor on any device,
        e.g. the encoder's output) -> planar (B, 2, m) float32 numpy out."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        if isinstance(ch, torch.Tensor):
            ch = ch.cpu().numpy()
        ch = np.asarray(ch, np.float32)
        if ch.ndim != 3 or ch.shape[0] != self.batch or ch.shape[1] != 2:
            raise ValueError(
                f"want planar ({self.batch}, 2, n), got {ch.shape}"
            )
        self._buf = np.concatenate([self._buf, ch], axis=-1)
        return self._drain()

    def flush(self) -> np.ndarray:
        """Emit the tail: pad TAPS+2 zeros so every output whose window
        began inside the real capture becomes computable."""
        out = self.flush_planar()
        return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)

    def flush_planar(self) -> np.ndarray:
        """Planar-form flush (see `flush`): (B, 2, m) float32."""
        if self._flushed:
            return np.zeros((self.batch, 2, 0), np.float32)
        self._flushed = True
        pad = np.zeros((self.batch, 2, TAPS + 2), np.float32)
        self._buf = np.concatenate([self._buf, pad], axis=-1)
        # emit outputs whose interpolation point pos(n) = rate*n + HALF lies
        # strictly inside the real capture (resample_stream's contract)
        end = self.in_base + self._buf.shape[-1] - (TAPS + 2)
        n_stop = (self.den * (end - _HALF) - 1) // self.num + 1
        return self._drain(limit=max(int(n_stop), self.out_next))

    def _drain(self, limit: int | None = None) -> np.ndarray:
        """Emit every output computable from the current buffer."""
        avail_end = self.in_base + self._buf.shape[-1]
        # output n needs input indices [base(n) - (HALF-1), base(n) + HALF],
        # so base(n) <= avail_end - 1 - HALF, i.e.
        # n*num + den*HALF <= den*(avail_end - HALF) - 1
        n_max = (self.den * (avail_end - 2 * _HALF) - 1) // self.num
        n_emit = n_max + 1 - self.out_next
        if limit is not None:
            n_emit = min(n_emit, limit - self.out_next)
        if n_emit <= 0:
            return np.zeros((self.batch, 2, 0), np.float32)
        outs = []
        while n_emit > 0:
            m = min(n_emit, _OUT_BLOCK)
            n0 = self.out_next
            # block-relative exact position math: the block origin is a
            # Python int (never overflows over an unbounded live run); the
            # within-block offsets k*num fit int64 for den <= 2**40 and
            # rate <~ 64 (num*_OUT_BLOCK < 2**63)
            base0, rem0 = divmod(n0 * self.num + self.den * _HALF, self.den)
            # a power-of-two bucket bounds the distinct block shapes; the
            # pad lanes repeat the last real lane and are cut off
            mp = max(256, 1 << (m - 1).bit_length())
            incr = rem0 + np.arange(mp, dtype=np.int64) * self.num
            incr[m:] = incr[m - 1]      # pad lanes stay inside the window
            q, rem = np.divmod(incr, self.den)
            ph = np.minimum((rem * PHASES + self.den // 2) // self.den,
                            PHASES - 1)
            lo = (base0 - (_HALF - 1)) - self.in_base
            n_win = (self.num * (mp - 1) + self.den - 1) // self.den + TAPS
            win = self._buf[:, :, lo : lo + n_win]
            if win.shape[-1] < n_win:   # slack past the guaranteed span
                win = np.pad(            # is never gathered by real lanes
                    win, ((0, 0), (0, 0), (0, n_win - win.shape[-1]))
                )
            out = _resample_block(
                torch.from_numpy(np.ascontiguousarray(win)).to(self.device),
                torch.from_numpy(q).to(self.device),
                torch.from_numpy(ph).to(self.device),
            )[:, :, :m]
            outs.append(out.cpu().numpy())
            self.out_next += m
            n_emit -= m
        # trim consumed input (keep the window context for out_next)
        keep_from = self._pos(self.out_next)[0] - (_HALF - 1)
        drop = max(0, keep_from - self.in_base)
        if drop:
            self._buf = self._buf[:, :, drop:]
            self.in_base += drop
        return np.concatenate(outs, axis=-1)
