"""The receive equalizer of a known 8-VSB transmitter, plain, in float64.

After derotation by the known oscillator the chain is one anti-causal
complex FIR (the root-raised-cosine taps on the pilot-offset carrier).
The level sequence is real, so each bin is seen twice, through C(f) and
conj(C(-f)); the least-squares combination of the two is compactly
supported in time and collapses to two real FIRs on the derotated planes:
lev = p (*) Re(u) + q (*) Im(u), here with K samples of support each side.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import tables as T
from reference.precision import fir_forward


def wl_taps(eq_k: int) -> tuple[np.ndarray, np.ndarray]:
    """(p, q) float64 of length 2K + 1; tap j applies to input i + j of a
    window that starts K samples before the field."""
    length = 1 << 16
    c = T.rrc_taps().astype(np.float64)
    ctil = c * np.exp(1j * T.osc_phase_increment() * np.arange(c.size))
    a = np.conj(np.fft.fft(np.conj(ctil), length))
    b = np.roll(np.conj(a)[::-1], 1)                 # conj(A(-f))
    den = np.abs(a) ** 2 + np.abs(b) ** 2
    ga = np.fft.ifft(np.conj(a) / den)
    gb = np.fft.ifft(np.conj(b) / den)
    p = np.real(ga) + np.real(gb)
    q = np.imag(gb) - np.imag(ga)
    k = (eq_k - np.arange(2 * eq_k + 1)) % length
    return p[k], q[k]


def oscillator_span(lo: int, hi: int) -> np.ndarray:
    """(2, hi - lo) float64 oscillator of stream samples [lo, hi) counted
    from field 0: field k's table times its phasor; before sample 0 the
    table with a unit phasor."""
    table = T.oscillator()[:, :T.N].astype(np.float64)
    ph = T.phasor_sequence(max((hi - 1) // T.N, 0) + 1).astype(np.float64)
    out = np.empty((2, hi - lo))
    g = lo
    while g < hi:
        k, i = divmod(g, T.N)
        n = min(hi - g, T.N - i)
        pr, pi = ph[k] if k >= 0 else (1.0, 0.0)
        out[0, g - lo:g - lo + n] = table[0, i:i + n] * pr - table[1, i:i + n] * pi
        out[1, g - lo:g - lo + n] = table[0, i:i + n] * pi + table[1, i:i + n] * pr
        g += n
    return out


def levels(win: torch.Tensor, g0: int, eq_k: int, dequant: float,
           precision: str = "f64", rows: int = 32) -> torch.Tensor:
    """(B, 260416) float64 levels of the field starting at stream sample
    g0, from its window win (B, 2, L) of codes or samples covering stream
    [g0 - K, g0 - K + L): derotate, scale by dequant / 0.81, and filter;
    the derotated samples and the taps rounded to `precision`."""
    dev = win.device
    osc = torch.tensor(oscillator_span(g0 - eq_k, g0 - eq_k + win.shape[-1]), device=dev)
    p, q = (torch.tensor(t, device=dev) for t in wl_taps(eq_k))
    s = dequant / T.OSC_AMPLITUDE ** 2
    out = torch.empty((win.shape[0], T.N), dtype=torch.float64, device=dev)
    for lo in range(0, win.shape[0], rows):
        w = win[lo:lo + rows].to(torch.float64)
        ur = (w[:, 0] * osc[0] + w[:, 1] * osc[1]) * s
        ui = (w[:, 1] * osc[0] - w[:, 0] * osc[1]) * s
        out[lo:lo + rows] = (fir_forward(ur, p, T.N, precision)
                             + fir_forward(ui, q, T.N, precision))
    return out


def slice_symbols(lev: torch.Tensor) -> torch.Tensor:
    """Levels -> int8 3-bit symbols: the nearest of 2v - 7 + 1.25."""
    return torch.clamp(torch.round((lev - (T.PILOT - 7.0)) / 2), 0, 7).to(torch.int8)

