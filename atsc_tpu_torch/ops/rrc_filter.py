"""Root-raised-cosine pulse-shaping FIR stage, the plain banded form.

Counterpart of atsc_tpu/ops/rrc_filter.py (reference src/atsc/filter.h:
9-69): the anti-causal forward FIR out[i] = sum_{k<112} in[i+k] c[k] over
the padded field. With the stream cut into 128-sample blocks A[j],

    out[j] = A[j] @ W_lo + A[j+1] @ W_hi

where W_lo[m, r] = c[m-r] and W_hi[m, r] = c[128+m-r] are banded 128x128
constants. Both products must run in full float32: torch.matmul does on
CUDA unless torch.backends.cuda.matmul.allow_tf32 is set, and TF32 would
break the 5e-6 IQ bound (which is why this is a matmul and not a conv1d,
whose cuDNN path takes TF32 by default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.rrc import rrc_taps

_BLK = 128


def _band(shift: int) -> np.ndarray:
    taps = rrc_taps().astype(np.float32)  # 112 entries, the last is 0
    k = shift + np.arange(_BLK)[:, None] - np.arange(_BLK)[None, :]
    ok = (k >= 0) & (k < P.RRC_TAPS)
    return np.where(ok, taps[np.clip(k, 0, P.RRC_TAPS - 1)], 0.0).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _w_lo() -> np.ndarray:
    return _band(0)


@functools.lru_cache(maxsize=1)
def _w_hi() -> np.ndarray:
    return _band(_BLK)


def banded_fir(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Forward FIR out[i] = sum_k x[..., i+k] c[k] as banded matmuls.

    x: (..., n_in) float32 with n_in >= n_out + 111. Returns (..., n_out).
    """
    *lead, n_in = x.shape
    nblk_out = -(-n_out // _BLK)
    nblk_in = nblk_out + 1
    pad = nblk_in * _BLK - n_in
    if pad > 0:
        x = torch.nn.functional.pad(x, (0, pad))
    a = x[..., : nblk_in * _BLK].reshape(-1, nblk_in, _BLK)
    x_lo = a[:, :nblk_out].reshape(-1, _BLK)
    x_hi = a[:, 1 : nblk_out + 1].reshape(-1, _BLK)
    out = x_lo @ const(_w_lo, x.device) + x_hi @ const(_w_hi, x.device)
    return out.reshape(*lead, nblk_out * _BLK)[..., :n_out]


def band_matrices_for(taps: np.ndarray) -> tuple[np.ndarray, ...]:
    """Banded 128x128 float32 matrices W_s[m, r] = taps[s*128 + m - r] of an
    arbitrary forward FIR out[i] = sum_k x[i+k] taps[k]: with the input
    cut into 128-sample blocks A[j], out[j] = sum_s A[j+s] @ W_s."""
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    n_taps = taps.size
    n_bands = -(-(n_taps + _BLK - 1) // _BLK)
    m = np.arange(_BLK)[:, None]
    r = np.arange(_BLK)[None, :]
    out = []
    for s in range(n_bands):
        k = s * _BLK + m - r
        w = np.where((k >= 0) & (k < n_taps), taps[np.clip(k, 0, n_taps - 1)], 0.0)
        out.append(w.astype(np.float32))
    return tuple(out)


def banded_fir_wl(
    xr: torch.Tensor, xi: torch.Tensor, weights: torch.Tensor, n_out: int
) -> torch.Tensor:
    """Widely-linear two-plane FIR out[i] = sum_k xr[.., i+k] tr[k] +
    xi[.., i+k] ti[k] as one (., 256) x (256, 128) product per band: the
    receive equalizer's shape, both planes contracting into one real
    output.

    xr, xi: (..., n_in) with n_in >= n_out + len(taps) - 1; weights:
    (bands, 256, 128) of the same dtype and device, rows 0:128 the real
    plane's band matrix (band_matrices_for(tr)) and rows 128:256 the
    imaginary plane's. Returns (..., n_out) in that dtype.
    """
    *lead, n_in = xr.shape
    n_bands = weights.shape[0]
    nblk_out = -(-n_out // _BLK)
    nblk_in = nblk_out + n_bands - 1
    pad = nblk_in * _BLK - n_in
    if pad > 0:
        xr = torch.nn.functional.pad(xr, (0, pad))
        xi = torch.nn.functional.pad(xi, (0, pad))
    ar = xr[..., : nblk_in * _BLK].reshape(-1, nblk_in, _BLK)
    ai = xi[..., : nblk_in * _BLK].reshape(-1, nblk_in, _BLK)
    out = None
    for s in range(n_bands):
        a2 = torch.cat([ar[:, s : s + nblk_out], ai[:, s : s + nblk_out]], dim=-1)
        term = a2.reshape(-1, 2 * _BLK) @ weights[s]
        out = term if out is None else out + term
    return out.reshape(*lead, nblk_out * _BLK)[..., :n_out]


def rrc_filter_field(iq_planar: torch.Tensor) -> torch.Tensor:
    """(B, 2, 261248) planar float32 -> (B, 2, 261120) planar float32 IQ,
    valid through sample 260,416."""
    return banded_fir(iq_planar, P.PADDED_OUT)
