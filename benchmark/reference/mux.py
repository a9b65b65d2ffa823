"""The FDM multiplex of B 8-VSB channels into one band at B x 6 MHz, plain,
in float64.

The symbol rate is 4.5 MHz x 684/286, so 513 input samples of a channel
are exactly 286 x B samples of the band: each 513-sample block (with 16
samples of context on either side) is resampled by one banded product with
a Kaiser(10)-windowed sinc interpolator, and channel k is mixed to
(k - (B-1)/2) x 6 MHz by a carrier of period 2B samples, which every
block's output spans a whole number of times.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.precision import lower

UP, DOWN, HALO = 286, 513, 16


def resample_matrix(n_slots: int) -> np.ndarray:
    """(513 + 32, 286 B) float64: output m of a block reads input position
    m x 513 / (286 B) + 16, through a sinc windowed by Kaiser(10) over
    +-17 samples, normalized to unit DC gain per output phase."""
    p = UP * n_slots
    pos = np.arange(p, dtype=np.float64) * DOWN / p + HALO
    t = pos[None, :] - np.arange(DOWN + 2 * HALO, dtype=np.float64)[:, None]
    x = np.clip(t / (HALO + 1), -1.0, 1.0)
    w = np.sinc(t) * np.i0(10.0 * np.sqrt(1.0 - x * x)) / np.i0(10.0)
    w[np.abs(t) > HALO + 1] = 0.0
    return w / w.sum(axis=0, keepdims=True)


def mixer(n_slots: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, 2B) cos and sin of slot k's carrier over its 2B-sample period."""
    k = np.arange(n_slots)[:, None]
    m = np.arange(2 * n_slots)[None, :]
    ph = 2 * np.pi * (2 * k - n_slots + 1) / (2 * n_slots) * m
    return np.cos(ph), np.sin(ph)


def blocks_after(samples: int) -> int:
    """Blocks of the band complete once `samples` samples of every channel
    were pushed (a block needs 16 samples past it)."""
    return max(samples - HALO, 0) // DOWN


def band(stream: torch.Tensor, start: int, b0: int, b1: int,
         precision: str = "f64") -> torch.Tensor:
    """Band samples of blocks [b0, b1) as (2, (b1 - b0) x 286 B) float64.

    stream: (B, 2, S) planar channel IQ holding stream samples
    [start, start + S); samples before stream sample 0 are zero. The
    resampler's operands are rounded to `precision`."""
    n_slots = stream.shape[0]
    dev = stream.device
    lo, hi = b0 * DOWN - HALO, b1 * DOWN + HALO
    win = torch.zeros((n_slots, 2, hi - lo), dtype=torch.float64, device=dev)
    a, b = max(lo, start, 0), min(hi, start + stream.shape[-1])
    win[..., a - lo:b - lo] = stream[..., a - start:b - start].to(torch.float64)
    blocks = win.unfold(-1, DOWN + 2 * HALO, DOWN)[:, :, : b1 - b0]
    w = torch.tensor(resample_matrix(n_slots), device=dev)
    res = lower(blocks, precision) @ lower(w, precision)      # (B, 2, nb, 286 B)
    res = res.reshape(n_slots, 2, -1, 2 * n_slots)
    cos, sin = (torch.tensor(t, device=dev)[:, None, :] for t in mixer(n_slots))
    re = (res[:, 0] * cos - res[:, 1] * sin).sum(dim=0)
    im = (res[:, 0] * sin + res[:, 1] * cos).sum(dim=0)
    return torch.stack([re, im]).reshape(2, -1)
