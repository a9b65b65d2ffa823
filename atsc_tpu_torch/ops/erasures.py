"""Burst/impulse-noise detection for erasure-assisted RS decoding.

Counterpart of atsc_tpu/ops/erasures.py. Impulse noise (A/74's canonical
8VSB impairment — gated bursts of strong wideband noise) corrupts a
contiguous run of received symbols. The convolutional interleaver spreads
such a run thinly over many RS codewords, and when the receiver can point
at the affected bytes, each costs RS half of what an unknown-position
error costs (2*errors + erasures <= 20): flagging a burst doubles the
correctable burst length.

Detection is slicer-residual based: within a burst the equalized levels
sit far from the 8VSB constellation, so the windowed mean of
|level - nearest_level| rises well above the stream's clean-air baseline.
Flags are dilated by one window to cover burst edges.

The device detector sums the residuals in float64, on the CPU and on the
card alike: a float32 running sum over a 260k-symbol field carries an
ulp of ~0.008 near its end, and CPU and CUDA scans add in different
orders, so a window within rounding of the threshold could flip between
devices. The JAX package's float32 window means are off by up to ~1.5e-3
from the float64 ones, so flags can differ from its only at windows that
close to the threshold (tests/test_torch_erasures.py states the band).
"""

from __future__ import annotations

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops.slicer import ideal_levels


def slicer_residual(levels: np.ndarray) -> np.ndarray:
    """|level - nearest 8VSB constellation point| per symbol."""
    lev = np.atleast_2d(np.asarray(levels, np.float64))
    sym = np.clip(np.rint((lev - P.PILOT_OFFSET + 7.0) / 2.0), 0, 7)
    return np.abs(lev - (sym * 2.0 - 7.0 + P.PILOT_OFFSET))


def burst_erasure_flags(
    levels: np.ndarray,
    window: int = 64,
    factor: float = 2.5,
    floor: float = 0.45,
) -> np.ndarray:
    """Per-symbol erasure flags from a windowed slicer-residual detector
    (float64, host).

    levels: (B, n) or (n,) equalized soft levels (pilot offset included).
    A position is flagged when the `window`-symbol mean residual exceeds
    max(factor * median_window_residual, floor) — the median is the
    clean-air baseline (bursts are assumed to cover well under half the
    stream), the absolute floor keeps quiet captures from flagging their
    own noise. Flags are dilated by `window` on each side.

    Returns (B, n) uint8.
    """
    r = slicer_residual(levels)
    b, n = r.shape
    c = np.cumsum(np.concatenate([np.zeros((b, 1)), r], axis=1), axis=1)
    w = (c[:, window:] - c[:, :-window]) / window  # (b, n - window + 1)
    base = np.median(w, axis=1, keepdims=True)
    hot = w > np.maximum(factor * base, floor)
    # valid-window flags -> per-symbol flags, dilated by one window
    flags = np.zeros((b, n), dtype=np.uint8)
    pad = np.zeros((b, 1), dtype=bool)
    edges = np.diff(np.concatenate([pad, hot, pad], axis=1).astype(np.int8),
                    axis=1)
    for bi in range(b):
        starts = np.nonzero(edges[bi] == 1)[0]
        ends = np.nonzero(edges[bi] == -1)[0]
        for s, e in zip(starts, ends):
            lo = max(s - window, 0)
            hi = min(e - 1 + 2 * window, n)  # window span + dilation
            flags[bi, lo:hi] = 1
    return flags


def median_last(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last axis, keepdims: the middle of the sorted
    values, or for an even count the midpoint (lo + hi) * 0.5 in x's dtype
    (torch.median would return the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    lo, hi = (n - 1) // 2, n // 2
    return (s[..., lo : lo + 1] + s[..., hi : hi + 1]) * 0.5


def burst_window_means(levels: torch.Tensor, window: int = 64) -> torch.Tensor:
    """(B, n) soft levels -> (B, n - window + 1) float64 windowed means of
    the slicer residual (the residual itself in float32, as the JAX
    package computes it)."""
    lev = levels.to(torch.float32)
    r = (lev - P.PILOT_OFFSET - ideal_levels(lev)).abs()
    c = torch.nn.functional.pad(torch.cumsum(r, dim=-1, dtype=torch.float64), (1, 0))
    return (c[:, window:] - c[:, :-window]) / window


def burst_threshold(w: torch.Tensor, window: int = 64, factor: float = 2.5,
                    floor: float = 0.45) -> torch.Tensor:
    """(B, 1) detector threshold max(factor * baseline, floor): the
    baseline is the median of a `window`-strided subsample of the windowed
    means (~4k values)."""
    return torch.clamp(factor * median_last(w[:, ::window]), min=floor)


def dilate_hot(hot: torch.Tensor, n: int, window: int = 64) -> torch.Tensor:
    """(B, n - window + 1) bool hot windows -> (B, n) uint8 flags: symbol i
    is flagged iff some hot window j lies in (i - 2w, i + w], exactly the
    host path's per-run [j - w, j + 2w) span. A windowed sum > 0 from one
    exact int32 cumsum."""
    hp = torch.nn.functional.pad(hot.to(torch.int32), (2 * window - 1, 2 * window))
    ch = torch.nn.functional.pad(torch.cumsum(hp, dim=-1, dtype=torch.int32), (1, 0))
    flags = (ch[:, 3 * window :] - ch[:, : -3 * window]) > 0
    return flags[:, :n].to(torch.uint8)


def burst_erasure_flags_dev(
    levels: torch.Tensor,
    window: int = 64,
    factor: float = 2.5,
    floor: float = 0.45,
) -> torch.Tensor:
    """Device twin of burst_erasure_flags: the same detector on the levels'
    device, so per-field flags never leave it. The baseline is the median
    of a strided subsample (burst_threshold) and the dilation a windowed
    sum (dilate_hot); the flag set for given hot windows is identical to
    the host path's.

    levels: (B, n) float soft levels (pilot offset included).
    Returns (B, n) uint8 flags on the levels' device.
    """
    w = burst_window_means(levels, window)
    hot = w > burst_threshold(w, window, factor, floor)
    return dilate_hot(hot, levels.shape[-1], window)
