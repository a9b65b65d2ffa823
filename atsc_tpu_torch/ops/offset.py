"""Pilot/frequency offset stage: modulate the real field onto the complex
oscillator with per-stream phase continuity.

Counterpart of atsc_tpu/ops/offset.py (reference src/atsc/offset.h):
multiply by the frozen oscillator table (tables/oscillator.py, with the
reference's float32-argument quirk) and advance a per-stream float32
phasor once a field. Complex values are planar float32 (re, im).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.oscillator import field_scale, oscillator_table


@functools.lru_cache(maxsize=1)
def _osc_planar() -> np.ndarray:
    """(2, 261248) float32 oscillator table for field 0, (re, im) planes."""
    t = oscillator_table()
    return np.stack([t.real, t.imag]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _scale_planar() -> np.ndarray:
    """(2,) float32 per-field phase advance (re, im)."""
    s = field_scale()
    return np.array([s.real, s.imag], dtype=np.float32)


def advance_phasor(phasor: torch.Tensor) -> torch.Tensor:
    """One field's oscillator phase advance: (B, 2) -> (B, 2) float32.

    Bit-exact to the float32 recurrence of tables.oscillator
    (phasor_for_field): each product and each sum is its own eager op, so
    every one rounds to float32 and nothing fuses them into an FMA. Keep
    it that way (no torch.compile, no fused kernel) or the stream drifts
    off the reference's phase."""
    s = const(_scale_planar, phasor.device)
    sr, si = s[0], s[1]
    re = phasor[:, 0] * sr - phasor[:, 1] * si
    im = phasor[:, 0] * si + phasor[:, 1] * sr
    return torch.stack([re, im], dim=-1)


def apply_pilot_offset(
    field: torch.Tensor, phasor: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """field: (B, 261248) float32 real symbols; phasor: (B, 2) float32.

    Returns (iq (B, 2, 261248) planar float32, next_phasor (B, 2)).
    """
    osc = const(_osc_planar, field.device)
    tr, ti = osc[0][None, :], osc[1][None, :]
    pr, pi = phasor[:, 0:1], phasor[:, 1:2]
    out_re = field * (tr * pr - ti * pi)
    out_im = field * (tr * pi + ti * pr)
    return torch.stack([out_re, out_im], dim=1), advance_phasor(phasor)
