"""IQ output quantization: CF32 -> CS16 / CS8 SDR sample formats, and the
packed wire layout.

Counterpart of atsc_tpu/ops/quantize.py. One global full-scale constant,
from the worst-case analytic peak of the 8VSB baseband so no field can
clip:

    peak = |phasor| * OSC_AMPLITUDE * max|level| * sum|rrc_taps|

computed in float64 as the JAX package does, then used as a float32
multiplier. torch.round is round-half-even, like jnp.round.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.tables.rrc import rrc_taps

#: quantized integer full-scale per format (symmetric, avoids -qmax-1)
QMAX = {"cs16": 32767, "cs8": 127}
DTYPE = {"cs16": torch.int16, "cs8": torch.int8}
NP_DTYPE = {"cs16": np.int16, "cs8": np.int8}
BYTES_PER_SAMPLE = {"cf32": 8, "cs16": 4, "cs8": 2}  # interleaved I+Q
#: packed-lane dtype of the wire layout (one (I, Q) pair per lane)
WIRE_DTYPE = {"cs16": torch.int32, "cs8": torch.int16}


@functools.lru_cache(maxsize=1)
def iq_peak() -> float:
    """Analytic worst-case |I| (= worst-case |Q|) of the baseband output."""
    max_level = 2.0 * 7 - 7 + P.PILOT_OFFSET                      # 8.25
    taps_l1 = float(np.abs(rrc_taps()).sum())
    phasor_slack = 1.0 + 1e-4  # float32 drift bound of the unit phasor
    return phasor_slack * P.OSC_AMPLITUDE * max_level * taps_l1


def quantize_scale(fmt: str) -> float:
    """Multiplier taking float IQ to integer codes for 'cs16'/'cs8'."""
    return QMAX[fmt] / iq_peak()


def quantize_iq(iq: torch.Tensor, fmt: str) -> torch.Tensor:
    """float32 IQ -> int16/int8 codes (round-half-even, clipped)."""
    q = float(QMAX[fmt])
    scale = torch.tensor(quantize_scale(fmt), dtype=torch.float32, device=iq.device)
    return torch.clamp(torch.round(iq * scale), -q, q).to(DTYPE[fmt])


def dequantize_iq(iq: np.ndarray, fmt: str) -> np.ndarray:
    """Integer codes -> float32 IQ (host side, for tests and analysis)."""
    return np.asarray(iq, dtype=np.float32) / np.float32(quantize_scale(fmt))


def pack_wire(iq: torch.Tensor, fmt: str) -> torch.Tensor:
    """Planar integer codes (..., 2, N) -> packed wire lanes (..., N): an
    int16 per cs8 pair, an int32 per cs16 pair, whose little-endian bytes
    are the interleaved (I, Q) wire stream."""
    ii = iq[..., 0, :].to(torch.int32)
    qq = iq[..., 1, :].to(torch.int32)
    if fmt == "cs8":
        p = (ii & 0xFF) | ((qq & 0xFF) << 8)
        p = p - ((p & 0x8000) << 1)          # re-sign for the int16 cast
        return p.to(torch.int16)
    if fmt == "cs16":
        return (ii & 0xFFFF) | (qq << 16)
    raise ValueError(f"wire layout applies to cs16/cs8 only, not {fmt!r}")


def unpack_wire(packed: np.ndarray, fmt: str) -> np.ndarray:
    """Packed wire lanes (..., N) -> planar codes (..., 2, N) (host side,
    the inverse of pack_wire)."""
    raw = np.ascontiguousarray(packed)
    pair = raw.view(np.dtype(NP_DTYPE[fmt])).reshape(*raw.shape, 2)
    return np.moveaxis(pair, -1, -2)


# -- quantized soft levels (the receive-side throughput tier) -------------
#
# Levels span the +-8.25 constellation plus noise excursions; +-12 full
# scale covers ~4 sigma of channel noise at the 12 dB threshold, and the
# int8 LSB (0.094) adds ~0.027 rms, ~30 dB below threshold channel noise.

SOFT_LEVEL_MAX = 12.0
SOFT_LEVEL_SCALE = 127.0 / SOFT_LEVEL_MAX
#: the dequantization multiplier (the soft Viterbi tier reads codes with it)
SOFT_LEVEL_INV = SOFT_LEVEL_MAX / 127.0


def quantize_soft_levels(lev: torch.Tensor) -> torch.Tensor:
    """float32 equalized levels -> int8 codes at SOFT_LEVEL_SCALE
    (round-half-even + clip; the plain twin of the equalizer kernel's
    soft-code output)."""
    s = torch.tensor(SOFT_LEVEL_SCALE, dtype=torch.float32, device=lev.device)
    return torch.clamp(torch.round(lev * s), -127, 127).to(torch.int8)
