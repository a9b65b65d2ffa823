"""8VSB hard-decision helpers for the receive path.

Counterpart of atsc_tpu/ops/slicer.py: one home for the
nearest-constellation math (levels are the 8VSB {-7..+7} lattice plus the
+1.25 pilot bias, reference src/atsc/signal.h:14-18). torch.round is
round-half-even, like jnp.round.
"""

from __future__ import annotations

import torch

from atsc_tpu_torch import params as P


def slice_symbols(lev: torch.Tensor) -> torch.Tensor:
    """Soft levels (pilot offset included) -> int8 3-bit symbol values."""
    sym = torch.round((lev - P.PILOT_OFFSET + 7.0) * 0.5)
    return torch.clamp(sym, 0, 7).to(torch.int8)


def ideal_levels(lev: torch.Tensor) -> torch.Tensor:
    """Nearest constellation level of each soft level, WITHOUT the pilot
    bias: values on the {-7,-5,...,+7} lattice. The slicer residual is
    `(lev - P.PILOT_OFFSET) - ideal_levels(lev)`."""
    x = lev - P.PILOT_OFFSET
    return torch.clamp(torch.round((x + 7.0) * 0.5) * 2.0 - 7.0, -7.0, 7.0)
