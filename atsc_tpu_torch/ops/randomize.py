"""Data randomizer stage: one XOR over the field.

Counterpart of atsc_tpu/ops/randomize.py (reference src/atsc/randomize.h:
43-55): drop each packet's 0x47 sync byte, XOR the 187 payload bytes with
the per-field PN table, zero the 20 RS parity slots.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.randomizer import randomizer_table


@functools.lru_cache(maxsize=1)
def _table() -> np.ndarray:
    return randomizer_table()  # (312, 187) uint8


def randomize_field(ts: torch.Tensor) -> torch.Tensor:
    """(B, 58656) uint8 TS bytes -> (B, 312, 207) uint8, parity slots zeroed."""
    b = ts.shape[0]
    pkts = ts.reshape(b, P.DATA_SEGMENTS, P.MPEG2_BYTES)
    payload = pkts[:, :, 1:] ^ const(_table, ts.device)
    parity = torch.zeros(
        (b, P.DATA_SEGMENTS, P.RS_BYTES), dtype=torch.uint8, device=ts.device
    )
    return torch.cat([payload, parity], dim=-1)
