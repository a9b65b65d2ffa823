"""Reed-Solomon RS(207,187) encoder as a GF(2) bit-matrix product.

Counterpart of atsc_tpu/ops/rs_encode.py (reference src/atsc/
reed_solomon.h:192-242). The code is GF(2)-linear, so parity bits = data
bits @ M (mod 2) with the (1496, 160) binary matrix of
tables.galois.rs_bit_matrix: one (B*312, 1496) x (1496, 160) product.

The JAX package takes it as an int8 x int8 -> int32 dot; CUDA matmul takes
no integer operands, so here it is a float32 product reduced `& 1`. That
is exact: the operands are 0/1 and every sum is an integer <= 1496 < 2^24.
It stays exact under TF32 too (0 and 1 are exact there and the sum is
accumulated in float32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.galois import rs_bit_matrix

_BIT_SHIFTS = np.arange(7, -1, -1, dtype=np.uint8)  # MSB-first bit order


@functools.lru_cache(maxsize=1)
def _matrix() -> np.ndarray:
    return rs_bit_matrix().astype(np.float32)  # (1496, 160) of 0/1


@functools.lru_cache(maxsize=1)
def _shifts() -> np.ndarray:
    return _BIT_SHIFTS


@functools.lru_cache(maxsize=1)
def _weights() -> np.ndarray:
    return (1 << _BIT_SHIFTS.astype(np.int32)).astype(np.int32)


def rs_encode_field(rand: torch.Tensor) -> torch.Tensor:
    """(B, 312, 207) uint8 with zeroed parity -> (B, 312, 207) RS-encoded."""
    b = rand.shape[0]
    dev = rand.device
    data = rand[:, :, : P.SEGMENT_BYTES]  # (B, 312, 187)

    bits = (data[..., None] >> const(_shifts, dev)) & 1  # MSB-first
    bits = bits.reshape(b * P.DATA_SEGMENTS, P.SEGMENT_BYTES * 8)
    sums = bits.to(torch.float32) @ const(_matrix, dev)  # (B*312, 160)
    parity_bits = sums.to(torch.int32) & 1

    pb = parity_bits.reshape(b, P.DATA_SEGMENTS, P.RS_BYTES, 8)
    parity = (pb * const(_weights, dev)).sum(dim=-1).to(torch.uint8)
    return torch.cat([data, parity], dim=-1)
