"""Convolutional interleaver stage: one gather into concat(cur, prev).

Counterpart of atsc_tpu/ops/interleave.py (reference src/atsc/
interleaver.h:11-19): the interleaver scatter inverted into a gather over
output positions that selects from the current or the previous field's RS
output, composed with the trellis stage's encoder-major byte order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.interleave import gather_tables


@functools.lru_cache(maxsize=1)
def _combined_src_enc_major() -> np.ndarray:
    """Gather index into concat([cur, prev]) (src + 64584*from_prev), with
    round-major j = (r*12 + e)*13 + c reordered encoder-major
    m = (e*414 + r)*13 + c, flattened to (64584,) int64."""
    src, from_prev = gather_tables()
    idx = src.astype(np.int64) + P.DATA_PER_FIELD * from_prev.astype(np.int64)
    idx = idx.reshape(P.TRELLIS_ROUNDS, P.TRELLIS_ENCODERS, P.TRELLIS_INPUT_BYTES)
    return np.ascontiguousarray(idx.transpose(1, 0, 2)).reshape(-1)


def interleave_field_enc_major(
    cur_rs: torch.Tensor, prev_rs: torch.Tensor
) -> torch.Tensor:
    """(B, 64584) current + previous RS fields -> (B, 12, 5382) interleaved
    bytes in encoder-major layout (the trellis stage's native input)."""
    both = torch.cat([cur_rs, prev_rs], dim=-1)  # (B, 129168)
    il = torch.index_select(both, 1, const(_combined_src_enc_major, both.device))
    return il.reshape(cur_rs.shape[0], P.TRELLIS_ENCODERS, -1)
