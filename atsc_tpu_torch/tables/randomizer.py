"""Data-randomizer PN table (ATSC A/53 §5.2.1).

Behavioral spec: reference src/atsc/randomize.h:12-36. A 16-bit LFSR with
generator polynomial x16+x13+x12+x11+x7+x6+x3+x1 (0x9c65), initial state
0xf180, re-initialized every field. The output byte is a non-contiguous
8-bit tap of the state:

    out bit 7..4 <- state bits 13..10
    out bit 3    <- state bit 6
    out bit 2..1 <- state bits 3..2
    out bit 0    <- state bit 0

The table covers exactly 187*312 bytes (one field of payload), sampled
*before* each state advance. On advance, the state shifts left and the
generator is folded back in when bit 16 pops out.

The whole randomizer stage at runtime is then a single XOR with this table
plus zeroing of the 20 parity slots per segment — one fused elementwise op
on TPU.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P

_GENERATOR = 0x9C65
_INITIAL_STATE = 0xF180


@functools.lru_cache(maxsize=1)
def randomizer_table() -> np.ndarray:
    """(312, 187) uint8 whitening bytes, one row per segment."""
    n = P.SEGMENT_BYTES * P.DATA_SEGMENTS
    table = np.empty(n, dtype=np.uint8)
    state = _INITIAL_STATE
    for i in range(n):
        out = (state & 0x3C00) >> 6
        out |= (state & 0x0040) >> 3
        out |= (state & 0x000C) >> 1
        out |= state & 0x0001
        table[i] = out
        state <<= 1
        if state & 0x10000:
            state ^= (_GENERATOR << 1) | 1
    return table.reshape(P.DATA_SEGMENTS, P.SEGMENT_BYTES)


def randomize_field_np(ts_field: np.ndarray) -> np.ndarray:
    """Numpy oracle: (312*188,) TS bytes -> (312, 207) with parity slots zeroed."""
    pkts = ts_field.reshape(P.DATA_SEGMENTS, P.MPEG2_BYTES)
    out = np.zeros((P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES), dtype=np.uint8)
    out[:, : P.SEGMENT_BYTES] = pkts[:, 1:] ^ randomizer_table()
    return out
