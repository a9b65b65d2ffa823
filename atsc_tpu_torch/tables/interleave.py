"""Convolutional byte interleaver, fused with trellis pre-permutations.

Behavioral spec: reference src/atsc/interleaver.h (B=52-branch, M=4-byte
convolutional interleaver, fused at table-build time with the trellis
commutator rotation at segment boundaries and the 12-encoder transpose so
the trellis stage consumes 13 contiguous bytes per encoder per round).
The vestigial decomposed form in reference src/common/interleaver.h
documents the same permutations separately.

The reference materializes a *scatter* table: input byte i of field N lands
at position table[i] of field N or N+1.  Scatters are expensive on TPU, so
we invert it host-side into two *gather* vectors over output positions:

    out_field_N[p] = (prev_rs_field if FROM_PREV[p] else cur_rs_field)[SRC[p]]

Runtime is then one `jnp.where(from_prev, prev[src], cur[src])` — a pair of
gathers fused by XLA — with the previous field's RS output as the only
carried state.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P

_LEN = P.DATA_PER_FIELD  # 64,584


@functools.lru_cache(maxsize=1)
def _scatter_table() -> np.ndarray:
    """Reproduce the reference's fused scatter table (interleaver.h:22-108).

    Entry i = destination of input byte i: (field_bit << 16) | position,
    field_bit 1 meaning "lands in the *next* output field".
    """
    # Trellis commutator phase boundaries: ceil(207*i/12)*12 for i in [0, 936).
    shift_points = [
        ((P.SEGMENT_FEC_BYTES * i + P.TRELLIS_ENCODERS - 1) // P.TRELLIS_ENCODERS)
        * P.TRELLIS_ENCODERS
        for i in range(P.DATA_SEGMENTS * 3)
    ]
    boundary_iter = iter(shift_points[1:])
    next_boundary = next(boundary_iter)
    shift = 0

    table = np.zeros(_LEN, dtype=np.uint32)
    # 52 delay lines; line k delays its bytes by 4*k positions (FIFO depth 4*k).
    fifo = [np.full(4 * k, -1, dtype=np.int64) for k in range(52)]
    idx = [0] * 52

    group_size = P.TRELLIS_INPUT_BYTES * P.TRELLIS_ENCODERS  # 156
    line = 0
    for pos in range(_LEN * 2):
        if pos == next_boundary:
            next_boundary = next(boundary_iter)
            shift = (shift + 4) % P.TRELLIS_ENCODERS

        # trellis transpose: regroup so each encoder gets 13 contiguous bytes
        group, rem = divmod(pos, group_size)
        row = rem // P.TRELLIS_ENCODERS
        col = (pos + shift) % P.TRELLIS_ENCODERS
        destination = group * group_size + col * P.TRELLIS_INPUT_BYTES + row

        if destination >= _LEN:
            destination = (destination - _LEN) | (1 << 16)

        if line == 0:
            if pos < _LEN:
                table[pos] = destination
        else:
            r = fifo[line][idx[line]]
            fifo[line][idx[line]] = pos
            if 0 <= r < _LEN:
                table[r] = destination
            idx[line] = (idx[line] + 1) % (4 * line)

        line += 1
        if line == 52:
            line = 0
        if pos == _LEN - 1:
            line = 0  # commutator restarts at each field boundary
    return table


@functools.lru_cache(maxsize=1)
def gather_tables() -> tuple[np.ndarray, np.ndarray]:
    """(src, from_prev): for each output position p of a field,
    src[p] = source byte index, from_prev[p] = 1 if it comes from the
    previous input field (0 = current). Exact inverse of the scatter table.
    """
    scatter = _scatter_table()
    pos = (scatter & 0xFFFF).astype(np.int64)
    field_bit = (scatter >> 16).astype(np.int64)

    src = np.full(_LEN, -1, dtype=np.int32)
    from_prev = np.zeros(_LEN, dtype=np.int32)
    # current-field deliveries: input i of field N -> position pos[i] of field N
    cur_mask = field_bit == 0
    src[pos[cur_mask]] = np.nonzero(cur_mask)[0].astype(np.int32)
    # next-field deliveries: input i of field N-1 -> position pos[i] of field N
    nxt_mask = field_bit == 1
    src_prev = np.nonzero(nxt_mask)[0].astype(np.int32)
    src[pos[nxt_mask]] = src_prev
    from_prev[pos[nxt_mask]] = 1

    assert (src >= 0).all(), "interleaver inversion must cover every output byte"
    return src, from_prev


def interleave_field_np(
    cur_rs: np.ndarray, prev_rs: np.ndarray
) -> np.ndarray:
    """Numpy oracle: interleaved output field from current+previous RS fields."""
    src, from_prev = gather_tables()
    return np.where(from_prev.astype(bool), prev_rs[src], cur_rs[src])
