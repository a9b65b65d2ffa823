"""Trellis output-commutator gather table and bit-plane layout constants.

Behavioral spec: reference src/atsc/trellis.h — 12 interleaved 2/3-rate
trellis encoders consume 414 rounds x 12 encoders x 13 bytes; each byte is
encoded MSB-first as bit pairs (7,6),(5,4),(3,2),(1,0); the output
commutator places symbol i of data-segment `dseg` (produced by encoder
(dseg*4 + i) mod 12) at padded-field position (dseg+1)*832 + 4 + i
(trellis.h:549-576).

TPU-first reformulation: the trellis state recurrences are XOR prefix
scans (cumsum mod 2) over per-encoder bit streams — see ops/trellis.py.
The commutator becomes one precomputed *gather*: for each data-symbol slot
of the padded field, the index of its source symbol in the (encoder-major)
flattened symbol array. Combined with the field/segment sync constants this
lets the whole "assemble symbols" stage be a single fused gather/select.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P


@functools.lru_cache(maxsize=1)
def commutator_gather() -> tuple[np.ndarray, np.ndarray]:
    """Returns (positions, sources).

    positions: (258336,) int32 padded-field indices of the data symbols.
    sources:   (258336,) int32 indices into the flattened per-round symbol
               stream laid out as (rounds=414, encoders=12, 52 symbols/encode)
               — i.e. source = round*624 + encoder*52 + within_encode.
    """
    n = P.DATA_SYMBOLS_PER_FIELD
    index = np.arange(n, dtype=np.int64)
    dseg = index // P.DATA_SYMBOLS_PER_SEGMENT
    dseg_offset = index % P.DATA_SYMBOLS_PER_SEGMENT
    trellis = (dseg * 4 + index) % P.TRELLIS_ENCODERS
    trellis_index = (index // P.TRELLIS_ENCODERS) % 52
    chunk = index // (52 * P.TRELLIS_ENCODERS)
    source = chunk * 52 * P.TRELLIS_ENCODERS + trellis * 52 + trellis_index
    position = (dseg + 1) * P.SYMBOLS_PER_SEGMENT + 4 + dseg_offset
    return position.astype(np.int32), source.astype(np.int32)


@functools.lru_cache(maxsize=1)
def padded_field_gather() -> tuple[np.ndarray, np.ndarray]:
    """Dense gather over the whole padded field.

    Returns (is_data, src): is_data[p]=1 iff position p is a data-symbol
    slot; src[p] = index into the (414*12*52,) round-major symbol stream
    (0 where not a data slot).
    """
    position, source = commutator_gather()
    is_data = np.zeros(P.PADDED_SYMBOLS, dtype=bool)
    src = np.zeros(P.PADDED_SYMBOLS, dtype=np.int32)
    is_data[position] = True
    src[position] = source
    return is_data, src


@functools.lru_cache(maxsize=1)
def encoder_stream_to_round_major() -> np.ndarray:
    """Permutation mapping (encoder, symbol#) -> round-major stream index.

    The scan-friendly layout keeps each encoder's 21,528-symbol stream
    contiguous: sym_enc[(e, s)] with s = round*52 + within.  The commutator
    sources index the round-major layout (round, encoder, within).  This
    permutation converts between them: round_major[i] = enc_major[perm[i]].
    """
    rounds, encs, per = P.TRELLIS_ROUNDS, P.TRELLIS_ENCODERS, 52
    r, e, w = np.meshgrid(
        np.arange(rounds), np.arange(encs), np.arange(per), indexing="ij"
    )
    # index into (encoders, rounds*52) flattened array
    return (e * rounds * per + r * per + w).reshape(-1).astype(np.int32)
