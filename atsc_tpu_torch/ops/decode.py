"""Symbol-domain receive chain: the exact inverses of the transmit FEC
stages, recovering transport-stream bytes from 8VSB symbol fields.

Counterpart of atsc_tpu/ops/decode.py (the reference has no receive path;
its RS decoder is dead code, reference src/atsc/reed_solomon.h:41-190):

    field symbols -> de-commutate (gather) -> trellis decode (local XOR)
    -> de-interleave (gather vs previous field) -> RS(207,187) correction
    (ops/rs_decode.py) -> de-randomize -> TS packets

* De-commutator: the inverse of the commutator gather — the data slots of
  the padded field, back in encoder-major stream order.
* Trellis decode: hard-decision and local. z1 IS the lower input bit
  (reference trellis.h:23-34) and the differential precoder inverts as
  X2[s] = z2[s] XOR z2[s-1] (trellis.h:12-21), so only one z2 bit per
  encoder is carried. The z0 redundancy bit is unused here.
* De-interleaver: the reference's scatter table is the deinterleave
  gather; RS field N gathers from received fields N and N+1 (one field of
  latency; the previous received field is the carried state).
* De-randomizer: the PN XOR is self-inverse; the 0x47 syncs go back in.
* Erasure flags ride the same gathers (propagate_erasure_flags), so each
  RS codeword learns which of its bytes came from flagged symbols.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.interleave import _scatter_table
from atsc_tpu_torch.tables.randomizer import randomizer_table
from atsc_tpu_torch.tables.trellis_tables import (
    commutator_gather,
    encoder_stream_to_round_major,
)

_NSYM = P.TRELLIS_SYMBOLS_PER_ENCODER       # 21,528 symbols per encoder
_NB = P.TRELLIS_BYTES_PER_ENCODER           # 5,382 bytes per encoder
_LEN = P.DATA_PER_FIELD                     # 64,584


@functools.lru_cache(maxsize=1)
def _decommutate_src() -> np.ndarray:
    """(12*21528,) int64: padded-field position of each encoder-major
    trellis symbol (inverse of the assemble stage's gather)."""
    position, source = commutator_gather()   # round-major source indices
    perm = encoder_stream_to_round_major()   # round_major[i] = enc_major[perm[i]]
    table = np.full(P.TRELLIS_ENCODERS * _NSYM, -1, dtype=np.int64)
    table[perm[source]] = position
    if (table < 0).any():
        raise AssertionError("the de-commutator must cover every trellis symbol")
    return table


@functools.lru_cache(maxsize=1)
def _deinterleave_src() -> np.ndarray:
    """(64584,) int64 gather into concat([cur, prev]) interleaved fields
    (round-major byte order): RS field N's byte i sits at pos[i] of
    interleaved field N + field_bit[i] — cur is field N+1 here."""
    scatter = _scatter_table()
    pos = (scatter & 0xFFFF).astype(np.int64)
    field_bit = (scatter >> 16).astype(np.int64)
    return pos + _LEN * (1 - field_bit)


@functools.lru_cache(maxsize=1)
def _weights2() -> np.ndarray:
    return np.array([128, 32, 8, 2], dtype=np.int32)


@functools.lru_cache(maxsize=1)
def _weights1() -> np.ndarray:
    return np.array([64, 16, 4, 1], dtype=np.int32)


@functools.lru_cache(maxsize=1)
def _randomizer() -> np.ndarray:
    return randomizer_table()


def decommutate_field(field: torch.Tensor) -> torch.Tensor:
    """(B, >=260416) symbol field (any dtype) -> (B, 12, 21528) trellis
    symbols of the same dtype, in encoder-major stream order."""
    syms = torch.index_select(field, -1, const(_decommutate_src, field.device))
    return syms.reshape(field.shape[0], P.TRELLIS_ENCODERS, _NSYM)


def trellis_decode_field(
    symbols: torch.Tensor, z2_prev: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert the 12-way trellis encode (hard-decision).

    symbols: (B, 12, 21528) int8 3-bit symbols (encoder-major);
    z2_prev: (B, 12) int32 — last z2 bit of each encoder's previous field
    (0 at cold start, matching the encoder's zeroed initial state).
    Returns (bytes (B, 12, 5382) uint8, new z2_prev (B, 12) int32).

    The bit planes stay uint8. The byte sum is taken in int32 and cast:
    torch.sum of uint8 promotes to int64 (jnp.sum(..., dtype=uint8) has
    no direct twin), and each byte is exactly <= 255, so the cast is exact.
    """
    s = symbols.to(torch.uint8)
    z2 = (s >> 2) & 1
    x1 = (s >> 1) & 1                          # z1 = X1 verbatim
    z2_shifted = torch.cat(
        [z2_prev.to(torch.uint8)[..., None], z2[..., :-1]], dim=-1
    )
    x2 = z2 ^ z2_shifted                       # differential decode
    return pack_trellis_bytes(x2, x1), z2[..., -1].to(torch.int32)


def pack_trellis_bytes(x2: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """(B, 12, 21528) input bit-pair planes -> (B, 12, 5382) uint8 bytes
    (MSB-first pairs: pair p occupies bits (7-2p, 6-2p))."""
    b = x2.shape[0]
    x2p = x2.reshape(b, P.TRELLIS_ENCODERS, _NB, 4).to(torch.int32)
    x1p = x1.reshape(b, P.TRELLIS_ENCODERS, _NB, 4).to(torch.int32)
    dev = x2.device
    packed = x2p * const(_weights2, dev) + x1p * const(_weights1, dev)
    return packed.sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def enc_major_to_round_major(bytes_enc: torch.Tensor) -> torch.Tensor:
    """(B, 12, 5382) encoder-major bytes -> (B, 64584) round-major
    interleaved field (j = (round*12 + enc)*13 + col)."""
    b = bytes_enc.shape[0]
    x = bytes_enc.reshape(
        b, P.TRELLIS_ENCODERS, P.TRELLIS_ROUNDS, P.TRELLIS_INPUT_BYTES
    )
    return x.permute(0, 2, 1, 3).reshape(b, _LEN)


def deinterleave_field(
    cur_il: torch.Tensor, prev_il: torch.Tensor
) -> torch.Tensor:
    """Recover the RS field whose bytes span the two received fields.

    cur_il/prev_il: (B, 64584) uint8 round-major interleaved fields N+1
    and N. Returns RS field N (B, 64584) uint8.
    """
    both = torch.cat([cur_il, prev_il], dim=-1)
    return torch.index_select(both, -1, const(_deinterleave_src, both.device))


def propagate_erasure_flags(
    flag_field: torch.Tensor, prev_flag_il: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry per-symbol unreliability flags through the inverse chain.

    A symbol flagged unreliable (e.g. by the receiver's burst detector,
    ops/erasures.py) marks its trellis byte, which lands in some RS
    codeword position: the same gathers decode_field uses move the flags,
    so each codeword learns which of its bytes came from flagged symbols
    and RS can treat them as erasures.

    flag_field: (B, >=260416) uint8/bool flags of received field k;
    prev_flag_il: (B, 64584) uint8 carried flags (previous field).
    Returns (codeword flags (B, 312, 207) uint8 for RS field k-1, new
    carried flags (B, 64584) uint8).
    """
    f = decommutate_field(flag_field.to(torch.uint8))
    b = f.shape[0]
    fb = f.reshape(b, P.TRELLIS_ENCODERS, _NB, 4).amax(dim=-1)
    cur = enc_major_to_round_major(fb)
    rs = deinterleave_field(cur, prev_flag_il)
    return rs.reshape(b, P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES), cur


def derandomize_field(rs_data: torch.Tensor) -> torch.Tensor:
    """(B, 312, 207) uint8 corrected codewords -> (B, 58656) uint8 TS
    packets (PN XOR undone, 0x47 sync bytes re-inserted)."""
    b = rs_data.shape[0]
    payload = rs_data[..., : P.SEGMENT_BYTES] ^ const(_randomizer, rs_data.device)
    sync = torch.full((b, P.DATA_SEGMENTS, 1), 0x47, dtype=torch.uint8,
                      device=rs_data.device)
    pkts = torch.cat([sync, payload], dim=-1)
    return pkts.reshape(b, P.FIELD_TS_BYTES)
