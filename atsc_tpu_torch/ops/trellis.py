"""12-way interleaved 2/3-rate trellis encoder as byte-level XOR prefixes.

Counterpart of atsc_tpu/ops/trellis.py (reference src/atsc/trellis.h;
the bit-serial model is trellis.h:10-51). Each byte is consumed MSB-first
as bit pairs; the upper bit X2 feeds a differential precoder, the lower
bit X1 is emitted as z1 and feeds a 2-delay feedback encoder whose output
z0 is the pre-update state. The 2-delay recurrence splits into two
differential chains on alternating X1 bits, so all three recurrences are
XOR prefixes, and within a byte the four bit-pair planes combine with O(1)
XOR algebra: only the per-byte parities

    S2 = x2_0^x2_1^x2_2^x2_3   (precoder),
    Su = x1_0^x1_2             (even-step conv chain),
    Sv = x1_1^x1_3             (odd-step conv chain)

need a prefix over the 5,382 bytes of each encoder. The JAX package takes
that prefix as a blocked bf16 matmul against a triangular ones matrix (a
TPU idiom); here it is an int32 cumsum reduced `& 1`, exact because every
partial sum is <= the byte count (5,382 a field). With E* the exclusive
prefix of S*, per symbol s = 4t + p (byte t, plane p):

    z2[4t+p]   = E2[t] ^ (x2_0^..^x2_p)[t] ^ d
    z0[4t+0]   = Ev[t] ^ d1          z0[4t+1] = Eu[t] ^ x1_0[t] ^ d2
    z0[4t+2]   = Ev[t] ^ x1_1[t] ^ d1
    z0[4t+3]   = Eu[t] ^ x1_0[t] ^ x1_2[t] ^ d2
    z1[4t+p]   = x1_p[t]
"""

from __future__ import annotations

import torch

from atsc_tpu_torch import params as P


def _byte_excl_scan(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive XOR prefix over the byte axis.

    s: (B, 12, n) int32 in {0,1}. Returns (excl (B, 12, n) in {0,1},
    total (B, 12) in {0,1})."""
    incl = torch.cumsum(s, dim=-1, dtype=torch.int32)
    return (incl - s) & 1, incl[..., -1] & 1


def trellis_planes(
    il: torch.Tensor, d: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plane algebra over a byte axis of any length.

    il: (B, 12, n) uint8; d/d1/d2: (B, 12) int32 carries in {0, 1}.
    Returns ([plane_0, .., plane_3], t2, tu, tv): plane p (B, 12, n) int8
    holds the symbol of bit pair p of every byte (stream position 4t + p),
    and t2/tu/tv (B, 12) are the XOR totals of S2/Su/Sv over all n bytes.
    """
    x = il.to(torch.int32)

    # bit-pair planes, MSB-first: pair p uses bits (7-2p, 6-2p)
    x2 = [(x >> k) & 1 for k in (7, 5, 3, 1)]
    x1 = [(x >> k) & 1 for k in (6, 4, 2, 0)]

    s2 = x2[0] ^ x2[1] ^ x2[2] ^ x2[3]
    su = x1[0] ^ x1[2]
    sv = x1[1] ^ x1[3]

    e2, t2 = _byte_excl_scan(s2)
    eu, tu = _byte_excl_scan(su)
    ev, tv = _byte_excl_scan(sv)

    dc = d[..., None]
    d1c = d1[..., None]
    d2c = d2[..., None]

    p2 = [x2[0], x2[0] ^ x2[1], x2[0] ^ x2[1] ^ x2[2], s2]
    z2 = [e2 ^ pp ^ dc for pp in p2]
    z0 = [
        ev ^ d1c,
        eu ^ x1[0] ^ d2c,
        ev ^ x1[1] ^ d1c,
        eu ^ x1[0] ^ x1[2] ^ d2c,
    ]
    planes = [(z2[p] * 4 + x1[p] * 2 + z0[p]).to(torch.int8) for p in range(4)]
    return planes, t2, tu, tv


def trellis_encode_field(
    il: torch.Tensor, d: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode one interleaved field.

    il: (B, 12, 5382) uint8 in encoder-major layout (from
    interleave_field_enc_major). d/d1/d2: (B, 12) int32 per-encoder carries.
    Returns (symbols, d, d1, d2) with symbols (B, 12, 21528) int8 in
    encoder-major stream order (byte*4 + bit-pair along the last axis).
    """
    planes, t2, tu, tv = trellis_planes(il, d, d1, d2)
    symbols = torch.stack(planes, dim=-1).reshape(
        il.shape[0], P.TRELLIS_ENCODERS, P.TRELLIS_SYMBOLS_PER_ENCODER
    )

    d_new = (t2 + d) & 1
    d1_new = (tv + d1) & 1
    d2_new = (tu + d2) & 1
    return symbols, d_new, d1_new, d2_new
