"""Soft-decision Viterbi decoding of the 8VSB trellis code.

Counterpart of atsc_tpu/ops/viterbi.py. The hard-decision inverse in
ops/decode.py reads the coded bits off sliced symbols and discards the z0
redundancy bit; this module decodes the rate-2/3 trellis (reference
src/atsc/trellis.h:10-51: Z2 = X2 precoded, Z1 = X1, Z0 = D1 with
D1 <- X1^D2, D2 <- D1) from soft levels by maximum-likelihood sequence
estimation, buying the ~3.5 dB the code was put there for.

The 4-state ACS (the uncoded Z2 bit is a pair of parallel branches,
resolved by a min over the two candidate levels) and the traceback run in
ops/cuda/viterbi_acs.py: the CUDA kernels for a CUDA tensor, their plain
twins for a CPU tensor. The 4 path metrics carry across fields (the encoder
never resets), and each field commits its own traceback from the best final
state. n_chunks > 1 is the chunk-parallel near-MLSE, through the chunked
instantiations of the same kernels: each encoder stream is decoded as
n_chunks windows with 128 steps of context on either side (_chunk_plan),
n_chunks times less sequential depth.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.ops.cuda.viterbi_acs import viterbi_field, viterbi_field_chunked
from atsc_tpu_torch.ops.decode import pack_trellis_bytes  # noqa: F401  (public here too)

_NSYM = P.TRELLIS_SYMBOLS_PER_ENCODER   # 21,528
_NB = P.TRELLIS_BYTES_PER_ENCODER       # 5,382
_BIG = 1e9

# state s = 2*D1 + D2; transition on X1: Z0 = D1, s' = 2*(X1^D2) + D1.
# For new state s' = 2a + b: predecessor (D1=b, D2=a^X1) = 2b + (a^X1).
_PRED0 = np.array([0, 2, 1, 3], dtype=np.int32)   # X1 = 0
_PRED1 = np.array([1, 3, 0, 2], dtype=np.int32)   # X1 = 1
_B_OF = np.array([0, 1, 0, 1], dtype=np.int32)    # Z0 of every branch into s'


@functools.lru_cache(maxsize=1)
def _constellation() -> np.ndarray:
    """(8,) float32 level of symbol v = 4*Z2 + 2*Z1 + Z0 (pilot included)."""
    v = np.arange(8, dtype=np.float32)
    return v * 2 - 7 + np.float32(P.PILOT_OFFSET)


def init_metrics(batch: int, *, device: str | torch.device) -> torch.Tensor:
    """(B, 12, 4) float32 path metrics at a cold start: the encoder's delay
    registers are zeroed, so only state 0 is reachable."""
    m = torch.full((batch, P.TRELLIS_ENCODERS, 4), _BIG, dtype=torch.float32,
                   device=resolve_device(device))
    m[..., 0] = 0.0
    return m


def _chunk_plan(t: int, n_chunks: int, warmup: int):
    """Static chunking layout: n_chunks equal windows of length
    L + 2*warmup, clamped inside [0, t) (so the first window has no left
    warmup and the last has a doubled one), plus the per-chunk offset of
    the kept L-symbol region inside its window."""
    if t % n_chunks:
        raise ValueError(f"{n_chunks} chunks must divide {t}")
    length = t // n_chunks
    w = length + 2 * warmup
    if w > t:
        raise ValueError("warmup too large for this chunk count")
    starts = np.clip(np.arange(n_chunks) * length - warmup, 0, t - w)
    offs = np.arange(n_chunks) * length - starts
    return length, w, starts, offs


def viterbi_decode_field(
    levels: torch.Tensor, z2_prev: torch.Tensor, metrics: torch.Tensor,
    n_chunks: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-decision twin of ops.decode.trellis_decode_field.

    levels: (B, 12, T) float32 soft levels, or int8 soft-level codes at
    SOFT_LEVEL_SCALE (dequantized in the ACS by the same float32 multiply
    by SOFT_LEVEL_INV), T a multiple of 24 (a field is 21,528 = 24 * 897);
    z2_prev: (B, 12) int32 differential-precoder state; metrics: (B, 12, 4)
    carried path metrics. Returns (bytes (B, 12, T/4) uint8, new z2_prev,
    new metrics). n_chunks > 1: chunk-parallel near-MLSE (chunk 0 starts
    from the carried metrics, the others flat at 0; the new metrics are the
    last chunk's; exact at the field head and across fields, each interior
    seam converging to the MLSE path within the warmup whp).
    """
    if n_chunks <= 1:
        return viterbi_field(levels, z2_prev, metrics)
    return viterbi_field_chunked(levels, z2_prev, metrics, n_chunks)
