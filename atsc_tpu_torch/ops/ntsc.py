"""NTSC co-channel interference rejection: 12-symbol comb filter +
partial-response Viterbi decoding.

Counterpart of atsc_tpu/ops/ntsc.py. A comb H(z) = 1 - z^-12 at the symbol
rate puts spectral nulls every fs/12 = 897 kHz, near the visual, chroma and
audio carriers of a co-channel analog transmitter, and turns the 8-level
signal into a 15-level partial-response one that the trellis code keeps
ML-decodable.

Because the output commutator interleaves the 12 trellis encoders symbol by
symbol, the comb's 12-symbol delay is exactly one step in each encoder's
own stream: within a segment it is the same encoder's previous symbol;
across segment boundaries the last symbols of the previous segment belong
to the right encoders; across the field boundary the field sync's 12
reserved symbols are copies of the previous field's last 12 data symbols.
The only exception is the 4 symbols per segment whose delayed reference
lands on a segment-sync symbol: per-step "reset" branches against the known
+-5 sync levels (_pr_reset_tables). So the PR Viterbi is a per-encoder ACS
over the combined state (trellis state x previous symbol), 16 reachable
states, run by ops/cuda/viterbi_acs.py (the kernels for a CUDA tensor,
their plain twins for a CPU tensor), and n_chunks > 1 through their chunked
instantiations (the chunk-parallel near-MLSE of ops/viterbi.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.ops.cuda.viterbi_acs import viterbi_pr_field, viterbi_pr_field_chunked
from atsc_tpu_torch.ops.viterbi import _PRED0, _PRED1

_NSYM = P.TRELLIS_SYMBOLS_PER_ENCODER   # 21,528
_N = P.SYMBOLS_PER_FIELD
_SEG = P.SYMBOLS_PER_SEGMENT            # 832
_BIG = 1e9
_COMB_DELAY = 12
_SYNC_LEVELS = np.array([5.0, -5.0, -5.0, 5.0], dtype=np.float32)


def comb_field(levels: torch.Tensor) -> torch.Tensor:
    """(B, >=260416) soft levels -> (B, 260416) combed observations
    y[p] = lev[p] - lev[p-12]. The first 12 outputs are head garbage but
    harmless: the first data symbol of a field sits at position 836 and
    references position 824 (a reserved-symbol slot inside the same field),
    so every gathered data observation is valid."""
    lev = levels[..., :_N]
    shifted = torch.cat(
        [torch.zeros_like(lev[..., :_COMB_DELAY]), lev[..., :-_COMB_DELAY]], dim=-1)
    return lev - shifted


@functools.lru_cache(maxsize=1)
def _pr_reset_tables() -> tuple[np.ndarray, np.ndarray]:
    """(reset (21528, 12) bool, const (21528, 12) float32): per encoder-
    major symbol (k, e), whether its comb reference lands on a known
    segment-sync symbol, and that symbol's (pilot-free) level. Validates
    the every-delay-is-one-encoder-step structure by construction."""
    from atsc_tpu_torch.ops.decode import _decommutate_src

    src = _decommutate_src().reshape(P.TRELLIS_ENCODERS, _NSYM)
    q = src - _COMB_DELAY                 # delayed reference position
    seg, off = np.divmod(q, _SEG)
    reset = (seg >= 1) & (off < 4)        # segment-sync slots
    const = np.where(reset, _SYNC_LEVELS[np.clip(off, 0, 3)], 0.0)
    # every non-reset reference must be the same encoder's previous symbol
    # (k >= 1) or a reserved-symbol copy of it (k = 0)
    prev_p = np.empty_like(src)
    prev_p[:, 0] = -1
    prev_p[:, 1:] = src[:, :-1]
    reserved = (seg == 0) & (off >= _SEG - P.RESERVED_SYMBOLS)
    ok = reset | (q == prev_p) | (reserved & (np.arange(_NSYM) == 0))
    if not ok.all():
        raise AssertionError("comb structure violated: commutator tables changed?")
    return (
        np.ascontiguousarray(reset.T),
        np.ascontiguousarray(const.T.astype(np.float32)),
    )


@functools.lru_cache(maxsize=1)
def _pr_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(lv (16,) float32 emitted level of combined state u = s*4 + h,
    s_pred (16,) int32 its predecessor trellis state, pred_idx (16, 4)
    int32 predecessor combined states, prev_lev (16, 4) float32 the
    predecessor symbol's level per hypothesis h_prev)."""
    u = np.arange(16)
    s2, h = u >> 2, u & 3
    x1 = h & 1
    v = 2 * h + (s2 & 1)
    lv = (2 * v - 7).astype(np.float32)
    s_pred = np.where(x1 == 1, _PRED1[s2], _PRED0[s2]).astype(np.int32)
    pred_idx = (s_pred[:, None] * 4 + np.arange(4)).astype(np.int32)
    prev_lev = (2 * (2 * np.arange(4)[None, :] + (s_pred[:, None] & 1)) - 7
                ).astype(np.float32)
    return lv, s_pred, pred_idx, prev_lev


def init_pr_metrics(batch: int, *, device: str | torch.device) -> torch.Tensor:
    """(B, 12, 16) float32 cold-start metrics: the encoder starts in trellis
    state 0 having just 'emitted' symbol 0 (the reserved-symbol
    initialization, reference src/atsc/atsc.cpp:24-26) -> only u = 0."""
    m = torch.full((batch, P.TRELLIS_ENCODERS, 16), _BIG, dtype=torch.float32,
                   device=resolve_device(device))
    m[..., 0] = 0.0
    return m


def viterbi_pr_decode_field(
    y: torch.Tensor, z2_prev: torch.Tensor, metrics: torch.Tensor,
    n_chunks: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PR twin of ops.viterbi.viterbi_decode_field: combed observations
    y (B, 12, T) float32 in, trellis bytes out. Returns (bytes (B, 12, T/4)
    uint8, new z2_prev (B, 12) int32, new metrics (B, 12, 16)). n_chunks
    > 1: chunk-parallel near-MLSE (ops.viterbi.viterbi_decode_field), each
    chunk's step reading its own rows of the reset/const tables."""
    if n_chunks <= 1:
        return viterbi_pr_field(y, z2_prev, metrics)
    return viterbi_pr_field_chunked(y, z2_prev, metrics, n_chunks)


def detect_ntsc(levels, per_channel: bool = False):
    """Decide whether the comb path beats the plain path for this signal.

    Compares hard-slicer residual power on the plain 8-level field with that
    on the combed 15-level field: white noise doubles through the comb, so
    a clean or AWGN capture picks plain, while narrowband co-channel energy
    (which the comb nulls) inflates only the plain residual. levels:
    (B, >=260416) float32 soft levels of one field (a tensor on any device,
    or numpy); the votes are taken on the host in float32 numpy, the JAX
    package's arithmetic, so both packages vote alike.

    Returns one bool over the whole batch by default; per_channel=True
    returns a (B,) bool array.
    """
    if isinstance(levels, torch.Tensor):
        levels = levels[..., :_N].cpu().numpy()
    lev = np.atleast_2d(np.asarray(levels, np.float32))[..., :_N]
    r_plain = lev - P.PILOT_OFFSET
    r_plain = r_plain - np.clip(np.rint((r_plain + 7) / 2) * 2 - 7, -7, 7)
    y = lev[..., _COMB_DELAY:] - lev[..., :-_COMB_DELAY]
    r_comb = y - np.clip(np.rint(y / 2) * 2, -14, 14)
    votes = np.mean(r_comb**2, axis=-1) < np.mean(r_plain**2, axis=-1)
    return votes if per_channel else bool(
        np.mean(r_comb**2) < np.mean(r_plain**2)
    )
