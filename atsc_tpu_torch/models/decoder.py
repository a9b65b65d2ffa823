"""The 8VSB symbol-domain field decoder: inverse pipeline + RS correction.

Counterpart of atsc_tpu/models/decoder.py (hard-decision tier). The device
core inverts commutator/trellis/interleaver per field and computes the
syndromes; Reed-Solomon correction runs, on the device too, only when some
segment's syndromes are non-zero, so a clean field costs one host sync.

Latency/state model: byte i of RS field N is spread over interleaved
fields N and N+1, so `decode_field(state, field_k)` returns TS field k-1;
the carried state is the previous received interleaved field and 12
precoder bits. A cold-start decoder fed the encoder's field 0 first
returns the encoder's virtual all-zero pre-start field (drop it), exactly
mirroring the encoder's zero-initialized interleaver buffer (reference
src/atsc/atsc.cpp:34).

Two more tiers decode soft levels instead of sliced symbols, with the same
latency: SoftDecoder (maximum-likelihood 4-state Viterbi, ops/viterbi.py,
float32 levels or int8 soft-level codes) and NtscDecoder (12-symbol comb +
16-state partial-response Viterbi, ops/ntsc.py). Every tier takes optional
per-symbol erasure flags (Decoder.decode's erasure_flags): they ride the
same gathers to the codewords, whose flagged bytes the errors-and-erasures
corrector treats as erasures. SoftDecoder and NtscDecoder take
viterbi_chunks > 1 for the chunk-parallel Viterbi (ops/viterbi.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.ops.decode import (
    decommutate_field,
    deinterleave_field,
    derandomize_field,
    enc_major_to_round_major,
    propagate_erasure_flags,
    trellis_decode_field,
)
from atsc_tpu_torch.ops.ntsc import comb_field, init_pr_metrics, viterbi_pr_decode_field
from atsc_tpu_torch.ops.rs_decode import (
    rs_correct_field,
    rs_correct_field_erasures,
    syndrome_field,
)
from atsc_tpu_torch.ops.viterbi import init_metrics, viterbi_decode_field


class DecoderState(NamedTuple):
    """Carried per-channel state; every leaf is batched (B, ...)."""

    prev_il: torch.Tensor   # (B, 64584) uint8 previous received interleaved field
    z2_prev: torch.Tensor   # (B, 12) int32 trellis precoder state (last z2)


def init_decoder_state(batch: int, *, device: str | torch.device) -> DecoderState:
    dev = resolve_device(device)
    return DecoderState(
        prev_il=torch.zeros((batch, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev),
        z2_prev=torch.zeros((batch, P.TRELLIS_ENCODERS), dtype=torch.int32, device=dev),
    )


def decode_field(
    state: DecoderState, field: torch.Tensor
) -> tuple[DecoderState, torch.Tensor, torch.Tensor]:
    """One received field for B channels, on the state's device.

    field: (B, >=260416) int8 symbol values (field k).
    Returns (new state, codewords (B, 312, 207) uint8 of RS field k-1
    *before* error correction, syndromes (B, 312, 20) uint8 — all-zero
    rows are error-free segments). Nothing is written in place; an old
    state stays valid.
    """
    syms = decommutate_field(field)
    bytes_enc, z2_new = trellis_decode_field(syms, state.z2_prev)
    cur_il, codewords, syn = _rs_stage(bytes_enc, state.prev_il)
    return DecoderState(prev_il=cur_il, z2_prev=z2_new), codewords, syn


def _rs_stage(bytes_enc: torch.Tensor, prev_il: torch.Tensor):
    """Trellis bytes (B, 12, 5382) of field k -> (round-major interleaved
    field k, codewords (B, 312, 207) of RS field k-1, syndromes)."""
    cur_il = enc_major_to_round_major(bytes_enc)
    rs = deinterleave_field(cur_il, prev_il)
    codewords = rs.reshape(rs.shape[0], P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES)
    return cur_il, codewords, syndrome_field(codewords)


class SoftDecoderState(NamedTuple):
    """Soft-path carried state: adds the Viterbi path metrics."""

    prev_il: torch.Tensor   # (B, 64584) uint8
    z2_prev: torch.Tensor   # (B, 12) int32
    metrics: torch.Tensor   # (B, 12, 4) float32 trellis path metrics


def init_soft_decoder_state(batch: int, *, device: str | torch.device) -> SoftDecoderState:
    hard = init_decoder_state(batch, device=device)
    return SoftDecoderState(prev_il=hard.prev_il, z2_prev=hard.z2_prev,
                            metrics=init_metrics(batch, device=device))


def soft_decode_field(
    state: SoftDecoderState, levels: torch.Tensor, n_chunks: int = 1
) -> tuple[SoftDecoderState, torch.Tensor, torch.Tensor]:
    """Soft-decision twin of decode_field: maximum-likelihood trellis
    decoding (ops/viterbi.py) instead of hard slicing, ~3.5 dB of coding
    gain on noisy captures.

    levels: (B, >=260416) float32 equalized soft levels (pilot offset
    included, not sliced), or int8 soft-level codes at SOFT_LEVEL_SCALE,
    which stay int8 through the decommutate gather and are dequantized in
    the ACS. Same returns and latency as decode_field.
    """
    if levels.dtype != torch.int8:
        levels = levels.to(torch.float32)
    bytes_enc, z2_new, metrics = viterbi_decode_field(
        decommutate_field(levels), state.z2_prev, state.metrics, n_chunks)
    cur_il, codewords, syn = _rs_stage(bytes_enc, state.prev_il)
    return SoftDecoderState(prev_il=cur_il, z2_prev=z2_new, metrics=metrics), codewords, syn


class NtscDecoderState(NamedTuple):
    """Comb-path carried state: 16-state partial-response path metrics."""

    prev_il: torch.Tensor   # (B, 64584) uint8
    z2_prev: torch.Tensor   # (B, 12) int32
    metrics: torch.Tensor   # (B, 12, 16) float32 PR path metrics


def init_ntsc_decoder_state(batch: int, *, device: str | torch.device) -> NtscDecoderState:
    hard = init_decoder_state(batch, device=device)
    return NtscDecoderState(prev_il=hard.prev_il, z2_prev=hard.z2_prev,
                            metrics=init_pr_metrics(batch, device=device))


def ntsc_decode_field(
    state: NtscDecoderState, levels: torch.Tensor, n_chunks: int = 1
) -> tuple[NtscDecoderState, torch.Tensor, torch.Tensor]:
    """NTSC-rejection twin of soft_decode_field: 12-symbol comb filter +
    16-state partial-response Viterbi (ops/ntsc.py), for captures with
    analog co-channel interference, which the comb nulls at a ~3 dB
    white-noise cost.

    levels: (B, >=260416) float32 equalized soft levels (pilot offset
    included, not sliced). Same returns and latency as decode_field.
    """
    y = decommutate_field(comb_field(levels.to(torch.float32)))
    bytes_enc, z2_new, metrics = viterbi_pr_decode_field(
        y, state.z2_prev, state.metrics, n_chunks)
    cur_il, codewords, syn = _rs_stage(bytes_enc, state.prev_il)
    return NtscDecoderState(prev_il=cur_il, z2_prev=z2_new, metrics=metrics), codewords, syn


class Decoder:
    """Stateful wrapper: symbol fields in, corrected TS fields out."""

    def __init__(self, batch: int = 1, *, device: str | torch.device):
        self.device = resolve_device(device)
        self.batch = batch
        self._state = init_decoder_state(batch, device=self.device)
        self._step = decode_field
        self.flag_il: torch.Tensor | None = None  # carried erasure flags
        self.segments_corrected = 0
        self.segments_uncorrectable = 0
        self.segments_erasure_assisted = 0

    @property
    def state(self) -> DecoderState:
        return self._state

    @state.setter
    def state(self, value: DecoderState) -> None:
        self._state = value

    def decode(
        self, field, erasure_flags=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(B, >=260416) int8 symbol field k (tensor or numpy; soft levels
        for the soft and NTSC decoders) -> (ts
        (B, 58656) uint8 of field k-1, n_errors (B, 312) int32; -1 marks
        uncorrectable), both host numpy.

        erasure_flags: optional (B, >=260416) uint8/bool per-symbol
        unreliability flags for the same received field (e.g. from
        ops/erasures.py's burst detector); flagged bytes are RS erasures,
        2*errors + erasures <= 20 per segment instead of errors <= 10.
        The flags carry one field of state (`flag_il`), like the symbols:
        once used, a call without flags counts as all-clear flags.

        The first call after a cold start returns the all-zero pre-start
        field (see module docstring); callers should drop it.
        """
        if not isinstance(field, torch.Tensor):
            field = torch.as_tensor(np.asarray(field))
        self._state, codewords, syn = self._step(self._state, field.to(self.device))
        cw_flags = None   # stays on the device, for the erasure corrector
        if erasure_flags is not None or self.flag_il is not None:
            if self.flag_il is None:
                self.flag_il = torch.zeros((self.batch, P.DATA_PER_FIELD),
                                           dtype=torch.uint8, device=self.device)
            if erasure_flags is None:
                flags_in = torch.zeros((self.batch, P.SYMBOLS_PER_FIELD),
                                       dtype=torch.uint8, device=self.device)
            else:
                if not isinstance(erasure_flags, torch.Tensor):
                    erasure_flags = torch.as_tensor(np.asarray(erasure_flags))
                flags_in = erasure_flags.to(self.device)
            cw_flags, self.flag_il = propagate_erasure_flags(flags_in, self.flag_il)
        n_errors = np.zeros((self.batch, P.DATA_SEGMENTS), dtype=np.int32)
        dirty = (syn != 0).any(dim=-1)
        if bool(dirty.any()):
            # the whole field in one pass: the errors-and-erasures
            # corrector where flags exist (with its per-segment
            # errors-only fallback), else the errors-only one
            if cw_flags is not None:
                codewords, n_dev = rs_correct_field_erasures(codewords, syn, cw_flags)
            else:
                codewords, n_dev = rs_correct_field(codewords, syn)
            n_errors = n_dev.cpu().numpy()
            self.segments_corrected += int((n_errors > 0).sum())
            self.segments_uncorrectable += int((n_errors < 0).sum())
            if cw_flags is not None:
                flagged = (dirty & (cw_flags != 0).any(dim=-1)).cpu().numpy()
                self.segments_erasure_assisted += int(((n_errors > 0) & flagged).sum())
        ts = derandomize_field(codewords).cpu().numpy()
        return ts, n_errors


class SoftDecoder(Decoder):
    """Decoder taking soft levels (float32, or int8 soft-level codes)
    instead of sliced symbols: the trellis stage runs maximum-likelihood
    (Viterbi), for noisy captures where hard slicing exceeds RS's
    10-byte/segment budget."""

    def __init__(self, batch: int = 1, viterbi_chunks: int = 1, *,
                 device: str | torch.device):
        super().__init__(batch, device=device)
        self._state = init_soft_decoder_state(batch, device=self.device)
        self._step = functools.partial(soft_decode_field, n_chunks=viterbi_chunks)


class NtscDecoder(Decoder):
    """Decoder for NTSC co-channel-impaired captures: soft levels in,
    comb-filtered 15-level partial-response ML trellis decoding."""

    def __init__(self, batch: int = 1, viterbi_chunks: int = 1, *,
                 device: str | torch.device):
        super().__init__(batch, device=device)
        self._state = init_ntsc_decoder_state(batch, device=self.device)
        self._step = functools.partial(ntsc_decode_field, n_chunks=viterbi_chunks)
