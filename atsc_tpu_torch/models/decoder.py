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

The soft (Viterbi) and NTSC decoders, and RS erasure flags, are not
ported yet.
"""

from __future__ import annotations

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
    trellis_decode_field,
)
from atsc_tpu_torch.ops.rs_decode import rs_correct_field, syndrome_field


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
    cur_il = enc_major_to_round_major(bytes_enc)
    rs = deinterleave_field(cur_il, state.prev_il)
    codewords = rs.reshape(rs.shape[0], P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES)
    syn = syndrome_field(codewords)
    return DecoderState(prev_il=cur_il, z2_prev=z2_new), codewords, syn


class Decoder:
    """Stateful wrapper: symbol fields in, corrected TS fields out."""

    def __init__(self, batch: int = 1, *, device: str | torch.device):
        self.device = resolve_device(device)
        self.batch = batch
        self._state = init_decoder_state(batch, device=self.device)
        self.segments_corrected = 0
        self.segments_uncorrectable = 0

    @property
    def state(self) -> DecoderState:
        return self._state

    @state.setter
    def state(self, value: DecoderState) -> None:
        self._state = value

    def decode(
        self, field, erasure_flags=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(B, >=260416) int8 symbol field k (tensor or numpy) -> (ts
        (B, 58656) uint8 of field k-1, n_errors (B, 312) int32; -1 marks
        uncorrectable), both host numpy.

        The first call after a cold start returns the all-zero pre-start
        field (see module docstring); callers should drop it.
        """
        if erasure_flags is not None:
            raise NotImplementedError(
                "RS erasure flags are not yet ported to atsc_tpu_torch")
        if not isinstance(field, torch.Tensor):
            field = torch.as_tensor(np.asarray(field))
        self._state, codewords, syn = decode_field(
            self._state, field.to(self.device))
        n_errors = np.zeros((self.batch, P.DATA_SEGMENTS), dtype=np.int32)
        dirty = (syn != 0).any(dim=-1)
        if bool(dirty.any()):
            codewords, n_dev = rs_correct_field(codewords, syn)
            n_errors = n_dev.cpu().numpy()
            self.segments_corrected += int((n_errors > 0).sum())
            self.segments_uncorrectable += int((n_errors < 0).sum())
        ts = derandomize_field(codewords).cpu().numpy()
        return ts, n_errors
