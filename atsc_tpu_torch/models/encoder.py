"""The 8VSB encoder model: the 7-stage pipeline over batched channels.

Counterpart of atsc_tpu/models/encoder.py (reference src/atsc/atsc.cpp:
79-90): ``state, iq = encode_field(state, ts)``. On a CUDA device the back
half (level map + pilot offset + RRC FIR, and the cs16/cs8 quantizer) is
the hand kernel ops/cuda/offset_fir; on the CPU it is that kernel's plain
twin.

Carried state per stream (the complete resumable state): previous field's
RS output (interleaver double buffer), 36 bits of trellis carries, 12
saved reserved symbols, field parity, oscillator phasor.

There is no buffer donation as in the JAX package. encode_field never
writes into its arguments, so an old state stays valid (tests and state
conversion rely on that); the stateful Encoder rebinds its state each
field and PyTorch's caching allocator hands the dropped tensors' blocks to
the next field. The only in-place writes are into fresh intermediates
(assemble's reserved slots, field_levels' tail).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.ops.assemble import assemble_field_structured
from atsc_tpu_torch.ops.cuda.offset_fir import offset_fir_fused
from atsc_tpu_torch.ops.interleave import interleave_field_enc_major
from atsc_tpu_torch.ops.offset import advance_phasor
from atsc_tpu_torch.ops.randomize import randomize_field
from atsc_tpu_torch.ops.rs_encode import rs_encode_field
from atsc_tpu_torch.ops.trellis import trellis_encode_field
from atsc_tpu_torch.tables.oscillator import phasor_for_field


class EncoderState(NamedTuple):
    """Carried per-channel state; every leaf is batched (B, ...)."""

    prev_rs: torch.Tensor        # (B, 64584) uint8
    trellis_d: torch.Tensor      # (B, 12) int32 differential precoder
    trellis_d1: torch.Tensor     # (B, 12) int32 conv encoder delay 1
    trellis_d2: torch.Tensor     # (B, 12) int32 conv encoder delay 2
    saved: torch.Tensor          # (B, 12) int8 reserved symbol values
    parity: torch.Tensor         # (B,) int32 field parity (0 even, 1 odd)
    phasor: torch.Tensor         # (B, 2) float32 oscillator phasor (re, im)


def init_state(
    batch: int, field_index: int = 0, *, device: str | torch.device
) -> EncoderState:
    """Fresh state for `batch` channels on `device`, as of a global field
    index: field_index > 0 sets only the closed-form parts (parity,
    phasor); the data-dependent parts match a cold start, like the
    reference's constructor (atsc.cpp:17-35)."""
    dev = resolve_device(device)
    z = phasor_for_field(field_index)
    phasor = torch.tensor(
        [np.float32(z.real), np.float32(z.imag)], dtype=torch.float32, device=dev
    )
    carry = (batch, P.TRELLIS_ENCODERS)
    return EncoderState(
        prev_rs=torch.zeros((batch, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev),
        trellis_d=torch.zeros(carry, dtype=torch.int32, device=dev),
        trellis_d1=torch.zeros(carry, dtype=torch.int32, device=dev),
        trellis_d2=torch.zeros(carry, dtype=torch.int32, device=dev),
        saved=torch.zeros((batch, P.RESERVED_SYMBOLS), dtype=torch.int8, device=dev),
        parity=torch.full((batch,), field_index % 2, dtype=torch.int32, device=dev),
        phasor=phasor.repeat(batch, 1),
    )


def encode_field(
    state: EncoderState, ts: torch.Tensor, out_format: str = "cf32",
    wire: bool = False,
) -> tuple[EncoderState, torch.Tensor]:
    """One field for B channels: (B, 58656) uint8 TS bytes on the state's
    device -> (B, 2, 261120) planar IQ, valid through sample 260,416
    (float32 for 'cf32', int16/int8 codes for 'cs16'/'cs8'), or
    (B, 261120) packed wire lanes with wire=True (cs16/cs8 only)."""
    want = (state.parity.shape[0], P.FIELD_TS_BYTES)
    if ts.dtype != torch.uint8 or tuple(ts.shape) != want:
        raise ValueError(f"ts must be {want} uint8, got {tuple(ts.shape)} {ts.dtype}")
    if ts.device != state.prev_rs.device:
        raise ValueError(f"ts on {ts.device} but the state on {state.prev_rs.device}")
    rand = randomize_field(ts)
    rs = rs_encode_field(rand)
    rs_flat = rs.reshape(rs.shape[0], -1)
    il = interleave_field_enc_major(rs_flat, state.prev_rs)
    symbols, d, d1, d2 = trellis_encode_field(
        il, state.trellis_d, state.trellis_d1, state.trellis_d2
    )
    field, new_saved = assemble_field_structured(symbols, state.parity, state.saved)
    iq = offset_fir_fused(field, state.phasor, out_format=out_format, wire=wire)
    new_state = EncoderState(
        prev_rs=rs_flat,
        trellis_d=d,
        trellis_d1=d1,
        trellis_d2=d2,
        saved=new_saved,
        parity=state.parity ^ 1,
        phasor=advance_phasor(state.phasor),
    )
    return new_state, iq


def encode_fields(
    state: EncoderState, ts_fields: torch.Tensor, out_format: str = "cf32",
    wire: bool = False,
) -> tuple[EncoderState, torch.Tensor]:
    """T fields in order: (T, B, 58656) -> (T, B, 2, 261120), or
    (T, B, 261120) wire lanes."""
    out = []
    for ts in ts_fields:
        state, iq = encode_field(state, ts, out_format=out_format, wire=wire)
        out.append(iq)
    return state, torch.stack(out)


class Encoder:
    """Stateful wrapper around encode_field (the single-process API, the
    analog of reference atsc.h's atsc_encoder)."""

    def __init__(self, batch: int = 1, field_index: int = 0,
                 out_format: str = "cf32", wire: bool = False, *,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.batch = batch
        self.out_format = out_format
        self.wire = wire
        self.state = init_state(batch, field_index, device=self.device)

    def _to_device(self, ts) -> torch.Tensor:
        if isinstance(ts, torch.Tensor):
            return ts.to(self.device)
        arr = np.asarray(ts)
        if arr.dtype != np.uint8:
            raise ValueError(f"TS bytes must be uint8, got {arr.dtype}")
        return torch.tensor(arr, device=self.device)

    def encode(self, ts) -> torch.Tensor:
        """(B, 58656) uint8 (numpy or tensor) -> one field's IQ on the
        encoder's device: (B, 2, 261120) planar, or (B, 261120) wire."""
        self.state, iq = encode_field(
            self.state, self._to_device(ts), out_format=self.out_format,
            wire=self.wire,
        )
        return iq

    def encode_many(self, ts_fields) -> torch.Tensor:
        """(T, B, 58656) -> (T, B, 2, 261120) planar, or (T, B, 261120)."""
        self.state, iq = encode_fields(
            self.state, self._to_device(ts_fields), out_format=self.out_format,
            wire=self.wire,
        )
        return iq


def _host(iq) -> np.ndarray:
    return iq.cpu().numpy() if isinstance(iq, torch.Tensor) else np.asarray(iq)


def iq_interleave(iq) -> np.ndarray:
    """Planar (..., 2, N>=260416) IQ (numpy or tensor) -> interleaved numpy
    (..., 260416, 2): the byte layout of the reference's complex<float>
    CF32 stream (atsc.cpp:89)."""
    arr = _host(iq)[..., : P.SYMBOLS_PER_FIELD]
    return np.ascontiguousarray(np.moveaxis(arr, -2, -1))


def iq_to_complex(iq) -> np.ndarray:
    """Planar (..., 2, N) or interleaved (..., N, 2) float32 IQ -> complex64
    of the 260,416 valid samples."""
    arr = _host(iq)
    if arr.shape[-1] == 2:  # interleaved
        arr = np.ascontiguousarray(arr[..., : P.SYMBOLS_PER_FIELD, :])
        return arr.view(np.complex64)[..., 0]
    return iq_interleave(arr).view(np.complex64)[..., 0]
