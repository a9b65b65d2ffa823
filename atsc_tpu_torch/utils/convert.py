"""Carry encoder and decoder state between the JAX package and this one.

Neither model has weights (their constants are the tables); what a
stream carries is its EncoderState or DecoderState. Both packages use the
same leaves, names, shapes and dtypes, so a stream started in one
continues in the other and gives the same bytes:

    leaves = {k: np.asarray(v) for k, v in jax_state._asdict().items()}
    state = state_from_numpy(leaves, device="cuda")
    rx_state = decoder_state_from_numpy(jax_rx_leaves, device="cuda")

and the soft and NTSC decoders' states likewise
(soft_decoder_state_from_numpy, ntsc_decoder_state_from_numpy). The
receiver's two other carries move the same way: a Decoder's erasure flags
(`decoder.flag_il = flag_il_from_numpy(np.asarray(jax_decoder._flag_il),
device)`) and an AdaptiveEqualizer's RLS state
(`eq.state = adaptive_state_from_numpy({"r": ..., "v": ..., "w": ...,
"fields_seen": ...}, device)`, from the JAX equalizer's `_r`, `_v`,
`_w_dev` and `_fields_seen`). A transmit-side resampler continues from
a JAX StreamResampler's `full_state()` (`stream_resampler_from_numpy`),
and a CfoCorrector from a JAX one's frequency and phase
(`CfoCorrector(jax_corrector.cfo_hz, phi=jax_corrector._phi)`). A headend's
FDM muxer and demuxer continue from a JAX FdmMuxer's / FdmDemuxer's
`get_state()` carry (`fdm_muxer_from_numpy`, `fdm_demuxer_from_numpy`). The
chunk-parallel decoders carry nothing new: their metrics and z2_prev move
with the soft and NTSC decoder states.
"""

from __future__ import annotations

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.decoder import (
    DecoderState,
    NtscDecoderState,
    SoftDecoderState,
    init_decoder_state,
    init_ntsc_decoder_state,
    init_soft_decoder_state,
)
from atsc_tpu_torch.models.encoder import EncoderState, init_state
from atsc_tpu_torch.ops.adaptive_eq import EQ_DIM, AdaptiveState
from atsc_tpu_torch.ops.mux import FdmDemuxer, FdmMuxer
from atsc_tpu_torch.ops.resample import StreamResampler


def state_from_numpy(leaves: dict, device: str | torch.device) -> EncoderState:
    """{leaf name: numpy array} -> EncoderState on `device`. Raises on a
    missing or extra leaf, or a dtype or shape other than init_state's."""
    dev = resolve_device(device)
    if set(leaves) != set(EncoderState._fields):
        raise ValueError(
            f"state leaves {sorted(leaves)} != {sorted(EncoderState._fields)}")
    parity = np.asarray(leaves["parity"])
    if parity.ndim != 1:
        raise ValueError(f"state leaf parity must be (B,), got {parity.shape}")
    ref = init_state(parity.shape[0], device="cpu")
    out = {}
    for name, want in ref._asdict().items():
        arr = np.asarray(leaves[name])
        if arr.dtype != want.numpy().dtype or arr.shape != tuple(want.shape):
            raise ValueError(
                f"state leaf {name}: want {tuple(want.shape)} {want.numpy().dtype}"
                f", got {arr.shape} {arr.dtype}")
        out[name] = torch.tensor(arr, device=dev)
    return EncoderState(**out)


def state_to_numpy(state: EncoderState) -> dict:
    """EncoderState -> {leaf name: numpy array} on the host."""
    return _leaves_to_numpy(state)


def _leaves_from_numpy(d: dict, kind, init, what: str, device):
    """{leaf name: numpy array} -> kind(...) on `device`, each leaf checked
    against init(B, device="cpu")'s dtype and shape (B from prev_il)."""
    dev = resolve_device(device)
    if set(d) != set(kind._fields):
        raise ValueError(f"{what} leaves {sorted(d)} != {sorted(kind._fields)}")
    prev = np.asarray(d["prev_il"])
    if prev.ndim != 2:
        raise ValueError(f"{what} leaf prev_il must be (B, 64584), got {prev.shape}")
    ref = init(prev.shape[0], device="cpu")
    out = {}
    for name, want in ref._asdict().items():
        arr = np.asarray(d[name])
        if arr.dtype != want.numpy().dtype or arr.shape != tuple(want.shape):
            raise ValueError(
                f"{what} leaf {name}: want {tuple(want.shape)} "
                f"{want.numpy().dtype}, got {arr.shape} {arr.dtype}")
        out[name] = torch.tensor(arr, device=dev)
    return kind(**out)


def _leaves_to_numpy(state) -> dict:
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}


def decoder_state_from_numpy(d: dict, device: str | torch.device) -> DecoderState:
    """{leaf name: numpy array} -> DecoderState on `device`: a receive
    stream begun in the JAX package goes on in this one with the same
    bytes (the equalizer carries no state; its taps are tables). Raises on
    a missing or extra leaf, or a dtype or shape other than
    init_decoder_state's."""
    return _leaves_from_numpy(d, DecoderState, init_decoder_state, "decoder state",
                              device)


def decoder_state_to_numpy(state: DecoderState) -> dict:
    """DecoderState -> {leaf name: numpy array} on the host."""
    return _leaves_to_numpy(state)


def soft_decoder_state_from_numpy(d: dict, device: str | torch.device) -> SoftDecoderState:
    """{leaf name: numpy array} -> SoftDecoderState on `device` (the
    Viterbi path metrics carry too), with decoder_state_from_numpy's
    checks against init_soft_decoder_state."""
    return _leaves_from_numpy(d, SoftDecoderState, init_soft_decoder_state,
                              "soft decoder state", device)


def soft_decoder_state_to_numpy(state: SoftDecoderState) -> dict:
    """SoftDecoderState -> {leaf name: numpy array} on the host."""
    return _leaves_to_numpy(state)


def ntsc_decoder_state_from_numpy(d: dict, device: str | torch.device) -> NtscDecoderState:
    """{leaf name: numpy array} -> NtscDecoderState on `device` (the
    16-state PR path metrics carry too), with decoder_state_from_numpy's
    checks against init_ntsc_decoder_state."""
    return _leaves_from_numpy(d, NtscDecoderState, init_ntsc_decoder_state,
                              "ntsc decoder state", device)


def ntsc_decoder_state_to_numpy(state: NtscDecoderState) -> dict:
    """NtscDecoderState -> {leaf name: numpy array} on the host."""
    return _leaves_to_numpy(state)


def flag_il_from_numpy(flags: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """(B, 64584) uint8 carried erasure flags (a Decoder's `flag_il`, the
    JAX Decoder's `_flag_il`) -> a tensor on `device`. Raises on another
    shape or dtype."""
    arr = np.asarray(flags)
    if arr.dtype != np.uint8 or arr.ndim != 2 or arr.shape[1] != P.DATA_PER_FIELD:
        raise ValueError(f"carried erasure flags: want (B, {P.DATA_PER_FIELD}) uint8, "
                         f"got {arr.shape} {arr.dtype}")
    return torch.tensor(arr, device=resolve_device(device))


def adaptive_state_from_numpy(d: dict, device: str | torch.device) -> AdaptiveState:
    """{"r": (B, D, D), "v": (B, D), "w": (B, D) or None, "fields_seen":
    int} -> AdaptiveState on `device` (float32 leaves, D = 515): an
    adaptive stream trained in the JAX package goes on in this one. Raises
    on a missing or extra leaf, or a dtype or shape other than these."""
    dev = resolve_device(device)
    want = {"r", "v", "w", "fields_seen"}
    if set(d) != want:
        raise ValueError(f"adaptive state leaves {sorted(d)} != {sorted(want)}")
    r = np.asarray(d["r"])
    if r.ndim != 3:
        raise ValueError(f"adaptive state leaf r must be (B, D, D), got {r.shape}")
    b = r.shape[0]
    shapes = {"r": (b, EQ_DIM, EQ_DIM), "v": (b, EQ_DIM), "w": (b, EQ_DIM)}
    out = {}
    for name, shape in shapes.items():
        if name == "w" and d["w"] is None:
            out["w"] = None
            continue
        arr = np.asarray(d[name])
        if arr.dtype != np.float32 or arr.shape != shape:
            raise ValueError(f"adaptive state leaf {name}: want {shape} float32, "
                             f"got {arr.shape} {arr.dtype}")
        out[name] = torch.tensor(arr, device=dev)
    return AdaptiveState(out["r"], out["v"], out["w"], int(d["fields_seen"]))


def adaptive_state_to_numpy(state: AdaptiveState) -> dict:
    """AdaptiveState -> {"r", "v", "w", "fields_seen"} on the host."""
    return {"r": state.r.cpu().numpy(), "v": state.v.cpu().numpy(),
            "w": None if state.w is None else state.w.cpu().numpy(),
            "fields_seen": state.fields_seen}


def stream_resampler_from_numpy(full_state: dict,
                                device: str | torch.device) -> StreamResampler:
    """A StreamResampler.full_state() of either package ({"num", "den",
    "out_next", "in_base", "batch", "buf" (B, 2, n) float32, "flushed"})
    -> a StreamResampler on `device` that goes on from the same exact
    position with the same buffered window. Raises on a missing or extra
    key, a buffer of another shape or dtype, or a flushed state."""
    want = {"num", "den", "out_next", "in_base", "batch", "buf", "flushed"}
    if set(full_state) != want:
        raise ValueError(f"resampler state keys {sorted(full_state)} != {sorted(want)}")
    buf = np.asarray(full_state["buf"])
    batch = int(full_state["batch"])
    if buf.dtype != np.float32 or buf.ndim != 3 or buf.shape[:2] != (batch, 2):
        raise ValueError(f"resampler buffer: want ({batch}, 2, n) float32, "
                         f"got {buf.shape} {buf.dtype}")
    return StreamResampler.load_full_state(full_state, device=device)


def fdm_muxer_from_numpy(carry: np.ndarray, n_slots: int,
                         device: str | torch.device) -> FdmMuxer:
    """An FdmMuxer.get_state() carry of either package ((B, 2, n) float32:
    the resampler halo plus the unconsumed block remainder) -> an FdmMuxer
    of n_slots on `device` that goes on from it. Raises on another shape or
    dtype."""
    carry = np.asarray(carry)
    if carry.dtype != np.float32 or carry.ndim != 3 or carry.shape[:2] != (n_slots, 2):
        raise ValueError(f"muxer carry: want ({n_slots}, 2, n) float32, "
                         f"got {carry.shape} {carry.dtype}")
    mux = FdmMuxer(n_slots, device=device)
    mux.set_state(carry)
    return mux


def fdm_demuxer_from_numpy(carry: np.ndarray, n_slots: int,
                           device: str | torch.device) -> FdmDemuxer:
    """An FdmDemuxer.get_state() carry of either package ((2, n) float32:
    the filter halo plus the unconsumed block remainder) -> an FdmDemuxer of
    n_slots on `device` that goes on from it. Raises on another shape or
    dtype."""
    carry = np.asarray(carry)
    if carry.dtype != np.float32 or carry.ndim != 2 or carry.shape[0] != 2:
        raise ValueError(f"demuxer carry: want (2, n) float32, got {carry.shape} "
                         f"{carry.dtype}")
    dmx = FdmDemuxer(n_slots, device=device)
    dmx.set_state(carry)
    return dmx
