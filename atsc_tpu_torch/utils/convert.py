"""Carry encoder state between the JAX package and this one.

The encoder has no weights (its constants are atsc_tpu.tables); what a
stream carries is its EncoderState. Both packages use the same leaves,
names, shapes and dtypes, so a stream started in one continues in the
other and gives the same bytes:

    leaves = {k: np.asarray(v) for k, v in jax_state._asdict().items()}
    state = state_from_numpy(leaves, device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.encoder import EncoderState, init_state


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
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}
