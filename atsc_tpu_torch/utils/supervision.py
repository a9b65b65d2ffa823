"""Failure detection and checkpoint-rollback recovery for long-running
encode streams.

Counterpart of atsc_tpu/utils/supervision.py. The failure modes that
matter in a stream that runs for days are device-side corruption (a bad
memory read, a card coming back wrong) and state desync after a resume.
Detection is cheap because 8VSB output is tightly characterized:

  * every IQ sample is a convolution of bounded symbol levels with the
    RRC taps through a 0.9-amplitude oscillator, so |sample| can never
    exceed 8.25 * sum|taps| * 0.9 (IQ_BOUND); NaN/Inf or a bound
    violation means corruption, checked by one reduction on the IQ's
    device that returns one number per step (the IQ stays where it is);
  * the carried EncoderState is tiny and typed: parity and trellis
    carries 0/1, saved symbols in [0, 8), the phasor on the unit circle
    up to float32 drift.

Recovery restores the last good checkpoint (utils/checkpoint.py) and
re-encodes the TS fields given since then, kept in a replay ring.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.encoder import Encoder, EncoderState
from atsc_tpu_torch.tables.rrc import rrc_taps
from atsc_tpu_torch.utils.checkpoint import load_state, save_state

# loosest possible valid |IQ| (levels +-8.25 would need every tap aligned)
IQ_BOUND = float(8.25 * np.abs(rrc_taps()).sum() * P.OSC_AMPLITUDE) * 1.0001


def iq_health(iq: torch.Tensor) -> torch.Tensor:
    """max |IQ| over the whole array, reduced on its device to a 0-d
    tensor (NaN propagates). Healthy iff finite and <= IQ_BOUND."""
    return iq.abs().amax()


def state_healthy(state: EncoderState) -> bool:
    """Host check of the carried state's invariants (a few hundred bytes
    per channel come back: the carries, parity and phasor, not prev_rs)."""
    parity = state.parity.cpu().numpy()
    saved = state.saved.cpu().numpy()
    carries = [c.cpu().numpy() for c in (state.trellis_d, state.trellis_d1,
                                         state.trellis_d2)]
    phasor = state.phasor.cpu().numpy()
    mag = np.hypot(phasor[:, 0], phasor[:, 1])
    return bool(
        np.isin(parity, (0, 1)).all()
        and (saved >= 0).all() and (saved < 8).all()
        and all(np.isin(c, (0, 1)).all() for c in carries)
        and np.isfinite(phasor).all()
        and (np.abs(mag - 1.0) < 1e-3).all()
    )


class SupervisedEncoder:
    """Encoder with health checks, periodic checkpoints and rollback.

    Every field's IQ gets iq_health and the carried state state_healthy.
    On a failure the last good checkpoint is restored and the TS fields
    since then (a replay ring of at most `checkpoint_every` fields) are
    re-encoded before the failing field is retried. A second
    failure on the same field raises RuntimeError: a persistent fault, for
    the operator.
    """

    def __init__(self, batch: int = 1, checkpoint_every: int = 64,
                 checkpoint_path: str | None = None, *,
                 device: str | torch.device):
        self.enc = Encoder(batch=batch, device=device)
        self.batch = batch
        self.checkpoint_every = checkpoint_every
        self.path = checkpoint_path or os.path.join(
            tempfile.gettempdir(), f"atsc_tpu_torch_ckpt_{os.getpid()}.npz")
        self.fields_encoded = 0
        self.failures = 0
        self._replay: list = []   # the TS fields since the last checkpoint
        self._checkpoint()

    def _checkpoint(self) -> None:
        save_state(self.path, self.enc.state, self.fields_encoded)
        self._replay.clear()

    def _healthy(self, iq: torch.Tensor) -> bool:
        peak = float(iq_health(iq))
        return bool(np.isfinite(peak) and peak <= IQ_BOUND
                    and state_healthy(self.enc.state))

    def _recover(self) -> None:
        """Roll back to the checkpoint and re-encode the replay ring."""
        self.failures += 1
        self.enc.state, self.fields_encoded = load_state(self.path,
                                                         device=self.enc.device)
        for ts in self._replay:
            if not self._healthy(self.enc.encode(ts)):
                raise RuntimeError(f"fault persists while replaying field "
                                   f"{self.fields_encoded} after rollback")
            self.fields_encoded += 1

    def encode(self, ts) -> torch.Tensor:
        """(B, 58656) uint8 (numpy, or a tensor on any device, which the
        replay ring keeps where it is) -> (B, 2, 261120) IQ on the
        encoder's device, supervised. Raises RuntimeError if the same field
        fails twice."""
        if not isinstance(ts, torch.Tensor):
            ts = np.asarray(ts)
        for _ in range(2):
            iq = self.enc.encode(ts)
            if self._healthy(iq):
                self.fields_encoded += 1
                self._replay.append(ts)
                if len(self._replay) >= self.checkpoint_every:
                    self._checkpoint()
                return iq
            self._recover()
        raise RuntimeError(f"persistent encode fault at field {self.fields_encoded}")
