"""Streaming encoder: chunked TS input -> whole fields -> IQ sink.

Counterpart of atsc_tpu/models/streaming.py (reference src/atsc/atsc.cpp:
59-77, accumulate-and-fire): push arbitrary byte chunks per channel; a
field is encoded whenever every channel has one buffered, B channels in
lockstep, and the sink receives each channel's interleaved samples,
bit-layout-identical to the reference's complex<float> output (or int16
/ int8 pairs for cs16 / cs8).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.encoder import Encoder, iq_interleave

SinkFn = Callable[[int, np.ndarray], None]  # (channel, iq (260416, 2))


class StreamingEncoder:
    """Push arbitrary-size TS byte chunks per channel; fields are encoded
    whenever every channel has at least one field buffered."""

    def __init__(self, channels: int = 1, sink: Optional[SinkFn] = None,
                 out_format: str = "cf32", *, device: str | torch.device):
        self.channels = channels
        self.sink = sink
        self._enc = Encoder(batch=channels, out_format=out_format, device=device)
        self._buf: list[bytearray] = [bytearray() for _ in range(channels)]
        self.fields_encoded = 0

    @property
    def encoder(self) -> Encoder:
        return self._enc

    def push(self, data: bytes | np.ndarray, channel: int = 0) -> int:
        """Buffer TS bytes for one channel; encodes every complete field
        available on ALL channels. Returns the number of fields encoded."""
        self._buf[channel].extend(bytes(data))
        return self._drain()

    def _drain(self) -> int:
        fb = P.FIELD_TS_BYTES
        ready = min(len(b) // fb for b in self._buf)
        for _ in range(ready):
            ts = np.empty((self.channels, fb), dtype=np.uint8)
            for c, b in enumerate(self._buf):
                ts[c] = np.frombuffer(bytes(b[:fb]), dtype=np.uint8)
                del b[:fb]
            iq = self._enc.encode(ts)
            if self.sink is not None:
                wire = iq_interleave(iq)  # (B, 260416, 2) host numpy
                for c in range(self.channels):
                    self.sink(c, wire[c])
        self.fields_encoded += ready
        return ready

    def flush_partial(self) -> int:
        """Zero-pad buffered partial fields and encode them (end of
        stream). Every channel is padded to the same field count so the
        batch stays in lockstep. Returns fields encoded."""
        fb = P.FIELD_TS_BYTES
        if all(len(b) == 0 for b in self._buf):
            return 0
        target = max(-(-len(b) // fb) for b in self._buf)
        for b in self._buf:
            b.extend(bytes(target * fb - len(b)))
        return self._drain()
