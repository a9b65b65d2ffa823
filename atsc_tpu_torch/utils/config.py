"""Typed encode configuration, the twin of atsc_tpu/utils/config.py.

The DSP numerology stays compile-time constant (params.py); this covers
the deployment shape that this package's `run` reads: channels, the
multiplex, the sink, pacing, and the output format and rate. The fields it
has carry the JAX package's names and defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    channels: int = 1              # independent 8VSB streams (batch axis)
    mux: bool = False              # FDM-combine all channels into one
    #                                wideband multiplex at channels*6 MHz
    sink: str = "null"             # "null" | "-" | file path
    realtime: bool = False         # pace the sink to the output sample clock
    out_format: str = "cf32"       # "cf32" | "cs16" | "cs8" wire format
    rate: object = None            # output sample rate (samples/s, a
    #                                Fraction keeps it exact; None = nominal)
    ppm: float = 0.0               # emulated transmit clock error (parts
    #                                per million; scales the output rate)

    def validate(self) -> "EncoderConfig":
        """Raises ValueError on a configuration no encode can run."""
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")
        if self.out_format not in ("cf32", "cs16", "cs8"):
            raise ValueError(f"unknown format {self.out_format!r}")
        return self
