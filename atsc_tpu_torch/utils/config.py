"""Typed encode configuration, the twin of atsc_tpu/utils/config.py.

The DSP numerology stays compile-time constant (params.py); this covers
the deployment shape that this package's `run` reads: channels, the
multiplex, the sink, pacing, the output format and rate, and the SoapySDR
sink's driver, frequency and gain. The fields carry the JAX package's
names and defaults; its multi-device fields (fields_per_step, n_time,
n_ch) come with --mesh.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    channels: int = 1              # independent 8VSB streams (batch axis)
    mux: bool = False              # FDM-combine all channels into one
    #                                wideband multiplex at channels*6 MHz
    sink: str = "null"             # "null" | "-" | file path | "soapy[:driver]"
    realtime: bool = False         # pace the sink to the output sample clock
    out_format: str = "cf32"       # "cf32" | "cs16" | "cs8" wire format
    rate: object = None            # output sample rate (samples/s, a
    #                                Fraction keeps it exact; None = nominal)
    ppm: float = 0.0               # emulated transmit clock error (parts
    #                                per million; scales the output rate)
    # the 'soapy' sink's device (the reference's -d/-f/-g flags,
    # util/defaults.h:3-5); 'soapy:<driver>' in `sink` names the driver too
    frequency_hz: float = 473_000_000.0
    gain_db: float = 54.0
    driver: str = "file"

    def validate(self) -> "EncoderConfig":
        """Raises ValueError on a configuration no encode can run."""
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")
        if self.out_format not in ("cf32", "cs16", "cs8"):
            raise ValueError(f"unknown format {self.out_format!r}")
        return self
