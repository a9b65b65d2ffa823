"""Typed encode configuration, the twin of atsc_tpu/utils/config.py.

The DSP numerology stays compile-time constant (params.py); this covers
the deployment shape that this package's `run` reads: channels, the
fields a step takes and the mesh (`encode --mesh`), the multiplex, the
sink, pacing, the output format and rate, and the SoapySDR sink's driver,
frequency and gain. The fields carry the JAX package's names and defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    channels: int = 1              # independent 8VSB streams (batch axis)
    fields_per_step: int = 8       # fields a sharded step encodes (--mesh)
    # sharding (multi-device): mesh axes; 1 = axis unused
    n_time: int = 1                # field time-block shards (SP analog)
    n_ch: int = 1                  # channel shards (DP analog)
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
        if self.channels % max(self.n_ch, 1):
            raise ValueError(f"channels ({self.channels}) must divide evenly over "
                             f"{self.n_ch} channel shards")
        if self.fields_per_step < 1:
            raise ValueError(f"fields_per_step must be >= 1, got {self.fields_per_step}")
        if self.out_format not in ("cf32", "cs16", "cs8"):
            raise ValueError(f"unknown format {self.out_format!r}")
        return self
