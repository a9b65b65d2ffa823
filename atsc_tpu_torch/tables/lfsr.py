"""Generic Fibonacci LFSR bit-sequence generator (host-side, numpy).

Behavioral spec: reference src/common/lfsr.h:5-34 — each step outputs
``(state >> shift_out) & 1`` and then advances
``state = (state << 1) | parity(state & mask)``.
Used for the PN511 / PN63 field-sync sequences (ATSC A/53 §5.4.2).
"""

from __future__ import annotations

import numpy as np


def lfsr_bits(initial_state: int, shift_out: int, mask: int, nbits: int) -> np.ndarray:
    """Return ``nbits`` output bits of the LFSR as a uint8 array."""
    out = np.empty(nbits, dtype=np.uint8)
    state = initial_state
    for i in range(nbits):
        out[i] = (state >> shift_out) & 1
        fb = bin(state & mask).count("1") & 1
        state = ((state << 1) | fb) & 0xFFFFFFFF
    return out


def pn511() -> np.ndarray:
    """PN511 field-sync sequence (reference field_sync.h:80: lfsr<0b10, 8, 0b110110110, 511>)."""
    return lfsr_bits(0b10, 8, 0b110110110, 511)


def pn63() -> np.ndarray:
    """PN63 field-sync sequence (reference field_sync.h:81: lfsr<0b111001, 5, 0b110000, 63>)."""
    return lfsr_bits(0b111001, 5, 0b110000, 63)
