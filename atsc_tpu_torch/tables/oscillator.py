"""Pilot/frequency-offset oscillator constants.

Behavioral spec: reference src/atsc/offset.h:84-109 — multiply the padded
field by amplitude * e^{j*2*pi*f/fs*n} with f = 309411 - 3e6 Hz, and keep
phase continuity across fields by multiplying the table each field by the
scalar advance e^{j*dphi*260416}.

Numeric contract quirk (replicated deliberately): the reference computes
``cosf(phase_increment * i)`` — the *argument* is rounded to float32 before
the trig call. At i ~ 2.6e5 the phase is ~4e5 radians where float32 spacing
is ~0.03 rad, so the shipped table carries phase errors up to ~0.016 rad at
the field tail. The golden vectors (and any receiver-facing compatibility
bound) bake this in, so we reproduce it exactly: build the table from the
float32-rounded argument (evaluated in float64, then rounded once to
float32 — within 1 ulp of glibc cosf).

The per-field advance ``scale`` suffers the same float32 argument rounding.
Runtime carries a single complex64 phasor per stream, multiplied by
``scale`` each field — the same O(1 ulp/field) drift the reference accrues.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P


@functools.lru_cache(maxsize=1)
def phase_increment() -> float:
    return 2.0 * np.pi * P.OSC_FREQUENCY / P.SAMPLE_RATE


@functools.lru_cache(maxsize=1)
def oscillator_table() -> np.ndarray:
    """(261248,) complex64 oscillator values for field 0."""
    inc = phase_increment()
    n = np.arange(P.PADDED_SYMBOLS, dtype=np.float64)
    arg = (inc * n).astype(np.float32).astype(np.float64)  # the cosf-arg rounding
    re = (P.OSC_AMPLITUDE * np.cos(arg)).astype(np.float32)
    im = (P.OSC_AMPLITUDE * np.sin(arg)).astype(np.float32)
    return (re + 1j * im).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def field_scale() -> complex:
    """complex64 per-field phase advance e^{j*dphi*SYMBOLS_PER_FIELD}."""
    arg = np.float64(
        np.float32(phase_increment() * P.SYMBOLS_PER_FIELD)
    )  # same float32 argument rounding as the reference
    return complex(np.complex64(np.cos(arg) + 1j * np.sin(arg)))


def _phasor_replay_np(field_index: int) -> complex:
    """The float32 recurrence, replayed step-by-step in numpy (the
    numeric contract: sharded streams must match the sequential
    encoder's per-field complex64 multiply exactly — there is no closed
    form for the per-step rounding)."""
    z = np.complex64(1.0)
    s = np.complex64(field_scale())
    for _ in range(field_index):
        z = np.complex64(z * s)
    return complex(z)


@functools.lru_cache(maxsize=1)
def _native_replay_verified() -> bool:
    """Once per process: trust the native C replay (runtime/tsio.cpp
    phasor_replay, built with -ffp-contract=off so no FMA re-rounds the
    complex multiply) only after it reproduces the numpy recurrence
    bit-for-bit over a verification ladder — every small k plus
    power-of-two strides out to 2^16 (any contraction/vectorization
    divergence compounds within a handful of steps, so a deep ladder
    catches it with certainty)."""
    try:
        from atsc_tpu_torch.runtime.io import phasor_replay_native
    except Exception:
        return False
    s = field_scale()
    if phasor_replay_native(s, 1) is None:
        return False
    ks = list(range(64)) + [1 << p for p in range(6, 17)]
    z = np.complex64(1.0)
    sc = np.complex64(s)
    k_prev = 0
    for k in sorted(set(ks)):
        for _ in range(k - k_prev):
            z = np.complex64(z * sc)
        k_prev = k
        if phasor_replay_native(s, k) != complex(z):
            return False
    return True


def phasor_for_field(field_index: int) -> complex:
    """Phasor for an arbitrary field index: the float32 recurrence
    replayed so sharded streams match the sequential encoder exactly.
    The replay runs in the native runtime when its bit-identity is
    verified (O(ms) even at field ~1e6, where the Python scalar loop
    takes seconds); numpy step-loop fallback otherwise."""
    if field_index > 256 and _native_replay_verified():
        from atsc_tpu_torch.runtime.io import phasor_replay_native

        z = phasor_replay_native(field_scale(), field_index)
        if z is not None:
            return z
    return _phasor_replay_np(field_index)
