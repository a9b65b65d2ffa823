"""GF(256) arithmetic and the RS(207,187) encoder expressed as linear algebra.

Behavioral spec: reference src/atsc/galois.h (log/exp tables over primitive
polynomial 0x11d) and src/atsc/reed_solomon.h (generator polynomial with
roots alpha^0..alpha^19; LFSR-division encoder, shortened from RS(255,235)).

TPU-first reformulation: every GF(256) operation is linear over GF(2), so
the 20 parity bytes (160 bits) of a codeword are a binary matrix product of
the 187 data bytes (1496 bits):

    parity_bits = data_bits @ M  (mod 2),   M: (1496, 160) in {0,1}

which maps the whole Reed-Solomon stage of a field onto one (312, 1496) x
(1496, 160) int8 matmul on the MXU — no gathers, no sequential LFSR.
This module builds M (host-side, once) plus a plain numpy polynomial-
remainder oracle used to cross-check it.
"""

from __future__ import annotations

import functools

import numpy as np

from atsc_tpu_torch import params as P

_POLY = 0x11D
_NROOTS = P.RS_BYTES  # 20


@functools.lru_cache(maxsize=1)
def gf_tables() -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables for GF(256) with primitive polynomial 0x11d."""
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    v = 1
    for i in range(255):
        exp[i] = v
        exp[i + 255] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= _POLY
    return exp, log


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(256) multiply (numpy oracle)."""
    exp, log = gf_tables()
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = exp[log[a] + log[b]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def rs_generator_poly() -> np.ndarray:
    """Generator polynomial coefficients g[0..20] (g[20]=1), roots alpha^0..19.

    Matches the constructor loop of reference reed_solomon.h:23-39.
    """
    exp, _ = gf_tables()
    g = np.zeros(_NROOTS + 1, dtype=np.uint8)
    g[0] = 1
    for root in range(_NROOTS):
        # multiply g by (x + alpha^root)
        alpha = exp[root]
        g_new = np.zeros_like(g)
        g_new[1 : root + 2] = g[: root + 1]                       # g * x
        g_new[: root + 1] ^= gf_mul(g[: root + 1], alpha)         # + g * alpha^root
        g = g_new
    # reorder so g[i] is the coefficient of x^i, degree 20 monic
    return g


def rs_encode_segment_np(data: np.ndarray) -> np.ndarray:
    """Numpy oracle: 187 data bytes -> 20 parity bytes via LFSR division.

    parity(x) = data(x) * x^20 mod g(x), systematic shortened RS(207,187).
    """
    g = rs_generator_poly()
    # g[i] coeff of x^i; division uses the monic top term g[20]=1
    bb = np.zeros(_NROOTS, dtype=np.uint8)  # bb[0] is the "oldest" (highest) term
    for byte in data:
        feedback = int(byte) ^ int(bb[0])
        bb[:-1] = bb[1:]
        bb[-1] = 0
        if feedback:
            # subtract feedback * g (excluding the monic term), aligned so that
            # bb[j] accumulates g[NROOTS-1-j] * feedback
            bb ^= gf_mul(g[:_NROOTS][::-1], feedback)
        # note: g[::-1][j] = g[NROOTS-j] for j>=1 ... verified vs golden
    return bb


@functools.lru_cache(maxsize=1)
def rs_bit_matrix() -> np.ndarray:
    """(1496, 160) uint8 binary matrix M with parity_bits = data_bits @ M mod 2.

    data_bits layout: byte-major, bit 7 first (MSB-first within each byte).
    parity_bits layout: same convention over the 20 parity bytes.
    Built by encoding the 1496 GF(2) basis vectors through the numpy oracle;
    GF(2)-linearity of the RS code makes this exact.
    """
    nbits_in = P.SEGMENT_BYTES * 8
    nbits_out = _NROOTS * 8
    m = np.zeros((nbits_in, nbits_out), dtype=np.uint8)
    data = np.zeros(P.SEGMENT_BYTES, dtype=np.uint8)
    for byte_idx in range(P.SEGMENT_BYTES):
        for bit in range(8):
            data[byte_idx] = 1 << (7 - bit)
            parity = rs_encode_segment_np(data)
            data[byte_idx] = 0
            m[byte_idx * 8 + bit] = np.unpackbits(parity)
    return m
