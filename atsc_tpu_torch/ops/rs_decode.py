"""Reed-Solomon RS(207,187) decoder, errors-only tier: syndromes and error
correction on the device.

Counterpart of atsc_tpu/ops/rs_decode.py (reference src/atsc/
reed_solomon.h:41-190 carries the scalar Berlekamp-Massey/Chien/Forney
decoder, dead code there):

* `syndrome_field` — "is this field clean?" is GF(2)-linear, so the
  syndrome bits are codeword_bits @ S (mod 2), one product for all 312
  segments of every channel.
* `rs_correct_field` — the errors-only decode as fixed-shape, branch-free
  arithmetic over all (B, 312) segments at once: GF(256) multiply as an
  8-round carryless shift/XOR, inversion as a^254, the inversionless
  Berlekamp-Massey (RiBM) in 20 fixed rounds, and the Chien search and
  Forney evaluations as GF(2) bit products against precomputed matrices.

CUDA matmul takes no integer operands, so every GF(2) bit product is a
float32 matmul reduced `& 1`. It is exact: the operands are 0/1 and each
sum is an integer <= 1656 < 2^24, and 0/1 survive TF32 too. These are
plain products that the JAX package leaves to XLA, so they go to
torch.matmul. The erasure tier is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.tables.galois import gf_mul, gf_tables

_NROOTS = P.RS_BYTES
_N = P.SEGMENT_FEC_BYTES  # 207
_BIT_SHIFTS = np.arange(7, -1, -1, dtype=np.int32)


def syndromes_np(codeword: np.ndarray) -> np.ndarray:
    """(..., 207) uint8 -> (..., 20) uint8 syndromes S_j = c(alpha^j).

    The codeword polynomial convention matches the encoder (tables/galois
    .py): c = [data(187) | parity(20)], highest-degree coefficient first.
    """
    exp, _ = gf_tables()
    cw = np.asarray(codeword, dtype=np.uint8)
    out = np.zeros(cw.shape[:-1] + (_NROOTS,), dtype=np.uint8)
    for j in range(_NROOTS):
        # Horner: s = s*alpha^j + c[i]
        s = np.zeros(cw.shape[:-1], dtype=np.uint8)
        alpha_j = exp[j]
        for i in range(_N):
            s = gf_mul(s, alpha_j) ^ cw[..., i]
        out[..., j] = s
    return out


@functools.lru_cache(maxsize=1)
def _syndrome_bit_matrix() -> np.ndarray:
    """(207*8, 20*8) GF(2) matrix: syndrome_bits = codeword_bits @ S mod 2,
    built with one batched syndromes_np call over the 1,656 unit
    codewords."""
    nbits_in = _N * 8
    units = np.zeros((nbits_in, _N), dtype=np.uint8)
    idx = np.arange(nbits_in)
    units[idx, idx // 8] = (1 << (7 - (idx % 8))).astype(np.uint8)
    syn = syndromes_np(units)                     # (1656, 20)
    return np.unpackbits(syn, axis=-1).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _f32(make) -> np.ndarray:
    """The 0/1 matrix `make()` as float32, the matmul operand."""
    return make().astype(np.float32)


@functools.lru_cache(maxsize=1)
def _shifts() -> np.ndarray:
    return _BIT_SHIFTS


@functools.lru_cache(maxsize=1)
def _bit_weights() -> np.ndarray:
    return (1 << _BIT_SHIFTS).astype(np.int32)


def _bit_matmul(values: torch.Tensor, matrix: torch.Tensor,
                out_bytes: int) -> torch.Tensor:
    """GF(2)-linear map as one float32 matmul: (..., nin) byte values ->
    (..., out_bytes) int32 byte values through `matrix` ((nin*8,
    out_bytes*8) float32 of 0/1, MSB-first bit convention on both
    sides)."""
    lead = values.shape[:-1]
    dev = values.device
    bits = (values[..., None].to(torch.int32) >> const(_shifts, dev)) & 1
    bits = bits.reshape(*lead, values.shape[-1] * 8).to(torch.float32)
    out_bits = (bits @ matrix).to(torch.int32) & 1
    ob = out_bits.reshape(*lead, out_bytes, 8)
    return (ob * const(_bit_weights, dev)).sum(dim=-1, dtype=torch.int32)


def _syndrome_matrix() -> np.ndarray:
    return _f32(_syndrome_bit_matrix)


def syndrome_field(codewords: torch.Tensor) -> torch.Tensor:
    """(..., 207) uint8 -> (..., 20) uint8 syndromes, one matmul."""
    syn = _bit_matmul(codewords, const(_syndrome_matrix, codewords.device),
                      _NROOTS)
    return syn.to(torch.uint8)


# == Device-side batched errors-only corrector ==========================
#
# A decode is accepted only if L <= 10, #Chien roots == L, Lambda' is
# non-zero at every root, and the re-computed syndromes of the patched
# codeword are all zero; rejected segments return unchanged with n = -1.
# Clean segments fall through untouched with n = 0 (delta stays 0 for all
# 20 rounds, so C = 1 and nothing matches).

def _gf_mul_dev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) multiply (int32 in, int32 out, broadcasting):
    carryless multiply with interleaved 0x11d reduction — 8 shift/mask/XOR
    rounds, no gathers."""
    b = b.to(torch.int32)
    cur = a.to(torch.int32)
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.int32, device=cur.device)
    for i in range(8):
        acc = acc ^ torch.where(((b >> i) & 1) != 0, cur, 0)
        if i < 7:
            cur = ((cur << 1) & 0xFF) ^ torch.where((cur & 0x80) != 0, 0x1D, 0)
    return acc


def _gf_inv_dev(a: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) inverse a^254 (Fermat); maps 0 -> 0 (callers
    must reject den == 0 explicitly)."""
    sq = _gf_mul_dev(a, a)          # a^2
    r = sq
    cur = sq
    for _ in range(6):              # a^4 .. a^128
        cur = _gf_mul_dev(cur, cur)
        r = _gf_mul_dev(r, cur)
    return r                        # a^(2+4+...+128) = a^254


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis (log-depth fold)."""
    n = x.shape[-1]
    while n > 1:
        h = n // 2
        lo = x[..., :h] ^ x[..., h : 2 * h]
        x = torch.cat([lo, x[..., 2 * h :]], dim=-1) if n % 2 else lo
        n = x.shape[-1]
    return x[..., 0]


@functools.lru_cache(maxsize=4)
def _eval_bit_matrix(kind: str) -> np.ndarray:
    """GF(2) matrix evaluating a coefficient vector at the 207 valid
    locator points alpha^{-j}, j = 206 - i (position i = first
    transmitted byte at i = 0):

    - 'chien':    (21*8, 207*8)  V[i] = sum_k C[k] alpha^{-j k}
    - 'omega':    (20*8, 207*8)  num[i] = sum_k Omega[k] alpha^{-j k}
    - 'lamprime': (21*8, 207*8)  den[i] = sum_{k odd} C[k] alpha^{-j (k-1)}
    """
    exp, _ = gf_tables()
    j = _N - 1 - np.arange(_N)                      # (207,) degrees
    ncoef = _NROOTS if kind == "omega" else _NROOTS + 1
    k = np.arange(ncoef)
    if kind == "lamprime":
        powlog = (-(j[None, :] * (k - 1)[:, None])) % 255
        active = (k % 2) == 1                       # formal derivative
    else:
        powlog = (-(j[None, :] * k[:, None])) % 255
        active = np.ones(ncoef, dtype=bool)
    m = np.zeros((ncoef * 8, _N * 8), dtype=np.int8)
    for kk in range(ncoef):
        if not active[kk]:
            continue
        base = exp[powlog[kk]].astype(np.uint8)     # (207,)
        for t in range(8):
            vals = gf_mul(np.uint8(1 << (7 - t)), base)
            m[kk * 8 + t] = np.unpackbits(vals)
    return m


@functools.lru_cache(maxsize=1)
def _chien_lamprime_matrix() -> np.ndarray:
    """Chien and Lambda' read the same locator bits: one (168, 2*1656)
    float32 matrix, one product."""
    return np.concatenate([_eval_bit_matrix("chien"),
                           _eval_bit_matrix("lamprime")], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _omega_matrix() -> np.ndarray:
    return _eval_bit_matrix("omega").astype(np.float32)


@functools.lru_cache(maxsize=1)
def _alpha_j() -> np.ndarray:
    """(207,) int32 X_i = alpha^{j}, j = 206 - i (Forney's X_i factor)."""
    exp, _ = gf_tables()
    return exp[(_N - 1 - np.arange(_N)) % 255].astype(np.int32)


def _ribm(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inversionless Berlekamp-Massey (RiBM), 20 fixed rounds.

    s: (..., 20) int32 syndrome sequence. Returns (C (..., 21) int32, the
    locator scaled by the accumulated gamma product — the scale cancels
    in Forney's Omega/C' ratio — and ell (...,) int32, the register
    length = error count). Round r's discrepancy window s[r-i] is a slice
    of the padded reversed syndromes; out-of-range terms are zero, so the
    full-width product equals the r+1-term one.
    """
    lead = s.shape[:-1]
    dev = s.device
    # s_rev_ext[j] = s_ext[40 - j] with s_ext = [zeros(21) | s]:
    # round r's window v_i = s[r - i] = s_rev_ext[19 - r + i], i < 21
    s_rev_ext = torch.cat(
        [torch.flip(s, dims=[-1]),
         torch.zeros(lead + (_NROOTS + 1,), dtype=torch.int32, device=dev)],
        dim=-1,
    )
    c = torch.zeros(lead + (_NROOTS + 1,), dtype=torch.int32, device=dev)
    c[..., 0] = 1
    k = c.clone()
    ell = torch.zeros(lead, dtype=torch.int32, device=dev)
    gamma = torch.ones(lead, dtype=torch.int32, device=dev)
    zero_col = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
    for r in range(_NROOTS):
        v = s_rev_ext[..., _NROOTS - 1 - r : 2 * _NROOTS - r]
        delta = _xor_reduce(_gf_mul_dev(c, v))
        xk = torch.cat([zero_col, k[..., :-1]], dim=-1)
        c_new = _gf_mul_dev(gamma[..., None], c) ^ _gf_mul_dev(delta[..., None], xk)
        upd = (delta != 0) & (2 * ell <= r)
        k = torch.where(upd[..., None], c, xk)
        gamma = torch.where(upd, delta, gamma)
        ell = torch.where(upd, r + 1 - ell, ell)
        c = c_new
    return c, ell


def _poly_mul_scan(p: torch.Tensor, q: torch.Tensor,
                   out_len: int) -> torch.Tensor:
    """GF(256) polynomial product sum_k p[k] * x^k * q(x), truncated to
    out_len coefficients: 21 uniform-shape multiplies, each term a static
    roll of the zero-padded q (never wraps non-zeros into the low end,
    since deg q + 20 < 2*out_len)."""
    lead = p.shape[:-1]
    pad = out_len - q.shape[-1]
    q_ext = torch.cat(
        [q, torch.zeros(lead + (pad,), dtype=torch.int32, device=q.device)], dim=-1)
    out = torch.zeros_like(q_ext)
    for kk in range(_NROOTS + 1):
        term = _gf_mul_dev(p[..., kk, None], q_ext)
        out = out ^ torch.roll(term, kk, dims=-1)
    return out


def _poly_mul_mod20(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., 21) x (..., 20) GF(256) polynomial product mod x^20 (the
    Omega shape): terms of degree >= 20 roll into the padded top half and
    are sliced away."""
    return _poly_mul_scan(p, s, 2 * _NROOTS)[..., :_NROOTS]


def _chien_forney(loc: torch.Tensor, omega: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Locator (..., 21) + Omega (..., 20) -> (root (..., 207) bool,
    nroots (...,) int32, mag (..., 207) int32 error magnitudes, den
    (..., 207) int32 C'(X_i^-1) values — callers must reject den == 0 at
    roots). Chien search and both Forney evaluations are GF(2)-linear in
    the coefficient bits: two bit products + Fermat inversion."""
    dev = loc.device
    both = _bit_matmul(loc, const(_chien_lamprime_matrix, dev), 2 * _N)
    v, den = both[..., :_N], both[..., _N:]
    root = v == 0
    nroots = root.sum(dim=-1, dtype=torch.int32)
    num = _bit_matmul(omega, const(_omega_matrix, dev), _N)
    mag = _gf_mul_dev(_gf_mul_dev(num, _gf_inv_dev(den)), const(_alpha_j, dev))
    return root, nroots, mag, den


def rs_correct_field(
    codewords: torch.Tensor, syn: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched errors-only RS correction, entirely on the device.

    codewords: (..., 207) uint8; syn: (..., 20) uint8 (syndrome_field of
    the same codewords; any leading batch shape). Returns (corrected
    (..., 207) uint8, n_errors (...,) int32): n >= 0 bytes corrected, -1
    uncorrectable (codeword returned unchanged).
    """
    s = syn.to(torch.int32)
    cw = codewords.to(torch.int32)

    c, ell = _ribm(s)
    omega = _poly_mul_mod20(c, s)
    root, nroots, mag, den = _chien_forney(c, omega)

    ok = (
        (ell <= _NROOTS // 2)
        & (nroots == ell)
        & ~torch.any(root & (den == 0), dim=-1)
    )
    corrected = torch.where(root & ok[..., None], cw ^ mag, cw)
    syn2 = syndrome_field(corrected.to(torch.uint8))
    ok = ok & ~torch.any(syn2 != 0, dim=-1)
    out = torch.where(ok[..., None], corrected, cw).to(torch.uint8)
    n = torch.where(ok, nroots, -1)
    return out, n
