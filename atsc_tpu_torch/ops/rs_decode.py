"""Reed-Solomon RS(207,187) decoder: syndromes, and error and erasure
correction on the device.

Counterpart of atsc_tpu/ops/rs_decode.py (reference src/atsc/
reed_solomon.h:41-190 carries the scalar Berlekamp-Massey/Chien/Forney
decoder, dead code there):

* `syndrome_field` — "is this field clean?" is GF(2)-linear, so the
  syndrome bits are codeword_bits @ S (mod 2), one product for all 312
  segments of every channel.
* `rs_correct_field` — the errors-only decode as fixed-shape, branch-free
  arithmetic over all (B, 312) segments at once: GF(256) multiply and
  inverse as lookups in 64K/256-entry tables, the inversionless
  Berlekamp-Massey (RiBM) in 20 fixed rounds, and the Chien search and
  Forney evaluations as GF(2) bit products against precomputed matrices.
  (The JAX package multiplies by an 8-round carryless shift/XOR and
  inverts as a^254, because the TPU gathers poorly; on the card a gather
  from a table that stays in cache is one pass where those are ~90 and
  ~1100, and the integers are the same.)
* `rs_correct_field_erasures` — the errors-and-erasures decode (2*errors
  + erasures <= 20 per segment) on the same fixed-shape machinery, with a
  per-segment errors-only fallback for wrong or excessive flags.

CUDA matmul takes no integer operands, so every GF(2) bit product is a
float32 matmul reduced `& 1`. It is exact: the operands are 0/1 and each
sum is an integer <= 1656 < 2^24, and 0/1 survive TF32 too. These are
plain products that the JAX package leaves to XLA, so they go to
torch.matmul.
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

@functools.lru_cache(maxsize=1)
def _gf_mul_flat() -> np.ndarray:
    """(65536,) int32 GF(256) products: [a << 8 | b] = a * b."""
    a = np.arange(256)
    return gf_mul(a[:, None], a[None, :]).astype(np.int32).reshape(-1)


@functools.lru_cache(maxsize=1)
def _gf_inv_table() -> np.ndarray:
    """(256,) int32 GF(256) inverses, 0 -> 0."""
    exp, log = gf_tables()
    inv = np.zeros(256, np.int32)
    inv[1:] = exp[(255 - log[1:].astype(np.int64)) % 255]
    return inv


def _gf_mul_dev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) multiply (int32 in, int32 out, broadcasting): a
    lookup in the 64K product table."""
    idx = (a.to(torch.int32) << 8) | b.to(torch.int32)
    return const(_gf_mul_flat, idx.device)[idx]


def _gf_inv_dev(a: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) inverse; maps 0 -> 0 (callers must reject
    den == 0 explicitly)."""
    return const(_gf_inv_table, a.device)[a.to(torch.int32)]


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


def _ribm(s: torch.Tensor, n_active: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inversionless Berlekamp-Massey (RiBM), 20 fixed rounds.

    s: (..., 20) int32 syndrome sequence. n_active: optional (...,) int32
    per-segment count of active rounds — rounds r >= n_active freeze every
    register (the errors-and-erasures tier runs BM on a shifted
    modified-syndrome sequence whose valid length, 20 - e, is a
    per-segment value, not a shape). Returns (C (..., 21) int32, the
    locator scaled by the accumulated gamma product — the scale cancels in
    Forney's Omega/C' ratio — and ell (...,) int32, the register length =
    error count). Round r's discrepancy window s[r-i] is a slice of the
    padded reversed syndromes; out-of-range terms are zero, so the
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
        if n_active is None:
            k = torch.where(upd[..., None], c, xk)
        else:
            act = r < n_active
            upd = upd & act
            c_new = torch.where(act[..., None], c_new, c)
            k = torch.where(upd[..., None], c, torch.where(act[..., None], xk, k))
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


def _erasure_locator(flags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 207) uint8/bool byte-erasure flags -> (Gamma (..., 21) int32
    erasure-locator coefficients, e (...,) int32 erasure counts).

    Gamma(x) = prod_{flagged i} (1 - X_i x), X_i = alpha^(206-i), built by
    a 207-step loop multiplying in one linear factor per flagged position
    (each step: one GF multiply over 21 lanes and a 1-slot slide). Degrees
    past 20 are silently truncated — callers reject e > 20 before using
    Gamma.
    """
    f = flags != 0
    e = f.sum(dim=-1, dtype=torch.int32)
    lead = f.shape[:-1]
    dev = f.device
    g = torch.zeros(lead + (_NROOTS + 1,), dtype=torch.int32, device=dev)
    g[..., 0] = 1
    zero_col = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
    xs = const(_alpha_j, dev)
    for i in range(_N):
        shifted = torch.cat([zero_col, _gf_mul_dev(g[..., :-1], xs[i])], dim=-1)
        g = torch.where(f[..., i, None], g ^ shifted, g)
    return g, e


def rs_correct_field_erasures(
    codewords: torch.Tensor, syn: torch.Tensor, flags: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched errors-and-erasures RS correction, entirely on the device.

    Corrects any mix of nu errors + e flagged byte erasures with 2*nu + e
    <= 20 per segment (against errors <= 10), falling back per segment to
    the errors-only decode where the erasure decode fails (wrong or
    excessive flags).

    Formulation: erasure locator Gamma by a loop over the 207 positions
    (_erasure_locator); modified syndromes T = S*Gamma mod x^20; the error
    locator from the same inversionless BM as the errors-only tier, run on
    the shifted sequence U_r = T_{e+r} (valid length 20 - e, handled by
    masking BM rounds); combined locator Psi = C*Gamma; Omega = S*Psi mod
    x^20; Chien/Forney on Psi through the same bit products. Acceptance:
    2*ell + e <= 20, #roots == ell + e, no root at Psi' == 0, Psi's degree
    fits, and the patched codeword's recomputed syndromes are zero.

    codewords/syn as rs_correct_field; flags (..., 207) uint8/bool.
    Returns (corrected (..., 207) uint8, n (...,) int32): n >= 0 bytes
    changed, -1 uncorrectable either way.
    """
    s = syn.to(torch.int32)
    cw = codewords.to(torch.int32)

    gamma, e = _erasure_locator(flags)
    t_mod = _poly_mul_mod20(gamma, s)

    # U_r = T_{e+r}, zero past the valid window (the BM rounds are masked
    # by n_active = 20 - e anyway, so the fill value is immaterial)
    idx = e[..., None] + torch.arange(_NROOTS, dtype=torch.int32, device=s.device)
    u = torch.where(idx < _NROOTS,
                    torch.gather(t_mod, -1, torch.clamp(idx, max=_NROOTS - 1).to(torch.int64)),
                    0)

    # the erasure branch and its per-segment errors-only fallback ride
    # every shared stage as one doubled batch: [0] = errors-only on S,
    # [1] = the erasure decode on U
    s2 = torch.stack([s, u])
    n_act = torch.stack([torch.full_like(e, _NROOTS), _NROOTS - e])
    c2, ell2 = _ribm(s2, n_active=n_act)
    c_plain, c_era = c2[0], c2[1]
    ell = ell2[1]

    # combined locator Psi = C * Gamma: the full product (41 coefficients),
    # its tail required zero (deg Psi = ell + e <= 20 whenever decodable)
    psi_full = _poly_mul_scan(c_era, gamma, 2 * _NROOTS + 1)
    psi = psi_full[..., : _NROOTS + 1]
    tail_ok = ~torch.any(psi_full[..., _NROOTS + 1 :] != 0, dim=-1)

    loc2 = torch.stack([c_plain, psi])
    omega2 = _poly_mul_mod20(loc2, s.expand(s2.shape))
    root2, nroots2, mag2, den2 = _chien_forney(loc2, omega2)

    ok_plain = (
        (ell2[0] <= _NROOTS // 2)
        & (nroots2[0] == ell2[0])
        & ~torch.any(root2[0] & (den2[0] == 0), dim=-1)
    )
    ok_era = (
        (e <= _NROOTS)
        & (2 * ell + e <= _NROOTS)
        & (nroots2[1] == ell + e)
        & tail_ok
        & ~torch.any(root2[1] & (den2[1] == 0), dim=-1)
    )
    ok2 = torch.stack([ok_plain, ok_era])
    cand2 = torch.where(root2 & ok2[..., None], cw ^ mag2, cw)
    syn2 = syndrome_field(cand2.to(torch.uint8))
    ok2 = ok2 & ~torch.any(syn2 != 0, dim=-1)
    n_changed = (root2[1] & (mag2[1] != 0)).sum(dim=-1, dtype=torch.int32)

    # the erasure decode wins where it verified; else the errors-only
    # fallback (it succeeds whenever the true errors are <= 10); else the
    # codeword unchanged with n = -1
    out = torch.where(ok2[1][..., None], cand2[1],
                      torch.where(ok2[0][..., None], cand2[0], cw))
    n = torch.where(ok2[1], n_changed, torch.where(ok2[0], nroots2[0], -1))
    return out.to(torch.uint8), n.to(torch.int32)
