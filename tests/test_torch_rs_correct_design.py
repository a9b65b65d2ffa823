"""A model of csrc/rs_correct.cu on the CPU, and the dispatch of
ops/rs_decode.py::rs_correct_field.

The kernel runs only on a CUDA device (chip_smoke.py holds it against its
plain twin there). This model replays, in numpy, what each warp and lane
of it reads, exchanges and writes, with the constants parsed from the
source: the grid of warps of 32 segments, each lane's five 4-byte
syndrome loads and the ballot of dirty lanes, the copy of the warp's bytes
(every byte once), and per dirty segment in ballot order the lane-held
Berlekamp-Massey rounds with the shuffle-XOR discrepancy and x^m B moved
up a lane, Omega, the Chien/Forney walk over the positions lane + 32 t and
the check syndromes summed per lane and reduced over the warp. It must
equal rs_correct_field_plain bit for bit (bytes and counts) on noisy
segments, errors in the parity bytes, 11-14 errors, syndromes built to
reach every rejection branch, and the leading shapes (B, 312) and
(F*B, 312).
"""

import os
import re

import numpy as np
import pytest
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops import rs_decode as trs
from atsc_tpu_torch.ops.cuda import rs_correct as rsk
from atsc_tpu_torch.tables.galois import gf_mul, gf_tables

torch.set_num_threads(2)

SEG, N, R = P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES, P.RS_BYTES
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "atsc_tpu_torch", "csrc", "rs_correct.cu")


def _constants() -> dict:
    """Every `constexpr int` of the source, its expression evaluated in
    order (C's integer division of positive ints is //)."""
    with open(SRC) as fh:
        text = fh.read()
    k: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        k[name] = int(eval(expr.replace("/", "//"), {}, dict(k)))
    return k


K = _constants()
TAB = rsk.gf_table_bytes().astype(np.int64)
EX, LG = TAB[: K["kExp"]], TAB[K["kExp"]:]
LANES = np.arange(32)
PAD = K["kPad"]


def test_constants_and_tables():
    assert (K["kN"], K["kRoots"], K["kMaxErrors"]) == (N, R, R // 2)
    assert K["kSegsPerWarp"] == 32 and K["kPosPerLane"] * 32 >= N > (K["kPosPerLane"] - 1) * 32
    assert K["kVecsPerLane"] * 32 * 16 >= K["kWarpBytes"] == 32 * N
    assert K["kWarpBytes"] % 16 == 0 and PAD == 32
    exp, log = gf_tables()
    np.testing.assert_array_equal(EX, exp)
    np.testing.assert_array_equal(LG, log)
    assert len(TAB) == K["kExp"] + K["kLog"] == 768


# -- the model -----------------------------------------------------------------

def _gmul(a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return np.where((a != 0) & (b != 0), EX[LG[a] + LG[b]], 0)


def _warp_xor(v: np.ndarray) -> np.ndarray:
    """The 5-step __shfl_xor_sync butterfly: lane l takes lane l ^ o."""
    o = 16
    while o:
        v = v ^ v[LANES ^ o]
        o >>= 1
    return v


def _uniform(v: np.ndarray) -> int:
    assert (v == v[0]).all()
    return int(v[0])


def _shfl_up(v: np.ndarray) -> np.ndarray:
    """__shfl_up_sync(v, 1), then lane 0 set to 0."""
    out = np.concatenate([v[:1], v[:-1]])
    out[0] = 0
    return out


def _decode_segment(src: np.ndarray, syn: np.ndarray):
    """decode_segment for one dirty segment: (patched bytes or None, n,
    the branch that decided)."""
    win = np.zeros(PAD + 32, np.int64)
    win[PAD + LANES] = np.where(LANES < R, syn[np.minimum(LANES, R - 1)], 0)

    c = (LANES == 0).astype(np.int64)
    xb = (LANES == 1).astype(np.int64)
    ell = log_b = 0
    for r in range(K["kRoots"]):
        d = _uniform(_warp_xor(_gmul(c, win[PAD + r - LANES])))
        nb = xb
        if d:
            lc = int(LG[d]) - log_b
            lc += 255 if lc < 0 else 0
            t = c
            c = c ^ np.where(xb != 0, EX[lc + LG[xb]], 0)
            if 2 * ell <= r:
                nb, log_b, ell = t, int(LG[d]), r + 1 - ell
        xb = _shfl_up(nb)
    if ell > K["kMaxErrors"]:
        return None, -1, "bm"

    loc = c
    o = np.zeros(32, np.int64)
    for i in range(K["kMaxErrors"] + 1):
        o ^= _gmul(loc[i], win[PAD + LANES - i])
    om = np.where(LANES < R, o, 0)
    lc = np.where(loc[: K["kMaxErrors"] + 1] != 0, LG[loc[: K["kMaxErrors"] + 1]], -1)

    p = LANES[:, None] + 32 * np.arange(K["kPosPerLane"])[None, :]   # (lane, t)
    valid = p < N
    byte = np.where(valid, src[np.minimum(p, N - 1)], 0)
    j = N - 1 - p
    step = 255 - j
    v = np.zeros_like(p)
    den = np.zeros_like(p)
    e = np.zeros_like(p)
    e_prev = np.zeros_like(p)
    for k in range(K["kMaxErrors"] + 1):
        if lc[k] >= 0:
            v ^= EX[lc[k] + e]
            if k & 1:   # C'(x) = sum over odd k of C_k x^(k-1)
                den ^= EX[lc[k] + e_prev]
        e_prev = e
        e = e + step
        e = e - np.where(e >= 255, 255, 0)
    root = valid & (v == 0)
    bad = root & (den == 0)
    num = np.zeros_like(p)
    e = np.zeros_like(p)
    for k in range(R):
        if om[k]:
            num ^= EX[LG[om[k]] + e]
        e = e + step
        e = e - np.where(e >= 255, 255, 0)
    fix = root & ~bad & (num != 0)
    mag = EX[(LG[num] + j + 255 - LG[np.where(den == 0, 1, den)]) % 255]
    patched = np.where(fix, byte ^ mag, byte)
    nroots = int(root.sum(axis=1).sum())   # each lane's popc, then __reduce_add_sync
    if nroots != ell or bad.any():
        return None, -1, "den" if bad.any() else "roots"

    w = np.zeros((32, R // 4), np.int64)
    e = np.zeros_like(p)
    live = valid & (patched != 0)
    lq = LG[patched]
    for s in range(R):
        term = np.where(live, EX[lq + e], 0)
        for t in range(K["kPosPerLane"]):
            w[:, s >> 2] ^= term[:, t] << (8 * (s & 3))
        e = e + j
        e = e - np.where(e >= 255, 255, 0)
    if any(_uniform(_warp_xor(w[:, q])) for q in range(R // 4)):
        return None, -1, "check"
    out = src.copy()
    out[p[root]] = patched[root]
    return out, ell, "accepted"


def kernel_model(cw: np.ndarray, syn: np.ndarray):
    """The launch over (nseg, 207) / (nseg, 20) uint8: (out, n, the branch
    of each segment)."""
    nseg = cw.shape[0]
    flat_in = cw.reshape(-1)
    flat_out = np.zeros(nseg * N, np.uint8)
    writes = np.zeros(nseg * N, np.int64)
    n = np.full(nseg, 7777, np.int64)
    branch = [None] * nseg
    per_block = K["kWarps"] * K["kSegsPerWarp"]
    blocks = (nseg + per_block - 1) // per_block
    words = syn.astype("<u1").reshape(nseg, R).view("<u4")          # five 4-byte loads
    for blk in range(blocks):
        for warp in range(K["kWarps"]):
            seg0 = (blk * K["kWarps"] + warp) * K["kSegsPerWarp"]
            if seg0 >= nseg:
                continue
            nw = min(32, nseg - seg0)
            s = np.zeros(32, np.int64)
            s[:nw] = np.bitwise_or.reduce(words[seg0:seg0 + nw], axis=1)
            dirty = [lane for lane in range(32) if s[lane] != 0]    # the ballot, ffs order
            base, length = seg0 * N, nw * N
            nvec = length >> 4
            for lane in range(32):
                for t in range(K["kVecsPerLane"]):
                    i = lane + 32 * t
                    if i < nvec:
                        sl = slice(base + 16 * i, base + 16 * i + 16)
                        flat_out[sl] = flat_in[sl]
                        writes[sl] += 1
            for i in range((nvec << 4), length):
                flat_out[base + i] = flat_in[base + i]
                writes[base + i] += 1
            for lane in range(nw):
                if lane not in dirty:
                    n[seg0 + lane], branch[seg0 + lane] = 0, "clean"
            for owner in dirty:
                seg = seg0 + owner
                got, cnt, why = _decode_segment(cw[seg].astype(np.int64),
                                                syn[seg].astype(np.int64))
                if got is not None:
                    flat_out[seg * N:(seg + 1) * N] = got
                n[seg], branch[seg] = cnt, why
    assert (writes == 1).all(), "the copy writes every byte once"
    assert (n != 7777).all()
    return flat_out.reshape(nseg, N), n.astype(np.int32), branch


def _held(cw: np.ndarray, want_branches=()):
    """cw (..., 207) uint8: the model against rs_correct_field_plain with
    syndrome_field's syndromes; returns the branches taken."""
    cw_t = torch.tensor(cw)
    syn = trs.syndrome_field(cw_t)
    return _held_syn(cw, syn.numpy(), want_branches)


def _held_syn(cw: np.ndarray, syn: np.ndarray, want_branches=()):
    lead = cw.shape[:-1]
    want_cw, want_n = trs.rs_correct_field_plain(torch.tensor(cw), torch.tensor(syn))
    got_cw, got_n, branch = kernel_model(cw.reshape(-1, N), syn.reshape(-1, R))
    np.testing.assert_array_equal(got_cw.reshape(cw.shape), want_cw.numpy())
    np.testing.assert_array_equal(got_n.reshape(lead), want_n.numpy())
    for b in want_branches:
        assert b in branch, (b, sorted(set(branch)))
    return branch


# -- the cases -----------------------------------------------------------------

def _clean(golden, field: int = 0) -> np.ndarray:
    return golden["rs"][field].reshape(SEG, N).copy()


def _inject(seg: np.ndarray, rng, k: int, positions=None) -> None:
    pos = rng.choice(np.arange(N) if positions is None else positions, size=k, replace=False)
    seg[pos] ^= rng.integers(1, 256, size=k).astype(np.uint8)


def _gf_inv(a: int) -> int:
    exp, log = gf_tables()
    return int(exp[(255 - log[a]) % 255])


def _parity_error_with_syndromes(target: np.ndarray) -> np.ndarray:
    """The error pattern in the 20 parity bytes whose syndromes are
    `target` (a GF(256) Vandermonde solve), as 207 bytes."""
    exp, _ = gf_tables()
    m = np.array([[int(exp[(s * (R - 1 - q)) % 255]) for q in range(R)] + [int(target[s])]
                  for s in range(R)], dtype=np.int64)
    for col in range(R):
        piv = next(r for r in range(col, R) if m[r, col])
        m[[col, piv]] = m[[piv, col]]
        m[col] = gf_mul(m[col], _gf_inv(int(m[col, col])))
        for r in range(R):
            if r != col and m[r, col]:
                m[r] ^= gf_mul(m[col], m[r, col]).astype(np.int64)
    e = np.zeros(N, np.uint8)
    e[N - R:] = m[:, R]
    return e


def _lfsr_syndromes(conn: np.ndarray, seed_vals: np.ndarray) -> np.ndarray:
    """20 terms of the sequence a connection polynomial conn (conn[0] = 1)
    generates from its first deg(conn) values."""
    s = np.zeros(R, np.int64)
    deg = len(conn) - 1
    s[:deg] = seed_vals
    for r in range(deg, R):
        acc = 0
        for i in range(1, deg + 1):
            acc ^= int(gf_mul(conn[i], s[r - i]))
        s[r] = acc
    return s


def _poly_mul(a, b) -> np.ndarray:
    out = np.zeros(len(a) + len(b) - 1, np.int64)
    for i, x in enumerate(a):
        for k, y in enumerate(b):
            out[i + k] ^= int(gf_mul(x, y))
    return out


def test_model_equals_plain_on_noisy_segments(golden):
    """tests/test_torch_rs_decode.py's noisy field: 0-12 errors a segment."""
    rng = np.random.default_rng(2026)
    bad = _clean(golden)[None].copy()
    for seg, k in enumerate(np.arange(SEG) % 13):
        _inject(bad[0, seg], rng, int(k))
    branch = _held(bad, ("clean", "accepted", "roots"))
    counts = np.arange(SEG) % 13
    assert all(branch[s] == "accepted" for s in range(SEG) if 1 <= counts[s] <= 10)


def test_model_equals_plain_on_parity_byte_errors(golden):
    rng = np.random.default_rng(21)
    bad = _clean(golden, 1)
    for seg in range(0, SEG, 3):
        _inject(bad[seg], rng, 1 + seg % 10, positions=np.arange(N - R, N))
    branch = _held(bad[:96], ("clean", "accepted"))
    assert branch.count("accepted") == 32


@pytest.mark.parametrize("k", [11, 12, 13, 14])
def test_model_equals_plain_beyond_ten_errors(golden, k):
    rng = np.random.default_rng(100 + k)
    bad = _clean(golden, 2)[:48]
    for seg in range(0, 48, 2):
        _inject(bad[seg], rng, k)
    _held(bad, ("clean",))


def test_model_reaches_every_rejection_branch(golden):
    """Syndromes built for each branch, on consistent codewords (an error
    pattern in the parity bytes carries them) except the last:
    - L > 10 (S = 0, ..., 0, 1: the length jumps to 20);
    - a double root of the locator, where C' = 0 (and fewer distinct
      roots than L);
    - roots outside the 207 valid positions;
    - the check: with consistent syndromes, L <= 10 and L distinct valid
      roots always give a codeword, so only syndromes of another error
      pattern than the bytes carry reach it."""
    clean = _clean(golden, 3)[:40]
    exp, _ = gf_tables()
    cw = clean.copy()
    t_bm = np.zeros(R, np.int64)
    t_bm[-1] = 1
    cw[1] ^= _parity_error_with_syndromes(t_bm)
    # (1 + X x)^2 (1 + Y x): C' vanishes at X^-1
    x_, y_ = int(exp[5]), int(exp[100])
    double = _poly_mul(_poly_mul([1, x_], [1, x_]), [1, y_])
    cw[3] ^= _parity_error_with_syndromes(_lfsr_syndromes(double, np.array([7, 9, 200])))
    # a locator whose roots lie at alpha^-j for j past 206 (no valid position)
    outside = _poly_mul([1, int(exp[230])], [1, int(exp[240])])
    cw[5] ^= _parity_error_with_syndromes(_lfsr_syndromes(outside, np.array([3, 17])))
    rng = np.random.default_rng(7)
    for seg in (7, 9):
        _inject(cw[seg], rng, 4)
    syn = trs.syndrome_field(torch.tensor(cw)).numpy()
    branch = _held_syn(cw, syn, ("clean", "bm", "den", "roots", "accepted"))
    assert branch[1] == "bm" and branch[3] == "den" and branch[5] == "roots"

    # the check: syndromes of one pattern over the bytes of another
    other = clean.copy()
    for seg in (11, 13, 15):
        _inject(other[seg], rng, 3)
    syn_other = trs.syndrome_field(torch.tensor(other)).numpy()
    mixed = clean.copy()
    for seg in (11, 13, 15):
        _inject(mixed[seg], rng, 2)
    branch = _held_syn(mixed, syn_other, ("check",))
    assert [branch[s] for s in (11, 13, 15)] == ["check"] * 3


@pytest.mark.parametrize("lead", [(2, SEG), (3 * 2, SEG)])
def test_model_equals_plain_on_leading_shapes(golden, lead):
    """(B, 312) and (F*B, 312): warps straddle channels and the last warp
    is ragged (624 and 1,872 segments)."""
    rng = np.random.default_rng(sum(lead))
    n_rows = lead[0]
    cw = np.stack([_clean(golden, r % 4) for r in range(n_rows)])
    for r in range(n_rows):
        for seg in rng.choice(SEG, size=12, replace=False):
            _inject(cw[r, seg], rng, int(rng.integers(1, 13)))
    branch = _held(cw, ("clean", "accepted"))
    assert len(branch) == n_rows * SEG


# -- the dispatch --------------------------------------------------------------

def test_cpu_tensors_reach_the_twin_and_never_the_kernel(golden, monkeypatch):
    def refuse(*_):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(trs, "rs_correct_kernel", refuse)
    before = rsk.LAUNCHES
    rng = np.random.default_rng(4)
    bad = _clean(golden)[:64].copy()
    for seg in range(0, 64, 4):
        _inject(bad[seg], rng, 3)
    cw, syn = torch.tensor(bad), trs.syndrome_field(torch.tensor(bad))
    got = trs.rs_correct_field(cw, syn)
    want = trs.rs_correct_field_plain(cw, syn)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rsk.LAUNCHES == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A CPU tensor, a wrong type or a syndrome shape that is not the
    codewords' raise before any launch."""
    cw = torch.zeros((2, N), dtype=torch.uint8)
    syn = torch.zeros((2, R), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        rsk.rs_correct(cw, syn)
    with pytest.raises(ValueError, match="codewords"):
        rsk.rs_correct(cw.to(torch.int32), syn)
    with pytest.raises(ValueError, match="syn"):
        rsk.rs_correct(cw, syn[:1])
