"""Models of the index maps of two hand kernels of the PyTorch port, on the
CPU: the state-parallel PR add-compare-select of csrc/viterbi_acs.cu and
the register-blocked FIR tiling of csrc/offset_fir.cu.

The kernels run only on a CUDA device (chip_smoke.py holds them against
their plain twins there). These models replay, in numpy, what each thread
of them reads, exchanges and writes, with the constants parsed from the
sources, so a wrong map shows here without a card:
- the PR model emulates every thread's owned state, its four metric
  shuffles, the per-group reset bits, the packing of picks and their
  transpose into decision words, and the xor-shuffle renormalization,
  step by step in float32 with one rounding per operation (as the kernel's
  __fadd_rn/__fmul_rn), and must equal pr_acs_forward_plain bit for bit;
- the FIR model checks that the blocks and threads own every output of
  [0, 261120) exactly once, read only inside the field, and that each
  thread's register window and tap order give each output its 111 taps in
  order k = 0..110.
"""

import os
import re

import numpy as np
import pytest
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops.cuda import viterbi_acs as vk

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "atsc_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source(source)).group(1))


# -- the PR add-compare-select -----------------------------------------------

PR_THREADS = _constant("viterbi_acs.cu", "kPrThreads")
_HI = tuple(int(x.strip().rstrip("u"), 16) for x in re.search(   # transpose16's kHi
    r"kHi\[4\] = \{([^}]*)\}", _source("viterbi_acs.cu")).group(1).split(","))


def _pred0(s2):
    return 2 * (s2 & 1) + (s2 >> 1)


def _transpose16(x: np.ndarray, wl: np.ndarray) -> np.ndarray:
    """The kernel's transpose16 on (W, 32) uint64-held words: four
    butterfly stages, each a __shfl_xor_sync and a block swap."""
    t, rows = wl & 15, np.arange(x.shape[0])[:, None]
    for i, hi in enumerate(_HI):
        b = 8 >> i
        y = x[rows, wl ^ b]
        lo = ~hi & 0xFFFFFFFF
        x = np.where(t & b, (x & hi) | ((y >> (2 * b)) & lo), (x & lo) | ((y << (2 * b)) & hi))
        x &= 0xFFFFFFFF
    return x


def _emulate_pr(threads: int, obs: np.ndarray, rc: np.ndarray, m_in: np.ndarray):
    """Every thread of pr_acs_forward_kernel<threads>, warp by warp, one
    step at a time. Returns (decisions (T, L) int32, metrics (16, L))."""
    f32 = np.float32
    steps, lanes = obs.shape
    lpb = threads // 16
    warps = -(-lanes // lpb) * (threads // 32)        # whole blocks
    wl = np.arange(32)[None, :].repeat(warps, 0)      # (W, 32) lane in the warp
    seg, t = wl >> 4, wl & 15                         # thread t owns state t
    lane = np.arange(warps)[:, None] * 2 + seg
    valid = lane < lanes
    lc = np.minimum(lane, lanes - 1)
    enc = lane % P.TRELLIS_ENCODERS
    s2, h1 = t >> 2, t & 3
    sp = _pred0(s2) ^ (h1 & 1)
    src = [seg * 16 + sp * 4 + h for h in range(4)]
    pc = [(2 * (2 * h + (sp & 1)) - 7).astype(f32) for h in range(4)]
    lv = (2 * (2 * h1 + (s2 & 1)) - 7).astype(f32)
    m = np.where(valid, m_in[t, lc], f32(0)).astype(f32)
    dec = np.zeros((steps, lanes), np.int64)
    rows = np.arange(warps)[:, None]
    for g0 in range(0, steps, vk.GROUP):
        grp = rc[g0:g0 + vk.GROUP, enc]                          # (24, W, 32)
        reset_bits = ((grp & 1) << np.arange(vk.GROUP)[:, None, None]).sum(0)
        sign_bits = (((grp >> 1) == 1) << np.arange(vk.GROUP)[:, None, None]).sum(0)
        with_resets = (reset_bits != 0).any(1, keepdims=True)   # __any_sync
        acc = np.zeros(m.shape, np.uint64)
        for s in range(vk.GROUP):
            mp = [m[rows, src[h]] for h in range(4)]              # __shfl_sync
            reset = with_resets & (((reset_bits >> s) & 1) == 1)
            sync = np.where((sign_bits >> s) & 1, f32(5), f32(-5))
            pe = [np.where(reset, sync, pc[h]) for h in range(4)]
            o = np.where(valid, obs[g0 + s, lc], f32(0)).astype(f32)
            a = o - lv
            c = []
            for h in range(4):
                tt = a + pe[h]
                c.append(mp[h] + tt * tt)
            m01, i01 = np.minimum(c[0], c[1]), c[1] < c[0]
            m23, i23 = np.minimum(c[2], c[3]), c[3] < c[2]
            m = np.minimum(m01, m23)
            sel = np.where(m23 < m01, 2 + i23, i01.astype(np.int64)).astype(np.uint64)
            acc |= sel << np.uint64(2 * (s % 16))
            if s in (15, vk.GROUP - 1):
                word = _transpose16(acc, wl)                     # thread t: step t
                row = g0 + s - s % 16 + t
                keep = valid & ((s == 15) | (t < vk.GROUP - 16))
                dec[row[keep], lane[keep]] = word[keep].astype(np.int64)
                acc[:] = 0
        mn = m                                                   # renormalize
        for off in (8, 4, 2, 1):
            mn = np.minimum(mn, mn[rows, wl ^ off])             # __shfl_xor_sync
        m = (m - mn).astype(f32)
    m_out = np.zeros((16, lanes), np.float32)
    m_out[t[valid], lane[valid]] = m[valid]
    dec = np.where(dec >= 1 << 31, dec - (1 << 32), dec).astype(np.int32)
    return dec, m_out


def _pr_inputs(lanes: int, seed: int):
    """48 steps of random combed observations, with the rc rows [48, 96)
    of the field (a segment-sync reset row at 69), from mixed metrics."""
    rng = np.random.default_rng(seed)
    obs = (4.0 * rng.standard_normal((48, lanes))).astype(np.float32)
    rc = np.ascontiguousarray(vk._pr_rc_table()[48:96])
    m_in = rng.uniform(0.0, 60.0, (16, lanes)).astype(np.float32)
    m_in[:, ::5] = 1e9
    m_in[0, ::5] = 0.0                                 # cold-started lanes
    return obs, rc, m_in


def test_pr_predecessor_groups_and_shuffle_sources():
    """Thread t owns state t; its four candidates read states sp*4 + h, the
    predecessor group of the plain twin's tables, fetched from thread
    sp*4 + h of the same lane."""
    from atsc_tpu_torch.ops.ntsc import _pr_tables

    t = np.arange(16)
    sp = _pred0(t >> 2) ^ (t & 1)
    lv, _, pred_idx, prev_lev = _pr_tables()
    np.testing.assert_array_equal(pred_idx, sp[:, None] * 4 + np.arange(4))
    np.testing.assert_array_equal(lv, 2 * (2 * (t & 3) + ((t >> 2) & 1)) - 7)
    np.testing.assert_array_equal(prev_lev, 2 * (2 * np.arange(4) + (sp[:, None] & 1)) - 7)


@pytest.mark.parametrize("seed", [0, 1])
def test_pr_transpose16_is_a_transpose(seed):
    """16 rows of 16 2-bit entries, two lanes per warp: thread t ends with
    column t of its lane's matrix."""
    rng = np.random.default_rng(seed)
    ent = rng.integers(0, 4, (3, 2, 16, 16))          # warp, lane, row t, entry j
    words = (ent.astype(np.uint64) << (2 * np.arange(16, dtype=np.uint64))).sum(-1)
    got = _transpose16(words.reshape(3, 32), np.arange(32)[None].repeat(3, 0))
    want = (ent.transpose(0, 1, 3, 2).astype(np.uint64)
            << (2 * np.arange(16, dtype=np.uint64))).sum(-1)
    np.testing.assert_array_equal(got, want.reshape(3, 32))


@pytest.mark.parametrize("lanes,threads", [(24, PR_THREADS), (13, PR_THREADS),
                                           (12, PR_THREADS), (60, PR_THREADS)])
def test_pr_state_parallel_model_equals_plain(lanes, threads):
    """T=48 with reset steps inside, 24 lanes (13: the last block part
    empty; 12 and 60: one and five channels): the emulated kernel's
    decisions and final metrics equal pr_acs_forward_plain bit for bit."""
    obs, rc, m_in = _pr_inputs(lanes, seed=lanes + threads)
    dec, m_out = _emulate_pr(threads, obs, rc, m_in)
    want_dec, want_m = vk.pr_acs_forward_plain(torch.tensor(obs), torch.tensor(rc),
                                               torch.tensor(m_in))
    assert (rc & 1).any()
    np.testing.assert_array_equal(dec, want_dec.numpy())
    np.testing.assert_array_equal(m_out.view(np.int32), want_m.numpy().view(np.int32))


# -- the FIR tiling ----------------------------------------------------------

FIR_R = _constant("offset_fir.cu", "kR")
FIR_THREADS = _constant("offset_fir.cu", "kThreads")


def _fir_layout(r: int):
    """The kernel's constants for R outputs per thread."""
    threads = FIR_THREADS
    halo = P.RRC_NTAPS - 1
    window = (r + halo + 3) // 4 * 4
    return threads, threads * r, window, (threads - 1) * r + window


@pytest.mark.parametrize("r", [FIR_R])
def test_fir_tiles_own_every_output_once_and_read_inside_the_field(r):
    threads, tile, window, staged = _fir_layout(r)
    assert P.PADDED_OUT % tile == 0
    blocks = P.PADDED_OUT // tile
    base = np.arange(blocks)[:, None] * tile
    j0 = base + np.arange(threads)[None, :] * r          # (blocks, threads)
    owned = np.zeros(P.PADDED_OUT, np.int64)
    np.add.at(owned, (j0[..., None] + np.arange(r)).reshape(-1), 1)
    assert (owned == 1).all()
    # staging reads [base, base + staged), in whole 4-sample vectors
    assert staged % 4 == 0 and (base + staged).max() <= P.PADDED_SYMBOLS
    # each thread's window, [j0, j0 + window), lies in its block's staging,
    # covers the R + 110 samples its outputs need, and starts 16-byte aligned
    assert ((j0 - base) % 4 == 0).all()
    assert (j0 + window <= base + staged).all() and window >= r + P.RRC_NTAPS - 1


@pytest.mark.parametrize("r", [FIR_R])
def test_fir_window_feeds_each_output_its_taps_in_order(r):
    """The unrolled loop (sample n of the window, then output q, tap
    k = n - q) gives every output taps 0..110 in increasing order."""
    _, _, window, _ = _fir_layout(r)
    seen = [[] for _ in range(r)]
    for n in range(window):
        for q in range(r):
            k = n - q
            if 0 <= k < P.RRC_NTAPS:
                seen[q].append(k)
    assert all(ks == list(range(P.RRC_NTAPS)) for ks in seen)


@pytest.mark.parametrize("fmt,wire", [("cf32", False), ("cs16", False), ("cs8", False),
                                      ("cs16", True), ("cs8", True)])
def test_fir_stores_cover_the_output_once_in_aligned_vectors(fmt, wire):
    """Each thread stores its R outputs 4 at a time per plane: over the
    wrapper's output layout (output_spec, B=3), every element is written
    exactly once and every store is aligned to its width (4 elements)."""
    from atsc_tpu_torch.ops.cuda import offset_fir as fir

    batch = 3
    shape, dtype = fir.output_spec(batch, fmt, wire)
    size = torch.empty((), dtype=dtype).element_size()
    planes = 1 if wire else 2
    threads, tile, _, _ = _fir_layout(FIR_R)
    written = np.zeros(int(np.prod(shape)), np.int64)
    j0 = (np.arange(P.PADDED_OUT // tile)[:, None] * tile
          + np.arange(threads)[None, :] * FIR_R).reshape(-1)
    for b in range(batch):
        for plane in range(planes):
            for r in range(0, FIR_R, 4):
                start = (b * planes + plane) * P.PADDED_OUT + j0 + r
                assert (start * size % (4 * size) == 0).all()
                np.add.at(written, (start[:, None] + np.arange(4)).reshape(-1), 1)
    assert (written == 1).all()
