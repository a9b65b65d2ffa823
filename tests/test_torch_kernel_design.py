"""Models of the index maps of the redesigned hand kernels of the PyTorch
port, on the CPU: the state-parallel PR and 4-state add-compare-select
passes and the chunk-parallel tracebacks of csrc/viterbi_acs.cu, the
register-blocked FIR tiling of csrc/offset_fir.cu and the tensor-core band
tiling of the fast equalizer tier in csrc/eq_fir.cu.

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
  order k = 0..110;
- the 4-state model emulates the butterfly (2 threads per lane, two
  states each) thread by thread: held states, the shuffled state,
  decision packing and its merge into words, the 3 x 8 step words of a
  24-step group and the renormalization, and must equal acs_forward_plain
  bit for bit on float32 and int8 observations;
- the equalizer model replays the fast tier's 16 x 16 tiles: the blocks,
  warps and tiles own every output of [0, 260416) once, read only inside
  the window, each lane's ldmatrix row addresses and the host-built B
  operand image give the mma fragments of the band-16 product, which sums
  to banded_fir_wl over the 128-wide band weights, and the kernel's
  chunked float32 accumulation stays within the fast tier's 1e-4 of
  eq_fir_plain;
- the traceback model runs the three phases of both chunked tracebacks
  (the chunks of whole groups, every entry chain of a chunk to the group
  where they merge, the map of an unmerged chunk, the entry states
  resolved from the top chunk down, the heads walked again) and must
  equal traceback_plain / pr_traceback_plain bit for bit on forward-pass,
  random and never-merging decisions; it checks that the head walk writes
  only words the first phase left, and that below the head it would write
  the same words;
- the chunked 4-state models replay the chunk-lane threads of
  acs_forward_chunked_kernel (the peeled, padded front word, the groups
  of words read from registers filled a group ahead, the last words, the
  decision byte put together from masks, the per-step renormalization)
  and of traceback_chunked_kernel (output words in stream order from
  funnel-shifted decision words held in a ring refilled ahead, the chain
  on doubled states, whole-word stores inside a kept region and bytes on
  its boundary words, written once each), and must equal
  acs_forward_chunked_plain / traceback_chunked_plain bit for bit at
  window lengths of every residue mod 4;
- the chunked PR models replay pr_acs_forward_chunked_kernel at 1, 2 and
  4 threads a chunk-lane (the state split by s2 with its shuffle sources,
  the groups of steps read from rows loaded a group ahead, the
  warp-uniform no-reset path, the decision bits from the sign bits of
  float32 differences, the store owner of each word) and
  pr_traceback_chunked_kernel (output words as 4-step chains over a ring
  of words copied ahead, stream realignment by start(c), whole words
  inside a kept region and bytes on its boundary words, each written
  once), and must equal pr_acs_forward_chunked_plain /
  pr_traceback_chunked_plain bit for bit with reset steps in every window;
- the trellis model replays trellis_fused_kernel on 32-bit words (the
  byte prefix of a word, the packed word totals, one warp scan a round
  with the row's carry byte, the four planes by shifts and masks, the
  4 x 4 byte transpose), the persistent grid's walk with its loads a
  round ahead, and the store map (every output byte once, each warp store
  one 512-byte run), and must equal trellis_fused_plain bit for bit in
  both layouts at 12 and 36 rows, and the JAX probe once.
"""

import functools
import importlib.util
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


# -- the 4-state add-compare-select ------------------------------------------

ACS_THREADS = _constant("viterbi_acs.cu", "kAcsThreads")
_PILOT = np.float32(1.25)


def _emulate_acs(obs: np.ndarray, m_in: np.ndarray, inv=None):
    """Every thread of acs_forward_kernel (the butterfly, 2 threads per
    lane), warp by warp, one step at a time, in float32 with one rounding
    per operation. Returns (decisions (T/4, L) int32, metrics (4, L))."""
    f32 = np.float32
    steps, lanes = obs.shape
    warps = -(-lanes * 2 // ACS_THREADS) * (ACS_THREADS // 32)
    wl = np.arange(32)[None, :].repeat(warps, 0)
    tid = np.arange(warps)[:, None] * 32 + wl
    b, lane = tid & 1, tid >> 1
    valid = lane < lanes
    lc = np.where(valid, lane, lanes - 1)
    rows = np.arange(warps)[:, None]
    lv = [(2 * v - 7).astype(f32) + _PILOT for v in (b, b + 4, b + 2, b + 6)]
    m, m2 = m_in[3 * b, lc], m_in[1 + b, lc]
    dec = np.zeros((steps // 4, lanes), np.int64)

    def survivor(c0, c1, z0, z1):
        x1 = c1 < c0
        return np.minimum(c0, c1), (x1 | (np.where(x1, z1, z0) << 1)).astype(np.uint64)

    for g0 in range(0, steps, vk.GROUP):
        w = np.zeros((2,) + m.shape, np.uint64)
        for s in range(vk.GROUP):
            o = obs[g0 + s, lc]
            o = o if inv is None else o.astype(f32) * f32(inv)
            d = []
            for lvi in lv:
                tt = o - lvi
                d.append(tt * tt)
            p0, z0 = np.minimum(d[0], d[1]), (d[1] < d[0]).astype(np.uint64)
            p1, z1 = np.minimum(d[2], d[3]), (d[3] < d[2]).astype(np.uint64)
            keep, dk = survivor(m + p0, m2 + p1, z0, z1)              # new state 3b
            send, ds = survivor(m2 + p0, m + p1, z0, z1)              # new state 2 - b
            m, m2 = keep, send[rows, wl ^ 1]                          # __shfl_xor_sync
            byte = (dk << (6 * b).astype(np.uint64)) | (ds << (4 - 2 * b).astype(np.uint64))
            w[s % 8 // 4] |= byte << np.uint64(8 * (s % 4))
            if s % 8 == 7:
                recv = np.where(b == 1, w[0], w[1])[rows, wl ^ 1]
                word = np.where(b == 1, w[1], w[0]) | recv
                row = g0 // 4 + s // 8 * 2 + b
                dec[row[valid], lane[valid]] = word[valid].astype(np.int64)
                w[:] = 0
        mn = np.minimum(m, m2)                                         # renormalize
        mn = np.minimum(mn, mn[rows, wl ^ 1])
        m, m2 = m - mn, m2 - mn
    m_out = np.zeros((4, lanes), np.float32)
    m_out[3 * b[valid], lane[valid]] = m[valid]
    m_out[1 + b[valid], lane[valid]] = m2[valid]
    dec = np.where(dec >= 1 << 31, dec - (1 << 32), dec).astype(np.int32)
    return dec, m_out


def _acs_inputs(lanes: int, seed: int, int8: bool):
    """48 steps (two renormalization groups) of random soft levels, or
    their int8 codes, from mixed metrics with cold-started lanes."""
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV, quantize_soft_levels

    rng = np.random.default_rng(seed)
    obs = torch.tensor((4.0 * rng.standard_normal((48, lanes))).astype(np.float32))
    m_in = rng.uniform(0.0, 60.0, (4, lanes)).astype(np.float32)
    m_in[:, ::5] = 1e9
    m_in[0, ::5] = 0.0
    if int8:
        return quantize_soft_levels(obs), torch.tensor(m_in), SOFT_LEVEL_INV
    return obs, torch.tensor(m_in), None


def test_acs_design_constant_is_a_modelled_one():
    assert ACS_THREADS % 32 == 0 and vk.GROUP % 8 == 0


@pytest.mark.parametrize("lanes", [1, 12, 13, 16, 17, 60])
@pytest.mark.parametrize("int8", [False, True])
def test_acs_state_parallel_model_equals_plain(lanes, int8):
    """T=48 at one lane, one channel (12 lanes, fewer than a warp holds),
    13 and 17 lanes (part-empty warps), 16 (one full warp) and five
    channels: the emulated kernel's decisions and final metrics equal
    acs_forward_plain bit for bit."""
    obs, m_in, inv = _acs_inputs(lanes, seed=lanes + 14, int8=int8)
    dec, m_out = _emulate_acs(obs.numpy(), m_in.numpy(), inv)
    want_dec, want_m = vk.acs_forward_plain(obs, m_in, inv)
    np.testing.assert_array_equal(dec, want_dec.numpy())
    np.testing.assert_array_equal(m_out.view(np.int32), want_m.numpy().view(np.int32))


def test_acs_butterfly_state_map():
    """Thread b holds states (3b, 1 + b); the two threads hold each state
    once. The new states it makes, 3b (kept) and 2 - b (sent), are the two
    with low bit b, and their predecessors under the trellis (new state
    2a + b from 2b + a at X1 = 0, 2b + 1 - a at X1 = 1) are the pair it
    holds, in the order the kernel adds them: kept = (x, y), sent = (y, x)."""
    held = {b: (3 * b, 1 + b) for b in (0, 1)}
    assert sorted(held[0] + held[1]) == [0, 1, 2, 3]
    for b, (x, y) in held.items():
        for new, want in ((3 * b, (x, y)), (2 - b, (y, x))):
            a = new >> 1
            assert new & 1 == b
            assert (2 * b + a, 2 * b + 1 - a) == want
    # the sent state is the other thread's next y
    assert [2 - b for b in (0, 1)] == [held[1 - b][1] for b in (0, 1)]


# -- the tensor-core equalizer (fast tier) -----------------------------------

def _eq_layout() -> dict:
    """The fast tier's constants, from csrc/eq_fir.cu."""
    k = {n: _constant("eq_fir.cu", n) for n in (
        "kWinLen", "kNOut", "kFastK", "kBand", "kChunkBands", "kTcWarps", "kTilesPerWarp",
        "kTcChannels", "kRowBytes")}
    k["kBands"] = 2 * k["kFastK"] // k["kBand"] + 1
    k["kTcCols"] = k["kTcWarps"] * k["kTilesPerWarp"] * k["kBand"] ** 2
    k["kTcGrid"] = -(-k["kNOut"] // k["kTcCols"])
    k["kRows"] = k["kTcCols"] // k["kBand"] + k["kBands"] - 1
    k["kPlaneBytes"] = k["kRows"] * k["kRowBytes"]
    return k


EQL = _eq_layout()


def _eq_tiles():
    """(block base (G, 1), first staged row of each warp tile (1, W * TPW))."""
    base = np.arange(EQL["kTcGrid"])[:, None] * EQL["kTcCols"]
    a0 = np.arange(EQL["kTcWarps"] * EQL["kTilesPerWarp"])[None, :] * EQL["kBand"]
    return base, a0


def _a_fragment_samples(a0: int, band: int, plane: int) -> np.ndarray:
    """(32, 4, 2): the staged sample (of the plane, relative to the block
    base) that ldmatrix.x4 delivers to each lane, register and half, from
    the kernel's row addresses (a_lane + a0 rows + plane + band rows)."""
    lane = np.arange(32)
    q = lane >> 3
    addr = (plane * EQL["kPlaneBytes"]
            + (a0 + band + (lane & 7) + 8 * (q & 1)) * EQL["kRowBytes"] + (q >> 1) * 16)
    out = np.empty((32, 4, 2), np.int64)
    for j in range(4):           # matrix j: rows from lanes 8j..8j+7; lane t gets row t // 4
        for e in range(2):
            byte = addr[8 * j + lane // 4] + 4 * (lane % 4) + 2 * e - plane * EQL["kPlaneBytes"]
            assert (byte % EQL["kRowBytes"] < 2 * EQL["kBand"]).all()   # inside a row's data
            out[:, j, e] = byte // EQL["kRowBytes"] * EQL["kBand"] + byte % EQL["kRowBytes"] // 2
    return out


def _b_image(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """atsc_eq_fir_set_taps' tier-0 image: (34, 32, 4, 2) tap values, band
    plane bp = 2 s + (0 re, 1 im), lane, register r = 2 nt + hk, half e."""
    bands = EQL["kBands"]
    bp, lane, r, e = np.meshgrid(np.arange(2 * bands), np.arange(32), np.arange(4),
                                 np.arange(2), indexing="ij")
    n = 8 * (r // 2) + lane // 4
    k = 2 * (lane % 4) + 8 * (r % 2)
    t = EQL["kBand"] * (bp // 2) + k + e - n
    taps = np.where(bp % 2 == 1, q[np.clip(t, 0, p.size - 1)],
                    p[np.clip(t, 0, p.size - 1)])
    return np.where((t >= 0) & (t < p.size), taps, 0.0).astype(np.float32)


def _b_matrices(img: np.ndarray) -> np.ndarray:
    """(34, 16, 16) B[k][n] from the image through the mma B layout: lane
    (g, c), register {b0, b1} of column tile nt: k = 2c + (0, 1), n = 8 nt +
    g; {b2, b3}: k + 8."""
    out = np.full((img.shape[0], 16, 16), np.nan, np.float32)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for r in range(4):
            nt, hk = r // 2, r % 2
            for e in range(2):
                out[:, 2 * c + 8 * hk + e, 8 * nt + g] = img[:, lane, r, e]
    assert not np.isnan(out).any()
    return out


def _eq_taps():
    from atsc_tpu_torch.ops.cuda import eq_fir as teq

    p, q = teq._taps_f32(EQL["kFastK"])
    return teq._bf16_round(p), teq._bf16_round(q)


def test_eq_constants_match_the_wrapper():
    from atsc_tpu_torch.ops.cuda import eq_fir as teq

    assert (EQL["kWinLen"], EQL["kNOut"]) == (teq.WIN_LEN, teq.N_OUT)
    assert teq.TIERS[(EQL["kFastK"], False)] == 0


def test_eq_tiles_own_every_output_once_and_read_inside_the_window():
    """Blocks x warps x tiles x rows g + 8h: every output of [0, 260416)
    stored once (rows past the end masked, 16 outputs a row); each block
    stages [base, base + rows * 16) inside the window; every A operand row
    lies in the staged rows."""
    base, a0 = _eq_tiles()
    rows = (base // EQL["kBand"] + a0)[..., None] + np.arange(16)       # (G, tiles, 16)
    j = rows[..., None] * EQL["kBand"] + np.arange(EQL["kBand"])
    stored = j[rows * EQL["kBand"] < EQL["kNOut"]]
    owned = np.bincount(stored.reshape(-1), minlength=EQL["kNOut"])
    assert owned.size == EQL["kNOut"] and (owned == 1).all()
    span = EQL["kRows"] * EQL["kBand"]
    assert base.min() >= 0 and (base + span).max() <= EQL["kWinLen"]
    assert span % 16 == 0 and EQL["kTcCols"] % 16 == 0       # cp.async pieces, int8 too
    assert a0.max() + 15 + EQL["kBands"] - 1 < EQL["kRows"]
    # the last output reads sample 260416 - 1 + 256, inside the last block's span
    assert (EQL["kNOut"] - 1 + 2 * EQL["kFastK"]) < base.max() + span


def test_eq_ldmatrix_rows_are_the_band_operands():
    """Lane t, register j, half e of ldmatrix.x4 at the kernel's addresses
    holds A_s[row][k] = u[16 (a0 + s + row) + k] in the mma A layout:
    row = t // 4 + 8 (j & 1), k = 2 (t % 4) + 8 (j >> 1) + e; and the 8
    row addresses of each ldmatrix phase fall in distinct 16-byte bank
    groups."""
    lane = np.arange(32)
    for a0 in (0, EQL["kBand"], 3 * EQL["kBand"]):
        for band in range(EQL["kBands"]):
            for plane in range(2):
                got = _a_fragment_samples(a0, band, plane)
                for j in range(4):
                    for e in range(2):
                        row = lane // 4 + 8 * (j & 1)
                        k = 2 * (lane % 4) + 8 * (j >> 1) + e
                        np.testing.assert_array_equal(got[:, j, e],
                                                      16 * (a0 + band + row) + k)
                q = lane >> 3
                addr = (a0 + band + (lane & 7) + 8 * (q & 1)) * EQL["kRowBytes"] + (q >> 1) * 16
                for j in range(4):
                    slots = addr[8 * j:8 * j + 8] % 128 // 16
                    assert len(set(slots.tolist())) == 8


def test_eq_b_image_is_the_band_matrices():
    """The host-built fragment image, read through the mma B layout, is
    P_s[k][n] = p[16 s + k - n] and Q_s likewise (0 outside the taps)."""
    p, q = _eq_taps()
    mats = _b_matrices(_b_image(p, q))
    k, n = np.arange(16)[:, None], np.arange(16)[None, :]
    for bp in range(2 * EQL["kBands"]):
        taps = q if bp % 2 else p
        t = 16 * (bp // 2) + k - n
        want = np.where((t >= 0) & (t < taps.size), taps[np.clip(t, 0, taps.size - 1)], 0.0)
        np.testing.assert_array_equal(mats[bp], want)


def _eq_planes(seed: int):
    """A B=1 random window through the plain twin's derotation and bf16
    rounding: (ur, ui) float32 holding bf16 values, and the window."""
    from atsc_tpu_torch import params as TP
    from atsc_tpu_torch.models.receiver import _osc_planar
    from atsc_tpu_torch.ops.cuda import eq_fir as teq

    n = TP.SYMBOLS_PER_FIELD
    rng = np.random.default_rng(seed)
    win = torch.tensor(rng.normal(0.0, 0.3, (1, 2, teq.WIN_LEN)).astype(np.float32))
    osc = torch.tensor(_osc_planar(n - 128, n - 128 + teq.WIN_LEN, 0))
    s = torch.tensor(teq._scale(1.0))
    wr, wi, cr, ci = win[0, 0], win[0, 1], osc[0], osc[1]
    ur = ((wr * cr + wi * ci) * s).to(torch.bfloat16).to(torch.float32)
    ui = ((wi * cr - wr * ci) * s).to(torch.bfloat16).to(torch.float32)
    return ur.numpy(), ui.numpy(), win, osc


def _band16(ur, ui, mats, chunked: bool) -> np.ndarray:
    """The kernel's sum over all tiles: per band s and plane the product
    of the staged rows shifted by s with B_s, in float64 (chunked=False),
    or as the kernel accumulates (chunked=True): products of a chunk of
    kChunkBands bands from zero in float32, chunk sums added in float32."""
    rows = EQL["kTcGrid"] * EQL["kTcCols"] // 16
    need = (rows + EQL["kBands"] - 1) * 16
    planes = [x[:need].reshape(-1, 16) for x in (ur, ui)]
    dt = np.float32 if chunked else np.float64
    total = None
    for c0 in range(0, EQL["kBands"], EQL["kChunkBands"]):
        acc = np.zeros((rows, 16), dt)
        for s in range(c0, min(c0 + EQL["kChunkBands"], EQL["kBands"])):
            for plane in range(2):
                a = planes[plane][s:s + rows].astype(dt)
                b = mats[2 * s + plane].astype(dt)
                for k in range(16):          # one product at a time, rounded per add
                    acc = acc + a[:, k:k + 1] * b[k][None, :]
        total = acc if total is None else total + acc
    return total.reshape(-1)[:EQL["kNOut"]]


def test_eq_band16_sum_equals_banded_fir_wl():
    """Summed in float64, the 34 shifted band products equal banded_fir_wl
    over _band_weights(128) (the 128-wide bands of the TPU form) to 1e-12."""
    from atsc_tpu_torch.ops.cuda import eq_fir as teq
    from atsc_tpu_torch.ops.rrc_filter import banded_fir_wl

    ur, ui, _, _ = _eq_planes(21)
    mats = _b_matrices(_b_image(*_eq_taps()))
    got = _band16(ur, ui, mats, chunked=False)
    w = teq._band_weights(EQL["kFastK"], "bfloat16").to(torch.float64)
    want = banded_fir_wl(torch.tensor(ur, dtype=torch.float64),
                         torch.tensor(ui, dtype=torch.float64), w, teq.N_OUT).numpy()
    assert np.abs(got - want).max() < 1e-12


def test_eq_chunked_float32_accumulation_within_the_fast_tier_limit():
    """The kernel's chunked float32 accumulation stays within 1e-4 (the
    fast tier's limit on soft levels) of eq_fir_plain."""
    from atsc_tpu_torch.ops.cuda import eq_fir as teq

    ur, ui, win, osc = _eq_planes(22)
    mats = _b_matrices(_b_image(*_eq_taps()))
    got = _band16(ur, ui, mats, chunked=True)
    want = teq.eq_fir_plain(win, osc, soft=True)[0].numpy()
    assert np.abs(got - want).max() < 1e-4


# -- the exact equalizer tier: 3 x TF32 on the tensor cores ------------------

def _tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to tf32 as the kernels' tf32_bits does: + 0x1000, low 13
    bits cleared (to nearest, ties away from zero)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32(x)
    return hi, _tf32((np.asarray(x, np.float32) - hi).astype(np.float32))


def _rz(v: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """acc + sum_k a[..., k] b[..., k] over one 8-term k-step, worse than the
    tensor cores: the products exact, the step's sum rounded toward zero to
    float32, then the accumulation rounded toward zero."""
    step = _rz((a.astype(np.float64) * b.astype(np.float64)).sum(-1))
    return _rz(acc.astype(np.float64) + step.astype(np.float64))


def _kahan(s: np.ndarray, c: np.ndarray, x: np.ndarray):
    y = (x - c).astype(np.float32)
    t = (s + y).astype(np.float32)
    return t, ((t - s).astype(np.float32) - y).astype(np.float32)


def _xl_layout() -> dict:
    """The exact tier's constants, from csrc/eq_fir.cu."""
    k = {n: _constant("eq_fir.cu", n) for n in (
        "kWinLen", "kNOut", "kExactK", "kXBand", "kXWarps", "kXTilesPerWarp", "kXChunkSteps")}
    k["kTaps"] = 2 * k["kExactK"] + 1
    k["kXNt"] = k["kXBand"] // 8
    k["kXBands"] = (k["kTaps"] - 1 + k["kXBand"] - 1) // k["kXBand"] + 1
    k["kXRows"] = k["kXWarps"] * k["kXTilesPerWarp"] * 16
    k["kXCols"] = k["kXRows"] * k["kXBand"]
    k["kXGrid"] = -(-k["kNOut"] // k["kXCols"])
    k["kXStaged"] = k["kXRows"] + k["kXBands"] - 1
    k["kXRowBytes"] = 4 * (4 * k["kXBand"] + 4)
    k["kXTapLen"] = k["kXBand"] * (k["kXBands"] + 1)
    return k


XL = _xl_layout()


def _x_tap_image(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """atsc_eq_fir_set_taps' tier-1 image: (4, kXTapLen) planes p hi, p lo,
    q hi, q lo, tap t at kXBand + t."""
    img = np.zeros((4, XL["kXTapLen"]), np.float32)
    for pl, taps in enumerate((p, q)):
        img[2 * pl:2 * pl + 2, XL["kXBand"]:XL["kXBand"] + taps.size] = _split(taps)
    return img


def _x_lane_taps(img: np.ndarray, sb: int, kh: int, nt: int, plane: int, half: int):
    """(32, 2) the b0, b1 words lane (g, t4) loads for band sb, k-step kh,
    n-tile nt: image[2 plane + half][kXBand + 8 m + t4 - g (+ 4)], m = kXNt
    sb + kh - nt (tap_lane + 8 m in the kernel)."""
    lane = np.arange(32)
    m = XL["kXNt"] * sb + kh - nt
    at = XL["kXBand"] + 8 * m + (lane & 3) - (lane >> 2)
    idx = np.stack([at, at + 4], 1)
    assert idx.min() >= 0 and idx.max() < XL["kXTapLen"]
    return img[2 * plane + half][idx]


def _x_taps():
    from atsc_tpu_torch.models.receiver import _wl_eq_taps

    return _wl_eq_taps(XL["kExactK"])


def _x_golden_planes():
    """The derotated planes of the golden window (stream span from 256
    samples before field 1) as the plain twin makes them, and that twin's
    exact soft levels."""
    from atsc_tpu_torch.models.receiver import field_window
    from atsc_tpu_torch.ops.cuda import eq_fir as teq

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                                  "golden.npz"))
    n = P.SYMBOLS_PER_FIELD
    win, osc = field_window(golden["iq"].reshape(1, -1), n, margin=XL["kExactK"],
                            length=teq.WIN_LEN)
    win, osc = torch.tensor(win), torch.tensor(osc)
    s = torch.tensor(teq._scale(1.0))
    wr, wi, cr, ci = win[0, 0], win[0, 1], osc[0], osc[1]
    ur = ((wr * cr + wi * ci) * s).numpy()
    ui = ((wi * cr - wr * ci) * s).numpy()
    want = teq.eq_fir_plain(win, osc, eq_k=XL["kExactK"], exact=True, soft=True)[0].numpy()
    return ur, ui, want


def _x_model(ur, ui, img, outputs: np.ndarray) -> np.ndarray:
    """The exact tier's levels at `outputs`, as the kernel takes them: per
    band, plane and k-step, lo*hi and hi*lo into one accumulator and hi*hi
    into another (_mma), the two added every kXChunkSteps k-steps and the
    chunks summed with Kahan compensation; the taps from the image through
    each lane's tap-block map."""
    band, nt_ = XL["kXBand"], XL["kXNt"]
    planes = [_split(ur), _split(ui)]
    n = outputs % band
    nt, col = n // 8, n % 8              # output column n' of the tile: B's column g
    s_ = np.zeros(outputs.size, np.float32)
    c_ = s_.copy()
    big, small = s_.copy(), s_.copy()
    steps = 0
    for sb in range(XL["kXBands"]):
        for pl in range(2):
            for kh in range(nt_):
                # B[k'][n'] of block m = kXNt sb + kh - nt through lane (g = n', t4)
                bh = np.empty((outputs.size, 8), np.float32)
                bl = np.empty_like(bh)
                for t in range(nt_):
                    sel = nt == t
                    for half, dst in ((0, bh), (1, bl)):
                        words = _x_lane_taps(img, sb, kh, t, pl, half)       # (32, 2)
                        blk = np.empty((8, 8), np.float32)                   # [k'][n']
                        for lane in range(32):
                            blk[lane & 3, lane >> 2] = words[lane, 0]
                            blk[(lane & 3) + 4, lane >> 2] = words[lane, 1]
                        dst[sel] = blk[:, col[sel]].T
                k = band * sb + 8 * kh + np.arange(8)      # A[row][k]: u[band (a + sb) + k]
                idx = (outputs - n)[:, None] + k[None, :]
                ah, al = planes[pl][0][idx], planes[pl][1][idx]
                small = _mma(small, al, bh)
                small = _mma(small, ah, bl)
                big = _mma(big, ah, bh)
                steps += 1
                if steps % XL["kXChunkSteps"] == 0:
                    s_, c_ = _kahan(s_, c_, (big + small).astype(np.float32))
                    big, small = np.zeros_like(big), np.zeros_like(small)
    assert steps % XL["kXChunkSteps"] == 0
    return (s_ - c_).astype(np.float32)


def test_eq_exact_constants_and_source_maps():
    """The exact tier's tile constants, the wrapper's contract, and the
    kernel's lane maps the models below replay (parsed from the source)."""
    from atsc_tpu_torch.ops.cuda import eq_fir as teq

    src = _source("eq_fir.cu")
    assert (XL["kWinLen"], XL["kNOut"]) == (teq.WIN_LEN, teq.N_OUT)
    assert teq.TIERS[(XL["kExactK"], True)] == 1
    assert XL["kXBand"] % 8 == 0 and XL["kNOut"] % XL["kXBand"] == 0
    assert (2 * XL["kXNt"]) % XL["kXChunkSteps"] == 0
    assert XL["kXRowBytes"] % 128 == 16
    for expr in ("s_taps + kXBand + t4 - g",
                 "8 * (kXNt * sb + d - (kXNt - 1)) + 2 * pl * kXTapLen",
                 "const int d = kh - nt + kXNt - 1;",
                 "(row0 + (lane & 7) + 8 * (q & 1)) * kXRowBytes + (q >> 1) * 16",
                 "(16 * tile + sb) * kXRowBytes + 4 * (2 * pl * kXBand + 8 * kh)",
                 "ldmatrix_x4(al, a + 4 * kXBand);",
                 "mma_tf32(small[tile][nt], al, bh[d][0], bh[d][1]);",
                 "mma_tf32(small[tile][nt], ah, bl[d][0], bl[d][1]);",
                 "mma_tf32(big[tile][nt], ah, bh[d][0], bh[d][1]);",
                 "(pl * kXNt + kh + 1) % kXChunkSteps == 0",
                 '#include "tensor_core.cuh"'):
        assert expr in src, expr
    assert "return (x + 0x1000u) & 0xFFFFE000u;" in _source("tensor_core.cuh")


def test_eq_exact_tiles_own_every_output_once_and_read_inside_the_window():
    """Blocks x warps x tiles x rows g + 8h x n-tiles x columns 2 t4 + e:
    every output of [0, 260416) stored once; each block stages [base, base
    + kXStaged kXBand) inside the window; every A row a tile's bands read
    lies in the staged rows."""
    band = XL["kXBand"]
    blocks = np.arange(XL["kXGrid"])[:, None, None]
    rows = (np.arange(XL["kXWarps"] * XL["kXTilesPerWarp"])[None, :, None] * 16
            + np.arange(16)[None, None, :])                        # the rows g + 8 h of a tile
    j_row = blocks * XL["kXCols"] + rows * band
    j = j_row[..., None] + np.arange(band)                          # 8 nt + 2 t4 + e
    stored = j[j_row < XL["kNOut"]]
    owned = np.bincount(stored.reshape(-1), minlength=XL["kNOut"])
    assert owned.size == XL["kNOut"] and (owned == 1).all()
    span = XL["kXStaged"] * band
    base = np.arange(XL["kXGrid"]) * XL["kXCols"]
    assert base.min() >= 0 and (base + span).max() <= XL["kWinLen"]
    assert rows.max() + XL["kXBands"] - 1 < XL["kXStaged"]
    # the last output reads sample 260415 + 512, inside the last block's span
    assert XL["kNOut"] - 1 + 2 * XL["kExactK"] < base.max() + span
    assert span % 4 == 0 and XL["kXCols"] % 16 == 0   # float4 / short4 / char4 staging


def test_eq_exact_ldmatrix_rows_are_the_band_operands():
    """Lane t, register j of ldmatrix.x4 at the kernel's addresses holds
    A[row][k] = u[kXBand (a0 + sb + row) + 8 kh + k] of the plane and half
    in the mma tf32 A layout: row = t // 4 + 8 (j & 1), k = t % 4 + 4 (j >> 1);
    the 8 row addresses of a phase fall in distinct 16-byte bank groups."""
    lane = np.arange(32)
    q = lane >> 3
    rb, band = XL["kXRowBytes"], XL["kXBand"]
    for a0 in (0, 16, 16 * (XL["kXWarps"] * XL["kXTilesPerWarp"] - 1)):
        for sb in (0, 1, XL["kXBands"] - 1):
            for pl in range(2):
                for half in range(2):
                    for kh in range(XL["kXNt"]):
                        addr = ((a0 + (lane & 7) + 8 * (q & 1)) * rb + (q >> 1) * 16
                                + sb * rb + 4 * ((2 * pl + half) * band + 8 * kh))
                        for j in range(4):
                            byte = addr[8 * j + lane // 4] + 4 * (lane % 4)
                            row, off = byte // rb, byte % rb // 4
                            assert ((off // band) == 2 * pl + half).all()
                            got = row * band + off % band
                            want = (band * (a0 + sb + lane // 4 + 8 * (j & 1)) + 8 * kh
                                    + lane % 4 + 4 * (j >> 1))
                            np.testing.assert_array_equal(got, want)
                            slots = addr[8 * j:8 * j + 8] % 128 // 16
                            assert len(set(slots.tolist())) == 8


def test_eq_exact_tap_image_gives_the_band_product():
    """The host's hi/lo tap image, read through each lane's tap-block map,
    is B_sb[k][n] = taps[kXBand sb + k - n] split into tf32 parts (hi =
    tf32(tap), hi + lo within 2^-22 of it); summed in float64, the band
    products over the golden planes equal banded_fir_wl over
    _band_weights(256, float32) within the split's residual."""
    from atsc_tpu_torch.ops.cuda import eq_fir as teq
    from atsc_tpu_torch.ops.rrc_filter import banded_fir_wl

    p, q = _x_taps()
    img = _x_tap_image(p, q)
    band, nt_ = XL["kXBand"], XL["kXNt"]
    mats = np.zeros((XL["kXBands"], 2, 2, band, band), np.float64)  # [sb][plane][half][k][n]
    for sb in range(XL["kXBands"]):
        for pl in range(2):
            for half in range(2):
                for kh in range(nt_):
                    for nt in range(nt_):
                        words = _x_lane_taps(img, sb, kh, nt, pl, half)
                        for lane in range(32):
                            k, n = 8 * kh + (lane & 3), 8 * nt + (lane >> 2)
                            mats[sb, pl, half, k, n] = words[lane, 0]
                            mats[sb, pl, half, k + 4, n] = words[lane, 1]
            taps = (p, q)[pl]
            k, n = np.arange(band)[:, None], np.arange(band)[None, :]
            t = band * sb + k - n
            want = np.where((t >= 0) & (t < taps.size), taps[np.clip(t, 0, taps.size - 1)], 0)
            np.testing.assert_array_equal(mats[sb, pl, 0], _tf32(want.astype(np.float32)))
            full = mats[sb, pl, 0] + mats[sb, pl, 1]
            assert (np.abs(full - want) <= 2.0 ** -22 * np.abs(want)).all()
    ur, ui, _ = _x_golden_planes()
    rows = XL["kNOut"] // band
    need = (rows + XL["kXBands"] - 1) * band
    planes = [x[:need].astype(np.float64).reshape(-1, band) for x in (ur, ui)]
    got = np.zeros((rows, band))
    for sb in range(XL["kXBands"]):
        for pl in range(2):
            got += planes[pl][sb:sb + rows] @ (mats[sb, pl, 0] + mats[sb, pl, 1])
    w = teq._band_weights(XL["kExactK"], "float32").to(torch.float64)
    want = banded_fir_wl(torch.tensor(ur, dtype=torch.float64),
                         torch.tensor(ui, dtype=torch.float64), w, teq.N_OUT).numpy()
    assert np.abs(got.reshape(-1) - want).max() < 1e-6


def test_eq_exact_split_arithmetic_within_the_exact_tier_limit():
    """The kernel's 3 x TF32 arithmetic, every k-step and accumulation
    rounded toward zero, with Kahan chunk sums, stays within the exact
    tier's 1e-5 of eq_fir_plain (exact, soft) on 4,096 outputs of the
    golden window (the first and last block's and random ones), and its
    hard symbols equal the twin's away from decision boundaries."""
    ur, ui, want = _x_golden_planes()
    img = _x_tap_image(*_x_taps())
    rng = np.random.default_rng(13)
    n = XL["kNOut"]
    outputs = np.unique(np.concatenate([np.arange(1024), np.arange(n - 1024, n),
                                        rng.choice(n, 2048, replace=False)]))
    got = _x_model(ur, ui, img, outputs)
    err = np.abs(got - want[outputs])
    assert err.max() <= 1e-5, err.max()

    def hard(lev):
        return np.clip(np.round((lev - (P.PILOT_OFFSET - 7.0)) * 0.5), 0, 7)

    x = (want[outputs] + 5.75) * 0.5
    near = np.abs(x - np.floor(x) - 0.5) < 1e-4 * 0.5
    assert ((hard(got) == hard(want[outputs])) | near).all()


# -- the banded-matmul probe: 3 x TF32 on the tensor cores -------------------

def _fv_layout() -> dict:
    """csrc/fir_variants.cu's constants."""
    k = {n: _constant("fir_variants.cu", n) for n in (
        "kBlk", "kInRows", "kOutRows", "kTaps", "kTile", "kGroupTiles", "kTapOff")}
    k["kSteps"] = 2 * k["kBlk"] // 8
    k["kNTiles"] = k["kBlk"] // 8
    k["kBlocks"] = (k["kTaps"] - 1 + 7) // 8 + 1
    k["kRowWarps"] = k["kNTiles"] // k["kGroupTiles"]
    k["kWarps"] = k["kTile"] // 16 * k["kRowWarps"]
    k["kWalk"] = k["kGroupTiles"] + k["kBlocks"] - 1
    k["kTapLen"] = k["kTapOff"] + 8 * k["kWalk"]
    return k


FV = _fv_layout()
FV_CASES = [("base", 5), ("base", 15), ("base", 17), ("onedot", 5), ("sharedmod", 5),
            ("combo", 5), ("combo", 15)]


def _fv_steps(c0: int):
    """The (k-step qs, n-tile c, tap block d) a warp with first n-tile c0
    runs, in order, as the kernel's loops: qq over [0, kWalk), c over its
    n-tiles, d = qq - c, the zero blocks (d outside [0, kBlocks)) skipped.
    Also replays the sliding window of tap blocks (blk[c]: prefilled with
    blocks -1 - c, each step shifting blk[c - 1] into blk[c] and loading
    block qq into blk[0]) and asserts each product reads the block it
    needs and each A fragment lies in K = 256."""
    window = [-1 - c if c + 1 < FV["kGroupTiles"] else None for c in range(FV["kGroupTiles"])]
    out = []
    for qq in range(FV["kWalk"]):
        window = [qq] + window[:-1]
        qs = c0 + qq
        assert 0 <= qs < FV["kSteps"]
        for c in range(FV["kGroupTiles"]):
            d = qq - c
            if d < 0 or d >= FV["kBlocks"]:
                continue
            assert window[c] == d, (c0, qq, c, window)
            out.append((qs, c, d))
    return out


def _fv_lane_blocks(w2_part: np.ndarray) -> np.ndarray:
    """(kWalk + 3, 8, 8) D_d[k][n] as the lanes load them (d = -3 ..
    kWalk - 1 at index d + 3, every block the window loads): the block's
    tap plane holds c[t] = W2[8 + t][8] at kTapOff + t (zeros around), and
    lane (g, t4) loads b0 (k = t4, n = g) at kTapOff + 8 d + t4 - g and b1
    (k = t4 + 4) 4 on."""
    plane = np.zeros(FV["kTapLen"], np.float32)
    t = np.arange(FV["kTaps"])
    plane[FV["kTapOff"] + t] = w2_part[8 + t, 8]
    out = np.full((FV["kWalk"] + 3, 8, 8), np.nan, np.float32)
    for d in range(1 - FV["kGroupTiles"], FV["kWalk"]):
        for lane in range(32):
            g, t4 = lane >> 2, lane & 3
            for e in range(2):
                at = FV["kTapOff"] + 8 * d + t4 + 4 * e - g
                assert 0 <= at < FV["kTapLen"]
                out[d + 3, t4 + 4 * e, g] = plane[at]
    assert not np.isnan(out).any()
    return out


def test_fir_variant_constants_and_source_maps():
    from atsc_tpu_torch.ops.cuda import fir_variants as tfv

    src = _source("fir_variants.cu")
    assert FV["kOutRows"] == P.PADDED_OUT // FV["kBlk"] == tfv._OUT_ROWS
    assert FV["kInRows"] * FV["kBlk"] == P.PADDED_SYMBOLS
    assert FV["kTaps"] == P.RRC_TAPS
    assert FV["kTile"] % 16 == 0 and FV["kNTiles"] % FV["kGroupTiles"] == 0
    for expr in ("const int rt = warp / kRowWarps;",
                 "const int c0 = (warp % kRowWarps) * kGroupTiles;",
                 "constexpr int kWalk = kGroupTiles + kBlocks - 1;",
                 "constexpr int kTapLen = kTapOff + 8 * kWalk;",
                 "split_tf32(__ldg(w2 + (8 + t) * kBlk + 8), hi, lo);",
                 "s_taps[i] = __uint_as_float(hi);",
                 "s_taps[kTapLen + i] = __uint_as_float(lo);",
                 "s_taps + kTapOff + t4 - g",
                 "const float* tp = tap_lane + 8 * qq;",
                 "const float* tp = tap_lane + 8 * (-1 - c);",
                 "for (int qq = 0; qq < kWalk; ++qq) {",
                 "if (d < 0 || d >= kBlocks) continue;",
                 "for (int c = 0; c + 1 < kGroupTiles; ++c) {",
                 "for (int c = kGroupTiles - 1; c > 0; --c)",
                 "for (int k = 0; k < 4; ++k) blk[c][k] = blk[c - 1][k];",
                 "blk[0][2] = __float_as_uint(tp[kTapLen]), "
                 "blk[0][3] = __float_as_uint(tp[kTapLen + 4]);",
                 "(16 * rt + (lane & 7) + 8 * (q & 1)) * kRowBytes + (q >> 1) * 16",
                 "a_base + (SHARED_MOD ? 1 : kTile) * kRowBytes",
                 "(qs < kSteps / 2 ? a_base : b_base) + 4 * 8 * (qs % (kSteps / 2))",
                 "const int d = qq - c;",
                 "mma_tf32(small[p][c], al, blk[c][0], blk[c][1]);",
                 "mma_tf32(small[p][c], ah, blk[c][2], blk[c][3]);",
                 "mma_tf32(big[p][c], ah, blk[c][0], blk[c][1]);",
                 '#include "tensor_core.cuh"'):
        assert expr in src, expr
    header = _source("tensor_core.cuh")
    for expr in ("hi = tf32_bits(__float_as_uint(x));",
                 "lo = tf32_bits(__float_as_uint(__fsub_rn(x, __uint_as_float(hi))));"):
        assert expr in header, expr


@pytest.mark.parametrize("variant,nchunk", FV_CASES, ids=[f"{v}-{n}" for v, n in FV_CASES])
def test_fir_variant_tiles_own_every_output_once(variant, nchunk):
    """Blocks (nchunk per channel) x tiles of kTile rows x warps (row tile
    rt, n-tiles from c0) x rows g + 8h x columns: every output (row, column)
    of [0, 2040) x [0, 128) stored once; every tile's raw rows lie in the
    field; every A row (a row, or b row one down) lies in the staged rows."""
    shared = variant in ("sharedmod", "combo")
    per = FV["kOutRows"] // nchunk
    owned = np.zeros((FV["kOutRows"], FV["kBlk"]), np.int64)
    for blk in range(nchunk):
        begin, end = blk * per, (blk + 1) * per
        for j0 in range(begin, end, FV["kTile"]):
            valid = min(FV["kTile"], end - j0)
            assert j0 + valid + 1 <= FV["kInRows"]          # the raw rows copied
            for w in range(FV["kWarps"]):
                rt, c0 = w // FV["kRowWarps"], (w % FV["kRowWarps"]) * FV["kGroupTiles"]
                rows = 16 * rt + np.arange(16)
                # a rows 16 rt + r; b rows one down (shared) or the b array's same row
                top = rows.max() + (1 if shared else 0)
                assert top < (FV["kTile"] + 1 if shared else FV["kTile"])
                rows = rows[rows < valid]
                cols = 8 * (c0 + np.arange(FV["kGroupTiles"]))[:, None] + np.arange(8)
                np.add.at(owned, ((j0 + rows)[:, None], cols.reshape(-1)[None, :]), 1)
    assert (owned == 1).all()


@pytest.mark.parametrize("c0", range(0, FV["kNTiles"], FV["kGroupTiles"]))
def test_fir_variant_tap_window_holds_each_steps_block(c0):
    """The warp whose first n-tile is c0: its products read the tap block
    of their step from the sliding window, and each of its n-tiles runs
    each of its kBlocks nonzero k-steps once."""
    steps = _fv_steps(c0)
    pairs = [(qs, c) for qs, c, _ in steps]
    assert len(pairs) == len(set(pairs)) == FV["kBlocks"] * FV["kGroupTiles"]


def test_fir_variant_skipped_steps_are_zero_and_the_taps_the_image():
    """Each warp runs, per n-tile, exactly the k-steps whose tap block of
    [W_lo; W_hi] is nonzero, and the block it uses is D_{qs - nt} as the
    lanes load it from the taps the block split from W2 (hi = tf32(W2),
    hi + lo within 2^-22 of W2); every block the window loads outside
    [0, kBlocks) is zero."""
    from atsc_tpu_torch.ops.cuda import fir_variants as tfv

    w2 = tfv._w2().astype(np.float64)
    assert tfv._w2().shape == (256, FV["kBlk"])
    parts = _split(tfv._w2())
    assert (np.abs(parts[0].astype(np.float64) + parts[1] - w2) <= 2.0 ** -22 * np.abs(w2)).all()
    hi, lo = _fv_lane_blocks(parts[0]), _fv_lane_blocks(parts[1])
    outside = [d + 3 for d in range(1 - FV["kGroupTiles"], FV["kWalk"])
               if not 0 <= d < FV["kBlocks"]]
    assert not hi[outside].any() and not lo[outside].any()
    for c0 in range(0, FV["kNTiles"], FV["kGroupTiles"]):
        seen = set()
        for qs, c, d in _fv_steps(c0):
            nt = c0 + c
            assert d == qs - nt
            np.testing.assert_array_equal(hi[d + 3], parts[0][8 * qs:8 * qs + 8, 8 * nt:8 * nt + 8])
            np.testing.assert_array_equal(lo[d + 3], parts[1][8 * qs:8 * qs + 8, 8 * nt:8 * nt + 8])
            seen.add((qs, nt))
        for c in range(FV["kGroupTiles"]):
            nt = c0 + c
            nonzero = {qs for qs in range(FV["kSteps"])
                       if w2[8 * qs:8 * qs + 8, 8 * nt:8 * nt + 8].any()}
            assert {qs for qs, t in seen if t == nt} == nonzero


def _fv_model(field: torch.Tensor, phasor: torch.Tensor, variant: str, rows: np.ndarray):
    """The kernel's (I, Q) at output rows `rows` of channel 0: modulate, split,
    per warp step (qs, c, d) lo*hi and hi*lo into one accumulator and hi*hi
    into another (_mma); ONE_DOT false folds the W_lo pair at qs = 16 and
    adds the W_hi pair at the end; then the phasor rotation."""
    from atsc_tpu_torch.ops.cuda import fir_variants as tfv
    from atsc_tpu_torch.ops.offset import _osc_planar

    one_dot = variant in ("onedot", "combo")
    osc = _osc_planar()
    lvl = (field[0].numpy().astype(np.float32) * np.float32(2.0)
           + np.float32(P.PILOT_OFFSET - 7.0)).astype(np.float32)
    ops = [_split((lvl * osc[0]).astype(np.float32)), _split((lvl * osc[1]).astype(np.float32))]
    parts = _split(tfv._w2())
    hi, lo = _fv_lane_blocks(parts[0]), _fv_lane_blocks(parts[1])
    blk = FV["kBlk"]
    out = np.zeros((2, rows.size, blk), np.float32)
    for c0 in range(0, FV["kNTiles"], FV["kGroupTiles"]):
        acc = {}
        for p in range(2):
            for c in range(FV["kGroupTiles"]):
                z = np.zeros((rows.size, 8), np.float32)
                acc[p, c] = [z.copy(), z.copy(), z.copy()]       # big, small, half
        for qs, c, d in _fv_steps(c0):
            if not one_dot and qs == FV["kSteps"] // 2 and c == 0:
                for a in acc.values():
                    a[2] = (a[0] + a[1]).astype(np.float32)
                    a[0], a[1] = np.zeros_like(a[0]), np.zeros_like(a[1])
            idx = (rows * blk + 8 * qs)[:, None] + np.arange(8)   # A[j][8 qs + k]
            for p in range(2):
                ah, al = ops[p][0][idx], ops[p][1][idx]
                bh, bl = hi[d + 3], lo[d + 3]
                a = acc[p, c]
                for n in range(8):      # output column 8 (c0 + c) + n
                    a[1][:, n] = _mma(a[1][:, n], al, np.broadcast_to(bh[:, n], al.shape))
                    a[1][:, n] = _mma(a[1][:, n], ah, np.broadcast_to(bl[:, n], ah.shape))
                    a[0][:, n] = _mma(a[0][:, n], ah, np.broadcast_to(bh[:, n], ah.shape))
        for c in range(FV["kGroupTiles"]):
            for p in range(2):
                big, small, half = acc[p, c]
                f = (big + small).astype(np.float32)
                if not one_dot:
                    f = (half + f).astype(np.float32)
                out[p, :, 8 * (c0 + c):8 * (c0 + c) + 8] = f
    pr, pi = phasor[0].numpy()
    fu, fw = out
    return np.stack([(fu * pr - fw * pi).astype(np.float32),
                     (fu * pi + fw * pr).astype(np.float32)])


@pytest.mark.parametrize("variant", ["base", "sharedmod", "onedot", "combo"])
def test_fir_variant_split_arithmetic_within_the_probe_limit(variant):
    """The kernel's 3 x TF32 arithmetic, every k-step and accumulation
    rounded toward zero, stays within the probe's 2e-6 of run_variant_plain
    and of offset_fir_plain on 64 output rows (the field's first and last
    32, golden field 0's symbols) of channel 0."""
    from atsc_tpu_torch.ops.cuda import fir_variants as tfv
    from atsc_tpu_torch.ops.cuda import offset_fir as tof

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                                  "golden.npz"))
    levels0 = golden["sync"][0].real.astype(np.float32)
    sym = np.rint((levels0 - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    sym[P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS:] = 0
    field = torch.tensor(sym[None])
    phasor = torch.tensor([[0.8, 0.6]], dtype=torch.float32)
    rows = np.concatenate([np.arange(32), np.arange(FV["kOutRows"] - 32, FV["kOutRows"])])
    got = _fv_model(field, phasor, variant, rows)
    cols = (rows[:, None] * FV["kBlk"] + np.arange(FV["kBlk"])).reshape(-1)
    got = got.reshape(2, -1)
    keep = cols < P.SYMBOLS_PER_FIELD
    plain = tfv.run_variant_plain(field, phasor, variant)[0].numpy()[:, cols]
    direct = tof.offset_fir_plain(field, phasor)[0].numpy()[:, cols]
    assert np.abs(got - plain)[:, keep].max() <= 2e-6
    assert np.abs(got - direct)[:, keep].max() <= 2e-6


# -- the chunk-parallel tracebacks -------------------------------------------

TB_CHUNKS = _constant("viterbi_acs.cu", "kTbChunks")       # 4-state
PR_TB_CHUNKS = _constant("viterbi_acs.cu", "kPrTbChunks")
TB_LANES = _constant("viterbi_acs.cu", "kTbLanes")


def _tb_step(pr: bool, dec: np.ndarray, t: int, states: np.ndarray):
    """Step t of the traceback on every chain, states (L, n) = the states
    into step t: (the step's x1 | z2<<1 pair of each chain, the states
    into step t - 1). dec holds the words as unsigned int64."""
    if pr:
        h = (dec[t][:, None] >> (2 * states)) & 3
        s2 = states >> 2
        pred = ((2 * (s2 & 1)) | (s2 >> 1)) ^ (states & 1)
        return states & 3, (pred << 2) | h
    byte = (dec[t // 4] >> (8 * (t % 4))) & 0xFF
    sel = (byte[:, None] >> (2 * states)) & 3
    return sel, ((states & 1) << 1) | ((states >> 1) ^ (sel & 1))


def _tb_group(pr: bool, dec: np.ndarray, g: int, states: np.ndarray):
    """Group g, last step first: (pairs (24, L, n) in step order, the states
    at the group's bottom)."""
    out = np.empty((vk.GROUP,) + states.shape, np.int64)
    for i in range(vk.GROUP - 1, -1, -1):
        out[i], states = _tb_step(pr, dec, g * vk.GROUP + i, states)
    return out, states


def _emulate_tb(dec: np.ndarray, start: np.ndarray, pr: bool):
    """The three phases of chunked_traceback<Tb4> (pr=False, dec (T/4, L))
    or <TbPr> (dec (T, L)), every lane at once, chunk by chunk. A thread's
    map is held as its S chains' states (L, S); a merged thread's chains
    are all one state, so it walks them as its one chain. Phase 3 walks
    each chunk to its bottom, writes only its head and checks that below
    the head it would write exactly what phase 1 wrote. Returns (bits
    (T/4, L) int32, heads (chunks, L) in groups, chunk sizes in groups)."""
    n_s = 16 if pr else 4
    groups = dec.shape[0] // (vk.GROUP if pr else vk.GROUP // 4)
    lanes = dec.shape[1]
    chunks = min(PR_TB_CHUNKS if pr else TB_CHUNKS, groups)
    bounds = [(c * groups // chunks, (c + 1) * groups // chunks) for c in range(chunks)]
    dec = dec.astype(np.int64) & 0xFFFFFFFF
    start = start.astype(np.int64)
    pair = np.full((groups * vk.GROUP, lanes), -1, np.int64)      # -1: not written
    maps, heads, merged_state = [], [], []
    for c, (bottom, top) in enumerate(bounds):                     # phase 1
        top_chunk = c == chunks - 1
        m = np.repeat(start[:, None], n_s, 1) if top_chunk else np.tile(np.arange(n_s),
                                                                        (lanes, 1))
        merged = np.full(lanes, top_chunk)
        head = np.zeros(lanes, np.int64)
        at = np.full(lanes, -1, np.int64)
        for g in range(top - 1, bottom - 1, -1):
            out, m_next = _tb_group(pr, dec, g, m)
            rows = pair[g * vk.GROUP:(g + 1) * vk.GROUP]
            rows[:, merged] = out[:, merged, 0]
            head += ~merged
            now = ~merged & (m_next == m_next[:, :1]).all(1)
            at = np.where(now, m_next[:, 0], at)
            merged |= now
            m = m_next
        maps.append(m)
        heads.append(head)
        merged_state.append(at)
    entry = start                                                  # phase 2
    for c in range(chunks - 2, -1, -1):
        entry = maps[c + 1][np.arange(lanes), entry]
        bottom, top = bounds[c]                                    # phase 3
        s = entry[:, None]
        for g in range(top - 1, bottom - 1, -1):
            out, s_next = _tb_group(pr, dec, g, s)
            rows = pair[g * vk.GROUP:(g + 1) * vk.GROUP]
            in_head = g >= top - heads[c]
            assert (rows[:, in_head] == -1).all()
            np.testing.assert_array_equal(rows[:, ~in_head], out[:, ~in_head, 0])
            rows[:, in_head] = out[:, in_head, 0]
            end = (g == top - heads[c]) & (heads[c] < top - bottom)   # the merge group
            np.testing.assert_array_equal(s_next[end, 0], merged_state[c][end])
            s = s_next
    assert (pair >= 0).all()
    words = (pair.reshape(-1, 4, lanes) << (8 * np.arange(4))[None, :, None]).sum(1)
    bits = np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32)
    return bits, np.stack(heads), np.array([top - bottom for bottom, top in bounds])


def _tb_decisions(pr: bool, kind: str, steps: int, lanes: int, seed: int):
    """(decisions, start) of one kind: "real", the forward pass's on noisy
    8-level symbols (σ 0.5, through the PR comb's reset rows for pr);
    "random" words; "unmerged", words on which no two chains ever merge
    (4-state: in every byte the x1 bits of states 0 and 2 are equal, and
    those of 1 and 3; PR: the four states of each predecessor group pick
    four distinct symbols)."""
    rng = np.random.default_rng(seed)
    n_s = 16 if pr else 4
    rows = steps if pr else steps // 4
    start = rng.integers(0, n_s, lanes).astype(np.int32)
    if kind == "real":
        lv = 2.0 * rng.integers(0, 8, (steps, lanes)) - 7.0 + (0.0 if pr else float(_PILOT))
        obs = torch.tensor((lv + 0.5 * rng.standard_normal((steps, lanes))).astype(np.float32))
        m = torch.full((n_s, lanes), 1e9)
        m[0] = 0.0
        if pr:
            dec, m = vk.pr_acs_forward_plain(obs, torch.tensor(vk._pr_rc_table()[:steps]), m)
        else:
            dec, m = vk.acs_forward_plain(obs, m)
        return dec.numpy(), torch.argmin(m, dim=0).to(torch.int32).numpy()
    if kind == "random":
        return rng.integers(-2 ** 31, 2 ** 31, (rows, lanes)).astype(np.int32), start
    u = np.arange(n_s)
    if pr:
        s2 = u >> 2
        group = ((2 * (s2 & 1)) | (s2 >> 1)) ^ (u & 1)
        picks = np.empty((rows, lanes, n_s), np.int64)
        for p in range(4):
            picks[..., group == p] = np.argsort(rng.random((rows, lanes, 4)), -1)
        words = (picks << (2 * u)).sum(-1)
    else:
        sel = rng.integers(0, 4, (steps, lanes, n_s))
        sel[..., 2] = (sel[..., 2] & 2) | (sel[..., 0] & 1)
        sel[..., 3] = (sel[..., 3] & 2) | (sel[..., 1] & 1)
        byte = (sel << (2 * u)).sum(-1)
        words = (byte.reshape(rows, 4, lanes) << (8 * np.arange(4))[None, :, None]).sum(1)
    return np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32), start


def test_tb_design_constants_and_map_tables():
    """A block is kTbLanes lanes (one warp a chunk) times at most kTbChunks
    (4-state) or kPrTbChunks (PR) chunks, within 1024 threads; the 4-state map's identity (0xE4) and
    predecessor table (0xD8, x1 flipping bit 2s) and the PR map's identity,
    as the source writes them, are the trellis' own."""
    src = _source("viterbi_acs.cu")
    assert TB_LANES == 32 and TB_LANES * max(TB_CHUNKS, PR_TB_CHUNKS) <= 1024
    ident4 = int(re.search(r"Map kIdentity = (0x[0-9A-F]+)u;", src).group(1), 16)
    ident16 = int(re.search(r"Map kIdentity = (0x[0-9A-F]+)ull;", src).group(1), 16)
    table4 = int(re.search(r"const uint32_t t = (0x[0-9A-F]+)u \^", src).group(1), 16)
    assert [(ident4 >> (2 * e)) & 3 for e in range(4)] == list(range(4))
    assert [(ident16 >> (4 * e)) & 15 for e in range(16)] == list(range(16))
    for byte in range(256):
        t = table4 ^ (byte & 0x55)
        for s in range(4):
            sel = (byte >> (2 * s)) & 3
            assert (t >> (2 * s)) & 3 == ((s & 1) << 1) | ((s >> 1) ^ (sel & 1))


@pytest.mark.parametrize("lanes,steps", [(1, 24), (12, 48), (13, 24 * 37), (60, 24 * 40)])
@pytest.mark.parametrize("kind", ["real", "random", "unmerged"])
@pytest.mark.parametrize("pr", [False, True], ids=["tb4", "pr"])
def test_tb_chunked_model_equals_plain(pr, kind, lanes, steps):
    """One and two groups (fewer than the chunks), 37 and 40 groups (cut
    into ragged chunks), one lane, one channel, 13 lanes and five
    channels: the emulated chunked traceback equals traceback_plain /
    pr_traceback_plain bit for bit on forward-pass, random and
    never-merging decisions. Real decisions merge (some head is shorter
    than its chunk); never-merging ones leave every head its whole chunk."""
    dec, start = _tb_decisions(pr, kind, steps, lanes, seed=steps + lanes)
    bits, heads, sizes = _emulate_tb(dec, start, pr)
    plain = vk.pr_traceback_plain if pr else vk.traceback_plain
    want = plain(torch.tensor(dec), torch.tensor(start)).numpy()
    np.testing.assert_array_equal(bits, want)
    assert (heads[-1] == 0).all()                      # the top chunk walks one chain
    inner = heads[:-1]
    if kind == "unmerged":
        assert (inner == sizes[:-1, None]).all()
    elif kind == "real" and steps >= 24 * 37:
        assert (inner < sizes[:-1, None]).any()


def _ab_tool():
    """tools/torch_kernel_ab.py as a module (tools/ is not a package)."""
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "tools", "torch_kernel_ab.py")
    spec = importlib.util.spec_from_file_location("torch_kernel_ab", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("pr", [False, True], ids=["tb4", "pr"])
def test_tb_tool_heads_and_unmerged_words(pr):
    """tools/torch_kernel_ab.py's head lengths (plain torch, what the card
    runs report) equal the model's on forward-pass decisions, 37 groups in
    16 ragged chunks; its never-merging words leave every head its whole
    chunk, and the model equals the plain twin on them."""
    ab = _ab_tool()
    dec, start = _tb_decisions(pr, "real", 24 * 37, 13, seed=5)
    _, heads, sizes = _emulate_tb(dec, start, pr)
    got, got_sizes = ab.tb_heads(torch.tensor(dec), pr)
    np.testing.assert_array_equal(got.numpy(), heads[:-1])
    np.testing.assert_array_equal(got_sizes.numpy(), sizes[:-1])
    words = ab.unmerged_words(pr, dec.shape[0], 13, torch.Generator().manual_seed(3),
                              torch.device("cpu"))
    bits, heads, sizes = _emulate_tb(words.numpy(), start, pr)
    assert (heads[:-1] == sizes[:-1, None]).all()
    plain = vk.pr_traceback_plain if pr else vk.traceback_plain
    np.testing.assert_array_equal(bits, plain(words, torch.tensor(start)).numpy())


# -- the chunked 4-state passes ----------------------------------------------

CHUNK4_THREADS = _constant("viterbi_acs.cu", "kChunk4Threads")
ACS_CHUNK_WORDS = _constant("viterbi_acs.cu", "kAcsChunkWords")
TB_CHUNK_WORDS = _constant("viterbi_acs.cu", "kTbChunkWords")
CHUNK_T = 600                    # 24 x 25 steps: W = 600 / C + 256 <= T for C >= 2
# W mod 4 = 0, 3, 2, 1 (every front padding) at T = CHUNK_T
CHUNK_COUNTS = (2, 8, 12, 24)


def _chunk_lanes(n_chunks: int, lanes: int):
    """The chunk-lanes of the launch: every (block, thread) of the grid of
    kChunk4Threads-thread blocks, lc = block * threads + thread, those past
    C L returning at once; (c, l) of the others."""
    n = n_chunks * lanes
    lc = np.arange(-(-n // CHUNK4_THREADS) * CHUNK4_THREADS)
    lc = lc[lc < n]
    return lc, lc // lanes, lc % lanes


def _acs4_step(o: np.ndarray, m: list):
    """acs4_step on every chunk-lane in float32, one rounding per
    operation: the decision byte assembled from the x1 mask and the Z2
    masks by x1, as the kernel does, and the metrics renormalized."""
    d = []
    for v in range(8):
        t = o - (np.float32(2 * v - 7) + _PILOT)
        d.append(t * t)
    p, z = [], [np.zeros(o.shape, np.uint32), np.zeros(o.shape, np.uint32)]
    for j in range(4):
        p.append(np.minimum(d[j], d[j + 4]))
        z[j >> 1] |= np.where(d[j + 4] < d[j], np.uint32(0x88 if j & 1 else 0x22), np.uint32(0))
    nm, x = [], np.zeros(o.shape, np.uint32)
    for s in range(4):
        a, b = s >> 1, s & 1
        c0, c1 = m[2 * b + a] + p[b], m[2 * b + 1 - a] + p[2 + b]
        x |= np.where(c1 < c0, np.uint32(1 << (2 * s)), np.uint32(0))
        nm.append(np.minimum(c0, c1))
    mn = np.minimum(np.minimum(nm[0], nm[1]), np.minimum(nm[2], nm[3]))
    m[:] = [v - mn for v in nm]
    x2 = x << np.uint32(1)
    return x | (x2 & z[1]) | (~x2 & z[0])


def _emulate_acs_chunked(obs: np.ndarray, m_in: np.ndarray, n_chunks: int, inv=None):
    """acs_forward_chunked_kernel, every thread at once: the peeled front
    word with its pad inert steps, the whole groups of kAcsChunkWords
    words read from registers filled one group ahead (the row pointer
    advanced a row a load), the last words one at a time. Returns
    (decisions (ceil(W/4), C L) int32, metrics (4, C L))."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    steps, lanes = obs.shape
    _, w, starts, _ = _chunk_plan(steps, n_chunks, vk.WARMUP)
    lc, c, l = _chunk_lanes(n_chunks, lanes)
    pad, words = -w % 4, -(-w // 4)
    row = starts[c].copy()                             # the next row of each thread
    m = [m_in[s, lc].astype(np.float32) for s in range(4)]
    dec = np.zeros((words, n_chunks * lanes), np.uint32)

    def load():
        nonlocal row
        o = obs[row, l]
        row = row + 1
        return o

    def step(o):
        return _acs4_step(o if inv is None else o.astype(np.float32) * np.float32(inv), m)

    word = np.zeros(lc.shape, np.uint32)
    for k in range(pad, 4):
        word |= step(load()) << np.uint32(8 * k)
    dec[0, lc] = word
    out = 1
    groups = (words - 1) // ACS_CHUNK_WORDS
    size = 4 * ACS_CHUNK_WORDS
    cur = [load() for _ in range(size)] if groups else None
    for g in range(groups):
        nxt = [load() for _ in range(size)] if g + 1 < groups else cur
        for j in range(ACS_CHUNK_WORDS):
            word = np.zeros(lc.shape, np.uint32)
            for k in range(4):
                word |= step(cur[4 * j + k]) << np.uint32(8 * k)
            dec[out, lc] = word
            out += 1
        cur = nxt
    for _ in range(1 + groups * ACS_CHUNK_WORDS, words):
        word = np.zeros(lc.shape, np.uint32)
        for k in range(4):
            word |= step(load()) << np.uint32(8 * k)
        dec[out, lc] = word
        out += 1
    assert out == words and (row == starts[c] + w).all()   # every window row read once
    m_out = np.zeros((4, n_chunks * lanes), np.float32)
    for s in range(4):
        m_out[s, lc] = m[s]
    return dec.view(np.int32), m_out




@pytest.mark.parametrize("lanes", [1, 12, 13])
@pytest.mark.parametrize("n_chunks", CHUNK_COUNTS)
def test_acs_chunked_model_equals_plain(n_chunks, lanes):
    """T=600 in C = 2, 8, 12, 24 windows (every front padding, 0-3 inert
    steps; the last words outside the whole groups), one lane, one
    channel and 13 lanes (a warp of chunk-lanes from several chunks): the
    emulated kernel's decisions and final metrics equal
    acs_forward_chunked_plain bit for bit on float32 levels and int8
    codes, chunk 0 from a cold start."""
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV, quantize_soft_levels

    rng = np.random.default_rng(n_chunks * 100 + lanes)
    lv = 2.0 * rng.integers(0, 8, (CHUNK_T, lanes)) - 7.0 + float(_PILOT)
    obs = torch.tensor((lv + 0.5 * rng.standard_normal(lv.shape)).astype(np.float32))
    m_in = torch.zeros((4, n_chunks * lanes))
    m_in[1:, :lanes] = 1e9
    for x, inv in ((obs, None), (quantize_soft_levels(obs), SOFT_LEVEL_INV)):
        dec, m_out = _emulate_acs_chunked(x.numpy(), m_in.numpy(), n_chunks, inv)
        want_dec, want_m = vk.acs_forward_chunked_plain(x, m_in, n_chunks, inv)
        np.testing.assert_array_equal(dec, want_dec.numpy())
        np.testing.assert_array_equal(m_out.view(np.int32), want_m.numpy().view(np.int32))


def _chain4x(w: np.ndarray, u: np.ndarray):
    """chain4x on every lane: (the output word, the doubled state before
    the word)."""
    v = (w & np.uint32(0x55555555)) ^ np.uint32(0xD8D8D8D8)
    word = np.zeros(w.shape, np.uint32)
    for k in range(3, -1, -1):
        vk_ = v >> np.uint32(8 * k - 1) if k else v << np.uint32(1)
        word += (((w >> np.uint32(8 * k)) >> u) & np.uint32(3)) << np.uint32(8 * k)
        u = (vk_ >> u) & np.uint32(6)
    return word, u


def _emulate_tb_chunked(dec: np.ndarray, start: np.ndarray, steps: int, n_chunks: int):
    """traceback_chunked_kernel, chunk by chunk, every lane of a chunk at
    once: the partial word at the window's top step by step, the whole
    words from decision words funnel-shifted by 8 (base mod 4) out of a
    ring of kTbChunkWords registers refilled kTbChunkWords words ahead,
    the partial word at the kept region's bottom. Counts every write of
    every output byte, whole-word stores apart, and checks each byte is
    written once and whole words only inside a kept region. Returns bits
    (T/4, L) int32."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    length, w, starts, _ = _chunk_plan(steps, n_chunks, vk.WARMUP)
    lanes = dec.shape[1] // n_chunks
    dec = dec.view(np.uint32)
    out = np.zeros((steps // 4, lanes), np.uint32)
    writes = np.zeros((steps, lanes), np.int64)
    pad, g_n = -w % 4, TB_CHUNK_WORDS
    for c in range(n_chunks):
        col = dec[:, c * lanes:(c + 1) * lanes]
        t0, t1, row0 = c * length, (c + 1) * length, int(starts[c])
        base = pad - row0
        e, r = base >> 2, base & 3
        u = 2 * start[c * lanes:(c + 1) * lanes].astype(np.uint32)

        def emit(j, word, whole):
            lo, hi = max(4 * j, t0), min(4 * j + 3, t1 - 1)
            if whole:
                assert hi - lo == 3 and 4 * j >= t0 and 4 * j + 3 < t1
            for t in range(lo, hi + 1):
                b = np.uint32(8 * (t & 3))
                out[j] = (out[j] & ~(np.uint32(0xFF) << b)) | (((word >> b) & 0xFF) << b)
                writes[t] += 1

        def partial(hi_t, lo_t):
            nonlocal u
            word = np.zeros(lanes, np.uint32)
            for t in range(hi_t, lo_t - 1, -1):
                q = t + base
                byte = (col[q >> 2] >> np.uint32(8 * (q & 3))) & np.uint32(0xFF)
                word |= ((byte >> u) & np.uint32(3)) << np.uint32(8 * (t & 3))
                u = (((((byte & 0x55) ^ 0xD8) << 1).astype(np.uint32)) >> u) & np.uint32(6)
            return word

        t = row0 + w - 1
        if t & 3 != 3:
            lo = max(t & ~3, t0)
            emit(t >> 2, partial(t, lo), False)
            t = lo - 1
        jhi, jlo = (t + 1) // 4 - 1, (t0 + 3) >> 2
        if t >= t0 and jhi >= jlo:
            hi_w = col[jhi + e + 1] if r else np.zeros(lanes, np.uint32)
            buf = [col[jhi - g + e] if jhi - g >= jlo else None for g in range(g_n)]
            nxt = jhi + e - g_n
            for j0 in range(jhi, jlo - 1, -g_n):
                for g in range(g_n):
                    j = j0 - g
                    if j < jlo:
                        break
                    lo_w = buf[g]
                    assert lo_w is not None and (lo_w == col[j + e]).all()
                    if j - g_n >= jlo:
                        buf[g] = col[nxt]
                    nxt -= 1
                    a = ((hi_w.astype(np.uint64) << np.uint64(32)) | lo_w) >> np.uint64(8 * r)
                    word, u = _chain4x((a & 0xFFFFFFFF).astype(np.uint32), u)
                    hi_w = lo_w
                    emit(j, word, j < t1 >> 2)
            t = 4 * jlo - 1
        if t >= t0:
            emit(t >> 2, partial(t, t0), False)
    assert (writes == 1).all()
    return out.view(np.int32)


@pytest.mark.parametrize("kind", ["real", "random", "unmerged"])
@pytest.mark.parametrize("lanes", [1, 12, 13])
@pytest.mark.parametrize("n_chunks", CHUNK_COUNTS)
def test_tb_chunked4_model_equals_plain(n_chunks, lanes, kind):
    """T=600 in C = 2, 8, 12, 24 windows (every front padding; kept
    regions of 300, 75, 50 and 25 steps, so boundary words shared by two
    chunks at C = 8 and 24), 1, 12 and 13 lanes: the emulated chunked
    traceback writes every output byte once and equals
    traceback_chunked_plain bit for bit on the forward pass's decisions,
    random words and words on which no two chains ever merge."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    w = _chunk_plan(CHUNK_T, n_chunks, vk.WARMUP)[1]
    rows, n = -(-w // 4), n_chunks * lanes
    seed = n_chunks * 100 + lanes
    if kind == "real":
        rng = np.random.default_rng(seed)
        lv = 2.0 * rng.integers(0, 8, (CHUNK_T, lanes)) - 7.0 + float(_PILOT)
        obs = torch.tensor((lv + 0.5 * rng.standard_normal(lv.shape)).astype(np.float32))
        m_in = torch.zeros((4, n))
        m_in[1:, :lanes] = 1e9
        d, m_out = vk.acs_forward_chunked_plain(obs, m_in, n_chunks)
        dec, start = d.numpy(), torch.argmin(m_out, dim=0).to(torch.int32).numpy()
    else:
        dec, start = _tb_decisions(False, kind, 4 * rows, n, seed)
    bits = _emulate_tb_chunked(dec, start, CHUNK_T, n_chunks)
    want = vk.traceback_chunked_plain(torch.tensor(dec), torch.tensor(start), CHUNK_T, n_chunks)
    np.testing.assert_array_equal(bits, want.numpy())


# -- the chunked PR passes -----------------------------------------------------

PR_LANE_THREADS = _constant("viterbi_acs.cu", "kPrLaneThreads")
PR_GROUP_STEPS = _constant("viterbi_acs.cu", "kPrGroupSteps")
PR_TB_AHEAD = _constant("viterbi_acs.cu", "kPrTbAhead")
CHUNK_THREADS = _constant("viterbi_acs.cu", "kChunkThreads")
PR_SPLIT = tuple(int(x) for x in re.search(                 # kPrSplit4, kPrSplit2
    r"constexpr int64_t kPrSplit4 = (\d+), kPrSplit2 = (\d+);", _source("viterbi_acs.cu")).groups())
_F32 = np.float32


def _pr_lane_threads(n: int) -> int:
    """pr_lane_threads: threads a chunk-lane for n chunk-lanes."""
    if PR_LANE_THREADS > 0:
        return PR_LANE_THREADS
    return 4 if n <= PR_SPLIT[0] else 2 if n <= PR_SPLIT[1] else 1


def _pr_level(b, h):
    """E_b[h] = 4h + 2b - 7 (b, h arrays or ints), float32."""
    return (4 * np.asarray(h) + 2 * np.asarray(b) - 7).astype(_F32)


def _pr_group(a, x0, x1, e0, e1, bits):
    """pr_group on every thread (arrays (4, N) by h' or h, float32): the new
    metrics of the group and bits with the group's 8 decision bits shifted
    in, from the sign bits of three float32 differences a state."""
    n = np.empty(a.shape, _F32)
    for h1 in range(3, -1, -1):
        x, e = (x1, e1) if h1 & 1 else (x0, e0)
        tt = a[h1] + e
        c = x + tt * tt
        m01, m23 = np.minimum(c[0], c[1]), np.minimum(c[2], c[3])
        d01, d23 = (c[1] - c[0]).view(np.uint32), (c[3] - c[2]).view(np.uint32)
        dp = (m23 - m01).view(np.uint32)
        n[h1] = np.minimum(m01, m23)
        bits = (bits << np.uint32(1)) | (dp >> np.uint32(31))
        bits = (bits << np.uint32(1)) | (((dp & d23) | (~dp & d01)) >> np.uint32(31))
    return n, bits


def _emulate_pr_chunked(obs: np.ndarray, rc: np.ndarray, m_in: np.ndarray, n_chunks: int,
                        threads: int | None = None):
    """pr_acs_forward_chunked_kernel<T>, every thread of the launch at once (T
    = threads, else pr_lane_threads): thread tid runs chunk-lane tid / T,
    warps past the last chunk-lane return, the others run along; groups of
    kPrGroupSteps T steps read from rows loaded a group ahead; a warp takes
    the no-reset path unless one of its threads has a reset step in the
    group; the state split with its shuffle sources (T = 2: the kept group
    and the sent one by xor 1; T = 4: each thread's two predecessor groups
    from quad lanes src0 / src1, the minimum by xor 1 and 2); the decision
    word's owner stores it. Returns (decisions (W, C L) int32, metrics (16,
    C L), the no-reset and reset groups run by warps)."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    steps, lanes = obs.shape
    _, w, starts, _ = _chunk_plan(steps, n_chunks, vk.WARMUP)
    n = n_chunks * lanes
    t = threads or _pr_lane_threads(n)
    g_steps = PR_GROUP_STEPS * t
    tid = np.arange(-(-n * t // CHUNK_THREADS) * CHUNK_THREADS)
    tid = tid[(tid - tid % 32) // t < n]                 # whole warps past the end return
    q, valid = tid % t, tid // t < n
    lc = np.minimum(tid // t, n - 1)
    c, l = lc // lanes, lc % lanes
    row = starts[c].copy()                               # each thread's next row
    warp = (tid - tid[0]) // 32
    dec = np.zeros((w, n), np.int64)
    stores = np.zeros((w, n), np.int64)
    e = [_pr_level(0, np.arange(4)[:, None]), _pr_level(1, np.arange(4)[:, None])]

    def shuffle(v, src):                                  # v (..., N) from thread src
        assert ((src - src % 32) == (tid - tid % 32)).all()   # inside the warp
        return v[..., src - tid[0]]

    def held(groups):                                     # m_in's groups (N,) -> (4, N)
        return np.stack([m_in[4 * groups + h, lc] for h in range(4)]).astype(_F32)

    hs = np.arange(4)[:, None]
    m = k = r = x0 = x1 = last = None
    if t == 1:                                            # m[s2]: group s2
        m = np.stack([held(np.full(tid.shape, s2)) for s2 in range(4)])
    elif t == 2:                                          # K = group 3b, R = group 1 + b
        k, r = held(3 * q), held(1 + q)
        lv = [_pr_level(q, hs), _pr_level(1 - q, hs)]
    else:                                                 # quad lane q = 2p + j
        p, j = q >> 1, q & 1
        src0 = tid - q + np.where(j == 1, 3 - 2 * p, 2 * p)
        src1 = tid - q + np.where(j == 1, 2 * p, 3 - 2 * p)
        g = np.where(j == 1, 2 - p, 3 * p)
        x0, x1 = held(np.where(j == 1, 1 + p, 3 * p)), held(np.where(j == 1, 3 * p, 1 + p))
        lv, f0, f1 = _pr_level(p, hs), _pr_level(p ^ j, hs), _pr_level(1 - (p ^ j), hs)

    def refs(lvl, rst, sync):                             # pr_refs
        return np.where(rst, sync, lvl).astype(_F32)

    def step(o, rst, sync):
        nonlocal m, k, r, x0, x1, last
        zero = np.zeros(tid.shape, np.uint32)
        if t == 1:
            a = [o - e[0], o - e[1]]
            pe = [refs(e[0], rst, sync), refs(e[1], rst, sync)]
            nm, word = [None] * 4, zero
            for s2 in range(3, -1, -1):
                sp = int(_pred0(s2))
                nm[s2], word = _pr_group(a[s2 & 1], m[sp], m[sp ^ 1], pe[sp & 1],
                                         pe[(sp & 1) ^ 1], word)
            mn = np.min(np.stack(nm), axis=(0, 1))
            m = np.stack(nm) - mn
            return word
        if t == 2:
            pe = [refs(lv[0], rst, sync), refs(lv[1], rst, sync)]
            a = o - lv[0]
            kept, bk = _pr_group(a, k, r, pe[0], pe[1], zero)
            sent, bs = _pr_group(a, r, k, pe[1], pe[0], zero)
            half = np.minimum(kept.min(0), sent.min(0))
            mn = np.minimum(half, shuffle(half, tid ^ 1))
            r, k = shuffle(sent, tid ^ 1) - mn, kept - mn
            part = np.where(q == 0, bk | (bs << np.uint32(16)),          # __byte_perm
                            (bk << np.uint32(24)) | (bs << np.uint32(8)))
            return part | shuffle(part, tid ^ 1)
        pe = [refs(f0, rst, sync), refs(f1, rst, sync)]
        own, bits = _pr_group(o - lv, x0, x1, pe[0], pe[1], zero)   # own: group g
        mm = own.min(0)
        mm = np.minimum(mm, shuffle(mm, tid ^ 1))
        mn = np.minimum(mm, shuffle(mm, tid ^ 2))
        x0, x1 = shuffle(own, src0) - mn, shuffle(own, src1) - mn
        last = own - mn                                   # group g, renormalized
        part = bits << (8 * g).astype(np.uint32)
        part |= shuffle(part, tid ^ 1)
        return part | shuffle(part, tid ^ 2)

    def load():
        nonlocal row
        o, rr = obs[row, l], rc[row, l % 12]
        row = row + 1
        return o.astype(_F32), rr

    def put(pstep, word):                                 # the owner of step pstep stores
        mine = valid & (pstep % t == q)
        dec[pstep, lc[mine]] = word[mine]
        stores[pstep, lc[mine]] += 1

    groups, runs = w // g_steps, [0, 0]
    cur = [load() for _ in range(g_steps)] if groups else []
    for gi in range(groups):
        nxt = [load() for _ in range(g_steps)] if gi + 1 < groups else cur
        rst_any = np.zeros(tid.shape, bool)
        for _, rr in cur:
            rst_any |= (rr & 1) == 1
        slow = np.zeros(warp.max() + 1, bool)
        np.logical_or.at(slow, warp, rst_any)                # __any_sync
        slow = slow[warp]
        runs[0] += int((~slow[::32]).sum())
        runs[1] += int(slow[::32].sum())
        for i, (o, rr) in enumerate(cur):
            rst = slow & ((rr & 1) == 1)                      # the no-reset path selects nothing
            sync = np.where((rr >> 1) == 1, _F32(5), _F32(-5))
            put(gi * g_steps + i, step(o, rst, sync))
        cur = nxt
    for pstep in range(groups * g_steps, w):                # the last W mod G steps
        o, rr = load()
        put(pstep, step(o, (rr & 1) == 1, np.where((rr >> 1) == 1, _F32(5), _F32(-5))))
    assert (row == starts[c] + w).all() and (stores == 1).all()
    m_out = np.zeros((16, n), _F32)
    held_out = ([(np.full(tid.shape, s2), m[s2]) for s2 in range(4)] if t == 1 else
                [(3 * q, k), (1 + q, r)] if t == 2 else [(g, last)])
    for groups_, v in held_out:
        for h in range(4):
            m_out[4 * groups_[valid] + h, lc[valid]] = v[h, valid]
    dec = np.where(dec >= 1 << 31, dec - (1 << 32), dec).astype(np.int32)
    return dec, m_out, runs


@functools.lru_cache(maxsize=None)
def _pr_chunk_case(n_chunks: int, lanes: int):
    """(obs, rc, m_in, decisions, final metrics) of pr_acs_forward_chunked_plain
    on the comb (one encoder step back) of noisy 8-level symbols over CHUNK_T
    steps with the field's first CHUNK_T rc rows (reset steps at 0, 69 and
    138 mod 207, so in every window), chunk 0 from a cold start."""
    rng = np.random.default_rng(n_chunks * 100 + lanes)
    lev = 2.0 * rng.integers(0, 8, (CHUNK_T + 1, lanes)) - 7.0
    lev = lev + 0.5 * rng.standard_normal(lev.shape)
    obs = (lev[1:] - lev[:-1]).astype(np.float32)
    rc = np.ascontiguousarray(vk._pr_rc_table()[:CHUNK_T])
    m_in = np.zeros((16, n_chunks * lanes), np.float32)
    m_in[1:, :lanes] = 1e9
    dec, m_out = vk.pr_acs_forward_chunked_plain(torch.tensor(obs), torch.tensor(rc),
                                                 torch.tensor(m_in), n_chunks)
    return obs, rc, m_in, dec.numpy(), m_out.numpy()


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("lanes", [1, 12, 13])
@pytest.mark.parametrize("n_chunks", CHUNK_COUNTS)
def test_pr_chunked_model_equals_plain(n_chunks, lanes, threads):
    """T=600 in C = 2, 8, 12, 24 windows (every W mod 4 and start(c) mod 4)
    with reset steps inside every window, 1, 12 and 13 lanes, 1, 2 and 4
    threads a chunk-lane: the emulated kernel's decisions and final metrics
    equal pr_acs_forward_chunked_plain bit for bit, with warps on both the
    no-reset and the reset path."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    obs, rc, m_in, want_dec, want_m = _pr_chunk_case(n_chunks, lanes)
    _, w, starts, _ = _chunk_plan(CHUNK_T, n_chunks, vk.WARMUP)
    assert all(((rc[s:s + w] & 1) == 1).any(0).all() for s in starts)
    dec, m_out, runs = _emulate_pr_chunked(obs, rc, m_in, n_chunks, threads)
    np.testing.assert_array_equal(dec, want_dec)
    np.testing.assert_array_equal(m_out.view(np.int32), want_m.view(np.int32))
    assert runs[0] > 0 and runs[1] > 0


def _pr_pred_table() -> int:
    """pr_pred_table: pred0(s >> 2) ^ (s & 1) at bits 2s."""
    return sum(int(_pred0(s >> 2) ^ (s & 1)) << (2 * s) for s in range(16))


def _pr_back(w: np.ndarray, u: np.ndarray) -> np.ndarray:
    """pr_back on every lane: the doubled state before a step."""
    tab = np.uint32(_pr_pred_table())
    three = np.uint32(3)
    return (((tab >> u) & three) << np.uint32(3)) | (((w >> u) & three) << np.uint32(1))


def _emulate_pr_tb_chunked(dec: np.ndarray, start: np.ndarray, steps: int, n_chunks: int):
    """pr_traceback_chunked_kernel, chunk by chunk, every lane of a chunk at
    once: the partial word at the window's top step by step, the whole
    words each a 4-step chain over the rows a ring of kPrTbAhead / 4 words
    copied ahead holds (word j in slot j mod the ring, refilled with word j
    minus the ring once word j is read), the partial word at the kept
    region's bottom; stream step t is decision row t - start(c). Counts
    every write of every output byte and checks each is written once and
    whole words only inside a kept region. Returns bits (T/4, L) int32."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    length, w, starts, _ = _chunk_plan(steps, n_chunks, vk.WARMUP)
    lanes = dec.shape[1] // n_chunks
    dec = dec.view(np.uint32)
    out = np.zeros((steps // 4, lanes), np.uint32)
    writes = np.zeros((steps, lanes), np.int64)
    gw = PR_TB_AHEAD // 4
    for c in range(n_chunks):
        col = dec[:, c * lanes:(c + 1) * lanes]
        t0, t1, row0 = c * length, (c + 1) * length, int(starts[c])
        u = 2 * start[c * lanes:(c + 1) * lanes].astype(np.uint32)

        def emit(j, word, whole):
            lo, hi = max(4 * j, t0), min(4 * j + 3, t1 - 1)
            if whole:
                assert hi - lo == 3 and 4 * j >= t0 and 4 * j + 3 < t1
            for t in range(lo, hi + 1):
                b = np.uint32(8 * (t & 3))
                out[j] = (out[j] & ~(np.uint32(0xFF) << b)) | (((word >> b) & 0xFF) << b)
                writes[t] += 1

        def partial(hi_t, lo_t):
            nonlocal u
            word = np.zeros(lanes, np.uint32)
            for t in range(hi_t, lo_t - 1, -1):
                word |= ((u >> np.uint32(1)) & np.uint32(3)) << np.uint32(8 * (t & 3))
                u = _pr_back(col[t - row0], u)
            return word

        t = row0 + w - 1
        if t & 3 != 3:
            lo = max(t & ~3, t0)
            emit(t >> 2, partial(t, lo), False)
            t = lo - 1
        jhi, jlo = (t + 1) // 4 - 1, (t0 + 3) >> 2
        if t >= t0 and jhi >= jlo:
            ring = [None] * gw                           # (word, its 4 rows) a slot

            def fetch(j):
                if j >= jlo:
                    ring[j % gw] = (j, [col[4 * j + k - row0] for k in range(4)])

            for i in range(gw):
                fetch(jhi - i)
            for j in range(jhi, jlo - 1, -1):
                held_j, rows = ring[j % gw]
                assert held_j == j                        # the slot holds word j
                v = []
                for k in range(3, -1, -1):
                    v.append(u)
                    u = _pr_back(rows[k], u)
                word = np.zeros(lanes, np.uint32)
                for k, uk in zip(range(3, -1, -1), v):
                    word |= ((uk >> np.uint32(1)) & np.uint32(3)) << np.uint32(8 * k)
                fetch(j - gw)
                emit(j, word, j < t1 >> 2)
            t = 4 * jlo - 1
        if t >= t0:
            emit(t >> 2, partial(t, t0), False)
    assert (writes == 1).all()
    return out.view(np.int32)


@pytest.mark.parametrize("kind", ["real", "random", "unmerged"])
@pytest.mark.parametrize("lanes", [1, 12, 13])
@pytest.mark.parametrize("n_chunks", CHUNK_COUNTS)
def test_pr_tb_chunked_model_equals_plain(n_chunks, lanes, kind):
    """T=600 in C = 2, 8, 12, 24 windows (start(c) of every residue mod 4;
    kept regions of 300, 75, 50 and 25 steps, so boundary words shared by
    two chunks at C = 8 and 24), 1, 12 and 13 lanes: the emulated word-wise
    traceback writes every output byte once and equals
    pr_traceback_chunked_plain bit for bit on the forward pass's decisions,
    random words and words on which no two chains ever merge."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    w = _chunk_plan(CHUNK_T, n_chunks, vk.WARMUP)[1]
    n = n_chunks * lanes
    if kind == "real":
        *_, dec, m_out = _pr_chunk_case(n_chunks, lanes)
        start = np.argmin(m_out, axis=0).astype(np.int32)
    else:
        dec, start = _tb_decisions(True, kind, w, n, n_chunks * 100 + lanes)
    bits = _emulate_pr_tb_chunked(dec, start, CHUNK_T, n_chunks)
    want = vk.pr_traceback_chunked_plain(torch.tensor(dec), torch.tensor(start), CHUNK_T,
                                         n_chunks)
    np.testing.assert_array_equal(bits, want.numpy())


def test_chunked_design_constants():
    """4-state: one warp a block; whole words a forward group; the
    traceback's words in flight fit the registers a thread has to spare.
    PR: whole warps a block; 1, 2 or 4 threads a chunk-lane (or chosen at
    launch: 4 up to kPrSplit4 chunk-lanes, B=1 and B=384 at C=2; 2 up to
    kPrSplit2, B=384 at C=8; 1 beyond, B=384 at C=24 and 92); a forward
    group of a few steps a thread; the traceback's ring of whole words in
    static shared memory; its predecessor table the trellis' own. T=600
    windows have every W mod 4."""
    from atsc_tpu_torch.ops.ntsc import _pr_tables
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    assert CHUNK4_THREADS == 32 and 1 <= ACS_CHUNK_WORDS <= 8 and 1 <= TB_CHUNK_WORDS <= 16
    assert CHUNK_THREADS % 32 == 0 and PR_LANE_THREADS in (0, 1, 2, 4)
    assert 1 <= PR_GROUP_STEPS <= 4 and PR_TB_AHEAD % 4 == 0
    assert PR_TB_AHEAD * CHUNK_THREADS * 4 <= 48 * 1024
    if PR_LANE_THREADS == 0:
        assert 0 < PR_SPLIT[0] < PR_SPLIT[1]
        assert [_pr_lane_threads(c * 12 * b) for b, c in ((1, 92), (384, 2), (384, 8), (384, 24))] \
            == [4, 4, 2, 1]
    pred = _pr_tables()[2][:, 0] // 4                     # predecessor group of each state
    assert [(_pr_pred_table() >> (2 * u)) & 3 for u in range(16)] == pred.tolist()
    assert sorted(-_chunk_plan(CHUNK_T, c, vk.WARMUP)[1] % 4 for c in CHUNK_COUNTS) == [0, 1, 2, 3]


def test_pr_chunked_state_split_and_shuffle_sources():
    """New group s2 reads predecessor groups pred0(s2) (x1 = 0) and
    pred0(s2) ^ 1 (x1 = 1). T = 2: thread b runs the kept group 3b from (K,
    R) = old groups (3b, 1 + b) and the sent group 2 - b from (R, K); it
    keeps the kept one, the next K, and its partner's sent one is its next
    R. T = 4: quad lane q = 2p + j runs group j ? 2 - p : 3p and fetches its
    (x1 = 0, x1 = 1) groups from quad lanes src0 and src1, the lanes that
    ran them."""
    for b in (0, 1):
        kept, sent, k, r = 3 * b, 2 - b, 3 * b, 1 + b
        assert (_pred0(kept), _pred0(kept) ^ 1) == (k, r)
        assert (_pred0(sent), _pred0(sent) ^ 1) == (r, k)
        assert 2 - (1 - b) == r and (kept & 1, sent & 1) == (b, b)   # one emitted parity
    runs = {2 * p + j: (2 - p if j else 3 * p) for p in (0, 1) for j in (0, 1)}
    assert sorted(runs.values()) == [0, 1, 2, 3]
    for q, g in runs.items():
        p, j = q >> 1, q & 1
        src0, src1 = (3 - 2 * p, 2 * p) if j else (2 * p, 3 - 2 * p)
        assert (runs[src0], runs[src1]) == (_pred0(g), _pred0(g) ^ 1)


# -- the fused trellis encoder: four bytes per instruction --------------------

def _tf_layout() -> dict:
    """csrc/trellis_fused.cu's constants, and the byte-permute selectors of
    its word totals and its 4 x 4 transpose, in source order."""
    src = _source("trellis_fused.cu")
    k = {n: _constant("trellis_fused.cu", n) for n in ("kRowBytes", "kLaneBytes", "kWarps")}
    k["kRowWords"] = k["kRowBytes"] // 4
    k["kRoundBytes"] = 32 * k["kLaneBytes"]
    k["kRounds"] = -(-k["kRowBytes"] // k["kRoundBytes"])
    k["kB0"] = int(re.search(r"constexpr uint32_t kB0 = (0x[0-9a-fA-F]+)u;", src).group(1), 16)
    k["sel"] = [int(x, 16) for x in re.findall(r", (0x[0-9a-fA-F]{4})\)", src)]
    return k


TF = _tf_layout()
_U = np.uint32


def _tf_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """__byte_perm(x, y, sel): byte n of the result is byte (sel >> 4n) & 7
    of the 8 bytes x, y (x first)."""
    b = [(x >> _U(8 * i)) & _U(0xFF) for i in range(4)] + \
        [(y >> _U(8 * i)) & _U(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for n in range(4):
        out |= b[(sel >> (4 * n)) & 7] << _U(8 * n)
    return out


def _tf_prefix(x: np.ndarray) -> np.ndarray:
    y = x ^ (x << _U(8))
    return y ^ (y << _U(16))


def _tf_bcast(x: np.ndarray, s: int) -> np.ndarray:
    return _tf_perm(x, _U(0), 0x1111 * s)


def _tf_planes(w: np.ndarray, pe: np.ndarray) -> list:
    """planes4: byte i of plane p is symbol p of byte i of w, given pe."""
    b0 = _U(TF["kB0"])
    v = pe ^ (pe >> _U(4))
    g = v ^ (w >> _U(4))
    x0 = (v << _U(1)) ^ (v >> _U(1)) ^ (w >> _U(5))
    x1 = x0 ^ (w >> _U(3))
    x2 = x1 ^ (w >> _U(1))
    x3 = x2 ^ (w << _U(1))
    return [(x0 & 4 * b0) | ((w >> _U(5)) & 2 * b0) | (v & b0),
            (x1 & 4 * b0) | ((w >> _U(3)) & 2 * b0) | ((g >> _U(2)) & b0),
            (x2 & 4 * b0) | ((w >> _U(1)) & 2 * b0) | (g & b0),
            (x3 & 4 * b0) | ((w << _U(1)) & 2 * b0) | (((g ^ w) >> _U(2)) & b0)]


def _tf_scan(x: np.ndarray) -> np.ndarray:
    """warp_scan over the last axis (32 lanes): __shfl_up_sync(x, o) gives
    lane l lane l - o's x (its own below o), and lanes >= o XOR it in."""
    x = x.copy()
    for o in (1, 2, 4, 8, 16):
        y = np.concatenate([x[..., :o], x[..., :-o]], axis=-1)
        x[..., o:] ^= y[..., o:]
    return x


def _tf_words(r: int, interleaved: bool) -> tuple[np.ndarray, np.ndarray]:
    """(4, 32) row word index of word s of lane l in round r, and whether it
    is live (inside the row): interleaved 128 r + 32 s + l, plane-major
    128 r + 4 l + s (the lane's 16 bytes)."""
    s, lane = np.arange(4)[:, None], np.arange(32)[None, :]
    idx = 128 * r + (32 * s + lane if interleaved else 4 * lane + s)
    live = np.broadcast_to(128 * r + (32 * s if interleaved else 4 * lane) < TF["kRowWords"],
                           idx.shape)
    return idx, live


def _tf_carry_bytes(d, d1, d2) -> np.ndarray:
    return ((d & 1) << 1 | (d2 & 1) << 2 | (d1 & 1)).astype(np.uint32) * _U(TF["kB0"])


def _tf_round(w: np.ndarray, cb: np.ndarray, interleaved: bool):
    """encode_round on every row at once: w (R, 4, 32) the lanes' words, cb
    (R,) the rows' running carry bytes. Returns (planes (R, 4 s, 4 p, 32),
    base (R, 32), the moved cb)."""
    pre = _tf_prefix(w)
    sel = TF["sel"]
    t = _tf_perm(_tf_perm(pre[:, 0], pre[:, 1], sel[0]), _tf_perm(pre[:, 2], pre[:, 3], sel[1]),
                 sel[2])
    if interleaved:
        inc = _tf_scan(t)
        ti = _tf_prefix(inc[:, 31])
        base = inc ^ t ^ (ti << _U(8))[:, None] ^ cb[:, None]
        cb = cb ^ _tf_bcast(ti, 3)
    else:
        li = _tf_prefix(t)
        lt = _tf_bcast(li, 3)
        inc = _tf_scan(lt)
        base = inc ^ lt ^ (li << _U(8)) ^ cb[:, None]
        cb = cb ^ inc[:, 31]
    planes = np.stack([np.stack(_tf_planes(w[:, s], (pre[:, s] << _U(8)) ^ _tf_bcast(base, s)), 1)
                       for s in range(4)], 1)
    return planes, base, cb


def _tf_transpose(p: list) -> list:
    """The interleaved store's 4 x 4 byte transpose of planes p[0..3]."""
    sel = TF["sel"][3:]
    t0, t1 = _tf_perm(p[0], p[1], sel[0]), _tf_perm(p[0], p[1], sel[1])
    t2, t3 = _tf_perm(p[2], p[3], sel[2]), _tf_perm(p[2], p[3], sel[3])
    return [_tf_perm(t0, t2, sel[4]), _tf_perm(t0, t2, sel[5]), _tf_perm(t1, t3, sel[6]),
            _tf_perm(t1, t3, sel[7])]


def _tf_emulate(il: np.ndarray, d, d1, d2, interleaved: bool):
    """The kernel on rows il (R, kRowBytes) uint8 with carries (R,): the
    output (R, 4 kRowBytes) int8, the stores [(row offsets of the 32 lanes'
    16-byte stores (R, 32), live (32,)), ...] one per warp store instruction
    of a round, and the bases (R, rounds, 32) of every round."""
    rows = il.shape[0]
    words = il.reshape(rows, -1).view("<u4").astype(np.uint32)
    out = np.full((rows, 4 * TF["kRowBytes"]), 0xEE, np.uint8)     # never-written bytes show
    stores, bases = [], []
    cb = _tf_carry_bytes(d, d1, d2)
    row_off = (np.arange(rows) * 4 * TF["kRowBytes"])[:, None]
    for r in range(TF["kRounds"]):
        idx, live = _tf_words(r, interleaved)
        w = np.where(live[None], words[:, np.minimum(idx, TF["kRowWords"] - 1)], _U(0))
        planes, base, cb = _tf_round(w, cb, interleaved)
        bases.append(base)
        if interleaved:
            for s in range(4):
                vec = np.stack(_tf_transpose([planes[:, s, p] for p in range(4)]), -1)
                stores.append((16 * idx[s], live[s], vec))
        else:
            for p in range(4):
                stores.append((p * TF["kRowBytes"] + 4 * idx[0], live[0], planes[:, :, p]
                               .transpose(0, 2, 1)))
        for off, lv, vec in stores[-4:]:
            data = np.ascontiguousarray(vec, "<u4").view(np.uint8).reshape(rows, 32, 16)
            for lane in np.nonzero(lv)[0]:
                out[:, off[lane]:off[lane] + 16] = data[:, lane]
    out_flat = out.view(np.int8)
    return out_flat, [(row_off + off[None], lv) for off, lv, _ in stores], np.stack(bases, 1)


def _tf_walk(rows: int, blocks: int) -> list:
    """The persistent grid's walk: warp gw of blocks x kWarps takes rows gw,
    gw + stride, ...; in a row's loop each round loads the next before it
    computes, and the last round, peeled, loads the next row's first.
    Returns every warp's computed (row, round) units, asserting each was the
    one loaded a step before."""
    stride = blocks * TF["kWarps"]
    walks = []
    for gw in range(min(stride, rows)):
        row = gw
        loads, done = [(row, 0)], []
        while True:
            nrow = row + stride
            for r in range(TF["kRounds"] - 1):
                loads.append((row, r + 1))
                done.append((row, r))
            if nrow < rows:
                loads.append((nrow, 0))
            done.append((row, TF["kRounds"] - 1))
            if nrow >= rows:
                break
            row = nrow
        assert loads == done
        walks.append(done)
    return walks


def _tf_inputs(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    il = rng.integers(0, 256, size=(rows, TF["kRowBytes"]), dtype=np.uint8)
    return il, *(rng.integers(0, 2, size=rows, dtype=np.int32) for _ in range(3))


def test_trellis_swar_constants_and_source_maps():
    """The kernel's constants against the wrapper's shapes, and the maps the
    model replays, parsed from the source: loads, stores, the scans, the
    carry byte and the plane formulas."""
    from atsc_tpu_torch.ops.cuda import trellis_fused as tfk

    src = _source("trellis_fused.cu")
    assert TF["kRowBytes"] == tfk.PAD_BYTES and 4 * TF["kRowBytes"] == tfk.PAD_SYMBOLS
    assert TF["kRowWords"] % 32 == 0 and TF["kRounds"] == 11 and TF["kLaneBytes"] == 16
    assert len(TF["sel"]) == 11
    for expr in ("q[s] = live_word<true>(r, s, lane) ? __ldg(w + 32 * s + lane) : 0u;",
                 "__ldg(reinterpret_cast<const uint4*>(w) + lane)",
                 "const uint32_t* w = reinterpret_cast<const uint32_t*>(src) + 128 * r;",
                 "return r + 1 < kRounds || (kInterleaved ? s < kLastSteps : lane < kLastLanes);",
                 "constexpr int kLastSteps = (kRowWords - 128 * (kRounds - 1)) / 32;",
                 "constexpr int kLastLanes = (kRowWords - 128 * (kRounds - 1)) / 4;",
                 "__stcs(reinterpret_cast<uint4*>(dst + 16 * (128 * r + 32 * s + lane)),",
                 "__stcs(reinterpret_cast<uint4*>(dst + p * kRowBytes + 4 * (128 * r + 4 * lane)),",
                 "make_uint4(pl[0][p], pl[1][p], pl[2][p], pl[3][p]));",
                 "return ((d[row] & 1) << 1 | (d2[row] & 1) << 2 | (d1[row] & 1)) * kB0;",
                 "const uint32_t y = x ^ (x << 8);",
                 "return __byte_perm(x, 0u, 0x1111u * s);",
                 "const uint32_t y = __shfl_up_sync(kFull, x, o);",
                 "if (lane >= o) x ^= y;",
                 "const uint32_t ti = prefix_bytes(__shfl_sync(kFull, inc, 31));",
                 "base = inc ^ t ^ (ti << 8) ^ cb;",
                 "cb ^= byte_bcast(ti, 3);",
                 "const uint32_t lt = byte_bcast(li, 3);",
                 "base = inc ^ lt ^ (li << 8) ^ cb;",
                 "cb ^= __shfl_sync(kFull, inc, 31);",
                 "planes4(w[s], (pre[s] << 8) ^ byte_bcast(base, s), pl[s]);",
                 "const uint32_t v = pe ^ (pe >> 4);",
                 "const uint32_t g = v ^ (w >> 4);",
                 "const uint32_t x0 = (v << 1) ^ (v >> 1) ^ (w >> 5);",
                 "const uint32_t x1 = x0 ^ (w >> 3);",
                 "const uint32_t x2 = x1 ^ (w >> 1);",
                 "const uint32_t x3 = x2 ^ (w << 1);",
                 "pl[0] = (x0 & 4 * kB0) | ((w >> 5) & 2 * kB0) | (v & kB0);",
                 "pl[1] = (x1 & 4 * kB0) | ((w >> 3) & 2 * kB0) | ((g >> 2) & kB0);",
                 "pl[2] = (x2 & 4 * kB0) | ((w >> 1) & 2 * kB0) | (g & kB0);",
                 "pl[3] = (x3 & 4 * kB0) | ((w << 1) & 2 * kB0) | (((g ^ w) >> 2) & kB0);",
                 "const int nrow = row + stride;",
                 "for (int r = 0; r + 1 < kRounds; ++r) {",
                 "next = load_round<kInterleaved>(src, r + 1, lane);",
                 "next = load_round<kInterleaved>(il + static_cast<size_t>(nrow) * kRowBytes, 0, lane);",
                 "if (kLast && s >= kLastSteps) continue;",
                 "if (kLast && lane >= kLastLanes) return;",
                 "row = nrow, cb = next_cb;",
                 "int row = blockIdx.x * kWarps + warp;",
                 "const int stride = gridDim.x * kWarps;"):
        assert expr in src, expr


def test_trellis_swar_word_steps():
    """Every (byte x, byte P before it) pair, four to a word: the planes give
    ops/trellis.py's symbols with E = S(P); prefix_bytes is the running XOR
    of a word's bytes, the packed totals are each word's XOR, the broadcast
    copies a byte, the transpose is one, and the carry byte's S is
    (d, d2, d1)."""
    x, pb = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    x, pb = x.reshape(-1, 4).astype(np.uint32), pb.reshape(-1, 4).astype(np.uint32)
    pack = (lambda a: a[:, 0] | a[:, 1] << _U(8) | a[:, 2] << _U(16) | a[:, 3] << _U(24))
    w, pe = pack(x), pack(pb)

    def bit(v, k):
        return (v >> _U(k)) & _U(1)

    e2 = bit(pb, 7) ^ bit(pb, 5) ^ bit(pb, 3) ^ bit(pb, 1)
    eu, ev = bit(pb, 6) ^ bit(pb, 2), bit(pb, 4) ^ bit(pb, 0)
    z2 = [e2 ^ bit(x, 7)]
    for k in (5, 3, 1):
        z2.append(z2[-1] ^ bit(x, k))
    z0 = [ev, eu ^ bit(x, 6), ev ^ bit(x, 4), eu ^ bit(x, 6) ^ bit(x, 2)]
    for p, plane in enumerate(_tf_planes(w, pe)):
        want = z2[p] << _U(2) | bit(x, 6 - 2 * p) << _U(1) | z0[p]
        np.testing.assert_array_equal(plane, pack(want))
    run = np.bitwise_xor.accumulate(x, axis=1)
    np.testing.assert_array_equal(_tf_prefix(w), pack(run))
    four = _tf_prefix(w[:4 * 1024].reshape(-1, 4))
    t = _tf_perm(_tf_perm(four[:, 0], four[:, 1], TF["sel"][0]),
                 _tf_perm(four[:, 2], four[:, 3], TF["sel"][1]), TF["sel"][2])
    np.testing.assert_array_equal(t, pack(run[:4 * 1024, 3].reshape(-1, 4)))
    for s in range(4):
        np.testing.assert_array_equal(_tf_bcast(w, s), x[:, s] * _U(TF["kB0"]))
    planes = [w, w * _U(3), pe, pe ^ w]
    got = _tf_transpose(planes)
    for i in range(4):
        for p in range(4):
            np.testing.assert_array_equal((got[i] >> _U(8 * p)) & _U(0xFF),
                                          (planes[p] >> _U(8 * i)) & _U(0xFF))
    d, d1, d2 = (np.array([0, 1, 0, 1, 0, 1, 0, 1]) >> k & 1 for k in range(3))
    c = _tf_carry_bytes(d, d1, d2) & _U(0xFF)
    np.testing.assert_array_equal(bit(c, 7) ^ bit(c, 5) ^ bit(c, 3) ^ bit(c, 1), d)
    np.testing.assert_array_equal(bit(c, 6) ^ bit(c, 2), d2)
    np.testing.assert_array_equal(bit(c, 4) ^ bit(c, 0), d1)


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planemajor"])
def test_trellis_swar_scan_gives_every_word_its_prefix(interleaved):
    """Byte s of a round's base at lane l is the XOR of every byte of the row
    before word s of lane l, the carry byte included, round after round
    (the warp scan, the steps' or words' prefix, and cb moving on)."""
    il, d, d1, d2 = _tf_inputs(3, 21)
    bases = _tf_emulate(il, d, d1, d2, interleaved)[2]
    c = _tf_carry_bytes(d, d1, d2) & _U(0xFF)
    before = np.concatenate([np.zeros((3, 1), np.uint8),
                             np.bitwise_xor.accumulate(il, axis=1)], 1) ^ c[:, None].astype(np.uint8)
    for r in range(TF["kRounds"]):
        idx, live = _tf_words(r, interleaved)
        for s in range(4):
            got = (bases[:, r] >> _U(8 * s)) & _U(0xFF)
            want = before[:, 4 * np.minimum(idx[s], TF["kRowWords"] - 1)]
            np.testing.assert_array_equal(got[:, live[s]], want[:, live[s]])


@pytest.mark.parametrize("rows,blocks", [(12, 2), (36, 5), (36, 9), (12, 3)])
def test_trellis_persistent_walk_takes_every_round_once(rows, blocks):
    """Rows strided over the grid's warps, a round's loads issued a round
    ahead (across rows too): every (row, round) computed once, each warp's
    rounds of a row in order. Row counts not a multiple of the grid's warps
    leave some warps a row fewer."""
    walks = _tf_walk(rows, blocks)
    units = [u for walk in walks for u in walk]
    assert sorted(units) == [(row, r) for row in range(rows) for r in range(TF["kRounds"])]
    for walk in walks:
        for a, b in zip(walk, walk[1:]):
            assert b == (a[0], a[1] + 1) or (b[1] == 0 and a[1] == TF["kRounds"] - 1)
    assert len({len(w) for w in walks}) == (1 if rows % (blocks * TF["kWarps"]) == 0 else 2)


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planemajor"])
def test_trellis_store_map_writes_every_byte_once_in_whole_lines(interleaved):
    """Every output byte of every row written once; every store 16-byte
    aligned; each warp store instruction's live lanes one contiguous
    512-byte run starting on a 128-byte line; loads inside the row."""
    rows = 12
    _, stores, _ = _tf_emulate(*_tf_inputs(rows, 3), interleaved)
    hits = np.zeros(rows * 4 * TF["kRowBytes"], np.int64)
    for off, live in stores:
        lanes = off[:, live]
        assert (lanes % 16 == 0).all()
        if live.any():
            assert live.all() or not interleaved      # plane-major's last round: 24 lanes
            assert (np.diff(lanes, axis=1) == 16).all() and (lanes[:, 0] % 128 == 0).all()
        for k in range(16):
            np.add.at(hits, (lanes + k).reshape(-1), 1)
    assert (hits == 1).all()
    for r in range(TF["kRounds"]):
        idx, live = _tf_words(r, interleaved)
        assert idx[live].max() < TF["kRowWords"] and (idx >= 0).all()


@pytest.mark.parametrize("rows", [12, 36])
@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planemajor"])
def test_trellis_swar_model_equals_plain(rows, interleaved):
    """The model of the kernel equals trellis_fused_plain bit for bit over
    whole rows, pad bytes included (B = 1 and 3: 12 and 36 rows)."""
    from atsc_tpu_torch.ops.cuda import trellis_fused as tfk

    il, d, d1, d2 = _tf_inputs(rows, rows)
    got = _tf_emulate(il, d, d1, d2, interleaved)[0]
    b = rows // 12
    want = tfk.trellis_fused_plain(torch.tensor(il.reshape(b, 12, -1)),
                                   *(torch.tensor(c.reshape(b, 12)) for c in (d, d1, d2)),
                                   interleaved=interleaved)
    np.testing.assert_array_equal(got, want.numpy().reshape(rows, -1))


def test_trellis_swar_model_equals_jax_probe():
    """Once against the JAX probe's Pallas kernel in interpret mode (B=1,
    both layouts)."""
    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location(
        "trellis_fuse_probe", os.path.join(os.path.dirname(CSRC), "..", "tools",
                                           "trellis_fuse_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    il, d, d1, d2 = _tf_inputs(12, 77)
    args = (jnp.asarray(il.reshape(1, 12, -1)), *(jnp.asarray(c.reshape(1, 12)) for c in (d, d1, d2)))
    for interleaved in (True, False):
        want = np.asarray(probe.trellis_fused(*args, chans=1, interleaved=interleaved,
                                              interpret=True))
        got = _tf_emulate(il, d, d1, d2, interleaved)[0]
        np.testing.assert_array_equal(got, want.reshape(12, -1))
