"""Soft-decision Viterbi: the add-compare-select forward passes and the
tracebacks of the 4-state trellis and of the 16-state NTSC partial-response
trellis, as CUDA kernel wrappers with their plain PyTorch twins.

Counterpart of atsc_tpu/ops/pallas/viterbi_acs.py (acs_forward, traceback,
pr_acs_forward, pr_traceback); the kernels are csrc/viterbi_acs.cu (its
header says what bounds them). A CUDA tensor goes to the kernel, a CPU
tensor to the `*_plain` twin; there is no fallback from one to the other.
`LAUNCHES` counts launches per kernel, so a run can show that its main path
went through the kernels.

Layouts (one field, T = 21,528 trellis steps; a lane l = b*12 + e is one
(channel, encoder) trellis; any number of lanes L):
  obs        (T, L) float32, or int8 soft-level codes (4-state tier only)
  metrics    (S, L) float32, state-major (S = 4, or 16 for the PR tier)
  decisions  4-state: (T/4, L) int32, byte k of word i = step 4i+k, bits
             (2s, 2s+1) = (x1, z2) into state s; PR: (T, L) int32, bits
             (2u, 2u+1) = the predecessor-symbol pick of combined state u
  bits       (T/4, L) int32, byte k of word i = x1 | z2<<1 of step 4i+k
T must be a multiple of 24: the metrics renormalize every 24 steps, and
that cadence is part of the numerics (bit-identical to the JAX package).

Each pass also has a chunked form (`*_chunked`, the JAX package's
`_chunked_mlse`, for `--viterbi-chunks`): C windows of W = T/C + 2*WARMUP
steps (ops/viterbi.py `_chunk_plan`) decoded as C*L chunk-lanes c*L + l,
read straight from the unchunked (T, L) obs, with the metrics renormalized
after every step (the reference's cadence there). Its 4-state decisions are
(ceil(W/4), C*L) words with -W mod 4 steps of zero padding in front; its PR
decisions (W, C*L); its tracebacks write each chunk's kept region into the
unchunked (T/4, L) bits.

The plain twins hoist everything that does not depend on the path metrics
(branch metrics, decision words) out of the sequential loop and compute it
vectorized over blocks of steps; the loop keeps only the metric recursion
(and, in a traceback, the state walk). Every float op is a separate eager
op in the kernel's order, so nothing fuses into an FMA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.cuda import _build

GROUP = 24           # steps per renormalization (the JAX package's _GROUP)
WARMUP = 128         # chunked windows: context steps on each side (csrc's kWarmup)
_STEP_BYTES = 64 << 20    # the plain twins' working set per block of steps

KERNELS = ("acs_forward", "traceback", "pr_acs_forward", "pr_traceback")
CHUNKED = tuple(k + "_chunked" for k in KERNELS)
#: kernel launches in this process, per kernel; callers may reset them to 0
LAUNCHES = dict.fromkeys(KERNELS + CHUNKED, 0)


@functools.lru_cache(maxsize=1)
def _acs_tables() -> tuple[np.ndarray, np.ndarray]:
    """(pred (8,), branch (8,)) int64: candidate c (c < 4: X1=0 into state
    c; else X1=1 into state c-4) reads metric pred[c] plus p[branch[c]],
    where p[2*x1 + b] = min(d[2*x1 + b], d[4 + 2*x1 + b]) resolves the
    parallel Z2 branch."""
    from atsc_tpu_torch.ops.viterbi import _B_OF, _PRED0, _PRED1

    pred = np.concatenate([_PRED0, _PRED1]).astype(np.int64)
    branch = np.concatenate([_B_OF, 2 + _B_OF]).astype(np.int64)
    return pred, branch


@functools.lru_cache(maxsize=1)
def _pr_rc_table() -> np.ndarray:
    """(T, 12) int32 packed reset/const: bit 0 = the comb reference lands
    on a segment-sync symbol, bit 1 = that symbol's level sign (+5)."""
    from atsc_tpu_torch.ops.ntsc import _pr_reset_tables

    reset, const_ = _pr_reset_tables()
    return reset.astype(np.int32) | ((const_ > 0).astype(np.int32) << 1)


def _block_steps(lanes: int, per_lane_step: int) -> int:
    """Steps per vectorized block of a plain twin: a multiple of 24 whose
    working set stays near _STEP_BYTES."""
    return max(GROUP, _STEP_BYTES // max(1, lanes * per_lane_step) // GROUP * GROUP)


def _pack4(x: torch.Tensor) -> torch.Tensor:
    """(T, L) integer bytes -> (T/4, L) int32 words, byte k of word i =
    x[4i + k]."""
    t, l = x.shape
    x = x.to(torch.int64).reshape(t // 4, 4, l)
    shifts = torch.tensor([0, 8, 16, 24], device=x.device).reshape(1, 4, 1)
    return _to_int32((x << shifts).sum(dim=1))


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding unsigned 32-bit words -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _check_steps(t: int) -> None:
    if t % GROUP:
        raise ValueError(f"T={t} trellis steps must be a multiple of {GROUP}")


def _check_acs(obs: torch.Tensor, metrics: torch.Tensor, states: int) -> None:
    if obs.ndim != 2:
        raise ValueError(f"obs must be (T, L), got {tuple(obs.shape)}")
    _check_steps(obs.shape[0])
    if metrics.dtype != torch.float32 or tuple(metrics.shape) != (states, obs.shape[1]):
        raise ValueError(f"metrics must be ({states}, {obs.shape[1]}) float32, got "
                         f"{tuple(metrics.shape)} {metrics.dtype}")
    if metrics.device != obs.device:
        raise ValueError(f"obs on {obs.device} but metrics on {metrics.device}")


def _check_obs_type(obs: torch.Tensor, inv_scale: float | None) -> None:
    if obs.dtype == torch.int8 and inv_scale is None:
        raise ValueError("int8 obs need inv_scale (the soft-code dequantization)")
    if obs.dtype == torch.float32 and inv_scale is not None:
        raise ValueError("inv_scale applies to int8 obs only")
    if obs.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"obs must be float32 or int8, got {obs.dtype}")


def _check_tb(dec: torch.Tensor, start: torch.Tensor, rows_per_group: int) -> None:
    if dec.dtype != torch.int32 or dec.ndim != 2 or dec.shape[0] % rows_per_group:
        raise ValueError(f"decisions must be (rows, L) int32 with rows a multiple of "
                         f"{rows_per_group}, got {tuple(dec.shape)} {dec.dtype}")
    if start.dtype != torch.int32 or tuple(start.shape) != (dec.shape[1],):
        raise ValueError(f"start must be ({dec.shape[1]},) int32, got "
                         f"{tuple(start.shape)} {start.dtype}")
    if start.device != dec.device:
        raise ValueError(f"decisions on {dec.device} but start on {start.device}")


# -- plain twins -----------------------------------------------------------

def acs_forward_plain(obs: torch.Tensor, metrics: torch.Tensor,
                      inv_scale: float | None = None):
    """The 4-state forward pass in plain PyTorch ops, on any device.
    Returns (decisions (T/4, L) int32, final metrics (4, L) float32)."""
    _check_acs(obs, metrics, 4)
    _check_obs_type(obs, inv_scale)
    return _acs_plain(obs, metrics, inv_scale, GROUP)


def _acs_plain(obs: torch.Tensor, metrics: torch.Tensor, inv_scale: float | None,
               every: int, skip: int = 0):
    """The 4-state forward pass over obs (T, L), T a multiple of 4, the
    metrics renormalized after every `every`-th step; the first `skip` steps
    are padding (no metric update, zero decision bits)."""
    from atsc_tpu_torch.ops.viterbi import _constellation

    t, l = obs.shape
    dev = obs.device
    lv = const(_constellation, dev)
    pred, branch = (torch.from_numpy(a).to(dev) for a in _acs_tables())
    inv = None if inv_scale is None else torch.tensor(inv_scale, dtype=torch.float32,
                                                      device=dev)
    m = metrics.t().contiguous()                       # (L, 4)
    dec = torch.empty((t // 4, l), dtype=torch.int32, device=dev)
    blk = _block_steps(l, 8 * 4 * 4)
    for t0 in range(0, t, blk):
        t1 = min(t, t0 + blk)
        o = obs[t0:t1]
        if inv is not None:
            o = o.to(torch.float32) * inv             # the in-kernel dequant
        diff = o[..., None] - lv                       # (n, L, 8)
        d = diff * diff
        lo, hi = d[..., :4], d[..., 4:]
        p = torch.minimum(lo, hi)                      # p[2*x1 + b]
        zc = hi < lo                                   # the Z2 bit of each branch
        br = p[..., branch]                            # (n, L, 8)
        cand = torch.empty_like(br)
        # per-step views made once: the loop is launch-bound
        steps = zip(br.unbind(0), cand.unbind(0), cand[..., :4].unbind(0),
                    cand[..., 4:].unbind(0))
        for i, (br_i, c_i, c0, c1) in enumerate(steps, t0):
            if i < skip:
                continue
            torch.add(torch.index_select(m, 1, pred), br_i, out=c_i)
            m = torch.minimum(c0, c1)
            if i % every == every - 1:
                m = m - m.amin(dim=1, keepdim=True)
        x1 = cand[..., 4:] < cand[..., :4]             # (n, L, 4)
        z2 = torch.where(x1, zc[..., [2, 3, 2, 3]], zc[..., [0, 1, 0, 1]])
        pair = x1.to(torch.int64) | (z2.to(torch.int64) << 1)
        if t0 < skip:
            pair[:skip - t0] = 0
        shifts = torch.tensor([0, 2, 4, 6], device=dev)
        dec[t0 // 4:t1 // 4] = _pack4((pair << shifts).sum(dim=-1))
    return dec, m.t().contiguous()


def traceback_plain(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The 4-state traceback in plain PyTorch ops, on any device: walk the
    decisions from the last step to the first from `start` (L,) int32.
    Returns bits (T/4, L) int32."""
    _check_tb(dec, start, GROUP // 4)
    return _pack4(_tb4_walk(dec, start))


def _tb4_walk(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The 4-state traceback over decision words (W, L) from `start`:
    (4W, L) uint8, x1 | z2<<1 of every step."""
    w, l = dec.shape
    dev = dec.device
    s = start.to(torch.int64)[:, None]
    out_all = torch.empty((4 * w, l), dtype=torch.uint8, device=dev)
    states = torch.arange(4, device=dev)
    blk = _block_steps(l, 4 * 8 * 3) // 4               # words per block
    for w1 in range(w, 0, -blk):
        w0 = max(0, w1 - blk)
        words = dec[w0:w1].to(torch.int64) & 0xFFFFFFFF
        byte = (words[:, None, :] >> torch.tensor([0, 8, 16, 24], device=dev)[:, None]) & 0xFF
        byte = byte.reshape(-1, l)                     # (n, L), step order
        sel = (byte[..., None] >> (2 * states)) & 3    # (n, L, 4): (x1 | z2<<1) into s
        prev = ((states & 1) << 1) | ((states >> 1) ^ (sel & 1))
        walk = torch.empty(byte.shape + (1,), dtype=torch.int64, device=dev)
        for w_i, p_i in zip(reversed(walk.unbind(0)), reversed(prev.unbind(0))):
            w_i.copy_(s)
            s = torch.gather(p_i, 1, s)
        walk = walk[..., 0]
        out_all[4 * w0:4 * w1] = torch.gather(sel, 2, walk[..., None])[..., 0].to(torch.uint8)
    return out_all


def pr_acs_forward_plain(obs: torch.Tensor, rc: torch.Tensor, metrics: torch.Tensor):
    """The 16-state PR forward pass in plain PyTorch ops, on any device.
    obs (T, L) float32; rc (T, 12) int32 (_pr_rc_table rows, indexed by
    encoder l % 12); metrics (16, L). Returns (decisions (T, L) int32,
    final metrics (16, L) float32)."""
    _check_acs(obs, metrics, 16)
    _check_rc(obs, rc)
    enc = torch.arange(obs.shape[1], device=obs.device) % P.TRELLIS_ENCODERS
    return _pr_plain(obs, lambda t0, t1: rc[t0:t1][:, enc], metrics, GROUP)


def _pr_plain(obs: torch.Tensor, rc_rows, metrics: torch.Tensor, every: int):
    """The 16-state PR forward pass over obs (T, L), rc_rows(t0, t1) giving
    the (t1 - t0, L) rc of each step and lane, the metrics renormalized after
    every `every`-th step."""
    from atsc_tpu_torch.ops.ntsc import _pr_tables

    t, l = obs.shape
    dev = obs.device
    # combined state u = s*4 + h: emitted level lv[u], and per hypothesis
    # h_prev the predecessor state pred_idx[u, h] and its level prev_lev[u, h]
    lv, _, pred_idx, prev_lev = (torch.from_numpy(a).to(dev) for a in _pr_tables())
    pred = pred_idx.reshape(-1).to(torch.int64)
    five = torch.tensor(5.0, device=dev)
    m = metrics.t().contiguous()                       # (L, 16)
    dec = torch.empty((t, l), dtype=torch.int32, device=dev)
    blk = _block_steps(l, 64 * 4 * 4)
    for t0 in range(0, t, blk):
        t1 = min(t, t0 + blk)
        a = obs[t0:t1, :, None] - lv                   # (n, L, 16): obs - level(u)
        rcl = rc_rows(t0, t1)                          # (n, L)
        reset = (rcl & 1) == 1
        sync = torch.where((rcl >> 1) == 1, five, -five)
        # the delayed reference: the known sync level at reset steps
        pe = torch.where(reset[..., None, None], sync[..., None, None], prev_lev)
        e = a[..., None] + pe                          # (n, L, 16, 4)
        bm = (e * e).reshape(t1 - t0, l, 64)
        cand = torch.empty_like(bm)
        c = cand.reshape(t1 - t0, l, 16, 4)
        # the survivor is the minimum of the 4 candidates, exact in any order
        for i, (bm_i, c_i, c4) in enumerate(zip(bm.unbind(0), cand.unbind(0), c.unbind(0)),
                                            t0):
            torch.add(torch.index_select(m, 1, pred), bm_i, out=c_i)
            m = torch.amin(c4, dim=-1)
            if i % every == every - 1:
                m = m - m.amin(dim=1, keepdim=True)
        i01 = (c[..., 1] < c[..., 0]).to(torch.int64)
        i23 = (c[..., 3] < c[..., 2]).to(torch.int64)
        pick = torch.minimum(c[..., 2], c[..., 3]) < torch.minimum(c[..., 0], c[..., 1])
        idx = torch.where(pick, 2 + i23, i01)          # first-min argmin, (n, L, 16)
        shifts = 2 * torch.arange(16, device=dev)
        dec[t0:t1] = _to_int32((idx << shifts).sum(dim=-1))
    return dec, m.t().contiguous()


def pr_traceback_plain(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The 16-state PR traceback in plain PyTorch ops, on any device, from
    the combined state `start` (L,) int32. Returns bits (T/4, L) int32 in
    the 4-state traceback's layout."""
    _check_tb(dec, start, GROUP)
    return _pack4(_pr_walk(dec, start))


def _pr_walk(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The PR traceback over decisions (T, L) from `start`: (T, L) uint8,
    x1 | z2<<1 (= u & 3 of the combined state u) of every step."""
    from atsc_tpu_torch.ops.ntsc import _pr_tables

    t, l = dec.shape
    dev = dec.device
    s_pred = torch.from_numpy(_pr_tables()[1]).to(device=dev, dtype=torch.int64)
    states = torch.arange(16, device=dev)
    s = start.to(torch.int64)[:, None]
    out = torch.empty((t, l), dtype=torch.uint8, device=dev)
    blk = _block_steps(l, 16 * 8 * 2)
    for t1 in range(t, 0, -blk):
        t0 = max(0, t1 - blk)
        h_prev = (dec[t0:t1, :, None].to(torch.int64) >> (2 * states)) & 3   # (n, L, 16)
        prev = (s_pred << 2) | h_prev
        walk = torch.empty((t1 - t0, l, 1), dtype=torch.int64, device=dev)
        for w_i, p_i in zip(reversed(walk.unbind(0)), reversed(prev.unbind(0))):
            w_i.copy_(s)
            s = torch.gather(p_i, 1, s)
        out[t0:t1] = (walk[..., 0] & 3).to(torch.uint8)   # x1 | z2<<1 = u & 3
    return out


# -- plain twins of the chunked passes --------------------------------------

def _windows(x: torch.Tensor, starts: np.ndarray, w: int) -> torch.Tensor:
    """(T, K) rows -> (W, C, K): chunk c's window rows starts[c] + p."""
    idx = torch.as_tensor(starts[:, None] + np.arange(w), device=x.device)   # (C, W)
    return x[idx.reshape(-1)].reshape(len(starts), w, -1).transpose(0, 1)


def _kept(per_step: torch.Tensor, length: int, offs: np.ndarray, lanes: int) -> torch.Tensor:
    """(W, C*L) per-step bytes of the windows -> (T, L): each chunk's kept
    region, in stream order."""
    return torch.cat([per_step[o:o + length, c * lanes:(c + 1) * lanes]
                      for c, o in enumerate(offs.tolist())], dim=0)


def _check_chunked(obs: torch.Tensor, metrics: torch.Tensor, states: int, n_chunks: int):
    """The chunk plan (length, W, starts, offs) of obs (T, L); raises
    _chunk_plan's ValueErrors, or on metrics of another shape."""
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    if obs.ndim != 2:
        raise ValueError(f"obs must be (T, L), got {tuple(obs.shape)}")
    plan = _chunk_plan(obs.shape[0], n_chunks, WARMUP)
    lanes = n_chunks * obs.shape[1]
    if metrics.dtype != torch.float32 or tuple(metrics.shape) != (states, lanes):
        raise ValueError(f"metrics must be ({states}, {lanes}) float32 (a column per "
                         f"chunk-lane), got {tuple(metrics.shape)} {metrics.dtype}")
    if metrics.device != obs.device:
        raise ValueError(f"obs on {obs.device} but metrics on {metrics.device}")
    return plan


def _check_tb_chunked(dec: torch.Tensor, start: torch.Tensor, steps: int, n_chunks: int,
                      rows_of):
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    plan = _chunk_plan(steps, n_chunks, WARMUP)
    if steps % 4:
        raise ValueError(f"T={steps} trellis steps must be a multiple of 4")
    rows = rows_of(plan[1])
    if dec.dtype != torch.int32 or dec.ndim != 2 or dec.shape[0] != rows or dec.shape[1] % n_chunks:
        raise ValueError(f"decisions must be ({rows}, C*L) int32, got "
                         f"{tuple(dec.shape)} {dec.dtype}")
    if start.dtype != torch.int32 or tuple(start.shape) != (dec.shape[1],):
        raise ValueError(f"start must be ({dec.shape[1]},) int32, got "
                         f"{tuple(start.shape)} {start.dtype}")
    if start.device != dec.device:
        raise ValueError(f"decisions on {dec.device} but start on {start.device}")
    return plan


def _words(w: int) -> int:
    """4-state decision words of a W-step window (front-padded to whole words)."""
    return -(-w // 4)


def acs_forward_chunked_plain(obs: torch.Tensor, metrics: torch.Tensor, n_chunks: int,
                              inv_scale: float | None = None):
    """The chunked 4-state forward pass in plain PyTorch ops, on any device
    (see acs_forward_chunked)."""
    length, w, starts, _ = _check_chunked(obs, metrics, 4, n_chunks)
    _check_obs_type(obs, inv_scale)
    pad = -w % 4
    win = _windows(obs, starts, w).reshape(w, -1)                 # (W, C*L)
    win = torch.cat([win.new_zeros((pad, win.shape[1])), win])
    return _acs_plain(win, metrics, inv_scale, 1, skip=pad)


def traceback_chunked_plain(dec: torch.Tensor, start: torch.Tensor, steps: int,
                            n_chunks: int) -> torch.Tensor:
    """The chunked 4-state traceback in plain PyTorch ops, on any device
    (see traceback_chunked)."""
    length, w, _, offs = _check_tb_chunked(dec, start, steps, n_chunks, _words)
    per_step = _tb4_walk(dec, start)[-w % 4:]
    return _pack4(_kept(per_step, length, offs, dec.shape[1] // n_chunks))


def pr_acs_forward_chunked_plain(obs: torch.Tensor, rc: torch.Tensor, metrics: torch.Tensor,
                                 n_chunks: int):
    """The chunked 16-state PR forward pass in plain PyTorch ops, on any
    device (see pr_acs_forward_chunked)."""
    _, w, starts, _ = _check_chunked(obs, metrics, 16, n_chunks)
    _check_rc(obs, rc)
    enc = torch.arange(obs.shape[1], device=obs.device) % P.TRELLIS_ENCODERS
    rcw = _windows(rc, starts, w)[:, :, enc].reshape(w, -1)       # (W, C*L)
    win = _windows(obs, starts, w).reshape(w, -1)
    return _pr_plain(win, lambda t0, t1: rcw[t0:t1], metrics, 1)


def pr_traceback_chunked_plain(dec: torch.Tensor, start: torch.Tensor, steps: int,
                               n_chunks: int) -> torch.Tensor:
    """The chunked PR traceback in plain PyTorch ops, on any device (see
    pr_traceback_chunked)."""
    length, _, _, offs = _check_tb_chunked(dec, start, steps, n_chunks, lambda w: w)
    return _pack4(_kept(_pr_walk(dec, start), length, offs, dec.shape[1] // n_chunks))


def _check_rc(obs: torch.Tensor, rc: torch.Tensor) -> None:
    if (rc.dtype != torch.int32
            or tuple(rc.shape) != (obs.shape[0], P.TRELLIS_ENCODERS)):
        raise ValueError(f"rc must be ({obs.shape[0]}, {P.TRELLIS_ENCODERS}) int32, "
                         f"got {tuple(rc.shape)} {rc.dtype}")
    if rc.device != obs.device:
        raise ValueError(f"obs on {obs.device} but rc on {rc.device}")


# -- the kernels -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_lib(device_index: int) -> ctypes.CDLL:
    """The built kernel library."""
    lib = _build.load("viterbi_acs")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, args in (
        ("atsc_acs_forward", [i, p, i, p, p, p, i, i, f, p]),
        ("atsc_traceback", [i, p, p, p, i, i, p]),
        ("atsc_pr_acs_forward", [i, p, p, p, p, p, i, i, p]),
        ("atsc_pr_traceback", [i, p, p, p, i, i, p]),
        ("atsc_acs_forward_chunked", [i, p, i, p, p, p, i, i, i, f, p]),
        ("atsc_traceback_chunked", [i, p, p, p, i, i, i, p]),
        ("atsc_pr_acs_forward_chunked", [i, p, p, p, p, p, i, i, i, p]),
        ("atsc_pr_traceback_chunked", [i, p, p, p, i, i, i, p]),
    ):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    return lib


def _device_of(x: torch.Tensor, name: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def acs_forward(obs: torch.Tensor, metrics: torch.Tensor,
                inv_scale: float | None = None):
    """Forward 4-state ACS over obs (T, L) float32, or int8 soft-level
    codes dequantized in the kernel by inv_scale (float32), from metrics
    (4, L) float32. Returns (decisions (T/4, L) int32, final metrics
    (4, L)), renormalized after every 24 steps.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    acs_forward_plain."""
    _check_acs(obs, metrics, 4)
    _check_obs_type(obs, inv_scale)
    if obs.device.type == "cpu":
        return acs_forward_plain(obs, metrics, inv_scale)
    dev = _device_of(obs, "acs_forward")
    obs, metrics = obs.contiguous(), metrics.contiguous()
    t, l = obs.shape
    dec = torch.empty((t // 4, l), dtype=torch.int32, device=dev)
    mout = torch.empty_like(metrics)
    inv = float(np.float32(inv_scale)) if inv_scale is not None else 1.0
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_acs_forward(
            dev.index, obs.data_ptr(), int(obs.dtype == torch.int8), metrics.data_ptr(),
            dec.data_ptr(), mout.data_ptr(), t, l, inv, _stream(dev))
    _launched("acs_forward", err)
    return dec, mout


def traceback(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Reverse 4-state traceback over decisions (T/4, L) int32 from start
    (L,) int32. Returns bit words (T/4, L) int32: byte k of word i = the
    (x1 | z2<<1) pair of step 4i+k.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    traceback_plain."""
    _check_tb(dec, start, GROUP // 4)
    if dec.device.type == "cpu":
        return traceback_plain(dec, start)
    dev = _device_of(dec, "traceback")
    dec, start = dec.contiguous(), start.contiguous()
    bits = torch.empty_like(dec)
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_traceback(
            dev.index, dec.data_ptr(), start.data_ptr(), bits.data_ptr(),
            dec.shape[0], dec.shape[1], _stream(dev))
    _launched("traceback", err)
    return bits


def pr_acs_forward(obs: torch.Tensor, rc: torch.Tensor, metrics: torch.Tensor):
    """Forward 16-state PR ACS over combed obs (T, L) float32 with the
    per-step reset/sign table rc (T, 12) int32 (row t, encoder l % 12),
    from metrics (16, L). Returns (decisions (T, L) int32, final metrics
    (16, L)), renormalized after every 24 steps.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    pr_acs_forward_plain."""
    _check_acs(obs, metrics, 16)
    _check_rc(obs, rc)
    if obs.dtype != torch.float32:
        raise ValueError(f"PR obs must be float32, got {obs.dtype}")
    if obs.device.type == "cpu":
        return pr_acs_forward_plain(obs, rc, metrics)
    dev = _device_of(obs, "pr_acs_forward")
    obs, rc, metrics = obs.contiguous(), rc.contiguous(), metrics.contiguous()
    t, l = obs.shape
    dec = torch.empty((t, l), dtype=torch.int32, device=dev)
    mout = torch.empty_like(metrics)
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_pr_acs_forward(
            dev.index, obs.data_ptr(), rc.data_ptr(), metrics.data_ptr(), dec.data_ptr(),
            mout.data_ptr(), t, l, _stream(dev))
    _launched("pr_acs_forward", err)
    return dec, mout


def pr_traceback(dec: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Reverse PR traceback over decisions (T, L) int32 from the combined
    state start (L,) int32. Returns bit words (T/4, L) int32 in the
    traceback() layout.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    pr_traceback_plain."""
    _check_tb(dec, start, GROUP)
    if dec.device.type == "cpu":
        return pr_traceback_plain(dec, start)
    dev = _device_of(dec, "pr_traceback")
    dec, start = dec.contiguous(), start.contiguous()
    t, l = dec.shape
    bits = torch.empty((t // 4, l), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_pr_traceback(
            dev.index, dec.data_ptr(), start.data_ptr(), bits.data_ptr(), t, l,
            _stream(dev))
    _launched("pr_traceback", err)
    return bits


def acs_forward_chunked(obs: torch.Tensor, metrics: torch.Tensor, n_chunks: int,
                        inv_scale: float | None = None):
    """Chunked forward 4-state ACS: obs (T, L) float32, or int8 soft-level
    codes dequantized by inv_scale, decoded as n_chunks windows of W =
    T/n_chunks + 2*WARMUP steps (ops/viterbi.py _chunk_plan) from metrics
    (4, n_chunks*L) float32, chunk-lane c*L + l. Returns (decisions
    (ceil(W/4), n_chunks*L) int32, -W mod 4 zero steps in front, final
    metrics (4, n_chunks*L)), renormalized after every step.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    acs_forward_chunked_plain."""
    _, w, _, _ = _check_chunked(obs, metrics, 4, n_chunks)
    _check_obs_type(obs, inv_scale)
    if obs.device.type == "cpu":
        return acs_forward_chunked_plain(obs, metrics, n_chunks, inv_scale)
    dev = _device_of(obs, "acs_forward_chunked")
    obs, metrics = obs.contiguous(), metrics.contiguous()
    t, l = obs.shape
    dec = torch.empty((_words(w), n_chunks * l), dtype=torch.int32, device=dev)
    mout = torch.empty_like(metrics)
    inv = float(np.float32(inv_scale)) if inv_scale is not None else 1.0
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_acs_forward_chunked(
            dev.index, obs.data_ptr(), int(obs.dtype == torch.int8), metrics.data_ptr(),
            dec.data_ptr(), mout.data_ptr(), t, l, n_chunks, inv, _stream(dev))
    _launched("acs_forward_chunked", err)
    return dec, mout


def traceback_chunked(dec: torch.Tensor, start: torch.Tensor, steps: int,
                      n_chunks: int) -> torch.Tensor:
    """Chunked 4-state traceback over acs_forward_chunked's decisions from
    start (n_chunks*L,) int32, each window from its last step. Returns bit
    words (T/4, L) int32 of the T = `steps` stream steps (traceback()
    layout), each step from the chunk whose kept region holds it.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    traceback_chunked_plain."""
    _check_tb_chunked(dec, start, steps, n_chunks, _words)
    if dec.device.type == "cpu":
        return traceback_chunked_plain(dec, start, steps, n_chunks)
    dev = _device_of(dec, "traceback_chunked")
    dec, start = dec.contiguous(), start.contiguous()
    l = dec.shape[1] // n_chunks
    bits = torch.empty((steps // 4, l), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_traceback_chunked(
            dev.index, dec.data_ptr(), start.data_ptr(), bits.data_ptr(), steps, l,
            n_chunks, _stream(dev))
    _launched("traceback_chunked", err)
    return bits


def pr_acs_forward_chunked(obs: torch.Tensor, rc: torch.Tensor, metrics: torch.Tensor,
                           n_chunks: int):
    """Chunked forward 16-state PR ACS over combed obs (T, L) float32 and
    rc (T, 12) int32 (chunk c's step p reads row starts[c] + p), from
    metrics (16, n_chunks*L). Returns (decisions (W, n_chunks*L) int32,
    final metrics (16, n_chunks*L)), renormalized after every step.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    pr_acs_forward_chunked_plain."""
    _, w, _, _ = _check_chunked(obs, metrics, 16, n_chunks)
    _check_rc(obs, rc)
    if obs.dtype != torch.float32:
        raise ValueError(f"PR obs must be float32, got {obs.dtype}")
    if obs.device.type == "cpu":
        return pr_acs_forward_chunked_plain(obs, rc, metrics, n_chunks)
    dev = _device_of(obs, "pr_acs_forward_chunked")
    obs, rc, metrics = obs.contiguous(), rc.contiguous(), metrics.contiguous()
    t, l = obs.shape
    dec = torch.empty((w, n_chunks * l), dtype=torch.int32, device=dev)
    mout = torch.empty_like(metrics)
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_pr_acs_forward_chunked(
            dev.index, obs.data_ptr(), rc.data_ptr(), metrics.data_ptr(), dec.data_ptr(),
            mout.data_ptr(), t, l, n_chunks, _stream(dev))
    _launched("pr_acs_forward_chunked", err)
    return dec, mout


def pr_traceback_chunked(dec: torch.Tensor, start: torch.Tensor, steps: int,
                         n_chunks: int) -> torch.Tensor:
    """Chunked PR traceback over pr_acs_forward_chunked's decisions from the
    combined states start (n_chunks*L,) int32. Returns bit words (T/4, L)
    int32 in the traceback() layout.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    pr_traceback_chunked_plain."""
    _check_tb_chunked(dec, start, steps, n_chunks, lambda w: w)
    if dec.device.type == "cpu":
        return pr_traceback_chunked_plain(dec, start, steps, n_chunks)
    dev = _device_of(dec, "pr_traceback_chunked")
    dec, start = dec.contiguous(), start.contiguous()
    l = dec.shape[1] // n_chunks
    bits = torch.empty((steps // 4, l), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib(dev.index).atsc_pr_traceback_chunked(
            dev.index, dec.data_ptr(), start.data_ptr(), bits.data_ptr(), steps, l,
            n_chunks, _stream(dev))
    _launched("pr_traceback_chunked", err)
    return bits


# -- whole fields ----------------------------------------------------------

def pack_bits_to_bytes(bits: torch.Tensor, z2_prev_row: torch.Tensor):
    """Packed traceback words -> trellis bytes, on packed operands.

    bits (W, L) int32 (byte k = x1 | z2<<1 of step 4i+k); z2_prev_row (L,)
    int32 in {0, 1}, the carried precoder state. Returns (bytes (W, L)
    int32 in [0, 256), z2_last (L,) int32). The differential decode
    x2_t = z2_t ^ z2_{t-1} runs on whole words (a byte shift within the word
    and a one-word carry), then the 4 (x2, x1) pairs assemble MSB-first."""
    ones = 0x01010101
    x1w = bits & ones
    z2w = (bits >> 1) & ones
    hi = (z2w >> 24) & 1                      # byte 3 -> next word's byte 0
    carry = torch.cat([z2_prev_row.to(torch.int32)[None], hi[:-1]], dim=0)
    x2w = z2w ^ (((z2w << 8) | carry) & ones)
    acc = torch.zeros_like(bits)
    for k in range(4):
        # pair k of the byte sits at bits (7-2k, 6-2k), MSB-first
        acc = acc | (((x2w >> (8 * k)) & 1) << (7 - 2 * k))
        acc = acc | (((x1w >> (8 * k)) & 1) << (6 - 2 * k))
    return acc, hi[-1]


def _lanes_t_major(x: torch.Tensor) -> torch.Tensor:
    """(B, 12, T) -> (T, B*12) contiguous: one transpose copy, so a warp's
    loads of one step are contiguous."""
    b, ne, t = x.shape
    return x.reshape(b * ne, t).t().contiguous()


def _finish(bits: torch.Tensor, z2_prev: torch.Tensor, mout: torch.Tensor,
            b: int, ne: int):
    """Traceback words -> (bytes (B, 12, T/4) uint8, new z2 (B, 12) int32,
    new metrics (B, 12, S) float32)."""
    bytes_w, z2_last = pack_bits_to_bytes(bits, z2_prev.reshape(b * ne))
    w = bits.shape[0]
    bytes_out = bytes_w.to(torch.uint8).reshape(w, b, ne).permute(1, 2, 0).contiguous()
    new_metrics = mout.t().reshape(b, ne, mout.shape[0]).contiguous()
    return bytes_out, z2_last.reshape(b, ne), new_metrics


def viterbi_field(levels: torch.Tensor, z2_prev: torch.Tensor,
                  metrics: torch.Tensor):
    """Exact MLSE over one field of soft levels, through acs_forward and
    traceback (twin of atsc_tpu viterbi_field_pallas; any batch, no
    padding).

    levels: (B, 12, T) float32 soft levels, or int8 soft-level codes at
    SOFT_LEVEL_SCALE; z2_prev: (B, 12) int32; metrics: (B, 12, 4) float32.
    Returns (bytes (B, 12, T/4) uint8, new z2_prev (B, 12) int32, new
    metrics (B, 12, 4) float32). The traceback starts from the argmin of
    the renormalized final metrics (first minimum on ties)."""
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV

    b, ne, t = levels.shape
    _check_steps(t)
    inv = SOFT_LEVEL_INV if levels.dtype == torch.int8 else None
    dec, mout = acs_forward(_lanes_t_major(levels),
                            metrics.reshape(b * ne, 4).t().contiguous(), inv_scale=inv)
    start = torch.argmin(mout, dim=0).to(torch.int32)
    return _finish(traceback(dec, start), z2_prev, mout, b, ne)


def viterbi_pr_field(y: torch.Tensor, z2_prev: torch.Tensor, metrics: torch.Tensor):
    """Exact 16-state PR MLSE over one field of combed observations,
    through pr_acs_forward and pr_traceback (twin of atsc_tpu
    viterbi_pr_field_pallas; any batch).

    y: (B, 12, T) float32; z2_prev: (B, 12) int32; metrics: (B, 12, 16)
    float32. Returns (bytes (B, 12, T/4) uint8, new z2_prev, new metrics)."""
    b, ne, t = y.shape
    _check_steps(t)
    rc = const(_pr_rc_table, y.device)[:t]
    dec, mout = pr_acs_forward(_lanes_t_major(y), rc,
                               metrics.reshape(b * ne, 16).t().contiguous())
    start = torch.argmin(mout, dim=0).to(torch.int32)
    return _finish(pr_traceback(dec, start), z2_prev, mout, b, ne)


def _chunk_metrics(metrics: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """(B, 12, S) carried metrics -> (S, C*B*12): chunk 0 keeps them, the
    other chunks start flat at 0 (the JAX package's _chunked_mlse)."""
    b, ne, s = metrics.shape
    m0 = torch.zeros((s, n_chunks * b * ne), dtype=torch.float32, device=metrics.device)
    m0[:, :b * ne] = metrics.reshape(b * ne, s).t()
    return m0


def viterbi_field_chunked(levels: torch.Tensor, z2_prev: torch.Tensor,
                          metrics: torch.Tensor, n_chunks: int):
    """Chunk-parallel near-MLSE over one field of soft levels, through
    acs_forward_chunked and traceback_chunked (twin of the JAX package's
    viterbi_bits(n_chunks > 1) path). Same arguments and returns as
    viterbi_field; the new metrics are the last chunk's, each window's
    traceback starts from the first argmin of its final metrics."""
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV

    b, ne, t = levels.shape
    inv = SOFT_LEVEL_INV if levels.dtype == torch.int8 else None
    dec, mout = acs_forward_chunked(_lanes_t_major(levels), _chunk_metrics(metrics, n_chunks),
                                    n_chunks, inv_scale=inv)
    start = torch.argmin(mout, dim=0).to(torch.int32)
    bits = traceback_chunked(dec, start, t, n_chunks)
    return _finish(bits, z2_prev, mout[:, (n_chunks - 1) * b * ne:], b, ne)


def viterbi_pr_field_chunked(y: torch.Tensor, z2_prev: torch.Tensor, metrics: torch.Tensor,
                             n_chunks: int):
    """Chunk-parallel 16-state PR near-MLSE over one field of combed
    observations, through pr_acs_forward_chunked and pr_traceback_chunked.
    Same arguments and returns as viterbi_pr_field."""
    b, ne, t = y.shape
    rc = const(_pr_rc_table, y.device)[:t]
    dec, mout = pr_acs_forward_chunked(_lanes_t_major(y), rc,
                                       _chunk_metrics(metrics, n_chunks), n_chunks)
    start = torch.argmin(mout, dim=0).to(torch.int32)
    bits = pr_traceback_chunked(dec, start, t, n_chunks)
    return _finish(bits, z2_prev, mout[:, (n_chunks - 1) * b * ne:], b, ne)
