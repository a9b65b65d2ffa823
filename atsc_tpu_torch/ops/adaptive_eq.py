"""Training-sequence adaptive equalizer: decode through unknown channels.

Counterpart of atsc_tpu/ops/adaptive_eq.py. The zf equalizer inverts the
known transmit chain and assumes an ideal channel between TX and capture.
Real 8VSB receivers instead train their equalizer on the known sync
symbols of every field (A/53's PN511/PN63 field sync exists for this).
Here a widely-linear least-squares equalizer is estimated from the 2,068
known symbols per field (820 field-sync + 312x4 segment-sync levels),
tracking slow channel drift with exponential forgetting. It absorbs any
linear distortion the capture path adds on top of the modulator:
multipath echoes, analog front-end ripple, complex gain/phase offset, DC
bias.

1.  **Block recursive least squares as batched matmuls.** Per field, the
    training design matrix X (rows = [Re u, Im u] windows of T taps
    around each known symbol, plus a bias column; u = derotated baseband)
    accumulates the normal equations R <- lam R + X^T X, v <- lam v +
    X^T d, and one ridge-scaled batched Cholesky solve per field yields
    the tap vector w = [p, q, bias].
2.  **Apply as banded matmuls**: the learned filter runs as blocked
    (rows, 128) x (128, 128) products with per-channel band matrices
    gathered from the tap vector, hard slicing after.

Precision. The Gram, the dd refinement and the solve run in float32 with
TF32 and reduced-precision float32 matmul switched off inside this module,
whatever the caller set (`torch.set_float32_matmul_precision`,
`torch.backends.cuda.matmul.allow_tf32`): the JAX package computes them at
Precision.HIGHEST. The apply FIRs take `apply_precision`: "highest" is
float32; "default" rounds both operands to bfloat16 and sums the exact
products in float32, on the CPU and the card alike, as the fast zf tier
does (on the TPU it is one bf16 pass; XLA:CPU runs it in float32).

No kernel of the JAX package lives here: it is XLA einsums and a Cholesky
there, and plain torch (cuBLAS, cuSOLVER on the card) here.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.slicer import ideal_levels, slice_symbols
from atsc_tpu_torch.tables.sync import sync_templates

_N = P.SYMBOLS_PER_FIELD
_BLK = 128

EQ_HALF = 128                  # one-sided tap support K
EQ_TAPS = 2 * EQ_HALF + 1      # T = 257 taps per I/Q component
EQ_DIM = 2 * EQ_TAPS + 1       # D = 515 unknowns (p, q, bias)
WINDOW_MARGIN = 384            # required context per side of a field window
#: bytes of one decision-directed design-matrix group (X and X*w): the dd
#: Gram runs over channel groups so that B=384 fits the card (the whole
#: batch would take 2 x 25.7 GB)
DD_GROUP_BYTES = 4 << 30


@contextlib.contextmanager
def fp32_matmul():
    """Float32 matmuls at full precision inside the block (no TF32 on the
    card, no bf16 passes in the CPU's oneDNN), the caller's setting
    restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@functools.lru_cache(maxsize=1)
def _training_set() -> tuple[np.ndarray, np.ndarray]:
    """(positions (n,), targets (2, n) float32) — field-relative indices
    of the known (constant) symbols and their levels per field parity.
    Positions < EQ_HALF are dropped so every feature window stays inside
    [pos - K, pos + K] of the field's [0, field_end - K)."""
    template, is_const = sync_templates()
    pos = np.nonzero(is_const[:_N])[0]
    pos = pos[pos >= EQ_HALF]
    return pos.astype(np.int32), template[:, pos].astype(np.float32)


def _strided_windows(u: torch.Tensor, start: int, n: int, step: int,
                     t: int) -> torch.Tensor:
    """windows[..., i, k] = u[..., start + step*i + k] for i < n, k < t: a
    strided view of u (Tensor.unfold), never a gather. Every window must
    lie inside u."""
    if not (0 <= start and start + (n - 1) * step + t <= u.shape[-1]):
        raise ValueError(f"windows ({start}, {n}, {step}, {t}) leave u of "
                         f"length {u.shape[-1]}")
    return u[..., start : start + (n - 1) * step + t].unfold(-1, t, step)


@functools.lru_cache(maxsize=1)
def _training_window_plan() -> tuple[int, int, int, int, int, int] | None:
    """Slice plan for the training positions, or None if the sync template
    ever stops matching the expected shape (one contiguous field-sync run
    + equal-length segment-sync runs on a uniform stride, with the tap span
    fitting inside one stride): (run0_start, run0_len, seg_start,
    seg_stride, seg_len, n_seg_runs). Verified against _training_set()
    exactly."""
    pos, _ = _training_set()
    runs = np.split(pos, np.nonzero(np.diff(pos) > 1)[0] + 1)
    r0, rest = runs[0], runs[1:]
    if not (np.all(np.diff(r0) == 1) and rest
            and len({len(r) for r in rest}) == 1
            and all(np.all(np.diff(r) == 1) for r in rest)):
        return None
    starts = np.array([r[0] for r in rest])
    stride = np.diff(starts)
    if stride.size and not np.all(stride == stride[0]):
        return None
    plan = (int(r0[0]), len(r0), int(starts[0]),
            int(stride[0]) if stride.size else 0, len(rest[0]), len(rest))
    # each run's window span must fit inside one stride (rl - 1 + T <=
    # stride); an oversized tap span takes the gather fallback
    if plan[4] - 1 + EQ_TAPS > plan[3]:
        return None
    a0, n0, s1, st, rl, nr = plan
    rebuilt = np.concatenate(
        [a0 + np.arange(n0)]
        + [s1 + st * s + np.arange(rl) for s in range(nr)])
    return plan if np.array_equal(rebuilt, pos) else None


def _training_windows(u: torch.Tensor, margin: int) -> torch.Tensor:
    """(B, W) derotated component -> (B, n_pos, T) feature windows for the
    sync training set, via the slice plan (gather fallback)."""
    plan = _training_window_plan()
    if plan is None:
        pos, _ = _training_set()
        idx = pos[:, None] + (margin - EQ_HALF) + np.arange(EQ_TAPS)
        return u[..., torch.as_tensor(idx, device=u.device)]
    a0, n0, s1, stride, rl, nr = plan
    fs = _strided_windows(u, a0 + margin - EQ_HALF, n0, 1, EQ_TAPS)
    # segment-sync runs: fold into (nr, stride) rows, then the rl windows
    # of each run's span (rl - 1 + T <= stride)
    base = s1 + margin - EQ_HALF
    v = u[..., base : base + nr * stride]
    pad = nr * stride - v.shape[-1]
    if pad > 0:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(*u.shape[:-1], nr, stride)[..., : rl - 1 + EQ_TAPS]
    seg = v.unfold(-1, EQ_TAPS, 1).reshape(*u.shape[:-1], nr * rl, EQ_TAPS)
    return torch.cat([fs, seg], dim=-2)


def _derotate(win: torch.Tensor, osc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """win (B, 2, W) planar IQ, osc (2, W) planar oscillator ->
    (Re u, Im u) with u = win * conj(osc) / amplitude^2."""
    inv_p2 = float(np.float32(1.0 / (P.OSC_AMPLITUDE ** 2)))
    wr, wi = win[:, 0], win[:, 1]
    cr, ci = osc[0], osc[1]
    return (wr * cr + wi * ci) * inv_p2, (wi * cr - wr * ci) * inv_p2


def _design(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """(B, n, T) feature windows of Re u and Im u -> (B, n, D) design
    matrix [Re u windows | Im u windows | 1]."""
    ones = torch.ones(xr.shape[:-1] + (1,), dtype=xr.dtype, device=xr.device)
    return torch.cat([xr, xi, ones], dim=-1)


def rls_update(
    r_mat: torch.Tensor, v: torch.Tensor, win: torch.Tensor, osc: torch.Tensor,
    targets: torch.Tensor, lam: float, *, margin: int = WINDOW_MARGIN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One field's normal-equation accumulation.

    r_mat: (B, D, D); v: (B, D); win: (B, 2, W) planar IQ covering
    [field_start - margin, field_end + margin); osc: (2, W) matching
    oscillator span; targets: (n,) known levels for this field's parity.
    """
    ur, ui = _derotate(win, osc)
    x = _design(_training_windows(ur, margin), _training_windows(ui, margin))
    xt = x.transpose(1, 2)
    with fp32_matmul():
        r_new = lam * r_mat + torch.bmm(xt, x)
        v_new = lam * v + xt @ targets
    return r_new, v_new


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _banded_fir_batched(x: torch.Tensor, taps: torch.Tensor, n_out: int,
                        precision: str = "highest") -> torch.Tensor:
    """Forward FIR out[b, i] = sum_k x[b, i+k] taps[b, k] with per-channel
    taps, as blocked batched matmuls (band matrices gathered from the tap
    vector). precision "default": both operands rounded to bfloat16, the
    exact products summed in float32."""
    n_taps = taps.shape[-1]
    if n_taps != EQ_TAPS:
        raise ValueError(f"{n_taps} taps, the band tables hold {EQ_TAPS}")
    n_bands = -(-(n_taps + _BLK - 1) // _BLK)
    nblk_out = -(-n_out // _BLK)
    nblk_in = nblk_out + n_bands - 1
    pad = nblk_in * _BLK - x.shape[-1]
    if pad > 0:
        x = torch.nn.functional.pad(x, (0, pad))
    a = x[:, : nblk_in * _BLK].reshape(x.shape[0], nblk_in, _BLK)
    if precision == "default":
        a, taps = _bf16_round(a), _bf16_round(taps)
    idx, valid = const(_band_index, x.device), const(_band_valid, x.device)
    out = 0.0
    with fp32_matmul():
        for s in range(n_bands):
            w = taps[:, idx[s]] * valid[s]                   # (B, 128, 128)
            out = out + torch.bmm(a[:, s : s + nblk_out], w)
    return out.reshape(x.shape[0], nblk_out * _BLK)[:, :n_out]


@functools.lru_cache(maxsize=1)
def _band_tables() -> tuple[np.ndarray, np.ndarray]:
    """Band matrices of the T-tap FIR: (index (bands, 128, 128) int64 into
    the taps, valid (bands, 128, 128) float32 0/1); band s holds tap
    k = 128 s + m - r at [m, r]."""
    n_bands = -(-(EQ_TAPS + _BLK - 1) // _BLK)
    m = np.arange(_BLK)[:, None]
    r = np.arange(_BLK)[None, :]
    k = np.stack([s * _BLK + m - r for s in range(n_bands)])
    valid = ((k >= 0) & (k < EQ_TAPS)).astype(np.float32)
    return np.clip(k, 0, EQ_TAPS - 1).astype(np.int64), valid


def _band_index() -> np.ndarray:
    return _band_tables()[0]


def _band_valid() -> np.ndarray:
    return _band_tables()[1]


def _apply_taps(
    w: torch.Tensor, win: torch.Tensor, osc: torch.Tensor, margin: int,
    soft: bool, apply_precision: str,
) -> torch.Tensor:
    """Equalize one field with an already-solved tap vector."""
    if apply_precision not in ("highest", "default"):
        raise ValueError(f"unknown apply precision {apply_precision!r}")
    p, q, bias = w[:, :EQ_TAPS], w[:, EQ_TAPS : 2 * EQ_TAPS], w[:, 2 * EQ_TAPS :]
    ur, ui = _derotate(win, osc)
    start = margin - EQ_HALF
    lev = (_banded_fir_batched(ur[..., start:], p, _N, apply_precision)
           + _banded_fir_batched(ui[..., start:], q, _N, apply_precision) + bias)
    return lev if soft else slice_symbols(lev)


def _solve_taps(r_mat: torch.Tensor, v: torch.Tensor, ridge: float) -> torch.Tensor:
    """Ridge-regularized normal-equation solve -> (B, D) tap vector.

    The feature Gram matrix is rank-deficient by construction (515
    unknowns, but every feature window is a linear image of only ~369
    underlying level samples), so the ridge is scaled relative to R's
    trace: large enough to dominate float32 accumulation noise in the null
    space, small enough (1e-4 default) that the tap shrinkage is far below
    the 1.0 slicing margin. The ridged Gram is symmetric positive
    definite: Cholesky, then two triangular solves. cholesky_ex does not
    check its info flag and the solves have none, so the host never waits
    for the card here (chip_smoke phase 21 holds a field to that).
    """
    eye = torch.eye(EQ_DIM, dtype=r_mat.dtype, device=r_mat.device)
    scale = torch.diagonal(r_mat, dim1=-2, dim2=-1).sum(-1)[:, None, None] / EQ_DIM
    chol = torch.linalg.cholesky_ex(r_mat + ridge * scale * eye).L
    y = torch.linalg.solve_triangular(chol, v[..., None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]


def solve_and_equalize(
    r_mat: torch.Tensor, v: torch.Tensor, win: torch.Tensor, osc: torch.Tensor,
    ridge: float, *, margin: int = WINDOW_MARGIN, soft: bool = False,
    apply_precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the accumulated normal equations and equalize one field.

    Returns (symbols (B, 260416) int8 — or the float32 soft levels when
    soft=True — and taps (B, D), the solved [p, q, bias] vector)."""
    with fp32_matmul():
        w = _solve_taps(r_mat, v, ridge)
    return _apply_taps(w, win, osc, margin, soft, apply_precision), w


def equalize_with_taps(
    w: torch.Tensor, win: torch.Tensor, osc: torch.Tensor, *,
    margin: int = WINDOW_MARGIN, soft: bool = False,
    apply_precision: str = "highest",
) -> torch.Tensor:
    """Apply-only equalization with a cached tap vector: the retrain
    cadence's fast path (no Gram, no Cholesky)."""
    return _apply_taps(w, win, osc, margin, soft, apply_precision)


def dd_gram(r_mat: torch.Tensor, v: torch.Tensor, lev: torch.Tensor,
            win: torch.Tensor, osc: torch.Tensor, *, margin: int = WINDOW_MARGIN,
            stride: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The decision-directed normal equations: (R + X^T W X, v + X^T W d)
    with every `stride`-th symbol of the field as a row, the first pass's
    sliced level as its target d and the reliability w = max(0, 1 -
    |residual|) as its weight. Built over channel groups of at most
    DD_GROUP_BYTES, each group's X from strided views of u."""
    pilot = P.PILOT_OFFSET
    n_pos = len(range(EQ_HALF, _N - EQ_HALF, stride))
    lev_s = lev[..., EQ_HALF : _N - EQ_HALF : stride]
    ideal = ideal_levels(lev_s)
    rel = torch.clamp(1.0 - (lev_s - pilot - ideal).abs(), min=0.0)
    targets = ideal + pilot                                  # (B, n)
    ur, ui = _derotate(win, osc)
    b = r_mat.shape[0]
    group = max(1, DD_GROUP_BYTES // (2 * n_pos * EQ_DIM * 4))
    r2, v2 = torch.empty_like(r_mat), torch.empty_like(v)
    for g0 in range(0, b, group):
        sl = slice(g0, g0 + group)
        x = _design(_strided_windows(ur[sl], margin, n_pos, stride, EQ_TAPS),
                    _strided_windows(ui[sl], margin, n_pos, stride, EQ_TAPS))
        xwt = (x * rel[sl, :, None]).transpose(1, 2)
        with fp32_matmul():
            r2[sl] = r_mat[sl] + torch.bmm(xwt, x)
            v2[sl] = v[sl] + (xwt @ targets[sl, :, None])[..., 0]
        del x, xwt
    return r2, v2


def dd_refine_and_equalize(
    r_mat: torch.Tensor, v: torch.Tensor, lev: torch.Tensor, win: torch.Tensor,
    osc: torch.Tensor, ridge: float, *, margin: int = WINDOW_MARGIN,
    stride: int = 8, soft: bool = False, apply_precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decision-directed second pass: re-solve the equalizer with the first
    pass's own decisions as training targets (dd_gram: ~32k rows at stride
    8, 16x the sync rows), then re-equalize. The refined normal equations
    add to the sync ones, and the result serves this field only: the
    carried state stays sync-trained, so decision errors never feed back
    across fields.

    lev: (B, 260416) float32 first-pass soft levels. Other args and
    returns exactly as solve_and_equalize.
    """
    r2, v2 = dd_gram(r_mat, v, lev, win, osc, margin=margin, stride=stride)
    return solve_and_equalize(r2, v2, win, osc, ridge, margin=margin,
                              soft=soft, apply_precision=apply_precision)


class AdaptiveState(NamedTuple):
    """What an AdaptiveEqualizer carries between fields."""

    r: torch.Tensor            # (B, D, D) float32 accumulated Gram
    v: torch.Tensor            # (B, D) float32 accumulated X^T d
    w: torch.Tensor | None     # (B, D) float32 last solved taps (None: none yet)
    fields_seen: int           # fields processed (the cadence counter)


class AdaptiveEqualizer:
    """Per-stream RLS equalizer state on `device`: feed one field window at
    a time.

    forgetting: weight on past fields' normal equations (1.0 = infinite
    memory, lowest noise for static channels; ~0.95 tracks slow drift;
    0.0 trains every field on its own 2,068 sync symbols, the fastest
    setting for abrupt channel changes).
    ridge: Tikhonov floor keeping the first solve well-posed, relative to
    trace(R).
    apply_precision: "highest" (float32) or "default" (bf16 operands,
    float32 sums) for the per-field apply FIRs; training and the solve
    always run in float32.
    decision_directed: after the sync-trained solve, re-solve with every
    dd_stride-th decided symbol as a reliability-weighted training row
    (dd_refine_and_equalize), per field only; the first pass that makes
    the decisions runs at apply_precision too.
    train_every: retrain cadence — train + solve on every k-th field and
    run the cached taps through the apply-only path (equalize_with_taps)
    on the fields between.
    """

    def __init__(self, batch: int = 1, forgetting: float = 1.0,
                 ridge: float = 1e-4, apply_precision: str = "highest",
                 decision_directed: bool = False, dd_stride: int = 8,
                 train_every: int = 1, *, device: str | torch.device):
        if train_every < 1:
            raise ValueError(f"train_every must be >= 1, got {train_every}")
        if apply_precision not in ("highest", "default"):
            raise ValueError(f"unknown apply precision {apply_precision!r}")
        self.device = resolve_device(device)
        self.batch = batch
        self._lam = float(np.float32(forgetting))
        self._ridge = float(np.float32(ridge))
        self._apply_precision = apply_precision
        self.decision_directed = decision_directed
        self.dd_stride = dd_stride
        self.train_every = train_every
        self.reset()

    @property
    def taps(self) -> np.ndarray | None:
        """Last solved (B, D) tap vector, fetched on access (the receive
        loop never waits for it)."""
        return None if self._w_dev is None else self._w_dev.cpu().numpy()

    @property
    def state(self) -> AdaptiveState:
        return AdaptiveState(self._r, self._v, self._w_dev, self._fields_seen)

    @state.setter
    def state(self, value: AdaptiveState) -> None:
        self._r, self._v, self._w_dev, self._fields_seen = value

    def reset(self) -> None:
        """Forget all accumulated training (a new stream epoch re-bases the
        derotation phase, so the learned taps no longer apply)."""
        self._r = torch.zeros((self.batch, EQ_DIM, EQ_DIM), dtype=torch.float32,
                              device=self.device)
        self._v = torch.zeros((self.batch, EQ_DIM), dtype=torch.float32,
                              device=self.device)
        self._w_dev: torch.Tensor | None = None
        self._fields_seen = 0

    def process_field(self, win_planar, osc_planar, parity: int,
                      soft: bool = False) -> torch.Tensor:
        """Train on this field's sync symbols (subject to the train_every
        cadence), then equalize it.

        win_planar: (B, 2, N + 2*margin) float32 planar IQ; osc_planar:
        (2, same) planar oscillator (numpy or tensors); parity: this
        field's sync parity (0 = even). Returns (B, 260416) int8 hard
        symbols, or float32 soft levels when soft=True, on the device.
        """
        win = torch.as_tensor(win_planar).to(self.device, torch.float32)
        osc = torch.as_tensor(osc_planar).to(self.device, torch.float32)
        train = (self._w_dev is None
                 or self._fields_seen % self.train_every == 0)
        self._fields_seen += 1
        if not train:
            return equalize_with_taps(self._w_dev, win, osc, soft=soft,
                                      apply_precision=self._apply_precision)
        self._r, self._v = rls_update(
            self._r, self._v, win, osc, const(_sync_targets, self.device)[parity],
            self._lam)
        if self.decision_directed:
            # the first pass only feeds decisions: it runs at the apply
            # tier, bf16 operands under "default" (the JAX package's
            # first pass is "default", one bf16 pass on the TPU and float32
            # on XLA:CPU, which "highest" here reproduces)
            lev, _ = solve_and_equalize(self._r, self._v, win, osc, self._ridge,
                                        soft=True, apply_precision=self._apply_precision)
            sym, w = dd_refine_and_equalize(
                self._r, self._v, lev, win, osc, self._ridge,
                stride=self.dd_stride, soft=soft,
                apply_precision=self._apply_precision)
        else:
            sym, w = solve_and_equalize(self._r, self._v, win, osc, self._ridge,
                                        soft=soft, apply_precision=self._apply_precision)
        self._w_dev = w
        return sym


def _sync_targets() -> np.ndarray:
    """(2, n) float32 sync levels per field parity."""
    return _training_set()[1]
