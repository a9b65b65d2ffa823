"""The port's adaptive (training-sequence) equalizer on the CPU against the
JAX package's, on the same numpy field windows: taps and soft levels
within stated tolerances, hard symbols identical, over the channels of
tests/test_adaptive_eq.py; the window builders against a gather; the
float64 zf reference equalize_span; the state carried from a JAX stream.

Both sides run the apply FIRs at "highest" (float32) here. The Gram
matrices from torch and from XLA:CPU differ in their low bits, and the
Cholesky of a 515-unknown system with a ridge of 1e-4 of trace/D
amplifies that, so taps and levels agree to a tolerance, not bit for bit.
Measured on these cases: levels within 1.6e-3 of JAX's inside a field and
within 1.8e-2 in its first and last EDGE symbols (their windows read the
zero-filled stream before the first sample, or straddle the channel
step); taps within 8.2e-3 with noise and within 8.2e-2 on noise-free
captures (taps up to ~12; there the ridge alone fixes the null space,
which no window sees). adaptive-dd's first pass runs at the apply
precision, float32 here as JAX's "default" is on XLA:CPU. Its case sits
at 20 dB, where symbols lie arbitrarily close to a decision boundary:
there (1-4 of 520,832 symbols a field) a level within LEV_TOL of a
boundary may slice the other way; every other symbol is identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.models import receiver as jrx
from atsc_tpu.ops import adaptive_eq as jae
from atsc_tpu_torch.models import receiver as trx
from atsc_tpu_torch.ops import adaptive_eq as tae

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
B = 2
N_FIELDS = 4
LEV_TOL = 2e-3       # |port - JAX| soft levels inside a field
EDGE = 384           # symbols at either end of a field held to EDGE_LEV_TOL
EDGE_LEV_TOL = 2e-2
TAP_TOL = 0.1        # |port - JAX| taps
BF16_LEV_TOL = 0.1   # the "default" (bf16-operand) apply against float32 (measured 0.051)


@pytest.fixture(scope="module")
def clean_iq():
    """(B, N_FIELDS * N) complex128 baseband of seeded random TS through
    the port's CPU encoder."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    rng = np.random.default_rng(47)
    ts = rng.integers(0, 256, size=(N_FIELDS, B, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc = Encoder(batch=B, device="cpu")
    return np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(N_FIELDS)],
                          -1).astype(np.complex128)


def _channel(iq: np.ndarray, h) -> np.ndarray:
    """y[b, n] = sum_m h[m] iq[b, n-m] (causal FIR channel, zero history)."""
    return np.stack([np.convolve(row, h)[: iq.shape[1]] for row in iq])


def _multipath(iq, rng):
    """tests/test_adaptive_eq.py's multipath + complex gain + noise."""
    h = np.zeros(24, np.complex128)
    h[0] = 0.85 * np.exp(0.4j)
    h[7] = 0.2 * np.exp(-1.3j)
    h[23] = -0.1 + 0.05j
    y = _channel(iq, h)
    return y + (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape)) * 0.01


def _step(iq, rng):
    """A gain/phase step before field 2 on lane 0."""
    y = iq.copy()
    y[0, 2 * N :] *= 0.8 * np.exp(0.9j)
    return y


def _two_lanes(iq, rng):
    """Lane 0 clean, lane 1 through a strong echo channel."""
    y = iq.copy()
    y[1] = np.convolve(y[1], [0.7 * np.exp(0.5j), 0, 0, 0.15j])[: y.shape[1]]
    return y


def _awgn20(iq, rng):
    """Multipath at 20 dB AWGN (tests/test_adaptive_eq.py's dd case)."""
    y = _channel(iq, [0.9 * np.exp(0.5j), 0, 0.2 * np.exp(-1.3j), 0, 0.08j])
    p = float(np.mean(np.abs(y) ** 2))
    noise = rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape)
    return y + noise * np.sqrt(p / 10 ** (20.0 / 10.0) / 2.0)


CASES = {
    "clean": (lambda iq, rng: iq, {}),
    "multipath": (_multipath, {}),
    "step_forgetting0": (_step, dict(forgetting=0.0)),
    "train_every3": (_multipath, dict(train_every=3)),
    "two_lanes": (_two_lanes, {}),
    "dd_20db": (_awgn20, dict(decision_directed=True)),
}


def _sym(lev: np.ndarray) -> np.ndarray:
    return np.clip(np.rint((lev - P.PILOT_OFFSET + 7.0) / 2.0), 0, 7).astype(np.int8)


def _near_boundary(lev: np.ndarray, tol: float) -> np.ndarray:
    """Where a level lies within tol of a slicer decision boundary."""
    x = (lev - P.PILOT_OFFSET + 7.0) / 2.0
    inner = (x > 0.5 - tol / 2) & (x < 6.5 + tol / 2)
    return inner & (np.abs(x - np.floor(x) - 0.5) < tol / 2)


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_equalizer_matches_jax(clean_iq, case):
    """Field by field through both AdaptiveEqualizers (soft levels, then
    taps): levels and taps within the stated tolerances, the sliced symbols
    identical (adaptive-dd at 20 dB: but within LEV_TOL of a boundary, for
    at most 1e-4 of the symbols)."""
    impair, kw = CASES[case]
    iq = impair(clean_iq, np.random.default_rng(61)).astype(np.complex64)
    je = jae.AdaptiveEqualizer(batch=B, apply_precision="highest", **kw)
    te = tae.AdaptiveEqualizer(batch=B, apply_precision="highest", device="cpu", **kw)
    dd = kw.get("decision_directed", False)
    for k in range(N_FIELDS - 1):
        win, osc = jrx.field_window(iq, k * N, 0, margin=tae.WINDOW_MARGIN)
        want = np.asarray(je.process_field(win, osc, k % 2, soft=True))
        got = te.process_field(win, osc, k % 2, soft=True)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, N)
        err = np.abs(got.numpy() - want)
        inner = err[:, EDGE:-EDGE].max()
        assert inner <= LEV_TOL, (case, k, inner)
        assert err.max() <= EDGE_LEV_TOL, (case, k, err.max())
        assert np.abs(te.taps - je.taps).max() <= TAP_TOL, (case, k)
        differ = _sym(got.numpy()) != _sym(want)
        if dd:
            assert not (differ & ~_near_boundary(want, LEV_TOL)).any(), (case, k)
            assert differ.sum() <= 1e-4 * differ.size, (case, k, differ.sum())
        else:
            assert not differ.any(), (case, k, differ.sum())
    assert te.state.fields_seen == je._fields_seen == N_FIELDS - 1
    if case == "two_lanes":
        assert np.abs(te.taps[0] - te.taps[1]).max() > 0.1


def test_hard_symbols_and_default_tier(clean_iq):
    """soft=False gives the sliced levels; the "default" apply tier (bf16
    operands, float32 sums) stays within BF16_LEV_TOL of JAX's float32
    levels and slices the multipath capture identically."""
    iq = _multipath(clean_iq, np.random.default_rng(61)).astype(np.complex64)
    win, osc = jrx.field_window(iq, 0, 0, margin=tae.WINDOW_MARGIN)
    je = jae.AdaptiveEqualizer(batch=B, apply_precision="highest")
    want = np.asarray(je.process_field(win, osc, 0, soft=True))
    for prec in ("highest", "default"):
        te = tae.AdaptiveEqualizer(batch=B, apply_precision=prec, device="cpu")
        hard = te.process_field(win, osc, 0)
        te.reset()
        soft = te.process_field(win, osc, 0, soft=True)
        assert hard.dtype == torch.int8
        np.testing.assert_array_equal(hard.numpy(), _sym(soft.numpy()))
        err = np.abs(soft.numpy() - want)[:, EDGE:-EDGE].max()
        assert err <= (LEV_TOL if prec == "highest" else BF16_LEV_TOL), (prec, err)
        np.testing.assert_array_equal(hard.numpy(), _sym(want))


def test_gram_ignores_the_callers_matmul_precision(clean_iq):
    """The caller's float32 matmul setting ("medium" lets oneDNN, and on
    the card cuBLAS, use reduced precision) does not reach the Gram, the
    solve or the apply: bit-identical taps and levels, and the caller's
    setting restored."""
    iq = _multipath(clean_iq, np.random.default_rng(61)).astype(np.complex64)
    win, osc = jrx.field_window(iq, 0, 0, margin=tae.WINDOW_MARGIN)
    ref = tae.AdaptiveEqualizer(batch=B, device="cpu")
    want = ref.process_field(win, osc, 0, soft=True)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        te = tae.AdaptiveEqualizer(batch=B, device="cpu")
        got = te.process_field(win, osc, 0, soft=True)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want) and torch.equal(te.state.r, ref.state.r)
    assert torch.equal(te.state.w, ref.state.w)


def test_training_windows_equal_a_gather():
    """The view-built design-matrix windows (_training_windows,
    _strided_windows) equal a gather, and JAX's, on the sync training set
    and the decision-directed stride-8 set; the plan and training set are
    JAX's."""
    assert tae._training_window_plan() == jae._training_window_plan() is not None
    for a, b in zip(tae._training_set(), jae._training_set()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    m = tae.WINDOW_MARGIN
    u = rng.normal(size=(2, N + 2 * m)).astype(np.float32)
    pos, _ = tae._training_set()
    idx = pos[:, None] + (m - tae.EQ_HALF) + np.arange(tae.EQ_TAPS)
    got = tae._training_windows(torch.tensor(u), m).numpy()
    np.testing.assert_array_equal(got, u[:, idx])
    np.testing.assert_array_equal(got, np.asarray(jae._training_windows(jnp.asarray(u), m)))
    stride = 8
    dd_pos = np.arange(tae.EQ_HALF, N - tae.EQ_HALF, stride)
    idx2 = dd_pos[:, None] + (m - tae.EQ_HALF) + np.arange(tae.EQ_TAPS)
    got2 = tae._strided_windows(torch.tensor(u), m, len(dd_pos), stride, tae.EQ_TAPS)
    np.testing.assert_array_equal(got2.numpy(), u[:, idx2])
    with pytest.raises(ValueError):
        tae._strided_windows(torch.tensor(u), m, len(dd_pos) + 200, stride, tae.EQ_TAPS)


def test_equalize_span_matches_jax(clean_iq):
    """The float64 host equalizer (the numpy backend) within 1e-9 of
    JAX's, mid-stream and at a cold start with a partial stream."""
    iq = clean_iq[:, : 3 * N]
    for g0, off, n_out in ((N, 0, N), (0, 0, 5000), (N + 100, 4000, N - 100)):
        got = trx.equalize_span(iq[:, off:], g0, first_field=0, n_out=n_out,
                                stream_offset=off)
        want = jrx.equalize_span(iq[:, off:], g0, first_field=0, n_out=n_out,
                                 stream_offset=off)
        assert got.dtype == np.float64 and got.shape == (B, n_out)
        assert np.abs(got - want).max() <= 1e-9
    np.testing.assert_array_equal(trx.slice_levels(want), jrx.slice_levels(want))


def test_adaptive_state_carries_a_jax_stream(clean_iq):
    """A JAX AdaptiveEqualizer trains on fields 0-1 of the multipath
    capture; its state ({r, v, w, fields_seen}) moves into the port, whose
    field 2 gives JAX's field-2 levels within LEV_TOL and the same
    symbols; also on the cadence's apply-only path (train_every=3)."""
    from atsc_tpu_torch.utils.convert import adaptive_state_from_numpy, adaptive_state_to_numpy

    iq = _multipath(clean_iq, np.random.default_rng(61)).astype(np.complex64)
    for kw in ({}, dict(train_every=3)):
        je = jae.AdaptiveEqualizer(batch=B, apply_precision="highest", **kw)
        for k in range(2):
            je.process_field(*jrx.field_window(iq, k * N, 0, margin=tae.WINDOW_MARGIN), k % 2)
        leaves = {"r": np.asarray(je._r), "v": np.asarray(je._v),
                  "w": np.asarray(je._w_dev), "fields_seen": je._fields_seen}
        te = tae.AdaptiveEqualizer(batch=B, apply_precision="highest", device="cpu", **kw)
        te.state = adaptive_state_from_numpy(leaves, device="cpu")
        back = adaptive_state_to_numpy(te.state)
        assert back["fields_seen"] == 2
        for name in ("r", "v", "w"):
            np.testing.assert_array_equal(back[name], leaves[name])
        win, osc = jrx.field_window(iq, 2 * N, 0, margin=tae.WINDOW_MARGIN)
        want = np.asarray(je.process_field(win, osc, 0, soft=True))
        got = te.process_field(win, osc, 0, soft=True).numpy()
        assert np.abs(got - want)[:, EDGE:-EDGE].max() <= LEV_TOL
        np.testing.assert_array_equal(_sym(got), _sym(want))
    with pytest.raises(ValueError):
        adaptive_state_from_numpy({**leaves, "r": leaves["r"].astype(np.float64)}, device="cpu")
    with pytest.raises(ValueError):
        adaptive_state_from_numpy({"r": leaves["r"], "v": leaves["v"]}, device="cpu")
