"""The port's burst-erasure detector and flag propagation on the CPU,
held against the JAX package on the same numpy inputs.

The detector's windowed means come from a running sum over 260k
residuals: the JAX package sums in float32 (its error reaches ~1.5e-3 in a
window mean here), the port in float64. So a window whose mean lies within
THRESHOLD_BAND of the threshold may be hot in one and not the other; every
other window, and so every flag it does not reach, must agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.ops import decode as jdec
from atsc_tpu.ops import erasures as jer
from atsc_tpu_torch.ops import decode as tdec
from atsc_tpu_torch.ops import erasures as ter

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
#: window-mean distance from the threshold inside which the port's and
#: JAX's hot windows may differ (measured: 1.5e-3 on the window means,
#: ~2.5x that on the threshold through the baseline median)
THRESHOLD_BAND = 1e-2


def _burst_capture(burst: bool) -> np.ndarray:
    """(2, N) soft levels of field 1 of a seeded 3-field capture through
    the port's CPU encoder and zf equalizer: channel 0 clean air, channel
    1 with AWGN (0.05 rms); with burst=True both carry a 3,000-sample x6
    impulse burst at N + 40,000 (tests/test_receiver.py's burst)."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
    from atsc_tpu_torch.models.receiver import equalize_field_device

    rng = np.random.default_rng(11)
    ts = rng.integers(0, 256, size=(3, 2, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc = Encoder(batch=2, device="cpu")
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(3)], -1)
    if burst:
        s0 = N + 40_000
        iq[:, s0 : s0 + 3000] += (rng.normal(size=(2, 3000))
                                  + 1j * rng.normal(size=(2, 3000))) * 6.0
    noise = rng.normal(size=iq.shape[1]) + 1j * rng.normal(size=iq.shape[1])
    iq[1] += noise * 0.05
    return equalize_field_device(iq, N, soft=True, device="cpu").numpy()


@pytest.fixture(scope="module", params=["burst", "clean"])
def levels(request):
    return request.param, _burst_capture(request.param == "burst")


def test_burst_detector_matches_jax(levels):
    """burst_erasure_flags_dev against JAX's: identical wherever no hot
    window within THRESHOLD_BAND of the threshold could reach; the burst
    flagged in both channels, the clean capture not at all."""
    kind, lev = levels
    want = np.asarray(jer.burst_erasure_flags_dev(jnp.asarray(lev)))
    got = ter.burst_erasure_flags_dev(torch.tensor(lev))
    assert got.dtype == torch.uint8 and tuple(got.shape) == lev.shape
    got = got.numpy()
    w = ter.burst_window_means(torch.tensor(lev))
    thr = ter.burst_threshold(w)
    hot = w > thr
    band = (w - thr).abs() < THRESHOLD_BAND
    sure = ter.dilate_hot(hot & ~band, N).numpy()     # hot in both
    maybe = ter.dilate_hot(hot | band, N).numpy()     # hot in either
    assert ((want >= sure) & (want <= maybe)).all()
    assert ((got >= sure) & (got <= maybe)).all()
    if kind == "burst":
        s0 = 40_000
        assert got[:, s0 + 200 : s0 + 2800].all()     # the burst's inside
        assert 3000 <= got.sum(axis=1).min() and got.sum(axis=1).max() < 3400
        np.testing.assert_array_equal(got, want)      # no window near the edge here
    else:
        assert not got.any() and not want.any()


def test_host_detector_and_residual_equal_jax(levels):
    """The float64 host path (slicer_residual, burst_erasure_flags) is the
    JAX package's, bit for bit, and flags what the device path flags."""
    _, lev = levels
    np.testing.assert_array_equal(ter.slicer_residual(lev), jer.slicer_residual(lev))
    host = ter.burst_erasure_flags(lev)
    np.testing.assert_array_equal(host, jer.burst_erasure_flags(lev))
    assert host.dtype == np.uint8
    np.testing.assert_array_equal(host, ter.burst_erasure_flags_dev(torch.tensor(lev)).numpy())


@pytest.mark.parametrize("n", [4069, 4070, 1, 2, 7, 8])
def test_median_matches_jnp_median(n):
    """median_last is jnp.median for odd and even counts (torch.median
    takes the lower middle value; jnp.median the midpoint), float32 bit
    for bit, on values whose midpoint rounds."""
    rng = np.random.default_rng(n)
    x = (rng.random((3, n)) * 3).astype(np.float32)
    got = ter.median_last(torch.tensor(x)).numpy()
    want = np.asarray(jnp.median(jnp.asarray(x), axis=-1, keepdims=True))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if n % 2 == 0:
        assert not np.array_equal(got, torch.tensor(x).median(-1, keepdim=True).values.numpy())


def test_dilation_equals_host_runs():
    """dilate_hot (a windowed sum) flags exactly the host path's per-run
    [j - w, j + 2w) spans, on random hot windows with runs at both ends."""
    rng = np.random.default_rng(3)
    n, win = 5000, 64
    hot = rng.random((4, n - win + 1)) < 0.003
    hot[0, :5] = hot[1, -3:] = True
    got = ter.dilate_hot(torch.tensor(hot), n, win).numpy()
    want = np.zeros((4, n), np.uint8)
    for b in range(4):
        for j in np.nonzero(hot[b])[0]:
            want[b, max(j - win, 0) : min(j + 2 * win, n)] = 1
    np.testing.assert_array_equal(got, want)


def test_propagate_erasure_flags_identical_to_jax():
    """Random per-symbol flags over 3 fields at B=2, the carried flags
    included: codeword flags and carry identical to JAX's."""
    rng = np.random.default_rng(21)
    jcarry = jnp.zeros((2, P.DATA_PER_FIELD), jnp.uint8)
    tcarry = torch.zeros((2, P.DATA_PER_FIELD), dtype=torch.uint8)
    for _ in range(3):
        f = (rng.random((2, N)) < 0.01).astype(np.uint8)
        jcw, jcarry = jdec.propagate_erasure_flags(jnp.asarray(f), jcarry)
        tcw, tcarry = tdec.propagate_erasure_flags(torch.tensor(f), tcarry)
        assert tcw.dtype == torch.uint8 and tuple(tcw.shape) == (2, 312, 207)
        np.testing.assert_array_equal(tcw.numpy(), np.asarray(jcw))
        np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
    assert tcw.numpy().any()
