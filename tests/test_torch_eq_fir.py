"""The equalizer kernel module of the PyTorch port on the CPU: the plain twin
against the JAX Pallas kernel (interpret mode) on the golden-IQ window of
field 0 and on a random window, the band weights, the wrapper's routing and
its refusals. The CUDA kernel itself is held against the plain twin on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.models.receiver import _osc_planar as jax_osc_planar
from atsc_tpu.ops.pallas import eq_fir as jeq
from atsc_tpu.ops.quantize import QMAX, quantize_scale
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.cuda import eq_fir as teq

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
W = teq.WIN_LEN


def _window(golden, eq_k: int) -> tuple[np.ndarray, np.ndarray]:
    """(2, 2, W) float32: channel 0 the golden IQ of fields 0-1 from stream
    sample -eq_k (zero before the stream start), channel 1 seeded random
    IQ; and the (2, W) oscillator of that span."""
    iq = golden["iq"][:2].reshape(-1)
    win = np.zeros((2, 2, W), np.float32)
    win[0, 0, eq_k:] = iq.real[: W - eq_k]
    win[0, 1, eq_k:] = iq.imag[: W - eq_k]
    win[1] = np.random.default_rng(5).normal(0.0, 0.2, (2, W)).astype(np.float32)
    return win, jax_osc_planar(-eq_k, -eq_k + W, 0)


def _codes(win: np.ndarray) -> np.ndarray:
    s = quantize_scale("cs8")
    return np.clip(np.round(win * s), -QMAX["cs8"], QMAX["cs8"]).astype(np.int8)


@pytest.fixture(scope="module")
def jax_out(golden):
    """The four interpret-mode calls of the JAX kernel, shared."""
    def run(win, osc, **kw):
        out = jeq.eq_fir_fused(jnp.asarray(win), jnp.asarray(osc),
                               interpret=True, **kw)
        return np.asarray(out)[:, :N]

    w128, o128 = _window(golden, 128)
    w256, o256 = _window(golden, 256)
    dq = 1.0 / quantize_scale("cs8")
    return {
        "fast_hard": run(w128, o128, eq_k=128),
        "fast_soft": run(w128, o128, eq_k=128, soft=True),
        "exact_soft": run(w256, o256, eq_k=256, soft=True, exact=True),
        "cs8_hard": run(_codes(w128), o128, eq_k=128, dequant=dq),
    }


def _plain(golden, eq_k, codes=False, **kw):
    win, osc = _window(golden, eq_k)
    if codes:
        win = _codes(win)
        kw["dequant"] = 1.0 / quantize_scale("cs8")
    return teq.eq_fir_plain(torch.tensor(win), torch.tensor(osc), eq_k=eq_k, **kw).numpy()


def _near_boundary(soft: np.ndarray, tol: float) -> np.ndarray:
    """Where a soft level lies within tol of a hard decision boundary."""
    x = (soft + 5.75) * 0.5
    return np.abs(x - np.floor(x) - 0.5) * 2.0 < tol


def test_fast_tier_matches_jax(golden, jax_out):
    """Fast tier: hard symbols identical on golden; soft within 0.04 (the
    fast-tier contract) on both windows; on the random window a hard
    symbol may differ only where the level sits within 0.04 of a decision
    boundary."""
    soft = _plain(golden, 128, soft=True)
    hard = _plain(golden, 128)
    assert soft.dtype == np.float32 and soft.shape == (2, N)
    assert hard.dtype == np.int8 and hard.shape == (2, N)
    np.testing.assert_array_equal(hard[0], jax_out["fast_hard"][0])
    assert np.abs(soft - jax_out["fast_soft"]).max() < 0.04
    diff = hard[1] != jax_out["fast_hard"][1]
    assert not (diff & ~_near_boundary(soft[1], 0.04)).any()


def test_exact_tier_matches_jax(golden, jax_out):
    """Exact tier (fp32, K=256): soft within 1e-5 (the bound of
    tests/test_pallas_kernels.py's exact-tier test) on both windows."""
    soft = _plain(golden, 256, soft=True, exact=True)
    assert np.abs(soft - jax_out["exact_soft"]).max() < 1e-5


def test_cs8_codes_match_jax(golden, jax_out):
    """cs8 integer-code windows dequantize in the kernel: at most 4 hard
    mismatches on golden (the bound of test_pallas_kernels.py's quantized
    window test)."""
    hard = _plain(golden, 128, codes=True)
    assert int((hard[0] != jax_out["cs8_hard"][0]).sum()) <= 4
    soft = _plain(golden, 128, codes=True, soft=True)
    diff = hard[1] != jax_out["cs8_hard"][1]
    assert not (diff & ~_near_boundary(soft[1], 0.04)).any()


def test_soft_codes_are_quantized_soft_levels(golden):
    """soft_q=True gives quantize_soft_levels of the soft output."""
    from atsc_tpu_torch.ops.quantize import quantize_soft_levels

    soft = _plain(golden, 128, soft=True)
    codes = _plain(golden, 128, soft=True, soft_q=True)
    assert codes.dtype == np.int8
    np.testing.assert_array_equal(
        codes, quantize_soft_levels(torch.tensor(soft)).numpy())


@pytest.mark.parametrize("eq_k,dtype", [(128, "bfloat16"), (256, "float32"),
                                        (128, "float32"), (256, "bfloat16")])
def test_band_weights_equal_jax(eq_k, dtype):
    got = teq._band_weights(eq_k, dtype)
    want = jeq._band_weights(eq_k, dtype)
    assert str(got.dtype) == f"torch.{dtype}" and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  want.astype(np.float32))
    assert teq.bands_for(eq_k) == jeq.bands_for(eq_k)


def test_window_contract_equals_jax():
    assert teq.WIN_LEN == jeq.WIN_LEN == jeq.win_len(128) == jeq.win_len(256)


def test_wrapper_routes_cpu_tensors_to_plain(golden):
    """A CPU tensor goes through the plain twin (bit-identical) and
    launches nothing."""
    win, osc = (torch.tensor(a) for a in _window(golden, 128))
    before = teq.LAUNCHES
    got = teq.eq_fir_fused(win, osc, soft=True)
    assert torch.equal(got, teq.eq_fir_plain(win, osc, soft=True))
    assert teq.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "shape", "osc_dtype", "osc_shape",
                                  "eq_k", "tier", "contiguous", "device", "osc_device"])
def test_wrapper_rejects_bad_input(case):
    win = torch.zeros((1, 2, W), dtype=torch.float32)
    osc = torch.zeros((2, W), dtype=torch.float32)
    eq_k, exact = 128, False
    if case == "dtype":
        win = win.to(torch.float64)
    elif case == "shape":
        win = win[..., :-1]
    elif case == "osc_dtype":
        osc = osc.to(torch.float16)
    elif case == "osc_shape":
        osc = osc[:1]
    elif case == "eq_k":
        eq_k = 192
    elif case == "tier":  # the kernel runs K=256 in the exact tier only
        eq_k = 256
    elif case == "contiguous":
        win = torch.zeros((1, W, 2), dtype=torch.float32).transpose(1, 2)
    elif case == "device":
        win, osc = win.to("meta"), osc.to("meta")
    elif case == "osc_device":
        osc = osc.to("meta")
    before = teq.LAUNCHES
    with pytest.raises(ValueError):
        teq.eq_fir_fused(win, osc, eq_k=eq_k, exact=exact)
    assert teq.LAUNCHES == before


def test_cuda_path_without_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the kernel build raises: there is no quiet plain
    fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.build.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("eq_fir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        teq._kernel_lib.__wrapped__(0)
    _build.build.cache_clear()
