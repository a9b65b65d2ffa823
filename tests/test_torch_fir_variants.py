"""The offset+FIR design-variant module of the PyTorch port on the CPU: the
plain twin of every probe run against the JAX probe's Pallas kernel
(interpret mode) and against the JAX offset_fir_fused, the wrapper's
routing and refusals, the port's probe tool, and the refusal to build
either new kernel without nvcc. The CUDA kernels themselves are held
against their plain twins on the card by chip_smoke.py."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.ops.offset import _scale_planar
from atsc_tpu.ops.pallas.offset_fir import offset_fir_fused as jax_offset_fir
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.cuda import fir_variants as fv
from atsc_tpu_torch.ops.cuda import trellis_fused as tf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = P.SYMBOLS_PER_FIELD
TOL = 2e-6  # float32 sums in another order (and FMA contraction in JAX)
# the probe's runs through run_variant: (variant, nchunk)
CASES = [("base", 15), ("base", 17), ("onedot", 5), ("sharedmod", 5),
         ("combo", 5), ("combo", 15), ("base", 5)]


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    return _tool("fir_probe")


@pytest.fixture(scope="module")
def inputs(golden):
    """Golden field 0 as int8 symbol values (padding tail 0) and the
    field-1 phasor, numpy, B=1."""
    levels = golden["sync"][:1].real.astype(np.float32)
    sym = np.rint((levels - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    sym[..., P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS:] = 0
    return sym, _scale_planar()[None].astype(np.float32)


@pytest.fixture(scope="module")
def jax_base(inputs):
    return np.asarray(jax_offset_fir(*map(jnp.asarray, inputs), interpret=True))


@pytest.mark.parametrize("variant,nchunk", CASES, ids=[f"{v}-{n}" for v, n in CASES])
def test_plain_matches_jax_variant_and_offset_fir(jax_probe, inputs, jax_base, variant,
                                                  nchunk):
    """Within 2e-6 of JAX run_variant (whole array) and of JAX
    offset_fir_fused cf32 over the valid [0, 260416)."""
    want = np.asarray(jax_probe.run_variant(
        *map(jnp.asarray, inputs), variant, nchunk, interpret=True))
    got = fv.run_variant_plain(*map(torch.tensor, inputs), variant, nchunk).numpy()
    assert got.shape == want.shape == (1, 2, P.PADDED_OUT) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got[..., :N] - jax_base[..., :N]).max() <= TOL


def test_wrapper_routes_cpu_tensors_to_plain(inputs):
    field, phasor = map(torch.tensor, inputs)
    before = fv.LAUNCHES
    got = fv.run_variant(field, phasor, "combo", 15)
    assert torch.equal(got, fv.run_variant_plain(field, phasor, "combo", 15))
    assert fv.LAUNCHES == before


@pytest.mark.parametrize("case", ["variant", "nchunk", "nchunk_zero", "shape", "dtype",
                                  "phasor", "device"])
def test_wrapper_rejects_bad_input(case):
    field = torch.zeros((1, P.PADDED_SYMBOLS), dtype=torch.int8)
    phasor = torch.zeros((1, 2), dtype=torch.float32)
    variant, nchunk = "base", 5
    if case == "variant":
        variant = "fused"
    elif case == "nchunk":
        nchunk = 7          # 2040 / 7 leaves rows unwritten
    elif case == "nchunk_zero":
        nchunk = 0
    elif case == "shape":
        field = field[:, : P.PADDED_OUT].contiguous()
    elif case == "dtype":
        field = field.to(torch.uint8)
    elif case == "phasor":
        phasor = torch.zeros((2, 2), dtype=torch.float32)
    elif case == "device":
        field, phasor = field.to("meta"), phasor.to("meta")
    before = fv.LAUNCHES
    with pytest.raises(ValueError):
        fv.run_variant(field, phasor, variant, nchunk)
    if case != "device":
        with pytest.raises(ValueError):
            fv.run_variant_plain(field, phasor, variant, nchunk)
    assert fv.LAUNCHES == before


def test_probe_tool_on_cpu(capsys):
    """The port's probe on the CPU: the JAX probe's seven runs, none an
    error, each within 2e-6 of the base line."""
    rc = _tool("torch_fir_probe").main(["--device", "cpu", "--batch", "1", "--iters", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [ln["variant"] for ln in lines] == [
        "base", "base_chunks15", "base_chunks17", "onedot", "sharedmod", "combo",
        "combo_chunks15"]
    assert not any("error" in ln for ln in lines)
    assert all(0.0 <= ln["max_err"] <= TOL and ln["ms"] > 0 for ln in lines)


@pytest.mark.parametrize("module", [fv, tf], ids=["fir_variants", "trellis_fused"])
def test_kernel_build_without_nvcc_raises(module, monkeypatch, tmp_path):
    """Without nvcc the kernel build raises: no quiet plain fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.build.cache_clear()
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            module._kernel_lib.__wrapped__()
    finally:
        _build.build.cache_clear()
        _build.load.cache_clear()
