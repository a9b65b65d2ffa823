"""The offset+FIR kernel module of the PyTorch port on the CPU: the plain
twin against the JAX Pallas kernel (interpret mode), the wrapper's routing,
and its refusals. The CUDA kernel itself is held against the plain twin on
the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.ops.offset import _scale_planar
from atsc_tpu.ops.pallas.offset_fir import offset_fir_fused as jax_offset_fir
from atsc_tpu.ops.quantize import unpack_wire
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.cuda import offset_fir as fir

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD


def _golden_symbols(golden) -> np.ndarray:
    """Golden fields 0-1 (sync stage, float levels) -> int8 symbol values;
    the 12-sample padding tail (level 0.0) is stored as symbol 0."""
    levels = golden["sync"][:2].real.astype(np.float32)
    sym = np.rint((levels - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    sym[..., P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS:] = 0
    return sym


def _phasors() -> np.ndarray:
    s = _scale_planar()
    return np.array([[1.0, 0.0], [s[0], s[1]]], dtype=np.float32)


def test_plain_cf32_matches_jax_kernel_and_golden(golden):
    """cf32 within 2e-6 of the Pallas kernel (interpret mode) and within
    5e-6 of golden IQ, over the valid [0, 260416)."""
    sym, ph = _golden_symbols(golden), _phasors()
    got = fir.offset_fir_plain(torch.tensor(sym), torch.tensor(ph)).numpy()
    want = np.asarray(jax_offset_fir(jnp.asarray(sym), jnp.asarray(ph),
                                     interpret=True))
    assert got.shape == (2, 2, P.PADDED_OUT) and got.dtype == np.float32
    assert np.abs(got[..., :N] - want[..., :N]).max() <= 2e-6
    got_c = (got[:, 0, :N] + 1j * got[:, 1, :N]).astype(np.complex64)
    assert np.abs(got_c - golden["iq"][:2]).max() <= 5e-6


@pytest.mark.parametrize("fmt,wire", [("cs16", False), ("cs8", False),
                                      ("cs16", True), ("cs8", True)])
def test_plain_quantized_matches_jax_kernel(golden, fmt, wire):
    """cs16/cs8 codes, planar or packed wire lanes: within 1 LSB of the
    Pallas kernel (they rotate by the phasor at different points, so a
    code may sit on the other side of a rounding boundary)."""
    sym, ph = _golden_symbols(golden), _phasors()
    got = fir.offset_fir_plain(torch.tensor(sym), torch.tensor(ph),
                               out_format=fmt, wire=wire).numpy()
    want = np.asarray(jax_offset_fir(jnp.asarray(sym), jnp.asarray(ph),
                                     interpret=True, out_format=fmt, wire=wire))
    shape, dtype = fir.output_spec(2, fmt, wire)
    assert got.shape == shape and got.dtype == torch.empty(0, dtype=dtype).numpy().dtype
    if wire:
        got, want = unpack_wire(got, fmt), unpack_wire(want, fmt)
    diff = np.abs(got[..., :N].astype(np.int32) - want[..., :N].astype(np.int32))
    assert diff.max() <= 1


def test_wrapper_routes_cpu_tensors_to_plain(golden):
    """A CPU tensor goes through the plain twin (bit-identical) and launches
    nothing."""
    sym, ph = torch.tensor(_golden_symbols(golden)), torch.tensor(_phasors())
    before = fir.LAUNCHES
    got = fir.offset_fir_fused(sym, ph, out_format="cs8", wire=True)
    assert torch.equal(got, fir.offset_fir_plain(sym, ph, out_format="cs8", wire=True))
    assert fir.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "shape", "phasor", "format", "cf32_wire",
                                  "contiguous", "device"])
def test_wrapper_rejects_bad_input(case):
    field = torch.zeros((2, P.PADDED_SYMBOLS), dtype=torch.int8)
    phasor = torch.zeros((2, 2), dtype=torch.float32)
    fmt, wire = "cf32", False
    if case == "dtype":
        field = field.to(torch.int16)
    elif case == "shape":
        field = field[:, :-1]
    elif case == "phasor":
        phasor = phasor.to(torch.float64)
    elif case == "format":
        fmt = "cs4"
    elif case == "cf32_wire":
        wire = True
    elif case == "contiguous":
        field = torch.zeros((P.PADDED_SYMBOLS, 2), dtype=torch.int8).t()
    elif case == "device":
        field, phasor = field.to("meta"), phasor.to("meta")
    before = fir.LAUNCHES
    with pytest.raises(ValueError):
        fir.offset_fir_fused(field, phasor, out_format=fmt, wire=wire)
    assert fir.LAUNCHES == before


def test_a_misaligned_field_is_accepted():
    """A field that does not start on a 4-byte boundary (a view one byte
    in) is taken as it is (the CUDA path copies it first, since the kernel
    stages the field 4 symbols at a time) and gives the aligned output."""
    rng = np.random.default_rng(3)
    buf = torch.tensor(rng.integers(0, 8, P.PADDED_SYMBOLS + 1), dtype=torch.int8)
    field = buf[1:].view(1, -1)
    phasor = torch.tensor([[0.6, 0.8]], dtype=torch.float32)
    assert field.data_ptr() % 4
    got = fir.offset_fir_fused(field, phasor, "cs16", wire=True)
    want = fir.offset_fir_fused(field.clone(), phasor, "cs16", wire=True)
    assert torch.equal(got, want)


def test_cuda_path_without_cuda_raises(monkeypatch, tmp_path):
    """Without nvcc the kernel build raises (no quiet plain fallback), and
    asking the encoder for CUDA without a card raises."""
    from atsc_tpu_torch.models.encoder import Encoder

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.build.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("offset_fir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fir._kernel_lib.__wrapped__(0)
    _build.build.cache_clear()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Encoder(batch=1, device="cuda")


def test_module_imports_without_nvcc_or_gpu(tmp_path):
    """Importing the wrapper needs no nvcc and no GPU, and builds nothing."""
    import os
    import subprocess
    import sys

    code = ("import atsc_tpu_torch.ops.cuda.offset_fir as m\n"
            "from atsc_tpu_torch.ops.cuda import _build\n"
            "assert m.LAUNCHES == 0\n"
            "assert _build.build.cache_info().currsize == 0\n"
            "print('imported')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(tmp_path))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr
