"""The fused trellis kernel module of the PyTorch port on the CPU: the plain
twin against the JAX probe's Pallas kernel (interpret mode) over whole
arrays, the stream-order prefix against JAX trellis_encode_field, the
wrapper's routing and refusals, and the port's probe tool. The CUDA kernel
itself is held against the plain twin on the card by chip_smoke.py."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.ops.trellis import trellis_encode_field as jax_trellis
from atsc_tpu_torch.ops.cuda import trellis_fused as tf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    return _tool("trellis_fuse_probe")


def _inputs(seed: int):
    """Seeded (il_pad with random pad bytes, d, d1, d2) as numpy."""
    rng = np.random.default_rng(seed)
    il_pad = rng.integers(0, 256, size=(B, 12, tf.PAD_BYTES), dtype=np.uint8)
    carries = [rng.integers(0, 2, size=(B, 12), dtype=np.int32) for _ in range(3)]
    return il_pad, *carries


@pytest.mark.parametrize("chans", [1, 2])
@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planemajor"])
def test_plain_equals_jax_kernel(jax_probe, interleaved, chans):
    """Whole output arrays, pad bytes included, bit for bit."""
    args = _inputs(40 + chans)
    want = np.asarray(jax_probe.trellis_fused(*map(jnp.asarray, args), chans=chans,
                                              interleaved=interleaved, interpret=True))
    got = tf.trellis_fused_plain(*map(torch.tensor, args), interleaved=interleaved).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planemajor"])
def test_stream_prefix_equals_jax_encoder_over_two_fields(interleaved):
    """Two chained fields: the stream-order cut equals JAX
    trellis_encode_field, with JAX's carries handed from field to field."""
    rng = np.random.default_rng(7)
    nb = P.TRELLIS_BYTES_PER_ENCODER
    carries = [jnp.asarray(rng.integers(0, 2, size=(B, 12), dtype=np.int32))
               for _ in range(3)]
    for _ in range(2):
        il_pad = rng.integers(0, 256, size=(B, 12, tf.PAD_BYTES), dtype=np.uint8)
        sym, *next_carries = jax_trellis(jnp.asarray(il_pad[..., :nb]), *carries)
        got = tf.trellis_fused_plain(torch.tensor(il_pad),
                                     *(torch.tensor(np.asarray(c)) for c in carries),
                                     interleaved=interleaved)
        assert np.array_equal(tf.to_stream(got, interleaved).numpy(), np.asarray(sym))
        carries = next_carries


def test_wrapper_routes_cpu_tensors_to_plain():
    args = [torch.tensor(a) for a in _inputs(3)]
    before = tf.LAUNCHES
    for interleaved in (True, False):
        got = tf.trellis_fused(*args, interleaved=interleaved)
        assert torch.equal(got, tf.trellis_fused_plain(*args, interleaved=interleaved))
    assert tf.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "shape", "carry_dtype", "carry_shape",
                                  "contiguous", "mixed_devices", "device"])
def test_wrapper_rejects_bad_input(case):
    il_pad, d, d1, d2 = (torch.tensor(a) for a in _inputs(5))
    if case == "dtype":
        il_pad = il_pad.to(torch.int8)
    elif case == "shape":
        il_pad = il_pad[..., : P.TRELLIS_BYTES_PER_ENCODER].contiguous()
    elif case == "carry_dtype":
        d1 = d1.to(torch.int64)
    elif case == "carry_shape":
        d2 = d2[:, :6].contiguous()
    elif case == "contiguous":
        d = torch.zeros((12, B), dtype=torch.int32).t()
    elif case == "mixed_devices":
        d = d.to("meta")
    elif case == "device":
        il_pad, d, d1, d2 = (t.to("meta") for t in (il_pad, d, d1, d2))
    before = tf.LAUNCHES
    with pytest.raises(ValueError):
        tf.trellis_fused(il_pad, d, d1, d2)
    assert tf.LAUNCHES == before


def test_probe_tool_on_cpu(capsys):
    """The port's probe on the CPU: both layouts bit-exact, then the
    reference line."""
    rc = _tool("torch_trellis_fuse_probe").main(
        ["--device", "cpu", "--batch", "2", "--iters", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [ln["layout"] for ln in lines] == ["interleaved", "planemajor", "torch_reference"]
    assert all(ln["bit_exact"] is True for ln in lines[:2])
    assert all(ln["ms_to_stream"] > 0 for ln in lines)
