"""The port's receiver measurement tools against the JAX package's, on the
CPU: tools/torch_rx_threshold.py against tools/rx_threshold.py (run by
patching sys.argv, as from its command line) and the probe logic of
tools/torch_chip_gauntlet.py against tools/chip_gauntlet.py's (its own
capture and check functions, driving the JAX IqReceiver as its main does)
on a 2-field capture.

The threshold sweep draws the same noise in the same order in both tools,
but the equalized levels differ: the port's zf fast tier rounds its
operands to bf16 as its card kernel does, while the JAX package on XLA:CPU
equalizes in float32 (levels ~1e-3 apart, 0.13 dB of MER on a clean
field), so a noisy level that close to a decision boundary goes the other
way. At the
swept points whether the TS comes back exact, the uncorrectable segments
and the post-RS byte errors are held exactly, and the RS-corrected
segment count within RS_CORRECTED_TOL of JAX's: each flipped symbol can
make one more or one fewer segment need RS; measured 185 against 186 at
20 dB hard and 5 against 5 at 14 dB soft (1 and 0 at 13 and 12 dB)."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RS_CORRECTED_TOL = 3

torch.set_num_threads(2)


def _load(name: str):
    """tools/<name>.py as a module (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(fn) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


# a 2-field capture: the receiver's one-field interleaver latency leaves 1
# decoded field (with 1 field there would be none to judge)
@pytest.mark.parametrize("argv", [
    ["--fields", "2", "--snrs", "20", "--modes", "hard"],
    ["--fields", "2", "--snrs", "14", "--modes", "soft"],
])
def test_rx_threshold_matches_jax(argv, monkeypatch):
    """The port's threshold lines against the JAX tool's, SNR by SNR."""
    port = _load("torch_rx_threshold")
    got = _lines(lambda: port.main([*argv, "--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["rx_threshold.py", *argv])
    monkeypatch.chdir(REPO)
    want = _lines(_load("rx_threshold").main)
    assert len(got) == len(want) == 2
    key = "rs_corrected_segments"
    for g, w in zip(got[:-1], want[:-1]):
        assert abs(g[key] - w[key]) <= RS_CORRECTED_TOL, (g, w)
        assert {**g, key: 0} == {**w, key: 0}
    assert got[-1].pop("device") == "cpu" and got[-1].pop("card") is None
    assert got[-1] == want[-1]
    assert got[0]["exact"] and got[0][key] > 0


@pytest.fixture
def jax_gauntlet():
    """tools/chip_gauntlet.py as a module, with the JAX compilation-cache
    settings its import makes put back afterwards."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield _load("chip_gauntlet")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.mark.parametrize("probe", ["clean_hard", "cs8_hard"])
def test_chip_gauntlet_probe_matches_jax(probe, jax_gauntlet):
    """One probe of the port's gauntlet on a 2-field capture: the JAX
    tool's line for the same probe (its capture, its check), and the sent
    TS back."""
    from atsc_tpu.models.receiver import IqReceiver as JaxReceiver
    from atsc_tpu.ops.quantize import QMAX, quantize_scale

    port = _load("torch_chip_gauntlet")
    ts, iq, rng = port._capture(2, device="cpu")
    run = dict(port._probes(iq, rng, "cpu"))[probe]
    got = _lines(lambda: port._run_probe(probe, run, ts))

    jts, jiq, _ = jax_gauntlet._capture(2)
    np.testing.assert_array_equal(ts, jts)
    assert np.abs(iq - jiq).max() <= 5e-6
    if probe == "cs8_hard":
        codes = np.stack([jiq.real, jiq.imag], axis=-1) * quantize_scale("cs8")
        codes = np.clip(np.round(codes), -QMAX["cs8"], QMAX["cs8"]).astype(np.int8)
        r = JaxReceiver(batch=1, wire_format="cs8")
        decoded = r.push_codes(codes) + r.flush()
    else:
        r = JaxReceiver(batch=1)
        decoded = r.push(jiq) + r.flush()
    want = _lines(lambda: jax_gauntlet._check(probe, decoded, jts))
    assert not any(got[0].pop("launches").values())   # the CPU runs the plain twins
    assert got == want and got[0]["ok"] and got[0]["fields_decoded"] == 1
