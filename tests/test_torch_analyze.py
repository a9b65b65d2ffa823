"""`analyze` and mer_db of the PyTorch port against the JAX package's, on the
CPU: the same seeded captures (made by the port's CPU encoder) through both
packages' run_analyze. The JAX side runs its zf equalizer as on the TPU,
through the Pallas eq_fir kernel in interpret mode (as
tests/test_pallas_kernels.py runs it), whose fast tier rounds its operands
to bf16 as the port's kernel and its plain twin do; XLA:CPU's unfused step
sums float32 operands and reads ~0.1 dB more MER on a clean field.

Tolerances: integers, mer_method, decodable, ntsc_detected and
decode_flags exact; sro_ppm within 0.002 ppm, cfo_hz within 0.02 Hz,
mer_db and mer_clean_db within 0.05 dB (the captures sit well away from
the 15.2 and 20 dB gates)."""

import contextlib
import functools
import io
import json
import sys

import numpy as np
import pytest
import torch

from atsc_tpu import cli as jcli
from atsc_tpu.models import receiver as jrx
from atsc_tpu.ops.pallas import eq_fir as jeq
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch import params as P
from atsc_tpu_torch.models import receiver as trx
from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
from atsc_tpu_torch.utils.config import EncoderConfig

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
#: key -> absolute tolerance; every other key of a report is held exactly
_TOL = {"sro_ppm": 0.002, "cfo_hz": 0.02, "mer_db": 0.05, "mer_clean_db": 0.05,
        "rms": 1e-5}


def _random_ts(rng, t: int, b: int = 1) -> np.ndarray:
    ts = rng.integers(0, 256, size=(t, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _encode(ts: np.ndarray) -> np.ndarray:
    """(F, 1, 58656) TS -> (F*N,) complex128 through the port's CPU encoder."""
    enc = Encoder(batch=1, device="cpu")
    return np.concatenate([iq_to_complex(enc.encode(ts[k]))[0]
                           for k in range(ts.shape[0])]).astype(np.complex128)


def _write(path, y: np.ndarray) -> str:
    np.stack([y.real, y.imag], -1).astype(np.float32).tofile(path)
    return str(path)


def _clean(tmp):
    return _write(tmp / "clean.iq", _encode(_random_ts(np.random.default_rng(41), 4))), []


def _impaired(tmp):
    """tests/test_signal_quality.py's: a mid-field start, 250 Hz, 30 ppm,
    28 dB AWGN."""
    rng = np.random.default_rng(43)
    iq = _encode(_random_ts(rng, 5))
    cut = 7_000
    y = iq[cut:] * np.exp(2j * np.pi * 250.0 / P.SAMPLE_RATE * np.arange(iq.size - cut))
    y = trx.resample_stream(y, 1.0 / (1.0 + 30e-6))[0]
    p = float(np.mean(np.abs(y) ** 2))
    y = y + (rng.normal(size=y.size) + 1j * rng.normal(size=y.size)) * np.sqrt(
        p / 10 ** 2.8 / 2.0)
    return _write(tmp / "impaired.iq", y), []


def _rate(tmp):
    """A 20 MS/s capture written by the port's `encode --rate 20e6`."""
    src = tmp / "in.ts"
    _random_ts(np.random.default_rng(53), 4)[:, 0].tofile(src)
    cap = tmp / "cap20.iq"
    tcli.run(EncoderConfig(sink=str(cap), rate=20e6), [str(src)], device="cpu")
    return str(cap), ["--rate", "20e6", "--fields", "3"]


def _frame_cut(tmp):
    """Cut at a frame boundary (2 fields in): offset 0, parity 0, the
    oscillator ~pi off, so the zf MER falls back to the adaptive one."""
    return _write(tmp / "frame.iq", _encode(_random_ts(np.random.default_rng(59), 6))[2 * N:]), []


def _burst(tmp):
    """A 3,000-sample x6 impulse burst inside the measured field."""
    rng = np.random.default_rng(11)
    iq = _encode(_random_ts(rng, 4))
    iq[40_000:43_000] += (rng.normal(size=3000) + 1j * rng.normal(size=3000)) * 6.0
    return _write(tmp / "burst.iq", iq), []


def _ntsc(tmp):
    """A co-channel tone at the comb's first null, 0.05x the signal RMS."""
    iq = _encode(_random_ts(np.random.default_rng(83), 4))
    n = np.arange(iq.size)
    f = P.SAMPLE_RATE / 12 + P.OSC_FREQUENCY
    rms = np.sqrt(np.mean(np.abs(iq) ** 2))
    return _write(tmp / "ntsc.iq",
                  iq + 0.05 * rms * np.exp(2j * np.pi * f * n / P.SAMPLE_RATE + 0.4j)), []


def _demux(tmp):
    """A B=2 multiplex written by the port's `encode --mux`."""
    ts = _random_ts(np.random.default_rng(47), 4, 2)
    paths = []
    for ch in range(2):
        paths.append(str(tmp / f"in{ch}.ts"))
        ts[:, ch].tofile(paths[-1])
    cap = tmp / "wide.iq"
    tcli.run(EncoderConfig(channels=2, mux=True, sink=str(cap)), paths, device="cpu")
    return str(cap), ["--demux", "2", "--fields", "3"]


#: capture -> (maker, what the report must say)
CAPTURES = {
    "clean": (_clean, dict(mer_method="zf", decode_flags="")),
    "impaired": (_impaired, dict(mer_method="adaptive",
                                 decode_flags="--sro auto --cfo auto --align auto")),
    "rate20e6": (_rate, dict(mer_method="adaptive", decode_flags="--rate 20e6 --align auto")),
    "frame_cut": (_frame_cut, dict(mer_method="adaptive", decode_flags="--equalizer adaptive")),
    "burst": (_burst, dict(mer_method="zf", decode_flags="--erasures burst")),
    "ntsc": (_ntsc, dict(mer_method="zf", ntsc_detected=True, decode_flags="--ntsc auto")),
    "demux2": (_demux, dict(slots=2, decode_flags="--demux 2")),
}


@pytest.fixture
def jax_fused_eq(monkeypatch):
    """The JAX package's zf equalizer through its Pallas kernel, interpreted."""
    monkeypatch.setenv("ATSC_TPU_FUSED", "1")
    monkeypatch.setattr(jeq, "eq_fir_fused", functools.partial(jeq.eq_fir_fused,
                                                               interpret=True))
    jrx.device_eq_step.cache_clear()
    yield
    jrx.device_eq_step.cache_clear()


def _assert_same(got, want, where: str = "") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), f"{where}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif where.rsplit(".", 1)[-1] in _TOL:
        assert abs(got - want) <= _TOL[where.rsplit(".", 1)[-1]], f"{where}: {got} vs {want}"
    else:
        assert type(got) is type(want) and got == want, f"{where}: {got!r} vs {want!r}"


@pytest.mark.parametrize("name", list(CAPTURES))
def test_analyze_matches_jax(name, tmp_path, jax_fused_eq):
    make, expect = CAPTURES[name]
    cap, extra = make(tmp_path)
    got = tcli.run_analyze(tcli.build_analyze_argparser().parse_args(
        [cap, "--device", "cpu", *extra]))
    want = jcli.run_analyze(jcli.build_analyze_argparser().parse_args([cap, *extra]))
    _assert_same(got, want, name)
    for k, v in expect.items():
        assert got[k] == v, (k, got)
    reports = got.get("per_slot", [got])
    assert all(r["decodable"] and r["mer_db"] > 22 for r in reports), got


def test_mer_db_matches_jax(golden):
    """mer_db on golden levels with seeded noise, float32 and float64, and
    on a tensor, within 1e-4 dB of the JAX package's."""
    rng = np.random.default_rng(3)
    lev = golden["sync"][:2].real.astype(np.float64)
    for sigma in (0.05, 0.3):
        noisy = lev + rng.normal(0, sigma, lev.shape)
        for arr in (noisy, noisy.astype(np.float32)):
            want = jrx.mer_db(arr)
            assert np.abs(trx.mer_db(arr) - want).max() <= 1e-4
            assert np.abs(trx.mer_db(torch.from_numpy(arr)) - want).max() <= 1e-4


def test_cli_analyze_prints_the_report(tmp_path):
    """`analyze` through main prints run_analyze's report as one JSON line;
    -d/-f/-g parse; the soapy source, where the SoapySDR bindings are
    absent, stops with the JAX package's RuntimeError; a --rate too narrow
    for the band is refused with the JAX CLI's message."""
    cap, _ = _clean(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["analyze", cap, "--device", "cpu", "-d", "lime", "-f", "5e8",
                          "-g", "10"]) == 0
    report = json.loads(out.getvalue())
    assert report["mer_method"] == "zf" and report["decode_flags"] == ""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "SoapySDR", None)   # the import fails
        with pytest.raises(RuntimeError, match="SoapySDR python bindings not available"):
            tcli.main(["analyze", "soapy", "-d", "hackrf", "--device", "cpu"])
    with pytest.raises(ValueError, match="occupied"):
        tcli.run_analyze(tcli.build_analyze_argparser().parse_args(
            [cap, "--rate", "5e6", "--device", "cpu"]))
