"""The port's streaming resampler (atsc_tpu_torch/ops/resample.py) and the
CLI paths that use it (`encode --rate/--ppm`, `decode --rate`, numeric
`--sro`), on the CPU, held against the JAX package on the same seeded
inputs, with tests/test_resample.py's cases.

Tolerances, on unit-RMS input: the port's output within 1e-6 of JAX's
StreamResampler (measured 4.8e-7: XLA:CPU fuses the 32-tap multiply-add
chain, the port rounds each product and each sum in tap order), within
1e-5 of the float64 whole-capture `resample_stream`, and bit-identical to
itself under any chunking.
"""

import contextlib
import io
import json
from fractions import Fraction

import numpy as np
import pytest
import torch

from atsc_tpu import cli as jcli
from atsc_tpu import params as P
from atsc_tpu.ops import resample as jrs
from atsc_tpu.utils.config import EncoderConfig
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch.models.receiver import resample_stream
from atsc_tpu_torch.ops import resample as trs
from atsc_tpu_torch.ops.resample import SYMBOL_RATE_FRACTION, StreamResampler, capture_rate
from atsc_tpu_torch.utils.config import EncoderConfig as TEncoderConfig
from atsc_tpu_torch.utils.convert import stream_resampler_from_numpy

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
JAX_TOL = 1e-6       # port against JAX's StreamResampler
WHOLE_TOL = 1e-5     # port against the float64 resample_stream


def _noise(seed: int, shape) -> np.ndarray:
    """Unit-RMS complex64 white noise."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _run(rs, iq) -> np.ndarray:
    return np.concatenate([rs.push(iq), rs.flush()], axis=-1)


def test_kernel_table_and_rates_match_jax():
    np.testing.assert_array_equal(trs._kernel_table(), jrs._kernel_table())
    for sps in (16_000_000, 20e6, Fraction(12_000_000), 10_762_237.76):
        assert trs.capture_rate(sps) == jrs.capture_rate(sps)
        assert trs.output_rate(sps) == jrs.output_rate(sps)
    assert trs.SYMBOL_RATE_FRACTION == jrs.SYMBOL_RATE_FRACTION


def test_stream_matches_whole_capture_and_jax():
    """tests/test_resample.py:19: one shot through the port's resampler
    against resample_stream and against JAX's StreamResampler, on every
    sample each emits."""
    iq = _noise(11, 120_000)
    rate = 1.0 + 37e-6
    got = _run(StreamResampler(rate, batch=1, device="cpu"), iq[None])
    want = _run(jrs.StreamResampler(rate, batch=1), iq[None])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= JAX_TOL
    ref = resample_stream(iq, rate)
    assert got.shape[1] >= ref.shape[1]
    np.testing.assert_allclose(got[:, : ref.shape[1]], ref, atol=WHOLE_TOL)


def test_stream_chunked_equals_one_shot():
    """tests/test_resample.py:39: push boundaries are invisible: any
    chunking emits bit-identical output."""
    iq = _noise(12, (2, 100_000))
    rate = capture_rate(16_000_000)
    ref = _run(StreamResampler(rate, batch=2, device="cpu"), iq)
    chunked = StreamResampler(rate, batch=2, device="cpu")
    outs, pos = [], 0
    for c in (1, 999, 65_536, 17, 33_447):
        outs.append(chunked.push(iq[:, pos:pos + c]))
        pos += c
    outs.append(chunked.push(iq[:, pos:]))
    outs.append(chunked.flush())
    got = np.concatenate(outs, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert np.abs(ref - _run(jrs.StreamResampler(rate, batch=2), iq)).max() <= JAX_TOL


def test_exact_rational_position_never_drifts():
    """tests/test_resample.py:61: after 10^8 outputs the interpolation point
    equals the closed form exactly, as JAX's does."""
    rate = capture_rate(20_000_000)
    assert rate == Fraction(2860, 1539)
    rs = StreamResampler(rate, batch=1, device="cpu")
    n = 100_000_000
    base, ph = rs._pos(n)
    assert (base, ph) == jrs.StreamResampler(rate, batch=1)._pos(n)
    exact = Fraction(2860, 1539) * n + 16
    assert base == exact.numerator // exact.denominator
    assert ph == min(round((exact - base) * 512), 511)
    assert capture_rate(SYMBOL_RATE_FRACTION) == 1


def test_state_roundtrip_resumes_bit_identically():
    """tests/test_resample.py:80: state()/load_state() + re-reading the
    input from in_base continues the emission bit-identically."""
    iq = _noise(13, 150_000)[None]
    rs = StreamResampler((2860, 1539), batch=1, device="cpu")
    rs.push(iq[:, :70_000])
    st = rs.state()
    cont = np.concatenate([rs.push(iq[:, 70_000:]), rs.flush()], axis=-1)
    rs2 = StreamResampler.load_state(st, device="cpu")
    cont2 = np.concatenate([rs2.push(iq[:, st["in_base"]:]), rs2.flush()], axis=-1)
    np.testing.assert_array_equal(cont, cont2)
    assert rs2.in_consumed == iq.shape[1] + trs.TAPS + 2


def test_push_planar_matches_push():
    """tests/test_resample.py:128: push_planar (numpy, or a tensor such as
    the encoder's output) emits what the complex push emits."""
    iq = _noise(21, (3, 80_000))
    want = _run(StreamResampler((1539, 2000), batch=3, device="cpu"), iq)
    planar = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    for src in (planar, torch.from_numpy(planar)):
        b = StreamResampler((1539, 2000), batch=3, device="cpu")
        got = np.concatenate([b.push_planar(src), b.flush_planar()], axis=-1)
        np.testing.assert_array_equal(got[:, 0] + 1j * got[:, 1], want)
    with pytest.raises(ValueError, match="want planar"):
        b = StreamResampler((1539, 2000), batch=3, device="cpu")
        b.push_planar(planar[:2])


def test_flushed_state_refuses_resume():
    """tests/test_resample.py:306: a post-flush full_state carries flushed=1
    and load_full_state refuses it; push after flush raises."""
    rs = StreamResampler(Fraction(10_762_238, 12_000_000), batch=1, device="cpu")
    rs.push_planar(np.zeros((1, 2, 4096), np.float32))
    mid = rs.full_state()
    assert int(mid["flushed"]) == 0
    StreamResampler.load_full_state(mid, device="cpu")
    rs.flush_planar()
    post = rs.full_state()
    assert int(post["flushed"]) == 1
    with pytest.raises(ValueError, match="flush"):
        StreamResampler.load_full_state(post, device="cpu")
    with pytest.raises(RuntimeError):
        rs.push_planar(np.zeros((1, 2, 8), np.float32))
    assert rs.flush_planar().shape == (1, 2, 0)


def test_jax_full_state_continues_in_port():
    """A JAX StreamResampler stopped mid-stream continues in the port
    (utils/convert.py): the same position and window, the same next
    outputs within JAX_TOL, and the same count."""
    iq = _noise(23, (2, 90_000))
    planar = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    rate = jrs.output_rate(16e6)
    j = jrs.StreamResampler(rate, batch=2)
    j.push_planar(planar[..., :41_234])
    t = stream_resampler_from_numpy(j.full_state(), device="cpu")
    assert (t.num, t.den, t.out_next, t.in_base, t.in_consumed) == (
        j.num, j.den, j.out_next, j.in_base, j.in_consumed)
    got = np.concatenate([t.push_planar(planar[..., 41_234:]), t.flush_planar()], -1)
    want = np.concatenate([j.push_planar(planar[..., 41_234:]), j.flush_planar()], -1)
    assert got.shape == want.shape and np.abs(got - want).max() <= JAX_TOL
    with pytest.raises(ValueError, match="flush"):
        stream_resampler_from_numpy(j.full_state(), device="cpu")
    bad = dict(j.full_state(), flushed=0, buf=np.zeros((3, 2, 5), np.float32))
    with pytest.raises(ValueError, match="buffer"):
        stream_resampler_from_numpy(bad, device="cpu")


# -- the CLI paths -------------------------------------------------------------


def _random_ts(seed: int, t: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=(t, P.FIELD_TS_BYTES),
                                              dtype=np.uint8)
    ts[:, :: P.MPEG2_BYTES] = 0x47
    return ts


def _decode_both(tmp_path, cap, flags: list) -> tuple[bytes, dict, bytes, dict]:
    """Port decode on the CPU and JAX decode of one capture: (port TS, port
    summary without `device`, JAX TS, JAX summary)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main(["decode", str(cap), *flags, "-o", str(tmp_path / "port.ts"),
                          "--device", "cpu", "--stats"]) == 0
    got = json.loads(err.getvalue().strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    want = jcli.run_decode(jcli.build_decode_argparser().parse_args(
        [str(cap), *flags, "-o", str(tmp_path / "jax.ts"), "--stats"]))
    return ((tmp_path / "port.ts").read_bytes(), got,
            (tmp_path / "jax.ts").read_bytes(), want)


@pytest.mark.parametrize("flags, decode_flags", [
    (["--rate", "16e6"], ["--rate", "16e6"]),     # tests/test_resample.py:147
    (["--ppm", "37"], ["--sro", "37"]),           # tests/test_resample.py:229
])
def test_cli_encode_resampled_then_decode_match_jax(tmp_path, flags, decode_flags):
    """`encode --rate 16e6` / `--ppm 37` on the port gives the JAX CLI's
    capture (same length, samples within 1e-5: the encoders' IQ agree to
    5e-6) and --stats rate; `decode --rate 16e6` / `--sro 37` of it gives
    the JAX CLI's TS file and summary (mer_db within 0.5 dB, the adaptive
    levels' 1e-3), and the sent TS."""
    ts = _random_ts(211, 5)
    src = tmp_path / "in.ts"
    ts.tofile(src)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main([str(src), "-o", str(tmp_path / "cap.iq"), *flags,
                          "--device", "cpu", "--stats"]) == 0
    enc = json.loads(err.getvalue().strip().splitlines()[-1])
    assert jcli.main([str(src), "-o", str(tmp_path / "jcap.iq"), *flags]) == 0
    got = np.fromfile(tmp_path / "cap.iq", np.float32)
    want = np.fromfile(tmp_path / "jcap.iq", np.float32)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    target = (16e6 if "--rate" in flags else float(SYMBOL_RATE_FRACTION * (1 + Fraction(37) / 10**6)))
    assert enc["output_rate"] == target and enc["fields"] == 5
    assert abs(got.size / 2 - 5 * N * target / P.SAMPLE_RATE) < 64

    out, s, jout, sj = _decode_both(tmp_path, tmp_path / "cap.iq", decode_flags)
    assert out == jout
    assert abs(s.pop("mer_db")[0] - sj.pop("mer_db")[0]) <= 0.5
    assert s == sj
    assert s["segments_uncorrectable"] == 0 and s["fields_decoded"] >= 2
    assert out == ts[1 : 1 + s["fields_decoded"]].tobytes()


@pytest.mark.parametrize("kw", [dict(rate=16e6, out_format="cs8"), dict(rate=4e6),
                                dict(channels=2, rate=16e6), dict(channels=2, ppm=30.0)])
def test_cli_encode_rate_validation_matches_jax(kw):
    """tests/test_resample.py:264,329: quantized formats, a clock below the
    occupied band and several channels without --mux are refused with the
    JAX CLI's messages."""
    with pytest.raises(ValueError) as port:
        tcli.run(TEncoderConfig(**kw), ["/dev/null"], device="cpu")
    with pytest.raises(ValueError) as ref:
        jcli.run(EncoderConfig(**kw), ["/dev/null"])
    assert str(port.value) == str(ref.value)
