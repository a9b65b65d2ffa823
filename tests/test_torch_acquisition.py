"""The port's capture conditioning on the CPU, held against the JAX
package on the same seeded captures: the host estimators
(find_field_sync(_iq), estimate_cfo, estimate_sro, resample_stream,
CfoCorrector) give identical offsets, parities, rates, Hz and samples
(both are the same float64 numpy), and the decode CLI's conditioning flags
(--align, --cfo auto/track, --sro auto, --resync, the full gauntlet of
tests/test_gauntlet.py) give the JAX CLI's TS file and summary.

The captures are tests/test_adaptive_eq.py's, tests/test_resync.py's and
tests/test_gauntlet.py's, encoded by the port's CPU encoder (both sides
read the same bytes). JAX's Decoder corrects flagged fields with
rs_correct_field_erasures_jit, whose XLA:CPU compile runs past 15
minutes; the gauntlet runs that function eagerly on the JAX side (the
same integers), as tests/test_torch_receiver.py does.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from atsc_tpu import cli as jcli
from atsc_tpu import params as P
from atsc_tpu.models import decoder as jdec
from atsc_tpu.models import receiver as jrx
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch.models import receiver as trx

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD


def _random_ts(rng, t, b) -> np.ndarray:
    ts = rng.integers(0, 256, size=(t, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _encode(ts: np.ndarray) -> np.ndarray:
    """(T, B, 58656) -> (B, T*N) complex64 through the port's CPU encoder."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    enc = Encoder(batch=ts.shape[1], device="cpu")
    return np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(ts.shape[0])], -1)


def _write_cf32(path, y: np.ndarray) -> None:
    np.stack([y.real, y.imag], axis=-1).astype(np.float32).tofile(path)


# -- the host estimators -----------------------------------------------------


@pytest.fixture(scope="module")
def rotated():
    """tests/test_adaptive_eq.py:102's capture: 3 fields through a 90-degree
    rotation plus an echo."""
    iq = _encode(_random_ts(np.random.default_rng(67), 3, 1))[0]
    return np.convolve(iq, [1j, 0, 0, 0.2 * np.exp(0.3j)])[: iq.size]


@pytest.mark.parametrize("cut, want_off, want_par", [(0, 0, 0), (1000, N - 1000, 1),
                                                     (N + 7, N - 7, 0)])
def test_find_field_sync_iq_matches_jax(rotated, cut, want_off, want_par):
    got = trx.find_field_sync_iq(rotated[cut:])
    assert got == jrx.find_field_sync_iq(rotated[cut:]) == (want_off, want_par)


def test_find_field_sync_on_levels_matches_jax(golden):
    """The real-projection correlator on equalized levels (golden sync
    stage), from a mid-field start: the same offset and parity."""
    levels = golden["sync"][:3, :N].real.reshape(-1)
    for cut in (0, 5000, N + 31):
        got = trx.find_field_sync(levels[cut:])
        assert got == jrx.find_field_sync(levels[cut:])
        assert got[0] == (N - cut) % N


@pytest.mark.parametrize("cfo", [517.3, -1204.8, 0.0])
def test_estimate_cfo_matches_jax(cfo):
    """tests/test_adaptive_eq.py:153: the same Hz, bit for bit, and within
    1 Hz of the offset put in."""
    iq = _encode(_random_ts(np.random.default_rng(73), 2, 1))[0]
    y = iq * np.exp(2j * np.pi * cfo / P.SAMPLE_RATE * np.arange(iq.size))
    got = trx.estimate_cfo(y)
    assert got == jrx.estimate_cfo(y)
    assert abs(got - cfo) < 1.0


def test_estimate_sro_and_resample_stream_match_jax():
    """tests/test_adaptive_eq.py:194: the same rate estimate (no offset and
    37 ppm) and the same resampled samples, bit for bit."""
    iq = _encode(_random_ts(np.random.default_rng(101), 4, 1))
    assert trx.estimate_sro(iq) == jrx.estimate_sro(iq)
    cap = trx.resample_stream(iq, 1.0 / (1.0 + 37e-6))
    np.testing.assert_array_equal(cap, jrx.resample_stream(iq, 1.0 / (1.0 + 37e-6)))
    est = trx.estimate_sro(cap)
    assert est == jrx.estimate_sro(cap)
    assert abs((est - 1.0) * 1e6 - 37.0) < 1.0
    with pytest.raises(ValueError, match="at least 2 complete fields"):
        trx.estimate_sro(iq[:, : N + 1000])


def test_cfo_corrector_matches_jax():
    """Chunked derotation, skip and a mid-stream retune: the same samples
    and phase as JAX's CfoCorrector; a corrector built from a JAX one's
    frequency and phase goes on identically."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 50_000)) + 1j * rng.standard_normal((1, 50_000)))
    t, j = trx.CfoCorrector(412.5), jrx.CfoCorrector(412.5)
    for lo, hi in ((0, 17), (17, 20_000), (20_000, 31_111)):
        np.testing.assert_array_equal(t(x[:, lo:hi]), j(x[:, lo:hi]))
    t.skip(1234)
    j.skip(1234)
    t.retune(-77.25)
    j.retune(-77.25)
    np.testing.assert_array_equal(t(x[:, 31_111:40_000]), j(x[:, 31_111:40_000]))
    assert (t._phi, t._n) == (j._phi, j._n)
    carried = trx.CfoCorrector(j.cfo_hz, phi=j._phi)
    np.testing.assert_array_equal(carried(x[:, 40_000:]), j(x[:, 40_000:]))
    np.testing.assert_array_equal(trx.CfoCorrector(0.0)(x), x)


# -- the decode CLI's conditioning flags, port against the JAX CLI ------------


#: |port - JAX| of --stats' mer_db: the adaptive equalizer's levels agree
#: with JAX's to ~1e-3 (tests/test_torch_adaptive_eq.py), a few percent of
#: a clean capture's residual power
MER_TOL_DB = 0.5


def _same_summary(s: dict, sj: dict, skip: tuple = ()) -> None:
    """Every key of the two --stats summaries equal, mer_db within
    MER_TOL_DB, the keys in `skip` not compared."""
    assert set(s) == set(sj)
    for k in s:
        if k == "mer_db":
            assert abs(s[k][0] - sj[k][0]) <= MER_TOL_DB, (s, sj)
        elif k not in skip:
            assert s[k] == sj[k], (k, s, sj)


def _decode_both(tmp_path, cap, flags: list) -> tuple[bytes, dict, bytes, dict]:
    """Port decode on the CPU and JAX decode of one capture file: (port TS,
    port summary without `device`, JAX TS, JAX summary)."""
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


def test_cli_align_cfo_auto_matches_jax(tmp_path):
    """tests/test_adaptive_eq.py's --cfo auto --align auto capture: 400 Hz,
    a rotated two-path channel, a start mid-field 0."""
    ts = _random_ts(np.random.default_rng(79), 4, 1)
    iq = _encode(ts)[0]
    y = np.convolve(iq, [0.9 * np.exp(0.6j), 0, 0.12j])[: iq.size]
    y = y * np.exp(2j * np.pi * 400.0 / P.SAMPLE_RATE * np.arange(y.size))
    _write_cf32(tmp_path / "cap.iq", y[55_555:])
    got, s, want, sj = _decode_both(tmp_path, tmp_path / "cap.iq",
                                    ["--cfo", "auto", "--align", "auto"])
    assert got == want == ts[1:3, 0].tobytes()
    _same_summary(s, sj)
    assert abs(s["cfo_hz"] - 400.0) < 1.0 and s["align_offset"] == N - 55_555


def test_cli_sro_auto_matches_jax(tmp_path):
    """tests/test_adaptive_eq.py's --sro auto capture: 37 ppm fast through a
    complex gain."""
    ts = _random_ts(np.random.default_rng(103), 5, 1)
    cap = trx.resample_stream(_encode(ts) * (0.9 * np.exp(0.8j)), 1.0 / (1.0 + 37e-6))[0]
    _write_cf32(tmp_path / "cap.iq", cap)
    got, s, want, sj = _decode_both(tmp_path, tmp_path / "cap.iq", ["--sro", "auto"])
    assert got == want
    _same_summary(s, sj)
    assert abs(s["sro_ppm"] - 37.0) < 1.0 and s["segments_uncorrectable"] == 0
    assert got == ts[1 : 1 + s["fields_decoded"], 0].tobytes()


def test_cli_cfo_track_matches_jax(tmp_path):
    """tests/test_resync.py:86: a 180 Hz offset stepping by 35 Hz at field 6,
    --cfo track --forgetting 0: the same retunes and Hz as JAX (estimated
    on the host from the same corrected blocks), and the same, sent TS on
    the fields before the step and after the re-lock. The fields between
    (the step, then up to 8 fields to the next tracking update) are
    expendable in the reference test too: with uncorrectable segments,
    their bytes and the RS counters follow levels that agree with JAX's
    only to ~1e-3."""
    n_fields = 14
    ts = _random_ts(np.random.default_rng(47), n_fields, 1)
    iq = _encode(ts)[0]
    freq = 180.0 + 35.0 * (np.arange(iq.size) >= 6 * N)
    _write_cf32(tmp_path / "cap.iq", iq * np.exp(2j * np.pi * np.cumsum(freq) / P.SAMPLE_RATE))
    got, s, want, sj = _decode_both(tmp_path, tmp_path / "cap.iq",
                                    ["--cfo", "track", "--forgetting", "0.0"])
    _same_summary(s, sj, skip=("segments_corrected", "segments_uncorrectable"))
    assert s["cfo_retunes"] >= 1 and abs(s["cfo_hz"] - 215.0) < 2.0
    out = np.frombuffer(got, np.uint8).reshape(-1, P.FIELD_TS_BYTES)
    ref = np.frombuffer(want, np.uint8).reshape(-1, P.FIELD_TS_BYTES)
    assert out.shape == ref.shape
    for k in [*range(4), *range(11, out.shape[0])]:
        np.testing.assert_array_equal(out[k], ref[k])
        np.testing.assert_array_equal(out[k], ts[k, 0])


def slipped_capture() -> tuple[np.ndarray, np.ndarray, int]:
    """tests/test_resync.py:26's capture: 9 fields through a complex gain,
    7,019 samples dropped at 3N + 123,456. (ts, (1, n) capture, drop)."""
    ts = _random_ts(np.random.default_rng(41), 9, 1)
    iq = _encode(ts) * (0.9 * np.exp(0.6j))
    cut, drop = 3 * N + 123_456, 7_019
    return ts, np.concatenate([iq[:, :cut], iq[:, cut + drop:]], axis=-1), drop


def test_cli_resync_auto_matches_jax(tmp_path):
    """--resync auto (promotes zf to adaptive) over the unknown slip: one
    resync in both, the same summary but for the RS counters, and the same,
    sent TS on the fields before the slip and after the re-lock. The three
    fields emitted between the slip and its detection are garbage in both;
    their bytes and RS counters follow adaptive levels that agree with
    JAX's only to ~1e-3 (a symbol near a boundary slices either way)."""
    ts, cap, _ = slipped_capture()
    _write_cf32(tmp_path / "cap.iq", cap[0])
    got, s, want, sj = _decode_both(tmp_path, tmp_path / "cap.iq", ["--resync", "auto"])
    assert s["resyncs"] == sj["resyncs"] == 1
    _same_summary(s, sj, skip=("segments_corrected", "segments_uncorrectable"))
    a = np.frombuffer(got, np.uint8).reshape(-1, P.FIELD_TS_BYTES)
    b = np.frombuffer(want, np.uint8).reshape(-1, P.FIELD_TS_BYTES)
    # the CLI reads whole field blocks: the capture's last, partial one
    # (the slip shortened it) is dropped, so the re-locked tail is one field
    assert a.shape == b.shape == (6, P.FIELD_TS_BYTES)
    for k in (0, 1, 5):   # before the slip, and the re-locked tail
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a[:2], ts[:2, 0])
    np.testing.assert_array_equal(a[5], ts[6, 0])


@pytest.fixture
def jax_eager_erasures(monkeypatch):
    from atsc_tpu.ops import rs_decode as jrs

    monkeypatch.setattr(jdec, "rs_correct_field_erasures_jit", jrs.rs_correct_field_erasures)


def test_cli_full_gauntlet_matches_jax(tmp_path, jax_eager_erasures):
    """tests/test_gauntlet.py:22, every impairment at once (multipath with a
    complex gain, 400 Hz CFO, 25 ppm SRO, 24 dB AWGN, an impulse burst, a
    cut mid-field 0) through --sro auto --cfo auto --trellis viterbi
    --erasures burst: the JAX CLI's TS file and summary, and the sent TS."""
    rng = np.random.default_rng(131)
    ts = _random_ts(rng, 5, 1)
    iq = _encode(ts)[0]
    y = np.convolve(iq, [0.85 * np.exp(0.7j), 0, 0.12 * np.exp(-1.1j), 0, 0.05j])[: iq.size]
    y = y * np.exp(2j * np.pi * 400.0 / P.SAMPLE_RATE * np.arange(y.size))
    y = trx.resample_stream(y, 1.0 / (1.0 + 25e-6))[0]
    sigma = np.sqrt(float(np.mean(np.abs(y) ** 2)) / 10 ** (24.0 / 10.0) / 2.0)
    y = y + (rng.normal(size=y.size) + 1j * rng.normal(size=y.size)) * sigma
    s0 = 2 * N + 97_000
    y[s0 : s0 + 2600] += (rng.normal(size=2600) + 1j * rng.normal(size=2600)) * 4.0
    _write_cf32(tmp_path / "cap.iq", y[77_777:])
    got, s, want, sj = _decode_both(
        tmp_path, tmp_path / "cap.iq",
        ["--sro", "auto", "--cfo", "auto", "--trellis", "viterbi", "--erasures", "burst"])
    assert got == want
    _same_summary(s, sj)
    assert abs(s["sro_ppm"] - 25.0) < 1.0 and abs(s["cfo_hz"] - 400.0) < 2.0
    assert s["segments_uncorrectable"] == 0 and s["fields_decoded"] >= 2
    assert got == ts[1 : 1 + s["fields_decoded"], 0].tobytes()


# -- validation: the JAX CLI's refusals and messages --------------------------


@pytest.mark.parametrize("flags, jax_flags", [
    (["--rate", "4e6"], ["--demux", "1", "--rate", "4e6"]),
    (["-c", "2", "--rate", "16e6"], None),
    (["-c", "2", "--sro", "12"], None),
    (["-c", "2", "--align", "auto"], None),
    (["-c", "2", "--cfo", "auto"], None),
])
def test_cli_decode_conditioning_validation_matches_jax(tmp_path, flags, jax_flags):
    """Multichannel --rate/--sro/--align/--cfo auto and a --rate below the
    band are refused with the JAX CLI's messages (JAX checks the band on
    its --demux path, the one with a rate of its own; a single-channel
    capture is its --demux 1)."""
    cap = tmp_path / "cap.iq"
    np.zeros(2 * 2 * N * 2, np.float32).tofile(cap)
    with pytest.raises(ValueError) as port:
        tcli.run_decode(tcli.build_decode_argparser().parse_args(
            [str(cap), *flags, "-o", str(tmp_path / "o.ts"), "--device", "cpu"]))
    with pytest.raises(ValueError) as ref:
        jcli.run_decode(jcli.build_decode_argparser().parse_args(
            [str(cap), *(jax_flags or flags), "-o", str(tmp_path / "j.ts")]))
    assert str(port.value) == str(ref.value)
