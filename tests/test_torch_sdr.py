"""The port's SoapySDR sink and source (runtime/io.py) and the CLI's live
paths, held against the JAX package on the CPU. No radio is attached: a
fake `SoapySDR` module (the port's own copy of tests/test_sdr_source.py's
fake, whose TX device also records every buffer it is given) serves a
canned capture and records the device settings. Each scenario runs the
same served capture or TS through both packages: TS bytes, the --stats
summary and the recorded settings must agree, and the sink's device bytes
must be the JAX CLI's within the encoders' contract (cf32 5e-6 a
component, cs8 1 LSB, a multiplex 1e-5 of its RMS) and the port's own
file sink's bit for bit. Captures are the port's CPU encoder's, B <= 2, at
most 4 fields a case.

Tolerances: every summary key exact but mer_db, within 0.05 dB where the
zf equalizer measures it (the JAX side's Pallas kernel interpreted, as
tests/test_torch_analyze.py runs it) and 0.5 dB where the adaptive one
does (tests/test_torch_acquisition.py's MER_TOL_DB)."""

import contextlib
import io
import sys
import types

import numpy as np
import pytest
import torch

from atsc_tpu import cli as jcli
from atsc_tpu.runtime import io as jio
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
from atsc_tpu_torch.ops.resample import SYMBOL_RATE_FRACTION
from atsc_tpu_torch.runtime import io as tio
from tests.test_torch_acquisition import MER_TOL_DB
from tests.test_torch_analyze import _assert_same, jax_fused_eq  # noqa: F401

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
ZF_MER_TOL_DB = 0.05


def _install_fake_soapy(monkeypatch, samples=None, mtu: int = 4096, hiccups: int = 0,
                        gap_at: int | None = None, gap_len: int = 0, stamp: bool = False,
                        flag_stamps: bool = True) -> dict:
    """Install a fake `SoapySDR` module; returns the dict its device
    records its settings in (and, under "tx", every buffer written).

    RX: serves `samples` ((n, 2) component pairs) at most mtu a read,
    after `hiccups` alternating timeout/overflow results; reading past the
    served capture raises (a hang becomes a failure). gap_at/gap_len: after
    gap_at samples, one overflow and gap_len samples of stream time
    dropped. stamp: buffers carry timeNs from the virtual stream position
    at the configured rate, flagged HAS_TIME unless flag_stamps is False."""
    calls: dict = {}
    mod = types.ModuleType("SoapySDR")
    mod.SOAPY_SDR_RX = "RX"
    mod.SOAPY_SDR_TX = "TX"
    mod.SOAPY_SDR_TIMEOUT = -1
    mod.SOAPY_SDR_OVERFLOW = -2
    mod.SOAPY_SDR_HAS_TIME = 1 << 2

    class _Result:
        def __init__(self, ret, time_ns=0):
            self.ret = ret
            self.timeNs = time_ns
            self.flags = mod.SOAPY_SDR_HAS_TIME if time_ns and flag_stamps else 0

    class Device:
        def __init__(self, dev_args):
            calls["driver"] = dev_args["driver"]
            self._pos = self._vpos = 0
            self._gapped = False
            self._hiccups = hiccups

        def setBandwidth(self, d, ch, v):
            calls["bandwidth"] = v

        def setSampleRate(self, d, ch, v):
            calls["rate"] = v

        def setFrequency(self, d, ch, v):
            calls["frequency"] = v

        def setGain(self, d, ch, v):
            calls["gain"] = v

        def setupStream(self, d, fmt):
            calls["direction"], calls["format"] = d, fmt
            return "stream"

        def activateStream(self, s):
            calls["activated"] = True

        def getStreamMTU(self, s):
            return mtu

        def readStream(self, s, bufs, num):
            if self._hiccups > 0:
                self._hiccups -= 1
                return _Result(-1 if self._hiccups % 2 else -2)
            if gap_at is not None and not self._gapped and self._pos >= gap_at:
                self._gapped = True
                self._vpos += gap_len
                return _Result(-2)
            if self._pos >= samples.shape[0]:
                raise AssertionError("read past the served capture")
            got = min(num, mtu, samples.shape[0] - self._pos)
            if gap_at is not None and not self._gapped:
                got = min(got, gap_at - self._pos)
            t = int(1e15 + self._vpos / calls["rate"] * 1e9) if stamp else 0
            bufs[0][:got] = samples[self._pos:self._pos + got]
            self._pos += got
            self._vpos += got
            return _Result(got, t)

        def writeStream(self, s, bufs, num):
            calls.setdefault("tx", []).append(np.asarray(bufs[0][:num]).tobytes())
            return _Result(num)

        def deactivateStream(self, s):
            calls["deactivated"] = True

        def closeStream(self, s):
            calls["closed"] = True

    mod.Device = Device
    monkeypatch.setitem(sys.modules, "SoapySDR", mod)
    return calls


def _random_ts(rng, t: int, b: int = 1) -> np.ndarray:
    ts = rng.integers(0, 256, size=(t, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _samples(ts: np.ndarray) -> np.ndarray:
    """(F, 1, 58656) TS -> (F*N, 2) float32 pairs through the port's CPU encoder."""
    enc = Encoder(batch=1, device="cpu")
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k]))[0] for k in range(ts.shape[0])])
    return np.stack([iq.real, iq.imag], -1).astype(np.float32)


# -- the source: exact reads, hiccups and gaps, port against JAX --------------

#: scenario -> (fake's keyword arguments, the reads made)
SOURCE_CASES = {
    "exact_bytes_hiccups": (dict(mtu=777, hiccups=4), [5, 8_003, 64_000]),
    "timestamped_gap_filled": (dict(mtu=999, gap_at=7_000, gap_len=1_234, stamp=True),
                               [(20_000 + 1_234) * 8]),
    "no_fill_without_stamps": (dict(mtu=777, gap_at=1_500, gap_len=999), [20_000 * 8]),
    "unflagged_stamps_ignored": (dict(mtu=777, gap_at=2_000, gap_len=777, stamp=True,
                                      flag_stamps=False), [20_000 * 8]),
}


@pytest.mark.parametrize("case", list(SOURCE_CASES))
def test_sdr_source_matches_jax(case, monkeypatch):
    """Both packages' SoapySdrSource on the same served stream: the same
    bytes, overflow and gap counters and device settings; a sizeless read
    is refused, the stream is not seekable and reads b'' once closed."""
    kw, reads = SOURCE_CASES[case]
    samples = np.random.default_rng(3).normal(size=(20_000, 2)).astype(np.float32)
    seen = []
    for mod in (tio, jio):
        calls = _install_fake_soapy(monkeypatch, samples, **kw)
        src = mod.SoapySdrSource(driver="fake", sample_rate=2e6, bandwidth_hz=1e6)
        assert not src.seekable() and src.readable()
        with pytest.raises(ValueError, match="never"):
            src.read()
        got = b"".join(src.read(n) for n in reads)
        counters = (src.overflows, src.gaps_filled, src.gap_samples, src.bytes_read())
        src.close()
        assert src.read(16) == b""
        seen.append((got, counters, calls))
    (got, counters, calls), (want, want_counters, want_calls) = seen
    assert got == want and counters == want_counters and calls == want_calls
    assert calls == {"driver": "fake", "bandwidth": 1e6, "rate": 2e6, "frequency": 473e6,
                     "gain": 30.0, "direction": "RX", "format": "CF32", "activated": True,
                     "deactivated": True, "closed": True}
    fill = kw["gap_len"] if case == "timestamped_gap_filled" else 0
    assert counters[1:3] == (int(fill > 0), fill)
    wire = samples.tobytes()
    if fill:
        at = kw["gap_at"] * 8
        assert got == wire[:at] + bytes(fill * 8) + wire[at:]
    else:
        assert got == wire[: len(got)]


# -- the live decode paths, port against the JAX CLI -------------------------


def _decode_both(monkeypatch, tmp_path, served: np.ndarray, argv: list, **fake) -> tuple:
    """`decode` of the served capture through both CLIs: (port TS, port
    summary without `device`, JAX TS, JAX summary, port device settings,
    JAX device settings)."""
    out = []
    for tool, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        calls = _install_fake_soapy(monkeypatch, served, **fake)
        path = tmp_path / f"{tool.__name__}.ts"
        with contextlib.redirect_stderr(io.StringIO()):
            s = tool.run_decode(tool.build_decode_argparser().parse_args(
                [*argv, "-o", str(path), "--stats", *extra]))
        out.append((path.read_bytes(), s, calls))
    (got, s, calls), (want, sj, jcalls) = out
    assert s.pop("device") == "cpu"
    return got, s, want, sj, calls, jcalls


def _same_summary(s: dict, sj: dict, mer_tol: float) -> None:
    assert set(s) == set(sj), (s, sj)
    for k in s:
        if k == "mer_db":
            assert np.abs(np.subtract(s[k], sj[k])).max() <= mer_tol, (s, sj)
        else:
            assert s[k] == sj[k], (k, s, sj)


def test_cli_decode_live_matches_jax(monkeypatch, tmp_path, jax_fused_eq):
    """`decode soapy:fake` captures at the symbol rate and 6 MHz and
    decodes the sent TS, as the JAX CLI does."""
    ts = _random_ts(np.random.default_rng(149), 3)
    served = np.concatenate([_samples(ts), np.zeros((N, 2), np.float32)])
    got, s, want, sj, calls, jcalls = _decode_both(
        monkeypatch, tmp_path, served, ["soapy:fake", "--max-fields", "2"], mtu=65_536)
    assert got == want == ts[:2, 0].tobytes()
    _same_summary(s, sj, ZF_MER_TOL_DB)
    assert s["overflows"] == s["gaps_filled"] == s["gap_samples"] == 0
    assert calls == jcalls and calls["rate"] == P.SAMPLE_RATE and calls["bandwidth"] == 6e6
    assert calls["driver"] == "fake" and calls["deactivated"]


def test_cli_decode_live_overflow_gap_matches_jax(monkeypatch, tmp_path, jax_fused_eq):
    """A timestamped overflow gap is zero-filled at the source and RS
    corrects the zeroed span: the sent TS, the gap counted, in both CLIs."""
    ts = _random_ts(np.random.default_rng(157), 4)
    samples = _samples(ts)
    gap_at, gap_len = int(1.5 * N), 600
    served = np.concatenate([samples[:gap_at], samples[gap_at + gap_len:],
                             np.zeros((N, 2), np.float32)])
    got, s, want, sj, calls, jcalls = _decode_both(
        monkeypatch, tmp_path, served, ["soapy:fake", "--max-fields", "3"], mtu=65_536,
        gap_at=gap_at, gap_len=gap_len, stamp=True)
    assert got == want == ts[:3, 0].tobytes()
    _same_summary(s, sj, ZF_MER_TOL_DB)
    assert (s["overflows"], s["gaps_filled"], s["gap_samples"]) == (1, 1, gap_len)
    assert s["segments_uncorrectable"] == 0 and s["segments_corrected"] > 0
    assert calls == jcalls


def test_cli_decode_demux_live_matches_jax(monkeypatch, tmp_path):
    """`decode soapy --demux 2` runs the SDR at the 12 MHz multiplex rate
    and bandwidth and returns every slot's TS, as the JAX CLI does."""
    b = 2
    ts = _random_ts(np.random.default_rng(151), 4, b)
    paths = []
    for ch in range(b):
        paths.append(str(tmp_path / f"in{ch}.ts"))
        ts[:, ch].tofile(paths[-1])
    cap = tmp_path / "band.iq"
    assert tcli.main([*paths, "--mux", "-o", str(cap), "--device", "cpu"]) == 0
    served = np.concatenate([np.fromfile(cap, np.float32).reshape(-1, 2),
                             np.zeros((1 << 20, 2), np.float32)])
    got, s, want, sj, calls, jcalls = _decode_both(
        monkeypatch, tmp_path, served, ["soapy", "--demux", str(b), "--max-fields", "2"],
        mtu=65_536)
    assert got == want and got[: 2 * b * P.FIELD_TS_BYTES] == ts[:2].tobytes()
    _same_summary(s, sj, MER_TOL_DB)
    assert s["segments_uncorrectable"] == 0 and s["overflows"] == 0
    assert calls == jcalls and calls["rate"] == calls["bandwidth"] == b * 6e6
    assert calls["driver"] == "hackrf" and calls["gain"] == 30.0


@pytest.mark.parametrize("flags,reason", [
    (["-c", "2"], "single-channel"),
    (["--sro", "auto"], "live"),
    (["--checkpoint", "c.npz", "--resume"], "live"),
    (["--demux", "2", "--checkpoint", "c.npz", "--resume"], "live"),
])
def test_cli_decode_live_refusals_match_jax(flags, reason, monkeypatch, tmp_path):
    """What a live capture cannot do is refused with the JAX CLI's words,
    before any device opens."""
    messages = []
    for tool, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        calls = _install_fake_soapy(monkeypatch, np.zeros((1, 2), np.float32))
        with pytest.raises(ValueError, match=reason) as exc:
            tool.run_decode(tool.build_decode_argparser().parse_args(
                ["soapy", "-o", str(tmp_path / "o.ts"), *flags, *extra]))
        assert calls == {}
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_cli_analyze_live_matches_jax(monkeypatch, jax_fused_eq):
    """`analyze soapy:fake` grabs the fields off the SDR at the symbol rate
    and reports what the JAX CLI reports for them."""
    served = _samples(_random_ts(np.random.default_rng(23), 6))
    reports, settings = [], []
    for tool, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        settings.append(_install_fake_soapy(monkeypatch, served, mtu=65_536))
        reports.append(tool.run_analyze(tool.build_analyze_argparser().parse_args(
            ["soapy:fake", "--fields", "4", "-g", "12", *extra])))
    _assert_same(*reports, "analyze soapy:fake")
    assert reports[0]["mer_method"] == "zf" and reports[0]["decodable"]
    assert settings[0] == settings[1]
    assert settings[0]["rate"] == P.SAMPLE_RATE and settings[0]["gain"] == 12.0


# -- the sink: device bytes and clock, port against the JAX CLI ---------------


def _encode_both(monkeypatch, tmp_path, inputs: list, argv: list) -> tuple:
    """Encode through both CLIs into the fake TX device: (port settings,
    JAX settings); the port's settings hold its file sink's bytes too."""
    out = []
    for tool, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        calls = _install_fake_soapy(monkeypatch)
        assert tool.main([*inputs, *argv, "-o", "soapy:fake", *extra]) == 0
        out.append(calls)
    path = tmp_path / "file.iq"
    assert tcli.main([*inputs, *argv, "-o", str(path), "--device", "cpu"]) == 0
    out[0]["file"] = path.read_bytes()
    return tuple(out)


@pytest.mark.parametrize("argv", [["-f", "615e6", "-g", "40"],
                                  ["--format", "cs8"],
                                  ["-c", "2", "--mux"]])
def test_cli_encode_soapy_sink_matches_jax(argv, monkeypatch, tmp_path):
    """The bytes the TX device receives: the port's file sink's exactly,
    and the JAX CLI's within the encoders' contract; the device's settings
    (rate, bandwidth, frequency, gain, format) the JAX CLI's."""
    rng = np.random.default_rng(21)
    mux = "--mux" in argv
    ts = _random_ts(rng, 2, 2 if mux else 1)
    inputs = []
    for ch in range(ts.shape[1]):
        inputs.append(str(tmp_path / f"in{ch}.ts"))
        ts[:, ch].tofile(inputs[-1])
    calls, jcalls = _encode_both(monkeypatch, tmp_path, inputs, argv)
    got, want = b"".join(calls.pop("tx")), b"".join(jcalls.pop("tx"))
    assert got == calls.pop("file")
    assert calls == jcalls and calls["direction"] == "TX" and calls["closed"]
    fmt = "cs8" if "cs8" in argv else "cf32"
    dtype = np.int8 if fmt == "cs8" else np.float32
    g, w = np.frombuffer(got, dtype), np.frombuffer(want, dtype)
    assert g.size == w.size
    if fmt == "cs8":
        assert calls["format"] == "CS8" and g.size == 2 * 2 * N
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
    elif mux:
        assert calls["rate"] == calls["bandwidth"] == 12e6
        assert np.abs(g - w).max() <= 1e-5 * np.sqrt(np.mean(w.astype(np.float64) ** 2))
    else:
        assert (calls["frequency"], calls["gain"], calls["rate"]) == (615e6, 40.0,
                                                                      P.SAMPLE_RATE)
        assert calls["bandwidth"] == 6e6 and g.size == 2 * 2 * N
        assert np.abs(g - w).max() <= 5e-6


@pytest.mark.parametrize("argv,rate", [
    (["--ppm", "400"], float(SYMBOL_RATE_FRACTION)),
    (["--rate", "12e6"], 12e6),
    (["-c", "2", "--mux", "--ppm", "400"], 12e6),
])
def test_cli_encode_soapy_clock_matches_jax(argv, rate, monkeypatch, tmp_path):
    """--ppm stretches the samples but keeps the SDR at its nominal clock
    (the symbol rate, or the multiplex rate with --mux), so the emulated
    clock error reaches the air; --rate sets the clock. The JAX CLI's
    settings and sample count."""
    mux = "--mux" in argv
    ts = _random_ts(np.random.default_rng(22), 1, 2 if mux else 1)
    inputs = []
    for ch in range(ts.shape[1]):
        inputs.append(str(tmp_path / f"in{ch}.ts"))
        ts[:, ch].tofile(inputs[-1])
    calls, jcalls = _encode_both(monkeypatch, tmp_path, inputs, argv)
    n_tx = sum(len(b) for b in calls.pop("tx")) // 8
    assert n_tx == sum(len(b) for b in jcalls.pop("tx")) // 8
    assert len(calls.pop("file")) == 8 * n_tx
    assert calls == jcalls and calls["rate"] == rate
    if "--ppm" in argv:
        nominal = int(np.ceil(N / 513)) * 286 * 2 if mux else N
        ppm = float(argv[argv.index("--ppm") + 1])
        assert nominal < n_tx <= nominal * (1 + ppm * 1e-6)
