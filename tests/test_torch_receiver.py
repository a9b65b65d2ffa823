"""The hard-decision receive slice of the PyTorch port on the CPU, held
against the JAX package: decode_field on golden symbol fields, the IQ
receiver on golden IQ and on a noisy capture with RS firing, the Decoder
bit for bit, decoder-state conversion, and the decode CLI."""

import contextlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.models import decoder as jdec
from atsc_tpu.models import receiver as jrx
from atsc_tpu_torch.models import decoder as tdec
from atsc_tpu_torch.models import receiver as trx
from atsc_tpu_torch.utils.convert import decoder_state_from_numpy, decoder_state_to_numpy

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
SNR_DB = 20.0   # AWGN in the IQ domain: hard decisions err, RS corrects all


def _golden_symbols(golden) -> np.ndarray:
    """The 4 golden fields (sync stage) as (4, 1, 261248) int8 symbols."""
    levels = golden["sync"][:4].real.astype(np.float32)
    sym = np.rint((levels - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    return sym[:, None]


def _random_ts(rng, t, b) -> np.ndarray:
    ts = rng.integers(0, 256, size=(t, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


@pytest.fixture(scope="module")
def noisy():
    """3 fields of seeded random TS through the port's CPU encoder, plus
    seeded AWGN at SNR_DB: (ts (3, 1, 58656), noisy iq (1, 3N) complex64)."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    ts = _random_ts(np.random.default_rng(7), 3, 1)
    enc = Encoder(batch=1, device="cpu")
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(3)], -1)
    rng = np.random.default_rng(20)
    sig = np.sqrt(np.mean(np.abs(iq) ** 2))
    noise = rng.normal(0, 1, iq.shape) + 1j * rng.normal(0, 1, iq.shape)
    return ts, (iq + noise * sig * 10 ** (-SNR_DB / 20) / np.sqrt(2)).astype(np.complex64)


def test_decode_field_matches_jax_on_golden(golden):
    """State, codewords and syndromes identical to JAX's decode_field over
    the 4 golden fields; the RS fields equal golden["rs"]."""
    sym = _golden_symbols(golden)
    js = jdec.init_decoder_state(1)
    ts_ = tdec.init_decoder_state(1, device="cpu")
    for k in range(4):
        js, jcw, jsyn = jdec.decode_field(js, jnp.asarray(sym[k]))
        ts_, tcw, tsyn = tdec.decode_field(ts_, torch.tensor(sym[k]))
        np.testing.assert_array_equal(tcw.numpy(), np.asarray(jcw))
        np.testing.assert_array_equal(tsyn.numpy(), np.asarray(jsyn))
        np.testing.assert_array_equal(ts_.prev_il.numpy(), np.asarray(js.prev_il))
        np.testing.assert_array_equal(ts_.z2_prev.numpy(), np.asarray(js.z2_prev))
        assert tcw.dtype == torch.uint8 and ts_.z2_prev.dtype == torch.int32
        if k:
            np.testing.assert_array_equal(tcw.numpy()[0].reshape(-1), golden["rs"][k - 1])
            assert not tsyn.numpy().any()


@pytest.mark.parametrize("profile", ["auto", "exact"])
def test_iq_receiver_decodes_golden_like_jax(golden, profile):
    """The port's receiver decodes golden IQ fields 0-3 to
    golden["input"][0:3] byte for byte, as JAX's receiver does."""
    iq = golden["iq"][:4].reshape(1, -1)
    rx = trx.IqReceiver(batch=1, eq_profile=profile, device="cpu")
    got = rx.push(iq[:, :250_000]) + rx.push(iq[:, 250_000:]) + rx.flush()
    jr = jrx.IqReceiver(batch=1, eq_profile=profile)
    want = jr.push(iq) + jr.flush()
    assert len(got) == len(want) == 3
    for k, ((ts, n), (jts, _)) in enumerate(zip(got, want)):
        assert ts.dtype == np.uint8 and n.dtype == np.int32
        np.testing.assert_array_equal(ts[0], golden["input"][k])
        np.testing.assert_array_equal(ts, jts)
        assert not n.any()
    assert rx.decoder.segments_corrected == 0 and rx.fields_emitted == 3


def test_iq_receiver_noisy_capture_rs_fires(noisy):
    """AWGN at 20 dB: hard decisions err, RS corrects every segment, the
    sent TS comes back; the pre-start field's statistics are rolled back."""
    ts, iq = noisy
    rx = trx.IqReceiver(batch=1, measure_mer=True, device="cpu")
    got = rx.push(iq) + rx.flush()
    assert len(got) == 2
    for k, (out, nerr) in enumerate(got):
        np.testing.assert_array_equal(out, ts[k])
        assert (nerr >= 0).all()
    assert rx.decoder.segments_corrected > 0
    assert rx.decoder.segments_uncorrectable == 0
    assert rx.decoder.segments_corrected == sum(int((n > 0).sum()) for _, n in got)
    assert 19.0 < rx.mer[0] < 26.0


def test_decoder_bit_identical_to_jax_on_noisy_field(noisy):
    """The same sliced noisy symbol fields through both Decoders: identical
    codewords (via TS), n_errors and TS, RS firing."""
    ts, iq = noisy
    jd = jdec.Decoder(batch=1)
    td = tdec.Decoder(batch=1, device="cpu")
    for k in range(2):
        sym = trx.equalize_field_device(iq, k * N, device="cpu").numpy()
        jts, jn = jd.decode(sym)
        tts, tn = td.decode(sym)
        np.testing.assert_array_equal(tts, jts)
        np.testing.assert_array_equal(tn, jn)
        assert tn.dtype == np.int32
    np.testing.assert_array_equal(tts, ts[0])
    assert td.segments_corrected == jd.segments_corrected > 0
    assert td.segments_uncorrectable == jd.segments_uncorrectable == 0


def test_decoder_state_carries_a_jax_stream(golden):
    """A JAX Decoder decodes golden fields 0-1; its state moves into the
    port, which decodes fields 2-3 to the same TS as JAX."""
    sym = _golden_symbols(golden)
    jd = jdec.Decoder(batch=1)
    for k in range(2):
        jd.decode(sym[k])
    leaves = {k: np.asarray(v) for k, v in jd.state._asdict().items()}
    td = tdec.Decoder(batch=1, device="cpu")
    td.state = decoder_state_from_numpy(leaves, device="cpu")
    back = decoder_state_to_numpy(td.state)
    assert all(np.array_equal(back[k], leaves[k]) and back[k].dtype == leaves[k].dtype
               for k in leaves)
    for k in (2, 3):
        jts, _ = jd.decode(sym[k])
        tts, _ = td.decode(sym[k])
        np.testing.assert_array_equal(tts, jts)
        np.testing.assert_array_equal(tts[0], golden["input"][k - 1])
    with pytest.raises(ValueError):
        decoder_state_from_numpy({**leaves, "z2_prev": leaves["z2_prev"].astype(np.int64)},
                                 device="cpu")


def test_cli_decode_matches_jax_cli(tmp_path):
    """A 3-field cs8 capture written by the port's encode CLI decodes with
    the port's decode CLI to the same TS file as the JAX CLI gives, and to
    the TS that went in."""
    from atsc_tpu import cli as jcli
    from atsc_tpu_torch import cli as tcli

    ts = _random_ts(np.random.default_rng(31), 3, 1)[:, 0]
    src, cap = tmp_path / "in.ts", tmp_path / "cap.cs8"
    ts.tofile(src)
    assert tcli.main([str(src), "--format", "cs8", "-o", str(cap), "--device", "cpu"]) == 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main(["decode", str(cap), "--format", "cs8", "-o",
                          str(tmp_path / "port.ts"), "--device", "cpu", "--stats"]) == 0
    assert jcli.main(["decode", str(cap), "--format", "cs8", "-o",
                      str(tmp_path / "jax.ts")]) == 0
    got = (tmp_path / "port.ts").read_bytes()
    assert got == (tmp_path / "jax.ts").read_bytes()
    assert got == ts[:2].tobytes()
    import json

    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    assert stats["fields_decoded"] == 2 and stats["segments_uncorrectable"] == 0
    assert stats["mer_db"][0] > 30


@pytest.mark.parametrize("kw", [dict(backend="adaptive", resync="auto", viterbi_chunks=4,
                                     trellis="soft"),
                                dict(viterbi_chunks=2, trellis="soft"),
                                dict(viterbi_chunks=3, ntsc="comb"),
                                dict(backend="adaptive-dd", resync="auto", viterbi_chunks=2,
                                     ntsc="comb"),
                                dict(viterbi_chunks=2, backend="adaptive", trellis="soft")])
def test_receiver_refuses_unported_options(noisy, kw):
    """The chunk-parallel Viterbi options the receiver refused before it was
    ported now build on every backend and tier that JAX allows, and decode
    the 20 dB capture to the sent TS."""
    ts, iq = noisy
    rx = trx.IqReceiver(batch=1, device="cpu", **kw)
    assert rx.viterbi_chunks == kw["viterbi_chunks"]
    out = rx.push(iq) + rx.flush()
    assert len(out) == 2 and rx.decoder.segments_uncorrectable == 0
    for k, (got, _) in enumerate(out):
        np.testing.assert_array_equal(got, ts[k])


def test_receiver_chunked_matches_jax(noisy):
    """IqReceiver(trellis="soft", viterbi_chunks=24) against the JAX
    package's on the 20 dB capture: the same TS and n_errors per field."""
    ts, iq = noisy
    jr = jrx.IqReceiver(batch=1, trellis="soft", viterbi_chunks=24)
    tr = trx.IqReceiver(batch=1, trellis="soft", viterbi_chunks=24, device="cpu")
    want = jr.push(iq) + jr.flush()
    got = tr.push(iq) + tr.flush()
    assert len(got) == len(want) == 2
    for (g_ts, g_n), (w_ts, w_n), sent in zip(got, want, ts):
        np.testing.assert_array_equal(g_ts, w_ts)
        np.testing.assert_array_equal(g_n, w_n)
        np.testing.assert_array_equal(g_ts, sent)


@pytest.mark.parametrize("flag", [["--mesh", "2x1"],
                                  ["--mesh", "2x1", "--fields-per-step", "2"],
                                  ["soapy", "-d", "hackrf", "-f", "615e6", "-g", "40"]])
def test_cli_decode_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """--mesh, with or without the flag that acts with it
    (--fields-per-step), now does what the JAX CLI does: it decodes a
    2-field cs8 capture over 2 time shards (on the one CPU device) to the
    plain decode's TS. The soapy source, given as the input with -d/-f/-g,
    is ported: where the SoapySDR bindings are absent it stops with the
    JAX package's RuntimeError."""
    from atsc_tpu_torch import cli as tcli

    if flag[0] == "soapy":
        monkeypatch.setitem(sys.modules, "SoapySDR", None)   # the import fails
        with pytest.raises(RuntimeError, match="decode from a capture file instead"):
            tcli.main(["decode", "--device", "cpu", "-o", str(tmp_path / "o.ts"), *flag])
        return
    ts = _random_ts(np.random.default_rng(33), 2, 1)[:, 0]
    src, cap = tmp_path / "in.ts", tmp_path / "cap.cs8"
    ts.tofile(src)
    assert tcli.main([str(src), "--format", "cs8", "-o", str(cap), "--device", "cpu"]) == 0
    base = ["decode", str(cap), "--format", "cs8", "--device", "cpu", "-o"]
    assert tcli.main([*base, str(tmp_path / "plain.ts")]) == 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main([*base, str(tmp_path / "mesh.ts"), *flag]) == 0
    assert (tmp_path / "mesh.ts").read_bytes() == (tmp_path / "plain.ts").read_bytes()
    assert (tmp_path / "mesh.ts").read_bytes() == ts[:1].tobytes()
    assert "decode --mesh: 2 shards on 1 cpu device(s)" in err.getvalue()


@pytest.mark.parametrize("flag", [["--checkpoint", "c.npz"], ["--profile", "d"],
                                  ["--demux", "2", "--resume"], ["--resume"],
                                  ["--demux", "2", "--checkpoint", "c.npz"],
                                  ["--checkpoint", "c.npz", "--checkpoint-every", "8"]])
def test_cli_decode_runs_the_state_and_operation_flags(flag, tmp_path):
    """The decode flags refused before they were ported now run: on a
    2-field cs8 capture (a 2-slot multiplex with --demux) --checkpoint
    writes a receiver checkpoint at the decoded position and --profile a
    trace, the TS the same as without them; --resume without --checkpoint
    stops with its own error and touches no output."""
    from atsc_tpu_torch import cli as tcli

    ts = _random_ts(np.random.default_rng(32), 2, 1)[:, 0]
    src, cap = tmp_path / "in.ts", tmp_path / "cap.iq"
    ts.tofile(src)
    demux = "--demux" in flag
    enc = ["-c", "2", "--mux"] if demux else ["--format", "cs8"]
    assert tcli.main([str(src), *enc, "-o", str(cap), "--device", "cpu"]) == 0
    fmt = [] if demux else ["--format", "cs8"]
    flag = [str(tmp_path / a) if a in ("c.npz", "d") else a for a in flag]
    out = tmp_path / "back.ts"
    argv = ["decode", str(cap), *fmt, "-o", str(out), "--device", "cpu"]
    if "--resume" in flag:
        with pytest.raises(ValueError, match="--resume requires --checkpoint"):
            tcli.main([*argv, *flag])
        assert not out.exists()
        return
    assert tcli.main([*argv, *flag]) == 0
    want = np.stack([ts[:1]] * (2 if demux else 1), axis=1)
    assert out.read_bytes() == want.tobytes()
    if "--checkpoint" in flag:
        with np.load(flag[flag.index("--checkpoint") + 1]) as z:
            assert int(z["fields_emitted"]) == 1
            assert ("xarr_demux_carry" in z.files) == demux
    if "--profile" in flag:
        assert os.listdir(flag[flag.index("--profile") + 1])


@pytest.mark.parametrize("flag", [["--fields-per-step", "2"], ["--checkpoint-every", "8"],
                                  ["-d", "lime", "-f", "615e6", "-g", "20"]])
def test_cli_decode_accepts_flags_without_effect(flag, tmp_path):
    """decode's flags that act only with --mesh, --checkpoint or a soapy
    source parse, and change no byte of the TS and no --stats key of a
    2-field cs8 capture decoded without them."""
    from atsc_tpu_torch import cli as tcli

    ts = _random_ts(np.random.default_rng(32), 2, 1)[:, 0]
    src, cap = tmp_path / "in.ts", tmp_path / "cap.cs8"
    ts.tofile(src)
    assert tcli.main([str(src), "--format", "cs8", "-o", str(cap), "--device", "cpu"]) == 0
    outs, stats = [], []
    for extra in ([], flag):
        out, err = tmp_path / f"back{len(outs)}.ts", io.StringIO()
        with contextlib.redirect_stderr(err):
            assert tcli.main(["decode", str(cap), "--format", "cs8", "-o", str(out),
                              "--device", "cpu", "--stats", *extra]) == 0
        outs.append(out.read_bytes())
        stats.append(err.getvalue().strip().splitlines()[-1])
    assert outs[0] == outs[1] == ts[:1].tobytes()
    assert stats[0] == stats[1]


def test_window_helpers_match_jax(golden):
    """eq_window_bounds is (-K, WIN_LEN) for each profile; field_window and
    the equalizer taps equal the JAX package's."""
    for profile, k in (("auto", 128), ("fast", 128), ("exact", 256)):
        assert trx.eq_window_bounds(profile) == (-k, 263168)
    iq = golden["iq"][:2].reshape(1, -1)
    for a, b in zip(trx.field_window(iq, N, 0, margin=128, length=263168),
                    jrx.field_window(iq, N, 0, margin=128, length=263168)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in (128, 256):
        for a, b in zip(trx._wl_eq_taps(k), jrx._wl_eq_taps(k)):
            np.testing.assert_array_equal(a, b)


# -- the numpy and adaptive backends, and the burst erasure tier --------------
#
# JAX's Decoder corrects flagged fields with rs_correct_field_erasures_jit,
# whose whole-function XLA:CPU compile runs past 15 minutes here; the JAX
# side of these tests runs the same function eagerly (op by op), which
# gives the same integers.


@pytest.fixture
def jax_eager_erasures(monkeypatch):
    from atsc_tpu.ops import rs_decode as jrs

    monkeypatch.setattr(jdec, "rs_correct_field_erasures_jit", jrs.rs_correct_field_erasures)


def _capture(seed: int, b: int, impair) -> tuple[np.ndarray, np.ndarray]:
    """4 fields of seeded random TS at batch b through the port's CPU
    encoder, impaired: (ts (4, b, 58656), capture (b, 4N) complex64)."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    rng = np.random.default_rng(seed)
    ts = _random_ts(rng, 4, b)
    enc = Encoder(batch=b, device="cpu")
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(4)], -1)
    return ts, impair(iq.astype(np.complex128), rng).astype(np.complex64)


def _multipath(iq, rng):
    """tests/test_adaptive_eq.py's multipath + complex gain + noise."""
    h = np.zeros(24, np.complex128)
    h[0], h[7], h[23] = 0.85 * np.exp(0.4j), 0.2 * np.exp(-1.3j), -0.1 + 0.05j
    y = np.stack([np.convolve(r, h)[: iq.shape[1]] for r in iq])
    return y + (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape)) * 0.01


def _dd_channel(iq, rng):
    """Multipath at 20 dB AWGN: sync-only training leaves uncorrectable
    segments, the decision-directed pass none (tests/test_adaptive_eq.py)."""
    y = np.stack([np.convolve(r, [0.9 * np.exp(0.5j), 0, 0.2 * np.exp(-1.3j), 0, 0.08j])
                  [: iq.shape[1]] for r in iq])
    p = float(np.mean(np.abs(y) ** 2))
    noise = rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape)
    return y + noise * np.sqrt(p / 10 ** (20.0 / 10.0) / 2.0)


def _burst(iq, rng):
    """A 3,000-sample x6 impulse burst at N + 40,000 in every channel
    (tests/test_receiver.py::test_iq_receiver_burst_erasures_recover_impulse_noise)."""
    s0 = N + 40_000
    shape = (iq.shape[0], 3000)
    iq[:, s0 : s0 + 3000] += (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 6.0
    return iq


#: mode -> (capture seed, batch, impairment, IqReceiver kwargs)
RX_MODES = {
    "numpy": (29, 1, lambda iq, rng: iq, dict(backend="numpy")),
    "adaptive": (47, 2, _multipath, dict(backend="adaptive")),
    "adaptive_train_every3": (47, 2, _multipath, dict(backend="adaptive", train_every=3,
                                                      eq_profile="exact")),
    "adaptive_soft": (47, 2, _multipath, dict(backend="adaptive", trellis="soft")),
    "adaptive_dd": (61, 1, _dd_channel, dict(backend="adaptive-dd", eq_profile="exact")),
    "adaptive_sync_only": (61, 1, _dd_channel, dict(backend="adaptive", eq_profile="exact")),
    "erasures_hard": (11, 1, _burst, dict(erasures="burst")),
    "erasures_soft": (11, 1, _burst, dict(erasures="burst", trellis="soft")),
    "numpy_erasures": (11, 1, _burst, dict(backend="numpy", erasures="burst")),
}


@pytest.fixture(scope="module")
def rx_captures():
    """Captures shared by the mode cases, made once per (seed, batch,
    impairment)."""
    cache = {}

    def get(mode):
        seed, b, impair, _ = RX_MODES[mode]
        key = (seed, b, impair)
        if key not in cache:
            cache[key] = _capture(seed, b, impair)
        return cache[key]

    return get


#: modes at 20 dB: their levels agree with JAX's to ~1e-3 (the Gram's low
#: bits, tests/test_torch_adaptive_eq.py), and a symbol that close to a
#: decision boundary may fall the other way, so a segment's byte-error
#: count may differ by one; TS and the RS counters may not
NEAR_THRESHOLD = ("adaptive_dd", "adaptive_sync_only")


@pytest.mark.parametrize("mode", list(RX_MODES))
def test_iq_receiver_modes_match_jax(rx_captures, jax_eager_erasures, mode):
    """Each newly ported IqReceiver mode against JAX's IqReceiver on the
    same capture: identical TS and RS counters (corrected, uncorrectable,
    erasure-assisted) and per-segment error counts (NEAR_THRESHOLD modes:
    within one byte in at most 2 % of the segments), and the sent TS back
    wherever JAX gets it."""
    ts, cap = rx_captures(mode)
    kw = RX_MODES[mode][3]
    rx = trx.IqReceiver(batch=cap.shape[0], device="cpu", **kw)
    got = rx.push(cap[:, :300_001]) + rx.push(cap[:, 300_001:]) + rx.flush()
    jr = jrx.IqReceiver(batch=cap.shape[0], **kw)
    want = jr.push(cap) + jr.flush()
    assert len(got) == len(want) == 3
    for (t, n), (jt, jn) in zip(got, want):
        np.testing.assert_array_equal(t, jt)
        if mode in NEAR_THRESHOLD:
            np.testing.assert_array_equal(n < 0, jn < 0)
            assert np.abs(n - jn).max() <= 1 and (n != jn).mean() <= 0.02
        else:
            np.testing.assert_array_equal(n, jn)
    for name in ("segments_corrected", "segments_uncorrectable", "segments_erasure_assisted"):
        assert getattr(rx.decoder, name) == getattr(jr.decoder, name), name
    exact = all(np.array_equal(t, ts[k]) for k, (t, _) in enumerate(got))
    if mode == "adaptive_sync_only":
        assert rx.decoder.segments_uncorrectable > 0   # dd's reason to exist
    else:
        assert exact and rx.decoder.segments_uncorrectable == 0, mode
    if "erasures" in mode:
        assert rx.decoder.segments_erasure_assisted > 40
    if mode.startswith("adaptive"):
        assert rx.adaptive.state.fields_seen == 4 and rx.adaptive.taps.shape == (cap.shape[0], 515)


def test_zf_without_erasures_fails_the_burst(rx_captures):
    """The burst capture needs the erasure tier: errors-only RS leaves
    uncorrectable segments (as in JAX)."""
    ts, cap = rx_captures("erasures_hard")
    rx = trx.IqReceiver(batch=1, device="cpu")
    rx.push(cap)
    rx.flush()
    assert rx.decoder.segments_uncorrectable > 0


def test_decoder_erasure_flags_match_jax(rx_captures, jax_eager_erasures):
    """Decoder.decode with flags, bit for bit against JAX's Decoder: TS,
    n_errors, counters and the carried flags over three fields, the last
    one without flags (the carry goes on with all-clear flags); then the
    carried flags move from a JAX Decoder into the port through
    utils/convert.py and the next field decodes the same."""
    from atsc_tpu_torch.ops.erasures import burst_erasure_flags_dev
    from atsc_tpu_torch.utils.convert import decoder_state_from_numpy, flag_il_from_numpy

    _, cap = rx_captures("erasures_hard")
    lev = [trx.equalize_field_device(cap, k * N, soft=True, device="cpu") for k in range(4)]
    flags = [burst_erasure_flags_dev(x).numpy() for x in lev]
    sym = [np.clip(np.rint((x.numpy() - P.PILOT_OFFSET + 7.0) / 2.0), 0, 7).astype(np.int8)
           for x in lev]
    jd, td = jdec.Decoder(batch=1), tdec.Decoder(batch=1, device="cpu")
    for k in range(3):
        f = flags[k] if k < 2 else None
        jts, jn = jd.decode(sym[k], erasure_flags=f)
        tts, tn = td.decode(sym[k], erasure_flags=f)
        np.testing.assert_array_equal(tts, jts)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(td.flag_il.numpy(), np.asarray(jd._flag_il))
    assert td.segments_erasure_assisted == jd.segments_erasure_assisted > 40
    assert td.segments_corrected == jd.segments_corrected
    assert td.segments_uncorrectable == jd.segments_uncorrectable == 0
    # the carry from a JAX stream: state + flags into a fresh port Decoder
    td2 = tdec.Decoder(batch=1, device="cpu")
    td2.state = decoder_state_from_numpy(
        {k: np.asarray(v) for k, v in jd.state._asdict().items()}, device="cpu")
    td2.flag_il = flag_il_from_numpy(np.asarray(jd._flag_il), device="cpu")
    jts, jn = jd.decode(sym[3], erasure_flags=flags[3])
    tts, tn = td2.decode(sym[3], erasure_flags=flags[3])
    np.testing.assert_array_equal(tts, jts)
    np.testing.assert_array_equal(tn, jn)
    with pytest.raises(ValueError):
        flag_il_from_numpy(np.zeros((1, 100), np.uint8), device="cpu")


def test_receiver_validation_matches_jax():
    """The options the adaptive and numpy backends bring are validated as
    in JAX: train_every only for adaptive, quantized wire only for the zf
    backend, a margin only for numpy."""
    for kw in (dict(backend="numpy", train_every=2), dict(train_every=2),
               dict(backend="adaptive", wire_format="cs8"),
               dict(backend="adaptive", margin=100), dict(resync="auto"),
               dict(backend="adaptive", train_every=0)):
        with pytest.raises(ValueError):
            jrx.IqReceiver(batch=1, **kw)
        with pytest.raises(ValueError):
            trx.IqReceiver(batch=1, device="cpu", **kw)


def test_cli_decode_adaptive_erasures_matches_jax_cli(tmp_path, jax_eager_erasures):
    """`decode --equalizer adaptive --erasures burst --stats` on a cs8
    capture through multipath with an impulse burst (dequantized on the
    host): the same TS file as the JAX CLI, the sent TS, and --stats with
    segments_erasure_assisted; --train-every 2 and adaptive-dd decode it
    too."""
    import json

    from atsc_tpu import cli as jcli
    from atsc_tpu_torch import cli as tcli
    from atsc_tpu_torch.ops.quantize import QMAX, quantize_scale

    ts, cap = _capture(63, 1, lambda iq, rng: _burst(_multipath(iq, rng), rng))
    s = quantize_scale("cs8")
    codes = np.clip(np.round(np.stack([cap.real, cap.imag], -1) * s), -QMAX["cs8"], QMAX["cs8"])
    path = tmp_path / "cap.cs8"
    codes.astype(np.int8).tofile(path)
    for extra in ([], ["--train-every", "2"], ["--equalizer", "adaptive-dd"]):
        eq = [] if "--equalizer" in extra else ["--equalizer", "adaptive"]
        args = [str(path), "--format", "cs8", *eq, "--erasures", "burst", *extra]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert tcli.main(["decode", *args, "-o", str(tmp_path / "port.ts"),
                              "--device", "cpu", "--stats"]) == 0
        stats = json.loads(err.getvalue().strip().splitlines()[-1])
        got = (tmp_path / "port.ts").read_bytes()
        assert got == ts[:3, 0].tobytes(), extra
        assert stats["fields_decoded"] == 3 and stats["segments_uncorrectable"] == 0
        assert stats["segments_erasure_assisted"] > 0
        if not extra:
            assert jcli.main(["decode", *args, "-o", str(tmp_path / "jax.ts")]) == 0
            assert got == (tmp_path / "jax.ts").read_bytes()


# -- resync and known gaps (tests/test_resync.py) -----------------------------


def test_iq_receiver_resync_matches_jax():
    """tests/test_resync.py:26: 9 fields through a complex gain, 7,019
    samples dropped at 3N + 123,456, pushed in 100,003-sample chunks with
    resync="auto": the same resync_log (a true post-slip boundary with its
    parity) and resyncs as JAX's IqReceiver, and the same, sent TS on the
    fields before the slip and after the re-lock. The three fields emitted
    between the slip and its detection are garbage in both (their bytes
    and byte-error counts follow adaptive levels that agree with JAX's to
    ~1e-3); both flag each of them uncorrectable."""
    from tests.test_torch_acquisition import slipped_capture

    ts, cap, drop = slipped_capture()
    rx = trx.IqReceiver(batch=1, backend="adaptive", resync="auto", device="cpu")
    jr = jrx.IqReceiver(batch=1, backend="adaptive", resync="auto")
    got, want = [], []
    for pos in range(0, cap.shape[1], 100_003):
        got += rx.push(cap[:, pos : pos + 100_003])
        want += jr.push(cap[:, pos : pos + 100_003])
    got += rx.flush()
    want += jr.flush()
    assert rx.resyncs == jr.resyncs == 1
    assert rx.resync_log == jr.resync_log
    m, rem = divmod(rx.resync_log[0]["stream_sample"] + drop, N)
    assert rem == 0 and rx.resync_log[0]["parity"] == m % 2
    assert len(got) == len(want) == rx.fields_emitted == 7
    n_tail = 9 - m - 1
    assert n_tail == 2
    for k in (0, 1, 5, 6):
        (t, n), (jt, jn) = got[k], want[k]
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(t, ts[k if k < 2 else m + k - 5])
    for k in (2, 3, 4):
        assert (got[k][1] < 0).any() and (want[k][1] < 0).any()


def test_iq_receiver_notify_gap_keeps_lock_with_resync():
    """tests/test_resync.py:66: a known 600-sample drop zero-filled by
    notify_gap under resync="auto": no resync, every field exact, the same
    TS, byte-error counts and RS counters as JAX's IqReceiver."""
    from tests.test_torch_acquisition import _encode

    ts = _random_ts(np.random.default_rng(43), 5, 1)
    iq = _encode(ts) * np.exp(0.3j)
    cut, drop = 2 * N + 50_000, 600
    outs = []
    for rx in (trx.IqReceiver(batch=1, backend="adaptive", resync="auto", device="cpu"),
               jrx.IqReceiver(batch=1, backend="adaptive", resync="auto")):
        got = rx.push(iq[:, :cut]) + rx.notify_gap(drop)
        got += rx.push(iq[:, cut + drop:]) + rx.flush()
        assert rx.resyncs == 0 and len(got) == 4
        assert rx.decoder.segments_corrected > 0   # the gap really hit data
        outs.append((got, rx.decoder.segments_corrected))
    (got, corrected), (want, jcorrected) = outs
    assert corrected == jcorrected
    for k, ((t, n), (jt, jn)) in enumerate(zip(got, want)):
        assert (n >= 0).all()
        np.testing.assert_array_equal(t, ts[k])
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(n, jn)
