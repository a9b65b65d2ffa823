"""The hard-decision receive slice of the PyTorch port on the CPU, held
against the JAX package: decode_field on golden symbol fields, the IQ
receiver on golden IQ and on a noisy capture with RS firing, the Decoder
bit for bit, decoder-state conversion, and the decode CLI."""

import contextlib
import io

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


@pytest.mark.parametrize("kw", [dict(backend="adaptive"),
                                dict(viterbi_chunks=2, trellis="soft"),
                                dict(erasures="burst"), dict(backend="numpy"),
                                dict(resync="auto")])
def test_receiver_refuses_unported_options(kw):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        trx.IqReceiver(batch=1, device="cpu", **kw)


@pytest.mark.parametrize("flag", [["--viterbi-chunks", "4"], ["--equalizer", "adaptive"],
                                  ["--mesh", "2x1"], ["--cfo", "auto"], ["--resume"],
                                  ["-o", "slot{ch}.ts"]])
def test_cli_decode_refuses_unported_flags(flag, tmp_path):
    from atsc_tpu_torch import cli as tcli

    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(io.StringIO()):
        tcli.main(["decode", str(tmp_path / "x.iq"), "--device", "cpu", *flag])
    assert exc.value.code == 2


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
