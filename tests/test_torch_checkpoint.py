"""Checkpoint/resume, supervision, profiling, pacing and EncoderConfig of the
PyTorch port, on the CPU: twins of the JAX package's checkpoint tests
(tests/test_streaming_io.py, test_receiver.py, test_mux.py,
test_resample.py, test_resync.py, test_adaptive_eq.py and
test_supervision.py), the file format crossing both ways between the
packages, and the resumes the port refuses (a missing or short output, a
changed decode flag).

A resumed CLI run is held to the port's own uninterrupted run: the two
CLIs stop at --max-fields differently (the JAX CLI finishes its step of
--fields-per-step fields)."""

import contextlib
import glob
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from atsc_tpu.models import encoder as jenc
from atsc_tpu.models import receiver as jrx
from atsc_tpu.utils import checkpoint as jck
from atsc_tpu.utils import config as jconfig
from atsc_tpu.utils import supervision as jsup
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch import params as P
from atsc_tpu_torch.models import receiver as trx
from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
from atsc_tpu_torch.utils import checkpoint as tck
from atsc_tpu_torch.utils import supervision as tsup
from atsc_tpu_torch.utils.config import EncoderConfig

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
FB = P.FIELD_TS_BYTES


def _random_ts(rng, t: int, b: int = 1) -> np.ndarray:
    ts = rng.integers(0, 256, size=(t, b, FB), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _encode_iq(ts: np.ndarray) -> np.ndarray:
    """(F, B, 58656) TS -> (B, F*N) complex64 through the port's CPU encoder."""
    enc = Encoder(batch=ts.shape[1], device="cpu")
    return np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(ts.shape[0])], -1)


def _write_cf32(path, iq: np.ndarray) -> str:
    np.stack([iq.real, iq.imag], -1).astype(np.float32).tofile(path)
    return str(path)


def _decode(argv) -> dict:
    return tcli.run_decode(tcli.build_decode_argparser().parse_args([*argv, "--device", "cpu"]))


def _fields(path, b: int = 1) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, b, FB)


# -- the encoder's state ------------------------------------------------------

def test_checkpoint_resume(golden, tmp_path):
    """tests/test_streaming_io.py:211: two fields, save, load into a fresh
    encoder, two more: bit-identical to four uninterrupted fields."""
    enc = Encoder(batch=1, device="cpu")
    enc.encode_many(golden["input"][:2, None, :])
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, enc.state, fields_encoded=2)
    enc2 = Encoder(batch=1, device="cpu")
    enc2.state, n = tck.load_state(path, device="cpu")
    assert n == 2
    resumed = enc2.encode_many(golden["input"][2:4, None, :])
    ref = Encoder(batch=1, device="cpu").encode_many(golden["input"][:, None, :])
    assert torch.equal(resumed, ref[2:4])


def test_checkpoint_version_mismatch_fails_loudly(golden, tmp_path):
    """tests/test_streaming_io.py:227: a future version, no version stamp,
    and a reshaped leaf each raise an error that names them."""
    enc = Encoder(batch=1, device="cpu")
    enc.encode(golden["input"][:1])
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, enc.state, fields_encoded=1)
    z = dict(np.load(path))
    z["__version__"] = np.asarray(tck.CHECKPOINT_VERSION + 7, dtype=np.int64)
    np.savez(path, **z)
    with pytest.raises(ValueError) as e:
        tck.load_state(path, device="cpu")
    assert str(tck.CHECKPOINT_VERSION + 7) in str(e.value)
    assert str(tck.CHECKPOINT_VERSION) in str(e.value)
    z.pop("__version__")
    np.savez(path, **z)
    with pytest.raises(ValueError, match="version 0"):
        tck.load_state(path, device="cpu")
    tck.save_state(path, enc.state, fields_encoded=1)
    z = dict(np.load(path))
    leaf = next(k for k in z if not k.startswith("__"))
    z[leaf] = z[leaf].reshape(1, -1)[:, :-1]
    np.savez(path, **z)
    with pytest.raises(ValueError, match=leaf):
        tck.load_state(path, device="cpu")
    assert tck.CHECKPOINT_VERSION == jck.CHECKPOINT_VERSION


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encoder_checkpoint_crosses_packages(golden, tmp_path, writer):
    """A checkpoint the JAX package wrote resumes in the port, and one the
    port wrote loads in the JAX package's load_state: the same keys and
    dtypes; the continued fields within 5e-6 of golden."""
    path = str(tmp_path / "ckpt.npz")
    if writer == "jax":
        enc = jenc.Encoder(batch=1, donate=False)
        enc.encode_many(golden["input"][:2, None, :])
        jck.save_state(path, enc.state, fields_encoded=2)
        state, n = tck.load_state(path, device="cpu")
        cont = Encoder(batch=1, device="cpu")
        cont.state = state
    else:
        enc = Encoder(batch=1, device="cpu")
        enc.encode_many(golden["input"][:2, None, :])
        tck.save_state(path, enc.state, fields_encoded=2)
        state, n = jck.load_state(path)
        cont = jenc.Encoder(batch=1, donate=False)
        cont.state = state
    assert n == 2
    with np.load(path) as z:
        kinds = {k: (z[k].dtype, z[k].shape) for k in z.files}
    assert kinds["prev_rs"] == (np.uint8, (1, P.DATA_PER_FIELD))
    assert kinds["phasor"] == (np.float32, (1, 2))
    for k in (2, 3):
        iq = iq_to_complex(np.asarray(cont.encode(golden["input"][k][None])))[0]
        assert np.abs(iq - golden["iq"][k]).max() < 5e-6


# -- the receiver's state -------------------------------------------------------

def test_receiver_checkpoint_resume(tmp_path):
    """tests/test_receiver.py:128: a receiver saved mid-field and reloaded
    continues bit for bit (decoder state, stream window, RS stats)."""
    rng = np.random.default_rng(43)
    ts = _random_ts(rng, 4)
    iq = _encode_iq(ts).copy()
    iq[:, int(1.5 * N): int(1.5 * N) + 25] = 0  # force RS corrections
    ref = trx.IqReceiver(batch=1, device="cpu")
    want = ref.push(iq) + ref.flush()
    cut = N + 12345
    rx = trx.IqReceiver(batch=1, device="cpu")
    got = rx.push(iq[:, :cut])
    path = str(tmp_path / "rx.npz")
    tck.save_receiver(path, rx)
    rx2 = tck.load_receiver(path, device="cpu")
    got += rx2.push(iq[:, cut:]) + rx2.flush()
    assert len(got) == len(want) == 3
    for (a, na), (b, nb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(na, nb)
    assert rx2.decoder.segments_corrected == ref.decoder.segments_corrected > 0


def _noisy(iq, rng, snr_db=20.0):
    sig = np.sqrt(np.mean(np.abs(iq) ** 2))
    noise = rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape)
    return iq + noise * sig * 10 ** (-snr_db / 20) / np.sqrt(2)


def _burst(iq, rng):
    iq = iq.copy()
    iq[:, N + 40_000: N + 43_000] += (rng.normal(size=(iq.shape[0], 3000))
                                      + 1j * rng.normal(size=(iq.shape[0], 3000))) * 6.0
    return iq


def _multipath(iq, rng):
    h = np.zeros(16, np.complex128)
    h[0], h[5] = 0.95, 0.18 * np.exp(1.1j)
    return np.stack([np.convolve(r, h)[: iq.shape[1]] for r in iq])


#: receiver configuration -> (impairment, IqReceiver kwargs): every carry a
#: checkpoint holds (Viterbi metrics exact and chunked, PR metrics, the
#: erasure flags, the RLS equations and cadence)
RX_STATES = {
    "soft": (_noisy, dict(trellis="soft")),
    "soft_chunked": (_noisy, dict(trellis="soft", viterbi_chunks=2)),
    "ntsc_comb": (_noisy, dict(ntsc="comb")),
    "erasures": (_burst, dict(erasures="burst")),
    "adaptive_train_every3": (_multipath, dict(backend="adaptive", train_every=3)),
}


@pytest.mark.parametrize("mode", list(RX_STATES))
def test_receiver_checkpoint_resume_every_state(tmp_path, mode):
    """A receiver saved mid-stream, reloaded, and fed the rest gives the
    same TS and n_errors as the saved one fed the same rest; both the sent
    TS (tests/test_adaptive_eq.py:267 for the cadence)."""
    impair, kw = RX_STATES[mode]
    rng = np.random.default_rng(313)
    ts = _random_ts(rng, 4)
    iq = impair(_encode_iq(ts).astype(np.complex128), rng).astype(np.complex64)
    rx = trx.IqReceiver(batch=1, device="cpu", **kw)
    split = 2 * N + 1234
    first = rx.push(iq[:, :split])
    path = str(tmp_path / "rx.npz")
    tck.save_receiver(path, rx)
    rx2 = tck.load_receiver(path, device="cpu")
    want = rx.push(iq[:, split:]) + rx.flush()
    got = rx2.push(iq[:, split:]) + rx2.flush()
    assert len(first) + len(got) == 3 and len(got) == len(want)
    for (a, na), (b, nb), k in zip(got, want, range(len(first), 3)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(a, ts[k])
    if rx.adaptive is not None:
        assert rx2.adaptive.train_every == 3
        assert rx2.adaptive.state.fields_seen == rx.adaptive.state.fields_seen
    assert rx2.decoder.segments_erasure_assisted == rx.decoder.segments_erasure_assisted


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_receiver_checkpoint_crosses_packages(tmp_path, writer):
    """A receiver checkpoint written by either package resumes in the
    other with the same TS and n_errors as the writer's uninterrupted run."""
    rng = np.random.default_rng(43)
    ts = _random_ts(rng, 4)
    iq = _encode_iq(ts).copy()
    iq[:, int(1.5 * N): int(1.5 * N) + 25] = 0
    cut = N + 12345
    path = str(tmp_path / "rx.npz")
    if writer == "jax":
        rx = jrx.IqReceiver(batch=1)
        first = rx.push(iq[:, :cut])
        jck.save_receiver(path, rx)
        other = tck.load_receiver(path, device="cpu")
    else:
        rx = trx.IqReceiver(batch=1, device="cpu")
        first = rx.push(iq[:, :cut])
        tck.save_receiver(path, rx)
        other = jck.load_receiver(path)
    want = rx.push(iq[:, cut:]) + rx.flush()
    got = other.push(iq[:, cut:]) + other.flush()
    assert len(first) + len(got) == 3 and len(got) == len(want)
    for (a, na), (b, nb), k in zip(got, want, range(len(first), 3)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(a, ts[k])
    assert other.decoder.segments_corrected == rx.decoder.segments_corrected


def test_resync_state_checkpoint_roundtrip(tmp_path):
    """tests/test_resync.py:123: the resync configuration and state."""
    rx = trx.IqReceiver(batch=1, backend="adaptive", resync="auto", resync_after=3,
                        resync_threshold=0.25, device="cpu")
    rx._epoch = 2 * N + 137
    rx.first_field = 1
    rx.resyncs = 2
    rx.resync_log = [{"stream_sample": 137, "parity": 1},
                     {"stream_sample": 2 * N + 137, "parity": 0}]
    rx.fields_emitted = 7
    rx._bad_streak = 1
    path = str(tmp_path / "rx.npz")
    tck.save_receiver(path, rx)
    back = tck.load_receiver(path, device="cpu")
    assert (back.resync, back.resync_after, back.resync_threshold) == ("auto", 3, 0.25)
    assert back._epoch == rx._epoch and back.first_field == 1
    assert back.resyncs == 2 and back.resync_log == rx.resync_log
    assert back.fields_emitted == 7 and back._bad_streak == 1
    assert not back._acquiring


def test_receiver_checkpoint_version_mismatch_fails_loudly(tmp_path):
    """tests/test_streaming_io.py:264."""
    path = str(tmp_path / "rx.npz")
    tck.save_receiver(path, trx.IqReceiver(batch=1, device="cpu"))
    z = dict(np.load(path))
    z["__version__"] = np.asarray(tck.CHECKPOINT_VERSION + 1, dtype=np.int64)
    np.savez(path, **z)
    with pytest.raises(ValueError) as e:
        tck.load_receiver(path, device="cpu")
    assert str(tck.CHECKPOINT_VERSION + 1) in str(e.value)


# -- the CLI's encode -------------------------------------------------------------

def _split_encode(tmp_path, inputs, flags):
    """An uninterrupted encode, and one stopped at 2 fields with a
    checkpoint then resumed into a second file: (full, p1 + p2) bytes."""
    full, p1, p2 = (str(tmp_path / n) for n in ("full.iq", "p1.iq", "p2.iq"))
    ck = str(tmp_path / "state.npz")
    base = [*inputs, "--device", "cpu", *flags]
    assert tcli.main([*base, "-o", full]) == 0
    assert tcli.main([*base, "-o", p1, "--max-fields", "2", "--checkpoint", ck]) == 0
    assert tcli.main([*base, "-o", p2, "--resume", "--checkpoint", ck]) == 0
    assert os.path.getsize(p1) and os.path.getsize(p2)   # a genuine split
    return open(full, "rb").read(), open(p1, "rb").read() + open(p2, "rb").read()


def test_cli_checkpoint_resume(golden, tmp_path):
    """tests/test_streaming_io.py:360."""
    ts = tmp_path / "in.ts"
    ts.write_bytes(golden["input"].reshape(-1).tobytes())
    full, split = _split_encode(tmp_path, [str(ts)], [])
    assert split == full


def test_cli_mux_checkpoint_resume(tmp_path):
    """tests/test_mux.py:116: the muxer's carry rides the checkpoint and a
    checkpointed stop does not flush it; mismatched modes are refused."""
    ts = _random_ts(np.random.default_rng(137), 4, 2)
    a, c = tmp_path / "a.ts", tmp_path / "b.ts"
    ts[:, 0].tofile(a)
    ts[:, 1].tofile(c)
    full, split = _split_encode(tmp_path, [str(a), str(c)], ["--mux"])
    assert split == full
    with pytest.raises(ValueError, match="disagree"):
        tcli.main([str(a), str(c), "-o", str(tmp_path / "p3.iq"), "--resume",
                   "--checkpoint", str(tmp_path / "state.npz"), "--device", "cpu"])


def test_cli_encode_rate_checkpoint_resume(golden, tmp_path):
    """tests/test_resample.py:174: the resampler's exact position and
    buffered window ride the checkpoint."""
    ts = tmp_path / "in.ts"
    ts.write_bytes(golden["input"].reshape(-1).tobytes())
    full, split = _split_encode(tmp_path, [str(ts)], ["--rate", "12e6"])
    assert split == full
    with pytest.raises(ValueError, match="differs"):
        tcli.main([str(ts), "-o", str(tmp_path / "p3.iq"), "--rate", "16e6", "--resume",
                   "--checkpoint", str(tmp_path / "state.npz"), "--device", "cpu"])


# -- the CLI's decode --------------------------------------------------------------

@pytest.fixture(scope="module")
def cap4(tmp_path_factory):
    """4 fields of seeded TS (tests/test_receiver.py:156's draws) as a cf32
    capture file: (ts (4, 58656), path)."""
    ts = _random_ts(np.random.default_rng(47), 4)
    path = tmp_path_factory.mktemp("cap4") / "cap.iq"
    return ts[:, 0], _write_cf32(path, _encode_iq(ts)[0])


def _part(cap, out, ck, *extra):
    _decode([cap, "-o", out, "--checkpoint", ck, "--checkpoint-every", "1",
             "--max-fields", "1", *extra])


def test_cli_decode_checkpoint_resume(cap4, tmp_path):
    """tests/test_receiver.py:156: stop after the first decoded field,
    resume to the end into the same file."""
    ts, cap = cap4
    out, ck = str(tmp_path / "out.ts"), str(tmp_path / "rx.npz")
    _part(cap, out, ck)
    assert _fields(out).shape[0] == 1
    _decode([cap, "-o", out, "--checkpoint", ck, "--resume"])
    np.testing.assert_array_equal(_fields(out)[:, 0], ts[:3])


def test_cli_decode_resume_truncates_post_checkpoint_output(cap4, tmp_path):
    """tests/test_receiver.py:324: output written after the checkpoint is
    cut off on resume; --resume without --checkpoint and a changed --format
    are refused before the output is touched."""
    ts, cap = cap4
    out, ck = str(tmp_path / "out.ts"), str(tmp_path / "rx.npz")
    _part(cap, out, ck)
    with open(out, "ab") as f:
        f.write(bytes(FB))
    _decode([cap, "-o", out, "--checkpoint", ck, "--resume"])
    np.testing.assert_array_equal(_fields(out)[:, 0], ts[:3])
    with pytest.raises(ValueError, match="requires --checkpoint"):
        _decode([cap, "-o", out, "--resume"])
    with pytest.raises(ValueError, match="input format"):
        _decode([cap, "-o", out, "--checkpoint", ck, "--resume", "--format", "cs16"])
    assert os.path.getsize(out) == 3 * FB


@pytest.mark.parametrize("how", ["missing", "short"])
@pytest.mark.parametrize("demux", [False, True])
def test_cli_decode_resume_refuses_lost_output(tmp_path, cap4, how, demux):
    """A resume whose output file is gone, or shorter than the fields
    decoded before the checkpoint, is refused: those fields are lost, and
    writing only the rest would look like a whole stream. (The JAX CLI
    writes only the rest, warning only when the file is short.)"""
    if demux:
        ts = _random_ts(np.random.default_rng(139), 5, 2)
        srcs = [str(tmp_path / f"s{k}.ts") for k in range(2)]
        for k in range(2):
            ts[:, k].tofile(srcs[k])
        cap = str(tmp_path / "wide.iq")
        assert tcli.main([*srcs, "--mux", "-o", cap, "--device", "cpu"]) == 0
        flags = ["--demux", "2"]
    else:
        cap, flags = cap4[1], []
    out, ck = str(tmp_path / "out.ts"), str(tmp_path / "rx.npz")
    _decode([cap, "-o", out, "--checkpoint", ck, "--checkpoint-every", "1",
             "--max-fields", "1", *flags])
    size = os.path.getsize(out)
    assert size >= FB * (2 if demux else 1)
    if how == "missing":
        os.remove(out)
    else:
        os.truncate(out, size - 100)
    with pytest.raises(ValueError, match=how if how == "missing" else "short"):
        _decode([cap, "-o", out, "--checkpoint", ck, "--resume", *flags])
    if how == "short":
        assert os.path.getsize(out) == size - 100


@pytest.mark.parametrize("flag", [["--trellis", "viterbi"], ["--equalizer", "adaptive"],
                                  ["--viterbi-chunks", "2", "--trellis", "viterbi"]])
def test_cli_decode_resume_refuses_changed_flags(cap4, tmp_path, flag):
    """A flag that configures the receiver, given on --resume, must be the
    checkpoint's: the decode continues as it was."""
    _, cap = cap4
    out, ck = str(tmp_path / "out.ts"), str(tmp_path / "rx.npz")
    _part(cap, out, ck)
    with pytest.raises(ValueError, match="cannot change on --resume"):
        _decode([cap, "-o", out, "--checkpoint", ck, "--resume", *flag])
    assert os.path.getsize(out) == FB


@pytest.mark.parametrize("flag", [["--align", "auto"], ["--sro", "auto"], ["--sro", "30"],
                                  ["--rate", "12e6"]])
def test_cli_decode_refuses_checkpoint_of_conditioned_stream(cap4, tmp_path, flag):
    """A checkpoint counts the conditioned stream's samples (after the align
    offset, on the resampled grid): a later --resume without the flag would
    skip to the wrong capture sample. So --checkpoint with such conditioning
    is refused before anything is written, as it is for --demux."""
    _, cap = cap4
    out, ck = str(tmp_path / "out.ts"), str(tmp_path / "rx.npz")
    with pytest.raises(ValueError, match="not checkpointable"):
        _decode([cap, "-o", out, "--checkpoint", ck, *flag])
    assert not os.path.exists(out) and not os.path.exists(ck)


def test_cli_decode_resume_restores_numeric_cfo(tmp_path):
    """tests/test_receiver.py:364: a numeric --cfo comes back from the
    checkpoint, phase-continuous, without being given again."""
    ts = _random_ts(np.random.default_rng(61), 4)
    iq = _encode_iq(ts)[0]
    cap = _write_cf32(tmp_path / "cap.iq",
                      iq * np.exp(2j * np.pi * 80.0 * np.arange(iq.size) / P.SAMPLE_RATE))
    out, ck = str(tmp_path / "out.ts"), str(tmp_path / "rx.npz")
    _part(cap, out, ck, "--cfo", "80.0")
    _decode([cap, "-o", out, "--checkpoint", ck, "--resume"])
    np.testing.assert_array_equal(_fields(out)[:, 0], ts[:3, 0])


def test_cli_demux_checkpoint_resume(tmp_path):
    """tests/test_mux.py:316: the demuxer carry and the wideband read
    cursor ride the receiver checkpoint."""
    ts = _random_ts(np.random.default_rng(139), 5, 2)
    srcs = [str(tmp_path / f"s{k}.ts") for k in range(2)]
    for k in range(2):
        ts[:, k].tofile(srcs[k])
    cap = str(tmp_path / "wide.iq")
    assert tcli.main([*srcs, "--mux", "-o", cap, "--device", "cpu"]) == 0
    full, part, ck = (str(tmp_path / n) for n in ("full.ts", "part.ts", "rx.npz"))
    _decode([cap, "--demux", "2", "-o", full])
    _decode([cap, "--demux", "2", "-o", part, "--checkpoint", ck, "--checkpoint-every", "1",
             "--max-fields", "2"])
    assert 0 < os.path.getsize(part) < os.path.getsize(full)
    _decode([cap, "--demux", "2", "-o", part, "--checkpoint", ck, "--resume"])
    assert open(part, "rb").read() == open(full, "rb").read()
    got = _fields(full, 2)
    np.testing.assert_array_equal(got, ts[: got.shape[0]])


def test_cli_cfo_track_checkpoint_resume_phase(tmp_path):
    """tests/test_resync.py:150: a `--cfo track` run's checkpoint restores
    the corrector's accumulated phase (not the final rate times the
    consumed samples), so the resumed tail decodes exactly."""
    rng = np.random.default_rng(53)
    n_fields = 14
    ts = _random_ts(rng, n_fields)
    iq = _encode_iq(ts)[0]
    n = np.arange(iq.size)
    freq = 150.0 + 30.0 * (n >= 5 * N)
    cap = _write_cf32(tmp_path / "cap.iq",
                      iq * np.exp(2j * np.pi * np.cumsum(freq) / P.SAMPLE_RATE))
    full, part, ck = (str(tmp_path / n) for n in ("full.ts", "part.ts", "c.npz"))
    s = _decode([cap, "--cfo", "track", "--forgetting", "0.0", "-o", full, "--stats"])
    assert s["cfo_retunes"] >= 1
    _decode([cap, "--cfo", "track", "--forgetting", "0.0", "-o", part, "--checkpoint", ck,
             "--checkpoint-every", "4", "--max-fields", "10"])
    _decode([cap, "--forgetting", "0.0", "-o", part, "--checkpoint", ck, "--resume"])
    want, got = _fields(full)[:, 0], _fields(part)[:, 0]
    assert got.shape == want.shape
    for k in range(11, want.shape[0]):
        np.testing.assert_array_equal(want[k], ts[k, 0])
        np.testing.assert_array_equal(got[k], ts[k, 0])


# -- supervision ---------------------------------------------------------------------

def test_iq_bound_admits_real_output(golden, tmp_path):
    """tests/test_supervision.py:14, with IQ_BOUND equal to the JAX
    package's."""
    assert tsup.IQ_BOUND == jsup.IQ_BOUND
    sup = tsup.SupervisedEncoder(batch=1, checkpoint_every=2,
                                 checkpoint_path=str(tmp_path / "ck.npz"), device="cpu")
    ref = Encoder(batch=1, device="cpu")
    for f in range(4):
        iq = sup.encode(golden["input"][f][None])
        want = ref.encode(golden["input"][f][None])
        assert torch.equal(iq, want)
    assert sup.failures == 0 and sup.fields_encoded == 4
    assert float(tsup.iq_health(want)) <= tsup.IQ_BOUND
    assert tsup.iq_health(want).shape == ()


def test_state_corruption_detected_and_recovered(golden, tmp_path):
    """tests/test_supervision.py:29: a NaN phasor is caught, the stream
    rolls back to the checkpoint, replays, and goes on bit for bit."""
    sup = tsup.SupervisedEncoder(batch=1, checkpoint_every=100,
                                 checkpoint_path=str(tmp_path / "ck.npz"), device="cpu")
    iq0 = sup.encode(golden["input"][0][None])
    bad = sup.enc.state._replace(phasor=torch.full_like(sup.enc.state.phasor, float("nan")))
    sup.enc.state = bad
    assert not tsup.state_healthy(bad)
    iq1 = sup.encode(golden["input"][1][None])
    assert sup.failures == 1
    ref = Encoder(batch=1, device="cpu")
    assert torch.equal(iq0, ref.encode(golden["input"][0][None]))
    assert torch.equal(iq1, ref.encode(golden["input"][1][None]))


def test_persistent_fault_raises(golden, tmp_path, monkeypatch):
    """A field that fails again after the rollback is a persistent fault."""
    sup = tsup.SupervisedEncoder(batch=1, checkpoint_path=str(tmp_path / "ck.npz"),
                                 device="cpu")
    monkeypatch.setattr(tsup, "iq_health", lambda iq: torch.tensor(float("inf")))
    with pytest.raises(RuntimeError, match="persistent"):
        sup.encode(golden["input"][0][None])


# -- operations: profile, pacing, the configuration ----------------------------------

def test_cli_profile_writes_a_trace(cap4, tmp_path):
    """--profile on encode and decode writes a torch.profiler Chrome trace
    into the directory and leaves the output as it is without it."""
    ts, cap = cap4
    src = tmp_path / "in.ts"
    ts[:2].tofile(src)
    d = tmp_path / "prof"
    for argv in ([str(src), "-o", str(tmp_path / "a.iq"), "--profile", str(d / "enc")],
                 ["decode", cap, "-o", str(tmp_path / "a.ts"), "--profile", str(d / "dec")]):
        assert tcli.main([*argv, "--device", "cpu"]) == 0
    for sub in ("enc", "dec"):
        (trace,) = glob.glob(str(d / sub / "*.pt.trace.json"))
        with open(trace) as fh:
            assert json.load(fh)["traceEvents"]
    np.testing.assert_array_equal(_fields(tmp_path / "a.ts")[:, 0], ts[:3])


@pytest.mark.parametrize("native", [True, False])
def test_iq_sink_paces(tmp_path, native, monkeypatch):
    """IqSink(pace_bytes_per_sec) holds the bytes to the rate, through the
    native writer thread and without it."""
    from atsc_tpu_torch.runtime import io as tio

    if not native:
        monkeypatch.setattr(tio, "_load", lambda: None)
    elif tio._load() is None:
        pytest.skip("no C++ toolchain for the native runtime")
    sink = tio.IqSink(str(tmp_path / "o.iq"), pace_bytes_per_sec=2e6)
    t0 = time.perf_counter()
    for _ in range(4):
        sink.write(np.zeros(100_000, np.uint8))
    sink.close()
    assert time.perf_counter() - t0 >= 0.19
    assert os.path.getsize(tmp_path / "o.iq") == 400_000


@pytest.mark.parametrize("flags,pace", [
    (["--format", "cs8"], P.SAMPLE_RATE * 2),
    (["-c", "2", "--format", "cs16"], 2 * P.SAMPLE_RATE * 4),
    (["-c", "2", "--mux"], 12e6 * 8),
    (["--rate", "20e6"], 20e6 * 8),
])
def test_cli_realtime_pace(tmp_path, monkeypatch, flags, pace):
    """encode --realtime paces the sink at the JAX CLI's rate: the output
    stream's samples/s times its bytes a sample; without it, unpaced."""
    seen = []
    real = tcli.IqSink

    def sink(path, pace_bytes_per_sec=0.0):
        seen.append(pace_bytes_per_sec)
        return real(path, pace_bytes_per_sec=0.0)

    monkeypatch.setattr(tcli, "IqSink", sink)
    src = tmp_path / "in.ts"
    _random_ts(np.random.default_rng(2), 1)[:, 0].tofile(src)
    for extra in (["--realtime"], []):
        assert tcli.main([str(src), "--device", "cpu", *flags, *extra]) == 0
    assert seen == [pytest.approx(pace, rel=1e-12), 0.0]


def test_encoder_config_matches_jax():
    """EncoderConfig's fields are the JAX package's, the multi-device ones
    (fields_per_step, n_time, n_ch) included, with its defaults;
    validate() raises ValueError on what the JAX one asserts against."""
    import dataclasses

    port = {f.name: f.default for f in dataclasses.fields(EncoderConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.EncoderConfig)}
    assert port == ref
    assert EncoderConfig(channels=4, out_format="cs8").validate().channels == 4
    assert EncoderConfig(channels=4, n_time=2, n_ch=2).validate().n_ch == 2
    for kw in (dict(channels=0), dict(out_format="cs4"), dict(channels=3, n_ch=2),
               dict(fields_per_step=0)):
        with pytest.raises(ValueError):
            EncoderConfig(**kw).validate()
        with pytest.raises(AssertionError):
            jconfig.EncoderConfig(**kw).validate()


def test_cli_encode_resume_checks_the_checkpoint(tmp_path):
    """An encode --resume whose checkpoint holds another channel count is
    refused before the output opens."""
    src = tmp_path / "in.ts"
    _random_ts(np.random.default_rng(4), 2)[:, 0].tofile(src)
    ck = str(tmp_path / "s.npz")
    assert tcli.main([str(src), "-o", str(tmp_path / "a.iq"), "--max-fields", "1",
                      "--checkpoint", ck, "--device", "cpu"]) == 0
    out = tmp_path / "b.iq"
    out.write_bytes(b"precious")
    with pytest.raises(ValueError, match="channels"):
        tcli.main([str(src), "-c", "2", "-o", str(out), "--resume", "--checkpoint", ck,
                   "--device", "cpu"])
    assert out.read_bytes() == b"precious"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main([str(src), "-o", str(out), "--resume", "--checkpoint", ck,
                          "--device", "cpu", "--stats"]) == 0
    assert json.loads(err.getvalue().strip().splitlines()[-1])["fields"] == 1
