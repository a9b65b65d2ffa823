"""The port's multi-device receive path on the CPU: the sharded decoder
against the port's sequential decoder (hard) and against the JAX
package's ShardedDecoder at the seam where a soft tier warms its metrics
(soft, soft-i8, ntsc), the sharded receiver's equalizers and tiers
against the sent TS and the sequential IqReceiver, the sharded-receiver
checkpoint in both packages' hands, and `decode --mesh` against the JAX
CLI: its output, its --stats, its refusals, and where the port departs
from it (a resume whose output is missing or short, --train-every)."""

import numpy as np
import pytest
import torch

from atsc_tpu import cli as jcli
from atsc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from atsc_tpu.parallel.rx_shard import ShardedDecoder as JaxShardedDecoder
from atsc_tpu.parallel.rx_shard import ShardedReceiver as JaxShardedReceiver
from atsc_tpu.utils import checkpoint as jck
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.decoder import Decoder
from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
from atsc_tpu_torch.models.receiver import IqReceiver
from atsc_tpu_torch.ops.assemble import field_levels
from atsc_tpu_torch.ops.quantize import quantize_soft_levels
from atsc_tpu_torch.parallel import rx_shard
from atsc_tpu_torch.parallel.mesh import make_mesh
from atsc_tpu_torch.parallel.rx_shard import ShardedDecoder, ShardedReceiver
from atsc_tpu_torch.utils import checkpoint as tck
from tests.test_torch_distributed import _symbol_fields

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
FB = P.FIELD_TS_BYTES


def _random_ts(seed: int, t: int, b: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=(t, b, FB), dtype=np.uint8)
    ts.reshape(t, b, P.DATA_SEGMENTS, P.MPEG2_BYTES)[..., 0] = 0x47
    return ts


def _cpu_mesh(n_time: int, n_ch: int):
    return make_mesh(n_time, n_ch, ["cpu"] * (n_time * n_ch))


def _encode_iq(ts: np.ndarray) -> np.ndarray:
    """(T, B, 58656) TS -> (B, T*N) complex64 through the port's encoder."""
    enc = Encoder(batch=ts.shape[1], device="cpu")
    return np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(ts.shape[0])], -1)


def _write_cf32(path, iq: np.ndarray) -> str:
    """(B, T*N) complex -> an interleaved-per-field cf32 capture file."""
    b = iq.shape[0]
    flat = iq.reshape(b, -1, N).transpose(1, 0, 2).reshape(-1)
    np.stack([flat.real, flat.imag], -1).astype(np.float32).tofile(path)
    return str(path)


# -- the symbol-field decoder ----------------------------------------------

@pytest.mark.parametrize("n_time,n_ch,f_dev", [(2, 2, 1), (4, 1, 1), (1, 2, 2)])
def test_sharded_hard_decoder_equals_sequential(n_time, n_ch, f_dev):
    """Two sharded steps, with symbol errors injected inside RS's budget,
    give the sequential Decoder's TS and error counts, field for field,
    and its carried state exactly."""
    t = n_time * f_dev
    ts = _random_ts(61, 2 * t, n_ch)
    fields = _symbol_fields(ts)
    fields[1, 0, 5000:5012] ^= 3
    dec = ShardedDecoder(_cpu_mesh(n_time, n_ch), batch=n_ch, fields_per_device=f_dev)
    got = [dec.decode(fields[:t]), dec.decode(fields[t:])]
    got_ts = np.concatenate([g[0] for g in got])
    got_err = np.concatenate([g[1] for g in got])
    seq = Decoder(batch=n_ch, device="cpu")
    for k in range(2 * t):
        want_ts, want_err = seq.decode(fields[k])
        np.testing.assert_array_equal(got_ts[k], want_ts)
        np.testing.assert_array_equal(got_err[k], want_err)
    assert dec.segments_corrected == seq.segments_corrected > 0
    for k in range(1, 2 * t):
        np.testing.assert_array_equal(got_ts[k], ts[k - 1])
    for name in ("prev_il", "z2_prev"):
        np.testing.assert_array_equal(getattr(dec.state, name),
                                      getattr(seq.state, name).numpy())


def _pr_scan_np(obs: np.ndarray) -> np.ndarray:
    """A float32 numpy replay of the JAX package's _pr_acs_scan(zeros,
    (obs, reset, const), 16) over a field's last W positions, every op
    rounded on its own (numpy never contracts a multiply-add)."""
    from atsc_tpu.ops.ntsc import _pr_reset_tables, _pr_tables

    lv, s_pred, _, prev_lev = (np.asarray(a) for a in _pr_tables())
    reset, const = _pr_reset_tables()
    w = obs.shape[-1]
    reset, const = reset[-w:], const[-w:]
    m = np.zeros(obs.shape[:2] + (16,), np.float32)
    for i in range(w):
        mr = m.reshape(*m.shape[:-1], 4, 4)
        m_pred = np.stack([mr[..., int(s_pred[u]), :] for u in range(16)], axis=-2)
        prev = np.where(reset[i][:, None, None], const[i][:, None, None], prev_lev)
        e = (obs[..., i][..., None, None] - lv[:, None]).astype(np.float32) + prev
        m = np.min(m_pred + e * e, axis=-1)
        if i % 16 == 15:
            m = m - m.min(axis=-1, keepdims=True)
    return m


@pytest.mark.parametrize("tier", ["soft", "soft-i8", "pr"])
def test_warm_metrics_equal_the_jax_scan(tier):
    """The seam warm-up on random observations: the 4-state tiers equal the
    JAX package's _acs_scan(zeros, obs, 16) bit for bit. The PR warm-up
    equals a float32 replay of _pr_acs_scan(zeros, xs, 16) that rounds
    every op (the kernels' arithmetic) bit for bit, and XLA:CPU's
    _pr_acs_scan, which contracts the candidate m + e*e into an FMA,
    within the PR tier's tolerance."""
    import jax.numpy as jnp

    from atsc_tpu.ops.ntsc import _pr_acs_scan, _pr_reset_tables
    from atsc_tpu.ops.quantize import SOFT_LEVEL_INV
    from atsc_tpu.ops.viterbi import _acs_scan

    rng = np.random.default_rng(5)
    obs = (rng.normal(size=(3, 12, rx_shard.WARMUP)) * 4).astype(np.float32)
    if tier == "pr":
        reset, const = _pr_reset_tables()
        xs = (jnp.moveaxis(jnp.asarray(obs), -1, 0), jnp.asarray(reset[-128:]),
              jnp.asarray(const[-128:]))
        want, _ = _pr_acs_scan(jnp.zeros((3, 12, 16), jnp.float32), xs, 16)
        got = rx_shard.warm_pr_metrics(torch.from_numpy(obs)).numpy()
        np.testing.assert_array_equal(got, _pr_scan_np(obs))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-3)
        return
    x = obs
    if tier == "soft-i8":
        x = np.clip(np.round(obs * 10), -127, 127).astype(np.int8)
        jobs = jnp.asarray(x).astype(jnp.float32) * jnp.float32(SOFT_LEVEL_INV)
    else:
        jobs = jnp.asarray(x)
    want, _ = _acs_scan(jnp.zeros((3, 12, 4), jnp.float32), jnp.moveaxis(jobs, -1, 0), 16)
    got = rx_shard.warm_metrics(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tier", ["soft", "soft-i8", "ntsc"])
def test_sharded_ml_decoder_matches_jax(tier):
    """On a 2x1 mesh the second time shard warms its metrics over the first
    shard's last 128 observations (a sharded soft decode differs from the
    sequential one at seams by design): over one step (two for soft, so
    the carried metrics start the next) the decoded bytes
    equal the JAX package's ShardedDecoder and the sent TS, and the
    carried metrics are bit-identical."""
    ts = _random_ts(103, 4, 1)
    levels = field_levels(torch.from_numpy(_symbol_fields(ts))).numpy()
    x = quantize_soft_levels(torch.from_numpy(levels)).numpy() if tier == "soft-i8" else levels
    steps = 2 if tier == "soft" else 1
    x = x[: 2 * steps]
    dec = ShardedDecoder(_cpu_mesh(2, 1), batch=1, trellis=tier)
    jdec = JaxShardedDecoder(jax_make_mesh(2, 1), batch=1, trellis=tier)
    got = np.concatenate([dec.decode(x[2 * i : 2 * i + 2])[0] for i in range(steps)])
    want = np.concatenate([jdec.decode(x[2 * i : 2 * i + 2])[0] for i in range(steps)])
    np.testing.assert_array_equal(got, want)
    for k in range(1, 2 * steps):
        np.testing.assert_array_equal(got[k], ts[k - 1])
    np.testing.assert_array_equal(dec.state.metrics, np.asarray(jdec.state.metrics))
    np.testing.assert_array_equal(dec.state.z2_prev, np.asarray(jdec.state.z2_prev))


# -- the receive chain -----------------------------------------------------

def _two_steps(rx, iq: np.ndarray, t: int) -> np.ndarray:
    """Decode 2t fields of iq (B, 2t*N) in two steps with real context at
    the seam and zeros at the stream's ends."""
    b, m = iq.shape[0], 384
    z = np.zeros((b, m), iq.dtype)
    a, _ = rx.decode_iq(np.concatenate([z, iq[:, : t * N + m]], 1), with_context=True)
    c, _ = rx.decode_iq(np.concatenate([iq[:, t * N - m :], z], 1), with_context=True)
    return np.concatenate([a, c])


@pytest.mark.parametrize("kw,mesh,f_dev", [
    (dict(), (2, 2), 1),
    (dict(trellis="soft-i8"), (2, 1), 1),
    (dict(equalizer="adaptive"), (2, 1), 1),
    (dict(equalizer="adaptive-dd", train_every=2), (1, 2), 2),
])
def test_sharded_receiver_equals_sequential(kw, mesh, f_dev):
    """Planar IQ in: the TS equals the sent TS and the sequential
    IqReceiver's (forgetting 0 for the adaptive tiers, whose per-field
    training is the sharded one), over two steps."""
    b = mesh[1]
    t = mesh[0] * f_dev
    ts = _random_ts(71, 2 * t, b)
    iq = _encode_iq(ts)
    rx = ShardedReceiver(_cpu_mesh(*mesh), batch=b, fields_per_device=f_dev, **kw)
    got = _two_steps(rx, iq, t)
    eq = kw.get("equalizer", "device")
    seq = IqReceiver(batch=b, backend="device" if eq == "zf" else eq, forgetting=0.0,
                     trellis=kw.get("trellis", "hard"), train_every=kw.get("train_every", 1),
                     device="cpu")
    want = seq.push(iq) + seq.flush()
    for k in range(1, 2 * t):
        np.testing.assert_array_equal(got[k], ts[k - 1])
        np.testing.assert_array_equal(got[k], want[k - 1][0])
    assert rx.segments_uncorrectable == 0


def test_sharded_receiver_cs8_windows():
    """A cs8 capture's codes go up verbatim (decode_codes) and decode to
    the sent TS, as the sequential receiver's push_codes does."""
    ts = _random_ts(79, 2, 1)
    enc = Encoder(batch=1, out_format="cs8", device="cpu")
    codes = np.concatenate([np.moveaxis(enc.encode(ts[k]).numpy()[..., :N], -2, -1)
                            for k in range(2)], axis=1)        # (1, 2N, 2) int8
    rx = ShardedReceiver(_cpu_mesh(2, 1), batch=1, wire_format="cs8")
    got, nerr = rx.decode_codes(codes)
    np.testing.assert_array_equal(got[1], ts[0])
    assert (nerr >= 0).all()
    seq = IqReceiver(batch=1, wire_format="cs8", device="cpu")
    want = seq.push_codes(codes) + seq.flush()
    np.testing.assert_array_equal(got[1], want[0][0])
    with pytest.raises(ValueError, match="use decode_codes"):
        rx.decode_iq(np.zeros((1, 2 * N), np.complex64))


@pytest.mark.parametrize("kw,match", [
    (dict(equalizer="lms"), "unknown equalizer"),
    (dict(trellis="soft-i4"), "unknown trellis mode"),
    (dict(wire_format="cs4"), "unknown wire format"),
    (dict(equalizer="adaptive", trellis="soft"), "shard with the zf equalizer"),
    (dict(train_every=2), "zf does not train"),
    (dict(equalizer="adaptive", train_every=2), "must divide fields_per_device=1"),
])
def test_sharded_receiver_refusals_are_the_jax_ones(kw, match):
    mesh = _cpu_mesh(2, 1)
    with pytest.raises(ValueError, match=match):
        ShardedReceiver(mesh, batch=1, **kw)
    with pytest.raises(ValueError, match=match):
        JaxShardedReceiver(jax_make_mesh(2, 1), batch=1, **kw)


def test_rx_shard_dryrun():
    rx_shard.dryrun(1, ["cpu"])


# -- checkpoints ------------------------------------------------------------

def test_sharded_receiver_checkpoint_crosses_packages(tmp_path):
    """A port checkpoint of a soft sharded receiver restores into the JAX
    package's (which ignores the port's train_every key), and the JAX
    package's save of that restores here: the same leaves, progress and
    RS counters both ways."""
    ts = _random_ts(83, 2, 1)
    rx = ShardedReceiver(_cpu_mesh(2, 1), batch=1, trellis="soft")
    rx.decode_iq(_encode_iq(ts))
    rx.segments_corrected = 3
    path = str(tmp_path / "p.npz")
    tck.save_sharded_receiver(path, rx, extra={"fields_emitted": 1})
    jrx = JaxShardedReceiver(jax_make_mesh(2, 1), batch=1, trellis="soft")
    assert jck.restore_sharded_receiver(path, jrx) == {"fields_emitted": 1}
    for name in ("prev_il", "z2_prev", "metrics"):
        np.testing.assert_array_equal(np.asarray(getattr(jrx._state, name)),
                                      getattr(rx.state, name))
    assert (jrx._next_field, jrx.segments_corrected) == (2, 3)
    back = str(tmp_path / "j.npz")
    jck.save_sharded_receiver(back, jrx, extra={"fields_emitted": 1})
    rx2 = ShardedReceiver(_cpu_mesh(2, 1), batch=1, trellis="soft")
    assert tck.restore_sharded_receiver(back, rx2) == {"fields_emitted": 1}
    for name in ("prev_il", "z2_prev", "metrics"):
        np.testing.assert_array_equal(getattr(rx2.state, name), getattr(rx.state, name))
    assert (rx2._next_field, rx2.segments_corrected) == (2, 3)


def test_sharded_checkpoint_records_train_every(tmp_path):
    """The retrain cadence is saved, and a receiver with another cadence
    (or another tier) refuses the file."""
    rx = ShardedReceiver(_cpu_mesh(1, 1), batch=1, fields_per_device=2,
                         equalizer="adaptive", train_every=2)
    path = str(tmp_path / "c.npz")
    tck.save_sharded_receiver(path, rx)
    with np.load(path) as z:
        assert int(z["train_every"]) == 2
    other = ShardedReceiver(_cpu_mesh(1, 1), batch=1, fields_per_device=2,
                            equalizer="adaptive")
    with pytest.raises(ValueError, match="train_every=2, but this decode runs train_every=1"):
        tck.restore_sharded_receiver(path, other)
    with pytest.raises(ValueError, match="trellis=hard, but this decode runs trellis=soft"):
        tck.restore_sharded_receiver(path, ShardedReceiver(
            _cpu_mesh(1, 1), batch=1, fields_per_device=2, trellis="soft"))


# -- decode --mesh -----------------------------------------------------------

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A clean 5-field, 2-channel cf32 capture and its sent TS."""
    ts = _random_ts(89, 5, 2)
    path = tmp_path_factory.mktemp("cap") / "cap.iq"
    return _write_cf32(path, _encode_iq(ts)), ts


def _port_decode(argv) -> dict:
    return tcli.run_decode(tcli.build_decode_argparser().parse_args([*argv, "--device", "cpu"]))


def _jax_decode(argv) -> dict:
    return jcli.run_decode(jcli.build_decode_argparser().parse_args(argv))


def test_cli_decode_mesh_matches_the_jax_cli(tmp_path, capture, capsys):
    """`decode --mesh 2x2` on a clean capture: the TS equals the JAX CLI's
    --mesh decode and the sent TS, and --stats agrees on every shared key;
    the placement is on stderr and in --stats."""
    cap, ts = capture
    argv = ["-c", "2", "--mesh", "2x2", "--fields-per-step", "2", "--stats"]
    got = _port_decode([cap, "-o", str(tmp_path / "p.ts"), *argv])
    want = _jax_decode([cap, "-o", str(tmp_path / "j.ts"), *argv])
    assert (tmp_path / "p.ts").read_bytes() == (tmp_path / "j.ts").read_bytes()
    out = np.fromfile(tmp_path / "p.ts", np.uint8).reshape(4, 2, FB)
    np.testing.assert_array_equal(out, ts[:4])
    assert {k: got[k] for k in want} == want
    assert got["devices"] == ["cpu"] * 4
    assert "decode --mesh: 4 shards on 1 cpu device(s)" in capsys.readouterr().err


def test_cli_decode_mesh_ntsc_tier(tmp_path, capture):
    """An ML tier under --mesh (the comb: equalized float levels through
    the sharded PR Viterbi) decodes the clean capture to the sent TS."""
    cap, ts = capture
    s = _port_decode([cap, "-o", str(tmp_path / "o.ts"), "-c", "2", "--mesh", "2x1",
                      "--fields-per-step", "2", "--ntsc", "comb"])
    assert s["fields_decoded"] == 4 and s["segments_uncorrectable"] == 0
    np.testing.assert_array_equal(np.fromfile(tmp_path / "o.ts", np.uint8).reshape(4, 2, FB),
                                  ts[:4])


def test_cli_decode_mesh_checkpoint_resume(tmp_path, capture):
    """A checkpointed --mesh decode stopped at --max-fields and resumed is
    byte-identical to the unbroken run; a resume whose output is missing
    or short is refused (the JAX CLI writes only the rest), leaving it
    untouched."""
    cap, _ = capture
    whole = tmp_path / "whole.ts"
    _port_decode([cap, "-o", str(whole), "-c", "2", "--mesh", "2x1", "--fields-per-step", "2"])
    out, ck = tmp_path / "r.ts", str(tmp_path / "r.npz")
    flags = ["-c", "2", "--mesh", "2x1", "--fields-per-step", "2", "--checkpoint", ck]
    first = _port_decode([cap, "-o", str(out), *flags, "--max-fields", "1",
                          "--checkpoint-every", "1"])
    assert first["fields_decoded"] == 1
    saved = out.read_bytes()
    out.unlink()
    with pytest.raises(ValueError, match="is missing"):
        _port_decode([cap, "-o", str(out), *flags, "--resume"])
    out.write_bytes(saved[:-1])
    with pytest.raises(ValueError, match="1 short of the 1 fields"):
        _port_decode([cap, "-o", str(out), *flags, "--resume"])
    assert out.read_bytes() == saved[:-1]
    out.write_bytes(saved + b"junk")
    _port_decode([cap, "-o", str(out), *flags, "--resume"])
    assert out.read_bytes() == whole.read_bytes()


def test_cli_decode_mesh_train_every_reaches_the_receiver(tmp_path, capture, monkeypatch):
    """--train-every K reaches the sharded receiver (the JAX CLI drops it)
    and its checkpoint records K."""
    cap, ts = capture
    seen = []

    class Spy(ShardedReceiver):
        def __init__(self, *a, **kw):
            seen.append(kw.get("train_every"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(tcli, "ShardedReceiver", Spy)
    ck = str(tmp_path / "a.npz")
    _port_decode([cap, "-o", str(tmp_path / "a.ts"), "-c", "2", "--mesh", "1x2",
                  "--fields-per-step", "2", "--equalizer", "adaptive", "--train-every", "2",
                  "--checkpoint", ck])
    assert seen == [2]
    with np.load(ck) as z:
        assert int(z["train_every"]) == 2
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "a.ts", np.uint8).reshape(4, 2, FB), ts[:4])


@pytest.mark.parametrize("flags", [
    ["--sro", "5"], ["--rate", "20e6"], ["--forgetting", "0.5"], ["--erasures", "burst"],
    ["--resync", "auto"], ["--viterbi-chunks", "24", "--trellis", "viterbi"],
    ["--ntsc", "auto"], ["--cfo", "track"], ["--ntsc", "comb", "--trellis", "viterbi"],
    ["--equalizer", "adaptive", "--trellis", "viterbi"],
    ["--cfo", "100", "--checkpoint", "c.npz"], ["--resume"],
    ["--resume", "--checkpoint", "c.npz", "-o", "s{ch}.ts"],
    ["-c", "2", "--in-soapy"], ["--resume", "--checkpoint", "c.npz", "--in-soapy"],
])
def test_cli_decode_mesh_refusals_are_the_jax_clis(tmp_path, flags):
    """Every refusal of the JAX CLI's run_decode_mesh, word for word."""
    src = "soapy" if "--in-soapy" in flags else str(tmp_path / "none.iq")
    flags = [f for f in flags if f != "--in-soapy"]
    argv = [src, "-o", str(tmp_path / "o.ts"), "--mesh", "2x1", *flags]
    with pytest.raises(ValueError) as want:
        _jax_decode(argv)
    with pytest.raises(ValueError) as got:
        _port_decode(argv)
    assert str(got.value) == str(want.value)


def test_cli_decode_mesh_parse_error_is_the_jax_clis(tmp_path):
    argv = [str(tmp_path / "none.iq"), "--mesh", "2by2"]
    with pytest.raises(ValueError) as want:
        _jax_decode(argv)
    with pytest.raises(ValueError) as got:
        _port_decode(argv)
    assert str(got.value) == str(want.value) == "--mesh wants TIMExCH (e.g. 4x2), got '2by2'"
