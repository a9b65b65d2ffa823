"""The port's multi-device encode path on the CPU: meshes of repeated CPU
devices (the counterpart of the JAX package's 8 virtual devices), the
field-sharded encoder against the port's sequential encoder (bit for bit)
and against the JAX package's ShardedEncoder, the sample-sharded filter
against JAX's and golden's IQ, and `encode --mesh` through the CLI."""

import numpy as np
import pytest
import torch

from atsc_tpu.parallel.field_shard import ShardedEncoder as JaxShardedEncoder
from atsc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from atsc_tpu.parallel.sample_shard import SP_AXIS as JAX_SP_AXIS
from atsc_tpu.parallel.sample_shard import SampleShardedFilter as JaxSampleShardedFilter
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch import params as P
from atsc_tpu_torch.models.encoder import encode_fields, init_state
from atsc_tpu_torch.parallel import field_shard, sample_shard
from atsc_tpu_torch.parallel.field_shard import ShardedEncoder
from atsc_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, gather, make_mesh, place
from atsc_tpu_torch.parallel.sample_shard import SP_AXIS, SampleShardedFilter
from atsc_tpu_torch.tables.oscillator import phasor_for_field

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
FB = P.FIELD_TS_BYTES


def _random_ts(seed: int, t: int, b: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=(t, b, FB), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _cpu_mesh(n_time: int, n_ch: int) -> Mesh:
    return make_mesh(n_time, n_ch, ["cpu"] * (n_time * n_ch))


# -- meshes and placement -------------------------------------------------

def test_make_mesh_places_row_major_and_refuses_too_few_devices():
    """Shard (t, c) takes devices[t * n_ch + c]; a list may repeat a
    device; more shards than devices is refused, and with no list the
    visible CUDA devices (none here) are the devices."""
    mesh = _cpu_mesh(2, 3)
    assert mesh.shape == {TIME_AXIS: 2, CH_AXIS: 3}
    assert mesh.local() == mesh.coords() and len(mesh.coords()) == 6
    assert all(mesh.device(c) == torch.device("cpu") for c in mesh.coords())
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_mesh(2, 1)


def test_place_and_gather_round_trip():
    """A (T, B, n) array split over time and channels and replicated
    state gather back to the full arrays; a channel count that does not
    divide over the shards is refused."""
    mesh = _cpu_mesh(2, 2)
    x = np.arange(4 * 6 * 5, dtype=np.int32).reshape(4, 6, 5)
    parts = place(x, mesh, (TIME_AXIS, CH_AXIS))
    assert tuple(parts[(1, 0)].shape) == (2, 3, 5)
    np.testing.assert_array_equal(parts[(1, 0)].numpy(), x[2:, :3])
    np.testing.assert_array_equal(gather(parts, mesh, (TIME_AXIS, CH_AXIS)), x)
    rep = place(x[0], mesh, (CH_AXIS, None))
    np.testing.assert_array_equal(rep[(0, 1)].numpy(), rep[(1, 1)].numpy())
    np.testing.assert_array_equal(gather(rep, mesh, (CH_AXIS, None)), x[0])
    with pytest.raises(ValueError, match="does not divide"):
        place(np.zeros((5, 5)), mesh, (CH_AXIS,))


# -- the field-sharded encoder -------------------------------------------

@pytest.mark.parametrize("n_time,n_ch,f_dev,fmt", [
    (2, 2, 1, "cf32"), (4, 1, 1, "cs8"), (1, 4, 1, "cf32"), (2, 2, 2, "cs8"),
    (2, 1, 2, "cs16"),
])
def test_sharded_encoder_equals_sequential(n_time, n_ch, f_dev, fmt):
    """Two consecutive sharded steps equal the port's sequential
    encode_fields over the same fields bit for bit: the IQ (or codes) and
    every carried state leaf, phasor included."""
    t_total = n_time * f_dev
    batch = n_ch
    ts = _random_ts(7, 2 * t_total, batch)
    seq_state, seq_iq = encode_fields(init_state(batch, device="cpu"),
                                      torch.from_numpy(ts), out_format=fmt)
    enc = ShardedEncoder(_cpu_mesh(n_time, n_ch), batch=batch,
                         fields_per_device=f_dev, out_format=fmt)
    state = enc.init_state()
    state, iq1 = enc.step(state, ts[:t_total])
    state, iq2 = enc.step(state, ts[t_total:])
    got = np.concatenate([enc.gather_iq(iq1), enc.gather_iq(iq2)])
    np.testing.assert_array_equal(got, seq_iq.numpy())
    full = enc.gather_state(state)
    for name in full._fields:
        np.testing.assert_array_equal(getattr(full, name),
                                      getattr(seq_state, name).numpy(), err_msg=name)


def test_sharded_encoder_starts_at_a_field_index_and_refuses_bad_batches():
    """init_state(field_index) sets the closed-form parity and phasor as
    the sequential init_state does; a batch that does not divide over the
    channel shards and an unknown format are refused."""
    enc = ShardedEncoder(_cpu_mesh(2, 2), batch=2)
    full = enc.gather_state(enc.init_state(field_index=5))
    ref = init_state(2, 5, device="cpu")
    np.testing.assert_array_equal(full.phasor, ref.phasor.numpy())
    np.testing.assert_array_equal(full.parity, ref.parity.numpy())
    with pytest.raises(ValueError, match="does not divide"):
        ShardedEncoder(_cpu_mesh(1, 2), batch=3)
    with pytest.raises(ValueError, match="unknown out_format"):
        ShardedEncoder(_cpu_mesh(1, 2), batch=2, out_format="cs4")


@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_sharded_encoder_matches_jax(fmt):
    """Against the JAX package's ShardedEncoder on a 2x2 mesh, two steps:
    the RS field and every integer state leaf exact, the phasor within
    1 ulp (XLA:CPU contracts the JAX recurrence into FMAs and drifts),
    IQ within 5e-6, codes within 1 LSB."""
    ts = _random_ts(11, 4, 2)
    jenc = JaxShardedEncoder(jax_make_mesh(2, 2), batch=2, out_format=fmt)
    jst = jenc.init_state()
    jst, j1 = jenc.step(jst, ts[:2])
    jst, j2 = jenc.step(jst, ts[2:])
    want = np.concatenate([np.asarray(j1), np.asarray(j2)])[..., :N]
    enc = ShardedEncoder(_cpu_mesh(2, 2), batch=2, out_format=fmt)
    st = enc.init_state()
    st, p1 = enc.step(st, ts[:2])
    st, p2 = enc.step(st, ts[2:])
    got = np.concatenate([enc.gather_iq(p1), enc.gather_iq(p2)])[..., :N]
    full = enc.gather_state(st)
    for name in ("prev_rs", "trellis_d", "trellis_d1", "trellis_d2", "saved", "parity"):
        np.testing.assert_array_equal(getattr(full, name), np.asarray(getattr(jst, name)))
    ulps = np.abs(full.phasor.view(np.int32) - np.asarray(jst.phasor).view(np.int32))
    assert ulps.max() <= 1
    if fmt == "cf32":
        assert np.abs(got - want).max() <= 5e-6
    else:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_tail_encoders_are_the_assembled_reserved_symbols():
    """The 12 symbols the sharded step hands to the next field are the
    ones the sequential assemble stage saves."""
    from atsc_tpu_torch.ops.assemble import assemble_field_structured

    sym = torch.from_numpy(np.random.default_rng(3).integers(
        0, 8, size=(2, P.TRELLIS_ENCODERS, P.TRELLIS_SYMBOLS_PER_ENCODER), dtype=np.int8))
    _, saved = assemble_field_structured(sym, torch.zeros(2, dtype=torch.int32),
                                         torch.zeros((2, 12), dtype=torch.int8))
    tails = sym[:, torch.as_tensor(field_shard._tail_encoders()), -1]
    np.testing.assert_array_equal(tails.numpy(), saved.numpy())


def test_field_shard_dryrun():
    field_shard.dryrun(4, ["cpu"] * 4)


# -- the sample-sharded filter --------------------------------------------

@pytest.mark.parametrize("n_sp", [2, 4])
def test_sample_sharded_filter_matches_jax_and_golden(golden, n_sp):
    """The overlap-save filter over n_sp shards: golden's 4 fields within
    5e-6 of golden's IQ and of the JAX package's SampleShardedFilter."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    lev = golden["sync"].real.astype(np.float32)[:, :N]
    ph = np.stack([[phasor_for_field(f).real, phasor_for_field(f).imag]
                   for f in range(4)]).astype(np.float32)
    parity = np.asarray([0, 1, 0, 1], np.int32)
    got = SampleShardedFilter(Mesh(["cpu"] * n_sp, (SP_AXIS,)))(lev, ph, parity).numpy()
    jfilt = JaxSampleShardedFilter(JaxMesh(np.asarray(jax.devices()[:n_sp]), (JAX_SP_AXIS,)))
    want = np.asarray(jfilt(lev, ph, parity))
    assert got.shape == (4, N, 2)
    assert np.abs(got - want).max() < 5e-6
    got_c = got[..., 0] + 1j * got[..., 1]
    assert np.abs(got_c - golden["iq"]).max() < 5e-6


def test_sample_shard_refusals_and_dryrun():
    with pytest.raises(ValueError, match="'sp' axis"):
        SampleShardedFilter(_cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="must divide"):
        SampleShardedFilter(Mesh(["cpu"] * 3, (SP_AXIS,)))
    sample_shard.dryrun(2, ["cpu", "cpu"])


# -- encode --mesh ----------------------------------------------------------

def _encode(tmp_path, name, ts_paths, *flags) -> bytes:
    out = tmp_path / name
    assert tcli.main([*ts_paths, "-o", str(out), "--device", "cpu", *flags]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("fmt,mesh,fps", [("cf32", "2x2", "4"), ("cs8", "2x2", "2"),
                                          ("cs16", "4x1", "4")])
def test_cli_encode_mesh_equals_plain(tmp_path, capsys, fmt, mesh, fps):
    """`encode --mesh` gives the plain encode's bytes (five fields, so the
    last step is zero-padded), prints the shards' placement on stderr, and
    reports it in --stats."""
    ts = _random_ts(19, 5, 2)
    paths = []
    for c in range(2):
        ts[:, c].tofile(tmp_path / f"in{c}.ts")
        paths.append(str(tmp_path / f"in{c}.ts"))
    plain = _encode(tmp_path, "plain.iq", paths, "--format", fmt)
    got = _encode(tmp_path, "mesh.iq", paths, "--format", fmt, "--mesh", mesh,
                  "--fields-per-step", fps, "--stats")
    assert got == plain
    err = capsys.readouterr().err
    assert "encode --mesh: 4 shards on 1 cpu device(s)" in err
    assert '"devices": ["cpu", "cpu", "cpu", "cpu"]' in err


def test_cli_encode_mesh_checkpoint_resume(tmp_path):
    """A checkpointed --mesh encode stopped at --max-fields and resumed
    from its checkpoint writes the unbroken run's bytes; the zero-padded
    EOF step (the fifth field) leaves the checkpoint at the last whole
    step, as the JAX CLI does."""
    ts = _random_ts(23, 5, 1)[:, 0]
    src = tmp_path / "in.ts"
    ts.tofile(src)
    ck = str(tmp_path / "s.npz")
    plain = _encode(tmp_path, "plain.iq", [str(src)])
    flags = ["--mesh", "2x1", "--fields-per-step", "2", "--checkpoint", ck,
             "--checkpoint-every", "1"]
    first = _encode(tmp_path, "p1.iq", [str(src)], *flags, "--max-fields", "2")
    with np.load(ck) as z:
        assert int(z["__fields_encoded__"]) == 2
    rest = _encode(tmp_path, "p2.iq", [str(src)], *flags, "--resume")
    assert first + rest == plain
    with np.load(ck) as z:
        assert int(z["__fields_encoded__"]) == 4


@pytest.mark.parametrize("argv,want", [
    (["--mesh", "2by2"], "error: --mesh wants TIMExCH (e.g. 4x2), got '2by2'"),
])
def test_cli_encode_mesh_parse_error_is_the_jax_clis(tmp_path, capsys, argv, want):
    from atsc_tpu import cli as jcli

    src = tmp_path / "in.ts"
    _random_ts(2, 1, 1).tofile(src)
    assert tcli.main([str(src), "--device", "cpu", *argv]) == 2
    assert want in capsys.readouterr().err
    assert jcli.main([str(src), *argv]) == 2
    assert want in capsys.readouterr().err


def test_cli_encode_mesh_refuses_channels_off_the_mesh(tmp_path):
    src = tmp_path / "in.ts"
    _random_ts(2, 1, 1).tofile(src)
    with pytest.raises(ValueError, match="must divide evenly over 2 channel shards"):
        tcli.main([str(src), "--device", "cpu", "-c", "3", "--mesh", "1x2"])
