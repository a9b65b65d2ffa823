"""The wideband headend path of the PyTorch port on the CPU, held against
the JAX package: the FDM multiplexer and demultiplexer (ops/mux.py) block
products, tables, streaming carries and their conversion, demux_slot, and
the CLI's `encode --mux`, `decode --demux` (with --first-field, --rate and
--viterbi-chunks) and `-o '{ch}'` against the JAX CLI (tests/test_mux.py's
drives, B <= 3, at most 4 fields)."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import cli as jcli
from atsc_tpu import params as P
from atsc_tpu.ops import mux as jm
from atsc_tpu_torch import cli as tcli
from atsc_tpu_torch.ops import mux as tm
from atsc_tpu_torch.utils import convert

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
# the block products against JAX's, relative to the RMS of JAX's output:
# float32 sums of 545 (mux) and 286*B + 2*halo (demux) products in another
# order; measured at most 5.6e-7 (mux) and 1.7e-6 (demux) at B <= 4
REL_TOL = 1e-5


def _random_ts(rng, t, b) -> np.ndarray:
    ts = rng.integers(0, 256, size=(t, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _close(got: np.ndarray, want: np.ndarray) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.abs(got - want).max() <= REL_TOL * rms


@pytest.mark.parametrize("b", [1, 2, 3, 23])
def test_mux_tables_match_jax(b):
    """The resampler, demux filter and mixer tables: the JAX package's
    float64 construction cast to float32, identical."""
    np.testing.assert_array_equal(tm._resample_matrix(b), jm._resample_matrix(b))
    np.testing.assert_array_equal(tm._demux_matrix(b), jm._demux_matrix(b))
    for got, want in zip(tm._mixer_tables(b), jm._mixer_tables(b)):
        np.testing.assert_array_equal(got, want)
    assert tm._demux_halo(b) == jm._demux_halo(b)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_mux_blocks_matches_jax(b):
    x = np.random.default_rng(10 + b).normal(0, 1, (b, 2, 513 * 5 + 2 * tm._HALO))
    x = x.astype(np.float32)
    _close(tm.mux_blocks(torch.tensor(x)).numpy(), jm.mux_blocks(jnp.asarray(x)))


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_demux_blocks_matches_jax(b):
    h = tm._demux_halo(b)
    y = np.random.default_rng(20 + b).normal(0, 1, (2, 286 * b * 4 + 2 * h))
    y = y.astype(np.float32)
    _close(tm.demux_blocks(torch.tensor(y), b).numpy(), jm.demux_blocks(jnp.asarray(y), b))


def test_mux_blocks_runs_in_fp32_whatever_the_caller_set():
    """The block products ignore a lowered float32 matmul precision."""
    x = torch.randn(2, 2, 513 * 2 + 2 * tm._HALO, generator=torch.Generator().manual_seed(3))
    want = tm.mux_blocks(x)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = tm.mux_blocks(x)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def fields3():
    """3 channels x 3 fields of seeded random TS through the JAX encoder:
    (ts, (3, 2, 3N) planar IQ)."""
    from atsc_tpu.models.encoder import Encoder

    ts = _random_ts(np.random.default_rng(109), 3, 3)
    enc = Encoder(batch=3, donate=False)
    iq = np.concatenate([np.asarray(enc.encode(ts[k]))[:, :, :N] for k in range(3)], -1)
    return ts, iq


def test_fdm_muxer_streams_like_jax(fields3):
    """FdmMuxer pushed per field, then flushed, gives JAX's multiplex; a
    push in uneven chunks gives the same samples; the carry goes in and out
    in JAX's layout."""
    _, iq = fields3
    jmux, tmux = jm.FdmMuxer(3), tm.FdmMuxer(3, device="cpu")
    want = [jmux.push(iq[:, :, k * N:(k + 1) * N]) for k in range(2)]
    got = [tmux.push(torch.tensor(iq[:, :, k * N:(k + 1) * N])) for k in range(2)]
    np.testing.assert_array_equal(tmux.get_state(), jmux.get_state())
    want += [jmux.push(iq[:, :, 2 * N:]), jmux.flush()]
    got += [tmux.push(iq[:, :, 2 * N:]), tmux.flush()]
    for g, w in zip(got, want):
        _close(g, w)
    whole = np.concatenate(got, -1)
    c = tm.FdmMuxer(3, device="cpu")
    parts = [c.push(iq[:, :, p:p + 77_777]) for p in range(0, iq.shape[-1], 77_777)]
    np.testing.assert_allclose(np.concatenate(parts + [c.flush()], -1), whole, atol=1e-6)
    with pytest.raises(ValueError) as port:
        tmux.push(np.zeros((2, 2, 10), np.float32))
    with pytest.raises(ValueError) as ref:
        jmux.push(np.zeros((2, 2, 10), np.float32))
    assert str(port.value) == str(ref.value)


def test_fdm_carries_continue_a_jax_stream(fields3):
    """A JAX FdmMuxer's and FdmDemuxer's get_state() after part of a
    stream, moved with utils/convert.py, goes on as JAX's does."""
    _, iq = fields3
    jmux = jm.FdmMuxer(3)
    head = jmux.push(iq[:, :, :N + 1234])
    tmux = convert.fdm_muxer_from_numpy(jmux.get_state(), 3, device="cpu")
    _close(np.concatenate([tmux.push(iq[:, :, N + 1234:]), tmux.flush()], -1),
           np.concatenate([jmux.push(iq[:, :, N + 1234:]), jmux.flush()], -1))
    m = np.concatenate([head, jm.FdmMuxer(3).flush()], -1)[:, :200_000]
    jd = jm.FdmDemuxer(3)
    jd.push(m[:, :123_457])
    td = convert.fdm_demuxer_from_numpy(jd.get_state(), 3, device="cpu")
    np.testing.assert_array_equal(td.get_state(), jd.get_state())
    _close(np.concatenate([td.push(m[:, 123_457:]), td.flush()], -1),
           np.concatenate([jd.push(m[:, 123_457:]), jd.flush()], -1))
    with pytest.raises(ValueError):
        convert.fdm_muxer_from_numpy(jmux.get_state()[:2], 3, device="cpu")
    with pytest.raises(ValueError):
        convert.fdm_demuxer_from_numpy(jd.get_state().astype(np.float64), 3, device="cpu")


def test_fdm_demuxer_streams_like_jax(fields3):
    """FdmDemuxer on JAX's multiplex: JAX's basebands, any chunking of the
    pushes alike, and the same flush."""
    _, iq = fields3
    jmux = jm.FdmMuxer(3)
    m = np.concatenate([jmux.push(iq), jmux.flush()], -1)
    jd, td = jm.FdmDemuxer(3), tm.FdmDemuxer(3, device="cpu")
    want = np.concatenate([jd.push(m), jd.flush()], -1)
    got = np.concatenate([td.push(torch.tensor(m)), td.flush()], -1)
    _close(got, want)
    d2 = tm.FdmDemuxer(3, device="cpu")
    parts = [d2.push(m[:, p:p + 99_991]) for p in range(0, m.shape[-1], 99_991)]
    np.testing.assert_allclose(np.concatenate(parts + [d2.flush()], -1), got, atol=1e-6)


def test_demux_slot_matches_jax(fields3):
    """The host verification inverse: the same float64 numpy, identical."""
    _, iq = fields3
    jmux = jm.FdmMuxer(3)
    m = np.concatenate([jmux.push(iq[:, :, :N]), jmux.flush()], -1)
    for slot in (0, 2):
        np.testing.assert_array_equal(tm.demux_slot(m, slot, 3), jm.demux_slot(m, slot, 3))


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """tests/test_mux.py:232's drive: 2 channels x 3 fields, one TS file
    each, through `encode --mux` of both CLIs."""
    d = tmp_path_factory.mktemp("wide")
    ts = _random_ts(np.random.default_rng(137), 3, 2)
    paths = [str(d / f"{k}.ts") for k in range(2)]
    for k, p in enumerate(paths):
        ts[:, k].tofile(p)
    assert tcli.main([*paths, "-o", str(d / "port.iq"), "--mux", "--device", "cpu"]) == 0
    assert jcli.main([*paths, "-o", str(d / "jax.iq"), "--mux"]) == 0
    return d, ts, paths


def test_cli_encode_mux_matches_jax(wide):
    d, _, _ = wide
    got = np.fromfile(d / "port.iq", np.float32)
    want = np.fromfile(d / "jax.iq", np.float32)
    assert got.size == want.size == 2 * int(np.ceil(3 * N / 513)) * 286 * 2
    _close(got, want)


def _decode(tool, argv, tmp_path, name):
    extra = ["--device", "cpu"] if tool is tcli else []
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        s = tool.run_decode(tool.build_decode_argparser().parse_args(
            [*argv, "-o", str(tmp_path / name), *extra]))
    return s


@pytest.mark.parametrize("trellis", [[], ["--trellis", "viterbi", "--viterbi-chunks", "24"]])
def test_cli_decode_demux_matches_jax(wide, tmp_path, trellis):
    """`decode --demux 2` of the JAX multiplex: the same interleaved TS as
    the JAX CLI (hard, and the chunk-parallel soft tier), which is the
    sent TS."""
    d, ts, _ = wide
    argv = [str(d / "jax.iq"), "--demux", "2", "--stats", *trellis]
    s = _decode(tcli, argv, tmp_path, "port.ts")
    sj = _decode(jcli, argv, tmp_path, "jax.ts")
    got = (tmp_path / "port.ts").read_bytes()
    assert got == (tmp_path / "jax.ts").read_bytes() == ts[:2].tobytes()
    assert s["segments_uncorrectable"] == sj["segments_uncorrectable"] == 0
    assert s["fields_decoded"] == sj["fields_decoded"] == 2 and s["demux_slots"] == 2


def test_cli_decode_per_channel_output_matches_jax(wide, tmp_path):
    """-o 'slot{ch}.ts' writes one TS file per channel, on --demux (the
    port's own multiplex) and on a plain 2-channel decode, as JAX's does."""
    d, ts, paths = wide
    _decode(tcli, [str(d / "port.iq"), "--demux", "2"], tmp_path, "slot{ch}.ts")
    _decode(jcli, [str(d / "port.iq"), "--demux", "2"], tmp_path, "j{ch}.ts")
    for k in range(2):
        got = (tmp_path / f"slot{k}.ts").read_bytes()
        assert got == (tmp_path / f"j{k}.ts").read_bytes() == ts[:2, k].tobytes()
    cap = tmp_path / "two.iq"
    assert tcli.main([*paths, "-o", str(cap), "--device", "cpu"]) == 0
    _decode(tcli, [str(cap), "-c", "2"], tmp_path, "c{ch}.ts")
    _decode(jcli, [str(cap), "-c", "2"], tmp_path, "jc{ch}.ts")
    for k in range(2):
        got = (tmp_path / f"c{k}.ts").read_bytes()
        assert got == (tmp_path / f"jc{k}.ts").read_bytes() == ts[:2, k].tobytes()


def test_cli_decode_demux_first_field_matches_jax(fields3, tmp_path):
    """tests/test_mux.py:195: a multiplex whose stream starts at field 1,
    decoded with --first-field 1 (3 slots), the JAX CLI's TS."""
    ts, iq = fields3
    mux = jm.FdmMuxer(3)
    m = np.concatenate([mux.push(iq[:, :, N:]), mux.flush()], axis=-1)
    cap = tmp_path / "odd.iq"
    np.stack([m[0], m[1]], axis=-1).astype(np.float32).tofile(cap)
    argv = [str(cap), "--demux", "3", "--first-field", "1"]
    s = _decode(tcli, argv, tmp_path, "port.ts")
    _decode(jcli, argv, tmp_path, "jax.ts")
    got = (tmp_path / "port.ts").read_bytes()
    assert got == (tmp_path / "jax.ts").read_bytes() == ts[1:2].tobytes()
    assert s["segments_uncorrectable"] == 0


def test_cli_mux_rate_demux_rate_matches_jax(tmp_path):
    """tests/test_mux.py:224: `encode --mux --rate 16e6` -> `decode --demux
    2 --rate 16e6`, both CLIs: the same capture (within the block
    tolerance), and the same TS, align_parity and resample_rate."""
    ts = _random_ts(np.random.default_rng(151), 4, 2)
    paths = [str(tmp_path / f"{k}.ts") for k in range(2)]
    for k, p in enumerate(paths):
        ts[:, k].tofile(p)
    cap = tmp_path / "wide16.iq"
    assert tcli.main([*paths, "--mux", "-o", str(cap), "--rate", "16e6",
                      "--device", "cpu"]) == 0
    assert jcli.main([*paths, "--mux", "-o", str(tmp_path / "j16.iq"), "--rate", "16e6"]) == 0
    _close(np.fromfile(cap, np.float32), np.fromfile(tmp_path / "j16.iq", np.float32))
    argv = [str(cap), "--demux", "2", "--rate", "16e6"]
    s = _decode(tcli, argv, tmp_path, "port.ts")
    sj = _decode(jcli, argv, tmp_path, "jax.ts")
    got = (tmp_path / "port.ts").read_bytes()
    assert got == (tmp_path / "jax.ts").read_bytes()
    for key in ("align_parity", "align_offset", "resample_rate", "fields_decoded",
                "segments_uncorrectable"):
        assert s[key] == sj[key], key
    assert s["align_parity"] == 1 and s["segments_uncorrectable"] == 0
    assert got == ts[1:1 + s["fields_decoded"]].tobytes()


@pytest.mark.parametrize("flags", [
    ["--demux", "-2"],
    ["--demux", "2", "--viterbi-chunks", "24"],
    ["--demux", "2", "--ntsc", "comb", "--erasures", "burst"],
    ["--demux", "2", "--cfo", "100"],
    ["--demux", "2", "--sro", "12"],
    ["--demux", "2", "-c", "2"],
    ["--demux", "2", "--trellis", "viterbi-i8"],
    ["--demux", "4", "--rate", "20e6"],
    ["--viterbi-chunks", "24"],
])
def test_cli_decode_demux_validation_matches_jax(tmp_path, flags):
    """Usage errors on the demux and chunked paths: the JAX CLI's messages,
    and an existing output file is not truncated (tests/test_mux.py:260)."""
    cap = tmp_path / "cap.iq"
    cap.write_bytes(b"\0" * 64)
    out = tmp_path / "out.ts"
    out.write_bytes(b"precious bytes")
    with pytest.raises(ValueError) as port:
        tcli.run_decode(tcli.build_decode_argparser().parse_args(
            [str(cap), "-o", str(out), "--device", "cpu", *flags]))
    with pytest.raises(ValueError) as ref:
        jcli.run_decode(jcli.build_decode_argparser().parse_args(
            [str(cap), "-o", str(out), *flags]))
    assert str(port.value) == str(ref.value)
    assert out.read_bytes() == b"precious bytes"


@pytest.mark.parametrize("flags", [
    ["--mux", "--format", "cs8"],
    ["-c", "2", "--rate", "20e6"],
    ["-c", "3", "--mux", "--rate", "16e6"],
])
def test_cli_encode_mux_validation_matches_jax(tmp_path, flags):
    src = tmp_path / "in.ts"
    _random_ts(np.random.default_rng(1), 1, 1).tofile(src)
    with pytest.raises(ValueError) as port:
        tcli.main([str(src), "-o", str(tmp_path / "o.iq"), "--device", "cpu", *flags])
    with pytest.raises(ValueError) as ref:
        jcli.main([str(src), "-o", str(tmp_path / "j.iq"), *flags])
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("n", ["5", "0"])
def test_cli_viterbi_chunks_argument_matches_jax(n):
    """--viterbi-chunks must divide 21528: the same argparse message."""
    msgs = []
    for ap in (tcli.build_decode_argparser(), jcli.build_decode_argparser()):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            ap.parse_args(["cap.iq", "--viterbi-chunks", n])
        msgs.append(err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1])
    assert msgs[0] == msgs[1] and "divisor of 21528" in msgs[0]
