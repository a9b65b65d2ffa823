"""The PyTorch port's encoder slice end to end on the CPU: golden fields,
random TS against JAX encode_field in every output format, state carried
over from a JAX stream, the streaming encoder, and the CLI against the JAX
CLI."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.models import encoder as jax_encoder
from atsc_tpu.ops.quantize import unpack_wire
from atsc_tpu.tables.oscillator import phasor_for_field
from atsc_tpu_torch import cli as pt_cli
from atsc_tpu_torch.models.encoder import (
    Encoder,
    encode_field,
    init_state,
    iq_to_complex,
)
from atsc_tpu_torch.models.streaming import StreamingEncoder
from atsc_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = P.SYMBOLS_PER_FIELD
_jax_step = jax.jit(jax_encoder.encode_field, static_argnames=("out_format", "wire"))


def _random_ts(seed: int, shape) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _leaves(jax_state) -> dict:
    return {k: np.asarray(v) for k, v in jax_state._asdict().items()}


def _assert_iq_close(got: np.ndarray, want: np.ndarray, fmt: str, wire: bool):
    """cf32 within 5e-6 per component, codes within 1 LSB, over the valid
    [0, 260416) (the two packages differ only in float32 rounding order)."""
    if fmt == "cf32":
        assert np.abs(got[..., :N] - want[..., :N]).max() <= 5e-6
        return
    if wire:
        got, want = unpack_wire(got, fmt), unpack_wire(want, fmt)
    diff = got[..., :N].astype(np.int32) - want[..., :N].astype(np.int32)
    assert np.abs(diff).max() <= 1


def test_golden_fields_and_state_match_jax(golden):
    """4 golden fields: IQ within 5e-6 of golden; the final state equal to
    JAX's leaf for leaf, and the phasor bit for bit to the float32
    recurrence phasor_for_field(4).

    The jitted JAX encode_field on XLA:CPU fuses advance_phasor's
    multiply and subtract into an FMA, so its phasor leaves that
    recurrence by 1 ulp from field 4 on; the port, op by op, does not.
    Against JAX the phasor is therefore held to 1 ulp."""
    enc = Encoder(batch=1, device="cpu")
    many = enc.encode_many(golden["input"][:2, None])   # fields 0-1 at once
    assert many.shape == (2, 1, 2, P.PADDED_OUT)
    iqs = [many[0], many[1]] + [enc.encode(golden["input"][f][None]) for f in (2, 3)]
    for f, iq in enumerate(iqs):
        assert iq.shape == (1, 2, P.PADDED_OUT) and iq.dtype == torch.float32
        assert np.abs(iq_to_complex(iq)[0] - golden["iq"][f]).max() <= 5e-6

    state = jax_encoder.init_state(1)
    for f in range(4):
        state, _ = _jax_step(state, jnp.asarray(golden["input"][f][None]))
    got, want = state_to_numpy(enc.state), _leaves(state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k != "phasor":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    z = phasor_for_field(4)
    np.testing.assert_array_equal(
        got["phasor"][0], np.array([z.real, z.imag], dtype=np.float32))
    ulp = np.spacing(np.abs(want["phasor"]))
    assert (np.abs(got["phasor"] - want["phasor"]) <= ulp).all()


@pytest.mark.parametrize("fmt,wire", [("cf32", False), ("cs16", False),
                                      ("cs8", False), ("cs16", True),
                                      ("cs8", True)])
def test_random_ts_matches_jax(fmt, wire):
    """B=3 channels of random TS, 2 fields, against JAX encode_field."""
    ts = _random_ts(21, (2, 3, P.FIELD_TS_BYTES))
    pt_state = init_state(3, device="cpu")
    jx_state = jax_encoder.init_state(3)
    for f in range(2):
        pt_state, got = encode_field(pt_state, torch.tensor(ts[f]), fmt, wire)
        jx_state, want = _jax_step(jx_state, jnp.asarray(ts[f]), out_format=fmt,
                                   wire=wire)
        want = np.asarray(want)
        assert got.shape == want.shape and got.numpy().dtype == want.dtype
        _assert_iq_close(got.numpy(), want, fmt, wire)


def test_state_carried_from_jax_stream():
    """A stream started in JAX (2 fields) and carried into the port through
    utils.convert gives the same fields 3-4 as JAX; the state round-trips."""
    ts = _random_ts(22, (4, 2, P.FIELD_TS_BYTES))
    jx_state = jax_encoder.init_state(2)
    for f in range(2):
        jx_state, _ = _jax_step(jx_state, jnp.asarray(ts[f]))
    pt_state = state_from_numpy(_leaves(jx_state), device="cpu")
    for k, v in state_to_numpy(pt_state).items():
        np.testing.assert_array_equal(v, _leaves(jx_state)[k], err_msg=k)
    for f in range(2, 4):
        pt_state, got = encode_field(pt_state, torch.tensor(ts[f]))
        jx_state, want = _jax_step(jx_state, jnp.asarray(ts[f]))
        _assert_iq_close(got.numpy(), np.asarray(want), "cf32", False)
    with pytest.raises(ValueError):
        bad = _leaves(jx_state)
        bad["parity"] = bad["parity"].astype(np.int64)
        state_from_numpy(bad, device="cpu")


@pytest.mark.parametrize("field_index", [0, 5, 300])
def test_init_state_matches_jax(field_index):
    """A fresh state as of a global field index (parity, phasor) equals
    JAX's init_state leaf for leaf."""
    got = state_to_numpy(init_state(2, field_index, device="cpu"))
    want = _leaves(jax_encoder.init_state(2, field_index))
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_encoder_rejects_bad_ts():
    enc = Encoder(batch=2, device="cpu")
    for bad in (np.zeros((2, P.FIELD_TS_BYTES), np.int16),
                np.zeros((3, P.FIELD_TS_BYTES), np.uint8),
                np.zeros((2, P.FIELD_TS_BYTES - 1), np.uint8)):
        with pytest.raises(ValueError):
            enc.encode(bad)
    with pytest.raises(ValueError):
        enc.encode(torch.zeros((2, P.FIELD_TS_BYTES), dtype=torch.int32))


def test_streaming_chunked_equals_one_shot():
    """Ragged pushes on 2 channels, then a partial-field flush, equal the
    one-shot encode of the same (zero-padded) fields."""
    ts = _random_ts(23, (2, 2, P.FIELD_TS_BYTES))
    tail = _random_ts(24, (2, 1000))
    got = {0: [], 1: []}
    stream = StreamingEncoder(
        channels=2, sink=lambda c, iq: got[c].append(iq.copy()), device="cpu")
    for c in range(2):
        data = np.concatenate([ts[0, c], ts[1, c], tail[c]]).tobytes()
        cuts = [0, 7, 40_000, 58_656, 100_001, len(data)]
        for a, b in zip(cuts, cuts[1:]):
            stream.push(data[a:b], channel=c)
    assert stream.fields_encoded == 2
    assert stream.flush_partial() == 1

    padded = np.zeros((2, P.FIELD_TS_BYTES), np.uint8)
    padded[:, :1000] = tail
    enc = Encoder(batch=2, device="cpu")
    for f, field_ts in enumerate([ts[0], ts[1], padded]):
        want = iq_to_complex(enc.encode(field_ts))
        for c in range(2):
            assert got[c][f].shape == (N, 2)
            np.testing.assert_array_equal(got[c][f].view(np.complex64)[:, 0], want[c])


@pytest.mark.parametrize("fmt", ["cf32", "cs8"])
def test_cli_matches_jax_cli(tmp_path, capsys, fmt):
    """The port's cli.main on a 2-field TS file, 2 channels, against the
    JAX CLI's output: cf32 within 5e-6, cs8 within 1 LSB."""
    from atsc_tpu.cli import run as jax_run
    from atsc_tpu.utils.config import EncoderConfig

    ts_path = tmp_path / "in.ts"
    _random_ts(25, (2, P.FIELD_TS_BYTES)).tofile(ts_path)
    out_pt, out_jx = tmp_path / "pt.iq", tmp_path / "jx.iq"
    rc = pt_cli.main([str(ts_path), "-o", str(out_pt), "--channels", "2",
                      "--format", fmt, "--stats", "--device", "cpu"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["fields"] == 4 and stats["ts_sync_errors"] == 0
    assert stats["ts_packets"] == 2 * P.DATA_SEGMENTS
    jax_run(EncoderConfig(channels=2, sink=str(out_jx), out_format=fmt),
            [str(ts_path)])

    dtype = np.float32 if fmt == "cf32" else np.int8
    got, want = np.fromfile(out_pt, dtype), np.fromfile(out_jx, dtype)
    assert got.size == want.size == 2 * 2 * N * 2
    if fmt == "cf32":
        assert np.abs(got - want).max() <= 5e-6
    else:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_cli_fields_per_step_matches_jax_cli(tmp_path):
    """`encode --fields-per-step 2` on a 3-field TS (not a multiple of 2),
    cf32: within 5e-6 of the JAX CLI's output at --fields-per-step 2, as
    test_cli_matches_jax_cli holds the default, and byte for byte the
    port's output without the flag (it reads fields, not steps)."""
    from atsc_tpu.cli import main as jax_main

    ts_path = tmp_path / "in.ts"
    _random_ts(27, (3, P.FIELD_TS_BYTES)).tofile(ts_path)
    out = {k: tmp_path / f"{k}.iq" for k in ("pt", "pt_default", "jx")}
    assert pt_cli.main([str(ts_path), "-o", str(out["pt"]), "--fields-per-step", "2",
                        "--device", "cpu"]) == 0
    assert pt_cli.main([str(ts_path), "-o", str(out["pt_default"]), "--device", "cpu"]) == 0
    assert jax_main([str(ts_path), "-o", str(out["jx"]), "--fields-per-step", "2"]) == 0
    got, want = np.fromfile(out["pt"], np.float32), np.fromfile(out["jx"], np.float32)
    assert got.size == want.size == 3 * N * 2
    assert np.abs(got - want).max() <= 5e-6
    assert out["pt"].read_bytes() == out["pt_default"].read_bytes()


@pytest.mark.parametrize("flag", [["--fields-per-step", "3"], ["--checkpoint-every", "5"],
                                  ["-d", "lime", "-f", "615e6", "-g", "20"],
                                  ["--driver", "uhd", "--frequency", "5e8", "--gain", "0"]])
def test_cli_accepts_flags_without_effect(tmp_path, flag):
    """The JAX CLI's flags that act only with --mesh, --checkpoint or a
    soapy sink parse, and change no byte of a cs8 encode without them."""
    ts_path = tmp_path / "in.ts"
    _random_ts(28, (1, P.FIELD_TS_BYTES)).tofile(ts_path)
    base = [str(ts_path), "--format", "cs8", "--device", "cpu", "-o"]
    assert pt_cli.main([*base, str(tmp_path / "plain.iq")]) == 0
    assert pt_cli.main([*base, str(tmp_path / "flag.iq"), *flag]) == 0
    assert (tmp_path / "flag.iq").read_bytes() == (tmp_path / "plain.iq").read_bytes()


@pytest.mark.parametrize("flag", [["--mesh", "2x1"],
                                  ["--mesh", "2x1", "--fields-per-step", "2"],
                                  ["-o", "soapy", "-d", "hackrf", "-f", "615e6", "-g", "40"],
                                  ["-o", "soapy:lime"]])
def test_cli_rejects_unported_flags(tmp_path, capsys, monkeypatch, flag):
    """--mesh, with or without --fields-per-step, now does what the JAX
    CLI does: it encodes, over 2 time shards (on the one CPU device), and
    the bytes equal the plain encode's, as the JAX CLI's sharded encode
    equals its plain one. The soapy sink is ported: where the SoapySDR
    bindings are absent it stops with the JAX package's RuntimeError,
    output-less."""
    if "--mesh" in flag:
        ts_path = tmp_path / "in.ts"
        _random_ts(27, (3, P.FIELD_TS_BYTES)).tofile(ts_path)
        base = [str(ts_path), "--format", "cs8", "--device", "cpu", "-o"]
        assert pt_cli.main([*base, str(tmp_path / "plain.iq")]) == 0
        assert pt_cli.main([*base, str(tmp_path / "mesh.iq"), *flag]) == 0
        assert (tmp_path / "mesh.iq").read_bytes() == (tmp_path / "plain.iq").read_bytes()
        assert "encode --mesh: 2 shards on 1 cpu device(s)" in capsys.readouterr().err
        return
    monkeypatch.setitem(sys.modules, "SoapySDR", None)   # the import fails
    ts_path = tmp_path / "in.ts"
    _random_ts(29, (1, P.FIELD_TS_BYTES)).tofile(ts_path)
    with pytest.raises(RuntimeError, match="SoapySDR python bindings not available"):
        pt_cli.main([str(ts_path), "--device", "cpu", *flag])


def _checkpointed_fields(path) -> int:
    with np.load(path) as z:
        return int(z["__fields_encoded__"])


@pytest.mark.parametrize("flag", [["--mux", "--checkpoint", "c"],
                                  ["--rate", "20e6", "--mux", "--profile", "d"],
                                  ["--ppm", "3", "--checkpoint", "c"], ["--checkpoint", "c"],
                                  ["--resume"], ["--profile", "d"], ["--realtime"],
                                  ["--checkpoint", "c", "--checkpoint-every", "4"]])
def test_cli_runs_the_state_and_operation_flags(tmp_path, flag):
    """The flags the CLI refused before they were ported now run on a
    2-field TS: --checkpoint writes the state (with the muxer carry or the
    resampler state where the run has one), --profile a trace, --realtime
    the same bytes as without it; --resume without --checkpoint stops with
    its own error."""
    src = tmp_path / "in.ts"
    _random_ts(29, (2, P.FIELD_TS_BYTES)).tofile(src)
    argv = [str(src), "--device", "cpu", "-o", str(tmp_path / "out.iq")]
    flag = [str(tmp_path / a) if a in ("c", "d") else a for a in flag]
    if flag == ["--resume"]:
        with pytest.raises(ValueError, match="--resume requires --checkpoint"):
            pt_cli.main([*argv, *flag])
        assert not (tmp_path / "out.iq").exists()
        return
    assert pt_cli.main([*argv, *flag]) == 0
    if "--checkpoint" in flag:
        ck = flag[flag.index("--checkpoint") + 1]
        assert _checkpointed_fields(ck) == 2
        with np.load(ck) as z:
            assert ("__mux_carry__" in z.files) == ("--mux" in flag)
            assert ("__rs_num__" in z.files) == ("--ppm" in flag)
    if "--profile" in flag:
        assert os.listdir(flag[flag.index("--profile") + 1])
    if flag == ["--realtime"]:
        assert pt_cli.main([*argv[:-1], str(tmp_path / "plain.iq")]) == 0
        assert (tmp_path / "out.iq").read_bytes() == (tmp_path / "plain.iq").read_bytes()


def test_cli_default_device_needs_cuda(tmp_path):
    """The CLI defaults to CUDA and fails loudly where there is none, for
    encode, decode and analyze alike."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ts_path = tmp_path / "in.ts"
    _random_ts(26, (1, P.FIELD_TS_BYTES)).tofile(ts_path)
    with pytest.raises(RuntimeError, match="cuda"):
        pt_cli.main([str(ts_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        pt_cli.main(["decode", str(ts_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        pt_cli.main(["analyze", str(ts_path)])


def test_port_imports_no_jax():
    """Importing the port (package, encoder, CLI) loads no JAX module."""
    code = ("import sys\n"
            "import atsc_tpu_torch, atsc_tpu_torch.models.encoder, "
            "atsc_tpu_torch.models.streaming, atsc_tpu_torch.cli, "
            "atsc_tpu_torch.utils.convert\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.')], 'jax imported'\n"
            "print('no-jax')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "no-jax" in out.stdout, out.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    device, and when it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
