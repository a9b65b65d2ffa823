"""The port's multi-process path on the CPU (parallel/distributed.py):
the process mesh and per-process channel assignment in one process, then
two real processes joined by torch.distributed over gloo, two CPU shards
each: one ShardedEncoder step on a 2x2 mesh whose time ring crosses the
processes, with a hard and a soft ShardedDecoder step over it (this
file's `_child`, run as a script), and the two multi-process tools,
byte-compared with the sequential port."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch.parallel import distributed as tdist  # noqa: E402
from atsc_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS  # noqa: E402

FB = P.FIELD_TS_BYTES


def _random_ts(seed: int, t: int, b: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=(t, b, FB), dtype=np.uint8)
    ts.reshape(t, b, P.DATA_SEGMENTS, P.MPEG2_BYTES)[..., 0] = 0x47
    return ts


def _symbol_fields(ts: np.ndarray) -> np.ndarray:
    """(T, B, 58656) TS -> (T, B, 261248) int8 symbol fields (the port's
    encoder front half, with its carried state)."""
    from atsc_tpu_torch.ops.assemble import assemble_field_structured
    from atsc_tpu_torch.ops.interleave import interleave_field_enc_major
    from atsc_tpu_torch.ops.randomize import randomize_field
    from atsc_tpu_torch.ops.rs_encode import rs_encode_field
    from atsc_tpu_torch.ops.trellis import trellis_encode_field

    t, b = ts.shape[:2]
    prev = torch.zeros((b, P.DATA_PER_FIELD), dtype=torch.uint8)
    d = d1 = d2 = torch.zeros((b, P.TRELLIS_ENCODERS), dtype=torch.int32)
    saved = torch.zeros((b, P.RESERVED_SYMBOLS), dtype=torch.int8)
    parity = torch.zeros((b,), dtype=torch.int32)
    out = []
    for k in range(t):
        rs = rs_encode_field(randomize_field(torch.from_numpy(ts[k]))).reshape(b, -1)
        sym, d, d1, d2 = trellis_encode_field(interleave_field_enc_major(rs, prev), d, d1, d2)
        field, saved = assemble_field_structured(sym, parity, saved)
        prev, parity = rs, parity ^ 1
        out.append(field)
    return torch.stack(out).numpy()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(argv_of, timeout: int = 300) -> list[str]:
    """Start two processes (argv_of(process_id)), wait, return their
    outputs; both must exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(argv_of(i), env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outs


# -- one process ------------------------------------------------------------

def test_pod_mesh_in_one_process():
    """Without a process group the pod mesh is this process's shards, and
    it owns every channel."""
    mesh = tdist.pod_mesh(n_time=2, devices=["cpu"] * 4)
    assert mesh.shape == {TIME_AXIS: 2, CH_AXIS: 2}
    assert mesh.local() == mesh.coords()
    assert tdist.local_channel_slice(mesh, 6) == slice(0, 6)
    np.testing.assert_array_equal(tdist.local_channel_indices(mesh, 6), np.arange(6))
    with pytest.raises(ValueError, match="do not divide over 3 time shards"):
        tdist.pod_mesh(n_time=3, devices=["cpu"] * 4)


def test_initialize_one_process_is_a_noop_and_the_backend_is_named():
    tdist.initialize(num_processes=1)
    tdist.initialize(num_processes=None)
    with pytest.raises(ValueError, match="backend must be one of"):
        tdist.initialize("localhost:1", num_processes=2, process_id=0)
    assert tdist.local_devices("cpu, cpu") == [torch.device("cpu")] * 2


def test_channel_assignment_of_a_two_process_mesh():
    """A (1, 4) mesh over two processes of two shards: each owns two
    channel shards, a contiguous range (the mesh is built with explicit
    ranks, as pod_mesh builds it in a process group)."""
    from atsc_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([["cpu"] * 4], (TIME_AXIS, CH_AXIS), ranks=[[0, 0, 1, 1]])
    assert mesh.local() == [(0, 0), (0, 1)]
    assert tdist.local_channel_slice(mesh, 8) == slice(0, 4)
    assert "(0,2)=cpu@rank1" in mesh.placement()


# -- two processes -----------------------------------------------------------

def _child(pid: int, port: int) -> None:
    """One of two gloo processes with two CPU shards each: a 2x2 global
    mesh, process p owning time row p, so every time-axis exchange crosses
    the processes. Checks this process's shards of one ShardedEncoder step
    and one hard and one soft ShardedDecoder step against the sequential
    port (hard) and a one-process mesh (soft)."""
    torch.set_num_threads(2)
    from atsc_tpu_torch.models.decoder import Decoder
    from atsc_tpu_torch.models.encoder import encode_fields, init_state
    from atsc_tpu_torch.ops.assemble import field_levels
    from atsc_tpu_torch.parallel.field_shard import IQ_SPEC, STATE_SPEC, ShardedEncoder
    from atsc_tpu_torch.parallel.mesh import make_mesh, shard_index
    from atsc_tpu_torch.parallel.rx_shard import CW_SPEC, ShardedDecoder

    tdist.initialize(f"localhost:{port}", num_processes=2, process_id=pid, backend="gloo")
    mesh = tdist.pod_mesh(n_time=2, devices=["cpu", "cpu"])
    assert mesh.local() == [(pid, 0), (pid, 1)], mesh.local()

    ts = _random_ts(5, 2, 2)
    enc = ShardedEncoder(mesh, batch=2)
    state, iq = enc.step(enc.init_state(), ts)
    seq_state, seq_iq = encode_fields(init_state(2, device="cpu"), torch.from_numpy(ts))
    for c, part in iq.items():
        want = seq_iq.numpy()[shard_index(mesh, c, IQ_SPEC, seq_iq.shape)]
        np.testing.assert_array_equal(part.numpy(), want)
    for c, st in state.items():
        for name, spec in zip(st._fields, STATE_SPEC):
            full = getattr(seq_state, name).numpy()
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          full[shard_index(mesh, c, spec, full.shape)])

    fields = _symbol_fields(ts)
    dec = ShardedDecoder(mesh, batch=2)
    cw, _ = dec.step(fields)
    seq = Decoder(batch=2, device="cpu")
    for k in range(2):
        seq._state, words, _ = seq._step(seq._state, torch.from_numpy(fields[k]))
        for c, part in cw.items():
            if c[0] == k:
                np.testing.assert_array_equal(part[0].numpy(), words[c[1]:c[1] + 1].numpy())
    for c, st in dec._state.items():
        np.testing.assert_array_equal(st.prev_il.numpy(), seq.state.prev_il[c[1]:c[1] + 1].numpy())

    levels = field_levels(torch.from_numpy(fields)).numpy()
    soft = ShardedDecoder(mesh, batch=2, trellis="soft")
    cw, _ = soft.step(levels)
    ref = ShardedDecoder(make_mesh(2, 2, ["cpu"] * 4), batch=2, trellis="soft")
    ref_cw, _ = ref.step(levels)
    for c, part in cw.items():
        np.testing.assert_array_equal(part.numpy(), ref_cw[c].numpy())
        np.testing.assert_array_equal(soft._state[c].metrics.numpy(), ref._state[c].metrics.numpy())
    assert CW_SPEC == (TIME_AXIS, CH_AXIS, None, None)
    print(f"child-ok {pid}", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def test_two_process_sharded_step():
    port = _free_port()
    outs = _run_two(lambda i: [sys.executable, os.path.abspath(__file__), "child", str(i),
                               str(port)])
    for i, out in enumerate(outs):
        assert f"child-ok {i}" in out, out


def test_two_process_tools(tmp_path):
    """tools/torch_distributed_encode.py and torch_distributed_decode.py,
    two processes of two CPU shards each over gloo, 4 channels: every
    channel's IQ is the sequential encoder's byte for byte (3 fields at 2
    a step, so the last step is partial), and the decode of those
    captures gives back the sent TS (the last field stays in the
    de-interleaver)."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_interleave

    t, b = 3, 4
    ts = _random_ts(17, t, b)
    paths = []
    for c in range(b):
        ts[:, c].tofile(tmp_path / f"in{c}.ts")
        paths.append(str(tmp_path / f"in{c}.ts"))

    def tool(name, *args):
        port = _free_port()
        return _run_two(lambda i: [
            sys.executable, os.path.join(REPO, "tools", name), *args,
            "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--process-id", str(i), "--backend", "gloo", "--device", "cpu,cpu",
            "-c", str(b), "--fields-per-step", "2"])

    outs = tool("torch_distributed_encode.py", *paths, "-o", str(tmp_path / "iq{ch}.cf32"))
    for i, out in enumerate(outs):
        assert f"process {i}: backend gloo" in out
        assert f"process {i}: encoded {t} fields" in out
    seq = Encoder(batch=b, device="cpu").encode_many(ts).numpy()
    for c in range(b):
        assert (tmp_path / f"iq{c}.cf32").read_bytes() == iq_interleave(seq[:, c]).tobytes()

    outs = tool("torch_distributed_decode.py", str(tmp_path / "iq{ch}.cf32"),
                "-o", str(tmp_path / "ts{ch}.ts"))
    for i, out in enumerate(outs):
        assert f"process {i}: decoded {t} fields" in out
    for c in range(b):
        got = np.fromfile(tmp_path / f"ts{c}.ts", np.uint8).reshape(-1, FB)
        np.testing.assert_array_equal(got, ts[: t - 1, c])


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]))
