"""The soft-decision Viterbi tier of the PyTorch port on the CPU, held
against the JAX package: the 4-state ACS and traceback (the port's plain
twins of csrc/viterbi_acs.cu) against the Pallas kernels in interpret mode
and the XLA scan, bit for bit on bytes, z2 and path metrics; then
SoftDecoder, IqReceiver(trellis="soft"|"soft-i8"), the decode CLI and
decoder-state conversion."""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.models import decoder as jdec
from atsc_tpu.ops import quantize as jq
from atsc_tpu.ops import viterbi as jv
from atsc_tpu.ops.pallas import viterbi_acs as jk
from atsc_tpu_torch.models import decoder as tdec
from atsc_tpu_torch.models import receiver as trx
from atsc_tpu_torch.ops import viterbi as tv
from atsc_tpu_torch.ops.cuda import viterbi_acs as tk
from atsc_tpu_torch.utils import convert
from tests.test_decoder import _random_ts

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
NE = P.TRELLIS_ENCODERS
W2 = np.array([128, 32, 8, 2])
W1 = np.array([64, 16, 4, 1])
# one jitted JAX soft step for every slice test (the JAX SoftDecoder jits a
# fresh partial per instance, so each would compile again), and the XLA
# scan jitted once per shape (called bare, it compiles on every call)
_JAX_SOFT_STEP = jax.jit(jdec.soft_decode_field)
_XLA_BITS = jax.jit(jv.viterbi_bits)


def _noisy_levels(rng, b, t, sigma=1.0) -> np.ndarray:
    ideal = rng.integers(0, 8, size=(b, NE, t)) * 2 - 7 + P.PILOT_OFFSET
    return (ideal + rng.normal(0, sigma, ideal.shape)).astype(np.float32)


def _xla_bytes(levels, z2_prev, metrics):
    """The JAX XLA scan (viterbi_bits) plus byte packing."""
    x1, z2, m = _XLA_BITS(jnp.asarray(levels), jnp.asarray(metrics))
    z2s = jnp.concatenate([jnp.asarray(z2_prev)[..., None], z2[..., :-1]], axis=-1)
    b, ne, t = levels.shape
    x2 = np.asarray(z2 ^ z2s).reshape(b, ne, t // 4, 4)
    x1p = np.asarray(x1).reshape(b, ne, t // 4, 4)
    return ((x2 * W2 + x1p * W1).sum(-1).astype(np.uint8), np.asarray(z2)[..., -1],
            np.asarray(m))


def _port(levels, z2_prev, metrics):
    out = tv.viterbi_decode_field(torch.tensor(levels), torch.tensor(z2_prev),
                                  torch.tensor(metrics))
    return tuple(x.numpy() for x in out)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def test_viterbi_field_bit_identical_to_jax():
    """Bytes, z2 and metrics equal the Pallas kernel (interpret) and the
    XLA scan exactly (B=32, T=96, as tests/test_viterbi.py)."""
    b, t = 32, 96
    rng = np.random.default_rng(7)
    levels = _noisy_levels(rng, b, t)
    metrics = np.asarray(jv.init_metrics(b))
    z2_prev = rng.integers(0, 2, (b, NE)).astype(np.int32)
    got = _port(levels, z2_prev, metrics)
    assert got[0].shape == (b, NE, t // 4)
    _assert_same(got, jk.viterbi_field_pallas(jnp.asarray(levels), jnp.asarray(z2_prev),
                                              jnp.asarray(metrics), interpret=True))
    _assert_same(got, _xla_bytes(levels, z2_prev, metrics))


def test_viterbi_field_odd_batch():
    """B=5: the port takes any number of lanes (no padding to 32 channels,
    which was TPU lane geometry); exact against the Pallas kernel, which
    pads."""
    b, t = 5, 96
    rng = np.random.default_rng(17)
    levels = _noisy_levels(rng, b, t)
    metrics = np.asarray(jv.init_metrics(b))
    z2_prev = rng.integers(0, 2, (b, NE)).astype(np.int32)
    _assert_same(_port(levels, z2_prev, metrics),
                 jk.viterbi_field_pallas(jnp.asarray(levels), jnp.asarray(z2_prev),
                                         jnp.asarray(metrics), interpret=True))


def test_viterbi_field_carries_metrics_and_z2():
    """Metrics and z2 chain over 3 consecutive calls exactly as the Pallas
    kernel's do."""
    b, t = 32, 96
    rng = np.random.default_rng(11)
    mj = mt = np.asarray(jv.init_metrics(b))
    zj = zt = np.zeros((b, NE), np.int32)
    for _ in range(3):
        levels = _noisy_levels(rng, b, t, 0.8)
        bj, zj, mj = (np.asarray(x) for x in jk.viterbi_field_pallas(
            jnp.asarray(levels), jnp.asarray(zj), jnp.asarray(mj), interpret=True))
        bt, zt, mt = _port(levels, zt, mt)
        _assert_same((bt, zt, mt), (bj, zj, mj))


def test_viterbi_field_int8_codes_bit_identical():
    """int8 soft-level codes: the port dequantizes with the same float32
    multiply by SOFT_LEVEL_INV as the Pallas kernel and the XLA path."""
    b, t = 32, 96
    rng = np.random.default_rng(13)
    codes = np.asarray(jq.quantize_soft_levels(jnp.asarray(_noisy_levels(rng, b, t))))
    assert codes.dtype == np.int8
    metrics = np.asarray(jv.init_metrics(b))
    z2_prev = np.zeros((b, NE), np.int32)
    got = _port(codes, z2_prev, metrics)
    _assert_same(got, jk.viterbi_field_pallas(jnp.asarray(codes), jnp.asarray(z2_prev),
                                              jnp.asarray(metrics), interpret=True))
    deq = np.asarray(jnp.asarray(codes).astype(jnp.float32) * jnp.float32(jq.SOFT_LEVEL_INV))
    _assert_same(got, _xla_bytes(deq, z2_prev, metrics))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_acs_forward_and_traceback_match_jax_kernels(dtype):
    """Kernel level: the decision words, final metrics and traceback words
    of acs_forward/traceback (plain twins on the CPU) equal the Pallas
    kernels' on the same (T, L) lanes (L = 3 x 128)."""
    t, l = 96, 384
    rng = np.random.default_rng(19)
    obs = _noisy_levels(rng, l // NE, t).reshape(l, t).T.copy()
    inv = None
    if dtype == "int8":
        obs = np.asarray(jq.quantize_soft_levels(jnp.asarray(obs)))
        inv = float(jq.SOFT_LEVEL_INV)
    m0 = rng.uniform(0, 50, (4, l)).astype(np.float32)
    dj, mj = jk.acs_forward(jnp.asarray(obs.reshape(t, 3, 128)),
                            jnp.asarray(m0.reshape(4, 3, 128)), interpret=True,
                            inv_scale=inv)
    dt, mt = tk.acs_forward(torch.tensor(obs), torch.tensor(m0), inv_scale=inv)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj).reshape(t // 4, l))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj).reshape(4, l))
    start = rng.integers(0, 4, l).astype(np.int32)
    bj = jk.traceback(dj, jnp.asarray(start.reshape(3, 128)), interpret=True)
    bt = tk.traceback(dt, torch.tensor(start))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj).reshape(t // 4, l))
    assert tk.LAUNCHES["acs_forward"] == 0    # a CPU tensor never launches


def test_pack_bits_to_bytes_matches_jax():
    rng = np.random.default_rng(23)
    words, l = 24, 256
    bits = (rng.integers(0, 4, (words, 4, l)) << (8 * np.arange(4))[None, :, None]).sum(1)
    bits = bits.astype(np.int32)
    z2 = rng.integers(0, 2, l).astype(np.int32)
    got = tk.pack_bits_to_bytes(torch.tensor(bits), torch.tensor(z2))
    want = jk.pack_bits_to_bytes(jnp.asarray(bits.reshape(words, 2, 128)),
                                 jnp.asarray(z2.reshape(2, 128)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).reshape(words, l))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).reshape(l))


def test_pack_trellis_bytes_and_init_metrics_match_jax():
    rng = np.random.default_rng(29)
    x2 = rng.integers(0, 2, (2, NE, P.TRELLIS_SYMBOLS_PER_ENCODER)).astype(np.int32)
    x1 = rng.integers(0, 2, x2.shape).astype(np.int32)
    got = tv.pack_trellis_bytes(torch.tensor(x2), torch.tensor(x1)).numpy()
    _assert_same((got,), (jv.pack_trellis_bytes(jnp.asarray(x2), jnp.asarray(x1)),))
    _assert_same((tv.init_metrics(3, device="cpu").numpy(),), (jv.init_metrics(3),))


@pytest.mark.parametrize("case", ["steps", "metrics_shape", "metrics_dtype", "inv_f32",
                                  "inv_missing", "obs_dtype", "tb_rows", "tb_start",
                                  "rc_shape"])
def test_kernel_wrappers_refuse_bad_input(case):
    obs = torch.zeros(48, 24)
    m4 = torch.zeros(4, 24)
    call = {
        "steps": lambda: tk.acs_forward(torch.zeros(50, 24), m4),
        "metrics_shape": lambda: tk.acs_forward(obs, torch.zeros(4, 25)),
        "metrics_dtype": lambda: tk.acs_forward(obs, m4.double()),
        "inv_f32": lambda: tk.acs_forward(obs, m4, inv_scale=0.5),
        "inv_missing": lambda: tk.acs_forward(obs.to(torch.int8), m4),
        "obs_dtype": lambda: tk.acs_forward(obs.double(), m4),
        "tb_rows": lambda: tk.traceback(torch.zeros(10, 24, dtype=torch.int32),
                                        torch.zeros(24, dtype=torch.int32)),
        "tb_start": lambda: tk.traceback(torch.zeros(12, 24, dtype=torch.int32),
                                         torch.zeros(24, dtype=torch.int64)),
        "rc_shape": lambda: tk.pr_acs_forward(obs, torch.zeros(48, 11, dtype=torch.int32),
                                              torch.zeros(16, 24)),
    }[case]
    with pytest.raises(ValueError):
        call()


def test_viterbi_decode_field_refuses_chunks():
    """A chunk count must divide the field and leave room for the warmup
    halos: _chunk_plan's ValueErrors, with the JAX package's messages; a
    valid count builds a SoftDecoder."""
    lev = torch.zeros(1, NE, 48)
    z2, m = torch.zeros(1, NE, dtype=torch.int32), tv.init_metrics(1, device="cpu")
    for c in (5, 2):   # 5 does not divide 48; 2 leaves windows of 24 + 2 * 128 > 48
        with pytest.raises(ValueError) as port:
            tv.viterbi_decode_field(lev, z2, m, n_chunks=c)
        with pytest.raises(ValueError) as ref:
            jv._chunk_plan(48, c, 128)
        assert str(port.value) == str(ref.value)
    assert tdec.SoftDecoder(batch=1, viterbi_chunks=4, device="cpu").batch == 1


# -- the chunk-parallel Viterbi (n_chunks > 1) --------------------------------

def test_chunk_warmup_is_one_constant():
    """The chunked kernels fix their warm-up at compile time (kWarmup in
    csrc/viterbi_acs.cu); the wrappers' plans and twins use WARMUP, and
    the JAX package's chunked decode the default of viterbi_bits: all one
    value."""
    import inspect
    import os
    import re

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "atsc_tpu_torch", "csrc", "viterbi_acs.cu")
    with open(src) as fh:
        text = fh.read()
    k_warmup = int(re.search(r"constexpr int kWarmup = (\d+);", text).group(1))
    jax_default = inspect.signature(jv.viterbi_bits).parameters["warmup"].default
    assert k_warmup == tk.WARMUP == jax_default
    assert "warmup" not in text[text.index('extern "C" {'):]   # not an argument

# one jitted JAX chunked field decode per chunk count and input type
_JAX_CHUNKED = jax.jit(jv.viterbi_decode_field, static_argnames=("n_chunks",))
SNR14_SIGMA = float(np.sqrt(21.0 / 10 ** 1.4))   # 14 dB on the 8 levels (power 21)


@pytest.mark.parametrize("chunks", [8, 24, 92])      # W mod 4 = 3, 1, 2
@pytest.mark.parametrize("obs", ["f32", "int8"])
@pytest.mark.parametrize("snr", ["clean", "14dB"])
def test_chunked_viterbi_bit_identical_to_jax(chunks, obs, snr):
    """viterbi_decode_field(n_chunks=C) against the JAX package's
    chunk-parallel path (its lax.scan of _acs_step, per-step
    renormalization) on two fields at B=2, the second from the first's
    carried metrics and z2: bytes, z2 and metrics bit for bit."""
    rng = np.random.default_rng(1000 + chunks)
    b, t = 2, P.TRELLIS_SYMBOLS_PER_ENCODER
    z2 = rng.integers(0, 2, (b, NE)).astype(np.int32)
    m = np.asarray(jv.init_metrics(b))
    z2_t, m_t = torch.tensor(z2), torch.tensor(m)
    for _ in range(2):
        lev = _noisy_levels(rng, b, t, 0.0 if snr == "clean" else SNR14_SIGMA)
        if obs == "int8":
            lev = np.asarray(jq.quantize_soft_levels(jnp.asarray(lev)))
        want = _JAX_CHUNKED(jnp.asarray(lev), jnp.asarray(z2), jnp.asarray(m),
                            n_chunks=chunks)
        got = tv.viterbi_decode_field(torch.tensor(lev), z2_t, m_t, n_chunks=chunks)
        _assert_same(tuple(x.numpy() for x in got), want)
        z2, m = (np.asarray(x) for x in want[1:])
        z2_t, m_t = got[1], got[2]


@pytest.mark.parametrize("chunks", [8, 24, 92])
def test_chunked_kernel_twins_match_window_decode(chunks):
    """The chunked twins against the JAX package's per-step scan run on
    windows gathered by hand (first, middle and last chunk): the same final
    metrics, and each chunk's kept region of the bits comes from its own
    window's traceback."""
    rng = np.random.default_rng(2000 + chunks)
    t, l = P.TRELLIS_SYMBOLS_PER_ENCODER, 12
    obs = torch.tensor(_noisy_levels(rng, 1, t, 0.8)[0].T.copy())       # (T, 12)
    m0 = torch.zeros(4, chunks * l)
    m0[:, :l] = torch.tensor(np.asarray(jv.init_metrics(1))[0].T)
    dec, mout = tk.acs_forward_chunked(obs, m0, chunks)
    length, w, starts, offs = jv._chunk_plan(t, chunks, 128)
    assert tuple(dec.shape) == (-(-w // 4), chunks * l)
    start = torch.argmin(mout, dim=0).to(torch.int32)
    bits = tk.traceback_chunked(dec, start, t, chunks).numpy()
    # each chunk's window through the JAX per-step scan
    for c in (0, chunks // 2, chunks - 1):
        win = jnp.asarray(obs.numpy()[starts[c]:starts[c] + w].T[None])   # (1, 12, W)
        init = m0[:, c * l:(c + 1) * l].numpy().T[None]
        fin, decs = jax.lax.scan(jv._acs_step, jnp.asarray(init), jnp.moveaxis(win, -1, 0))
        np.testing.assert_array_equal(np.asarray(fin)[0].T, mout[:, c * l:(c + 1) * l].numpy())
        st = jnp.argmin(fin, axis=-1).astype(jnp.int32)
        _, (x1, z2) = jax.lax.scan(jv._traceback_step, st, decs, reverse=True)
        pair = (np.asarray(x1) | (np.asarray(z2) << 1))[:, 0].astype(np.uint8)    # (W, 12)
        kept = pair[offs[c]:offs[c] + length]
        got = bits.view(np.uint8).reshape(t // 4, l, 4).transpose(0, 2, 1).reshape(t, l)
        np.testing.assert_array_equal(got[c * length:(c + 1) * length], kept)


def test_chunked_wrappers_refuse_bad_input():
    t = P.TRELLIS_SYMBOLS_PER_ENCODER
    obs = torch.zeros(t, 12)
    with pytest.raises(ValueError, match="chunks must divide"):
        tk.acs_forward_chunked(obs, torch.zeros(4, 5 * 12), 5)
    with pytest.raises(ValueError, match="a column per chunk-lane"):
        tk.acs_forward_chunked(obs, torch.zeros(4, 12), 4)
    with pytest.raises(ValueError, match="decisions must be"):
        tk.traceback_chunked(torch.zeros(9, 48, dtype=torch.int32),
                             torch.zeros(48, dtype=torch.int32), t, 4)


def test_soft_decoder_chunked_matches_jax(level_fields):
    """SoftDecoder(viterbi_chunks=24) against the JAX package's on the
    noisy golden fields: TS and n_errors per field, and the state."""
    ts, fields = level_fields
    lev = fields["noisy"]
    jd = jdec.SoftDecoder(batch=1, viterbi_chunks=24)
    jd._step = jax.jit(functools.partial(jdec.soft_decode_field, n_chunks=24))
    td = tdec.SoftDecoder(batch=1, viterbi_chunks=24, device="cpu")
    for k in range(3):
        _assert_same(td.decode(lev[k]), jd.decode(lev[k]))
        _assert_same(tuple(v.numpy() for v in td.state), tuple(jd.state))
    np.testing.assert_array_equal(td.decode(lev[3])[0][0], ts[2])


# -- the slice -------------------------------------------------------------

@pytest.fixture(scope="module")
def level_fields(golden):
    """The 4 golden fields as ideal soft levels (B=1), and the same plus
    seeded AWGN (sigma 0.7, where hard slicing floods RS); their TS is
    golden["input"]."""
    lev = golden["sync"][:4, None, :N].real.astype(np.float32)
    rng = np.random.default_rng(89)
    noisy = lev + rng.normal(size=lev.shape).astype(np.float32) * 0.7
    return golden["input"], {"clean": lev, "noisy": noisy}


def _jax_soft_decoder(b):
    d = jdec.SoftDecoder(batch=b)
    d._step = _JAX_SOFT_STEP
    return d


@pytest.mark.parametrize("kind", ["clean", "noisy"])
def test_soft_decoder_matches_jax(level_fields, kind):
    """SoftDecoder's state (interleaved field, z2, metrics), codewords,
    syndromes, TS and n_errors equal the JAX package's field by field; the
    noisy fields need RS and still decode exactly."""
    from atsc_tpu_torch.ops.decode import deinterleave_field
    from atsc_tpu_torch.ops.rs_decode import syndrome_field

    ts, fields = level_fields
    lev = fields[kind]
    js = jdec.init_soft_decoder_state(1)
    jd, td = _jax_soft_decoder(1), tdec.SoftDecoder(batch=1, device="cpu")
    for k in range(3):
        prev_il = td.state.prev_il
        js, jcw, jsyn = _JAX_SOFT_STEP(js, jnp.asarray(lev[k]))
        jts, jn = jd.decode(lev[k])
        tts, tn = td.decode(lev[k])
        _assert_same(tuple(v.numpy() for v in td.state), tuple(js))
        tcw = deinterleave_field(td.state.prev_il, prev_il).reshape(jcw.shape)
        _assert_same((tcw.numpy(), syndrome_field(tcw).numpy()), (jcw, jsyn))
        _assert_same((tts, tn), (jts, jn))
        if k:
            np.testing.assert_array_equal(tts[0], ts[k - 1])
            assert (tn >= 0).all()
    assert td.segments_corrected == jd.segments_corrected
    assert (td.segments_corrected > 0) == (kind == "noisy")


def test_soft_decoder_state_carries_a_jax_stream(level_fields):
    """A JAX soft stream (metrics included) moves into the port after one
    field and decodes on with the same bytes."""
    ts, fields = level_fields
    lev = fields["noisy"]
    jd = _jax_soft_decoder(1)
    jd.decode(lev[0])
    leaves = {k: np.asarray(v) for k, v in jd.state._asdict().items()}
    td = tdec.SoftDecoder(batch=1, device="cpu")
    td.state = convert.soft_decoder_state_from_numpy(leaves, device="cpu")
    back = convert.soft_decoder_state_to_numpy(td.state)
    _assert_same(tuple(back[k] for k in leaves), tuple(leaves.values()))
    for k in (1, 2):
        tts, tn = td.decode(lev[k])
        _assert_same((tts, tn), jd.decode(lev[k]))
        np.testing.assert_array_equal(tts[0], ts[k - 1])
    with pytest.raises(ValueError):
        convert.soft_decoder_state_from_numpy(
            {**leaves, "metrics": leaves["metrics"][..., :2]}, device="cpu")
    with pytest.raises(ValueError):
        convert.soft_decoder_state_from_numpy(
            {k: v for k, v in leaves.items() if k != "metrics"}, device="cpu")


@pytest.fixture(scope="module")
def noisy_capture():
    """The noisy capture of tests/test_viterbi.py (IQ noise 0.035 per
    component): 3 fields of seeded random TS through the port's CPU
    encoder."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    rng = np.random.default_rng(97)
    ts = _random_ts(rng, 3, 1)
    enc = Encoder(batch=1, device="cpu")
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(3)], -1)
    noise = rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape)
    return ts, (iq + noise * 0.035).astype(np.complex64)


def test_hard_receiver_fails_on_noisy_capture(noisy_capture):
    ts, iq = noisy_capture
    rx = trx.IqReceiver(batch=1, device="cpu")
    got = rx.push(iq) + rx.flush()
    assert not all((n >= 0).all() and np.array_equal(out, ts[k])
                   for k, (out, n) in enumerate(got))


@pytest.mark.parametrize("trellis", ["soft", "soft-i8"])
def test_iq_receiver_soft_tiers_on_noisy_capture(noisy_capture, trellis):
    """Where the hard receiver fails, both soft tiers return the sent TS,
    as the JAX receiver's soft tiers do (tests/test_viterbi.py)."""
    ts, iq = noisy_capture
    rx = trx.IqReceiver(batch=1, trellis=trellis, device="cpu")
    got = rx.push(iq[:, :300_000]) + rx.push(iq[:, 300_000:]) + rx.flush()
    assert len(got) == 2 and isinstance(rx.decoder, tdec.SoftDecoder)
    for k, (out, nerr) in enumerate(got):
        assert (nerr >= 0).all()
        np.testing.assert_array_equal(out, ts[k])


def test_iq_receiver_soft_measures_mer_without_slicing(noisy_capture):
    """measure_mer with trellis='soft' reads the levels and still decodes
    them by maximum likelihood."""
    ts, iq = noisy_capture
    rx = trx.IqReceiver(batch=1, trellis="soft", measure_mer=True, device="cpu")
    got = rx.push(iq) + rx.flush()
    np.testing.assert_array_equal(got[0][0], ts[0])
    assert 5.0 < rx.mer[0] < 30.0


@pytest.mark.parametrize("kw", [dict(measure_mer=True), dict(erasures="burst"),
                                dict(ntsc="comb"), dict(ntsc="auto"),
                                dict(backend="adaptive")])
def test_soft_i8_incompatibilities(kw):
    with pytest.raises(ValueError, match="soft-i8"):
        trx.IqReceiver(batch=1, trellis="soft-i8", device="cpu", **kw)


def test_cli_decode_trellis_viterbi_matches_jax_cli(tmp_path, noisy_capture):
    """`decode --trellis viterbi` on the noisy cf32 capture writes the same
    TS file as the JAX CLI, and the sent TS."""
    from atsc_tpu import cli as jcli
    from atsc_tpu_torch import cli as tcli

    ts, iq = noisy_capture
    cap = tmp_path / "noisy.iq"
    cap.write_bytes(np.stack([iq[0].real, iq[0].imag], -1).astype(np.float32).tobytes())
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main(["decode", str(cap), "-o", str(tmp_path / "port.ts"),
                          "--trellis", "viterbi", "--device", "cpu", "--stats"]) == 0
    assert jcli.main(["decode", str(cap), "-o", str(tmp_path / "jax.ts"),
                      "--trellis", "viterbi"]) == 0
    got = (tmp_path / "port.ts").read_bytes()
    assert got == (tmp_path / "jax.ts").read_bytes()
    assert got == ts[:2, 0].tobytes()
    import json

    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    assert stats["segments_uncorrectable"] == 0 and "ntsc_comb" not in stats
    assert "mer_db" in stats


@pytest.mark.parametrize("flags", [["--trellis", "viterbi", "--viterbi-chunks", "24"],
                                   ["--trellis", "viterbi-i8", "--viterbi-chunks", "92"]])
def test_cli_decode_viterbi_chunks_matches_jax_cli(tmp_path, noisy_capture, flags):
    """`decode --viterbi-chunks N` (soft and soft-i8 tiers) on the noisy
    capture writes the JAX CLI's TS file, which is the sent TS."""
    from atsc_tpu import cli as jcli
    from atsc_tpu_torch import cli as tcli

    ts, iq = noisy_capture
    cap = tmp_path / "noisy.iq"
    cap.write_bytes(np.stack([iq[0].real, iq[0].imag], -1).astype(np.float32).tobytes())
    with contextlib.redirect_stderr(io.StringIO()):
        assert tcli.main(["decode", str(cap), "-o", str(tmp_path / "port.ts"),
                          "--device", "cpu", *flags]) == 0
    assert jcli.main(["decode", str(cap), "-o", str(tmp_path / "jax.ts"), *flags]) == 0
    got = (tmp_path / "port.ts").read_bytes()
    assert got == (tmp_path / "jax.ts").read_bytes() == ts[:2, 0].tobytes()


def test_cli_decode_viterbi_i8_reports_no_mer(tmp_path, noisy_capture):
    """`decode --trellis viterbi-i8 --stats` decodes the noisy capture from
    int8 soft codes and leaves the MER out of the summary (its codes cannot
    feed the MER accumulator), as the JAX CLI does."""
    from atsc_tpu_torch import cli as tcli

    ts, iq = noisy_capture
    cap = tmp_path / "noisy.iq"
    cap.write_bytes(np.stack([iq[0].real, iq[0].imag], -1).astype(np.float32).tobytes())
    args = tcli.build_decode_argparser().parse_args(
        [str(cap), "-o", str(tmp_path / "i8.ts"), "--trellis", "viterbi-i8",
         "--device", "cpu", "--stats"])
    with contextlib.redirect_stderr(io.StringIO()):
        summary = tcli.run_decode(args)
    assert "mer_db" not in summary and summary["segments_uncorrectable"] == 0
    assert (tmp_path / "i8.ts").read_bytes() == ts[:2, 0].tobytes()
