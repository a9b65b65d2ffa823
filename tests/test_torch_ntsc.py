"""The NTSC co-channel rejection tier of the PyTorch port on the CPU, held
against the JAX package: the comb, the 16-state partial-response ACS and
traceback (the port's plain twins of csrc/viterbi_acs.cu) against the
Pallas kernels in interpret mode and the XLA scan, NtscDecoder,
detect_ntsc's votes, IqReceiver(ntsc="auto") on a co-channel capture, the
decode CLI and decoder-state conversion."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.models import decoder as jdec
from atsc_tpu.ops import ntsc as jn
from atsc_tpu.ops import viterbi as jv
from atsc_tpu.ops.pallas import viterbi_acs as jk
from atsc_tpu_torch.models import decoder as tdec
from atsc_tpu_torch.models import receiver as trx
from atsc_tpu_torch.ops import ntsc as tn
from atsc_tpu_torch.ops.cuda import viterbi_acs as tk
from atsc_tpu_torch.utils import convert
from tests.test_decoder import _random_ts

torch.set_num_threads(2)

N = P.SYMBOLS_PER_FIELD
NE = P.TRELLIS_ENCODERS
_JAX_NTSC_STEP = jax.jit(jdec.ntsc_decode_field)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def _pr_xla(y, z2_prev, metrics):
    """The JAX XLA PR scan (_pr_acs_scan + _traceback_scan) plus packing."""
    b, ne, t = y.shape
    reset, const = jn._pr_reset_tables()
    xs = (jnp.moveaxis(jnp.asarray(y), -1, 0), jnp.asarray(reset[:t]),
          jnp.asarray(const[:t]))
    m, decs = jn._pr_acs_scan(jnp.asarray(metrics), xs, unroll=24)
    start = jnp.argmin(m, axis=-1).astype(jnp.int32)
    x1, z2 = jv._traceback_scan(start, decs, unroll=24, step=jn._pr_traceback_step)
    x1, z2 = np.moveaxis(np.asarray(x1), 0, -1), np.moveaxis(np.asarray(z2), 0, -1)
    z2s = np.concatenate([z2_prev[..., None], z2[..., :-1]], axis=-1)
    x2 = (z2 ^ z2s).reshape(b, ne, t // 4, 4)
    by = (x2 * np.array([128, 32, 8, 2])
          + x1.reshape(b, ne, t // 4, 4) * np.array([64, 16, 4, 1])).sum(-1)
    return by.astype(np.uint8), z2[..., -1].astype(np.int32), np.asarray(m)


def test_viterbi_pr_field_matches_jax():
    """Bytes and z2 exact against the Pallas kernel (interpret) and the XLA
    scan, with segment-sync reset steps inside T. Metrics within the JAX
    test's own tolerance: the side that differs is JAX's, whose XLA:CPU
    build FMA-contracts m + (a + pe)^2; the port rounds the square, then
    adds, as the TPU and the CUDA kernel do."""
    b, t = 32, 96
    rng = np.random.default_rng(3)
    y = rng.normal(0, 6.0, size=(b, NE, t)).astype(np.float32)
    metrics = np.asarray(jn.init_pr_metrics(b))
    z2_prev = rng.integers(0, 2, (b, NE)).astype(np.int32)
    assert jn._pr_reset_tables()[0][:t].sum() > 0
    got = tuple(x.numpy() for x in tn.viterbi_pr_decode_field(
        torch.tensor(y), torch.tensor(z2_prev), torch.tensor(metrics)))
    for want in (jk.viterbi_pr_field_pallas(jnp.asarray(y), jnp.asarray(z2_prev),
                                            jnp.asarray(metrics), interpret=True),
                 _pr_xla(y, z2_prev, metrics)):
        _assert_same(got[:2], want[:2])
        assert got[2].dtype == np.float32
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-4, atol=1e-3)


def test_viterbi_pr_field_carries_state():
    """z2 and metrics chain over 3 calls (B=5: no padding in the port); the
    bytes stay exact against the Pallas kernel fed its own state."""
    b, t = 5, 96
    rng = np.random.default_rng(5)
    mj = mt = np.asarray(jn.init_pr_metrics(b))
    zj = zt = np.zeros((b, NE), np.int32)
    for _ in range(3):
        y = rng.normal(0, 6.0, size=(b, NE, t)).astype(np.float32)
        bj, zj, mj = (np.asarray(x) for x in jk.viterbi_pr_field_pallas(
            jnp.asarray(y), jnp.asarray(zj), jnp.asarray(mj), interpret=True))
        bt, zt, mt = (x.numpy() for x in tk.viterbi_pr_field(
            torch.tensor(y), torch.tensor(zt), torch.tensor(mt)))
        _assert_same((bt, zt), (bj, zj))
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-3)


def test_pr_traceback_matches_jax_kernel():
    """Kernel level: pr_traceback (plain twin) over the Pallas forward
    kernel's own decision words equals the Pallas traceback bit for bit."""
    t, l = 96, 256
    rng = np.random.default_rng(7)
    obs = rng.normal(0, 6.0, (t, l)).astype(np.float32)
    rc = np.broadcast_to(tk._pr_rc_table()[:t, None, :], (t, l // NE + 1, NE))
    rc = np.ascontiguousarray(rc.reshape(t, -1)[:, :l])
    m0 = rng.uniform(0, 50, (16, l)).astype(np.float32)
    dj, mj = jk.pr_acs_forward(jnp.asarray(obs.reshape(t, 2, 128)),
                               jnp.asarray(rc.reshape(t, 2, 128)),
                               jnp.asarray(m0.reshape(16, 2, 128)), interpret=True)
    start = rng.integers(0, 16, l).astype(np.int32)
    bj = jk.pr_traceback(dj, jnp.asarray(start.reshape(2, 128)), interpret=True)
    bt = tk.pr_traceback(torch.tensor(np.asarray(dj).reshape(t, l)), torch.tensor(start))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj).reshape(t // 4, l))
    # and the forward pass: metrics within the JAX test's tolerance
    dt, mt = tk.pr_acs_forward(torch.tensor(obs),
                               torch.tensor(tk._pr_rc_table()[:t]), torch.tensor(m0))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj).reshape(16, l),
                               rtol=1e-4, atol=1e-3)
    assert dt.shape == (t, l) and dt.dtype == torch.int32


def test_comb_field_matches_jax():
    rng = np.random.default_rng(9)
    lev = rng.normal(0, 4, (2, P.PADDED_SYMBOLS)).astype(np.float32)
    got = tn.comb_field(torch.tensor(lev)).numpy()
    _assert_same((got,), (jn.comb_field(jnp.asarray(lev)),))


def test_init_pr_metrics_matches_jax():
    _assert_same((tn.init_pr_metrics(3, device="cpu").numpy(),), (jn.init_pr_metrics(3),))


def test_viterbi_pr_decode_field_refuses_chunks():
    """A chunk count that does not divide the field, or leaves no room for
    the warmup halos, is refused with _chunk_plan's messages; a valid one
    builds an NtscDecoder."""
    y = torch.zeros(1, NE, 48)
    z2, m = torch.zeros(1, NE, dtype=torch.int32), tn.init_pr_metrics(1, device="cpu")
    for c in (5, 2):   # 5 does not divide 48; 2 leaves windows of 24 + 2 * 128 > 48
        with pytest.raises(ValueError) as port:
            tn.viterbi_pr_decode_field(y, z2, m, n_chunks=c)
        with pytest.raises(ValueError) as ref:
            jv._chunk_plan(48, c, 128)
        assert str(port.value) == str(ref.value)
    assert tdec.NtscDecoder(batch=1, viterbi_chunks=4, device="cpu").batch == 1


_JAX_PR_CHUNKED = jax.jit(jn.viterbi_pr_decode_field, static_argnames=("n_chunks",))
SNR14_SIGMA = float(np.sqrt(21.0 / 10 ** 1.4))   # 14 dB on the 8 levels (power 21)


@pytest.mark.parametrize("chunks", [8, 24, 92])      # W mod 4 = 3, 1, 2
@pytest.mark.parametrize("snr", ["clean", "14dB"])
def test_chunked_pr_viterbi_matches_jax(chunks, snr):
    """viterbi_pr_decode_field(n_chunks=C) against the JAX package's
    chunked PR path on two combed fields at B=2 (the second from the first's
    carried state; each chunk reads its own rows of the reset/const
    tables): bytes and z2 bit for bit, metrics within the PR tier's FMA
    tolerance (XLA:CPU contracts m + bm; measured up to 3.1e-5 here)."""
    rng = np.random.default_rng(3000 + chunks)
    b, t = 2, P.TRELLIS_SYMBOLS_PER_ENCODER
    z2 = rng.integers(0, 2, (b, NE)).astype(np.int32)
    m = np.asarray(jn.init_pr_metrics(b))
    z2_t, m_t = torch.tensor(z2), torch.tensor(m)
    for _ in range(2):
        lev = rng.integers(0, 8, (b, NE, t + 1)) * 2 - 7 + P.PILOT_OFFSET
        if snr == "14dB":
            lev = lev + rng.normal(0, SNR14_SIGMA, lev.shape)
        y = (lev[..., 1:] - lev[..., :-1]).astype(np.float32)    # one encoder step back
        want = _JAX_PR_CHUNKED(jnp.asarray(y), jnp.asarray(z2), jnp.asarray(m),
                               n_chunks=chunks)
        got = tn.viterbi_pr_decode_field(torch.tensor(y), z2_t, m_t, n_chunks=chunks)
        _assert_same((got[0].numpy(), got[1].numpy()), want[:2])
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-3)
        z2, m = (np.asarray(x) for x in want[1:])
        z2_t, m_t = got[1], got[2]


def _cci(n: np.ndarray, scale_rms: float) -> np.ndarray:
    """Co-channel tone at the comb's first null (tests/test_ntsc.py)."""
    f = P.SAMPLE_RATE / 12 + P.OSC_FREQUENCY
    return scale_rms * np.exp(2j * np.pi * f * n / P.SAMPLE_RATE + 0.4j)


@pytest.mark.parametrize("kind", ["clean", "awgn", "tone", "mixed"])
def test_detect_ntsc_votes_match_jax(golden, kind):
    lev = golden["sync"][:2, :N].real.astype(np.float32)      # B=2 channels
    rng = np.random.default_rng(79)
    n = np.arange(N)
    tone = (2.0 * np.cos(2 * np.pi * n / 12 + 0.3)).astype(np.float32)
    if kind == "awgn":
        lev = lev + rng.normal(0, 0.3, lev.shape).astype(np.float32)
    elif kind == "tone":
        lev = lev + tone
    elif kind == "mixed":
        lev = lev + np.stack([tone, 0 * tone])
    for per_channel in (True, False):
        got = tn.detect_ntsc(torch.tensor(lev), per_channel=per_channel)
        want = jn.detect_ntsc(lev, per_channel=per_channel)
        np.testing.assert_array_equal(got, want)
    assert list(tn.detect_ntsc(lev, per_channel=True)) == {
        "clean": [False] * 2, "awgn": [False] * 2, "tone": [True] * 2,
        "mixed": [True, False]}[kind]


# -- the slice -------------------------------------------------------------

@pytest.fixture(scope="module")
def level_fields(golden):
    """The 4 golden fields as ideal soft levels (B=1), clean and with a
    co-channel tone at the comb null in the level domain."""
    lev = golden["sync"][:4, None, :N].real.astype(np.float32)
    n = np.arange(4 * N).reshape(4, 1, N)
    tone = (2.0 * np.cos(2 * np.pi * n / 12 + 0.3)).astype(np.float32)
    return golden["input"], {"clean": lev, "tone": lev + tone}


@pytest.mark.parametrize("kind", ["clean", "tone"])
def test_ntsc_decoder_matches_jax(level_fields, kind):
    """NtscDecoder's z2, interleaved field, codewords, syndromes, TS and
    n_errors equal the JAX package's field by field (metrics within the PR
    tolerance; see test_viterbi_pr_field_matches_jax)."""
    from atsc_tpu_torch.ops.decode import deinterleave_field
    from atsc_tpu_torch.ops.rs_decode import syndrome_field

    ts, fields = level_fields
    lev = fields[kind]
    js = jdec.init_ntsc_decoder_state(1)
    jd = jdec.NtscDecoder(batch=1)
    jd._step = _JAX_NTSC_STEP
    td = tdec.NtscDecoder(batch=1, device="cpu")
    for k in range(3):
        prev_il = td.state.prev_il
        js, jcw, jsyn = _JAX_NTSC_STEP(js, jnp.asarray(lev[k]))
        jts, jnerr = jd.decode(lev[k])
        tts, tnerr = td.decode(lev[k])
        _assert_same((td.state.prev_il.numpy(), td.state.z2_prev.numpy()),
                     (js.prev_il, js.z2_prev))
        np.testing.assert_allclose(td.state.metrics.numpy(), np.asarray(js.metrics),
                                   rtol=1e-4, atol=1e-3)
        tcw = deinterleave_field(td.state.prev_il, prev_il).reshape(jcw.shape)
        _assert_same((tcw.numpy(), syndrome_field(tcw).numpy()), (jcw, jsyn))
        _assert_same((tts, tnerr), (jts, jnerr))
        if k:
            np.testing.assert_array_equal(tts[0], ts[k - 1])


def test_ntsc_decoder_state_carries_a_jax_stream(level_fields):
    ts, fields = level_fields
    lev = fields["tone"]
    jd = jdec.NtscDecoder(batch=1)
    jd._step = _JAX_NTSC_STEP
    jd.decode(lev[0])
    leaves = {k: np.asarray(v) for k, v in jd.state._asdict().items()}
    td = tdec.NtscDecoder(batch=1, device="cpu")
    td.state = convert.ntsc_decoder_state_from_numpy(leaves, device="cpu")
    back = convert.ntsc_decoder_state_to_numpy(td.state)
    _assert_same(tuple(back[k] for k in leaves), tuple(leaves.values()))
    for k in (1, 2):
        tts, tnerr = td.decode(lev[k])
        _assert_same((tts, tnerr), jd.decode(lev[k]))
        np.testing.assert_array_equal(tts[0], ts[k - 1])
    with pytest.raises(ValueError):
        convert.ntsc_decoder_state_from_numpy(
            {**leaves, "metrics": leaves["metrics"][..., :4]}, device="cpu")


def test_ntsc_decoder_chunked_matches_jax(level_fields):
    """NtscDecoder(viterbi_chunks=24) against the JAX package's on the
    golden fields with a co-channel tone: TS, n_errors and z2 per field,
    metrics within the PR tolerance."""
    import functools

    ts, fields = level_fields
    lev = fields["tone"]
    jd = jdec.NtscDecoder(batch=1, viterbi_chunks=24)
    jd._step = jax.jit(functools.partial(jdec.ntsc_decode_field, n_chunks=24))
    td = tdec.NtscDecoder(batch=1, viterbi_chunks=24, device="cpu")
    for k in range(4):
        tts, tnerr = td.decode(lev[k])
        _assert_same((tts, tnerr), jd.decode(lev[k]))
        _assert_same((td.state.prev_il.numpy(), td.state.z2_prev.numpy()),
                     (jd.state.prev_il, jd.state.z2_prev))
        np.testing.assert_allclose(td.state.metrics.numpy(), np.asarray(jd.state.metrics),
                                   rtol=1e-4, atol=1e-3)
        if k:
            np.testing.assert_array_equal(tts[0], ts[k - 1])


@pytest.fixture(scope="module")
def cci_capture():
    """tests/test_ntsc.py's co-channel capture: 4 fields of seeded random
    TS through the port's CPU encoder plus a tone at 0.5x signal RMS."""
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    ts = _random_ts(np.random.default_rng(83), 4, 1)
    enc = Encoder(batch=1, device="cpu")
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(4)], -1)
    rms = np.sqrt(np.mean(np.abs(iq) ** 2))
    return ts, iq, (iq + _cci(np.arange(iq.shape[1]), 0.5 * rms)).astype(np.complex64)


def test_hard_receiver_fails_on_cci(cci_capture):
    ts, _, cap = cci_capture
    rx = trx.IqReceiver(batch=1, device="cpu")
    rx.push(cap)
    rx.flush()
    assert rx.decoder.segments_uncorrectable > 0


def test_iq_receiver_ntsc_auto_rejects_cci(cci_capture):
    """ntsc='auto' votes for the comb on the first field, engages it and
    returns the sent TS, as the JAX receiver does (tests/test_ntsc.py)."""
    ts, _, cap = cci_capture
    rx = trx.IqReceiver(batch=1, ntsc="auto", device="cpu")
    got = rx.push(cap) + rx.flush()
    assert rx.ntsc_active and list(rx.ntsc_votes) == [True]
    assert isinstance(rx.decoder, tdec.NtscDecoder)
    assert len(got) == 3
    for k, (out, nerr) in enumerate(got):
        assert (nerr >= 0).all()
        np.testing.assert_array_equal(out, ts[k])


def test_ntsc_auto_stays_off_on_clean_capture(cci_capture):
    ts, iq, _ = cci_capture
    rx = trx.IqReceiver(batch=1, ntsc="auto", device="cpu")
    got = rx.push(iq[:, : 3 * N]) + rx.flush()
    assert not rx.ntsc_active and type(rx.decoder) is tdec.Decoder
    for k, (out, _) in enumerate(got):
        np.testing.assert_array_equal(out, ts[k])


def test_ntsc_auto_split_vote_warns_and_majority_wins(cci_capture):
    """One channel with CCI and one clean: the votes split 1/2, a warning
    goes to stderr, and the batch stays on the plain path (no majority)."""
    ts, iq, cap = cci_capture
    both = np.concatenate([cap[:, : 2 * N], iq[:, : 2 * N]])
    rx = trx.IqReceiver(batch=2, ntsc="auto", device="cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = rx.push(both) + rx.flush()
    assert list(rx.ntsc_votes) == [True, False] and not rx.ntsc_active
    assert "disagrees across channels (1/2" in err.getvalue()
    np.testing.assert_array_equal(got[0][0][1], ts[0, 0])


@pytest.mark.parametrize("kw", [dict(ntsc="comb", erasures="burst"),
                                dict(ntsc="fast"), dict(ntsc="auto", erasures="burst")])
def test_receiver_ntsc_argument_errors(kw):
    with pytest.raises(ValueError):
        trx.IqReceiver(batch=1, device="cpu", **kw)


def test_cli_decode_ntsc_auto_matches_jax_cli(tmp_path, cci_capture):
    """`decode --ntsc auto` on the co-channel capture writes the same TS
    file as the JAX CLI, with summary["ntsc_comb"] true in both."""
    from atsc_tpu.cli import build_decode_argparser, run_decode
    from atsc_tpu_torch import cli as tcli

    ts, _, cap = cci_capture
    cap = cap[:, : 3 * N]
    p = tmp_path / "cci.iq"
    p.write_bytes(np.stack([cap[0].real, cap[0].imag], -1).astype(np.float32).tobytes())
    port_args = tcli.build_decode_argparser().parse_args(
        [str(p), "-o", str(tmp_path / "port.ts"), "--ntsc", "auto", "--device", "cpu"])
    got = tcli.run_decode(port_args)
    want = run_decode(build_decode_argparser().parse_args(
        [str(p), "-o", str(tmp_path / "jax.ts"), "--ntsc", "auto"]))
    assert got["ntsc_comb"] is True and want["ntsc_comb"] is True
    assert got["segments_uncorrectable"] == want["segments_uncorrectable"] == 0
    out = (tmp_path / "port.ts").read_bytes()
    assert out == (tmp_path / "jax.ts").read_bytes() == ts[:2, 0].tobytes()
