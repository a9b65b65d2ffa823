"""The PyTorch port's stage ops against the JAX reference ops and the
golden stage dumps, on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.ops import assemble as jax_assemble
from atsc_tpu.ops import interleave as jax_interleave
from atsc_tpu.ops import offset as jax_offset
from atsc_tpu.ops import quantize as jax_quantize
from atsc_tpu.ops import randomize as jax_randomize
from atsc_tpu.ops import rrc_filter as jax_rrc
from atsc_tpu.ops import rs_encode as jax_rs
from atsc_tpu.ops import trellis as jax_trellis
from atsc_tpu.tables.oscillator import phasor_for_field
from atsc_tpu_torch.ops import quantize as pt_quantize
from atsc_tpu_torch.ops.assemble import assemble_field_structured, field_levels
from atsc_tpu_torch.ops.interleave import interleave_field_enc_major
from atsc_tpu_torch.ops.offset import advance_phasor, apply_pilot_offset
from atsc_tpu_torch.ops.randomize import randomize_field
from atsc_tpu_torch.ops.rrc_filter import rrc_filter_field
from atsc_tpu_torch.ops.rs_encode import rs_encode_field
from atsc_tpu_torch.ops.trellis import trellis_encode_field

torch.set_num_threads(2)


def _enc_major(il_round_major: np.ndarray) -> np.ndarray:
    """(..., 64584) round-major interleaved bytes -> (..., 12, 5382)."""
    lead = il_round_major.shape[:-1]
    x = il_round_major.reshape(*lead, P.TRELLIS_ROUNDS, P.TRELLIS_ENCODERS,
                               P.TRELLIS_INPUT_BYTES)
    return np.swapaxes(x, -3, -2).reshape(*lead, P.TRELLIS_ENCODERS, -1)


def test_front_stages_match_golden(golden):
    """randomize, RS and interleave, field by field with the interleaver's
    previous field carried: byte-exact against the golden dumps."""
    prev = torch.zeros((1, P.DATA_PER_FIELD), dtype=torch.uint8)
    for f in range(4):
        rand = randomize_field(torch.tensor(golden["input"][f][None]))
        np.testing.assert_array_equal(rand.numpy().reshape(-1), golden["rand"][f])
        rs = rs_encode_field(rand).reshape(1, -1)
        np.testing.assert_array_equal(rs.numpy()[0], golden["rs"][f])
        il = interleave_field_enc_major(rs, prev)
        np.testing.assert_array_equal(il.numpy()[0], _enc_major(golden["il"][f]))
        prev = rs


def test_front_stages_match_jax_random():
    """The same three stages on random TS at B=3: byte-exact against JAX."""
    rng = np.random.default_rng(11)
    ts = rng.integers(0, 256, size=(3, P.FIELD_TS_BYTES), dtype=np.uint8)
    prev = rng.integers(0, 256, size=(3, P.DATA_PER_FIELD), dtype=np.uint8)

    rand = randomize_field(torch.tensor(ts))
    want_rand = np.asarray(jax_randomize.randomize_field(jnp.asarray(ts)))
    np.testing.assert_array_equal(rand.numpy(), want_rand)

    rs = rs_encode_field(rand)
    want_rs = np.asarray(jax_rs.rs_encode_field(jnp.asarray(want_rand)))
    np.testing.assert_array_equal(rs.numpy(), want_rs)

    flat = want_rs.reshape(3, -1)
    il = interleave_field_enc_major(rs.reshape(3, -1), torch.tensor(prev))
    want_il = jax_interleave.interleave_field_enc_major(
        jnp.asarray(flat), jnp.asarray(prev))
    np.testing.assert_array_equal(il.numpy(), np.asarray(want_il))


def test_trellis_matches_jax_with_carries():
    """Symbols and the 36 carried bits exact against JAX, from random
    nonzero carries, over two chained fields."""
    rng = np.random.default_rng(12)
    carries = [rng.integers(0, 2, size=(3, 12), dtype=np.int32) for _ in range(3)]
    assert all(c.any() for c in carries)
    pt_c = [torch.tensor(c) for c in carries]
    jx_c = [jnp.asarray(c) for c in carries]
    for _ in range(2):
        il = rng.integers(0, 256, size=(3, 12, P.TRELLIS_BYTES_PER_ENCODER),
                          dtype=np.uint8)
        sym, *pt_c = trellis_encode_field(torch.tensor(il), *pt_c)
        want, *jx_c = jax_trellis.trellis_encode_field(jnp.asarray(il), *jx_c)
        assert sym.dtype == torch.int8
        np.testing.assert_array_equal(sym.numpy(), np.asarray(want))
        for got_c, want_c in zip(pt_c, jx_c):
            assert got_c.dtype == torch.int32
            np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_assemble_and_levels_match_jax():
    """assemble_field_structured (commutator + sync + reserved symbols) and
    field_levels exact against JAX, both parities."""
    rng = np.random.default_rng(13)
    sym = rng.integers(0, 8, size=(3, 12, P.TRELLIS_SYMBOLS_PER_ENCODER),
                       dtype=np.int8)
    parity = np.array([0, 1, 1], dtype=np.int32)
    saved = rng.integers(0, 8, size=(3, P.RESERVED_SYMBOLS), dtype=np.int8)

    field, new_saved = assemble_field_structured(
        torch.tensor(sym), torch.tensor(parity), torch.tensor(saved))
    want_f, want_s = jax_assemble.assemble_field_structured(
        jnp.asarray(sym), jnp.asarray(parity), jnp.asarray(saved))
    assert field.shape == (3, P.PADDED_SYMBOLS) and field.dtype == torch.int8
    np.testing.assert_array_equal(field.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(new_saved.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        field_levels(field).numpy(),
        np.asarray(jax_assemble.field_levels(want_f)))


def test_advance_phasor_bit_exact():
    """advance_phasor equals JAX's and phasor_for_field(k) bit for bit,
    k = 1..8 (the float32 recurrence, no FMA)."""
    z0 = phasor_for_field(0)
    start = np.array([[z0.real, z0.imag]] * 2, dtype=np.float32)
    pt, jx = torch.tensor(start), jnp.asarray(start)
    for k in range(1, 9):
        pt, jx = advance_phasor(pt), jax_offset.advance_phasor(jx)
        got = pt.numpy()
        np.testing.assert_array_equal(got, np.asarray(jx))
        z = phasor_for_field(k)
        want = np.array([np.float32(z.real), np.float32(z.imag)], np.float32)
        np.testing.assert_array_equal(got[0], want)


def test_pilot_offset_and_fir_match_jax():
    """apply_pilot_offset within 1e-6 and the banded FIR within 2e-6 of
    JAX (float32; the two may order or fuse the products differently)."""
    rng = np.random.default_rng(14)
    lvl = rng.choice(np.arange(-7, 8, 2, dtype=np.float32) + 1.25,
                     size=(2, P.PADDED_SYMBOLS)).astype(np.float32)
    s = jax_offset._scale_planar()
    phasor = np.array([[1.0, 0.0], [s[0], s[1]]], dtype=np.float32)

    iq, nxt = apply_pilot_offset(torch.tensor(lvl), torch.tensor(phasor))
    want_iq, want_nxt = jax_offset.apply_pilot_offset(
        jnp.asarray(lvl), jnp.asarray(phasor))
    assert np.abs(iq.numpy() - np.asarray(want_iq)).max() <= 1e-6
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want_nxt))

    out = rrc_filter_field(iq)
    want = np.asarray(jax_rrc.rrc_filter_field(want_iq))
    assert out.shape == (2, 2, P.PADDED_OUT)
    n = P.SYMBOLS_PER_FIELD
    assert np.abs(out.numpy()[..., :n] - want[..., :n]).max() <= 2e-6


@pytest.mark.parametrize("fmt", ["cs16", "cs8"])
def test_quantize_and_wire_match_jax(fmt):
    """quantize_iq (round-half-even at the same float32 scale) and
    pack_wire exact against JAX on the same float32 input; unpack_wire
    inverts pack_wire; the scale constants agree."""
    assert pt_quantize.QMAX == jax_quantize.QMAX
    assert pt_quantize.quantize_scale(fmt) == jax_quantize.quantize_scale(fmt)
    rng = np.random.default_rng(15)
    peak = jax_quantize.iq_peak()
    iq = rng.uniform(-1.2 * peak, 1.2 * peak, size=(2, 2, 4096)).astype(np.float32)
    # exact half-code points: round-half-even must pick the even code
    halves = (np.arange(-8, 8) + 0.5) / np.float32(jax_quantize.quantize_scale(fmt))
    iq[0, 0, :16] = halves.astype(np.float32)

    codes = pt_quantize.quantize_iq(torch.tensor(iq), fmt)
    want = np.asarray(jax_quantize.quantize_iq(jnp.asarray(iq), fmt))
    assert codes.dtype == pt_quantize.DTYPE[fmt]
    np.testing.assert_array_equal(codes.numpy(), want)

    packed = pt_quantize.pack_wire(codes, fmt)
    want_packed = np.asarray(jax_quantize.pack_wire(jnp.asarray(want), fmt))
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    np.testing.assert_array_equal(pt_quantize.unpack_wire(packed.numpy(), fmt), want)
    np.testing.assert_array_equal(
        pt_quantize.dequantize_iq(want, fmt), jax_quantize.dequantize_iq(want, fmt))
