"""The port's RS(207,187) errors-only decoder on the CPU against the JAX
package's, bit for bit: syndromes, the device corrector's codewords and
error counts, and the host tables both build."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atsc_tpu import params as P
from atsc_tpu.ops import rs_decode as jrs
from atsc_tpu.tables.galois import gf_mul
from atsc_tpu_torch.ops import rs_decode as trs

torch.set_num_threads(2)

SEG, N = P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES


@pytest.fixture(scope="module")
def noisy_field(golden):
    """(1, 312, 207) valid codewords with 0-12 byte errors injected per
    segment (seeded): 0-10 correctable, 11-12 mostly not."""
    rng = np.random.default_rng(2026)
    clean = golden["rs"][0].reshape(1, SEG, N).copy()
    bad = clean.copy()
    counts = np.arange(SEG) % 13
    for seg, k in enumerate(counts):
        pos = rng.choice(N, size=k, replace=False)
        bad[0, seg, pos] ^= rng.integers(1, 256, size=k).astype(np.uint8)
    return clean, bad, counts


@pytest.fixture(scope="module")
def jax_corrected(noisy_field):
    _, bad, _ = noisy_field
    syn = jrs.syndrome_field(jnp.asarray(bad))
    cw, n = jrs.rs_correct_field_jit(jnp.asarray(bad), syn)
    return np.asarray(syn), np.asarray(cw), np.asarray(n)


def test_syndrome_field_identical_to_jax(noisy_field, jax_corrected):
    _, bad, _ = noisy_field
    got = trs.syndrome_field(torch.tensor(bad)).numpy()
    assert got.dtype == np.uint8 and got.shape == (1, SEG, P.RS_BYTES)
    np.testing.assert_array_equal(got, jax_corrected[0])
    clean_syn = trs.syndrome_field(torch.tensor(noisy_field[0])).numpy()
    assert not clean_syn.any()


def test_rs_correct_field_bit_identical_to_jax(noisy_field, jax_corrected):
    clean, bad, counts = noisy_field
    syn = trs.syndrome_field(torch.tensor(bad))
    cw, n = trs.rs_correct_field(torch.tensor(bad), syn)
    cw, n = cw.numpy(), n.numpy()
    assert cw.dtype == np.uint8 and n.dtype == np.int32
    np.testing.assert_array_equal(cw, jax_corrected[1])
    np.testing.assert_array_equal(n, jax_corrected[2])
    # and the decode is right: every segment with <= 10 errors restored
    ok = counts <= 10
    np.testing.assert_array_equal(n[0, ok], counts[ok])
    np.testing.assert_array_equal(cw[0, ok], clean[0, ok])
    assert (n[0, counts > 10] == -1).any()


def test_rs_correct_field_leading_batch_dims(noisy_field):
    """Any leading batch shape: (2, 312) gives each row's own result."""
    clean, bad, _ = noisy_field
    both = np.concatenate([bad, clean])
    syn = trs.syndrome_field(torch.tensor(both))
    cw, n = trs.rs_correct_field(torch.tensor(both), syn)
    one, n1 = trs.rs_correct_field(torch.tensor(bad), trs.syndrome_field(torch.tensor(bad)))
    np.testing.assert_array_equal(cw[:1].numpy(), one.numpy())
    np.testing.assert_array_equal(n[:1].numpy(), n1.numpy())
    np.testing.assert_array_equal(cw[1].numpy(), clean[0])
    assert not n[1].any()


def test_gf_arithmetic_matches_tables():
    """_gf_mul_dev over all 256 x 256 pairs equals the log/exp table
    multiply; _gf_inv_dev inverts every non-zero element."""
    a = torch.arange(256, dtype=torch.int32)[:, None]
    b = torch.arange(256, dtype=torch.int32)[None, :]
    want = gf_mul(np.arange(256)[:, None], np.arange(256)[None, :])
    np.testing.assert_array_equal(trs._gf_mul_dev(a, b).numpy(), want.astype(np.int32))
    x = torch.arange(1, 256, dtype=torch.int32)
    assert (trs._gf_mul_dev(x, trs._gf_inv_dev(x)) == 1).all()
    assert int(trs._gf_inv_dev(torch.zeros(1, dtype=torch.int32))) == 0


@pytest.mark.parametrize("name", ["syndrome", "chien", "omega", "lamprime", "alpha_j"])
def test_host_matrices_equal_jax(name):
    if name == "syndrome":
        got, want = trs._syndrome_bit_matrix(), jrs._syndrome_bit_matrix()
    elif name == "alpha_j":
        got, want = trs._alpha_j(), jrs._alpha_j()
    else:
        got, want = trs._eval_bit_matrix(name), jrs._eval_bit_matrix(name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_syndromes_np_equal_jax(noisy_field):
    _, bad, _ = noisy_field
    np.testing.assert_array_equal(trs.syndromes_np(bad[0, :8]),
                                  jrs.syndromes_np(bad[0, :8]))
