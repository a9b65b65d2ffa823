"""The port's RS(207,187) decoder on the CPU against the JAX package's,
bit for bit: syndromes, the errors-only and the errors-and-erasures
correctors' codewords and counts (on tests/test_rs_decode.py's own
cases), and the host tables both build."""

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


# -- the errors-and-erasures tier ---------------------------------------------
#
# JAX's rs_correct_field_erasures runs eagerly here (op by op): the jitted
# whole takes XLA:CPU minutes to compile, the eager form ~15 s once per
# shape, so every case below rides (1, 312, 207) fields.

SWEEP = [(20, 0), (14, 3), (8, 6), (1, 9), (4, 8)]   # (erasures, errors)
N_FUZZ = 40


def _oracle_mix(clean, rng):
    """tests/test_rs_decode.py's oracle field: per segment (seg % 6) clean,
    errors only, erasures only, a full-budget mix, 11 errors (over the
    errors-only budget) or errors with 3 wrong flags on clean bytes."""
    bad = clean.copy()
    flags = np.zeros_like(bad)
    for seg in range(SEG):
        kind = seg % 6
        if kind == 0:
            nu, e = 0, 0
        elif kind == 1:
            nu, e = int(rng.integers(1, 11)), 0
        elif kind == 2:
            nu, e = 0, int(rng.integers(1, 21))
        elif kind == 3:
            e = int(rng.integers(0, 19))
            nu = (20 - e) // 2
        elif kind == 4:
            nu, e = 11, 0
        else:
            nu, e = int(rng.integers(1, 6)), 0
        pos = rng.choice(N, size=nu + e, replace=False)
        for p in pos[:nu]:
            bad[seg, p] ^= rng.integers(1, 256)
        for p in pos[nu:]:
            bad[seg, p] ^= rng.integers(0, 256)   # an erased byte may be fine
            flags[seg, p] = 1
        if kind == 5:
            clean_pos = np.setdiff1d(np.arange(N), pos[:nu])
            flags[seg, rng.choice(clean_pos, size=3, replace=False)] = 1
    return bad, flags


def _case_field(clean):
    """One field of the host-oracle cases of tests/test_rs_decode.py:
    segments 0-4 the errors + erasures sweep, 5 harmless erasures, 6 wrong
    hints, 7 a 15-byte erased burst, 8-47 the seeded fuzz trials; the
    rest clean. Returns (bad, flags, want_n)."""
    bad, flags = clean.copy(), np.zeros_like(clean)
    want = np.zeros(SEG, np.int32)
    for seg, (ne, nu) in enumerate(SWEEP):
        rng = np.random.default_rng(ne * 31 + nu)
        pos = rng.choice(N, size=ne + nu, replace=False)
        for p in pos:
            bad[seg, p] ^= rng.integers(1, 256)
        flags[seg, pos[:ne]] = 1
        want[seg] = ne + nu
    bad[5, 60] ^= 0x21                       # one error, 4 erasures on clean bytes
    flags[5, [5, 6, 7, 8]] = 1
    want[5] = 1
    bad[6, 120:128] ^= 0x0F                  # 8 errors the 6 hints all miss
    flags[6, 1:7] = 1
    want[6] = 8
    bad[7, 50:65] ^= 0x3C                    # 15 erased bytes > t = 10
    flags[7, 50:65] = 1
    want[7] = 15
    rng = np.random.default_rng(2024)
    for trial in range(N_FUZZ):
        seg = 8 + trial
        e = int(rng.integers(0, 21))
        nu = int(rng.integers(0, (20 - e) // 2 + 1))
        pos = rng.choice(N, size=e + nu, replace=False)
        for p in pos:
            v = bad[seg, p]
            while bad[seg, p] == v:
                bad[seg, p] = rng.integers(0, 256)
        flags[seg, pos[:e]] = 1
        want[seg] = e + nu
    return bad, flags, want


@pytest.fixture(scope="module")
def erasure_fields(golden):
    """The two case fields through JAX's erasure corrector (eager) and the
    port's: {name: (clean, bad, flags, jax (cw, n), port (cw, n))}."""
    clean = golden["rs"][0].reshape(SEG, N)
    out = {}
    mix = _oracle_mix(clean, np.random.default_rng(555))
    cases = _case_field(clean)
    for name, (bad, flags) in (("mix", mix), ("cases", cases[:2])):
        b, f = bad[None], flags[None]
        jcw, jn = jrs.rs_correct_field_erasures(
            jnp.asarray(b), jrs.syndrome_field(jnp.asarray(b)), jnp.asarray(f))
        tcw, tn = trs.rs_correct_field_erasures(
            torch.tensor(b), trs.syndrome_field(torch.tensor(b)), torch.tensor(f))
        out[name] = (clean, bad, flags, (np.asarray(jcw), np.asarray(jn)),
                     (tcw.numpy(), tn.numpy()))
    out["want_n"] = cases[2]
    return out


def test_erasure_corrector_bit_identical_to_jax(erasure_fields):
    """The 312-segment oracle mix (clean, errors only, erasures only, full
    budget, over budget, wrong flags): codewords and counts identical to
    JAX's, dtypes kept, every within-budget segment restored."""
    for name in ("mix", "cases"):
        clean, _, _, (jcw, jn), (tcw, tn) = erasure_fields[name]
        assert tcw.dtype == np.uint8 and tn.dtype == np.int32
        assert tcw.shape == (1, SEG, N) and tn.shape == (1, SEG)
        np.testing.assert_array_equal(tcw, jcw)
        np.testing.assert_array_equal(tn, jn)
    clean, _, _, _, (tcw, tn) = erasure_fields["mix"]
    ok = np.arange(SEG) % 6 != 4
    np.testing.assert_array_equal(tcw[0, ok], clean[ok])
    assert (tn[0, ~ok] == -1).any()


@pytest.mark.parametrize("seg", range(len(SWEEP)),
                         ids=[f"{e}erasures-{n}errors" for e, n in SWEEP])
def test_errors_and_erasures_sweep(erasure_fields, seg):
    """2*errors + erasures <= 20 corrects exactly, beyond the 10-error
    budget, as in JAX."""
    clean, _, _, (jcw, jn), (tcw, tn) = erasure_fields["cases"]
    want = erasure_fields["want_n"][seg]
    assert tn[0, seg] == jn[0, seg] == want
    np.testing.assert_array_equal(tcw[0, seg], clean[seg])
    np.testing.assert_array_equal(tcw[0, seg], jcw[0, seg])


@pytest.mark.parametrize("seg,what", [(5, "harmless erasures"), (6, "wrong hints"),
                                      (7, "15-byte erased burst")])
def test_erasure_hints_edge_cases(erasure_fields, seg, what):
    """Erasures on clean bytes are harmless (n counts changed bytes only);
    hints that miss every error fall back to errors-only; a 15-byte
    erased burst (over t = 10) corrects."""
    clean, _, _, (jcw, jn), (tcw, tn) = erasure_fields["cases"]
    assert tn[0, seg] == jn[0, seg] == erasure_fields["want_n"][seg], what
    np.testing.assert_array_equal(tcw[0, seg], clean[seg])


def test_errors_and_erasures_fuzz(erasure_fields):
    """40 seeded trials across the whole 2*errors + erasures <= 20 region,
    random positions and magnitudes: all corrected, as in JAX."""
    clean, _, _, (jcw, jn), (tcw, tn) = erasure_fields["cases"]
    segs = np.arange(8, 8 + N_FUZZ)
    np.testing.assert_array_equal(tn[0, segs], erasure_fields["want_n"][segs])
    np.testing.assert_array_equal(tn[0, segs], jn[0, segs])
    np.testing.assert_array_equal(tcw[0, segs], clean[segs])
    assert not tn[0, 8 + N_FUZZ:].any()


def test_erasure_corrector_leading_batch_dims(erasure_fields):
    """(2, 3, 312, 207) leading shapes: each (312, 207) row gives its own
    field's result — the case field's in row [1, 2] (JAX's codewords and
    counts), the clean field untouched elsewhere."""
    clean, bad, flags, (jcw, jn), _ = erasure_fields["cases"]
    b = np.broadcast_to(clean, (2, 3, SEG, N)).copy()
    f = np.zeros_like(b)
    b[1, 2], f[1, 2] = bad, flags
    cw, n = trs.rs_correct_field_erasures(
        torch.tensor(b), trs.syndrome_field(torch.tensor(b)), torch.tensor(f))
    cw, n = cw.numpy(), n.numpy()
    np.testing.assert_array_equal(cw[1, 2], jcw[0])
    np.testing.assert_array_equal(n[1, 2], jn[0])
    n[1, 2] = 0
    assert not n.any()
    np.testing.assert_array_equal(cw, np.broadcast_to(clean, cw.shape))


def test_ribm_mask_and_erasure_locator_equal_jax():
    """The n_active round mask (random syndromes and per-segment active
    counts) and the erasure locator (random flag rows, e up to 207) give
    JAX's locators, lengths and counts."""
    rng = np.random.default_rng(9)
    s = rng.integers(0, 256, size=(64, P.RS_BYTES), dtype=np.int32)
    act = rng.integers(0, P.RS_BYTES + 1, size=64, dtype=np.int32)
    jc, jl = jrs._ribm(jnp.asarray(s), n_active=jnp.asarray(act))
    tc, tl = trs._ribm(torch.tensor(s), n_active=torch.tensor(act))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    f = (rng.random((8, N)) < np.linspace(0.01, 1.0, 8)[:, None]).astype(np.uint8)
    jg, je = jrs._erasure_locator(jnp.asarray(f))
    tg, te = trs._erasure_locator(torch.tensor(f))
    assert tg.dtype == torch.int32 and te.dtype == torch.int32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
