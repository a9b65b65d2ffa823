"""The plain reference against the golden vectors and the program's plain
twins, at small sizes on the CPU."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from conftest import BENCH
from reference import equalizer as E
from reference import mux as M
from reference import tables as T
from reference.encoder import RefEncoder, modulate, plan, quantize_cs8

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(os.path.dirname(BENCH), "tests", "golden", "golden.npz"))


def _ts(fields: int, batch: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (fields, batch, T.FIELD_TS_BYTES), dtype=np.uint8)
    ts[:, :, ::188] = 0x47
    return ts


def test_reference_encoder_matches_golden(golden):
    """Four golden fields from a cold start: IQ within 5e-6 (the golden
    vectors' bound), symbols at the sync slots as the template has them."""
    enc = RefEncoder(1, CPU)
    for k in range(4):
        field = enc.step(torch.from_numpy(golden["input"][k][None]))
        iq = modulate(field, k)[0].numpy()
        err = np.abs(iq[0] + 1j * iq[1] - golden["iq"][k]).max()
        assert err <= 5e-6, (k, err)
        assert (field[0, 4 * 0: 4] == torch.tensor([6, 1, 1, 6], dtype=torch.int8)).all()


def test_rs_bit_matrix_is_the_lfsr():
    data = np.random.default_rng(0).integers(0, 256, (5, T.SEGMENT_BYTES), dtype=np.uint8)
    bits = np.unpackbits(data, axis=1).astype(np.float32)
    par = (bits @ T.rs_bit_matrix()).astype(np.int64) & 1
    assert (np.packbits(par.astype(np.uint8), axis=1) == T.rs_parity(data)).all()


@pytest.mark.parametrize("keys", [[2], [1, 4], [0, 3]])
def test_skipped_fields_give_the_same_symbols(keys):
    """A replay that skips fields (carries only) gives the symbols of a
    replay that computes every field."""
    ts = torch.from_numpy(_ts(5, 2))
    full, part = RefEncoder(2, CPU), RefEncoder(2, CPU)
    modes = plan(keys, 0)
    for k in range(5):
        a = full.step(ts[k])
        b = part.step(ts[k], modes.get(k, "skip"))
        if k in keys:
            assert torch.equal(a, b)


def test_reference_matches_the_program_plain_twins():
    """The program's CPU path (its plain twins) against the reference:
    cs8 wire codes within 1 LSB, the multiplex within float32 rounding, the
    equalizer within its bf16 operands."""
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.models.receiver import _osc_planar, device_eq_step, eq_window_bounds
    from atsc_tpu_torch.ops.mux import FdmMuxer

    ts = _ts(3, 2)
    ref = RefEncoder(2, CPU)
    enc = Encoder(2, out_format="cs8", wire=True, device="cpu")
    mux = FdmMuxer(2, device="cpu")
    iqs, codes = [], []
    for k in range(3):
        field = ref.step(torch.from_numpy(ts[k]))
        x = modulate(field, k)
        iqs.append(x)
        codes.append(quantize_cs8(x))
        got = enc.encode(ts[k]).numpy().view(np.int8).reshape(2, -1, 2)[:, :T.N]
        d = np.abs(got.transpose(0, 2, 1).astype(int) - codes[-1].numpy().astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-4
        band = mux.push(x.float())
        r = M.band(torch.cat(iqs, -1), 0, M.blocks_after(k * T.N), M.blocks_after((k + 1) * T.N))
        assert band.shape == tuple(r.shape)
        assert float((torch.from_numpy(band).double() - r).abs().max()) < 1e-5 * float(
            r.pow(2).mean().sqrt())
    lo, wl = eq_window_bounds("auto")
    stream = torch.cat(codes, -1)
    win = stream[..., T.N + lo:T.N + lo + wl].contiguous()
    osc = torch.from_numpy(_osc_planar(T.N + lo, T.N + lo + wl, 0))
    lev = device_eq_step(True, 1 / float(T.cs8_scale()))(win, osc)
    ref_lev = E.levels(win, T.N, -lo, 1 / float(T.cs8_scale()))
    assert float((lev.double() - ref_lev).pow(2).mean().sqrt()) < 0.01
    sym = device_eq_step(False, 1 / float(T.cs8_scale()))(win, osc)
    assert torch.equal(sym, E.slice_symbols(ref_lev))
