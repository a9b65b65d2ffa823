"""The comparison that decides `correct` has to fail: the controls (the
reference at the precision below the stated one, in the program's place)
and a run with the timed path broken underneath, at B = 2 on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

import control
import harness
import run
from conftest import CELLS, SMALL

CONTROLS = {"pool384.tx": "tf32", "band23.tx_mux": "tf32", "pool384.rx_soft": "fp8",
            "pool384.rx_hard": "fp8"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = control.control_run(harness.Cell(name), 11, None, 6, "cpu", SMALL)
    assert out["precision"] == CONTROLS[name]
    assert out["correct"] is False, out["numbers"]


@pytest.mark.parametrize("name", CELLS)
def test_float64_reference_in_the_program_place_is_correct(name):
    """The other side of the control: the reference itself, in the
    program's place, meets every limit (each number reads 0)."""
    out = control.control_run(harness.Cell(name), 11, "f64", 6, "cpu", SMALL)
    assert out["correct"] is True, out["numbers"]
    assert all(v["value"] == 0 for v in out["numbers"].values()), out["numbers"]


def _stale_encoder(monkeypatch):
    import atsc_tpu_torch.models.encoder as enc

    real = enc.encode_field
    monkeypatch.setattr(enc, "encode_field",
                        lambda state, ts, **kw: (state, real(state, ts, **kw)[1]))


def _half_encoder(monkeypatch):
    import atsc_tpu_torch.models.encoder as enc

    real = enc.encode_field

    def half(state, ts, **kw):
        new, iq = real(state, ts, **kw)
        iq = iq.clone()
        iq[iq.shape[0] // 2:] = 0
        return new, iq
    monkeypatch.setattr(enc, "encode_field", half)


def _altered_encoder(monkeypatch):
    import atsc_tpu_torch.models.encoder as enc

    real = enc.encode_field

    def altered(state, ts, **kw):
        new, iq = real(state, ts, **kw)
        iq = iq.clone()
        iq.view(-1)[12345] += 3
        return new, iq
    monkeypatch.setattr(enc, "encode_field", altered)


def _stale_decoder(monkeypatch):
    import atsc_tpu_torch.models.decoder as dec

    for name in ("decode_field", "soft_decode_field"):
        real = getattr(dec, name)
        monkeypatch.setattr(dec, name, lambda state, x, *a, _r=real, **kw:
                            (state,) + tuple(_r(state, x, *a, **kw)[1:]))


def _half_decoder(monkeypatch):
    import atsc_tpu_torch.models.decoder as dec

    real = dec.Decoder.decode

    def half(self, field, erasure_flags=None):
        ts, nerr = real(self, field, erasure_flags)
        ts = ts.copy()
        ts[ts.shape[0] // 2:] = 0
        return ts, nerr
    monkeypatch.setattr(dec.Decoder, "decode", half)


def _altered_decoder(monkeypatch):
    import atsc_tpu_torch.models.decoder as dec

    real = dec.Decoder.decode

    def altered(self, field, erasure_flags=None):
        ts, nerr = real(self, field, erasure_flags)
        ts = ts.copy()
        ts[0, 777] ^= 0x10
        return ts, nerr
    monkeypatch.setattr(dec.Decoder, "decode", altered)


FAULTS = {
    "state unchanged": {"tx": _stale_encoder, "rx": _stale_decoder},
    "half the batch left out": {"tx": _half_encoder, "rx": _half_decoder},
    "an answer altered": {"tx": _altered_encoder, "rx": _altered_decoder},
}
# the exchange between chips: no cell runs on more than one chip


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    side = "rx" if name.startswith("pool384.rx") else "tx"
    FAULTS[fault][side](monkeypatch)
    out = run.execute(harness.Cell(name), 2**31 + 5, 1.0, False, device="cpu",
                      max_fields=4, overrides=SMALL)
    assert out["correct"] is False, (fault, out["checks"])
    assert np.isfinite(out["metrics"]["setup_s"]["value"])
