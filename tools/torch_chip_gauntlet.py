#!/usr/bin/env python3
"""Impairment gauntlet of atsc_tpu_torch on the card: the PyTorch
counterpart of tools/chip_gauntlet.py, its seven probes on its capture (4
seeded fields, seed 17) through the port's IqReceiver, each asserting the
sent TS back with no uncorrectable segment:

  clean_hard            loopback, hard path (the eq_fir kernel)
  cs8_hard              int8 wire capture, dequantized in the kernel
  awgn15_viterbi        15 dB AWGN, soft Viterbi (acs_forward + traceback)
  awgn13_viterbi        13 dB AWGN
  awgn13_viterbi_i8     13 dB AWGN, the quantized soft tier (int8 level codes)
  cci_ntsc              0.5x-RMS co-channel tone at the comb null, ntsc="comb"
                        (pr_acs_forward + pr_traceback)
  multipath_adaptive_dd multipath + complex gain, the adaptive-dd equalizer

    python3 tools/torch_chip_gauntlet.py [--device cuda]

One JSON line per probe, with the launches of each kernel wrapper during
it (on the CPU every count stays 0: the plain twins run); exits 1 if a
probe fails. Needs a CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex  # noqa: E402
from atsc_tpu_torch.models.receiver import IqReceiver  # noqa: E402
from atsc_tpu_torch.ops.cuda import eq_fir as eqk  # noqa: E402
from atsc_tpu_torch.ops.cuda import viterbi_acs as vk  # noqa: E402
from atsc_tpu_torch.ops.quantize import QMAX, quantize_scale  # noqa: E402


def _capture(nfields: int = 4, seed: int = 17, *, device):
    """(ts (F, 1, 58656), iq (1, F*N) complex64, the rng the AWGN probes
    draw from next): tools/chip_gauntlet.py's capture, the port's encoder."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, size=(nfields, 1, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc = Encoder(batch=1, device=device)
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(nfields)], axis=-1)
    return ts, iq, rng


def _launches() -> dict:
    """Every receive kernel wrapper's launch count (chip_smoke's _launches)."""
    return {"eq_fir_fused": eqk.LAUNCHES, **vk.LAUNCHES}


def _run_probe(name: str, run, ts: np.ndarray) -> bool:
    """Run one probe; its fields 0..len-1 must be the sent fields, fully
    corrected. Prints the probe's line with the launches it made."""
    before = _launches()
    got = run()   # [(ts_field (B, 58656), nerr (B, 312)), ...]
    launches = {k: v - before[k] for k, v in _launches().items()}
    ok = len(got) >= ts.shape[0] - 1
    unc = 0
    for k, (tsf, nerr) in enumerate(got):
        unc += int((nerr < 0).sum())
        ok = ok and bool((tsf == ts[k]).all())
    ok = ok and unc == 0
    print(json.dumps({"probe": name, "ok": ok, "fields_decoded": len(got),
                      "segments_uncorrectable": unc, "launches": launches}), flush=True)
    return ok


def _probes(iq: np.ndarray, rng, device) -> list:
    """[(name, run)] in tools/chip_gauntlet.py's order; run() decodes the
    probe's capture to [(ts, nerr), ...]. The AWGN probes draw their noise
    from rng when they run, in this order."""
    p_sig = float(np.mean(np.abs(iq) ** 2))

    def decode(x, codes: bool = False, **kw):
        r = IqReceiver(batch=1, device=device, **kw)
        return (r.push_codes(x) if codes else r.push(x)) + r.flush()

    def awgn(snr: float):
        sigma = np.sqrt(p_sig / 10 ** (snr / 10.0) / 2.0)
        noisy = iq + (rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape)) * sigma
        return noisy.astype(np.complex64)

    def cs8():
        codes = np.stack([iq.real, iq.imag], axis=-1) * quantize_scale("cs8")
        codes = np.clip(np.round(codes), -QMAX["cs8"], QMAX["cs8"]).astype(np.int8)
        return decode(codes, codes=True, wire_format="cs8")

    def cci():
        # an analog co-channel tone at the comb's first null
        n = np.arange(iq.shape[1])
        f = P.SAMPLE_RATE / 12 + P.OSC_FREQUENCY
        tone = 0.5 * np.sqrt(p_sig) * np.exp(2j * np.pi * f * n / P.SAMPLE_RATE + 0.4j)
        return decode((iq + tone).astype(np.complex64), ntsc="comb")

    def multipath():
        y = np.convolve(iq[0], [0.9 * np.exp(0.6j), 0, 0.1 * np.exp(-1.0j)])[: iq.shape[1]]
        return decode(y[None].astype(np.complex64), backend="adaptive-dd")

    return [
        ("clean_hard", lambda: decode(iq)),
        ("cs8_hard", cs8),
        ("awgn15_viterbi", lambda: decode(awgn(15.0), trellis="soft")),
        ("awgn13_viterbi", lambda: decode(awgn(13.0), trellis="soft")),
        ("awgn13_viterbi_i8", lambda: decode(awgn(13.0), trellis="soft-i8")),
        ("cci_ntsc", cci),
        ("multipath_adaptive_dd", multipath),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without CUDA), "
                         "'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ts, iq, rng = _capture(device=dev)
    results = [_run_probe(name, run, ts) for name, run in _probes(iq, rng, dev)]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
