#!/usr/bin/env python3
"""Receiver noise threshold of atsc_tpu_torch: hard slicing against the
Viterbi tiers, swept over AWGN SNR at the receiver input (the port's own
encoded baseband as the signal). For each trellis mode and SNR, the
post-RS outcome of a fresh IqReceiver: the 8VSB analog of a TOV
(threshold-of-visibility) measurement. Commercial 8VSB receivers quote
~15.2 dB in white noise. The PyTorch counterpart of tools/rx_threshold.py:
the same flags, the same random draws in the same order, the same JSON
lines; --device picks the card (the default; it fails without one) or the
CPU, and --viterbi-chunks sweeps the chunk-parallel soft tiers.

    python3 tools/torch_rx_threshold.py [--fields 4] [--snrs 22,20,18,17,16,15,14]
        [--modes hard,soft,soft-i8] [--backend device] [--viterbi-chunks 24]
        [--device cuda]

One JSON line per (mode, SNR), then {"threshold_db": {mode: the lowest
swept SNR with exact TS, or null}, ...}. The port's measured thresholds
are in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex  # noqa: E402
from atsc_tpu_torch.models.receiver import IqReceiver  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fields", type=int, default=4)
    ap.add_argument("--snrs", default="22,20,18,17,16,15,14")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--modes", default="hard,soft",
                    help="comma list of trellis modes to sweep (hard, soft, soft-i8)")
    ap.add_argument("--backend", default="device",
                    choices=("device", "adaptive", "adaptive-dd"),
                    help="equalizer under test: the known-chain zf path (default), "
                         "sync-trained RLS, or RLS + decision-directed refinement")
    ap.add_argument("--viterbi-chunks", type=int, default=1, metavar="N",
                    help="the soft tiers' chunk count (1 = exact MLSE; a divisor of "
                         "21528, e.g. 24); hard slicing has no trellis search")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without CUDA), "
                         "'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    snrs = [float(s) for s in args.snrs.split(",")]
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    ts = rng.integers(0, 256, size=(args.fields, 1, P.FIELD_TS_BYTES), dtype=np.uint8)
    for k in range(args.fields):
        ts[k, :, ::188] = 0x47
    enc = Encoder(batch=1, device=dev)
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(args.fields)],
                        axis=-1)
    p_sig = float(np.mean(np.abs(iq) ** 2))

    thresholds = {}
    for mode in args.modes.split(","):
        thresholds[mode] = None
        chunks = 1 if mode == "hard" else args.viterbi_chunks
        for snr in snrs:
            sigma = np.sqrt(p_sig / 10 ** (snr / 10) / 2)
            noise = (rng.normal(size=iq.shape) + 1j * rng.normal(size=iq.shape)) * sigma
            rx = IqReceiver(batch=1, trellis=mode, backend=args.backend,
                            viterbi_chunks=chunks, device=dev)
            got = rx.push(iq + noise) + rx.flush()
            byte_errs = sum(int(np.sum(out != ts[k])) for k, (out, _) in enumerate(got))
            ok = byte_errs == 0 and all((nerr >= 0).all() for _, nerr in got)
            line = {"mode": mode, "snr_db": snr, "post_rs_byte_errors": byte_errs,
                    "uncorrectable_segments": rx.decoder.segments_uncorrectable,
                    "rs_corrected_segments": rx.decoder.segments_corrected,
                    "exact": ok}
            if chunks > 1:
                line["viterbi_chunks"] = chunks
            print(json.dumps(line), flush=True)
            if ok:
                thresholds[mode] = snr
    print(json.dumps({"threshold_db": thresholds,
                      "note": "lowest swept SNR with exact TS recovery",
                      "device": str(dev),
                      "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
