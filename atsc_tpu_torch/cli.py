"""CLI frontend, encode path: MPEG-TS in -> baseband IQ out, on a CUDA
device (or the CPU with --device cpu).

Counterpart of the single-device encode loop of atsc_tpu/cli.py. Sinks:
a file path, 'null' (discard; a throughput run) or '-' (stdout). cf32
goes out as the reference's interleaved complex<float>; cs16/cs8 leave
the kernel as packed wire lanes and are written verbatim.

Usage:
  python -m atsc_tpu_torch.cli input.ts -o out.iq
  python -m atsc_tpu_torch.cli input.ts --channels 8 --format cs8 --stats
  python -m atsc_tpu_torch.cli a.ts b.ts -o out.iq        # one stream per channel

Flags of the JAX CLI that this package does not have yet (--mesh, --mux,
--rate, --ppm, --checkpoint, --resume, --profile, --realtime, the soapy
sink, the decode and analyze subcommands) stop with an error naming them;
none is silently ignored.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from atsc_tpu import params as P
from atsc_tpu.runtime.io import IqSink, TsReader
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.encoder import Encoder
from atsc_tpu_torch.utils.profiling import ThroughputMeter

# flags of atsc_tpu.cli's encode path that are not ported yet
_NOT_PORTED = ("mesh", "mux", "rate", "ppm", "checkpoint", "resume",
               "profile", "realtime")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="atsc_tpu_torch", description="ATSC 8VSB encoder (PyTorch + CUDA)"
    )
    ap.add_argument("input", nargs="+",
                    help="MPEG-TS source(s): file, '-' (stdin) or "
                         "'udp://[group]:port'. One source: broadcast to all "
                         "--channels. Several: one stream per channel "
                         "(shorter streams are zero-padded until the longest "
                         "ends)")
    ap.add_argument("-o", "--output", default="null",
                    help="IQ sink: 'null', '-' (stdout) or a file path")
    ap.add_argument("-c", "--channels", type=int, default=1,
                    help="encode the stream as N parallel channels")
    ap.add_argument("--format", dest="out_format", default="cf32",
                    choices=("cf32", "cs16", "cs8"),
                    help="IQ wire format: complex float32, or int16/int8 "
                         "codes quantized on the device")
    ap.add_argument("--max-fields", type=int, default=0,
                    help="stop after N fields per channel (0 = until EOF)")
    ap.add_argument("--stats", action="store_true",
                    help="print a JSON throughput summary to stderr")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without "
                         "CUDA), 'cuda:N' or 'cpu'")
    for name in ("mesh", "rate", "checkpoint", "profile"):
        ap.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ppm", type=float, default=None, help=argparse.SUPPRESS)
    for name in ("mux", "resume", "realtime"):
        ap.add_argument(f"--{name}", action="store_true", help=argparse.SUPPRESS)
    return ap


def _read_field(readers, field_bytes: int):
    """Read up to one field from every reader; returns (ts (len(readers),
    field_bytes) uint8, packets_read, sync_bad), or None once every stream
    is exhausted. A short stream is zero-padded; the sync-byte counts
    cover the whole packets read."""
    datas = [r.read(field_bytes) for r in readers]
    if all(len(d) == 0 for d in datas):
        return None
    checked = bad = 0
    for d in datas:
        firsts = np.frombuffer(d, np.uint8)[
            : len(d) - len(d) % P.MPEG2_BYTES : P.MPEG2_BYTES
        ]
        checked += firsts.size
        bad += int(np.count_nonzero(firsts != 0x47))
    ts = np.stack([np.frombuffer(d + bytes(field_bytes - len(d)), np.uint8)
                   for d in datas])
    return ts, checked, bad


def run(input_paths, output: str = "null", channels: int = 1,
        out_format: str = "cf32", max_fields: int = 0, stats: bool = False,
        device: str = "cuda") -> dict:
    """Encode TS input(s) to an IQ sink; returns the throughput summary."""
    dev = resolve_device(device)
    if isinstance(input_paths, str):
        input_paths = [input_paths]
    if len(input_paths) not in (1, channels):
        raise ValueError(f"{len(input_paths)} inputs for {channels} channels")
    if out_format not in ("cf32", "cs16", "cs8"):
        raise ValueError(f"unknown format {out_format!r}")
    if output == "soapy" or output.startswith("soapy:"):
        raise NotImplementedError(
            "the soapy sink is not yet ported to atsc_tpu_torch")
    # quantized formats leave the kernel as packed wire lanes whose bytes
    # are the interleaved stream: the sink writes them verbatim
    wire = out_format in ("cs16", "cs8")
    enc = Encoder(batch=channels, out_format=out_format, wire=wire, device=dev)
    meter = ThroughputMeter(channels=channels)
    field_bytes = P.FIELD_TS_BYTES
    fields_done = sync_checked = sync_bad = 0
    readers = [TsReader(p) for p in input_paths]
    sink = IqSink(output)
    try:
        while True:
            got = _read_field(readers, field_bytes)
            if got is None:
                break
            ts, checked, bad = got
            sync_checked += checked
            sync_bad += bad
            if ts.shape[0] == 1 and channels > 1:
                ts = np.broadcast_to(ts, (channels, field_bytes))
            iq = enc.encode(ts).cpu().numpy()
            if wire:
                sink.write_wire(iq, P.SYMBOLS_PER_FIELD)
            else:
                sink.write_planar(iq, P.SYMBOLS_PER_FIELD)
            meter.add_fields(channels)
            fields_done += 1
            if max_fields and fields_done >= max_fields:
                break
    finally:
        for r in readers:
            r.close()
        sink.close()

    summary = meter.summary()
    summary["device"] = str(dev)
    summary["ts_sync_errors"] = sync_bad
    summary["ts_packets"] = sync_checked
    if stats:
        if sync_checked and sync_bad / sync_checked > 0.5:
            print(f"warning: {sync_bad}/{sync_checked} TS packets lack the "
                  "0x47 sync byte: input is misaligned or not a transport "
                  "stream", file=sys.stderr)
        print(json.dumps(summary), file=sys.stderr)
    return summary


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] in (["decode"], ["analyze"]):
        print(f"error: the {argv[0]} subcommand is not yet ported to "
              "atsc_tpu_torch", file=sys.stderr)
        return 2
    if argv[:1] == ["encode"]:
        argv = argv[1:]
    ap = build_argparser()
    args = ap.parse_args(argv)
    given = [f"--{n}" for n in _NOT_PORTED if getattr(args, n) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: not yet ported to atsc_tpu_torch")
    channels = args.channels
    if len(args.input) > 1:
        if channels not in (1, len(args.input)):
            ap.error(f"{len(args.input)} inputs but --channels {channels}")
        channels = len(args.input)
    run(args.input, output=args.output, channels=channels,
        out_format=args.out_format, max_fields=args.max_fields,
        stats=args.stats, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
