"""CLI frontend: MPEG-TS in -> baseband IQ out (encode), and baseband IQ
in -> MPEG-TS out (decode), on a CUDA device (or the CPU with --device
cpu).

Counterpart of the single-device encode loop and the zf decode path of
atsc_tpu/cli.py. Encode sinks: a file path, 'null' (discard; a throughput
run) or '-' (stdout). cf32 goes out as the reference's interleaved
complex<float>; cs16/cs8 leave the kernel as packed wire lanes and are
written verbatim. Decode reads a capture in any of those formats that
starts at the stream epoch; cs16/cs8 codes are uploaded as they are and
dequantized inside the equalizer kernel.

Usage:
  python -m atsc_tpu_torch.cli input.ts -o out.iq
  python -m atsc_tpu_torch.cli input.ts --channels 8 --format cs8 --stats
  python -m atsc_tpu_torch.cli a.ts b.ts -o out.iq        # one stream per channel
  python -m atsc_tpu_torch.cli decode out.iq -o back.ts --stats
  python -m atsc_tpu_torch.cli decode out.cs8 -c 8 --format cs8 -o back.ts

Flags of the JAX CLI that this package does not have yet (encode: --mesh,
--mux, --rate, --ppm, --checkpoint, --resume, --profile, --realtime, the
soapy sink; decode: --mesh, --demux, --sro, --rate, --cfo, --align,
--resync, --viterbi-chunks other than 1, --checkpoint, --resume,
--profile, the soapy source; the analyze subcommand) stop with an error
naming them; none is silently ignored. Decode runs the equalizers
`--equalizer zf|adaptive|adaptive-dd` (with `--forgetting` and
`--train-every` for the adaptive ones), the trellis tiers `--trellis
hard|viterbi|viterbi-i8`, the NTSC comb `--ntsc off|comb|auto` and the RS
erasure tier `--erasures off|burst`. A cs16/cs8 capture under an adaptive
equalizer is dequantized on the host (the codes path is the zf kernel's).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.encoder import Encoder
from atsc_tpu_torch.models.receiver import IqReceiver
from atsc_tpu_torch.ops.quantize import BYTES_PER_SAMPLE, dequantize_iq
from atsc_tpu_torch.runtime.io import IqSink, TsReader
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


# decode flags of atsc_tpu.cli that are not ported yet, with the default
# that means "not given" (--viterbi-chunks 1 is the exact Viterbi this
# package runs; --sro 0, --cfo 0, --align none and --resync off condition
# nothing)
_DECODE_NOT_PORTED = {
    "mesh": None, "demux": 0, "sro": "0", "rate": None, "cfo": "0",
    "align": "none", "resync": "off", "viterbi_chunks": 1,
    "checkpoint": None, "resume": False, "profile": None,
}

#: CLI --trellis value -> IqReceiver trellis mode
_TRELLIS_MODE = {"hard": "hard", "viterbi": "soft", "viterbi-i8": "soft-i8"}


def build_decode_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="atsc_tpu_torch decode",
        description="8VSB receiver (PyTorch + CUDA): baseband IQ -> MPEG-TS",
    )
    ap.add_argument("input", help="IQ capture ('-' = stdin) produced by the "
                                  "encoder, starting at the stream epoch")
    ap.add_argument("-o", "--output", default="-",
                    help="TS output path or '-' (stdout); channels are "
                         "interleaved per field (a '{ch}' template is not "
                         "yet ported)")
    ap.add_argument("-c", "--channels", type=int, default=1,
                    help="channel count the capture was encoded with")
    ap.add_argument("--format", dest="in_format", default="cf32",
                    choices=("cf32", "cs16", "cs8"),
                    help="IQ wire format of the capture")
    ap.add_argument("--first-field", type=int, default=0,
                    help="oscillator epoch (field index) of the stream start")
    ap.add_argument("--eq-profile", default="auto",
                    choices=("auto", "exact", "fast"),
                    help="zf equalizer tier: 'exact' = +-256 taps in fp32 "
                         "(golden regression), 'fast' = +-128 taps with bf16 "
                         "operands (the default)")
    ap.add_argument("--trellis", default="hard", choices=tuple(_TRELLIS_MODE),
                    help="'hard': slice symbols then invert the trellis "
                         "algebraically; 'viterbi': soft-decision maximum-"
                         "likelihood trellis decoding (~3.5 dB coding gain on "
                         "noisy captures); 'viterbi-i8': the same on int8 "
                         "soft-level codes from the equalizer kernel (no MER "
                         "in --stats)")
    ap.add_argument("--ntsc", default="off", choices=("off", "comb", "auto"),
                    help="analog NTSC co-channel rejection: 12-symbol comb + "
                         "16-state partial-response ML trellis decoding; "
                         "'auto' lets the first field's slicer residuals "
                         "decide (the comb costs ~3 dB against white noise)")
    ap.add_argument("--equalizer", default="zf",
                    choices=("zf", "adaptive", "adaptive-dd"),
                    help="'zf': fixed zero-forcing inverse of the known TX "
                         "chain (ideal channel); 'adaptive': widely-linear "
                         "RLS trained on each field's sync symbols, for "
                         "captures through an unknown linear channel "
                         "(multipath, gain/phase, ripple); 'adaptive-dd': + a "
                         "decision-directed second pass per field (~1 dB "
                         "more sensitivity near threshold)")
    ap.add_argument("--forgetting", type=float, default=1.0,
                    help="adaptive equalizer memory: 1.0 = average all "
                         "fields (static channel), 0.0 = retrain per field")
    ap.add_argument("--train-every", type=int, default=1, metavar="K",
                    help="adaptive equalizer retrain cadence: train + solve "
                         "on every K-th field, apply the cached taps between")
    ap.add_argument("--erasures", default="off", choices=("off", "burst"),
                    help="'burst': detect impulse-noise bursts from slicer "
                         "residuals and pass the affected bytes to RS as "
                         "erasures (2*errors + erasures <= 20 per segment "
                         "instead of errors <= 10)")
    ap.add_argument("--max-fields", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print a JSON decode summary to stderr")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without "
                         "CUDA), 'cuda:N' or 'cpu'")
    for name, default in _DECODE_NOT_PORTED.items():
        flag = f"--{name.replace('_', '-')}"
        if isinstance(default, bool):
            ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            ap.add_argument(flag, type=type(default) if default is not None else str,
                            default=default, help=argparse.SUPPRESS)
    return ap


def _decode_not_ported(args) -> str:
    """'' when args ask only for what this package runs, else the error."""
    given = [f"--{n.replace('_', '-')}" for n, d in _DECODE_NOT_PORTED.items()
             if getattr(args, n) != d]
    if args.input == "soapy" or args.input.startswith("soapy:"):
        given.append("the soapy source")
    if "{ch}" in args.output:
        given.append("-o with '{ch}' (one TS file per channel)")
    if given:
        return f"decode {', '.join(given)}: not yet ported to atsc_tpu_torch"
    return ""


_CODE_DTYPE = {"cs16": np.int16, "cs8": np.int8}


def _block_to_complex(buf: bytes, fmt: str, channels: int) -> np.ndarray:
    """One field block of wire bytes -> (channels, 260416) complex64,
    cs16/cs8 codes dequantized on the host."""
    if fmt == "cf32":
        iq = np.frombuffer(buf, dtype=np.float32)
    else:
        iq = dequantize_iq(np.frombuffer(buf, dtype=_CODE_DTYPE[fmt]), fmt)
    iq = np.ascontiguousarray(iq.reshape(-1, 2)).view(np.complex64)[:, 0]
    return iq.reshape(channels, P.SYMBOLS_PER_FIELD)


def run_decode(args) -> dict:
    """Decode a capture (args from build_decode_argparser) to TS; returns
    the summary (printed to stderr with --stats)."""
    unported = _decode_not_ported(args)
    if unported:
        raise NotImplementedError(unported)
    fmt, channels = args.in_format, args.channels
    dev = resolve_device(args.device)
    # cs16/cs8 codes are buffered and uploaded verbatim (2-4x less H2D
    # traffic) and dequantized inside the zf equalizer kernel; the adaptive
    # equalizers take float samples, dequantized on the host
    codes_path = fmt in ("cs16", "cs8") and args.equalizer == "zf"
    trellis = _TRELLIS_MODE[args.trellis]
    rx = IqReceiver(batch=channels, first_field=args.first_field,
                    backend="device" if args.equalizer == "zf" else args.equalizer,
                    forgetting=args.forgetting, trellis=trellis,
                    erasures=None if args.erasures == "off" else args.erasures,
                    wire_format=fmt if codes_path else "cf32",
                    eq_profile=args.eq_profile,
                    ntsc=None if args.ntsc == "off" else args.ntsc,
                    # the i8 tier's int8 level codes cannot feed the MER
                    # accumulator; --stats still reports everything else
                    measure_mer=args.stats and trellis != "soft-i8",
                    train_every=args.train_every, device=dev)
    block = P.SYMBOLS_PER_FIELD * BYTES_PER_SAMPLE[fmt] * channels
    fields = 0
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    fout = None
    try:
        fout = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")

        def emit(decoded) -> None:
            nonlocal fields
            for ts, _ in decoded:   # (B, 58656): one field, every channel
                fout.write(ts.tobytes())
                fields += 1

        while True:
            buf = fin.read(block)
            if len(buf) < block:
                if buf:
                    print(f"warning: dropping {len(buf)}-byte partial field "
                          "block at EOF", file=sys.stderr)
                break
            if codes_path:
                codes = np.frombuffer(buf, dtype=_CODE_DTYPE[fmt])
                emit(rx.push_codes(codes.reshape(channels, P.SYMBOLS_PER_FIELD, 2)))
            else:
                emit(rx.push(_block_to_complex(buf, fmt, channels)))
            if args.max_fields and fields >= args.max_fields:
                break
        if not args.max_fields or fields < args.max_fields:
            emit(rx.flush())
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
        if fout is not None and fout is not sys.stdout.buffer:
            fout.close()

    summary = {
        "fields_decoded": fields,
        "segments_corrected": rx.decoder.segments_corrected,
        "segments_uncorrectable": rx.decoder.segments_uncorrectable,
        "device": str(dev),
    }
    if args.erasures != "off":
        summary["segments_erasure_assisted"] = rx.decoder.segments_erasure_assisted
    if args.ntsc != "off":
        summary["ntsc_comb"] = rx.ntsc_active
    if rx.mer is not None:
        summary["mer_db"] = [round(float(v), 2) for v in rx.mer]
    if args.stats:
        print(json.dumps(summary), file=sys.stderr)
    return summary


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["analyze"]:
        print("error: the analyze subcommand is not yet ported to "
              "atsc_tpu_torch", file=sys.stderr)
        return 2
    if argv[:1] == ["decode"]:
        ap = build_decode_argparser()
        args = ap.parse_args(argv[1:])
        unported = _decode_not_ported(args)
        if unported:
            ap.error(unported)
        run_decode(args)
        return 0
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
