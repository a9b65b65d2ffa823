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
  python -m atsc_tpu_torch.cli in.ts -c 8 --mux -o band.iq    # one 48 MHz multiplex
  python -m atsc_tpu_torch.cli decode band.iq --demux 8 -o 'slot{ch}.ts'

Flags of the JAX CLI that this package does not have yet (encode: --mesh,
--checkpoint, --resume, --profile, --realtime, the soapy sink; decode:
--mesh, --checkpoint, --resume, --profile, the soapy source; the analyze
subcommand) stop with an error naming them; none is silently ignored.
The flags that act only with one of those (--fields-per-step with --mesh,
--checkpoint-every with --checkpoint, -d/-f/-g with a soapy device) are
accepted, with the JAX CLI's defaults, and change nothing without it.
Decode runs the equalizers `--equalizer zf|adaptive|adaptive-dd` (with
`--forgetting` and `--train-every` for the adaptive ones), the trellis
tiers `--trellis hard|viterbi|viterbi-i8` (chunk-parallel with
`--viterbi-chunks N`), the NTSC comb `--ntsc off|comb|auto` and the RS
erasure tier `--erasures off|burst`. A cs16/cs8 capture under an adaptive
equalizer is dequantized on the host (the codes path is the zf kernel's).

The wideband headend: `encode --mux` FDM-combines the channels into one cf32
multiplex at channels x 6 MHz (ops/mux.py, composing with --rate), and
`decode --demux B` demultiplexes such a capture on the device into one
batched adaptive receiver; `-o` with '{ch}' writes one TS file per channel.

Capture conditioning (single channel): `decode --rate SPS` resamples a
capture clocked at any rate to the symbol rate as it streams, numeric
`--sro PPM` undoes a known clock error the same way, `--sro auto` measures
it over the whole capture first; `--align auto` finds the first field
boundary, `--cfo HZ|auto|track` removes a carrier offset (`track`
re-estimates it every 8 fields), `--resync auto` re-acquires after a sample
slip. Each of them promotes the zf equalizer to the adaptive one.
`encode --rate SPS` / `--ppm PPM` resample the cf32 output to an SDR's
clock.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from fractions import Fraction

import numpy as np

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.encoder import Encoder
from atsc_tpu_torch.models.receiver import (
    CfoCorrector,
    IqReceiver,
    estimate_cfo,
    estimate_sro,
    find_field_sync_iq,
    resample_stream,
)
from atsc_tpu_torch.ops.mux import FdmDemuxer, FdmMuxer
from atsc_tpu_torch.ops.quantize import BYTES_PER_SAMPLE, dequantize_iq
from atsc_tpu_torch.ops.resample import (
    SYMBOL_RATE_FRACTION,
    StreamResampler,
    capture_rate,
)
from atsc_tpu_torch.runtime.io import IqSink, TsReader
from atsc_tpu_torch.utils.profiling import ThroughputMeter

# flags of atsc_tpu.cli's encode path that are not ported yet
_NOT_PORTED = ("mesh", "checkpoint", "resume", "profile", "realtime")


def _add_inert_flags(ap: argparse.ArgumentParser, fields_per_step: int,
                     gain: float, live: str) -> None:
    """The JAX CLI's flags that act only together with an unported flag or
    a soapy device, with its defaults: --fields-per-step (fields a --mesh
    step takes; without --mesh the output does not depend on it),
    --checkpoint-every (with --checkpoint) and the SDR's -d/-f/-g (with
    the soapy `live`). Accepted and unused; the flag they act with is
    refused as not yet ported."""
    ap.add_argument("--fields-per-step", type=int, default=fields_per_step,
                    help="(--mesh) fields a device step takes; the output "
                         "does not depend on it")
    ap.add_argument("--checkpoint-every", type=int, default=64, metavar="FIELDS",
                    help="(--checkpoint) fields between saved states")
    ap.add_argument("-d", "--driver", default="hackrf",
                    help=f"SoapySDR driver of the 'soapy' {live}")
    ap.add_argument("-f", "--frequency", type=float, default=473e6,
                    help=f"(the 'soapy' {live}) RF centre frequency in Hz")
    ap.add_argument("-g", "--gain", type=float, default=gain,
                    help=f"(the 'soapy' {live}) gain in dB")


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
    ap.add_argument("--mux", action="store_true",
                    help="FDM-combine the channels into ONE wideband "
                         "multiplex at channels*6 MHz (6-MHz slot raster "
                         "centered on DC): drive a whole band from one "
                         "wideband SDR. cf32 output only")
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
    ap.add_argument("--rate", default=None, metavar="SPS",
                    help="output sample rate in samples/s (e.g. 20e6 for a "
                         "20 MS/s SDR master clock): polyphase-resample the "
                         "baseband from the nominal 10.762238 MHz symbol "
                         "rate (or the channels*6 MHz multiplex rate with "
                         "--mux) before the sink, tracking the conversion "
                         "position as an exact rational so an unbounded "
                         "run never drifts; `decode --rate` inverts it. cf32 "
                         "output only (quantized wire formats are produced "
                         "in-kernel at the nominal rate)")
    ap.add_argument("--ppm", type=float, default=0.0,
                    help="emulate a transmit clock error of this many parts "
                         "per million: the output is resampled as if the "
                         "DAC ran at nominal*(1+ppm/1e6), the TX mirror of "
                         "`decode --sro` (controlled-SRO captures for "
                         "receiver testing; composes with --rate)")
    _add_inert_flags(ap, fields_per_step=8, gain=54.0, live="sink")
    for name in ("mesh", "checkpoint", "profile"):
        ap.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)
    for name in ("resume", "realtime"):
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


def _is_live(path: str) -> bool:
    """A SoapySDR device ('soapy' or 'soapy:<module>'), not a file."""
    return path == "soapy" or path.startswith("soapy:")


def _write_planar(sink, arr: np.ndarray) -> None:
    """Write a (B, 2, m) planar chunk whose every sample is valid (a
    resampled stream has no padded tail)."""
    if arr.shape[-1]:
        sink.write_planar(arr, arr.shape[-1])


def run(input_paths, output: str = "null", channels: int = 1,
        out_format: str = "cf32", max_fields: int = 0, stats: bool = False,
        device: str = "cuda", rate=None, ppm: float = 0.0, mux: bool = False) -> dict:
    """Encode TS input(s) to an IQ sink; returns the throughput summary.
    rate (samples/s, exact as a Fraction) and ppm resample the output
    (cf32; one channel, or the multiplex). mux: FDM-combine the channels
    into one multiplex at channels*6 MHz (ops/mux.py FdmMuxer)."""
    dev = resolve_device(device)
    if isinstance(input_paths, str):
        input_paths = [input_paths]
    if len(input_paths) not in (1, channels):
        raise ValueError(f"{len(input_paths)} inputs for {channels} channels")
    if out_format not in ("cf32", "cs16", "cs8"):
        raise ValueError(f"unknown format {out_format!r}")
    if mux and out_format != "cf32":
        raise ValueError("--mux emits cf32 only")
    resampler = None
    out_sps = None  # output sample rate per emitted stream (Hz)
    if rate is not None or ppm:
        if out_format != "cf32":
            raise ValueError("--rate/--ppm emit cf32 only (quantized wire "
                             "formats are produced in-kernel at the "
                             "nominal rate)")
        if channels > 1 and not mux:
            # per-channel resampled streams emit a variable number of
            # samples per field: a channel-interleaved output would be
            # unparseable
            raise ValueError("--rate/--ppm with --channels > 1 requires "
                             "--mux (one wideband stream); separate "
                             "resampled outputs need one encode run per "
                             "channel")
        native = Fraction(6_000_000 * channels) if mux else SYMBOL_RATE_FRACTION
        target = Fraction(rate) if rate is not None else native
        if ppm:
            # a DAC clocked ppm fast stretches the sample grid: emit
            # 1 + ppm/1e6 samples per nominal sample (decode --sro ppm is
            # the exact inverse)
            target = target * (1 + Fraction(ppm) / 1_000_000)
        band = 6_000_000 * (channels if mux else 1)
        if target < band:
            raise ValueError(
                f"--rate {float(target):.0f} cannot carry the occupied "
                f"+-{band / 2e6:g} MHz band (needs >= {band / 1e6:g} MS/s)")
        if target != native:
            resampler = StreamResampler(native / target, batch=1 if mux else channels,
                                        device=dev)
        out_sps = float(target)
    if _is_live(output):
        raise NotImplementedError(
            "the soapy sink is not yet ported to atsc_tpu_torch")
    # quantized formats leave the kernel as packed wire lanes whose bytes
    # are the interleaved stream: the sink writes them verbatim
    wire = out_format in ("cs16", "cs8")
    enc = Encoder(batch=channels, out_format=out_format, wire=wire, device=dev)
    muxer = FdmMuxer(channels, device=dev) if mux else None
    meter = ThroughputMeter(channels=channels)

    def emit_mux_chunk(chunk: np.ndarray) -> None:
        """(2, m) wideband multiplex chunk -> (resample ->) sink."""
        if resampler is not None and chunk.shape[-1]:
            chunk = resampler.push_planar(chunk[None])[0]
        _write_planar(sink, chunk[None])

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
            iq = enc.encode(ts)
            if muxer is not None:
                emit_mux_chunk(muxer.push(iq[:, :, : P.SYMBOLS_PER_FIELD]))
            elif resampler is not None:
                _write_planar(sink, resampler.push_planar(iq[:, :, : P.SYMBOLS_PER_FIELD]))
            elif wire:
                sink.write_wire(iq.cpu().numpy(), P.SYMBOLS_PER_FIELD)
            else:
                sink.write_planar(iq.cpu().numpy(), P.SYMBOLS_PER_FIELD)
            meter.add_fields(channels)
            fields_done += 1
            if max_fields and fields_done >= max_fields:
                break
        if muxer is not None:
            emit_mux_chunk(muxer.flush())
        if resampler is not None:
            _write_planar(sink, resampler.flush_planar())
    finally:
        for r in readers:
            r.close()
        sink.close()

    summary = meter.summary()
    summary["device"] = str(dev)
    if out_sps is not None:
        summary["output_rate"] = out_sps
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
# that means "not given"
_DECODE_NOT_PORTED = {"mesh": None, "checkpoint": None, "resume": False, "profile": None}

#: CLI --trellis value -> IqReceiver trellis mode
_TRELLIS_MODE = {"hard": "hard", "viterbi": "soft", "viterbi-i8": "soft-i8"}


def build_decode_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="atsc_tpu_torch decode",
        description="8VSB receiver (PyTorch + CUDA): baseband IQ -> MPEG-TS",
    )
    ap.add_argument("input", help="IQ capture ('-' = stdin) produced by the "
                                  "encoder, starting at the stream epoch "
                                  "(anywhere, with --align auto)")
    ap.add_argument("-o", "--output", default="-",
                    help="TS output path or '-' (stdout); channels are "
                         "interleaved per field, or one file per channel "
                         "when the path contains '{ch}' (e.g. 'slot{ch}.ts')")
    ap.add_argument("-c", "--channels", type=int, default=1,
                    help="channel count the capture was encoded with")
    ap.add_argument("--demux", type=int, default=0, metavar="B",
                    help="the capture is a B-slot FDM multiplex at B*6 MHz "
                         "(encode --mux layout): demultiplex on the device "
                         "and decode all B channels (adaptive equalizer; "
                         "output is channel-interleaved per field like -c B)")
    ap.add_argument("--format", dest="in_format", default="cf32",
                    choices=("cf32", "cs16", "cs8"),
                    help="IQ wire format of the capture")
    ap.add_argument("--first-field", type=int, default=0,
                    help="oscillator epoch (field index) of the stream start")
    ap.add_argument("--sro", default="0", metavar="PPM|auto",
                    help="sample-rate offset of the capture: a fixed ppm "
                         "value (streaming, composes with --rate), or "
                         "'auto' to estimate it from the sync-peak drift "
                         "across the capture (sub-ppm; reads the whole "
                         "input up front). The stream is polyphase-"
                         "resampled to the nominal symbol rate; implies "
                         "--align auto (the resampler's bulk delay shifts "
                         "the field boundaries)")
    ap.add_argument("--rate", default=None, metavar="SPS",
                    help="sample rate of the capture in samples/s (e.g. "
                         "20e6 for a 20 MS/s SDR): streaming polyphase-"
                         "resample to the nominal symbol rate, tracking "
                         "the conversion position as an exact rational so "
                         "an unbounded live run never drifts. Implies "
                         "--align auto; single-channel only, except with "
                         "--demux, where the capture is resampled to the "
                         "B*6 MHz multiplex rate and the band is aligned "
                         "via slot 0's PN511")
    ap.add_argument("--cfo", default="0", metavar="HZ|auto|track",
                    help="carrier frequency offset of the capture: a fixed "
                         "Hz value, or 'auto' to estimate it from the pilot "
                         "tone (windowed-FFT peak + quadratic interpolation, "
                         "sub-Hz from ~2 fields). 'track' re-estimates the "
                         "residual every 8 fields from the pilot in the last "
                         "two field blocks and retunes the corrector phase-"
                         "continuously, for long captures whose tuner "
                         "drifts or steps; pair with --forgetting < 1 so "
                         "the equalizer re-trains quickly after a step. "
                         "Non-zero CFO implies --equalizer adaptive")
    ap.add_argument("--align", default="none", choices=("none", "auto"),
                    help="'auto': locate the first field boundary by PN511 "
                         "correlation (phase/gain-robust) and decode from "
                         "there, for captures that do not start at a field "
                         "boundary. Single-channel only; implies "
                         "--equalizer adaptive (the epoch phase offset is "
                         "absorbed by training)")
    ap.add_argument("--resync", default="off", choices=("off", "auto"),
                    help="'auto': detect sync loss (a run of fields whose RS "
                         "segments are mostly uncorrectable, e.g. after an "
                         "SDR overflow dropped an unknown number of samples) "
                         "and re-acquire the field boundary by PN511 "
                         "correlation in the buffered stream, resetting "
                         "decoder/equalizer state there. Implies "
                         "--equalizer adaptive (the re-acquired epoch "
                         "carries an unknown phase offset)")
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

    def _chunks(value: str) -> int:
        n = int(value)
        if n < 1 or 21528 % n:
            raise argparse.ArgumentTypeError(
                f"{n} must be a divisor of 21528 (e.g. 8, 12, 24, 46, 92)"
            )
        return n

    ap.add_argument("--viterbi-chunks", type=_chunks, default=1, metavar="N",
                    help="chunk-parallel Viterbi: decode each encoder stream "
                         "as N independent chunks with 128-symbol warmup "
                         "halos (N times less sequential depth on the device; "
                         "byte-identical at operating SNRs; must divide "
                         "21528, e.g. 24). 1 = exact MLSE")
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
    _add_inert_flags(ap, fields_per_step=4, gain=30.0, live="source")
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
    if _is_live(args.input):
        given.append("the soapy source (-d/-f/-g)")
    if given:
        return f"decode {', '.join(given)}: not yet ported to atsc_tpu_torch"
    return ""


_CODE_DTYPE = {"cs16": np.int16, "cs8": np.int8}


class _TsOut:
    """Decode TS output: one interleaved stream ('-' or a path, channels
    interleaved per field; the default), or one file per channel when the
    path contains '{ch}' (e.g. `-o 'slot{ch}.ts'` with --demux 8, the
    headend form)."""

    def __init__(self, path: str, channels: int):
        self.per_channel = "{ch}" in path
        if self.per_channel:
            self._fps = [open(path.replace("{ch}", str(i)), "wb")
                         for i in range(channels)]
        else:
            self._fps = [sys.stdout.buffer if path == "-" else open(path, "wb")]

    def write_fields(self, ts: np.ndarray) -> None:
        """ts: (B, FIELD_TS_BYTES): one decoded field for B channels."""
        if self.per_channel:
            for fp, row in zip(self._fps, ts):
                fp.write(row.tobytes())
        else:
            self._fps[0].write(ts.tobytes())

    def close(self) -> None:
        for fp in self._fps:
            if fp is not sys.stdout.buffer:
                fp.close()


def _parse_sps(s: str) -> Fraction:
    """'20e6' / '16000000' / '10762237.76' -> exact Fraction samples/s."""
    try:
        return Fraction(s)
    except ValueError:
        return Fraction(float(s))


def _wire_to_complex(buf: bytes, fmt: str) -> np.ndarray:
    """Wire bytes -> flat complex64 samples (any whole-sample length),
    cs16/cs8 codes dequantized on the host."""
    buf = buf[: len(buf) - len(buf) % BYTES_PER_SAMPLE[fmt]]
    if fmt == "cf32":
        arr = np.frombuffer(buf, dtype=np.float32)
    else:
        arr = dequantize_iq(np.frombuffer(buf, dtype=_CODE_DTYPE[fmt]), fmt)
    return np.ascontiguousarray(arr.reshape(-1, 2)).view(np.complex64)[:, 0]


class _ResampledCapture:
    """Streaming rate-conversion adapter for decode input: wraps a
    capture-rate wire stream (any --format) and serves nominal-symbol-rate
    cf32 wire bytes through a StreamResampler on `device`. read(n) returns
    exactly n bytes until the source is exhausted (then the resampler
    tail, then b''), so every conditioning stage downstream
    (align/CFO/equalizer) runs unchanged at the nominal rate."""

    _CHUNK = 1 << 19  # capture samples ingested per source read

    def __init__(self, fin, fmt: str, rate, device):
        self._fin = fin
        self._fmt = fmt
        self._bps = BYTES_PER_SAMPLE[fmt]
        self._rs = StreamResampler(rate, batch=1, device=device)
        self._pend = bytearray()
        self._eof = False

    def _ingest(self) -> None:
        want = self._CHUNK * self._bps
        raw = self._fin.read(want)
        out = (self._rs.push(_wire_to_complex(raw, self._fmt)[None])
               if raw else None)
        if len(raw) < want:
            self._eof = True
            tail = self._rs.flush()
            out = (np.concatenate([out, tail], -1)
                   if out is not None else tail)
        if out.shape[-1]:
            self._pend += np.ascontiguousarray(out[0]).view(np.float32).tobytes()

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._pend) < n):
            self._ingest()
        if n < 0:
            n = len(self._pend)
        out = bytes(self._pend[:n])
        del self._pend[:n]
        return out

    def close(self) -> None:
        if self._fin is not sys.stdin.buffer:
            self._fin.close()


def run_decode(args) -> dict:
    """Decode a capture (args from build_decode_argparser) to TS; returns
    the summary (printed to stderr with --stats). The conditioning flags
    follow the JAX CLI's run_decode: validation in its order, the same
    equalizer promotions, the same summary keys."""
    if _is_live(args.input) and args.sro == "auto":
        raise ValueError("--sro auto reads the whole capture up front "
                         "and cannot run on a live stream (capture to "
                         "a file first and measure, then pass the "
                         "numeric ppm value — that path streams)")
    unported = _decode_not_ported(args)
    if unported:
        raise NotImplementedError(unported)
    if args.demux:
        return run_decode_demux(args)
    fmt, channels = args.in_format, args.channels
    dev = resolve_device(args.device)
    # streaming rate conversion (--rate capture clock, numeric --sro ppm):
    # an exact-rational capture-samples-per-output ratio applied by a
    # StreamResampler wrapped around the input
    stream_rate = None
    if args.rate is not None:
        sps = _parse_sps(args.rate)
        if sps < 6_000_000:
            raise ValueError("--rate below the 6 MHz multiplex rate "
                             "cannot carry the band")
        stream_rate = capture_rate(sps)
    if args.sro not in ("0", "auto"):
        stream_rate = ((stream_rate or Fraction(1))
                       * (1 + _parse_sps(args.sro) / 1_000_000))
    if stream_rate is not None and channels != 1:
        raise ValueError("--rate/--sro are single-channel only")
    align = args.align == "auto"
    cfo_auto = args.cfo in ("auto", "track")
    cfo_track = args.cfo == "track"
    sro_rate = None
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    fout = None
    try:
        if stream_rate is not None and stream_rate != 1:
            fin = _ResampledCapture(fin, fmt, stream_rate, dev)
            fmt, align = "cf32", True  # the resampler's bulk delay shifts
            #                            the field boundaries
        if args.sro == "auto":
            # whole-capture conditioning: estimate the rate from sync-peak
            # drift, resample to the nominal symbol rate, re-wrap as an
            # in-memory cf32 stream, and align (composes with --rate: the
            # streaming wrapper above runs first)
            if channels != 1:
                raise ValueError("--sro is single-channel only")
            raw = _wire_to_complex(fin.read(), fmt)
            if fin is not sys.stdin.buffer:
                fin.close()
            sro_rate = estimate_sro(raw)
            cond = resample_stream(raw, sro_rate)[0]
            fin = io.BytesIO(
                np.stack([cond.real, cond.imag], -1).astype(np.float32).tobytes())
            fmt, align = "cf32", True
        block = P.SYMBOLS_PER_FIELD * BYTES_PER_SAMPLE[fmt] * channels
        if (align or cfo_auto) and channels != 1:
            raise ValueError("--align/--cfo auto are single-channel only")
        _check_chunks(args)
        first_field, offset, pending = args.first_field, 0, None
        equalizer = args.equalizer
        if args.resync == "auto" and equalizer == "zf":
            equalizer = "adaptive"  # a re-acquired epoch needs training
        iq0 = None
        if align or cfo_auto:
            iq0 = _wire_to_complex(fin.read(2 * block), fmt)
        cfo_hz = estimate_cfo(iq0) if cfo_auto else float(args.cfo)
        if (cfo_hz != 0.0 or cfo_track) and equalizer == "zf":
            equalizer = "adaptive"  # residual rotation needs training
        correct = CfoCorrector(cfo_hz)
        if align:
            if equalizer == "zf":
                equalizer = "adaptive"  # the epoch phase offset needs training
            iq0c = correct(iq0)
            offset, first_field = find_field_sync_iq(iq0c)
            pending = iq0c[:, offset:]
        elif iq0 is not None:
            pending = correct(iq0)
        # with no host conditioning, cs16/cs8 codes are buffered and
        # uploaded verbatim (2-4x less H2D traffic) and dequantized inside
        # the zf equalizer kernel; the adaptive equalizers take float
        # samples, dequantized on the host
        codes_path = (fmt in ("cs16", "cs8") and equalizer == "zf"
                      and not align and cfo_hz == 0.0 and pending is None)
        trellis = _TRELLIS_MODE[args.trellis]
        rx = IqReceiver(batch=channels, first_field=first_field,
                        backend="device" if equalizer == "zf" else equalizer,
                        forgetting=args.forgetting, trellis=trellis,
                        erasures=None if args.erasures == "off" else args.erasures,
                        wire_format=fmt if codes_path else "cf32",
                        eq_profile=args.eq_profile,
                        ntsc=None if args.ntsc == "off" else args.ntsc,
                        # the i8 tier's int8 level codes cannot feed the MER
                        # accumulator; --stats still reports everything else
                        measure_mer=args.stats and trellis != "soft-i8",
                        resync=None if args.resync == "off" else args.resync,
                        viterbi_chunks=args.viterbi_chunks,
                        train_every=args.train_every, device=dev)
        fields = 0
        track_tail: list[np.ndarray] = []  # last 2 corrected field blocks
        cfo_retunes = 0
        last_track = 0
        fout = _TsOut(args.output, channels)

        def emit(decoded) -> None:
            nonlocal fields
            for ts, _ in decoded:   # (B, 58656): one field, every channel
                fout.write_fields(ts)
                fields += 1

        if pending is not None:
            emit(rx.push(pending))
        while True:
            buf = fin.read(block)
            if len(buf) < block:
                if buf and align:
                    emit(rx.push(correct(_wire_to_complex(buf, fmt))))
                elif buf:
                    print(f"warning: dropping {len(buf)}-byte partial field "
                          "block at EOF", file=sys.stderr)
                break
            if codes_path:
                codes = np.frombuffer(buf, dtype=_CODE_DTYPE[fmt])
                decoded = rx.push_codes(codes.reshape(channels, P.SYMBOLS_PER_FIELD, 2))
            else:
                blk = correct(_wire_to_complex(buf, fmt).reshape(
                    channels, P.SYMBOLS_PER_FIELD))
                decoded = rx.push(blk)
                if cfo_track:
                    track_tail.append(blk)
                    del track_tail[:-2]
            emit(decoded)
            if cfo_track and len(track_tail) == 2 and fields - last_track >= 8:
                # tracking update: the pilot's offset in the *corrected*
                # stream is the residual CFO; fold it in phase-continuously
                last_track = fields
                resid = estimate_cfo(np.concatenate(track_tail, axis=-1))
                if 0.05 <= abs(resid) <= 1500.0:
                    cfo_hz = correct.cfo_hz + resid
                    correct.retune(cfo_hz)
                    cfo_retunes += 1
            if args.max_fields and fields >= args.max_fields:
                break
        if not args.max_fields or fields < args.max_fields:
            emit(rx.flush())
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
        if fout is not None:
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
    if args.resync != "off":
        summary["resyncs"] = rx.resyncs
    if rx.mer is not None:
        summary["mer_db"] = [round(float(v), 2) for v in rx.mer]
    if align:
        summary |= {"align_offset": offset, "align_parity": first_field}
    if cfo_hz != 0.0:
        summary["cfo_hz"] = round(cfo_hz, 3)
    if cfo_track:
        summary["cfo_retunes"] = cfo_retunes
    if sro_rate is not None:
        summary["sro_ppm"] = round((sro_rate - 1.0) * 1e6, 3)
    elif args.sro != "0":
        summary["sro_ppm"] = float(_parse_sps(args.sro))
    if args.rate is not None:
        summary["resample_rate"] = float(stream_rate)
    if args.stats:
        print(json.dumps(summary), file=sys.stderr)
    return summary


def _check_chunks(args) -> None:
    if (args.viterbi_chunks > 1
            and not args.trellis.startswith("viterbi")
            and args.ntsc == "off"):
        raise ValueError("--viterbi-chunks needs a soft trellis path: "
                         "add --trellis viterbi or --ntsc comb/auto")


def run_decode_demux(args) -> dict:
    """Wideband headend receive (the JAX CLI's run_decode_demux, without its
    checkpoint and resume branches): the device FDM demultiplexer
    (ops/mux.py) feeding one batched adaptive receiver, B transport
    streams out of one B*6 MHz capture. `--rate` takes a capture clocked
    at any SDR rate (streaming-resampled to the multiplex rate; implies
    `--align auto`, since the conversion shifts the epoch); `--align auto`
    locates the field boundary in slot 0's demuxed baseband (every slot is
    sample-synchronous)."""
    for flag, default in (("cfo", "0"), ("sro", "0"), ("mesh", None)):
        if getattr(args, flag) != default:
            raise ValueError(f"--demux does not support --{flag}")
    rate_frac = None
    if args.rate is not None:
        rate_frac = _parse_sps(args.rate) / Fraction(6_000_000 * args.demux)
        if rate_frac < 1:
            raise ValueError(
                f"--rate below the {args.demux * 6} MHz multiplex rate "
                "cannot carry the band")
    align = args.align == "auto" or (rate_frac is not None and rate_frac != 1)
    if args.channels != 1:
        raise ValueError("--demux sets the channel count itself")
    _check_chunks(args)
    if args.trellis == "viterbi-i8":
        raise ValueError("--demux decodes with the adaptive equalizer; "
                         "the quantized tier needs the device equalizer "
                         "— use --trellis viterbi")
    b = args.demux
    if b < 1:
        raise ValueError(f"--demux wants a slot count >= 1, got {b}")
    dev = resolve_device(args.device)
    dmx = FdmDemuxer(b, device=dev)

    def make_rx(first_field: int) -> IqReceiver:
        return IqReceiver(
            batch=b,
            backend="adaptive-dd" if args.equalizer == "adaptive-dd" else "adaptive",
            forgetting=args.forgetting,
            first_field=first_field,
            trellis=_TRELLIS_MODE[args.trellis],
            erasures=None if args.erasures == "off" else args.erasures,
            ntsc=None if args.ntsc == "off" else args.ntsc,
            viterbi_chunks=args.viterbi_chunks, eq_profile=args.eq_profile,
            measure_mer=args.stats and args.trellis != "viterbi-i8",
            resync=None if args.resync == "off" else args.resync,
            train_every=args.train_every, device=dev,
        )

    # construct (and so flag-validate) the receiver before opening the
    # output: a usage error must not truncate a file. An --align run
    # rebuilds it with the detected parity later.
    rx = make_rx(args.first_field)
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    in_fmt = args.in_format
    if rate_frac is not None and rate_frac != 1:
        fin = _ResampledCapture(fin, in_fmt, rate_frac, dev)
        in_fmt = "cf32"
    fout = None
    fields = 0

    def emit(decoded) -> None:
        nonlocal fields
        for ts, _ in decoded:
            fout.write_fields(ts)
            fields += 1

    # --align/--rate: hold the demuxed baseband until slot 0's PN511
    # locates the field boundary (all slots are sample-synchronous, so one
    # search aligns the whole band); the residual fractional delay of the
    # rate conversion is a linear channel the adaptive training absorbs
    pend_bb: list[np.ndarray] = []
    aligned = not align
    align_info: dict = {}

    def start_aligned() -> None:
        nonlocal aligned, rx
        buf = np.concatenate(pend_bb, axis=-1)
        off, parity = find_field_sync_iq(buf[0])
        align_info.update(align_offset=int(off), align_parity=int(parity))
        rx = make_rx(parity)
        aligned = True
        pend_bb.clear()
        emit(rx.push(buf[:, off:]))

    def feed(bb: np.ndarray) -> None:
        if aligned:
            if bb.shape[-1]:
                emit(rx.push(bb))
            return
        if bb.shape[-1]:
            pend_bb.append(bb)
        if sum(x.shape[-1] for x in pend_bb) >= 2 * P.SYMBOLS_PER_FIELD:
            start_aligned()

    try:
        fout = _TsOut(args.output, b)
        while True:
            buf = fin.read(1 << 22)
            if not buf:
                break
            feed(dmx.push(_wire_to_complex(buf, in_fmt)))
            if args.max_fields and fields >= args.max_fields:
                break
        if not args.max_fields or fields < args.max_fields:
            feed(dmx.flush())
            if not aligned:
                # short capture: align with whatever is buffered, if a
                # whole field (+ the sync probe span) made it through
                if sum(x.shape[-1] for x in pend_bb) >= P.SYMBOLS_PER_FIELD + 707:
                    start_aligned()
                else:
                    print("warning: capture too short to locate a field "
                          "boundary; nothing decoded", file=sys.stderr)
            if aligned:
                emit(rx.flush())
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
        if fout is not None:
            fout.close()
    summary = {
        "fields_decoded": fields,
        "segments_corrected": rx.decoder.segments_corrected,
        "segments_uncorrectable": rx.decoder.segments_uncorrectable,
        "demux_slots": b,
        "device": str(dev),
    }
    summary.update(align_info)
    if rate_frac is not None:
        summary["resample_rate"] = float(rate_frac)
    if args.resync != "off":
        summary["resyncs"] = rx.resyncs
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
    if _is_live(args.output):
        given.append("the soapy sink (-d/-f/-g)")
    if given:
        ap.error(f"{', '.join(given)}: not yet ported to atsc_tpu_torch")
    channels = args.channels
    if len(args.input) > 1:
        if channels not in (1, len(args.input)):
            ap.error(f"{len(args.input)} inputs but --channels {channels}")
        channels = len(args.input)
    run(args.input, output=args.output, channels=channels,
        out_format=args.out_format, max_fields=args.max_fields,
        stats=args.stats, device=args.device,
        rate=None if args.rate is None else _parse_sps(args.rate), ppm=args.ppm,
        mux=args.mux)
    return 0


if __name__ == "__main__":
    sys.exit(main())
