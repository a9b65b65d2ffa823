"""CLI frontend: MPEG-TS in -> baseband IQ out (encode), baseband IQ in ->
MPEG-TS out (decode), and signal-quality triage of a capture (analyze), on
a CUDA device (or the CPU with --device cpu).

Counterpart of the single-device paths of atsc_tpu/cli.py. Encode sinks:
a file path, 'null' (discard; a throughput run), '-' (stdout) or
'soapy[:driver]', a SoapySDR transmitter (-d/-f/-g: driver, RF frequency,
gain). cf32 goes out as the reference's interleaved complex<float>;
cs16/cs8 leave the kernel as packed wire lanes and are written verbatim.
Decode reads a capture in any of those formats that starts at the stream
epoch, or receives live from 'soapy[:driver]'; cs16/cs8 codes are uploaded
as they are and dequantized inside the equalizer kernel. The SoapySDR
paths need the `SoapySDR` python bindings and stop with an error naming
them where they are absent.

Usage:
  python -m atsc_tpu_torch.cli input.ts -o out.iq
  python -m atsc_tpu_torch.cli input.ts --channels 8 --format cs8 --stats
  python -m atsc_tpu_torch.cli a.ts b.ts -o out.iq        # one stream per channel
  python -m atsc_tpu_torch.cli decode out.iq -o back.ts --stats
  python -m atsc_tpu_torch.cli decode out.cs8 -c 8 --format cs8 -o back.ts
  python -m atsc_tpu_torch.cli in.ts -c 8 --mux -o band.iq    # one 48 MHz multiplex
  python -m atsc_tpu_torch.cli decode band.iq --demux 8 -o 'slot{ch}.ts'
  python -m atsc_tpu_torch.cli analyze cap.iq               # MER, offsets, flags
  python -m atsc_tpu_torch.cli in.ts -o a.iq --max-fields 100 --checkpoint s.npz
  python -m atsc_tpu_torch.cli in.ts -o b.iq --checkpoint s.npz --resume
  python -m atsc_tpu_torch.cli in.ts -o soapy -d hackrf -f 473e6 -g 54
  python -m atsc_tpu_torch.cli decode soapy:hackrf -o live.ts --stats
  python -m atsc_tpu_torch.cli analyze soapy -f 473e6 -g 30
  python -m atsc_tpu_torch.cli in.ts -c 8 --mesh 2x2 -o out.iq   # 4 shards
  python -m atsc_tpu_torch.cli decode out.iq -c 8 --mesh 2x2 -o back.ts

Multi-device: `--mesh TIMExCH` encodes or decodes over a mesh of
TIME x CH shards (parallel/), --fields-per-step fields a step; the shards
are laid round-robin over the visible devices of --device's kind (so one
card runs several shards in turn; the placement goes to stderr and into
--stats). Every flag of the JAX CLI runs; -d/-f/-g act only with a soapy
device.
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

Operations: `--checkpoint PATH` saves the stream's whole state every
`--checkpoint-every` fields and at the end (utils/checkpoint.py, the JAX
package's file format), `--resume` continues from it byte-identically
(encode: the resumed run writes the rest of the stream to -o; decode: -o
must hold what was decoded before the checkpoint, and is cut back to that
position). `--profile DIR` writes a torch.profiler trace of the run;
`encode --realtime` paces the sink to the output sample clock.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
from fractions import Fraction

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.models.encoder import Encoder
from atsc_tpu_torch.models.receiver import (
    CfoCorrector,
    IqReceiver,
    equalize_field_device,
    estimate_cfo,
    estimate_sro,
    field_window,
    find_field_sync_iq,
    mer_db,
    resample_stream,
)
from atsc_tpu_torch.ops.adaptive_eq import AdaptiveEqualizer
from atsc_tpu_torch.ops.erasures import burst_erasure_flags
from atsc_tpu_torch.ops.mux import FdmDemuxer, FdmMuxer
from atsc_tpu_torch.ops.ntsc import detect_ntsc
from atsc_tpu_torch.ops.quantize import BYTES_PER_SAMPLE, dequantize_iq
from atsc_tpu_torch.ops.resample import (
    SYMBOL_RATE_FRACTION,
    StreamResampler,
    capture_rate,
)
from atsc_tpu_torch.parallel.field_shard import ShardedEncoder
from atsc_tpu_torch.parallel.mesh import make_mesh
from atsc_tpu_torch.parallel.rx_shard import ShardedReceiver
from atsc_tpu_torch.runtime.io import IqSink, SoapySdrSink, SoapySdrSource, TsReader
from atsc_tpu_torch.utils import checkpoint as ckpt
from atsc_tpu_torch.utils.config import EncoderConfig
from atsc_tpu_torch.utils.profiling import ThroughputMeter, profile


def _add_mesh_flags(ap: argparse.ArgumentParser, fields_per_step: int, what: str) -> None:
    """--mesh TIMExCH and --fields-per-step (the fields a --mesh step
    takes; without --mesh the output does not depend on it), with the JAX
    CLI's defaults."""
    ap.add_argument("--mesh", default=None, metavar="TIMExCH",
                    help=f"multi-device {what} over a mesh, e.g. '4x2' = 4 field "
                         "time-block shards x 2 channel shards (consecutive "
                         "fields across shards with O(1) state exchange; "
                         "channels must divide CH). The shards are laid "
                         "round-robin over the visible devices of --device's "
                         "kind, so one card runs several shards in turn")
    ap.add_argument("--fields-per-step", type=int, default=fields_per_step,
                    help="(--mesh) fields a device step takes")


def _parse_mesh(text: str) -> tuple[int, int]:
    """'TIMExCH' -> (n_time, n_ch), or the JAX CLI's ValueError."""
    try:
        n_time, n_ch = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants TIMExCH (e.g. 4x2), got {text!r}") from None
    return n_time, n_ch


def _make_mesh(n_time: int, n_ch: int, device: torch.device, what: str):
    """The n_time x n_ch mesh, its shards laid round-robin over the
    visible devices of `device`'s kind (the CPU is one device), the
    placement printed on stderr."""
    if device.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [device]
    n = n_time * n_ch
    mesh = make_mesh(n_time, n_ch, [visible[i % len(visible)] for i in range(n)])
    print(f"{what} --mesh: {n} shards on {len(visible)} {device.type} device(s): "
          + " ".join(mesh.placement()), file=sys.stderr)
    return mesh


def _add_sdr_flags(ap: argparse.ArgumentParser, gain: float, live: str) -> None:
    """The SoapySDR device's -d/-f/-g (the reference's flags,
    util/defaults.h:3-5), with the JAX CLI's defaults for the `live` side."""
    ap.add_argument("-d", "--driver", default="hackrf",
                    help=f"SoapySDR driver of the 'soapy' {live}")
    ap.add_argument("-f", "--frequency", type=float, default=473e6,
                    help=f"(the 'soapy' {live}) RF centre frequency in Hz")
    ap.add_argument("-g", "--gain", type=float, default=gain,
                    help=f"(the 'soapy' {live}) gain in dB")


def _add_state_flags(ap: argparse.ArgumentParser, what: str) -> None:
    """--checkpoint, --checkpoint-every, --resume and --profile."""
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help=f"save the complete resumable {what} state to PATH "
                         "every --checkpoint-every fields and at the end")
    ap.add_argument("--checkpoint-every", type=int, default=64, metavar="FIELDS",
                    help="(--checkpoint) fields between saved states")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint, skipping the input it "
                         "already consumed")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the run (CPU and "
                         "CUDA activity, Chrome trace format) into LOGDIR")


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
                    help="IQ sink: 'null', '-' (stdout), a file path or "
                         "'soapy[:driver]' for SDR transmit")
    ap.add_argument("-c", "--channels", type=int, default=1,
                    help="encode the stream as N parallel channels")
    ap.add_argument("--mux", action="store_true",
                    help="FDM-combine the channels into ONE wideband "
                         "multiplex at channels*6 MHz (6-MHz slot raster "
                         "centered on DC): drive a whole band from one "
                         "wideband SDR. cf32 output only")
    ap.add_argument("--realtime", action="store_true",
                    help="pace the sink to the output sample clock (the "
                         "10.762238 MHz symbol rate per channel, the "
                         "multiplex rate with --mux, or --rate/--ppm's)")
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
    _add_state_flags(ap, "encoder")
    _add_mesh_flags(ap, fields_per_step=8, what="encode")
    _add_sdr_flags(ap, gain=54.0, live="sink")
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


def _profiled(logdir: str | None):
    return profile(logdir) if logdir else contextlib.nullcontext()


def run(cfg: EncoderConfig, input_paths, max_fields: int = 0, stats: bool = False,
        checkpoint: str | None = None, checkpoint_every: int = 64,
        resume: bool = False, profile_dir: str | None = None, *,
        device: str = "cuda") -> dict:
    """Encode TS input(s) to an IQ sink per `cfg`; returns the throughput
    summary. cfg.rate (samples/s, exact as a Fraction) and cfg.ppm
    resample the output (cf32; one channel, or the multiplex); cfg.mux
    FDM-combines the channels into one multiplex at channels*6 MHz
    (ops/mux.py FdmMuxer); cfg.realtime paces the sink. A 'soapy[:driver]'
    sink is a SoapySDR transmitter that its own clock paces: at the symbol
    rate, the multiplex rate with mux, or cfg.rate's clock (cfg.ppm
    stretches the samples, not the clock). checkpoint saves
    the state every `checkpoint_every` fields and at the end, resume
    continues from it (the input's first fields, already encoded, are
    skipped). A checkpointed stop at max_fields leaves the mux and
    resampler carries unflushed: the resumed run renders them from real
    data."""
    cfg.validate()
    dev = resolve_device(device)
    if isinstance(input_paths, str):
        input_paths = [input_paths]
    channels, fmt, mux = cfg.channels, cfg.out_format, cfg.mux
    if len(input_paths) not in (1, channels):
        raise ValueError(f"{len(input_paths)} inputs for {channels} channels")
    if mux and fmt != "cf32":
        raise ValueError("--mux emits cf32 only")
    resampler = None
    out_sps = None  # output sample rate per emitted stream (Hz)
    sdr_sps = None  # a soapy sink's hardware clock (not stretched by --ppm)
    if cfg.rate is not None or cfg.ppm:
        if fmt != "cf32":
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
        target = nominal = Fraction(cfg.rate) if cfg.rate is not None else native
        if cfg.ppm:
            # a DAC clocked ppm fast stretches the sample grid: emit
            # 1 + ppm/1e6 samples per nominal sample (decode --sro ppm is
            # the exact inverse)
            target = target * (1 + Fraction(cfg.ppm) / 1_000_000)
        band = 6_000_000 * (channels if mux else 1)
        if target < band:
            raise ValueError(
                f"--rate {float(target):.0f} cannot carry the occupied "
                f"+-{band / 2e6:g} MHz band (needs >= {band / 1e6:g} MS/s)")
        if target != native:
            resampler = StreamResampler(native / target, batch=1 if mux else channels,
                                        device=dev)
        out_sps = float(target)
        # the SDR plays the ppm-stretched samples at the nominal clock, or
        # the emulated clock error cancels on air; only --rate sets the
        # hardware clock
        sdr_sps = float(nominal)
    if resume and not checkpoint:
        raise ValueError("--resume requires --checkpoint")
    per_stream = out_sps if out_sps is not None else (
        channels * 6e6 if mux else P.SAMPLE_RATE)
    stream_rate = per_stream * (1 if mux else channels)
    meshed = cfg.n_time * cfg.n_ch > 1
    if meshed:
        # the field-sharded encoder: fields_per_step fields a step over
        # n_time time shards, planar output (the gathered step is host IQ)
        mesh = _make_mesh(cfg.n_time, cfg.n_ch, dev, "encode")
        enc = ShardedEncoder(mesh, batch=channels, out_format=fmt,
                             fields_per_device=max(1, cfg.fields_per_step // cfg.n_time))
        mesh_state = enc.init_state()
        t_step = enc.t_total
    else:
        # quantized formats leave the kernel as packed wire lanes whose
        # bytes are the interleaved stream: the sink writes them verbatim
        enc = Encoder(batch=channels, out_format=fmt, wire=fmt in ("cs16", "cs8"),
                      device=dev)
        t_step = 1
    muxer = FdmMuxer(channels, device=dev) if mux else None
    fields_done = 0
    if resume:
        # everything is checked before the sink opens: a refused resume
        # leaves the output untouched
        state, fields_done = ckpt.load_state(checkpoint, device="cpu" if meshed else dev)
        if state.parity.shape[0] != channels:
            raise ValueError(f"checkpoint holds {state.parity.shape[0]} channels, "
                             f"this encode {channels}")
        if meshed:
            mesh_state = enc.put_state(state)
        else:
            enc.state = state
        carry = ckpt.load_mux_carry(checkpoint)
        if (carry is not None) != (muxer is not None):
            raise ValueError("checkpoint and --mux disagree: resume a --mux run "
                             "with --mux and a plain run without it")
        if muxer is not None:
            muxer.set_state(carry)
        rs_saved = ckpt.load_resample_state(checkpoint)
        if (rs_saved is not None) != (resampler is not None):
            raise ValueError("checkpoint and --rate disagree: resume a --rate run "
                             "with the same --rate and a nominal-rate run "
                             "without it")
        if resampler is not None:
            if (int(rs_saved["num"]), int(rs_saved["den"])) != (resampler.num,
                                                                 resampler.den):
                raise ValueError("--rate differs from the checkpointed run's rate")
            resampler = StreamResampler.load_full_state(rs_saved, device=dev)
    meter = ThroughputMeter(channels=channels)

    def save() -> None:
        ckpt.save_state(checkpoint, enc.gather_state(mesh_state) if meshed else enc.state,
                        fields_done,
                        mux_carry=None if muxer is None else muxer.get_state(),
                        resample_state=None if resampler is None else resampler.full_state())

    def emit_mux_chunk(chunk: np.ndarray) -> None:
        """(2, m) wideband multiplex chunk -> (resample ->) sink."""
        if resampler is not None and chunk.shape[-1]:
            chunk = resampler.push_planar(chunk[None])[0]
        _write_planar(sink, chunk[None])

    def emit(iq) -> None:
        """One encoded field for every channel: planar (B, 2, 261120) or
        packed wire lanes (B, 261120), a tensor or host numpy."""
        if muxer is not None:
            emit_mux_chunk(muxer.push(iq[:, :, : P.SYMBOLS_PER_FIELD]))
        elif resampler is not None:
            _write_planar(sink, resampler.push_planar(iq[:, :, : P.SYMBOLS_PER_FIELD]))
        else:
            host = iq.cpu().numpy() if isinstance(iq, torch.Tensor) else iq
            if host.ndim == 2:
                sink.write_wire(host, P.SYMBOLS_PER_FIELD)
            else:
                sink.write_planar(np.ascontiguousarray(host), P.SYMBOLS_PER_FIELD)

    field_bytes = P.FIELD_TS_BYTES
    n_run = sync_checked = sync_bad = 0
    last_saved = fields_done
    eof = False   # the loop ended at the end of the input (not at max_fields)
    state_clean = True   # meshed: the state has not advanced past pad fields
    readers = [TsReader(p) for p in input_paths]
    sink = None
    try:
        if _is_live(cfg.sink):
            # the SDR's own clock paces it; --mux runs it at the multiplex
            # rate with a matching analog bandwidth, --rate/--ppm at sdr_sps
            sink = SoapySdrSink(
                driver=cfg.sink.split(":", 1)[1] if ":" in cfg.sink else cfg.driver,
                frequency_hz=cfg.frequency_hz, gain_db=cfg.gain_db, stream_format=fmt,
                sample_rate=sdr_sps if sdr_sps is not None else (stream_rate if mux else None),
                bandwidth_hz=channels * 6e6 if mux else 6_000_000.0)
        else:
            sink = IqSink(cfg.sink, pace_bytes_per_sec=stream_rate * BYTES_PER_SAMPLE[fmt]
                          if cfg.realtime else 0.0)
        for r in readers:   # the fields the checkpointed run encoded
            left = fields_done * field_bytes
            while left > 0:
                got = r.read(min(left, field_bytes))
                if not got:
                    break
                left -= len(got)
        with _profiled(profile_dir):
            while True:
                step = []   # up to t_step fields, (channels, field_bytes) each
                while len(step) < t_step:
                    got = _read_field(readers, field_bytes)
                    if got is None:
                        break
                    ts, checked, bad = got
                    sync_checked += checked
                    sync_bad += bad
                    step.append(np.broadcast_to(ts, (channels, field_bytes)))
                if not step:
                    eof = True
                    break
                whole = len(step)
                if meshed:
                    ts = np.zeros((t_step, channels, field_bytes), np.uint8)
                    ts[:whole] = step
                    # a zero-padded EOF step advances the state past the
                    # real stream: no checkpoint from here on
                    state_clean = state_clean and whole == t_step
                    mesh_state, iq = enc.step(mesh_state, ts)
                    iq_host = enc.gather_iq(iq)
                    for f in range(whole):
                        emit(iq_host[f])
                else:
                    emit(enc.encode(step[0]))
                meter.add_fields(whole * channels)
                n_run += whole
                fields_done += whole
                if (checkpoint and state_clean
                        and fields_done - last_saved >= checkpoint_every):
                    save()
                    last_saved = fields_done
                if max_fields and n_run >= max_fields:
                    break
            # a checkpointed stop before the end of the input must not
            # flush: the flush zero-pads the carried remainder, which the
            # resumed run renders from real data
            if eof or not checkpoint:
                if muxer is not None:
                    emit_mux_chunk(muxer.flush())
                if resampler is not None:
                    _write_planar(sink, resampler.flush_planar())
    finally:
        for r in readers:
            r.close()
        if sink is not None:
            sink.close()
    if checkpoint and fields_done != last_saved and state_clean:
        save()

    summary = meter.summary()
    summary["device"] = str(dev)
    if meshed:
        summary["mesh"] = f"{cfg.n_time}x{cfg.n_ch}"
        summary["devices"] = [str(mesh.device(c)) for c in mesh.coords()]
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


#: CLI --trellis value -> IqReceiver trellis mode
_TRELLIS_MODE = {"hard": "hard", "viterbi": "soft", "viterbi-i8": "soft-i8"}


def build_decode_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="atsc_tpu_torch decode",
        description="8VSB receiver (PyTorch + CUDA): baseband IQ -> MPEG-TS",
    )
    ap.add_argument("input", help="IQ capture ('-' = stdin) produced by the "
                                  "encoder, starting at the stream epoch "
                                  "(anywhere, with --align auto); or "
                                  "'soapy[:driver]' to capture live from a "
                                  "SoapySDR receiver (see -d/-f/-g)")
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
    _add_state_flags(ap, "receiver")
    _add_mesh_flags(ap, fields_per_step=4, what="decode")
    _add_sdr_flags(ap, gain=30.0, live="source")
    return ap


def _open_capture(args, sample_rate: float, bandwidth_hz: float):
    """The capture to decode or analyze: '-' = stdin, 'soapy[:driver]' = a
    live SoapySDR receive stream at sample_rate and bandwidth_hz (in
    --format wire samples), else a capture file."""
    if args.input == "-":
        return sys.stdin.buffer
    if _is_live(args.input):
        return SoapySdrSource(
            driver=args.input.split(":", 1)[1] if ":" in args.input else args.driver,
            frequency_hz=args.frequency, gain_db=args.gain, sample_rate=sample_rate,
            stream_format=args.in_format, bandwidth_hz=bandwidth_hz)
    return open(args.input, "rb")


def _live_stats(args, fin) -> dict:
    """A live capture's stream counters for the --stats summary."""
    if not _is_live(args.input):
        return {}
    return {"overflows": fin.overflows, "gaps_filled": fin.gaps_filled,
            "gap_samples": fin.gap_samples}


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

    @classmethod
    def wrap(cls, fp) -> "_TsOut":
        """Adopt an already-open single interleaved stream (the resume path)."""
        out = cls.__new__(cls)
        out.per_channel = False
        out._fps = [fp]
        return out

    def write_fields(self, ts: np.ndarray) -> None:
        """ts: (B, FIELD_TS_BYTES): one decoded field for B channels."""
        if self.per_channel:
            for fp, row in zip(self._fps, ts):
                fp.write(row.tobytes())
        else:
            self._fps[0].write(ts.tobytes())

    def flush(self) -> None:
        for fp in self._fps:
            fp.flush()

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
    capture-rate wire stream (any --format, a file or a live SDR) and
    serves nominal-symbol-rate cf32 wire bytes through a StreamResampler on
    `device`. read(n) returns exactly n bytes until the source is exhausted
    (then the resampler tail, then b''), so every conditioning stage
    downstream (align/CFO/equalizer) runs unchanged at the nominal rate."""

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

    def seekable(self) -> bool:
        return False

    def close(self) -> None:
        if self._fin is not sys.stdin.buffer:
            self._fin.close()

    def __getattr__(self, name):  # a live source's counters (overflows, gaps)
        return getattr(self._fin, name)


#: decode flags that configure the receiver: (args name, default, the
#: receiver attribute a checkpoint restores it to, how the flag maps to it)
_RX_FLAGS = (
    ("trellis", "hard", "trellis", _TRELLIS_MODE.get),
    ("ntsc", "off", "ntsc", str),
    ("erasures", "off", "erasures", str),
    ("viterbi_chunks", 1, "viterbi_chunks", int),
    ("eq_profile", "auto", "eq_profile", str),
    ("train_every", 1, "train_every", int),
)


def _check_resume_flags(args, rx) -> None:
    """A --resume continues the checkpointed decode as it was: a receiver
    flag given now (not left at its default) must be the checkpoint's."""
    def refuse(flag: str, saved, given) -> None:
        raise ValueError(f"checkpoint was saved with --{flag} {saved}, this decode "
                         f"asks for {given}; decode flags cannot change on --resume")

    for name, default, attr, to_rx in _RX_FLAGS:
        given = getattr(args, name)
        if given != default and to_rx(given) != getattr(rx, attr):
            refuse(name.replace("_", "-"), getattr(rx, attr), given)
    if args.equalizer != "zf" and rx.backend != args.equalizer:
        refuse("equalizer", rx.backend, args.equalizer)
    if args.resync != "off" and rx.resync is None:
        refuse("resync", "off", args.resync)
    if (args.forgetting != 1.0 and rx.adaptive is not None
            and float(np.float32(args.forgetting)) != rx.adaptive._lam):
        refuse("forgetting", rx.adaptive._lam, args.forgetting)


def _reopen_output(path: str, emitted: int, channels: int) -> "_TsOut":
    """The resume path's TS output: '-' as it is; a file must hold the
    `emitted` fields decoded before the checkpoint (a missing or shorter
    file is refused: its fields are lost and a resume would write only the
    rest), and anything after them, written after the checkpoint, is cut
    off."""
    if path == "-":
        return _TsOut.wrap(sys.stdout.buffer)
    expect = emitted * P.FIELD_TS_BYTES * channels
    if not os.path.exists(path):
        raise ValueError(f"--resume: the output {path!r} is missing; it must hold the "
                         f"{emitted} fields decoded before the checkpoint (restore "
                         "it, or decode from the start without --resume)")
    size = os.path.getsize(path)
    if size < expect:
        raise ValueError(f"--resume: the output {path!r} is {size} bytes, "
                         f"{expect - size} short of the {emitted} fields decoded "
                         "before the checkpoint (restore it, or decode from the "
                         "start without --resume)")
    fp = open(path, "r+b")
    fp.truncate(expect)
    fp.seek(0, 2)
    return _TsOut.wrap(fp)


def _skip_input(fin, nbytes: int) -> None:
    """Move past the capture bytes a checkpointed decode consumed."""
    if fin.seekable():
        fin.seek(nbytes)
        return
    while nbytes > 0:
        got = fin.read(min(nbytes, 1 << 20))
        if not got:
            break
        nbytes -= len(got)


def run_decode(args) -> dict:
    """Decode a capture (args from build_decode_argparser) to TS; returns
    the summary (printed to stderr with --stats). The conditioning flags
    follow the JAX CLI's run_decode: validation in its order, the same
    equalizer promotions, the same summary keys. --checkpoint/--resume as
    there, except that a resume whose output file is missing or short is
    refused (the JAX CLI writes only the rest of the stream). A live
    'soapy' input is single-channel, cannot run --sro auto and cannot
    resume; its summary adds the stream's overflow and gap counters."""
    if args.demux:
        return run_decode_demux(args)
    if args.mesh:
        return run_decode_mesh(args)
    fmt, channels = args.in_format, args.channels
    if args.resume and not args.checkpoint:
        raise ValueError("--resume requires --checkpoint")
    if args.resume and "{ch}" in args.output:
        raise ValueError("per-channel output ('{ch}') is not resumable; "
                         "resume into a single interleaved output")
    if _is_live(args.input):
        if channels != 1:
            raise ValueError("a live SDR capture is single-channel; use "
                             "--demux for a wideband multi-channel band")
        if args.sro == "auto":
            raise ValueError("--sro auto reads the whole capture up front "
                             "and cannot run on a live stream (capture to "
                             "a file first and measure, then pass the "
                             "numeric ppm value — that path streams)")
        if args.resume:
            raise ValueError("--resume needs a repositionable capture, "
                             "not a live stream")
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
    if args.checkpoint and (align or stream_rate is not None or args.sro == "auto"):
        # a checkpoint counts the conditioned stream's samples (after the
        # align offset, on the resampled grid), not the capture's: a resume
        # would skip to the wrong sample
        raise ValueError("--align/--sro/--rate conditioning is not "
                         "checkpointable (decode the capture in one run, "
                         "or pre-convert it)")
    if args.resume and cfo_auto:
        raise ValueError("--resume cannot re-run --cfo auto/track estimation "
                         "(the checkpoint holds its CFO and phase: resume "
                         "without --cfo)")
    rx = fout = sro_rate = None
    fin = _open_capture(args, float(_parse_sps(args.rate)) if args.rate else P.SAMPLE_RATE,
                        6e6)
    try:
        if args.resume:
            # the checkpoint and the output are checked before anything is
            # read or written: a refused resume leaves both as they were
            rx = ckpt.load_receiver(args.checkpoint, device=dev)
            if rx.batch != channels:
                raise ValueError(f"checkpoint batch {rx.batch} != --channels {channels}")
            saved_fmt = rx.checkpoint_extra.get("in_format", fmt)
            if saved_fmt != fmt:
                raise ValueError(f"checkpoint input format {saved_fmt!r} != "
                                 f"--format {fmt!r}")
            _check_resume_flags(args, rx)
            fout = _reopen_output(args.output, rx.fields_emitted, channels)
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
        if rx is not None:
            # the checkpointed numeric CFO applies unless overridden, with
            # the corrector's accumulated phase at the checkpoint (a
            # --cfo track run retuned mid-stream, so the final rate times
            # the consumed samples is not that phase)
            cfo_hz = (float(args.cfo) if args.cfo != "0"
                      else float(rx.checkpoint_extra.get("cfo_hz", 0.0)))
            correct = CfoCorrector(cfo_hz)
            consumed = rx._stream.end
            saved_phi = rx.checkpoint_extra.get("cfo_phi")
            if saved_phi is not None:
                correct._phi = float(saved_phi)
                correct._n = consumed
            else:
                correct.skip(consumed)
            rx.measure_mer = args.stats and rx.trellis != "soft-i8"
            codes_path = rx.wire_format != "cf32"
            _skip_input(fin, consumed * BYTES_PER_SAMPLE[fmt] * channels)
        else:
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
            fout = _TsOut(args.output, channels)
        fields = last_ckpt = 0
        track_tail: list[np.ndarray] = []  # last 2 corrected field blocks
        cfo_retunes = 0
        last_track = 0

        def emit(decoded) -> None:
            nonlocal fields
            for ts, _ in decoded:   # (B, 58656): one field, every channel
                fout.write_fields(ts)
                fields += 1

        def maybe_checkpoint(force: bool = False) -> None:
            nonlocal last_ckpt
            if args.checkpoint and (force or fields - last_ckpt >= args.checkpoint_every):
                fout.flush()
                ckpt.save_receiver(args.checkpoint, rx,
                                   extra={"in_format": fmt, "cfo_hz": cfo_hz,
                                          "cfo_phi": correct._phi})
                last_ckpt = fields

        with _profiled(args.profile):
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
                maybe_checkpoint()
                if args.max_fields and fields >= args.max_fields:
                    break
            if not args.max_fields or fields < args.max_fields:
                emit(rx.flush())
            maybe_checkpoint(force=True)
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
    if args.resync != "off" or rx.resync is not None:
        summary["resyncs"] = rx.resyncs
    summary |= _live_stats(args, fin)
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


def _read_field_blocks(fin, k: int, b: int, fmt: str, quantized: bool):
    """Read up to k whole per-field wire blocks: -> (B, got*N) complex64
    (quantized=False; cs16/cs8 dequantized on the host) or (B, got*N, 2)
    integer codes, verbatim (quantized=True, for the sharded decode_codes
    path); None at EOF. A trailing partial block is dropped with a
    warning."""
    n = P.SYMBOLS_PER_FIELD
    block = n * BYTES_PER_SAMPLE[fmt] * b
    buf = fin.read(block * k)
    whole = len(buf) // block
    if len(buf) % block:
        print(f"warning: dropping {len(buf) % block}-byte partial "
              "field block at EOF", file=sys.stderr)
    if whole == 0:
        return None
    buf = buf[: whole * block]
    if quantized:
        codes = np.frombuffer(buf, dtype=_CODE_DTYPE[fmt])
        return np.ascontiguousarray(
            codes.reshape(whole, b, n, 2).transpose(1, 0, 2, 3).reshape(b, whole * n, 2))
    flat = _wire_to_complex(buf, fmt)
    return np.ascontiguousarray(flat.reshape(whole, b, n).transpose(1, 0, 2).reshape(b, -1))


class _SampleFifo:
    """Per-channel sample FIFO for the conditioned mesh decode loop:
    (B, n[, 2]) chunks in (push order kept), slices of any length out.
    Used only when --cfo/--align conditioning breaks the file's
    field-block alignment."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []
        self.have = 0

    def push(self, arr: np.ndarray) -> None:
        if arr.shape[1]:
            self._chunks.append(arr)
            self.have += arr.shape[1]

    def pop(self, n: int) -> np.ndarray:
        if n > self.have:
            raise ValueError(f"pop({n}) from a fifo holding {self.have}")
        out, got = [], 0
        while got < n:
            ch = self._chunks[0]
            take = min(ch.shape[1], n - got)
            out.append(ch[:, :take])
            if take == ch.shape[1]:
                self._chunks.pop(0)
            else:
                self._chunks[0] = ch[:, take:]
            got += take
        self.have -= n
        return np.concatenate(out, axis=1) if len(out) > 1 else out[0]


def run_decode_mesh(args) -> dict:
    """Multi-device decode (the JAX CLI's run_decode_mesh): the
    sample-synchronous receive chain of parallel/rx_shard.py
    ShardedReceiver, T = --fields-per-step fields a step over the mesh,
    with a one-step lookahead so every step boundary gets real +-384-sample
    equalizer context (a clean capture decodes with zero RS corrections,
    like the streaming path). Every trellis tier shards (--trellis
    viterbi/viterbi-i8, --ntsc comb); cs16/cs8 captures upload verbatim;
    --checkpoint/--resume persist the gathered sharded state
    (utils/checkpoint.py save_sharded_receiver); --cfo/--align condition
    the capture on the host first and decode with the per-field adaptive
    equalizer. Unlike the JAX CLI, --train-every reaches the receiver, the
    checkpoint records it, and a resume whose output is missing or short is
    refused, as the port's other resumes are."""
    for flag, default in (("sro", "0"), ("rate", None),
                          ("forgetting", 1.0), ("erasures", "off"),
                          ("resync", "off")):
        if getattr(args, flag) != default:
            raise ValueError(f"--mesh decode does not support --{flag}"
                             if flag != "forgetting" else
                             "--mesh adaptive training is strictly "
                             "per-field; --forgetting does not apply")
    n_time, n_ch = _parse_mesh(args.mesh)
    if args.viterbi_chunks > 1:
        raise ValueError("--mesh decode does not support --viterbi-chunks")
    if args.ntsc == "auto":
        raise ValueError("--mesh wants an explicit comb decision: use "
                         "--ntsc comb (run `analyze` or a sequential "
                         "--ntsc auto probe to decide first)")
    if args.cfo == "track":
        raise ValueError("--mesh supports a fixed/auto --cfo; 'track' "
                         "re-estimation is a sequential-receiver feature")

    b = args.channels
    n = P.SYMBOLS_PER_FIELD
    align_auto = args.align == "auto"
    cfo_auto = args.cfo == "auto"
    cfo_hz = 0.0 if cfo_auto else float(args.cfo)
    conditioning = align_auto or cfo_auto or cfo_hz != 0.0
    trellis = _TRELLIS_MODE[args.trellis]
    if args.ntsc == "comb":
        if args.trellis != "hard":
            raise ValueError("--ntsc comb IS the ML trellis tier (16-state "
                             "partial-response Viterbi) — drop --trellis")
        trellis = "ntsc"
    equalizer = args.equalizer
    if conditioning and equalizer == "zf":
        equalizer = "adaptive"   # epoch phase/residual rotation needs training
    if equalizer != "zf" and trellis != "hard":
        raise ValueError("--mesh ML trellis tiers (viterbi/viterbi-i8/"
                         "--ntsc comb) shard with the zf equalizer only")
    if conditioning and trellis != "hard":
        raise ValueError("--mesh --cfo/--align conditioning decodes with "
                         "the adaptive equalizer (hard trellis)")
    if args.checkpoint and conditioning:
        raise ValueError("--mesh --cfo/--align conditioning is not "
                         "checkpointable (decode the capture in one run, "
                         "or pre-convert it)")
    resume = bool(args.resume)
    if resume and not args.checkpoint:
        raise ValueError("--resume requires --checkpoint")
    if resume and _is_live(args.input):
        raise ValueError("--resume needs a repositionable capture, "
                         "not a live stream")
    if resume and "{ch}" in args.output:
        raise ValueError("per-channel output ('{ch}') is not resumable; "
                         "resume into a single interleaved output")
    if _is_live(args.input) and b != 1:
        raise ValueError("a live SDR capture is single-channel; use "
                         "--demux for a wideband multi-channel band")

    dev = resolve_device(args.device)
    mesh = _make_mesh(n_time, n_ch, dev, "decode")
    fmt = args.in_format
    # quantized captures ride the sharded decode_codes path verbatim;
    # conditioning needs float samples, so it dequantizes on the host
    quantized = fmt != "cf32" and not conditioning

    def receiver(first_field: int) -> ShardedReceiver:
        return ShardedReceiver(
            mesh, batch=b, fields_per_device=max(1, args.fields_per_step // n_time),
            first_field=first_field, eq_profile=args.eq_profile,
            equalizer=equalizer, trellis=trellis,
            wire_format=fmt if quantized else "cf32", train_every=args.train_every)

    rx = receiver(args.first_field)
    t = rx.t_total
    margin = rx._margin   # the decode_* with_context edge (384 samples)
    block = n * BYTES_PER_SAMPLE[fmt] * b

    fields = 0           # TS fields emitted
    fields_consumed = 0  # capture fields fed into decoded steps
    corrected = uncorrectable = 0
    last_ckpt = 0
    fout = None
    if resume:
        # the checkpoint and the output are checked before anything is
        # read or written: a refused resume leaves both as they were
        extra = ckpt.restore_sharded_receiver(args.checkpoint, rx)
        if extra.get("in_format", fmt) != fmt:
            raise ValueError(f"checkpoint --format {extra.get('in_format')!r} != {fmt!r}")
        fields_consumed = int(extra.get("fields_consumed", 0))
        fields = last_ckpt = int(extra.get("fields_emitted", 0))
        corrected = int(extra.get("segments_corrected", 0))
        uncorrectable = int(extra.get("segments_uncorrectable", 0))
        fout = _reopen_output(args.output, fields, b)
    fin = _open_capture(args, P.SAMPLE_RATE, 6e6)
    if fout is None:
        fout = _TsOut(args.output, b)

    left = np.zeros((b, margin) + ((2,) if quantized else ()),
                    _CODE_DTYPE[fmt] if quantized else np.complex64)
    if resume and fields_consumed > 0:
        # seek past the consumed capture, re-reading the last consumed
        # field block for the next step's left edge context
        _skip_input(fin, (fields_consumed - 1) * block)
        prev = _read_field_blocks(fin, 1, b, fmt, quantized)
        if prev is not None:
            left = prev[:, -margin:]

    def read_step():
        """-> ((B, T*N[, 2]) zero-padded step, real field count)."""
        arr = _read_field_blocks(fin, t, b, fmt, quantized)
        if arr is None:
            return None, 0
        whole = arr.shape[1] // n
        if whole < t:
            pad = np.zeros((b, t * n - arr.shape[1]) + arr.shape[2:], arr.dtype)
            arr = np.concatenate([arr, pad], axis=1)
        return arr, whole

    cond_info: dict = {}
    if conditioning:
        fifo = _SampleFifo()
        # buffer enough for CFO estimation (~4 fields) + the sync search
        while fifo.have < 4 * n + 8192:
            arr = _read_field_blocks(fin, t, b, fmt, quantized=False)
            if arr is None:
                break
            fifo.push(arr)
        if fifo.have < (2 * n + 707 if align_auto else n):
            raise ValueError("capture too short for --cfo/--align "
                             "conditioning under --mesh")
        buffered = fifo.pop(fifo.have)
        if cfo_auto:
            cfo_hz = estimate_cfo(buffered[0])
        corrector = CfoCorrector(cfo_hz)
        buffered = np.ascontiguousarray(corrector(buffered))
        cond_info["cfo_hz"] = round(float(cfo_hz), 3)
        if align_auto:
            off, parity = find_field_sync_iq(buffered[0])
            buffered = buffered[:, off:]
            cond_info.update(align_offset=int(off), align_parity=int(parity))
            rx = receiver(parity)   # re-base the oscillator epoch on the parity
        fifo.push(np.ascontiguousarray(buffered))
        eof = False

        def read_step():  # noqa: F811 (the conditioned twin)
            """Serve (B, T*N) steps from the fifo, topping it up
            (derotating chunks in stream order)."""
            nonlocal eof
            while fifo.have < t * n and not eof:
                arr = _read_field_blocks(fin, t, b, fmt, quantized=False)
                if arr is None:
                    eof = True
                    break
                fifo.push(np.ascontiguousarray(corrector(arr)))
            whole = min(fifo.have // n, t)
            if whole == 0:
                return None, 0
            arr = fifo.pop(whole * n)
            if whole < t:
                arr = np.concatenate([arr, np.zeros((b, (t - whole) * n), arr.dtype)],
                                     axis=1)
            return arr, whole

    def maybe_checkpoint(force: bool = False) -> None:
        nonlocal last_ckpt
        if args.checkpoint and (force or fields - last_ckpt >= args.checkpoint_every):
            fout.flush()
            ckpt.save_sharded_receiver(
                args.checkpoint, rx,
                extra={"in_format": fmt, "fields_consumed": fields_consumed,
                       "fields_emitted": fields, "segments_corrected": corrected,
                       "segments_uncorrectable": uncorrectable})
            last_ckpt = fields

    def decode_step(left, cur, right, start_field, real) -> bool:
        nonlocal fields, corrected, uncorrectable, fields_consumed
        arr = np.concatenate([left, cur, right], axis=1)
        if quantized:
            ts, nerr = rx.decode_codes(arr, with_context=True)
        else:
            ts, nerr = rx.decode_iq(arr, with_context=True)
        fields_consumed += real
        for k in range(t):
            # output k is TS field start_field + k - 1: skip the pre-start
            # virtual field (k = 0 of the very first step) and, on a
            # padded EOF step, outputs past the last real field's TS
            if start_field + k - 1 < 0 or k > real - 1:
                continue
            fout.write_fields(ts[k])
            fields += 1
            corrected += int((nerr[k] > 0).sum())
            uncorrectable += int((nerr[k] < 0).sum())
            if args.max_fields and fields >= args.max_fields and not args.checkpoint:
                # stop mid-step only when un-checkpointed: a resumable run
                # finishes the step (the sharded state has already
                # advanced past it), overshooting --max-fields by < T
                return True
        return bool(args.max_fields and fields >= args.max_fields)

    try:
        with _profiled(args.profile):
            held, held_real = read_step()
            start = fields_consumed
            while held is not None:
                nxt, nxt_real = read_step()
                right = nxt[:, :margin] if nxt is not None else np.zeros_like(left)
                if decode_step(left, held, right, start, held_real):
                    break
                maybe_checkpoint()
                left = held[:, -margin:]
                held, held_real = nxt, nxt_real
                start += t
            maybe_checkpoint(force=True)
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
        fout.close()
    summary = {
        "fields_decoded": fields,
        "segments_corrected": corrected,
        "segments_uncorrectable": uncorrectable,
        "mesh": f"{n_time}x{n_ch}",
        "trellis": trellis,
        "equalizer": equalizer,
        "device": str(dev),
        "devices": [str(mesh.device(c)) for c in mesh.coords()],
    }
    summary.update(cond_info)
    summary |= _live_stats(args, fin)
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
    """Wideband headend receive (the JAX CLI's run_decode_demux): the
    device FDM demultiplexer (ops/mux.py) feeding one batched adaptive
    receiver, B transport streams out of one B*6 MHz capture. `--rate`
    takes a capture clocked at any SDR rate (streaming-resampled to the
    multiplex rate; implies `--align auto`, since the conversion shifts the
    epoch); `--align auto` locates the field boundary in slot 0's demuxed
    baseband (every slot is sample-synchronous). --checkpoint saves the
    receiver with the demuxer's carry and the wideband read cursor;
    --resume continues from it into the interleaved output, refusing a
    missing or short one."""
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
    if args.checkpoint and (rate_frac is not None or align):
        raise ValueError("--demux --rate/--align conditioning is not "
                         "checkpointable (decode the capture in one run, "
                         "or pre-convert it)")
    if args.resume and not args.checkpoint:
        raise ValueError("--resume requires --checkpoint")
    if args.resume and _is_live(args.input):
        raise ValueError("--resume needs a repositionable capture, "
                         "not a live stream")
    if args.resume and "{ch}" in args.output:
        raise ValueError("per-channel output ('{ch}') is not resumable; "
                         "resume into a single interleaved output")
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

    wb_read = 0   # wideband multiplex samples consumed (the resume cursor)
    fout = None
    # a live band: the SDR runs at the multiplex rate (or at --rate,
    # stream-resampled down to it) with the multiplex's bandwidth
    fin = _open_capture(args, float(_parse_sps(args.rate)) if args.rate else dmx.rate_hz,
                        dmx.rate_hz)
    in_fmt = args.in_format
    if rate_frac is not None and rate_frac != 1:
        fin = _ResampledCapture(fin, in_fmt, rate_frac, dev)
        in_fmt = "cf32"
    sample_bytes = BYTES_PER_SAMPLE[in_fmt]
    fields = last_ckpt = 0

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

    def maybe_checkpoint(force: bool = False) -> None:
        nonlocal last_ckpt
        if args.checkpoint and (force or fields - last_ckpt >= args.checkpoint_every):
            fout.flush()
            ckpt.save_receiver(args.checkpoint, rx,
                               extra={"in_format": args.in_format, "demux_slots": b,
                                      "wideband_read": wb_read},
                               extra_arrays={"demux_carry": dmx.get_state()})
            last_ckpt = fields

    try:
        if args.resume:
            # checked before anything is read or written
            rx = ckpt.load_receiver(args.checkpoint, device=dev)
            if rx.batch != b:
                raise ValueError(f"checkpoint slots {rx.batch} != --demux {b}")
            carry = rx.checkpoint_arrays.get("demux_carry")
            if carry is None:
                raise ValueError("checkpoint is not a --demux decode checkpoint")
            saved_fmt = rx.checkpoint_extra.get("in_format", args.in_format)
            if saved_fmt != args.in_format:
                raise ValueError(f"checkpoint input format {saved_fmt!r} != "
                                 f"--format {args.in_format!r}")
            _check_resume_flags(args, rx)
            dmx.set_state(carry)
            wb_read = int(rx.checkpoint_extra.get("wideband_read", 0))
            rx.measure_mer = args.stats and rx.trellis != "soft-i8"
            fout = _reopen_output(args.output, rx.fields_emitted, b)
            _skip_input(fin, wb_read * sample_bytes)
        else:
            # construct (and so flag-validate) the receiver before opening
            # the output: a usage error must not truncate a file. An
            # --align run rebuilds it with the detected parity later.
            rx = make_rx(args.first_field)
            fout = _TsOut(args.output, b)
        with _profiled(args.profile):
            while True:
                buf = fin.read(1 << 22)
                if not buf:
                    break
                wb_read += len(buf) // sample_bytes
                feed(dmx.push(_wire_to_complex(buf, in_fmt)))
                maybe_checkpoint()
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
            maybe_checkpoint(force=True)
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
    summary |= _live_stats(args, fin)
    if rx.mer is not None:
        summary["mer_db"] = [round(float(v), 2) for v in rx.mer]
    if args.stats:
        print(json.dumps(summary), file=sys.stderr)
    return summary


def build_analyze_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="atsc_tpu_torch analyze",
        description="Signal-quality triage of an 8VSB IQ capture without "
                    "decoding: power, field alignment, carrier offset, "
                    "sample-rate offset, MER (the broadcast monitoring "
                    "metric) and the decode flags the capture needs",
    )
    ap.add_argument("input", help="IQ capture path, '-' (stdin), or "
                                  "'soapy[:driver]' to grab a few fields live off "
                                  "a SoapySDR receiver. One channel at the symbol "
                                  "rate by default; --demux/--rate cover wideband "
                                  "FDM multiplexes and other SDR clocks")
    ap.add_argument("--format", dest="in_format", default="cf32",
                    choices=("cf32", "cs16", "cs8"))
    ap.add_argument("--fields", type=int, default=4,
                    help="fields to analyze (>= 3 enables the SRO estimate); "
                         "one extra field of alignment slack is read on top")
    ap.add_argument("--cfo-search", type=float, default=3000.0,
                    help="one-sided carrier-offset search range (Hz)")
    ap.add_argument("--demux", type=int, default=0, metavar="B",
                    help="the capture is a B-slot FDM multiplex at B*6 MHz "
                         "(encode --mux output, a wideband SDR grab): demux "
                         "and report every slot")
    ap.add_argument("--rate", default=None, metavar="SPS",
                    help="capture sample rate (e.g. 20e6 for a 20 MS/s SDR "
                         "grab): stream-resampled to the native band rate "
                         "before analysis")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without "
                         "CUDA), 'cuda:N' or 'cpu'")
    _add_sdr_flags(ap, gain=30.0, live="source")
    return ap


def _analyze_iq(iq: np.ndarray, cfo_search: float, force_adaptive: bool = False,
                resampled: bool = False, *, device: str | torch.device) -> dict:
    """The per-channel metric core of `analyze` (the JAX CLI's _analyze_iq):
    (n,) complex baseband at the symbol rate -> {rms, sro_ppm, cfo_hz,
    align, mer_db, ...}. The estimators run on the host in float64 as in
    the JAX package; the equalizers on `device` (the zf MER through the
    eq_fir kernel, fast tier, soft levels; the adaptive MER through
    AdaptiveEqualizer).

    resampled: the samples already went through one rate conversion
    (--rate / demux): small SRO readings are then within the
    interpolator's phase-ripple noise and a second cascaded resample costs
    more MER than the residual drift, so the correction gate is wider."""
    n = P.SYMBOLS_PER_FIELD
    out: dict = {
        "samples": int(iq.size),
        "rms": round(float(np.sqrt(np.mean(np.abs(iq) ** 2))), 6),
    }
    if iq.size < n + P.SYMBOLS_PER_SEGMENT:
        out["error"] = (f"capture too short to analyze: {iq.size} samples "
                        "(< one field + one segment)")
        return out

    # impulse blanking (a monitor's front end): a strong noise burst
    # otherwise captures the estimators (the PN511 correlator peaks on the
    # burst, SRO and CFO follow it). The 8VSB envelope is Rayleigh (median
    # = 1.177 sigma), so 4x the median is ~4.7 sigma: clean samples almost
    # never trip it. The median is taken over non-zero samples and floored
    # at a quarter of the RMS, so a mostly zero-filled capture cannot
    # blank everything.
    amp = np.abs(iq)
    nz = amp[amp > 0]
    base = max(float(np.median(nz)) if nz.size else 0.0, 0.25 * out["rms"])
    hot = amp > 4.0 * base if base > 0 else np.zeros(amp.shape, bool)
    n_hot = int(hot.sum())
    if n_hot:
        out["blanked_samples"] = n_hot
        iq = np.where(hot, 0, iq)

    # SRO scales every frequency, so a pilot CFO estimate taken off-rate is
    # biased by pilot_Hz * ppm: align (PN511 correlation is CFO-robust over
    # its 47 us), resample to nominal, then measure the carrier offset
    off, parity = find_field_sync_iq(iq)
    if iq.size - off >= int(2.2 * n):
        rate = float(estimate_sro(iq[off:]))   # capture samples / nominal
        sro_ppm = (rate - 1.0) * 1e6
        out["sro_ppm"] = round(sro_ppm, 3)
        gate = 5.0 if resampled else 2.0
        if abs(sro_ppm) > gate:
            iq = resample_stream(iq, rate)[0]

    cfo = float(estimate_cfo(iq, search_hz=cfo_search))
    out["cfo_hz"] = round(cfo, 2)
    if abs(cfo) > 0.5:
        iq = iq * np.exp(-2j * np.pi * cfo / P.SAMPLE_RATE * np.arange(iq.size))

    off, parity = find_field_sync_iq(iq)
    out["align_offset"] = int(off)
    out["align_parity"] = int(parity)

    if iq.size - off >= n:
        levs: dict = {}  # method -> equalized levels (the burst triage below)

        def adaptive_mer() -> float:
            # phase/epoch-agnostic: the sync-trained equalizer absorbs any
            # fixed rotation or linear channel
            win, osc = field_window(iq[None], off, first_field=parity)
            lev = AdaptiveEqualizer(batch=1, device=device).process_field(
                win, osc, parity, soft=True)
            levs["adaptive"] = lev.cpu().numpy()
            return float(mer_db(levs["adaptive"])[0])

        mer = None
        if off == 0 and parity == 0 and not force_adaptive:
            # looks epoch-aligned: try the zf inverse of the known TX chain.
            # off == parity == 0 does not prove it (a capture cut at a frame
            # boundary looks the same with the oscillator ~pi off), so a
            # poor zf MER falls back to the adaptive measurement
            levs["zf"] = equalize_field_device(iq[None], 0, soft=True,
                                               device=device).cpu().numpy()
            mer = float(mer_db(levs["zf"])[0])
            out["mer_method"] = "zf"
        if mer is None or mer < 20.0:
            adaptive = adaptive_mer()
            if mer is None or adaptive > mer:
                mer = adaptive
                out["mer_method"] = "adaptive"
        out["mer_db"] = round(mer, 2)
        out["decodable"] = bool(out["mer_db"] >= 15.2)

        # impulse-noise triage: heavy-tailed windowed slicer residuals mark
        # bursts, which the RS erasure tier recovers far past the
        # errors-only budget; the soft-trellis advice below then judges the
        # burst-excluded MER
        lev_used = levs[out["mer_method"]]
        bflags = burst_erasure_flags(lev_used)[:, :n]
        n_burst = int(bflags.sum())
        out["burst_symbols"] = n_burst
        if n_burst:
            clean = lev_used[:, :n].copy()
            sliced = np.clip(np.rint((clean - P.PILOT_OFFSET + 7.0) / 2.0), 0, 7
                             ) * 2.0 - 7.0 + P.PILOT_OFFSET
            mask = bflags.astype(bool)
            clean[mask] = sliced[mask]       # zero the burst residuals
            out["mer_clean_db"] = round(float(mer_db(clean)[0]), 2)
        # analog co-channel triage: slicer residuals of the plain against
        # the 12-symbol-combed field (the comb's ~3 dB white-noise penalty
        # is in the vote, so clean and AWGN captures never trip it)
        out["ntsc_detected"] = bool(detect_ntsc(lev_used[:, :n]))
    else:
        out["note"] = ("capture too short after alignment for a MER "
                       "field; raise --fields")

    # the decode flags this capture needs (run_analyze prepends the capture
    # context, --rate/--demux)
    flags = []
    if abs(out.get("sro_ppm", 0.0)) > (5.0 if resampled else 2.0):
        flags.append("--sro auto")
    if abs(out.get("cfo_hz", 0.0)) > 5.0:
        flags.append("--cfo auto")
    if out.get("align_offset", 0) or out.get("align_parity", 0):
        flags.append("--align auto")
    if out.get("mer_method") == "adaptive" and "--align auto" not in flags:
        flags.append("--equalizer adaptive")
    # >= 192 flagged symbols = at least one real windowed burst event (the
    # detector dilates each to ~3 windows)
    burst_advised = out.get("burst_symbols", 0) >= 192
    if burst_advised:
        flags.append("--erasures burst")
    mer = out.get("mer_clean_db") if burst_advised else out.get("mer_db")
    if mer is None:
        mer = out.get("mer_db")
    if mer is not None and mer < 20.0:
        flags.append("--trellis viterbi")
    if out.get("ntsc_detected"):
        # the comb tier supersedes both: its PR Viterbi is already ML, and
        # the burst detector assumes the plain 8-level slicer
        flags = [f for f in flags if f not in ("--trellis viterbi", "--erasures burst")]
        flags.append("--ntsc auto")
    out["decode_flags"] = " ".join(flags)
    return out


def run_analyze(args) -> dict:
    """Measure a capture the way a broadcast monitor would (the JAX CLI's
    run_analyze): locate the field sync (PN511), estimate and back out SRO
    and CFO, then equalize one aligned field and report its MER, the
    burst and NTSC triage and the decode flags the capture needs. With
    --demux B the input is a B-slot FDM multiplex at B*6 MHz: it is
    demultiplexed on the device and every slot gets its own report, with
    band-level advice. A 'soapy' input grabs the fields live."""
    dev = resolve_device(args.device)
    n = P.SYMBOLS_PER_FIELD
    fmt = args.in_format
    slots = args.demux
    if slots:
        demux = FdmDemuxer(slots, device=dev)
        per_field_wb = int(np.ceil(n * demux.rate_hz / P.SAMPLE_RATE))
        # +1 field of budget: the first sync can land up to a field in,
        # and the SRO/MER gates need their spans after the offset
        want_samples = (args.fields + 1) * per_field_wb + 8192
        native, bw = demux.rate_hz, slots * 6e6
    else:
        want_samples = (args.fields + 1) * n + 2 * P.SYMBOLS_PER_SEGMENT
        native, bw = P.SAMPLE_RATE, 6_000_000.0
    # --rate: the capture runs at an arbitrary clock; stream-resample it to
    # the native band rate first (decode's adapter; rates below native
    # upsample, fine while the occupied band is carried)
    rate_frac = None
    cap_sps = native   # a live grab's SDR clock
    if args.rate is not None:
        sps = _parse_sps(args.rate)
        band = 6_000_000 * max(slots, 1)
        if sps < band:
            raise ValueError(
                f"--rate {float(sps):.0f} cannot carry the occupied "
                f"+-{band / 2e6:g} MHz band (needs >= {band / 1e6:g} MS/s)")
        rate_frac = sps / Fraction(band) if slots else capture_rate(sps)
        cap_sps = float(sps)
    fin = _open_capture(args, cap_sps, bw)
    try:
        if rate_frac is not None and rate_frac != 1:
            fin = _ResampledCapture(fin, fmt, rate_frac, dev)
            fmt = "cf32"
        buf = fin.read(want_samples * BYTES_PER_SAMPLE[fmt])
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
    iq = _wire_to_complex(buf, fmt)
    resampled = rate_frac is not None and rate_frac != 1
    # capture-context flags the decoder needs for this capture, whatever
    # the estimators find
    ctx = [] if args.rate is None else [f"--rate {args.rate}"]
    if not slots:
        out = _analyze_iq(iq, args.cfo_search, resampled=resampled, device=dev)
        if "error" in out:
            raise ValueError(out["error"])
        out["decode_flags"] = " ".join(ctx + ([out["decode_flags"]]
                                              if out["decode_flags"] else []))
        return out

    bb = np.concatenate([demux.push(iq), demux.flush()], axis=-1)
    if bb.shape[-1] < n + P.SYMBOLS_PER_SEGMENT:
        raise ValueError(
            f"capture too short to analyze: {bb.shape[-1]} demuxed "
            "samples per slot (< one field + one segment)")
    per_slot = [_analyze_iq(bb[s], args.cfo_search, force_adaptive=True,
                            resampled=True, device=dev)
                for s in range(slots)]
    # decode --demux conditions the whole band, not per slot (it refuses
    # --sro/--cfo/--equalizer, aligns off slot 0 and takes the clock from
    # --rate), so the actionable advice is band-level
    band_flags = [f"--demux {slots}", *ctx]
    if any(s.get("align_offset", 0) or s.get("align_parity", 0) for s in per_slot):
        band_flags.append("--align auto")
    out = {
        "multiplex_rate": float(native),
        "slots": slots,
        "samples": int(iq.size),
        "rms": round(float(np.sqrt(np.mean(np.abs(iq) ** 2))), 6),
        "per_slot": per_slot,
        "decode_flags": " ".join(band_flags),
    }
    for s in per_slot:   # per-slot flags are not actionable under --demux
        s.pop("decode_flags", None)
    if args.rate is None and any(abs(s.get("sro_ppm", 0.0)) > 5.0 for s in per_slot):
        out["note"] = ("slots report a sample-rate offset: the wideband "
                       "clock is off — decode with --rate set to the "
                       "capture's true sample rate")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["analyze"]:
        print(json.dumps(run_analyze(build_analyze_argparser().parse_args(argv[1:]))))
        return 0
    if argv[:1] == ["decode"]:
        run_decode(build_decode_argparser().parse_args(argv[1:]))
        return 0
    if argv[:1] == ["encode"]:
        argv = argv[1:]
    ap = build_argparser()
    args = ap.parse_args(argv)
    channels = args.channels
    if len(args.input) > 1:
        if channels not in (1, len(args.input)):
            ap.error(f"{len(args.input)} inputs but --channels {channels}")
        channels = len(args.input)
    n_time = n_ch = 1
    if args.mesh:
        try:
            n_time, n_ch = _parse_mesh(args.mesh)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    cfg = EncoderConfig(
        channels=channels, fields_per_step=args.fields_per_step, n_time=n_time,
        n_ch=n_ch, mux=args.mux, sink=args.output, realtime=args.realtime,
        out_format=args.out_format,
        rate=None if args.rate is None else _parse_sps(args.rate), ppm=args.ppm,
        frequency_hz=args.frequency, gain_db=args.gain, driver=args.driver)
    run(cfg, args.input, max_fields=args.max_fields, stats=args.stats,
        checkpoint=args.checkpoint, checkpoint_every=args.checkpoint_every,
        resume=args.resume, profile_dir=args.profile, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
