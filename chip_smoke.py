#!/usr/bin/env python3
"""Drive the PyTorch port's transmit and receive main paths, its capture
conditioning front end, the chunk-parallel Viterbi, the wideband headend
(FDM mux and demux), `analyze`, the streams' checkpoints and operations,
the SoapySDR sink and source (against a fake SoapySDR module: no radio),
the receiver measurement tools, the two kernel-design probes, and the
multi-device encode and decode (meshes of shards on the one card, and two
processes over gloo), once on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:

1. device: name, compute capability (must be 9.0), nvidia-smi's name and
   power limit; TF32 is switched off for matmul and cuDNN.
2. build: nvcc builds csrc/offset_fir.cu, eq_fir.cu, viterbi_acs.cu,
   trellis_fused.cu and fir_variants.cu from this checkout, all at once;
   seconds and ptxas' resource lines; the RRC taps load on the chosen card.
   After that and after each wrapper's first launches (phases 3, 7, 12, 17
   and 18) the current CUDA device must still be the chosen one.
3. kernel: offset_fir_fused against its plain PyTorch twin on the card at
   B=4, 1 and 3 (random symbols plus golden field 0): cf32 <= 2e-6,
   cs16/cs8 planar and wire <= 1 LSB over the valid [0, 260416); a field
   one byte off a 4-byte boundary gives the aligned field's IQ exactly.
4. golden: Encoder(batch=1, device="cuda") over the 4 golden fields: IQ
   <= 5e-6, randomize/RS/interleave bytes exact, final phasor bit-exact,
   one kernel launch per field.
5. full size: Encoder(batch=384) for cf32, cs16 planar and cs8 wire: 3
   warm + 10 timed fields (CUDA events), channel 0 of the first timed
   field against the port's CPU path (<= 5e-6 / <= 1 LSB); then the
   kernel against the plain twin at B=384 cf32, both timed, and one
   F.conv1d over the modulated planes (fp32, TF32 off) as the yardstick.
6. cli: atsc_tpu_torch.cli.main on a 12-field TS file, 4 channels, cs8;
   then `cli decode` of that capture back to the TS (stats line checked).
7. eq_kernel: eq_fir_fused against its plain twin at B=4, fast and exact
   tiers, f32/cs16/cs8 windows, hard/soft/soft-code outputs, on a clean
   loopback window (the port's Encoder on golden input) and a random one:
   soft <= 1e-4 (fast) / 1e-5 (exact); hard identical on the clean window
   and, elsewhere, different only within 1e-4 of a decision boundary; a
   window off a 16-byte boundary gives the aligned window's levels.
8. golden_receive: IqReceiver(batch=1, device="cuda") decodes golden IQ to
   golden["input"][0:3] exactly, one kernel launch per equalized field;
   then the same through eq_profile="exact" (the 3 x TF32 exact tier).
9. receive_full: B=384 distinct random TS encoded on the card, field
   windows cut on the card, the composed eq + decode_field + derandomize
   step over 3 warm + 10 timed fields (CUDA events) for cf32, cs16 and
   cs8 windows at the fast profile, every channel's TS byte-exact; then
   the kernel against the plain twin in turns (fast, cf32), the exact tier
   once (with its fp32 bound and its tensor bound: the bytes, or 3 tf32
   products for each of the function's multiply-adds at 494.7 TFLOP/s; its
   bound is the lesser), and F.conv1d over the derotated planes as the
   yardstick.
10. noisy: B=8 AWGN loopback at 20 dB: the card's receiver returns the
   sent TS with RS firing; the card's Decoder and the CPU Decoder agree on
   codewords, n_errors and TS for the same noisy symbol fields.
11. receive_host: IqReceiver(batch=384, device="cuda"), the receiver's
   entry point, fed B=384 fields from host memory (cf32 by push, cs8 by
   push_codes): host wall ms per pushed field over 4 fields, every
   channel's TS byte-exact, one kernel launch per equalized field; and the
   oscillator span and one window's host-to-card copy timed alone.
12. viterbi_kernels: acs_forward (float32 and int8 obs), traceback,
   pr_acs_forward (segment-sync reset steps inside the span) and
   pr_traceback against their plain twins on the card, bit for bit, at
   B=384 and T=21,528 on real decommutated levels (the port's encoder, the
   equalizer, plus AWGN), each pass and its traceback also at 12 and 60
   lanes (acs_forward in both observation types); both tracebacks also on
   decision words built so that no two survivor chains ever merge, at
   B=384 and 12 lanes (timed as ms_unmerged); the chunked tracebacks' head
   lengths on the real decisions; each kernel timed (CUDA events) beside
   one run of its plain twin.
13. golden_soft: IqReceiver(batch=1, device="cuda") with trellis="soft",
   trellis="soft-i8" and ntsc="comb" decodes golden IQ to
   golden["input"][0:3] exactly, one launch of each kernel of its path per
   decoded field.
14. receive_full_soft: the soft (cf32 windows), soft-i8 (cs8) and NTSC
   comb (cf32) receive steps at B=384 (eq soft/soft codes ->
   soft_decode_field / ntsc_decode_field -> derandomize) over 3 warm + 10
   timed fields, every channel's TS byte-exact; ms/field, real-time
   channels, peak memory, and each stage of the step timed alone.
15. noisy_soft: B=8 at 15 dB IQ-domain SNR: the hard receiver leaves
   uncorrectable segments, soft and soft-i8 return the sent TS on every
   channel; the card's and the CPU's SoftDecoder agree on state (bytes, z2,
   metrics), codewords, n_errors and TS.
16. cci: B=8 with a co-channel tone at the comb null (0.5x signal RMS): the
   hard receiver leaves uncorrectable segments, ntsc="auto" engages on
   every channel and returns the sent TS; the card's and the CPU's
   NtscDecoder agree bit for bit on state (bytes, z2, metrics) and TS.
17. trellis_fused: tools/torch_trellis_fuse_probe.py's main at B=384 (its
   own path, launches counted); then the kernel against its plain twin in
   both layouts, whole arrays bit for bit, and the stream-order cut against
   trellis_encode_field, on random bytes (pad bytes too) and carries, at
   B=384, 1 and 23 (12 and 276 rows: the persistent grid's ragged edges);
   at B=384 the kernel per layout timed back to back and with the L2
   flushed before each launch, the twin and trellis_encode_field timed.
18. fir_variants: tools/torch_fir_probe.py's main at B=384 (launches
   counted); then each of the probe's seven (variant, nchunk) runs against
   run_variant_plain and against offset_fir_fused cf32, <= 2e-6 over the
   valid [0, 260416), on random symbols with golden field 0 in channel 0;
   each run timed, the twin once; the dense banded product's FLOP beside
   the tf32 FLOP the kernel executes (zero tap blocks skipped); its bound
   the lesser of phase 5's fp32 bound and the 3 x TF32 one.
19. erasures: B=8 with a 3,000-sample x6 impulse burst at N + 40,000 in
   every channel: zf alone leaves uncorrectable segments; erasures="burst"
   returns every TS exactly, hard and soft (the soft run launching
   acs_forward and traceback), with erasure-assisted segments in every
   channel; the card's Decoder with flags equals the CPU's (TS, n_errors,
   counters, carried flags).
20. adaptive: B=8 through multipath + complex gain: zf fails, adaptive,
   adaptive + soft and train_every=4 return every TS; at 20 dB AWGN over a
   multipath channel adaptive leaves uncorrectable segments and
   adaptive-dd none; backend="numpy" decodes golden IQ exactly; the card's
   AdaptiveEqualizer against the CPU's on the same windows (levels
   <= 2e-3 inside a field, taps <= 0.1, identical TS from both
   receivers); one `cli decode --equalizer adaptive --erasures burst
   --stats` of a multipath + burst capture.
21. full_adaptive: B=384 through a two-path channel, the adaptive receive
   step (train + solve + apply, hard -> decode_field -> derandomize) over
   3 warm + 10 timed fields for adaptive, train_every=4 and adaptive-dd,
   every channel's TS byte-exact; ms/field, real-time channels, peak
   memory, and each stage timed alone (derotate + windows, Gram, solve,
   apply, slice, decode; dd's Gram); one more field runs with
   torch.cuda.set_sync_debug_mode("error"): the equalizer never syncs.
22. full_erasures: B=384 zf with a burst in every field and channel, the
   erasure receive step (eq soft levels -> detector -> slice ->
   decode_field -> flag propagation -> RS erasure correction ->
   derandomize) over 3 warm + 10 timed fields, every channel's TS
   byte-exact; ms/field, channels, peak memory, each stage alone.

23. gauntlet: tests/test_gauntlet.py:22's capture (multipath with a complex
   gain, 400 Hz CFO, 25 ppm SRO, 24 dB AWGN, a 2,600-sample x4 burst, a
   cut at 77,777) through `cli decode --sro auto --cfo auto --trellis
   viterbi --erasures burst --stats` on the card: TS byte-exact, sro and cfo
   estimates, no uncorrectable segment, acs_forward and traceback once per
   field through the decoder; the same decode with --device cpu gives the
   same TS and summary (mer_db within 0.5 dB). Then tests/test_resync.py:86's
   tuner step (180 Hz + 35 Hz at field 6) through `--cfo track`: a retune,
   the fields the reference test checks exact.
24. rate: `cli encode --rate 20e6` of 48 seeded fields (one offset_fir_fused
   launch per field) and `cli decode --rate 20e6 --trellis viterbi` of the
   23.2 M-sample capture on the card, TS byte-exact from the first aligned
   field; host s per field and the real-time factor of both; the same
   decode with `--viterbi-chunks 24` gives the exact decode's TS
   (launching only the chunked kernels), its real-time factor beside the
   exact one. Then StreamResampler on the card against the CPU on the
   first 2 M capture samples (<= 1e-6) and under two chunkings
   (bit-identical), and one 65,536-output block timed on the card (ms per
   field of output, Msps).
25. resync_full: IqReceiver(batch=384, backend="adaptive", resync="auto")
   over tests/test_resync.py:26's 9 fields with a complex gain per channel
   and one common 7,019-sample slip, built on the card field by field and
   pushed from host memory in 100,003-sample chunks: one resync onto a true
   post-slip boundary with its parity, pre-slip fields and the re-locked
   tail byte-exact on every channel; host ms per pushed field, the
   re-acquisition's time, peak device memory.
26. viterbi_chunked: the chunked instantiations of the four Viterbi
   kernels (`--viterbi-chunks`) against their plain twins on the card, bit
   for bit, at B=384 and B=1 for C = 2, 8, 24 and 92 chunks (every window
   length mod 4): float32 and int8 4-state passes, the PR pass with its
   reset steps, both tracebacks; each timed beside its bound (the
   function's own bytes: the unchunked obs read once) and one run of its
   twin. The soft, soft-i8 and NTSC decode steps at B=384 and B=1, exact
   against every C, ms per field: each configuration timed in rounds, in
   turns with the others, the median of the round means and their spread,
   and the host's time to issue a step (one C=24 step launches each
   kernel of its path once, no other); B=8 at
   14 dB through IqReceiver: chunked TS equal to the exact TS, the soft
   tier's the sent TS.
27. headend: `cli encode --channels 23 --mux` of 8 seeded fields (one TS
   file per channel: UHF channels 14-36, 138 MHz at 138 MS/s) and `cli
   decode --demux 23 --trellis viterbi --viterbi-chunks 24 -o
   'slot{ch}.ts'`: every slot's TS byte-exact, no uncorrectable segment,
   the decode launching only the chunked 4-state kernels (once a field);
   host real-time factors (on the wall clock of the whole run, start-up
   included, and in the steady state: the encode's mean step, the decode's
   host time per field beyond a `--max-fields 3` run), peak device
   memory, and mux_blocks /
   demux_blocks of one field at B=23 timed by CUDA events. Then B=4
   `--mux --rate 30.72e6` -> `--demux 4 --rate 30.72e6`: the TS from
   field 1.
28. analyze: `cli analyze` of one clean channel (--fields 4): the zf MER
   through one eq_fir_fused launch, > 30 dB, no decode flags; of an
   impaired channel (a cut at 77,777 samples, 25 ppm, 400 Hz, a two-path
   channel, 25 dB AWGN): its sro/cfo readings, and its decode_flags fed to
   `cli decode` give the sent TS; of phase 27's B=23 multiplex through
   `--demux 23 --fields 3`: 23 slot reports, and the band flags decode
   every slot to the sent TS. The seconds of each run.
29. state and operations: a B=384 cs8 `cli encode` stopped after field 3
   with --checkpoint and resumed gives the bytes of an uninterrupted
   6-field run (one offset_fir_fused launch a field), and phase 27's
   `encode --mux` at B=23 the same; IqReceiver at B=384 (soft exact and
   C=24, NTSC comb, all three from cs8 codes, and adaptive
   train_every=4 through a two-path channel) saved after two decoded
   fields and reloaded gives the unbroken run's TS, the resumed runs
   launching their Viterbi kernels on the card; `decode --demux 23
   --checkpoint` stopped at 3 fields and resumed gives phase 28's band TS;
   the checkpoints' save/load ms and bytes on disk at B=384; `--profile`
   writes a torch.profiler trace naming offset_fir_fused's CUDA kernel
   (one event a field); `--realtime` on 8 cs8 fields takes at least 95 %
   of their 193.6 ms of air and writes the unpaced run's bytes;
   SupervisedEncoder at B=384 catches a NaN put in its phasor, rolls back
   and recovers bit for bit.
30. sdr_sink: a fake `SoapySDR` module in sys.modules (its TX device
   records its settings and a sha256 of every buffer written); `cli encode
   -o soapy -d fake -f 473e6 -g 54` of a 6-field B=1 TS in cf32 and cs8:
   the device's bytes are the same run's `-o file` bytes, the device at
   the symbol rate and 6 MHz; phase 27's B=23 `--mux` band: 138 MS/s, 138
   MHz of bandwidth, phase 27's multiplex bytes; one offset_fir_fused
   launch a field.
31. sdr_source: the fake RX device serves phase 30's cf32 capture (4
   hiccups, then one 600-sample overflow drop, buffers timestamped) to
   `decode soapy --stats`: the sent TS (the fields the zero-filled span may
   touch excepted), overflows / gaps_filled / gap_samples as injected, one
   eq_fir_fused launch a field; phase 27's band to `decode soapy --demux 23
   --trellis viterbi --viterbi-chunks 24`: every slot's TS, the chunked
   4-state kernels once a field; the capture to `analyze soapy`: zf MER,
   no flags.
32. tools: tools/torch_chip_gauntlet.py's main in this process: its 7
   probes all ok, each with its kernel launches (the probe's kernels each
   launched); tools/torch_rx_threshold.py `--fields 2 --modes hard,soft
   --snrs 20,14,12`: the TS exact at 20 dB hard and 14 dB soft.
33. sharded_encode: ShardedEncoder at B=384 on a 2x2 mesh of four shards
   on the one card, 2 fields a shard (4 a step), cf32 and cs8: bit-exact
   to the sequential Encoder on the card over the same 4 fields, IQ and
   state; ms a step beside the sequential 4 fields (CUDA events), peak
   memory, 4 offset_fir_fused launches a step.
34. sharded_receive: ShardedReceiver at B=384 over phase 33's IQ, zf
   with hard, soft, soft-i8 and NTSC, and adaptive, on the 2x2 mesh and on
   a 1x1 mesh (one shard, the sequential chain): the TS exact on every
   channel; ms a step (CUDA events; 4 shards on one card, not a scaling
   figure) and each kernel's launches (a field of each channel shard).
35. sample_sharded: SampleShardedFilter over 4 shards on the card:
   golden's 4 fields within 5e-6 of golden's IQ.
36. mesh_cli: cli.main `encode --mesh 2x2` of a 4-channel cs8 stream (the
   plain encode's bytes, the placement in --stats) and `decode --mesh 2x2
   --checkpoint` of it, stopped at --max-fields and resumed (the plain
   decode's TS, the sent TS).
37. two_process_tools: two processes each of
   tools/torch_distributed_encode.py and torch_distributed_decode.py,
   two shards each on the one card, `--backend gloo` named and printed
   (NCCL refuses two ranks on one card): every channel's IQ the
   sequential Encoder's bytes, the decoded TS the sent TS.

Then the kernels line (offset_fir_fused, eq_fir_fused and the four
Viterbi kernels also carry `design`, a string fixed here beside the
sources' constants; eq_fir_fused its fast tier's soft-level error at B=4
and B=384; the four Viterbi kernels a `chunked` entry: the chunked
instantiation's launches on the main paths that run it (phase 24's
`--viterbi-chunks` decode, phase 26's IqReceiver decodes, phase 27's
`--demux` decode, the counts zeroed before each and read after; and every
launch in phases 28-32) and, per chunk count, its ms, bound and error at
B=384 and B=1; every kernel also `launches_phases_28_29`: every count zeroed
just before phase 28 and read just after phase 29, so each of its launches in
them counts, set-up encodes included; and `launches_phases_30_32` and
`launches_phases_33_37`, counted the same way over phases 30-32 and 33-37:
the two-process tools' own launches stay in their processes), and last
{"ok": true,
"device": {...}}. Without a
CUDA device, or without the package beside this script, it fails before
printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B_FULL = 384        # channels of a headend batch: the middle of bench.py's grid
WARM, TIMED = 3, 10
B_NOISY = 8
HOST_FIELDS = 4     # fields timed through IqReceiver at B_FULL
NOISY_SNR_DB = 20.0  # IQ-domain AWGN: hard decisions err, RS corrects all
NOISY_SOFT_SNR_DB = 15.0  # hard slicing leaves uncorrectable segments, soft does not
KERNEL_LEVEL_SIGMA = 0.5  # level-domain AWGN under the Viterbi kernel comparisons
# the impulse burst of tests/test_receiver.py: BURST_LEN samples of
# complex Gaussian noise x BURST_SCALE, BURST_AT samples into a field
BURST_AT, BURST_LEN, BURST_SCALE = 40_000, 3000, 6.0
# float ops of one trellis step and lane: 4-state (8 sub, 8 mul, 4 min, 8
# add, 4 select), PR (8 sub, 64 add, 64 mul, 64 add, 48 min)
ACS_FLOPS, PR_FLOPS = 32, 248
# the designs of the two redesigned kernels, as their sources fix them
FIR_DESIGN = "R=8 register window, 128 threads per block"   # csrc/offset_fir.cu
PR_DESIGN = "state-parallel S=16, 32 threads per block"     # csrc/viterbi_acs.cu
ACS_DESIGN = ("state-parallel butterfly S=2, 32 threads per block, "
              "float32 obs prefetched 2 groups ahead into L2")  # csrc/viterbi_acs.cu
TB_DESIGN = ("chunk-parallel: 16 chunks of whole groups per lane, a thread per (lane, chunk), "
             "4 entry chains to the merge, entry states resolved in shared memory, heads "
             "retraced")  # csrc/viterbi_acs.cu
PR_TB_DESIGN = ("chunk-parallel: 8 chunks of whole groups per lane, a thread per (lane, chunk), "
                "16 entry chains (prmt gathers) to the merge, entry states resolved in shared "
                "memory, heads retraced")  # csrc/viterbi_acs.cu
# the chunked kernels (csrc/viterbi_acs.cu, the *_chunked kernels): a thread
# per (lane, chunk), all states in registers, per-step renormalization,
# windows read from the unchunked obs
CHUNKED_DESIGN = {
    "acs_forward": "blocks of one warp; padded word peeled, 16-step groups of obs one group "
                   "ahead in registers, no bounds test in the loop; decision bytes from "
                   "masks",
    "traceback": "blocks of one warp; output words in stream order, each one funnel shift of "
                 "two decision words and one 4-step chain on doubled states, 8 words in "
                 "flight, whole-word stores, kept-region boundary words byte by byte",
    "pr_acs_forward": "64 threads per block; T threads a chunk-lane chosen from C L (4 up to "
                      "9,216 chunk-lanes, 2 up to 65,536, then 1), the 16 states split by s2 "
                      "into groups of 4 (T=2: 5 xor shuffles a step, T=4: 10 shuffles); obs "
                      "and rc of 2T-step groups one group ahead in registers; a warp-uniform "
                      "no-reset path; the pick and pair compares as FADD sign bits gathered "
                      "by funnel shifts",
    "pr_traceback": "64 threads per block; output words in stream order, each a 4-step chain, "
                    "32 decision words in flight through a cp.async ring in shared memory, "
                    "whole-word stores, kept-region boundary words byte by byte",
}
EQ_DESIGN = ("fast: mma.sync.m16n8k16 bf16 bands of 16, B operands in registers, "
             "4096 outputs x 16 channels per block of 4 warps (4 tiles each), "
             "float32 chunks of 2 bands; exact: 3 x TF32 mma.sync.m16n8k8 bands of 32, "
             "hi/lo rows by ldmatrix, tap blocks from a 1-D hi/lo array in shared memory, "
             "4096 outputs per block of 4 warps (2 tiles each, held across the band loop), "
             "hi*hi and cross products in two accumulators, Kahan chunks of 4 k-steps")
# csrc/eq_fir.cu
FIR_VARIANTS_DESIGN = ("3 x TF32 mma.sync.m16n8k8, the k-steps of zero tap blocks skipped (15 of "
                       "32 per n-tile), a sliding window of 4 hi/lo tap blocks from shared "
                       "memory, 4 warps of 16 rows x 4 n-tiles, raw rows of the next 16-row "
                       "tile by cp.async, 3 blocks an SM (2 with separate modulation)")
# csrc/fir_variants.cu
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, the published peaks
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494.7e12    # dense, the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def timed(fn, reps: int = 10) -> float:
    """Mean device ms of fn() over reps back-to-back calls, after one."""
    return timed_with_host(fn, reps)[0]


def timed_with_host(fn, reps: int = 10) -> tuple[float, float]:
    """(mean device ms, mean host ms to issue one call) of fn() over reps
    back-to-back calls, after one: the host clock stops when the last call
    returns, before any wait for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host


def device_kept(dev, after: str) -> None:
    """Fails unless dev is still the current CUDA device: no kernel entry
    point or tap load may move it (on one card this cannot fail; with more
    it would show a leak)."""
    import torch

    check(torch.cuda.current_device() == dev.index,
          f"the current CUDA device moved to {torch.cuda.current_device()} after {after}")


def csrc_constant(source: str, name: str) -> int:
    """constexpr int `name` of atsc_tpu_torch/csrc/`source`."""
    with open(os.path.join(REPO, "atsc_tpu_torch", "csrc", source)) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);", fh.read()).group(1))


def bound_ms(nbytes: float, flops: float, flop_rate: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "atsc_tpu_torch")):
        fail(f"no atsc_tpu_torch package beside {os.path.basename(__file__)}")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")

    from atsc_tpu_torch import cli
    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
    from atsc_tpu_torch.ops import (
        apply_pilot_offset,
        field_levels,
        interleave_field_enc_major,
        randomize_field,
        rs_encode_field,
    )
    from atsc_tpu_torch.ops.cuda import _build
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk
    from atsc_tpu_torch.ops.cuda import fir_variants as fvk
    from atsc_tpu_torch.ops.cuda import offset_fir as fir
    from atsc_tpu_torch.ops.cuda import trellis_fused as tfk
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk
    from atsc_tpu_torch.ops.quantize import unpack_wire
    from atsc_tpu_torch.tables.oscillator import phasor_for_field
    from atsc_tpu_torch.tables.rrc import rrc_taps

    n_valid = P.SYMBOLS_PER_FIELD
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    golden = np.load(os.path.join(REPO, "tests", "golden", "golden.npz"))

    # -- 1. device -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=name, capability=list(cap),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    check(cap == (9, 0), f"compute capability {cap}, the kernels are built for sm_90a")

    # -- 2. build: one nvcc per source, all started together -------------------
    t0 = time.perf_counter()
    sources = ("offset_fir", "eq_fir", "viterbi_acs", "trellis_fused", "fir_variants")
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {k: pool.submit(_build.build, k) for k in sources}
        builds = {k: f.result() for k, f in futures.items()}
    fir._kernel_lib(dev.index)   # loads the RRC taps on dev
    eqk._kernel_lib(dev.index)
    vk._kernel_lib(dev.index)
    tfk._kernel_lib()
    fvk._kernel_lib()
    wall = time.perf_counter() - t0
    device_kept(dev, "the tap load")
    for kname, built in builds.items():
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=kname, seconds=round(wall, 3),
             nvcc_seconds=round(built.seconds, 3), reused=built.seconds == 0.0,
             library=os.path.relpath(built.path, REPO), ptxas=ptxas)

    # -- 3. kernel against plain on the card ----------------------------------
    def code_err(got: torch.Tensor, want: torch.Tensor, fmt: str, wire: bool) -> int:
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if wire:
            g, w = unpack_wire(g, fmt), unpack_wire(w, fmt)
        return int(np.abs(g[..., :n_valid].astype(np.int32)
                          - w[..., :n_valid].astype(np.int32)).max())

    rng = np.random.default_rng(2024)
    sym = rng.integers(0, 8, size=(4, P.PADDED_SYMBOLS), dtype=np.int8)
    levels0 = golden["sync"][0].real.astype(np.float32)
    sym[0] = np.rint((levels0 - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    sym[0, P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS:] = 0
    ph = np.array([[np.float32(z.real), np.float32(z.imag)]
                   for z in map(phasor_for_field, (0, 1, 7, 4096))], np.float32)
    field = torch.tensor(sym, device=dev)
    phasor = torch.tensor(ph, device=dev)
    errs = {}
    for b in (4, 1, 3):  # and B=1, B=3: a grid of one and of three channels
        for fmt, wire in (("cf32", False), ("cs16", False), ("cs8", False),
                          ("cs16", True), ("cs8", True)):
            got = fir.offset_fir_fused(field[:b], phasor[:b], out_format=fmt, wire=wire)
            want = fir.offset_fir_plain(field[:b], phasor[:b], out_format=fmt, wire=wire)
            torch.cuda.synchronize()
            shape, dtype = fir.output_spec(b, fmt, wire)
            check(tuple(got.shape) == shape and got.dtype == dtype,
                  f"B={b} {fmt} wire={wire}: kernel output {tuple(got.shape)} {got.dtype}")
            key = fmt + ("_wire" if wire else "")
            if fmt == "cf32":
                err = float((got[..., :n_valid] - want[..., :n_valid]).abs().max())
                check(err <= 2e-6, f"B={b} cf32 kernel vs plain {err} > 2e-6")
            else:
                err = code_err(got, want, fmt, wire)
                check(err <= 1, f"B={b} {key} kernel vs plain {err} LSB > 1")
            errs[key] = max(errs.get(key, 0), err)
    # a field one byte into its storage (not 4-byte aligned) gives the same IQ
    buf = torch.empty(P.PADDED_SYMBOLS + 1, dtype=torch.int8, device=dev)
    buf[1:] = field[0]
    misaligned_same = torch.equal(fir.offset_fir_fused(buf[1:].view(1, -1), phasor[:1]),
                                  fir.offset_fir_fused(field[:1], phasor[:1]))
    check(misaligned_same, "a field off a 4-byte boundary gives other IQ")
    device_kept(dev, "offset_fir_fused")
    emit("kernel", batch=[4, 1, 3], design=FIR_DESIGN, max_abs_err_cf32=errs["cf32"],
         max_lsb_err={k: v for k, v in errs.items() if k != "cf32"},
         misaligned_field_identical=misaligned_same,
         tolerance={"cf32": 2e-6, "codes_lsb": 1})

    # -- 4. golden through the encoder on the card ----------------------------
    prev = torch.zeros((1, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev)
    for f in range(4):
        rand = randomize_field(torch.tensor(golden["input"][f][None], device=dev))
        rs = rs_encode_field(rand).reshape(1, -1)
        il = interleave_field_enc_major(rs, prev)
        il_golden = golden["il"][f].reshape(
            P.TRELLIS_ROUNDS, P.TRELLIS_ENCODERS, P.TRELLIS_INPUT_BYTES
        ).transpose(1, 0, 2).reshape(P.TRELLIS_ENCODERS, -1)
        check(np.array_equal(rand.cpu().numpy().reshape(-1), golden["rand"][f]),
              f"randomize bytes differ from golden, field {f}")
        check(np.array_equal(rs.cpu().numpy()[0], golden["rs"][f]),
              f"RS bytes differ from golden, field {f}")
        check(np.array_equal(il.cpu().numpy()[0], il_golden),
              f"interleave bytes differ from golden, field {f}")
        prev = rs
    fir.LAUNCHES = 0
    enc = Encoder(batch=1, device=dev)
    iq_err = 0.0
    for f in range(4):
        iq = enc.encode(golden["input"][f][None])
        iq_err = max(iq_err, float(np.abs(iq_to_complex(iq)[0] - golden["iq"][f]).max()))
    launches_golden = fir.LAUNCHES
    z4 = phasor_for_field(4)
    got_ph = enc.state.phasor.cpu().numpy()[0]
    phasor_exact = bool(got_ph[0] == np.float32(z4.real)
                        and got_ph[1] == np.float32(z4.imag))
    emit("golden", fields=4, max_abs_err_iq=iq_err, tolerance=5e-6,
         stage_bytes_exact=True, phasor_bit_exact=phasor_exact,
         launches=launches_golden)
    check(iq_err <= 5e-6, f"golden IQ error {iq_err} > 5e-6")
    check(phasor_exact, f"phasor after 4 fields {got_ph} != phasor_for_field(4)")
    check(launches_golden == 4, f"{launches_golden} kernel launches for 4 fields")

    # -- 5. full size --------------------------------------------------------
    n_fields = WARM + TIMED
    ts_np = rng.integers(0, 256, size=(n_fields, B_FULL, P.FIELD_TS_BYTES),
                         dtype=np.uint8)
    ts_np[..., ::P.MPEG2_BYTES] = 0x47
    ts_dev = torch.tensor(ts_np, device=dev)
    full = {}
    fir.LAUNCHES = 0
    for fmt, wire in (("cf32", False), ("cs16", False), ("cs8", True)):
        key = fmt + ("_wire" if wire else "")
        enc = Encoder(batch=B_FULL, out_format=fmt, wire=wire, device=dev)
        for f in range(WARM):
            enc.encode(ts_dev[f])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        launches0 = fir.LAUNCHES
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        first = enc.encode(ts_dev[WARM])
        for f in range(WARM + 1, n_fields):
            enc.encode(ts_dev[f])
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / TIMED
        peak = torch.cuda.max_memory_allocated(dev)
        dlaunch = fir.LAUNCHES - launches0
        got0 = first[0].cpu().numpy()
        del first, enc
        ref = Encoder(batch=1, out_format=fmt, wire=wire, device="cpu")
        for f in range(WARM + 1):
            want0 = ref.encode(ts_np[f, :1])[0].numpy()
        if fmt == "cf32":
            err = float(np.abs(got0[..., :n_valid] - want0[..., :n_valid]).max())
            check(err <= 5e-6, f"B={B_FULL} cf32 channel 0 vs CPU: {err} > 5e-6")
        else:
            g, w = (unpack_wire(got0, fmt), unpack_wire(want0, fmt)) if wire else (got0, want0)
            err = int(np.abs(g[..., :n_valid].astype(np.int32)
                             - w[..., :n_valid].astype(np.int32)).max())
            check(err <= 1, f"B={B_FULL} {key} channel 0 vs CPU: {err} LSB > 1")
        t_field = ms / 1e3
        full[key] = {
            "ms_per_field": ms,
            "samples_per_s": B_FULL * n_valid / t_field,
            "realtime_channels": B_FULL / (t_field * P.FIELD_RATE),
            "max_memory_allocated": peak,
            "launches": dlaunch,
            "err_vs_cpu": err,
        }
        emit("full_size", batch=B_FULL, format=key, timed_fields=TIMED, **full[key])
        check(dlaunch == TIMED, f"{dlaunch} kernel launches for {TIMED} fields")
    launches_main = fir.LAUNCHES
    check(launches_main == 3 * n_fields,
          f"{launches_main} kernel launches for {3 * n_fields} encoded fields")
    del ts_dev

    # the kernel against the plain twin at B=384 cf32, in turns, and one
    # cuDNN conv1d over the modulated planes (fp32, TF32 off) as the yardstick
    sym_full = torch.randint(0, 8, (B_FULL, P.PADDED_SYMBOLS), dtype=torch.int8,
                             device=dev, generator=torch.Generator(dev).manual_seed(7))
    ph_full = phasor[torch.arange(B_FULL, device=dev) % 4].contiguous()

    run_kernel = lambda: fir.offset_fir_fused(sym_full, ph_full)  # noqa: E731
    run_plain = lambda: fir.offset_fir_plain(sym_full, ph_full)   # noqa: E731
    p1, k1, k2, p2 = timed(run_plain), timed(run_kernel), timed(run_kernel), timed(run_plain)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    err_full = float((run_kernel()[..., :n_valid] - run_plain()[..., :n_valid]).abs().max())
    modulated = apply_pilot_offset(field_levels(sym_full), ph_full)[0].reshape(
        2 * B_FULL, 1, P.PADDED_SYMBOLS)
    taps = torch.tensor(rrc_taps()[: P.RRC_NTAPS].copy(), device=dev).reshape(1, 1, -1)
    fir_conv_ms = timed(lambda: torch.nn.functional.conv1d(modulated, taps))
    del modulated
    # the valid work only: 260,416 outputs per channel, each reading 111
    # symbols (padding is neither read nor computed in the bound)
    fir_span = n_valid + P.RRC_NTAPS - 1
    fir_bytes = B_FULL * fir_span + 2 * 4 * fir_span + B_FULL * 2 * 4 + B_FULL * 2 * n_valid * 4
    fir_flop = B_FULL * n_valid * 2 * P.RRC_NTAPS * 2
    fir_bound, fir_bound_by = bound_ms(fir_bytes, fir_flop, FP32_FLOP_PER_S)
    emit("kernel_vs_plain", batch=B_FULL, format="cf32", kernel_ms=[k1, k2],
         plain_ms=[p1, p2], library_ms=fir_conv_ms, library="F.conv1d fp32",
         bound_ms=fir_bound, bound_by=fir_bound_by, max_abs_err=err_full)
    check(err_full <= 2e-6, f"B={B_FULL} cf32 kernel vs plain {err_full} > 2e-6")
    del sym_full

    # -- 6. the CLI, in process: encode, then decode what it wrote ------------
    cli_fields, cli_channels = 12, 4
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        ts_path = os.path.join(tmp, "in.ts")
        out_path = os.path.join(tmp, "out.cs8")
        ts_cli = np.random.default_rng(5).integers(
            0, 256, size=(cli_fields, P.FIELD_TS_BYTES), dtype=np.uint8)
        ts_cli[:, ::P.MPEG2_BYTES] = 0x47
        ts_cli.tofile(ts_path)
        fir.LAUNCHES = 0
        err_buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err_buf):
            rc = cli.main([ts_path, "--channels", str(cli_channels), "--format",
                           "cs8", "-o", out_path, "--stats"])
        wall = time.perf_counter() - t0
        launches_cli = fir.LAUNCHES
        stats = json.loads(err_buf.getvalue().strip().splitlines()[-1])
        size = os.path.getsize(out_path)
        out = np.fromfile(out_path, dtype=np.int16, count=n_valid)  # field 0, ch 0
        want_size = cli_fields * cli_channels * n_valid * 2
        ref = Encoder(batch=1, out_format="cs8", wire=True, device="cpu")
        want = ref.encode(ts_cli[:1])[0].numpy()[:n_valid]
        cli_err = int(np.abs(unpack_wire(out, "cs8").astype(np.int32)
                             - unpack_wire(want, "cs8").astype(np.int32)).max())
        emit("cli", rc=rc, bytes=size, expected_bytes=want_size, wall_s=wall,
             launches=launches_cli, err_vs_cpu_lsb=cli_err, stats=stats)
        check(rc == 0, f"cli.main returned {rc}")
        check(size == want_size, f"CLI wrote {size} bytes, expected {want_size}")
        check(stats["fields"] == cli_fields * cli_channels and stats["ts_sync_errors"] == 0
              and stats["device"] == str(dev), f"CLI stats line {stats}")
        check(launches_cli == cli_fields, f"{launches_cli} launches for {cli_fields} CLI fields")
        check(cli_err <= 1, f"CLI output vs CPU encoder: {cli_err} LSB > 1")

        back_path = os.path.join(tmp, "back.ts")
        eqk.LAUNCHES = 0
        err_buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err_buf):
            rc = cli.main(["decode", out_path, "--channels", str(cli_channels),
                           "--format", "cs8", "-o", back_path, "--stats"])
        wall = time.perf_counter() - t0
        launches_dec = eqk.LAUNCHES
        dstats = json.loads(err_buf.getvalue().strip().splitlines()[-1])
        back = np.fromfile(back_path, dtype=np.uint8).reshape(-1, cli_channels,
                                                               P.FIELD_TS_BYTES)
    n_back = cli_fields - 1  # the interleaver keeps the last field
    emit("cli_decode", rc=rc, fields=int(back.shape[0]), wall_s=wall,
         launches=launches_dec, stats=dstats)
    check(rc == 0, f"cli.main decode returned {rc}")
    check(back.shape[0] == n_back and all(
        np.array_equal(back[k, c], ts_cli[k]) for k in range(n_back)
        for c in range(cli_channels)), "CLI decode TS != the encoded TS")
    check(dstats["fields_decoded"] == n_back and dstats["segments_uncorrectable"] == 0
          and dstats["device"] == str(dev) and len(dstats["mer_db"]) == cli_channels
          and min(dstats["mer_db"]) > 30, f"CLI decode stats line {dstats}")
    check(launches_dec == cli_fields, f"{launches_dec} eq launches for {cli_fields} fields")

    # -- 7-10. the receive path -------------------------------------------------
    eq_err = receive_kernel_vs_plain(golden, dev)
    device_kept(dev, "eq_fir_fused")
    exact_launches = receive_golden(golden, dev)
    rx = receive_full_size(dev)
    receive_noisy(dev)
    receive_host_path(dev)

    # -- 12-16. the soft and NTSC trellis tiers --------------------------------
    vit = viterbi_kernels(dev)
    device_kept(dev, "the Viterbi kernels")
    receive_golden_soft(golden, dev)
    vit_launches = receive_full_soft(dev)
    receive_noisy_soft(dev)
    receive_cci(dev)

    # -- 17-18. the probe paths: neither kernel is on a main path above -------
    main_path = {"trellis_fused": tfk.LAUNCHES, "fir_variants": fvk.LAUNCHES}
    trellis = trellis_fused_kernel(dev)
    device_kept(dev, "trellis_fused")
    variants = fir_variants_kernel(
        golden, dev, {"bound_ms": fir_bound, "bound_by": fir_bound_by,
                      "library_ms": fir_conv_ms, "library": "F.conv1d fp32"},
        fir_bytes, fir_flop)
    device_kept(dev, "run_variant")

    # -- 19-22. the erasure tier and the trained equalizers --------------------
    receive_erasures(dev)
    receive_adaptive(golden, dev)
    full_adaptive(dev)
    full_erasures(dev)

    # -- 23-25. the capture conditioning front end ----------------------------
    gauntlet(dev)
    rate_launches = rate(dev)
    resync_full(dev)

    # -- 26-27. the chunk-parallel Viterbi and the wideband headend -----------
    chunked = viterbi_chunked(dev)
    device_kept(dev, "the chunked Viterbi kernels")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as band_dir:
        head = headend(dev, band_dir)
        for runs in (rate_launches, head["launches"]):   # the main paths' chunked launches
            for k, v in runs.items():
                chunked["launches"][k] += v

        # -- 28-29. analyze, and the stream's state and operations ----------
        # (every count zeroed before phase 28 and read after phase 29: each
        # launch in them, set-up encodes included, counts)
        _zero_every_count()
        analyze_card(dev, head["band"], band_dir)
        state_ops(dev, head["band"], band_dir)
        slice_launches = _every_count()

        # -- 30-32. the SDR sink and source, and the measurement tools --------
        # (counted as phases 28-29 are)
        _zero_every_count()
        capture = sdr_sink(dev, head["band"], band_dir)
        sdr_source(dev, head["band"], band_dir, capture)
        measurement_tools(dev)
        sdr_launches = _every_count()

        # -- 33-37. multi-device encode and decode: 4 shards on the one card,
        # and two processes of each multi-process tool (counted as 28-29 are;
        # the tools' own processes count in theirs)
        _zero_every_count()
        enc33 = sharded_encode(dev)
        sharded_receive(dev, enc33)
        del enc33
        sample_sharded(golden, dev)
        mesh_cli(dev, band_dir)
        two_process_tools(dev, band_dir)
        mesh_launches = _every_count()
    for k in chunked["launches"]:
        chunked["launches"][k] += slice_launches[k] + sdr_launches[k] + mesh_launches[k]

    print(json.dumps({"kernels": [
        {
            "name": "offset_fir_fused",
            "route": "cuda",
            "source": "atsc_tpu_torch/csrc/offset_fir.cu",
            "replaces": "atsc_tpu/ops/pallas/offset_fir.py:148",
            "design": FIR_DESIGN,
            "launches": launches_main,
            "launches_phases_28_29": slice_launches["offset_fir_fused"],
            "launches_phases_30_32": sdr_launches["offset_fir_fused"],
            "launches_phases_33_37": mesh_launches["offset_fir_fused"],
            "max_abs_err": errs["cf32"],
            "max_lsb_err": {k: v for k, v in errs.items() if k != "cf32"},
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": fir_bound,
            "bound_by": fir_bound_by,
            "library_ms": fir_conv_ms,
        },
        {
            "name": "eq_fir_fused",
            "route": "cuda",
            "source": "atsc_tpu_torch/csrc/eq_fir.cu",
            "replaces": "atsc_tpu/ops/pallas/eq_fir.py:137",
            "design": EQ_DESIGN,
            "launches": rx["launches"],
            "launches_phases_28_29": slice_launches["eq_fir_fused"],
            "launches_phases_30_32": sdr_launches["eq_fir_fused"],
            "launches_phases_33_37": mesh_launches["eq_fir_fused"],
            "max_abs_err": rx["max_abs_err"],
            "max_abs_err_b4": eq_err,
            "ms": rx["kernel_ms"],
            "plain_ms": rx["plain_ms"],
            "bound_ms": rx["bound_ms"],
            "bound_by": rx["bound_by"],
            "library_ms": rx["library_ms"],
            "exact": {"launches": exact_launches, **rx["exact"]},
        },
        *({"name": k, "route": "cuda", "source": "atsc_tpu_torch/csrc/viterbi_acs.cu",
           "replaces": f"atsc_tpu/ops/pallas/viterbi_acs.py:{line}",
           "launches": vit_launches[k], **vit[k], "library_ms": None,
           "launches_phases_28_29": slice_launches[k],
           "launches_phases_30_32": sdr_launches[k],
           "launches_phases_33_37": mesh_launches[k],
           "chunked": {"launches": chunked["launches"][k + "_chunked"],
                       "design": CHUNKED_DESIGN[k], "per_chunks": chunked["per"][k]}}
          for k, line in (("acs_forward", 157), ("traceback", 189),
                          ("pr_acs_forward", 344), ("pr_traceback", 375))),
        {"name": "trellis_fused", "route": "cuda",
         "source": "atsc_tpu_torch/csrc/trellis_fused.cu",
         "replaces": "tools/trellis_fuse_probe.py:122",
         "main_path_launches": main_path["trellis_fused"],
         "launches_phases_28_29": slice_launches["trellis_fused"],
         "launches_phases_30_32": sdr_launches["trellis_fused"],
         "launches_phases_33_37": mesh_launches["trellis_fused"], **trellis},
        {"name": "fir_variants", "route": "cuda",
         "source": "atsc_tpu_torch/csrc/fir_variants.cu",
         "replaces": "tools/fir_probe.py:132", "design": FIR_VARIANTS_DESIGN,
         "main_path_launches": main_path["fir_variants"],
         "launches_phases_28_29": slice_launches["fir_variants"],
         "launches_phases_30_32": sdr_launches["fir_variants"],
         "launches_phases_33_37": mesh_launches["fir_variants"], **variants},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def _codes_of(win, fmt: str):
    """Float windows -> the cs16/cs8 integer codes a capture would hold."""
    import torch

    from atsc_tpu_torch.ops.quantize import DTYPE, QMAX, quantize_scale

    q = float(QMAX[fmt])
    return torch.clamp(torch.round(win * quantize_scale(fmt)), -q, q).to(DTYPE[fmt])


def _window(stream, g0: int, eq_k: int):
    """(B, 2, WIN_LEN) window of a planar (B, 2, n) stream from stream sample
    g0 - eq_k, zero-filled outside the stream, cut on the stream's device."""
    import torch

    from atsc_tpu_torch.ops.cuda.eq_fir import WIN_LEN

    lo, hi = g0 - eq_k, g0 - eq_k + WIN_LEN
    a, b = max(lo, 0), min(hi, stream.shape[-1])
    out = torch.zeros(stream.shape[:-1] + (WIN_LEN,), dtype=stream.dtype,
                      device=stream.device)
    out[..., a - lo : b - lo] = stream[..., a:b]
    return out


def _near_boundary(x, tol: float):
    """Where x (decision units) lies within tol of a half-integer."""
    return (x - x.floor() - 0.5).abs() < tol


def _random_ts_dev(dev, n_fields: int, seed: int):
    """(n_fields, B_FULL, 58656) random TS with packet syncs, on the card."""
    import torch

    from atsc_tpu_torch import params as P

    gen = torch.Generator(dev).manual_seed(seed)
    ts = torch.randint(0, 256, (n_fields, B_FULL, P.FIELD_TS_BYTES), dtype=torch.uint8,
                       device=dev, generator=gen)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts


def _field_oscs(dev, n_fields: int, eq_k: int) -> list:
    """The oscillator span of each field's equalizer window, on the card."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.receiver import _osc_planar
    from atsc_tpu_torch.ops.cuda.eq_fir import WIN_LEN

    n = P.SYMBOLS_PER_FIELD
    return [torch.tensor(_osc_planar(k * n - eq_k, k * n - eq_k + WIN_LEN, 0), device=dev)
            for k in range(n_fields)]


def _loopback_windows(dev, ts, fmt: str, eq_k: int) -> list:
    """Encode ts (F, B, 58656) on the card in `fmt` and cut the equalizer
    window of each of the first F-1 fields on the card (the window reads
    K samples of the field before and the lookahead of the field after)."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.ops.cuda.eq_fir import WIN_LEN

    n = P.SYMBOLS_PER_FIELD
    enc = Encoder(batch=ts.shape[1], out_format=fmt, device=dev)
    fields = [enc.encode(ts[k])[..., :n] for k in range(ts.shape[0])]
    del enc
    wins = []
    for k in range(ts.shape[0] - 1):
        parts = [fields[k], fields[k + 1][..., : WIN_LEN - eq_k - n]]
        left = (fields[k - 1][..., n - eq_k :] if k else
                torch.zeros_like(fields[0][..., :eq_k]))
        wins.append(torch.cat([left, *parts], dim=-1))
    return wins


def receive_kernel_vs_plain(golden, dev) -> float:
    """Phase 7: eq_fir_fused against eq_fir_plain at B=4 on the card.
    Returns the largest soft-level error of the fast tier."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.models.receiver import EQ_PROFILES, _osc_planar
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_SCALE, quantize_scale

    n = P.SYMBOLS_PER_FIELD
    b = 4
    # a clean loopback stream: 3 fields of golden input, channel c starting
    # at golden field c, encoded on the card in each input format
    ts = np.stack([golden["input"][[(c + f) % 4 for c in range(b)]] for f in range(3)])
    streams = {}
    for fmt in ("cf32", "cs16", "cs8"):
        enc = Encoder(batch=b, out_format=fmt, device=dev)
        streams[fmt] = torch.cat([enc.encode(ts[f])[..., :n] for f in range(3)], dim=-1)
    gen = torch.Generator(dev).manual_seed(11)
    noise = 0.2 * torch.randn((b, 2, 3 * n), generator=gen, device=dev)
    tol = {"fast": 1e-4, "exact": 1e-5}
    worst = {"fast": 0.0, "exact": 0.0}
    mismatches = {}
    for tier in ("fast", "exact"):
        eq_k, exact = EQ_PROFILES[tier]
        osc = torch.tensor(_osc_planar(n - eq_k, n - eq_k + eqk.WIN_LEN, 0), device=dev)
        for fmt in ("cf32", "cs16", "cs8"):
            dq = 1.0 if fmt == "cf32" else 1.0 / quantize_scale(fmt)
            rand = noise if fmt == "cf32" else _codes_of(noise, fmt)
            for wname, stream in (("clean", streams[fmt]), ("random", rand)):
                win = _window(stream, n, eq_k)
                kw = dict(eq_k=eq_k, dequant=dq, exact=exact)
                soft_p = eqk.eq_fir_plain(win, osc, soft=True, **kw)
                soft_k = eqk.eq_fir_fused(win, osc, soft=True, **kw)
                err = float((soft_k - soft_p).abs().max())
                worst[tier] = max(worst[tier], err)
                check(err <= tol[tier], f"eq {tier} {fmt} {wname} soft {err} > {tol[tier]}")
                for mode, scale, bias in (("hard", 0.5, 5.75), ("codes", SOFT_LEVEL_SCALE, 0.0)):
                    soft_q = mode == "codes"
                    got = eqk.eq_fir_fused(win, osc, soft=soft_q, soft_q=soft_q, **kw)
                    want = eqk.eq_fir_plain(win, osc, soft=soft_q, soft_q=soft_q, **kw)
                    check(got.dtype == torch.int8 and tuple(got.shape) == (b, n),
                          f"eq {mode} output {tuple(got.shape)} {got.dtype}")
                    diff = got != want
                    near = _near_boundary((soft_p + bias) * scale, 1e-4 * scale)
                    key = f"{tier}_{fmt}_{wname}_{mode}"
                    mismatches[key] = int(diff.sum())
                    check(int((got.int() - want.int()).abs().max()) <= 1,
                          f"eq {key}: a code off by more than 1")
                    check(not bool((diff & ~near).any()),
                          f"eq {key}: mismatch away from a decision boundary")
                    if wname == "clean" and mode == "hard":
                        check(not bool(diff.any()), f"eq {key}: hard symbols differ")
    # a window one element into its storage (off a 16-byte boundary; the
    # wrapper copies it) gives the aligned window's levels exactly
    eq_k, _ = EQ_PROFILES["fast"]
    osc = torch.tensor(_osc_planar(n - eq_k, n - eq_k + eqk.WIN_LEN, 0), device=dev)
    win = _window(streams["cf32"], n, eq_k)
    buf = torch.empty(win.numel() + 1, dtype=win.dtype, device=dev)
    buf[1:] = win.reshape(-1)
    misaligned_same = torch.equal(eqk.eq_fir_fused(buf[1:].view(win.shape), osc, soft=True),
                                  eqk.eq_fir_fused(win, osc, soft=True))
    torch.cuda.synchronize()
    emit("eq_kernel", batch=b, max_abs_err_soft=worst, tolerance=tol,
         mismatches={k: v for k, v in mismatches.items() if v},
         misaligned_window_identical=misaligned_same)
    check(misaligned_same, "eq: a window off a 16-byte boundary gives other levels")
    return worst["fast"]


def receive_golden(golden, dev) -> int:
    """Phase 8: IqReceiver on the card decodes golden IQ exactly, through
    the fast and the exact profile. Returns the exact tier's launches."""
    import numpy as np

    from atsc_tpu_torch.models.receiver import IqReceiver
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk

    eqk.LAUNCHES = 0
    rx = IqReceiver(batch=1, device=dev)
    iq = golden["iq"][:4].reshape(1, -1)
    out = rx.push(iq[:, :400_000]) + rx.push(iq[:, 400_000:]) + rx.flush()
    launches = eqk.LAUNCHES
    exact = len(out) == 3 and all(
        np.array_equal(ts[0], golden["input"][k]) for k, (ts, _) in enumerate(out))
    emit("golden_receive", fields_in=4, fields_out=len(out), ts_exact=exact,
         launches=launches, segments_corrected=rx.decoder.segments_corrected)
    check(exact, "golden IQ did not decode to golden input[0:3] on the card")
    check(launches == 4, f"{launches} eq launches for 4 equalized fields")
    # the exact profile (the golden-regression tier) through the same entry point
    eqk.LAUNCHES = 0
    rx = IqReceiver(batch=1, device=dev, eq_profile="exact")
    out = rx.push(iq[:, :400_000]) + rx.push(iq[:, 400_000:]) + rx.flush()
    launches_x = eqk.LAUNCHES
    exact_x = len(out) == 3 and all(
        np.array_equal(ts[0], golden["input"][k]) for k, (ts, _) in enumerate(out))
    emit("golden_receive_exact", fields_in=4, fields_out=len(out), ts_exact=exact_x,
         launches=launches_x, segments_corrected=rx.decoder.segments_corrected)
    check(exact_x, "golden IQ did not decode to golden input[0:3] through the exact profile")
    check(launches_x == 4, f"{launches_x} exact-tier eq launches for 4 equalized fields")
    return launches_x


def receive_full_size(dev) -> dict:
    """Phase 9: the receive main path at B=384, timed; then the kernel
    against its plain twin, the exact tier and the conv1d yardstick."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import decode_field, init_decoder_state
    from atsc_tpu_torch.models.receiver import (
        EQ_PROFILES,
        _osc_planar,
        _wl_eq_taps,
        device_eq_step,
    )
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk
    from atsc_tpu_torch.ops.decode import derandomize_field
    from atsc_tpu_torch.ops.quantize import quantize_scale

    n = P.SYMBOLS_PER_FIELD
    eq_k, _ = EQ_PROFILES["fast"]
    n_fields = WARM + TIMED          # fields equalized and decoded
    ts = _random_ts_dev(dev, n_fields + 1, 2025)  # the last window reads the next field
    oscs = _field_oscs(dev, n_fields, eq_k)
    result = {}
    eqk.LAUNCHES = 0
    keep = None
    for fmt in ("cf32", "cs16", "cs8"):
        wins = _loopback_windows(dev, ts, fmt, eq_k)
        dq = 1.0 if fmt == "cf32" else 1.0 / quantize_scale(fmt)
        step = device_eq_step(False, dq, "fast")
        state = init_decoder_state(B_FULL, device=dev)
        outs, syns = [], []

        def run(k):
            nonlocal state
            sym = step(wins[k], oscs[k])
            state, cw, syn = decode_field(state, sym)
            outs.append(derandomize_field(cw))
            syns.append(syn)

        for k in range(WARM):
            run(k)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(WARM, n_fields):
            run(k)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / TIMED
        peak = torch.cuda.max_memory_allocated(dev)
        exact = all(torch.equal(outs[k], ts[k - 1]) for k in range(1, n_fields))
        clean = not any(bool(syns[k].any()) for k in range(1, n_fields))
        t_field = ms / 1e3
        result[fmt] = {
            "ms_per_field": ms,
            "realtime_channels": B_FULL / (t_field * P.FIELD_RATE),
            "max_memory_allocated": peak,
            "step_memory_above_inputs": peak - base,
            "ts_exact_all_channels": exact,
            "syndromes_zero": clean,
        }
        emit("receive_full", batch=B_FULL, format=fmt, profile="fast",
             timed_fields=TIMED, **result[fmt])
        check(exact, f"B={B_FULL} {fmt}: decoded TS differs from the sent TS")
        check(clean, f"B={B_FULL} {fmt}: non-zero syndromes on a clean loopback")
        if fmt == "cf32":
            keep = (wins[WARM], oscs[WARM])
        del wins, outs, syns, state
    launches = eqk.LAUNCHES
    check(launches == 3 * n_fields,
          f"{launches} eq launches for {3 * n_fields} equalized fields")
    del ts

    # the kernel against the plain twin (fast, cf32), in turns
    win, osc = keep
    run_kernel = lambda: eqk.eq_fir_fused(win, osc, eq_k=eq_k)  # noqa: E731
    run_plain = lambda: eqk.eq_fir_plain(win, osc, eq_k=eq_k)   # noqa: E731
    p1, k1, k2, p2 = timed(run_plain), timed(run_kernel), timed(run_kernel), timed(run_plain)
    hard_same = bool(torch.equal(run_kernel(), run_plain()))
    soft_err = float((eqk.eq_fir_fused(win, osc, eq_k=eq_k, soft=True)
                      - eqk.eq_fir_plain(win, osc, eq_k=eq_k, soft=True)).abs().max())
    # the exact tier once: its window starts 256 samples before the field,
    # so the fast window shifts right and its first 128 samples are zero
    ek, _ = EQ_PROFILES["exact"]
    win_x = torch.cat([torch.zeros_like(win[..., : ek - eq_k]),
                       win[..., : eqk.WIN_LEN - ek + eq_k]], dim=-1)
    osc_x = torch.tensor(_osc_planar(WARM * n - ek, WARM * n - ek + eqk.WIN_LEN, 0), device=dev)
    exact_ms = timed(lambda: eqk.eq_fir_fused(win_x, osc_x, eq_k=ek, exact=True))
    exact_plain_ms = timed(lambda: eqk.eq_fir_plain(win_x, osc_x, eq_k=ek, exact=True), reps=3)
    exact_err = float((eqk.eq_fir_fused(win_x, osc_x, eq_k=ek, exact=True, soft=True)
                       - eqk.eq_fir_plain(win_x, osc_x, eq_k=ek, exact=True, soft=True)
                       ).abs().max())
    # one cuDNN conv1d over the derotated planes: bf16 for fast, fp32 (TF32
    # off) for exact. It is a yardstick only; the port never calls it.
    s = float(np.float32(1.0 / P.OSC_AMPLITUDE ** 2))

    def derotated(w, o):
        return torch.stack([(w[:, 0] * o[0] + w[:, 1] * o[1]) * s,
                            (w[:, 1] * o[0] - w[:, 0] * o[1]) * s], dim=1)

    def weight(k, dtype):
        p, q = _wl_eq_taps(k)
        return torch.tensor(np.stack([p, q])[None], device=dev).to(dtype)

    u16 = derotated(win, osc).to(torch.bfloat16)
    w16 = weight(eq_k, torch.bfloat16)
    conv_ms = timed(lambda: torch.nn.functional.conv1d(u16, w16))
    u32 = derotated(win_x, osc_x)
    w32 = weight(ek, torch.float32)
    conv_exact_ms = timed(lambda: torch.nn.functional.conv1d(u32, w32))
    del u16, u32
    def eq_bytes(k):
        """The FIR reads n + 2K samples per plane of the window and the
        oscillator and writes n int8 symbols per channel."""
        span = n + 2 * k
        return B_FULL * 2 * span * win.element_size() + 2 * span * 4 + B_FULL * n

    fast_bound, fast_by = bound_ms(eq_bytes(eq_k),
                                   B_FULL * n * 2 * (2 * eq_k + 1) * 2, BF16_FLOP_PER_S)
    exact_flop = B_FULL * n * 2 * (2 * ek + 1) * 2
    exact_fp32_bound, exact_fp32_by = bound_ms(eq_bytes(ek), exact_flop, FP32_FLOP_PER_S)
    # or each multiply-add as 3 tf32 products on the tensor cores; the
    # bound is the lesser of the two floors
    exact_tc_bound, exact_tc_by = bound_ms(eq_bytes(ek), 3 * exact_flop, TF32_FLOP_PER_S)
    exact_bound, exact_by = min((exact_fp32_bound, exact_fp32_by), (exact_tc_bound, exact_tc_by))
    # what the kernel executes: kXBands bands of kXBand taps a plane (csrc/eq_fir.cu)
    x_band = csrc_constant("eq_fir.cu", "kXBand")
    x_bands = (2 * ek + x_band - 1) // x_band + 1
    exact_executed = B_FULL * n * 2 * x_bands * x_band * 2 * 3
    emit("eq_kernel_vs_plain", batch=B_FULL, format="cf32", profile="fast",
         kernel_ms=[k1, k2], plain_ms=[p1, p2], hard_identical=hard_same,
         max_abs_err_soft=soft_err, library_ms=conv_ms, library="F.conv1d bf16",
         bound_ms=fast_bound, bound_by=fast_by)
    emit("eq_kernel_exact", batch=B_FULL, format="cf32", profile="exact",
         kernel_ms=exact_ms, plain_ms=exact_plain_ms, max_abs_err_soft=exact_err,
         library_ms=conv_exact_ms, library="F.conv1d fp32", bound_ms=exact_bound,
         bound_by=exact_by, fp32_bound_ms=exact_fp32_bound, fp32_bound_by=exact_fp32_by,
         tensor_bound_ms=exact_tc_bound, tensor_bound_by=exact_tc_by, flop=exact_flop,
         executed_tf32_flop=exact_executed)
    check(hard_same, f"B={B_FULL}: kernel hard symbols differ from the plain twin")
    check(soft_err <= 1e-4, f"B={B_FULL}: fast soft error {soft_err} > 1e-4")
    check(exact_err <= 1e-5, f"B={B_FULL}: exact soft error {exact_err} > 1e-5")
    return {"launches": launches, "max_abs_err": soft_err,
            "kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": fast_bound, "bound_by": fast_by, "library_ms": conv_ms,
            "exact": {"ms": exact_ms, "plain_ms": exact_plain_ms, "max_abs_err": exact_err,
                      "bound_ms": exact_bound, "bound_by": exact_by,
                      "library_ms": conv_exact_ms}}


def receive_noisy(dev) -> None:
    """Phase 10: AWGN loopback at B=8: RS fires on the card, and the card's
    Decoder agrees with the CPU's bit for bit."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import Decoder, decode_field, init_decoder_state
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex
    from atsc_tpu_torch.models.receiver import IqReceiver, equalize_field_device
    from atsc_tpu_torch.ops.rs_decode import rs_correct_field

    n = P.SYMBOLS_PER_FIELD
    rng = np.random.default_rng(8)
    ts = rng.integers(0, 256, size=(4, B_NOISY, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc = Encoder(batch=B_NOISY, device=dev)
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(4)], axis=-1)
    sig = np.sqrt(np.mean(np.abs(iq) ** 2))
    noise = rng.normal(0, 1, iq.shape) + 1j * rng.normal(0, 1, iq.shape)
    noisy = (iq + noise * sig * 10 ** (-NOISY_SNR_DB / 20) / np.sqrt(2)).astype(np.complex64)

    rx = IqReceiver(batch=B_NOISY, measure_mer=True, device=dev)
    out = rx.push(noisy) + rx.flush()
    exact = len(out) == 3 and all(np.array_equal(t, ts[k]) for k, (t, _) in enumerate(out))

    card, host = Decoder(batch=B_NOISY, device=dev), Decoder(batch=B_NOISY, device="cpu")
    sc, sh = init_decoder_state(B_NOISY, device=dev), init_decoder_state(B_NOISY, device="cpu")
    same = True
    fired = 0
    for k in range(2):
        sym = equalize_field_device(noisy, k * n, device=dev)
        tc, nc = card.decode(sym)
        th, nh = host.decode(sym.cpu())
        sc, cwc, sync = decode_field(sc, sym)
        sh, cwh, synh = decode_field(sh, sym.cpu())
        cwc, ncc = rs_correct_field(cwc, sync)
        cwh, nch = rs_correct_field(cwh, synh)
        same &= (np.array_equal(tc, th) and np.array_equal(nc, nh)
                 and torch.equal(cwc.cpu(), cwh) and torch.equal(ncc.cpu(), nch))
        fired += int((nc > 0).sum())
    same &= np.array_equal(tc, ts[0])
    emit("noisy", batch=B_NOISY, snr_db=NOISY_SNR_DB, ts_exact=exact,
         segments_corrected=rx.decoder.segments_corrected,
         segments_uncorrectable=rx.decoder.segments_uncorrectable,
         mer_db=[round(float(v), 2) for v in rx.mer],
         decoder_card_equals_cpu=same, decoder_segments_corrected=fired)
    check(exact, "noisy loopback: the card's receiver did not return the sent TS")
    check(rx.decoder.segments_corrected > 0, "noisy loopback: RS never fired")
    check(same, "noisy field: the card's Decoder differs from the CPU Decoder")
    check(fired > 0, "noisy field: no segment corrected at the decoder")


def receive_host_path(dev) -> None:
    """Phase 11: IqReceiver at B=384, fed from host memory as a capture
    reader feeds it. Host wall time per pushed field covers the window
    assembly, the oscillator span, the copy to the card, the device step
    and the TS back to the host."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.models.receiver import IqReceiver, _osc_planar
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk

    n = P.SYMBOLS_PER_FIELD
    n_push = HOST_FIELDS + 2   # pushes 0 and 1 fill the one-field latency
    gen = torch.Generator(dev).manual_seed(2026)
    ts = torch.randint(0, 256, (n_push, B_FULL, P.FIELD_TS_BYTES), dtype=torch.uint8,
                       device=dev, generator=gen)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    ts_host = ts.cpu().numpy()
    for fmt in ("cf32", "cs8"):
        enc = Encoder(batch=B_FULL, out_format=fmt, device=dev)
        planar = [enc.encode(ts[k])[..., :n].cpu().numpy() for k in range(n_push)]
        del enc
        rx = IqReceiver(batch=B_FULL, wire_format=fmt, device=dev)
        outs, walls = [], []
        eqk.LAUNCHES = 0
        for k in range(n_push):
            x = planar[k]
            if fmt == "cf32":      # what a cf32 reader hands over: complex64
                x = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
            else:                  # and a cs8 reader: (B, n, 2) codes
                x = np.ascontiguousarray(x.transpose(0, 2, 1))
            planar[k] = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = rx.push(x) if fmt == "cf32" else rx.push_codes(x)
            walls.append(time.perf_counter() - t0)
            outs += [t for t, _ in got]
            del x
        outs += [t for t, _ in rx.flush()]
        launches = eqk.LAUNCHES
        exact = len(outs) == n_push - 1 and all(
            np.array_equal(outs[k], ts_host[k]) for k in range(n_push - 1))
        ms = float(np.mean(walls[2:])) * 1e3
        # two of the host's parts, timed alone: the oscillator span (built
        # in float64 on the host) and one window's pageable copy to the card
        lo = (n_push - 1) * n - 128
        t0 = time.perf_counter()
        osc = _osc_planar(lo, lo + eqk.WIN_LEN, 0)
        osc_ms = (time.perf_counter() - t0) * 1e3
        win = np.ones((B_FULL, 2, eqk.WIN_LEN), np.float32 if fmt == "cf32" else np.int8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(win).to(dev)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        del win, osc, outs, rx
        emit("receive_host", batch=B_FULL, format=fmt, profile="auto",
             timed_fields=HOST_FIELDS, host_ms_per_field=ms,
             realtime_channels=B_FULL / (ms / 1e3 * P.FIELD_RATE),
             push_ms=[w * 1e3 for w in walls], osc_span_ms=osc_ms,
             window_h2d_ms=h2d_ms, launches=launches, ts_exact_all_channels=exact)
        check(exact, f"IqReceiver B={B_FULL} {fmt}: decoded TS differs from the sent TS")
        check(launches == n_push, f"{launches} eq launches for {n_push} equalized fields")


def _cuda_ms(fn) -> tuple[object, float]:
    """(fn(), device ms of that one call by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _held(kernel, plain, reps: int = 10):
    """The kernel's output, whether it equals the plain twin's bit for bit,
    the largest difference, the kernel's ms (reps launches) and the plain
    twin's ms (one run)."""
    import torch

    want, plain_ms = _cuda_ms(plain)
    got = kernel()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    return got, same, err, timed(kernel, reps), plain_ms


def viterbi_kernels(dev) -> dict:
    """Phase 12: the four Viterbi kernels against their plain twins on the
    card, bit for bit, at B=384 and T=21,528 on real decommutated levels.
    Returns, per kernel, its kernels-line fields."""
    import torch

    from atsc_tpu_torch.models.receiver import EQ_PROFILES, device_eq_step
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk
    from atsc_tpu_torch.ops.decode import decommutate_field
    from atsc_tpu_torch.ops.ntsc import comb_field
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV, quantize_soft_levels

    eq_k, _ = EQ_PROFILES["fast"]
    ts = _random_ts_dev(dev, 3, 2027)
    win = _loopback_windows(dev, ts, "cf32", eq_k)[1]
    lev = device_eq_step(True, profile="fast")(win, _field_oscs(dev, 2, eq_k)[1])
    del win, ts
    gen = torch.Generator(dev).manual_seed(12)
    lev = lev + KERNEL_LEVEL_SIGMA * torch.randn(lev.shape, generator=gen, device=dev)
    obs = vk._lanes_t_major(decommutate_field(lev))                 # (T, L) float32
    codes = vk._lanes_t_major(decommutate_field(quantize_soft_levels(lev)))
    comb = vk._lanes_t_major(decommutate_field(comb_field(lev)))
    del lev
    t, l = obs.shape
    rc = torch.tensor(vk._pr_rc_table(), device=dev)
    m4 = torch.full((4, l), 1e9, device=dev)      # cold start: state 0 only
    m4[0] = 0.0
    m16 = torch.full((16, l), 1e9, device=dev)
    m16[0] = 0.0

    held = _held
    ab = _tool("torch_kernel_ab")   # tb_heads, head_stats, unmerged_words

    def unmerged(kernel, plain, pr, rows, start):
        """Both tracebacks on words where no chains merge, at all lanes and
        at 12: (identical at each, largest difference, the kernel's ms)."""
        words = ab.unmerged_words(pr, rows, l, gen, dev)
        _, same_u, err_u, ms_u, _ = held(lambda: kernel(words, start),
                                         lambda: plain(words, start))
        w12, s12 = words[:, :12].contiguous(), start[:12].contiguous()
        _, same12, err12, _, _ = held(lambda: kernel(w12, s12), lambda: plain(w12, s12))
        return same_u, same12, max(err_u, err12), ms_u

    out, checks = {}, {}
    (dec, m_out), same, err, ms, plain_ms = held(
        lambda: vk.acs_forward(obs, m4), lambda: vk.acs_forward_plain(obs, m4))
    _, same8, err8, ms8, plain8 = held(
        lambda: vk.acs_forward(codes, m4, SOFT_LEVEL_INV),
        lambda: vk.acs_forward_plain(codes, m4, SOFT_LEVEL_INV))
    checks["acs_forward"], checks["acs_forward_int8"] = same, same8
    out["acs_forward"] = dict(
        max_abs_err=max(err, err8), ms=ms, plain_ms=plain_ms, ms_int8=ms8,
        plain_ms_int8=plain8,
        **_bound(t * l * 4 + (t // 4) * l * 4 + 2 * 4 * l * 4, t * l * ACS_FLOPS),
        bound_int8=_bound(t * l + (t // 4) * l * 4 + 2 * 4 * l * 4,
                          t * l * (ACS_FLOPS + 1)))
    start = torch.argmin(m_out, dim=0).to(torch.int32)
    _, same, err, ms, plain_ms = held(lambda: vk.traceback(dec, start),
                                      lambda: vk.traceback_plain(dec, start))
    checks["traceback"] = same
    heads = ab.head_stats(*ab.tb_heads(dec, False))
    same_u, checks["traceback_unmerged_b1"], err_u, ms_u = unmerged(
        vk.traceback, vk.traceback_plain, False, dec.shape[0], start)
    checks["traceback_unmerged"] = same_u
    # and at 12 and 60 lanes: fewer lanes than one warp, and a part-empty
    # block, each pass and observation type, then its traceback
    small_acs, small_tb = {}, {}
    for nb in (1, 5):
        m_n = m4[:, :12 * nb].contiguous()
        for key, o_n, inv in (("f32", obs, None), ("int8", codes, SOFT_LEVEL_INV)):
            o_n = o_n[:, :12 * nb].contiguous()
            (dec_n, mo_n), same_n, err_n, _, _ = held(
                lambda: vk.acs_forward(o_n, m_n, inv),
                lambda: vk.acs_forward_plain(o_n, m_n, inv))
            checks[f"acs_forward_{key}_b{nb}"] = same_n
            small_acs[f"{key}_b{nb}"] = err_n
        st_n = torch.argmin(mo_n, dim=0).to(torch.int32)
        _, same_n, err_n, _, _ = held(lambda: vk.traceback(dec_n, st_n),
                                      lambda: vk.traceback_plain(dec_n, st_n))
        checks[f"traceback_b{nb}"] = same_n
        small_tb[f"b{nb}"] = err_n
    out["acs_forward"].update(design=ACS_DESIGN, max_abs_err_small=small_acs)
    out["acs_forward"]["max_abs_err"] = max(out["acs_forward"]["max_abs_err"],
                                            *small_acs.values())
    out["traceback"] = dict(design=TB_DESIGN, max_abs_err=max(err, err_u, *small_tb.values()),
                            max_abs_err_small=small_tb, ms=ms, plain_ms=plain_ms,
                            ms_unmerged=ms_u, heads=heads,
                            **_bound(2 * (t // 4) * l * 4 + l * 4, 0))
    del dec, obs, codes
    (dec, m_out), same, err, ms, plain_ms = held(
        lambda: vk.pr_acs_forward(comb, rc, m16),
        lambda: vk.pr_acs_forward_plain(comb, rc, m16))
    checks["pr_acs_forward"] = same
    resets = int((rc & 1).sum()) * (l // 12)
    # and at 12 and 60 lanes: a part-empty block, and fewer lanes than one,
    # each pass and then its traceback
    small, small_tb = {}, {}
    for nb in (1, 5):
        c_n, m_n = comb[:, :12 * nb].contiguous(), m16[:, :12 * nb].contiguous()
        (dec_n, mo_n), same_n, err_n, _, _ = held(
            lambda: vk.pr_acs_forward(c_n, rc, m_n),
            lambda: vk.pr_acs_forward_plain(c_n, rc, m_n))
        checks[f"pr_acs_forward_b{nb}"] = same_n
        small[f"b{nb}"] = err_n
        st_n = torch.argmin(mo_n, dim=0).to(torch.int32)
        _, same_n, err_n, _, _ = held(lambda: vk.pr_traceback(dec_n, st_n),
                                      lambda: vk.pr_traceback_plain(dec_n, st_n))
        checks[f"pr_traceback_b{nb}"] = same_n
        small_tb[f"b{nb}"] = err_n
    out["pr_acs_forward"] = dict(
        design=PR_DESIGN,
        max_abs_err=max(err, *small.values()), max_abs_err_small=small, ms=ms,
        plain_ms=plain_ms, reset_steps=resets,
        **_bound(2 * t * l * 4 + t * 12 * 4 + 2 * 16 * l * 4, t * l * PR_FLOPS))
    start = torch.argmin(m_out, dim=0).to(torch.int32)
    _, same, err, ms, plain_ms = held(lambda: vk.pr_traceback(dec, start),
                                      lambda: vk.pr_traceback_plain(dec, start))
    checks["pr_traceback"] = same
    heads = ab.head_stats(*ab.tb_heads(dec, True))
    same_u, checks["pr_traceback_unmerged_b1"], err_u, ms_u = unmerged(
        vk.pr_traceback, vk.pr_traceback_plain, True, t, start)
    checks["pr_traceback_unmerged"] = same_u
    out["pr_traceback"] = dict(design=PR_TB_DESIGN,
                               max_abs_err=max(err, err_u, *small_tb.values()),
                               max_abs_err_small=small_tb, ms=ms, plain_ms=plain_ms,
                               ms_unmerged=ms_u, heads=heads,
                               **_bound(t * l * 4 + (t // 4) * l * 4 + l * 4, 0))
    del dec, comb
    emit("viterbi_kernels", batch=B_FULL, steps=t, lanes=l, identical=checks, **out)
    for k, ok in checks.items():
        check(ok, f"{k}: the kernel differs from its plain twin"
              + ("" if k.endswith(("_b1", "_b5")) else f" at B={B_FULL}"))
    check(resets > 0, "no segment-sync reset step inside the PR span")
    return out


def _bound(nbytes: float, flops: float) -> dict:
    ms, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
    return {"bound_ms": ms, "bound_by": by}


def _zero_launches() -> None:
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk

    vk.LAUNCHES.update(dict.fromkeys(vk.LAUNCHES, 0))


def receive_golden_soft(golden, dev) -> None:
    """Phase 13: the soft, soft-i8 and comb tiers of IqReceiver on the card
    decode golden IQ exactly, one launch of each kernel of the path per
    decoded field."""
    import numpy as np

    from atsc_tpu_torch.models.receiver import IqReceiver
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk

    iq = golden["iq"][:4].reshape(1, -1)
    none = dict.fromkeys(vk.CHUNKED, 0)   # the exact tiers launch no chunked kernel
    path = {"acs_forward": 4, "traceback": 4, "pr_acs_forward": 0, "pr_traceback": 0, **none}
    comb = {"acs_forward": 0, "traceback": 0, "pr_acs_forward": 4, "pr_traceback": 4, **none}
    for name, kw, want in (("soft", dict(trellis="soft"), path),
                           ("soft-i8", dict(trellis="soft-i8"), path),
                           ("comb", dict(ntsc="comb"), comb)):
        _zero_launches()
        rx = IqReceiver(batch=1, device=dev, **kw)
        out = rx.push(iq[:, :400_000]) + rx.push(iq[:, 400_000:]) + rx.flush()
        launches = dict(vk.LAUNCHES)
        exact = len(out) == 3 and all(
            np.array_equal(ts[0], golden["input"][k]) for k, (ts, _) in enumerate(out))
        emit("golden_soft", tier=name, fields_in=4, fields_out=len(out), ts_exact=exact,
             launches=launches, segments_corrected=rx.decoder.segments_corrected)
        check(exact, f"golden IQ through the {name} tier != golden input[0:3] on the card")
        check(launches == want, f"{name}: launches {launches} for 4 decoded fields")


def receive_full_soft(dev) -> dict:
    """Phase 14: the soft, soft-i8 and NTSC receive steps at B=384, timed,
    then each stage of each step alone. Returns the Viterbi kernels'
    launches over the three timed main-path runs."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models import decoder as dec_mod
    from atsc_tpu_torch.models.receiver import EQ_PROFILES, device_eq_step
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk
    from atsc_tpu_torch.ops.decode import (
        decommutate_field,
        deinterleave_field,
        derandomize_field,
        enc_major_to_round_major,
    )
    from atsc_tpu_torch.ops.ntsc import comb_field
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV, quantize_scale
    from atsc_tpu_torch.ops.rs_decode import syndrome_field

    eq_k, _ = EQ_PROFILES["fast"]
    n_fields = WARM + TIMED
    ts = _random_ts_dev(dev, n_fields + 1, 2028)
    oscs = _field_oscs(dev, n_fields, eq_k)
    main = dict.fromkeys(vk.LAUNCHES, 0)
    for tier, fmt in (("soft", "cf32"), ("soft-i8", "cs8"), ("ntsc", "cf32")):
        wins = _loopback_windows(dev, ts, fmt, eq_k)
        dq = 1.0 if fmt == "cf32" else 1.0 / quantize_scale(fmt)
        step = device_eq_step(True, dq, "fast", soft_q=tier == "soft-i8")
        ntsc = tier == "ntsc"
        decode = dec_mod.ntsc_decode_field if ntsc else dec_mod.soft_decode_field
        state = (dec_mod.init_ntsc_decoder_state if ntsc else
                 dec_mod.init_soft_decoder_state)(B_FULL, device=dev)
        outs, syns = [], []

        def run(k):
            nonlocal state
            state, cw, syn = decode(state, step(wins[k], oscs[k]))
            outs.append(derandomize_field(cw))
            syns.append(syn)

        for k in range(WARM):
            run(k)
        kept = state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(WARM, n_fields):
            run(k)
        stop.record()
        torch.cuda.synchronize()
        launches = dict(vk.LAUNCHES)
        for k2, v in launches.items():
            main[k2] += v
        ms = start.elapsed_time(stop) / TIMED
        peak = torch.cuda.max_memory_allocated(dev)
        exact = all(torch.equal(outs[k], ts[k - 1]) for k in range(1, n_fields))
        clean = not any(bool(syns[k].any()) for k in range(1, n_fields))
        del outs, syns, state

        # each stage alone, on the first timed field's inputs
        win, osc = wins[WARM], oscs[WARM]
        del wins
        stages = {}
        lev = step(win, osc)
        stages["eq"] = timed(lambda: step(win, osc), reps=5)
        if ntsc:
            stages["comb"] = timed(lambda: comb_field(lev.to(torch.float32)), reps=5)
            lev = comb_field(lev)
        stages["decommutate"] = timed(lambda: decommutate_field(lev), reps=5)
        d = decommutate_field(lev)
        stages["transpose"] = timed(lambda: vk._lanes_t_major(d), reps=5)
        obs = vk._lanes_t_major(d)
        b, ne = B_FULL, P.TRELLIS_ENCODERS
        m0 = kept.metrics.reshape(b * ne, -1).t().contiguous()
        if ntsc:
            rc = torch.tensor(vk._pr_rc_table(), device=dev)
            fwd = lambda: vk.pr_acs_forward(obs, rc, m0)  # noqa: E731
            tb = vk.pr_traceback
        else:
            inv = SOFT_LEVEL_INV if tier == "soft-i8" else None
            fwd = lambda: vk.acs_forward(obs, m0, inv_scale=inv)  # noqa: E731
            tb = vk.traceback
        stages["forward_kernel"] = timed(fwd, reps=5)
        dec, mout = fwd()
        stages["argmin"] = timed(lambda: torch.argmin(mout, dim=0).to(torch.int32), reps=5)
        first = torch.argmin(mout, dim=0).to(torch.int32)
        stages["traceback_kernel"] = timed(lambda: tb(dec, first), reps=5)
        bits = tb(dec, first)
        z2 = kept.z2_prev.reshape(-1)
        stages["pack"] = timed(lambda: vk.pack_bits_to_bytes(bits, z2), reps=5)
        words, _ = vk.pack_bits_to_bytes(bits, z2)
        relayout = lambda: words.to(torch.uint8).reshape(-1, b, ne).permute(1, 2, 0).contiguous()  # noqa: E731
        stages["relayout"] = timed(relayout, reps=5)
        by = relayout()
        stages["deinterleave"] = timed(
            lambda: deinterleave_field(enc_major_to_round_major(by), kept.prev_il), reps=5)
        cw = deinterleave_field(enc_major_to_round_major(by), kept.prev_il).reshape(
            b, P.DATA_SEGMENTS, P.SEGMENT_FEC_BYTES)
        stages["syndromes"] = timed(lambda: syndrome_field(cw), reps=5)
        stages["derandomize"] = timed(lambda: derandomize_field(cw), reps=5)
        del win, lev, d, obs, dec, bits, words, by, cw, kept
        total = sum(stages.values())
        t_field = ms / 1e3
        emit("receive_full_soft", batch=B_FULL, tier=tier, format=fmt, profile="fast",
             timed_fields=TIMED, ms_per_field=ms,
             realtime_channels=B_FULL / (t_field * P.FIELD_RATE),
             max_memory_allocated=peak, step_memory_above_inputs=peak - base,
             ts_exact_all_channels=exact, syndromes_zero=clean, launches=launches,
             stages_ms=stages, stages_sum_ms=total,
             stage_shares={k2: v / total for k2, v in stages.items()})
        check(exact, f"B={B_FULL} {tier}: decoded TS differs from the sent TS")
        check(clean, f"B={B_FULL} {tier}: non-zero syndromes on a clean loopback")
        path = ("pr_acs_forward", "pr_traceback") if ntsc else ("acs_forward", "traceback")
        check(all(launches[k2] == (TIMED if k2 in path else 0) for k2 in launches),
              f"{tier}: Viterbi launches {launches} for {TIMED} timed fields")
    del ts, oscs
    torch.cuda.empty_cache()
    return main


def _noisy_capture(dev, seed: int, impair):
    """4 fields of seeded random TS at B_NOISY encoded on the card, impaired
    on the host: (ts (4, B, 58656), capture (B, 4N) complex64)."""
    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, size=(4, B_NOISY, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    enc = Encoder(batch=B_NOISY, device=dev)
    iq = np.concatenate([iq_to_complex(enc.encode(ts[k])) for k in range(4)], axis=-1)
    return ts, impair(iq, rng).astype(np.complex64)


def _receive(dev, cap, **kw):
    from atsc_tpu_torch.models.receiver import IqReceiver

    rx = IqReceiver(batch=B_NOISY, device=dev, **kw)
    return rx, rx.push(cap) + rx.flush()


def _exact(out, ts) -> bool:
    import numpy as np

    return len(out) == 3 and all(np.array_equal(t, ts[k]) and (n >= 0).all()
                                 for k, (t, n) in enumerate(out))


def _card_equals_cpu(card, host, fields) -> bool:
    """Decode the same soft level fields on the card and on the CPU; True
    when TS, n_errors, the carried states and the codewords (from
    consecutive interleaved fields) agree bit for bit."""
    import numpy as np
    import torch

    from atsc_tpu_torch.ops.decode import deinterleave_field

    same = True
    for lev in fields:
        pc, ph = card.state.prev_il, host.state.prev_il
        tc, nc = card.decode(lev)
        th, nh = host.decode(lev.cpu())
        same &= np.array_equal(tc, th) and np.array_equal(nc, nh)
        same &= all(torch.equal(a.cpu(), b) for a, b in zip(card.state, host.state))
        same &= torch.equal(deinterleave_field(card.state.prev_il, pc).cpu(),
                            deinterleave_field(host.state.prev_il, ph))
    return bool(same)


def receive_noisy_soft(dev) -> None:
    """Phase 15: B=8 at NOISY_SOFT_SNR_DB: hard fails, the soft tiers do
    not, and the card's SoftDecoder equals the CPU's."""
    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import SoftDecoder
    from atsc_tpu_torch.models.receiver import equalize_field_device

    def awgn(iq, rng):
        sig = np.sqrt(np.mean(np.abs(iq) ** 2))
        noise = rng.normal(0, 1, iq.shape) + 1j * rng.normal(0, 1, iq.shape)
        return iq + noise * sig * 10 ** (-NOISY_SOFT_SNR_DB / 20) / np.sqrt(2)

    ts, cap = _noisy_capture(dev, 15, awgn)
    hard, hard_out = _receive(dev, cap)
    tiers = {}
    for trellis in ("soft", "soft-i8"):
        rx, out = _receive(dev, cap, trellis=trellis)
        tiers[trellis] = {"ts_exact": _exact(out, ts),
                          "segments_corrected": rx.decoder.segments_corrected,
                          "segments_uncorrectable": rx.decoder.segments_uncorrectable}
    n = P.SYMBOLS_PER_FIELD
    fields = [equalize_field_device(cap, k * n, soft=True, device=dev) for k in range(2)]
    same = _card_equals_cpu(SoftDecoder(batch=B_NOISY, device=dev),
                            SoftDecoder(batch=B_NOISY, device="cpu"), fields)
    emit("noisy_soft", batch=B_NOISY, snr_db=NOISY_SOFT_SNR_DB,
         hard_segments_uncorrectable=hard.decoder.segments_uncorrectable,
         hard_ts_exact=_exact(hard_out, ts), tiers=tiers, decoder_card_equals_cpu=same)
    check(hard.decoder.segments_uncorrectable > 0,
          f"{NOISY_SOFT_SNR_DB} dB: the hard receiver left no uncorrectable segment")
    for trellis, r in tiers.items():
        check(r["ts_exact"] and r["segments_uncorrectable"] == 0,
              f"{NOISY_SOFT_SNR_DB} dB: the {trellis} tier did not return the sent TS")
    check(same, "noisy levels: the card's SoftDecoder differs from the CPU's")


def receive_cci(dev) -> None:
    """Phase 16: B=8 with co-channel interference at the comb null: hard
    fails, ntsc='auto' engages and decodes, and the card's NtscDecoder
    equals the CPU's."""
    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import NtscDecoder
    from atsc_tpu_torch.models.receiver import equalize_field_device

    def cci(iq, rng):
        rms = np.sqrt(np.mean(np.abs(iq) ** 2))
        f = P.SAMPLE_RATE / 12 + P.OSC_FREQUENCY   # tests/test_ntsc.py::_cci
        k = np.arange(iq.shape[-1])
        return iq + 0.5 * rms * np.exp(2j * np.pi * f * k / P.SAMPLE_RATE + 0.4j)

    ts, cap = _noisy_capture(dev, 16, cci)
    hard, _ = _receive(dev, cap)
    rx, out = _receive(dev, cap, ntsc="auto")
    exact = _exact(out, ts)
    n = P.SYMBOLS_PER_FIELD
    fields = [equalize_field_device(cap, k * n, soft=True, device=dev) for k in range(2)]
    same = _card_equals_cpu(NtscDecoder(batch=B_NOISY, device=dev),
                            NtscDecoder(batch=B_NOISY, device="cpu"), fields)
    emit("cci", batch=B_NOISY, tone_rms_ratio=0.5,
         hard_segments_uncorrectable=hard.decoder.segments_uncorrectable,
         ntsc_votes=[bool(v) for v in rx.ntsc_votes], ntsc_active=rx.ntsc_active,
         ts_exact=exact, segments_uncorrectable=rx.decoder.segments_uncorrectable,
         decoder_card_equals_cpu=same)
    check(hard.decoder.segments_uncorrectable > 0, "CCI: the hard receiver decoded it all")
    check(rx.ntsc_active and all(rx.ntsc_votes), "CCI: ntsc='auto' did not engage everywhere")
    check(exact, "CCI: the comb tier did not return the sent TS")
    check(same, "CCI levels: the card's NtscDecoder differs from the CPU's")


def _tool(name: str):
    """tools/<name>.py as a module (tools/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _run_tool(name: str, argv: list) -> tuple[object, int, list]:
    """Run tools/<name>.py's main(argv) in this process; (the tool's
    module, its exit code, the JSON lines it printed)."""
    tool = _tool(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv)
    return tool, rc, [json.loads(ln) for ln in out.getvalue().splitlines()]


def trellis_fused_kernel(dev) -> dict:
    """Phase 17: the fused trellis probe's path, then the kernel against its
    plain twin at B=384. Returns its kernels-line fields."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.ops.cuda import trellis_fused as tfk
    from atsc_tpu_torch.ops.trellis import trellis_encode_field

    tfk.LAUNCHES = 0
    _, rc, lines = _run_tool("torch_trellis_fuse_probe", ["--batch", str(B_FULL), "--iters", "10"])
    launches = tfk.LAUNCHES
    emit("trellis_probe", batch=B_FULL, rc=rc, lines=lines, launches=launches)
    check(rc == 0 and [ln.get("bit_exact") for ln in lines[:2]] == [True, True],
          f"tools/torch_trellis_fuse_probe.py: rc {rc}, {lines}")
    check(launches > 0, "the trellis probe launched no trellis_fused kernel")

    gen = torch.Generator(dev).manual_seed(17)
    ne, nb = P.TRELLIS_ENCODERS, P.TRELLIS_BYTES_PER_ENCODER
    il_pad = torch.randint(0, 256, (B_FULL, ne, tfk.PAD_BYTES), dtype=torch.uint8,
                           device=dev, generator=gen)
    d, d1, d2 = (torch.randint(0, 2, (B_FULL, ne), dtype=torch.int32, device=dev,
                               generator=gen) for _ in range(3))
    il = il_pad[..., :nb].contiguous()
    ref = trellis_encode_field(il, d, d1, d2)[0]
    ref_ms = timed(lambda: trellis_encode_field(il, d, d1, d2))
    flushed_ms = _tool("torch_kernel_ab").flushed_ms   # the L2 flushed before each launch
    ms, cold_ms, plain_ms, same, err = {}, {}, {}, {}, 0
    for interleaved in (True, False):
        name = "interleaved" if interleaved else "planemajor"
        got = tfk.trellis_fused(il_pad, d, d1, d2, interleaved=interleaved)
        want = tfk.trellis_fused_plain(il_pad, d, d1, d2, interleaved=interleaved)
        same[name] = bool(torch.equal(got, want))
        same[name + "_vs_trellis_encode_field"] = bool(
            torch.equal(tfk.to_stream(got, interleaved), ref))
        err = max(err, int((got.int() - want.int()).abs().max()))
        del got, want
        ms[name] = timed(lambda lay=interleaved: tfk.trellis_fused(il_pad, d, d1, d2,
                                                                   interleaved=lay))
        cold_ms[name] = flushed_ms(lambda lay=interleaved: tfk.trellis_fused(
            il_pad, d, d1, d2, interleaved=lay), 10, dev)
        plain_ms[name] = timed(lambda lay=interleaved: tfk.trellis_fused_plain(
            il_pad, d, d1, d2, interleaved=lay), reps=3)
    # the persistent grid's ragged edges: 12 and 276 rows
    for b, seed in ((1, 171), (23, 172)):
        g = torch.Generator(dev).manual_seed(seed)
        il_b = torch.randint(0, 256, (b, ne, tfk.PAD_BYTES), dtype=torch.uint8, device=dev,
                             generator=g)
        c_b = [torch.randint(0, 2, (b, ne), dtype=torch.int32, device=dev, generator=g)
               for _ in range(3)]
        ref_b = trellis_encode_field(il_b[..., :nb].contiguous(), *c_b)[0]
        for interleaved in (True, False):
            name = f"b{b}_" + ("interleaved" if interleaved else "planemajor")
            got = tfk.trellis_fused(il_b, *c_b, interleaved=interleaved)
            same[name] = bool(torch.equal(
                got, tfk.trellis_fused_plain(il_b, *c_b, interleaved=interleaved)))
            same[name + "_vs_trellis_encode_field"] = bool(
                torch.equal(tfk.to_stream(got, interleaved), ref_b))
    # bytes: the padded field and the carries read once, the symbols written once
    bound = _bound(B_FULL * ne * (tfk.PAD_BYTES + 3 * 4 + tfk.PAD_SYMBOLS), 0)
    emit("trellis_fused", batch=B_FULL, identical=same, kernel_ms=ms,
         kernel_ms_l2_flushed=cold_ms, plain_ms=plain_ms, reference_op_ms=ref_ms,
         reference_op="trellis_encode_field", **bound)
    for k, ok in same.items():
        check(ok, f"trellis_fused {k}: the kernel differs from its twin or trellis_encode_field")
    return {"launches": launches, "max_abs_err": err, "ms": ms["interleaved"],
            "ms_by_layout": ms, "ms_l2_flushed_by_layout": cold_ms,
            "plain_ms": plain_ms["interleaved"], "plain_ms_by_layout": plain_ms,
            "reference_op_ms": ref_ms, **bound, "library_ms": None}


def fir_variants_kernel(golden, dev, kernel1: dict, nbytes: int, flop: int) -> dict:
    """Phase 18: the offset+FIR design probe's path, then every probe run of
    the banded-matmul kernel against its plain twin and offset_fir_fused at
    B=384. kernel1 carries phase 5's fp32 bound and F.conv1d yardstick (the
    same function); nbytes and flop are that function's bytes and fp32
    FLOP. Returns its kernels-line fields."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.ops.cuda import fir_variants as fvk
    from atsc_tpu_torch.ops.cuda import offset_fir as fir

    n = P.SYMBOLS_PER_FIELD
    tol = 2e-6
    fvk.LAUNCHES = 0
    probe, rc, lines = _run_tool("torch_fir_probe", ["--batch", str(B_FULL), "--iters", "10"])
    launches = fvk.LAUNCHES
    emit("fir_probe", batch=B_FULL, rc=rc, lines=lines, launches=launches)
    check(rc == 0 and len(lines) == 7 and all(
        ln.get("max_err") is not None and ln["max_err"] <= tol for ln in lines),
        f"tools/torch_fir_probe.py: rc {rc}, {lines}")
    check(launches > 0, "the FIR probe launched no fir_variants kernel")

    gen = torch.Generator(dev).manual_seed(18)
    field = torch.randint(0, 8, (B_FULL, P.PADDED_SYMBOLS), dtype=torch.int8, device=dev,
                          generator=gen)
    levels0 = golden["sync"][0].real.astype(np.float32)
    sym0 = np.rint((levels0 - P.PILOT_OFFSET + 7.0) / 2.0).astype(np.int8)
    sym0[P.PADDED_SYMBOLS - P.RESERVED_SYMBOLS:] = 0
    field[0] = torch.tensor(sym0, device=dev)
    phasor = torch.tensor([[0.8, 0.6]], dtype=torch.float32, device=dev).repeat(B_FULL, 1)
    base = fir.offset_fir_fused(field, phasor)[..., :n]
    # the probe's runs through run_variant, and the variant's default
    runs = [r for r in probe.RUNS if r[1]] + [("base_chunks5", "base", 5)]
    ms, err_plain, err_base = {}, {}, {}
    for name, variant, nchunk in runs:
        got = fvk.run_variant(field, phasor, variant, nchunk)[..., :n]
        want = fvk.run_variant_plain(field, phasor, variant, nchunk)[..., :n]
        err_plain[name] = float((got - want).abs().max())
        err_base[name] = float((got - base).abs().max())
        ms[name] = timed(lambda v=variant, c=nchunk: fvk.run_variant(field, phasor, v, c))
        del got, want
    plain_ms = timed(lambda: fvk.run_variant_plain(field, phasor, "base", 5), reps=3)
    # the dense banded product: 2 planes x 256 multiply-adds per output
    # sample; the kernel executes, per n-tile, only the k-steps of the
    # nonzero 8 x 8 tap blocks (csrc/fir_variants.cu kBlocks), each as 3
    # tf32 products
    dense = B_FULL * P.PADDED_OUT * 2 * 256 * 2
    steps = (P.RRC_TAPS - 1 + 7) // 8 + 1
    executed = B_FULL * P.PADDED_OUT * 2 * 8 * steps * 2 * 3
    rate = {k: executed / (v * 1e-3) for k, v in ms.items()}
    # the function's floor as 3 x TF32, beside phase 5's fp32 one; the
    # bound is the lesser
    tc_bound, tc_by = bound_ms(nbytes, 3 * flop, TF32_FLOP_PER_S)
    bound, by = min((kernel1["bound_ms"], kernel1["bound_by"]), (tc_bound, tc_by))
    emit("fir_variants", batch=B_FULL, kernel_ms=ms, plain_ms=plain_ms,
         max_abs_err_vs_plain=err_plain, max_abs_err_vs_offset_fir=err_base, tolerance=tol,
         dense_flop=dense, executed_tf32_flop=executed, executed_tf32_flop_per_s=rate,
         fp32_bound_ms=kernel1["bound_ms"], tensor_bound_ms=tc_bound, tensor_bound_by=tc_by,
         bound_ms=bound, bound_by=by, library_ms=kernel1["library_ms"],
         library=kernel1["library"])
    for k in ms:
        check(err_plain[k] <= tol, f"fir_variants {k} vs plain {err_plain[k]} > {tol}")
        check(err_base[k] <= tol, f"fir_variants {k} vs offset_fir {err_base[k]} > {tol}")
    return {"launches": launches, "max_abs_err": max(err_plain.values()),
            "max_abs_err_vs_offset_fir": max(err_base.values()), "ms": ms["base_chunks5"],
            "ms_by_run": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": kernel1["library_ms"]}


def _burst_host(iq, rng, field: int = 1):
    """The impulse burst added to every channel of a host capture at
    BURST_AT samples into `field`."""
    from atsc_tpu_torch import params as P

    s0 = field * P.SYMBOLS_PER_FIELD + BURST_AT
    shape = (iq.shape[0], BURST_LEN)
    iq = iq.copy()
    iq[:, s0 : s0 + BURST_LEN] += (rng.normal(size=shape)
                                   + 1j * rng.normal(size=shape)) * BURST_SCALE
    return iq


def _multipath_host(iq, rng, noise: float = 0.01):
    """tests/test_adaptive_eq.py's multipath + complex gain + noise."""
    import numpy as np

    h = np.zeros(24, np.complex128)
    h[0], h[7], h[23] = 0.85 * np.exp(0.4j), 0.2 * np.exp(-1.3j), -0.1 + 0.05j
    y = np.stack([np.convolve(r, h)[: iq.shape[1]] for r in iq])
    return y + (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape)) * noise


def _launches() -> dict:
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk

    return {"eq_fir_fused": eqk.LAUNCHES, **vk.LAUNCHES}


def _zero_all_launches() -> None:
    from atsc_tpu_torch.ops.cuda import eq_fir as eqk

    eqk.LAUNCHES = 0
    _zero_launches()


def _every_count() -> dict:
    """Every wrapper's launch count, by kernel: all eight and the chunked two."""
    from atsc_tpu_torch.ops.cuda import fir_variants as fvk
    from atsc_tpu_torch.ops.cuda import offset_fir as fir
    from atsc_tpu_torch.ops.cuda import trellis_fused as tfk

    return {"offset_fir_fused": fir.LAUNCHES, **_launches(),
            "trellis_fused": tfk.LAUNCHES, "fir_variants": fvk.LAUNCHES}


def _zero_every_count() -> None:
    from atsc_tpu_torch.ops.cuda import fir_variants as fvk
    from atsc_tpu_torch.ops.cuda import offset_fir as fir
    from atsc_tpu_torch.ops.cuda import trellis_fused as tfk

    fir.LAUNCHES = tfk.LAUNCHES = fvk.LAUNCHES = 0
    _zero_all_launches()


def _since(before: dict) -> dict:
    """The launches of every kernel since `before` = _every_count()."""
    return {k: v - before[k] for k, v in _every_count().items()}


def receive_erasures(dev) -> None:
    """Phase 19: the burst erasure tier at B=8 on the card, hard and soft,
    and the card's Decoder with flags against the CPU's."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import Decoder
    from atsc_tpu_torch.models.receiver import equalize_field_device
    from atsc_tpu_torch.ops.decode import propagate_erasure_flags
    from atsc_tpu_torch.ops.erasures import burst_erasure_flags_dev
    from atsc_tpu_torch.ops.slicer import slice_symbols

    n = P.SYMBOLS_PER_FIELD
    ts, cap = _noisy_capture(dev, 19, _burst_host)
    zf, zf_out = _receive(dev, cap)
    tiers = {}
    for trellis in ("hard", "soft"):
        _zero_all_launches()
        rx, out = _receive(dev, cap, erasures="burst", trellis=trellis)
        tiers[trellis] = {"ts_exact": _exact(out, ts), "launches": _launches(),
                          "segments_corrected": rx.decoder.segments_corrected,
                          "segments_uncorrectable": rx.decoder.segments_uncorrectable,
                          "segments_erasure_assisted": rx.decoder.segments_erasure_assisted}
    card, host = Decoder(batch=B_NOISY, device=dev), Decoder(batch=B_NOISY, device="cpu")
    carry = torch.zeros((B_NOISY, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev)
    assisted = np.zeros(B_NOISY, np.int64)
    same = True
    for k in range(3):
        lev = equalize_field_device(cap, k * n, soft=True, device=dev)
        flags = burst_erasure_flags_dev(lev)
        sym = slice_symbols(lev)
        tc, nc = card.decode(sym, erasure_flags=flags)
        th, nh = host.decode(sym.cpu(), erasure_flags=flags.cpu())
        same &= np.array_equal(tc, th) and np.array_equal(nc, nh)
        same &= torch.equal(card.flag_il.cpu(), host.flag_il)
        same &= all(torch.equal(a.cpu(), b) for a, b in zip(card.state, host.state))
        cw_flags, carry = propagate_erasure_flags(flags, carry)
        assisted += ((nc > 0) & (cw_flags != 0).any(dim=-1).cpu().numpy()).sum(axis=-1)
    counters = ("segments_corrected", "segments_uncorrectable", "segments_erasure_assisted")
    same &= all(getattr(card, c) == getattr(host, c) for c in counters)
    emit("erasures", batch=B_NOISY, burst={"at": n + BURST_AT, "samples": BURST_LEN,
                                          "scale": BURST_SCALE},
         zf_segments_uncorrectable=zf.decoder.segments_uncorrectable,
         zf_ts_exact=_exact(zf_out, ts), tiers=tiers,
         decoder_card_equals_cpu=bool(same),
         decoder_erasure_assisted_per_channel=assisted.tolist(),
         decoder_counters={c: getattr(card, c) for c in counters})
    check(zf.decoder.segments_uncorrectable > 0, "burst: zf alone left no uncorrectable segment")
    for trellis, r in tiers.items():
        check(r["ts_exact"] and r["segments_uncorrectable"] == 0
              and r["segments_erasure_assisted"] > 0,
              f"burst: erasures='burst' with trellis={trellis} did not return the sent TS")
        want = {"eq_fir_fused": 4, "acs_forward": 4 if trellis == "soft" else 0,
                "traceback": 4 if trellis == "soft" else 0}
        check(all(r["launches"][k] == v for k, v in want.items()),
              f"burst {trellis}: launches {r['launches']}, want {want}")
    check(same, "burst: the card's Decoder with flags differs from the CPU's")
    check(bool((assisted > 0).all()), f"burst: erasure-assisted segments per channel {assisted}")


def receive_adaptive(golden, dev) -> None:
    """Phase 20: the adaptive and numpy backends at B=8 on the card, the
    card's AdaptiveEqualizer against the CPU's, and the decode CLI with
    the new flags."""
    import numpy as np

    from atsc_tpu_torch import cli
    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.receiver import IqReceiver, field_window
    from atsc_tpu_torch.ops.adaptive_eq import WINDOW_MARGIN, AdaptiveEqualizer

    n = P.SYMBOLS_PER_FIELD
    ts, cap = _noisy_capture(dev, 20, _multipath_host)
    zf, zf_out = _receive(dev, cap)
    runs = {}
    for name, kw in (("adaptive", dict(backend="adaptive")),
                     ("adaptive_soft", dict(backend="adaptive", trellis="soft")),
                     ("train_every4", dict(backend="adaptive", train_every=4))):
        _zero_all_launches()
        rx, out = _receive(dev, cap, **kw)
        runs[name] = {"ts_exact": _exact(out, ts), "launches": _launches(),
                      "segments_corrected": rx.decoder.segments_corrected,
                      "segments_uncorrectable": rx.decoder.segments_uncorrectable}
        if name == "adaptive":
            card_out = out

    def awgn_multipath(iq, rng):
        y = np.stack([np.convolve(r, [0.9 * np.exp(0.5j), 0, 0.2 * np.exp(-1.3j), 0, 0.08j])
                      [: iq.shape[1]] for r in iq])
        p = float(np.mean(np.abs(y) ** 2))
        noise = rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape)
        return y + noise * np.sqrt(p / 10 ** (20.0 / 10.0) / 2.0)

    ts20, cap20 = _noisy_capture(dev, 21, awgn_multipath)
    for name, backend in (("sync_only_20db", "adaptive"), ("dd_20db", "adaptive-dd")):
        rx, out = _receive(dev, cap20, backend=backend)
        runs[name] = {"ts_exact": _exact(out, ts20),
                      "segments_corrected": rx.decoder.segments_corrected,
                      "segments_uncorrectable": rx.decoder.segments_uncorrectable}
    rx = IqReceiver(batch=1, backend="numpy", device=dev)
    iq = golden["iq"][:4].reshape(1, -1)
    out = rx.push(iq[:, :400_000]) + rx.push(iq[:, 400_000:]) + rx.flush()
    numpy_exact = len(out) == 3 and all(
        np.array_equal(t[0], golden["input"][k]) for k, (t, _) in enumerate(out))

    # the card's equalizer against the CPU's on the same windows, and the
    # CPU receiver's TS against the card's
    ce = AdaptiveEqualizer(batch=B_NOISY, apply_precision="highest", device=dev)
    he = AdaptiveEqualizer(batch=B_NOISY, apply_precision="highest", device="cpu")
    lev_err = edge_err = tap_err = 0.0
    for k in range(3):
        win, osc = field_window(cap, k * n, 0, margin=WINDOW_MARGIN)
        a = ce.process_field(win, osc, k % 2, soft=True).cpu()
        b = he.process_field(win, osc, k % 2, soft=True)
        err = (a - b).abs()
        lev_err = max(lev_err, float(err[:, WINDOW_MARGIN:-WINDOW_MARGIN].max()))
        edge_err = max(edge_err, float(err.max()))
        tap_err = max(tap_err, float(np.abs(ce.taps - he.taps).max()))
    _, host_out = _receive("cpu", cap, backend="adaptive")
    ts_same = len(host_out) == len(card_out) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(card_out, host_out))

    # the decode CLI: a cf32 capture through multipath with a burst
    mp_burst = _burst_host(cap, np.random.default_rng(22))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        path = os.path.join(tmp, "cap.iq")
        blocks = np.stack([mp_burst[:, k * n : (k + 1) * n] for k in range(4)])
        np.stack([blocks.real, blocks.imag], -1).astype(np.float32).tofile(path)
        err_buf = io.StringIO()
        with contextlib.redirect_stderr(err_buf):
            rc = cli.main(["decode", path, "--channels", str(B_NOISY), "--equalizer",
                           "adaptive", "--erasures", "burst", "--stats",
                           "-o", os.path.join(tmp, "back.ts")])
        stats = json.loads(err_buf.getvalue().strip().splitlines()[-1])
        back = np.fromfile(os.path.join(tmp, "back.ts"), np.uint8).reshape(
            -1, B_NOISY, P.FIELD_TS_BYTES)
    cli_exact = back.shape[0] == 3 and all(np.array_equal(back[k], ts[k]) for k in range(3))
    emit("adaptive", batch=B_NOISY, zf_ts_exact=_exact(zf_out, ts),
         zf_segments_uncorrectable=zf.decoder.segments_uncorrectable, runs=runs,
         numpy_golden_exact=numpy_exact, card_vs_cpu={
             "max_abs_err_levels": lev_err, "max_abs_err_levels_edges": edge_err,
             "max_abs_err_taps": tap_err, "ts_and_n_errors_identical": ts_same},
         tolerance={"levels": 2e-3, "levels_edges": 2e-2, "taps": 0.1},
         cli={"rc": rc, "ts_exact": cli_exact, "stats": stats})
    check(not _exact(zf_out, ts), "multipath: zf decoded it, the channel is too benign")
    for name in ("adaptive", "adaptive_soft", "train_every4", "dd_20db"):
        check(runs[name]["ts_exact"] and runs[name]["segments_uncorrectable"] == 0,
              f"adaptive {name}: the sent TS did not come back")
    check(runs["sync_only_20db"]["segments_uncorrectable"] > 0,
          "20 dB: sync-only training left no uncorrectable segment")
    check(all(runs[k]["launches"]["eq_fir_fused"] == 0 for k in ("adaptive", "train_every4")),
          f"adaptive: eq_fir_fused launched {runs}")
    check(runs["adaptive_soft"]["launches"]["acs_forward"] == 4
          and runs["adaptive_soft"]["launches"]["traceback"] == 4,
          f"adaptive soft: launches {runs['adaptive_soft']['launches']}")
    check(numpy_exact, "numpy backend: golden IQ did not decode to golden input[0:3]")
    check(lev_err <= 2e-3 and edge_err <= 2e-2 and tap_err <= 0.1,
          f"adaptive: card vs CPU levels {lev_err} / {edge_err}, taps {tap_err}")
    check(ts_same, "adaptive: the card's and the CPU's receivers disagree")
    check(rc == 0 and cli_exact and stats["segments_uncorrectable"] == 0
          and stats["segments_erasure_assisted"] > 0 and stats["fields_decoded"] == 3,
          f"cli decode --equalizer adaptive --erasures burst: rc {rc}, {stats}")


def _stream_planes(dev, ts, margin: int):
    """Encode ts (F, B, 58656) on the card: (B, 2, margin + F*N) cf32
    planes with `margin` zero samples before the first field."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder

    n = P.SYMBOLS_PER_FIELD
    enc = Encoder(batch=ts.shape[1], device=dev)
    out = torch.zeros((ts.shape[1], 2, margin + ts.shape[0] * n), dtype=torch.float32,
                      device=dev)
    for k in range(ts.shape[0]):
        out[..., margin + k * n : margin + (k + 1) * n] = enc.encode(ts[k])[..., :n]
    return out


def _step_timing(run, n_fields: int, dev) -> tuple[float, int, int]:
    """run(k) over WARM untimed then TIMED timed fields: (ms/field by CUDA
    events, peak bytes allocated in the timed fields, that peak less what
    was allocated before them: the phase's own inputs)."""
    import torch

    for k in range(WARM):
        run(k)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(WARM, n_fields):
        run(k)
    stop.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    return start.elapsed_time(stop) / TIMED, peak, peak - base


def full_adaptive(dev) -> None:
    """Phase 21: the adaptive receive step at B=384, timed, for adaptive,
    train_every=4 and adaptive-dd; then each stage alone."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import decode_field, init_decoder_state
    from atsc_tpu_torch.models.receiver import _osc_planar
    from atsc_tpu_torch.ops import adaptive_eq as ae
    from atsc_tpu_torch.ops.decode import derandomize_field
    from atsc_tpu_torch.ops.slicer import slice_symbols

    n = P.SYMBOLS_PER_FIELD
    m = ae.WINDOW_MARGIN
    n_fields = WARM + TIMED
    ts = _random_ts_dev(dev, n_fields + 1, 2121)
    x = _stream_planes(dev, ts, m)
    # a two-path channel, y = h0 x + h5 x[n-5] with h0 = 0.9 e^{0.3i},
    # h5 = 0.15 e^{-0.9i}, in planar form
    y = torch.zeros_like(x)
    for (c, d), lag in (((0.9 * 0.955336, 0.9 * 0.295520), 0),
                        ((0.15 * 0.621610, -0.15 * 0.783327), 5)):
        xr, xi = x[:, 0, : x.shape[-1] - lag], x[:, 1, : x.shape[-1] - lag]
        y[:, 0, lag:] += c * xr - d * xi
        y[:, 1, lag:] += c * xi + d * xr
    del x, xr, xi
    wins = [y[..., k * n : k * n + n + 2 * m] for k in range(n_fields)]
    oscs = [torch.tensor(_osc_planar(k * n - m, k * n + n + m, 0), device=dev)
            for k in range(n_fields)]
    for name, kw in (("adaptive", {}), ("train_every4", dict(train_every=4)),
                     ("adaptive_dd", dict(decision_directed=True))):
        eq = ae.AdaptiveEqualizer(batch=B_FULL, apply_precision="default", device=dev, **kw)
        state = init_decoder_state(B_FULL, device=dev)
        outs, syns = [], []

        def run(k):
            nonlocal state
            sym = eq.process_field(wins[k], oscs[k], k % 2)
            state, cw, syn = decode_field(state, sym)
            outs.append(derandomize_field(cw))
            syns.append(syn)

        ms, peak, above = _step_timing(run, n_fields, dev)
        exact = all(torch.equal(outs[k], ts[k - 1]) for k in range(1, n_fields))
        clean = not any(bool(syns[k].any()) for k in range(1, n_fields))
        del outs, syns
        # one more field with host syncs made errors: the equalizer (its
        # Gram, Cholesky and triangular solves) never waits for the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            eq.process_field(wins[WARM], oscs[WARM], WARM % 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # each stage alone, on the first timed field's inputs
        win, osc = wins[WARM], oscs[WARM]
        t = ae.const(ae._sync_targets, dev)[WARM % 2]
        stages = {}

        def design():
            ur, ui = ae._derotate(win, osc)
            return ae._design(ae._training_windows(ur, m), ae._training_windows(ui, m))

        stages["derotate_windows"] = timed(design, reps=5)
        xd = design()
        xt = xd.transpose(1, 2)

        def gram():
            with ae.fp32_matmul():
                return torch.bmm(xt, xd), xt @ t

        stages["gram"] = timed(gram, reps=5)
        r, v = eq.state.r, eq.state.v
        with ae.fp32_matmul():
            stages["solve"] = timed(lambda: ae._solve_taps(r, v, eq._ridge), reps=5)
            w = ae._solve_taps(r, v, eq._ridge)
        stages["apply"] = timed(lambda: ae._apply_taps(w, win, osc, m, True, "default"), reps=5)
        lev = ae._apply_taps(w, win, osc, m, True, "default")
        # the dd step solves and applies twice (first pass, then refined)
        runs = {"solve": 2, "apply": 2} if kw.get("decision_directed") else {}
        if runs:
            stages["dd_gram"] = timed(lambda: ae.dd_gram(r, v, lev, win, osc, margin=m), reps=2)
        stages["slice"] = timed(lambda: slice_symbols(lev), reps=5)
        sym = slice_symbols(lev)
        st0 = init_decoder_state(B_FULL, device=dev)
        stages["decode"] = timed(lambda: derandomize_field(decode_field(st0, sym)[1]), reps=5)
        del xd, xt, lev, sym, eq
        torch.cuda.empty_cache()
        per_field = {k: v2 * runs.get(k, 1) for k, v2 in stages.items()}
        total = sum(per_field.values())
        emit("full_adaptive", batch=B_FULL, variant=name, apply_precision="default",
             timed_fields=TIMED, ms_per_field=ms,
             realtime_channels=B_FULL / (ms / 1e3 * P.FIELD_RATE),
             max_memory_allocated=peak, step_memory_above_inputs=above,
             ts_exact_all_channels=exact, syndromes_zero=clean, host_syncs_in_a_field=0,
             stages_ms=stages, stage_runs_per_trained_field=runs, stages_sum_ms=total,
             stage_shares={k: v2 / total for k, v2 in per_field.items()})
        check(exact, f"B={B_FULL} {name}: decoded TS differs from the sent TS")
    del wins, oscs, y, ts
    torch.cuda.empty_cache()


def full_erasures(dev) -> None:
    """Phase 22: the zf + burst-erasure receive step at B=384 with a burst
    in every field, timed; then each stage alone."""
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.decoder import decode_field, init_decoder_state
    from atsc_tpu_torch.models.receiver import EQ_PROFILES, device_eq_step
    from atsc_tpu_torch.ops.cuda.eq_fir import WIN_LEN
    from atsc_tpu_torch.ops.decode import derandomize_field, propagate_erasure_flags
    from atsc_tpu_torch.ops.erasures import burst_erasure_flags_dev
    from atsc_tpu_torch.ops.rs_decode import rs_correct_field, rs_correct_field_erasures
    from atsc_tpu_torch.ops.slicer import slice_symbols

    n = P.SYMBOLS_PER_FIELD
    eq_k, _ = EQ_PROFILES["fast"]
    n_fields = WARM + TIMED
    ts = _random_ts_dev(dev, n_fields + 1, 2222)
    x = _stream_planes(dev, ts, eq_k)
    gen = torch.Generator(dev).manual_seed(22)
    for k in range(n_fields + 1):
        s0 = eq_k + k * n + BURST_AT
        x[..., s0 : s0 + BURST_LEN] += BURST_SCALE / 2 ** 0.5 * torch.randn(
            (B_FULL, 2, BURST_LEN), generator=gen, device=dev)
    wins = [x[..., k * n : k * n + WIN_LEN].contiguous() for k in range(n_fields)]
    del x
    oscs = _field_oscs(dev, n_fields, eq_k)
    step = device_eq_step(True, 1.0, "fast")
    state = init_decoder_state(B_FULL, device=dev)
    carry = torch.zeros((B_FULL, P.DATA_PER_FIELD), dtype=torch.uint8, device=dev)
    outs, ns = [], []

    def run(k):
        nonlocal state, carry
        lev = step(wins[k], oscs[k])
        flags = burst_erasure_flags_dev(lev)
        state, cw, syn = decode_field(state, slice_symbols(lev))
        cw_flags, carry = propagate_erasure_flags(flags, carry)
        cw, nerr = rs_correct_field_erasures(cw, syn, cw_flags)
        outs.append(derandomize_field(cw))
        ns.append(nerr)

    ms, peak, above = _step_timing(run, n_fields, dev)
    exact = all(torch.equal(outs[k], ts[k - 1]) for k in range(1, n_fields))
    decodable = all(bool((ns[k] >= 0).all()) for k in range(1, n_fields))
    corrected = int(sum(int((ns[k] > 0).sum()) for k in range(WARM, n_fields)))
    del outs, ns
    win, osc = wins[WARM], oscs[WARM]
    stages = {"eq": timed(lambda: step(win, osc), reps=5)}
    lev = step(win, osc)
    stages["detector"] = timed(lambda: burst_erasure_flags_dev(lev), reps=5)
    flags = burst_erasure_flags_dev(lev)
    stages["slice"] = timed(lambda: slice_symbols(lev), reps=5)
    sym = slice_symbols(lev)
    st0 = init_decoder_state(B_FULL, device=dev)
    stages["decode_field"] = timed(lambda: decode_field(st0, sym), reps=5)
    _, cw, syn = decode_field(st0, sym)
    c0 = torch.zeros_like(carry)
    stages["flag_propagation"] = timed(lambda: propagate_erasure_flags(flags, c0), reps=5)
    cw_flags, _ = propagate_erasure_flags(flags, carry)
    stages["rs_erasures"] = timed(lambda: rs_correct_field_erasures(cw, syn, cw_flags), reps=3)
    stages["derandomize"] = timed(lambda: derandomize_field(cw), reps=5)
    total = sum(stages.values())
    # not a stage of the step: the errors-only corrector on the same field
    errors_only_ms = timed(lambda: rs_correct_field(cw, syn), reps=3)
    emit("full_erasures", batch=B_FULL, profile="fast", timed_fields=TIMED,
         burst={"at": BURST_AT, "samples": BURST_LEN, "scale": BURST_SCALE,
                "every_field": True},
         ms_per_field=ms, realtime_channels=B_FULL / (ms / 1e3 * P.FIELD_RATE),
         max_memory_allocated=peak, step_memory_above_inputs=above,
         ts_exact_all_channels=exact, segments_corrected_timed=corrected, stages_ms=stages, stages_sum_ms=total,
         stage_shares={k: v / total for k, v in stages.items()},
         rs_errors_only_ms=errors_only_ms)
    check(exact and decodable, f"B={B_FULL} erasures: decoded TS differs from the sent TS")
    check(corrected > 0, f"B={B_FULL} erasures: RS corrected nothing")
    del wins, oscs, ts, lev, flags, sym, cw, syn, cw_flags
    torch.cuda.empty_cache()


# -- 23-25: the capture conditioning front end ---------------------------------

RATE_FIELDS = 48         # phase 24: 1.16 s of air at 20 MS/s, 23.2 M samples
RATE_SPS = "20e6"
RATE_CMP_SAMPLES = 2_000_000
RESYNC_FIELDS = 9        # phase 25: tests/test_resync.py:26's capture
RESYNC_CUT, RESYNC_DROP, RESYNC_CHUNK = 3 * 260_416 + 123_456, 7_019, 100_003
MER_TOL_DB = 0.5         # card against CPU --stats mer_db (adaptive levels ~1e-3 apart)


CHUNKS = (2, 8, 24, 92)   # phase 26: W mod 4 = 0, 3, 1, 2
CHUNK_MAIN = 24           # the chunk count of the decode drives (phases 24, 26, 27)
CHUNK_SNR_DB = 14.0       # phase 26's IQ-domain AWGN for the chunked-equals-exact TS
# phase 26's decode steps: (rounds, calls a round); a B=1 step is ~1-6 ms
STEP_ROUNDS = {384: (5, 4), 1: (15, 20)}
HEADEND_SLOTS = 23        # phase 27: UHF channels 14-36, the post-repack band, 138 MHz
HEADEND_FIELDS = 8
MUX_RATE_SLOTS, MUX_RATE_FIELDS, MUX_RATE_SPS = 4, 4, "30.72e6"


def _chunk_bounds(t: int, l: int, c: int, w: int, offs) -> dict:
    """The chunked kernels' bounds at C chunks of W steps over L lanes. The
    forward passes read their inputs once: the unchunked (T, L) obs and (T,
    12) rc, whose rows in two overlapping windows are one read, not two;
    they write their window decisions and final metrics once. The
    tracebacks read their windows from the top down to their kept regions
    and write the (T/4, L) words. The operations are every window step's
    ACS. `window_obs_bytes` is what the forward passes read when each
    window's rows are fetched anew (the overlaps counted again)."""
    walked = int(sum(w - int(o) for o in offs))          # traceback steps per lane
    words = -(-w // 4)
    return {
        "acs_forward": dict(_bound(t * l * 4 + words * c * l * 4 + 2 * 4 * c * l * 4,
                                   w * c * l * (ACS_FLOPS + 7)),
                            window_obs_bytes=w * c * l * 4),
        "acs_forward_int8": _bound(t * l + words * c * l * 4 + 2 * 4 * c * l * 4,
                                   w * c * l * (ACS_FLOPS + 8)),
        "traceback": _bound(l * walked + t * l + c * l * 4, 0),
        "pr_acs_forward": dict(_bound(t * l * 4 + t * 12 * 4 + w * c * l * 4
                                      + 2 * 16 * c * l * 4, w * c * l * (PR_FLOPS + 31)),
                               window_obs_bytes=w * c * l * 4 + w * c * 12 * 4),
        "pr_traceback": _bound(l * walked * 4 + t * l + c * l * 4, 0),
    }


def _timed_rounds(runs: dict, rounds: int, reps: int) -> dict:
    """Each of runs' callables timed `rounds` times, in turns with the
    others (timed_with_host(fn, reps) each; the order rotated every round,
    so a drift of the card or the host falls on all of them alike). Per
    name: the median of the round means, their least and greatest, device
    ms; and host_ms, the median of the host's times to issue one call: a
    step whose host_ms is about its ms is bound by the host."""
    import numpy as np

    names, got, host = list(runs), {k: [] for k in runs}, {k: [] for k in runs}
    for r in range(rounds):
        k0 = r % len(names)
        for k in names[k0:] + names[:k0]:
            ms, host_ms = timed_with_host(runs[k], reps=reps)
            got[k].append(ms)
            host[k].append(host_ms)
    return {k: {"ms": float(np.median(v)), "min_ms": min(v), "max_ms": max(v),
                "host_ms": float(np.median(host[k]))} for k, v in got.items()}


def viterbi_chunked(dev) -> dict:
    """Phase 26: the chunked instantiations of the four Viterbi kernels
    against their plain twins on the card, bit for bit, at B=384 and B=1 for
    every chunk count of CHUNKS (float32 and int8 4-state passes, the PR
    pass with its reset steps: every window of every C holds one for every
    encoder, checked first; both tracebacks), each timed beside its
    bound; the soft, soft-i8 and NTSC decode steps at B=384 and B=1, exact
    against chunked, timed in rounds (_timed_rounds); then B=8 at
    CHUNK_SNR_DB through IqReceiver, chunked TS equal to the exact TS (the
    counts zeroed before each chunked decode and read after). Returns the
    kernels-line fields per kernel and the chunked launches of the
    IqReceiver decodes."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models import decoder as dec_mod
    from atsc_tpu_torch.ops.cuda import viterbi_acs as vk
    from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV, quantize_soft_levels
    from atsc_tpu_torch.ops.viterbi import _chunk_plan

    t = P.TRELLIS_SYMBOLS_PER_ENCODER
    gen = torch.Generator(dev).manual_seed(26)
    rc_np = vk._pr_rc_table()
    rc = torch.tensor(rc_np, device=dev)
    per = {k: {} for k in vk.KERNELS}
    checks = {}
    for c in CHUNKS:   # the PR pass's reset branch runs in every window, for every encoder
        _, w, starts, _ = _chunk_plan(t, c, vk.WARMUP)
        check(all(bool((rc_np[s:s + w] & 1).any(axis=0).all()) for s in starts),
              f"C={c}: a window of {w} steps holds no reset step for some encoder")
    for b in (B_FULL, 1):
        l = 12 * b
        ideal = (torch.randint(0, 8, (t + 1, l), generator=gen, device=dev).float() * 2 - 7
                 + P.PILOT_OFFSET)
        lev = ideal + KERNEL_LEVEL_SIGMA * torch.randn(ideal.shape, generator=gen, device=dev)
        obs = lev[1:].contiguous()
        codes = quantize_soft_levels(obs)
        comb = (lev[1:] - lev[:-1]).contiguous()     # the comb: one encoder step back
        del ideal, lev
        for c in CHUNKS:
            length, w, _, offs = _chunk_plan(t, c, vk.WARMUP)
            m4 = torch.zeros((4, c * l), device=dev)
            m4[1:, :l] = 1e9                              # chunk 0 from a cold start
            m16 = torch.zeros((16, c * l), device=dev)
            m16[1:, :l] = 1e9
            bounds = _chunk_bounds(t, l, c, w, offs)
            row = {}
            (dec, mo), ok, err, ms, pms = _held(
                lambda: vk.acs_forward_chunked(obs, m4, c),
                lambda: vk.acs_forward_chunked_plain(obs, m4, c))
            checks[f"acs_forward_b{b}_c{c}"] = ok
            row["acs_forward"] = dict(ms=ms, plain_ms=pms, max_abs_err=err, **bounds["acs_forward"])
            _, ok, err, ms, pms = _held(
                lambda: vk.acs_forward_chunked(codes, m4, c, inv_scale=SOFT_LEVEL_INV),
                lambda: vk.acs_forward_chunked_plain(codes, m4, c, inv_scale=SOFT_LEVEL_INV))
            checks[f"acs_forward_int8_b{b}_c{c}"] = ok
            row["acs_forward"].update(ms_int8=ms, plain_ms_int8=pms, bound_int8=bounds[
                "acs_forward_int8"], max_abs_err=max(err, row["acs_forward"]["max_abs_err"]))
            start = torch.argmin(mo, dim=0).to(torch.int32)
            _, ok, err, ms, pms = _held(lambda: vk.traceback_chunked(dec, start, t, c),
                                        lambda: vk.traceback_chunked_plain(dec, start, t, c))
            checks[f"traceback_b{b}_c{c}"] = ok
            row["traceback"] = dict(ms=ms, plain_ms=pms, max_abs_err=err, **bounds["traceback"])
            del dec
            (dec, mo), ok, err, ms, pms = _held(
                lambda: vk.pr_acs_forward_chunked(comb, rc, m16, c),
                lambda: vk.pr_acs_forward_chunked_plain(comb, rc, m16, c))
            checks[f"pr_acs_forward_b{b}_c{c}"] = ok
            row["pr_acs_forward"] = dict(ms=ms, plain_ms=pms, max_abs_err=err,
                                         **bounds["pr_acs_forward"])
            start = torch.argmin(mo, dim=0).to(torch.int32)
            _, ok, err, ms, pms = _held(lambda: vk.pr_traceback_chunked(dec, start, t, c),
                                        lambda: vk.pr_traceback_chunked_plain(dec, start, t, c))
            checks[f"pr_traceback_b{b}_c{c}"] = ok
            row["pr_traceback"] = dict(ms=ms, plain_ms=pms, max_abs_err=err,
                                       **bounds["pr_traceback"])
            del dec, mo
            for k, v in row.items():
                per[k].setdefault(str(c), {})["b1" if b == 1 else f"b{B_FULL}"] = v
            emit("viterbi_chunked", batch=b, chunks=c, window=w, kept=length,
                 identical={k: checks[f"{k}_b{b}_c{c}"] for k in
                            ("acs_forward", "acs_forward_int8", "traceback", "pr_acs_forward",
                             "pr_traceback")}, **row)
        del obs, codes, comb
        torch.cuda.empty_cache()
    for k, ok in checks.items():
        check(ok, f"{k}: the chunked kernel differs from its plain twin")

    # the decode steps a receiver runs, exact (C = 1) against chunked, on
    # random soft levels, in rounds
    steps = {}
    for b in (B_FULL, 1):
        ideal = (torch.randint(0, 8, (b, P.SYMBOLS_PER_FIELD), generator=gen, device=dev)
                 .float() * 2 - 7 + P.PILOT_OFFSET)
        lev = ideal + KERNEL_LEVEL_SIGMA * torch.randn(ideal.shape, generator=gen, device=dev)
        for tier in ("soft", "soft-i8", "ntsc"):
            ntsc = tier == "ntsc"
            decode = dec_mod.ntsc_decode_field if ntsc else dec_mod.soft_decode_field
            state = (dec_mod.init_ntsc_decoder_state if ntsc else
                     dec_mod.init_soft_decoder_state)(b, device=dev)
            x = quantize_soft_levels(lev) if tier == "soft-i8" else lev
            runs = {str(c): functools.partial(decode, state, x, n_chunks=c)
                    for c in (1, *CHUNKS)}
            _zero_launches()
            runs[str(CHUNK_MAIN)]()
            torch.cuda.synchronize()
            got = dict(vk.LAUNCHES)
            path = (("pr_acs_forward_chunked", "pr_traceback_chunked") if ntsc
                    else ("acs_forward_chunked", "traceback_chunked"))
            check(all(got[k] == (1 if k in path else 0) for k in got),
                  f"{tier} step at C={CHUNK_MAIN}: launches {got} for one step")
            row = _timed_rounds(runs, *STEP_ROUNDS[1 if b == 1 else 384])
            for c in CHUNKS:
                row[str(c)]["vs_exact"] = row[str(c)]["ms"] / row["1"]["ms"]
            steps[f"{tier}_b{b}"] = row
        del lev, ideal
    emit("viterbi_chunked_steps", ms_per_field=steps, chunks_main=CHUNK_MAIN,
         rounds={str(k): v for k, v in STEP_ROUNDS.items()},
         note="key '1' is the exact tier; ms is the median of the round means")

    # the same receiver at CHUNK_SNR_DB, exact and chunked: the same TS
    def awgn(iq, rng):
        sig = np.sqrt(np.mean(np.abs(iq) ** 2))
        noise = rng.normal(0, 1, iq.shape) + 1j * rng.normal(0, 1, iq.shape)
        return iq + noise * sig * 10 ** (-CHUNK_SNR_DB / 20) / np.sqrt(2)

    ts, cap = _noisy_capture(dev, 26, awgn)
    tiers, main = {}, dict.fromkeys(vk.CHUNKED, 0)
    for name, kw in (("soft", dict(trellis="soft")), ("ntsc", dict(ntsc="comb"))):
        ex, ex_out = _receive(dev, cap, **kw)
        _zero_launches()
        ch, ch_out = _receive(dev, cap, viterbi_chunks=CHUNK_MAIN, **kw)
        got = dict(vk.LAUNCHES)
        path = (("pr_acs_forward_chunked", "pr_traceback_chunked") if name == "ntsc"
                else ("acs_forward_chunked", "traceback_chunked"))
        check(all((got[k] == len(ch_out) + 1) if k in path else got[k] == 0 for k in got),
              f"IqReceiver {name} with viterbi_chunks: launches {got} for "
              f"{len(ch_out)} decoded fields")
        for k in path:
            main[k] += got[k]
        same = len(ch_out) == len(ex_out) == 3 and all(
            np.array_equal(a[0], b_[0]) and np.array_equal(a[1], b_[1])
            for a, b_ in zip(ch_out, ex_out))
        tiers[name] = {"chunked_equals_exact": same, "ts_exact": _exact(ch_out, ts),
                       "segments_corrected": ch.decoder.segments_corrected,
                       "segments_uncorrectable": ch.decoder.segments_uncorrectable,
                       "exact_segments_uncorrectable": ex.decoder.segments_uncorrectable,
                       "launches": {k: got[k] for k in path}}
    emit("viterbi_chunked_snr", batch=B_NOISY, snr_db=CHUNK_SNR_DB, chunks=CHUNK_MAIN,
         tiers=tiers)
    check(tiers["soft"]["chunked_equals_exact"] and tiers["soft"]["ts_exact"],
          f"{CHUNK_SNR_DB} dB: the chunked soft tier is not the exact tier's sent TS {tiers}")
    check(tiers["ntsc"]["chunked_equals_exact"],
          f"{CHUNK_SNR_DB} dB: the chunked comb tier differs from the exact one {tiers}")
    return {"per": per, "launches": main}


def headend(dev, tmp: str) -> dict:
    """Phase 27: the wideband headend round trip at full width, B =
    HEADEND_SLOTS: `cli encode --channels 23 --mux` of HEADEND_FIELDS
    seeded fields (one TS file per channel) and `cli decode --demux 23
    --trellis viterbi --viterbi-chunks 24 -o 'slot{ch}.ts'`, every slot's
    TS byte-exact with no uncorrectable segment; host real-time factors
    (wall clock of each whole run, start-up included; and steady: the
    encode's mean step from its --stats, the decode's host s per field
    beyond a `--max-fields 3` run of the same capture), peak device
    memory, the launches of the decode's main path; the mux
    and demux block products of one field timed by CUDA events. Then a
    B=4 `--mux --rate 30.72e6` -> `--demux 4 --rate 30.72e6` drive. The
    band's TS files and capture stay in `tmp` for phases 28-29. Returns
    the decode's chunked launches and the band: {"ts", "paths", "cap"}."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.ops import mux as mx
    from atsc_tpu_torch.ops.cuda import offset_fir as fir

    n, b = P.SYMBOLS_PER_FIELD, HEADEND_SLOTS
    period_s = 1.0 / P.FIELD_RATE
    rng = np.random.default_rng(27)
    ts = rng.integers(0, 256, size=(HEADEND_FIELDS, b, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts[..., :: P.MPEG2_BYTES] = 0x47
    paths = [os.path.join(tmp, f"ch{k}.ts") for k in range(b)]
    for k, path in enumerate(paths):
        ts[:, k].tofile(path)
    cap = os.path.join(tmp, "band.iq")
    torch.cuda.reset_peak_memory_stats(dev)
    fir.LAUNCHES = 0
    rc_enc, enc_stats, enc_wall = _cli([*paths, "--channels", str(b), "--mux", "-o", cap,
                                        "--stats"])
    enc_launches = fir.LAUNCHES
    enc_peak = torch.cuda.max_memory_allocated(dev)
    n_cap = os.path.getsize(cap) // 8
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_all_launches()
    rc, stats, wall = _cli(["decode", cap, "--demux", str(b), "--trellis", "viterbi",
                            "--viterbi-chunks", str(CHUNK_MAIN), "--stats",
                            "-o", os.path.join(tmp, "slot{ch}.ts")])
    launches = _launches()
    dec_peak = torch.cuda.max_memory_allocated(dev)
    slots = [np.fromfile(os.path.join(tmp, f"slot{k}.ts"), np.uint8) for k in range(b)]
    rc3, stats3, wall3 = _cli(["decode", cap, "--demux", str(b), "--trellis", "viterbi",
                               "--viterbi-chunks", str(CHUNK_MAIN), "--max-fields", "3",
                               "--stats", "-o", os.path.join(tmp, "first{ch}.ts")])
    band_paths, band_cap = paths, cap
    fd, fd3 = stats["fields_decoded"], stats3["fields_decoded"]
    dec_field_s = (wall - wall3) / max(1, fd - fd3)   # host s per field, start-up excluded
    exact = [slots[k].tobytes() == ts[:fd, k].tobytes() for k in range(b)]
    want_n = -(-HEADEND_FIELDS * n // mx.RESAMPLE_DOWN) * mx.RESAMPLE_UP * b

    # the two block products of one field at B = 23, alone (CUDA events)
    gen = torch.Generator(dev).manual_seed(27)
    n_blk = -(-n // mx.RESAMPLE_DOWN)
    x = torch.randn((b, 2, n_blk * mx.RESAMPLE_DOWN + 2 * mx._HALO), generator=gen, device=dev)
    halo = mx._demux_halo(b)
    y = torch.randn((2, n_blk * mx.RESAMPLE_UP * b + 2 * halo), generator=gen, device=dev)
    mux_ms = timed(lambda: mx.mux_blocks(x), reps=5)
    demux_ms = timed(lambda: mx.demux_blocks(y, b), reps=5)
    mux_flops = 2 * b * 2 * n_blk * (mx.RESAMPLE_DOWN + 2 * mx._HALO) * mx.RESAMPLE_UP * b
    demux_flops = 2 * b * 2 * n_blk * (mx.RESAMPLE_UP * b + 2 * halo) * mx.RESAMPLE_DOWN
    del x, y
    torch.cuda.empty_cache()
    emit("headend", slots=b, band_mhz=6 * b, fields=HEADEND_FIELDS, capture_samples=n_cap,
         encode={"rc": rc_enc, "stats": enc_stats, "host_s": enc_wall,
                 "realtime_factor_wall_with_startup": HEADEND_FIELDS * period_s / enc_wall,
                 "realtime_factor_steady": period_s * 1e3 / enc_stats["step_ms_mean"],
                 "offset_fir_launches": enc_launches, "max_memory_allocated": enc_peak},
         decode={"rc": rc, "stats": stats, "host_s": wall,
                 "realtime_factor_wall_with_startup": HEADEND_FIELDS * period_s / wall,
                 "max_fields_3": {"rc": rc3, "fields_decoded": fd3, "host_s": wall3},
                 "host_s_per_field_steady": dec_field_s,
                 "realtime_factor_steady": period_s / dec_field_s,
                 "ts_exact_slots": sum(exact), "launches": launches,
                 "max_memory_allocated": dec_peak},
         mux_ms_per_field=mux_ms, demux_ms_per_field=demux_ms,
         mux_tflops=mux_flops / mux_ms / 1e9, demux_tflops=demux_flops / demux_ms / 1e9,
         field_period_ms=period_s * 1e3)
    check(rc_enc == 0 and enc_stats["fields"] == HEADEND_FIELDS * b
          and enc_stats["device"] == str(dev), f"encode --mux: rc {rc_enc}, {enc_stats}")
    check(n_cap == want_n, f"encode --mux wrote {n_cap} samples, want {want_n}")
    check(enc_launches == HEADEND_FIELDS, f"encode --mux: {enc_launches} offset_fir launches")
    check(rc == 0 and stats["device"] == str(dev) and fd == HEADEND_FIELDS - 1 and all(exact)
          and stats["segments_uncorrectable"] == 0,
          f"decode --demux {b}: {sum(exact)} of {b} slots byte-exact ({stats})")
    check(rc3 == 0 and fd3 == 3, f"decode --demux {b} --max-fields 3: rc {rc3}, {stats3}")
    check(launches["acs_forward_chunked"] == fd + 1 and launches["traceback_chunked"] == fd + 1
          and launches["acs_forward"] == 0 and launches["traceback"] == 0
          and launches["eq_fir_fused"] == 0,
          f"decode --demux: launches {launches} for {fd} decoded fields")

    # B=4 at an SDR master clock: --mux --rate -> --demux --rate
    b4 = MUX_RATE_SLOTS
    ts4 = rng.integers(0, 256, size=(MUX_RATE_FIELDS, b4, P.FIELD_TS_BYTES), dtype=np.uint8)
    ts4[..., :: P.MPEG2_BYTES] = 0x47
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        paths = [os.path.join(tmp, f"ch{k}.ts") for k in range(b4)]
        for k, path in enumerate(paths):
            ts4[:, k].tofile(path)
        cap = os.path.join(tmp, "band30.iq")
        rc4e, st4e, _ = _cli([*paths, "--mux", "--rate", MUX_RATE_SPS, "-o", cap, "--stats"])
        rc4, st4, wall4 = _cli(["decode", cap, "--demux", str(b4), "--rate", MUX_RATE_SPS,
                                "--trellis", "viterbi", "--viterbi-chunks", str(CHUNK_MAIN),
                                "--stats", "-o", os.path.join(tmp, "out.ts")])
        out4 = np.fromfile(os.path.join(tmp, "out.ts"), np.uint8)
    fd4 = st4["fields_decoded"]
    exact4 = fd4 >= MUX_RATE_FIELDS - 2 and out4.tobytes() == ts4[1:1 + fd4].tobytes()
    emit("headend_rate", slots=b4, sps=float(MUX_RATE_SPS), encode={"rc": rc4e, "stats": st4e},
         decode={"rc": rc4, "stats": st4, "host_s": wall4, "ts_exact": exact4})
    check(rc4e == 0 and st4e["output_rate"] == float(MUX_RATE_SPS),
          f"encode --mux --rate: {st4e}")
    check(rc4 == 0 and st4["align_parity"] == 1 and st4["segments_uncorrectable"] == 0 and exact4,
          f"decode --demux --rate: the TS is not the sent TS from field 1 ({st4})")
    return {"launches": {k: launches[k] for k in ("acs_forward_chunked", "traceback_chunked")},
            "band": {"ts": ts, "paths": band_paths, "cap": band_cap}}


def _host_ts(rng, n_fields: int):
    """(n_fields, 58656) random TS with packet syncs (tests/test_decoder.py's
    _random_ts at one channel, the same draws)."""
    from atsc_tpu_torch import params as P

    ts = rng.integers(0, 256, size=(n_fields, 1, P.FIELD_TS_BYTES), dtype="uint8")
    ts[..., :: P.MPEG2_BYTES] = 0x47
    return ts[:, 0]


def _encode_host(dev, ts):
    """(F, 58656) TS -> (F*N,) complex64 through Encoder(batch=1) on dev."""
    import numpy as np

    from atsc_tpu_torch.models.encoder import Encoder, iq_to_complex

    enc = Encoder(batch=1, device=dev)
    return np.concatenate([iq_to_complex(enc.encode(ts[k][None]))[0]
                           for k in range(ts.shape[0])])


def _cli(argv: list) -> tuple[int, dict, float]:
    """cli.main(argv) with stderr captured: (rc, the --stats line, host s)."""
    from atsc_tpu_torch import cli

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    return rc, json.loads(err.getvalue().strip().splitlines()[-1]), wall


def _same_summary(card: dict, host: dict) -> bool:
    """Every --stats key equal but `device`, mer_db within MER_TOL_DB."""
    if set(card) != set(host):
        return False
    return all(abs(card[k][0] - host[k][0]) <= MER_TOL_DB if k == "mer_db" else card[k] == host[k]
               for k in card if k != "device")


def gauntlet(dev) -> None:
    """Phase 23: tests/test_gauntlet.py:22's capture (every impairment at
    once) through `cli decode --sro auto --cfo auto --trellis viterbi
    --erasures burst` on the card, and on the CPU for comparison; then
    tests/test_resync.py:86's tuner step through `--cfo track`."""
    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.receiver import resample_stream

    n = P.SYMBOLS_PER_FIELD
    rng = np.random.default_rng(131)
    ts = _host_ts(rng, 5)
    iq = _encode_host(dev, ts)
    y = np.convolve(iq, [0.85 * np.exp(0.7j), 0, 0.12 * np.exp(-1.1j), 0, 0.05j])[: iq.size]
    y = y * np.exp(2j * np.pi * 400.0 / P.SAMPLE_RATE * np.arange(y.size))
    y = resample_stream(y, 1.0 / (1.0 + 25e-6))[0]
    sigma = np.sqrt(float(np.mean(np.abs(y) ** 2)) / 10 ** (24.0 / 10.0) / 2.0)
    y = y + (rng.normal(size=y.size) + 1j * rng.normal(size=y.size)) * sigma
    s0 = 2 * n + 97_000
    y[s0 : s0 + 2600] += (rng.normal(size=2600) + 1j * rng.normal(size=2600)) * 4.0
    y = y[77_777:]
    flags = ["--sro", "auto", "--cfo", "auto", "--trellis", "viterbi", "--erasures", "burst",
             "--stats"]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        cap = os.path.join(tmp, "gauntlet.iq")
        np.stack([y.real, y.imag], -1).astype(np.float32).tofile(cap)
        _zero_all_launches()
        rc, stats, wall = _cli(["decode", cap, *flags, "-o", os.path.join(tmp, "card.ts")])
        launches = _launches()
        rc_cpu, stats_cpu, wall_cpu = _cli(["decode", cap, *flags, "--device", "cpu",
                                            "-o", os.path.join(tmp, "cpu.ts")])
        got = np.fromfile(os.path.join(tmp, "card.ts"), np.uint8)
        got_cpu = np.fromfile(os.path.join(tmp, "cpu.ts"), np.uint8)
    fd = stats["fields_decoded"]
    exact = got.tobytes() == ts[1 : 1 + fd].tobytes()
    # the decoder also runs on the first aligned field, whose output the
    # one-field interleaver latency discards: fd + 1 fields per kernel
    want_launches = {"eq_fir_fused": 0, "acs_forward": fd + 1, "traceback": fd + 1,
                     "pr_acs_forward": 0, "pr_traceback": 0,
                     **{k + "_chunked": 0 for k in ("acs_forward", "traceback",
                                                    "pr_acs_forward", "pr_traceback")}}
    emit("gauntlet", capture={"fields": 5, "multipath": True, "cfo_hz": 400.0, "sro_ppm": 25.0,
                              "snr_db": 24.0, "burst": [s0, 2600, 4.0], "cut": 77_777},
         rc=rc, stats=stats, host_s=wall, host_s_per_field=wall / fd, ts_exact=exact,
         launches=launches, cpu={"rc": rc_cpu, "stats": stats_cpu, "host_s": wall_cpu,
                                 "ts_identical": got.tobytes() == got_cpu.tobytes(),
                                 "summary_identical": _same_summary(stats, stats_cpu)})
    check(rc == 0 and rc_cpu == 0, f"gauntlet: cli decode returned {rc} / {rc_cpu} (cpu)")
    check(stats["device"] == str(dev), f"gauntlet: decoded on {stats['device']}")
    check(fd >= 2 and exact, f"gauntlet: the TS is not the sent TS ({stats})")
    check(abs(stats["sro_ppm"] - 25.0) < 1.0 and abs(stats["cfo_hz"] - 400.0) < 2.0,
          f"gauntlet: sro/cfo estimates {stats}")
    check(stats["segments_uncorrectable"] == 0, f"gauntlet: uncorrectable segments {stats}")
    check(launches == want_launches, f"gauntlet: launches {launches}, want {want_launches}")
    check(got.tobytes() == got_cpu.tobytes() and _same_summary(stats, stats_cpu),
          f"gauntlet: card {stats} and CPU {stats_cpu} disagree")

    # tests/test_resync.py:86: 180 Hz stepping by 35 Hz at field 6
    n_fields = 14
    ts = _host_ts(np.random.default_rng(47), n_fields)
    iq = _encode_host(dev, ts)
    freq = 180.0 + 35.0 * (np.arange(iq.size) >= 6 * n)
    y = iq * np.exp(2j * np.pi * np.cumsum(freq) / P.SAMPLE_RATE)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        cap = os.path.join(tmp, "step.iq")
        np.stack([y.real, y.imag], -1).astype(np.float32).tofile(cap)
        _zero_all_launches()
        rc, stats, wall = _cli(["decode", cap, "--cfo", "track", "--forgetting", "0.0",
                                "--stats", "-o", os.path.join(tmp, "out.ts")])
        launches = _launches()
        out = np.fromfile(os.path.join(tmp, "out.ts"), np.uint8).reshape(-1, P.FIELD_TS_BYTES)
    kept = [*range(4), *range(11, out.shape[0])]
    exact = all(np.array_equal(out[k], ts[k]) for k in kept)
    emit("gauntlet_cfo_track", capture={"fields": n_fields, "cfo_hz": 180.0, "step_hz": 35.0,
                                        "step_at_field": 6},
         rc=rc, stats=stats, host_s=wall, fields_checked=kept, ts_exact_checked=exact,
         launches=launches)
    check(rc == 0 and stats["cfo_retunes"] >= 1 and abs(stats["cfo_hz"] - 215.0) < 2.0,
          f"cfo track: {stats}")
    check(abs(stats["fields_decoded"] - (n_fields - 1)) <= 1 and exact,
          f"cfo track: fields {kept} are not the sent TS ({stats})")


def rate(dev) -> dict:
    """Phase 24: one 20 MS/s SDR channel: `cli encode --rate 20e6` of
    RATE_FIELDS seeded fields and `cli decode --rate 20e6 --trellis
    viterbi` of what it wrote, on the card, also with `--viterbi-chunks`;
    StreamResampler on the card against the CPU on the first
    RATE_CMP_SAMPLES capture samples, and under two chunkings; the
    resampler's block timed on the card. Returns the chunked decode's
    launches of the chunked kernels."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.ops import resample as rs
    from atsc_tpu_torch.ops.cuda import offset_fir as fir

    n = P.SYMBOLS_PER_FIELD
    period_s = 1.0 / P.FIELD_RATE
    ts = _host_ts(np.random.default_rng(24), RATE_FIELDS)
    ratio = 20e6 / P.SAMPLE_RATE
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO) as tmp:
        src, cap = os.path.join(tmp, "in.ts"), os.path.join(tmp, "cap20.iq")
        ts.tofile(src)
        fir.LAUNCHES = 0
        rc_enc, enc_stats, enc_wall = _cli([src, "-o", cap, "--rate", RATE_SPS, "--stats"])
        enc_launches = fir.LAUNCHES
        n_cap = os.path.getsize(cap) // 8
        _zero_all_launches()
        rc, stats, wall = _cli(["decode", cap, "--rate", RATE_SPS, "--trellis", "viterbi",
                                "--stats", "-o", os.path.join(tmp, "back.ts")])
        launches = _launches()
        back = np.fromfile(os.path.join(tmp, "back.ts"), np.uint8)
        _zero_all_launches()
        rc_c, stats_c, wall_c = _cli(["decode", cap, "--rate", RATE_SPS, "--trellis", "viterbi",
                                      "--viterbi-chunks", str(CHUNK_MAIN), "--stats",
                                      "-o", os.path.join(tmp, "back_chunked.ts")])
        launches_c = _launches()
        back_c = np.fromfile(os.path.join(tmp, "back_chunked.ts"), np.uint8)
        head = np.fromfile(cap, np.complex64, count=RATE_CMP_SAMPLES)[None]
    fd, fd_c = stats["fields_decoded"], stats_c["fields_decoded"]
    exact = back.tobytes() == ts[1 : 1 + fd].tobytes()
    want_n = RATE_FIELDS * n * ratio
    enc_fields = enc_stats["fields"]
    emit("rate_cli", sps=float(RATE_SPS), fields=RATE_FIELDS, capture_samples=n_cap,
         encode={"rc": rc_enc, "stats": enc_stats, "host_s": enc_wall,
                 "host_s_per_field": enc_wall / RATE_FIELDS,
                 "realtime_factor": period_s / (enc_wall / RATE_FIELDS),
                 "offset_fir_launches": enc_launches},
         decode={"rc": rc, "stats": stats, "host_s": wall, "host_s_per_field": wall / fd,
                 "realtime_factor": period_s / (wall / fd), "ts_exact": exact,
                 "launches": launches},
         decode_chunked={"viterbi_chunks": CHUNK_MAIN, "rc": rc_c, "stats": stats_c,
                         "host_s": wall_c, "host_s_per_field": wall_c / max(1, fd_c),
                         "realtime_factor": period_s / (wall_c / max(1, fd_c)),
                         "ts_equal_exact": back_c.tobytes() == back.tobytes(),
                         "launches": launches_c}, field_period_ms=period_s * 1e3)
    check(rc_enc == 0 and enc_fields == RATE_FIELDS and enc_stats["output_rate"] == 20e6
          and enc_stats["device"] == str(dev), f"encode --rate: rc {rc_enc}, {enc_stats}")
    check(abs(n_cap - want_n) < 64, f"encode --rate wrote {n_cap} samples, want ~{want_n:.0f}")
    check(enc_launches == RATE_FIELDS, f"encode --rate: {enc_launches} offset_fir launches")
    check(rc == 0 and stats["device"] == str(dev) and fd >= RATE_FIELDS - 3 and exact
          and stats["segments_uncorrectable"] == 0,
          f"decode --rate: the TS is not the sent TS from the first aligned field ({stats})")
    check(launches["acs_forward"] == fd + 1 and launches["traceback"] == fd + 1,
          f"decode --rate: launches {launches} for {fd} decoded fields")
    check(rc_c == 0 and fd_c == fd and back_c.tobytes() == back.tobytes()
          and stats_c["segments_uncorrectable"] == 0,
          f"decode --rate --viterbi-chunks {CHUNK_MAIN}: not the exact decode's TS ({stats_c})")
    check(launches_c["acs_forward_chunked"] == fd + 1 and launches_c["traceback_chunked"] == fd + 1
          and launches_c["acs_forward"] == 0 and launches_c["traceback"] == 0,
          f"decode --rate --viterbi-chunks: launches {launches_c} for {fd} decoded fields")

    # the resampler itself: card against CPU, and two chunkings on each
    frac = rs.capture_rate(20_000_000)

    def run(device, chunks):
        r = rs.StreamResampler(frac, batch=1, device=device)
        outs, pos = [], 0
        for c in chunks:
            outs.append(r.push(head[:, pos : pos + c]))
            pos += c
        outs.append(r.push(head[:, pos:]))
        outs.append(r.flush())
        return np.concatenate(outs, axis=-1)

    t0 = time.perf_counter()
    card = run(dev, ())
    card_wall = time.perf_counter() - t0
    cut = (1, 999, 65_536, 17, 333_447)
    card_chunked = run(dev, cut)
    cpu = run("cpu", ())
    cpu_chunked = run("cpu", cut)
    err = float(np.abs(card - cpu).max())
    # one full block on the card: CUDA events over back-to-back calls
    r = rs.StreamResampler(frac, batch=1, device=dev)
    m = rs._OUT_BLOCK
    incr = np.arange(m, dtype=np.int64) * r.num
    q, rem = np.divmod(incr, r.den)
    ph = np.minimum((rem * rs.PHASES + r.den // 2) // r.den, rs.PHASES - 1)
    n_win = (r.num * (m - 1) + r.den - 1) // r.den + rs.TAPS
    win = torch.tensor(np.stack([head[0, :n_win].real, head[0, :n_win].imag])[None], device=dev)
    q_d, ph_d = torch.tensor(q, device=dev), torch.tensor(ph, device=dev)
    block_ms = timed(lambda: rs._resample_block(win, q_d, ph_d), reps=20)
    emit("rate_resampler", samples_in=RATE_CMP_SAMPLES, samples_out=int(card.shape[-1]),
         max_abs_err_card_vs_cpu=err, tolerance=1e-6,
         card_chunked_bit_identical=bool(np.array_equal(card, card_chunked)),
         cpu_chunked_bit_identical=bool(np.array_equal(cpu, cpu_chunked)),
         block_outputs=m, block_ms=block_ms, ms_per_field=block_ms * n / m,
         msps=m / (block_ms * 1e-3) / 1e6,
         push_host_s_per_field=card_wall / (card.shape[-1] / n))
    check(card.shape == cpu.shape and err <= 1e-6,
          f"StreamResampler card vs CPU {err} > 1e-6 (shapes {card.shape} {cpu.shape})")
    check(np.array_equal(card, card_chunked) and np.array_equal(cpu, cpu_chunked),
          "StreamResampler: a chunking changed the output")
    return {k: launches_c[k] for k in ("acs_forward_chunked", "traceback_chunked")}


def resync_full(dev) -> None:
    """Phase 25: IqReceiver(batch=B_FULL, backend="adaptive", resync="auto")
    on the card over tests/test_resync.py:26's capture at the headend
    width: a complex gain per channel, one common slip of RESYNC_DROP
    samples at RESYNC_CUT, built on the card field by field and pushed from
    host memory in RESYNC_CHUNK-sample chunks."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.models.receiver import IqReceiver

    n = P.SYMBOLS_PER_FIELD
    ts = _random_ts_dev(dev, RESYNC_FIELDS, 2525)
    enc = Encoder(batch=B_FULL, device=dev)
    gen = torch.Generator(dev).manual_seed(25)
    mag = 0.7 + 0.4 * torch.rand(B_FULL, 1, generator=gen, device=dev)
    ang = 2 * np.pi * torch.rand(B_FULL, 1, generator=gen, device=dev)
    gr, gi = mag * torch.cos(ang), mag * torch.sin(ang)
    cache: dict = {}
    encoded = 0

    def field(k):
        """Original field k through the channel gains, complex on the card
        (fields are asked for in order; two stay cached)."""
        nonlocal encoded
        while encoded <= k:
            x = enc.encode(ts[encoded])[..., :n]
            cache[encoded] = torch.complex(gr * x[:, 0] - gi * x[:, 1],
                                           gr * x[:, 1] + gi * x[:, 0])
            encoded += 1
            cache.pop(encoded - 3, None)
        return cache[k]

    def original(lo, hi):
        """Original stream samples [lo, hi), (B, hi-lo) complex64 on the card."""
        parts = []
        while lo < hi:
            k, i = divmod(lo, n)
            take = min(hi - lo, n - i)
            parts.append(field(k)[:, i : i + take])
            lo += take
        return torch.cat(parts, dim=-1)

    total = RESYNC_FIELDS * n - RESYNC_DROP
    rx = IqReceiver(batch=B_FULL, backend="adaptive", resync="auto", device=dev)
    acquire_s = []
    reacquire = rx._try_reacquire

    def timed_reacquire(final):
        t0 = time.perf_counter()
        done = reacquire(final)
        if done:
            acquire_s.append(time.perf_counter() - t0)
        return done

    rx._try_reacquire = timed_reacquire
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    got, push_s, host_peak = [], 0.0, 0
    for pos in range(0, total, RESYNC_CHUNK):
        hi = min(pos + RESYNC_CHUNK, total)
        pieces = []
        if pos < RESYNC_CUT:
            pieces.append(original(pos, min(hi, RESYNC_CUT)))
        if hi > RESYNC_CUT:
            lo = max(pos, RESYNC_CUT)
            pieces.append(original(lo + RESYNC_DROP, hi + RESYNC_DROP))
        chunk = torch.cat(pieces, dim=-1).cpu().numpy()
        host_peak = max(host_peak, rx._stream.end - rx._stream.base)
        t0 = time.perf_counter()
        got += rx.push(chunk)
        push_s += time.perf_counter() - t0
        del chunk
    t0 = time.perf_counter()
    got += rx.flush()
    push_s += time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    cache.clear()
    ts_np = ts.cpu().numpy()
    del ts
    log = rx.resync_log
    epoch = log[0]["stream_sample"] if log else -1
    m, rem = divmod(epoch + RESYNC_DROP, n)
    n_tail = RESYNC_FIELDS - m - 1
    pre = len(got) >= 2 and all(np.array_equal(got[k][0], ts_np[k]) for k in range(2))
    tail = len(got) >= n_tail >= 2 and all(
        np.array_equal(got[len(got) - n_tail + j][0], ts_np[m + j])
        and bool((got[len(got) - n_tail + j][1] >= 0).all()) for j in range(n_tail))
    emit("resync_full", batch=B_FULL, fields=RESYNC_FIELDS,
         slip={"at": RESYNC_CUT, "samples": RESYNC_DROP}, chunk=RESYNC_CHUNK,
         resyncs=rx.resyncs, resync_log=log, fields_emitted=len(got),
         pre_slip_exact_all_channels=pre, relocked_tail_fields=n_tail,
         relocked_tail_exact_all_channels=tail,
         host_ms_per_pushed_field=push_s * 1e3 / (total / n), push_host_s=push_s,
         reacquire_ms=[t * 1e3 for t in acquire_s], max_memory_allocated=peak,
         max_buffered_samples=host_peak)
    check(rx.resyncs == 1, f"B={B_FULL} resync: {rx.resyncs} resyncs, log {log}")
    check(rem == 0 and log[0]["parity"] == m % 2,
          f"B={B_FULL} resync: epoch {epoch} is not a post-slip boundary ({log})")
    check(pre and tail, f"B={B_FULL} resync: pre-slip {pre}, re-locked tail {tail}")
    del rx, enc, got, ts_np
    torch.cuda.empty_cache()


# -- 28-29: analyze, and the stream's state and operations -------------------

ANALYZE_CUT, ANALYZE_PPM, ANALYZE_HZ, ANALYZE_SNR_DB = 77_777, 25.0, 400.0, 25.0
STATE_FIELDS, STATE_STOP = 6, 3   # phase 29: the B=384 encode, stopped after field 3
REALTIME_FIELDS = 8


def _analyze(argv: list) -> tuple[dict, float]:
    """cli.main(["analyze", *argv]) with stdout captured: (report, host s)."""
    from atsc_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["analyze", *argv])
    wall = time.perf_counter() - t0
    check(rc == 0, f"analyze {argv}: rc {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), wall


def _digest(paths: list) -> str:
    """sha256 of the files' bytes one after another."""
    import hashlib

    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 24), b""):
                h.update(block)
    return h.hexdigest()


def _write_cf32(path: str, iq) -> str:
    import numpy as np

    np.stack([iq.real, iq.imag], -1).astype(np.float32).tofile(path)
    return path


def analyze_card(dev, band: dict, tmp: str) -> None:
    """Phase 28: `cli analyze` on the card. One clean channel (--fields 4):
    the zf MER through one eq_fir_fused launch, > 30 dB, no flags. An
    impaired channel (a cut at 77,777 samples, 25 ppm, 400 Hz, a two-path
    channel, 25 dB AWGN): its decode_flags fed to `cli decode` give the
    sent TS. The phase-27 B=23 multiplex through `analyze --demux 23
    --fields 3`: 23 slot reports, and its band flags decode every slot to
    the sent TS (the interleaved output stays in `tmp` for phase 29).
    Reads launch counts as differences: phases 28-29 zero no count, so
    main() reads every launch in them."""
    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.receiver import resample_stream

    ts = _host_ts(np.random.default_rng(28), 5)
    clean = _write_cf32(os.path.join(tmp, "clean.iq"), _encode_host(dev, ts))
    before = _every_count()
    rep, clean_s = _analyze([clean, "--fields", "4"])
    clean_launches = _since(before)["eq_fir_fused"]
    emit("analyze_clean", fields=4, report=rep, host_s=clean_s, eq_fir_launches=clean_launches)
    check(rep["mer_method"] == "zf" and rep["mer_db"] > 30 and rep["decode_flags"] == ""
          and rep["align_offset"] == 0, f"analyze, clean: {rep}")
    check(clean_launches == 1, f"analyze, clean: {clean_launches} eq_fir_fused launches")

    rng = np.random.default_rng(280)
    ts = _host_ts(rng, 7)
    iq = _encode_host(dev, ts).astype(np.complex128)
    y = np.convolve(iq, [0.9 * np.exp(0.5j), 0, 0, 0.15 * np.exp(-1.1j)])[: iq.size]
    y = y * np.exp(2j * np.pi * ANALYZE_HZ / P.SAMPLE_RATE * np.arange(y.size))
    y = resample_stream(y, 1.0 / (1.0 + ANALYZE_PPM * 1e-6))[0]
    sigma = np.sqrt(float(np.mean(np.abs(y) ** 2)) / 10 ** (ANALYZE_SNR_DB / 10) / 2.0)
    y = (y + (rng.normal(size=y.size) + 1j * rng.normal(size=y.size)) * sigma)[ANALYZE_CUT:]
    impaired = _write_cf32(os.path.join(tmp, "impaired.iq"), y)
    rep, imp_s = _analyze([impaired])
    flags = rep["decode_flags"].split()
    out = os.path.join(tmp, "impaired.ts")
    before = _every_count()
    rc, stats, dec_s = _cli(["decode", impaired, *flags, "--stats", "-o", out])
    launches = _since(before)
    fd = stats["fields_decoded"]
    exact = np.fromfile(out, np.uint8).tobytes() == ts[1:1 + fd].tobytes()
    emit("analyze_impaired", capture={"fields": 7, "cut": ANALYZE_CUT, "sro_ppm": ANALYZE_PPM,
                                      "cfo_hz": ANALYZE_HZ, "snr_db": ANALYZE_SNR_DB,
                                      "paths": 2},
         report=rep, host_s=imp_s, decode={"flags": flags, "rc": rc, "stats": stats,
                                           "host_s": dec_s, "ts_exact": exact,
                                           "launches": launches})
    check(abs(rep["sro_ppm"] - ANALYZE_PPM) < 1.0 and abs(rep["cfo_hz"] - ANALYZE_HZ) < 2.0
          and rep["mer_method"] == "adaptive" and rep["decodable"],
          f"analyze, impaired: {rep}")
    check(all(f in rep["decode_flags"] for f in ("--sro auto", "--cfo auto", "--align auto")),
          f"analyze, impaired: flags {rep['decode_flags']!r}")
    check(rc == 0 and fd >= 3 and exact and stats["segments_uncorrectable"] == 0,
          f"decode {flags}: the TS is not the sent TS ({stats})")

    b = band["ts"].shape[1]
    rep, band_s = _analyze([band["cap"], "--demux", str(b), "--fields", "3"])
    flags = rep["decode_flags"].split()
    full = os.path.join(tmp, "band_full.ts")
    rc, stats, band_dec_s = _cli(["decode", band["cap"], *flags, "--stats", "-o", full])
    got = np.fromfile(full, np.uint8).reshape(-1, b, P.FIELD_TS_BYTES)
    fd = stats["fields_decoded"]
    exact = got.shape[0] == fd and np.array_equal(got, band["ts"][:fd])
    slots = rep["per_slot"]
    emit("analyze_band", slots=b, fields=3, host_s=band_s,
         mer_db=[s.get("mer_db") for s in slots], methods=sorted({s.get("mer_method")
                                                                  for s in slots}),
         decode_flags=rep["decode_flags"],
         decode={"rc": rc, "stats": stats, "host_s": band_dec_s, "ts_exact_slots": exact})
    check(rep["slots"] == b and len(slots) == b and all(s["decodable"] for s in slots)
          and flags == ["--demux", str(b)], f"analyze --demux {b}: {rep}")
    check(rc == 0 and fd >= HEADEND_FIELDS - 2 and exact
          and stats["segments_uncorrectable"] == 0,
          f"decode {flags}: the band's TS is not the sent TS ({stats})")


def _receiver_resume(dev, kw: dict, blocks: list, ts, path: str) -> dict:
    """IqReceiver(batch=B_FULL, **kw) fed blocks 0-2, saved, fed block 3 and
    flushed; the saved state reloaded and fed the same: the TS and n_errors
    of both, the sent TS from field 1, the resumed run's launches, and the
    checkpoint's save/load ms and bytes on disk."""
    import numpy as np
    import torch

    from atsc_tpu_torch.models.receiver import IqReceiver
    from atsc_tpu_torch.utils import checkpoint as ckpt

    def push(rx, x):
        return rx.push(x) if np.iscomplexobj(x) else rx.push_codes(x)

    rx = IqReceiver(batch=B_FULL, device=dev, **kw)
    first = []
    for x in blocks[:3]:
        first += push(rx, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_receiver(path, rx)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    rx2 = ckpt.load_receiver(path, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    os.remove(path)
    want = push(rx, blocks[3]) + rx.flush()
    before = _every_count()
    got = push(rx2, blocks[3]) + rx2.flush()
    launches = _since(before)
    same = len(got) == len(want) == 2 and all(
        np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]) for g, w in zip(got, want))
    sent = len(first) == 1 and np.array_equal(first[0][0], ts[0]) and all(
        np.array_equal(g[0], ts[1 + k]) for k, g in enumerate(got))
    return {"save_ms": save_ms, "load_ms": load_ms, "bytes": nbytes, "same_as_unbroken": same,
            "sent_ts": sent, "launches": launches}


def state_ops(dev, band: dict, tmp: str) -> None:
    """Phase 29: the stream's state and operations on the card. A B=384 cs8
    encode stopped after field 3 with --checkpoint and resumed: the bytes
    of an uninterrupted 6-field run; the same for phase 27's `encode --mux`
    at B=23. IqReceiver at B=384 (soft exact and C=24 and NTSC comb from
    cs8 codes, adaptive train_every=4 through a two-path channel), saved
    after field 2 and reloaded: the TS of the unbroken run; `decode --demux
    23 --checkpoint` stopped at 3 fields and resumed: phase 28's band TS.
    --profile's trace names offset_fir_fused's CUDA kernel; --realtime on 8
    cs8 fields takes at least 95 % of their air time; SupervisedEncoder
    at B=384 catches a NaN put in its state and recovers bit for bit. The
    checkpoints' save/load ms and bytes on disk at B=384. Launch counts
    are read as differences, as in phase 28."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.utils import checkpoint as ckpt
    from atsc_tpu_torch.utils.supervision import SupervisedEncoder

    n, fb = P.SYMBOLS_PER_FIELD, P.FIELD_TS_BYTES
    rng = np.random.default_rng(29)
    ts_path = os.path.join(tmp, "state.ts")
    _host_ts(rng, STATE_FIELDS).tofile(ts_path)
    ck = os.path.join(tmp, "state.npz")

    # the B=384 cs8 encode: uninterrupted, then stopped and resumed
    base = [ts_path, "--channels", str(B_FULL), "--format", "cs8", "--stats"]
    full, p1, p2 = (os.path.join(tmp, f"enc_{k}.cs8") for k in ("full", "p1", "p2"))
    rc0, st0, full_s = _cli([*base, "-o", full])
    want = _digest([full])
    os.remove(full)
    before = _every_count()
    rc1, st1, p1_s = _cli([*base, "-o", p1, "--max-fields", str(STATE_STOP), "--checkpoint", ck])
    ck_bytes = os.path.getsize(ck)
    rc2, st2, p2_s = _cli([*base, "-o", p2, "--resume", "--checkpoint", ck])
    enc_launches = _since(before)["offset_fir_fused"]
    sizes = [os.path.getsize(p) for p in (p1, p2)]
    same = _digest([p1, p2]) == want
    for p in (p1, p2):
        os.remove(p)
    # the encoder checkpoint's own cost at B=384
    enc = Encoder(batch=B_FULL, device=dev)
    enc.encode(torch.zeros((B_FULL, fb), dtype=torch.uint8, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_state(ck, enc.state, 1)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state, _ = ckpt.load_state(ck, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    state_same = all(torch.equal(a, b) for a, b in zip(state, enc.state))
    # the same state deflated, as np.savez_compressed writes it
    deflated = ck + ".deflated"
    t0 = time.perf_counter()
    with open(deflated, "wb") as fh:
        np.savez_compressed(fh, **{k: v.cpu().numpy() for k, v in enc.state._asdict().items()})
    deflate_ms = (time.perf_counter() - t0) * 1e3
    deflate_bytes = os.path.getsize(deflated)
    os.remove(deflated)
    del enc, state
    emit("state_encode", batch=B_FULL, format="cs8", fields=STATE_FIELDS, stop=STATE_STOP,
         rc=[rc0, rc1, rc2], host_s=[full_s, p1_s, p2_s], bytes_split=sizes,
         identical_to_unbroken=same, offset_fir_launches=enc_launches,
         checkpoint={"bytes": ck_bytes, "save_ms": save_ms, "load_ms": load_ms,
                     "state_identical": state_same,
                     "deflated": {"bytes": deflate_bytes, "save_ms": deflate_ms}})
    check(rc0 == rc1 == rc2 == 0 and st1["fields"] == STATE_STOP * B_FULL
          and st2["fields"] == (STATE_FIELDS - STATE_STOP) * B_FULL,
          f"encode --checkpoint/--resume: {st1}, {st2}")
    check(same, "encode --resume: the split B=384 cs8 run differs from the unbroken one")
    check(enc_launches == STATE_FIELDS, f"encode --resume: {enc_launches} offset_fir launches")
    check(state_same, "load_state: the B=384 state differs from the saved one")

    # encode --mux at B=23: phase 27's run, stopped after field 4 and resumed
    b = band["ts"].shape[1]
    base = [*band["paths"], "--channels", str(b), "--mux"]
    p1, p2 = (os.path.join(tmp, f"mux_{k}.iq") for k in ("p1", "p2"))
    rc1, _, _ = _cli([*base, "-o", p1, "--max-fields", "4", "--checkpoint", ck, "--stats"])
    rc2, _, _ = _cli([*base, "-o", p2, "--resume", "--checkpoint", ck, "--stats"])
    same = _digest([p1, p2]) == _digest([band["cap"]])
    emit("state_mux", slots=b, fields=HEADEND_FIELDS, stop=4, rc=[rc1, rc2],
         bytes_split=[os.path.getsize(p) for p in (p1, p2)], identical_to_unbroken=same)
    check(rc1 == rc2 == 0 and same,
          f"encode --mux --resume at B={b}: the split multiplex differs from phase 27's")
    for p in (p1, p2, ck):
        os.remove(p)

    # IqReceiver at B=384: every decoder's and the RLS state through a checkpoint
    ts = _random_ts_dev(dev, 4, 2929)
    ts_host = ts.cpu().numpy()
    enc = Encoder(batch=B_FULL, out_format="cs8", device=dev)
    codes = [np.ascontiguousarray(enc.encode(ts[k])[..., :n].cpu().numpy().transpose(0, 2, 1))
             for k in range(4)]
    enc = Encoder(batch=B_FULL, device=dev)
    planes = [enc.encode(ts[k])[..., :n].cpu().numpy() for k in range(4)]
    del enc, ts
    echo, tail = 0.2 * np.exp(-1.1j), np.zeros((B_FULL, 5), np.complex64)
    cplx = []
    for x in planes:   # a two-path channel across the field boundaries
        x = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
        y = x.copy()
        y[:, 5:] += echo * x[:, :-5]
        y[:, :5] += echo * tail
        tail = x[:, -5:]
        cplx.append(y)
    del planes
    receivers = {}
    for name, kw, blocks in (
            ("soft", dict(wire_format="cs8", trellis="soft"), codes),
            ("soft_c24", dict(wire_format="cs8", trellis="soft", viterbi_chunks=CHUNK_MAIN),
             codes),
            ("ntsc_comb", dict(wire_format="cs8", ntsc="comb"), codes),
            ("adaptive_train_every4", dict(backend="adaptive", train_every=4), cplx)):
        r = _receiver_resume(dev, kw, blocks, ts_host, ck)
        receivers[name] = r
        torch.cuda.empty_cache()
    del codes, cplx
    emit("state_receiver", batch=B_FULL, saved_after_fields=2, receivers=receivers)
    for name, r in receivers.items():
        check(r["same_as_unbroken"] and r["sent_ts"],
              f"IqReceiver {name} B={B_FULL}: the reloaded receiver's TS differs ({r})")
    want = {"soft": {"acs_forward": 2, "traceback": 2},
            "soft_c24": {"acs_forward_chunked": 2, "traceback_chunked": 2},
            "ntsc_comb": {"pr_acs_forward": 2, "pr_traceback": 2},
            "adaptive_train_every4": {}}
    for name, r in receivers.items():
        eq = 0 if name.startswith("adaptive") else 2
        check(r["launches"] == {**{k: 0 for k in r["launches"]}, "eq_fir_fused": eq,
                                **want[name]},
              f"IqReceiver {name}: the resumed run's launches {r['launches']}")

    # decode --demux 23 through the CLI: stopped at 3 fields, resumed
    part = os.path.join(tmp, "band_part.ts")
    flags = ["--demux", str(b)]
    rc1, st1, _ = _cli(["decode", band["cap"], *flags, "--max-fields", "3", "--checkpoint", ck,
                        "--checkpoint-every", "1", "--stats", "-o", part])
    part_fields = os.path.getsize(part) // (b * fb)
    rc2, st2, resume_s = _cli(["decode", band["cap"], *flags, "--resume", "--checkpoint", ck,
                               "--stats", "-o", part])
    same = _digest([part]) == _digest([os.path.join(tmp, "band_full.ts")])
    emit("state_demux", slots=b, rc=[rc1, rc2], fields_before_resume=part_fields,
         fields_resumed=st2["fields_decoded"], resume_host_s=resume_s,
         checkpoint_bytes=os.path.getsize(ck), identical_to_unbroken=same)
    check(rc1 == rc2 == 0 and 3 <= part_fields < HEADEND_FIELDS - 1 and same,
          f"decode --demux {b} --resume: the TS differs from the unbroken decode "
          f"({part_fields} fields before, {st2})")

    # --profile: a torch.profiler trace naming offset_fir_fused's kernel
    prof = os.path.join(tmp, "prof")
    rc, _, prof_s = _cli([ts_path, "--channels", "4", "--format", "cs8", "--max-fields", "3",
                          "--profile", prof, "--stats"])
    traces = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    fir_events = [e for e in events if e.get("cat") == "kernel"
                  and "offset_fir" in e.get("name", "")]
    emit("state_profile", rc=rc, traces=len(traces), host_s=prof_s,
         offset_fir_kernel_events=len(fir_events),
         kernel_name=fir_events[0]["name"] if fir_events else None,
         offset_fir_us=[e.get("dur") for e in fir_events])
    check(rc == 0 and len(traces) == 1 and len(fir_events) == 3,
          f"--profile: {len(fir_events)} offset_fir kernel events in {traces}")

    # --realtime: 8 cs8 fields paced to the symbol clock
    rt_ts = os.path.join(tmp, "rt.ts")
    _host_ts(rng, REALTIME_FIELDS).tofile(rt_ts)
    paced, unpaced = os.path.join(tmp, "rt.cs8"), os.path.join(tmp, "nort.cs8")
    rc1, _, paced_s = _cli([rt_ts, "--format", "cs8", "--realtime", "-o", paced, "--stats"])
    rc2, _, unpaced_s = _cli([rt_ts, "--format", "cs8", "-o", unpaced, "--stats"])
    air_s = REALTIME_FIELDS / P.FIELD_RATE
    same = _digest([paced]) == _digest([unpaced])
    emit("state_realtime", fields=REALTIME_FIELDS, air_s=air_s, paced_host_s=paced_s,
         unpaced_host_s=unpaced_s, identical_bytes=same)
    check(rc1 == rc2 == 0 and same and paced_s >= 0.95 * air_s,
          f"--realtime: {paced_s} s for {air_s} s of air")

    # SupervisedEncoder at B=384: a NaN put in the phasor before field 3
    ts = _random_ts_dev(dev, 4, 2930)
    sup = SupervisedEncoder(batch=B_FULL, checkpoint_every=2,
                            checkpoint_path=os.path.join(tmp, "sup.npz"), device=dev)
    ref = Encoder(batch=B_FULL, device=dev)
    exact = []
    for k in range(4):
        if k == 3:
            sup.enc.state = sup.enc.state._replace(
                phasor=torch.full_like(sup.enc.state.phasor, float("nan")))
        exact.append(torch.equal(sup.encode(ts[k]), ref.encode(ts[k])))
    emit("state_supervised", batch=B_FULL, fields=4, nan_before_field=3,
         failures=sup.failures, fields_encoded=sup.fields_encoded, exact_fields=exact)
    check(sup.failures == 1 and sup.fields_encoded == 4 and all(exact),
          f"SupervisedEncoder: failures {sup.failures}, exact {exact}")
    del sup, ref, ts
    torch.cuda.empty_cache()


# -- 30-32: the SDR sink and source, and the receiver measurement tools -------

SDR_FIELDS = 6            # phase 30's B=1 TS: 6 fields
SDR_MTU = 65_536          # samples a fake device's stream call moves at most
SDR_HICCUPS = 4           # phase 31: 2 timeouts and 2 overflows before the data
SDR_GAP_AT, SDR_GAP_LEN = int(1.5 * 260_416), 600   # one timestamped overflow drop
SDR_MAX_FIELDS = 5


@contextlib.contextmanager
def _fake_soapy(served=None, hiccups: int = 0, gap_at: int | None = None,
                gap_len: int = 0):
    """A fake `SoapySDR` module in sys.modules for the block; yields the
    dict its one device records its settings in. TX: the bytes of every
    buffer written go into a running sha256 ("tx_sha256") and a count
    ("tx_bytes"). RX: serves `served` ((n, 2) component pairs) SDR_MTU at a
    time, after `hiccups` alternating timeout/overflow results; after gap_at
    samples one overflow and gap_len samples of stream time dropped, the
    buffers stamped (timeNs with HAS_TIME) from the stream position. A read
    past the served capture fails the run. No radio is attached: this is
    the SoapySDR API as the port's sink and source call it."""
    import hashlib
    import types

    calls: dict = {"tx_bytes": 0}
    digest = hashlib.sha256()
    mod = types.ModuleType("SoapySDR")
    mod.SOAPY_SDR_RX, mod.SOAPY_SDR_TX = "RX", "TX"
    mod.SOAPY_SDR_TIMEOUT, mod.SOAPY_SDR_OVERFLOW, mod.SOAPY_SDR_HAS_TIME = -1, -2, 1 << 2

    class Result:
        def __init__(self, ret, time_ns=0):
            self.ret, self.timeNs = ret, time_ns
            self.flags = mod.SOAPY_SDR_HAS_TIME if time_ns else 0

    class Device:
        def __init__(self, dev_args):
            calls["driver"] = dev_args["driver"]
            self._pos = self._vpos = 0
            self._hiccups, self._gapped = hiccups, False

        def setBandwidth(self, d, ch, v):
            calls["bandwidth"] = v

        def setSampleRate(self, d, ch, v):
            calls["rate"] = v

        def setFrequency(self, d, ch, v):
            calls["frequency"] = v

        def setGain(self, d, ch, v):
            calls["gain"] = v

        def setupStream(self, d, fmt):
            calls["direction"], calls["format"] = d, fmt
            return "stream"

        def activateStream(self, s):
            pass

        def getStreamMTU(self, s):
            return SDR_MTU

        def readStream(self, s, bufs, num):
            if self._hiccups > 0:
                self._hiccups -= 1
                return Result(-1 if self._hiccups % 2 else -2)
            if gap_at is not None and not self._gapped and self._pos >= gap_at:
                self._gapped = True
                self._vpos += gap_len
                return Result(-2)
            check(self._pos < served.shape[0], "a live decode read past the served capture")
            got = min(num, SDR_MTU, served.shape[0] - self._pos)
            if gap_at is not None and not self._gapped:
                got = min(got, gap_at - self._pos)
            t_ns = int(1e15 + self._vpos / calls["rate"] * 1e9) if gap_at is not None else 0
            bufs[0][:got] = served[self._pos:self._pos + got]
            self._pos += got
            self._vpos += got
            return Result(got, t_ns)

        def writeStream(self, s, bufs, num):
            data = bufs[0][:num]   # C-contiguous (n, 2) samples
            digest.update(data)
            calls["tx_bytes"] += data.nbytes
            return Result(num)

        def deactivateStream(self, s):
            pass

        def closeStream(self, s):
            calls["closed"] = True
            calls["tx_sha256"] = digest.hexdigest()

    mod.Device = Device
    sys.modules["SoapySDR"] = mod
    try:
        yield calls
    finally:
        del sys.modules["SoapySDR"]


def sdr_sink(dev, band: dict, tmp: str) -> str:
    """Phase 30: `cli encode -o soapy` into the fake TX device on the card:
    a 6-field B=1 TS in cf32 and in cs8, its device bytes those of the same
    run's `-o file` bit for bit; phase 27's B=23 `--mux` band, the device at
    138 MS/s with 138 MHz of bandwidth and its bytes phase 27's multiplex.
    offset_fir_fused launches once a field. Returns the B=1 cf32 capture's
    path (kept in `tmp` for phase 31)."""
    import numpy as np

    from atsc_tpu_torch import params as P

    n = P.SYMBOLS_PER_FIELD
    ts_path = os.path.join(tmp, "sdr.ts")
    _host_ts(np.random.default_rng(30), SDR_FIELDS).tofile(ts_path)
    sdr = ["-d", "fake", "-f", "473e6", "-g", "54"]
    runs = {}
    for fmt in ("cf32", "cs8"):
        path = os.path.join(tmp, f"sdr.{fmt}")
        before = _every_count()
        with _fake_soapy() as calls:
            rc, stats, host_s = _cli([ts_path, "--format", fmt, "-o", "soapy", *sdr, "--stats"])
        launches = _since(before)["offset_fir_fused"]
        rc_file, _, _ = _cli([ts_path, "--format", fmt, "-o", path, "--stats"])
        runs[fmt] = {"rc": [rc, rc_file], "stats": stats, "host_s": host_s, "device": calls,
                     "identical_to_file_sink": calls["tx_sha256"] == _digest([path]),
                     "offset_fir_launches": launches}
        check(rc == rc_file == 0 and stats["device"] == str(dev),
              f"encode -o soapy --format {fmt}: rc {rc}, {stats}")
        check(runs[fmt]["identical_to_file_sink"]
              and calls["tx_bytes"] == SDR_FIELDS * n * 2 * (4 if fmt == "cf32" else 1),
              f"encode -o soapy --format {fmt}: the device bytes differ from the file sink's")
        check((calls["driver"], calls["rate"], calls["bandwidth"], calls["frequency"],
               calls["gain"], calls["format"], calls["direction"])
              == ("fake", P.SAMPLE_RATE, 6e6, 473e6, 54.0, fmt.upper(), "TX"),
              f"encode -o soapy --format {fmt}: device settings {calls}")
        check(launches == SDR_FIELDS, f"encode -o soapy: {launches} offset_fir launches")
    b = band["ts"].shape[1]
    before = _every_count()
    with _fake_soapy() as calls:
        rc, stats, host_s = _cli([*band["paths"], "--channels", str(b), "--mux", "-o", "soapy",
                                  *sdr, "--stats"])
    launches = _since(before)["offset_fir_fused"]
    same = calls["tx_sha256"] == _digest([band["cap"]])
    emit("sdr_sink", fields=SDR_FIELDS, **runs,
         mux={"slots": b, "rc": rc, "stats": stats, "host_s": host_s, "device": calls,
              "identical_to_phase_27": same, "offset_fir_launches": launches})
    check(rc == 0 and same, f"encode --mux -o soapy: the device bytes differ from phase 27's")
    check(calls["rate"] == calls["bandwidth"] == b * 6e6,
          f"encode --mux -o soapy: device settings {calls}")
    check(launches == HEADEND_FIELDS, f"encode --mux -o soapy: {launches} offset_fir launches")
    return os.path.join(tmp, "sdr.cf32")


def sdr_source(dev, band: dict, tmp: str, capture: str) -> None:
    """Phase 31: the fake RX device on the card. Phase 30's B=1 capture,
    with hiccups and one timestamped overflow drop, through `decode soapy
    --stats`: the sent TS but for the field the zero-filled span lies in,
    the counters the fake injected, one eq_fir_fused launch a field. Phase
    27's band through `decode soapy --demux 23 --trellis viterbi
    --viterbi-chunks 24`: every slot's TS, the device at 138 MS/s. The
    capture through `analyze soapy`: the zf MER, no flags."""
    import numpy as np

    from atsc_tpu_torch import params as P

    n = P.SYMBOLS_PER_FIELD
    ts = _host_ts(np.random.default_rng(30), SDR_FIELDS)
    samples = np.fromfile(capture, np.float32).reshape(-1, 2)
    served = np.concatenate([samples[:SDR_GAP_AT], samples[SDR_GAP_AT + SDR_GAP_LEN:],
                             np.zeros((n, 2), np.float32)])
    out = os.path.join(tmp, "live.ts")
    before = _every_count()
    with _fake_soapy(served, SDR_HICCUPS, SDR_GAP_AT, SDR_GAP_LEN) as calls:
        rc, stats, host_s = _cli(["decode", "soapy", "-d", "fake", "--max-fields",
                                  str(SDR_MAX_FIELDS), "--stats", "-o", out])
    launches = _since(before)
    got = np.fromfile(out, np.uint8).reshape(-1, P.FIELD_TS_BYTES)
    # the interleaver spreads a TS field over two symbol fields: the gap's
    # symbol field and the one before may carry its zeros
    spanned = {SDR_GAP_AT // n - 1, SDR_GAP_AT // n}
    exact = [bool(np.array_equal(got[k], ts[k])) for k in range(got.shape[0])]
    counters = (stats.get("overflows"), stats.get("gaps_filled"), stats.get("gap_samples"))
    want_counters = (SDR_HICCUPS // 2 + 1, 1, SDR_GAP_LEN)
    emit("sdr_source_live", fields=SDR_FIELDS, gap={"at": SDR_GAP_AT, "samples": SDR_GAP_LEN},
         hiccups=SDR_HICCUPS, rc=rc, stats=stats, host_s=host_s, device=calls,
         ts_exact_by_field=exact, launches=launches)
    check(rc == 0 and stats["device"] == str(dev) and got.shape[0] == SDR_MAX_FIELDS,
          f"decode soapy: rc {rc}, {stats}")
    check(all(e for k, e in enumerate(exact) if k not in spanned),
          f"decode soapy: fields {exact} against the sent TS (the gap spans {spanned})")
    check(counters == want_counters, f"decode soapy: counters {counters}, want {want_counters}")
    check((calls["rate"], calls["bandwidth"], calls["gain"], calls["format"])
          == (P.SAMPLE_RATE, 6e6, 30.0, "CF32"), f"decode soapy: device settings {calls}")
    check(launches["eq_fir_fused"] == SDR_MAX_FIELDS + 1,
          f"decode soapy: launches {launches} for {SDR_MAX_FIELDS} decoded fields")

    b = band["ts"].shape[1]
    served = np.concatenate([np.fromfile(band["cap"], np.float32).reshape(-1, 2),
                             np.zeros((1 << 21, 2), np.float32)])
    out = os.path.join(tmp, "live_band.ts")
    before = _every_count()
    with _fake_soapy(served) as calls:
        rc, stats, host_s = _cli(["decode", "soapy", "-d", "fake", "--demux", str(b),
                                  "--trellis", "viterbi", "--viterbi-chunks", str(CHUNK_MAIN),
                                  "--max-fields", str(HEADEND_FIELDS - 2), "--stats",
                                  "-o", out])
    launches = _since(before)
    del served
    fd = stats["fields_decoded"]
    got = np.fromfile(out, np.uint8).reshape(-1, b, P.FIELD_TS_BYTES)
    exact = got.shape[0] == fd and np.array_equal(got, band["ts"][:fd])
    emit("sdr_source_band", slots=b, rc=rc, stats=stats, host_s=host_s, device=calls,
         ts_exact_slots=exact, launches=launches)
    check(rc == 0 and stats["device"] == str(dev) and fd >= HEADEND_FIELDS - 2 and exact
          and stats["segments_uncorrectable"] == 0 and stats["overflows"] == 0,
          f"decode soapy --demux {b}: the TS is not the sent TS ({stats})")
    check(calls["rate"] == calls["bandwidth"] == b * 6e6,
          f"decode soapy --demux {b}: device settings {calls}")
    check(launches["acs_forward_chunked"] == launches["traceback_chunked"] == fd + 1,
          f"decode soapy --demux {b}: launches {launches} for {fd} decoded fields")

    before = _every_count()
    with _fake_soapy(samples) as calls:
        rep, an_s = _analyze(["soapy", "-d", "fake", "--fields", "4"])
    launches = _since(before)["eq_fir_fused"]
    emit("sdr_source_analyze", report=rep, host_s=an_s, device=calls,
         eq_fir_launches=launches)
    check(rep["mer_method"] == "zf" and rep["mer_db"] > 30 and rep["decode_flags"] == ""
          and rep["align_offset"] == 0, f"analyze soapy: {rep}")
    check(calls["rate"] == P.SAMPLE_RATE and launches == 1,
          f"analyze soapy: device {calls}, {launches} eq_fir launches")


#: each gauntlet probe's kernels (all of them launched at least once)
GAUNTLET_KERNELS = {
    "clean_hard": ("eq_fir_fused",), "cs8_hard": ("eq_fir_fused",),
    "awgn15_viterbi": ("eq_fir_fused", "acs_forward", "traceback"),
    "awgn13_viterbi": ("eq_fir_fused", "acs_forward", "traceback"),
    "awgn13_viterbi_i8": ("eq_fir_fused", "acs_forward", "traceback"),
    "cci_ntsc": ("eq_fir_fused", "pr_acs_forward", "pr_traceback"),
    "multipath_adaptive_dd": (),
}


def measurement_tools(dev) -> None:
    """Phase 32: tools/torch_chip_gauntlet.py in this process (its 7 probes,
    each with its launches), then tools/torch_rx_threshold.py at 20, 14 and
    12 dB, hard and soft, on 2 fields: exact at 20 dB hard and 14 dB soft."""
    _, rc, probes = _run_tool("torch_chip_gauntlet", [])
    emit("gauntlet_tool", rc=rc, probes=probes)
    check(rc == 0 and [p["probe"] for p in probes] == list(GAUNTLET_KERNELS)
          and all(p["ok"] for p in probes), f"torch_chip_gauntlet: rc {rc}, {probes}")
    for p in probes:
        check(all(p["launches"][k] > 0 for k in GAUNTLET_KERNELS[p["probe"]]),
              f"torch_chip_gauntlet {p['probe']}: launches {p['launches']}")
    _, rc, lines = _run_tool("torch_rx_threshold", ["--fields", "2", "--modes", "hard,soft",
                                                    "--snrs", "20,14,12"])
    emit("rx_threshold_tool", rc=rc, lines=lines)
    exact = {(ln["mode"], ln["snr_db"]): ln["exact"] for ln in lines if "mode" in ln}
    check(rc == 0 and exact.get(("hard", 20.0)) and exact.get(("soft", 14.0)),
          f"torch_rx_threshold: {lines}")
    check(lines[-1]["device"] == str(dev), f"torch_rx_threshold ran on {lines[-1]}")


MESH = (2, 2)           # phases 33-36: time x channel shards, all four on the one card
MESH_F = 2              # fields a shard takes a step: 4 fields a step
MESH_ROUNDS = 2         # timed steps after one warm step
MESH_CLI_FIELDS = 8     # phase 36: a 4-channel cs8 stream
TOOL_FIELDS = 3         # phase 37: 4 channels, 2 processes of 2 shards


def _mesh_on(dev):
    """The 2x2 mesh of four shards on the one card."""
    from atsc_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(*MESH, [dev] * (MESH[0] * MESH[1]))


def _steps_ms(run) -> list:
    """Device ms (CUDA events) of MESH_ROUNDS calls of run() after one."""
    run()
    return [_cuda_ms(run)[1] for _ in range(MESH_ROUNDS)]


def sharded_encode(dev) -> dict:
    """Phase 33: ShardedEncoder at B=384 on a 2x2 mesh of four shards on
    the one card, 2 fields a shard (4 a step), cf32 and cs8: bit-exact to
    the sequential Encoder on the card over the same 4 fields (IQ and every
    state leaf); ms a step, the sequential encoder's ms over the same 4
    fields, peak memory, and offset_fir_fused launches (one a shard a
    step). Returns the cf32 step's host IQ and TS for phase 34."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import Encoder
    from atsc_tpu_torch.ops.cuda import offset_fir as fir
    from atsc_tpu_torch.parallel.field_shard import ShardedEncoder

    mesh = _mesh_on(dev)
    t = MESH[0] * MESH_F
    b_shard = B_FULL // MESH[1]
    ts = _host_ts(np.random.default_rng(33), t * B_FULL).reshape(t, B_FULL, -1)
    ts_dev = torch.tensor(ts, device=dev)
    out = {}
    for fmt in ("cf32", "cs8"):
        enc = ShardedEncoder(mesh, batch=B_FULL, fields_per_device=MESH_F, out_format=fmt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        l0 = fir.LAUNCHES
        state, iq = enc.step(enc.init_state(), ts_dev)
        torch.cuda.synchronize()
        launches = fir.LAUNCHES - l0
        peak = torch.cuda.max_memory_allocated(dev)
        seq = Encoder(batch=B_FULL, out_format=fmt, device=dev)
        same = True
        for k in range(t):
            want = seq.encode(ts_dev[k])
            for c in range(MESH[1]):
                part = iq[(k // MESH_F, c)][k % MESH_F]
                same &= torch.equal(part, want[c * b_shard:(c + 1) * b_shard])
        for coord, st in state.items():
            for name in st._fields:
                full = getattr(seq.state, name)
                c = coord[1]
                same &= torch.equal(getattr(st, name), full[c * b_shard:(c + 1) * b_shard])
        init = enc.init_state()
        ms = _steps_ms(lambda: enc.step(init, ts_dev))
        seq_enc = Encoder(batch=B_FULL, out_format=fmt, device=dev)
        seq_ms = _steps_ms(lambda: [seq_enc.encode(ts_dev[k]) for k in range(t)])
        out[fmt] = {"ms_per_step": ms, "sequential_ms_4_fields": seq_ms,
                    "max_memory_allocated": peak, "offset_fir_launches": launches,
                    "bit_exact": same}
        emit("sharded_encode", batch=B_FULL, mesh=f"{MESH[0]}x{MESH[1]}",
             placement=mesh.placement(), fields_per_step=t, format=fmt, **out[fmt])
        check(same, f"{fmt}: the sharded step differs from the sequential Encoder")
        check(launches == MESH[0] * MESH[1],
              f"{fmt}: {launches} offset_fir_fused launches for one step of 4 shards")
        if fmt == "cf32":
            host_iq = enc.gather_iq(iq)
        del iq, state, enc, seq, seq_enc
        torch.cuda.empty_cache()
    return {"ts": ts, "iq": host_iq, **out}


def sharded_receive(dev, enc33: dict) -> dict:
    """Phase 34: ShardedReceiver at B=384 on the 2x2 mesh over phase 33's
    IQ (4 fields a step; the stream's ends zero-filled): zf with hard,
    soft, soft-i8 and NTSC, and adaptive; the TS exact on every channel
    (fields 0-2: the interleaver keeps the last). Each tier's step (eq +
    decode + RS + derandomize, the windows already on the card) timed with
    CUDA events, beside the same receiver on a 1x1 mesh (one shard: the
    sequential chain over the same 4 fields), and each kernel's launches
    in a step."""
    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.parallel.distributed import put_global
    from atsc_tpu_torch.parallel.mesh import gather, make_mesh
    from atsc_tpu_torch.parallel.rx_shard import (
        FIELDS_SPEC,
        OSC_SPEC,
        WIN_SPEC,
        ShardedReceiver,
        _correct_and_derand,
    )

    n = P.SYMBOLS_PER_FIELD
    host = enc33["iq"]                                    # (T, B, 2, 261120)
    t = host.shape[0]
    iq = np.empty((t, B_FULL, n), np.complex64)
    iq.real, iq.imag = host[:, :, 0, :n], host[:, :, 1, :n]
    iq = np.ascontiguousarray(iq.transpose(1, 0, 2)).reshape(B_FULL, t * n)
    ts = enc33["ts"]
    meshes = {"2x2": _mesh_on(dev), "1x1": make_mesh(1, 1, [dev])}
    tiers = {"hard": dict(), "soft": dict(trellis="soft"),
             "soft-i8": dict(trellis="soft-i8"), "ntsc": dict(trellis="ntsc"),
             "adaptive": dict(equalizer="adaptive")}
    per_field = {"hard": ("eq_fir_fused",), "soft": ("eq_fir_fused", "acs_forward", "traceback"),
                 "soft-i8": ("eq_fir_fused", "acs_forward", "traceback"),
                 "ntsc": ("eq_fir_fused", "pr_acs_forward", "pr_traceback"),
                 "adaptive": ()}
    window_len, placed = None, {}
    out = {}
    for tier, kw in tiers.items():
        res = {}
        for key, mesh in meshes.items():
            rx = ShardedReceiver(mesh, batch=B_FULL, fields_per_device=t // mesh.shape["time"],
                                 **kw)
            if rx.window != window_len:     # one window geometry on the card at a time
                placed.clear()
                torch.cuda.empty_cache()
                window_len, (wins, oscs) = rx.window, rx.windows_iq(iq)
                placed = {k: (put_global(wins, m, WIN_SPEC), put_global(oscs, m, OSC_SPEC))
                          for k, m in meshes.items()}
                del wins, oscs
            w, o = placed[key]
            init = rx._state

            def step():
                rx._state = init
                cw, syn = rx.step(w, o, 0)
                return _correct_and_derand(rx, mesh, cw, syn)

            before = _every_count()
            got, _ = step()
            launches = {k: v for k, v in _since(before).items() if v}
            got_ts = gather(got, mesh, FIELDS_SPEC)
            exact = all(np.array_equal(got_ts[k + 1], ts[k]) for k in range(t - 1))
            uncorrectable = rx.segments_uncorrectable
            ms = _steps_ms(step)
            res[key] = {"ms_per_step": ms, "launches": launches, "ts_exact": exact,
                        "segments_uncorrectable": uncorrectable}
            check(exact, f"{tier} on the {key} mesh: TS differs from the sent TS")
            for k in per_field[tier]:   # one launch a field of each channel shard
                check(launches.get(k) == t * mesh.shape["ch"],
                      f"{tier} on {key}: launches {launches}")
            del rx, got, init
        out[tier] = res
        emit("sharded_receive", batch=B_FULL, tier=tier, fields_per_step=t,
             note="4 shards on one card; not a scaling figure", **res)
    placed.clear()
    torch.cuda.empty_cache()
    return out


def sample_sharded(golden, dev) -> None:
    """Phase 35: SampleShardedFilter over 4 shards on the one card (the
    overlap-save halo through device copies): golden's 4 fields within
    5e-6 of golden's IQ."""
    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.parallel.mesh import Mesh
    from atsc_tpu_torch.parallel.sample_shard import SP_AXIS, SampleShardedFilter
    from atsc_tpu_torch.tables.oscillator import phasor_for_field

    lev = golden["sync"].real.astype(np.float32)[:, : P.SYMBOLS_PER_FIELD]
    ph = np.asarray([[np.float32(z.real), np.float32(z.imag)]
                     for z in map(phasor_for_field, range(4))], np.float32)
    filt = SampleShardedFilter(Mesh([dev] * 4, (SP_AXIS,)))
    got, ms = _cuda_ms(lambda: filt(lev, ph, np.asarray([0, 1, 0, 1])))
    got = got.cpu().numpy()
    err = float(np.abs(got[..., 0] + 1j * got[..., 1] - golden["iq"]).max())
    emit("sample_sharded", shards=4, fields=4, max_abs_err=err, tolerance=5e-6, ms=ms)
    check(err < 5e-6, f"sample-sharded filter vs golden {err} >= 5e-6")


def mesh_cli(dev, tmp: str) -> None:
    """Phase 36: cli.main in this process, `encode --mesh 2x2` of a
    4-channel cs8 stream (bytes equal the plain encode's), then `decode
    --mesh 2x2 --checkpoint` of that capture stopped at --max-fields and
    resumed (the TS equals the plain decode's and the sent TS)."""
    import numpy as np

    from atsc_tpu_torch import params as P

    ts = _host_ts(np.random.default_rng(36), MESH_CLI_FIELDS)
    src = os.path.join(tmp, "mesh_in.ts")
    ts.tofile(src)
    enc = [src, "-c", "4", "--format", "cs8", "--stats", "-o"]
    rc0, _, _ = _cli([*enc, os.path.join(tmp, "plain.cs8")])
    before = _every_count()
    rc1, stats, wall = _cli([*enc, os.path.join(tmp, "mesh.cs8"), "--mesh", "2x2",
                             "--fields-per-step", "4"])
    enc_launches = _since(before)["offset_fir_fused"]
    same_enc = _digest([os.path.join(tmp, "plain.cs8")]) == _digest([os.path.join(tmp, "mesh.cs8")])
    cap = os.path.join(tmp, "mesh.cs8")
    dec = ["decode", cap, "-c", "4", "--format", "cs8", "--stats", "-o"]
    rc2, plain_stats, _ = _cli([*dec, os.path.join(tmp, "plain.ts")])
    out, ck = os.path.join(tmp, "mesh.ts"), os.path.join(tmp, "mesh_rx.npz")
    mesh_flags = ["--mesh", "2x2", "--fields-per-step", "4", "--checkpoint", ck,
                  "--checkpoint-every", "1"]
    before = _every_count()
    rc3, first, _ = _cli([*dec, out, *mesh_flags, "--max-fields", "3"])
    rc4, rest, dwall = _cli([*dec, out, *mesh_flags, "--resume"])
    dec_launches = _since(before)["eq_fir_fused"]
    with open(out, "rb") as fh:
        got = fh.read()
    with open(os.path.join(tmp, "plain.ts"), "rb") as fh:
        plain = fh.read()
    sent = np.repeat(ts[: MESH_CLI_FIELDS - 1, None], 4, axis=1).tobytes()
    emit("mesh_cli", encode_rc=rc1, encode_stats=stats, encode_wall_s=wall,
         encode_launches=enc_launches, encode_bytes_equal=same_enc, decode_rcs=[rc3, rc4],
         first=first, resumed=rest, decode_wall_s=dwall, decode_launches=dec_launches,
         ts_equal_plain=got == plain, ts_equal_sent=got == sent)
    check(rc0 == rc1 == rc2 == rc3 == rc4 == 0, "a --mesh CLI run failed")
    check(same_enc, "encode --mesh 2x2 bytes differ from the plain encode's")
    steps = MESH_CLI_FIELDS // 4     # 4 fields a step, one launch a shard
    check(stats["devices"] == [str(dev)] * 4 and enc_launches == steps * 4,
          f"encode --mesh: {stats}, {enc_launches} offset_fir_fused launches")
    check(got == plain == sent, "decode --mesh (stopped and resumed) TS differs")
    check(first["fields_decoded"] == 3 and rest["fields_decoded"] == MESH_CLI_FIELDS - 1
          and rest["devices"] == [str(dev)] * 4 and dec_launches > 0,
          f"decode --mesh: {first}, {rest}, {dec_launches} eq launches")
    check(plain_stats["fields_decoded"] == MESH_CLI_FIELDS - 1, f"plain decode {plain_stats}")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def two_process_tools(dev, tmp: str) -> dict:
    """Phase 37: two processes of tools/torch_distributed_encode.py, then
    two of torch_distributed_decode.py, each with two shards on the one
    card and `--backend gloo` (NCCL refuses two ranks on one card), 4
    channels: every channel's IQ equals the sequential Encoder's on the
    card byte for byte, and the decode gives back the sent TS."""
    import numpy as np

    from atsc_tpu_torch.models.encoder import Encoder, iq_interleave

    ts = _host_ts(np.random.default_rng(37), TOOL_FIELDS * 4).reshape(TOOL_FIELDS, 4, -1)
    paths = []
    for c in range(4):
        paths.append(os.path.join(tmp, f"tool_in{c}.ts"))
        ts[:, c].tofile(paths[-1])
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(tool: str, *args) -> tuple[list, float]:
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", tool), *args,
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(i), "--backend", "gloo", "--device", f"{dev},{dev}",
             "-c", "4", "--fields-per-step", "2"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        wall = time.perf_counter() - t0
        for i, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"{tool} process {i} exited {p.returncode}:\n{o[-3000:]}")
            check(f"process {i}: backend gloo" in o, f"{tool} process {i}: {o[-2000:]}")
        return [o.strip().splitlines()[-1] for o in outs], wall

    enc_out, enc_wall = run("torch_distributed_encode.py", *paths,
                            "-o", os.path.join(tmp, "tool_iq{ch}.cf32"))
    seq = Encoder(batch=4, device=dev).encode_many(ts).cpu().numpy()
    iq_same = True
    for c in range(4):
        with open(os.path.join(tmp, f"tool_iq{c}.cf32"), "rb") as fh:
            iq_same &= fh.read() == iq_interleave(seq[:, c]).tobytes()
    dec_out, dec_wall = run("torch_distributed_decode.py", os.path.join(tmp, "tool_iq{ch}.cf32"),
                            "-o", os.path.join(tmp, "tool_ts{ch}.ts"))
    ts_same = True
    for c in range(4):
        got = np.fromfile(os.path.join(tmp, f"tool_ts{c}.ts"), np.uint8).reshape(-1, ts.shape[-1])
        ts_same &= np.array_equal(got, ts[: TOOL_FIELDS - 1, c])
    emit("two_process_tools", backend="gloo", processes=2, shards_per_process=2,
         encode=enc_out, encode_wall_s=enc_wall, iq_equal_sequential=iq_same,
         decode=dec_out, decode_wall_s=dec_wall, ts_equal_sent=ts_same)
    check(iq_same, "the two-process encode's IQ differs from the sequential Encoder's")
    check(ts_same, "the two-process decode's TS differs from the sent TS")
    return {"encode_wall_s": enc_wall, "decode_wall_s": dec_wall}


if __name__ == "__main__":
    sys.exit(main())
