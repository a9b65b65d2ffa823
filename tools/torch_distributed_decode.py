#!/usr/bin/env python3
"""Multi-process decode driver of atsc_tpu_torch, the receive twin of
tools/torch_distributed_encode.py and the port of
tools/distributed_decode.py.

Every process runs this script with the same arguments and its own
--process-id; torch.distributed joins them (--backend nccl or gloo, as
named), and the global channel mesh spans every process's shards
(--device: a comma-separated list of this process's shard devices). Each
process reads the IQ captures and writes the TS of exactly the channels
its shards own; Reed-Solomon correction and de-randomization run on each
process's own shards. The processes agree on each step's field count (an
all-reduce), so a short capture on one cannot leave the others waiting.

Topology: pure channel parallelism, a (1, n) mesh, matching the encode
driver.

Usage (once per process):
    python tools/torch_distributed_decode.py 'cap_ch{ch}.iq' \\
        --coordinator host0:1234 --num-processes 2 --process-id $I \\
        --backend nccl --device cuda:$I \\
        --channels 8 -o 'out_ch{ch}.ts' [--trellis viterbi] [--fields-per-step 4]

Inputs: a cf32 interleaved capture per channel ('{ch}' template or one
file per channel), exactly what torch_distributed_encode.py writes,
field-aligned (the zf equalizer is sample-synchronous; condition an
impaired capture with the sequential `cli decode --align/--cfo/--sro`
first).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("inputs", nargs="+",
                    help="cf32 capture template with '{ch}' or one file per channel")
    ap.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="torch.distributed backend (nccl: one card per "
                         "process; gloo: shared cards or the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="this process's shard devices, comma-separated "
                         "(e.g. 'cuda:1', 'cuda:0,cuda:0', 'cpu,cpu')")
    ap.add_argument("-c", "--channels", type=int, required=True,
                    help="global channel count (divisible by the shard count)")
    ap.add_argument("-o", "--output", required=True,
                    help="per-channel TS output template containing '{ch}'")
    ap.add_argument("--trellis", default="hard", choices=("hard", "viterbi"))
    ap.add_argument("--eq-profile", default="auto")
    ap.add_argument("--first-field", type=int, default=0)
    ap.add_argument("--fields-per-step", type=int, default=4)
    args = ap.parse_args(argv)
    if "{ch}" not in args.output:
        raise ValueError("-o must contain '{ch}' (one file per channel)")

    from atsc_tpu_torch.parallel.distributed import initialize, local_devices

    devices = local_devices(args.device)
    initialize(args.coordinator, num_processes=args.num_processes,
               process_id=args.process_id, backend=args.backend)

    import numpy as np
    import torch

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.receiver import field_window
    from atsc_tpu_torch.parallel.distributed import (
        local_channel_slice,
        pod_mesh,
        put_global,
    )
    from atsc_tpu_torch.parallel.mesh import CH_AXIS
    from atsc_tpu_torch.parallel.rx_shard import (
        OSC_SPEC,
        WIN_SPEC,
        ShardedReceiver,
        _correct_and_derand,
    )

    mesh = pod_mesh(n_time=1, devices=devices)
    print(f"process {args.process_id}: backend {args.backend}, shards "
          + " ".join(mesh.placement()), flush=True)
    rx = ShardedReceiver(
        mesh, batch=args.channels, fields_per_device=args.fields_per_step,
        first_field=args.first_field, eq_profile=args.eq_profile,
        trellis="soft" if args.trellis == "viterbi" else "hard")
    sl = local_channel_slice(mesh, args.channels)
    t = rx.t_total
    n = P.SYMBOLS_PER_FIELD
    bl = sl.stop - sl.start
    per_shard = args.channels // mesh.shape[CH_AXIS]

    if len(args.inputs) == 1 and "{ch}" in args.inputs[0]:
        local_paths = [args.inputs[0].format(ch=c) for c in range(sl.start, sl.stop)]
    elif len(args.inputs) == args.channels:
        local_paths = args.inputs[sl]
    else:
        raise ValueError(f"{len(args.inputs)} inputs for {args.channels} channels "
                         "(want a '{ch}' template or one per channel)")
    readers = [open(p, "rb") for p in local_paths]
    sinks = {c: open(args.output.format(ch=c), "wb") for c in range(sl.start, sl.stop)}
    emitted = 0          # decoder output fields produced so far
    fields_done = 0      # real input fields consumed

    def run_step(iq_ext: np.ndarray, valid: int) -> None:
        """One sharded step over iq_ext (bl, l_ctx + t*N + r_ctx) complex64:
        t fields plus real stream context on both edges (zero-filled only
        at the capture's ends). Writes the TS of the first `valid` output
        fields, less the cold-start virtual field."""
        nonlocal emitted
        wins = np.zeros((t, args.channels, 2, rx.window), np.float32)
        oscs = np.empty((t, 2, rx.window), np.float32)
        for f in range(t):
            w, o = field_window(iq_ext, f * n, first_field=rx._next_field,
                                stream_offset=-l_ctx, margin=rx.eq_margin,
                                length=rx.window)
            wins[f, sl] = w
            oscs[f] = o
        start = rx._advance()
        cw, syn = rx.step(put_global(wins, mesh, WIN_SPEC),
                          put_global(oscs, mesh, OSC_SPEC), start % 2)
        # output k of this step is TS field emitted + k - 1
        ks = [k for k in range(valid) if emitted + k != 0]
        ts, _ = _correct_and_derand(rx, mesh, cw, syn)
        for coord, part in ts.items():
            host = part.cpu().numpy()          # (t, ch_shard, 58656)
            ch0 = coord[mesh.axis(CH_AXIS)] * per_shard
            for k in ks:
                for j in range(host.shape[1]):
                    sinks[ch0 + j].write(host[k, j].tobytes())
        emitted += t

    def agree(local_whole: int) -> int:
        """The step size every process runs: the least of their counts."""
        import torch.distributed as dist

        if not dist.is_initialized():
            return local_whole
        x = torch.tensor([local_whole], dtype=torch.int64,
                         device="cuda" if args.backend == "nccl" else "cpu")
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return int(x.item())

    # rolling sample buffer: l_ctx of left context carries across steps
    # and r_ctx of lookahead is read ahead, so every window sees real
    # stream context at step seams
    l_ctx = rx.eq_margin
    r_ctx = rx.window - n - l_ctx
    left = np.zeros((bl, l_ctx), np.complex64)
    pend = np.zeros((bl, 0), np.complex64)
    eof = False
    while True:
        while not eof and pend.shape[1] < t * n + r_ctx:
            bufs = [rd.read(t * n * 8) for rd in readers]
            got = min(len(b) // 8 for b in bufs)
            if got:
                new = np.empty((bl, got), np.complex64)
                for j, b_ in enumerate(bufs):
                    pairs = np.frombuffer(b_[: got * 8], np.float32).reshape(got, 2)
                    new[j] = pairs[:, 0] + 1j * pairs[:, 1]
                pend = np.concatenate([pend, new], axis=1)
            if min(len(b) for b in bufs) < t * n * 8:
                eof = True
        whole = agree(min(t, pend.shape[1] // n))
        if whole == 0:
            break
        ext = np.zeros((bl, l_ctx + t * n + r_ctx), np.complex64)
        ext[:, :l_ctx] = left
        take = min(pend.shape[1], t * n + r_ctx)
        ext[:, l_ctx : l_ctx + take] = pend[:, :take]
        run_step(ext, valid=whole)
        fields_done += whole
        if whole < t:
            break        # the final partial step (its tail decoded zero pads)
        left = ext[:, whole * n : whole * n + l_ctx]
        pend = pend[:, whole * n :]
    for f in readers:
        f.close()
    for f in sinks.values():
        f.close()
    print(f"process {args.process_id}: decoded {fields_done} fields x "
          f"channels [{sl.start}, {sl.stop})", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
