#!/usr/bin/env python3
"""Multi-process encode driver of atsc_tpu_torch, the twin of
tools/distributed_encode.py (the JAX package's pod-slice entry point).

Every process runs this script with the same arguments and its own
--process-id; torch.distributed joins them (--backend nccl or gloo, as
named: NCCL for one card per process, gloo where processes share a card
or run on the CPU), and the global channel mesh spans every process's
shards (--device: a comma-separated list of this process's shard
devices; a device may repeat). Each process ingests the transport streams
and writes IQ for exactly the channels its shards own
(`local_channel_slice`); the encoder's only cross-shard traffic is its
O(1)-per-channel state exchange, which a channel-only mesh does not need.

Topology: pure channel parallelism, a (1, n) mesh, so a process's shards
cover whole channels and its IO is a contiguous channel range. Time-block
sharding composes at the library level (parallel/field_shard.py) but
splits a channel's fields across processes, the wrong shape for per-
process file IO.

Usage (once per process):
    python tools/torch_distributed_encode.py in.ts \\
        --coordinator host0:1234 --num-processes 2 --process-id $I \\
        --backend nccl --device cuda:$I \\
        --channels 8 -o 'out_ch{ch}.iq' [--format cs8] [--fields-per-step 4]

Inputs: one TS file (replicated to every channel) or exactly --channels
files (one per channel; a process opens only its channels' files).
Outputs: one IQ file per owned channel ('{ch}' is the global channel
index), byte-identical to the sequential encoder's channel.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("inputs", nargs="+",
                    help="one TS file (replicated) or one per channel")
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
                    help="per-channel output template containing '{ch}'")
    ap.add_argument("--format", dest="out_format", default="cf32",
                    choices=("cf32", "cs16", "cs8"))
    ap.add_argument("--fields-per-step", type=int, default=4)
    ap.add_argument("--max-fields", type=int, default=0)
    args = ap.parse_args(argv)
    if "{ch}" not in args.output:
        raise ValueError("-o must contain '{ch}' (one file per channel)")

    from atsc_tpu_torch.parallel.distributed import initialize, local_devices

    devices = local_devices(args.device)
    initialize(args.coordinator, num_processes=args.num_processes,
               process_id=args.process_id, backend=args.backend)

    import numpy as np

    from atsc_tpu_torch import params as P
    from atsc_tpu_torch.models.encoder import iq_interleave
    from atsc_tpu_torch.parallel.distributed import local_channel_slice, pod_mesh
    from atsc_tpu_torch.parallel.field_shard import ShardedEncoder
    from atsc_tpu_torch.parallel.mesh import CH_AXIS

    mesh = pod_mesh(n_time=1, devices=devices)
    print(f"process {args.process_id}: backend {args.backend}, shards "
          + " ".join(mesh.placement()), flush=True)
    enc = ShardedEncoder(mesh, batch=args.channels,
                         fields_per_device=args.fields_per_step,
                         out_format=args.out_format)
    sl = local_channel_slice(mesh, args.channels)
    t = enc.t_total
    fb = P.FIELD_TS_BYTES

    if len(args.inputs) == 1:
        replicate = True
        local_paths = args.inputs
    elif len(args.inputs) == args.channels:
        replicate = False
        local_paths = args.inputs[sl]
    else:
        raise ValueError(f"{len(args.inputs)} inputs for "
                         f"{args.channels} channels (want 1 or B)")
    readers = [open(p, "rb") for p in local_paths]
    sinks = {c: open(args.output.format(ch=c), "wb") for c in range(sl.start, sl.stop)}
    per_shard = args.channels // mesh.shape[CH_AXIS]

    state = enc.init_state()
    fields_done = 0
    while True:
        # this step's TS for the channels this process owns; the other
        # processes' channel slots stay zero (only local shards are placed)
        bufs = [r.read(fb * t) for r in readers]
        whole = min(len(b) // fb for b in bufs)
        if whole == 0:
            break
        ts = np.zeros((t, args.channels, fb), np.uint8)
        for j, c in enumerate(range(sl.start, sl.stop)):
            src = bufs[0] if replicate else bufs[j]
            ts[:whole, c] = np.frombuffer(src[: whole * fb], np.uint8).reshape(whole, fb)
        state, iq = enc.step(state, ts)
        # drain: this process's shards are its channels
        for coord, data in iq.items():
            host = data.cpu().numpy()          # (t, ch_shard, 2, 261120)
            ch0 = coord[mesh.axis(CH_AXIS)] * per_shard
            for k in range(whole):
                for j in range(host.shape[1]):
                    sinks[ch0 + j].write(iq_interleave(host[k, j]).tobytes())
        fields_done += whole
        if whole < t or (args.max_fields and fields_done >= args.max_fields):
            break
    for f in readers:
        f.close()
    for f in sinks.values():
        f.close()
    print(f"process {args.process_id}: encoded {fields_done} fields x "
          f"channels [{sl.start}, {sl.stop})", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
