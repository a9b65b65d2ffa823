"""Multi-process execution (the JAX package's multi-host pod slice).

Counterpart of atsc_tpu/parallel/distributed.py. Every process runs the
same program; `initialize` joins them into one torch.distributed process
group with the backend the caller names (gloo or nccl; nothing chooses or
switches it), and `pod_mesh` builds the global ("time", "ch") mesh over
every process's shards, process 0's first. The per-step exchanges
(field_shard.py, rx_shard.py) are O(1) in stream length: per channel and
step, one RS or interleaved field (64.6 kB), 12 symbols and 36 bits; a
gloo run stages them through the host, where nccl sends from the card.
NCCL refuses two ranks on one card, so processes that share a card use
gloo.

Host-local IO: each process ingests TS and emits IQ (or the reverse) for
the channel shards it owns (`local_channel_slice`), and places only its
own shards of a full host array (`put_global`).
"""

from __future__ import annotations

import numpy as np
import torch

from atsc_tpu_torch import resolve_device
from atsc_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, place

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the process group (a no-op for one process): `backend` is
    'gloo' or 'nccl', and required when there are several processes;
    coordinator_address is process 0's 'host:port'."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    import torch.distributed as dist

    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def local_devices(device: str) -> list[torch.device]:
    """This process's shards' devices from a comma-separated list (e.g.
    'cuda:0', 'cpu,cpu'; a device may repeat)."""
    return [resolve_device(d.strip()) for d in device.split(",")]


def pod_mesh(n_time: int = 1, devices=None) -> Mesh:
    """The global mesh over every process's shards: each process passes
    its own `devices` (default: its visible CUDA devices), all the same
    count, and global shard i * k + j is process i's j-th device."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = world * len(devs)
    if n == 0 or n % n_time:
        raise ValueError(f"{n} shards do not divide over {n_time} time shards")
    flat_dev = np.empty(n, dtype=object)
    flat_rank = np.empty(n, dtype=np.int64)
    for r in range(world):
        for j, d in enumerate(devs):
            # a remote shard's device is named as its process names it
            flat_dev[r * len(devs) + j] = d
            flat_rank[r * len(devs) + j] = r
    shape = (n_time, n // n_time)
    return Mesh(flat_dev.reshape(shape), (TIME_AXIS, CH_AXIS),
                ranks=flat_rank.reshape(shape))


def local_channel_indices(mesh: Mesh, batch: int) -> np.ndarray:
    """Sorted global channel indices this process feeds and drains, for a
    batch sharded over the mesh's "ch" axis."""
    n_ch = mesh.shape[CH_AXIS]
    per_shard = batch // n_ch
    ax = mesh.axis(CH_AXIS)
    ch_ids = sorted({c[ax] for c in mesh.local()})
    if not ch_ids:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate([np.arange(c * per_shard, (c + 1) * per_shard)
                           for c in ch_ids])


def local_channel_slice(mesh: Mesh, batch: int) -> slice:
    """The [start, stop) channel range this process feeds and drains;
    raises if its channel shards are not contiguous."""
    idx = local_channel_indices(mesh, batch)
    if idx.size == 0:
        return slice(0, 0)
    if idx.size != idx[-1] - idx[0] + 1:
        raise ValueError("this process owns non-contiguous channel shards "
                         f"({idx.tolist()}); use local_channel_indices()")
    return slice(int(idx[0]), int(idx[-1]) + 1)


def put_global(tree, mesh: Mesh, spec) -> dict:
    """Place full host arrays (or tensors) on the mesh: this process's
    shards only, each a copy on its device. Every process passes the same
    full-size values, or values correct on the regions it owns."""
    return place(tree, mesh, spec)
