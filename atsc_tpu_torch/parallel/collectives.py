"""The exchanges between shards that the sharded step bodies use, each
along one mesh axis (the port's counterparts of jax.lax.ppermute,
all_gather and psum inside shard_map):

  ring_permute   every shard receives its left neighbour's tensor on the
                 ring t -> t+1 (or t -> t+shift);
  all_gather     every shard receives the stack of all the axis's tensors;
  broadcast_last every shard receives the last shard's tensor (the JAX
                 bodies' psum of a tensor masked to the last time shard).

A placed tensor is a dict {coord: tensor} over the shards this process
owns (mesh.py); every shard passes a tensor of the same shape and dtype,
as under SPMD. Between two shards of one process an exchange is a device
copy; `t.to(d)` on the tensor's own device returns the tensor itself, so
no step body writes into a tensor it exchanged. Between processes it is a
torch.distributed point-to-point message: every process walks the same
global list of (source, destination) pairs in the same order and posts a
send for each pair it is the source of and a receive for each it is the
destination of, tagged with the pair's position. The gloo backend carries
CPU tensors only, so under gloo a message is staged through the host
explicitly; under nccl it leaves from and lands on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from atsc_tpu_torch.parallel.mesh import Mesh


def _along(coord: tuple, axis: int, i: int) -> tuple:
    c = list(coord)
    c[axis] = i
    return tuple(c)


def _staged() -> bool:
    """True when cross-process messages must be CPU tensors (gloo)."""
    return dist.get_backend() == "gloo"


def exchange(mesh: Mesh, pairs: list[tuple[tuple, tuple]], parts: dict) -> dict:
    """Deliver parts[src] to dst for every (src, dst) of `pairs`, the same
    global list on every process. Returns {(src, dst): tensor on dst's
    device} for the pairs whose destination this process owns. A receive
    allocates like parts[dst] (shapes and dtypes agree across shards)."""
    out: dict = {}
    ops, recv = [], []
    for tag, (src, dst) in enumerate(pairs):
        s_rank, d_rank = mesh.rank_of(src), mesh.rank_of(dst)
        if s_rank == mesh.rank and d_rank == mesh.rank:
            out[(src, dst)] = parts[src].to(mesh.device(dst))
        elif s_rank == mesh.rank or d_rank == mesh.rank:
            staged = _staged()
            if s_rank == mesh.rank:
                x = parts[src].contiguous()
                ops.append(dist.P2POp(dist.isend, x.cpu() if staged else x, d_rank, tag=tag))
            else:
                like = parts[dst]
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  device="cpu" if staged else like.device)
                ops.append(dist.P2POp(dist.irecv, buf, s_rank, tag=tag))
                recv.append(((src, dst), buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for key, buf in recv:
        out[key] = buf.to(mesh.device(key[1]))
    return out


def ring_permute(mesh: Mesh, parts: dict, axis: str, shift: int = 1) -> dict:
    """out[c] = parts[c - shift along `axis`] (a ring: jax.lax.ppermute
    with the pairs (t, (t + shift) % n))."""
    ax = mesh.axis(axis)
    n = mesh.shards.shape[ax]
    pairs = [(c, _along(c, ax, (c[ax] + shift) % n)) for c in mesh.coords()]
    got = exchange(mesh, pairs, parts)
    return {dst: x for (_, dst), x in got.items()}


def all_gather(mesh: Mesh, parts: dict, axis: str) -> dict:
    """out[c] = stack([parts[c with axis index i] for i in range(n)])."""
    ax = mesh.axis(axis)
    n = mesh.shards.shape[ax]
    pairs = [(_along(c, ax, i), c) for c in mesh.coords() for i in range(n)]
    got = exchange(mesh, pairs, parts)
    return {c: torch.stack([got[(_along(c, ax, i), c)] for i in range(n)])
            for c in parts}


def broadcast_last(mesh: Mesh, parts: dict, axis: str) -> dict:
    """out[c] = parts[c with the last index of `axis`]: the last time
    shard's state, replicated over the axis (the JAX bodies' masked psum)."""
    ax = mesh.axis(axis)
    last = mesh.shards.shape[ax] - 1
    pairs = [(_along(c, ax, last), c) for c in mesh.coords()]
    got = exchange(mesh, pairs, parts)
    return {dst: x for (_, dst), x in got.items()}
