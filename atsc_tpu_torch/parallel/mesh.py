"""Device meshes, and the placement of global arrays on them.

Counterpart of atsc_tpu/parallel/mesh.py. Mesh axes:
  "time" — blocks of consecutive fields of each stream (SP/CP analog);
  "ch"   — independent 8VSB channels (DP analog).

A Mesh is a grid of shards, each a (process rank, torch.device) pair. The
devices of one process may repeat: several shards then run on one card
(or the CPU) in turn, the port's counterpart of the JAX package's virtual
devices. A global array is placed on a mesh by a spec, one mesh axis name
(or None) per leading dimension, like a JAX PartitionSpec: a named
dimension is split evenly over that axis, every other dimension, and every
axis the spec leaves out, is replicated. A placed array is a dict from the
shard coordinates this process owns to that shard's tensor on its device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from atsc_tpu_torch import resolve_device

TIME_AXIS = "time"
CH_AXIS = "ch"


class Shard(NamedTuple):
    """One mesh position: the process that owns it and its device there."""

    rank: int
    device: torch.device


def _this_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A named grid of shards.

    devices: an array-like of torch devices (or device strings) shaped like
    the grid, all owned by this process; or, with `ranks` of the same
    shape, a grid that spans processes (parallel/distributed.py pod_mesh).
    """

    def __init__(self, devices, axis_names: tuple[str, ...], ranks=None):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != len(axis_names):
            raise ValueError(f"a {devs.ndim}-D device grid for axes {axis_names}")
        me = _this_rank()
        ranks = np.full(devs.shape, me) if ranks is None else np.asarray(ranks)
        self.shards = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            self.shards[idx] = Shard(int(ranks[idx]), torch.device(devs[idx]))
        self.axis_names = tuple(axis_names)
        self.rank = me

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shards.shape))

    def coords(self) -> list[tuple[int, ...]]:
        """Every shard coordinate, in row-major order."""
        return list(np.ndindex(self.shards.shape))

    def local(self) -> list[tuple[int, ...]]:
        """The coordinates of the shards this process owns."""
        return [c for c in self.coords() if self.shards[c].rank == self.rank]

    def device(self, coord) -> torch.device:
        return self.shards[coord].device

    def rank_of(self, coord) -> int:
        return self.shards[coord].rank

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def placement(self) -> list[str]:
        """'(t,c)=device' for every shard, row-major (the CLI prints it)."""
        return [f"({','.join(map(str, c))})={self.shards[c].device}"
                + (f"@rank{self.shards[c].rank}" if self.shards[c].rank != self.rank else "")
                for c in self.coords()]


def make_mesh(n_time: int, n_ch: int, devices=None) -> Mesh:
    """A ("time", "ch") mesh of n_time x n_ch shards over `devices` (row-
    major: shard (t, c) takes devices[t * n_ch + c]). devices=None takes
    the visible CUDA devices; a list may repeat a device. Refuses more
    shards than devices, as the JAX package's make_mesh does."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_time * n_ch
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = [resolve_device(d) for d in list(devices)[:n]]
    grid = np.empty((n_time, n_ch), dtype=object)
    for i, d in enumerate(devs):
        grid[i // n_ch, i % n_ch] = d
    return Mesh(grid, (TIME_AXIS, CH_AXIS))


# -- placing global arrays --------------------------------------------------

def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(fn, tree, *rest):
    """fn over the leaves of a NamedTuple (or over a single leaf)."""
    if _is_tree(tree):
        return type(tree)(*(fn(*leaves) for leaves in zip(tree, *rest)))
    return fn(tree, *rest)


def shard_index(mesh: Mesh, coord, spec: tuple, shape) -> tuple[slice, ...]:
    """The slice of a global array of `shape` that shard `coord` holds."""
    idx = []
    for dim, size in enumerate(shape):
        ax = spec[dim] if dim < len(spec) else None
        if ax is None:
            idx.append(slice(None))
            continue
        n = mesh.shards.shape[mesh.axis(ax)]
        if size % n:
            raise ValueError(f"dimension {dim} ({size}) does not divide over "
                             f"the {n} shards of axis {ax!r}")
        i = coord[mesh.axis(ax)]
        idx.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(idx)


def place(tree, mesh: Mesh, spec) -> dict:
    """Split full arrays (numpy, or tensors on any device) over the mesh:
    {coord: tree of that shard's tensors on its device} for the shards
    this process owns. Every part is a copy."""

    def part(coord):
        def one(x, sp):
            sl = x[shard_index(mesh, coord, sp, x.shape)]
            if isinstance(sl, torch.Tensor):
                return sl.to(mesh.device(coord), copy=True).contiguous()
            return torch.tensor(np.ascontiguousarray(sl), device=mesh.device(coord))
        return _tree_map(one, tree, spec)

    return {c: part(c) for c in mesh.local()}


def gather(parts: dict, mesh: Mesh, spec):
    """The inverse of place: the full arrays as host numpy, from shards
    that must cover every region (a replicated region takes any copy)."""
    first = next(iter(parts.values()))

    def leaf(k, sp):
        ref = first[k] if _is_tree(first) else first
        shape = list(ref.shape)
        for dim, ax in enumerate(sp):
            if ax is not None:
                shape[dim] *= mesh.shards.shape[mesh.axis(ax)]
        out = np.empty(shape, dtype=_np_dtype(ref))
        seen = np.zeros(shape[: max(1, len(sp))], dtype=bool)
        for coord, p in parts.items():
            x = p[k] if _is_tree(p) else p
            idx = shard_index(mesh, coord, sp, shape)
            out[idx] = x.cpu().numpy()
            seen[idx[: seen.ndim]] = True
        if not seen.all():
            raise ValueError("gather needs every shard's region; this process "
                             "owns only some (see parallel/distributed.py)")
        return out

    if _is_tree(first):
        return type(first)(*(leaf(i, sp) for i, sp in enumerate(spec)))
    return leaf(None, spec)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype
