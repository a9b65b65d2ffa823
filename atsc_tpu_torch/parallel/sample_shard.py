"""Intra-field sample-block sharding: overlap-save pilot offset + RRC FIR
with a halo exchange, for minimum single-channel latency.

Counterpart of atsc_tpu/parallel/sample_shard.py. One field's 260,416
output samples are split into equal contiguous blocks over the "sp" mesh
axis. Each shard modulates its block onto its slice of the oscillator,
then receives the 111-sample lookahead halo from its right neighbour
(overlap-save). The last shard synthesizes its halo from the field-sync
padding constants, the trick that makes whole fields independent
(reference filter.h lookahead + field_sync.h padding copy).

Like the JAX module this path does not use the fused back-half kernel
(offset_fir_fused): that kernel's grid is whole 261,248-sample fields,
and a block plus its halo is neither field-shaped nor block-aligned. The
filter is ops/rrc_filter.py's banded float32 FIR, the kernel's plain
form. Use field_shard for throughput; this module is for latency.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.offset import _osc_planar
from atsc_tpu_torch.ops.rrc_filter import banded_fir
from atsc_tpu_torch.parallel.collectives import ring_permute
from atsc_tpu_torch.parallel.mesh import Mesh, place
from atsc_tpu_torch.tables.sync import sync_templates

SP_AXIS = "sp"
_HALO = P.RRC_LOOKAHEAD  # 111


@functools.lru_cache(maxsize=1)
def _pad_template() -> np.ndarray:
    """(2, 111) float32: the first 111 padding-segment symbol levels per
    parity (constant: the field-sync copy written after the field end)."""
    template, is_const = sync_templates()
    pad = template[:, P.SYMBOLS_PER_FIELD : P.SYMBOLS_PER_FIELD + _HALO]
    assert is_const[P.SYMBOLS_PER_FIELD : P.SYMBOLS_PER_FIELD + _HALO].all()
    return pad.copy()


def _modulate(lev: torch.Tensor, osc: torch.Tensor, phasor: torch.Tensor) -> torch.Tensor:
    """(B, n) real levels onto the oscillator span (2, n) and the per-
    stream phasor (B, 2): (B, 2, n) planar, in ops/offset.py's op order."""
    tr, ti = osc[0][None, :], osc[1][None, :]
    pr, pi = phasor[:, 0:1], phasor[:, 1:2]
    return torch.stack([lev * (tr * pr - ti * pi), lev * (tr * pi + ti * pr)], dim=1)


class SampleShardedFilter:
    """Sharded offset + FIR over a 1-D "sp" mesh: a field's (B, 260416)
    real symbol levels (no padding) -> (B, 260416, 2) IQ, the samples
    split over the shards."""

    def __init__(self, mesh: Mesh):
        if SP_AXIS not in mesh.axis_names:
            raise ValueError(f"the mesh needs an {SP_AXIS!r} axis, has {mesh.axis_names}")
        self.mesh = mesh
        self.n_sp = mesh.shape[SP_AXIS]
        if P.SYMBOLS_PER_FIELD % self.n_sp:
            raise ValueError(f"260416 must divide over {self.n_sp} sample shards")

    def __call__(self, field, phasor, parity) -> torch.Tensor:
        """field: (B, 260416) float32 (data + sync levels, no padding);
        phasor: (B, 2) float32; parity: (B,) int -> (B, 260416, 2)
        float32 on shard 0's device."""
        mesh, n_sp = self.mesh, self.n_sp
        ax = mesh.axis(SP_AXIS)
        nb = P.SYMBOLS_PER_FIELD // n_sp
        blocks = place(torch.as_tensor(np.asarray(field, np.float32)), mesh, (None, SP_AXIS))
        rep = {c: (torch.as_tensor(np.asarray(phasor, np.float32)).to(mesh.device(c)),
                   torch.as_tensor(np.asarray(parity)).to(mesh.device(c), torch.int64))
               for c in blocks}
        my = {}
        for c, blk in blocks.items():
            d = c[ax]
            osc = const(_osc_planar, blk.device)[:, d * nb : (d + 1) * nb]
            my[c] = _modulate(blk, osc, rep[c][0])                 # (B, 2, nb)
        # halo: each shard's first 111 modulated samples go to its left
        # neighbour; the last shard makes its own from the padding levels
        halo = ring_permute(mesh, {c: m[:, :, :_HALO] for c, m in my.items()}, SP_AXIS,
                            shift=-1)
        out = {}
        for c, m in my.items():
            if c[ax] == n_sp - 1:
                dev = m.device
                pad_lev = const(_pad_template, dev)[rep[c][1]]      # (B, 111)
                pad_osc = const(_osc_planar, dev)[:, P.SYMBOLS_PER_FIELD :
                                                  P.SYMBOLS_PER_FIELD + _HALO]
                h = _modulate(pad_lev, pad_osc, rep[c][0])
            else:
                h = halo[c]
            ext = torch.cat([m, h], dim=-1)                       # (B, 2, nb + 111)
            out[c] = banded_fir(ext, nb).transpose(1, 2)          # (B, nb, 2)
        dev0 = mesh.device(mesh.coords()[0])
        return torch.cat([out[c].to(dev0) for c in sorted(out)], dim=1)


def dryrun(n_devices: int, devices=None) -> None:
    """One sample-sharded offset + FIR of a zero field on a 1-D "sp" mesh
    of n_devices (default: the visible CUDA devices)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    filt = SampleShardedFilter(Mesh(list(devices)[:n_devices], (SP_AXIS,)))
    out = filt(np.zeros((1, P.SYMBOLS_PER_FIELD), np.float32),
               np.asarray([[1.0, 0.0]], np.float32), np.zeros((1,), np.int32))
    assert tuple(out.shape) == (1, P.SYMBOLS_PER_FIELD, 2)
