"""Operand rounding to a lower floating-point type, held in float64: the
controls of the correctness comparison compute the reference with their
operands rounded so, on any device alike."""

from __future__ import annotations

import torch

#: precision name -> what its operands are rounded to
PRECISIONS = ("f64", "tf32", "fp8")


def lower(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (any float type) rounded to `precision` and returned as float64.
    'tf32' keeps 10 mantissa bits (round half to even), 'fp8' is e4m3."""
    if precision == "f64":
        return x.to(torch.float64)
    if precision == "tf32":
        bits = x.to(torch.float32).contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0x0FFF + lsb) & ~0x1FFF
        return bits.view(torch.float32).to(torch.float64)
    if precision == "fp8":
        return x.to(torch.float32).to(torch.float8_e4m3fn).to(torch.float64)
    raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")


def fir_forward(x: torch.Tensor, taps: torch.Tensor, n_out: int,
                precision: str = "f64") -> torch.Tensor:
    """out[..., i] = sum_k x[..., i+k] taps[k] for i < n_out, in float64 as
    banded products of 128-sample blocks; x and taps rounded to `precision`
    first. x: (R, L) with L >= n_out + len(taps) - 1."""
    blk = 128
    xr = lower(x, precision)
    t = lower(taps, precision)
    n_taps = t.shape[0]
    bands = -(-(n_taps + blk - 1) // blk)
    nblk = -(-n_out // blk)
    need = (nblk + bands - 1) * blk
    if xr.shape[-1] < need:
        xr = torch.nn.functional.pad(xr, (0, need - xr.shape[-1]))
    a = xr[..., :need].reshape(xr.shape[0], nblk + bands - 1, blk)
    m = torch.arange(blk, device=x.device)
    out = None
    for s in range(bands):
        k = s * blk + m[:, None] - m[None, :]
        w = torch.where((k >= 0) & (k < n_taps), t[k.clamp(0, n_taps - 1)],
                        torch.zeros((), dtype=torch.float64, device=x.device))
        term = a[:, s:s + nblk].reshape(-1, blk) @ w
        out = term if out is None else out + term
    return out.reshape(x.shape[0], nblk * blk)[:, :n_out]
