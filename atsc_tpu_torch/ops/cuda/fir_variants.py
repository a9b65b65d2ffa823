"""Design variants of the fused offset+FIR (cf32) in the banded-matmul form:
the CUDA kernel's wrapper and its plain PyTorch twin.

Counterpart of tools/fir_probe.py::run_variant, the JAX package's probe of
restructurings of its offset_fir kernel; the kernel is
csrc/fir_variants.cu (its header says what bounds it). It computes what
offset_fir_fused computes in cf32, (B, 2, 261120) planar float32, as

    FIR_u[j] = U[j] @ W_lo + U[j+1] @ W_hi      (u = level * osc_re)
    FIR_w[j] = W[j] @ W_lo + W[j+1] @ W_hi      (w = level * osc_im)

over 128-sample rows, rotated by the phasor afterwards. Variants: "base"
(each operand modulated on its own, two K=128 products summed),
"sharedmod" (modulate once, the shifted operand read one row down),
"onedot" (one K=256 product of [U[j] | U[j+1]] and [W_lo; W_hi]) and
"combo" (both). `nchunk` (a divisor of 2040) sets the output rows per
block. A CUDA tensor goes to the kernel, a CPU tensor to
`run_variant_plain`; there is no fallback from one to the other.
`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.cuda.offset_fir import _check
from atsc_tpu_torch.ops.offset import _osc_planar
from atsc_tpu_torch.ops.rrc_filter import _BLK, _w_hi, _w_lo

VARIANTS = ("base", "sharedmod", "onedot", "combo")
# variant -> (shared_mod, one_dot), the kernel's template flags
_FLAGS = {"base": (0, 0), "sharedmod": (1, 0), "onedot": (0, 1), "combo": (1, 1)}
_OUT_ROWS = P.PADDED_OUT // _BLK          # 2040
_LEVEL_BIAS = P.PILOT_OFFSET - 7.0        # level = 2v - 7 + 1.25

#: kernel launches in this process; callers may reset it to 0
LAUNCHES = 0


@functools.lru_cache(maxsize=1)
def _w2() -> np.ndarray:
    """(256, 128) float32: W_lo over W_hi, the K=256 weight of one product."""
    return np.concatenate([_w_lo(), _w_hi()], axis=0)


def _check_variant(field: torch.Tensor, phasor: torch.Tensor, variant: str,
                   nchunk: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    if not isinstance(nchunk, int) or nchunk < 1 or _OUT_ROWS % nchunk:
        raise ValueError(f"nchunk must divide {_OUT_ROWS}, got {nchunk!r}")
    _check(field, phasor)


def run_variant_plain(
    field: torch.Tensor, phasor: torch.Tensor, variant: str, nchunk: int = 5,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops, on any device, with each
    variant's own products: "onedot"/"combo" one K=256 matmul, "base"/
    "sharedmod" two K=128 matmuls summed (nchunk is checked and changes
    nothing here). The CPU path, and the oracle the kernel is held against
    on the card. On CUDA it refuses TF32 matmuls, which cannot hold 2e-6."""
    _check_variant(field, phasor, variant, nchunk)
    if field.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("run_variant_plain needs float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    dev = field.device
    b = field.shape[0]
    osc = const(_osc_planar, dev).reshape(2, 1, _OUT_ROWS + 1, _BLK)
    lvl = field.reshape(1, b, _OUT_ROWS + 1, _BLK).to(torch.float32) * 2.0 + _LEVEL_BIAS
    uw = lvl * osc                                    # (2, B, 2041, 128): u, w
    a, nxt = uw[:, :, :_OUT_ROWS], uw[:, :, 1:]
    if _FLAGS[variant][1]:
        f = torch.cat([a, nxt], dim=-1) @ const(_w2, dev)
    else:
        f = a @ const(_w_lo, dev) + nxt @ const(_w_hi, dev)
    fu, fw = f[0], f[1]                               # (B, 2040, 128)
    pr, pi = phasor[:, 0, None, None], phasor[:, 1, None, None]
    out = torch.stack([fu * pr - fw * pi, fu * pi + fw * pr], dim=1)
    return out.reshape(b, 2, P.PADDED_OUT)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fir_variants")
    lib.atsc_fir_variant.restype = ctypes.c_int
    lib.atsc_fir_variant.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def run_variant(
    field: torch.Tensor, phasor: torch.Tensor, variant: str, nchunk: int = 5,
) -> torch.Tensor:
    """field: (B, 261248) int8 symbol values; phasor: (B, 2) float32.
    Returns (B, 2, 261120) planar float32 IQ, valid through sample 260,416,
    computed by `variant` (one of VARIANTS) with 2040 / nchunk output rows
    per block.

    The JAX probe's `interpret` has no counterpart: a CPU tensor runs the
    plain twin. A CUDA tensor launches the kernel (or raises).
    """
    global LAUNCHES
    _check_variant(field, phasor, variant, nchunk)
    if field.device.type == "cpu":
        return run_variant_plain(field, phasor, variant, nchunk)
    if field.device.type != "cuda":
        raise ValueError(f"run_variant runs on cpu or cuda, not {field.device}")
    if field.data_ptr() % 4:
        raise ValueError("field must be 4-byte aligned (the kernel loads 4 symbols at once)")
    dev = field.device
    out = torch.empty((field.shape[0], 2, P.PADDED_OUT), dtype=torch.float32, device=dev)
    shared_mod, one_dot = _FLAGS[variant]
    with torch.cuda.device(dev):
        err = _kernel_lib().atsc_fir_variant(
            dev.index, field.data_ptr(), phasor.data_ptr(),
            const(_osc_planar, dev).data_ptr(), const(_w2, dev).data_ptr(),
            out.data_ptr(), field.shape[0], nchunk, shared_mod, one_dot,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fir_variants kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
