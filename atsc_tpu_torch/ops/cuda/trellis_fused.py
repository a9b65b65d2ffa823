"""The 12-way trellis encoder as one kernel: the CUDA kernel's wrapper and
its plain PyTorch twin.

Counterpart of tools/trellis_fuse_probe.py::trellis_fused, the JAX
package's probe of a fused trellis kernel; the kernel is
csrc/trellis_fused.cu (its header says what bounds it). A CUDA tensor goes
to the kernel, a CPU tensor to `trellis_fused_plain`; there is no fallback
from one to the other. `LAUNCHES` counts kernel launches.

Input: the interleaved field in encoder-major layout padded from 5,382 to
5,504 bytes per encoder, (B, 12, 5504) uint8, and the carries d/d1/d2
(B, 12) int32 in {0, 1}. Output: the symbols of all 5,504 bytes, pad bytes
included (the TPU kernel's whole output, bit for bit), interleaved in
stream order (B, 12, 22016) int8 or plane-major (B, 12, 4, 5504) int8;
`to_stream` cuts either to `trellis_encode_field`'s (B, 12, 21528). The
kernel does not return the next carries: `trellis_encode_field` does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.trellis import trellis_planes

PAD_BYTES = 5504                    # 43 x 128: the TPU kernel's padded row
PAD_SYMBOLS = 4 * PAD_BYTES         # 22,016

#: kernel launches in this process; callers may reset it to 0
LAUNCHES = 0


def _check(il_pad: torch.Tensor, d: torch.Tensor, d1: torch.Tensor,
           d2: torch.Tensor) -> None:
    if il_pad.dtype != torch.uint8 or il_pad.ndim != 3 or (
            tuple(il_pad.shape[1:]) != (P.TRELLIS_ENCODERS, PAD_BYTES)):
        raise ValueError(
            f"il_pad must be (B, {P.TRELLIS_ENCODERS}, {PAD_BYTES}) uint8, got "
            f"{tuple(il_pad.shape)} {il_pad.dtype}")
    want = (il_pad.shape[0], P.TRELLIS_ENCODERS)
    for name, c in (("d", d), ("d1", d1), ("d2", d2)):
        if c.dtype != torch.int32 or tuple(c.shape) != want:
            raise ValueError(f"{name} must be {want} int32, got "
                             f"{tuple(c.shape)} {c.dtype}")
        if c.device != il_pad.device:
            raise ValueError(f"il_pad on {il_pad.device} but {name} on {c.device}")
        if not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not il_pad.is_contiguous():
        raise ValueError("il_pad must be contiguous")


def trellis_fused_plain(
    il_pad: torch.Tensor, d: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
    interleaved: bool = True,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops, on any device: the XOR
    plane algebra of ops/trellis.py over all 5,504 bytes. The CPU path, and
    the oracle the kernel is held against on the card."""
    _check(il_pad, d, d1, d2)
    planes = trellis_planes(il_pad, d, d1, d2)[0]
    if interleaved:
        return torch.stack(planes, dim=-1).reshape(
            il_pad.shape[0], P.TRELLIS_ENCODERS, PAD_SYMBOLS)
    return torch.stack(planes, dim=-2)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("trellis_fused")
    lib.atsc_trellis_fused.restype = ctypes.c_int
    lib.atsc_trellis_fused.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return lib


def trellis_fused(
    il_pad: torch.Tensor, d: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
    interleaved: bool = True,
) -> torch.Tensor:
    """il_pad: (B, 12, 5504) uint8 (bytes >= 5382 are don't-care);
    d/d1/d2: (B, 12) int32 in {0, 1}. Returns symbols (B, 12, 22016) int8
    in stream order (interleaved=True) or (B, 12, 4, 5504) plane-major.

    The JAX probe's `chans` (channels per Mosaic block) and `interpret`
    have no counterpart: the kernel's blocking is its own, and a CPU
    tensor runs the plain twin. A CUDA tensor launches the kernel (or
    raises).
    """
    global LAUNCHES
    _check(il_pad, d, d1, d2)
    if il_pad.device.type == "cpu":
        return trellis_fused_plain(il_pad, d, d1, d2, interleaved)
    if il_pad.device.type != "cuda":
        raise ValueError(f"trellis_fused runs on cpu or cuda, not {il_pad.device}")
    if il_pad.data_ptr() % 16:
        raise ValueError("il_pad must be 16-byte aligned (the kernel loads 16 bytes a lane)")
    dev = il_pad.device
    b = il_pad.shape[0]
    shape = ((b, P.TRELLIS_ENCODERS, PAD_SYMBOLS) if interleaved
             else (b, P.TRELLIS_ENCODERS, 4, PAD_BYTES))
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib().atsc_trellis_fused(
            dev.index, il_pad.data_ptr(), d.data_ptr(), d1.data_ptr(),
            d2.data_ptr(), out.data_ptr(), b * P.TRELLIS_ENCODERS,
            int(interleaved), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"trellis_fused kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def to_stream(sym: torch.Tensor, interleaved: bool) -> torch.Tensor:
    """Either output layout -> (B, 12, 21528) stream order, the symbols of
    the 5,382 field bytes (the JAX probe's _to_stream)."""
    if not interleaved:
        sym = sym.transpose(-1, -2).reshape(sym.shape[0], P.TRELLIS_ENCODERS, PAD_SYMBOLS)
    return sym[..., : P.TRELLIS_SYMBOLS_PER_ENCODER]
