"""Fused level-map + pilot-offset + RRC-FIR: the CUDA kernel's wrapper and
its plain PyTorch twin.

Counterpart of atsc_tpu/ops/pallas/offset_fir.py::offset_fir_fused; the
kernel is csrc/offset_fir.cu (its header says what bounds it). A CUDA
tensor goes to the kernel, a CPU tensor to `offset_fir_plain`; there is no
fallback from one to the other. `LAUNCHES` counts kernel launches, so a
run can show that its main path went through the kernel.

Output, for every format: (B, 2, 261120) planar, or (B, 261120) packed
wire lanes; samples [0, 260416) are the field's valid output. (The TPU
kernel's 262,144-wide quantized grid was Mosaic tiling and is not a
contract.)
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.assemble import field_levels
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.offset import _osc_planar, apply_pilot_offset
from atsc_tpu_torch.ops.quantize import (
    DTYPE,
    QMAX,
    WIRE_DTYPE,
    pack_wire,
    quantize_iq,
    quantize_scale,
)
from atsc_tpu_torch.ops.rrc_filter import rrc_filter_field
from atsc_tpu_torch.tables.rrc import rrc_taps

#: kernel launches in this process; callers may reset it to 0
LAUNCHES = 0

# (out_format, wire) -> the kernel's format code (csrc/offset_fir.cu Format)
_FORMAT_CODE = {
    ("cf32", False): 0,
    ("cs16", False): 1,
    ("cs8", False): 2,
    ("cs16", True): 3,
    ("cs8", True): 4,
}


def output_spec(
    batch: int, out_format: str = "cf32", wire: bool = False
) -> tuple[tuple[int, ...], torch.dtype]:
    """(shape, dtype) of the output for a batch, format and layout."""
    if (out_format, wire) not in _FORMAT_CODE:
        if out_format == "cf32" and wire:
            raise ValueError("wire layout applies to cs16/cs8 only "
                             "(cf32 stays planar; see iq_interleave)")
        raise ValueError(f"unknown out_format {out_format!r}")
    if wire:
        return (batch, P.PADDED_OUT), WIRE_DTYPE[out_format]
    dtype = torch.float32 if out_format == "cf32" else DTYPE[out_format]
    return (batch, 2, P.PADDED_OUT), dtype


def _check(field: torch.Tensor, phasor: torch.Tensor) -> None:
    if field.dtype != torch.int8 or field.ndim != 2 or (
            field.shape[1] != P.PADDED_SYMBOLS):
        raise ValueError(
            f"field must be (B, {P.PADDED_SYMBOLS}) int8, got "
            f"{tuple(field.shape)} {field.dtype}")
    if phasor.dtype != torch.float32 or tuple(phasor.shape) != (field.shape[0], 2):
        raise ValueError(
            f"phasor must be ({field.shape[0]}, 2) float32, got "
            f"{tuple(phasor.shape)} {phasor.dtype}")
    if phasor.device != field.device:
        raise ValueError(f"field on {field.device} but phasor on {phasor.device}")
    if not (field.is_contiguous() and phasor.is_contiguous()):
        raise ValueError("field and phasor must be contiguous")


def offset_fir_plain(
    field: torch.Tensor, phasor: torch.Tensor, out_format: str = "cf32",
    wire: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops, on any device:
    field_levels -> apply_pilot_offset -> banded float32 FIR ->
    quantize_iq -> pack_wire. The CPU path, and the oracle the kernel is
    held against on the card."""
    output_spec(field.shape[0], out_format, wire)
    _check(field, phasor)
    iq, _ = apply_pilot_offset(field_levels(field), phasor)
    iq = rrc_filter_field(iq)
    if out_format != "cf32":
        iq = quantize_iq(iq, out_format)
        if wire:
            iq = pack_wire(iq, out_format)
    return iq


@functools.lru_cache(maxsize=None)
def _kernel_lib(device_index: int) -> ctypes.CDLL:
    """The built kernel library, with the RRC taps loaded on this device."""
    lib = _build.load("offset_fir")
    lib.atsc_offset_fir_set_taps.restype = ctypes.c_int
    lib.atsc_offset_fir_set_taps.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.atsc_offset_fir.restype = ctypes.c_int
    lib.atsc_offset_fir.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p,
    ]
    taps = np.ascontiguousarray(rrc_taps(), dtype=np.float32)
    err = lib.atsc_offset_fir_set_taps(device_index, taps.ctypes.data)
    if err != 0:
        raise RuntimeError(f"loading the RRC taps on cuda:{device_index} "
                           f"failed: CUDA error {err}")
    return lib


def offset_fir_fused(
    field: torch.Tensor, phasor: torch.Tensor, out_format: str = "cf32",
    wire: bool = False,
) -> torch.Tensor:
    """field: (B, 261248) int8 symbol values; phasor: (B, 2) float32.

    'cf32': (B, 2, 261120) planar float32 IQ. 'cs16'/'cs8': the same IQ
    quantized to int16/int8 codes at quantize_scale. wire=True (cs16/cs8
    only): (B, 261120) int32/int16 lanes, one little-endian (I, Q) pair
    each, whose bytes are the interleaved SDR wire stream.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    offset_fir_plain.
    """
    global LAUNCHES
    shape, dtype = output_spec(field.shape[0], out_format, wire)
    _check(field, phasor)
    if field.device.type == "cpu":
        return offset_fir_plain(field, phasor, out_format, wire)
    if field.device.type != "cuda":
        raise ValueError(f"offset_fir_fused runs on cpu or cuda, not {field.device}")
    if field.data_ptr() % 4:  # the kernel stages the field 4 symbols at a time
        field = field.clone()
    dev = field.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    osc = const(_osc_planar, dev)
    quantized = out_format != "cf32"
    with torch.cuda.device(dev):  # the first call loads the taps on dev here
        err = _kernel_lib(dev.index).atsc_offset_fir(
            dev.index, field.data_ptr(), phasor.data_ptr(), osc.data_ptr(),
            out.data_ptr(), field.shape[0], _FORMAT_CODE[(out_format, wire)],
            quantize_scale(out_format) if quantized else 0.0,
            float(QMAX[out_format]) if quantized else 0.0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"offset_fir kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
