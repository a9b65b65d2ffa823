"""Errors-only RS(207,187) correction as one kernel: the CUDA kernel's
wrapper.

The kernel is csrc/rs_correct.cu (its header says what bounds it and why
it replaces no TPU kernel); its plain twin is
ops/rs_decode.py::rs_correct_field_plain, and ops/rs_decode.py::
rs_correct_field sends a CUDA tensor here and a CPU tensor to the twin.
`LAUNCHES` counts kernel launches.

Input: codewords (..., 207) uint8 and their syndromes (..., 20) uint8
(syndrome_field of the same codewords), any leading shape. Output, as the
twin's: (corrected (..., 207) uint8, n (...,) int32), n >= 0 bytes
corrected, -1 uncorrectable with the codeword unchanged. A segment whose
syndromes are all zero is taken as clean (n = 0) without looking at its
bytes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops._const import const
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.tables.galois import gf_tables

#: kernel launches in this process; callers may reset it to 0
LAUNCHES = 0


@functools.lru_cache(maxsize=1)
def gf_table_bytes() -> np.ndarray:
    """(768,) uint8: exp[512] (alpha^(i mod 255)) then log[256], the
    tables the kernel holds in shared memory."""
    exp, log = gf_tables()
    return np.concatenate([exp, log]).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("rs_correct")
    lib.atsc_rs_correct.restype = ctypes.c_int
    lib.atsc_rs_correct.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def _aligned(x: torch.Tensor, align: int) -> torch.Tensor:
    """x contiguous and starting on an `align`-byte boundary (a copy only
    where a view starts elsewhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % align == 0 else x.clone()


def rs_correct(codewords: torch.Tensor, syn: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """codewords (..., 207) uint8, syn (..., 20) uint8, both on one CUDA
    device -> (corrected (..., 207) uint8, n (...,) int32). Launches the
    kernel (or raises)."""
    global LAUNCHES
    n_bytes, n_roots = P.SEGMENT_FEC_BYTES, P.RS_BYTES
    if codewords.dtype != torch.uint8 or codewords.ndim < 1 or codewords.shape[-1] != n_bytes:
        raise ValueError(f"codewords must be (..., {n_bytes}) uint8, got "
                         f"{tuple(codewords.shape)} {codewords.dtype}")
    lead = tuple(codewords.shape[:-1])
    if syn.dtype != torch.uint8 or tuple(syn.shape) != lead + (n_roots,):
        raise ValueError(f"syn must be {lead + (n_roots,)} uint8, got "
                         f"{tuple(syn.shape)} {syn.dtype}")
    dev = codewords.device
    if dev.type != "cuda" or syn.device != dev:
        raise ValueError(f"rs_correct runs on one CUDA device: codewords on {dev}, "
                         f"syn on {syn.device}")
    nseg = codewords.numel() // n_bytes
    if nseg > 2**31 - 1 - 128:
        raise ValueError(f"{nseg} segments: the kernel indexes segments as int32")
    out = torch.empty(lead + (n_bytes,), dtype=torch.uint8, device=dev)
    n = torch.empty(lead, dtype=torch.int32, device=dev)
    if nseg == 0:
        return out, n
    cw = _aligned(codewords, 16)
    s = _aligned(syn, 4)
    tables = const(gf_table_bytes, dev)
    with torch.cuda.device(dev):
        err = _kernel_lib().atsc_rs_correct(
            dev.index, cw.data_ptr(), s.data_ptr(), tables.data_ptr(), out.data_ptr(),
            n.data_ptr(), nseg, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rs_correct kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, n
