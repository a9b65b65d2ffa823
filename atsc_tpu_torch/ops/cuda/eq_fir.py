"""Fused derotate + widely-linear FIR + slicer: the receive equalizer's CUDA
kernel wrapper and its plain PyTorch twin.

Counterpart of atsc_tpu/ops/pallas/eq_fir.py::eq_fir_fused; the kernel is
csrc/eq_fir.cu (its header says what bounds it). A CUDA tensor goes to the
kernel, a CPU tensor to `eq_fir_plain`; there is no fallback from one to
the other. `LAUNCHES` counts kernel launches, so a run can show that its
main path went through the kernel.

Window contract, the JAX package's: the window covers stream span
[g0 - K, g0 - K + WIN_LEN) of a field starting at stream sample g0, and the
oscillator the same span. The output is (B, 260416): the field's samples.
(The TPU kernel's 262,144-wide output grid was Mosaic tiling and is not a
contract.) The kernel runs the receiver's two profiles: fast (K=128, bf16
operands, f32 sums) and exact (K=256, float32 accuracy from 3 x TF32
products on the tensor cores).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from atsc_tpu_torch import params as P
from atsc_tpu_torch.ops.cuda import _build
from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_SCALE
from atsc_tpu_torch.ops.rrc_filter import band_matrices_for, banded_fir_wl

_BLK = 128
#: window samples per plane, for every supported K (the JAX package's
#: (2048 + 8) x 128; the FIR reads [0, 260416 + 2K) of it)
WIN_LEN = 263168
N_OUT = P.SYMBOLS_PER_FIELD
#: (eq_k, exact) -> the kernel's tier: the receiver's fast and exact profiles
TIERS = {(128, False): 0, (256, True): 1}

#: kernel launches in this process; callers may reset it to 0
LAUNCHES = 0

_WIN_TYPE = {torch.float32: 0, torch.int16: 1, torch.int8: 2}


def bands_for(eq_k: int) -> int:
    """Number of 128-wide FIR bands for one-sided tap support K."""
    return (2 * eq_k) // _BLK + 1


def _taps_f32(eq_k: int) -> tuple[np.ndarray, np.ndarray]:
    from atsc_tpu_torch.models.receiver import _wl_eq_taps

    return _wl_eq_taps(eq_k)


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> nearest bf16 (round-half-even), held as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


@functools.lru_cache(maxsize=8)
def _band_weights(eq_k: int, dtype: str = "bfloat16") -> torch.Tensor:
    """(bands, 256, 128) CPU tensor: per band s, rows 0:128 apply to the
    derotated real plane and rows 128:256 to the imaginary plane.
    dtype 'bfloat16' for the fast tier's operands, 'float32' for exact."""
    p_taps, q_taps = _taps_f32(eq_k)
    br = band_matrices_for(p_taps)
    bi = band_matrices_for(q_taps)
    if len(br) != bands_for(eq_k):
        raise AssertionError((len(br), eq_k))
    w = np.stack([np.concatenate([r, i], axis=0) for r, i in zip(br, bi)])
    return torch.from_numpy(w).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _weights_on(eq_k: int, exact: bool, device: torch.device) -> torch.Tensor:
    """The band weights as float64 on `device` (bf16 values for fast)."""
    w = _band_weights(eq_k, "float32" if exact else "bfloat16")
    return w.to(device=device, dtype=torch.float64)


def _check(win: torch.Tensor, osc: torch.Tensor, eq_k: int, exact: bool) -> None:
    if (eq_k, exact) not in TIERS:
        raise ValueError(f"(eq_k, exact) must be one of {sorted(TIERS)}, got "
                         f"{(eq_k, exact)}")
    if win.dtype not in _WIN_TYPE or win.ndim != 3 or tuple(win.shape[1:]) != (2, WIN_LEN):
        raise ValueError(
            f"win must be (B, 2, {WIN_LEN}) float32/int16/int8, got "
            f"{tuple(win.shape)} {win.dtype}")
    if osc.dtype != torch.float32 or tuple(osc.shape) != (2, WIN_LEN):
        raise ValueError(
            f"osc must be (2, {WIN_LEN}) float32, got {tuple(osc.shape)} {osc.dtype}")
    if osc.device != win.device:
        raise ValueError(f"win on {win.device} but osc on {osc.device}")
    if not (win.is_contiguous() and osc.is_contiguous()):
        raise ValueError("win and osc must be contiguous")


def _scale(dequant: float) -> np.float32:
    """The derotation constant dequant / 0.9^2, rounded once to float32."""
    return np.float32(dequant / (P.OSC_AMPLITUDE ** 2))


def eq_fir_plain(
    win: torch.Tensor, osc: torch.Tensor, eq_k: int = 128, soft: bool = False,
    dequant: float = 1.0, exact: bool = False, soft_q: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops, on any device: derotate
    in float32 (separate eager ops, so nothing fuses into an FMA), round the
    operands to bf16 for the fast tier, then banded_fir_wl over the band
    matrices of _wl_eq_taps, then the output mode. The CPU path, and the
    oracle the kernel is held against on the card.

    The FIR sums run in float64 and round once to float32: the operands
    (float32, or bf16 values) and their products are exact there, so the
    level is the correctly rounded sum, the reference both tiers of the
    kernel are held to (a float32 chain of 2 x 513 terms drifts ~1e-5, the
    exact tier's whole budget). A bf16 torch.matmul is never used: on the
    CPU it rounds its output to bf16 too.
    """
    _check(win, osc, eq_k, exact)
    dev = win.device
    s = torch.tensor(_scale(dequant), device=dev)
    wr = win[:, 0].to(torch.float32)
    wi = win[:, 1].to(torch.float32)
    cr, ci = osc[0], osc[1]
    ur = (wr * cr + wi * ci) * s
    ui = (wi * cr - wr * ci) * s
    if not exact:
        ur = ur.to(torch.bfloat16).to(torch.float32)
        ui = ui.to(torch.bfloat16).to(torch.float32)
    lev = banded_fir_wl(ur.to(torch.float64), ui.to(torch.float64),
                        _weights_on(eq_k, exact, dev), N_OUT).to(torch.float32)
    if soft and soft_q:
        scale = torch.tensor(SOFT_LEVEL_SCALE, dtype=torch.float32, device=dev)
        return torch.clamp(torch.round(lev * scale), -127, 127).to(torch.int8)
    if soft:
        return lev
    sym = torch.round((lev - (P.PILOT_OFFSET - 7.0)) * 0.5)  # -5.75, exact
    return torch.clamp(sym, 0, 7).to(torch.int8)


@functools.lru_cache(maxsize=None)
def _kernel_lib(device_index: int) -> ctypes.CDLL:
    """The built kernel library (each tier's taps load at its first use,
    _tier)."""
    lib = _build.load("eq_fir")
    lib.atsc_eq_fir_set_taps.restype = ctypes.c_int
    lib.atsc_eq_fir_set_taps.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.atsc_eq_fir.restype = ctypes.c_int
    lib.atsc_eq_fir.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _tier(device_index: int, eq_k: int, exact: bool) -> int:
    """The kernel tier of (eq_k, exact), its taps loaded on the device at
    first use: the fast tier's rounded to bf16 here, once, and laid out
    by the library as the tensor-core kernel's band matrices; the exact
    tier's split by the library into tf32 hi and lo parts for its 3 x TF32
    products. Call it with the device current."""
    tier = TIERS[(eq_k, exact)]
    p, q = _taps_f32(eq_k)
    if not exact:
        p, q = _bf16_round(p), _bf16_round(q)
    p = np.ascontiguousarray(p, np.float32)
    q = np.ascontiguousarray(q, np.float32)
    err = _kernel_lib(device_index).atsc_eq_fir_set_taps(
        device_index, tier, p.ctypes.data, q.ctypes.data, p.size)
    if err != 0:
        raise RuntimeError(f"loading the equalizer taps on cuda:{device_index} "
                           f"failed: CUDA error {err}")
    return tier


def eq_fir_fused(
    win: torch.Tensor, osc: torch.Tensor, eq_k: int = 128, soft: bool = False,
    dequant: float = 1.0, exact: bool = False, soft_q: bool = False,
) -> torch.Tensor:
    """win: (B, 2, WIN_LEN) planar window (float32, or cs16/cs8 int16/int8
    codes with dequant = 1 / quantize_scale) covering stream span
    [g0 - eq_k, ...); osc: (2, WIN_LEN) float32 oscillator for the same span.

    Returns (B, 260416): int8 hard symbols (soft=False), float32 soft levels
    (soft=True), or int8 soft-level codes at SOFT_LEVEL_SCALE (soft=True,
    soft_q=True). (eq_k, exact): (128, False), the fast tier with bf16
    operands, or (256, True), the fp32 exact tier.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    eq_fir_plain. The kernels load win and osc 16 bytes at a time, so on
    CUDA each must start at a 16-byte-aligned address: one that does not
    (a window cut out of a longer device-resident stream at an odd
    offset) is cloned first, a copy of the whole tensor on every call
    (0.8 GB for a B=384 float32 window, about the kernel's own time).
    """
    global LAUNCHES
    _check(win, osc, eq_k, exact)
    if win.device.type == "cpu":
        return eq_fir_plain(win, osc, eq_k, soft, dequant, exact, soft_q)
    if win.device.type != "cuda":
        raise ValueError(f"eq_fir_fused runs on cpu or cuda, not {win.device}")
    b = win.shape[0]
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 (the kernel's grid.y)")
    dev = win.device
    if win.data_ptr() % 16:  # the kernels load the window 16 bytes at a time
        win = win.clone()
    if osc.data_ptr() % 16:
        osc = osc.clone()
    out_mode = (2 if soft_q else 1) if soft else 0
    out = torch.empty((b, N_OUT), dtype=torch.float32 if out_mode == 1 else torch.int8,
                      device=dev)
    with torch.cuda.device(dev):  # the first call loads the tier's taps on dev here
        tier = _tier(dev.index, eq_k, exact)
        err = _kernel_lib(dev.index).atsc_eq_fir(
            dev.index, win.data_ptr(), _WIN_TYPE[win.dtype], osc.data_ptr(),
            out.data_ptr(), b, tier, out_mode, float(_scale(dequant)),
            float(np.float32(SOFT_LEVEL_SCALE)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"eq_fir kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
