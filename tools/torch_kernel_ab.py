#!/usr/bin/env python3
"""The redesigned hand kernels of the PyTorch port, head to head with design
variants of their sources and, given checkouts of other trees, with those
trees' kernels, on one CUDA device at B=384:

  offset_fir  offset_fir_fused (csrc/offset_fir.cu): outputs per thread,
              kR = 8 (this tree) against 4 and 12; cf32, cs16 planar and
              cs8 wire timed, all five formats compared
  pr_acs      pr_acs_forward (csrc/viterbi_acs.cu): threads per block,
              kPrThreads = 32 (this tree) against 64, 128 and 256, on
              random observations over the 21,528 steps of a field
              (segment-sync reset steps included)
  acs         acs_forward (csrc/viterbi_acs.cu, the butterfly): float32
              groups prefetched into L2, kAcsAhead = 2 (this tree) against
              0 (none); threads per block, kAcsThreads = 32 against 64; on
              random float32 levels and their int8 codes over the 21,528
              steps of a field
  tb          traceback and pr_traceback (csrc/viterbi_acs.cu, chunk-parallel):
              chunks per lane, kTbChunks = 16 (this tree) against 8 and 32
              (4-state), kPrTbChunks = 8 against 16 and 32 (PR); lanes per
              block (both), kTbLanes = 32 against 16 and 8; on the
              decisions of acs_forward / pr_acs_forward over random levels
              (with each chunk's head length, in groups of 24 steps) and on
              decision words on which no two chains ever merge
  eq_fir      eq_fir_fused, fast tier (csrc/eq_fir.cu): 16 x 16 tiles per
              warp, kTilesPerWarp = 4 (this tree) against 2, and channels
              per block, kTcChannels = 16 against 8; cf32,
              cs16 and cs8 windows (random IQ and its codes), hard, soft and
              soft-code outputs
  eq_exact    eq_fir_fused, exact tier (csrc/eq_fir.cu, 3 x TF32 on the
              tensor cores): 16-row tiles a warp holds across the band loop,
              kXTilesPerWarp = 2 (this tree) against 1; outputs a row and
              taps a band row, kXBand = 32 against 16; k-steps per Kahan
              chunk, kXChunkSteps = 4 against 2 and 8; the same windows and
              outputs as eq_fir (the random window at phase 7's 0.2 sigma),
              every build held to the exact tier's limits against
              eq_fir_plain (soft within 1e-5)
  fir_variants  run_variant (csrc/fir_variants.cu, 3 x TF32): the seven
              probe runs of tools/torch_fir_probe.py at B=384; the register
              floor that sets the blocks an SM, kRegsFloor = 168 (this tree:
              3 blocks with shared modulation) against 128 (4 blocks);
              n-tiles a warp, kGroupTiles = 4 against 2 (twice the warps);
              output rows a tile, kTile = 16 against 32 (twice the warps and
              the shared memory a block);
              offset_fir_fused timed beside them; every build held to 2e-6
              against run_variant_plain
  trellis_fused  trellis_fused (csrc/trellis_fused.cu, SWAR on 32-bit words):
              both layouts at B=384 (and bit identity at B=1 and 23),
              timed back to back and with the L2 flushed before each
              launch; warps a block, kWarps = 4 (this tree) against 8;
              every build held bit for bit to trellis_fused_plain; the
              SASS instructions of each build's main loop (its innermost
              loop: the rounds of a row) per input byte (the loop's
              instructions over the bytes a lane takes an iteration,
              kLaneBytes, or kVec in the earlier form); beside them, for
              scale, PyTorch's fill_ of the output and a copy kernel with
              the kernel's loads and stores and no arithmetic
  mma_peak    no source of the package: the card's mma.sync rate, a kernel
              of independent mma.sync.m16n8k8 tf32 products in registers on
              every SM, in TFLOP/s and products per SM and clock at the
              highest SM clock (the issue floor of the two tf32 kernels
              above)
  chunked     acs_forward_chunked (float32 and int8) and traceback_chunked
              (csrc/viterbi_acs.cu, the chunked 4-state passes) at B=384
              and B=1 for C = 2 and 24 chunks (--chunks): words a
              register group of the forward pass, kAcsChunkWords = 4 (this
              tree) against 2; decision words in flight in the traceback,
              kTbChunkWords = 8 against 4 and 16; threads per block,
              kChunk4Threads = 32 against 64; on noisy 8-level soft
              levels, their int8 codes and the forward pass's decisions.
              The chunked PR passes, pr_acs_forward_chunked on the comb of
              such levels with the field's reset/sign table and
              pr_traceback_chunked on its decisions, at the same points:
              threads a chunk-lane, kPrLaneThreads = 0 (this tree: chosen
              from C L) against 1, 2 and 4; steps a register group per
              thread a chunk-lane, kPrGroupSteps = 2 against 1 and 4;
              decision words in flight in the traceback, kPrTbAhead = 32
              against 16 and 64; threads per block, kChunkThreads = 64
              against 32. A variant runs only the cases of the kernels
              its constant shapes. And the instructions of each build's
              loops (below)

A variant is a copy of this tree's source with that one constant changed;
each build is compiled here with the package's nvcc flags into
atsc_tpu_torch/_build/ab/. Every build runs on the same inputs through the
package's own wrapper, routed to that build's library. Each is timed twice
with CUDA events, the second pass in the reverse order of the first. One
JSON line per build and case: {"kernel", "build", "ms", "identical",
"max_abs_err", ...}, compared with this tree's build; the first two lines
are nvidia-smi's name and power limit, and the card's highest SM clock.
Exit 1 if a build fails or differs from this tree's build beyond the
kernel's limit: pr_acs, acs and chunked
in any bit (decisions and final metrics); tb in any bit; offset_fir by more
than 2e-6 (cf32) or 1 LSB (codes); eq_fir by more than 1e-4 in a soft
level, or in a hard symbol or soft code other than by 1 within 1e-4 of a
decision boundary (chip_smoke phase 7's limits); eq_exact likewise with
1e-5, each build against the plain twin; fir_variants by more than 2e-6
from the plain twin; trellis_fused in any bit from the plain twin. The
ptxas lines of each build (registers, spills, shared memory) are printed
with it, and for eq_exact, fir_variants and trellis_fused the
instructions of each instantiation's largest loop by opcode (cuobjdump).

For `chunked` it also disassembles each build's library (cuobjdump -sass
beside nvcc) and prints, per chunked kernel (each instantiation), the
instructions of its largest loop and of one trellis step of it: the
instructions on the loop's main path (the longest path from its head to
its back branch through blocks that run no FSEL, where one exists: the PR
forward pass's no-reset path; else the longest) over the steps one pass of
it walks (4 kAcsChunkWords, 4 kTbChunkWords, kPrGroupSteps times the
threads a chunk-lane T, and the PR traceback's one output word, 4 steps,
where the source defines those constants; else the earlier forms' one
word, 4 steps, and one step), and for the PR forward pass that per thread
times T; the listing of those kernels written to
atsc_tpu_torch/_build/ab/sass/<build>.txt.

Usage: python tools/torch_kernel_ab.py [--kernels NAME ...]
       [--earlier DIR ...] [--batch 384] [--iters 10] [--chunks 2 24]
(DIR: a checkout of another tree inside this one, for example a `git
archive` of the parent commit unpacked into the git-ignored .archive_check/)
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from atsc_tpu_torch import params as P  # noqa: E402
from atsc_tpu_torch import resolve_device  # noqa: E402
from atsc_tpu_torch.ops.cuda import _build  # noqa: E402
from atsc_tpu_torch.ops.cuda import eq_fir as eqk  # noqa: E402
from atsc_tpu_torch.ops.cuda import fir_variants as fvk  # noqa: E402
from atsc_tpu_torch.ops.cuda import offset_fir as fir  # noqa: E402
from atsc_tpu_torch.ops.cuda import trellis_fused as tfk  # noqa: E402
from atsc_tpu_torch.ops.cuda import viterbi_acs as vk  # noqa: E402
from atsc_tpu_torch.ops.ntsc import _pr_tables  # noqa: E402
from atsc_tpu_torch.ops.quantize import (  # noqa: E402
    QMAX,
    SOFT_LEVEL_INV,
    SOFT_LEVEL_SCALE,
    quantize_scale,
    quantize_soft_levels,
    unpack_wire,
)

AB_DIR = os.path.join(_build.BUILD_DIR, "ab")
# kernel -> (source, wrapper module, ((constant, this tree's value, variants), ...))
KERNELS = {
    "offset_fir": ("offset_fir", fir, (("kR", 8, (4, 12)),)),
    "pr_acs": ("viterbi_acs", vk, (("kPrThreads", 32, (64, 128, 256)),)),
    "acs": ("viterbi_acs", vk,
            (("kAcsAhead", 2, (0,)), ("kAcsThreads", 32, (64,)))),
    "tb": ("viterbi_acs", vk, (("kTbChunks", 16, (8, 32)), ("kPrTbChunks", 8, (16, 32)),
                                ("kTbLanes", 32, (16, 8)))),
    "eq_fir": ("eq_fir", eqk, (("kTilesPerWarp", 4, (2,)), ("kTcChannels", 16, (8,)))),
    "eq_exact": ("eq_fir", eqk, (("kXTilesPerWarp", 2, (1,)), ("kXBand", 32, (16,)),
                                 ("kXChunkSteps", 4, (2, 8)))),
    "fir_variants": ("fir_variants", fvk, (("kRegsFloor", 168, (128,)), ("kGroupTiles", 4, (2,)),
                                           ("kTile", 16, (32,)))),
    "trellis_fused": ("trellis_fused", tfk, (("kWarps", 4, (8,)),)),
    "mma_peak": (None, None, ()),
    "chunked": ("viterbi_acs", vk, (("kAcsChunkWords", 4, (2,)), ("kTbChunkWords", 8, (4, 16)),
                                    ("kChunk4Threads", 32, (64,)),
                                    ("kPrLaneThreads", 0, (1, 2, 4)), ("kPrGroupSteps", 2, (1, 4)),
                                    ("kPrTbAhead", 32, (16, 64)), ("kChunkThreads", 64, (32,)))),
}
CHUNKS = (2, 24)     # chunked: the chunk counts
# eq_exact, fir_variants: the kernel whose largest loop's opcodes are counted
LOOP_MIX = {"eq_exact": "eq_fir_exact_kernel", "fir_variants": "fir_variant_kernel",
            "trellis_fused": "trellis_fused_kernel"}
# chunked: the kernels (longest names first) and the constants that shape each
CHUNKED_SASS = {
    "pr_acs_forward_chunked_kernel": ("kPrLaneThreads", "kPrGroupSteps", "kChunkThreads"),
    "pr_traceback_chunked_kernel": ("kPrTbAhead", "kChunkThreads"),
    "acs_forward_chunked_kernel": ("kAcsChunkWords", "kChunk4Threads"),
    "traceback_chunked_kernel": ("kTbChunkWords", "kChunk4Threads"),
}
FIR_FORMATS = (("cf32", False), ("cs16", False), ("cs8", False), ("cs16", True),
               ("cs8", True))
FIR_TIMED = (("cf32", False), ("cs16", False), ("cs8", True))
# fir_variants: tools/torch_fir_probe.py's banded runs, and the variant's default
FIR_RUNS = (("base", 5), ("base", 15), ("base", 17), ("onedot", 5), ("sharedmod", 5),
            ("combo", 5), ("combo", 15))
TOL_CF32, TOL_LSB = 2e-6, 1
TOL_EQ_SOFT = 1e-4
TOL_EQ_EXACT = 1e-5
STEPS = 21528        # trellis steps of a field
L2_FLUSH_BYTES = 256 << 20   # written before each launch that must find the 50 MB L2 cold


def mean_ms(fn, iters: int) -> float:
    """Mean device ms of fn() over iters back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def sources(kernels: list[str], earlier: list[str]) -> dict:
    """(kernel, build name) -> the .cu text, this tree's builds first."""
    out = {}
    for kernel in kernels:
        src, _, consts = KERNELS[kernel]
        if src is None:
            out[(kernel, "this tree")] = MMA_PEAK_CU
            continue
        with open(os.path.join(_build.CSRC, src + ".cu")) as fh:
            text = fh.read()
        out[(kernel, "this tree")] = text
        for path in earlier:
            with open(os.path.join(path, "atsc_tpu_torch", "csrc", src + ".cu")) as fh:
                out[(kernel, os.path.basename(os.path.normpath(path)))] = fh.read()
        for const, value, variants in consts:
            pattern = rf"(constexpr int {const} = ){value};"
            if len(re.findall(pattern, text)) != 1:
                raise RuntimeError(f"{src}.cu does not define {const} = {value} once")
            for v in variants:
                out[(kernel, f"{const}={v}")] = re.sub(pattern, rf"\g<1>{v};", text)
    return out


def compile_cu(tag: str, text: str, include: str) -> tuple[str, list[str]]:
    """nvcc text (as <tag>.cu, headers from `include`) into a shared
    library; (path, ptxas lines)."""
    os.makedirs(AB_DIR, exist_ok=True)
    src, lib = os.path.join(AB_DIR, tag + ".cu"), os.path.join(AB_DIR, f"lib{tag}.so")
    with open(src, "w") as fh:
        fh.write(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", include, "-o", lib,
                           src], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    return lib, ptxas_usage(proc.stdout + proc.stderr)


def ptxas_usage(log: str) -> list[str]:
    """nvcc -Xptxas -v output -> one line per kernel: its name (with its
    template argument) and its registers, spills and shared memory."""
    out, name = [], None
    for ln in log.splitlines():
        fn = re.search(r"Compiling entry function '(\S+)'", ln)
        if fn:
            m = re.search(r"\d+((?:[a-z0-9]+_)+(?:kernel|peak))(I(?:L[a-z]\d+E|[a-z])+E)?",
                          fn.group(1))
            args = re.findall(r"L[a-z](\d+)E|([a-z])", m.group(2)[1:-1]) if m and m.group(2) else []
            name = (m.group(1) + (f"<{','.join(a or b for a, b in args)}>" if args else "")
                    if m else fn.group(1))
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            out.append(f"{name}: {ln.strip()}")
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


class _Missing:
    """An entry point an earlier tree's library lacks: declared like the
    others, raising if it is ever called."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, *args):
        raise RuntimeError(f"{self.name}: not in this build")


class _AnyTree(ctypes.CDLL):
    """A kernel library of this tree or of an earlier one: the entry points
    the package declares and an earlier build does not have (the chunked
    Viterbi kernels, before they were added) resolve to _Missing."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("__"):
                raise
            fn = _Missing(name)
            setattr(self, name, fn)
            return fn


def bound(module, path: str, device_index: int) -> ctypes.CDLL:
    """The library at path, set up as the module's wrapper sets up its own
    (entry points declared, the FIR's and both equalizer tiers' taps
    loaded on the device)."""
    if module is None:
        return ctypes.CDLL(path)
    real = _build.load
    module._kernel_lib.cache_clear()
    _build.load = lambda name: _AnyTree(path)
    try:
        lib = (module._kernel_lib() if module in (fvk, tfk)
               else module._kernel_lib(device_index))
        if module is eqk:
            eqk._tier.cache_clear()
            with torch.cuda.device(device_index):
                eqk._tier(device_index, 128, False)
                eqk._tier(device_index, 256, True)
        return lib
    finally:
        _build.load = real
        module._kernel_lib.cache_clear()
        if module is eqk:
            eqk._tier.cache_clear()


@contextlib.contextmanager
def routed(module, lib: ctypes.CDLL):
    """The module's wrapper launches lib's kernel inside the block (its
    taps were loaded by `bound`)."""
    real = module._kernel_lib
    module._kernel_lib = lambda *device_index: lib
    if module is eqk:
        real_tier = eqk._tier
        eqk._tier = lambda device_index, eq_k, exact: eqk.TIERS[(eq_k, exact)]
    try:
        yield
    finally:
        module._kernel_lib = real
        if module is eqk:
            eqk._tier = real_tier


def flushed_ms(fn, iters: int, dev) -> float:
    """Mean device ms of fn() over iters calls, each after L2_FLUSH_BYTES
    were written (the L2 then holds none of fn's inputs), only fn timed."""
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    fn()
    total = 0.0
    for _ in range(iters):
        scratch.fill_(1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def in_turns(names: list[str], run, iters: int) -> dict:
    """Each build's ms, timed twice: in order, then in reverse order."""
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(mean_ms(lambda: run(n), iters))
    return times


def fir_diff(got: torch.Tensor, want: torch.Tensor, fmt: str, wire: bool) -> float:
    """Largest difference over the valid [0, 260416): float (cf32) or LSB."""
    n = P.SYMBOLS_PER_FIELD
    if fmt == "cf32":
        return float((got[..., :n] - want[..., :n]).abs().max())
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if wire:
        g, w = unpack_wire(g, fmt), unpack_wire(w, fmt)
    return float(abs(g[..., :n].astype("int32") - w[..., :n].astype("int32")).max())


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def ab_offset_fir(libs, names, dev, gen, args) -> bool:
    b = args.batch
    field = torch.randint(0, 8, (b, P.PADDED_SYMBOLS), dtype=torch.int8, device=dev,
                          generator=gen)
    ang = torch.rand(b, device=dev, generator=gen) * 6.2831855
    phasor = torch.stack([torch.cos(ang), torch.sin(ang)], 1).contiguous()
    ok = True
    for fmt, wire in FIR_FORMATS:
        def run(n, fmt=fmt, wire=wire):
            with routed(fir, libs[n]):
                return fir.offset_fir_fused(field, phasor, out_format=fmt, wire=wire)

        outs = {n: run(n) for n in names}
        ms = in_turns(names, run, args.iters) if (fmt, wire) in FIR_TIMED else {}
        for n in names:
            err = fir_diff(outs[n], outs["this tree"], fmt, wire)
            ok &= err <= (TOL_CF32 if fmt == "cf32" else TOL_LSB)
            emit(kernel="offset_fir", build=n, format=fmt + ("_wire" if wire else ""),
                 batch=b, ms=ms.get(n), identical=bool(torch.equal(outs[n], outs["this tree"])),
                 max_abs_err=err)
        del outs
    return ok


def ab_trellis(kernel: str, libs, names, dev, gen, args) -> bool:
    """pr_acs_forward or acs_forward (float32 and int8 observations)."""
    lanes = args.batch * P.TRELLIS_ENCODERS
    obs = 4.0 * torch.randn((STEPS, lanes), device=dev, generator=gen)
    ok = True
    if kernel == "pr_acs":
        rc = torch.tensor(vk._pr_rc_table(), device=dev)
        m16 = torch.full((16, lanes), 1e9, device=dev)
        m16[0] = 0.0
        cases = {"float32": lambda: vk.pr_acs_forward(obs, rc, m16)}
    else:
        codes = quantize_soft_levels(obs)
        m4 = torch.full((4, lanes), 1e9, device=dev)
        m4[0] = 0.0
        cases = {"float32": lambda: vk.acs_forward(obs, m4),
                 "int8": lambda: vk.acs_forward(codes, m4, SOFT_LEVEL_INV)}
    for case, fn in cases.items():
        def run(n, fn=fn):
            with routed(vk, libs[n]):
                return fn()

        outs = {n: run(n) for n in names}
        times = in_turns(names, run, args.iters)
        want = outs["this tree"]
        for n in names:
            got = outs[n]
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            ok &= same
            emit(kernel="pr_acs_forward" if kernel == "pr_acs" else "acs_forward", build=n,
                 obs=case, batch=args.batch, steps=STEPS, lanes=lanes, ms=times[n],
                 identical=same, max_abs_err=float((got[1] - want[1]).abs().max()),
                 decisions_differing=int((got[0] != want[0]).sum()))
        del outs
    return ok


def tb_chunks(pr: bool, name: str = "this tree") -> int | None:
    """The chunks per lane, at most, of build `name`'s traceback (pr: the PR
    one): its constant's variant value, else this tree's; None for a build
    of another tree."""
    const = "kPrTbChunks" if pr else "kTbChunks"
    if name.startswith(const + "="):
        return int(name.split("=")[1])
    if name != "this tree" and "=" not in name:
        return None
    with open(os.path.join(_build.CSRC, "viterbi_acs.cu")) as fh:
        return int(re.search(rf"constexpr int {const} = (\d+);", fh.read()).group(1))


def tb_heads(dec: torch.Tensor, pr: bool, max_chunks: int | None = None):
    """The head of every chunk but the top one of the chunked traceback
    (csrc/viterbi_acs.cu, chunked_traceback) on decisions dec (T/4, L)
    (pr: (T, L)) cut into min(max_chunks, groups) chunks as the kernel cuts
    them (max_chunks: this tree's constant by default): the groups walked
    from the chunk's top before all its entry chains hold one state (the
    whole chunk if they never do). Plain torch on dec's device. Returns
    (heads (chunks - 1, L), chunk sizes (chunks - 1,)) in groups of 24
    steps."""
    n_s = 16 if pr else 4
    groups = dec.shape[0] // (vk.GROUP if pr else vk.GROUP // 4)
    chunks = min(max_chunks or tb_chunks(pr), groups)
    dev = dec.device
    tops = torch.tensor([(c + 1) * groups // chunks for c in range(chunks - 1)],
                        dtype=torch.int64, device=dev)
    sizes = tops - torch.tensor([c * groups // chunks for c in range(chunks - 1)],
                                dtype=torch.int64, device=dev)
    words = dec.to(torch.int64) & 0xFFFFFFFF
    s_pred = torch.from_numpy(_pr_tables()[1]).to(device=dev, dtype=torch.int64)
    states = torch.arange(n_s, device=dev).expand(chunks - 1, dec.shape[1], n_s).clone()
    heads = sizes[:, None].expand(-1, dec.shape[1]).clone()
    done = torch.zeros(heads.shape, dtype=torch.bool, device=dev)
    for g in range(int(sizes.max()) if chunks > 1 else 0):
        for i in range(vk.GROUP - 1, -1, -1):
            t = ((tops - 1 - g) * vk.GROUP + i).clamp(min=0)    # a step per chunk
            if pr:
                states = (s_pred[states] << 2) | ((words[t][..., None] >> (2 * states)) & 3)
            else:
                byte = (words[t // 4] >> (8 * (t % 4))[:, None]) & 0xFF
                x1 = (byte[..., None] >> (2 * states)) & 1
                states = ((states & 1) << 1) | ((states >> 1) ^ x1)
        now = (states == states[..., :1]).all(-1) & ~done & (g < sizes)[:, None]
        heads[now] = g + 1
        done |= now
        if bool((done | (g + 1 >= sizes)[:, None]).all()):
            break
    return heads, sizes


def head_stats(heads: torch.Tensor, sizes: torch.Tensor) -> dict:
    """Head lengths over all (chunk, lane): mean and largest in steps, the
    share of each length in groups (4 = 4 or more), and the share that
    took the whole chunk (never merged, or merged in its last group)."""
    h = heads.double()
    whole = heads == sizes[:, None]
    return {"chunks": heads.shape[0] + 1, "mean_steps": float(h.mean()) * vk.GROUP,
            "max_steps": int(heads.max()) * vk.GROUP,
            "share_groups": {str(k): float((heads.clamp(max=4) == k).double().mean())
                             for k in range(1, 5)},
            "share_whole_chunk": float(whole.double().mean())}


def unmerged_words(pr: bool, rows: int, lanes: int, gen, dev) -> torch.Tensor:
    """Random decision words (rows, L) int32 on which no two traceback
    chains ever merge: 4-state, in every byte the x1 bits (bits 2s) of
    states 0 and 2 are equal, and those of 1 and 3 (each state's
    predecessor is then distinct); PR, the four states u of each
    predecessor group p pick j_u ^ k_p, j_u = u's rank in the group and
    k_p two random bits: four distinct picks."""
    r = torch.randint(0, 1 << 32, (rows, lanes), dtype=torch.int64, device=dev, generator=gen)
    if not pr:
        return vk._to_int32((r & ~0x50505050) | ((r & 0x05050505) << 4))
    word = torch.zeros_like(r)
    rank = [0, 0, 0, 0]
    for u, p in enumerate(_pr_tables()[1].tolist()):
        word |= (rank[p] ^ ((r >> (2 * p)) & 3)) << (2 * u)
        rank[p] += 1
    return vk._to_int32(word)


def ab_tb(libs, names, dev, gen, args) -> bool:
    """traceback and pr_traceback on forward-pass decisions over random
    levels and on never-merging words."""
    lanes = args.batch * P.TRELLIS_ENCODERS
    obs = 4.0 * torch.randn((STEPS, lanes), device=dev, generator=gen)
    ok = True
    for pr in (False, True):
        n_s = 16 if pr else 4
        m = torch.full((n_s, lanes), 1e9, device=dev)
        m[0] = 0.0
        with routed(vk, libs["this tree"]):
            dec, m = (vk.pr_acs_forward(obs, torch.tensor(vk._pr_rc_table(), device=dev), m)
                      if pr else vk.acs_forward(obs, m))
        start = torch.argmin(m, dim=0).to(torch.int32)
        tb = vk.pr_traceback if pr else vk.traceback
        for case in ("forward", "unmerged"):
            if case == "unmerged":
                dec = unmerged_words(pr, dec.shape[0], lanes, gen, dev)
            heads = {}
            for n in names:
                chunks = tb_chunks(pr, n)
                if chunks and chunks not in heads:
                    heads[chunks] = head_stats(*tb_heads(dec, pr, chunks))

            def run(n, dec=dec):
                with routed(vk, libs[n]):
                    return tb(dec, start)

            outs = {n: run(n) for n in names}
            times = in_turns(names, run, args.iters)
            want = outs["this tree"]
            for n in names:
                same = bool(torch.equal(outs[n], want))
                ok &= same
                emit(kernel="pr_traceback" if pr else "traceback", build=n, decisions=case,
                     batch=args.batch, steps=STEPS, lanes=lanes, ms=times[n], identical=same,
                     words_differing=int((outs[n] != want).sum()),
                     heads=heads.get(tb_chunks(pr, n)))
            del outs
        del dec
    return ok


def shaped_by(kernel: str, name: str) -> bool:
    """Whether build `name` runs the cases of chunked kernel `kernel`: this
    tree and earlier trees always, a variant when its constant shapes the
    kernel."""
    return "=" not in name or name.split("=")[0] in CHUNKED_SASS[kernel + "_kernel"]


def ab_chunked(libs, names, dev, gen, args) -> bool:
    """acs_forward_chunked (float32 levels and their int8 codes) and
    traceback_chunked on that pass's decisions, then pr_acs_forward_chunked
    on the comb of the levels (one encoder step back) with the field's
    reset/sign table and pr_traceback_chunked on its decisions, at
    B=args.batch and B=1 for each of args.chunks; chunk 0 starts cold, the
    others flat."""
    ok = True
    rc = torch.tensor(vk._pr_rc_table(), device=dev)
    for b in (args.batch, 1):
        lanes = b * P.TRELLIS_ENCODERS
        ideal = torch.randint(0, 8, (STEPS + 1, lanes), device=dev, generator=gen).float() * 2 - 7
        lev = ideal + P.PILOT_OFFSET + 0.5 * torch.randn(ideal.shape, device=dev, generator=gen)
        obs = lev[1:].contiguous()
        comb = (lev[1:] - lev[:-1]).contiguous()
        codes = quantize_soft_levels(obs)
        del ideal, lev
        for c in args.chunks:
            m4 = torch.zeros((4, c * lanes), device=dev)
            m4[1:, :lanes] = 1e9
            m16 = torch.zeros((16, c * lanes), device=dev)
            m16[1:, :lanes] = 1e9
            with routed(vk, libs["this tree"]):
                dec, mo = vk.acs_forward_chunked(obs, m4, c)
                pdec, pmo = vk.pr_acs_forward_chunked(comb, rc, m16, c)
            start = torch.argmin(mo, dim=0).to(torch.int32)
            pstart = torch.argmin(pmo, dim=0).to(torch.int32)
            cases = {
                ("acs_forward_chunked", "float32"): lambda c=c, m4=m4: vk.acs_forward_chunked(
                    obs, m4, c),
                ("acs_forward_chunked", "int8"): lambda c=c, m4=m4: vk.acs_forward_chunked(
                    codes, m4, c, SOFT_LEVEL_INV),
                ("traceback_chunked", "forward"): lambda c=c, dec=dec, start=start:
                    vk.traceback_chunked(dec, start, STEPS, c),
                ("pr_acs_forward_chunked", "comb"): lambda c=c, m16=m16:
                    vk.pr_acs_forward_chunked(comb, rc, m16, c),
                ("pr_traceback_chunked", "forward"): lambda c=c, pdec=pdec, pstart=pstart:
                    vk.pr_traceback_chunked(pdec, pstart, STEPS, c),
            }
            for (kernel, case), fn in cases.items():
                run_names = [n for n in names if shaped_by(kernel, n)]

                def run(n, fn=fn):
                    with routed(vk, libs[n]):
                        return fn()

                outs = {n: run(n) for n in run_names}
                times = in_turns(run_names, run, args.iters)
                want = outs["this tree"]
                for n in run_names:
                    got = outs[n]
                    pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
                    same = all(torch.equal(g, w) for g, w in pairs)
                    ok &= same
                    emit(kernel=kernel, build=n, case=case, batch=b, chunks=c, steps=STEPS,
                         lanes=lanes, ms=times[n], identical=same)
                del outs
            del dec, mo, pdec, pmo
        del obs, codes, comb
    return ok


def loops(listing: str) -> dict:
    """cuobjdump -sass text -> {function: [(instructions of a loop, from a
    label to a branch back to it; its instructions on the main path), ...]},
    largest loop first. The main path of a loop that runs an FSEL: the
    longest path from its head to its back branch that runs none, where
    one exists (the chunked PR forward pass's no-reset path); of any other
    loop, the whole loop."""
    out, name, ins, labels, branches = {}, None, [], {}, []

    def close():
        if name is None:
            return
        found = []
        for i, t in branches:
            if t in labels and labels[t] <= i:
                found.append((i - labels[t] + 1, main_path(ins, labels, labels[t], i)))
        out[name] = sorted(found, reverse=True)

    for line in listing.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            close()
            name, ins, labels, branches = fn.group(1), [], {}, []
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None:
            labels["0x" + m.group(1).lstrip("0").lower()] = len(ins)
            br = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", m.group(2))
            if br:
                branches.append((len(ins), br.group(1).lower() if br.group(1).startswith("0x")
                                 else br.group(1)))
            ins.append(m.group(2))
    close()
    return out


def main_path(ins: list[str], labels: dict, head: int, back: int) -> int:
    """Instructions on the longest path from instruction `head` to the
    back branch at `back` that runs no FSEL (forward edges only:
    fall-through, unless the instruction is an unpredicated BRA or EXIT,
    and forward branches inside the loop), where the loop runs an FSEL and
    such a path exists; else all of the loop's instructions."""
    def target(i):
        br = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", ins[i])
        if not br:
            return None
        t = br.group(1).lower() if br.group(1).startswith("0x") else br.group(1)
        return labels.get(t)

    def fsel(i):
        return ins[i].lstrip("@!P0123456789T ").startswith("FSEL")

    best = [None] * (back + 2)    # longest FSEL-free path from i to the back branch
    if any(fsel(i) for i in range(head, back + 1)):
        for i in range(back, head - 1, -1):
            if fsel(i):
                continue
            if i == back:
                best[i] = 1
                continue
            nxt = []
            t = target(i)
            if t is not None and i < t <= back:
                nxt.append(t)
            op = ins[i].strip()
            if not ((op.startswith("BRA") or op.startswith("EXIT")) and not op.startswith("@")):
                nxt.append(i + 1)
            got = [best[j] for j in nxt if best[j] is not None]
            best[i] = 1 + max(got) if got else None
    return best[head] or back - head + 1


def loop_mix(listing: str, kernel: str, innermost: bool = False) -> list[dict]:
    """Per instantiation of `kernel` in a cuobjdump -sass listing: its
    largest loop (a label to a branch back to it, nested loops included;
    innermost: the largest that holds no other loop, counting only
    predicated back branches, so that the shuffles' divergence fallback,
    which branches back into the loop, is no loop) as instructions by
    opcode (HMMA, LDSM, LDS, FADD, ...)."""
    out = []
    for part in listing.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel not in name:
            continue
        ins, labels, spans = [], {}, []
        for line in part.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                labels[lab.group(1)] = len(ins)
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                labels["0x" + m.group(1).lstrip("0").lower()] = len(ins)
                br = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", m.group(2))
                if br:
                    t = br.group(1).lower() if br.group(1).startswith("0x") else br.group(1)
                    if t in labels and (not innermost or m.group(2).lstrip().startswith("@")):
                        spans.append((len(ins) - labels[t] + 1, labels[t], len(ins)))
                ins.append(m.group(2))
        if innermost:
            spans = [(n, a, b) for n, a, b in spans
                     if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b) for _, a2, b2 in spans)]
        if spans:
            size, a, b = max(spans)
            ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", s).split()[0].split(".")[0]
                                      for s in ins[a:b + 1])
            out.append({"function": name, "loop_instructions": size,
                        "opcodes": dict(ops.most_common())})
    return out


def _sass_kernel(function: str) -> str | None:
    """The chunked kernel a mangled function name instantiates."""
    return next((k for k in CHUNKED_SASS if k in function), None)


def sass(libs: dict, plan: dict) -> None:
    """The chunked kernels' loops per build (see the module note)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out_dir = os.path.join(AB_DIR, "sass")
    os.makedirs(out_dir, exist_ok=True)
    for name, lib in libs.items():
        listing = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                                 check=True).stdout
        text = plan[("chunked", name)]
        per_pass = {}   # steps a pass of the main loop: from its constant, else earlier forms'
        for kernel, const, steps, earlier in (
                ("acs_forward_chunked_kernel", "kAcsChunkWords", lambda v: 4 * v, 4),
                ("traceback_chunked_kernel", "kTbChunkWords", lambda v: 4 * v, 1),
                ("pr_acs_forward_chunked_kernel", "kPrGroupSteps", lambda v: v, 1),
                ("pr_traceback_chunked_kernel", "kPrTbAhead", lambda v: 4, 1)):   # a word a pass
            found = re.search(rf"constexpr int {const} = (\d+);", text)
            per_pass[kernel] = steps(int(found.group(1))) if found else earlier
        for fn, found in loops(listing).items():
            kernel = _sass_kernel(fn)
            if kernel and found:
                (size, main), others = found[0], found[1:]
                threads = re.search(r"kernelILi(\d)EE", fn)
                lane_threads = int(threads.group(1)) if threads else 1
                steps = per_pass[kernel] * lane_threads   # a PR forward group: kPrGroupSteps T
                emit(kernel=kernel, build=name, function=fn, loop_instructions=size,
                     main_path=main, steps_a_pass=steps, per_step=main / steps,
                     lane_threads=lane_threads, per_lane_step=lane_threads * main / steps,
                     other_loops=[f[0] for f in others])
        with open(os.path.join(out_dir, re.sub(r"\W", "_", name) + ".txt"), "w") as fh:
            fh.writelines("Function : " + part for part in listing.split("Function : ")[1:]
                          if _sass_kernel(part.split(None, 1)[0]))


def ab_eq_fir(libs, names, dev, gen, args, exact: bool = False) -> bool:
    """The fast tier (exact: the exact tier) on a random cf32 window and its
    cs16/cs8 codes. The fast tier's builds are held to this tree's build,
    the exact tier's each to the plain twin."""
    from atsc_tpu_torch.models.receiver import _osc_planar

    n_out = P.SYMBOLS_PER_FIELD
    b = args.batch
    eq_k = 256 if exact else 128
    tol = TOL_EQ_EXACT if exact else TOL_EQ_SOFT
    # the exact tier's 1e-5 holds for chip_smoke phase 7's random windows
    # (0.2 sigma); at 0.5 sigma the levels grow and the CUDA-core form
    # itself strays 1.5e-5 from the twin
    win = (0.2 if exact else 0.5) * torch.randn((b, 2, eqk.WIN_LEN), device=dev, generator=gen)
    osc = torch.tensor(_osc_planar(n_out - eq_k, n_out - eq_k + eqk.WIN_LEN, 0), device=dev)
    ok = True
    for fmt in ("cf32", "cs16", "cs8"):
        if fmt == "cf32":
            w, dq = win, 1.0
        else:
            q = float(QMAX[fmt])
            w = torch.clamp(torch.round(win * quantize_scale(fmt)), -q, q).to(
                torch.int16 if fmt == "cs16" else torch.int8)
            dq = 1.0 / quantize_scale(fmt)
        tier = dict(eq_k=eq_k, exact=exact, dequant=dq)
        soft_p = eqk.eq_fir_plain(w, osc, soft=True, **tier)
        for mode in ("hard", "soft", "codes"):
            kw = dict(soft=mode != "hard", soft_q=mode == "codes", **tier)

            def run(n, w=w, kw=kw):
                with routed(eqk, libs[n]):
                    return eqk.eq_fir_fused(w, osc, **kw)

            outs = {n: run(n) for n in names}
            times = in_turns(names, run, args.iters)
            ref = eqk.eq_fir_plain(w, osc, **kw) if exact else outs["this tree"]
            for n in names:
                got = outs[n]
                if mode == "soft":
                    err = float((got - ref).abs().max())
                    within = err <= tol
                else:
                    scale, bias = (0.5, 5.75) if mode == "hard" else (SOFT_LEVEL_SCALE, 0.0)
                    x = (soft_p + bias) * scale
                    near = (x - x.floor() - 0.5).abs() < tol * scale
                    diff = got != ref
                    err = float((got.int() - ref.int()).abs().max())
                    within = err <= 1 and not bool((diff & ~near).any())
                ok &= within
                emit(kernel="eq_fir_fused", build=n, tier="exact" if exact else "fast",
                     format=fmt, output=mode, batch=b, ms=times[n],
                     identical=bool(torch.equal(got, outs["this tree"])),
                     max_abs_err=err, against="plain" if exact else "this tree",
                     within_limits=within)
            del outs, ref
        del soft_p
    return ok


def ab_fir_variants(libs, names, dev, gen, args) -> bool:
    """The seven probe runs (tools/torch_fir_probe.py's RUNS) on random
    symbols, each build against run_variant_plain; offset_fir_fused timed
    once beside them."""
    b = args.batch
    n_out = P.SYMBOLS_PER_FIELD
    field = torch.randint(0, 8, (b, P.PADDED_SYMBOLS), dtype=torch.int8, device=dev,
                          generator=gen)
    ang = torch.rand(b, device=dev, generator=gen) * 6.2831855
    phasor = torch.stack([torch.cos(ang), torch.sin(ang)], 1).contiguous()
    ok = True
    for variant, nchunk in FIR_RUNS:
        want = fvk.run_variant_plain(field, phasor, variant, nchunk)[..., :n_out]

        def run(n, variant=variant, nchunk=nchunk):
            with routed(fvk, libs[n]):
                return fvk.run_variant(field, phasor, variant, nchunk)

        outs = {n: run(n)[..., :n_out] for n in names}
        times = in_turns(names, run, args.iters)
        for n in names:
            err = float((outs[n] - want).abs().max())
            ok &= err <= TOL_CF32
            emit(kernel="fir_variants", build=n, variant=variant, nchunk=nchunk, batch=b,
                 ms=times[n], identical=bool(torch.equal(outs[n], outs["this tree"])),
                 max_abs_err=err, against="plain", within_limits=err <= TOL_CF32)
        del outs, want
    emit(kernel="offset_fir_fused", build="package", batch=b,
         ms=[mean_ms(lambda: fir.offset_fir_fused(field, phasor), args.iters)
             for _ in range(2)])
    return ok


def ab_trellis_fused(libs, names, dev, gen, args) -> bool:
    """Both layouts on random bytes (pad bytes too) and carries, every build
    against trellis_fused_plain bit for bit: at B=args.batch timed in turns
    and with the L2 flushed before each launch, at B=1 and 23 (12 and 276
    rows, the persistent grid's ragged edges) compared only."""
    ok = True
    for b in (args.batch, 1, 23):
        il_pad = torch.randint(0, 256, (b, P.TRELLIS_ENCODERS, tfk.PAD_BYTES),
                               dtype=torch.uint8, device=dev, generator=gen)
        d, d1, d2 = (torch.randint(0, 2, (b, P.TRELLIS_ENCODERS), dtype=torch.int32,
                                   device=dev, generator=gen) for _ in range(3))
        for interleaved in (True, False):
            want = tfk.trellis_fused_plain(il_pad, d, d1, d2, interleaved=interleaved)

            def run(n, interleaved=interleaved):
                with routed(tfk, libs[n]):
                    return tfk.trellis_fused(il_pad, d, d1, d2, interleaved=interleaved)

            outs = {n: run(n) for n in names}
            timed = b == args.batch
            times = in_turns(names, run, args.iters) if timed else {}
            for n in names:
                same = bool(torch.equal(outs[n], want))
                ok &= same
                emit(kernel="trellis_fused", build=n, batch=b,
                     layout="interleaved" if interleaved else "planemajor", ms=times.get(n),
                     ms_l2_flushed=flushed_ms(lambda: run(n), args.iters, dev) if timed else None,
                     identical=same, against="plain")
            del outs, want
        if b == args.batch:   # PyTorch's own kernels on the same bytes, for scale
            out = torch.empty((b, P.TRELLIS_ENCODERS, tfk.PAD_SYMBOLS), dtype=torch.int8,
                              device=dev)
            lib = ctypes.CDLL(compile_cu("trellis_copy", COPY_CU, _build.CSRC)[0])
            lib.copy_rows_launch.restype = ctypes.c_int
            lib.copy_rows_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p]

            def copy():
                err = lib.copy_rows_launch(il_pad.data_ptr(), out.data_ptr(),
                                           b * P.TRELLIS_ENCODERS,
                                           torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"copy_rows launch failed: CUDA error {err}")

            for case, fn in (("fill_output", lambda: out.fill_(1)), ("copy_same_map", copy)):
                emit(kernel="trellis_fused", build="yardstick", case=case, batch=b,
                     ms=[mean_ms(fn, args.iters) for _ in range(2)],
                     ms_l2_flushed=flushed_ms(fn, args.iters, dev))
            del out
    return ok


COPY_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// trellis_fused's interleaved loads and streaming stores with no
// arithmetic: a warp a row, word 128 r + 32 s + lane in, its 16 bytes out
// (the word 4 times)
__global__ void copy_rows(const uint32_t* il, uint4* out, int rows) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint32_t* src = il + static_cast<size_t>(row) * 1376;
  uint4* dst = out + static_cast<size_t>(row) * 1376;
  for (int k = lane; k < 1376; k += 32) {
    const uint32_t w = __ldg(src + k);
    __stcs(dst + k, make_uint4(w, w, w, w));
  }
}
extern "C" int copy_rows_launch(const void* il, void* out, int rows, void* s) {
  copy_rows<<<(rows + 3) / 4, 128, 0, static_cast<cudaStream_t>(s)>>>(
      static_cast<const uint32_t*>(il), static_cast<uint4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
"""


MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// kChains independent accumulators a warp, kIters rounds of one product
// each: the products never wait on each other or on memory
constexpr int kChains = 8, kIters = 4096;
__global__ void tf32_peak(float* out) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3F800000u + threadIdx.x;
  b[0] = b[1] = 0x3F800000u;
  float d[kChains][4] = {};
  for (int it = 0; it < kIters; ++it)
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
                   "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(int blocks, int threads, float* out, void* stream) {
  tf32_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
"""


def ab_mma_peak(lib, dev, args) -> bool:
    """mma.sync.m16n8k8 tf32's rate on this card: 8 independent accumulators
    a warp, 4096 rounds, 4 / 8 / 16 warps on each SM (two blocks an SM);
    TFLOP/s and products per SM and clock at the highest SM clock
    (nvidia-smi)."""
    lib.mma_peak.restype = ctypes.c_int
    lib.mma_peak.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]) * 1e6
    ok = True
    for warps in (4, 8, 16):
        blocks, threads = 2 * sms, 32 * warps // 2
        out = torch.empty(blocks * threads, device=dev)

        def run():
            err = lib.mma_peak(blocks, threads, out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"mma_peak launch failed: CUDA error {err}")

        ms = mean_ms(run, args.iters)
        products = blocks * threads // 32 * 8 * 4096
        ok &= bool(torch.isfinite(out).all())
        emit(kernel="mma_peak", build="probe", shape="m16n8k8 tf32", warps_per_sm=warps,
             ms=ms, tflop_per_s=products * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12,
             per_sm_clock=products / sms / (ms * 1e-3 * clock))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS), choices=list(KERNELS))
    ap.add_argument("--earlier", nargs="*", default=[], metavar="DIR",
                    help="checkouts of other trees, whose atsc_tpu_torch/csrc kernels "
                    "run beside this tree's (named by the directory's last part)")
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunks", type=int, nargs="*", default=list(CHUNKS),
                    help="chunked: the chunk counts")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    for query in ("name,power.limit", "clocks.max.sm"):   # the clock: for issue floors
        print(subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    plan = sources(args.kernels, args.earlier)
    tags = {k: f"{k[0]}-{i}" for i, k in enumerate(plan)}
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(plan)) as pool:
        futs = {k: pool.submit(compile_cu, tags[k], text, _build.CSRC)
                for k, text in plan.items()}
        built = {k: f.result() for k, f in futs.items()}
    libs = {}
    for (kernel, name), (path, ptxas) in built.items():
        libs.setdefault(kernel, {})[name] = bound(KERNELS[kernel][1], path, dev.index)
        emit(kernel=kernel, build=name, library=os.path.relpath(path, ROOT), ptxas=ptxas)
        if kernel in LOOP_MIX:   # the tensor-core kernels' instruction mix
            tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
            listing = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                                     check=True).stdout
            for mix in loop_mix(listing, LOOP_MIX[kernel], innermost=kernel == "trellis_fused"):
                lane_bytes = re.search(r"constexpr int (?:kLaneBytes|kVec) = (\d+);",
                                       plan[(kernel, name)])
                if kernel == "trellis_fused" and lane_bytes:   # a lane's bytes an iteration
                    mix["per_input_byte"] = mix["loop_instructions"] / int(lane_bytes.group(1))
                emit(kernel=kernel, build=name, **mix)

    ok = True
    gen = torch.Generator(dev).manual_seed(5)
    for kernel in args.kernels:
        names = list(libs[kernel])
        if kernel == "offset_fir":
            ok &= ab_offset_fir(libs[kernel], names, dev, gen, args)
        elif kernel == "eq_fir":
            ok &= ab_eq_fir(libs[kernel], names, dev, gen, args)
        elif kernel == "eq_exact":
            ok &= ab_eq_fir(libs[kernel], names, dev, gen, args, exact=True)
        elif kernel == "fir_variants":
            ok &= ab_fir_variants(libs[kernel], names, dev, gen, args)
        elif kernel == "trellis_fused":
            ok &= ab_trellis_fused(libs[kernel], names, dev, gen, args)
        elif kernel == "mma_peak":
            ok &= ab_mma_peak(libs[kernel]["this tree"], dev, args)
        elif kernel == "tb":
            ok &= ab_tb(libs[kernel], names, dev, gen, args)
        elif kernel == "chunked":
            sass(libs[kernel], plan)
            ok &= ab_chunked(libs[kernel], names, dev, gen, args)
        else:
            ok &= ab_trellis(kernel, libs[kernel], names, dev, gen, args)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
