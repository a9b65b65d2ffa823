#!/usr/bin/env python3
"""Two hand kernels of the PyTorch port, offset_fir_fused
(csrc/offset_fir.cu, register-blocked) and pr_acs_forward
(csrc/viterbi_acs.cu, state-parallel), head to head with design variants
of their sources and, given checkouts of other trees, with those trees'
kernels, on one CUDA device at B=384.

  offset_fir  outputs per thread, kR = 8 (this tree) against 4 and 12:
              cf32, cs16 planar and cs8 wire timed, all five formats
              compared
  pr_acs      threads per block, kPrThreads = 32 (this tree) against 64,
              128 and 256, at 16 threads per lane, on random observations
              over all 21,528 steps of a field (segment-sync reset steps
              included)

A variant is a copy of this tree's source with that one constant changed;
each build is compiled here with the package's nvcc flags into
atsc_tpu_torch/_build/ab/. Every build runs on the same inputs through the
package's own wrapper (offset_fir_fused, pr_acs_forward), routed to that
build's library. Each is timed twice with CUDA events, the second pass in
the reverse order of the first. One JSON line per build and format:
{"kernel", "build", "format", "ms", "identical", "max_abs_err"}, compared
with this tree's build (decisions and final metrics for pr_acs); the
first line is nvidia-smi's name and power limit. Exit 1 if a build fails,
a pr_acs build differs from this tree's in any bit, or an offset_fir build
differs by more than 2e-6 (cf32) or 1 LSB (codes).

Usage: python tools/torch_kernel_ab.py [--earlier DIR ...] [--batch 384]
       [--iters 10]
(DIR: a checkout of another tree inside this one, for example a `git
archive` of the parent commit unpacked into the git-ignored .archive_check/)
"""

from __future__ import annotations

import argparse
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
from atsc_tpu_torch.ops.cuda import offset_fir as fir  # noqa: E402
from atsc_tpu_torch.ops.cuda import viterbi_acs as vk  # noqa: E402
from atsc_tpu_torch.ops.quantize import unpack_wire  # noqa: E402

AB_DIR = os.path.join(_build.BUILD_DIR, "ab")
# kernel -> (source, wrapper module, constant, this tree's value, variants)
KERNELS = {
    "offset_fir": ("offset_fir", fir, "kR", 8, (4, 12)),
    "pr_acs": ("viterbi_acs", vk, "kPrThreads", 32, (64, 128, 256)),
}
FIR_FORMATS = (("cf32", False), ("cs16", False), ("cs8", False), ("cs16", True),
               ("cs8", True))
FIR_TIMED = (("cf32", False), ("cs16", False), ("cs8", True))
TOL_CF32, TOL_LSB = 2e-6, 1


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


def sources(earlier: list[str]) -> dict:
    """(kernel, build name) -> the .cu text, this tree's builds first."""
    out = {}
    for kernel, (src, _, const, value, variants) in KERNELS.items():
        with open(os.path.join(_build.CSRC, src + ".cu")) as fh:
            text = fh.read()
        out[(kernel, "this tree")] = text
        for path in earlier:
            with open(os.path.join(path, "atsc_tpu_torch", "csrc", src + ".cu")) as fh:
                out[(kernel, os.path.basename(os.path.normpath(path)))] = fh.read()
        pattern = rf"(constexpr int {const} = ){value};"
        if len(re.findall(pattern, text)) != 1:
            raise RuntimeError(f"{src}.cu does not define {const} = {value} once")
        for v in variants:
            out[(kernel, f"{const}={v}")] = re.sub(pattern, rf"\g<1>{v};", text)
    return out


def compile_cu(tag: str, text: str) -> tuple[str, str]:
    """nvcc text (as <tag>.cu) into a shared library; (path, ptxas lines)."""
    os.makedirs(AB_DIR, exist_ok=True)
    src, lib = os.path.join(AB_DIR, tag + ".cu"), os.path.join(AB_DIR, f"lib{tag}.so")
    with open(src, "w") as fh:
        fh.write(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    return lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def bound(module, path: str, device_index: int) -> ctypes.CDLL:
    """The library at path, set up as the module's wrapper sets up its own
    (entry points declared, the FIR's taps loaded on the device)."""
    real = _build.load
    module._kernel_lib.cache_clear()
    _build.load = lambda name: ctypes.CDLL(path)
    try:
        return module._kernel_lib(device_index)
    finally:
        _build.load = real
        module._kernel_lib.cache_clear()


@contextlib.contextmanager
def routed(module, lib: ctypes.CDLL):
    """The module's wrapper launches lib's kernel inside the block."""
    real = module._kernel_lib
    module._kernel_lib = lambda device_index: lib
    try:
        yield
    finally:
        module._kernel_lib = real


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", nargs="*", default=[], metavar="DIR",
                    help="checkouts of other trees, whose atsc_tpu_torch/csrc kernels "
                    "run beside this tree's (named by the directory's last part)")
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    plan = sources(args.earlier)
    tags = {k: f"{k[0]}-{i}" for i, k in enumerate(plan)}
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(plan)) as pool:
        futs = {k: pool.submit(compile_cu, tags[k], text) for k, text in plan.items()}
        built = {k: f.result() for k, f in futs.items()}
    libs = {}
    for (kernel, name), (path, ptxas) in built.items():
        libs[(kernel, name)] = bound(KERNELS[kernel][1], path, dev.index)
        emit(kernel=kernel, build=name, library=os.path.relpath(path, ROOT), ptxas=ptxas)
    ok = True

    # -- offset_fir ------------------------------------------------------------
    gen = torch.Generator(dev).manual_seed(5)
    b = args.batch
    field = torch.randint(0, 8, (b, P.PADDED_SYMBOLS), dtype=torch.int8, device=dev,
                          generator=gen)
    ang = torch.rand(b, device=dev, generator=gen) * 6.2831855
    phasor = torch.stack([torch.cos(ang), torch.sin(ang)], 1).contiguous()
    names = [n for k, n in plan if k == "offset_fir"]

    def fir_run(n, fmt, wire):
        with routed(fir, libs[("offset_fir", n)]):
            return fir.offset_fir_fused(field, phasor, out_format=fmt, wire=wire)

    for fmt, wire in FIR_FORMATS:
        outs = {n: fir_run(n, fmt, wire) for n in names}
        ms = dict.fromkeys(names)
        if (fmt, wire) in FIR_TIMED:
            ms = {n: [] for n in names}
            for n in names + names[::-1]:
                ms[n].append(mean_ms(lambda: fir_run(n, fmt, wire), args.iters))
        for n in names:
            err = fir_diff(outs[n], outs["this tree"], fmt, wire)
            ok &= err <= (TOL_CF32 if fmt == "cf32" else TOL_LSB)
            emit(kernel="offset_fir", build=n, format=fmt + ("_wire" if wire else ""),
                 batch=b, ms=ms[n], identical=bool(torch.equal(outs[n], outs["this tree"])),
                 max_abs_err=err)
        del outs

    # -- pr_acs_forward ----------------------------------------------------------
    del field
    t, lanes = 21528, b * P.TRELLIS_ENCODERS
    obs = 4.0 * torch.randn((t, lanes), device=dev, generator=gen)
    rc = torch.tensor(vk._pr_rc_table(), device=dev)
    m16 = torch.full((16, lanes), 1e9, device=dev)
    m16[0] = 0.0
    names = [n for k, n in plan if k == "pr_acs"]

    def pr_run(n):
        with routed(vk, libs[("pr_acs", n)]):
            return vk.pr_acs_forward(obs, rc, m16)

    outs = {n: pr_run(n) for n in names}
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(mean_ms(lambda: pr_run(n), args.iters))
    want = outs["this tree"]
    for n in names:
        got = outs[n]
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = float((got[1] - want[1]).abs().max())
        ok &= same
        emit(kernel="pr_acs_forward", build=n, batch=b, steps=t, lanes=lanes, ms=times[n],
             identical=same, max_abs_err=err,
             decisions_differing=int((got[0] != want[0]).sum()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
