"""Builds the package's CUDA sources (atsc_tpu_torch/csrc) with nvcc into
shared libraries with a plain C interface, loaded with ctypes.

A library is built at first use into atsc_tpu_torch/_build/, named by a
hash of its sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import: this module imports
on machines with no nvcc and no GPU, and only `build`/`load` need them.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)


class Build(NamedTuple):
    path: str        # the shared library
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc's output (ptxas resource usage); "" when reused


def find_nvcc() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc (CUDA_HOME defaulting to
    /usr/local/cuda, the toolkit's standard place). Raises if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or at $CUDA_HOME/bin/nvcc: the CUDA kernels "
        "of atsc_tpu_torch are built from source at first use and need the "
        "CUDA toolkit"
    )


@functools.lru_cache(maxsize=None)
def build(name: str) -> Build:
    """Build csrc/<name>.cu (with any csrc/*.cuh it includes) once."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return Build(lib, 0.0, "")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {src}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(lib, time.perf_counter() - t0, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, loaded once per process."""
    return ctypes.CDLL(build(name).path)
