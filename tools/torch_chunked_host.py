#!/usr/bin/env python3
"""The chunked Viterbi kernels of csrc/viterbi_acs.cu (the section from
ChunkPlan to the end of its namespace, with the helpers it uses), compiled
for the CPU with g++ and held bit for bit against their plain PyTorch twins,
before any card runs them.

A stub header stands in for CUDA: every CUDA thread of a launch is a
std::thread, a block at a time; warp shuffles and votes exchange through a
per-warp slot array between two std::barrier waits; the __f*_rn intrinsics
are single float32 operations (-ffp-contract=off), the funnel shifts and
__byte_perm are written out, and a cp.async copy is a plain copy (its
commit and wait do nothing). So it checks the index maps, the thread split
and the data each thread reads and writes, not timing or memory ordering.

Cases: T=600 steps in C = 2, 8, 12, 24 windows (every W mod 4 and start(c)
mod 4, reset steps in every window) at 1, 12 and 13 lanes: both 4-state
passes (float32 and int8), the PR forward pass at 1, 2 and 4 threads a
chunk-lane and as the launch chooses, and both tracebacks on the forward
passes' decisions, random words and (PR) words on which no two chains ever
merge. With --field, also a field of T=21,528 steps at C = 2, 8, 24, 92, one
lane per thread split and 12 lanes as the launch chooses (minutes).

Usage: python tools/torch_chunked_host.py [--tree DIR] [--field]
Prints one line per case; exit 1 if any differs. Builds into
atsc_tpu_torch/_build/host/.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from atsc_tpu_torch.ops.cuda import _build  # noqa: E402
from atsc_tpu_torch.ops.cuda import viterbi_acs as vk  # noqa: E402
from atsc_tpu_torch.ops.quantize import SOFT_LEVEL_INV, quantize_soft_levels  # noqa: E402
from atsc_tpu_torch.ops.viterbi import _chunk_plan  # noqa: E402

STUB = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static
struct Dim3 { unsigned x = 0; };
thread_local Dim3 threadIdx, blockIdx;
using std::max;
using std::min;
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return static_cast<uint32_t>((((uint64_t(hi) << 32) | lo) << (s & 31)) >> 32);
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return static_cast<uint32_t>(((uint64_t(hi) << 32) | lo) >> (s & 31));
}
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
struct Warp { std::barrier<> bar{32}; uint64_t slot[32]; };
thread_local Warp* tl_warp;
template <class V> static inline V xchg(V v, int src) {
  uint64_t b = 0; std::memcpy(&b, &v, sizeof(V));
  tl_warp->slot[threadIdx.x % 32] = b;
  tl_warp->bar.arrive_and_wait();
  const uint64_t o = tl_warp->slot[src];
  tl_warp->bar.arrive_and_wait();
  V r; std::memcpy(&r, &o, sizeof(V)); return r;
}
template <class V> static inline V __shfl_xor_sync(unsigned, V v, int m, int = 32) {
  return xchg(v, (threadIdx.x % 32) ^ m);
}
template <class V> static inline V __shfl_sync(unsigned, V v, int src, int w = 32) {
  return xchg(v, ((threadIdx.x % 32) & ~(w - 1)) | (src & (w - 1)));
}
static inline int __any_sync(unsigned, int p) {
  tl_warp->slot[threadIdx.x % 32] = p != 0;
  tl_warp->bar.arrive_and_wait();
  int any = 0;
  for (int i = 0; i < 32; ++i) any |= int(tl_warp->slot[i]);
  tl_warp->bar.arrive_and_wait();
  return any;
}
static void launch(int grid, int threads, const std::function<void()>& body) {
  for (int b = 0; b < grid; ++b) {
    std::vector<std::unique_ptr<Warp>> warps;
    for (int w = 0; w < (threads + 31) / 32; ++w) warps.emplace_back(new Warp);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = b; threadIdx.x = t; tl_warp = warps[t / 32].get();
        body();
      });
    for (auto& t : ts) t.join();
  }
}
inline void cp_async4(uint32_t* dst, const int32_t* src) { *dst = uint32_t(*src); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
"""

ENTRY = r"""
extern "C" {
int host_acs4(const void* obs, int i8, const float* m_in, int32_t* dec, float* m_out, int steps,
              int lanes, int chunks, float inv) {
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  launch(chunk_grid(plan, kChunk4Threads), kChunk4Threads, [&] {
    if (i8) acs_forward_chunked_kernel<int8_t>((const int8_t*)obs, m_in, dec, m_out, plan, inv);
    else acs_forward_chunked_kernel<float>((const float*)obs, m_in, dec, m_out, plan, inv);
  });
  return 0;
}
int host_tb4(const int32_t* dec, const int32_t* start, int32_t* bits, int steps, int lanes,
             int chunks) {
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  launch(chunk_grid(plan, kChunk4Threads), kChunk4Threads,
         [&] { traceback_chunked_kernel(dec, start, bits, plan); });
  return 0;
}
int host_pr_fwd(int t, const float* obs, const int32_t* rc, const float* m_in, int32_t* dec,
                float* m_out, int steps, int lanes, int chunks) {
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  if (t == 0) t = pr_lane_threads(plan.chunk_lanes());
  const int blocks = int((plan.chunk_lanes() * t + kChunkThreads - 1) / kChunkThreads);
  launch(blocks, kChunkThreads, [&] {
    if (t == 4) pr_acs_forward_chunked_kernel<4>(obs, rc, m_in, dec, m_out, plan);
    else if (t == 2) pr_acs_forward_chunked_kernel<2>(obs, rc, m_in, dec, m_out, plan);
    else pr_acs_forward_chunked_kernel<1>(obs, rc, m_in, dec, m_out, plan);
  });
  return t;
}
int host_pr_tb(const int32_t* dec, const int32_t* start, int32_t* bits, int steps, int lanes,
               int chunks) {
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  launch(chunk_grid(plan, kChunkThreads), kChunkThreads,
         [&] { pr_traceback_chunked_kernel(dec, start, bits, plan); });
  return 0;
}
}
"""


def cut(src: str, first: str, end: str) -> str:
    return src[src.index(first):src.index(end)]


def build(tree: str) -> ctypes.CDLL:
    """The chunked section of tree's viterbi_acs.cu under the stub, as a
    shared library in atsc_tpu_torch/_build/host/."""
    with open(os.path.join(tree, "atsc_tpu_torch", "csrc", "viterbi_acs.cu")) as fh:
        src = fh.read()
    chunked = cut(src, "// The chunk-parallel near-MLSE", "}  // namespace")
    start = chunked.find("// A 4-byte copy from global to shared memory")
    if start >= 0:   # the stub's cp.async stands in for the asm helpers
        chunked = chunked[:start] + chunked[chunked.index("// One PR traceback step"):]
    text = (STUB + "namespace {\n" + cut(src, "constexpr int kGroup", "// The 4-state add-compare")
            + cut(src, "__host__ __device__ constexpr int pred0", "// Transposes a 16 x 16")
            + chunked + "}\n" + ENTRY)
    out_dir = os.path.join(_build.BUILD_DIR, "host")
    os.makedirs(out_dir, exist_ok=True)
    cpp = os.path.join(out_dir, "chunked_host.cpp")
    lib = os.path.join(out_dir, "libchunked_host.so")
    with open(cpp, "w") as fh:
        fh.write(text)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-o", lib, cpp], check=True)
    return ctypes.CDLL(lib)


def ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def unmerged(rows: int, n: int, seed: int) -> np.ndarray:
    """PR decision words on which no two traceback chains ever merge
    (tools/torch_kernel_ab.py's)."""
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ab", os.path.join(ROOT, "tools", "torch_kernel_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab.unmerged_words(True, rows, n, torch.Generator().manual_seed(seed),
                             torch.device("cpu")).numpy()


def levels(steps: int, lanes: int, seed: int) -> np.ndarray:
    """Noisy 8-level symbols (σ 0.5), one more step than asked (for the comb)."""
    rng = np.random.default_rng(seed)
    lev = 2.0 * rng.integers(0, 8, (steps + 1, lanes)) - 7.0
    return lev + 0.5 * rng.standard_normal(lev.shape)


def case_4state(lib, steps: int, lanes: int, c: int, seed: int) -> list[str]:
    lev = levels(steps, lanes, seed)[1:] + 1.25
    _, w, _, _ = _chunk_plan(steps, c, vk.WARMUP)
    words, n = -(-w // 4), c * lanes
    m = np.zeros((4, n), np.float32)
    m[1:, :lanes] = 1e9
    bad = []
    obs = torch.tensor(lev.astype(np.float32))
    for name, x, inv in (("f32", obs, None), ("int8", quantize_soft_levels(obs), SOFT_LEVEL_INV)):
        xn = np.ascontiguousarray(x.numpy())
        dec, mo = np.zeros((words, n), np.int32), np.zeros_like(m)
        lib.host_acs4(ptr(xn), int(inv is not None), ptr(m), ptr(dec), ptr(mo), steps, lanes, c,
                      ctypes.c_float(inv or 1.0))
        wd, wm = vk.acs_forward_chunked_plain(x, torch.tensor(m), c, inv)
        if not (np.array_equal(dec, wd.numpy()) and np.array_equal(mo, wm.numpy())):
            bad.append(f"acs_forward {name}")
        if name == "f32":
            start = torch.argmin(wm, dim=0).to(torch.int32).numpy()
            bits = np.zeros((steps // 4, lanes), np.int32)
            lib.host_tb4(ptr(dec), ptr(start), ptr(bits), steps, lanes, c)
            want = vk.traceback_chunked_plain(wd, torch.tensor(start), steps, c).numpy()
            if not np.array_equal(bits, want):
                bad.append("traceback")
    return bad


def case_pr(lib, steps: int, lanes: int, c: int, threads: tuple, kinds: tuple,
            seed: int) -> list[str]:
    lev = levels(steps, lanes, seed)
    obs = np.ascontiguousarray((lev[1:] - lev[:-1]).astype(np.float32))
    rc = np.ascontiguousarray(vk._pr_rc_table()[:steps])
    _, w, starts, _ = _chunk_plan(steps, c, vk.WARMUP)
    assert all(((rc[s:s + w] & 1) == 1).any(0).all() for s in starts)   # resets in every window
    n = c * lanes
    m = np.zeros((16, n), np.float32)
    m[1:, :lanes] = 1e9
    wd, wm = vk.pr_acs_forward_chunked_plain(torch.tensor(obs), torch.tensor(rc),
                                             torch.tensor(m), c)
    bad = []
    for t in threads:
        dec, mo = np.zeros((w, n), np.int32), np.zeros_like(m)
        got_t = lib.host_pr_fwd(t, ptr(obs), ptr(rc), ptr(m), ptr(dec), ptr(mo), steps, lanes, c)
        if not (np.array_equal(dec, wd.numpy())
                and np.array_equal(mo.view(np.int32), wm.numpy().view(np.int32))):
            bad.append(f"pr_acs_forward T={got_t}")
    rng = np.random.default_rng(seed + 1)
    for kind in kinds:
        if kind == "forward":
            dec, start = wd.numpy(), torch.argmin(wm, dim=0).to(torch.int32).numpy()
        elif kind == "random":
            dec = rng.integers(-2 ** 31, 2 ** 31, (w, n)).astype(np.int32)
            start = rng.integers(0, 16, n).astype(np.int32)
        else:
            dec, start = unmerged(w, n, seed), rng.integers(0, 16, n).astype(np.int32)
        dec = np.ascontiguousarray(dec)
        bits = np.zeros((steps // 4, lanes), np.int32)
        lib.host_pr_tb(ptr(dec), ptr(start), ptr(bits), steps, lanes, c)
        want = vk.pr_traceback_chunked_plain(torch.tensor(dec), torch.tensor(start), steps, c)
        if not np.array_equal(bits, want.numpy()):
            bad.append(f"pr_traceback {kind}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="the checkout whose csrc is built")
    ap.add_argument("--field", action="store_true", help="also T=21,528 (minutes)")
    args = ap.parse_args(argv)
    lib = build(args.tree)
    cases = [(600, lanes, c, (1, 2, 4, 0), ("forward", "random", "unmerged"))
             for c in (2, 8, 12, 24) for lanes in (1, 12, 13)]
    if args.field:
        cases += [(21528, lanes, c, threads, ("forward",)) for c in (2, 8, 24, 92)
                  for lanes, threads in ((1, (1, 2, 4)), (12, (0,)))]
    ok = True
    for steps, lanes, c, threads, kinds in cases:
        seed = steps + 100 * c + lanes
        bad = case_pr(lib, steps, lanes, c, threads, kinds, seed)
        if steps == 600:
            bad += case_4state(lib, steps, lanes, c, seed)
        ok &= not bad
        print(f"T={steps} C={c} L={lanes}: " + ("identical" if not bad else
                                                 "DIFFERS: " + ", ".join(bad)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
