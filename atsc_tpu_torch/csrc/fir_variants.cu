// Level map + pilot offset + 112-tap RRC FIR (cf32) in the banded-matmul
// form, for Hopper (sm_90a): the design probe beside csrc/offset_fir.cu.
//
// Replaces the TPU kernel tools/fir_probe.py::run_variant (bodies
// atsc_tpu/ops/pallas/offset_fir.py::_kernel for "base", and
// _kernel_sharedmod, _kernel_onedot, _kernel_combo). The wrapper and plain
// PyTorch twin are ops/cuda/fir_variants.py. Same function as
// offset_fir_fused cf32: per channel b, with the field cut into 128-sample
// rows A[j] (2,041 of them) and 2,040 output rows,
//
//   lvl = 2 v - 7 + 1.25,  u = lvl * osc_re,  w = lvl * osc_im   (per sample)
//   FU[j] = U[j] @ W_lo + U[j+1] @ W_hi,  FW[j] = W[j] @ W_lo + W[j+1] @ W_hi
//   I = FU pr - FW pi,  Q = FU pi + FW pr                    ((pr, pi) = phasor[b])
//
// where W_lo[m, r] = c[m - r] and W_hi[m, r] = c[128 + m - r] are the banded
// 128 x 128 tap matrices (ops/rrc_filter.py). The products are executed
// dense, zeros included: 1,024 flop per output pair, against ~450 useful
// flop in offset_fir.cu's direct 111-tap form. Whether staging operands and
// weights in shared memory pays for that on this card is what the probe
// measures.
//
// Variants, as template flags:
// - SHARED_MOD = false: the a rows [j0, j0 + 32) and the one-row-shifted b
//   rows [j0 + 1, j0 + 33) are each read and modulated (64 rows a tile);
//   true: rows [j0, j0 + 33) are modulated once and b is the same tile read
//   one row down.
// - ONE_DOT = true: one accumulator over K = 256 of [u_a | u_b] against
//   [W_lo; W_hi]; false: two K = 128 accumulators, summed at the end.
// base = (false, false), sharedmod = (true, false), onedot = (false, true),
// combo = (true, true).
//
// Grid (nchunk, B), 256 threads: a block owns 2040 / nchunk output rows of
// one channel and walks them in tiles of 32 rows; it loads W_lo and W_hi
// (128 KB of float32) into dynamic shared memory once, so nchunk is how many
// blocks load the weights per channel. A tile: stage the modulated operand
// rows in shared memory (row-major), then each thread computes 4 rows x 4
// columns x 2 planes, stepping k by 4: per step 8 float4 operand loads (a
// warp shares its 4 rows, so each is a broadcast) and 4 float4 weight loads
// (a warp reads one 512-byte weight row, conflict-free) feed 128 FMAs.
// All float32 on the CUDA cores: the 5e-6 IQ bound rules out TF32 and bf16.
// FMA contraction is allowed (the tolerance is 2e-6, not bit identity).
//
// What bounds it on an H100: operations. At B = 384 the executed products
// are 1.03e11 flop (1.53 ms at the 67 TFLOP/s fp32 peak); the useful work is
// 44.4 GFLOP (0.663 ms), the bytes 0.9 GB (0.27 ms). One block per SM (the
// weights take 128 KB of shared memory), 8 warps, so the loop relies on its
// 32 independent accumulators to hide shared-memory latency. A tensor-core
// form (a 3 x TF32 split or wgmma) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kBlk = 128;                 // samples per row
constexpr int kInRows = 2041;             // rows of the padded field (261,248 samples)
constexpr int kOutRows = 2040;            // output rows (261,120 samples)
constexpr int kPaddedSymbols = kInRows * kBlk;
constexpr int kPaddedOut = kOutRows * kBlk;
constexpr int kTile = 32;                 // output rows per tile
constexpr int kThreads = 256;
constexpr float kLevelBias = 1.25f - 7.0f;

static_assert(kThreads == (kTile / 4) * 32, "8 warps of 4 rows each cover a tile");
static_assert(kBlk == 32 * 4, "a warp's 32 lanes cover a row, 4 columns each");

template <bool SHARED_MOD>
constexpr int operand_floats() {
  return SHARED_MOD ? 2 * (kTile + 1) * kBlk : 4 * kTile * kBlk;
}

template <bool SHARED_MOD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlk * kBlk + operand_floats<SHARED_MOD>());
}

// Modulate `count` field rows starting at `first` into dst (plane u) and
// dst + plane (plane w), row-major; rows at index >= limit are zeros (they
// feed only outputs past the block's end, which are never stored).
__device__ __forceinline__ void stage(float* dst, int plane, const int8_t* f, const float* osc,
                                      int first, int count, int limit) {
  for (int g = threadIdx.x; g < count * (kBlk / 4); g += kThreads) {
    const int r = g / (kBlk / 4);
    const int c = (g % (kBlk / 4)) * 4;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 w = u;
    if (r < limit) {
      const int n = (first + r) * kBlk + c;
      const char4 v = *reinterpret_cast<const char4*>(f + n);
      const float4 re = *reinterpret_cast<const float4*>(osc + n);
      const float4 im = *reinterpret_cast<const float4*>(osc + kPaddedSymbols + n);
      const float l0 = static_cast<float>(v.x) * 2.0f + kLevelBias;
      const float l1 = static_cast<float>(v.y) * 2.0f + kLevelBias;
      const float l2 = static_cast<float>(v.z) * 2.0f + kLevelBias;
      const float l3 = static_cast<float>(v.w) * 2.0f + kLevelBias;
      u = make_float4(l0 * re.x, l1 * re.y, l2 * re.z, l3 * re.w);
      w = make_float4(l0 * im.x, l1 * im.y, l2 * im.z, l3 * im.w);
    }
    *reinterpret_cast<float4*>(dst + r * kBlk + c) = u;
    *reinterpret_cast<float4*>(dst + plane + r * kBlk + c) = w;
  }
}

// acc[0] (plane u) and acc[1] (plane w) += op[rows ty*4 .. +4, 0:128) @
// wt[0:128, tx*4 .. +4), op's plane w at op + plane.
__device__ __forceinline__ void mac128(float (&acc)[2][4][4], const float* op, int plane,
                                       const float* wt, int ty, int tx) {
  const float* a = op + ty * 4 * kBlk;
  const float* wc = wt + tx * 4;
#pragma unroll 2
  for (int k = 0; k < kBlk; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wv[kk] = *reinterpret_cast<const float4*>(wc + (k + kk) * kBlk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float4 av = *reinterpret_cast<const float4*>(a + p * plane + i * kBlk + k);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[p][i][0] = fmaf(ak[kk], wv[kk].x, acc[p][i][0]);
          acc[p][i][1] = fmaf(ak[kk], wv[kk].y, acc[p][i][1]);
          acc[p][i][2] = fmaf(ak[kk], wv[kk].z, acc[p][i][2]);
          acc[p][i][3] = fmaf(ak[kk], wv[kk].w, acc[p][i][3]);
        }
      }
    }
  }
}

template <bool SHARED_MOD, bool ONE_DOT>
__global__ void __launch_bounds__(kThreads, 1)
fir_variant_kernel(const int8_t* __restrict__ field, const float* __restrict__ phasor,
                   const float* __restrict__ osc, const float* __restrict__ w2,
                   float* __restrict__ out, int rows_per_chunk) {
  extern __shared__ float4 smem4[];
  float* const sw = reinterpret_cast<float*>(smem4);  // [W_lo; W_hi], 256 x 128
  float* const sop = sw + 2 * kBlk * kBlk;            // operand rows, both planes
  const int b = blockIdx.y;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 2 * kBlk * kBlk / 4; i += kThreads)
    smem4[i] = reinterpret_cast<const float4*>(w2)[i];

  const int8_t* f = field + static_cast<size_t>(b) * kPaddedSymbols;
  float* o = out + static_cast<size_t>(b) * 2 * kPaddedOut;
  const float pr = phasor[2 * b];
  const float pi = phasor[2 * b + 1];
  const int row_end = (blockIdx.x + 1) * rows_per_chunk;

  for (int j0 = blockIdx.x * rows_per_chunk; j0 < row_end; j0 += kTile) {
    const int valid = min(kTile, row_end - j0);
    __syncthreads();  // the last tile's readers are done with sop
    // plane strides and the a / b operand bases of this variant
    int plane;
    const float* opa;
    const float* opb;
    if constexpr (SHARED_MOD) {
      plane = (kTile + 1) * kBlk;
      stage(sop, plane, f, osc, j0, kTile + 1, valid + 1);
      opa = sop;
      opb = sop + kBlk;
    } else {
      plane = kTile * kBlk;
      stage(sop, plane, f, osc, j0, kTile, valid);
      stage(sop + 2 * plane, plane, f, osc, j0 + 1, kTile, valid);
      opa = sop;
      opb = sop + 2 * plane;
    }
    __syncthreads();

    float fu[4][4], fw[4][4];
    if constexpr (ONE_DOT) {
      float acc[2][4][4] = {};
      mac128(acc, opa, plane, sw, ty, tx);
      mac128(acc, opb, plane, sw + kBlk * kBlk, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) fu[i][c] = acc[0][i][c], fw[i][c] = acc[1][i][c];
    } else {
      float lo[2][4][4] = {}, hi[2][4][4] = {};
      mac128(lo, opa, plane, sw, ty, tx);
      mac128(hi, opb, plane, sw + kBlk * kBlk, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          fu[i][c] = lo[0][i][c] + hi[0][i][c], fw[i][c] = lo[1][i][c] + hi[1][i][c];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= valid) break;
      const size_t n = static_cast<size_t>(j0 + r) * kBlk + tx * 4;
      *reinterpret_cast<float4*>(o + n) =
          make_float4(fu[i][0] * pr - fw[i][0] * pi, fu[i][1] * pr - fw[i][1] * pi,
                      fu[i][2] * pr - fw[i][2] * pi, fu[i][3] * pr - fw[i][3] * pi);
      *reinterpret_cast<float4*>(o + kPaddedOut + n) =
          make_float4(fu[i][0] * pi + fw[i][0] * pr, fu[i][1] * pi + fw[i][1] * pr,
                      fu[i][2] * pi + fw[i][2] * pr, fu[i][3] * pi + fw[i][3] * pr);
    }
  }
}

template <bool SHARED_MOD, bool ONE_DOT>
int launch(const int8_t* field, const float* phasor, const float* osc, const float* w2,
           float* out, int batch, int nchunk, cudaStream_t stream) {
  auto* kernel = fir_variant_kernel<SHARED_MOD, ONE_DOT>;
  constexpr size_t bytes = smem_bytes<SHARED_MOD>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nchunk, batch), kThreads, bytes, stream>>>(field, phasor, osc, w2, out,
                                                           kOutRows / nchunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// field: (batch, 261248) int8 symbol values; phasor: (batch, 2) float32;
// osc: (2, 261248) float32 oscillator planes; w2: (256, 128) float32, W_lo
// over W_hi; out: (batch, 2, 261120) float32; all contiguous on `device`,
// 16-byte aligned. shared_mod / one_dot pick the variant; nchunk divides
// 2040. Launches on `stream`, returns cudaGetLastError().
int atsc_fir_variant(int device, const int8_t* field, const float* phasor, const float* osc,
                     const float* w2, float* out, int batch, int nchunk, int shared_mod,
                     int one_dot, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch < 1 || batch > 65535 || nchunk < 1 || kOutRows % nchunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared_mod)
    return one_dot ? launch<true, true>(field, phasor, osc, w2, out, batch, nchunk, s)
                   : launch<true, false>(field, phasor, osc, w2, out, batch, nchunk, s);
  return one_dot ? launch<false, true>(field, phasor, osc, w2, out, batch, nchunk, s)
                 : launch<false, false>(field, phasor, osc, w2, out, batch, nchunk, s);
}

}  // extern "C"
