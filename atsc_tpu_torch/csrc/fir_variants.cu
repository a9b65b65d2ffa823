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
// 128 x 128 tap matrices (ops/rrc_filter.py): [W_lo; W_hi] = W2, W2[m, r] =
// c[m - r], is Toeplitz, and its 8 x 8 block (k-step q, n-tile nt) is the
// tap block D_{q - nt}[k][n] = c[8 (q - nt) + k - n], nonzero only for q -
// nt in [0, 14]: 15 of the 32 k-steps of each n-tile (120 multiply-adds per
// output for 111 useful taps). Whether the banded form beats offset_fir.cu's
// direct 111-tap form on this card is what the probe measures.
//
// The products run on the tensor cores as 3 x TF32, mma.sync.m16n8k8 (tf32
// -> f32): each operand x is split into tf32 words hi = tf32(x) and lo =
// tf32(x - hi) (the taps as a block stages them from W2, the modulated
// samples as it stages each tile), each product taken as lo*hi + hi*lo (one
// accumulator) + hi*hi (another). TF32 alone (10 fraction bits) would miss
// the 2e-6 bound by far; hi + lo holds x to within 2^-22 of it, so each
// product is within ~2^-21 of x*y and a 112-term sum of products of |x| <=
// 7.5 and taps of |c| summing to 0.19 stays well inside 2e-6 of the float32
// sums (a CPU model that rounds every k-step and every accumulation toward
// zero: 6.3e-7 against run_variant_plain, tests/test_torch_kernel_design.py),
// about the error of an fp32 SGEMM. The B fragments come from the taps'
// hi and lo planes in shared memory (1.4 KB): an n-tile's k-steps walk the
// tap blocks in order, so a window of 4 blocks (16 registers) slides one
// block a step, 4 four-byte loads a lane for the 24 products of a k-step.
// Holding all 15 blocks (60 registers) took 194-213 registers a thread and
// one block an SM; the shared-modulation variants then ran 24-29 % longer
// (tools/torch_kernel_ab.py).
//
// Variants, as template flags:
// - SHARED_MOD = false: the a rows [j0, j0 + kTile) and the one-row-shifted
//   b rows [j0 + 1, j0 + kTile + 1) are each modulated (2 kTile rows a
//   tile); true: rows [j0, j0 + kTile + 1) are modulated once and b is the
//   same rows read one down.
// - ONE_DOT = true: one accumulator pair over K = 256 of [u_a | u_b]
//   against [W_lo; W_hi]; false: the W_lo product (k-steps 0-15) and the
//   W_hi product (16-31) in their own accumulators, summed at the end.
// base = (false, false), sharedmod = (true, false), onedot = (false, true),
// combo = (true, true).
//
// Grid (nchunk, B), 4 warps: a block owns 2040 / nchunk output rows of one
// channel and walks them in tiles of 16 rows. A tile: its symbol and
// oscillator rows arrive by cp.async while the previous tile's products
// run; they are modulated and split into operand rows of 128 samples (u hi,
// u lo, w hi, w lo; 2,064 bytes apart, so the 8 rows of an ldmatrix phase
// hit distinct banks), then warp cg computes the tile's rows x n-tiles
// 4 cg .. 4 cg + 3 of both planes over its 18 k-steps, reading each A
// fragment by ldmatrix.x4 once for the up to 4 n-tiles it feeds, and
// rotates by the phasor. nchunk is how many blocks share a channel's rows.
// A block takes 56 KB of shared memory with shared modulation (3 blocks an
// SM, at <= 170 registers a thread: kRegsFloor), 87 KB with separate
// modulation (2), so one block's modulation, barriers and stores overlap
// the others' products. Tiles of 32 rows (8 warps, 107 / 169 KB, 2 / 1
// blocks an SM) ran 3-18 % slower (tools/torch_kernel_ab.py).
//
// What bounds it on an H100: at B = 384 the useful work is 44.4 GFLOP,
// 0.663 ms at the 67 TFLOP/s fp32 peak on the CUDA cores, or, as 3 tf32
// products each, 1.33e11 FLOP and 0.269 ms at the dense tf32 rate of 494.7
// TFLOP/s; the bytes are 0.9 GB (0.80 GB of IQ written), 0.269 ms at 3.35
// TB/s: tensor operations and bytes even. This form executes 120
// multiply-adds a plane per output for the 111 (8 % more; the dense banded
// product would be 256).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBlk = 128;                 // samples per row
constexpr int kInRows = 2041;             // rows of the padded field (261,248 samples)
constexpr int kOutRows = 2040;            // output rows (261,120 samples)
constexpr int kPaddedSymbols = kInRows * kBlk;
constexpr int kPaddedOut = kOutRows * kBlk;
constexpr int kTaps = 112;                // RRC taps, the last 0 (P.RRC_TAPS)
constexpr int kSteps = 2 * kBlk / 8;      // k-steps of 8 over K = 256
constexpr int kNTiles = kBlk / 8;         // 8-column n-tiles of an output row
constexpr int kBlocks = (kTaps - 1 + 7) / 8 + 1;  // nonzero 8 x 8 tap blocks D_0 .. D_14
constexpr int kTile = 16;                 // output rows per tile: 16-row mma tiles
constexpr int kGroupTiles = 4;            // n-tiles per warp
constexpr int kRowWarps = kNTiles / kGroupTiles;  // warps per 16-row tile
constexpr int kWarps = kTile / 16 * kRowWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kRegsFloor = 168;           // registers a thread that set the blocks an SM
constexpr int kRowBytes = 4 * (4 * kBlk + 4);  // u hi, u lo, w hi, w lo + 16 bytes
constexpr int kFieldBytes = (kTile + 1) * kBlk;        // a tile's symbol rows
constexpr int kOscBytes = (kTile + 1) * kBlk * 4;      // a tile's oscillator rows, per plane
constexpr int kRawBytes = kFieldBytes + 2 * kOscBytes;
// the k-steps a warp walks, relative to its first n-tile c0: [0, kWalk),
// the union of its n-tiles' nonzero steps
constexpr int kWalk = kGroupTiles + kBlocks - 1;
constexpr int kTapOff = 32;               // c[i] at [kTapOff + i] of a tap plane, zeros around
constexpr int kTapLen = kTapOff + 8 * kWalk;  // covers every block a lane loads
constexpr int kTapBytes = 2 * 4 * kTapLen;    // hi, lo
constexpr float kLevelBias = 1.25f - 7.0f;

static_assert(kTile % 16 == 0 && kNTiles % kGroupTiles == 0,
              "the warps cover the tile's 16-row tiles x the n-tiles of a row");
static_assert(kRowBytes % 128 == 16, "the 8 rows of an ldmatrix phase hit distinct banks");
static_assert((kRawBytes + kTapBytes) % 128 == 0,
              "the operand rows start on a 128-byte boundary");
static_assert(8 * (1 - kGroupTiles) - 7 + kTapOff >= 0 && 8 * (kWalk - 1) + 7 + kTapOff < kTapLen,
              "every tap block a lane loads lies in the tap planes");
static_assert(kNTiles - kGroupTiles + kWalk <= kSteps, "every warp's steps lie in K = 256");

template <bool SHARED_MOD>
constexpr int operand_rows() {
  return SHARED_MOD ? kTile + 1 : 2 * kTile;
}

template <bool SHARED_MOD>
constexpr size_t smem_bytes() {
  return kRawBytes + kTapBytes + static_cast<size_t>(operand_rows<SHARED_MOD>()) * kRowBytes;
}

// blocks an SM: as many as shared memory holds (an SM's 228 KB, 1 KB of it
// reserved a block), at no fewer than kRegsFloor registers a thread
template <bool SHARED_MOD>
constexpr int blocks_per_sm() {
  const int by_smem = static_cast<int>(233472 / (smem_bytes<SHARED_MOD>() + 1024));
  const int by_regs = 65536 / (kThreads * kRegsFloor);
  return by_smem < by_regs ? (by_smem > 0 ? by_smem : 1) : by_regs;
}

// Copies field rows [first, first + count) (symbols, 4 bytes a copy) and
// their oscillator rows (16 bytes a copy) into raw by cp.async.
__device__ __forceinline__ void copy_raw(unsigned char* raw, const int8_t* f, const float* osc,
                                         int first, int count) {
  const int fp = count * kBlk / 4;       // symbol copies
  const int op = count * kBlk / 4;       // oscillator copies per plane
  for (int i = threadIdx.x; i < fp + 2 * op; i += kThreads) {
    if (i < fp) {
      cp_async<4>(raw + 4 * i, f + first * kBlk + 4 * i);
    } else {
      const int plane = i - fp >= op, k = i - fp - plane * op;
      cp_async<16>(raw + kFieldBytes + plane * kOscBytes + 16 * k,
                   osc + plane * kPaddedSymbols + first * kBlk + 4 * k);
    }
  }
}

// Modulates raw rows [src, src + count) into operand rows [0, count) of dst
// as tf32 hi and lo words of u = lvl * osc_re and w = lvl * osc_im; rows at
// index >= limit are zeros (they feed only outputs past the tile's end,
// which are never stored).
__device__ __forceinline__ void modulate(unsigned char* dst, const unsigned char* raw, int src,
                                         int count, int limit) {
  for (int i = threadIdx.x; i < count * (kBlk / 4); i += kThreads) {
    const int r = i / (kBlk / 4);
    const int c = (i % (kBlk / 4)) * 4;
    uint4 uh = make_uint4(0u, 0u, 0u, 0u), ul = uh, wh = uh, wl = uh;
    if (r < limit) {
      const int n = (src + r) * kBlk + c;
      const char4 v = *reinterpret_cast<const char4*>(raw + n);
      const float4 re = *reinterpret_cast<const float4*>(raw + kFieldBytes + 4 * n);
      const float4 im = *reinterpret_cast<const float4*>(raw + kFieldBytes + kOscBytes + 4 * n);
      const float lv[4] = {static_cast<float>(v.x) * 2.0f + kLevelBias,
                           static_cast<float>(v.y) * 2.0f + kLevelBias,
                           static_cast<float>(v.z) * 2.0f + kLevelBias,
                           static_cast<float>(v.w) * 2.0f + kLevelBias};
      const float cr[4] = {re.x, re.y, re.z, re.w};
      const float ci[4] = {im.x, im.y, im.z, im.w};
      uint32_t* puh = &uh.x;
      uint32_t* pul = &ul.x;
      uint32_t* pwh = &wh.x;
      uint32_t* pwl = &wl.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        split_tf32(lv[k] * cr[k], puh[k], pul[k]);
        split_tf32(lv[k] * ci[k], pwh[k], pwl[k]);
      }
    }
    uint4* row = reinterpret_cast<uint4*>(dst + r * kRowBytes + 4 * c);
    row[0] = uh;
    row[kBlk / 4] = ul;
    row[2 * kBlk / 4] = wh;
    row[3 * kBlk / 4] = wl;
  }
}

template <bool SHARED_MOD, bool ONE_DOT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<SHARED_MOD>())
fir_variant_kernel(const int8_t* __restrict__ field, const float* __restrict__ phasor,
                   const float* __restrict__ osc, const float* __restrict__ w2,
                   float* __restrict__ out, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const raw = smem;               // symbols, osc re, osc im of a tile's rows
  float* const s_taps = reinterpret_cast<float*>(smem + kRawBytes);  // [hi, lo][kTapLen]
  unsigned char* const ops = smem + kRawBytes + kTapBytes;           // operand rows
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;        // the mma layouts: group g, thread t4 in it
  const int rt = warp / kRowWarps;               // the warp's 16-row tile
  const int c0 = (warp % kRowWarps) * kGroupTiles;     // its first n-tile

  const int8_t* f = field + static_cast<size_t>(b) * kPaddedSymbols;
  float* o = out + static_cast<size_t>(b) * 2 * kPaddedOut;
  const int row_begin = blockIdx.x * rows_per_chunk;
  const int row_end = row_begin + rows_per_chunk;
  copy_raw(raw, f, osc, row_begin, min(kTile, rows_per_chunk) + 1);
  cp_async_commit();
  // the taps from W2 (W2[m][r] = c[m - r], so c[i] = W2[8 + i][8]), split
  // into their tf32 hi and lo parts
  for (int i = threadIdx.x; i < kTapLen; i += kThreads) {
    const int t = i - kTapOff;
    uint32_t hi = 0u, lo = 0u;
    if (t >= 0 && t < kTaps) split_tf32(__ldg(w2 + (8 + t) * kBlk + 8), hi, lo);
    s_taps[i] = __uint_as_float(hi);
    s_taps[kTapLen + i] = __uint_as_float(lo);
  }
  const float pr = phasor[2 * b];
  const float pi = phasor[2 * b + 1];
  // tap block D_d[k][n] = c[8 d + k - n]: this lane's b0 (k = t4, n = g) at
  // tap_lane[8 d], b1 (k = t4 + 4) at tap_lane[8 d + 4]; lo a plane further
  const float* tap_lane = s_taps + kTapOff + t4 - g;
  // ldmatrix.x4: lane q*8 + r gives row r + 8 (q & 1), columns 4 (q >> 1) onward
  const int q = lane >> 3;
  const uint32_t a_base = smem_addr(ops) +
                          (16 * rt + (lane & 7) + 8 * (q & 1)) * kRowBytes + (q >> 1) * 16;
  // k-steps >= kSteps / 2 read the b operand: the same rows one down, or
  // the separately modulated b rows
  const uint32_t b_base = a_base + (SHARED_MOD ? 1 : kTile) * kRowBytes;

#pragma unroll 1
  for (int j0 = row_begin; j0 < row_end; j0 += kTile) {
    const int valid = min(kTile, row_end - j0);
    cp_async_wait_all();
    __syncthreads();  // this tile's raw rows have landed; the last tile's readers are done
    if constexpr (SHARED_MOD) {
      modulate(ops, raw, 0, kTile + 1, valid + 1);
    } else {
      modulate(ops, raw, 0, kTile, valid);
      modulate(ops + kTile * kRowBytes, raw, 1, kTile, valid);
    }
    __syncthreads();  // the operand rows are complete and raw is free
    if (j0 + kTile < row_end) {
      copy_raw(raw, f, osc, j0 + kTile, min(kTile, row_end - j0 - kTile) + 1);
      cp_async_commit();
    }

    // big: the hi x hi products; small: lo x hi and hi x lo; [plane u / w]
    // [n-tile][e], the mma C layout: rows g (e < 2) and g + 8, columns
    // 8 (c0 + c) + 2 t4 + (e & 1). half: the K = 128 product of W_lo
    // (ONE_DOT false), folded when the W_hi steps begin.
    float big[2][kGroupTiles][4], small[2][kGroupTiles][4], half[2][kGroupTiles][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int c = 0; c < kGroupTiles; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[p][c][e] = small[p][c][e] = half[p][c][e] = 0.0f;
    // blk[c]: the tap block d = qq - c of n-tile c at step qq (hi b0, b1, lo
    // b0, b1), a window that slides one block a step: each step moves
    // blk[c - 1] to blk[c] and loads block qq into blk[0], so before the
    // first step blk[c] holds block -1 - c
    uint32_t blk[kGroupTiles][4];
#pragma unroll
    for (int c = 0; c + 1 < kGroupTiles; ++c) {
      const float* tp = tap_lane + 8 * (-1 - c);
      blk[c][0] = __float_as_uint(tp[0]), blk[c][1] = __float_as_uint(tp[4]);
      blk[c][2] = __float_as_uint(tp[kTapLen]), blk[c][3] = __float_as_uint(tp[kTapLen + 4]);
    }
#pragma unroll
    for (int qq = 0; qq < kWalk; ++qq) {
#pragma unroll
      for (int c = kGroupTiles - 1; c > 0; --c)
#pragma unroll
        for (int k = 0; k < 4; ++k) blk[c][k] = blk[c - 1][k];
      {
        const float* tp = tap_lane + 8 * qq;
        blk[0][0] = __float_as_uint(tp[0]), blk[0][1] = __float_as_uint(tp[4]);
        blk[0][2] = __float_as_uint(tp[kTapLen]), blk[0][3] = __float_as_uint(tp[kTapLen + 4]);
      }
      const int qs = c0 + qq;  // the k-step: rows 8 qs .. 8 qs + 7 of [W_lo; W_hi]
      if (!ONE_DOT && qs == kSteps / 2) {
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int c = 0; c < kGroupTiles; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              half[p][c][e] = __fadd_rn(big[p][c][e], small[p][c][e]);
              big[p][c][e] = small[p][c][e] = 0.0f;
            }
      }
      const uint32_t a =
          (qs < kSteps / 2 ? a_base : b_base) + 4 * 8 * (qs % (kSteps / 2));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t ah[4], al[4];
        ldmatrix_x4(ah, a + 4 * (2 * p) * kBlk);
        ldmatrix_x4(al, a + 4 * (2 * p + 1) * kBlk);
#pragma unroll
        for (int c = 0; c < kGroupTiles; ++c) {
          const int d = qq - c;  // the tap block of (step, n-tile): zero outside [0, kBlocks)
          if (d < 0 || d >= kBlocks) continue;
          mma_tf32(small[p][c], al, blk[c][0], blk[c][1]);
          mma_tf32(small[p][c], ah, blk[c][2], blk[c][3]);
          mma_tf32(big[p][c], ah, blk[c][0], blk[c][1]);
        }
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * rt + g + 8 * h;
      if (r >= valid) continue;
#pragma unroll
      for (int c = 0; c < kGroupTiles; ++c) {
        float fu[2], fw[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * h + e;
          fu[e] = __fadd_rn(big[0][c][k], small[0][c][k]);
          fw[e] = __fadd_rn(big[1][c][k], small[1][c][k]);
          if (!ONE_DOT) {
            fu[e] = __fadd_rn(half[0][c][k], fu[e]);
            fw[e] = __fadd_rn(half[1][c][k], fw[e]);
          }
        }
        const size_t n = static_cast<size_t>(j0 + r) * kBlk + 8 * (c0 + c) + 2 * t4;
        *reinterpret_cast<float2*>(o + n) =
            make_float2(fu[0] * pr - fw[0] * pi, fu[1] * pr - fw[1] * pi);
        *reinterpret_cast<float2*>(o + kPaddedOut + n) =
            make_float2(fu[0] * pi + fw[0] * pr, fu[1] * pi + fw[1] * pr);
      }
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

// field: (batch, 261248) int8 symbol values, 4-byte aligned; phasor: (batch,
// 2) float32; osc: (2, 261248) float32 oscillator planes; w2: (256, 128)
// float32, W2 = [W_lo; W_hi]; out: (batch, 2, 261120) float32; all
// contiguous on `device`, osc 16-byte aligned.
// shared_mod / one_dot pick the variant; nchunk divides 2040. Launches on
// `stream`, returns cudaGetLastError().
int atsc_fir_variant(int device, const int8_t* field, const float* phasor, const float* osc,
                     const float* w2, float* out, int batch, int nchunk, int shared_mod,
                     int one_dot, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch < 1 || batch > 65535 || nchunk < 1 || kOutRows % nchunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(field) % 4 || reinterpret_cast<uintptr_t>(osc) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared_mod)
    return one_dot ? launch<true, true>(field, phasor, osc, w2, out, batch, nchunk, s)
                   : launch<true, false>(field, phasor, osc, w2, out, batch, nchunk, s);
  return one_dot ? launch<false, true>(field, phasor, osc, w2, out, batch, nchunk, s)
                 : launch<false, false>(field, phasor, osc, w2, out, batch, nchunk, s);
}

}  // extern "C"
