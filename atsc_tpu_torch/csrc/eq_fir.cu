// Fused derotate + widely-linear FIR + slicer for Hopper (sm_90a): the
// receive equalizer of the zero-forcing (zf) receiver.
//
// Replaces the TPU kernel atsc_tpu/ops/pallas/eq_fir.py::eq_fir_fused (body
// _kernel). Same function, not the same blocking. Per channel b and output
// sample j in [0, 260416), over a window that starts K samples before the
// field (stream span [g0 - K, g0 - K + 263168)):
//
//   u[n]   = (w[n] * conj(osc[n])) * s          s = dequant / 0.9^2
//          = ((wr cr + wi ci) s, (wi cr - wr ci) s)
//   lev[j] = sum_{t <= 2K} p[t] Re u[j+t] + q[t] Im u[j+t]
//
// then int8 hard symbols clip(rint((lev - (1.25 - 7)) * 0.5), 0, 7), float32
// soft levels, or int8 soft codes clip(rint(lev * scale), -127, 127). rintf
// rounds half to even, as jnp.round does (never roundf). int16/int8 code
// windows (cs16/cs8 captures) are cast to float and their dequantization
// rides in s. The derotation uses __fmul_rn/__fadd_rn/__fsub_rn so that no
// FMA contraction changes u: in the fast tier a 1-ulp change in u can flip
// its bf16 rounding. The plain twin (ops/cuda/eq_fir.py::eq_fir_plain)
// takes the same operations in the same order.
//
// The two tiers of the receiver's profiles, two kernels:
//
// fast (K = 128, tier 0): u and the taps rounded to bf16 (the taps on the
// host), products summed in float32: "bf16 operands, f32 accumulation",
// the TPU kernel's arithmetic, here on the tensor cores. Bands of 16: with
// output j = 16a + n and tap t = 16s + k - n (n, k < 16),
//   lev[16a + n] = sum_{s=0..16} sum_k Re u[16(a+s) + k] P_s[k][n]
//                                    + Im u[16(a+s) + k] Q_s[k][n],
// P_s[k][n] = p[16s + k - n] (0 outside [0, 256]), Q_s likewise from q.
// That is 34 products of a 16 x 16 matrix per 16 x 16 output tile (544
// multiply-adds per output for 514 useful). A block takes 4,096 outputs of
// 16 channels in turn. It stages the channel's window span and the
// oscillator span (4,352 samples: the outputs plus the 256-sample
// lookahead) by cp.async, derotates them into bf16 rows of 16 samples in
// shared memory, and its 4 warps each run four 16 x 16 output tiles as
// mma.sync.m16n8k16 (bf16 -> f32). The A operand of band s is the staged
// rows shifted down by s, read by ldmatrix, one row address per lane, so
// the overlapping rows need no copy; rows are 48 bytes apart (32 of data),
// so the 8 rows of each ldmatrix phase hit distinct banks. The 34 B
// operands (17 KB) are built once on the host in mma fragment order
// (atsc_eq_fir_set_taps) and held in registers, 136 per thread. The next
// channel's window span loads by cp.async while the tiles of this one run.
// The sum of each output is taken in chunks of 2 bands (4 products) from
// zero, the chunks added in float32: the tensor cores' float32 sums do not
// round to nearest at every add, and short chains keep that error near 1
// ulp of a level. The B operands in registers (254 per thread) leave 8
// warps on an SM; 4 tiles per warp and 16 channels per block measured
// 5-10 % faster than 2 and 8 at B = 384 (tools/torch_kernel_ab.py).
//
// exact (K = 256, tier 1): float32 accuracy from the tensor cores by a
// 3 x TF32 split. Each operand x (the derotated samples in staging, the
// taps once on the host) is split into tf32 words hi = tf32(x) and lo =
// tf32(x - hi), and each product is taken as lo*hi + hi*lo + hi*hi: the
// dropped lo*lo term and lo's own rounding leave x*y to within ~2^-21 of
// itself. The tiling is the fast tier's, with bands of 32: output j =
// 32 a + n and tap t = 32 s + k - n (n, k < 32), 17 bands, and band s's B
// matrix is cut into 8 x 8 tap blocks C_m[k][n] = taps[8 m + k - n], m =
// 4 s + kh - nt. mma.sync.m16n8k8 (tf32 -> f32) takes A, 16 rows of 8
// samples, by ldmatrix.x4 from staged rows of 32 samples (re hi, re lo,
// im hi, im lo; 528 bytes apart, conflict-free for any shift), and B by
// two 4-byte loads a lane from a 1-D array of the hi and lo taps in shared
// memory: the 33 x 2 x 2 band matrices would take ~1,000 registers a lane
// or 132 KB of shared memory, the 1-D array takes 9 KB. A block of 4
// warps stages 4,096 outputs of one channel (4,608 samples: derotated,
// split) and each warp holds 2 tiles of 16 x 32 outputs across the band
// loop, so one band's 7 tap blocks (per plane, hi and lo) load once for
// both tiles. The tensor cores' float32 sums round toward zero, not to
// nearest, so each output sums chunks of 4 k-steps (32 taps of one plane)
// from zero, hi*hi in one accumulator and the two small products in
// another, and the chunks are added on the CUDA cores with Kahan
// compensation: the level stays within a few ulp of the correctly rounded
// sum that the plain twin takes in float64 (a plain float32 chain drifts
// ~1e-5, the tier's whole budget; a CPU model that rounds every k-step
// and every accumulation toward zero stays within 3e-6,
// tests/test_torch_kernel_design.py).
//
// The Mosaic geometry of the TPU kernel (two BlockSpecs over one buffer for
// the halo, 8-row halo tiles, 128-wide bands, a 2048-row output grid) was
// tiling and is not carried over; the output is (B, 260416).
//
// What bounds them on an H100 at B = 384 (bytes once each, operations as
// the algorithm needs them):
// - fast: 2 x 257 multiply-adds per output, 1.03e11 FLOP (0.10 ms at the
//   bf16 tensor rate, 989 TFLOP/s); 0.90 GB moved for a cf32 window (0.80
//   GB in: the 260416 + 2K samples per plane the FIR reads; 0.10 GB of
//   int8 out), so 0.27 ms at 3.35 TB/s: bound by bytes.
// - exact: 2 x 513 multiply-adds per output, 2.05e11 FLOP: 3.1 ms at 67
//   TFLOP/s fp32 on the CUDA cores, or, as 3 tf32 products each, 6.16e11
//   FLOP and 1.245 ms at the dense tf32 rate (494.7 TFLOP/s), above its
//   0.80 GB (0.24 ms): bound by tensor operations. This form executes 544
//   taps a plane for the 513 (17 bands of 32), 6 % more, and is held
//   further by the ldmatrix traffic (~1 shared-memory wavefront per mma)
//   and the Kahan steps where mma.sync falls short of that rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device_guard.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kWinLen = 263168;   // window samples per plane (WIN_LEN)
constexpr int kNOut = 260416;     // outputs per channel (params.SYMBOLS_PER_FIELD)
constexpr float kHardBias = 1.25f - 7.0f;  // params.PILOT_OFFSET - 7

enum WinType : int { kF32 = 0, kI16 = 1, kI8 = 2 };
enum OutMode : int { kHard = 0, kSoft = 1, kSoftCodes = 2 };

__device__ __forceinline__ float hard_symbol(float lev) {
  return fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(lev, kHardBias), 0.5f)), 0.0f), 7.0f);
}

__device__ __forceinline__ float soft_code(float lev, float oscale) {
  return fminf(fmaxf(rintf(__fmul_rn(lev, oscale)), -127.0f), 127.0f);
}

// u = (w * conj(osc)) * s, each op rounded once, in the plain twin's order
__device__ __forceinline__ void derotate(float xr, float xi, float c0, float c1, float s,
                                         float& ur, float& ui) {
  ur = __fmul_rn(__fadd_rn(__fmul_rn(xr, c0), __fmul_rn(xi, c1)), s);
  ui = __fmul_rn(__fsub_rn(__fmul_rn(xi, c0), __fmul_rn(xr, c1)), s);
}

// -- fast tier: tensor-core bands of 16 ---------------------------------------

constexpr int kFastK = 128;
constexpr int kFastTaps = 2 * kFastK + 1;          // 257
constexpr int kBand = 16;                          // outputs per row, taps per band row
constexpr int kBands = 2 * kFastK / kBand + 1;     // 17
constexpr int kBandPlanes = 2 * kBands;            // B operands: band s, plane re (p) / im (q)
constexpr int kChunkBands = 2;                     // bands per float32 partial sum
constexpr int kChunks = (kBands + kChunkBands - 1) / kChunkBands;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTilesPerWarp = 4;                   // 16 x 16 output tiles per warp and channel
constexpr int kTcCols = kTcWarps * kTilesPerWarp * kBand * kBand;  // outputs per block (4096)
constexpr int kTcGrid = (kNOut + kTcCols - 1) / kTcCols;
constexpr int kTcChannels = 16;                    // channels per block, in turn
constexpr int kRows = kTcCols / kBand + kBands - 1;  // staged rows of 16 samples (272)
constexpr int kSpan = kRows * kBand;               // staged samples per plane (4352)
constexpr int kRowBytes = 48;                      // a bf16 row: 32 bytes + 16 of padding
constexpr int kPlaneBytes = kRows * kRowBytes;
constexpr int kOscBytes = 2 * kSpan * 4;

static_assert(kNOut % kBand == 0, "a row of 16 outputs is all valid or all past the end");
static_assert((kTcGrid - 1) * kTcCols + kSpan <= kWinLen,
              "the last block's span stays inside the window");
static_assert(kTcCols % 16 == 0 && kSpan % 16 == 0, "spans copy in 16-byte pieces");

// the B operands in mma fragment order: [band-plane][lane] = the lane's 4
// registers, {b0, b1} of output columns 0-7 then of columns 8-15
__device__ uint4 g_fast_b[kBandPlanes * 32];

// d += a (16 x 16, row) * b (16 x 8, col): bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive samples of a staged plane, as float
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const int16_t* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const int16_t* c = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// Copies [base, base + kSpan) of both planes (plane stride kWinLen) of src
// into dst ([2][kSpan]) with cp.async, 16 bytes per copy.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int base) {
  constexpr int kPieces = kSpan * static_cast<int>(sizeof(T)) / 16;  // per plane
  for (int i = threadIdx.x; i < 2 * kPieces; i += kTcThreads) {
    const int plane = i >= kPieces, k = i - plane * kPieces;
    cp_async<16>(reinterpret_cast<unsigned char*>(dst + plane * kSpan) + 16 * k,
                 reinterpret_cast<const unsigned char*>(src + plane * kWinLen + base) + 16 * k);
  }
}

template <typename T>
constexpr int fast_smem_bytes() {
  return kOscBytes + 2 * kSpan * static_cast<int>(sizeof(T)) + 2 * kPlaneBytes;
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
eq_fir_tc_kernel(const T* __restrict__ win, const float* __restrict__ osc, void* __restrict__ out,
                 int batch, int out_mode, float s, float oscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_osc = reinterpret_cast<float*>(smem);               // [2][kSpan]
  T* s_raw = reinterpret_cast<T*>(smem + kOscBytes);           // [2][kSpan]
  unsigned char* s_u = smem + kOscBytes + 2 * kSpan * sizeof(T);  // [2][kRows][48 B]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTcCols;
  const int b0 = blockIdx.y * kTcChannels;
  const int channels = min(kTcChannels, batch - b0);

  copy_span(s_osc, osc, base);
  copy_span(s_raw, win + static_cast<size_t>(b0) * 2 * kWinLen, base);
  cp_async_commit();
  uint4 bfrag[kBandPlanes];
#pragma unroll
  for (int i = 0; i < kBandPlanes; ++i) bfrag[i] = g_fast_b[i * 32 + lane];
  // ldmatrix.x4: lane q*8 + r gives row r + 8 (q & 1), taps 8 (q >> 1) onward
  const int q = lane >> 3;
  const uint32_t a_lane =
      smem_addr(s_u) + ((lane & 7) + 8 * (q & 1)) * kRowBytes + (q >> 1) * 16;
  const int g = lane >> 2, cc = lane & 3;  // the mma C layout: row g (and g + 8), columns 2cc
  cp_async_wait_all();
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < channels; ++c) {
    const int b = b0 + c;
    // derotate the staged span into bf16 rows, 8 samples (half a row) a step
    for (int i = threadIdx.x; i < 2 * kRows; i += kTcThreads) {
      const int n = 8 * i;
      float xr[8], xi[8], cr[8], ci[8];
      load8(s_raw + n, xr);
      load8(s_raw + kSpan + n, xi);
      load8(s_osc + n, cr);
      load8(s_osc + kSpan + n, ci);
      uint4 vr, vi;
      uint32_t* pr = &vr.x;
      uint32_t* pi = &vi.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float r0, i0, r1, i1;
        derotate(xr[2 * k], xi[2 * k], cr[2 * k], ci[2 * k], s, r0, i0);
        derotate(xr[2 * k + 1], xi[2 * k + 1], cr[2 * k + 1], ci[2 * k + 1], s, r1, i1);
        pr[k] = pack_bf16(r0, r1);
        pi[k] = pack_bf16(i0, i1);
      }
      unsigned char* dst = s_u + (i >> 1) * kRowBytes + (i & 1) * 16;
      *reinterpret_cast<uint4*>(dst) = vr;
      *reinterpret_cast<uint4*>(dst + kPlaneBytes) = vi;
    }
    __syncthreads();  // the rows are complete and the raw span is free
    if (c + 1 < channels) {
      copy_span(s_raw, win + static_cast<size_t>(b + 1) * 2 * kWinLen, base);
      cp_async_commit();
    }

#pragma unroll 1
    for (int tile = 0; tile < kTilesPerWarp; ++tile) {
      const int a0 = (warp * kTilesPerWarp + tile) * kBand;  // the tile's first row
      const uint32_t a_tile = a_lane + a0 * kRowBytes;
      float sum[2][4];  // [nt][e]: the mma C layout of output columns 8 nt + ...
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        float acc[2][4] = {};
#pragma unroll
        for (int sb = ch * kChunkBands; sb < (ch + 1) * kChunkBands && sb < kBands; ++sb) {
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            uint32_t a[4];
            ldmatrix_x4(a, a_tile + pl * kPlaneBytes + sb * kRowBytes);
            const uint4 bw = bfrag[2 * sb + pl];
            mma_bf16(acc[0], a, bw.x, bw.y);  // output columns 0-7
            mma_bf16(acc[1], a, bw.z, bw.w);  // output columns 8-15
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[nt][e] = ch == 0 ? acc[nt][e] : __fadd_rn(sum[nt][e], acc[nt][e]);
      }
      // sum[nt][2 h + e]: row g + 8 h, column 8 nt + 2 cc + e of the tile
      const int j_tile = base + a0 * kBand;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j_row = j_tile + (g + 8 * h) * kBand;
        if (j_row >= kNOut) continue;
        const size_t o = static_cast<size_t>(b) * kNOut + j_row + 2 * cc;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float v0 = sum[nt][2 * h], v1 = sum[nt][2 * h + 1];
          if (out_mode == kSoft) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + o + 8 * nt) =
                make_float2(v0, v1);
          } else {
            const bool hard = out_mode == kHard;
            const float y0 = hard ? hard_symbol(v0) : soft_code(v0, oscale);
            const float y1 = hard ? hard_symbol(v1) : soft_code(v1, oscale);
            char2 y;
            y.x = static_cast<signed char>(y0);
            y.y = static_cast<signed char>(y1);
            *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o + 8 * nt) = y;
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next channel's span has landed; the rows are free
  }
}

// -- exact tier: 3 x TF32 on the tensor cores, Kahan-compensated chunks -------

constexpr int kExactK = 256;
constexpr int kExactTaps = 2 * kExactK + 1;        // 513
constexpr int kXBand = 32;                         // outputs per row, taps per band row
constexpr int kXNt = kXBand / 8;                   // 8-wide column tiles and k-steps of a band
constexpr int kXBands = (kExactTaps - 1 + kXBand - 1) / kXBand + 1;  // 17
constexpr int kXBlocks = 2 * kXNt - 1;             // 8 x 8 tap blocks a band reads
constexpr int kXWarps = 4;
constexpr int kXThreads = 32 * kXWarps;
constexpr int kXTilesPerWarp = 2;                  // 16-row tiles a warp holds across the bands
constexpr int kXChunkSteps = 4;                    // k-steps (8 taps of a plane) per float32 chunk
constexpr int kXRows = kXWarps * kXTilesPerWarp * 16;  // output rows per block
constexpr int kXCols = kXRows * kXBand;            // outputs per block (4096)
constexpr int kXGrid = (kNOut + kXCols - 1) / kXCols;
constexpr int kXStaged = kXRows + kXBands - 1;     // staged rows
constexpr int kXRowBytes = 4 * (4 * kXBand + 4);   // re hi, re lo, im hi, im lo + 16 bytes
constexpr int kXTapLen = kXBand * (kXBands + 1);   // a tap plane: kXBand zeros, the taps, zeros
constexpr int kXTapBytes = 4 * 4 * kXTapLen;       // p hi, p lo, q hi, q lo
constexpr int kXSmem = kXTapBytes + kXStaged * kXRowBytes;

static_assert(kXBand % 8 == 0 && kNOut % kXBand == 0,
              "a row of outputs is all valid or all past the end");
static_assert((kXGrid - 1) * kXCols + kXStaged * kXBand <= kWinLen,
              "the last block's staging stays inside the window");
static_assert((2 * kXNt) % kXChunkSteps == 0, "a chunk never straddles two bands");
static_assert(kXRowBytes % 128 == 16, "the 8 rows of an ldmatrix phase hit distinct banks");
static_assert(kXTapBytes % 128 == 0, "the staged rows start on a 128-byte boundary");

// the taps split into tf32 hi and lo parts, planes p hi, p lo, q hi, q lo,
// tap t at [plane][kXBand + t] (atsc_eq_fir_set_taps)
__device__ float4 g_exact_taps[kXTapLen];

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// 4 consecutive samples of a window plane, as float
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const int16_t* p, float (&x)[4]) {
  const short4 v = *reinterpret_cast<const short4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(kXThreads, 2)
eq_fir_exact_kernel(const T* __restrict__ win, const float* __restrict__ osc,
                    void* __restrict__ out, int out_mode, float s, float oscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_taps = reinterpret_cast<float*>(smem);   // [4][kXTapLen]
  unsigned char* s_rows = smem + kXTapBytes;        // [kXStaged][kXRowBytes]

  const int b = blockIdx.y;
  const int base = blockIdx.x * kXCols;
  for (int i = threadIdx.x; i < kXTapLen; i += kXThreads)
    reinterpret_cast<float4*>(s_taps)[i] = g_exact_taps[i];
  // derotate the span [base, base + kXStaged kXBand) and split it into the
  // staged rows: row r holds samples base + kXBand r + [0, kXBand) of each
  // plane as tf32 hi and lo words
  {
    const T* wr = win + static_cast<size_t>(b) * 2 * kWinLen + base;
    const T* wi = wr + kWinLen;
    const float* cr = osc + base;
    const float* ci = osc + kWinLen + base;
    for (int i = threadIdx.x; i < kXStaged * kXBand / 4; i += kXThreads) {
      const int n = 4 * i;
      float xr[4], xi[4], c0[4], c1[4];
      load4(wr + n, xr);
      load4(wi + n, xi);
      load4(cr + n, c0);
      load4(ci + n, c1);
      uint4 rh, rl, ih, il;
      uint32_t* prh = &rh.x;
      uint32_t* prl = &rl.x;
      uint32_t* pih = &ih.x;
      uint32_t* pil = &il.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float ur, ui;
        derotate(xr[k], xi[k], c0[k], c1[k], s, ur, ui);
        split_tf32(ur, prh[k], prl[k]);
        split_tf32(ui, pih[k], pil[k]);
      }
      uint4* row = reinterpret_cast<uint4*>(s_rows + (n / kXBand) * kXRowBytes + 4 * (n % kXBand));
      row[0] = rh;
      row[kXBand / 4] = rl;
      row[2 * kXBand / 4] = ih;
      row[3 * kXBand / 4] = il;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // the mma layouts: group g, thread t4 in it
  // ldmatrix.x4: lane q*8 + r gives row r + 8 (q & 1), columns 4 (q >> 1) onward
  const int q = lane >> 3;
  const int row0 = warp * kXTilesPerWarp * 16;  // the warp's first output row
  const uint32_t a_lane = smem_addr(s_rows) +
                          (row0 + (lane & 7) + 8 * (q & 1)) * kXRowBytes + (q >> 1) * 16;
  // tap block C_m[k][n] = taps[8 m + k - n]: this lane's b0 (k = t4, n = g)
  // and b1 (k = t4 + 4)
  const float* tap_lane = s_taps + kXBand + t4 - g;

  // big: the hi x hi products of a chunk; small: lo x hi and hi x lo;
  // sum, comp: the Kahan sum of the chunks. [tile][nt][e]: the mma C layout
  // of output rows g (e < 2) and g + 8, columns 8 nt + 2 t4 + (e & 1)
  float big[kXTilesPerWarp][kXNt][4], small[kXTilesPerWarp][kXNt][4];
  float sum[kXTilesPerWarp][kXNt][4], comp[kXTilesPerWarp][kXNt][4];
#pragma unroll
  for (int tile = 0; tile < kXTilesPerWarp; ++tile)
#pragma unroll
    for (int nt = 0; nt < kXNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        big[tile][nt][e] = small[tile][nt][e] = sum[tile][nt][e] = comp[tile][nt][e] = 0.0f;

  // Band sb of the output tile at rows a0: lev[kXBand (a0 + r) + n] +=
  // sum_k u[kXBand (a0 + sb + r) + k] B_sb[k][n], B_sb[k][n] = taps[kXBand sb
  // + k - n]; in 8 x 8 pieces (k = 8 kh + k', n = 8 nt + n') B_sb is the tap
  // block C_m with m = kXNt sb + kh - nt.
#pragma unroll 1
  for (int sb = 0; sb < kXBands; ++sb) {
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      uint32_t bh[kXBlocks][2], bl[kXBlocks][2];  // block m = kXNt sb + d - (kXNt - 1)
#pragma unroll
      for (int d = 0; d < kXBlocks; ++d) {
        const float* tp = tap_lane + 8 * (kXNt * sb + d - (kXNt - 1)) + 2 * pl * kXTapLen;
        bh[d][0] = __float_as_uint(tp[0]);
        bh[d][1] = __float_as_uint(tp[4]);
        bl[d][0] = __float_as_uint(tp[kXTapLen]);
        bl[d][1] = __float_as_uint(tp[kXTapLen + 4]);
      }
#pragma unroll
      for (int kh = 0; kh < kXNt; ++kh) {
#pragma unroll
        for (int tile = 0; tile < kXTilesPerWarp; ++tile) {
          const uint32_t a =
              a_lane + (16 * tile + sb) * kXRowBytes + 4 * (2 * pl * kXBand + 8 * kh);
          uint32_t ah[4], al[4];
          ldmatrix_x4(ah, a);
          ldmatrix_x4(al, a + 4 * kXBand);
#pragma unroll
          for (int nt = 0; nt < kXNt; ++nt) {
            const int d = kh - nt + kXNt - 1;
            mma_tf32(small[tile][nt], al, bh[d][0], bh[d][1]);
            mma_tf32(small[tile][nt], ah, bl[d][0], bl[d][1]);
            mma_tf32(big[tile][nt], ah, bh[d][0], bh[d][1]);
          }
        }
        if ((pl * kXNt + kh + 1) % kXChunkSteps == 0) {
#pragma unroll
          for (int tile = 0; tile < kXTilesPerWarp; ++tile)
#pragma unroll
            for (int nt = 0; nt < kXNt; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                kahan_add(sum[tile][nt][e], comp[tile][nt][e],
                          __fadd_rn(big[tile][nt][e], small[tile][nt][e]));
                big[tile][nt][e] = small[tile][nt][e] = 0.0f;
              }
        }
      }
    }
  }

  // the output mode is uniform across a launch: a runtime switch here
  // costs next to nothing and keeps it out of the template
#pragma unroll
  for (int tile = 0; tile < kXTilesPerWarp; ++tile) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j_row = base + (row0 + 16 * tile + g + 8 * h) * kXBand;
      if (j_row >= kNOut) continue;
#pragma unroll
      for (int nt = 0; nt < kXNt; ++nt) {
        const size_t o = static_cast<size_t>(b) * kNOut + j_row + 8 * nt + 2 * t4;
        const float v0 = __fsub_rn(sum[tile][nt][2 * h], comp[tile][nt][2 * h]);
        const float v1 = __fsub_rn(sum[tile][nt][2 * h + 1], comp[tile][nt][2 * h + 1]);
        if (out_mode == kSoft) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
        } else {
          const bool hard = out_mode == kHard;
          char2 y;
          y.x = static_cast<signed char>(hard ? hard_symbol(v0) : soft_code(v0, oscale));
          y.y = static_cast<signed char>(hard ? hard_symbol(v1) : soft_code(v1, oscale));
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = y;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* win, const float* osc, void* out, int batch, int tier,
                   int out_mode, float s, float oscale, cudaStream_t stream) {
  const T* w = static_cast<const T*>(win);
  if (tier == 1) {
    const cudaError_t err = cudaFuncSetAttribute(
        eq_fir_exact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
    if (err != cudaSuccess) return err;
    eq_fir_exact_kernel<T><<<dim3(kXGrid, batch), kXThreads, kXSmem, stream>>>(
        w, osc, out, out_mode, s, oscale);
    return cudaSuccess;
  }
  constexpr int kSmem = fast_smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      eq_fir_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kTcGrid, (batch + kTcChannels - 1) / kTcChannels);
  eq_fir_tc_kernel<T><<<grid, kTcThreads, kSmem, stream>>>(w, osc, out, batch, out_mode, s,
                                                            oscale);
  return cudaSuccess;
}

// x -> its tf32 parts hi = tf32(x), lo = tf32(x - hi), as float32 values
void split_tf32_host(float x, float& hi, float& lo) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  u = tf32_bits(u);
  memcpy(&hi, &u, sizeof u);
  const float rest = x - hi;  // exact
  memcpy(&u, &rest, sizeof u);
  u = tf32_bits(u);
  memcpy(&lo, &u, sizeof u);
}

// float32 -> bf16 bits, rounded to nearest even (the taps are finite)
uint16_t bf16_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

}  // namespace

extern "C" {

// Loads the ntaps float32 taps p and q (host memory) of a tier on `device`:
// tier 0 (fast, K = 128, ntaps 257) as the 34 bf16 B operands of the
// tensor-core kernel in fragment order, tier 1 (exact, K = 256, ntaps 513)
// split into tf32 hi and lo parts, as four zero-padded tap planes. Call
// once per (device, tier) before that tier's first launch. The copies are
// ordered only against the legacy default stream, so the device is
// synchronized before returning: a first launch on any stream, a
// non-blocking one included, then reads the taps.
int atsc_eq_fir_set_taps(int device, int tier, const float* p, const float* q, int ntaps) {
  if ((tier != 0 && tier != 1) || ntaps != (tier == 0 ? kFastTaps : kExactTaps))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaError_t err;
  if (tier == 1) {
    // planes p hi, p lo, q hi, q lo: tap t at kXBand + t, zeros around;
    // hi = tf32(x), lo = tf32(x - hi)
    float image[4 * kXTapLen] = {};
    for (int t = 0; t < kExactTaps; ++t) {
      split_tf32_host(p[t], image[kXBand + t], image[kXTapLen + kXBand + t]);
      split_tf32_host(q[t], image[2 * kXTapLen + kXBand + t], image[3 * kXTapLen + kXBand + t]);
    }
    err = cudaMemcpyToSymbol(g_exact_taps, image, sizeof image);
  } else {
    // register r = 2 nt + hk of lane (g, cc) packs B[k][n], B[k + 1][n] with
    // n = 8 nt + g, k = 2 cc + 8 hk; band s of plane re/im: B[k][n] =
    // p/q[16 s + k - n], 0 outside the taps
    uint32_t image[kBandPlanes * 32 * 4];
    for (int bp = 0; bp < kBandPlanes; ++bp) {
      const float* taps = bp % 2 ? q : p;
      const int sb = bp / 2;
      for (int lane = 0; lane < 32; ++lane) {
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * (r / 2) + lane / 4, k = 2 * (lane % 4) + 8 * (r % 2);
          uint32_t word = 0;
          for (int e = 0; e < 2; ++e) {
            const int t = kBand * sb + k + e - n;
            if (t >= 0 && t < kFastTaps)
              word |= static_cast<uint32_t>(bf16_bits(taps[t])) << (16 * e);
          }
          image[(bp * 32 + lane) * 4 + r] = word;
        }
      }
    }
    err = cudaMemcpyToSymbol(g_fast_b, image, sizeof image);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSynchronize());
}

// win: (batch, 2, 263168) float32 / int16 / int8 (win_type 0 / 1 / 2);
// osc: (2, 263168) float32; out: (batch, 260416) int8 (out_mode 0 hard,
// 2 soft codes) or float32 (out_mode 1 soft), all contiguous on `device`,
// win and osc 16-byte aligned. tier 0 (fast, K = 128) or 1 (exact, K =
// 256). s: the derotation scale; oscale: the soft-code scale. Launches on
// `stream` and returns cudaGetLastError().
int atsc_eq_fir(int device, const void* win, int win_type, const float* osc, void* out,
                int batch, int tier, int out_mode, float s, float oscale, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch < 1 || batch > 65535 || (tier != 0 && tier != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_mode != kHard && out_mode != kSoft && out_mode != kSoftCodes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(win) % 16 || reinterpret_cast<uintptr_t>(osc) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (win_type) {
    case kF32: err = launch<float>(win, osc, out, batch, tier, out_mode, s, oscale, st); break;
    case kI16: err = launch<int16_t>(win, osc, out, batch, tier, out_mode, s, oscale, st); break;
    case kI8: err = launch<int8_t>(win, osc, out, batch, tier, out_mode, s, oscale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
