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
// exact (K = 256, tier 1): float32 operands on the CUDA cores. Each output
// sums 1,026 terms; the sum is taken in chunks of 8 taps (16 terms) in
// float32, and the chunks are added with Kahan compensation, so the level
// stays within a few ulp of the correctly rounded sum that the plain twin
// takes in float64 (a plain float32 chain drifts ~1e-5, the tier's whole
// budget). Grid (ceil(260416 / 1024), B), 256 threads, 4 consecutive
// outputs per thread over a register window of the staged samples
// (de-interleaved by 4, conflict-free), taps in __constant__ memory at
// compile-time indices.
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
// - exact: 2 x 513 multiply-adds per output, 2.05e11 FLOP, so 3.1 ms at
//   67 TFLOP/s fp32: bound by operations (the Kahan steps add ~25 %).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device_guard.cuh"

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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
    cp_async16(reinterpret_cast<unsigned char*>(dst + plane * kSpan) + 16 * k,
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

// -- exact tier: CUDA cores, Kahan-compensated chunks -------------------------

constexpr int kExactK = 256;
constexpr int kExactTaps = 2 * kExactK + 1;  // 513
constexpr int kThreads = 256;
constexpr int kR = 4;             // consecutive outputs per thread
constexpr int kTile = kThreads * kR;
constexpr int kGrid = (kNOut + kTile - 1) / kTile;
constexpr int kChunk = 8;         // taps per float32 partial sum

static_assert(kNOut % kR == 0, "a thread's outputs are all valid or all past the end");
static_assert((kGrid - 1) * kTile + kTile + kExactTaps - 1 <= kWinLen,
              "the last block's staging stays inside the window");

__constant__ float c_p[kExactTaps];
__constant__ float c_q[kExactTaps];

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
eq_fir_exact_kernel(const T* __restrict__ win, const float* __restrict__ osc,
                    void* __restrict__ out, int out_mode, float s, float oscale) {
  constexpr int kSpanX = kTile + kExactTaps - 1;  // staged samples per plane
  constexpr int kCols = kSpanX / kR;              // columns per row
  constexpr int kStride = kCols + 8;              // row stride (staging writes conflict-free)
  static_assert(kSpanX % kR == 0, "the span fills whole columns");
  __shared__ float su[kR * kStride];
  __shared__ float sv[kR * kStride];

  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const T* wr = win + static_cast<size_t>(b) * 2 * kWinLen;
  const T* wi = wr + kWinLen;
  const float* cr = osc;
  const float* ci = osc + kWinLen;
  for (int i = threadIdx.x; i < kSpanX; i += kThreads) {
    const int n = base + i;  // < kWinLen (static_assert above)
    float ur, ui;
    derotate(static_cast<float>(wr[n]), static_cast<float>(wi[n]), cr[n], ci[n], s, ur, ui);
    const int at = (i % kR) * kStride + i / kR;
    su[at] = ur;
    sv[at] = ui;
  }
  __syncthreads();

  const int j0 = base + kR * threadIdx.x;
  if (j0 >= kNOut) return;
  // sample m = kR * threadIdx.x + d lives at row d % kR, column threadIdx.x + d / kR
  const float* pu = su + threadIdx.x;
  const float* pv = sv + threadIdx.x;
#define EQ_AT(P, d) (P)[((d) % kR) * kStride + (d) / kR]

  float xr[kR], xi[kR];  // xr[r] = u[m0 + t + r] at tap t
#pragma unroll
  for (int r = 0; r < kR - 1; ++r) {
    xr[r] = EQ_AT(pu, r);
    xi[r] = EQ_AT(pv, r);
  }
  float part[kR], sum[kR], comp[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) part[r] = sum[r] = comp[r] = 0.0f;
#pragma unroll
  for (int t = 0; t < kExactTaps; ++t) {
    xr[kR - 1] = EQ_AT(pu, t + kR - 1);
    xi[kR - 1] = EQ_AT(pv, t + kR - 1);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      part[r] = fmaf(xr[r], c_p[t], part[r]);
      part[r] = fmaf(xi[r], c_q[t], part[r]);
    }
    if (t % kChunk == kChunk - 1 || t == kExactTaps - 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        kahan_add(sum[r], comp[r], part[r]);
        part[r] = 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kR - 1; ++r) {
      xr[r] = xr[r + 1];
      xi[r] = xi[r + 1];
    }
  }
#undef EQ_AT
  float lev[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) lev[r] = __fsub_rn(sum[r], comp[r]);

  // the output mode is uniform across a launch: a runtime switch here
  // costs next to nothing and keeps it out of the template
  const size_t o = static_cast<size_t>(b) * kNOut + j0;  // a multiple of 4
  if (out_mode == kSoft) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
        make_float4(lev[0], lev[1], lev[2], lev[3]);
  } else {
    char4 v;
    int8_t* c = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      c[r] = static_cast<int8_t>(out_mode == kHard ? hard_symbol(lev[r])
                                                   : soft_code(lev[r], oscale));
    *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + o) = v;
  }
}

template <typename T>
cudaError_t launch(const void* win, const float* osc, void* out, int batch, int tier,
                   int out_mode, float s, float oscale, cudaStream_t stream) {
  const T* w = static_cast<const T*>(win);
  if (tier == 1) {
    eq_fir_exact_kernel<T><<<dim3(kGrid, batch), kThreads, 0, stream>>>(w, osc, out, out_mode,
                                                                         s, oscale);
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
// into constant memory. Call once per (device, tier) before that tier's
// first launch. The copies are ordered only against the legacy default
// stream, so the device is synchronized before returning: a first launch
// on any stream, a non-blocking one included, then reads the taps.
int atsc_eq_fir_set_taps(int device, int tier, const float* p, const float* q, int ntaps) {
  if ((tier != 0 && tier != 1) || ntaps != (tier == 0 ? kFastTaps : kExactTaps))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaError_t err;
  if (tier == 1) {
    err = cudaMemcpyToSymbol(c_p, p, sizeof(float) * ntaps);
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_q, q, sizeof(float) * ntaps);
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
