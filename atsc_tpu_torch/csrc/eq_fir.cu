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
// rides in s.
//
// The two tiers of the receiver's profiles:
// - fast (K = 128): u rounded to bf16 (__float2bfloat16_rn), taps rounded to
//   bf16 on the host. A product of two bf16 values is exact in float32 and
//   the sums stay float32: "bf16 operands, f32 accumulation", the TPU
//   kernel's arithmetic.
// - exact (K = 256): float32 operands. Each output sums 1,026 terms; the sum
//   is taken in chunks of 8 taps (16 terms) in float32, and the chunks are
//   added with Kahan compensation, so the level stays within a few ulp of
//   the correctly rounded sum that the plain twin takes in float64 (a
//   plain float32 chain drifts ~1e-5, the tier's whole budget).
// The derotation uses __fmul_rn/__fadd_rn/__fsub_rn so that no FMA
// contraction changes u: in the fast tier a 1-ulp change in u can flip its
// bf16 rounding. The plain twin (ops/cuda/eq_fir.py::eq_fir_plain) takes the
// same operations in the same order.
//
// Design: grid (ceil(260416 / 1024), B), 256 threads, 4 consecutive
// outputs per thread. A block stages the derotated u of its 1,024 outputs
// plus the 2K-sample lookahead in shared memory (12 KB at K = 256), reading
// the window and oscillator once. The tap loop is unrolled at compile time
// and the taps of each tier sit in __constant__ memory, so every FMA takes
// its tap as a constant-bank operand (a warp-wide broadcast). Each thread
// keeps a sliding window of 4 samples per plane in registers: one
// shared-memory load per plane and tap feeds 4 FMAs. The staging layout
// de-interleaves the samples by 4 (sample n at row n % 4, column n / 4), so
// at every tap a warp reads one row at 32 consecutive columns (no bank
// conflicts) from an address the compiler knows up to the thread's column.
// The Mosaic geometry of the TPU kernel (two BlockSpecs over one buffer for
// the halo, 8-row halo tiles, a 2048-row output grid) was tiling and is not
// carried over; the output is (B, 260416).
//
// What bounds it on an H100 at B = 384 (bytes once each, operations as the
// algorithm needs them):
// - fast: 2 x 257 multiply-adds per output, 1.03e11 FLOP; 0.90 GB moved for a
//   cf32 window (0.80 GB in: the 260416 + 2K samples per plane the FIR reads;
//   0.10 GB of int8 out), so 0.27 ms at 3.35 TB/s.
//   On tensor cores (bf16, 989 TFLOP/s) it would be memory-bound; this form
//   runs its FMAs on the CUDA cores, where the fp32 rate (67 TFLOP/s) bounds
//   it at 1.5 ms.
// - exact: 2 x 513 multiply-adds per output, 2.05e11 FLOP, so 3.1 ms at
//   67 TFLOP/s fp32: bound by operations (the Kahan steps add ~25 %).
// A tensor-core banded form fed by TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinLen = 263168;   // window samples per plane (WIN_LEN)
constexpr int kNOut = 260416;     // outputs per channel (params.SYMBOLS_PER_FIELD)
constexpr int kThreads = 256;
constexpr int kR = 4;             // consecutive outputs per thread
constexpr int kTile = kThreads * kR;
constexpr int kGrid = (kNOut + kTile - 1) / kTile;
constexpr int kMaxTaps = 513;     // 2K + 1 at K = 256
constexpr int kChunk = 8;         // exact tier: taps per float32 partial sum
constexpr float kHardBias = 1.25f - 7.0f;  // params.PILOT_OFFSET - 7

static_assert(kNOut % kR == 0, "a thread's outputs are all valid or all past the end");
static_assert((kGrid - 1) * kTile + kTile + kMaxTaps - 1 <= kWinLen,
              "the last block's staging stays inside the window");

enum WinType : int { kF32 = 0, kI16 = 1, kI8 = 2 };
enum OutMode : int { kHard = 0, kSoft = 1, kSoftCodes = 2 };

template <int kTier>
struct Tier;
template <>
struct Tier<0> {  // fast
  static constexpr int kK = 128;
  static constexpr bool kExact = false;
};
template <>
struct Tier<1> {  // exact
  static constexpr int kK = 256;
  static constexpr bool kExact = true;
};

__constant__ float c_p[2][kMaxTaps];  // [tier][tap]
__constant__ float c_q[2][kMaxTaps];

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

template <typename T, int kTier>
__global__ void __launch_bounds__(kThreads)
eq_fir_kernel(const T* __restrict__ win, const float* __restrict__ osc, void* __restrict__ out,
              int out_mode, float s, float oscale) {
  constexpr int kNTaps = 2 * Tier<kTier>::kK + 1;
  constexpr bool kExact = Tier<kTier>::kExact;
  constexpr int kSpan = kTile + kNTaps - 1;      // staged samples per plane
  constexpr int kCols = kSpan / kR;              // columns per row
  constexpr int kStride = kCols + 8;             // row stride (staging writes conflict-free)
  static_assert(kSpan % kR == 0, "the span fills whole columns");
  __shared__ float su[kR * kStride];
  __shared__ float sv[kR * kStride];

  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const T* wr = win + static_cast<size_t>(b) * 2 * kWinLen;
  const T* wi = wr + kWinLen;
  const float* cr = osc;
  const float* ci = osc + kWinLen;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    const int n = base + i;  // < kWinLen (static_assert above)
    const float xr = static_cast<float>(wr[n]);
    const float xi = static_cast<float>(wi[n]);
    const float c0 = cr[n];
    const float c1 = ci[n];
    float ur = __fmul_rn(__fadd_rn(__fmul_rn(xr, c0), __fmul_rn(xi, c1)), s);
    float ui = __fmul_rn(__fsub_rn(__fmul_rn(xi, c0), __fmul_rn(xr, c1)), s);
    if constexpr (!kExact) {
      ur = __bfloat162float(__float2bfloat16_rn(ur));
      ui = __bfloat162float(__float2bfloat16_rn(ui));
    }
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
  float lev[kR];
  if constexpr (kExact) {
    float part[kR], sum[kR], comp[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) part[r] = sum[r] = comp[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < kNTaps; ++t) {
      xr[kR - 1] = EQ_AT(pu, t + kR - 1);
      xi[kR - 1] = EQ_AT(pv, t + kR - 1);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        part[r] = fmaf(xr[r], c_p[kTier][t], part[r]);
        part[r] = fmaf(xi[r], c_q[kTier][t], part[r]);
      }
      if (t % kChunk == kChunk - 1 || t == kNTaps - 1) {
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
#pragma unroll
    for (int r = 0; r < kR; ++r) lev[r] = __fsub_rn(sum[r], comp[r]);
  } else {
    float ar[kR], ai[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ar[r] = ai[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < kNTaps; ++t) {
      xr[kR - 1] = EQ_AT(pu, t + kR - 1);
      xi[kR - 1] = EQ_AT(pv, t + kR - 1);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        ar[r] = fmaf(xr[r], c_p[kTier][t], ar[r]);
        ai[r] = fmaf(xi[r], c_q[kTier][t], ai[r]);
      }
#pragma unroll
      for (int r = 0; r < kR - 1; ++r) {
        xr[r] = xr[r + 1];
        xi[r] = xi[r + 1];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) lev[r] = __fadd_rn(ar[r], ai[r]);
  }
#undef EQ_AT

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
    for (int r = 0; r < kR; ++r) {
      const float x =
          out_mode == kHard
              ? fminf(fmaxf(rintf(__fmul_rn(__fsub_rn(lev[r], kHardBias), 0.5f)), 0.0f), 7.0f)
              : fminf(fmaxf(rintf(__fmul_rn(lev[r], oscale)), -127.0f), 127.0f);
      c[r] = static_cast<int8_t>(x);
    }
    *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + o) = v;
  }
}

template <typename T, int kTier>
void launch(const void* win, const float* osc, void* out, int batch, int out_mode, float s,
            float oscale, cudaStream_t stream) {
  const dim3 grid(kGrid, batch);
  eq_fir_kernel<T, kTier><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(win), osc, out,
                                                          out_mode, s, oscale);
}

template <int kTier>
int launch_type(int win_type, const void* win, const float* osc, void* out, int batch,
                int out_mode, float s, float oscale, cudaStream_t stream) {
  switch (win_type) {
    case kF32: launch<float, kTier>(win, osc, out, batch, out_mode, s, oscale, stream); return 0;
    case kI16: launch<int16_t, kTier>(win, osc, out, batch, out_mode, s, oscale, stream); return 0;
    case kI8: launch<int8_t, kTier>(win, osc, out, batch, out_mode, s, oscale, stream); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Copies the ntaps float32 taps p and q (host memory) of a tier (0 fast,
// K = 128, ntaps 257; 1 exact, K = 256, ntaps 513) into constant memory on
// `device`. Call once per (device, tier) before that tier's first launch.
// The copies are ordered only against the legacy default stream, so the
// device is synchronized before returning: a first launch on any stream,
// a non-blocking one included, then reads the taps.
int atsc_eq_fir_set_taps(int device, int tier, const float* p, const float* q, int ntaps) {
  const int want = tier == 0 ? 2 * Tier<0>::kK + 1 : 2 * Tier<1>::kK + 1;
  if ((tier != 0 && tier != 1) || ntaps != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t off = sizeof(float) * static_cast<size_t>(tier) * kMaxTaps;
  err = cudaMemcpyToSymbol(c_p, p, sizeof(float) * ntaps, off);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbol(c_q, q, sizeof(float) * ntaps, off);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSynchronize());
}

// win: (batch, 2, 263168) float32 / int16 / int8 (win_type 0 / 1 / 2);
// osc: (2, 263168) float32; out: (batch, 260416) int8 (out_mode 0 hard,
// 2 soft codes) or float32 (out_mode 1 soft), all contiguous on `device`.
// tier 0 (fast, K = 128) or 1 (exact, K = 256). s: the derotation scale;
// oscale: the soft-code scale. Launches on `stream` and returns
// cudaGetLastError().
int atsc_eq_fir(int device, const void* win, int win_type, const float* osc, void* out,
                int batch, int tier, int out_mode, float s, float oscale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (out_mode != kHard && out_mode != kSoft && out_mode != kSoftCodes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (tier) {
    case 0: rc = launch_type<0>(win_type, win, osc, out, batch, out_mode, s, oscale, st); break;
    case 1: rc = launch_type<1>(win_type, win, osc, out, batch, out_mode, s, oscale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
