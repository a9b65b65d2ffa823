// Soft-decision Viterbi for Hopper (sm_90a): the add-compare-select forward
// passes and the tracebacks of the receiver's maximum-likelihood trellis
// tiers.
//
// Replaces the four TPU kernels of atsc_tpu/ops/pallas/viterbi_acs.py:
// - acs_forward_kernel    <- acs_forward (bodies _acs_kernel, _acs_update):
//   4-state ACS per lane, float32 soft levels or int8 soft-level codes;
// - traceback_kernel      <- traceback (body _tb_kernel);
// - pr_acs_forward_kernel <- pr_acs_forward (bodies _pr_acs_kernel,
//   _pr_update): the 16-state partial-response ACS of the NTSC comb tier;
// - pr_traceback_kernel   <- pr_traceback (body _pr_tb_kernel).
// The wrappers and plain PyTorch twins are ops/cuda/viterbi_acs.py.
//
// Layouts: a lane l = b*12 + e is one (channel, encoder) trellis; obs is
// T-major (T, L), so the 32 loads of one step by a warp are contiguous;
// metrics are state-major (S, L). 4-state decisions pack 4 steps per int32
// (byte k of word i = step 4i+k; bits 2s, 2s+1 = (x1, z2) into state s); PR
// decisions are one int32 per step (bits 2u, 2u+1 = the predecessor-symbol
// pick of combined state u). Traceback output: byte k of word i = x1 | z2<<1
// of step 4i+k. T is a multiple of 24: the metrics renormalize (subtract
// their minimum) after every 24 steps, the reference's cadence.
//
// Bit identity with the plain twin and the JAX package: every float op is
// written __fsub_rn / __fmul_rn / __fadd_rn, so nvcc contracts nothing into
// an FMA (the int8 dequant c*inv - lv and the PR candidate m + (a + pe)^2
// would otherwise contract), in the reference's order: (obs - lv), then the
// square as t*t, then min(d[v], d[v+4]) with the Z2 bit d[v+4] < d[v]
// (strict), then x1 = c1 < c0 (strict). The minima are fminf (2-way) and a
// `<`-select (the 4-state survivor); both give the same value here, since
// metrics are finite and never -0.0. The PR pick is the first-min tree of
// the reference: min/argmin of (c0, c1) and of (c2, c3), then the pair with
// the strictly smaller minimum, the first pair on a tie.
//
// Design: one thread per lane runs the whole T-step recursion with its 4 or
// 16 path metrics in registers. Blocks of 32 threads: at B = 384 there are
// 4,608 lanes, 144 warps in all, and blocks of 32 spread them over all 132
// SMs (36 blocks of 128 would leave 96 SMs idle). The loads never depend on
// the path, so each thread prefetches the next group's observations (24
// steps; the PR tier 4 steps, whose 4 x ~400 instructions already cover a
// load's latency) and decision words into registers while it works on the
// current group.
//
// What bounds it on an H100 at B = 384 (T = 21,528, L = 4,608): the bytes
// are 397 MB of float32 obs (99 MB int8) plus 99 MB of decisions for the
// 4-state forward pass (0.148 / 0.059 ms at 3.35 TB/s), 99 + 99 MB for its
// traceback (0.059 ms), 397 + 397 MB for the PR forward pass (0.237 ms) and
// 397 + 99 MB for its traceback (0.148 ms). None of the kernels comes near
// those: each is a dependent chain of 21,528 steps on one warp per
// scheduler, so it is bound by the latency of that chain (~60 instructions
// a step for the 4-state pass, ~400 for the PR pass, a handful for a
// traceback step). This design does nothing about that beyond spreading the
// warps; several threads per lane (a state-parallel ACS exchanging metrics
// by shuffles) is the lever.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 24;           // steps per renormalization
constexpr int kWpg = kGroup / 4;     // 4-state decision words per group
constexpr int kThreads = 32;
constexpr float kPilot = 1.25f;      // params.PILOT_OFFSET

__device__ __forceinline__ float load_obs(float x, float) { return x; }
__device__ __forceinline__ float load_obs(int8_t c, float inv) {
  return __fmul_rn(static_cast<float>(c), inv);  // ops.quantize SOFT_LEVEL_INV
}

// One 4-state add-compare-select (no renormalization): updates m0..m3 and
// returns the decision byte, bits (2s, 2s+1) = (x1, z2) into new state s.
__device__ __forceinline__ uint32_t acs_step(float o, float& m0, float& m1, float& m2,
                                             float& m3) {
  float d[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float t = __fsub_rn(o, static_cast<float>(2 * v - 7) + kPilot);
    d[v] = __fmul_rn(t, t);
  }
  // parallel-branch (Z2) resolution per (x1, z0-branch) pair
  const float p00 = fminf(d[0], d[4]);
  const float p01 = fminf(d[1], d[5]);
  const float p10 = fminf(d[2], d[6]);
  const float p11 = fminf(d[3], d[7]);
  const uint32_t zc00 = d[4] < d[0], zc01 = d[5] < d[1];
  const uint32_t zc10 = d[6] < d[2], zc11 = d[7] < d[3];
  // new state s' = 2a + b: predecessors 2b+a (X1=0) and 2b+1-a (X1=1)
  uint32_t dec = 0;
  float n[4];
  const float c0[4] = {__fadd_rn(m0, p00), __fadd_rn(m2, p01), __fadd_rn(m1, p00),
                       __fadd_rn(m3, p01)};
  const float c1[4] = {__fadd_rn(m1, p10), __fadd_rn(m3, p11), __fadd_rn(m0, p10),
                       __fadd_rn(m2, p11)};
  const uint32_t z0[4] = {zc00, zc01, zc00, zc01};
  const uint32_t z1[4] = {zc10, zc11, zc10, zc11};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool x1 = c1[s] < c0[s];
    n[s] = x1 ? c1[s] : c0[s];
    const uint32_t z2 = x1 ? z1[s] : z0[s];
    dec |= (static_cast<uint32_t>(x1) | (z2 << 1)) << (2 * s);
  }
  m0 = n[0];
  m1 = n[1];
  m2 = n[2];
  m3 = n[3];
  return dec;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
acs_forward_kernel(const T* __restrict__ obs, const float* __restrict__ m_in,
                   int32_t* __restrict__ dec, float* __restrict__ m_out, int groups, int lanes,
                   float inv) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  float m0 = m_in[l], m1 = m_in[stride + l], m2 = m_in[2 * stride + l],
        m3 = m_in[3 * stride + l];
  const T* src = obs + l;
  int32_t* out = dec + l;
  T cur[kGroup], nxt[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) cur[i] = src[i * stride];
  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups) {
      const T* p = src + static_cast<size_t>(g + 1) * kGroup * stride;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) nxt[i] = p[i * stride];
    }
#pragma unroll
    for (int j = 0; j < kWpg; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word |= acs_step(load_obs(cur[4 * j + k], inv), m0, m1, m2, m3) << (8 * k);
      out[static_cast<size_t>(g * kWpg + j) * stride] = static_cast<int32_t>(word);
    }
    const float mn = fminf(fminf(m0, m1), fminf(m2, m3));
    m0 = __fsub_rn(m0, mn);
    m1 = __fsub_rn(m1, mn);
    m2 = __fsub_rn(m2, mn);
    m3 = __fsub_rn(m3, mn);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) cur[i] = nxt[i];
  }
  m_out[l] = m0;
  m_out[stride + l] = m1;
  m_out[2 * stride + l] = m2;
  m_out[3 * stride + l] = m3;
}

__global__ void __launch_bounds__(kThreads)
traceback_kernel(const int32_t* __restrict__ dec, const int32_t* __restrict__ start,
                 int32_t* __restrict__ bits, int groups, int lanes) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  uint32_t s = static_cast<uint32_t>(start[l]);
  uint32_t cur[kWpg], nxt[kWpg];
  const int32_t* src = dec + l;
#pragma unroll
  for (int j = 0; j < kWpg; ++j)
    cur[j] = src[static_cast<size_t>((groups - 1) * kWpg + j) * stride];
  for (int g = groups - 1; g >= 0; --g) {
    if (g > 0) {
#pragma unroll
      for (int j = 0; j < kWpg; ++j)
        nxt[j] = src[static_cast<size_t>((g - 1) * kWpg + j) * stride];
    }
#pragma unroll
    for (int j = kWpg - 1; j >= 0; --j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const uint32_t byte = (cur[j] >> (8 * k)) & 0xFFu;
        const uint32_t sel = (byte >> (2 * s)) & 3u;   // x1 | z2<<1 into s
        word |= sel << (8 * k);
        s = ((s & 1u) << 1) | ((s >> 1) ^ (sel & 1u));
      }
      bits[static_cast<size_t>(g * kWpg + j) * stride + l] = static_cast<int32_t>(word);
    }
#pragma unroll
    for (int j = 0; j < kWpg; ++j) cur[j] = nxt[j];
  }
}

// One 16-state PR add-compare-select (no renormalization). rc: bit 0 = the
// comb reference is a segment-sync symbol, bit 1 = its sign (+5, else -5).
__device__ __forceinline__ uint32_t pr_step(float o, int32_t rc, float (&m)[16]) {
  const bool reset = (rc & 1) != 0;
  const float sync = (rc >> 1) == 1 ? 5.0f : -5.0f;
  float a[8], pe[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    a[v] = __fsub_rn(o, static_cast<float>(2 * v - 7));   // obs - emitted level
    pe[v] = reset ? sync : static_cast<float>(2 * v - 7);  // delayed reference
  }
  float nm[16];
  uint32_t word = 0;
  // combined state u = s2*4 + h': v = 2h' + (s2&1), x1 = h'&1, predecessor
  // trellis state sp = PRED0[s2] ^ x1, j = sp&1
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int s2 = u >> 2, h1 = u & 3;
    const int v = 2 * h1 + (s2 & 1);
    const int sp = (2 * (s2 & 1) + (s2 >> 1)) ^ (h1 & 1);
    const int j = sp & 1;
    float c[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float t = __fadd_rn(a[v], pe[2 * h + j]);
      c[h] = __fadd_rn(m[sp * 4 + h], __fmul_rn(t, t));
    }
    const float m01 = fminf(c[0], c[1]);
    const uint32_t i01 = c[1] < c[0];
    const float m23 = fminf(c[2], c[3]);
    const uint32_t i23 = c[3] < c[2];
    const bool pick = m23 < m01;
    nm[u] = fminf(m01, m23);
    word |= (pick ? 2u + i23 : i01) << (2 * u);
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) m[u] = nm[u];
  return word;
}

constexpr int kPrAhead = 4;  // PR steps prefetched ahead

__global__ void __launch_bounds__(kThreads)
pr_acs_forward_kernel(const float* __restrict__ obs, const int32_t* __restrict__ rc,
                      const float* __restrict__ m_in, int32_t* __restrict__ dec,
                      float* __restrict__ m_out, int steps, int lanes) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  const int e = l % 12;
  float m[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) m[u] = m_in[u * stride + l];
  float cur[kPrAhead], nxt[kPrAhead];
  int32_t rcur[kPrAhead], rnxt[kPrAhead];
#pragma unroll
  for (int i = 0; i < kPrAhead; ++i) {
    cur[i] = obs[i * stride + l];
    rcur[i] = rc[i * 12 + e];
  }
  const int blocks = steps / kPrAhead;
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
    const int t0 = b * kPrAhead;
    if (b + 1 < blocks) {
#pragma unroll
      for (int i = 0; i < kPrAhead; ++i) {
        nxt[i] = obs[static_cast<size_t>(t0 + kPrAhead + i) * stride + l];
        rnxt[i] = rc[(t0 + kPrAhead + i) * 12 + e];
      }
    }
#pragma unroll
    for (int i = 0; i < kPrAhead; ++i)
      dec[static_cast<size_t>(t0 + i) * stride + l] =
          static_cast<int32_t>(pr_step(cur[i], rcur[i], m));
    if ((t0 + kPrAhead) % kGroup == 0) {
      float mn = m[0];
#pragma unroll
      for (int u = 1; u < 16; ++u) mn = fminf(mn, m[u]);
#pragma unroll
      for (int u = 0; u < 16; ++u) m[u] = __fsub_rn(m[u], mn);
    }
#pragma unroll
    for (int i = 0; i < kPrAhead; ++i) {
      cur[i] = nxt[i];
      rcur[i] = rnxt[i];
    }
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) m_out[u * stride + l] = m[u];
}

__global__ void __launch_bounds__(kThreads)
pr_traceback_kernel(const int32_t* __restrict__ dec, const int32_t* __restrict__ start,
                    int32_t* __restrict__ bits, int groups, int lanes) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= lanes) return;
  const size_t stride = static_cast<size_t>(lanes);
  uint32_t s = static_cast<uint32_t>(start[l]);
  uint32_t cur[kGroup], nxt[kGroup];
  const int32_t* src = dec + l;
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    cur[i] = src[static_cast<size_t>((groups - 1) * kGroup + i) * stride];
  for (int g = groups - 1; g >= 0; --g) {
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        nxt[i] = src[static_cast<size_t>((g - 1) * kGroup + i) * stride];
    }
#pragma unroll
    for (int j = kWpg - 1; j >= 0; --j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const uint32_t h_prev = (cur[4 * j + k] >> (2 * s)) & 3u;
        const uint32_t x1 = s & 1u;
        word |= (s & 3u) << (8 * k);                      // x1 | z2<<1
        const uint32_t s2 = s >> 2;
        const uint32_t pred = ((2u * (s2 & 1u)) | (s2 >> 1)) ^ x1;
        s = (pred << 2) | h_prev;
      }
      bits[static_cast<size_t>(g * kWpg + j) * stride + l] = static_cast<int32_t>(word);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) cur[i] = nxt[i];
  }
}

inline int grid_for(int lanes) { return (lanes + kThreads - 1) / kThreads; }

inline bool bad_shape(int steps, int lanes) {
  return steps < kGroup || steps % kGroup != 0 || lanes < 1;
}

}  // namespace

extern "C" {

// obs: (T, L) float32 (obs_i8 = 0) or int8 codes dequantized by inv
// (obs_i8 = 1); m_in, m_out: (4, L) float32; dec: (T/4, L) int32, all
// contiguous on `device`. Launches on `stream`, returns cudaGetLastError().
int atsc_acs_forward(int device, const void* obs, int obs_i8, const float* m_in, int32_t* dec,
                     float* m_out, int steps, int lanes, float inv, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(steps, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = steps / kGroup;
  if (obs_i8)
    acs_forward_kernel<int8_t><<<grid_for(lanes), kThreads, 0, st>>>(
        static_cast<const int8_t*>(obs), m_in, dec, m_out, groups, lanes, inv);
  else
    acs_forward_kernel<float><<<grid_for(lanes), kThreads, 0, st>>>(
        static_cast<const float*>(obs), m_in, dec, m_out, groups, lanes, inv);
  return static_cast<int>(cudaGetLastError());
}

// dec, bits: (W, L) int32 with W = T/4 a multiple of 6; start: (L,) int32.
int atsc_traceback(int device, const int32_t* dec, const int32_t* start, int32_t* bits,
                   int words, int lanes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(4 * words, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  traceback_kernel<<<grid_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dec, start, bits, words / kWpg, lanes);
  return static_cast<int>(cudaGetLastError());
}

// obs: (T, L) float32; rc: (T, 12) int32; m_in, m_out: (16, L) float32;
// dec: (T, L) int32.
int atsc_pr_acs_forward(int device, const float* obs, const int32_t* rc, const float* m_in,
                        int32_t* dec, float* m_out, int steps, int lanes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(steps, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  pr_acs_forward_kernel<<<grid_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      obs, rc, m_in, dec, m_out, steps, lanes);
  return static_cast<int>(cudaGetLastError());
}

// dec: (T, L) int32; start: (L,) int32; bits: (T/4, L) int32.
int atsc_pr_traceback(int device, const int32_t* dec, const int32_t* start, int32_t* bits,
                      int steps, int lanes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(steps, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  pr_traceback_kernel<<<grid_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dec, start, bits, steps / kGroup, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
