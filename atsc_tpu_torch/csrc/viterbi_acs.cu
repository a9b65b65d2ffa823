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
// Design. The 4-state forward pass and both tracebacks run one thread per
// lane, with the path metrics (or the traceback state) in registers, in
// blocks of 32 threads (at B = 384: 4,608 lanes, 144 warps spread over all
// 132 SMs), each thread prefetching the next group's observations or
// decision words into registers while it works on the current group.
// The PR forward pass is state-parallel: 16 threads per lane, one per
// combined state, exchanging metrics by warp shuffles (its comment below
// has the maps), in blocks of one warp (two lanes).
//
// What bounds them on an H100 at B = 384 (T = 21,528, L = 4,608): the
// bytes are 397 MB of float32 obs (99 MB int8) plus 99 MB of decisions for
// the 4-state forward pass (0.148 / 0.059 ms at 3.35 TB/s), 99 + 99 MB for
// its traceback (0.059 ms), 397 + 397 MB for the PR forward pass (0.237
// ms, under its operations bound of 0.367 ms at the fp32 peak) and 397 +
// 99 MB for its traceback (0.148 ms). None of them comes near that: each
// is a dependent chain of 21,528 steps. One thread per lane leaves one
// warp per scheduler, so the 4-state pass and the tracebacks are bound by
// the latency of their chain (~60 instructions a step for the 4-state
// pass, a handful for a traceback step). The PR pass, one thread per lane,
// ran ~400 dependent instructions a step (7.8 ms); 16 threads per lane cut
// that to ~33 per thread and put ~17 warps on each SM, so it is bound by
// issue and by the shuffle latency in each step's chain (metric -> shuffle
// -> candidate -> minimum -> metric), at ~1/7 of the operations bound.
// The 4-state pass stays one thread per lane for now: 4 states give 4
// threads per lane, 576 warps for 528 schedulers, so the same design
// there needs its own measurement.

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

// The 16-state PR add-compare-select, state-parallel: 16 threads of one
// warp per lane (two lanes per warp), thread t owning combined state
// u = t = s2*4 + h' (v = 2h' + (s2&1) the emitted level, x1 = h'&1). Its
// four candidates read the metrics of its predecessor group, sp*4 + h with
// sp = PRED0[s2] ^ x1 (PRED0 = 0, 2, 1, 3): four shuffles a step.
constexpr int kPrS = 16;                     // threads per lane
constexpr int kPrThreads = 32;              // threads per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int pred0(int s2) { return 2 * (s2 & 1) + (s2 >> 1); }

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Transposes a 16 x 16 matrix of 2-bit entries held one row per thread by
// the 16 threads t of a lane (entry j of a row at bits 2j, 2j+1): after it
// thread t holds column t. Stage b swaps the off-diagonal b x b blocks of
// the thread pair (t, t ^ b); kHi marks the entries j with j & b set.
__device__ __forceinline__ uint32_t transpose16(uint32_t x, int t) {
  constexpr uint32_t kHi[4] = {0xFFFF0000u, 0xFF00FF00u, 0xF0F0F0F0u, 0xCCCCCCCCu};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = 8 >> i;
    const uint32_t y = __shfl_xor_sync(kFull, x, b);
    x = (t & b) ? (x & kHi[i]) | ((y >> (2 * b)) & ~kHi[i])
                : (x & ~kHi[i]) | ((y << (2 * b)) & kHi[i]);
  }
  return x;
}

// rc: bit 0 = the comb reference is a segment-sync symbol, bit 1 = its
// sign (+5, else -5). A block runs NT/16 lanes; lanes past `lanes` run
// along (the shuffles take the whole warp) but read and write nothing.
// Per group of 24 steps the block stages the obs rows one group ahead,
// lane-major in shared memory, so a thread takes its lane's 24 values in
// six 16-byte loads; the group's rc entries of a lane's encoder come one
// group ahead too, two per thread, and four ballots turn them into reset
// and sign bit masks. A warp with no reset step in the group runs it
// without the reset selects. Each thread packs its state's 2-bit picks,
// 16 steps to a word, and one transpose16 turns the lane's 16 words into
// the 16 steps' decision words (bits 2u, 2u+1 = the pick of state u),
// thread t storing step t's. Nothing but the four metric shuffles goes
// through the shared-memory/shuffle pipe in a step: per-step ballots and
// shared stores, tried first, cost more than the arithmetic.
template <int NT>
__global__ void __launch_bounds__(NT)
pr_acs_forward_kernel(const float* __restrict__ obs, const int32_t* __restrict__ rc,
                      const float* __restrict__ m_in, int32_t* __restrict__ dec,
                      float* __restrict__ m_out, int steps, int lanes) {
  constexpr int LPB = NT / kPrS;  // lanes per block
  constexpr int kObs = kGroup * LPB;
  constexpr int kObsPer = (kObs + NT - 1) / NT;
  static_assert(NT % 32 == 0, "whole warps");
  __shared__ __align__(16) float s_obs[2][LPB][kGroup];

  const int tid = threadIdx.x;
  const int seg = (tid & 31) >> 4, t = tid & 15;
  const int ll = (tid >> 5) * 2 + seg;  // lane in the block
  const int lane0 = blockIdx.x * LPB;
  const int l = lane0 + ll;
  const bool valid = l < lanes;
  const int e = l % 12;
  const size_t stride = static_cast<size_t>(lanes);

  const int s2 = t >> 2, h1 = t & 3;
  const int sp = pred0(s2) ^ (h1 & 1);
  const float lv = static_cast<float>(2 * (2 * h1 + (s2 & 1)) - 7);
  int src[4];
  float pc[4];  // the delayed reference level of hypothesis h, off reset steps
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    src[h] = seg * kPrS + sp * 4 + h;
    pc[h] = static_cast<float>(2 * (2 * h + (sp & 1)) - 7);
  }
  float m = valid ? m_in[t * stride + l] : 0.0f;

  float p_obs[kObsPer];
  int32_t p_rc[2];  // rc of steps t and 16 + t of the group, encoder e
  auto fetch = [&](int g) {
#pragma unroll
    for (int i = 0; i < kObsPer; ++i) {
      const int item = tid + i * NT, q = item % LPB;
      const size_t row = static_cast<size_t>(g) * kGroup + item / LPB;
      p_obs[i] = (item < kObs && lane0 + q < lanes) ? obs[row * stride + lane0 + q] : 0.0f;
    }
    const int32_t* r = rc + (static_cast<size_t>(g) * kGroup + t) * 12 + e;
    p_rc[0] = r[0];
    p_rc[1] = t < kGroup - 16 ? r[16 * 12] : 0;
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kObsPer; ++i) {
      const int item = tid + i * NT;
      if (item < kObs) s_obs[buf][item % LPB][item / LPB] = p_obs[i];
    }
  };
  fetch(0);
  stage(0);
  __syncthreads();

  const int groups = steps / kGroup;
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    const int buf = g & 1;
    // the group's reset and sign bits of this lane's encoder, step s at
    // bit s, from one ballot per 16 steps of the lane's 16 threads
    const uint32_t reset0 = __ballot_sync(kFull, p_rc[0] & 1);
    const uint32_t reset1 = __ballot_sync(kFull, p_rc[1] & 1);
    const uint32_t sign0 = __ballot_sync(kFull, (p_rc[0] >> 1) == 1);
    const uint32_t sign1 = __ballot_sync(kFull, (p_rc[1] >> 1) == 1);
    const uint32_t reset_bits =
        ((reset0 >> (16 * seg)) & 0xFFFFu) | (((reset1 >> (16 * seg)) & 0xFFu) << 16);
    const uint32_t sign_bits =
        ((sign0 >> (16 * seg)) & 0xFFFFu) | (((sign1 >> (16 * seg)) & 0xFFu) << 16);
    if (g + 1 < groups) fetch(g + 1);
    float ov[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&s_obs[buf][ll][i]);
      ov[i] = v.x, ov[i + 1] = v.y, ov[i + 2] = v.z, ov[i + 3] = v.w;
    }
    int32_t* out = dec + static_cast<size_t>(g) * kGroup * stride + l;
    auto run = [&](auto with_resets) {
      uint32_t acc = 0;  // this state's picks, step s at bits 2(s % 16)
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        float mp[4], pe[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          mp[h] = __shfl_sync(kFull, m, src[h]);
          pe[h] = pc[h];
        }
        if constexpr (decltype(with_resets)::value) {
          const float sync = (sign_bits >> s) & 1u ? 5.0f : -5.0f;
#pragma unroll
          for (int h = 0; h < 4; ++h) pe[h] = (reset_bits >> s) & 1u ? sync : pc[h];
        }
        const float a = __fsub_rn(ov[s], lv);  // obs - emitted level
        float c[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float tt = __fadd_rn(a, pe[h]);
          c[h] = __fadd_rn(mp[h], __fmul_rn(tt, tt));
        }
        const float m01 = fminf(c[0], c[1]);
        const uint32_t i01 = c[1] < c[0];
        const float m23 = fminf(c[2], c[3]);
        const uint32_t i23 = c[3] < c[2];
        const bool pick = m23 < m01;
        m = fminf(m01, m23);
        acc |= (pick ? 2u + i23 : i01) << (2 * (s % 16));
        if (s == 15 || s == kGroup - 1) {
          const uint32_t word = transpose16(acc, t);  // step s - s % 16 + t
          if (valid && (s == 15 || t < kGroup - 16))
            out[static_cast<size_t>(s - s % 16 + t) * stride] = static_cast<int32_t>(word);
          acc = 0;
        }
      }
    };
    if ((reset0 | reset1) != 0)  // warp-uniform
      run(Flag<true>());
    else
      run(Flag<false>());
    // renormalize: the lane's minimum over its 16 threads (exact in any
    // order on these finite, non-negative metrics)
    float mn = m;
#pragma unroll
    for (int off = kPrS / 2; off > 0; off >>= 1)
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
    m = __fsub_rn(m, mn);
    if (g + 1 < groups) stage(buf ^ 1);
    __syncthreads();
  }
  if (valid) m_out[t * stride + l] = m;
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
  constexpr int lanes_per_block = kPrThreads / kPrS;
  pr_acs_forward_kernel<kPrThreads>
      <<<(lanes + lanes_per_block - 1) / lanes_per_block, kPrThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(obs, rc, m_in, dec, m_out, steps, lanes);
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
