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
// Design. Both tracebacks run one thread per lane, with the traceback
// state in registers, in blocks of 32 threads (at B = 384: 4,608 lanes,
// 144 warps spread over all 132 SMs), each thread prefetching the next
// group's decision words into registers while it works on the current
// group. Both forward passes are state-parallel, exchanging metrics by
// warp shuffles with the observations one group ahead in registers: the
// 4-state pass as a butterfly, 2 threads per lane with two states each
// (9,216 threads, 288 warps at B = 384), the PR pass with 16 threads per
// lane, one per combined state, both in blocks of one warp (their comments
// below have the maps).
//
// What bounds them on an H100 at B = 384 (T = 21,528, L = 4,608): the
// bytes are 397 MB of float32 obs (99 MB int8) plus 99 MB of decisions for
// the 4-state forward pass (0.148 / 0.059 ms at 3.35 TB/s), 99 + 99 MB for
// its traceback (0.059 ms), 397 + 397 MB for the PR forward pass (0.237
// ms, under its operations bound of 0.367 ms at the fp32 peak) and 397 +
// 99 MB for its traceback (0.148 ms). None of them comes near that: each
// is a dependent chain of 21,528 steps. One thread per lane leaves one
// warp per scheduler, so the tracebacks are bound by the latency of their
// chain (a handful of instructions a traceback step). The forward passes,
// one thread per lane, ran ~60 (4-state) and ~400 (PR) dependent
// instructions a step; spread over 2 and 16 threads per lane they run ~30
// and ~33 per thread, bound by issue and by the latency of each step's
// chain (metric -> add -> minimum -> shuffle -> metric): the number of
// lanes at B = 384 does not fill the schedulers twice over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kGroup = 24;           // steps per renormalization
constexpr int kWpg = kGroup / 4;     // 4-state decision words per group
constexpr int kThreads = 32;
constexpr float kPilot = 1.25f;      // params.PILOT_OFFSET

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float load_obs(float x, float) { return x; }
__device__ __forceinline__ float load_obs(int8_t c, float inv) {
  return __fmul_rn(static_cast<float>(c), inv);  // ops.quantize SOFT_LEVEL_INV
}

// The branch metrics one thread needs for new states s' = 2a + b: the
// Z2-resolved minima p[x1] = min(d[2 x1 + b], d[2 x1 + b + 4]) and their Z2
// bits z[x1] = d[2 x1 + b + 4] < d[2 x1 + b] (strict), d[v] = (o - lv[v])^2.
struct Branches {
  float p0, p1;
  uint32_t z0, z1;
};

__device__ __forceinline__ Branches branches(float o, const float (&lv)[4]) {
  float d[4];  // levels b, b + 4, 2 + b, 6 + b
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fsub_rn(o, lv[i]);
    d[i] = __fmul_rn(t, t);
  }
  return {fminf(d[0], d[1]), fminf(d[2], d[3]), d[1] < d[0], d[3] < d[2]};
}

// One survivor: candidates c0 (X1 = 0) and c1 (X1 = 1); returns the 2-bit
// decision (x1 | z2 << 1) and sets m to the survivor. x1 = c1 < c0 (strict)
// picks c1 only when it is smaller, so the survivor is fminf(c0, c1): the
// same value (the metrics are finite and never -0.0), one instruction on
// the metric chain instead of a compare and a select.
__device__ __forceinline__ uint32_t survivor(float c0, float c1, const Branches& br, float& m) {
  const bool x1 = c1 < c0;
  m = fminf(c0, c1);
  return static_cast<uint32_t>(x1) | ((x1 ? br.z1 : br.z0) << 1);
}

// The 4-state add-compare-select, state-parallel as a butterfly: 2
// threads per lane, consecutive in a warp, in blocks of kAcsThreads (lanes
// past `lanes` run along, the shuffles take the whole warp, but read and
// write nothing). New state s' = 2a + b has predecessors 2b + a (X1 = 0)
// and 2b + 1 - a (X1 = 1), and both read the branches of bit b. Thread b
// holds states x = 3b and y = 1 + b. Both new states it makes read the
// predecessor pair {x, y} ({0, 1} or {3, 2}): it keeps new state 3b
// (X1 = 0 from x, X1 = 1 from y) and sends new state 2 - b (X1 = 0 from y,
// X1 = 1 from x) to the other thread, whose send is its next y: one xor
// shuffle a step and no select on the metric chain. Its decisions fill the
// bits of its two states in each step's byte; one xor shuffle per 8 steps
// merges the two threads' halves of 2 words, thread w storing word w. A
// group of 24 steps is 3 x 8 steps of words, so the words of a group never
// straddle a renormalization. The renormalizing minimum is taken by an xor
// shuffle (fminf, exact in any order on these finite, non-negative
// metrics). Observations are loaded by both threads of a lane (one address
// per lane, a broadcast) one group ahead, into registers; float32 ones are
// also prefetched into L2 kAcsAhead groups ahead by the lane's first
// thread (it took the float32 pass from 1.16 to 0.92 ms at B = 384; int8
// codes, a quarter of the bytes, gained nothing from it).
// Measured at B = 384 on an H100 (32 threads per block, T = 21,528): 0.92
// ms (float32) and 0.68 ms (int8), against 1.54 and 1.53 for one thread
// per lane and 1.09 and 0.95 for 4 threads per lane, a state each.
constexpr int kAcsThreads = 32;   // threads per block
constexpr int kAcsAhead = 2;      // float32 observations: groups prefetched ahead into L2

template <typename T>
__global__ void __launch_bounds__(kAcsThreads)
acs_forward_kernel(const T* __restrict__ obs, const float* __restrict__ m_in,
                   int32_t* __restrict__ dec, float* __restrict__ m_out, int groups, int lanes,
                   float inv) {
  static_assert(kAcsThreads % 32 == 0, "whole warps");
  const int tid = blockIdx.x * kAcsThreads + threadIdx.x;
  // b: this thread holds states (x, y) = (3b, 1 + b). Written tid & 1 and
  // tid >> 1, the same instructions schedule differently and the int8 pass
  // took 1.07 ms instead of 0.67 (H100, B = 384, tools/torch_kernel_ab.py).
  const int t = tid % 2;
  const int l = tid / 2;
  const int b = t & 1;
  const bool valid = l < lanes;
  const int lc = valid ? l : lanes - 1;  // lanes past the end read the last lane
  const size_t stride = static_cast<size_t>(lanes);
  float lv[4];  // the levels of this thread's four branches
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = b + (i & 1) * 4 + (i >> 1) * 2;  // b, b + 4, 2 + b, 6 + b
    lv[i] = static_cast<float>(2 * v - 7) + kPilot;
  }
  float m = m_in[3 * b * stride + lc];
  float m2 = m_in[(1 + b) * stride + lc];

  const T* src = obs + lc;
  int32_t* out = dec + l;
  T cur[kGroup], nxt[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) cur[i] = src[i * stride];
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups) {
      const T* p = src + static_cast<size_t>(g + 1) * kGroup * stride;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) nxt[i] = p[i * stride];
    }
    if (sizeof(T) == 4 && kAcsAhead > 0 && g + kAcsAhead < groups && b == 0) {
      const T* p = src + static_cast<size_t>(g + kAcsAhead) * kGroup * stride;
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i * stride));
    }
    int32_t* row = out + static_cast<size_t>(g) * kWpg * stride;
    uint32_t w[2] = {0, 0};  // this thread's bits of the 2 words of 8 steps
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const Branches br = branches(load_obs(cur[s], inv), lv);
      float keep, send;  // new states 3b and 2 - b (the other thread's next y)
      const uint32_t dk = survivor(__fadd_rn(m, br.p0), __fadd_rn(m2, br.p1), br, keep);
      const uint32_t ds = survivor(__fadd_rn(m2, br.p0), __fadd_rn(m, br.p1), br, send);
      m = keep;
      m2 = __shfl_xor_sync(kFull, send, 1);
      w[s % 8 / 4] |= ((dk << (6 * b)) | (ds << (4 - 2 * b))) << (8 * (s % 4));
      if (s % 8 == 7) {  // words 2 (s / 8), 2 (s / 8) + 1 of the group
        const uint32_t word = w[b] | __shfl_xor_sync(kFull, w[1 - b], 1);
        if (valid) row[static_cast<size_t>(s / 8 * 2 + b) * stride] = static_cast<int32_t>(word);
        w[0] = w[1] = 0;
      }
    }
    float mn = fminf(m, m2);
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, 1));
    m = __fsub_rn(m, mn);
    m2 = __fsub_rn(m2, mn);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) cur[i] = nxt[i];
  }
  if (valid) {
    m_out[3 * b * stride + l] = m;
    m_out[(1 + b) * stride + l] = m2;
  }
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
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (bad_shape(steps, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = steps / kGroup;
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(lanes) * 2 + kAcsThreads - 1) / kAcsThreads);
  if (obs_i8)
    acs_forward_kernel<int8_t><<<blocks, kAcsThreads, 0, st>>>(
        static_cast<const int8_t*>(obs), m_in, dec, m_out, groups, lanes, inv);
  else
    acs_forward_kernel<float><<<blocks, kAcsThreads, 0, st>>>(
        static_cast<const float*>(obs), m_in, dec, m_out, groups, lanes, inv);
  return static_cast<int>(cudaGetLastError());
}

// dec, bits: (W, L) int32 with W = T/4 a multiple of 6; start: (L,) int32.
int atsc_traceback(int device, const int32_t* dec, const int32_t* start, int32_t* bits,
                   int words, int lanes, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (bad_shape(4 * words, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  traceback_kernel<<<grid_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dec, start, bits, words / kWpg, lanes);
  return static_cast<int>(cudaGetLastError());
}

// obs: (T, L) float32; rc: (T, 12) int32; m_in, m_out: (16, L) float32;
// dec: (T, L) int32.
int atsc_pr_acs_forward(int device, const float* obs, const int32_t* rc, const float* m_in,
                        int32_t* dec, float* m_out, int steps, int lanes, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
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
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (bad_shape(steps, lanes)) return static_cast<int>(cudaErrorInvalidValue);
  pr_traceback_kernel<<<grid_for(lanes), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dec, start, bits, steps / kGroup, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
