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
// Each of the four also has a chunked form (acs_forward_chunked_kernel,
// traceback_chunked_kernel, pr_acs_forward_chunked_kernel,
// pr_traceback_chunked_kernel) for the chunk-parallel near-MLSE of
// `--viterbi-chunks` (the JAX package runs that as a lax.scan,
// atsc_tpu/ops/viterbi.py _chunked_mlse; ChunkPlan below). The wrappers
// and plain PyTorch twins are ops/cuda/viterbi_acs.py.
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
// Design. Both forward passes are state-parallel, exchanging metrics by
// warp shuffles with the observations one group ahead in registers: the
// 4-state pass as a butterfly, 2 threads per lane with two states each
// (9,216 threads, 288 warps at B = 384), the PR pass with 16 threads per
// lane, one per combined state, both in blocks of one warp (their comments
// below have the maps). Both tracebacks are chunk-parallel and exact: each
// lane's field is cut into chunks of whole groups, one thread per (lane,
// chunk), every chunk but the top one walked from all its entry states at
// once until their chains merge, the entry states then resolved from the
// top down in shared memory and each chunk's head walked again from its
// real entry (chunked_traceback below); 16 chunks (4-state) and 8 (PR) at
// B = 384 are 73,728 and 36,864 threads.
//
// What bounds them on an H100 at B = 384 (T = 21,528, L = 4,608): the
// bytes are 397 MB of float32 obs (99 MB int8) plus 99 MB of decisions for
// the 4-state forward pass (0.148 / 0.059 ms at 3.35 TB/s), 99 + 99 MB for
// its traceback (0.059 ms), 397 + 397 MB for the PR forward pass (0.237
// ms, under its operations bound of 0.367 ms at the fp32 peak) and 397 +
// 99 MB for its traceback (0.148 ms). Each pass is a dependent chain of
// 21,528 steps per lane. The forward passes, one thread per lane, ran ~60
// (4-state) and ~400 (PR) dependent instructions a step; spread over 2 and
// 16 threads per lane they run ~30 and ~33 per thread, bound by issue and
// by the latency of each step's chain (metric -> add -> minimum -> shuffle
// -> metric): the number of lanes at B = 384 does not fill the schedulers
// twice over. The tracebacks do a handful of integer operations a step;
// one thread per lane left ~1 warp per SM on a 21,528-step chain (0.68 and
// 0.83 ms); cut into chunks they run ~17 (4-state) and ~9 (PR) warps per
// SM on chains of ~1,345 and ~2,690 steps, at about half their bytes
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kGroup = 24;           // steps per renormalization
constexpr int kWpg = kGroup / 4;     // 4-state decision words per group
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

// The two tracebacks, chunk-parallel and exact. A lane's field is cut into
// `chunks` = min(K, groups) chunks of whole 24-step groups (chunk c holds
// groups [c G / chunks, (c + 1) G / chunks)), so no output word is shared
// between chunks, and one thread walks one (lane, chunk). K is kTbChunks
// for the 4-state trellis and kPrTbChunks for the PR one. A warp is 32
// consecutive lanes of one chunk (each decision row is one coalesced
// 128-byte load, as for one thread per lane); a block is all the chunks of
// those 32 lanes, so the hand-off between chunks goes through shared memory
// inside one launch. At B = 384: 144 blocks of 16 warps (4-state) or 8
// (PR), registers capped for two blocks per SM, so all are resident.
// Three phases, a __syncthreads() after the first:
// 1. The top chunk walks one chain from `start` and writes every word. Every
//    other chunk starts at its top step with all S entry states at once (a
//    map from entry state to current state: S = 4 entries of 2 bits in a
//    uint32, or 16 of 4 bits in a uint64), one group at a time. At the end
//    of the first group after which all S chains hold one state, it goes on
//    from that state as one chain to the chunk's bottom, writing the words
//    of those groups: below that point the path does not depend on the
//    entry state. It records the map of its bottom states (constant if the
//    chains merged) and the number of groups walked before the merge, its
//    head (all of the chunk if they never merged).
// 2. Each thread resolves its chunk's real entry state, from `start` down
//    through the maps of the chunks above it (at most K - 1 lookups in
//    shared memory).
// 3. It walks its head again, as one chain from that entry state, and
//    writes the head's words. Its state at the head's end is the merged
//    state, so the words below, written in phase 1, are the ones this chain
//    would write. A chunk whose chains never merged is walked twice in full:
//    exact, slower, and only on decision words built to keep every chain
//    apart.
// Each walk holds one group of decision rows in registers and reloads each
// output word's rows with the next group's as soon as they are used (one
// group of loads in flight). Measured at B = 384 on an H100: 0.11 ms
// (4-state) and 0.20 ms (PR) on real decisions, against 0.68 and 0.83 for
// one thread per lane; two or three groups in registers gained at most 3 %
// (4-state) and cost spills (PR); 8 chunks were as fast as 16 for the
// 4-state trellis and faster for the PR one (fewer 16-chain heads), 32
// (blocks of 1024 threads, not all resident) slower for both.
constexpr int kTbLanes = 32;      // lanes per block
constexpr int kTbChunks = 16;     // 4-state: chunks per lane, at most
constexpr int kPrTbChunks = 8;    // PR: chunks per lane, at most

__host__ __device__ constexpr int tb_min_blocks(int chunks) {
  return kTbLanes * chunks <= 512 ? 2 : 1;
}

// The 4-state trellis: a decision row is one word of 4 steps. Entry e of
// a map sits at bits 2e, 2e+1.
struct Tb4 {
  using Map = uint32_t;
  static constexpr int kChunks = kTbChunks, kRowsPerWord = 1;
  static constexpr Map kIdentity = 0xE4u;
  __device__ static Map constant(uint32_t s) { return s * 0x55u; }
  __device__ static uint32_t lookup(Map m, uint32_t e) { return (m >> (2 * e)) & 3u; }
  __device__ static bool merged(Map m, uint32_t& s) {
    s = m & 3u;
    return m == constant(s);
  }
  // one chain over output word j of the rows from s: the word
  template <int N>
  __device__ static uint32_t chain(const uint32_t (&w)[N], int j, uint32_t& s) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const uint32_t byte = (w[j] >> (8 * k)) & 0xFFu;
      const uint32_t sel = (byte >> (2 * s)) & 3u;   // x1 | z2<<1 into s
      word |= sel << (8 * k);
      s = ((s & 1u) << 1) | ((s >> 1) ^ (sel & 1u));
    }
    return word;
  }
  // every chain of the map over word j. A step's predecessor of state s,
  // ((s & 1) << 1) | ((s >> 1) ^ x1), as a table at bits 2s: 0xD8 (0, 2, 1,
  // 3) with x1 (bit 2s of the byte) flipping the low bit.
  template <int N>
  __device__ static void all(const uint32_t (&w)[N], int j, Map& m) {
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const uint32_t t = 0xD8u ^ ((w[j] >> (8 * k)) & 0x55u);
      uint32_t n = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) n |= ((t >> (2 * ((m >> (2 * e)) & 3u))) & 3u) << (2 * e);
      m = n;
    }
  }
};

// Bytes i = 0..3 of word q: the predecessor group of PR combined state
// u = 4q + i (u = s2*4 + h', pred0(s2) ^ x1 with x1 = u & 1), shifted left 2.
__host__ __device__ constexpr uint32_t pr_pred_bytes(int q) {
  uint32_t t = 0;
  for (int i = 0; i < 4; ++i) {
    const int u = 4 * q + i;
    t |= static_cast<uint32_t>((pred0(u >> 2) ^ (u & 1)) << 2) << (8 * i);
  }
  return t;
}

// The new states of the 4 map entries nibble-packed in m16 (16 bits) under
// a step's table tb (byte u of the 16 = the predecessor of state u): byte
// gathers by prmt from states m & 7 of each half of the table, then the
// half by bit 3; the 4 bytes packed back to nibbles.
__device__ __forceinline__ uint32_t pr_gather4(const uint32_t (&tb)[4], uint32_t m16) {
  const uint32_t sel = m16 & 0x7777u;
  const uint32_t lo = __byte_perm(tb[0], tb[1], sel);
  const uint32_t hi = __byte_perm(tb[2], tb[3], sel);
  const uint32_t r = __byte_perm(lo, hi, 0x3210u | ((m16 >> 1) & 0x4444u));
  return __byte_perm(r | (r >> 4), 0u, 0x4420u);   // bytes 0, 2 of r | r >> 4
}

// The 16-state PR trellis: a decision row is one step, 4 rows an output
// word. Entry e of a map sits at bits 4e..4e+3.
struct TbPr {
  using Map = uint64_t;
  static constexpr int kChunks = kPrTbChunks, kRowsPerWord = 4;
  static constexpr Map kIdentity = 0xFEDCBA9876543210ull;
  __device__ static Map constant(uint32_t s) { return s * 0x1111111111111111ull; }
  __device__ static uint32_t lookup(Map m, uint32_t e) {
    return static_cast<uint32_t>(m >> (4 * e)) & 15u;
  }
  __device__ static bool merged(Map m, uint32_t& s) {
    s = static_cast<uint32_t>(m) & 15u;
    return m == constant(s);
  }
  template <int N>
  __device__ static uint32_t chain(const uint32_t (&w)[N], int j, uint32_t& s) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const uint32_t h_prev = (w[4 * j + k] >> (2 * s)) & 3u;
      const uint32_t x1 = s & 1u;
      word |= (s & 3u) << (8 * k);                      // x1 | z2<<1
      const uint32_t s2 = s >> 2;
      const uint32_t pred = ((2u * (s2 & 1u)) | (s2 >> 1)) ^ x1;
      s = (pred << 2) | h_prev;
    }
    return word;
  }
  // every chain of the map over word j: a step's table of predecessors,
  // byte u = pred << 2 | the 2-bit pick of u (the row's 2-bit fields
  // spread to bytes), then 4 gathers of 4 entries
  template <int N>
  __device__ static void all(const uint32_t (&w)[N], int j, Map& m) {
    uint32_t lo = static_cast<uint32_t>(m), hi = static_cast<uint32_t>(m >> 32);
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      uint32_t tb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = (w[4 * j + k] >> (8 * q)) & 0xFFu;   // picks of states 4q..4q+3
        x = (x | (x << 12)) & 0x000F000Fu;
        x = (x | (x << 6)) & 0x03030303u;
        tb[q] = x | pr_pred_bytes(q);
      }
      lo = pr_gather4(tb, lo & 0xFFFFu) | (pr_gather4(tb, lo >> 16) << 16);
      hi = pr_gather4(tb, hi & 0xFFFFu) | (pr_gather4(tb, hi >> 16) << 16);
    }
    m = (static_cast<uint64_t>(hi) << 32) | lo;
  }
};

// Walks groups top - 1 down to bottom. While `merged` is false it carries
// every entry's chain in `map` and writes nothing; once all chains hold one
// state at a group's end it sets `merged` and goes on from that state `s`
// as one chain, writing each group's words. Returns the groups walked
// before that (the head).
template <class P>
__device__ __forceinline__ int walk(const int32_t* src, int32_t* out, size_t stride, int top,
                                    int bottom, bool& merged, uint32_t& s,
                                    typename P::Map& map) {
  constexpr int RW = P::kRowsPerWord, R = kWpg * RW;
  uint32_t w[R];
#pragma unroll
  for (int i = 0; i < R; ++i) w[i] = src[static_cast<size_t>((top - 1) * R + i) * stride];
  int head = 0;
#pragma unroll 1
  for (int g = top - 1; g >= bottom; --g) {
    const bool more = g > bottom;
    const int32_t* nxt = src + static_cast<size_t>(more ? g - 1 : g) * R * stride;
    auto refill = [&](int j) {  // once word j's rows are used: the next group's
      if (more) {
#pragma unroll
        for (int k = 0; k < RW; ++k)
          w[j * RW + k] = nxt[static_cast<size_t>(j * RW + k) * stride];
      }
    };
    if (merged) {
      int32_t* row = out + static_cast<size_t>(g) * kWpg * stride;
#pragma unroll
      for (int j = kWpg - 1; j >= 0; --j) {
        row[static_cast<size_t>(j) * stride] = static_cast<int32_t>(P::chain(w, j, s));
        refill(j);
      }
    } else {
#pragma unroll
      for (int j = kWpg - 1; j >= 0; --j) {
        P::all(w, j, map);
        refill(j);
      }
      ++head;
      merged = P::merged(map, s);
    }
  }
  return head;
}

// blockDim.x = kTbLanes * chunks, chunks = min(P::kChunks, groups)
template <class P>
__device__ __forceinline__ void chunked_traceback(const int32_t* __restrict__ dec,
                                                  const int32_t* __restrict__ start,
                                                  int32_t* __restrict__ bits, int groups,
                                                  int lanes) {
  using Map = typename P::Map;
  __shared__ Map s_map[P::kChunks][kTbLanes];   // each chunk's bottom state per entry
  __shared__ int s_head[P::kChunks][kTbLanes];
  const int chunks = blockDim.x / kTbLanes;
  const int c = threadIdx.x / kTbLanes, ln = threadIdx.x % kTbLanes;
  const int l = blockIdx.x * kTbLanes + ln;
  const bool valid = l < lanes, top_chunk = c == chunks - 1;
  const size_t stride = static_cast<size_t>(lanes);
  const int top = (c + 1) * groups / chunks, bottom = c * groups / chunks;
  const int32_t* src = dec + l;
  int32_t* out = bits + l;
  if (valid) {  // phase 1
    bool merged = top_chunk;
    uint32_t s = top_chunk ? static_cast<uint32_t>(start[l]) : 0u;
    Map map = P::kIdentity;
    s_head[c][ln] = walk<P>(src, out, stride, top, bottom, merged, s, map);
    s_map[c][ln] = merged ? P::constant(s) : map;
  }
  __syncthreads();
  if (!valid || top_chunk) return;
  uint32_t s = static_cast<uint32_t>(start[l]);  // phase 2
#pragma unroll 1
  for (int k = chunks - 1; k > c; --k) s = P::lookup(s_map[k][ln], s);
  bool merged = true;  // phase 3
  Map map = 0;
  walk<P>(src, out, stride, top, top - s_head[c][ln], merged, s, map);
}

__global__ void __launch_bounds__(kTbLanes * kTbChunks, tb_min_blocks(kTbChunks))
traceback_kernel(const int32_t* __restrict__ dec, const int32_t* __restrict__ start,
                 int32_t* __restrict__ bits, int groups, int lanes) {
  chunked_traceback<Tb4>(dec, start, bits, groups, lanes);
}

__global__ void __launch_bounds__(kTbLanes * kPrTbChunks, tb_min_blocks(kPrTbChunks))
pr_traceback_kernel(const int32_t* __restrict__ dec, const int32_t* __restrict__ start,
                    int32_t* __restrict__ bits, int groups, int lanes) {
  chunked_traceback<TbPr>(dec, start, bits, groups, lanes);
}

inline int tb_grid(int lanes) { return (lanes + kTbLanes - 1) / kTbLanes; }

inline int tb_threads(int groups, int chunks) {
  return kTbLanes * (groups < chunks ? groups : chunks);
}

inline bool bad_shape(int steps, int lanes) {
  return steps < kGroup || steps % kGroup != 0 || lanes < 1;
}

// The chunk-parallel near-MLSE (the JAX package's _chunked_mlse): each
// lane's T steps are cut into `chunks` kept regions of T / chunks steps,
// each decoded in a window of that plus kWarmup steps on either side,
// clamped inside [0, T) (so the first window has no left warm-up and the
// last a doubled one). A chunk-lane lc = c * L + l (chunk-major, so a
// warp's loads of one step are 32 consecutive lanes of one row) reads its
// window straight from the unchunked T-major obs at rows start(c) + p, and
// its traceback writes only its kept region into the unchunked (T/4, L)
// output: no window is ever gathered into memory. Three things differ from
// the exact kernels above:
// - the metrics are renormalized after every step (the reference's
//   per-step cadence; in float32 (a + b) - c is not (a - c) + b, so the
//   cadence is part of the numerics);
// - a window of W steps is rarely a multiple of 4: the 4-state decisions
//   are packed in words of 4 steps with pad = -W mod 4 steps in front,
//   which change no metric and carry zero bits. The tracebacks start at
//   the window's true last step; the front padding lies below every kept
//   region (chunk 0's starts at window step 0, padded step `pad`);
// - the PR pass reads rc at stream step start(c) + p.
constexpr int kWarmup = 128;   // context steps on either side (viterbi_bits' default)

struct ChunkPlan {
  int steps;    // T
  int lanes;    // L, the unchunked lanes
  int chunks;   // C
  int length;   // T / C, the kept steps of a chunk
  int window;   // W = length + 2 kWarmup
  __host__ __device__ int start(int c) const {
    const int s = c * length - kWarmup;
    return s < 0 ? 0 : (s > steps - window ? steps - window : s);
  }
  __host__ __device__ int offset(int c) const { return c * length - start(c); }
  __host__ __device__ int pad() const { return (4 - window % 4) % 4; }
  __host__ __device__ int64_t chunk_lanes() const {
    return static_cast<int64_t>(chunks) * lanes;
  }
};

inline bool bad_plan(const ChunkPlan& p) {
  return p.lanes < 1 || p.chunks < 1 || p.steps < 1 || p.steps % p.chunks != 0 ||
         p.window > p.steps;
}

inline ChunkPlan make_plan(int steps, int lanes, int chunks) {
  const int length = chunks > 0 ? steps / chunks : 0;
  return {steps, lanes, chunks, length, length + 2 * kWarmup};
}

inline int chunk_grid(const ChunkPlan& p, int threads) {
  return static_cast<int>((p.chunk_lanes() + threads - 1) / threads);
}

// The chunked 4-state passes: one thread per chunk-lane walks its whole
// window, all 4 states in registers, in blocks of one warp (at B = 1 the
// 288 chunk-lanes of C = 24 are 9 blocks on 9 SMs; at B = 384, 3,456).
//
// Forward (acs_forward_chunked_kernel): a step is acs4_step and nothing
// else. The padded front word is peeled off; whole groups of
// kAcsChunkWords words follow with no bounds test, each group's
// observations loaded one group ahead into registers through a pointer
// advanced a row a step; then the last words one at a time. A step's
// decision byte is put together from masks (the x1 bits of the four
// survivors, and the step's Z2 bits for x1 = 0 and 1), not bit by bit.
// What bounds it is issue: the loop is 66 instructions a step in float32
// and 70 in int8 (cuobjdump -sass; 28 FADD/FMUL, 11 FMNMX, 8 FSETP, 8 SEL,
// the rest masks, the load and its address), against ~100 for the form
// with a bounds test, a padding test and a 64-bit row multiply in every
// step. Measured on an H100 at B = 384, C = 24 (tools/torch_kernel_ab.py
// --kernels chunked): 0.38 ms against 0.57, the bytes bound 0.16. Tried
// and slower: an L2 prefetch of the float32 rows (it only adds issue),
// groups of 2 words, and the x1 / Z2 bits as float sign bits (an add and
// a multiply-high in place of a compare and a select: 4 more instructions
// a step, 13 % slower). A state-parallel form (2 threads per chunk-lane,
// the exact pass's butterfly) needs ~40 instructions a step per thread,
// ~80 per chunk-lane, and a shuffle on each step's chain.
//
// Traceback (traceback_chunked_kernel): the walk runs over output words in
// stream order. Stream steps 4j..4j+3 are window decision steps q = 4j +
// base + k (base = pad - start(c)), so their 4 decision bytes are one
// funnel shift of two consecutive decision words by 8 (base mod 4); each
// output word is then one chain4x of that word, built in a register and
// stored whole. Only a kept region's boundary words, which two
// chunk-lanes share when T / C is not a multiple of 4, are stored byte by
// byte, and a partial word at the window's top or the kept region's
// bottom is walked step by step. kTbChunkWords decision words are loaded
// ahead into registers, each refilled with the word kTbChunkWords below
// as soon as it is used. Measured as above: 0.10 ms against 0.27 (the
// form that loaded each word when the walk reached it and stored a byte a
// step), the bytes bound 0.064; 24 instructions a step. At B = 1 both
// passes are chains of ~1,000 steps on 9 warps (0.07-0.09 and 0.04-0.07
// ms), under the host's time for the rest of a B = 1 decode step.
constexpr int kChunk4Threads = 32;   // threads per block of the chunked 4-state passes
constexpr int kAcsChunkWords = 4;    // forward: decision words a group of loads covers
constexpr int kTbChunkWords = 8;     // traceback: decision words in flight
constexpr int kChunkThreads = 64;    // threads per block of the chunked PR passes

// One step of all four states from observation o, renormalized: returns
// the step's decision byte (bits 2s, 2s+1 = x1, z2 into state s). The
// float ops are branches() and survivor()'s, in the reference's order.
__device__ __forceinline__ uint32_t acs4_step(float o, float (&m)[4]) {
  float d[8];  // d[v] = (o - level v)^2
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float t = __fsub_rn(o, static_cast<float>(2 * v - 7) + kPilot);
    d[v] = __fmul_rn(t, t);
  }
  // branch j = 2 x1 + b: p[j] the Z2-resolved minimum, its Z2 bit at bit
  // 2s + 1 of every state s = 2a + b it feeds (0x22 for b = 0, 0x88 for 1)
  float p[4];
  uint32_t z[2] = {0, 0};  // by x1
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = fminf(d[j], d[j + 4]);
    z[j >> 1] |= d[j + 4] < d[j] ? (j & 1 ? 0x88u : 0x22u) : 0u;
  }
  float nm[4];
  uint32_t x = 0;  // x1 of state s at bit 2s
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // s = 2a + b: predecessors 2b + a, 2b + 1 - a
    const int a = s >> 1, b = s & 1;
    const float c0 = __fadd_rn(m[2 * b + a], p[b]), c1 = __fadd_rn(m[2 * b + 1 - a], p[2 + b]);
    x |= c1 < c0 ? 1u << (2 * s) : 0u;
    nm[s] = fminf(c0, c1);
  }
  const float mn = fminf(fminf(nm[0], nm[1]), fminf(nm[2], nm[3]));
#pragma unroll
  for (int s = 0; s < 4; ++s) m[s] = __fsub_rn(nm[s], mn);
  const uint32_t x2 = x << 1;
  return x | (x2 & z[1]) | (~x2 & z[0]);
}

// decisions (ceil(W / 4), C L) int32 in the exact pass's word layout
template <typename T>
__global__ void __launch_bounds__(kChunk4Threads)
acs_forward_chunked_kernel(const T* __restrict__ obs, const float* __restrict__ m_in,
                           int32_t* __restrict__ dec, float* __restrict__ m_out,
                           ChunkPlan plan, float inv) {
  constexpr int S = 4 * kAcsChunkWords;   // steps a group
  const int64_t lc = static_cast<int64_t>(blockIdx.x) * kChunk4Threads + threadIdx.x;
  const int64_t n = plan.chunk_lanes();
  if (lc >= n) return;
  const int c = static_cast<int>(lc / plan.lanes), l = static_cast<int>(lc % plan.lanes);
  const size_t stride = static_cast<size_t>(plan.lanes);
  float m[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) m[s] = m_in[s * n + lc];
  const int pad = plan.pad(), words = (plan.window + pad) / 4;
  const T* src = obs + static_cast<size_t>(plan.start(c)) * stride + l;   // the next row
  int32_t* out = dec + lc;
  // word 0: pad inert steps (no update, zero bits), then window steps 0 .. 3 - pad
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < pad) continue;
    word |= acs4_step(load_obs(*src, inv), m) << (8 * k);
    src += stride;
  }
  *out = static_cast<int32_t>(word);
  out += n;
  // words 1 .. words - 1: whole groups, the next group's rows in registers
  const int groups = (words - 1) / kAcsChunkWords;
  T cur[S], nxt[S];
  auto fetch = [&](T (&buf)[S]) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      buf[i] = *src;
      src += stride;
    }
  };
  if (groups > 0) fetch(cur);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups) fetch(nxt);
#pragma unroll
    for (int j = 0; j < kAcsChunkWords; ++j) {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) w |= acs4_step(load_obs(cur[4 * j + k], inv), m) << (8 * k);
      *out = static_cast<int32_t>(w);
      out += n;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) cur[i] = nxt[i];
  }
  // the last (words - 1) mod kAcsChunkWords words
#pragma unroll 1
  for (int i = 1 + groups * kAcsChunkWords; i < words; ++i) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w |= acs4_step(load_obs(*src, inv), m) << (8 * k);
      src += stride;
    }
    *out = static_cast<int32_t>(w);
    out += n;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) m_out[s * n + lc] = m[s];
}

// The doubled predecessor table of a decision byte: bits 2s+1, 2s+2 hold
// 2 pred(s), pred(s) = ((s & 1) << 1) | ((s >> 1) ^ x1 of s), so the state
// before a step is (pred2(byte) >> u) & 6 for the doubled state u = 2s
// after it (Tb4::all's 0xD8 table, shifted left once).
__device__ __forceinline__ uint32_t pred2(uint32_t byte) { return ((byte & 0x55u) ^ 0xD8u) << 1; }

// One chain of the 4-state traceback over a word w of 4 decision bytes,
// last step first, from the doubled state u: the output word (byte k =
// x1 | z2<<1 of step k); u becomes the doubled state before the word. Two
// dependent instructions a step (a shift and a mask).
__device__ __forceinline__ uint32_t chain4x(uint32_t w, uint32_t& u) {
  const uint32_t v = (w & 0x55555555u) ^ 0xD8D8D8D8u;   // pred2 of every byte, unshifted
  uint32_t word = 0;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const uint32_t vk = k ? v >> (8 * k - 1) : v << 1;   // byte k's table at bits 1..8
    word += ((w >> (8 * k) >> u) & 3u) << (8 * k);
    u = (vk >> u) & 6u;
  }
  return word;
}

// Bytes lo..hi (stream steps, one word) of an output word.
__device__ __noinline__ void store_bytes(int32_t* at, uint32_t word, int lo, int hi) {
  uint8_t* ob = reinterpret_cast<uint8_t*>(at);
  for (int t = lo; t <= hi; ++t) ob[t & 3] = static_cast<uint8_t>(word >> (8 * (t & 3)));
}

// The chunked 4-state traceback: chunk-lane lc walks its window from
// `start` at its last step down to its kept region's first, writing the
// kept steps' x1 | z2<<1 bytes into lane l's column of the (T/4, L) output
// (byte k of word j = stream step 4j + k).
__global__ void __launch_bounds__(kChunk4Threads)
traceback_chunked_kernel(const int32_t* __restrict__ dec, const int32_t* __restrict__ start,
                         int32_t* __restrict__ bits, ChunkPlan plan) {
  constexpr int G = kTbChunkWords;
  const int64_t lc = static_cast<int64_t>(blockIdx.x) * kChunk4Threads + threadIdx.x;
  const int64_t n = plan.chunk_lanes();
  if (lc >= n) return;
  const int c = static_cast<int>(lc / plan.lanes), l = static_cast<int>(lc % plan.lanes);
  const int t0 = c * plan.length, t1 = t0 + plan.length;   // the kept stream steps [t0, t1)
  const int row0 = plan.start(c);
  const int base = plan.pad() - row0;     // stream step t is decision step t + base
  const int e = base >> 2, r = base & 3;  // floor(base / 4), base mod 4
  const int32_t* dcol = dec + lc;         // decision word i at dcol[i n]
  int32_t* ocol = bits + l;               // output word j at ocol[j L]
  const int64_t lanes = plan.lanes;
  // output word j's kept bytes, for a word at a window's or kept region's edge
  auto emit_edge = [&](int j, uint32_t word) {
    const int lo = max(4 * j, t0), hi = min(4 * j + 3, t1 - 1);
    if (hi - lo == 3)
      ocol[j * lanes] = static_cast<int32_t>(word);
    else if (lo <= hi)
      store_bytes(ocol + j * lanes, word, lo, hi);
  };
  // stream steps hi_t down to lo_t of one output word, step by step
  uint32_t u = 2u * static_cast<uint32_t>(start[lc]);   // the doubled state
  auto partial = [&](int hi_t, int lo_t) {
    uint32_t word = 0;
    for (int t = hi_t; t >= lo_t; --t) {
      const int q = t + base;
      const uint32_t byte = static_cast<uint32_t>(dcol[(q >> 2) * n]) >> (8 * (q & 3));
      word |= ((byte >> u) & 3u) << (8 * (t & 3));
      u = (pred2(byte & 0xFFu) >> u) & 6u;
    }
    return word;
  };
  int t = row0 + plan.window - 1;   // the next stream step to walk
  if ((t & 3) != 3) {               // a partial word at the window's top
    const int lo = max(t & ~3, t0);
    emit_edge(t >> 2, partial(t, lo));
    t = lo - 1;
  }
  // whole words jhi down to jlo: word j's decision bytes are those of
  // decision words j + e (lo) and j + e + 1 (hi) shifted right by 8r
  const int jhi = (t + 1) / 4 - 1, jlo = (t0 + 3) >> 2;
  if (t >= t0 && jhi >= jlo) {
    const int jk = t1 >> 2;           // words below jk lie whole in the kept region
    uint32_t hi = r ? static_cast<uint32_t>(dcol[(jhi + e + 1) * n]) : 0u;
    uint32_t buf[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      buf[g] = jhi - g >= jlo ? static_cast<uint32_t>(dcol[(jhi - g + e) * n]) : 0u;
    int64_t next = (jhi + e - G) * n;  // the word refilled after the next one is used
    int32_t* o = ocol + jhi * lanes;
#pragma unroll 1
    for (int j0 = jhi; j0 >= jlo; j0 -= G) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 - g;
        if (j < jlo) break;
        const uint32_t lo = buf[g];
        if (j - G >= jlo) buf[g] = static_cast<uint32_t>(dcol[next]);
        next -= n;
        const uint32_t word = chain4x(__funnelshift_r(lo, hi, 8 * r), u);
        hi = lo;
        if (j < jk)
          *o = static_cast<int32_t>(word);
        else
          emit_edge(j, word);   // above the kept region, or its top boundary word
        o -= lanes;
      }
    }
    t = 4 * jlo - 1;
  }
  if (t >= t0)                      // a partial word at the kept region's bottom
    emit_edge(t >> 2, partial(t, t0));
}

// The chunked PR passes: every thread of a chunk-lane walks its whole
// window, in blocks of kChunkThreads threads.
//
// Forward (pr_acs_forward_chunked_kernel): T threads a chunk-lane (T = 1,
// 2 or 4, pr_lane_threads), the 16 states split by s2 into groups of the 4
// h'. New group s2 reads only predecessor groups pred0(s2) (its even h',
// x1 = 0) and pred0(s2) ^ 1 (odd h'): groups {0, 2} read {0, 1}, groups
// {1, 3} read {2, 3}, and a group's delayed reference levels depend only
// on its parity (pr_level). A step is four pr_group calls:
// - T = 1: the thread runs all four, the levels as immediates;
// - T = 2: thread b runs new groups 3b ("kept", from its own old group K
//   and the received R) and 2 - b ("sent", from R and K); it keeps the
//   kept one and sends the other, with its half minimum, by 5 xor shuffles
//   a step, each thread renormalizing what it holds (K = g0 / g3, R = g1 /
//   g2), so no value is chosen by a select;
// - T = 4: quad lane q = 2p + j runs one group (j = 0: kept of pair p,
//   j = 1: sent), fetching its two predecessor groups by 8 indexed shuffles
//   of the raw metrics and the minimum by 2 xor shuffles.
// The obs and rc of kPrGroupSteps T steps are loaded one group ahead into
// registers through row pointers; a warp with no reset step in a group
// runs it with the reference levels as they are, one with a reset step
// selects the sync level per step (8 selects). The two pair compares and
// the pick (c1 < c0, c3 < c2, m23 < m01) are the sign bits of three FADDs,
// shifted into the decision word a bit per funnel shift: the compares run
// on the FMA pipe, and the ALU pipe (half rate) keeps the minima and the
// shifts (compares and ORs under their predicates, one instruction fewer
// a state all on the ALU pipe, ran 7 % slower at C = 24). What bounds it is issue: the float ops are fixed (248 a step in
// the reference's order, no FMA, and the per-step renormalization's 15
// FMNMX and 16 FSUB) and the loop is 397 instructions a chunk-lane step at
// T = 1 (cuobjdump -sass; 213 a thread at T = 2, 130 at T = 4), against
// 409 for the form with 64 reset selects and a 64-bit row multiply a step.
// Measured on an H100 at B = 384 (tools/torch_kernel_ab.py --kernels
// chunked): C = 24, T = 1, 1.82 ms against 2.19, at 89 % of one
// instruction a cycle on the busiest schedulers (7 warps each of the
// 3,456); C = 8, T = 2, 1.90 against 2.54 (2.07 at T = 1); C = 2, T = 4,
// 2.76 against 6.16; at B = 1 T = 4 is 2.5-2.8x T = 1 (C = 24: 0.13
// against 0.35 ms, the parent 0.40). Groups of 2T steps keep a group's code near 800 instructions a
// thread: at T = 1 groups of 4 steps took 1.89 ms at C = 24, of 8 (96
// registers, not all warps resident) 2.78.
//
// Traceback (pr_traceback_chunked_kernel): the walk runs over output words
// in stream order, each a 4-step chain (pr_chain4) over the words of its 4
// steps, built in a register and stored whole. kPrTbAhead decision words
// are in flight as cp.async copies into a ring of output words in shared
// memory (this thread's column; each word's copies one group), the slots of
// a word refilled as soon as they are read. Only a kept region's boundary
// words, which two chunk-lanes share when T / C is not a multiple of 4, are
// stored byte by byte, and a partial word at the window's top or the kept
// region's bottom is walked step by step. Measured as above: C = 24, 0.21
// ms against 0.52 (the bytes bound 0.165); C = 2, 0.35 against 4.30, where
// 8 words loaded ahead into registers took 0.95 (16 and 32 words in
// registers were slower still).
constexpr int kPrLaneThreads = 0;    // forward: threads a chunk-lane, 0: chosen from C L
constexpr int kPrGroupSteps = 2;     // forward: steps a register group, per thread a chunk-lane
constexpr int kPrTbAhead = 32;       // traceback: decision words in flight

// E_b[h] = 4h + 2b - 7: the level that h' = h emits in a group of parity b,
// and the delayed reference level of hypothesis h of a predecessor group
// of parity b
__device__ __forceinline__ float pr_level(int b, int h) {
  return static_cast<float>(4 * h + 2 * b - 7);
}

// One group: the new metrics n[h'] of the 4 states h' of one s2 from the
// predecessor groups x0 (x1 = 0: h' = 0, 2) and x1 (x1 = 1: h' = 1, 3),
// with their reference levels e0, e1 and a[h'] = obs - the level h' emits.
// Shifts the group's 8 decision bits into bits from below (bits 2h', 2h'+1
// = the pick of h'). c1 - c0 is negative exactly when c1 < c0 (finite
// candidates, never -0: x + t*t rounds -0 + +0 to +0), so its sign bit is
// the strict compare.
__device__ __forceinline__ void pr_group(const float (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4], const float (&e0)[4],
                                         const float (&e1)[4], float (&n)[4], uint32_t& bits) {
#pragma unroll
  for (int h1 = 3; h1 >= 0; --h1) {
    const float (&x)[4] = h1 & 1 ? x1 : x0;
    const float (&e)[4] = h1 & 1 ? e1 : e0;
    float c[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float tt = __fadd_rn(a[h1], e[h]);
      c[h] = __fadd_rn(x[h], __fmul_rn(tt, tt));
    }
    const float m01 = fminf(c[0], c[1]), m23 = fminf(c[2], c[3]);
    const uint32_t d01 = __float_as_uint(__fsub_rn(c[1], c[0]));
    const uint32_t d23 = __float_as_uint(__fsub_rn(c[3], c[2]));
    const uint32_t dp = __float_as_uint(__fsub_rn(m23, m01));
    n[h1] = fminf(m01, m23);
    bits = __funnelshift_l(dp, bits, 1);                        // pick = m23 < m01
    bits = __funnelshift_l((dp & d23) | (~dp & d01), bits, 1);  // pick ? c3 < c2 : c1 < c0
  }
}

// The reference levels of a step: pe[b][h] = E_b[h], or the sync level on a
// reset step (kReset only)
template <bool kReset>
__device__ __forceinline__ void pr_refs(const float (&lv)[2][4], bool rst, float sync,
                                        float (&pe)[2][4]) {
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int h = 0; h < 4; ++h) pe[b][h] = kReset && rst ? sync : lv[b][h];
}

__device__ __forceinline__ float min4(const float (&v)[4]) {
  return fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
}

// What one thread of a chunk-lane holds between steps, per T; step() runs
// one step and returns its decision word (bits 2u, 2u+1 = the pick of state
// u), whole in every thread of the chunk-lane.
template <int T>
struct PrLane;

template <>
struct PrLane<1> {
  float m[4][4];   // by group s2, then h'
  __device__ PrLane(int, const float* m_in, int64_t n, int64_t lc) {
#pragma unroll
    for (int u = 0; u < 16; ++u) m[u >> 2][u & 3] = m_in[u * n + lc];
  }
  template <bool kReset>
  __device__ __forceinline__ uint32_t step(float o, bool rst, float sync) {
    float lv[2][4], pe[2][4], a[2][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        lv[b][h] = pr_level(b, h);
        a[b][h] = __fsub_rn(o, lv[b][h]);
      }
    pr_refs<kReset>(lv, rst, sync, pe);
    float nm[4][4];
    uint32_t word = 0;   // the groups' bits, s2 = 3 first
#pragma unroll
    for (int s2 = 3; s2 >= 0; --s2) {
      const int sp = pred0(s2);
      pr_group(a[s2 & 1], m[sp], m[sp ^ 1], pe[sp & 1], pe[(sp & 1) ^ 1], nm[s2], word);
    }
    const float mn = fminf(fminf(min4(nm[0]), min4(nm[1])), fminf(min4(nm[2]), min4(nm[3])));
#pragma unroll
    for (int s2 = 0; s2 < 4; ++s2)
#pragma unroll
      for (int h = 0; h < 4; ++h) m[s2][h] = __fsub_rn(nm[s2][h], mn);
    return word;
  }
  __device__ void store(float* m_out, int64_t n, int64_t lc) const {
#pragma unroll
    for (int u = 0; u < 16; ++u) m_out[u * n + lc] = m[u >> 2][u & 3];
  }
};

// Thread b: K = old group 3b, R = old group 1 + b; new group 3b (kept) from
// x1 = 0: K, x1 = 1: R, new group 2 - b (sent) from x1 = 0: R, x1 = 1: K.
// K's reference levels are E_b, R's E_(1-b), the emitted ones E_b.
template <>
struct PrLane<2> {
  float k[4], r[4];
  float lv[2][4];   // E_b, E_(1-b)
  uint32_t sel;     // __byte_perm: the kept group's byte to 3b, the sent one's to 2 - b
  int b;
  __device__ PrLane(int q, const float* m_in, int64_t n, int64_t lc) : b(q) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      k[h] = m_in[(12 * b + h) * n + lc];
      r[h] = m_in[(4 + 4 * b + h) * n + lc];
      lv[0][h] = pr_level(b, h);
      lv[1][h] = pr_level(1 - b, h);
    }
    sel = b ? 0x0141u : 0x1410u;
  }
  template <bool kReset>
  __device__ __forceinline__ uint32_t step(float o, bool rst, float sync) {
    float pe[2][4], a[4], kept[4], sent[4];
    pr_refs<kReset>(lv, rst, sync, pe);
#pragma unroll
    for (int h = 0; h < 4; ++h) a[h] = __fsub_rn(o, lv[0][h]);
    uint32_t bk = 0, bs = 0;
    pr_group(a, k, r, pe[0], pe[1], kept, bk);
    pr_group(a, r, k, pe[1], pe[0], sent, bs);
    const float half = fminf(min4(kept), min4(sent));
    const float mn = fminf(half, __shfl_xor_sync(kFull, half, 1));
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      r[h] = __fsub_rn(__shfl_xor_sync(kFull, sent[h], 1), mn);
      k[h] = __fsub_rn(kept[h], mn);
    }
    const uint32_t part = __byte_perm(bk, bs, sel);
    return part | __shfl_xor_sync(kFull, part, 1);
  }
  __device__ void store(float* m_out, int64_t n, int64_t lc) const {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      m_out[(12 * b + h) * n + lc] = k[h];
      m_out[(4 + 4 * b + h) * n + lc] = r[h];
    }
  }
};

// Quad lane q = 2p + j runs new group g(q) = j ? 2 - p : 3p (0, 2, 3, 1)
// from x0 = j ? R_p : K_p and x1 = the other, K_p = old group 3p (quad lane
// 2p's) and R_p = old group 1 + p (quad lane 3 - 2p's); x0's reference
// levels are E_(p^j), x1's E_(1-(p^j)), the emitted ones E_p.
template <>
struct PrLane<4> {
  float x0[4], x1[4], own[4], mn;
  float lv[4], e[2][4];
  int src0, src1, g;
  __device__ PrLane(int q, const float* m_in, int64_t n, int64_t lc) {
    const int p = q >> 1, j = q & 1;
    src0 = j ? 3 - 2 * p : 2 * p;
    src1 = j ? 2 * p : 3 - 2 * p;
    g = j ? 2 - p : 3 * p;
    const int g0 = j ? 1 + p : 3 * p, g1 = j ? 3 * p : 1 + p;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      x0[h] = m_in[(4 * g0 + h) * n + lc];
      x1[h] = m_in[(4 * g1 + h) * n + lc];
      own[h] = 0.0f;
      lv[h] = pr_level(p, h);
      e[0][h] = pr_level(p ^ j, h);
      e[1][h] = pr_level(1 - (p ^ j), h);
    }
    mn = 0.0f;
  }
  template <bool kReset>
  __device__ __forceinline__ uint32_t step(float o, bool rst, float sync) {
    float pe[2][4], a[4];
    pr_refs<kReset>(e, rst, sync, pe);
#pragma unroll
    for (int h = 0; h < 4; ++h) a[h] = __fsub_rn(o, lv[h]);
    uint32_t bits = 0;
    pr_group(a, x0, x1, pe[0], pe[1], own, bits);
    float m = min4(own);
    m = fminf(m, __shfl_xor_sync(kFull, m, 1));
    mn = fminf(m, __shfl_xor_sync(kFull, m, 2));
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      x0[h] = __fsub_rn(__shfl_sync(kFull, own[h], src0, 4), mn);
      x1[h] = __fsub_rn(__shfl_sync(kFull, own[h], src1, 4), mn);
    }
    uint32_t part = bits << (8 * g);
    part |= __shfl_xor_sync(kFull, part, 1);
    return part | __shfl_xor_sync(kFull, part, 2);
  }
  __device__ void store(float* m_out, int64_t n, int64_t lc) const {
#pragma unroll
    for (int h = 0; h < 4; ++h) m_out[(4 * g + h) * n + lc] = __fsub_rn(own[h], mn);
  }
};

// decisions (W, C L) int32 in the exact pass's layout; thread q of
// chunk-lane lc is thread T lc + q, and stores the decision words of the
// steps p with p mod T = q. Threads past the last chunk-lane in a warp that
// holds one run along (the shuffles take the whole warp) and store nothing.
template <int T>
__global__ void __launch_bounds__(kChunkThreads)
pr_acs_forward_chunked_kernel(const float* __restrict__ obs, const int32_t* __restrict__ rc,
                              const float* __restrict__ m_in, int32_t* __restrict__ dec,
                              float* __restrict__ m_out, ChunkPlan plan) {
  constexpr int G = kPrGroupSteps * T;   // steps a register group
  static_assert(kChunkThreads % 32 == 0, "whole warps");
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kChunkThreads + threadIdx.x;
  const int64_t n = plan.chunk_lanes();
  if ((tid - threadIdx.x % 32) / T >= n) return;   // the whole warp lies past the end
  const int q = static_cast<int>(tid % T);
  const bool valid = tid / T < n;
  const int64_t lc = valid ? tid / T : n - 1;
  const int c = static_cast<int>(lc / plan.lanes), l = static_cast<int>(lc % plan.lanes);
  const size_t stride = static_cast<size_t>(plan.lanes);
  const int row0 = plan.start(c);
  const float* src = obs + static_cast<size_t>(row0) * stride + l;   // the next row
  const int32_t* rsrc = rc + static_cast<size_t>(row0) * 12 + l % 12;
  int32_t* out = dec + lc;
  PrLane<T> lane(q, m_in, n, lc);
  auto put = [&](int p, uint32_t word) {
    if (valid && p % T == q) *out = static_cast<int32_t>(word);
    out += n;
  };
  float o_cur[G], o_nxt[G];
  int32_t r_cur[G], r_nxt[G];
  auto fetch = [&](float (&o)[G], int32_t (&r)[G]) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      o[i] = *src;
      r[i] = rsrc[12 * i];
      src += stride;
    }
    rsrc += 12 * G;
  };
  const int groups = plan.window / G;
  if (groups > 0) fetch(o_cur, r_cur);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups) fetch(o_nxt, r_nxt);
    int32_t any = 0;
#pragma unroll
    for (int i = 0; i < G; ++i) any |= r_cur[i];
    if (__any_sync(kFull, any & 1)) {   // a reset step in the warp's group
#pragma unroll
      for (int i = 0; i < G; ++i)
        put(g * G + i,
            lane.template step<true>(o_cur[i], r_cur[i] & 1, (r_cur[i] >> 1) == 1 ? 5.0f : -5.0f));
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) put(g * G + i, lane.template step<false>(o_cur[i], false, 0.0f));
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      o_cur[i] = o_nxt[i];
      r_cur[i] = r_nxt[i];
    }
  }
#pragma unroll 1
  for (int p = groups * G; p < plan.window; ++p) {   // the last W mod G steps
    const int32_t r = *rsrc;
    put(p, lane.template step<true>(*src, r & 1, (r >> 1) == 1 ? 5.0f : -5.0f));
    src += stride;
    rsrc += 12;
  }
  if (valid) lane.store(m_out, n, lc);
}

// Threads a chunk-lane of the chunked PR forward pass for n chunk-lanes:
// kPrLaneThreads where it is set, else 4 up to kPrSplit4 (B = 1 at any C,
// B = 384 at C = 2: one thread a chunk-lane leaves schedulers idle), 2 up
// to kPrSplit2 (B = 384 at C = 8), then 1, which issues the fewest
// instructions a chunk-lane (B = 384 at C = 24 and 92).
constexpr int64_t kPrSplit4 = 9216, kPrSplit2 = 65536;   // chunk-lanes

inline int pr_lane_threads(int64_t n) {
  if (kPrLaneThreads > 0) return kPrLaneThreads;
  return n <= kPrSplit4 ? 4 : n <= kPrSplit2 ? 2 : 1;
}

// The PR predecessor groups as a table at bits 2s: pred0(s >> 2) ^ (s & 1)
// for combined state s = 4 s2 + h'.
__host__ __device__ constexpr uint32_t pr_pred_table() {
  uint32_t t = 0;
  for (int s = 0; s < 16; ++s) t |= static_cast<uint32_t>(pred0(s >> 2) ^ (s & 1)) << (2 * s);
  return t;
}

// A 4-byte copy from global to shared memory that holds no register while
// it is in flight (cp.async), its commit and the wait for all but the N
// newest groups of this thread's copies.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One PR traceback step from the doubled state u = 2s (s the combined
// state at the step) and the step's decision word w: the doubled state
// before it, 2 (pred << 2 | the pick of s).
__device__ __forceinline__ uint32_t pr_back(uint32_t w, uint32_t u) {
  return (((pr_pred_table() >> u) & 3u) << 3) | (((w >> u) & 3u) << 1);
}

// One chain over the words w[3], w[2], w[1], w[0] of 4 steps, last step
// first, from the doubled state u: the output word (byte k = x1 | z2<<1 =
// s & 3 at step k); u becomes the doubled state before step 0.
__device__ __forceinline__ uint32_t pr_chain4(const uint32_t (&w)[4], uint32_t& u) {
  uint32_t v[4];
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    v[k] = u;
    u = pr_back(w[k], u);
  }
  const uint32_t lo = __byte_perm(v[0], v[1], 0x0040u), hi = __byte_perm(v[2], v[3], 0x0040u);
  return (__byte_perm(lo, hi, 0x5410u) >> 1) & 0x03030303u;
}

// The chunked PR traceback: chunk-lane lc walks its window from `start` at
// its last step down to its kept region's first, writing the kept steps'
// x1 | z2<<1 bytes into lane l's column of the (T/4, L) output (byte k of
// word j = stream step 4j + k); stream step t is decision row t - start(c).
__global__ void __launch_bounds__(kChunkThreads)
pr_traceback_chunked_kernel(const int32_t* __restrict__ dec, const int32_t* __restrict__ start,
                            int32_t* __restrict__ bits, ChunkPlan plan) {
  constexpr int GW = kPrTbAhead / 4;   // output words in flight
  static_assert(kPrTbAhead % 4 == 0, "whole output words");
  __shared__ uint32_t ring[GW][4][kChunkThreads];
  const int64_t lc = static_cast<int64_t>(blockIdx.x) * kChunkThreads + threadIdx.x;
  const int64_t n = plan.chunk_lanes();
  if (lc >= n) return;
  const int c = static_cast<int>(lc / plan.lanes), l = static_cast<int>(lc % plan.lanes);
  const int t0 = c * plan.length, t1 = t0 + plan.length;   // the kept stream steps [t0, t1)
  const int row0 = plan.start(c);
  const int32_t* dcol = dec + lc;   // stream step t at dcol[(t - row0) n]
  int32_t* ocol = bits + l;         // output word j at ocol[j L]
  const int64_t lanes = plan.lanes;
  auto emit_edge = [&](int j, uint32_t word) {   // word j's kept bytes
    const int lo = max(4 * j, t0), hi = min(4 * j + 3, t1 - 1);
    if (hi - lo == 3)
      ocol[j * lanes] = static_cast<int32_t>(word);
    else if (lo <= hi)
      store_bytes(ocol + j * lanes, word, lo, hi);
  };
  uint32_t u = 2u * static_cast<uint32_t>(start[lc]);   // the doubled state
  auto partial = [&](int hi_t, int lo_t) {   // steps hi_t down to lo_t of one word
    uint32_t word = 0;
    for (int t = hi_t; t >= lo_t; --t) {
      word |= ((u >> 1) & 3u) << (8 * (t & 3));
      u = pr_back(static_cast<uint32_t>(dcol[(t - row0) * n]), u);
    }
    return word;
  };
  int t = row0 + plan.window - 1;   // the next stream step to walk
  if ((t & 3) != 3) {               // a partial word at the window's top
    const int lo = max(t & ~3, t0);
    emit_edge(t >> 2, partial(t, lo));
    t = lo - 1;
  }
  // whole words jhi down to jlo, word j's step 4j + k copied into ring[j mod
  // GW][k] of this thread GW words ahead
  const int jhi = (t + 1) / 4 - 1, jlo = (t0 + 3) >> 2;
  if (t >= t0 && jhi >= jlo) {
    const int jk = t1 >> 2;           // words below jk lie whole in the kept region
    uint32_t* col = &ring[0][0][threadIdx.x];
    auto fetch = [&](int j) {         // word j's rows, one copy group (empty below jlo)
      if (j >= jlo) {
        const int32_t* src = dcol + (4 * j - row0) * n;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          cp_async4(col + ((j % GW) * 4 + k) * kChunkThreads, src + k * n);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < GW; ++i) fetch(jhi - i);
    int32_t* o = ocol + jhi * lanes;
#pragma unroll 1
    for (int j = jhi; j >= jlo; --j) {
      cp_async_wait<GW - 1>();        // word j's group is in
      const uint32_t* r = col + (j % GW) * 4 * kChunkThreads;
      const uint32_t w[4] = {r[0], r[kChunkThreads], r[2 * kChunkThreads], r[3 * kChunkThreads]};
      const uint32_t word = pr_chain4(w, u);
      fetch(j - GW);                  // into the slots just read
      if (j < jk)
        *o = static_cast<int32_t>(word);
      else
        emit_edge(j, word);   // above the kept region, or its top boundary word
      o -= lanes;
    }
    t = 4 * jlo - 1;
  }
  if (t >= t0)                      // a partial word at the kept region's bottom
    emit_edge(t >> 2, partial(t, t0));
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
  const int groups = words / kWpg;
  traceback_kernel<<<tb_grid(lanes), tb_threads(groups, kTbChunks), 0,
                     static_cast<cudaStream_t>(stream)>>>(dec, start, bits, groups, lanes);
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
  const int groups = steps / kGroup;
  pr_traceback_kernel<<<tb_grid(lanes), tb_threads(groups, kPrTbChunks), 0,
                        static_cast<cudaStream_t>(stream)>>>(dec, start, bits, groups, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The chunked instantiations (ChunkPlan above): obs (T, L) float32 or int8
// codes; m_in, m_out: (4, C L) float32, chunk-lane c L + l; dec:
// (ceil(W / 4), C L) int32.
int atsc_acs_forward_chunked(int device, const void* obs, int obs_i8, const float* m_in,
                             int32_t* dec, float* m_out, int steps, int lanes, int chunks,
                             float inv, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  if (bad_plan(plan)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (obs_i8)
    acs_forward_chunked_kernel<int8_t><<<chunk_grid(plan, kChunk4Threads), kChunk4Threads, 0, st>>>(
        static_cast<const int8_t*>(obs), m_in, dec, m_out, plan, inv);
  else
    acs_forward_chunked_kernel<float><<<chunk_grid(plan, kChunk4Threads), kChunk4Threads, 0, st>>>(
        static_cast<const float*>(obs), m_in, dec, m_out, plan, inv);
  return static_cast<int>(cudaGetLastError());
}

// dec: (ceil(W / 4), C L) int32; start: (C L,) int32; bits: (T/4, L) int32,
// every byte written once (the kept regions tile [0, T)).
int atsc_traceback_chunked(int device, const int32_t* dec, const int32_t* start, int32_t* bits,
                           int steps, int lanes, int chunks, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  if (bad_plan(plan) || steps % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  traceback_chunked_kernel<<<chunk_grid(plan, kChunk4Threads), kChunk4Threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(dec, start, bits, plan);
  return static_cast<int>(cudaGetLastError());
}

// obs: (T, L) float32; rc: (T, 12) int32; m_in, m_out: (16, C L) float32;
// dec: (W, C L) int32.
int atsc_pr_acs_forward_chunked(int device, const float* obs, const int32_t* rc,
                                const float* m_in, int32_t* dec, float* m_out, int steps,
                                int lanes, int chunks, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  if (bad_plan(plan)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lane_threads = pr_lane_threads(plan.chunk_lanes());
  const int blocks = static_cast<int>((plan.chunk_lanes() * lane_threads + kChunkThreads - 1) /
                                      kChunkThreads);
  if (lane_threads == 4)
    pr_acs_forward_chunked_kernel<4><<<blocks, kChunkThreads, 0, st>>>(obs, rc, m_in, dec, m_out,
                                                                       plan);
  else if (lane_threads == 2)
    pr_acs_forward_chunked_kernel<2><<<blocks, kChunkThreads, 0, st>>>(obs, rc, m_in, dec, m_out,
                                                                       plan);
  else
    pr_acs_forward_chunked_kernel<1><<<blocks, kChunkThreads, 0, st>>>(obs, rc, m_in, dec, m_out,
                                                                       plan);
  return static_cast<int>(cudaGetLastError());
}

// dec: (W, C L) int32; start: (C L,) int32; bits: (T/4, L) int32.
int atsc_pr_traceback_chunked(int device, const int32_t* dec, const int32_t* start,
                              int32_t* bits, int steps, int lanes, int chunks, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const ChunkPlan plan = make_plan(steps, lanes, chunks);
  if (bad_plan(plan) || steps % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  pr_traceback_chunked_kernel<<<chunk_grid(plan, kChunkThreads), kChunkThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(dec, start, bits, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
