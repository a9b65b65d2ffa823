// Errors-only RS(207,187) correction of a batch of segments, for Hopper
// (sm_90a), doing work only on the segments whose syndromes are not zero.
//
// Replaces no TPU kernel: the JAX package corrects with XLA ops
// (atsc_tpu/ops/rs_decode.py, rs_correct_field), and so did the port, as
// fixed-shape PyTorch code (ops/rs_decode.py, rs_correct_field_plain, this
// kernel's plain twin). That twin runs about a thousand small launches a
// call (20 Berlekamp-Massey rounds of ~40 ops, a 21-term polynomial
// product) over every segment of the batch, plus GF(2) bit products for
// Chien, Forney and the check syndromes (~260 GFLOP of float32 at B = 384).
// The host issues those launches more slowly than the card runs them, and
// 99.8 % of the work is on segments that are already clean (at 24 dB about
// 220 of 119,808 are dirty). This kernel was added for that.
//
// Function, per segment (codeword c[0..206], first byte transmitted first,
// c(x) = sum_i c[i] x^(206 - i); syndromes S_j = c(alpha^j), j < 20, over
// GF(256) with the polynomial 0x11d):
//   - S = 0: the codeword unchanged, n = 0 (the syndromes are trusted to be
//     those of the codeword, as the twin's contract states);
//   - else Berlekamp-Massey gives the locator C (C_0 = 1) and its length L;
//     Omega = C S mod x^20; Chien evaluates C at X^-1 = alpha^-(206 - i) for
//     the 207 positions; Forney gives e_i = X Omega(X^-1) / C'(X^-1) at each
//     root; the patched codeword's 20 syndromes are computed again;
//   - accepted when L <= 10, the roots number L, C' is not 0 at any root and
//     every syndrome of the patched codeword is 0: the patched codeword and
//     n = L; else the codeword unchanged and n = -1.
// This is the twin's acceptance test, and a decoder that accepts only a
// codeword within 10 bytes returns the one there is (bounded distance), so
// bytes and counts equal the twin's bit for bit.
//
// What bounds it on an H100: bytes. Every codeword is read and written
// once (the output is a new array) and every syndrome read once: at
// B = 384, 119,808 x (207 + 20 + 207 + 4) bytes = 52.5 MB, 0.0157 ms at
// 3.35 TB/s. The decodes are a few thousand warp instructions each, serial
// inside a warp, and there are a few hundred a field, spread over the
// warps: they add latency to the warps that hold them, not bytes. On an
// H100 80GB HBM3 at 700 W, B = 384, in two runs of chip_smoke.py phase 38:
// 0.027 / 0.051 ms on a clean field (the copy alone; 58 / 31 % of the
// bound), 0.067 / 0.057 ms on a 24 dB field with 165 dirty segments (the
// warps holding the most dirty segments finish last), against 33.2 / 36.8
// ms for the twin.
//
// Design: a warp owns 32 consecutive segments, one a lane (blocks of 4
// warps; the GF(256) exp and log tables, 768 bytes, in shared memory).
//   - each lane reads its segment's 20 syndrome bytes as five 4-byte
//     loads; __ballot_sync of "any byte non-zero" gives the dirty lanes;
//   - the warp copies its 32 x 207 = 6,624 contiguous bytes (414 16-byte
//     vectors, every load issued before the first store) to the output;
//   - then the warp decodes each dirty segment in turn, all 32 lanes on
//     one segment:
//       * the syndromes in a per-warp window of shared memory with 32 zero
//         bytes in front, so lane i reads S_(r - i) (0 where r < i);
//       * Berlekamp-Massey in 20 rounds, lane i holding coefficient i of C
//         and of x^m B; the discrepancy is a 5-step shuffle-XOR reduction;
//         x^m B moves up one lane a round (__shfl_up_sync); L, the
//         discrepancy and the update are warp-uniform, so no lane diverges;
//       * L > 10 rejects at once; else C goes to shared memory and lane
//         k < 20 computes Omega_k;
//       * Chien and Forney over the positions lane + 32 t (t < 7): 11
//         locator terms a position (deg C <= L <= 10), C' from the odd
//         terms of the same walk; Omega and the error value only at a root;
//         the roots counted by __reduce_add_sync;
//       * the check: each lane sums its patched bytes' terms of all 20
//         syndromes (4 to a 32-bit word), and 5 words are XOR-reduced
//         across the warp; only an accepted decode writes its bytes.
//   - each lane writes its segment's count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kN = 207;                             // codeword bytes
constexpr int kRoots = 20;                          // syndromes (parity bytes)
constexpr int kMaxErrors = 10;                      // kRoots / 2
constexpr int kWarps = 4;                           // warps a block
constexpr int kSegsPerWarp = 32;                    // one segment a lane
constexpr int kWarpBytes = kSegsPerWarp * kN;       // 6,624 contiguous bytes a warp
constexpr int kVecsPerLane = (kWarpBytes / 16 + 31) / 32;   // 13 (414 vectors)
constexpr int kPosPerLane = (kN + 31) / 32;         // 7: positions lane + 32 t
constexpr int kPad = 32;                            // zero bytes before S in the window
constexpr int kExp = 512;                           // exp table: alpha^(i mod 255)
constexpr int kLog = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarpBytes % 16 == 0, "each warp's bytes start on a 16-byte boundary");
static_assert((kExp + kLog) % 16 == 0, "the tables load as 16-byte vectors");

__device__ __forceinline__ uint32_t gf_mul(const uint8_t* ex, const uint8_t* lg,
                                           uint32_t a, uint32_t b) {
  return (a && b) ? ex[lg[a] + lg[b]] : 0u;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(kFull, v, o);
  return v;
}

// One dirty segment, decoded by the whole warp. win: the warp's window
// (kPad zero bytes, then S_0..S_19, then zeros); loc, om: 32 bytes each.
// Returns n (>= 1) after writing the patched bytes to dst, or -1.
__device__ int decode_segment(const uint8_t* __restrict__ src,
                              const uint8_t* __restrict__ syn, uint8_t* __restrict__ dst,
                              const uint8_t* ex, const uint8_t* lg, uint8_t* win,
                              uint8_t* loc, uint8_t* om, int lane) {
  __syncwarp();   // the previous segment's reads of win, loc and om are done
  win[kPad + lane] = lane < kRoots ? syn[lane] : 0;
  __syncwarp();

  // Berlekamp-Massey: c = C_lane, xb = (x^m B)_lane, b the last discrepancy
  uint32_t c = lane == 0, xb = lane == 1;
  int ell = 0;
  int log_b = 0;
#pragma unroll
  for (int r = 0; r < kRoots; ++r) {
    const uint32_t d = warp_xor(gf_mul(ex, lg, c, win[kPad + r - lane]));
    uint32_t nb = xb;   // B stays: x^(m+1) B next round
    if (d != 0) {
      int lc = lg[d] - log_b;
      lc += lc < 0 ? 255 : 0;
      const uint32_t t = c;
      c ^= xb ? ex[lc + lg[xb]] : 0u;
      if (2 * ell <= r) {   // the length grows: B = the old C, m = 1
        nb = t;
        log_b = lg[d];
        ell = r + 1 - ell;
      }
    }
    xb = __shfl_up_sync(kFull, nb, 1);
    if (lane == 0) xb = 0;
  }
  if (ell > kMaxErrors) return -1;

  // Omega = C S mod x^20, lane k < 20 holding Omega_k (deg C <= L <= 10)
  loc[lane] = static_cast<uint8_t>(c);
  __syncwarp();
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i <= kMaxErrors; ++i)
    o ^= gf_mul(ex, lg, loc[i], win[kPad + lane - i]);
  om[lane] = lane < kRoots ? static_cast<uint8_t>(o) : 0;
  __syncwarp();

  int lc[kMaxErrors + 1];   // log C_k, or -1 for C_k = 0
#pragma unroll
  for (int k = 0; k <= kMaxErrors; ++k) lc[k] = loc[k] ? lg[loc[k]] : -1;

  // Chien and Forney over the lane's positions p = lane + 32 t
  uint32_t patched[kPosPerLane];
  unsigned roots = 0;   // bit t: position t is a root
  bool bad = false;     // a root where C' = 0
#pragma unroll
  for (int t = 0; t < kPosPerLane; ++t) {
    const int p = lane + 32 * t;
    patched[t] = 0;
    if (p >= kN) continue;
    const uint32_t r = src[p];
    patched[t] = r;
    const int j = kN - 1 - p;          // X = alpha^j
    const int step = 255 - j;          // alpha^-j = alpha^step
    uint32_t v = 0, den = 0;
    int e = 0, e_prev = 0;             // e = k step mod 255
#pragma unroll
    for (int k = 0; k <= kMaxErrors; ++k) {
      if (lc[k] >= 0) {
        v ^= ex[lc[k] + e];
        if (k & 1) den ^= ex[lc[k] + e_prev];   // C'(x) = sum_(k odd) C_k x^(k-1)
      }
      e_prev = e;
      e += step;
      e -= e >= 255 ? 255 : 0;
    }
    if (v != 0) continue;
    roots |= 1u << t;
    if (den == 0) {
      bad = true;
      continue;
    }
    uint32_t num = 0;                  // Omega(X^-1)
    e = 0;
    for (int k = 0; k < kRoots; ++k) {
      if (om[k]) num ^= ex[lg[om[k]] + e];
      e += step;
      e -= e >= 255 ? 255 : 0;
    }
    if (num) patched[t] = r ^ ex[(lg[num] + j + 255 - lg[den]) % 255];
  }
  const int nroots = static_cast<int>(__reduce_add_sync(kFull, __popc(roots)));
  if (nroots != ell || __any_sync(kFull, bad)) return -1;

  // the patched codeword's syndromes: this lane's terms, then the warp's sum
  uint32_t w[kRoots / 4] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < kPosPerLane; ++t) {
    const int p = lane + 32 * t;
    if (p >= kN || patched[t] == 0) continue;
    const int lq = lg[patched[t]];
    const int j = kN - 1 - p;          // term of S_s: c[p] alpha^(s j)
    int e = 0;
#pragma unroll
    for (int s = 0; s < kRoots; ++s) {
      w[s >> 2] ^= static_cast<uint32_t>(ex[lq + e]) << (8 * (s & 3));
      e += j;
      e -= e >= 255 ? 255 : 0;
    }
  }
  uint32_t any = 0;
#pragma unroll
  for (int q = 0; q < kRoots / 4; ++q) any |= warp_xor(w[q]);
  if (any != 0) return -1;

#pragma unroll
  for (int t = 0; t < kPosPerLane; ++t)
    if (roots >> t & 1u) dst[lane + 32 * t] = static_cast<uint8_t>(patched[t]);
  return ell;
}

__global__ void __launch_bounds__(kWarps * 32)
rs_correct_kernel(const uint8_t* __restrict__ cw, const uint8_t* __restrict__ syn,
                  const uint8_t* __restrict__ tables, uint8_t* __restrict__ out,
                  int32_t* __restrict__ nerr, int nseg) {
  __shared__ __align__(16) uint8_t tab[kExp + kLog];
  __shared__ uint8_t win[kWarps][kPad + 32];
  __shared__ uint8_t loc[kWarps][32];
  __shared__ uint8_t om[kWarps][32];
  for (int i = threadIdx.x; i < (kExp + kLog) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(tab)[i] = __ldg(reinterpret_cast<const uint4*>(tables) + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg0 = (blockIdx.x * kWarps + warp) * kSegsPerWarp;
  if (seg0 >= nseg) return;   // the whole warp leaves together
  const int nw = min(kSegsPerWarp, nseg - seg0);   // segments of this warp
  const int seg = seg0 + lane;

  uint32_t s = 0;
  if (lane < nw) {
    const uint32_t* sp = reinterpret_cast<const uint32_t*>(syn + static_cast<size_t>(seg) * kRoots);
#pragma unroll
    for (int q = 0; q < kRoots / 4; ++q) s |= __ldg(sp + q);
  }
  unsigned dirty = __ballot_sync(kFull, s != 0);

  // the warp's codewords to the output: 16-byte vectors, then the ragged tail
  const size_t base = static_cast<size_t>(seg0) * kN;
  const int len = nw * kN;
  const int nvec = len >> 4;
  const uint4* vsrc = reinterpret_cast<const uint4*>(cw + base);
  uint4* vdst = reinterpret_cast<uint4*>(out + base);
  uint4 v[kVecsPerLane];
#pragma unroll
  for (int t = 0; t < kVecsPerLane; ++t)
    if (lane + 32 * t < nvec) v[t] = __ldg(vsrc + lane + 32 * t);
#pragma unroll
  for (int t = 0; t < kVecsPerLane; ++t)
    if (lane + 32 * t < nvec) vdst[lane + 32 * t] = v[t];
  for (int i = (nvec << 4) + lane; i < len; i += 32) out[base + i] = cw[base + i];

  int n = 0;
  if (dirty) {
    win[warp][lane] = 0;   // the kPad zeros in front of S
    __syncwarp();          // and the copy's stores before any patch
    while (dirty) {
      const int owner = __ffs(dirty) - 1;
      dirty &= dirty - 1;
      const size_t at = static_cast<size_t>(seg0 + owner);
      const int got = decode_segment(cw + at * kN, syn + at * kRoots, out + at * kN,
                                     tab, tab + kExp, win[warp], loc[warp], om[warp], lane);
      if (lane == owner) n = got;
    }
  }
  if (lane < nw) nerr[seg] = n;
}

}  // namespace

extern "C" {

// cw, out: (nseg, 207) uint8, 16-byte aligned; syn: (nseg, 20) uint8,
// 4-byte aligned; tables: 768 bytes (exp[512] = alpha^(i mod 255), then
// log[256]), 16-byte aligned; nerr: (nseg,) int32; all contiguous on
// `device`. Launches on `stream`, returns cudaGetLastError().
int atsc_rs_correct(int device, const uint8_t* cw, const uint8_t* syn, const uint8_t* tables,
                    uint8_t* out, int32_t* nerr, int nseg, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (nseg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kWarps * kSegsPerWarp;
  const int blocks = (nseg + per_block - 1) / per_block;
  rs_correct_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      cw, syn, tables, out, nerr, nseg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
