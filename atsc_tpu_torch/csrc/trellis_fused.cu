// The 12-way trellis encoder of one field in one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/trellis_fuse_probe.py::trellis_fused (body
// _kernel). The wrapper and plain PyTorch twin are ops/cuda/trellis_fused.py;
// the algebra is ops/trellis.py's (its header derives it). Per row r = one
// (channel, encoder) pair, over the 5,504 padded bytes x[t] of the row:
//
//   S2 = x7^x5^x3^x1,  Su = x6^x2,  Sv = x4^x0     (bits of byte x[t])
//   E[t] = XOR of S[0..t)  (exclusive), seeded with the carries d, d2, d1
//   z2_p = E2 ^ x7 ^ .. ^ x(7-2p)                  (precoder, pair p MSB first)
//   z0_0 = Ev,  z0_1 = Eu^x6,  z0_2 = Ev^x4,  z0_3 = Eu^x6^x2
//   sym_p = z2_p << 2 | x(6-2p) << 1 | z0_p         (stream position 4t + p)
//
// d pairs with the precoder chain S2, d2 with the even-step chain Su and d1
// with the odd-step chain Sv. The three parities pack into one 3-bit word
// S = S2 | Su<<1 | Sv<<2, so the three prefixes are a single XOR scan: no
// cumsum and no triangular matmul (the TPU kernel's bf16 TRIU dots). The
// whole row is computed, the 122 pad bytes past 5,382 included, so the
// output equals the TPU kernel's over the full array.
//
// Design: one warp per row, 4 rows per block (4,608 warps at B = 384, all
// resident in one wave). A warp walks its row in 11 rounds of 512 bytes:
// each lane loads 16 bytes with one 16-byte load (rows are 344 x 16 bytes,
// so every load is aligned), folds their 16 parities into its XOR total,
// takes an exclusive warp-shuffle XOR scan of the totals, adds the carry of
// the earlier rounds, and walks its 16 bytes serially. Output, by layout:
// interleaved (12, 22016): the 4 symbols of a byte are one 32-bit word, 16
// bytes four 16-byte stores; plane-major (12, 4, 5504): 16 bytes of each
// plane one 16-byte store.
//
// What bounds it on an H100: bytes. At B = 384 it reads 25.4 MB and writes
// 101.4 MB (0.038 ms at 3.35 TB/s); the work is ~40 integer operations per
// byte, 1.0e9 in all, well under the card's integer rate in that time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kRowBytes = 5504;                 // padded bytes per row (43 x 128)
constexpr int kVec = 16;                        // bytes per lane per round
constexpr int kVecs = kRowBytes / kVec;         // 344
constexpr int kRounds = (kVecs + 31) / 32;      // 11
constexpr int kWarps = 4;                       // rows per block
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRowBytes % kVec == 0, "rows are whole 16-byte vectors");

// S2 | Su<<1 | Sv<<2 of one byte: y = x ^ (x >> 4) pairs bit k with bit k+4.
__device__ __forceinline__ uint32_t parity3(uint32_t x) {
  const uint32_t y = x ^ (x >> 4);
  return (((y >> 3) ^ (y >> 1)) & 1u) | (y & 4u) >> 1 | (y & 1u) << 2;
}

// The four symbols of byte x, given E (carries folded in): symbol p in
// byte p of the result.
__device__ __forceinline__ uint32_t symbols4(uint32_t x, uint32_t e) {
  const uint32_t e2 = e & 1u, eu = (e >> 1) & 1u, ev = (e >> 2) & 1u;
  const uint32_t x7 = (x >> 7) & 1u, x6 = (x >> 6) & 1u, x5 = (x >> 5) & 1u;
  const uint32_t x4 = (x >> 4) & 1u, x3 = (x >> 3) & 1u, x2 = (x >> 2) & 1u;
  const uint32_t x1 = (x >> 1) & 1u, x0 = x & 1u;
  const uint32_t z20 = e2 ^ x7, z21 = z20 ^ x5, z22 = z21 ^ x3, z23 = z22 ^ x1;
  const uint32_t s0 = z20 << 2 | x6 << 1 | ev;
  const uint32_t s1 = z21 << 2 | x4 << 1 | (eu ^ x6);
  const uint32_t s2 = z22 << 2 | x2 << 1 | (ev ^ x4);
  const uint32_t s3 = z23 << 2 | x0 << 1 | (eu ^ x6 ^ x2);
  return s0 | s1 << 8 | s2 << 16 | s3 << 24;
}

template <bool kInterleaved>
__global__ void __launch_bounds__(kWarps * 32)
trellis_fused_kernel(const uint8_t* __restrict__ il, const int32_t* __restrict__ d,
                     const int32_t* __restrict__ d1, const int32_t* __restrict__ d2,
                     int8_t* __restrict__ out, int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const uint4* src = reinterpret_cast<const uint4*>(il + static_cast<size_t>(row) * kRowBytes);
  uint8_t* dst = reinterpret_cast<uint8_t*>(out) + static_cast<size_t>(row) * 4 * kRowBytes;
  uint32_t carry = (d[row] & 1) | (d2[row] & 1) << 1 | (d1[row] & 1) << 2;

#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int v = r * 32 + lane;
    const bool live = v < kVecs;
    const uint4 q = live ? src[v] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) total ^= parity3((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
    uint32_t incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl ^= y;
    }
    uint32_t e = carry ^ incl ^ total;  // E at this lane's first byte
    carry ^= __shfl_sync(kFull, incl, 31);
    if (!live) continue;

    uint32_t sym[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint32_t x = (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
      sym[i] = symbols4(x, e);
      e ^= parity3(x);
    }
    if constexpr (kInterleaved) {
      uint4* o = reinterpret_cast<uint4*>(dst + static_cast<size_t>(v) * 4 * kVec);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = make_uint4(sym[4 * k], sym[4 * k + 1], sym[4 * k + 2], sym[4 * k + 3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t word[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          word[k] = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) word[k] |= ((sym[4 * k + i] >> (8 * p)) & 0xffu) << (8 * i);
        }
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(p) * kRowBytes +
                                  static_cast<size_t>(v) * kVec) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// il: (rows/12, 12, 5504) uint8; d, d1, d2: (rows,) int32 carries in {0, 1};
// out: (rows/12, 12, 22016) int8 (interleaved = 1) or (rows/12, 12, 4,
// 5504) int8 (interleaved = 0); all contiguous on `device`, il and out
// 16-byte aligned. Launches on `stream`, returns cudaGetLastError().
int atsc_trellis_fused(int device, const uint8_t* il, const int32_t* d, const int32_t* d1,
                       const int32_t* d2, int8_t* out, int rows, int interleaved,
                       void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (interleaved)
    trellis_fused_kernel<true><<<blocks, kWarps * 32, 0, s>>>(il, d, d1, d2, out, rows);
  else
    trellis_fused_kernel<false><<<blocks, kWarps * 32, 0, s>>>(il, d, d1, d2, out, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
