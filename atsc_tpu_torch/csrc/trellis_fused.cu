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
// with the odd-step chain Sv. S is linear in the byte, so E[t] is S of
// P[t], the XOR of the raw bytes before t: the kernel scans bytes, not
// parities, with the carries as one byte c (bit 1 = d, bit 2 = d2, bit 0 =
// d1, whose S is (d, d2, d1)). The whole row is computed, the 122 pad
// bytes past 5,382 included, so the output equals the TPU kernel's over the
// full array.
//
// Design: four bytes per instruction (SWAR on 32-bit words, byte 0 first).
// A warp owns a row and walks it in 11 rounds of 512 bytes, 4 words a lane:
// interleaved, word 128 r + 32 s + lane of step s (each warp load one
// 128-byte line, each warp store of the 16 symbols of a word one 512-byte
// run); plane-major, words 128 r + 4 lane + s (one 16-byte load, and per
// plane one 16-byte store, 512 bytes a warp). A round:
//   - pre_s: the XOR of bytes 0..i of word s in byte i (two shift-XORs);
//     byte s of t is word s's total (byte 3 of pre_s);
//   - one warp XOR scan (5 shuffles) for all four words: interleaved, a
//     bytewise scan of t over the lanes (byte s scans step s), then the
//     steps' totals prefixed in the word; plane-major, the lane's words
//     prefixed in t, the lane total scanned. `base` byte s is the XOR of
//     every byte of the row before word s, c included; c moves on by the
//     round's total;
//   - per word, P = pre << 8 ^ base's byte s in every byte, and the four
//     planes in 4 x 8 bit lanes: v = P ^ P >> 4 holds Ev, E2 ^ .., Eu in
//     bits 0-3; the z2 chain shifts x7, x5, x3, x1 to bit 2, which brings
//     x6, x4, x2, x0 to bit 1; plane p byte i is symbol p of byte i, which
//     is plane-major's output word; interleaved transposes the 4 x 4 bytes
//     with 8 byte permutes.
// The grid is persistent (as many blocks as fit on the card, rows strided
// over its warps); each warp loads its next round (after a row's last, the
// next row's first) before it computes this one, and writes with streaming
// stores (st.global.cs: the symbols are not read again here).
//
// What bounds it on an H100: bytes. At B = 384 it reads 25.4 MB and writes
// 101.4 MB (0.038 ms at 3.35 TB/s). On an H100 80GB HBM3 at 700 W it takes
// 0.053 ms in either layout, within 5 % of a copy kernel with the same loads
// and stores and no arithmetic (0.051 ms; PyTorch's fill_ of the 101.4 MB
// alone takes 0.034): the mix of reads and writes, not the instructions,
// holds it (tools/torch_kernel_ab.py --kernels trellis_fused). The round
// loop issues 14.4 (interleaved) / 12.4 (plane-major) instructions an input
// byte, an issue floor of ~0.011 ms; 46 / 40 registers, no spills, 40 / 48
// warps an SM, so B = 384's 4,608 rows run as one wave.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kRowBytes = 5504;                 // padded bytes per row (43 x 128)
constexpr int kRowWords = kRowBytes / 4;        // 1,376
constexpr int kLaneBytes = 16;                  // input bytes a lane takes a round
constexpr int kRoundBytes = 32 * kLaneBytes;    // 512
constexpr int kRounds = (kRowBytes + kRoundBytes - 1) / kRoundBytes;   // 11
constexpr int kWarps = 4;                       // warps (rows at a time) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kB0 = 0x01010101u;           // bit 0 of every byte

constexpr int kLastSteps = (kRowWords - 128 * (kRounds - 1)) / 32;   // 3 of the last round's 4
constexpr int kLastLanes = (kRowWords - 128 * (kRounds - 1)) / 4;    // 24 of its 32

static_assert(kRowWords % 32 == 0, "a step of 32 words ends inside the row or at its end");
static_assert(kRowBytes % 16 == 0, "rows are whole 16-byte vectors");

__device__ __forceinline__ uint32_t prefix_bytes(uint32_t x) {   // byte i: XOR of bytes 0..i
  const uint32_t y = x ^ (x << 8);
  return y ^ (y << 16);
}

__device__ __forceinline__ uint32_t byte_bcast(uint32_t x, int s) {   // byte s in every byte
  return __byte_perm(x, 0u, 0x1111u * s);
}

// The carry byte c of a row, in every byte.
__device__ __forceinline__ uint32_t carry_bytes(const int32_t* d, const int32_t* d1,
                                                const int32_t* d2, int row) {
  return ((d[row] & 1) << 1 | (d2[row] & 1) << 2 | (d1[row] & 1)) * kB0;
}

// Word s of the lane in round r is live inside the row: every word but the
// last round's, there the first kLastSteps steps (interleaved) or the
// first kLastLanes lanes (plane-major).
template <bool kInterleaved>
__device__ __forceinline__ bool live_word(int r, int s, int lane) {
  return r + 1 < kRounds || (kInterleaved ? s < kLastSteps : lane < kLastLanes);
}

// The lane's 4 words of round r of the row at src (zeros past its end).
template <bool kInterleaved>
__device__ __forceinline__ uint4 load_round(const uint8_t* src, int r, int lane) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(src) + 128 * r;
  if constexpr (kInterleaved) {
    uint32_t q[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) q[s] = live_word<true>(r, s, lane) ? __ldg(w + 32 * s + lane) : 0u;
    return make_uint4(q[0], q[1], q[2], q[3]);
  } else {
    return live_word<false>(r, 0, lane) ? __ldg(reinterpret_cast<const uint4*>(w) + lane)
                                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Inclusive XOR scan of x over the warp's lanes.
__device__ __forceinline__ uint32_t warp_scan(uint32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x ^= y;
  }
  return x;
}

// The symbol planes of the 4 bytes of w, given pe (byte i: the XOR of every
// row byte before byte i, c included): byte i of pl[p] is symbol p of byte i.
__device__ __forceinline__ void planes4(uint32_t w, uint32_t pe, uint32_t (&pl)[4]) {
  const uint32_t v = pe ^ (pe >> 4);                    // bit 0 Ev, bit 2 Eu, bits 1^3 E2
  const uint32_t g = v ^ (w >> 4);                      // bit 0 Ev^x4, bit 2 Eu^x6
  const uint32_t x0 = (v << 1) ^ (v >> 1) ^ (w >> 5);   // bit 2: z2_0 = E2^x7
  const uint32_t x1 = x0 ^ (w >> 3);                    // bit 2: z2_1
  const uint32_t x2 = x1 ^ (w >> 1);                    // bit 2: z2_2
  const uint32_t x3 = x2 ^ (w << 1);                    // bit 2: z2_3
  pl[0] = (x0 & 4 * kB0) | ((w >> 5) & 2 * kB0) | (v & kB0);
  pl[1] = (x1 & 4 * kB0) | ((w >> 3) & 2 * kB0) | ((g >> 2) & kB0);
  pl[2] = (x2 & 4 * kB0) | ((w >> 1) & 2 * kB0) | (g & kB0);
  pl[3] = (x3 & 4 * kB0) | ((w << 1) & 2 * kB0) | (((g ^ w) >> 2) & kB0);
}

// One round of a row (kLast: its last, partly past the row's end): the
// lane's words q, the row's running carry bytes cb (moved on by the round),
// its symbols written to dst (the row's output) with streaming stores.
template <bool kInterleaved, bool kLast>
__device__ __forceinline__ void encode_round(uint4 q, int r, int lane, uint32_t& cb,
                                             uint8_t* dst) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t pre[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) pre[s] = prefix_bytes(w[s]);
  const uint32_t t = __byte_perm(__byte_perm(pre[0], pre[1], 0x0073),
                                 __byte_perm(pre[2], pre[3], 0x0073), 0x5410);
  uint32_t base;
  if constexpr (kInterleaved) {
    const uint32_t inc = warp_scan(t, lane);                 // byte s: step s's lanes 0..lane
    const uint32_t ti = prefix_bytes(__shfl_sync(kFull, inc, 31));   // steps 0..s
    base = inc ^ t ^ (ti << 8) ^ cb;
    cb ^= byte_bcast(ti, 3);
  } else {
    const uint32_t li = prefix_bytes(t);                     // byte s: words 0..s
    const uint32_t lt = byte_bcast(li, 3);
    const uint32_t inc = warp_scan(lt, lane);
    base = inc ^ lt ^ (li << 8) ^ cb;
    cb ^= __shfl_sync(kFull, inc, 31);
  }
  uint32_t pl[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) planes4(w[s], (pre[s] << 8) ^ byte_bcast(base, s), pl[s]);
  if constexpr (kInterleaved) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (kLast && s >= kLastSteps) continue;
      const uint32_t* p = pl[s];
      const uint32_t t0 = __byte_perm(p[0], p[1], 0x5140), t1 = __byte_perm(p[0], p[1], 0x7362);
      const uint32_t t2 = __byte_perm(p[2], p[3], 0x5140), t3 = __byte_perm(p[2], p[3], 0x7362);
      __stcs(reinterpret_cast<uint4*>(dst + 16 * (128 * r + 32 * s + lane)),
             make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                        __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)));
    }
  } else {
    if (kLast && lane >= kLastLanes) return;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      __stcs(reinterpret_cast<uint4*>(dst + p * kRowBytes + 4 * (128 * r + 4 * lane)),
             make_uint4(pl[0][p], pl[1][p], pl[2][p], pl[3][p]));
  }
}

template <bool kInterleaved>
__global__ void __launch_bounds__(kWarps * 32)
trellis_fused_kernel(const uint8_t* __restrict__ il, const int32_t* __restrict__ d,
                     const int32_t* __restrict__ d1, const int32_t* __restrict__ d2,
                     int8_t* __restrict__ out, int rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together
  uint8_t* dst0 = reinterpret_cast<uint8_t*>(out);
  uint32_t cb = carry_bytes(d, d1, d2, row);

  uint4 next = load_round<kInterleaved>(il + static_cast<size_t>(row) * kRowBytes, 0, lane);
  for (;;) {
    const int nrow = row + stride;
    const uint32_t next_cb = nrow < rows ? carry_bytes(d, d1, d2, nrow) : 0u;
    const uint8_t* src = il + static_cast<size_t>(row) * kRowBytes;
    uint8_t* dst = dst0 + static_cast<size_t>(row) * 4 * kRowBytes;
#pragma unroll 1
    for (int r = 0; r + 1 < kRounds; ++r) {
      const uint4 q = next;
      next = load_round<kInterleaved>(src, r + 1, lane);
      encode_round<kInterleaved, false>(q, r, lane, cb, dst);
    }
    const uint4 q = next;   // the last round; the next row's first loads
    if (nrow < rows)
      next = load_round<kInterleaved>(il + static_cast<size_t>(nrow) * kRowBytes, 0, lane);
    encode_round<kInterleaved, true>(q, kRounds - 1, lane, cb, dst);
    if (nrow >= rows) break;
    row = nrow, cb = next_cb;
  }
}

// The persistent grid: as many blocks as the card holds at once (asked once
// a device), no more than the rows need.
template <bool kInterleaved>
cudaError_t grid_blocks(int device, int rows, int* blocks) {
  static int held_on[64];   // blocks device i holds at once; 0 until asked
  int held = device >= 0 && device < 64 ? held_on[device] : 0;
  if (held == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trellis_fused_kernel<kInterleaved>, kWarps * 32, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    held = sms * per_sm;
    if (device >= 0 && device < 64) held_on[device] = held;
  }
  const int need = (rows + kWarps - 1) / kWarps;
  *blocks = need < held ? need : held;
  return cudaSuccess;
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
  int blocks = 0;
  const cudaError_t err = interleaved ? grid_blocks<true>(device, rows, &blocks)
                                      : grid_blocks<false>(device, rows, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (interleaved)
    trellis_fused_kernel<true><<<blocks, kWarps * 32, 0, s>>>(il, d, d1, d2, out, rows);
  else
    trellis_fused_kernel<false><<<blocks, kWarps * 32, 0, s>>>(il, d, d1, d2, out, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
