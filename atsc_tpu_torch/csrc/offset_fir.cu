// Fused level map + pilot offset + 112-tap RRC FIR for Hopper (sm_90a),
// with the optional cs16/cs8 quantization and packed wire lanes.
//
// Replaces the TPU kernel atsc_tpu/ops/pallas/offset_fir.py::offset_fir_fused
// (body _kernel). Same function, not the same blocking: per channel b and
// output sample j in [0, 261120),
//
//   lvl[n]  = 2 v[n] - 7 + 1.25                 (int8 symbol v -> level)
//   u[n]    = lvl[n] * osc_re[n],  w[n] = lvl[n] * osc_im[n]
//   U[j]    = sum_{k<111} c[k] u[j+k],  W[j] = sum_{k<111} c[k] w[j+k]
//   I[j]    = U[j] pr - W[j] pi,  Q[j] = U[j] pi + W[j] pr   ((pr, pi) = phasor[b])
//
// then either planar float32 (cf32), or rintf (round-half-even, as
// jnp.round) + clamp to +-qmax as planar int16/int8 (cs16/cs8), or each
// (I, Q) code pair packed into one little-endian lane: int32 for cs16,
// int16 for cs8 (wire). The real-tap FIR commutes with the complex phasor,
// so the phasor rotates the outputs and the oscillator table stays frozen.
// Valid output is [0, 260416); the rest of [0, 261120) is computed from
// the padding segment and never read.
//
// What bounds it on an H100: the direct form does 2 x 111 float32 FMAs
// per complex output, 44.4 GFLOP per field at B = 384 (0.663 ms at the
// 67 TFLOP/s fp32 peak), against about 0.8 GB of cf32 writes (0.24 ms at
// 3.35 TB/s). So it is bound by the FMA pipes, if the loop feeds them.
// The first form (one output per thread) did not: each tap issued two
// 4-byte shared loads for two FMAs, and an SM serves about one warp-wide
// shared load per clock against four warp-wide FFMAs, so it ran at 22.7 %
// of the fp32 peak (2.927 ms on an H100 80GB HBM3 at 700 W).
//
// Design: register blocking of the direct form. Each thread computes
// kR = 8 contiguous outputs per plane, walking a register window over its
// kR + 110 staged samples: each sample is read from shared memory once, as
// part of a 16-byte load, and feeds up to kR FMAs per plane (60 16-byte
// loads per 1,776 FFMAs). The tap and sample loops are fully unrolled, so
// each tap index is a compile-time constant and FFMA takes the tap from
// the constant bank; each output still sums fmaf over k = 0..110 in order,
// and the rotation is written out as nvcc contracted it in the first form,
// so the cf32 output is the first form's bit for bit. Windows start at a
// stride of 32 bytes, so the 8 threads of a quarter-warp share 4 16-byte
// bank groups: a 2-way conflict, which keeps the shared-memory pipe about
// as busy as the FMA pipes (480 against 444 clocks of an SM per warp).
// Storing vector c at c ^ (bit 3 of c) removes the conflict for 3 integer
// instructions per window vector, in the FMAs' issue slots: measured on an
// H100 80GB HBM3 (700 W), that build was 0.2-7 % slower, so issue, not the
// shared-memory pipe, bounds this form. There kR = 8 also ran ahead of
// kR = 4 (twice the loads per FMA) and of kR = 12 (48-byte stride, no
// conflict, but 1.5x the straight-line code); tools/torch_kernel_ab.py
// times all three. Blocks of 128 threads cover
// 1024 outputs, staging 1136 (u, w) samples from one read of the int8
// field; 255 blocks tile [0, 261120) exactly. Stores go out 4 outputs at
// a time (16 bytes cf32 and wire cs16, 8 bytes cs16 and wire cs8, 4 bytes
// cs8). All float32, no bf16 and no TF32 anywhere: the 5e-6 IQ bound rules
// both out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kPaddedSymbols = 261248;  // input samples per channel (params.PADDED_SYMBOLS)
constexpr int kPaddedOut = 261120;      // output samples per channel (params.PADDED_OUT)
constexpr int kTaps = 112;              // params.RRC_TAPS: 111 taps + one zero
constexpr int kUsedTaps = 111;
constexpr int kHalo = kUsedTaps - 1;    // lookahead samples past an output
constexpr int kR = 8;                   // contiguous outputs per thread
constexpr int kThreads = 128;
constexpr int kTile = kThreads * kR;    // outputs per block
constexpr int kWindow = (kR + kHalo + 3) / 4 * 4;       // samples a thread reads
constexpr int kStaged = (kThreads - 1) * kR + kWindow;  // samples a block stages
constexpr float kLevelBias = 1.25f - 7.0f;

static_assert(kR % 4 == 0, "windows and stores are whole 16-byte vectors");
static_assert(kPaddedOut % kTile == 0, "the grid covers the output exactly");
static_assert(kPaddedOut - kTile + kStaged <= kPaddedSymbols, "no read past the field");

enum Format : int { kCf32 = 0, kCs16 = 1, kCs8 = 2, kWireCs16 = 3, kWireCs8 = 4 };

__constant__ float c_taps[kTaps];

__device__ __forceinline__ int code(float x, float qscale, float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(x * qscale), -qmax), qmax));
}

__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack8(int b0, int b1, int b2, int b3) {
  return static_cast<uint32_t>(static_cast<uint8_t>(b0)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b1)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b2)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b3)) << 24);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
offset_fir_kernel(const int8_t* __restrict__ field, const float* __restrict__ phasor,
                  const float* __restrict__ osc, void* __restrict__ out, float qscale,
                  float qmax) {
  __shared__ __align__(16) float su[kStaged];
  __shared__ __align__(16) float sw[kStaged];

  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const char4* f = reinterpret_cast<const char4*>(
      field + static_cast<size_t>(b) * kPaddedSymbols + base);
  const float4* ore = reinterpret_cast<const float4*>(osc + base);
  const float4* oim = reinterpret_cast<const float4*>(osc + kPaddedSymbols + base);
  for (int q = threadIdx.x; q < kStaged / 4; q += kThreads) {
    const char4 s = f[q];
    const float4 cr = ore[q];
    const float4 ci = oim[q];
    const float l0 = static_cast<float>(s.x) * 2.0f + kLevelBias;
    const float l1 = static_cast<float>(s.y) * 2.0f + kLevelBias;
    const float l2 = static_cast<float>(s.z) * 2.0f + kLevelBias;
    const float l3 = static_cast<float>(s.w) * 2.0f + kLevelBias;
    reinterpret_cast<float4*>(su)[q] = make_float4(l0 * cr.x, l1 * cr.y, l2 * cr.z, l3 * cr.w);
    reinterpret_cast<float4*>(sw)[q] = make_float4(l0 * ci.x, l1 * ci.y, l2 * ci.z, l3 * ci.w);
  }
  __syncthreads();

  const float4* pu = reinterpret_cast<const float4*>(su + threadIdx.x * kR);
  const float4* pw = reinterpret_cast<const float4*>(sw + threadIdx.x * kR);
  float fu[kR], fw[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) fu[r] = fw[r] = 0.0f;
  // sample n of the window feeds output r with tap k = n - r; for each r
  // the taps come in order k = 0..110
#pragma unroll
  for (int n4 = 0; n4 < kWindow / 4; ++n4) {
    const float4 xu = pu[n4];
    const float4 xw = pw[n4];
    const float u4[4] = {xu.x, xu.y, xu.z, xu.w};
    const float w4[4] = {xw.x, xw.y, xw.z, xw.w};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int k = 4 * n4 + d - r;
        if (k >= 0 && k < kUsedTaps) {
          fu[r] = fmaf(u4[d], c_taps[k], fu[r]);
          fw[r] = fmaf(w4[d], c_taps[k], fw[r]);
        }
      }
    }
  }

  const float pr = phasor[2 * b];
  const float pi = phasor[2 * b + 1];
  // the rotation in the form nvcc gave the one-output-per-thread kernel,
  // written out so that both forms round alike
  float oi[kR], oq[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    oi[r] = __fmaf_rn(fu[r], pr, -__fmul_rn(fw[r], pi));
    oq[r] = __fmaf_rn(fw[r], pr, __fmul_rn(fu[r], pi));
  }
  const size_t j0 = static_cast<size_t>(base) + threadIdx.x * kR;

  if constexpr (F == kCf32) {
    float* o = static_cast<float*>(out) + static_cast<size_t>(b) * 2 * kPaddedOut + j0;
#pragma unroll
    for (int r = 0; r < kR; r += 4) {
      *reinterpret_cast<float4*>(o + r) = make_float4(oi[r], oi[r + 1], oi[r + 2], oi[r + 3]);
      *reinterpret_cast<float4*>(o + kPaddedOut + r) =
          make_float4(oq[r], oq[r + 1], oq[r + 2], oq[r + 3]);
    }
  } else {
    int ii[kR], qq[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ii[r] = code(oi[r], qscale, qmax);
      qq[r] = code(oq[r], qscale, qmax);
    }
    if constexpr (F == kCs16) {
      int16_t* o = static_cast<int16_t*>(out) + static_cast<size_t>(b) * 2 * kPaddedOut + j0;
#pragma unroll
      for (int r = 0; r < kR; r += 4) {
        *reinterpret_cast<uint2*>(o + r) =
            make_uint2(pack16(ii[r], ii[r + 1]), pack16(ii[r + 2], ii[r + 3]));
        *reinterpret_cast<uint2*>(o + kPaddedOut + r) =
            make_uint2(pack16(qq[r], qq[r + 1]), pack16(qq[r + 2], qq[r + 3]));
      }
    } else if constexpr (F == kCs8) {
      int8_t* o = static_cast<int8_t*>(out) + static_cast<size_t>(b) * 2 * kPaddedOut + j0;
#pragma unroll
      for (int r = 0; r < kR; r += 4) {
        *reinterpret_cast<uint32_t*>(o + r) = pack8(ii[r], ii[r + 1], ii[r + 2], ii[r + 3]);
        *reinterpret_cast<uint32_t*>(o + kPaddedOut + r) =
            pack8(qq[r], qq[r + 1], qq[r + 2], qq[r + 3]);
      }
    } else if constexpr (F == kWireCs16) {
      uint32_t* o = static_cast<uint32_t*>(out) + static_cast<size_t>(b) * kPaddedOut + j0;
#pragma unroll
      for (int r = 0; r < kR; r += 4)
        *reinterpret_cast<uint4*>(o + r) =
            make_uint4(pack16(ii[r], qq[r]), pack16(ii[r + 1], qq[r + 1]),
                       pack16(ii[r + 2], qq[r + 2]), pack16(ii[r + 3], qq[r + 3]));
    } else {
      uint16_t* o = static_cast<uint16_t*>(out) + static_cast<size_t>(b) * kPaddedOut + j0;
      // lane = I byte | Q byte << 8, two lanes per 32-bit word
#pragma unroll
      for (int r = 0; r < kR; r += 4)
        *reinterpret_cast<uint2*>(o + r) =
            make_uint2(pack8(ii[r], qq[r], ii[r + 1], qq[r + 1]),
                       pack8(ii[r + 2], qq[r + 2], ii[r + 3], qq[r + 3]));
    }
  }
}

template <int F>
void launch(const int8_t* field, const float* phasor, const float* osc, void* out, int batch,
            float qscale, float qmax, cudaStream_t stream) {
  const dim3 grid(kPaddedOut / kTile, batch);
  offset_fir_kernel<F><<<grid, kThreads, 0, stream>>>(field, phasor, osc, out, qscale, qmax);
}

}  // namespace

extern "C" {

// Copies the 112 RRC taps (host float32) into the kernel's constant memory
// on `device`. Call once per device before the first launch there.
int atsc_offset_fir_set_taps(int device, const float* taps) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  return static_cast<int>(cudaMemcpyToSymbol(c_taps, taps, sizeof(float) * kTaps));
}

// field: (batch, 261248) int8 symbol values, 4-byte aligned; phasor:
// (batch, 2) float32; osc: (2, 261248) float32 oscillator planes, 16-byte
// aligned; out: (batch, 2, 261120) planar (fmt 0-2) or (batch, 261120)
// wire lanes (fmt 3-4), 16-byte aligned, all contiguous on `device`.
// Launches on `stream` and returns cudaGetLastError().
int atsc_offset_fir(int device, const int8_t* field, const float* phasor, const float* osc,
                    void* out, int batch, int fmt, float qscale, float qmax, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(field) % 4 || reinterpret_cast<uintptr_t>(osc) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kCf32: launch<kCf32>(field, phasor, osc, out, batch, qscale, qmax, s); break;
    case kCs16: launch<kCs16>(field, phasor, osc, out, batch, qscale, qmax, s); break;
    case kCs8: launch<kCs8>(field, phasor, osc, out, batch, qscale, qmax, s); break;
    case kWireCs16: launch<kWireCs16>(field, phasor, osc, out, batch, qscale, qmax, s); break;
    case kWireCs8: launch<kWireCs8>(field, phasor, osc, out, batch, qscale, qmax, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
