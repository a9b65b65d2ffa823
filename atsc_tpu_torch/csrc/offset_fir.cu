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
// Design: grid (261120 / 256, B), 256 threads, one output per thread. A
// block stages its 256 + 110 modulated inputs (u, w) in shared memory,
// reading the int8 field once; the taps sit in __constant__ memory (every
// thread of a warp reads the same tap: a broadcast). All float32, no
// bf16 and no TF32 anywhere: the 5e-6 IQ bound rules both out. FMA inside
// the FIR sum is fine for that bound.
//
// What bounds it on an H100: the direct form does about 448 float32 FLOP
// per complex output (2 x 111 multiply-adds, plus the modulate and rotate),
// about 45 GFLOP per field at B = 384, against about 0.8 GB of cf32 writes
// (0.1 GB of int8 reads). Its inner loop issues two shared-memory loads per
// two FMAs, so it is bound by shared-memory load bandwidth on the CUDA
// cores, not by device memory. A tensor-core form (the banded 128 x 128
// matmuls in a float32-exact split) fed by TMA is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPaddedSymbols = 261248;  // input samples per channel (params.PADDED_SYMBOLS)
constexpr int kPaddedOut = 261120;      // output samples per channel (params.PADDED_OUT)
constexpr int kTaps = 112;              // params.RRC_TAPS: 111 taps + one zero
constexpr int kUsedTaps = 111;
constexpr int kTile = 256;              // outputs, and threads, per block
constexpr int kHalo = kUsedTaps - 1;    // lookahead samples past the tile
constexpr float kLevelBias = 1.25f - 7.0f;

static_assert(kPaddedOut % kTile == 0, "the grid covers the output exactly");
static_assert(kPaddedOut + kHalo <= kPaddedSymbols, "no read past the field");

enum Format : int { kCf32 = 0, kCs16 = 1, kCs8 = 2, kWireCs16 = 3, kWireCs8 = 4 };

__constant__ float c_taps[kTaps];

template <int F>
__global__ void __launch_bounds__(kTile)
offset_fir_kernel(const int8_t* __restrict__ field, const float* __restrict__ phasor,
                  const float* __restrict__ osc, void* __restrict__ out, float qscale,
                  float qmax) {
  __shared__ float su[kTile + kHalo];
  __shared__ float sw[kTile + kHalo];

  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int8_t* f = field + static_cast<size_t>(b) * kPaddedSymbols;
  for (int i = threadIdx.x; i < kTile + kHalo; i += kTile) {
    const int n = base + i;  // <= kPaddedOut - 1 + kHalo < kPaddedSymbols
    const float lvl = static_cast<float>(f[n]) * 2.0f + kLevelBias;
    su[i] = lvl * osc[n];
    sw[i] = lvl * osc[kPaddedSymbols + n];
  }
  __syncthreads();

  const float* pu = su + threadIdx.x;
  const float* pw = sw + threadIdx.x;
  float fu = 0.0f;
  float fw = 0.0f;
#pragma unroll
  for (int k = 0; k < kUsedTaps; ++k) {
    const float c = c_taps[k];
    fu = fmaf(pu[k], c, fu);
    fw = fmaf(pw[k], c, fw);
  }

  const float pr = phasor[2 * b];
  const float pi = phasor[2 * b + 1];
  float oi = fu * pr - fw * pi;
  float oq = fu * pi + fw * pr;
  const size_t j = static_cast<size_t>(base) + threadIdx.x;

  if constexpr (F == kCf32) {
    float* o = static_cast<float*>(out) + static_cast<size_t>(b) * 2 * kPaddedOut;
    o[j] = oi;
    o[kPaddedOut + j] = oq;
  } else {
    oi = fminf(fmaxf(rintf(oi * qscale), -qmax), qmax);
    oq = fminf(fmaxf(rintf(oq * qscale), -qmax), qmax);
    const int ii = static_cast<int>(oi);
    const int qq = static_cast<int>(oq);
    if constexpr (F == kCs16) {
      int16_t* o = static_cast<int16_t*>(out) + static_cast<size_t>(b) * 2 * kPaddedOut;
      o[j] = static_cast<int16_t>(ii);
      o[kPaddedOut + j] = static_cast<int16_t>(qq);
    } else if constexpr (F == kCs8) {
      int8_t* o = static_cast<int8_t*>(out) + static_cast<size_t>(b) * 2 * kPaddedOut;
      o[j] = static_cast<int8_t>(ii);
      o[kPaddedOut + j] = static_cast<int8_t>(qq);
    } else if constexpr (F == kWireCs16) {
      uint32_t* o = static_cast<uint32_t*>(out) + static_cast<size_t>(b) * kPaddedOut;
      o[j] = static_cast<uint32_t>(static_cast<uint16_t>(ii)) |
             (static_cast<uint32_t>(static_cast<uint16_t>(qq)) << 16);
    } else {
      uint16_t* o = static_cast<uint16_t*>(out) + static_cast<size_t>(b) * kPaddedOut;
      o[j] = static_cast<uint16_t>(static_cast<uint8_t>(ii) |
                                   (static_cast<uint16_t>(static_cast<uint8_t>(qq)) << 8));
    }
  }
}

template <int F>
void launch(const int8_t* field, const float* phasor, const float* osc, void* out, int batch,
            float qscale, float qmax, cudaStream_t stream) {
  const dim3 grid(kPaddedOut / kTile, batch);
  offset_fir_kernel<F><<<grid, kTile, 0, stream>>>(field, phasor, osc, out, qscale, qmax);
}

}  // namespace

extern "C" {

// Copies the 112 RRC taps (host float32) into the kernel's constant memory
// on `device`. Call once per device before the first launch there.
int atsc_offset_fir_set_taps(int device, const float* taps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(c_taps, taps, sizeof(float) * kTaps));
}

// field: (batch, 261248) int8 symbol values; phasor: (batch, 2) float32;
// osc: (2, 261248) float32 oscillator planes; out: (batch, 2, 261120)
// planar (fmt 0-2) or (batch, 261120) wire lanes (fmt 3-4), all contiguous
// on `device`. Launches on `stream` and returns cudaGetLastError().
int atsc_offset_fir(int device, const int8_t* field, const float* phasor, const float* osc,
                    void* out, int batch, int fmt, float qscale, float qmax, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
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
