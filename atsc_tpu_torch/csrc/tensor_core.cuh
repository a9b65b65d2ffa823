// Device helpers of the tensor-core kernels (eq_fir.cu, fir_variants.cu):
// cp.async staging, ldmatrix, mma.sync with tf32 operands, and the split of
// a float32 operand into the two tf32 words of a 3 x TF32 product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N = 16 (cached in L2 only) or 4 bytes from global to shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(N == 16 || N == 4, "cp.async copies 4 or 16 bytes here");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 8, row) * b (8 x 8, col): tf32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 fraction bits), to nearest with ties away from
// zero (cvt.rna); the low 13 bits are zero
__host__ __device__ __forceinline__ uint32_t tf32_bits(uint32_t x) {
  return (x + 0x1000u) & 0xFFFFE000u;
}

// x -> (hi, lo) tf32 words: hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact); hi + lo is x to within 2^-22 of it
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(x));
  lo = tf32_bits(__float_as_uint(__fsub_rn(x, __uint_as_float(hi))));
}
