// Device-side helpers shared by the attention kernels of this directory:
// cp.async copies into shared memory, float32 FMA dot products, and the
// tensor-core pieces of their TF32 and bf16 instances (operand rounding, one
// mma.sync m16n8k8 tile, the online softmax's fold over a warp's rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float bf16_value(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A product's operand as the tensor cores read it: TF32 rounded to nearest
// (ties away), or, in the bf16 instances, the bf16 value, which TF32 holds exactly.
template <bool BF16>
__device__ __forceinline__ uint32_t operand(float x) {
  if (BF16) return __float_as_uint(bf16_value(x));
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a . b for one m16n8k8 tile: a the 16 x 8 A fragment (rows g, g + 8;
// columns t, t + 4), b0 and b1 B's rows t and t + 4 of column g.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Folds a chunk's scores (log2 units; NT n-tiles of 8 keys, rows g and
// g + 8 of the warp in s[n][0..1] and s[n][2..3]) into the running row
// maxima m and this lane's partial sums l, replacing each score by
// exp2(s - m_new); rescale[i] is exp2(m_old - m_new) of row g + 8 i (0 on
// the first chunk).
template <int NT>
__device__ __forceinline__ void fold(float (&s)[NT][4], float (&m)[2], float (&l)[2], float (&rescale)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    const float m_new = fmaxf(m[i], quad_max(mx));  // finite: every chunk has a key below L
    rescale[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][2 * i + e] = exp2f(s[n][2 * i + e] - m_new);
        sum += s[n][2 * i + e];
      }
    }
    l[i] = fmaf(l[i], rescale[i], sum);
  }
}

}  // namespace attn
