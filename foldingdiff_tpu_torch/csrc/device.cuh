// Device-side helpers shared by the attention kernels of this directory:
// cp.async copies into shared memory, float32 FMA dot products, and the
// tensor-core pieces of their instances (the arithmetics of their products:
// operand rounding and the parts of the multi-pass presets, ldmatrix
// fragment loads, one mma.sync m16n8k8 tile and the products of parts, the
// online softmax's fold over a warp's rows).

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

// The value the tensor cores read for x (operand's bits as a float32), so
// that an operand rounded once in shared memory needs no conversion per load.
template <bool BF16>
__device__ __forceinline__ float rounded(float x) {
  return __uint_as_float(operand<BF16>(x));
}

// The arithmetic of a tensor-core instance's products, one per matmul
// precision of the model (ops/attention.py's table). Each float32 operand x
// is split into parts x0 = r(x), x1 = r(x - x0), x2 = r(x - x0 - x1), r the
// rounding to TF32 or to bf16 values, and a fixed list of products of parts
// is summed in float32, the small terms first, as JAX's DotAlgorithmPreset
// defines it:
//   TF32    TF32_TF32_F32      r TF32, x0        a0.b0
//   BF16    BF16_BF16_F32      r bf16, x0        a0.b0
//   TF32x3  TF32_TF32_F32_X3   r TF32, x0, x1    a1.b0 + a0.b1 + a0.b0
//   BF16x3  BF16_BF16_F32_X3   r bf16, x0, x1    the same
//   BF16x6  BF16_BF16_F32_X6   r bf16, x0..x2    the six with i + j <= 2
//   BF16x9  BF16_BF16_F32_X9   r bf16, x0..x2    all nine
// Every subtraction is exact in float32, and every product of two parts is
// exact on the TF32 tensor cores (a TF32 part has 11 significant bits, a
// bf16 part 8), so the instances compute the presets' products and differ
// from the plain versions only in the order of the float32 sums.
enum class Arith { TF32, BF16, TF32x3, BF16x3, BF16x6, BF16x9 };

template <Arith A>
constexpr bool kBF16Parts = A != Arith::TF32 && A != Arith::TF32x3;

// An arithmetic's products of parts, the one table of them: 10 i + j for
// part i of A's operand times part j of B's, smallest first.
struct Products {
  int n;
  int ij[9];
};

__host__ __device__ constexpr Products products_of(Arith a) {
  return a == Arith::TF32x3 || a == Arith::BF16x3 ? Products{3, {10, 1, 0}}
         : a == Arith::BF16x6                     ? Products{6, {20, 11, 2, 10, 1, 0}}
         : a == Arith::BF16x9                     ? Products{9, {22, 21, 12, 20, 11, 2, 10, 1, 0}}
                                                  : Products{1, {0}};
}

// Product p (0 .. kProducts - 1) of an arithmetic: 10 i + j.
__host__ __device__ constexpr int product_parts(Arith a, int p) { return products_of(a).ij[p]; }

// The parts of an operand: one more than the largest part index.
__host__ __device__ constexpr int parts_of(Arith a) {
  int last = 0;
  for (int p = 0; p < products_of(a).n; ++p) {
    const int i = product_parts(a, p) / 10, j = product_parts(a, p) % 10;
    last = i > last ? i : last;
    last = j > last ? j : last;
  }
  return last + 1;
}

template <Arith A>
constexpr int kParts = parts_of(A);
template <Arith A>
constexpr int kProducts = products_of(A).n;

// The part indices of every product packed two bits each (product p at
// bits 2p): of A's operand (first) or of B's.
__host__ __device__ constexpr uint32_t packed_parts(Arith a, bool first) {
  uint32_t packed = 0;
  for (int p = 0; p < products_of(a).n; ++p) {
    packed |= static_cast<uint32_t>(first ? product_parts(a, p) / 10 : product_parts(a, p) % 10) << (2 * p);
  }
  return packed;
}

// What a fragment register holds between its load and its mma: a single-
// rounding instance's operand, rounded once at the load; a multi-pass
// instance's float32 value, split at the mma (split, part).
template <Arith A>
__device__ __forceinline__ uint32_t held(float x) {
  return kParts<A> == 1 ? operand<kBF16Parts<A>>(x) : __float_as_uint(x);
}

// A multi-pass part's rounding: bf16 to nearest even, or TF32 to nearest,
// ties away, by integer operations (cvt.rna.tf32.f32's result for every
// finite value; the inline cvt's fixed register cost spilled the largest
// instances).
template <Arith A>
__device__ __forceinline__ uint32_t round_part(float x) {
  if constexpr (kBF16Parts<A>) {
    return operand<true>(x);
  } else {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  }
}

// The parts of a held value (held), as the tensor cores read them.
template <Arith A>
__device__ __forceinline__ void split(uint32_t (&r)[kParts<A>], uint32_t h) {
  if constexpr (kParts<A> == 1) {
    r[0] = h;
  } else {
    float x = __uint_as_float(h);
#pragma unroll
    for (int i = 0; i < kParts<A>; ++i) {
      r[i] = round_part<A>(x);
      x -= __uint_as_float(r[i]);
    }
  }
}

// Part i (0 .. kParts - 1, known at run time) of a held value.
template <Arith A>
__device__ __forceinline__ uint32_t part(uint32_t h, int i) {
  float x = __uint_as_float(h);
  uint32_t r = round_part<A>(x);
#pragma unroll
  for (int k = 1; k < kParts<A>; ++k) {
    if (k <= i) {
      x -= __uint_as_float(r);
      r = round_part<A>(x);
    }
  }
  return r;
}

// Four 8 x 4 tiles of 32-bit words from shared memory (ldmatrix on b16
// pairs): lanes 8 j .. 8 j + 7 give the row addresses of tile j, and lane
// (g, t) receives word t of row g of tile j in r[j].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// c += a . b for one m16n8k8 tile: a the 16 x 8 A fragment (rows g, g + 8;
// columns t, t + 4), b0 and b1 B's rows t and t + 4 of column g.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += the listed products of the parts ap[.][i] and bp[.][j] of one
// m16n8k8 tile's operands, from product P on, one mma each, the smallest
// first (compile-time part indices: the parts stay in registers).
template <Arith A, int P = 0>
__device__ __forceinline__ void mma_products(float (&c)[4], const uint32_t (&ap)[4][kParts<A>],
                                             const uint32_t (&bp)[2][kParts<A>]) {
  if constexpr (P < kProducts<A>) {
    constexpr int i = product_parts(A, P) / 10, j = product_parts(A, P) % 10;
    const uint32_t ai[4] = {ap[0][i], ap[1][i], ap[2][i], ap[3][i]};
    mma(c, ai, bp[0][j], bp[1][j]);
    mma_products<A, P + 1>(c, ap, bp);
  }
}

// How a multi-pass mma runs its products (mma<A, FORM>). Each fits the
// registers of the design that calls it: in each of the others ptxas
// spilled there (measured on every instance at D = 16, 32, 64).
//   - kUnrolled (the resident v2 design, one block of 255 registers a
//     thread, and v1's two-part instances): every part of a and b made at
//     once, the products unrolled; A's parts made anew at every call (the
//     empty asm hides that a is the same as at the last n-tile: held
//     across the unrolled n-tiles, they spilled);
//   - kLoop (v1's three-part instances at D <= 32, 128 registers): every
//     part made at once, then a loop over the products that picks two, so
//     that the compiler cannot interleave the products of many tiles;
//   - kLoopLean (the chunked v2 design at 168 and 255 registers, and v1's
//     three-part instances at D = 64): a loop over the products that makes
//     the two parts each one needs, no part outliving its mma; the most
//     conversions per mma.
// The loops leave each tile's products to run one after another (v1's
// three-part instances ran 0.75 and 1.01 ms at B = 64, L = 128 with kLoop,
// 1.49 and 2.16 with kLoopLean, on an H100 80GB HBM3 at 700 W).
enum class Form { kUnrolled, kLoop, kLoopLean };

// c += a . b for one m16n8k8 tile in arithmetic A, a and b (as mma's) held
// values (held), each listed product of their parts one mma into c, the
// smallest first, run as FORM says.
template <Arith A, Form FORM = Form::kUnrolled>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  constexpr uint32_t kFirst = packed_parts(A, true), kSecond = packed_parts(A, false);
  if constexpr (kParts<A> == 1) {
    mma(c, a, b0, b1);
  } else if constexpr (FORM == Form::kLoopLean) {
#pragma unroll 1
    for (int p = 0; p < kProducts<A>; ++p) {
      const int i = (kFirst >> (2 * p)) & 3, j = (kSecond >> (2 * p)) & 3;
      const uint32_t ai[4] = {part<A>(a[0], i), part<A>(a[1], i), part<A>(a[2], i), part<A>(a[3], i)};
      mma(c, ai, part<A>(b0, j), part<A>(b1, j));
    }
  } else {
    uint32_t ap[4][kParts<A>], bp[2][kParts<A>];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x = a[i];
      if constexpr (FORM == Form::kUnrolled) asm volatile("" : "+r"(x));
      split<A>(ap[i], x);
    }
    split<A>(bp[0], b0);
    split<A>(bp[1], b1);
    if constexpr (FORM == Form::kUnrolled) {
      mma_products<A>(c, ap, bp);
    } else {
      auto pick = [](const uint32_t (&r)[kParts<A>], int i) {
        return i == 0 ? r[0] : i == 1 ? r[1] : r[kParts<A> - 1];
      };
#pragma unroll 1
      for (int p = 0; p < kProducts<A>; ++p) {
        const int i = (kFirst >> (2 * p)) & 3, j = (kSecond >> (2 * p)) & 3;
        const uint32_t ai[4] = {pick(ap[0], i), pick(ap[1], i), pick(ap[2], i), pick(ap[3], i)};
        mma(c, ai, pick(bp[0], j), pick(bp[1], j));
      }
    }
  }
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
