// Device-side helpers shared by the attention kernels of this directory:
// cp.async copies into shared memory, float32 FMA dot products, and the
// tensor-core pieces of their instances (the arithmetics of their products:
// operand rounding, the output rounding of the 16-bit presets and the parts
// of the multi-pass presets, ldmatrix fragment loads, mma.sync m16n8k8
// (TF32) and m16n8k16 (bf16 and f16) tiles, the products of parts split once
// and run over independent accumulators, the 16-bit operands of the
// output-rounding instances, the online softmax's fold over a warp's
// rows); and the float64 pieces of both kernels' f64 instances
// (namespace f64: the float64 FMA design they run past L = 128 and at
// D = 64, and the DMMA fragments of their resident bodies).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// f16's rounding (to nearest even; past 65504 an infinity, subnormals kept)
// as a float32 value: 11 significant bits at most, which TF32 holds exactly
// (f16's subnormals are float32 normals).
__device__ __forceinline__ float f16_value(float x) {
  return __half2float(__float2half_rn(x));
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

// The arithmetic of an instance's products, one per matmul precision of the
// model (ops/attention.py's table). Each float32 operand x is split into
// parts x0 = r(x), x1 = r(x - x0), x2 = r(x - x0 - x1), r the rounding to
// TF32, bf16 or f16 values, and a fixed list of products of parts is summed
// in float32, the small terms first, as JAX's DotAlgorithmPreset defines
// it; F16F16 and BF16BF16 then round each dot's output once (output):
//   TF32      TF32_TF32_F32      r TF32, x0        a0.b0
//   BF16      BF16_BF16_F32      r bf16, x0        a0.b0
//   TF32x3    TF32_TF32_F32_X3   r TF32, x0, x1    a1.b0 + a0.b1 + a0.b0
//   BF16x3    BF16_BF16_F32_X3   r bf16, x0, x1    the same
//   BF16x6    BF16_BF16_F32_X6   r bf16, x0..x2    the six with i + j <= 2
//   BF16x9    BF16_BF16_F32_X9   r bf16, x0..x2    all nine
//   F16       F16_F16_F32        r f16, x0         a0.b0
//   F16F16    F16_F16_F16        r f16, x0         a0.b0, rounded to f16
//   BF16BF16  BF16_BF16_BF16     r bf16, x0        a0.b0, rounded to bf16
// Every subtraction is exact in float32, and every product of two parts is
// exact in float32 (a TF32 or f16 part has 11 significant bits, a bf16 part
// 8): the multi-pass instances' bf16 parts run on the bf16 tensor cores,
// every other part on the TF32 ones (but in v2's resident body of BF16,
// F16, F16F16 and BF16BF16, whose bf16 or f16 values run on their own:
// mma16 below, BF16 and F16 with no output rounding and their relative term
// in float32), so the instances compute the presets' products and differ
// from the plain versions only in the order of the float32 sums. F64
// (F64_F64_F64) is none of these: its instances run
// float64 products (namespace f64), on the FP64 tensor cores in the
// resident designs.
enum class Arith { TF32, BF16, TF32x3, BF16x3, BF16x6, BF16x9, F64, F16, F16F16, BF16BF16 };

template <Arith A>
constexpr bool kBF16Parts = A == Arith::BF16 || A == Arith::BF16x3 || A == Arith::BF16x6 || A == Arith::BF16x9 ||
                            A == Arith::BF16BF16;
template <Arith A>
constexpr bool kF16Operands = A == Arith::F16 || A == Arith::F16F16;
// F16F16 and BF16BF16 round each dot's output (output below)
template <Arith A>
constexpr bool kRoundsOutput = A == Arith::F16F16 || A == Arith::BF16BF16;

// A single-rounding instance's operand as the tensor cores read it: TF32
// (operand<false>), or the bf16 or f16 value, which TF32 holds exactly.
template <Arith A>
__device__ __forceinline__ uint32_t operand_of(float x) {
  if constexpr (kF16Operands<A>) {
    return __float_as_uint(f16_value(x));
  } else {
    return operand<kBF16Parts<A>>(x);
  }
}

// A dot's output as the instance leaves it: rounded once to f16 (F16F16) or
// to bf16 (BF16BF16), to nearest even, from the float32 sum of its products;
// else the sum itself.
template <Arith A>
__device__ __forceinline__ float output(float x) {
  if constexpr (A == Arith::F16F16) {
    return f16_value(x);
  } else if constexpr (A == Arith::BF16BF16) {
    return bf16_value(x);
  } else {
    return x;
  }
}

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
// rounding instance's operand, rounded once at the load; in the forms that
// split at the mma (mma<A>, mma_split) or split held fragments once
// (split_fragments), a multi-pass instance's float32 value.
template <Arith A>
__device__ __forceinline__ uint32_t held(float x) {
  return kParts<A> == 1 ? operand_of<A>(x) : __float_as_uint(x);
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

// Two 8 x 8 tiles of b16 values from shared memory: lanes 8 j .. 8 j + 7
// give the row addresses of tile j, and lane (g, t) receives word t of row g
// of tile j in r[j]; with TRANS, tile j transposed: the b16 values of rows
// 2t and 2t + 1 of its column g.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(s) : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(s) : "memory");
  }
}

// c += a . b for one m16n8k8 tile: a the 16 x 8 A fragment (rows g, g + 8;
// columns t, t + 4), b0 and b1 B's rows t and t + 4 of column g.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b for one m16n8k8 tile in arithmetic A, a and b (as mma's) held
// values (held): each listed product of their parts one mma into c, the
// smallest first, in a loop that makes the two parts each product needs, no
// part outliving its mma: the chunked v2 design's form (L > 128 or D = 64,
// no shipped configuration), whose registers hold nothing more (ptxas
// spilled with every part made at once there). The resident v2 design and
// v1 split each operand once instead (split4, products below), and so
// does TF32x3 there (mma_split above runs it in v1's chunked body).
template <Arith A>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  constexpr uint32_t kFirst = packed_parts(A, true), kSecond = packed_parts(A, false);
  if constexpr (kParts<A> == 1) {
    mma(c, a, b0, b1);
  } else {
#pragma unroll 1
    for (int p = 0; p < kProducts<A>; ++p) {
      const int i = (kFirst >> (2 * p)) & 3, j = (kSecond >> (2 * p)) & 3;
      const uint32_t ai[4] = {part<A>(a[0], i), part<A>(a[1], i), part<A>(a[2], i), part<A>(a[3], i)};
      mma(c, ai, part<A>(b0, j), part<A>(b1, j));
    }
  }
}

// c += the listed products of the parts ap[.][i] and bp[.][j] of one
// m16n8k8 tile's operands, from product P on, one mma each, the smallest
// first (compile-time part indices: the parts stay in registers).
template <Arith A, int P = 0>
__device__ __forceinline__ void mma_split_products(float (&c)[4], const uint32_t (&ap)[4][kParts<A>],
                                                   const uint32_t (&bp)[2][kParts<A>]) {
  if constexpr (P < kProducts<A>) {
    constexpr int i = product_parts(A, P) / 10, j = product_parts(A, P) % 10;
    const uint32_t ai[4] = {ap[0][i], ap[1][i], ap[2][i], ap[3][i]};
    mma(c, ai, bp[0][j], bp[1][j]);
    mma_split_products<A, P + 1>(c, ap, bp);
  }
}

// c += a . b for one m16n8k8 tile in arithmetic A, a and b (as mma's) held
// values (held): every part of both made at the call, the listed products
// unrolled, the smallest first. The TF32x3 instance's form in v1's chunked
// body (L > 128 or D = 64), where it beat splitting once (PERF.md §6): A's
// parts are made anew at every call (the empty asm hides that a is the
// same as at the last n-tile: held across the unrolled n-tiles, they
// spilled). The single-rounding instances' one mma.
template <Arith A>
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (kParts<A> == 1) {
    mma(c, a, b0, b1);
  } else {
    uint32_t ap[4][kParts<A>], bp[2][kParts<A>];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x = a[i];
      asm volatile("" : "+r"(x));
      split<A>(ap[i], x);
    }
    split<A>(bp[0], b0);
    split<A>(bp[1], b1);
    mma_split_products<A>(c, ap, bp);
  }
}

// ---- Multi-pass instances, split once: parts made at the load, products of
// parts over independent accumulators ----------------------------------------
//
// A multi-pass operand is split into its parts once, where it is loaded (into
// registers, or into planes of parts in shared memory that fragments are
// loaded from), never at an mma. bf16 parts run on the bf16 tensor cores,
// mma.sync m16n8k16 (every product of two bf16 parts is exact in float32):
// half the instructions of m16n8k8 and twice its rate. TF32 parts run on
// m16n8k8, two k-steps per 16 values of the contracted dimension. A "chunk"
// is those 16 values: per part, an A chunk is 4 kSteps words (kSteps A
// fragments) and a B chunk 2 kSteps words. products walks the chunks in
// order and, per k-step, the table's products smallest first, each over a
// group of n-tiles whose accumulators interleave. This replaced forms that
// split each fragment at every mma on the TF32 tensor cores and ran each
// tile's products as one dependent chain (v1's three-part instances as a
// loop over the products, to fit 128 registers); at B = 64, H = 12, L = 128,
// D = 32 with relative scores, v1's bf16x9 went 1.0276 -> 0.1620 ms, v2's
// 0.2311 -> 0.0751 (NVIDIA H100 80GB HBM3, 700 W, in turns:
// scripts/kernel_times_two_trees.py). TF32x3 splits once in both kernels'
// resident designs too, its A parts from held fragments (split_fragments),
// and keeps mma_split in v1's chunked body, where that won (PERF.md §6);
// so do v1's bf16x6 and bf16x9 in its resident design, their bf16 parts of
// q from held fragments too (v1's bf16x9 0.1645 -> 0.0888 ms there).

// k-steps per chunk of 16 contracted values: one m16n8k16 for bf16 parts, two m16n8k8 for TF32
template <Arith A>
constexpr int kSteps = kBF16Parts<A> ? 1 : 2;

// c += a . b for one m16n8k16 tile of bf16 values: a the 16 x 16 A fragment
// (bf16 pairs: rows g, g + 8; columns 2t, 2t + 1 and 2t + 8, 2t + 9), b0 and
// b1 B's rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; the lower column or
// row in the low half of each word.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- The output-rounding instances (F16F16, BF16BF16) on 16-bit operands:
// each operand rounded once to f16 or bf16 (as operand_of rounds it) and
// held as such, the products on the f16 or bf16 tensor cores (m16n8k16,
// float32 accumulators: every product of two 16-bit values is exact in
// float32) ---------------------------------------------------------------------

// c += a . b for one m16n8k16 tile of f16 values: the fragments as mma_bf16's.
__device__ __forceinline__ void mma_f16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats rounded to A's 16-bit type, lo in the low half: f16 (to
// nearest even; past 65504 an infinity, subnormals kept) under F16F16, else
// bf16 (to nearest even): the values f16_value and bf16_value give.
template <Arith A>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (kF16Operands<A>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    return pack_bf16(lo, hi);
  }
}

// A 16-bit value of A's type (its bits in the low half of x) as a float, exactly.
template <Arith A>
__device__ __forceinline__ float unpack16(uint32_t x) {
  if constexpr (kF16Operands<A>) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(x)));
  } else {
    return __uint_as_float(x << 16);
  }
}

// c += a . b for one m16n8k16 tile of A's 16-bit values (a: a0 .. a3).
template <Arith A>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (kF16Operands<A>) {
    mma_f16(c, a[0], a[1], a[2], a[3], b0, b1);
  } else {
    mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
  }
}

// Four 8 x 8 tiles of b16 values from shared memory, transposed: lanes
// 8 j .. 8 j + 7 give the row addresses of tile j, and lane (g, t) receives
// the b16 values of rows 2t and 2t + 1 of tile j's column g in r[j].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Splits four floats into their parts, as fragment words of one k-chunk:
// bf16 parts as the pairs (x0, x1) and (x2, x3), r[i] = {pair 0, pair 1} of
// part i; TF32 parts one a word, r[i] = {x0, x1, x2, x3} of part i. The
// same four values make a B chunk (B's (b0, b1), per k-step), and two calls
// an A chunk.
template <Arith A>
__device__ __forceinline__ void split4(uint32_t (&r)[kParts<A>][2 * kSteps<A>], float x0, float x1, float x2,
                                       float x3) {
  if constexpr (kBF16Parts<A>) {
#pragma unroll
    for (int i = 0; i < kParts<A>; ++i) {
      r[i][0] = pack_bf16(x0, x1);
      r[i][1] = pack_bf16(x2, x3);
      if (i + 1 < kParts<A>) {  // every subtraction exact
        x0 -= __uint_as_float(r[i][0] << 16);
        x1 -= __uint_as_float(r[i][0] & 0xffff0000u);
        x2 -= __uint_as_float(r[i][1] << 16);
        x3 -= __uint_as_float(r[i][1] & 0xffff0000u);
      }
    }
  } else {
    const float x[4] = {x0, x1, x2, x3};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t w[kParts<A>];
      split<A>(w, __float_as_uint(x[e]));
#pragma unroll
      for (int i = 0; i < kParts<A>; ++i) r[i][e] = w[i];
    }
  }
}

// One mma of a chunk's k-step s in arithmetic A: a the A chunk's words of a
// part, b0 and b1 the B chunk's words 2s, 2s + 1 of a part.
template <Arith A>
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4 * kSteps<A>], int s, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kBF16Parts<A>) {
    mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
  } else {
    const uint32_t as[4] = {a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3]};
    mma(c, as, b0, b1);
  }
}

// c[n] += the listed products of a's and b's parts, one k-step (s) of a
// chunk, from product P on, the smallest first, each over the G n-tiles.
template <Arith A, int G, int P = 0>
__device__ __forceinline__ void mma_products(float (*c)[4], const uint32_t (&a)[kParts<A>][4 * kSteps<A>],
                                             const uint32_t (&b)[G][kParts<A>][2 * kSteps<A>], int s) {
  if constexpr (P < kProducts<A>) {
    constexpr int i = product_parts(A, P) / 10, j = product_parts(A, P) % 10;
#pragma unroll
    for (int n = 0; n < G; ++n) mma_step<A>(c[n], a[i], s, b[n][j][2 * s], b[n][j][2 * s + 1]);
    mma_products<A, G, P + 1>(c, a, b, s);
  }
}

// c[n] += A . B[n] for G n-tiles over KC chunks in arithmetic A, from parts
// split once: per chunk kc, a_chunk(kc, a) gives every part of A's chunk
// and b_chunk(kc, n, b) every part of n-tile n's (from registers, from
// planes of parts, or split as loaded), then each k-step takes the table's
// products in order, the smallest first, as the multi-pass presets define
// them, each over the G n-tiles: no accumulator's next mma waits on its last
// with nothing between, and only one chunk's parts are live.
template <Arith A, int G, int KC, typename AChunk, typename BChunk>
__device__ __forceinline__ void products(float (*c)[4], const AChunk& a_chunk, const BChunk& b_chunk) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[kParts<A>][4 * kSteps<A>];
    a_chunk(kc, a);
    uint32_t b[G][kParts<A>][2 * kSteps<A>];
#pragma unroll
    for (int n = 0; n < G; ++n) b_chunk(kc, n, b[n]);
#pragma unroll
    for (int s = 0; s < kSteps<A>; ++s) mma_products<A, G>(c, a, b, s);
  }
}

// Held A fragments (held) of 2 KC m16n8k8 k-steps split into their parts
// once, as KC chunks of products: w[kc][i] holds part i of chunk kc. TF32
// parts: words 4 s .. 4 s + 3 those of k-step 2 kc + s. bf16 parts: the
// m16n8k16 A words of k-steps 2 kc and 2 kc + 1, whose fragments f[.] =
// {(g, c), (g + 8, c), (g, c + 1), (g + 8, c + 1)} hold columns c = 16 kc +
// 4t, + 1 and then + 2, + 3 of rows g and g + 8 (as tc::a_fragments makes
// them): row g's first two as k = 2t, 2t + 1, row g + 8's the same, then
// the last two of each as k = 2t + 8, 2t + 9, which is how split4 takes a
// B chunk's four columns.
template <Arith A, int KC>
__device__ __forceinline__ void split_fragments(uint32_t (&w)[KC][kParts<A>][4 * kSteps<A>],
                                                const uint32_t (&f)[2 * KC][4]) {
  if constexpr (kBF16Parts<A>) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t lo[kParts<A>][2], hi[kParts<A>][2];
      const uint32_t(&f0)[4] = f[2 * kc];
      const uint32_t(&f1)[4] = f[2 * kc + 1];
      split4<A>(lo, __uint_as_float(f0[0]), __uint_as_float(f0[2]), __uint_as_float(f0[1]), __uint_as_float(f0[3]));
      split4<A>(hi, __uint_as_float(f1[0]), __uint_as_float(f1[2]), __uint_as_float(f1[1]), __uint_as_float(f1[3]));
#pragma unroll
      for (int i = 0; i < kParts<A>; ++i) {
        w[kc][i][0] = lo[i][0];
        w[kc][i][1] = lo[i][1];
        w[kc][i][2] = hi[i][0];
        w[kc][i][3] = hi[i][1];
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < 2 * KC; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t p[kParts<A>];
        split<A>(p, f[ks][e]);
#pragma unroll
        for (int i = 0; i < kParts<A>; ++i) w[ks / 2][i][4 * (ks % 2) + e] = p[i];
      }
    }
  }
}

// A chunk held in registers, every part: the AChunk of products.
template <Arith A, int KC>
struct HeldChunks {
  const uint32_t (&x)[KC][kParts<A>][4 * kSteps<A>];
  __device__ __forceinline__ void operator()(int kc, uint32_t (&w)[kParts<A>][4 * kSteps<A>]) const {
#pragma unroll
    for (int i = 0; i < kParts<A>; ++i) {
#pragma unroll
      for (int e = 0; e < 4 * kSteps<A>; ++e) w[i][e] = x[kc][i][e];
    }
  }
};

// The A chunk (every part) of P for the 16 keys of score n-tiles s0 and s1
// (accumulators of rows g, g + 8): bf16 keys 2t, 2t + 1, then 8 + 2t, 9 + 2t
// of one m16n8k16 step, as the accumulators hold them; TF32 one m16n8k8
// step per n-tile, its keys in the order (0, 2, 4, 6, 1, 3, 5, 7) (k = t is
// key 2t, k = t + 4 key 2t + 1). B's rows are then the same four keys for
// both: 2t, 2t + 1, 8 + 2t, 9 + 2t (split4's x0 .. x3).
template <Arith A>
__device__ __forceinline__ void p_chunk(uint32_t (&pa)[1][kParts<A>][4 * kSteps<A>], const float (&s0)[4],
                                        const float (&s1)[4]) {
  uint32_t lo[kParts<A>][2 * kSteps<A>], hi[kParts<A>][2 * kSteps<A>];
  if constexpr (kBF16Parts<A>) {
    split4<A>(lo, s0[0], s0[1], s0[2], s0[3]);
    split4<A>(hi, s1[0], s1[1], s1[2], s1[3]);
  } else {
    split4<A>(lo, s0[0], s0[2], s0[1], s0[3]);
    split4<A>(hi, s1[0], s1[2], s1[1], s1[3]);
  }
#pragma unroll
  for (int i = 0; i < kParts<A>; ++i) {
#pragma unroll
    for (int w = 0; w < 2 * kSteps<A>; ++w) {
      pa[0][i][w] = lo[i][w];
      pa[0][i][2 * kSteps<A> + w] = hi[i][w];
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

// ---- The f64 instances (F64_F64_F64) past the resident designs: float64
// FMA on the CUDA cores --------------------------------------------------------
//
// Since both kernels' f64 instances run their products on the FP64 tensor
// cores in their resident designs (L <= 128 at D <= 32, every shipped
// configuration; the DMMA pieces below), this design runs them only at
// L > 128 and at D = 64. Both kernels' f64 instances share it: every
// product in float64 (two
// float32 values multiply exactly there) and each dot's output rounded to
// float32, q.k and the relative term each on its own before their sum, and
// p.v over every key; softmax in float32, online over the keys in exp2
// units, the scale folded in. A block of 256 threads owns kRows = 16 query
// rows of kPairs = 4 (b, h) pairs; warp w holds 8 rows of pair w / 2, a quad
// of lanes per row, each lane the dimensions 4 (tq + 4 i) .. + 3 of D (its
// q slice and its output slice in float64 registers), and the quad sums its
// partial dots with two xor-shuffles, which leave the same bits in every
// lane. The block walks the keys in chunks of kChunk = 1024 / D and stages
// each chunk's K and V rows of its pairs in shared memory as float64, and
// v2's table window of the chunk too, so that each value is converted to
// float64 once per block, not once per (row, key): a first form that read
// float32 rows from L1 and converted every operand at its use (41
// conversions a lane and key against 24 FMAs) ran 0.5634 ms at the flagship
// shape with relative scores, this one 0.4323 (v2; NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py phase 2). v1's e_lr rows, one per (row, key), are
// read from L1 and converted at their use. Rows and pairs past the tensors
// compute on the last ones (their quads' shuffles need them) and store
// nothing; keys past L are not visited.
namespace f64 {

constexpr int kRows = 16;   // query rows per block
constexpr int kPairs = 4;   // (b, h) pairs per block
constexpr int kLanes = 4;   // lanes per (row, pair)
constexpr int kThreads = kRows * kPairs * kLanes;
constexpr int kGroup = 4;   // keys whose dots run together
constexpr float kLog2e = 1.4426950408889634f;

// Blocks per SM the launch bounds ask for: two (128 registers) where the
// q and output slices are at most 16 doubles each, one at D = 64.
template <int D>
constexpr int kBlocks = D <= 32 ? 2 : 1;

template <int D>
constexpr int kChunk = 1024 / D;  // keys per staged chunk, a multiple of kGroup
template <int D>
constexpr int kRowD = D + 2;      // a staged row in doubles: 8 quads' 16-byte loads spread over the banks

// Shared memory (doubles): K and V of the chunk per pair, then (v2) the
// table rows the block's rows reach in it, row x = (l - l0) - (j - j0) +
// kChunk - 1.
template <int D, bool TABLE>
struct Smem {
  static constexpr int kK = 0;
  static constexpr int kV = kK + kPairs * kChunk<D> * kRowD<D>;
  static constexpr int kE = kV + kPairs * kChunk<D> * kRowD<D>;
  static constexpr int kWindow = kRows + kChunk<D> - 1;
  static constexpr int kDoubles = kE + (TABLE ? kWindow * kRowD<D> : 0);
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;     // (B, L)
  const float* rel;      // the v2 (2M - 1, D) table (TABLE), or v1's (L, L, D) e_lr
  float* out;
  long long sb, sh, sl;  // batch, head and row strides of q, k and v, in floats
  long long ob, oh, ol;  // and of out
  int H, L, M;
  long long BH;
  int n_tiles;
  float scale2;          // D^-1/2 * log2(e)
};

__device__ __forceinline__ double quad_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The quad's dot of q (this lane's float64 slice qd) with the staged row at
// `row` (doubles), rounded to float32.
template <int D>
__device__ __forceinline__ float staged_dot(const double (&qd)[D / 16][4], const double* row, int tq) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const double2 a = *reinterpret_cast<const double2*>(row + 4 * (tq + 4 * i));
    const double2 b = *reinterpret_cast<const double2*>(row + 4 * (tq + 4 * i) + 2);
    acc = fma(qd[i][0], a.x, acc);
    acc = fma(qd[i][1], a.y, acc);
    acc = fma(qd[i][2], b.x, acc);
    acc = fma(qd[i][3], b.y, acc);
  }
  return static_cast<float>(quad_sum(acc));
}

// The same with a float32 row in global memory (read through L1).
template <int D>
__device__ __forceinline__ float global_dot(const double (&qd)[D / 16][4], const float* row, int tq) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row) + tq + 4 * i);
    acc = fma(qd[i][0], static_cast<double>(x.x), acc);
    acc = fma(qd[i][1], static_cast<double>(x.y), acc);
    acc = fma(qd[i][2], static_cast<double>(x.z), acc);
    acc = fma(qd[i][3], static_cast<double>(x.w), acc);
  }
  return static_cast<float>(quad_sum(acc));
}

// Four float32 values of global memory at src (or zeros) as float64 at dst.
__device__ __forceinline__ void stage4(double* dst, const float* src, bool in) {
  const float4 x = in ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  reinterpret_cast<double2*>(dst)[0] = make_double2(x.x, x.y);
  reinterpret_cast<double2*>(dst)[1] = make_double2(x.z, x.w);
}

// TABLE: the relative term of row l and key j is q . table[l - j + M - 1]
// (v2); else q . e_lr[l, j] (v1).
template <int D, bool HAS_REL, bool TABLE>
__device__ __forceinline__ void attention(const Args& a) {
  using S = Smem<D, TABLE>;
  constexpr int kSlice = D / 16;  // float4 pieces per lane
  constexpr int kC = kChunk<D>, kR = kRowD<D>;
  extern __shared__ double2 smem2[];
  double* smem = reinterpret_cast<double*>(smem2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % kLanes;
  const int l0 = (blockIdx.x % a.n_tiles) * kRows;
  const long long n0 = static_cast<long long>(blockIdx.x / a.n_tiles) * kPairs;
  const int slot = warp / 2;  // the warp's pair in the block
  const int row = l0 + 8 * (warp % 2) + lane / kLanes;
  const bool live = row < a.L && n0 + slot < a.BH;
  const int l = row < a.L ? row : a.L - 1;
  const long long n = n0 + slot < a.BH ? n0 + slot : a.BH - 1;
  const long long b = n / a.H, h = n % a.H;
  const float* bias = a.bias + b * a.L;

  double qd[kSlice][4];
  double o[kSlice][4];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(a.q + b * a.sb + h * a.sh + l * a.sl) + tq + 4 * i);
    qd[i][0] = x.x, qd[i][1] = x.y, qd[i][2] = x.z, qd[i][3] = x.w;
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0;
  }
  float m = -INFINITY, sum = 0.0f;

  for (int j0 = 0; j0 < a.L; j0 += kC) {
    __syncthreads();  // the last chunk's reads are done
    // K and V rows j0 .. j0 + kC of the block's pairs, zeros past L and BH
#pragma unroll 1
    for (int i = threadIdx.x; i < kPairs * kC * (D / 4); i += kThreads) {
      const int p = i / (kC * (D / 4)), jj = i / (D / 4) % kC, c = i % (D / 4);
      const long long np = n0 + p;
      const bool in = np < a.BH && j0 + jj < a.L;
      const long long src = in ? (np / a.H) * a.sb + (np % a.H) * a.sh + (j0 + jj) * a.sl + 4 * c : 0;
      stage4(smem + S::kK + (p * kC + jj) * kR + 4 * c, a.k + src, in);
      stage4(smem + S::kV + (p * kC + jj) * kR + 4 * c, a.v + src, in);
    }
    if (HAS_REL && TABLE) {
#pragma unroll 1
      for (int i = threadIdx.x; i < S::kWindow * (D / 4); i += kThreads) {
        const int x = i / (D / 4), c = i % (D / 4);
        const int e = x + l0 - j0 - (kC - 1) + a.M - 1;
        const bool in = e >= 0 && e < 2 * a.M - 1;
        stage4(smem + S::kE + x * kR + 4 * c, a.rel + (in ? static_cast<long long>(e) * D + 4 * c : 0), in);
      }
    }
    __syncthreads();

    const int n_keys = min(kC, a.L - j0);
    // Keys by groups of kGroup: their dots are independent chains, which
    // the quads' shuffles and the FMAs' latency need (one key at a time ran
    // each dot as one dependent chain); the online softmax takes each
    // group's maximum once. Staged rows past L are zeros, scored -inf.
#pragma unroll 1
    for (int jj = 0; jj < n_keys; jj += kGroup) {
      float sc[kGroup];
      float mx = m;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = jj + g;
        float score = staged_dot<D>(qd, smem + S::kK + (slot * kC + j) * kR, tq);
        if (HAS_REL) {
          score += TABLE ? staged_dot<D>(qd, smem + S::kE + ((l - l0) - j + kC - 1) * kR, tq)
                         : global_dot<D>(qd, a.rel + (static_cast<long long>(l) * a.L + min(j0 + j, a.L - 1)) * D, tq);
        }
        sc[g] = j < n_keys ? fmaf(score, a.scale2, __ldg(bias + min(j0 + j, a.L - 1)) * kLog2e) : -INFINITY;
        mx = fmaxf(mx, sc[g]);
      }
      if (mx > m) {  // a new maximum (always at the first group): rescale what is summed
        const float r = exp2f(m - mx);
        sum *= r;
#pragma unroll
        for (int i = 0; i < kSlice; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] *= r;
        }
        m = mx;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float p = exp2f(sc[g] - m);
        sum += p;
        const double pd = p;
        const double* vr = smem + S::kV + (slot * kC + jj + g) * kR;
#pragma unroll
        for (int i = 0; i < kSlice; ++i) {
          const double2 x = *reinterpret_cast<const double2*>(vr + 4 * (tq + 4 * i));
          const double2 y = *reinterpret_cast<const double2*>(vr + 4 * (tq + 4 * i) + 2);
          o[i][0] = fma(pd, x.x, o[i][0]);
          o[i][1] = fma(pd, x.y, o[i][1]);
          o[i][2] = fma(pd, y.x, o[i][2]);
          o[i][3] = fma(pd, y.y, o[i][3]);
        }
      }
    }
  }
  if (!live) return;
  const double inv = 1.0 / static_cast<double>(sum);
  float4* dst = reinterpret_cast<float4*>(a.out + b * a.ob + h * a.oh + row * a.ol);
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    dst[tq + 4 * i] = make_float4(static_cast<float>(o[i][0] * inv), static_cast<float>(o[i][1] * inv),
                                  static_cast<float>(o[i][2] * inv), static_cast<float>(o[i][3] * inv));
  }
}

// ---- DMMA: float64 products on the FP64 tensor cores ----------------------
//
// The resident bodies of both kernels' f64 instances (L <= 128, D <= 32)
// run their products as mma.sync m16n8k16 with float64 operands and
// accumulators (sm_90), at the FP64 tensor cores' 67 TFLOP/s. Its fragments
// (CUTLASS's SM90_16x8x16_F64F64F64F64_TN): lane (g, t) = (lane / 4,
// lane % 4) holds A's value i at row g + 8 (i % 2), column t + 4 (i / 2),
// B's value j at row t + 4 j, column g, and the accumulator's c0, c1 at row
// g, columns 2t, 2t + 1, c2, c3 at row g + 8. The products sum over the
// contracted dimension, so its order is free as long as A and B agree: a
// "chunk" is 16 of its values, and lane t takes the four values
// 4t .. 4t + 3 of a chunk (columns 16 c + 4t .. of q, K and the table, read
// as 16-byte vectors) as k = t, t + 4, t + 8, t + 12; of p.v's keys, the
// four its score accumulators hold (2t, 2t + 1 of two n-tiles), so that P
// is an A operand as it lies. m16n8k8 and m16n8k4, timed in both kernels,
// were not kept (the kernels' notes give their times).

// c += one chunk's products, one m16n8k16: r0 and r8 the lane's four A
// values of rows g and g + 8 (float values widened here), b its four B
// values, value j of each at k = t + 4 j.
template <typename TA>
__device__ __forceinline__ void dmma_chunk(double (&c)[4], const TA (&r0)[4], const TA (&r8)[4],
                                           const double (&b)[4]) {
  const double a[8] = {r0[0], r8[0], r0[1], r8[1], r0[2], r8[2], r0[3], r8[3]};
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]),
        "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Four floats widened to float64.
__device__ __forceinline__ void widen(double (&x)[4], const float4 u) {
  x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
}

// Four consecutive values of shared memory (16-byte aligned) as float64:
// two 16-byte loads of doubles, or one of floats widened.
__device__ __forceinline__ void load4(double (&x)[4], const double* p) {
  const double2 u = reinterpret_cast<const double2*>(p)[0], w = reinterpret_cast<const double2*>(p)[1];
  x[0] = u.x, x[1] = u.y, x[2] = w.x, x[3] = w.y;
}

__device__ __forceinline__ void load4(double (&x)[4], const float* p) {
  widen(x, *reinterpret_cast<const float4*>(p));
}

// Two consecutive doubles (16-byte aligned) into x[0], x[1].
__device__ __forceinline__ void load2(double* x, const double* p) {
  const double2 u = *reinterpret_cast<const double2*>(p);
  x[0] = u.x, x[1] = u.y;
}

// Four floats stored widened as consecutive doubles (16-byte aligned).
__device__ __forceinline__ void store4(double* p, const float4 u) {
  reinterpret_cast<double2*>(p)[0] = make_double2(u.x, u.y);
  reinterpret_cast<double2*>(p)[1] = make_double2(u.z, u.w);
}

}  // namespace f64

}  // namespace attn
