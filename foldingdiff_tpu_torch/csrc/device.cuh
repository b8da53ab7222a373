// Device-side helpers shared by the attention kernels of this directory:
// cp.async copies into shared memory, float32 FMA dot products, and the
// tensor-core pieces of their instances (the arithmetics of their products:
// operand rounding and the parts of the multi-pass presets, ldmatrix
// fragment loads, mma.sync m16n8k8 (TF32) and m16n8k16 (bf16) tiles, the
// products of parts split once and run over independent accumulators, the
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
// exact in float32 (a TF32 part has 11 significant bits, a bf16 part 8):
// TF32 parts run on the TF32 tensor cores, bf16 parts on the bf16 ones, so
// the instances compute the presets' products and differ from the plain
// versions only in the order of the float32 sums.
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
// rounding instance's operand, rounded once at the load; in the forms that
// split at the mma (mma<A>, mma_split), a multi-pass instance's float32
// value.
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
// v1 split each operand once instead (split4, products below), but for
// TF32x3 where that lost (mma_split above).
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
// unrolled, the smallest first. The TF32x3 instances' form where it beats
// splitting once (v1, and the resident v2 design at L <= 64; PERF.md §6):
// A's parts are made anew at every call (the empty asm hides that a is the
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
// scripts/kernel_times_two_trees.py). TF32x3 keeps mma_split where that won
// (PERF.md §6).

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

}  // namespace attn
