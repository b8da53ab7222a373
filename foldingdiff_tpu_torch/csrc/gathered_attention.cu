// Fused BERT self-attention over a gathered relative-position tensor, for Hopper.
//
// Replaces the Pallas TPU kernels foldingdiff_tpu/ops/pallas_attention.py:
// _attn_rel_kernel with _one_head_t (HAS_REL = true) and _attn_kernel
// (HAS_REL = false), entry fused_attention. For every (b, h) pair and query
// row l it computes
//
//   s[j]   = (q[l] . k[j] + q[l] . e_lr[l, j]) * D^-1/2 + bias[b, j]
//   out[l] = softmax_j(s) . v
//
// with q, k, v, out (B, H, L, D) float32 contiguous, bias (B, L) the additive
// key mask (0 or -10000) and e_lr any (L, L, D) float32 tensor, contiguous: it
// is gathered from the caller's position ids, so nothing here assumes it is
// Toeplitz. The relative term is added before the scale, as in HF BERT.
//
// Three instances, one per matmul precision of the model (the caller picks
// one by `instance`; ops/attention.py maps the model's mode onto it), each
// computing the products that the JAX model's einsums compute in that mode:
//   0 FMA   (IEEE float32, "highest"): gathered_attention_kernel, float32 FMA
//           on the CUDA cores;
//   1 TF32  ("high", and "default" under a caller's TF32):
//           gathered_attention_tf32_kernel, q.k, q.e_lr and p.v on TF32
//           tensor cores (mma.sync m16n8k8), each operand rounded to TF32 by
//           cvt.rna.tf32.f32 (to nearest, ties away from zero), float32 sums;
//   2 bf16  ("BF16_BF16_F32"): gathered_attention_bf16_kernel, the TF32 body
//           on operands rounded to bf16 values (to nearest even): q, k, v and
//           e_lr as their fragments are loaded, P before p.v. TF32 holds
//           bf16's 8 significant bits, so each product is the exact product of
//           two bf16 values and the sums are float32, as JAX's preset defines.
//           P is normalised before it is rounded, as the einsum's operand is
//           the softmax's output: with more than one chunk of keys a first
//           pass over the keys finds each row's maximum and sum.
// Softmax is float32 in every instance, in exp2 units with the scale folded
// in.
//
// The first design (one block per (b, h) pair and tile of query rows, e_lr
// streamed from global memory by every thread) was bound by L2 traffic: e_lr
// does not depend on b or h, yet each of the 768 pairs of a flagship call
// (B = 64, H = 12, L = 128, D = 32) read all 2 MiB of it, 1.61 GB per call at
// ~4.0 TB/s: 0.4048 ms against 0.3175 ms for the plain PyTorch version on an
// H100 80GB HBM3 at 700 W, with the FMAs at 9% of the float32 CUDA-core peak.
//
// FMA design: a block owns a tile of R = 16 query rows and a group of P = 8
// consecutive (b, h) pairs (a group may span batch items), 128 threads. The
// block walks the keys in chunks of Jc = 128 / D (4 at D = 32) and stages,
// per chunk, e_lr[l0:l0+R, j0:j0+Jc, :] once for all P pairs, the P pairs' K
// and V rows of the chunk and their bias entries: two stages in dynamic
// shared memory, filled with 16-byte cp.async (4-byte for the bias), so the
// next chunk's loads overlap this chunk's FMAs.
//
// A 16-byte shared load is served a quarter-warp (8 lanes) per wavefront, so
// what a thread reads from shared memory per FMA sets the pace, however many
// lanes share a word. One (row, pair) output per thread reads K, e_lr and V
// once per FMA (3 D floats per key for 3 D FMAs). Here a quad of 4 threads
// owns 2 rows x 2 pairs, each lane a quarter of D of all four: per key a lane
// reads 6 D / 4 floats for the same 3 D FMAs, and the quad sums its partial
// scores with 2 xor-shuffles per output, which leave the same bits in every
// lane. Each lane keeps its slices of q and of the four output rows in
// registers and runs the online softmax of all four (in exp2 units), rescaled
// once per chunk. The two quads of an 8-lane phase share their rows and take
// pairs one apart; staged rows are Jc * D + 16 floats apart (16 mod 32), so
// their K and V reads fill the 32 banks and their e_lr reads coincide. Keys
// past L, rows past L and pairs past B * H are zero-filled in shared memory,
// keys past L are scored -inf, and nothing is written for the rest. The mask is
// the additive -10000, never -inf, so padded query rows still produce output.
//
// Per stage: (R + 2P) * (Jc * D + 16) + P * Jc floats, 18,560 bytes at D = 32,
// 37,120 double-buffered. ptxas puts the D = 32 instances at 165-168
// registers; __launch_bounds__ asks for three blocks (12 warps) per SM, which
// the register file then holds without spills. A cap of 128 registers (four
// blocks) spilled and ran slower, and so did R = 32 or Jc * D = 256. Shared
// memory does not grow with L, so no length is refused for it.
//
// What bounds the FMA instance, per flagship call: 2.42 GFLOP of FMAs (3 L^2 D
// per pair: q.k, q.e and p.v), 36 us at the 67 TFLOP/s float32 peak;
// shared-memory reads of 6 D / 4 floats per (thread, key) plus 8 shuffles, 56
// wavefronts per warp and key, 22 M wavefronts, ~95 us at one wavefront per
// clock per SM (132 SMs, 1.755 GHz); L2 reads of ceil(BH / P) * L^2 * D * 4 =
// 201 MB of e_lr (8x less than before), ceil(L / R) * BH * L * D * 8 = 201 MB
// of K and V and 25 MB of q and out, 428 MB in all; device memory sees ~52 MB
// (e_lr once, q, k, v, out). It stays float32 FMA for IEEE parity, which on
// tensor cores would need the 3xTF32 split (three products per term).
//
// Tensor-core design (TF32 and bf16). The products cost 4.9 us per flagship
// call at the 495 TFLOP/s TF32 rate. The relative term is not a product
// over query rows: rel[n, l, j] = q[n, l] . e_lr[l, j] takes another e_lr
// row block for every row l. It is one over pairs at a fixed row:
// (pairs x D) . (D x keys). So a block of 16 warps (512 threads) owns
// P = 16 pairs and R = 16 query rows, and walks the keys in chunks of 32
// (16 at D = 64):
//   - The relative term. Warp w computes row l0 + w for the 16 pairs:
//     C = Q_l . E_l^T, the pairs the m16n8k8 tile's 16 rows, the chunk's
//     keys its columns, E_l's B fragments read from L2 (each e_lr element
//     once per block, for 16 pairs: 100 MB per flagship call). It stores C
//     transposed into one of two (pair, row, key) buffers in shared memory
//     (rows Jc + 8 floats apart, pairs 16 (Jc + 8) + 8: the float2 stores
//     and loads fall on 32 distinct banks), one chunk ahead, so a chunk
//     needs one barrier.
//   - Then warp w takes pair n0 + w's 16 rows, as the v2 kernel's
//     tensor-core warps do: scores start from the buffer's rel values,
//     S += Q . K^T, then scale and bias in one FMA, keys past L scored -inf;
//     the softmax online over chunks (bf16: normalised, as above); p . v from
//     the score accumulators as they are, each k-step's keys in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) for P and V alike (the accumulator holds
//     columns 2t, 2t + 1 where the A fragment wants t, t + 4).
//   - K, V and the bias of a pair are read by its warp alone, so the warp
//     reads their fragments straight from L2 (201 MB of K and V per flagship
//     call); nothing of them is staged.
//   - Both A operands come from the block's 16 x 16 x D q tile, staged once
//     in shared memory (rows with their 16-float halves swapped on odd rows,
//     pairs 16 mod 32 floats apart: conflict-free either way) and loaded per
//     chunk, so that no q register lives across the loop: 512 threads have
//     128 registers each, and ptxas hoists every independent L2 load it can.
//   - The products sum over d, so each k-step may take any 8 of D's columns
//     as long as A and B agree: k-step 2c + h takes 16c + 4t + 2h (k = t) and
//     16c + 4t + 2h + 1 (k = t + 4), so that every lane reads its q, K and
//     e_lr columns as float4s; p . v's output columns are permuted the same
//     way, so that V is read and out written as float4s.
// Measured at the flagship shape (scripts/gathered_attention_variants.py,
// NVIDIA H100 80GB HBM3, 700 W, in turns with the FMA instance's 0.1364 ms):
// TF32 0.0773 ms with e_lr, 0.0468 without; bf16 0.1237 (two passes).
// What the design went through, in that script's runs:
//   - K, V and e_lr staged per chunk of 8 keys through a cp.async ring, two
//     barriers per chunk: 0.1078 ms. Its time tracked the chunks, not the
//     bytes: 32 rows per block (45% fewer L2 bytes) ran slower, a fourth
//     stage changed nothing, 16-key chunks ran 13% faster. A warp's chunk
//     was a 16 x 8 tile whose staging, barriers, fold and rescale cost
//     several hundred instructions for 8 mma.
//   - e_lr read from L2 and the relative term one chunk ahead (one barrier):
//     0.1063, 0.0820 with 16-key chunks.
//   - K and V read by each warp from L2, 32-key chunks: 0.0760, but ptxas
//     spilled at D = 32 and D = 64 with q's fragments in registers; loading
//     q from L2 per k-step instead was 30-45% slower and spilled more; 64-key
//     chunks and 32 rows per block spilled. The staged q tile removed every
//     spill at the same speed.
//
// Rows, keys and pairs outside the tensors read as zeros (zero-filled in
// shared memory, or not loaded), keys past L are scored -inf, and nothing is
// stored for rows past L or pairs past B * H.
//
// Plain C interface for ctypes; the kernel launches on the caller's stream,
// on the given device, allocates nothing and does not synchronise. The
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "device.cuh"
#include "launch.cuh"

namespace {

using namespace attn;

constexpr int kRows = 16;                  // R: query rows per block
constexpr int kPairs = 8;                  // P: (b, h) pairs per block
constexpr int kThreads = kRows * kPairs;   // a quad of 4 threads owns 2 rows x 2 pairs
constexpr int kChunkFloats = 128;          // Jc * D: one staged row of a chunk
constexpr int kStride = kChunkFloats + 16;  // padded row, 16 mod 32 floats
constexpr float kLog2e = 1.4426950408889634f;

// Offsets (floats) in one stage: e_lr rows (HAS_REL only) from 0, then K, V, bias.
template <int D, bool HAS_REL>
struct Stage {
  static constexpr int kKeys = kChunkFloats / D;  // Jc
  static constexpr int kK = HAS_REL ? kRows * kStride : 0;
  static constexpr int kV = kK + kPairs * kStride;
  static constexpr int kBias = kV + kPairs * kStride;
  static constexpr int kFloats = kBias + kPairs * kKeys;  // multiple of 4
};

__device__ __forceinline__ void axpy4(float p, const float4 x, float4& y) {
  y.x = fmaf(p, x.x, y.x);
  y.y = fmaf(p, x.y, y.y);
  y.z = fmaf(p, x.z, y.z);
  y.w = fmaf(p, x.w, y.w);
}

// Issues the copies of the chunk of keys [j0, j0 + Jc) into `st`: e_lr rows
// l0.. of the tile, K and V rows and bias entries of pairs n0... What lies
// outside the tensors is zero-filled with plain stores.
template <int D, bool HAS_REL>
__device__ __forceinline__ void stage_chunk(float* st, const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ e_lr, int H, int L,
                                            long long BH, int l0, long long n0, int j0) {
  using S = Stage<D, HAS_REL>;
  constexpr int kVec = kChunkFloats / 4;  // float4 per staged row
  static_assert(kRows * kVec % kThreads == 0 && kPairs * kVec % kThreads == 0, "even staging");
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t = threadIdx.x;
  if (HAS_REL) {
#pragma unroll
    for (int it = 0; it < kRows * kVec / kThreads; ++it) {
      const int i = t + it * kThreads;
      const int r = i / kVec, c = i % kVec;
      float* dst = st + r * kStride + 4 * c;
      const int l = l0 + r, j = j0 + (4 * c) / D;
      if (l < L && j < L) {
        cp_async16(dst, e_lr + (static_cast<size_t>(l) * L + j0) * D + 4 * c);
      } else {
        *reinterpret_cast<float4*>(dst) = zero;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kPairs * kVec / kThreads; ++it) {
    const int i = t + it * kThreads;
    const int p = i / kVec, c = i % kVec;
    const long long n = n0 + p;
    const int j = j0 + (4 * c) / D;
    float* kd = st + S::kK + p * kStride + 4 * c;
    float* vd = st + S::kV + p * kStride + 4 * c;
    if (n < BH && j < L) {
      const size_t off = (static_cast<size_t>(n) * L + j0) * D + 4 * c;
      cp_async16(kd, k + off);
      cp_async16(vd, v + off);
    } else {
      *reinterpret_cast<float4*>(kd) = zero;
      *reinterpret_cast<float4*>(vd) = zero;
    }
  }
  if (t < kPairs * S::kKeys) {
    const int p = t / S::kKeys, jj = t % S::kKeys;
    const long long n = n0 + p;
    float* dst = st + S::kBias + t;
    if (n < BH && j0 + jj < L) {
      cp_async4(dst, bias + static_cast<size_t>(n / H) * L + j0 + jj);
    } else {
      *dst = 0.0f;
    }
  }
}

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 3 : 1)
gathered_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ e_lr, float* __restrict__ out, int H, int L,
                          long long BH, int n_tiles, float scale) {
  using S = Stage<D, HAS_REL>;
  constexpr int Jc = S::kKeys;
  constexpr int kSlice = D / 16;  // float4 pieces of a D-vector per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // Quad layout: lane tq of quad `quad` holds the float4 pieces tq, tq + 4, ...
  // of each D-vector of the quad's 4 outputs (rows r0, r0 + 1) x (pairs pa, pb).
  // The two quads of an 8-lane phase share their rows and take pairs one
  // apart, so their K and V loads land kStride = 16 mod 32 floats apart.
  const int tq = threadIdx.x & 3;
  const int quad = threadIdx.x >> 2;
  const int r0 = 2 * (quad >> 2);
  const int pa = (quad & 1) + ((quad >> 1) & 1) * 4;  // 0, 1, 4, 5
  const int pb = pa + 2;
  const int l0 = (blockIdx.x % n_tiles) * kRows;
  const long long n0 = static_cast<long long>(blockIdx.x / n_tiles) * kPairs;

  // output o = 2 * row + pair: (r0, pa), (r0, pb), (r0 + 1, pa), (r0 + 1, pb)
  float4 qr[4][kSlice];
  float4 acc[4][kSlice];
  float row_max[4], denom[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int l = l0 + r0 + (o >> 1);
    const long long n = n0 + ((o & 1) ? pb : pa);
    const bool live = l < L && n < BH;
    const float* src = q + (static_cast<size_t>(live ? n : 0) * L + (live ? l : 0)) * D;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      qr[o][i] = live ? __ldg(reinterpret_cast<const float4*>(src) + tq + 4 * i)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc[o][i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    row_max[o] = -INFINITY;
    denom[o] = 0.0f;
  }
  const float scale2 = scale * kLog2e;  // scores in log2 units, for exp2f

  const int n_chunks = (L + Jc - 1) / Jc;
  stage_chunk<D, HAS_REL>(smem, k, v, bias, e_lr, H, L, BH, l0, n0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk<D, HAS_REL>(smem + ((c + 1) & 1) * S::kFloats, k, v, bias, e_lr, H, L, BH, l0,
                              n0, (c + 1) * Jc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* st = smem + (c & 1) * S::kFloats;
    const float4* e0 = reinterpret_cast<const float4*>(st + r0 * kStride);  // HAS_REL only
    const float4* e1 = reinterpret_cast<const float4*>(st + (r0 + 1) * kStride);
    const float4* ka = reinterpret_cast<const float4*>(st + S::kK + pa * kStride);
    const float4* kb = reinterpret_cast<const float4*>(st + S::kK + pb * kStride);
    const float4* va = reinterpret_cast<const float4*>(st + S::kV + pa * kStride);
    const float4* vb = reinterpret_cast<const float4*>(st + S::kV + pb * kStride);
    const float* bias_a = st + S::kBias + pa * Jc;
    const float* bias_b = st + S::kBias + pb * Jc;
    const int valid = min(Jc, L - c * Jc);

    float s[4][Jc];
#pragma unroll
    for (int jj = 0; jj < Jc; ++jj) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        const int x = jj * (D / 4) + tq + 4 * i;
        const float4 kxa = ka[x], kxb = kb[x];
        part[0] = dot4(qr[0][i], kxa, part[0]);
        part[1] = dot4(qr[1][i], kxb, part[1]);
        part[2] = dot4(qr[2][i], kxa, part[2]);
        part[3] = dot4(qr[3][i], kxb, part[3]);
        if (HAS_REL) {
          const float4 ex0 = e0[x], ex1 = e1[x];
          part[0] = dot4(qr[0][i], ex0, part[0]);
          part[1] = dot4(qr[1][i], ex0, part[1]);
          part[2] = dot4(qr[2][i], ex1, part[2]);
          part[3] = dot4(qr[3][i], ex1, part[3]);
        }
      }
      const float ba = bias_a[jj] * kLog2e, bb = bias_b[jj] * kLog2e;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        // sum over the quad: every lane ends with the same bits
        part[o] += __shfl_xor_sync(0xffffffffu, part[o], 1);
        part[o] += __shfl_xor_sync(0xffffffffu, part[o], 2);
        s[o][jj] = jj < valid ? fmaf(part[o], scale2, (o & 1) ? bb : ba) : -INFINITY;
      }
    }

    // fold the chunk into the running maxima and sums
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      float m = row_max[o];
#pragma unroll
      for (int jj = 0; jj < Jc; ++jj) m = fmaxf(m, s[o][jj]);
      const float c_old = exp2f(row_max[o] - m);  // 0 on the first chunk
      row_max[o] = m;
      denom[o] *= c_old;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        acc[o][i].x *= c_old;
        acc[o][i].y *= c_old;
        acc[o][i].z *= c_old;
        acc[o][i].w *= c_old;
      }
    }
#pragma unroll
    for (int jj = 0; jj < Jc; ++jj) {
      float p[4];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        p[o] = exp2f(s[o][jj] - row_max[o]);
        denom[o] += p[o];
      }
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        const int x = jj * (D / 4) + tq + 4 * i;
        const float4 vxa = va[x], vxb = vb[x];
        axpy4(p[0], vxa, acc[0][i]);
        axpy4(p[1], vxb, acc[1][i]);
        axpy4(p[2], vxa, acc[2][i]);
        axpy4(p[3], vxb, acc[3][i]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int l = l0 + r0 + (o >> 1);
    const long long n = n0 + ((o & 1) ? pb : pa);
    if (l >= L || n >= BH) continue;
    const float inv = 1.0f / denom[o];
    float4* dst = reinterpret_cast<float4*>(out + (static_cast<size_t>(n) * L + l) * D);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const float4 a = acc[o][i];
      dst[tq + 4 * i] = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  }
}

template <int D, bool HAS_REL>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* e_lr, float* out, int B, int H, int L, int device,
                   cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = &gathered_attention_kernel<D, HAS_REL>;
  const size_t smem = 2 * sizeof(float) * Stage<D, HAS_REL>::kFloats;
  const cudaError_t err =
      attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  const long long bh = static_cast<long long>(B) * H;
  const int n_tiles = (L + kRows - 1) / kRows;
  const long long blocks = n_tiles * ((bh + kPairs - 1) / kPairs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, bias, e_lr, out, H, L, bh, n_tiles, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// ---- Tensor-core instances (TF32, and bf16 on rounded operands) ----------

namespace tc {

constexpr int kPairs = 16;   // (b, h) pairs per block: the M of the relative term's products
constexpr int kRows = 16;    // query rows per block: the M of q.k and p.v
constexpr int kWarps = 16;   // warp w: row l0 + w of the relative term, then pair n0 + w's rows
constexpr int kThreads = 32 * kWarps;
static_assert(kWarps == kPairs && kWarps == kRows, "one pair and one query row per warp");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* e_lr;
  float* out;
  int H, L;
  long long BH;
  int n_tiles;
  float scale2;  // D^-1/2 * log2(e)
};

// Floats between two pairs' rows in the staged q tile (16 mod 32).
template <int D>
constexpr int kQPair = kRows * D + 16;

// The chunk of keys, and the offsets (floats) into dynamic shared memory:
// two buffers of the relative term's (pair, row, key) values (HAS_REL only),
// then the block's q tile, 16 pairs x 16 rows.
template <int D, bool HAS_REL>
struct Smem {
  static constexpr int kKeys = D <= 32 ? 32 : 16;  // keys per chunk
  static constexpr int kRelRow = kKeys % 16 == 0 ? kKeys + 8 : kKeys;  // 8 mod 16
  static constexpr int kRelPair = kRows * kRelRow + 8;                 // 8 mod 32
  static constexpr int kRelBuf = kPairs * kRelPair;
  static constexpr int kQ = HAS_REL ? 2 * kRelBuf : 0;
  static constexpr int kFloats = kQ + kPairs * kQPair<D>;
};

// Columns 16c + 4t .. 16c + 4t + 3 of row `row` of the (rows, D) matrix at
// `base` in global memory; zero for a row past `rows`.
template <int D>
__device__ __forceinline__ float4 columns(const float* base, int rows, int row, int c, int t) {
  return row < rows ? __ldg(reinterpret_cast<const float4*>(base + static_cast<size_t>(row) * D + 16 * c + 4 * t))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Staged q rows are D floats; odd rows have their 16-float halves swapped
// (D >= 32), and pairs are 16 mod 32 floats apart, so that the float4
// fragment loads of an 8-lane phase, rows g and g + 1 of a pair or pairs g
// and g + 1 of a row, fall on 32 distinct banks.
template <int D>
__device__ __forceinline__ int q_offset(int pair, int row, int f) {
  return pair * kQPair<D> + row * D + 4 * (f ^ (D >= 32 ? 4 * (row & 1) : 0));
}

// The A fragments of a 16-row operand of the staged q tile `qs` whose rows
// g and g + 8 are (pair p0, row r0) and (p1, r1). The products sum over d,
// so a k-step may take any 8 columns that A and B share: k-step 2c + h takes
// columns 16c + 4t + 2h (k = t) and 16c + 4t + 2h + 1 (k = t + 4), and each
// lane reads its columns as float4s.
template <int D, bool BF16>
__device__ __forceinline__ void q_fragments(uint32_t (&f)[D / 8][4], const float* qs, int p0, int r0, int p1,
                                            int r1, int t) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 u = *reinterpret_cast<const float4*>(qs + q_offset<D>(p0, r0, 4 * c + t));
    const float4 w = *reinterpret_cast<const float4*>(qs + q_offset<D>(p1, r1, 4 * c + t));
    f[2 * c][0] = operand<BF16>(u.x);
    f[2 * c][1] = operand<BF16>(w.x);
    f[2 * c][2] = operand<BF16>(u.y);
    f[2 * c][3] = operand<BF16>(w.y);
    f[2 * c + 1][0] = operand<BF16>(u.z);
    f[2 * c + 1][1] = operand<BF16>(w.z);
    f[2 * c + 1][2] = operand<BF16>(u.w);
    f[2 * c + 1][3] = operand<BF16>(w.w);
  }
}

// c += A . B^T over D, this lane's B row row `row` of the (rows, D) matrix at
// `base` (k-steps as in q_fragments).
template <int D, bool BF16>
__device__ __forceinline__ void product(float (&c)[4], const uint32_t (&a)[D / 8][4], const float* base, int rows,
                                        int row, int t) {
  float4 y[D / 16];
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) y[cc] = columns<D>(base, rows, row, cc, t);
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) {
    mma(c, a[2 * cc], operand<BF16>(y[cc].x), operand<BF16>(y[cc].y));
    mma(c, a[2 * cc + 1], operand<BF16>(y[cc].z), operand<BF16>(y[cc].w));
  }
}

// V's columns as p . v's n-tiles take them: n-tile dn's column g is
// 8W (dn / W) + W g + dn % W, W = min(4, D / 8), so that each lane reads W
// consecutive columns of a key's row, and writes W consecutive columns of out.
template <int D>
struct VCols {
  static constexpr int kW = D / 8 < 4 ? D / 8 : 4;
  static constexpr int kBlocks = D / (8 * kW);
};

// W consecutive floats of global memory at p, or zeros where `live` is false.
template <int W>
__device__ __forceinline__ void load_cols(float (&x)[W], const float* p, bool live) {
  if constexpr (W == 4) {
    const float4 u = live ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  } else {
    const float2 u = live ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.0f, 0.0f);
    x[0] = u.x, x[1] = u.y;
  }
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int D, bool HAS_REL, bool BF16>
__device__ __forceinline__ void attention(const Args& a) {
  using S = Smem<D, HAS_REL>;
  using V = VCols<D>;
  constexpr int kKS = D / 8;           // k-steps of q.k and the relative term, n-tiles of p.v
  constexpr int kNT = S::kKeys / 8;    // key n-tiles per chunk
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int l0 = (blockIdx.x % a.n_tiles) * kRows;
  const long long n0 = static_cast<long long>(blockIdx.x / a.n_tiles) * kPairs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // The warp's pair; past B * H its q, K and V read as zeros and nothing is stored
  const long long n = n0 + warp;
  const bool live = n < a.BH;
  const int keys = live ? a.L : 0;  // K and V rows the warp reads
  const float* kp = a.k + static_cast<size_t>(live ? n : 0) * a.L * D;
  const float* vp = a.v + static_cast<size_t>(live ? n : 0) * a.L * D;
  const float* bias = a.bias + static_cast<size_t>(live ? n / a.H : 0) * a.L;
  const int lr = l0 + warp;  // the warp's row of the relative term
  const int rel_keys = lr < a.L ? a.L : 0;
  const float* e_row = a.e_lr + static_cast<size_t>(rel_keys ? lr : 0) * a.L * D;  // e_lr[lr]: (L, D)

  // The block's q tile, rows l0.. of pairs n0.., staged once: q.k's A
  // operand is pair `warp`'s 16 rows, the relative term's row `warp` of the
  // 16 pairs, both loaded per chunk, so that no q register lives across the
  // loop (512 threads have 128 registers each)
  float* qs = smem + S::kQ;
#pragma unroll 1
  for (int i = threadIdx.x; i < kPairs * kRows * (D / 4); i += kThreads) {
    const int p = i / (kRows * (D / 4)), r = i / (D / 4) % kRows, f = i % (D / 4);
    float* d = qs + q_offset<D>(p, r, f);
    if (n0 + p < a.BH && l0 + r < a.L) {
      cp_async16(d, a.q + ((static_cast<size_t>(n0 + p) * a.L + l0 + r) * D + 4 * f));
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float o[kKS][4];  // p.v's accumulators: rows g, g + 8, columns as VCols orders them
#pragma unroll
  for (int dn = 0; dn < kKS; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {1.0f, 1.0f};

  const int n_chunks = (a.L + S::kKeys - 1) / S::kKeys;
  // bf16 rounds the normalised P: with several chunks, pass 0 finds each
  // row's maximum and sum first; item i is chunk i % n_chunks of pass
  // first_pass + i / n_chunks
  const bool stats_pass = BF16 && n_chunks > 1;
  const int first_pass = stats_pass ? 0 : 1;
  const int n_items = (2 - first_pass) * n_chunks;
  // Row lr of item i's relative term for the block's 16 pairs, into rel
  // buffer i % 2 as [pair][row][key]: the pairs are the m16n8k8 tile's rows,
  // the chunk's keys its columns. Past the last item it computes chunk 0
  // again, which nothing reads.
  auto relative_term = [&](int i) {
    const int j0 = (i % n_chunks) * S::kKeys;
    float* buf = smem + (i & 1) * S::kRelBuf;
    uint32_t qr[kKS][4];
    q_fragments<D, BF16>(qr, qs, g, warp, g + 8, warp, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      product<D, BF16>(acc, qr, e_row, rel_keys, j0 + 8 * nt + g, t);
      float* d = buf + g * S::kRelPair + warp * S::kRelRow + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(d) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(d + 8 * S::kRelPair) = make_float2(acc[2], acc[3]);
    }
  };

  if (HAS_REL) relative_term(0);
#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    const int pass = first_pass + it / n_chunks, c = it % n_chunks, j0 = c * S::kKeys;
    const float* rel = smem + (it & 1) * S::kRelBuf;
    if (HAS_REL) {
      // item it's relative term is in rel buffer it % 2; every warp is done
      // with the other buffer, which the next item's relative term fills,
      // interleaved by the compiler with this item's work below
      __syncthreads();
      relative_term(it + 1);
    }

    // S = rel + Q . K^T; then scale and bias, in log2 units
    uint32_t qf[kKS][4];
    q_fragments<D, BF16>(qf, qs, warp, g, warp, g + 8, t);
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (HAS_REL) {
        const float* r = rel + warp * S::kRelPair + g * S::kRelRow + 8 * nt + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(r);
        const float2 r1 = *reinterpret_cast<const float2*>(r + 8 * S::kRelRow);
        s[nt][0] = r0.x, s[nt][1] = r0.y, s[nt][2] = r1.x, s[nt][3] = r1.y;
      } else {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      }
      product<D, BF16>(s[nt], qf, kp, keys, j0 + 8 * nt + g, t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + 8 * nt + 2 * t + e;
        const float bias2 = col < a.L ? __ldg(bias + col) * kLog2e : -INFINITY;
        s[nt][e] = fmaf(s[nt][e], a.scale2, bias2);
        s[nt][2 + e] = fmaf(s[nt][2 + e], a.scale2, bias2);
      }
    }

    float rescale[2];
    if (!BF16) {
      fold(s, m, l, rescale);  // online: P unnormalised, the output rescaled
#pragma unroll
      for (int dn = 0; dn < kKS; ++dn) {
        o[dn][0] *= rescale[0];
        o[dn][1] *= rescale[0];
        o[dn][2] *= rescale[1];
        o[dn][3] *= rescale[1];
      }
    } else if (pass == 0 || !stats_pass) {
      fold(s, m, l, rescale);  // the stats pass; or the only chunk, which holds every key
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = exp2f(s[nt][i] - m[i / 2]);
      }
    }
    if (BF16 && pass == 1) {
      if (c == 0) {
        inv[0] = 1.0f / quad_sum(l[0]);
        inv[1] = 1.0f / quad_sum(l[1]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = bf16_value(s[nt][i] * inv[i / 2]);
      }
    }

    if (pass == 1) {
      // p . v: key n-tile nt as one k-step, its keys in the order 2t, 2t + 1
      // (lane t's a0/a1 and a2/a3 columns) for P and V alike
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint32_t pa[4] = {operand<BF16>(s[nt][0]), operand<BF16>(s[nt][2]), operand<BF16>(s[nt][1]),
                                operand<BF16>(s[nt][3])};
        const int key = j0 + 8 * nt + 2 * t;
        const float* v0 = vp + static_cast<size_t>(key) * D + V::kW * g;
#pragma unroll
        for (int hb = 0; hb < V::kBlocks; ++hb) {
          float x0[V::kW], x1[V::kW];
          load_cols(x0, v0 + 8 * V::kW * hb, key < keys);
          load_cols(x1, v0 + D + 8 * V::kW * hb, key + 1 < keys);
#pragma unroll
          for (int dd = 0; dd < V::kW; ++dd) {
            mma(o[V::kW * hb + dd], pa, operand<BF16>(x0[dd]), operand<BF16>(x1[dd]));
          }
        }
      }
    }
  }

  if (!live) return;
  if (!BF16) {
    inv[0] = 1.0f / quad_sum(l[0]);
    inv[1] = 1.0f / quad_sum(l[1]);
  } else {
    inv[0] = inv[1] = 1.0f;  // P was normalised
  }
  // o[W hb + dd][2 i + e] is row l0 + g + 8 i, column 8W hb + W (2t + e) + dd
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = l0 + g + 8 * i;
    if (row >= a.L) continue;
    float* dst = a.out + (static_cast<size_t>(n) * a.L + row) * D;
#pragma unroll
    for (int hb = 0; hb < V::kBlocks; ++hb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[V::kW];
#pragma unroll
        for (int dd = 0; dd < V::kW; ++dd) x[dd] = o[V::kW * hb + dd][2 * i + e] * inv[i];
        store_cols(dst + 8 * V::kW * hb + V::kW * (2 * t + e), x);
      }
    }
  }
}

}  // namespace tc

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_tf32_kernel(const tc::Args a) {
  tc::attention<D, HAS_REL, false>(a);
}

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_bf16_kernel(const tc::Args a) {
  tc::attention<D, HAS_REL, true>(a);
}

template <int D, bool HAS_REL, bool BF16>
cudaError_t launch_tc(const float* q, const float* k, const float* v, const float* bias,
                      const float* e_lr, float* out, int B, int H, int L, int device,
                      cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel =
      BF16 ? &gathered_attention_bf16_kernel<D, HAS_REL> : &gathered_attention_tf32_kernel<D, HAS_REL>;
  const size_t smem = sizeof(float) * tc::Smem<D, HAS_REL>::kFloats;
  const cudaError_t err =
      attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  tc::Args a{q, k, v, bias, e_lr, out, H, L, static_cast<long long>(B) * H, (L + tc::kRows - 1) / tc::kRows,
             kLog2e / sqrtf(static_cast<float>(D))};
  const long long blocks = a.n_tiles * ((a.BH + tc::kPairs - 1) / tc::kPairs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// instance: 0 FMA, 1 TF32, 2 bf16 (see the note at the top)
template <int D, bool HAS_REL>
cudaError_t dispatch_instance(const float* q, const float* k, const float* v, const float* bias,
                              const float* e_lr, float* out, int B, int H, int L, int instance,
                              int device, cudaStream_t stream) {
  switch (instance) {
    case 0: return launch<D, HAS_REL>(q, k, v, bias, e_lr, out, B, H, L, device, stream);
    case 1: return launch_tc<D, HAS_REL, false>(q, k, v, bias, e_lr, out, B, H, L, device, stream);
    case 2: return launch_tc<D, HAS_REL, true>(q, k, v, bias, e_lr, out, B, H, L, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t dispatch_rel(const float* q, const float* k, const float* v, const float* bias,
                         const float* e_lr, float* out, int B, int H, int L, int has_rel,
                         int instance, int device, cudaStream_t stream) {
  return has_rel
             ? dispatch_instance<D, true>(q, k, v, bias, e_lr, out, B, H, L, instance, device, stream)
             : dispatch_instance<D, false>(q, k, v, bias, e_lr, out, B, H, L, instance, device, stream);
}

cudaError_t dispatch(const float* q, const float* k, const float* v, const float* bias,
                     const float* e_lr, float* out, int B, int H, int L, int D, int has_rel,
                     int instance, int device, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_rel<16>(q, k, v, bias, e_lr, out, B, H, L, has_rel, instance, device, s);
    case 32: return dispatch_rel<32>(q, k, v, bias, e_lr, out, B, H, L, has_rel, instance, device, s);
    case 64: return dispatch_rel<64>(q, k, v, bias, e_lr, out, B, H, L, has_rel, instance, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `e_lr` is the contiguous (L, L, D) tensor, or null when has_rel is 0; q, k,
// v and e_lr are 16-byte aligned. `instance` picks the arithmetic: 0 FMA,
// 1 TF32, 2 bf16. `device` is the index of the device that holds the tensors
// and `stream`.
extern "C" int gathered_attention_forward(const float* q, const float* k, const float* v,
                                          const float* bias, const float* e_lr, float* out,
                                          int B, int H, int L, int D, int has_rel, int instance,
                                          int device, void* stream) {
  return attn::on_device(device, [&] {
    return dispatch(q, k, v, bias, e_lr, out, B, H, L, D, has_rel, instance, device,
                    static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* gathered_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
