// Fused BERT self-attention with HF `relative_key` position scores, for Hopper.
//
// Replaces the Pallas TPU kernels foldingdiff_tpu/ops/pallas_attention.py:
// _attn_rel_kernel_v2 (HAS_REL = true) and _attn_kernel_v2 (HAS_REL = false),
// entry fused_attention_v2. For every batch item b, head h and query row l it
// computes
//
//   s[j]   = (q[l] . k[j] + q[l] . E[l - j + M - 1]) * D^-1/2 + bias[b, j]
//   out[l] = softmax_j(s) . v
//
// with bias (B, L) the additive key mask (0 or -10000, never -inf) and E the
// raw (2M-1, D) distance-embedding table, L <= M. The relative term is added
// before the scale, as in HF BERT. q, k and v are (B, H, L, D) float32 views
// in any layout whose last dimension has stride 1 and whose rows start on 16
// bytes: the denoiser passes the (B, L, H, D) projections as they are. out is
// written as a contiguous (B, L, H, D) buffer, the layout the output
// projection reads.
//
// Three instances, one per matmul precision of the model (the caller picks
// one by `instance`; ops/attention.py maps the model's mode onto it), each
// computing the products that the JAX model's einsums compute in that mode:
//   0 FMA   (IEEE float32, "highest"): rel_attention_kernel, float32 FMA on
//           the CUDA cores;
//   1 TF32  ("high", and "default" under a caller's TF32):
//           rel_attention_tf32_kernel, q.k, q.E and p.v on TF32 tensor cores
//           (mma.sync m16n8k8), each operand rounded to TF32 by
//           cvt.rna.tf32.f32 (to nearest, ties away from zero), float32 sums;
//   2 bf16  ("BF16_BF16_F32"): rel_attention_bf16_kernel, the TF32 body on
//           operands rounded to bf16 values (to nearest even): q, k, v and E
//           as their fragments are loaded, P before p.v. TF32 holds bf16's 8
//           significant bits, so each product is the exact product of two
//           bf16 values and the sums are float32, as JAX's preset defines.
//           P is normalised before it is rounded, as the einsum's operand is
//           the softmax's output: with more than one chunk of keys a first
//           pass over the keys finds each row's maximum and sum.
// Softmax is float32 in every instance, in exp2 units with the scale folded
// in.
//
// What bounds it, per flagship call (B = 64, H = 12, L = 128, D = 32): 3 L^2 D
// multiply-adds per (b, h) pair (q.k, q.E and p.v), 2.42 GFLOP in all, and
// 50.4 MB of q, k, v and out to move. FMA: 36.1 us at the H100's 67 TFLOP/s
// float32 rate outside the tensor cores against 15.0 us of bytes at 3.35
// TB/s, so operations bound it. TF32 and bf16: 4.9 us at 495 TFLOP/s, so the
// bytes bound it, at 15.0 us.
//
// FMA design: register tiles on the CUDA cores. The SM serves one
// shared-memory wavefront (32 lanes x 4 bytes) per clock against four
// warp-wide FMAs, so a thread must do about four FMAs per float it reads from
// shared memory (a first design of one thread per query row read three per
// FMA and ran at 19% of the bound, 0.1894 ms on an H100 80GB HBM3 at 700 W).
// A unit of 64 threads owns one head and a tile of 64 query rows and walks
// the keys in chunks of 64:
//   - Scores. Thread (rg, kg) of the unit owns rows rg + 8 i and keys kg + 8 jj
//     (i, jj < 8). Both step by 8, so l - j = rg - kg + 8 (i - jj) takes 15
//     values: the 64 scores need 8 q rows, 8 k rows and 15 table rows, read
//     as 16-byte vectors, for 128 FMAs per 4 dimensions (31 floats read).
//     The 8 lanes of a quarter-warp share rg and take consecutive kg, so
//     they read consecutive K and table rows, padded to D + 4 floats (4 mod
//     32) onto distinct banks, and one q vector as a broadcast.
//   - Softmax, online over chunks: row maxima and sums across the 8 lanes of
//     a row by xor-shuffles. Probabilities go to shared memory transposed
//     (key-major); the running maxima, denominators and each chunk's rescale
//     factors live in shared memory too, which keeps the thread under the
//     168 registers that three blocks per SM leave it. The d loop and the
//     staging loops are not unrolled, for the same reason: unrolled, ptxas
//     spills.
//   - p . v. Thread (rgp, dg) owns D / 4 consecutive rows x 4 dimensions
//     (8 x 4 at D = 32) and reads per key its rows' probabilities and one V
//     vector: 12 floats for 32 FMAs.
// A block holds two units, two heads of one batch item and one row tile,
// which share the staged table window and bias of every chunk. One head per
// block was 47% slower at B = 64, L = 64 and no faster at the sampler's small
// chunk (scripts/rel_attention_variants.py). Per chunk, K, V, the bias and
// the 127 table rows are filled with 16-byte cp.async (4-byte for the bias);
// V has its own copy group, waited for only before p . v. The probabilities
// overwrite K and the window once the scores are made, so shared memory
// stays 73 KB at D = 32, three blocks (12 warps) per SM. Measured at the
// flagship shape: 0.0787 ms, 46% of its 36.1 us bound (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py phase 2).
//
// Tensor-core design (TF32 and bf16). A block of four warps owns 64 query
// rows of one (b, h), a warp 16 of them, and walks the keys in chunks of 64;
// its grid is B x H x ceil(L / 64) blocks, 180 at the sampler's small chunk
// (B = 15, L = 64). Per chunk the block stages K, V, the bias and the 128
// table rows its rows reach with 16-byte cp.async, rows padded to D + 4
// floats, so that every fragment load below falls on 32 distinct banks. A
// warp keeps its q rows as TF32 A fragments in registers for the whole call.
//   - The relative term is one more product: QE = Q . E_win^T over the 80
//     table rows (79 used) that the warp's 16 rows reach in the chunk, on the
//     tensor cores like q.k (a third of the work: on FMA it would set the
//     floor). QE goes to the warp's own slice of shared memory (rows 88
//     floats apart) and is read back skewed, rel[r, c] = QE[r, r - c + 63],
//     as the first value of each score accumulator: the Toeplitz structure
//     that _skew_rows builds with static rolls on the TPU.
//   - Scores S = Q . K^T: 8 n-tiles of 8 keys, D / 8 k-steps each; scale and
//     bias in one FMA, keys past L scored -inf.
//   - Softmax: row maxima and sums across each row's quad by xor-shuffles;
//     TF32 online over chunks, the sum kept per lane and reduced once at the
//     end; bf16 as above.
//   - p . v from the score accumulators as they are. The accumulator of an
//     m16n8 tile holds columns 2t and 2t + 1 of rows g and g + 8, where the
//     A fragment of m16n8k8 wants columns t and t + 4: the products are
//     summed over the keys, so the k-step takes its 8 keys in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) for P and V alike, and each lane reads V rows
//     2t and 2t + 1. No shuffle, no trip through shared memory.
// Why mma.sync and not wgmma: at TF32 the operations' floor (4.9 us) is a
// third of the bytes' (15.0 us), so mma.sync, well below the tensor cores'
// peak, still leaves the bytes the limit. Measured at the flagship shape:
// TF32 0.0500 ms, 30% of its 15.0 us bound, against 0.0786 ms for the FMA
// instance in the same run; bf16 0.0934 ms (its two passes over the keys)
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 2). A variant that
// converted every operand once in shared memory and loaded fragment pairs
// as float2 (half the loads, a third of the conversions) was no faster, so
// the instruction stream is not what holds it: each block stages K, V and
// the window of every chunk from L2 with nothing in flight behind them.
//
// Rows, keys and table rows outside the tensors are zero-filled in shared
// memory, keys past L are scored -inf, and nothing is stored for rows past L
// or heads past H.
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

constexpr int kTile = 64;    // query rows per tile, and keys per chunk
constexpr int kUnit = 64;    // threads per head: 8 row groups x 8 key groups
constexpr int kHeads = 2;    // heads per block, one unit each
constexpr int kMicro = 8;    // rows (and keys) of a thread's score tile, 8 apart
constexpr int kWindow = 2 * kTile - 1;  // table rows a (tile, chunk) pair reads
constexpr int kPStride = kTile + 4;     // key-major probabilities, padded
constexpr float kLog2e = 1.4426950408889634f;

// Offsets (floats) into dynamic shared memory.
template <int D, bool HAS_REL>
struct Smem {
  static constexpr int kRow = D + 4;                     // padded q, K and table rows
  static constexpr int kQ = 0;                           // kHeads x kTile x kRow
  static constexpr int kV = kQ + kHeads * kTile * kRow;  // kHeads x kTile x D
  static constexpr int kBias = kV + kHeads * kTile * D;  // kTile
  static constexpr int kScale = kBias + kTile;           // kHeads x kTile: a chunk's rescale factors
  static constexpr int kMax = kScale + kHeads * kTile;   // kHeads x kTile: running row maxima
  static constexpr int kSum = kMax + kHeads * kTile;     // kHeads x kTile: softmax denominators
  static constexpr int kK = kSum + kHeads * kTile;       // kHeads x kTile x kRow, then P
  static constexpr int kE = kK + kHeads * kTile * kRow;  // kWindow x kRow, HAS_REL only
  static constexpr int kKE = kHeads * kTile * kRow + (HAS_REL ? kWindow * kRow : 0);
  static constexpr int kP = kHeads * kTile * kPStride;   // kHeads x kTile keys x kPStride
  static constexpr int kFloats = kK + (kKE > kP ? kKE : kP);
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* table;
  float* out;
  long long sb, sh, sl;  // batch, head and row strides of q, k and v, in floats
  int H, L, M, n_tiles, n_groups;
  float scale2;  // D^-1/2 * log2(e)
};

// Copies rows [r0, r0 + kTile) of one of q, k, v (`src`) for the block's kHeads
// heads into `dst` (rows `row` floats apart); rows past L and heads past H
// are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int row, const float* src, long long sb,
                                           long long sh, long long sl, int H, int L, int b,
                                           int h0, int r0) {
  constexpr int kVec = D / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int i = threadIdx.x; i < kHeads * kTile * kVec; i += kHeads * kUnit) {
    const int u = i / (kTile * kVec);
    const int r = (i / kVec) % kTile;
    const int c = i % kVec;
    const int h = h0 + u, l = r0 + r;
    float* d = dst + (u * kTile + r) * row + 4 * c;
    if (h < H && l < L) {
      cp_async16(d, src + b * sb + h * sh + l * sl + 4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = zero;
    }
  }
}

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kHeads * kUnit, D <= 32 ? 6 / kHeads : 1)
rel_attention_kernel(const Args a) {
  using S = Smem<D, HAS_REL>;
  constexpr int kRow = S::kRow;
  constexpr int kVec = D / 4;            // float4 pieces of a D-vector
  constexpr int kRowsPV = kVec;          // rows of a thread's output tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tile = blockIdx.x % a.n_tiles;
  const int group = (blockIdx.x / a.n_tiles) % a.n_groups;
  const int b = blockIdx.x / (a.n_tiles * a.n_groups);
  const int l0 = tile * kTile, h0 = group * kHeads;
  const int u = threadIdx.x / kUnit, tu = threadIdx.x % kUnit;
  const int rg = tu / kMicro, kg = tu % kMicro;    // score layout
  const int rgp = tu / kVec, dg = tu % kVec;       // p . v layout

  const float* qs = smem + S::kQ + u * kTile * kRow;
  const float* ks = smem + S::kK + u * kTile * kRow;
  const float* es = smem + S::kE;
  const float* vs = smem + S::kV + u * kTile * D;
  const float* bs = smem + S::kBias;
  float* ps = smem + S::kK + u * kTile * kPStride;  // over K and the window
  float* scale_s = smem + S::kScale + u * kTile;
  float* max_s = smem + S::kMax + u * kTile;
  float* sum_s = smem + S::kSum + u * kTile;

  float4 o[kRowsPV];
#pragma unroll
  for (int r = 0; r < kRowsPV; ++r) o[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < kHeads * kTile; i += kHeads * kUnit) {
    smem[S::kMax + i] = -INFINITY;
    smem[S::kSum + i] = 0.0f;
  }

  const int n_chunks = (a.L + kTile - 1) / kTile;
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * kTile;
    __syncthreads();  // the last chunk's reads of P, V and the rescale are done
    if (c == 0) {
      stage_rows<D>(smem + S::kQ, kRow, a.q, a.sb, a.sh, a.sl, a.H, a.L, b, h0, l0);
    }
    stage_rows<D>(smem + S::kK, kRow, a.k, a.sb, a.sh, a.sl, a.H, a.L, b, h0, j0);
    if (HAS_REL) {
      // window row x holds table row x - (kTile - 1) + l0 - j0 + M - 1
      const int e0 = l0 - j0 - (kTile - 1) + a.M - 1;
#pragma unroll 1
      for (int i = threadIdx.x; i < kWindow * kVec; i += kHeads * kUnit) {
        const int x = i / kVec, cc = i % kVec;
        const int e = e0 + x;
        float* d = smem + S::kE + x * kRow + 4 * cc;
        if (e >= 0 && e < 2 * a.M - 1) {
          cp_async16(d, a.table + static_cast<long long>(e) * D + 4 * cc);
        } else {
          *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      float* d = smem + S::kBias + threadIdx.x;
      if (j < a.L) {
        cp_async4(d, a.bias + static_cast<long long>(b) * a.L + j);
      } else {
        *d = 0.0f;
      }
    }
    cp_async_commit();
    // V is waited for only before p . v: its copy overlaps the scores.
    stage_rows<D>(smem + S::kV, D, a.v, a.sb, a.sh, a.sl, a.H, a.L, b, h0, j0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // Scores of rows rg + 8 i x keys kg + 8 jj: q.k, then q.E along the 15 diagonals.
    float s[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) s[i][jj] = 0.0f;
    }
    // Not unrolled: unrolled, the loads of later steps are hoisted and registers spill.
#pragma unroll 1
    for (int d4 = 0; d4 < kVec; ++d4) {
      float4 qv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + kMicro * i) * kRow + 4 * d4);
      }
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (kg + kMicro * jj) * kRow + 4 * d4);
#pragma unroll
        for (int i = 0; i < kMicro; ++i) s[i][jj] = dot4(qv[i], kv, s[i][jj]);
      }
      if (HAS_REL) {
#pragma unroll
        for (int delta = -(kMicro - 1); delta < kMicro; ++delta) {  // delta = i - jj
          const int x = kTile - 1 + rg - kg + kMicro * delta;
          const float4 ev = *reinterpret_cast<const float4*>(es + x * kRow + 4 * d4);
#pragma unroll
          for (int i = 0; i < kMicro; ++i) {
            const int jj = i - delta;
            if (jj >= 0 && jj < kMicro) s[i][jj] = dot4(qv[i], ev, s[i][jj]);
          }
        }
      }
    }
    __syncthreads();  // K and the window are read: P overwrites them

    float bias2[kMicro];
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      const int j = kg + kMicro * jj;
      bias2[jj] = j0 + j < a.L ? bs[j] * kLog2e : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int row = rg + kMicro * i;
      const float m_old = max_s[row];  // read by the row's 8 lanes before lane 0 writes it
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        s[i][jj] = fmaf(s[i][jj], a.scale2, bias2[jj]);  // -inf past L
        m = fmaxf(m, s[i][jj]);
      }
      // the row's 64 keys lie on the 8 lanes kg = 0..7 of one quarter-warp
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      const float m_new = fmaxf(m_old, m);  // finite: chunk c has a key below L
      const float rescale = exp2f(m_old - m_new);  // 0 on the first chunk
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const float p = exp2f(s[i][jj] - m_new);
        sum += p;
        ps[(kg + kMicro * jj) * kPStride + row] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (kg == 0) {
        max_s[row] = m_new;
        scale_s[row] = rescale;
        sum_s[row] = fmaf(sum_s[row], rescale, sum);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // p . v for rows rgp * kRowsPV + r, dimensions 4 dg .. 4 dg + 3.
#pragma unroll
    for (int r = 0; r < kRowsPV; r += 4) {
      const float4 f = *reinterpret_cast<const float4*>(scale_s + rgp * kRowsPV + r);
      const float fr[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[r + t].x *= fr[t];
        o[r + t].y *= fr[t];
        o[r + t].z *= fr[t];
        o[r + t].w *= fr[t];
      }
    }
    const int n_keys = min(kTile, a.L - j0);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + 4 * dg);
      const float* pj = ps + j * kPStride + rgp * kRowsPV;
#pragma unroll
      for (int r = 0; r < kRowsPV; r += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pj + r);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          o[r + t].x = fmaf(pr[t], vv.x, o[r + t].x);
          o[r + t].y = fmaf(pr[t], vv.y, o[r + t].y);
          o[r + t].z = fmaf(pr[t], vv.z, o[r + t].z);
          o[r + t].w = fmaf(pr[t], vv.w, o[r + t].w);
        }
      }
    }
  }

  // The denominators were written before the last chunk's p . v began.
  const int h = h0 + u;
  if (h >= a.H) return;
#pragma unroll
  for (int r = 0; r < kRowsPV; ++r) {
    const int l = l0 + rgp * kRowsPV + r;
    if (l >= a.L) break;
    const float inv = 1.0f / sum_s[rgp * kRowsPV + r];
    float* dst = a.out + ((static_cast<long long>(b) * a.L + l) * a.H + h) * D + 4 * dg;
    *reinterpret_cast<float4*>(dst) = make_float4(o[r].x * inv, o[r].y * inv, o[r].z * inv, o[r].w * inv);
  }
}

template <int D, bool HAS_REL>
cudaError_t launch(Args a, int B, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const size_t smem = sizeof(float) * Smem<D, HAS_REL>::kFloats;
  const cudaError_t err = attn::opt_in_smem(
      reinterpret_cast<const void*>(&rel_attention_kernel<D, HAS_REL>), granted, device, smem);
  if (err != cudaSuccess) return err;
  a.n_groups = (a.H + kHeads - 1) / kHeads;
  const long long blocks = static_cast<long long>(B) * a.n_groups * a.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rel_attention_kernel<D, HAS_REL><<<static_cast<unsigned>(blocks), kHeads * kUnit, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- Tensor-core instances (TF32, and bf16 on rounded operands) ----------

namespace tc {

constexpr int kWarps = 4;                // warps per block, 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;       // query rows per block
constexpr int kKeys = 64;                // keys per chunk: 8 n-tiles of 8
constexpr int kWin = kRows + kKeys;      // table rows staged per chunk (127 reached)
constexpr int kWarpWin = 16 + kKeys;     // table rows a warp's QE spans (79 reached): 10 n-tiles
constexpr int kQEStride = kWarpWin + 8;  // 88 floats (24 mod 32): the float2 stores of QE fall on distinct banks

// Offsets (floats) into dynamic shared memory; every row D + 4 floats (4 mod 32).
template <int D, bool HAS_REL>
struct Smem {
  static constexpr int kRow = D + 4;
  static constexpr int kQ = 0;                           // kRows x kRow
  static constexpr int kK = kQ + kRows * kRow;           // kKeys x kRow
  static constexpr int kV = kK + kKeys * kRow;           // kKeys x kRow
  static constexpr int kBias = kV + kKeys * kRow;        // kKeys
  static constexpr int kE = kBias + kKeys;               // kWin x kRow, HAS_REL only
  static constexpr int kQE = kE + (HAS_REL ? kWin * kRow : 0);  // kWarps x 16 x kQEStride, HAS_REL only
  static constexpr int kFloats = kQE + (HAS_REL ? kWarps * 16 * kQEStride : 0);
};

// Copies rows [r0, r0 + rows) of one head of q, k or v (`src` at the head's
// first float) into `dst`, rows D + 4 floats apart; rows past L are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long sl, int L, int r0,
                                           int rows) {
  constexpr int kVec = D / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    float* d = dst + r * (D + 4) + 4 * c;
    if (r0 + r < L) {
      cp_async16(d, src + (r0 + r) * sl + 4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <int D, bool HAS_REL, bool BF16>
__device__ __forceinline__ void attention(const Args& a) {
  using S = Smem<D, HAS_REL>;
  constexpr int kRow = S::kRow;
  constexpr int kDT = D / 8;  // k-steps of q.k and q.E, n-tiles of p.v
  constexpr int kNT = kKeys / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tile = blockIdx.x % a.n_tiles;
  const int h = (blockIdx.x / a.n_tiles) % a.H;
  const int b = blockIdx.x / (a.n_tiles * a.H);
  const int l0 = tile * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lw = l0 + 16 * warp;  // the warp's first query row
  const bool live = lw < a.L;     // warp-uniform: a warp wholly past L only stages
  const long long head = b * a.sb + h * a.sh;

  const float* qs = smem + S::kQ;
  const float* ks = smem + S::kK;
  const float* vs = smem + S::kV;
  const float* bs = smem + S::kBias;
  float* qe = smem + S::kQE + warp * 16 * kQEStride;

  uint32_t qf[kDT][4];  // the warp's q rows as A fragments
  float o[kDT][4];      // its output rows, as p.v's accumulators
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {1.0f, 1.0f};

  const int n_chunks = (a.L + kKeys - 1) / kKeys;
  // bf16 rounds the normalised P: with several chunks, pass 0 finds each
  // row's maximum and sum first
  const bool stats_pass = BF16 && n_chunks > 1;
  for (int pass = stats_pass ? 0 : 1; pass < 2; ++pass) {
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kKeys;
      const bool first = c == 0 && (pass == 0 || !stats_pass);
      __syncthreads();  // the last chunk's reads of K, V and the window are done
      if (first) stage_rows<D>(smem + S::kQ, a.q + head, a.sl, a.L, l0, kRows);
      stage_rows<D>(smem + S::kK, a.k + head, a.sl, a.L, j0, kKeys);
      if (HAS_REL) {
        // window row x holds table row x - (kKeys - 1) + l0 - j0 + M - 1
        const int e0 = l0 - j0 - (kKeys - 1) + a.M - 1;
#pragma unroll 1
        for (int i = threadIdx.x; i < kWin * (D / 4); i += kThreads) {
          const int x = i / (D / 4), cc = i % (D / 4);
          const int e = e0 + x;
          float* d = smem + S::kE + x * kRow + 4 * cc;
          if (e >= 0 && e < 2 * a.M - 1) {
            cp_async16(d, a.table + static_cast<long long>(e) * D + 4 * cc);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      }
      if (threadIdx.x < kKeys) {
        const int j = j0 + threadIdx.x;
        float* d = smem + S::kBias + threadIdx.x;
        if (j < a.L) {
          cp_async4(d, a.bias + static_cast<long long>(b) * a.L + j);
        } else {
          *d = 0.0f;
        }
      }
      cp_async_commit();
      // V is waited for only before p . v: its copy overlaps the scores
      if (pass == 1) stage_rows<D>(smem + S::kV, a.v + head, a.sl, a.L, j0, kKeys);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      float s[kNT][4];
      if (live) {
        if (first) {
#pragma unroll
          for (int kk = 0; kk < kDT; ++kk) {
            const float* q0 = qs + (16 * warp + g) * kRow + 8 * kk + t;
            qf[kk][0] = operand<BF16>(q0[0]);
            qf[kk][1] = operand<BF16>(q0[8 * kRow]);
            qf[kk][2] = operand<BF16>(q0[4]);
            qf[kk][3] = operand<BF16>(q0[8 * kRow + 4]);
          }
        }
        if (HAS_REL) {
          // QE = Q . E_win^T over window rows 16 warp + [0, 80), into the warp's slice
          const float* ew = smem + S::kE + (16 * warp) * kRow;
#pragma unroll
          for (int n = 0; n < kWarpWin / 8; ++n) {
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kk = 0; kk < kDT; ++kk) {
              const float* e = ew + (8 * n + g) * kRow + 8 * kk + t;
              mma(acc, qf[kk], operand<BF16>(e[0]), operand<BF16>(e[4]));
            }
            float* d = qe + g * kQEStride + 8 * n + 2 * t;
            *reinterpret_cast<float2*>(d) = make_float2(acc[0], acc[1]);
            *reinterpret_cast<float2*>(d + 8 * kQEStride) = make_float2(acc[2], acc[3]);
          }
          __syncwarp();
        }
        // S = rel + Q . K^T; then scale and bias, in log2 units
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = g + 8 * (i / 2), col = 8 * n + 2 * t + i % 2;
            s[n][i] = HAS_REL ? qe[r * kQEStride + r - col + kKeys - 1] : 0.0f;
          }
#pragma unroll
          for (int kk = 0; kk < kDT; ++kk) {
            const float* k0 = ks + (8 * n + g) * kRow + 8 * kk + t;
            mma(s[n], qf[kk], operand<BF16>(k0[0]), operand<BF16>(k0[4]));
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t + e;
            const float bias2 = j0 + col < a.L ? bs[col] * kLog2e : -INFINITY;
            s[n][e] = fmaf(s[n][e], a.scale2, bias2);
            s[n][2 + e] = fmaf(s[n][2 + e], a.scale2, bias2);
          }
        }

        float rescale[2];
        if (!BF16) {
          fold(s, m, l, rescale);  // online: P unnormalised, the output rescaled
#pragma unroll
          for (int n = 0; n < kDT; ++n) {
            o[n][0] *= rescale[0];
            o[n][1] *= rescale[0];
            o[n][2] *= rescale[1];
            o[n][3] *= rescale[1];
          }
        } else if (pass == 0 || !stats_pass) {
          fold(s, m, l, rescale);  // the stats pass; or the only chunk, which holds every key
        } else {
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = exp2f(s[n][i] - m[i / 2]);
          }
        }
        if (BF16 && pass == 1) {
          if (c == 0) {
            inv[0] = 1.0f / quad_sum(l[0]);
            inv[1] = 1.0f / quad_sum(l[1]);
          }
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = bf16_value(s[n][i] * inv[i / 2]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      if (live && pass == 1) {
        // p . v: key n-tile n as one k-step, its keys in the order 2t, 2t + 1
        // (lane t's a0/a1 and a2/a3 columns) for P and V alike
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint32_t pa[4] = {operand<BF16>(s[n][0]), operand<BF16>(s[n][2]), operand<BF16>(s[n][1]),
                                  operand<BF16>(s[n][3])};
          const float* v0 = vs + (8 * n + 2 * t) * kRow + g;
#pragma unroll
          for (int dn = 0; dn < kDT; ++dn) {
            mma(o[dn], pa, operand<BF16>(v0[8 * dn]), operand<BF16>(v0[kRow + 8 * dn]));
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = lw + g + 8 * i;
    if (row >= a.L) continue;
    float* dst = a.out + ((static_cast<long long>(b) * a.L + row) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn) {
      *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(o[dn][2 * i] * inv[i], o[dn][2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace tc

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(tc::kThreads, D <= 32 ? 3 : 2) rel_attention_tf32_kernel(const Args a) {
  tc::attention<D, HAS_REL, false>(a);
}

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(tc::kThreads, D <= 32 ? 3 : 2) rel_attention_bf16_kernel(const Args a) {
  tc::attention<D, HAS_REL, true>(a);
}

template <int D, bool HAS_REL, bool BF16>
cudaError_t launch_tc(Args a, int B, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = BF16 ? &rel_attention_bf16_kernel<D, HAS_REL> : &rel_attention_tf32_kernel<D, HAS_REL>;
  const size_t smem = sizeof(float) * tc::Smem<D, HAS_REL>::kFloats;
  const cudaError_t err =
      attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  a.n_tiles = (a.L + tc::kRows - 1) / tc::kRows;
  const long long blocks = static_cast<long long>(B) * a.H * a.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// instance: 0 FMA, 1 TF32, 2 bf16 (see the note at the top)
template <int D, bool HAS_REL>
cudaError_t dispatch_instance(const Args& a, int B, int instance, int device, cudaStream_t stream) {
  switch (instance) {
    case 0: return launch<D, HAS_REL>(a, B, device, stream);
    case 1: return launch_tc<D, HAS_REL, false>(a, B, device, stream);
    case 2: return launch_tc<D, HAS_REL, true>(a, B, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t dispatch_rel(const Args& a, int B, int has_rel, int instance, int device, cudaStream_t stream) {
  return has_rel ? dispatch_instance<D, true>(a, B, instance, device, stream)
                 : dispatch_instance<D, false>(a, B, instance, device, stream);
}

}  // namespace

// q, k, v: (B, H, L, D) float32 views that share the (batch, head, row)
// strides sb, sh, sl in floats (the last dimension has stride 1), every row
// 16-byte aligned. out: a contiguous (B, L, H, D) buffer. table:
// the contiguous (2M - 1, D) distance table, 16-byte aligned, or null when
// has_rel is 0. `instance` picks the arithmetic: 0 FMA, 1 TF32, 2 bf16.
// `device` is the index of the device that holds the tensors and `stream`.
extern "C" int rel_attention_forward(const float* q, const float* k, const float* v,
                                     const float* bias, const float* table, float* out,
                                     long long sb, long long sh, long long sl, int B, int H, int L,
                                     int D, int M, int has_rel, int instance, int device,
                                     void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.table = table;
  a.out = out;
  a.sb = sb;
  a.sh = sh;
  a.sl = sl;
  a.H = H;
  a.L = L;
  a.M = M;
  a.n_tiles = (L + kTile - 1) / kTile;
  a.scale2 = kLog2e / sqrtf(static_cast<float>(D));
  return attn::on_device(device, [&] {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
      case 16: return dispatch_rel<16>(a, B, has_rel, instance, device, s);
      case 32: return dispatch_rel<32>(a, B, has_rel, instance, device, s);
      case 64: return dispatch_rel<64>(a, B, has_rel, instance, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
