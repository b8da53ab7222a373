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
// What bounds it. A flagship call (B = 64, H = 12, L = 128, D = 32) is 3 L^2 D
// FMAs per (b, h) pair (q.k, q.E and p.v), 2.42 GFLOP in all: 36.1 us at the
// H100's 67 TFLOP/s float32 rate outside the tensor cores, against 15.0 us to
// move the 50.4 MB of q, k, v and out at 3.35 TB/s. So the FMAs bound it. The
// first design (one thread per query row) read three floats from shared
// memory per FMA and ran at 19% of that bound (0.1894 ms on an H100 80GB HBM3
// at 700 W). The SM serves one shared-memory wavefront (32 lanes x 4 bytes)
// per clock against four warp-wide FMAs, so a thread must do about four FMAs
// per float it reads from shared memory to keep the FMA pipes busy.
//
// Design: register tiles on the CUDA cores. The 3xTF32 tensor-core route
// would compute Q . E_window^T over 2L - 1 table rows and skew it by index,
// up to twice the relative term's work, with three products per term and the
// fragments moved between layouts; the Toeplitz structure makes the CUDA-core
// tile cheap instead. A unit of 64 threads owns one head and a tile of 64
// query rows and walks the keys in chunks of 64:
//   - Scores. Thread (rg, kg) of the unit owns rows rg + 8 i and keys kg + 8 jj
//     (i, jj < 8). Both step by 8, so l - j = rg - kg + 8 (i - jj) takes 15
//     values: the 64 scores need 8 q rows, 8 k rows and 15 table rows, read
//     as 16-byte vectors, for 128 FMAs per 4 dimensions (31 floats read).
//     The 8 lanes of a quarter-warp share rg and take consecutive kg, so
//     they read consecutive K and table rows, padded to D + 4 floats (4 mod
//     32) onto distinct banks, and one q vector as a broadcast.
//   - Softmax, online over chunks, in exp2 units: row maxima and sums across
//     the 8 lanes of a row by xor-shuffles. Probabilities go to shared
//     memory transposed (key-major); the running maxima, denominators and
//     each chunk's rescale factors live in shared memory too, which keeps the
//     thread under the 168 registers that three blocks per SM leave it.
//     The d loop and the staging loops are not unrolled, for the same reason:
//     unrolled, ptxas spills.
//   - p . v. Thread (rgp, dg) owns D / 4 consecutive rows x 4 dimensions
//     (8 x 4 at D = 32) and reads per key its rows' probabilities and one V
//     vector: 12 floats for 32 FMAs.
// A block holds two units, two heads of one batch item and one row tile,
// which share the staged table window and bias of every chunk: the window
// depends only on the tile and the chunk, so it is read once for both heads.
// One head per block was 47% slower at B = 64, L = 64 and no faster at the
// sampler's small chunk (B = 15, L = 64), where the 90 two-head blocks leave
// SMs idle (scripts/rel_attention_variants.py). Staged data: q of the tile,
// and per chunk K, V, the bias and the 127 table rows, filled with 16-byte
// cp.async (4-byte for the bias); V has its own copy group, waited for only
// before p . v, so it lands behind the scores. The probabilities overwrite K
// and the window once the scores are made, so shared memory stays 73 KB at
// D = 32, three blocks (12 warps) per SM, and does not grow with L. Rows,
// keys and table rows outside the tensors are zero-filled in shared memory,
// keys past L are scored -inf, and nothing is stored for rows past L or heads
// past H.
//
// Measured at the flagship shape: 0.0787 ms, 46% of the 36.1 us bound, against
// 0.1894 ms for the first design (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// phase 2). The phases of a chunk run one after another behind barriers;
// overlapping them (K and the window double-buffered) would need P in its
// own 35 KB, and a block per SM less.
//
// Plain C interface for ctypes; the kernel launches on the caller's stream,
// on the given device, allocates nothing and does not synchronise. The
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <math.h>

#include "launch.cuh"

namespace {

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

template <int D>
cudaError_t dispatch_rel(const Args& a, int B, int has_rel, int device, cudaStream_t stream) {
  return has_rel ? launch<D, true>(a, B, device, stream) : launch<D, false>(a, B, device, stream);
}

}  // namespace

// q, k, v: (B, H, L, D) float32 views that share the (batch, head, row)
// strides sb, sh, sl in floats (the last dimension has stride 1), every row
// 16-byte aligned. out: a contiguous (B, L, H, D) buffer. table:
// the contiguous (2M - 1, D) distance table, 16-byte aligned, or null when
// has_rel is 0. `device` is the index of the device that holds the tensors
// and `stream`.
extern "C" int rel_attention_forward(const float* q, const float* k, const float* v,
                                     const float* bias, const float* table, float* out,
                                     long long sb, long long sh, long long sl, int B, int H, int L,
                                     int D, int M,
                                     int has_rel, int device, void* stream) {
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
      case 16: return dispatch_rel<16>(a, B, has_rel, device, s);
      case 32: return dispatch_rel<32>(a, B, has_rel, device, s);
      case 64: return dispatch_rel<64>(a, B, has_rel, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
