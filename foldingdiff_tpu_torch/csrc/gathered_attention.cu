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
// The first design (one block per (b, h) pair and tile of query rows, e_lr
// streamed from global memory by every thread) was bound by L2 traffic: e_lr
// does not depend on b or h, yet each of the 768 pairs of a flagship call
// (B = 64, H = 12, L = 128, D = 32) read all 2 MiB of it, 1.61 GB per call at
// ~4.0 TB/s: 0.4048 ms against 0.3175 ms for the plain PyTorch version on an
// H100 80GB HBM3 at 700 W, with the FMAs at 9% of the float32 CUDA-core peak.
//
// Design: a block owns a tile of R = 16 query rows and a group of P = 8
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
// What bounds it now, per flagship call: 2.42 GFLOP of FMAs (3 L^2 D per pair:
// q.k, q.e and p.v), 36 us at the 67 TFLOP/s float32 peak; shared-memory reads
// of 6 D / 4 floats per (thread, key) plus 8 shuffles, 56 wavefronts per warp
// and key, 22 M wavefronts, ~95 us at one wavefront per clock per SM (132 SMs,
// 1.755 GHz); L2 reads of ceil(BH / P) * L^2 * D * 4 = 201 MB of e_lr (8x
// less than before), ceil(L / R) * BH * L * D * 8 = 201 MB of K and V and
// 25 MB of q and out, 428 MB in all; device memory sees ~52 MB (e_lr once,
// q, k, v, out). The tensor cores are not used: parity is float32 with TF32
// off, which needs the 3xTF32 split (three products per term) and the three
// products' fragments moved between layouts through shared memory.
//
// Two instances by the model's matmul precision (ops/attention.py picks one
// by `bf16`): gathered_attention_kernel computes in float32 FMA (IEEE
// float32, and TF32, computed more precisely than asked);
// gathered_attention_bf16_kernel computes what "BF16_BF16_F32" defines, the
// float32 products of bf16 values: q is rounded to bf16 values (to nearest
// even) as it is loaded, each staged chunk of k, v and e_lr in place in
// shared memory once it has landed (rounded at their use, they cost the
// registers that three blocks per SM leave a thread, and ptxas spilled), and
// P before p . v. P is the softmax's normalised output, as the einsum's
// operand is, so that instance walks the keys twice: a first pass finds each
// row's maximum and sum, the second forms P as exp2(s - max - log2(sum)),
// rounds it and accumulates p . v.
//
// Plain C interface for ctypes; the kernel launches on the caller's stream,
// on the given device, allocates nothing and does not synchronise. The
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "launch.cuh"

namespace {

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

__device__ __forceinline__ float4 bf16_values(const float4 x) {
  return make_float4(bf16_value(x.x), bf16_value(x.y), bf16_value(x.z), bf16_value(x.w));
}

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

template <int D, bool HAS_REL, bool BF16>
__device__ __forceinline__ void gathered_attention(const float* __restrict__ q, const float* __restrict__ k,
                                                   const float* __restrict__ v,
                                                   const float* __restrict__ bias,
                                                   const float* __restrict__ e_lr,
                                                   float* __restrict__ out, int H, int L, long long BH,
                                                   int n_tiles, float scale) {
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
      if (BF16) qr[o][i] = bf16_values(qr[o][i]);
    }
    row_max[o] = -INFINITY;
    denom[o] = 0.0f;
  }
  const float scale2 = scale * kLog2e;  // scores in log2 units, for exp2f

  const int n_chunks = (L + Jc - 1) / Jc;
  for (int pass = BF16 ? 0 : 1; pass < 2; ++pass) {
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      // bf16: exp2(s - max - log2(sum)) is the normalised probability
      if (BF16 && pass == 1) row_max[o] += log2f(denom[o]);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[o][i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    stage_chunk<D, HAS_REL>(smem, k, v, bias, e_lr, H, L, BH, l0, n0, 0);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        stage_chunk<D, HAS_REL>(smem + ((c + 1) & 1) * S::kFloats, k, v, bias, e_lr, H, L, BH,
                                l0, n0, (c + 1) * Jc);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      float* st = smem + (c & 1) * S::kFloats;
      if (BF16) {  // e_lr, K and V of the chunk (everything before the bias) to bf16 values, in place
#pragma unroll 1
        for (int i = threadIdx.x; i < S::kBias / 4; i += kThreads) {
          float4* x = reinterpret_cast<float4*>(st) + i;
          *x = bf16_values(*x);
        }
        __syncthreads();
      }
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

      if (!BF16 || pass == 0) {  // fold the chunk into the running maxima and sums
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          float m = row_max[o];
#pragma unroll
          for (int jj = 0; jj < Jc; ++jj) m = fmaxf(m, s[o][jj]);
          const float c_old = exp2f(row_max[o] - m);  // 0 on the first chunk
          row_max[o] = m;
          denom[o] *= c_old;
          if (BF16) {  // the first pass: sums only
#pragma unroll
            for (int jj = 0; jj < Jc; ++jj) denom[o] += exp2f(s[o][jj] - m);
          } else {
#pragma unroll
            for (int i = 0; i < kSlice; ++i) {
              acc[o][i].x *= c_old;
              acc[o][i].y *= c_old;
              acc[o][i].z *= c_old;
              acc[o][i].w *= c_old;
            }
          }
        }
      }
      if (pass == 1) {
#pragma unroll
        for (int jj = 0; jj < Jc; ++jj) {
          float p[4];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            p[o] = exp2f(s[o][jj] - row_max[o]);
            if (BF16) {
              p[o] = bf16_value(p[o]);  // the normalised probability, rounded
            } else {
              denom[o] += p[o];
            }
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
      }
      __syncthreads();  // the next iteration refills this stage
    }
  }

#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int l = l0 + r0 + (o >> 1);
    const long long n = n0 + ((o & 1) ? pb : pa);
    if (l >= L || n >= BH) continue;
    const float inv = BF16 ? 1.0f : 1.0f / denom[o];  // bf16: P was normalised
    float4* dst = reinterpret_cast<float4*>(out + (static_cast<size_t>(n) * L + l) * D);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const float4 a = acc[o][i];
      dst[tq + 4 * i] = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  }
}

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 3 : 1)
gathered_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ e_lr, float* __restrict__ out, int H, int L,
                          long long BH, int n_tiles, float scale) {
  gathered_attention<D, HAS_REL, false>(q, k, v, bias, e_lr, out, H, L, BH, n_tiles, scale);
}

// Two blocks per SM: at three, the first pass's sums cost the D = 32 instance
// with relative scores a spill.
template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 2 : 1)
gathered_attention_bf16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const float* __restrict__ e_lr, float* __restrict__ out, int H,
                               int L, long long BH, int n_tiles, float scale) {
  gathered_attention<D, HAS_REL, true>(q, k, v, bias, e_lr, out, H, L, BH, n_tiles, scale);
}

template <int D, bool HAS_REL, bool BF16>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* e_lr, float* out, int B, int H, int L, int device,
                   cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel =
      BF16 ? &gathered_attention_bf16_kernel<D, HAS_REL> : &gathered_attention_kernel<D, HAS_REL>;
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

template <int D, bool HAS_REL>
cudaError_t dispatch_bf16(const float* q, const float* k, const float* v, const float* bias,
                          const float* e_lr, float* out, int B, int H, int L, int bf16,
                          int device, cudaStream_t stream) {
  return bf16 ? launch<D, HAS_REL, true>(q, k, v, bias, e_lr, out, B, H, L, device, stream)
              : launch<D, HAS_REL, false>(q, k, v, bias, e_lr, out, B, H, L, device, stream);
}

template <int D>
cudaError_t dispatch_rel(const float* q, const float* k, const float* v, const float* bias,
                         const float* e_lr, float* out, int B, int H, int L, int has_rel,
                         int bf16, int device, cudaStream_t stream) {
  return has_rel ? dispatch_bf16<D, true>(q, k, v, bias, e_lr, out, B, H, L, bf16, device, stream)
                 : dispatch_bf16<D, false>(q, k, v, bias, e_lr, out, B, H, L, bf16, device, stream);
}

cudaError_t dispatch(const float* q, const float* k, const float* v, const float* bias,
                     const float* e_lr, float* out, int B, int H, int L, int D, int has_rel,
                     int bf16, int device, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_rel<16>(q, k, v, bias, e_lr, out, B, H, L, has_rel, bf16, device, s);
    case 32: return dispatch_rel<32>(q, k, v, bias, e_lr, out, B, H, L, has_rel, bf16, device, s);
    case 64: return dispatch_rel<64>(q, k, v, bias, e_lr, out, B, H, L, has_rel, bf16, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `e_lr` is the contiguous (L, L, D) tensor, or null when has_rel is 0; q, k,
// v and e_lr are 16-byte aligned. `bf16` picks the instance: 0 float32 FMA,
// 1 bf16 values. `device` is the index of the device that holds the tensors
// and `stream`.
extern "C" int gathered_attention_forward(const float* q, const float* k, const float* v,
                                          const float* bias, const float* e_lr, float* out,
                                          int B, int H, int L, int D, int has_rel, int bf16,
                                          int device, void* stream) {
  return attn::on_device(device, [&] {
    return dispatch(q, k, v, bias, e_lr, out, B, H, L, D, has_rel, bf16, device,
                    static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* gathered_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
