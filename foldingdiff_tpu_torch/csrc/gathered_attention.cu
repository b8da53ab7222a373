// Fused BERT self-attention over a gathered relative-position tensor, for Hopper.
//
// Replaces the Pallas TPU kernels foldingdiff_tpu/ops/pallas_attention.py:
// _attn_rel_kernel with _one_head_t (HAS_REL = true) and _attn_kernel
// (HAS_REL = false), entry fused_attention. For every batch item b, head h
// and query row l it computes
//
//   s[j]   = (q[l] . k[j] + q[l] . e_lr[l, j]) * D^-1/2 + bias[b, j]
//   out[l] = softmax_j(s) . v
//
// with q, k, v, out (B, H, L, D) float32 contiguous, bias (B, L) the additive
// key mask (0 or -10000) and e_lr any (L, L, D) tensor: it is gathered from
// the caller's position ids, so nothing here assumes it is Toeplitz. The
// relative term is added before the scale, as in HF BERT.
//
// The kernel reads e_lr as elt (D, L_key, L_query), elt[d, j, l] =
// e_lr[l, j, d], the transposed layout the TPU kernel also took
// (pallas_attention.py:126). One thread owns one query row, so for a fixed
// (d, j) the 32 threads of a warp read 32 neighbouring floats: every load of
// the relative term is one coalesced 128-byte line. In e_lr's own layout the
// threads would be L * D floats apart.
//
// What bounds it on the card: e_lr is 2 MiB at L = 128, D = 32, far above a
// block's 227 KB of shared memory, so it stays in global memory. Every
// (b, h) pair reads all of it: 768 pairs x 2 MiB is 1.6 GB per flagship call,
// against 50 MB of q, k, v and out. That traffic is served by the 50 MB L2,
// which holds elt for the whole call, so the kernel is bound by L2 bandwidth
// and by the load latency it can hide, not by device memory. Blocks that share
// a head tile do not share their loads; a block that served several heads from
// one staged chunk of elt would cut the L2 traffic, at the cost of shared
// memory and occupancy.
//
// Design otherwise as rel_attention.cu: one block per (b, h, tile of up to 128
// query rows); K, V and the bias row staged in dynamic shared memory (33 KB at
// L = 128, D = 32; the opt-in above 48 KB is made for D = 64); each thread
// keeps its q row and output row in registers and makes one online-softmax
// pass over the keys. The mask is the additive -10000, never -inf, so padded
// query rows still produce output.
//
// Plain C interface for ctypes; the kernel launches on the caller's stream,
// on the given device, allocates nothing and does not synchronise. The
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <math.h>

#include "launch.cuh"

namespace {

using attn::kMaxRows;

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kMaxRows)
gathered_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ elt, float* __restrict__ out,
                          int H, int L, float scale) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * L * D;

  float* ks = smem;        // L x D
  float* vs = ks + L * D;  // L x D
  float* bs = vs + L * D;  // L

  for (int i = threadIdx.x; i < L * D; i += rows) {
    ks[i] = k[head + i];
    vs[i] = v[head + i];
  }
  for (int i = threadIdx.x; i < L; i += rows) bs[i] = bias[static_cast<size_t>(b) * L + i];
  __syncthreads();

  const int l = blockIdx.x * rows + threadIdx.x;
  if (l >= L) return;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q[head + static_cast<size_t>(l) * D + d];
    acc[d] = 0.0f;
  }
  float row_max = -INFINITY;
  float denom = 0.0f;
  const size_t plane = static_cast<size_t>(L) * L;  // elt stride between d

  for (int j = 0; j < L; ++j) {
    const float* kj = ks + j * D;
    float qk = 0.0f;
    float rel = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) qk = fmaf(qr[d], kj[d], qk);
    if (HAS_REL) {
      const float* e = elt + static_cast<size_t>(j) * L + l;  // elt[0, j, l]
#pragma unroll
      for (int d = 0; d < D; ++d) rel = fmaf(qr[d], __ldg(e + d * plane), rel);
    }
    const float s = (qk + rel) * scale + bs[j];
    if (s > row_max) {
      const float c = expf(row_max - s);  // 0 on the first key
      denom *= c;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= c;
      row_max = s;
    }
    const float p = expf(s - row_max);
    denom += p;
    const float* vj = vs + j * D;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
  }

  const float inv = 1.0f / denom;
#pragma unroll
  for (int d = 0; d < D; ++d) out[head + static_cast<size_t>(l) * D + d] = acc[d] * inv;
}

template <int D, bool HAS_REL>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* elt, float* out, int B, int H, int L, int device,
                   cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const int rows = attn::rows_per_block(L);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(L) * D + L);
  const cudaError_t err = attn::opt_in_smem(
      reinterpret_cast<const void*>(&gathered_attention_kernel<D, HAS_REL>), granted, device,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + rows - 1) / rows, H, B);
  gathered_attention_kernel<D, HAS_REL><<<grid, rows, smem, stream>>>(
      q, k, v, bias, elt, out, H, L, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_rel(const float* q, const float* k, const float* v, const float* bias,
                         const float* elt, float* out, int B, int H, int L, int has_rel,
                         int device, cudaStream_t stream) {
  return has_rel ? launch<D, true>(q, k, v, bias, elt, out, B, H, L, device, stream)
                 : launch<D, false>(q, k, v, bias, elt, out, B, H, L, device, stream);
}

cudaError_t dispatch(const float* q, const float* k, const float* v, const float* bias,
                     const float* elt, float* out, int B, int H, int L, int D, int has_rel,
                     int device, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_rel<16>(q, k, v, bias, elt, out, B, H, L, has_rel, device, s);
    case 32: return dispatch_rel<32>(q, k, v, bias, elt, out, B, H, L, has_rel, device, s);
    case 64: return dispatch_rel<64>(q, k, v, bias, elt, out, B, H, L, has_rel, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `elt` is e_lr in the (D, L_key, L_query) layout, or null when has_rel is 0.
// `device` is the index of the device that holds the tensors and `stream`.
extern "C" int gathered_attention_forward(const float* q, const float* k, const float* v,
                                          const float* bias, const float* elt, float* out,
                                          int B, int H, int L, int D, int has_rel, int device,
                                          void* stream) {
  return attn::on_device(device, [&] {
    return dispatch(q, k, v, bias, elt, out, B, H, L, D, has_rel, device,
                    static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* gathered_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
