// Fused BERT self-attention with HF `relative_key` position scores, for Hopper.
//
// Replaces the Pallas TPU kernels foldingdiff_tpu/ops/pallas_attention.py:
// _attn_rel_kernel_v2 (HAS_REL = true) and _attn_kernel_v2 (HAS_REL = false).
// For every batch item b, head h and query row l it computes
//
//   s[j]   = (q[l] . k[j] + q[l] . E[l - j + M - 1]) * D^-1/2 + bias[b, j]
//   out[l] = softmax_j(s) . v
//
// with q, k, v, out (B, H, L, D) float32 contiguous, bias (B, L) the additive
// key mask (0 or -10000) and E the raw (2M-1, D) distance-embedding table,
// L <= M. The relative term is added before the scale, as in HF BERT.
//
// What bounds it on the card: at the denoiser's shapes (L <= 128, D = 32) one
// (b, h) pair is 1.6 M FMAs (q.k, q.E and p.v: 3 L^2 D) against ~96 KB of
// q/K/V/out and table traffic, the table being shared by all pairs and
// L2-resident. That is ~33 FLOP per byte, above the float32 CUDA-core ridge
// of ~20, so the kernel is bound on the SM, not by device memory: per key a
// warp issues D scalar shared loads of the table window against 3 D FMAs,
// and the two dot products are serial FMA chains. The plain PyTorch version
// instead writes the (B, H, L, L) score tensor to device memory and reads it
// back several times (scores, + rel, softmax, probs @ v).
//
// Design: one block per (b, h, tile of up to 128 query rows), one thread per
// query row. K, V, the bias row and the table rows that the tile needs
// (window [l0 + M - L, l_last + M - 1], at most 2L - 1 rows) are staged in
// dynamic shared memory (66 KB at L = 128, D = 32, hence the opt-in above
// 48 KB). Each thread keeps its q row and its output row in registers and makes
// one online-softmax pass over the keys; no score leaves the thread. The
// per-row diagonal read E[l - j + M - 1] is a plain shared-memory index:
// the TPU kernel's reversed-table matmul and row skew do not exist here.
// Neighbouring threads read neighbouring table rows, so rows are padded to
// D + 1 floats to keep those reads on distinct banks; K and V rows are read
// by all threads at once (a broadcast) and need no padding. The mask is the
// additive -10000, never -inf, so padded query rows still produce output.
//
// Plain C interface for ctypes; the kernel launches on the caller's stream,
// on the given device, allocates nothing and does not synchronise. The
// return value is cudaGetLastError() after the launch. The host side of a
// launch is kept small, since the sampler's small chunks are bound by it: the
// shared-memory opt-in is made once per kernel instance and device, and the
// current device is switched only when it is not already the tensors' own.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <math.h>

namespace {

constexpr int kMaxRows = 128;     // query rows (threads) per block
constexpr int kMaxDevices = 64;   // devices the opt-in bookkeeping tracks

int rows_per_block(int L) { return std::min(((L + 31) / 32) * 32, kMaxRows); }

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kMaxRows)
rel_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ table, float* __restrict__ out,
                     int H, int L, int M, float scale) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  const int l0 = blockIdx.x * rows;
  const int l_end = min(l0 + rows, L);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = (static_cast<size_t>(b) * H + h) * L * D;

  float* ks = smem;        // L x D
  float* vs = ks + L * D;  // L x D
  float* bs = vs + L * D;  // L
  float* es = bs + L;      // window rows x (D + 1), HAS_REL only

  for (int i = threadIdx.x; i < L * D; i += rows) {
    ks[i] = k[head + i];
    vs[i] = v[head + i];
  }
  for (int i = threadIdx.x; i < L; i += rows) bs[i] = bias[static_cast<size_t>(b) * L + i];
  if (HAS_REL) {
    // Table rows l - j + M - 1 for l in [l0, l_end), j in [0, L): the first
    // is l0 + M - L (>= 0 because L <= M), and there are l_end - l0 + L - 1.
    const int e0 = l0 + M - L;
    const int n_e = l_end - l0 + L - 1;
    for (int i = threadIdx.x; i < n_e * D; i += rows) {
      const int r = i / D;
      const int c = i - r * D;
      es[r * (D + 1) + c] = table[static_cast<size_t>(e0 + r) * D + c];
    }
  }
  __syncthreads();

  const int l = l0 + threadIdx.x;
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
  // Window row of E[l - j + M - 1] for j = 0; it moves down one row per key.
  const float* e_row = es + (l - l0 + L - 1) * (D + 1);

  for (int j = 0; j < L; ++j) {
    const float* kj = ks + j * D;
    float qk = 0.0f;
    float rel = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) qk = fmaf(qr[d], kj[d], qk);
    if (HAS_REL) {
      const float* ej = e_row - j * (D + 1);
#pragma unroll
      for (int d = 0; d < D; ++d) rel = fmaf(qr[d], ej[d], rel);
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

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device.
// Each instance remembers, per device, the largest size it has opted in to,
// and calls cudaFuncSetAttribute only when a launch needs more.
template <int D, bool HAS_REL>
cudaError_t opt_in_smem(int device, size_t smem) {
  static std::atomic<size_t> granted[kMaxDevices];
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < kMaxDevices && smem <= granted[device].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      rel_attention_kernel<D, HAS_REL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && device < kMaxDevices) {
    size_t prev = granted[device].load(std::memory_order_relaxed);
    while (prev < smem && !granted[device].compare_exchange_weak(prev, smem)) {
    }
  }
  return err;
}

template <int D, bool HAS_REL>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* table, float* out, int B, int H, int L, int M,
                   int device, cudaStream_t stream) {
  const int rows = rows_per_block(L);
  const int n_e = HAS_REL ? (std::min(rows, L) + L - 1) : 0;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(L) * D + L +
                                       static_cast<size_t>(n_e) * (D + 1));
  const cudaError_t err = opt_in_smem<D, HAS_REL>(device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + rows - 1) / rows, H, B);
  rel_attention_kernel<D, HAS_REL><<<grid, rows, smem, stream>>>(
      q, k, v, bias, table, out, H, L, M, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_rel(const float* q, const float* k, const float* v, const float* bias,
                         const float* table, float* out, int B, int H, int L, int M,
                         int has_rel, int device, cudaStream_t stream) {
  return has_rel ? launch<D, true>(q, k, v, bias, table, out, B, H, L, M, device, stream)
                 : launch<D, false>(q, k, v, bias, table, out, B, H, L, M, device, stream);
}

cudaError_t dispatch(const float* q, const float* k, const float* v, const float* bias,
                     const float* table, float* out, int B, int H, int L, int D, int M,
                     int has_rel, int device, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_rel<16>(q, k, v, bias, table, out, B, H, L, M, has_rel, device, s);
    case 32: return dispatch_rel<32>(q, k, v, bias, table, out, B, H, L, M, has_rel, device, s);
    case 64: return dispatch_rel<64>(q, k, v, bias, table, out, B, H, L, M, has_rel, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `device` is the index of the device that holds the tensors and `stream`.
extern "C" int rel_attention_forward(const float* q, const float* k, const float* v,
                                     const float* bias, const float* table, float* out,
                                     int B, int H, int L, int D, int M, int has_rel,
                                     int device, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  err = dispatch(q, k, v, bias, table, out, B, H, L, D, M, has_rel, device,
                 static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return err;
}

extern "C" const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
