// Host-side launch helpers shared by the attention kernels of this directory.
//
// The sampler's small chunks are bound by the host's launch cost, so the host
// side of a launch is kept small: a kernel that takes more than the default
// 48 KB of dynamic shared memory opts in once per kernel instance and device,
// and the current device is switched only when it is not already the
// tensors' own. A persistent kernel's grid takes the SM count, read once
// per device.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

// The part of a kernel source a library holds: ops/attention.py builds a
// source once per group of its instances and head sizes, side by side
// (CudaLibrary.parts). Bit i of ATTN_INSTANCES is instance i (the C entry's
// `instance`), bits 0, 1, 2 of ATTN_HEAD_DIMS are D = 16, 32, 64; a launch
// outside the part returns cudaErrorInvalidValue. All of them by default.
#ifndef ATTN_INSTANCES
#define ATTN_INSTANCES 0x7ff
#endif
#ifndef ATTN_HEAD_DIMS
#define ATTN_HEAD_DIMS 0x7
#endif

namespace attn {

template <int I>
constexpr bool kBuiltInstance = (ATTN_INSTANCES >> I) & 1;
template <int D>
constexpr bool kBuiltHeadDim = (ATTN_HEAD_DIMS >> (D == 16 ? 0 : D == 32 ? 1 : 2)) & 1;

constexpr int kMaxDevices = 64;  // devices the opt-in bookkeeping tracks

// Dynamic shared memory above 48 KB needs an opt-in per kernel and device.
// `granted` is the kernel instance's own record of the largest size it has
// opted in to on each device; cudaFuncSetAttribute is called only when a
// launch needs more.
inline cudaError_t opt_in_smem(const void* kernel, std::atomic<size_t>* granted, int device,
                               size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < kMaxDevices && smem <= granted[device].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && device < kMaxDevices) {
    size_t prev = granted[device].load(std::memory_order_relaxed);
    while (prev < smem && !granted[device].compare_exchange_weak(prev, smem)) {
    }
  }
  return err;
}

// The device's SM count, read once per device: the grid of a persistent kernel.
inline cudaError_t sm_count(int device, int* count) {
  static std::atomic<int> counts[kMaxDevices];
  if (device < kMaxDevices && (*count = counts[device].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) counts[device].store(*count, std::memory_order_relaxed);
  return err;
}

// Runs launch() with `device` current, restoring the caller's device after.
template <typename Launch>
int on_device(int device, Launch&& launch) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  err = launch();
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // namespace attn
