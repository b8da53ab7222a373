// Host-side launch helpers shared by the attention kernels of this directory.
//
// The sampler's small chunks are bound by the host's launch cost, so the host
// side of a launch is kept small: a kernel that takes more than the default
// 48 KB of dynamic shared memory opts in once per kernel instance and device,
// and the current device is switched only when it is not already the
// tensors' own.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace attn {

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
