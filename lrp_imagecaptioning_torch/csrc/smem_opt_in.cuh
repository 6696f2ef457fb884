// Dynamic shared memory above 48 KB a block is refused at launch unless the
// kernel's attribute allows it, and the attribute belongs to one device's
// context: a process that launches on several cards sets it on each.
// allow_dynamic_smem sets it on the current device the first time that
// device launches the kernel; `done` (one a kernel) keeps a bit for each of
// the first 64 devices.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}
