// Raising a kernel's dynamic shared-memory limit, once per device: the
// kernels that take more than 48 KB (bucket_stage.cuh's K1 / K4,
// masked_scores.cu, dics_topn.cu, swa_attention.cu) call this before
// each launch, and only the first launch on a device reaches the driver.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// Lets `kernel` take up to `bytes` of dynamic shared memory on the
// current device; `done` is the kernel's own mask of devices already set
// (one static per kernel, or per template instance).
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                                      std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
