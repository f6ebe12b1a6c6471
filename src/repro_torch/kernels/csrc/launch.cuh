// Host-side launch helpers shared by fastmix_tiles.cuh (FastMix, apply-track's
// gossip, the fp8-EF rounds) and product_tiles.cuh (apply-track's per-agent
// product, the power matmul).  Each source compiles its own copy (anonymous
// namespace).
#pragma once
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// What one kernel instantiation needs from the CUDA runtime before it launches
// with `smem` dynamic shared-memory bytes on a device: the attribute that
// allows them (raised, never lowered, so a concurrent launch of a larger
// size stays allowed) and how many blocks of `threads` the device holds at
// once (the persistent apply kernel's grid).  Asked once per device and
// size, then kept: a launch then costs no runtime query.
struct Setup {
  std::mutex mu;
  size_t allowed[kMaxDevices] = {};
  size_t smem[kMaxDevices] = {};
  int resident[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t setup(Setup& cache, Kernel kern, int threads, size_t smem,
                  int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.allowed[dev] < smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cache.allowed[dev] = smem;
  }
  if (cache.smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.smem[dev] = smem;
    cache.resident[dev] = sms * per_sm;
  }
  *resident = cache.resident[dev];
  return cudaSuccess;
}

}  // namespace
