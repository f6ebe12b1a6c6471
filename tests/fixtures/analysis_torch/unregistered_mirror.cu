// Fixture: an in-kernel copy of the tracking combine in a CUDA source that
// the registry does not list for it.  Analyzer input only, never built.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tracked(float s, float g, float gp) {
  return __fsub_rn(__fadd_rn(s, g), gp);
}

__global__ void combine(const float* s, const float* g, const float* gp,
                        float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = tracked(s[i], g[i], gp[i]);
}

}  // namespace
