// The power-step matmul G = A @ W (Alg. 1's local step; the centralized
// comparator's iteration W <- qr(A W)).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/power_matmul.py::_power_matmul (pallas_call :71,
//     body _power_kernel :25)
//
// What it computes: A (d, d) fp32 and W (d, k) fp32, both row-major and
// contiguous  ->  G (d, k) fp32,  G[i, j] = sum_c A[i, c] * W[c, j], one
// fp32 FMA chain per output over c ascending.  The TPU kernel pads k to the
// 128-wide MXU lane; nothing here is padded in memory: the ragged row,
// column and contraction edges are masked on load.
//
// What bounds it on an H100: A is read once (4 d^2 bytes) for 2 d^2 k
// flops, 2k flops per 4-byte word.  For k in the tens that is under 16
// flops per byte, far below the fp32 rate's 20 flops per byte: HBM bounds
// it.  W (at most 4096 x 32 x 4 B = 512 KiB) stays in the 50 MB L2.
//
// What the design does about it: one block of 128 threads owns a 16-row
// slab of A and a 32-column tile of G (grid.y covers k > 32), so at
// d = 4096 the grid has 256 blocks and every SM streams A.  The block walks
// the contraction in 32-wide chunks: the A chunk (16 x 32) and the W chunk
// (32 x 32) are staged in shared memory, and the next chunk's global loads
// are issued into registers before the current chunk's FMAs run, so the
// loads of one chunk overlap the arithmetic of the other.  Lanes map to
// output columns (conflict-free W reads); each thread keeps four rows'
// sums, and one 16-byte shared read of A (a warp broadcast) feeds four
// contraction steps.  Simple first: no split of the contraction across
// blocks, no TMA.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;          // rows of A per block
constexpr int kBN = 32;          // output columns per block (one per lane)
constexpr int kCK = 32;          // contraction chunk
constexpr int kThreads = 128;    // 32 columns x 4 row groups
constexpr int kRowGroups = kThreads / kBN;          // 4
constexpr int kRows = kBM / kRowGroups;             // 4 rows per thread
constexpr int kALoads = kBM * kCK / kThreads;       // 4 A values per thread
constexpr int kWLoads = kCK * kBN / kThreads;       // 8 W values per thread
constexpr int kAStride = kCK + 4;                   // keeps rows 16-byte aligned

__global__ void __launch_bounds__(kThreads)
power_matmul_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    float* __restrict__ g, int d, int k) {
  __shared__ __align__(16) float as[kBM][kAStride];
  __shared__ float ws[kCK][kBN];

  const int i0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % kBN;
  const int ty = threadIdx.x / kBN;

  float ra[kALoads], rw[kWLoads];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int n = 0; n < kALoads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int r = idx / kCK, c = idx % kCK;
      const int row = i0 + r, col = c0 + c;
      ra[n] = (row < d && col < d) ? a[(long long)row * d + col] : 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kWLoads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int row = c0 + r, col = j0 + c;
      rw[n] = (row < d && col < k) ? w[(long long)row * k + col] : 0.0f;
    }
  };

  float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
  fetch(0);
  for (int c0 = 0; c0 < d; c0 += kCK) {
#pragma unroll
    for (int n = 0; n < kALoads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      as[idx / kCK][idx % kCK] = ra[n];
    }
#pragma unroll
    for (int n = 0; n < kWLoads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      ws[idx / kBN][idx % kBN] = rw[n];
    }
    __syncthreads();
    if (c0 + kCK < d) fetch(c0 + kCK);       // in flight during the FMAs
#pragma unroll
    for (int c = 0; c < kCK; c += 4) {
      const float w0 = ws[c][tx], w1 = ws[c + 1][tx];
      const float w2 = ws[c + 2][tx], w3 = ws[c + 3][tx];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float4 av =
            *reinterpret_cast<const float4*>(&as[ty + q * kRowGroups][c]);
        float s = acc[q];
        s = __fmaf_rn(av.x, w0, s);
        s = __fmaf_rn(av.y, w1, s);
        s = __fmaf_rn(av.z, w2, s);
        s = __fmaf_rn(av.w, w3, s);
        acc[q] = s;
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i0 + ty + q * kRowGroups;
    if (i < d && j < k) g[(long long)i * k + j] = acc[q];
  }
}

}  // namespace

extern "C" {

// G = A @ W for A (d, d), W (d, k), G (d, k), all fp32 and contiguous.
// Returns cudaError_t.
int power_matmul(const void* A, const void* W, void* G, int d, int k,
                 void* stream) {
  if (d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((d + kBM - 1) / kBM, (k + kBN - 1) / kBN);
  power_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)W, (float*)G, d, k);
  return (int)cudaGetLastError();
}

const char* power_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
