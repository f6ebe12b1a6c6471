// Batched Gram matrix X^T X with fp32 accumulation.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gram.py::_gram (pallas_call :70, body _gram_kernel :24)
// which the reference maps over agents for CholeskyQR2's k x k Gram
// (src/repro/kernels/cholqr.py::_gram_nk :129-149).
//
// What it computes: x of shape (batch, n, d), fp32 or bf16, row-major and
// contiguous  ->  out (batch, d, d) fp32,  out[b] = sum_r x[b, r, :]^T x[b, r, :].
//
// What bounds it on an H100: the input is read once (batch * n * d
// elements) and d * d floats are written per batch element; the work is
// 2 * batch * n * d * d flops.  On the main path d is CholeskyQR2's k
// (5 for the paper's grid, 32 for the large one), so at most 2 * 32 = 64
// flops per 4-byte element, about 16 flops per byte: HBM bounds it at
// k = 5 and the fp32 CUDA cores at k = 32.
//
// What the design does about it: one block per (32 x 32 output tile,
// batch element); the block walks the reduction axis in 32-row chunks
// staged in shared memory (converted to fp32 on load), and each thread
// keeps four fp32 accumulators for four output rows of one output column.
// The output tile is written once.  The ragged edges (n not a multiple of
// 32, d < 32) are masked on load, not padded in memory.  The TPU's grid
// revisiting of one resident output block becomes a loop inside the block.
// Simple first: at batch = 64 the grid has fewer blocks than the card has
// SMs; splitting the reduction across blocks is left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTile = 32;              // output tile edge and chunk height
constexpr int kThreads = 256;          // 32 columns x 8 row groups
constexpr int kRows = kTile / (kThreads / kTile);   // 4 rows per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ x, float* __restrict__ out,
            long long n, int d) {
  __shared__ float xi[kTile][kTile + 1];   // chunk rows x tile cols (i side)
  __shared__ float xj[kTile][kTile + 1];   // chunk rows x tile cols (j side)

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const T* xb = x + (long long)b * n * d;
  const int tx = threadIdx.x % kTile;      // output column within the tile
  const int ty = threadIdx.x / kTile;      // row group: rows ty + 8 q

  float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long r0 = 0; r0 < n; r0 += kTile) {
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile, cc = idx % kTile;
      const long long row = r0 + r;
      const bool in_row = row < n;
      xi[r][cc] = (in_row && i0 + cc < d) ? to_f32(xb[row * d + i0 + cc])
                                          : 0.0f;
      xj[r][cc] = (in_row && j0 + cc < d) ? to_f32(xb[row * d + j0 + cc])
                                          : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float vj = xj[r][tx];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        acc[q] = __fmaf_rn(xi[r][ty + q * (kThreads / kTile)], vj, acc[q]);
    }
    __syncthreads();
  }

  float* ob = out + (long long)b * d * d;
  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = i0 + ty + q * (kThreads / kTile);
    if (i < d && j < d) ob[(long long)i * d + j] = acc[q];
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int batch, long long n, int d,
                   cudaStream_t stream) {
  const int tiles = (d + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, batch);
  gram_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)x, (float*)out,
                                                n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[b] = x[b]^T x[b] for x (batch, n, d); is_bf16 selects the input type.
// Returns cudaError_t.
int gram_batched(const void* x, void* out, int batch, long long n, int d,
                 int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(x, out, batch, n, d, st)
                 : launch<float>(x, out, batch, n, d, st);
}

const char* gram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
