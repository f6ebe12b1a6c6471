// The power-step matmul G = A @ W (Alg. 1's local step; the centralized
// comparator's iteration W <- qr(A W)).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/power_matmul.py::_power_matmul (pallas_call :71,
//     body _power_kernel :25)
//
// What it computes: A (d, d) fp32 and W (d, k) fp32, both row-major and
// contiguous  ->  G (d, k) fp32,  G[i, j] = sum_c A[i, c] * W[c, j] in fp32
// (no TF32).  The TPU kernel pads k to the 128-wide MXU lane; nothing here is
// padded in memory: the ragged row, column and contraction edges are masked
// on load.
//
// What bounds it on an H100: A is read once (4 d^2 bytes) for 2 d^2 k
// flops, 2k flops per 4-byte word.  For k in the tens that is under 16
// flops per byte, below the fp32 rate's 20 flops per byte: HBM bounds it
// (0.020 ms at d = 4096, k = 32).  At d = 300 the 0.36 MB of A take 0.1 us:
// the launch and the serial chain of chunk loads set the time.
//
// What the design does about it: it is apply-track's per-agent product
// (product_tiles.cuh) at one agent, with the contraction split across a
// thread-block cluster where the rows alone give too few blocks.  A block
// owns BM rows and all k columns (so W is read once per BM rows, not once
// per 16 rows and 32 columns), keeps two 32-wide chunks of A and W in flight
// through a 3-stage cp.async ring, and feeds TR x TC register tiles (8 x 4
// at k = 32, one row by 8 columns at k = 5).  The wrapper's power_tile picks
// BM, the padded width KP and the cluster size S: at d = 4096, k = 32,
// BM = 128 and S = 8 give 256 blocks of 16 chunks each; at d = 300, k = 5,
// BM = 64 and S = 8 give 40 blocks of one or two chunks each (no S <= 8
// reaches 132 blocks there).  The S ranks of a cluster sum their partial
// tiles over distributed shared memory in rank order, so the result is
// deterministic and takes one launch; S = 1 is the unsplit product.
#include "product_tiles.cuh"

extern "C" {

// G = A @ W for A (d, d), W (d, k), G (d, k), all fp32 and contiguous, on
// BM = bm (64 or 128) rows and KP = kp (8, 16, 32 or 64, at least min(k,
// 64)) columns per block, the contraction split over clusters of `split`
// (1, 2, 4 or 8, at most ceil(d / 32)) blocks.  Returns cudaError_t.
int power_matmul(const void* A, const void* W, void* G, int d, int k, int bm,
                 int kp, int split, void* stream) {
  if (!product_shape_ok(d, k, bm, kp, split))
    return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  const float* w = (const float*)W;
  float* g = (float*)G;
  cudaStream_t st = (cudaStream_t)stream;
  return split > 1
      ? (int)agent_product<true>(bm, kp, split, a, w, g, 1, d, k, st)
      : (int)agent_product<false>(bm, kp, 1, a, w, g, 1, d, k, st);
}

const char* power_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
