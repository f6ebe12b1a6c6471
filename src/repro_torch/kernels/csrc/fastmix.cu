// FastMix rounds (Alg. 3), optionally fused with subspace tracking (Eqn. 3.1).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fastmix.py::_fastmix_track_fused (pallas_call :484,
//     body _fastmix_track_kernel :419, rounds _rounds :203)   -> TRACK = true
//   src/repro/kernels/fastmix.py::_fastmix_fused (pallas_call :331,
//     body _fastmix_kernel :250)                              -> TRACK = false
//
// What it computes, per column c of the flattened (m, n) iterate:
//   x    = S + G - G_prev            (TRACK)   or   x = S
//   prev = cur = x
//   K times:  sent  = WIRE_BF16 ? bf16_rne(cur) : cur
//             mixed = sum_j L[i, j] * sent[j]      (fp32 FMAs, j ascending)
//             prev, cur = cur, (1 + eta) * mixed - eta * prev
//   out  = cur                        (fp32)
//
// What bounds it on an H100: each element of S (and G, G_prev) is read once
// and each output written once, so the bytes are 4 * m * n * (3 + 1) with
// tracking; the work is 2 * m * m * n * K flops.  At m = 64, K = 8 that is
// 1024 flops per column against 1 KiB moved: about 1 flop per byte, so the
// fp32 CUDA-core rate (about 67 TFLOP/s) bounds it, not HBM.  At m = 50,
// n = 1500 there are only 47 column tiles: too few blocks for 132 SMs, and
// the launch itself dominates.
//
// What the design does about it: every column evolves independently under
// the recursion, so one block owns a BN-column tile for all K rounds.  L
// (m x m), prev, cur (and, on the bf16 wire, the rounded sent values) live
// in shared memory the whole time; global memory is touched once to load
// the tile and once to store it.  Lanes map to columns (coalesced loads,
// conflict-free shared reads of sent[j][c]); each thread accumulates four
// rows at once so one shared read of sent[j][c] feeds four FMAs while the
// L[i][j] reads are warp broadcasts.  The TPU's 128-padding of the agent
// axis and its BlockSpec tiles have no counterpart here: the ragged column
// edge is masked, and L is padded in shared memory only to the 4-row group.
// L and eta are runtime operands, and K is a runtime loop bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float wire_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool TRACK, bool WIRE_BF16>
__global__ void __launch_bounds__(kThreads)
fastmix_rounds_kernel(const float* __restrict__ L,
                      const float* __restrict__ S,
                      const float* __restrict__ G,
                      const float* __restrict__ Gp,
                      float* __restrict__ out,
                      int m, long long n, float eta, int K, int bn) {
  extern __shared__ float smem[];
  const int mp = (m + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  float* sL = smem;                       // mp x m   (rows >= m are zero)
  float* prev = sL + mp * m;              // m x bn
  float* cur = prev + m * bn;             // m x bn
  float* sent = WIRE_BF16 ? cur + m * bn : cur;   // m x bn on the bf16 wire

  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * bn;

  for (int idx = tid; idx < mp * m; idx += kThreads)
    sL[idx] = idx < m * m ? L[idx] : 0.0f;
  for (int idx = tid; idx < m * bn; idx += kThreads) {
    const int i = idx / bn, c = idx % bn;
    const long long col = c0 + c;
    float v = 0.0f;
    if (col < n) {
      const long long g = (long long)i * n + col;
      v = S[g];
      if (TRACK) v = __fsub_rn(__fadd_rn(v, G[g]), Gp[g]);  // (s + g) - gp
    }
    prev[idx] = v;
    cur[idx] = v;
    if (WIRE_BF16) sent[idx] = wire_round(v);
  }
  __syncthreads();

  const float one_eta = __fadd_rn(1.0f, eta);
  const int c = tid % bn;
  const int group = tid / bn;
  const int groups = kThreads / bn;
  for (int round = 0; round < K; ++round) {
    // nxt overwrites prev in place: prev[i][c] is read only by the thread
    // that writes it, and every thread reads only `sent` (= cur) otherwise.
    for (int i0 = group * kRowsPerThread; i0 < m;
         i0 += groups * kRowsPerThread) {
      float acc[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < m; ++j) {
        const float s = sent[j * bn + c];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = __fmaf_rn(sL[(i0 + r) * m + j], s, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + r;
        if (i < m) {
          const int e = i * bn + c;
          prev[e] = __fsub_rn(__fmul_rn(one_eta, acc[r]),
                              __fmul_rn(eta, prev[e]));
        }
      }
    }
    __syncthreads();
    float* t = prev; prev = cur; cur = t;     // prev <- cur, cur <- nxt
    if (WIRE_BF16) {
      for (int idx = tid; idx < m * bn; idx += kThreads)
        sent[idx] = wire_round(cur[idx]);
      __syncthreads();
    } else {
      sent = cur;
    }
  }

  for (int idx = tid; idx < m * bn; idx += kThreads) {
    const int i = idx / bn, cc = idx % bn;
    const long long col = c0 + cc;
    if (col < n) out[(long long)i * n + col] = cur[idx];
  }
}

template <bool TRACK, bool WIRE_BF16>
cudaError_t launch(const float* L, const float* S, const float* G,
                   const float* Gp, float* out, int m, long long n,
                   float eta, int K, int bn, size_t smem,
                   cudaStream_t stream) {
  auto kern = fastmix_rounds_kernel<TRACK, WIRE_BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + bn - 1) / bn;
  kern<<<(unsigned)tiles, kThreads, smem, stream>>>(L, S, G, Gp, out, m, n,
                                                    eta, K, bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for (m, bn, wire); the wrapper's
// tile_width() picks bn with the same formula.
size_t fastmix_smem_bytes(int m, int bn, int wire_bf16) {
  const int mp = (m + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  return sizeof(float) * ((size_t)mp * m + (size_t)(wire_bf16 ? 3 : 2) * m * bn);
}

// out = FastMix^K(track ? S + G - Gp : S) over the (m, n) fp32 iterate.
// G and Gp are ignored (may be null) when track == 0.  Returns cudaError_t.
int fastmix_rounds(const void* L, const void* S, const void* G,
                   const void* Gp, void* out, int m, long long n, float eta,
                   int K, int bn, int track, int wire_bf16, void* stream) {
  const size_t smem = fastmix_smem_bytes(m, bn, wire_bf16);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)L;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  float* o = (float*)out;
  if (track) {
    return wire_bf16
        ? launch<true, true>(l, s, g, gp, o, m, n, eta, K, bn, smem, st)
        : launch<true, false>(l, s, g, gp, o, m, n, eta, K, bn, smem, st);
  }
  return wire_bf16
      ? launch<false, true>(l, s, g, gp, o, m, n, eta, K, bn, smem, st)
      : launch<false, false>(l, s, g, gp, o, m, n, eta, K, bn, smem, st);
}

const char* fastmix_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
