// FastMix rounds (Alg. 3) over the fp8 error-feedback wire, optionally fused
// with subspace tracking (Eqn. 3.1).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fastmix.py::_fastmix_track_ef_fused (pallas_call :565,
//     body _fastmix_track_ef_kernel :501, rounds _rounds_ef :221) -> TRACK = true
//   src/repro/kernels/fastmix.py::_fastmix_ef_fused (pallas_call :401,
//     body _fastmix_ef_kernel :258)                                -> TRACK = false
//
// What it computes, per column c of the flattened (m, n) iterate, with the
// per-agent wire replica h (the error-feedback state) carried beside it:
//   x    = S + G - G_prev          (TRACK)   or   x = S
//   prev = cur = x,  h = err
//   K times:  f     = clamp(cbrt(cur - h), -448, 448)
//             fq    = fp32(e4m3fn_rne(f))              (the 1-byte send)
//             h     = h + (fq * fq) * fq
//             mixed = (cur + sum_j L[i, j] * h[j]) - h  (fp32 FMAs, j ascending)
//             prev, cur = cur, (1 + eta) * mixed - eta * prev
//   out = cur, err_out = h         (fp32)
//
// The cube root is (float)cbrt((double)v), the same route as the plain
// version's f64 root rounded to fp32.  The clamp keeps NaN (comparisons,
// not fminf/fmaxf, which would drop it), and the cast is Hopper's native
// round-to-nearest-even e4m3 conversion with saturation, so the kernel and
// the reference's clip-then-cast agree.  Build without --use_fast_math: it
// would flush the subnormal innovations the companded wire reaches (down to
// 2^-27) and swap in an approximate root.
//
// What bounds it on an H100: each element of S (G, G_prev) and err is read
// once and out and err_out written once, 4 * m * n * 6 bytes tracked; the
// work per round is 2 * m * m * n FMA flops plus about 10 flops and one f64
// cube root per element.  At m = 64 that is about 1 flop per byte: the fp32
// CUDA-core rate bounds it, and the f64 root (H100's f64 rate is half its
// fp32 rate, and cbrt costs tens of f64 operations) adds a term of the same
// order per round.
//
// What the design does about it: as in fastmix.cu, one block owns a
// BN-column tile for all K rounds, with L, prev, cur and the replica h in
// shared memory; global memory is touched once to load the tile and once
// to store it.  Each round is two phases separated by a barrier: every
// thread advances h on its elements (the send), then each thread mixes
// four rows of one column (the receive), writing nxt over prev in place.
// That holds L in one block's shared memory, which takes m <= 228.  Past
// it each round is two launches: an elementwise send that advances h in
// err_out, then FastMix's panel kernel (fastmix_tiles.cuh) for the
// receive, the iterates rotating through device memory.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "fastmix_tiles.cuh"

namespace {

constexpr int kRowsPerThread = 4;
constexpr float kFp8Max = 448.0f;

// Round to e4m3fn (nearest even, saturating) and back: exact through half.
__device__ __forceinline__ float fp8_round(float f) {
  const __nv_fp8_storage_t q =
      __nv_cvt_float_to_fp8(f, __NV_SATFINITE, __NV_E4M3);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3)));
}

// One error-feedback send: the replica advanced by the companded innovation.
__device__ __forceinline__ float ef_send(float cur, float h) {
  float f = (float)cbrt((double)__fsub_rn(cur, h));
  f = f > kFp8Max ? kFp8Max : (f < -kFp8Max ? -kFp8Max : f);   // NaN stays
  const float fq = fp8_round(f);
  return __fadd_rn(h, __fmul_rn(__fmul_rn(fq, fq), fq));
}

template <bool TRACK>
__global__ void __launch_bounds__(kThreads)
fastmix_ef_kernel(const float* __restrict__ L, const float* __restrict__ S,
                  const float* __restrict__ G, const float* __restrict__ Gp,
                  const float* __restrict__ err, float* __restrict__ out,
                  float* __restrict__ err_out, int m, long long n,
                  float one_eta, float eta, int K, int bn) {
  extern __shared__ float smem[];
  const int mp = (m + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  float* sL = smem;                       // mp x m   (rows >= m are zero)
  float* prev = sL + mp * m;              // m x bn
  float* cur = prev + m * bn;             // m x bn
  float* h = cur + m * bn;                // m x bn   wire replica

  const int tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * bn;

  for (int idx = tid; idx < mp * m; idx += kThreads)
    sL[idx] = idx < m * m ? L[idx] : 0.0f;
  for (int idx = tid; idx < m * bn; idx += kThreads) {
    const int i = idx / bn, c = idx % bn;
    const long long col = c0 + c;
    float v = 0.0f, e = 0.0f;
    if (col < n) {
      const long long g = (long long)i * n + col;
      v = S[g];
      if (TRACK) v = __fsub_rn(__fadd_rn(v, G[g]), Gp[g]);  // (s + g) - gp
      e = err[g];
    }
    prev[idx] = v;
    cur[idx] = v;
    h[idx] = e;
  }
  __syncthreads();

  const int c = tid % bn;
  const int group = tid / bn;
  const int groups = kThreads / bn;
  for (int round = 0; round < K; ++round) {
    for (int idx = tid; idx < m * bn; idx += kThreads)       // the send
      h[idx] = ef_send(cur[idx], h[idx]);
    __syncthreads();
    // the receive; nxt overwrites prev in place: prev[i][c] is read only by
    // the thread that writes it, and h, cur are only read in this phase
    for (int i0 = group * kRowsPerThread; i0 < m;
         i0 += groups * kRowsPerThread) {
      float acc[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < m; ++j) {
        const float hj = h[j * bn + c];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = __fmaf_rn(sL[(i0 + r) * m + j], hj, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + r;
        if (i < m) {
          const int e = i * bn + c;
          const float mixed = __fsub_rn(__fadd_rn(cur[e], acc[r]), h[e]);
          prev[e] = __fsub_rn(__fmul_rn(one_eta, mixed),
                              __fmul_rn(eta, prev[e]));
        }
      }
    }
    __syncthreads();
    float* t = prev; prev = cur; cur = t;     // prev <- cur, cur <- nxt
  }

  for (int idx = tid; idx < m * bn; idx += kThreads) {
    const int i = idx / bn, cc = idx % bn;
    const long long col = c0 + cc;
    if (col < n) {
      const long long g = (long long)i * n + col;
      out[g] = cur[idx];
      err_out[g] = h[idx];
    }
  }
}

template <bool TRACK>
cudaError_t launch(const float* L, const float* S, const float* G,
                   const float* Gp, const float* err, float* out,
                   float* err_out, int m, long long n, float one_eta,
                   float eta, int K, int bn, size_t smem,
                   cudaStream_t stream) {
  auto kern = fastmix_ef_kernel<TRACK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (n + bn - 1) / bn;
  kern<<<(unsigned)tiles, kThreads, smem, stream>>>(L, S, G, Gp, err, out,
                                                    err_out, m, n, one_eta,
                                                    eta, K, bn);
  return cudaGetLastError();
}

// One send over every element: h_out = ef_send(cur, h_in) (in place
// when h_in == h_out).
__global__ void __launch_bounds__(kThreads)
ef_send_kernel(Src cur, const float* h_in, float* h_out, int m,
               long long n) {
  const long long total = (long long)m * n;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < total; g += (long long)gridDim.x * kThreads)
    h_out[g] = ef_send(cur.at((int)(g / n), g % n, n), h_in[g]);
}

// K rounds past the resident limit: per round the send (h in err_out;
// err is read in the first), then the panel receive.  K <= 0: out = x,
// err_out = err.
cudaError_t ef_panel_rounds(const float* L, Src x, const float* err,
                            float* out, float* err_out, float* work, int m,
                            long long n, float one_eta, float eta, int K,
                            cudaStream_t st) {
  if (K <= 0) {
    const cudaError_t e = copy_source(x, out, m, n, st);
    if (e != cudaSuccess) return e;
    return copy_source(buffer(err), err_out, m, n, st);
  }
  for (int t = 0; t < K; ++t) {
    const Src cur = t == 0 ? x : buffer(round_out(out, work, m, n, t - 1, K));
    const Src prev =
        t <= 1 ? x : buffer(round_out(out, work, m, n, t - 2, K));
    ef_send_kernel<<<elementwise_blocks(m, n), kThreads, 0, st>>>(
        cur, t == 0 ? err : err_out, err_out, m, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_panel<kEfRecv, false>(L, buffer(err_out), prev, cur,
                                     round_out(out, work, m, n, t, K), m, n,
                                     one_eta, eta, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for (m, bn); the wrapper's
// ef_tile_width(m) picks bn with the same formula.
size_t fastmix_ef_smem_bytes(int m, int bn) {
  const int mp = (m + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  return sizeof(float) * ((size_t)mp * m + (size_t)3 * m * bn);
}

// (out, err_out) = fp8-EF FastMix^K(track ? S + G - Gp : S, err) over the
// (m, n) fp32 iterate.  G and Gp are ignored (may be null) when track == 0.
// bn 0: the panel path (2K launches; `work` holds 2 m n floats when
// K >= 2, else it may be null).  Returns cudaError_t.
int fastmix_ef_rounds(const void* L, const void* S, const void* G,
                      const void* Gp, const void* err, void* out,
                      void* err_out, void* work, int m, long long n,
                      float one_eta, float eta, int K, int bn, int track,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)L;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  const float* e = (const float*)err;
  float* o = (float*)out;
  float* eo = (float*)err_out;
  if (bn == 0) {
    if (m <= 0 || (K >= 2 && work == nullptr)) return cudaErrorInvalidValue;
    return ef_panel_rounds(l, source(s, g, gp, track), e, o, eo,
                           (float*)work, m, n, one_eta, eta, K, st);
  }
  const size_t smem = fastmix_ef_smem_bytes(m, bn);
  return track ? launch<true>(l, s, g, gp, e, o, eo, m, n, one_eta, eta, K,
                              bn, smem, st)
               : launch<false>(l, s, g, gp, e, o, eo, m, n, one_eta, eta, K,
                               bn, smem, st);
}

const char* fastmix_ef_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
