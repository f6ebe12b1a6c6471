// Dense local power step followed by subspace tracking (Eqn. 3.1) and the
// FastMix gossip (Alg. 3): DeEPCA's gossip half-iteration for explicit
// per-agent matrices A_j, two kernels behind one C entry.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fastmix.py::_apply_track_fused (pallas_call :797,
//     body _apply_track_kernel :629)
//
// What it computes, for every agent a and every column of the flattened
// (m, d*k) iterate:
//   G[a]  = A[a] @ W[a]          (fp32 FMAs over the contraction, ascending)
//   x     = (S + G) - G_prev
//   S_new = P_K(L) x                            (no wire, K > 0)
//         = K rounds  sent = bf16_rne(cur); mixed = L sent;
//                     prev, cur = cur, (1 + eta) mixed - eta prev   (bf16)
//         = x                                   (K = 0)
//   and G written once (the next iteration's G_prev).
//
// What bounds it on an H100: A (m d^2 floats) is read once, W, S, G_prev
// once and S_new, G written once: 4 (m d^2 + 5 m d k + m^2) bytes; the
// product is 2 m d^2 k flops and the P_K(L) apply 2 m^2 d k.  At m = 64,
// d = 4096, k = 32 that is 4.3 GB (1.3 ms at 3.35 TB/s) against 69 GFLOP
// (1.0 ms at 67 TFLOP/s fp32): HBM bounds it, the fp32 CUDA cores close
// behind.
//
// What the design does about it.  The rounds mix across agents, but the
// product does not, so the two run as separate kernels on the stream and
// the product never stages another agent's W:
//   1. the per-agent product (product_tiles.cuh, shared with
//      power_matmul.cu), the contraction whole in each block: grid
//      (ceil(d / BM), m), agent-major, so the blocks of one agent run
//      together and W[a] stays in L2; a 3-stage cp.async ring of A and W
//      chunks, TR x TC register tiles.  Every output is one fp32 FMA chain
//      over e ascending (no TF32).
//   2. FastMix's tracked kernels (fastmix_tiles.cuh, shared with fastmix.cu):
//      without a wire the one-pass apply of the cached P_K(L), forming the
//      tracked iterate from S, G, G_prev on its tile; with the bf16 wire, or
//      K = 0, the register-tiled round loop over L.  Past their resident
//      limit (m > 230) FastMix's panel kernels, which take any m.
// The wrapper (kernels/fastmix.py) picks BM, KP and FastMix's tile; this
// entry refuses what does not fit.  L, P and eta are runtime operands.
#include "fastmix_tiles.cuh"
#include "product_tiles.cuh"

extern "C" {

// (S_new, G) = (gossip(S + A W - Gp), A W) for A (m, d, d), W, S, Gp, S_new,
// G (m, d, k), all fp32 and contiguous.  M is P_K(L) (m, m) when the call
// applies it (no wire, K > 0: stages 1 or 2, FastMix's apply tile rows x
// bn), else L (the bf16 wire or K = 0: FastMix's round tile); one_eta is
// 1 + eta rounded once to fp32.  rows 0 takes FastMix's panel kernels
// instead (m past their resident limit; `work` holds 2 m d k floats for the
// rounds when K >= 2, else it may be null).
// bm (64 or 128) and kp (8, 16, 32 or 64, at least min(k, 64)) shape the
// product.  `problems` problems run in one call: A is (problems, m, d, d),
// W, S, Gp, S_new and G (problems, m, d, k); the product runs over all
// problems * m agents, the gossip kernel over `problems` slices (problem z
// mixes with M + z m_stride: 0 for one shared M), each problem's
// (1 + eta, eta) from coef when it is not null (pairs coef_stride floats
// apart; see fastmix.cu).  The panel kernels take one problem per call.
// Every kernel goes on `stream`.  Returns cudaError_t.
int apply_track(const void* M, const void* A, const void* W, const void* S,
                const void* Gp, void* S_new, void* G, void* work, int m,
                int d, int k, float one_eta, float eta, int K, int bm,
                int kp, int rows, int bn, int stages, int wire_bf16,
                int problems, long long m_stride, const void* coef,
                long long coef_stride, void* stream) {
  const bool rounds_path = wire_bf16 || K <= 0;
  const bool panel = rows == 0;
  const long long n = (long long)d * k;
  const Slices sl = {problems, (long long)m * n, m_stride,
                     (const float*)coef, coef_stride, nullptr};
  if (m <= 0 || !valid_slices(sl) ||
      (long long)problems * m > 65535 ||
      !product_shape_ok(d, k, bm, kp, 1) ||
      (!panel && !valid_tile(m, bn, rows)) ||
      (!panel && !rounds_path && stages != 1 && stages != 2) ||
      (panel && (problems != 1 || coef != nullptr)) ||
      (panel && rounds_path && K >= 2 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)A;
  const float* w = (const float*)W;
  const float* s = (const float*)S;
  const float* gp = (const float*)Gp;
  const float* mm = (const float*)M;
  float* sn = (float*)S_new;
  float* g = (float*)G;
  cudaError_t err =
      agent_product<false>(bm, kp, 1, a, w, g, problems * m, d, k, st);
  if (err != cudaSuccess) return (int)err;
  if (panel) {
    const Src x = source(s, g, gp, true);
    float* wk = (float*)work;
    if (!rounds_path)
      return (int)launch_panel<kApply, false>(mm, x, x, x, sn, m, n, 1.0f,
                                              0.0f, st);
    return wire_bf16
        ? (int)panel_rounds<true>(mm, x, sn, wk, m, n, one_eta, eta, K,
                                    st)
        : (int)panel_rounds<false>(mm, x, sn, wk, m, n, one_eta, eta,
                                     K, st);
  }
  const bool vec = vectorizable(s, g, gp, sn, n, 1, sl.x);
  if (rounds_path)
    return wire_bf16
        ? (int)rounds<true, kWireBf16>(mm, s, g, gp, nullptr, sn, nullptr, m,
                                       n, one_eta, eta, K, bn, rows, vec, sl,
                                       st)
        : (int)rounds<true, kWireNone>(mm, s, g, gp, nullptr, sn, nullptr, m,
                                       n, one_eta, eta, K, bn, rows, vec, sl,
                                       st);
  return (int)apply<true>(mm, s, g, gp, sn, m, n, bn, rows, stages == 2, vec,
                          problems, sl.x, m_stride, st);
}

const char* apply_track_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
