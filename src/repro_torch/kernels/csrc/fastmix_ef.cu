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
// The value sent is the f64 route's, e4m3(clamp((float)cbrt((double)v))),
// the same as the plain version's f64 root rounded to fp32: the kernel
// takes the fp32 root cbrtf and falls back to the f64 one only next to an
// e4m3 rounding boundary (send_fp8 in fastmix_tiles.cuh; equal on all 2^32
// inputs, checked on the card).  The clamp keeps NaN (comparisons, not
// fminf/fmaxf, which would drop it), and the cast is Hopper's native
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
// order per round (scripts/ef_round_phases.py times each phase of a round
// on the card).  At m = 50, n = 1500 (w8a) there is little work in all:
// the launch and each thread's serial chain per round set the time.
//
// What the design does about it: it is FastMix's register-tiled round loop
// (fastmix_tiles.cuh, fastmix_rounds_kernel) on a third wire.  One block owns
// a BN-column tile for all K rounds, with L in shared memory transposed;
// each thread owns an R x C register tile of prev and cur (8 x 4 where the
// iterate is wide, 4 x 1 where it is narrow, as the wrapper's rounds_tile
// picks), so for each agent j one load of h[j][c..c+C) and one or two
// broadcast loads of Lt[j][i0..i0+R) feed R x C FMAs.  What an agent sends is
// its replica h, so the double-buffered sent array holds h itself: at the
// end of a round each thread advances h = ef_send(cur, h) on its own tile
// (reading its h back from the buffer the round mixed) and writes it to the
// other buffer, and the next round forms L h and (cur + L h) - h from there.
// The sends run in a pass of their own after the combine, when the
// product's accumulators are dead, which keeps the f64 roots' temporaries
// in fewer registers.
// One barrier per round; global memory is read once and written once.  At
// w8a the 4 x 1 tile gives 188 blocks of 4 warps and 4 cube roots per
// thread per round.  L in one block's shared memory beside the two buffers
// takes m <= 230 (the round loop's own limit).  Past it each round is two
// launches: an elementwise send that advances h in err_out, then FastMix's
// panel kernel (fastmix_tiles.cuh: the cp.async ring over a grid sized to
// the SMs, and its slice axis) for the receive, the iterates rotating
// through device memory.  The launch goes through the Setup cache
// (launch.cuh): the shared-memory attribute is set once per device and size.
#include "fastmix_tiles.cuh"

namespace {

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
// err is read in the first), then the panel receive, over every slice
// (contiguous (m, n) iterates: the send runs over their slices m rows).
// K <= 0: out = x, err_out = err.
cudaError_t ef_panel_rounds(const float* L, Src x, const float* err,
                            float* out, float* err_out, float* work, int m,
                            long long n, float one_eta, float eta, int K,
                            const Panel& p, cudaStream_t st) {
  const int count = p.sl.count;
  if (K <= 0) {
    const cudaError_t e = copy_source(x, out, m, n, count, st);
    if (e != cudaSuccess) return e;
    return copy_source(buffer(err), err_out, m, n, count, st);
  }
  const int rows = count * m;
  const long long w = (long long)rows * n;
  for (int t = 0; t < K; ++t) {
    const Src cur = t == 0 ? x : buffer(round_out(out, work, w, t - 1, K));
    const Src prev = t <= 1 ? x : buffer(round_out(out, work, w, t - 2, K));
    ef_send_kernel<<<elementwise_blocks(rows, n), kThreads, 0, st>>>(
        cur, t == 0 ? err : err_out, err_out, rows, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_panel<kEfRecv, false>(L, buffer(err_out), prev, cur,
                                     round_out(out, work, w, t, K), m, n,
                                     one_eta, eta, p, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// (out, err_out) = fp8-EF FastMix^K(track ? S + G - Gp : S, err) over the
// (m, n) fp32 iterate.  G and Gp are ignored (may be null) when track == 0.
// rows 8 or 4 picks the round loop's thread tile and bn its column tile (the
// wrapper's rounds_tile); rows 0 the panel path on a panel_bm x bn output
// tile (2K launches; `work` holds 2 slices m n floats when K >= 2, else it
// may be null).  slices, x_stride, m_stride, coef and coef_stride as in
// fastmix.cu's fastmix_rounds.  Returns cudaError_t.
int fastmix_ef_rounds(const void* L, const void* S, const void* G,
                      const void* Gp, const void* err, void* out,
                      void* err_out, void* work, int m, long long n,
                      float one_eta, float eta, int K, int bn, int rows,
                      int panel_bm, int track, int slices,
                      long long x_stride, long long m_stride,
                      const void* coef, long long coef_stride,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)L;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  const float* e = (const float*)err;
  float* o = (float*)out;
  float* eo = (float*)err_out;
  const Slices sl = {slices, x_stride, m_stride, (const float*)coef,
                     coef_stride, nullptr};
  if (!valid_slices(sl)) return cudaErrorInvalidValue;
  const bool vec = vectorizable(S, G, Gp, out, n, track, x_stride) &&
                   aligned16(err) && aligned16(err_out);
  if (rows == 0) {
    if (!valid_panel(m, n, panel_bm, bn, sl) || (K >= 2 && work == nullptr))
      return cudaErrorInvalidValue;
    return ef_panel_rounds(
        l, source(s, g, gp, track), e, o, eo, (float*)work, m, n, one_eta,
        eta, K, make_panel(panel_bm, bn, l, m, vec && aligned16(work), sl),
        st);
  }
  if (!valid_tile(m, bn, rows)) return cudaErrorInvalidValue;
  return track
      ? rounds<true, kWireFp8Ef>(l, s, g, gp, e, o, eo, m, n, one_eta, eta,
                                 K, bn, rows, vec, sl, st)
      : rounds<false, kWireFp8Ef>(l, s, g, gp, e, o, eo, m, n, one_eta, eta,
                                  K, bn, rows, vec, sl, st);
}

// The panel receive's occupancy on a bm x bn tile (fastmix.cu's
// fastmix_panel_occupancy, kind 2).  Returns cudaError_t.
int fastmix_ef_panel_occupancy(int bm, int bn, int* out) {
  return (int)panel_occupancy<kEfRecv, false>(bm, bn, false, out);
}

const char* fastmix_ef_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
