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
// Without a wire the recursion is linear, so the K rounds are one product
// with the matrix polynomial P_K(L): P_{-1} = P_0 = I, P_{k+1} = (1 + eta)
// L P_k - eta P_{k-1}, as the reference's own fastmix_poly computes it
// wherever its Pallas kernel does not run.  Three entry points:
//   fastmix_poly    builds P_K(L) (m x m): the round loop applied to I;
//   fastmix_apply   out = P x in one pass over the iterate (the main path);
//   fastmix_rounds  the K rounds themselves: the bf16 wire, whose rounding
//                   is nonlinear, and K = 0.
//
// What bounds it on an H100.  apply moves 4 * m * n * (3 + 1) bytes with
// tracking (S, G, G_prev read once, the output written once) for
// 2 * m * m * n flops: at m = 64, 8 flops per byte against the card's 20
// (67 TFLOP/s fp32 over 3.35 TB/s), so HBM bounds it.  rounds does K times
// the flops: about 64 per byte at m = 64, K = 8, so the fp32 CUDA cores
// bound it.  At m = 50, n = 1500 (w8a) there is little work in all: the
// launch and each thread's serial chain of FMAs set the time.
//
// What the design does about it.  Each thread owns an R x C register tile
// of the (m, BN) column tile: 8 rows x 4 adjacent columns where the
// iterate is wide (throughput), 4 rows x 1 column where it is narrow
// (the serial chain per thread is 8x shorter: w8a, the P_K(L) build), as
// long as m <= 128 lets 8 warps hold the narrow tile's rows.  The
// mixing matrix M (L or P) sits in shared memory transposed, Mt[j][i], so
// for each j one load of x[j][c..c+C) and one or two broadcast 16-byte
// loads of Mt[j][i0..i0+R) feed R x C FMAs (32 per 3 loads on the wide
// tile): the FMAs set the pace, not the shared loads.
//   apply: persistent blocks walk the column tiles with a two-stage
//   cp.async ring (16-byte copies, zero-filled past n), so the next tile's
//   S, G, G_prev stream in while this tile's FMAs run; each thread forms
//   the tracking combine on the chunks it copied, in place, and stores its
//   outputs straight from registers.  Where two stages do not fit beside
//   P (m past about 200), one stage holds the combined iterate, loaded
//   before each tile's FMAs.
//   rounds: prev and cur stay in the owning thread's registers; only what
//   each agent sends lives in shared memory, double buffered, so a round
//   ends in one barrier.  Global memory is read once and written once.
// Both hold all of M in one block's shared memory, which takes m <= 230.
// Past that the panel kernels (fastmix_tiles.cuh) take any m: M and the
// iterate stream through shared memory in panels over a grid of 64 x 64
// output tiles, one launch per round (and one for the apply), the
// iterates of the rounds in device memory.
// Ragged edges: rows of Mt past m are zero, columns past n load as zero
// and are not stored; a row length n that is not a multiple of 4, or a
// base that is not 16-byte aligned, takes the 4-byte variant.  M, eta and
// K are runtime operands; the caller passes one_eta = 1 + eta rounded once
// to fp32, as the plain versions form it.
#include "fastmix_tiles.cuh"

extern "C" {

// The wrapper (kernels/fastmix.py) chooses rows, bn and stages (rows 0:
// the panel kernels of fastmix_tiles.cuh, for m past the resident limit);
// these entries refuse a thread tile whose warps exceed the block, and the
// shared-memory attribute refuses bytes past the card's limit.
//
// out = FastMix^K(track ? S + G - Gp : S) over the (m, n) fp32 iterate, K
// rounds in one launch; rows 8 or 4 picks the thread tile, rows 0 the
// panel kernels (K launches; `work` holds 2 m n floats when K >= 2, else
// it may be null).  G and Gp are ignored (may be null) when track == 0.
// Returns cudaError_t.
int fastmix_rounds(const void* L, const void* S, const void* G,
                   const void* Gp, void* out, void* work, int m, long long n,
                   float one_eta, float eta, int K, int bn, int rows,
                   int track, int wire_bf16, void* stream) {
  const float* l = (const float*)L;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) {
    if (m <= 0 || (K >= 2 && work == nullptr)) return cudaErrorInvalidValue;
    const Src x = source(s, g, gp, track);
    float* w = (float*)work;
    return wire_bf16
        ? panel_rounds<true>(l, x, o, w, m, n, one_eta, eta, K, st)
        : panel_rounds<false>(l, x, o, w, m, n, one_eta, eta, K, st);
  }
  if (!valid_tile(m, bn, rows)) return cudaErrorInvalidValue;
  const bool vec = vectorizable(S, G, Gp, out, n, track);
  if (track)
    return wire_bf16
        ? rounds<true, kWireBf16>(l, s, g, gp, nullptr, o, nullptr, m, n,
                                  one_eta, eta, K, bn, rows, vec, st)
        : rounds<true, kWireNone>(l, s, g, gp, nullptr, o, nullptr, m, n,
                                  one_eta, eta, K, bn, rows, vec, st);
  return wire_bf16
      ? rounds<false, kWireBf16>(l, s, g, gp, nullptr, o, nullptr, m, n,
                                 one_eta, eta, K, bn, rows, vec, st)
      : rounds<false, kWireNone>(l, s, g, gp, nullptr, o, nullptr, m, n,
                                 one_eta, eta, K, bn, rows, vec, st);
}

// out = P (track ? S + G - Gp : S) over the (m, n) fp32 iterate in one
// pass; P is (m, m) fp32, P_K(L) from fastmix_poly; stages 2 (a cp.async
// ring) or 1; rows 0: the panel kernel.  Returns cudaError_t.
int fastmix_apply(const void* P, const void* S, const void* G,
                  const void* Gp, void* out, int m, long long n, int bn,
                  int rows, int stages, int track, void* stream) {
  const float* p = (const float*)P;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) {
    if (m <= 0) return cudaErrorInvalidValue;
    const Src x = source(s, g, gp, track);
    return launch_panel<kApply, false>(p, x, x, x, o, m, n, 1.0f, 0.0f, st);
  }
  if (!valid_tile(m, bn, rows) || (stages != 1 && stages != 2))
    return cudaErrorInvalidValue;
  const bool vec = vectorizable(S, G, Gp, out, n, track);
  const bool two = stages == 2;
  return track ? apply<true>(p, s, g, gp, o, m, n, bn, rows, two, vec, st)
               : apply<false>(p, s, g, gp, o, m, n, bn, rows, two, vec, st);
}

// P = P_K(L), (m, m) fp32 row-major: the round loop applied to I, on the
// narrow thread tile (rows 4: m columns are little work) where it fits;
// rows 0: the panel rounds (`work` as in fastmix_rounds, n = m).
int fastmix_poly(const void* L, void* P, void* work, int m, float one_eta,
                 float eta, int K, int bn, int rows, void* stream) {
  const float* l = (const float*)L;
  float* p = (float*)P;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) {
    if (m <= 0 || (K >= 2 && work == nullptr)) return cudaErrorInvalidValue;
    return panel_rounds<false>(l, identity(), p, (float*)work, m, m,
                               one_eta, eta, K, st);
  }
  if (!valid_tile(m, bn, rows)) return cudaErrorInvalidValue;
  return rows == 4
      ? launch_rounds<false, kWireNone, false, true, 4, 1>(
            l, nullptr, nullptr, nullptr, nullptr, p, nullptr, m, m,
            one_eta, eta, K, bn, st)
      : launch_rounds<false, kWireNone, false, true, 8, 4>(
            l, nullptr, nullptr, nullptr, nullptr, p, nullptr, m, m,
            one_eta, eta, K, bn, st);
}

const char* fastmix_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
