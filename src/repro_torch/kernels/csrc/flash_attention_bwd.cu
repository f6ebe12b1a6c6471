// Causal flash attention, backward (dQ, dK, dV), with grouped-query heads.
//
// Replaces no Pallas kernel of its own: it is the gradient of the function
// that flash_attention.cu computes (the port of
// src/repro/kernels/flash_attention.py::flash_attention_single, pallas_call
// :96).  The reference trains through src/repro/models/attention.py::sdpa,
// whose _einsum_attention (:77) and _chunked_attention (:90) XLA
// differentiates; the port trains through its flash kernel, so that
// kernel's function needs this gradient.
//
// What it computes, for q (B, H, Sq, HD), k (B, Hkv, Skv, HD), v (B, Hkv,
// Skv, HDV), o and dO (B, H, Sq, HDV), all fp32 or all bf16, and the
// forward's fp32 lse (B, H, Sq), contiguous; (HD, HDV) is (64, 64), (128,
// 128) or, for DeepSeek's MLA (qk nope 128 + rope 64 a head, v 128), (192,
// 128), the forward's instances.  Every operand and gradient is taken
// through its batch, head and sequence strides (in elements), with the
// head dim at stride 1.  Query head h reads kv head h / (H / Hkv).  Per
// (b, h), the FlashAttention-2 backward:
//   D   = rowsum(dO o)                     (fp32, written to `delta`; o
//         is fp32 for bf16 calls too: the forward's o32, before its cast,
//         which the training path saves; see flash_attention.cu)
//   s   = (q / sqrt(HD)) k^T;  P = exp(s - lse) where col < Skv and, when
//         causal, row >= col on absolute indices (top-left), else 0
//   dV  = P^T dO;  dP = dO V^T;  dS = P (dP - D)
//   dQ  = dS K / sqrt(HD);  dK = dS^T (q / sqrt(HD))
// S's dots and dQ, dK run over HD, dP's dots, dV and D over HDV.  Every
// sum runs in fp32; dK and dV sum the H / Hkv query heads of their kv head
// before the cast; every gradient is cast to the operands' type.
//
// Deterministic, without atomics: two grids, launched one after the other
// on the caller's stream, each owning what it writes.
//   dQ grid    (q tiles, B H): D for the tile's rows (written for the
//              second grid), then a loop over the kv tiles the tile's rows
//              see, dQ held in registers.
//   dK/dV grid (kv tiles, B Hkv): a loop over the kv head's H / Hkv query
//              heads and, per head, over the q tiles that see the kv tile,
//              dK and dV held in registers.
// Each sum runs in a fixed order, so two calls give the same bits.  Both
// grids recompute S and dP: 7 products where the bound counts 5.
//
// What bounds it on an H100: B * H * S^2 * (3 HD + 2 HDV) flops over the
// unmasked half of a causal score matrix (S, dQ, dK at HD; dP, dV at HDV;
// 5 B H S^2 HD at HD = HDV; twice that at Sq x Skv when not causal)
// against reading q, k, v, o, dO, lse once and writing dq, dk, dv once.
// At the training shape (B = 8, H = 9, Hkv = 3, S = 512, HD = 64) that is
// some 240 flops a byte, below the card's 295 for bf16: the bytes bound
// it; at S = 4096 the tensor cores' rate does; at MLA's (B = 4, H = Hkv
// = 128, S = 512, (192, 128)) some 166 flops a byte: the bytes.
//
// bf16 (flash_bwd_dq_bf16, flash_bwd_dkdv_bf16; the LM's path): the tensor
// cores, with flash_attention.cu's tiles (flash_tiles.cuh).  A tile is 64
// rows; in a group of 4 warps each warp owns 16 of them.  Tiles stream in
// bf16 through two-stage cp.async rings of XOR-swizzled tiles (16-byte
// copies, free of bank conflicts for them and for ldmatrix; rows past Sq
// or Skv are zero-filled by the src-size-0 form, since 0 x NaN would poison
// the products); every product runs on mma.sync m16n8k16 (bf16 in, fp32
// accumulate), its operands read by ldmatrix.  P is one FFMA and one ex2:
// P = 2^(s c - lse log2 e) with c = log2(e) / sqrt(HD), on the bf16 q
// unscaled (as the forward takes it).  The masks run only on tiles that
// cross the diagonal, Sq or Skv; rows past Sq are masked to P = 0 (their
// lse and D read 0).  Blocks take their tiles heaviest first, as the
// forward's do (the i-th block, i = blockIdx.y * gridDim.x + blockIdx.x,
// takes head i mod gridDim.y).
//   dQ grid, blocks of 4 warps: the q and dO tiles are copied once; K and
//   V tiles stream.  A warp computes its 16 x 64 tiles of S = q K^T and
//   dP = dO V^T (K and V read without .trans), then dS = P (dP - D) in
//   registers; the C fragments of two 8-column tiles of dS are one A
//   fragment of dQ += dS K (K by ldmatrix.trans), as the forward reuses P.
//   The q and dO fragments are read by ldmatrix at each k-step (held, they
//   would take 64 registers at HD 128).  dQ is scaled once, at the end.  D
//   is summed from device memory in the prologue, two threads a row, from
//   the forward's fp32 o32.  At
//   HD 64 the registers are capped for three blocks an SM (167, no
//   spills): 5% faster on an H100 at the training shape than the 226 and
//   two blocks the compiler picks unbounded.
//   dK/dV grid, blocks of two groups of 4 warps: K and V are copied once;
//   the groups split the (head, q tile) iterations by parity, each with
//   its own ring of q, dO, lse and D.  A warp computes the transposed tiles
//   S^T = K q^T and dP^T = V dO^T, whose accumulators are laid out by kv
//   row, the row of dK and dV: P^T and dS^T, rounded to bf16 in registers,
//   are directly the A fragments of dV += P^T dO and dK += dS^T q (dO and q
//   by ldmatrix.trans).  P and dS never pass through shared memory.  At
//   the end the second group's sums pass through the rings' memory and are
//   added to the first group's (first + second, a fixed order).  Under the
//   causal mask kv tile 0 is seen by every q tile and the last by one, so
//   one group a block left the heavy blocks alone on the critical path: a
//   second group halves it (on an H100, 18% faster at the training shape
//   and 22% at S = 4096, hd 128 than two blocks of one group an SM).  At
//   HD 128 the dK and dV sums take 128 registers a thread, so a warp takes
//   a q tile in two passes of 32 columns, and K and V are read from shared
//   memory at each k-step; at (192, 128) they take 160 (96 of dK, 64 of
//   dV) and the block spills 208 bytes at 255 registers, in the same two
//   passes of 32 columns (four passes of 16 spilled 368 bytes and ran 5%
//   slower on an H100 at MLA's training shape).  Where HD and HDV differ,
//   the k-steps past HDV run S^T alone and the n-pairs past HDV dK alone
//   (the same loops, guarded at compile time).  The dQ block at (192,
//   128), one an SM, holds 96 registers of dQ and spills 80 bytes.
//   Shared memory: the dQ grid q, dO, two-stage K and V rings (three
//   [64][HD] and three [64][HDV] bf16 tiles) and 512 B of lse and D (48.5
//   KB at HD 64, 96.5 KB at HD 128, 120.5 KB at (192, 128): three, two and
//   one block an SM); the dK/dV grid five tiles of each width and 2 KB (82
//   KB, 162 KB, 202 KB: one block of 8 warps an SM).
//   Rounding: P is rounded to bf16 before P^T dO and dS before the dQ and
//   dK products, where FlashAttention-2 rounds (the forward rounds P before
//   P V the same way); every sum stays in fp32.  At the training shape
//   with unit-normal operands that moves dq, dk, dv by some 4e-3 of
//   max|ref| from the fp32-P formulas
//   (tests/test_torch_flash_attention.py pins the budget).
//
// fp32 (flash_bwd_dq, flash_bwd_dkdv): no tensor-core path keeps IEEE fp32
// dots (TF32 would not), so the CUDA cores: tiles of 64 rows are staged in
// shared memory as fp32 (rows padded to HD + 1 or HDV + 1 floats, so the
// column walks are free of bank conflicts); a thread owns 4 rows x 4 score
// columns (16 threads a row group) and 4 rows x HD / 16 (and HDV / 16)
// output columns; q is scaled in fp32 before the dot, and P and dS stay
// fp32.  At (192, 128) a block takes 177.75 KB (dQ) and 194 KB (dK/dV).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"

namespace {

// Batch, head and sequence strides of the eight tensors, in elements.
struct Strides {
  long long q[3], k[3], v[3], o[3], d_o[3], dq[3], dk[3], dv[3];
};

// ------------------------------------------------------------ fp32 kernels
constexpr int kB = 64;                  // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;              // threads of one 4-row group
constexpr int kRows = 4;                // rows a thread owns
constexpr int kCols = kB / kLanes;      // score columns a thread owns

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// Rows [row0, row0 + kB) of a (rows, W) operand with row stride `stride`
// into a [kB][W + 1] fp32 tile, times `mul`; rows at or past n_rows are 0.
// Where W divides the block a thread keeps one column and steps kThreads
// / W rows at a time; else (W = 192) it walks the tile's elements.
template <int W, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0, int n_rows,
                                      float mul) {
  if constexpr (kThreads % W == 0) {
    constexpr int kStep = kThreads / W;
    const int c = threadIdx.x % W;
    for (int r = threadIdx.x / W; r < kB; r += kStep)
      dst[r * (W + 1) + c] =
          row0 + r < n_rows ? ld(src + (row0 + r) * stride + c) * mul : 0.0f;
  } else {
    for (int i = threadIdx.x; i < kB * W; i += kThreads) {
      const int r = i / W, c = i % W;
      dst[r * (W + 1) + c] =
          row0 + r < n_rows ? ld(src + (row0 + r) * stride + c) * mul : 0.0f;
    }
  }
}

// s[i][j] = a[r0 + i] . b[tc + kLanes j] over W, for two [kB][W + 1] tiles.
template <int W>
__device__ __forceinline__ void dots(const float* a, const float* b, int r0,
                                     int tc, float (&s)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < W; ++c) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(r0 + i) * (W + 1) + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tc + j * kLanes) * (W + 1) + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = __fmaf_rn(av[i], bv[j], s[i][j]);
  }
}

// s -> P = exp(s - lse) on the unmasked entries (0 elsewhere, rows past Sq
// included); dp -> dS = P (dP - D).  Rows from q0 + r0, columns kv0 + tc +
// kLanes j.
__device__ __forceinline__ void grads_of_scores(
    float (&s)[kRows][kCols], float (&dp)[kRows][kCols], const float* lse_s,
    const float* d_s, int q0, int kv0, int r0, int tc, int Sq, int Skv,
    int causal) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = kv0 + tc + j * kLanes;
      const bool ok = row < Sq && col < Skv && (!causal || row >= col);
      const float p = ok ? expf(s[i][j] - lse_s[r0 + i]) : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - d_s[r0 + i]);
    }
  }
}

template <int HD, int HDV>
constexpr size_t smem_dq() {
  // q and k (first o, for D) tiles at HD, dO and v at HDV; dS; lse and D
  return ((size_t)2 * kB * (HD + 1) + (size_t)2 * kB * (HDV + 1) +
          (size_t)kB * (kB + 1) + 2 * kB) *
         sizeof(float);
}

template <int HD, int HDV>
constexpr size_t smem_dkdv() {
  // k and q tiles at HD, v and dO at HDV; P and dS; lse and D
  return ((size_t)2 * kB * (HD + 1) + (size_t)2 * kB * (HDV + 1) +
          (size_t)2 * kB * (kB + 1) + 2 * kB) *
         sizeof(float);
}

template <int HD, int HDV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv,
             int Sq, int Skv, int causal, float scale, Strides st) {
  constexpr int kP = HD + 1, kPV = HDV + 1;
  constexpr int kOut = HD / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kB][kP] q scaled
  float* dos = qs + kB * kP;            // [kB][kPV] dO
  float* ks = dos + kB * kPV;           // [kB][kP] k (first: o at kPV, for D)
  float* vs = ks + kB * kP;             // [kB][kPV] v
  float* dss = vs + kB * kPV;           // [kB][kB + 1] dS
  float* lse_s = dss + kB * (kB + 1);   // [kB]
  float* d_s = lse_s + kB;              // [kB]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = blockIdx.x * kB;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hkv * st.k[1];
  const T* vb = v + b * st.v[0] + hkv * st.v[1];
  const T* ob = o + b * st.o[0] + h * st.o[1];
  const T* dob = dout + b * st.d_o[0] + h * st.d_o[1];
  T* dqb = dq + b * st.dq[0] + h * st.dq[1];
  const long long rows = (long long)bh * Sq;

  const int tr = threadIdx.x / kLanes, tc = threadIdx.x % kLanes;
  const int r0 = tr * kRows;

  stage<HD>(qs, qb, st.q[2], q0, Sq, scale);
  stage<HDV>(dos, dob, st.d_o[2], q0, Sq, 1.0f);
  stage<HDV>(ks, ob, st.o[2], q0, Sq, 1.0f);
  if (threadIdx.x < kB)
    lse_s[threadIdx.x] =
        q0 + threadIdx.x < Sq ? lse[rows + q0 + threadIdx.x] : 0.0f;
  __syncthreads();
  {
    // D = rowsum(dO o): four lanes a row, summed in a fixed order
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.0f;
    for (int c = part; c < HDV; c += 4)
      acc = __fmaf_rn(dos[r * kPV + c], ks[r * kPV + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      d_s[r] = acc;
      if (q0 + r < Sq) delta[rows + q0 + r] = acc;
    }
  }

  float acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;

  int n_tiles = (Skv + kB - 1) / kB;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kB, Sq) - 1) / kB + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kB;
    __syncthreads();                    // the last readers of ks, vs, dss
    stage<HD>(ks, kb, st.k[2], kv0, Skv, 1.0f);
    stage<HDV>(vs, vb, st.v[2], kv0, Skv, 1.0f);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    dots<HD>(qs, ks, r0, tc, s);
    dots<HDV>(dos, vs, r0, tc, dp);
    grads_of_scores(s, dp, lse_s, d_s, q0, kv0, r0, tc, Sq, Skv, causal);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dss[(r0 + i) * (kB + 1) + tc + j * kLanes] = dp[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(r0 + i) * (kB + 1) + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float kv = ks[c * kP + tc + j * kLanes];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][j] = __fmaf_rn(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      put(dqb + row * st.dq[2] + tc + j * kLanes, acc[i][j] * scale);
  }
}

template <int HD, int HDV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv,
               int Sq, int Skv, int causal, float scale, Strides st) {
  constexpr int kP = HD + 1, kPV = HDV + 1;
  constexpr int kOut = HD / kLanes, kOutV = HDV / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;                     // [kB][kP] this block's k tile
  float* vs = ks + kB * kP;             // [kB][kPV] this block's v tile
  float* qs = vs + kB * kPV;            // [kB][kP] q scaled
  float* dos = qs + kB * kP;            // [kB][kPV] dO
  float* ps = dos + kB * kPV;           // [kB][kB + 1] P
  float* dss = ps + kB * (kB + 1);      // [kB][kB + 1] dS
  float* lse_s = dss + kB * (kB + 1);   // [kB]
  float* d_s = lse_s + kB;              // [kB]

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv % Hkv;
  const int rep = H / Hkv;
  const int kv0 = blockIdx.x * kB;
  const T* kb = k + b * st.k[0] + hkv * st.k[1];
  const T* vb = v + b * st.v[0] + hkv * st.v[1];
  T* dkb = dk + b * st.dk[0] + hkv * st.dk[1];
  T* dvb = dv + b * st.dv[0] + hkv * st.dv[1];

  const int tr = threadIdx.x / kLanes, tc = threadIdx.x % kLanes;
  const int r0 = tr * kRows;   // q rows of the scores; kv rows of dK, dV

  stage<HD>(ks, kb, st.k[2], kv0, Skv, 1.0f);
  stage<HDV>(vs, vb, st.v[2], kv0, Skv, 1.0f);

  float adk[kRows][kOut], adv[kRows][kOutV];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) adk[i][j] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOutV; ++j) adv[i][j] = 0.0f;
  }

  const int n_q = (Sq + kB - 1) / kB;
  // causal: q tiles above this kv tile's first column see none of it
  const int first = causal ? kv0 / kB : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hkv * rep + hh;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* dob = dout + b * st.d_o[0] + h * st.d_o[1];
    const long long rows = ((long long)b * H + h) * Sq;
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();                  // the last readers of qs, dos, ps, dss
      stage<HD>(qs, qb, st.q[2], q0, Sq, scale);
      stage<HDV>(dos, dob, st.d_o[2], q0, Sq, 1.0f);
      if (threadIdx.x < kB) {
        const bool in = q0 + threadIdx.x < Sq;
        lse_s[threadIdx.x] = in ? lse[rows + q0 + threadIdx.x] : 0.0f;
        d_s[threadIdx.x] = in ? delta[rows + q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      float s[kRows][kCols], dp[kRows][kCols];
      dots<HD>(qs, ks, r0, tc, s);
      dots<HDV>(dos, vs, r0, tc, dp);
      grads_of_scores(s, dp, lse_s, d_s, q0, kv0, r0, tc, Sq, Skv, causal);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          ps[(r0 + i) * (kB + 1) + tc + j * kLanes] = s[i][j];
          dss[(r0 + i) * (kB + 1) + tc + j * kLanes] = dp[i][j];
        }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {    // the tile's q rows, in order
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = ps[r * (kB + 1) + r0 + i];
          dsv[i] = dss[r * (kB + 1) + r0 + i];
        }
#pragma unroll
        for (int j = 0; j < kOutV; ++j) {
          const float dov = dos[r * kPV + tc + j * kLanes];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            adv[i][j] = __fmaf_rn(pv[i], dov, adv[i][j]);
        }
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          const float qv = qs[r * kP + tc + j * kLanes];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            adk[i][j] = __fmaf_rn(dsv[i], qv, adk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = kv0 + r0 + i;
    if (row >= Skv) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      put(dkb + row * st.dk[2] + tc + j * kLanes, adk[i][j]);
#pragma unroll
    for (int j = 0; j < kOutV; ++j)
      put(dvb + row * st.dv[2] + tc + j * kLanes, adv[i][j]);
  }
}

// ------------------------------------------------------------ bf16 kernels
constexpr int kStages = 2;              // depth of the cp.async rings
static_assert(kTileThreads == 2 * kTileRows,
              "the lse and D rows are copied one float a thread");

// One 4-byte global -> shared copy in flight (a row's lse or D);
// src_bytes 0 zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int HD, int HDV>
constexpr size_t smem_dq_bf16() {
  // q and a two-stage K ring of [64][HD] bf16, dO and a two-stage V ring
  // of [64][HDV]; lse and D of 64 rows
  return (size_t)3 * kTileRows * (HD + HDV) * sizeof(bf16) +
         (size_t)2 * kTileRows * sizeof(float);
}

template <int HD, int HDV>
constexpr size_t smem_dkdv_bf16() {
  // K [64][HD] and V [64][HDV], then a ring a warp group: two-stage q
  // [64][HD] and dO [64][HDV] tiles, lse and D of 64 rows each stage
  return (size_t)(1 + 2 * kStages) * kTileRows * (HD + HDV) * sizeof(bf16) +
         (size_t)2 * 2 * kStages * kTileRows * sizeof(float);
}

// The warp's 16 rows of an fp32 (16, W) accumulator held as C fragments,
// times mul, rounded to bf16 into the same rows of a swizzled [rows][W]
// shared tile, then copied to rows row0 + (those rows) of dst below n_rows
// by 16-byte stores.  Touches only the warp's own rows of `tile`.
template <int W>
__device__ __forceinline__ void store_rows(bf16* tile,
                                           const float (&acc)[W / 8][4],
                                           float mul, bf16* dst,
                                           long long stride, int row0,
                                           int n_rows) {
  constexpr int kChunks = W / 8;
  const int lane = threadIdx.x % 32, wr = threadIdx.x / 32 * 16;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr + g + hh * 8;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(tile + swz<W>(r, n * 8) + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * hh] * mul,
                                acc[n][2 * hh + 1] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int idx = lane + i * 32;
    const int r = wr + idx / kChunks, c = idx % kChunks;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<W>(r, c * 8));
  }
}

// Two n-tiles of C fragments (16 x 8 each, fp32) rounded to bf16 as the A
// fragment of one 16 x 16 k-step.
__device__ __forceinline__ void a_fragment(unsigned (&a)[4],
                                           const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kTileThreads,
                                  HD == 64 ? 3 : HD == 128 ? 2 : 1)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ o,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, int H, int Hkv, int Sq, int Skv,
                  int causal, float scale, Strides st) {
  constexpr int kTile = kTileRows * HD;
  constexpr int kTileV = kTileRows * HDV;
  constexpr int kKB = HD / 16;          // k-steps of S; n-pairs of dQ
  constexpr int kVB = HDV / 16;         // k-steps of dP
  constexpr int kSteps = kKB > kVB ? kKB : kVB;
  constexpr int kN = kTileRows / 8;     // score n-tiles of 8 kv columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);     // [64][HD]
  bf16* sdo = sq + kTile;                           // [64][HDV]
  bf16* sk = sdo + kTileV;                          // [kStages][64][HD]
  bf16* sv = sk + kStages * kTile;                  // [kStages][64][HDV]
  float* lse_s = reinterpret_cast<float*>(sv + kStages * kTileV);  // [64]
  float* d_s = lse_s + kTileRows;                                  // [64]

  // the i-th block takes q tile (from the last) i / (B H) of (b, h) =
  // i mod (B H): every head's heaviest tile first
  const long long lin = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = (int)(lin % gridDim.y);
  const int q0 = (gridDim.x - 1 - (int)(lin / gridDim.y)) * kTileRows;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + hkv * st.k[1];
  const bf16* vb = v + b * st.v[0] + hkv * st.v[1];
  const float* ob = o + b * st.o[0] + h * st.o[1];
  const bf16* dob = dout + b * st.d_o[0] + h * st.d_o[1];
  const long long rows = (long long)bh * Sq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;           // mma quad row, column
  const int li = lane & 7, lj = lane >> 3;          // ldmatrix row, matrix
  const int wr = warp * 16;                         // the warp's first row

  int n_tiles = (Skv + kTileRows - 1) / kTileRows;
  if (causal)
    n_tiles = min(n_tiles, (min(q0 + kTileRows, Sq) - 1) / kTileRows + 1);

  // one commit group per kv tile; the q and dO tiles travel with tile 0
  load_tile<HD>(sq, qb, st.q[2], q0, Sq);
  load_tile<HDV>(sdo, dob, st.d_o[2], q0, Sq);
  load_tile<HD>(sk, kb, st.k[2], 0, Skv);
  load_tile<HDV>(sv, vb, st.v[2], 0, Skv);
  cp_async_commit();

  {
    // D = rowsum(dO o) from device memory, o the forward's fp32 o32: two
    // threads a row, each half the row in 16-byte loads, then one shuffle
    // (a fixed order)
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.0f;
    if (q0 + r < Sq) {
      const bf16* pd = dob + (q0 + r) * st.d_o[2] + half * (HDV / 2);
      const float* po = ob + (q0 + r) * st.o[2] + half * (HDV / 2);
#pragma unroll
      for (int c = 0; c < HDV / 16; ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(pd + c * 8);
        const __nv_bfloat162* x2 =
            reinterpret_cast<const __nv_bfloat162*>(&x);
        const float4 y0 = *reinterpret_cast<const float4*>(po + c * 8);
        const float4 y1 = *reinterpret_cast<const float4*>(po + c * 8 + 4);
        const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = __bfloat1622float2(x2[j]);
          acc = fmaf(a.x, y[2 * j], acc);
          acc = fmaf(a.y, y[2 * j + 1], acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const bool in = q0 + r < Sq;
      d_s[r] = acc;
      lse_s[r] = in ? lse[rows + q0 + r] : 0.0f;
      if (in) delta[rows + q0 + r] = acc;
    }
  }
  __syncthreads();
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dd[2];                 // rows wr + g and wr + g + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lse2[hh] = lse_s[wr + g + hh * 8] * kLog2e;
    dd[hh] = d_s[wr + g + hh * 8];
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kTileRows;
    if (t + 1 < n_tiles) {
      const int st1 = (t + 1) % kStages;
      load_tile<HD>(sk + st1 * kTile, kb, st.k[2], kv0 + kTileRows, Skv);
      load_tile<HDV>(sv + st1 * kTileV, vb, st.v[2], kv0 + kTileRows, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();                 // tile t (and q, dO) have landed
    __syncthreads();
    const bf16* ks = sk + (t % kStages) * kTile;
    const bf16* vs = sv + (t % kStages) * kTileV;

    // S = q K^T (k-steps over HD) and dP = dO V^T (over HDV): 16 rows x
    // 64 columns a warp
    float s[kN][4], dp[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      unsigned qa[4], da[4];
      const int ra = wr + li + (lj & 1) * 8, ca = kk * 16 + (lj >> 1) * 8;
      if (kk < kKB) ldmatrix_x4(qa, smem_u32(sq + swz<HD>(ra, ca)));
      if (kk < kVB) ldmatrix_x4(da, smem_u32(sdo + swz<HDV>(ra, ca)));
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        const int rb = np * 16 + li + (lj >> 1) * 8, cb = kk * 16 + (lj & 1) * 8;
        unsigned r[4];
        if (kk < kKB) {
          ldmatrix_x4(r, smem_u32(ks + swz<HD>(rb, cb)));
          mma_bf16(s[2 * np], qa, r[0], r[1]);
          mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
        }
        if (kk < kVB) {
          ldmatrix_x4(r, smem_u32(vs + swz<HDV>(rb, cb)));
          mma_bf16(dp[2 * np], da, r[0], r[1]);
          mma_bf16(dp[2 * np + 1], da, r[2], r[3]);
        }
      }
    }

    // dS = P (dP - D), P = 2^(s c - lse log2 e); the masks on the tiles
    // that cross the diagonal or Skv
    const bool edge =
        kv0 + kTileRows > Skv || (causal && kv0 + kTileRows - 1 > q0);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        if (edge) {
          const int row = q0 + wr + g + (e >> 1) * 8;
          const int col = kv0 + n * 8 + 2 * t4 + (e & 1);
          if (!(col < Skv && (!causal || row >= col))) p = 0.0f;
        }
        s[n][e] = p * (dp[n][e] - dd[e >> 1]);
      }

    // dQ += dS K, dS rounded to bf16 in registers, K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      unsigned sa[4];
      a_fragment(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < kKB; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, smem_u32(ks + swz<HD>(kk * 16 + li + (lj & 1) * 8,
                                                   np * 16 + (lj >> 1) * 8)));
        mma_bf16(acc[2 * np], sa, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], sa, r[2], r[3]);
      }
    }
    __syncthreads();                    // the stage of tile t is free again
  }

  cp_async_wait<0>();
  __syncthreads();
  // through the warp's own rows of the q tile to 16-byte stores
  store_rows<HD>(sq, acc, scale, dq + b * st.dq[0] + h * st.dq[1], st.dq[2],
                 q0, Sq);
}

// The dK/dV grid's two warp groups (4 warps each) share the block's K and
// V tiles and split its (head, q tile) iterations by parity.
constexpr int kGroups = 2;
constexpr int kDkdvThreads = kGroups * kTileThreads;

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kTileThreads)
               : "memory");
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                    int causal, float scale, Strides st) {
  constexpr int kTile = kTileRows * HD;
  constexpr int kTileV = kTileRows * HDV;
  constexpr int kKB = HD / 16;          // k-steps of S^T; n-pairs of dK
  constexpr int kVB = HDV / 16;         // k-steps of dP^T; n-pairs of dV
  constexpr int kSteps = kKB > kVB ? kKB : kVB;
  constexpr int kQC = HD == 64 ? 64 : 32;  // q columns of a tile a pass
  constexpr int kRing = kStages * ((kTile + kTileV) * (int)sizeof(bf16) +
                                   2 * kTileRows * (int)sizeof(float));
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);     // [64][HD]
  bf16* sv = sk + kTile;                            // [64][HDV]
  // then one ring a warp group: q [kStages][64][HD], dO [kStages][64][HDV],
  // lse, D [kStages][64]
  const int group = threadIdx.x / kTileThreads;
  const int tid = threadIdx.x % kTileThreads;       // thread in the group
  unsigned char* ring =
      smem_raw + (kTile + kTileV) * sizeof(bf16) + group * kRing;
  bf16* sq = reinterpret_cast<bf16*>(ring);
  bf16* sdo = sq + kStages * kTile;
  float* lse_s = reinterpret_cast<float*>(sdo + kStages * kTileV);
  float* d_s = lse_s + kStages * kTileRows;

  // the i-th block takes kv tile i / (B Hkv) of (b, hkv) = i mod (B Hkv):
  // under the causal mask tile 0, which every q tile sees, first
  const long long lin = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int bkv = (int)(lin % gridDim.y);
  const int kv0 = (int)(lin / gridDim.y) * kTileRows;
  const int b = bkv / Hkv, hkv = bkv % Hkv;
  const int rep = H / Hkv;

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int li = lane & 7, lj = lane >> 3;
  const int wr = tid / 32 * 16;         // the warp's first kv row

  // iteration it takes query head hkv rep + it / per_head and q tile
  // first + it % per_head (causal: q tiles above the kv tile see none of
  // it); the group takes it = group, group + 2, ..., its j-th into ring
  // stage j % kStages
  const int n_q = (Sq + kTileRows - 1) / kTileRows;
  const int first = causal ? kv0 / kTileRows : 0;
  const int per_head = max(n_q - first, 0);
  const int n_it = rep * per_head;
  const int n_mine = (n_it - group + kGroups - 1) / kGroups;

  auto fetch = [&](int j) {
    const int it = j * kGroups + group;
    const int h = hkv * rep + it / per_head;
    const int q0 = (first + it % per_head) * kTileRows;
    const int stg = j % kStages;
    load_tile<HD>(sq + stg * kTile, q + b * st.q[0] + h * st.q[1], st.q[2],
                  q0, Sq, tid);
    load_tile<HDV>(sdo + stg * kTileV, dout + b * st.d_o[0] + h * st.d_o[1],
                   st.d_o[2], q0, Sq, tid);
    const int i = tid % kTileRows;
    const bool in = q0 + i < Sq;
    const float* src = (tid < kTileRows ? lse : delta) +
                       ((long long)b * H + h) * Sq;
    float* dst = (tid < kTileRows ? lse_s : d_s) + stg * kTileRows + i;
    cp_async4(smem_u32(dst), in ? src + q0 + i : src, in ? 4 : 0);
  };

  // K by group 0, V by group 1; both groups wait for both
  if (group == 0)
    load_tile<HD>(sk, k + b * st.k[0] + hkv * st.k[1], st.k[2], kv0, Skv,
                  tid);
  else
    load_tile<HDV>(sv, v + b * st.v[0] + hkv * st.v[1], st.v[2], kv0, Skv,
                   tid);
  cp_async_commit();
  if (n_mine > 0) fetch(0);
  cp_async_commit();                    // then one commit group a fetch
  cp_async_wait<1>();
  __syncthreads();

  const float scale_log2 = scale * kLog2e;
  float adk[HD / 8][4], adv[HDV / 8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) adk[n][e] = 0.0f;
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) adv[n][e] = 0.0f;
  }

  for (int j = 0; j < n_mine; ++j) {
    if (j + 1 < n_mine) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // fetch j has landed
    group_sync(group);
    const int it = j * kGroups + group;
    const int stg = j % kStages;
    const int q0 = (first + it % per_head) * kTileRows;
    const bf16* qs = sq + stg * kTile;
    const bf16* dos = sdo + stg * kTileV;
    const float* ls = lse_s + stg * kTileRows;
    const float* ds = d_s + stg * kTileRows;
    const bool edge =
        q0 + kTileRows > Sq || (causal && q0 < kv0 + kTileRows - 1);

#pragma unroll
    for (int c0 = 0; c0 < kTileRows; c0 += kQC) {
      // S^T = K q^T (k-steps over HD) and dP^T = V dO^T (over HDV): 16 kv
      // rows x kQC q columns a warp
      float s[kQC / 8][4], dp[kQC / 8][4];
#pragma unroll
      for (int n = 0; n < kQC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        unsigned ka[4], va[4];
        const int ra = wr + li + (lj & 1) * 8, ca = kk * 16 + (lj >> 1) * 8;
        if (kk < kKB) ldmatrix_x4(ka, smem_u32(sk + swz<HD>(ra, ca)));
        if (kk < kVB) ldmatrix_x4(va, smem_u32(sv + swz<HDV>(ra, ca)));
#pragma unroll
        for (int np = 0; np < kQC / 16; ++np) {
          const int rb = c0 + np * 16 + li + (lj >> 1) * 8;
          const int cb = kk * 16 + (lj & 1) * 8;
          unsigned r[4];
          if (kk < kKB) {
            ldmatrix_x4(r, smem_u32(qs + swz<HD>(rb, cb)));
            mma_bf16(s[2 * np], ka, r[0], r[1]);
            mma_bf16(s[2 * np + 1], ka, r[2], r[3]);
          }
          if (kk < kVB) {
            ldmatrix_x4(r, smem_u32(dos + swz<HDV>(rb, cb)));
            mma_bf16(dp[2 * np], va, r[0], r[1]);
            mma_bf16(dp[2 * np + 1], va, r[2], r[3]);
          }
        }
      }

      // P^T = 2^(s c - lse log2 e), dS^T = P^T (dP^T - D), by q column;
      // the masks (q past Sq, the diagonal) on the tiles that need them
#pragma unroll
      for (int n = 0; n < kQC / 8; ++n) {
        const int c = c0 + n * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          const float dv_e = (e & 1) ? d2.y : d2.x;
          float p = ex2(fmaf(s[n][e], scale_log2, -lv * kLog2e));
          if (edge) {
            const int qrow = q0 + c + (e & 1);
            const int kvrow = kv0 + wr + g + (e >> 1) * 8;
            if (!(qrow < Sq && (!causal || qrow >= kvrow))) p = 0.0f;
          }
          dp[n][e] = p * (dp[n][e] - dv_e);
          s[n][e] = p;
        }
      }

      // dV += P^T dO and dK += dS^T q: P^T and dS^T rounded to bf16 in
      // registers as A fragments, dO and q by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kQC / 16; ++kk) {
        unsigned pa[4], sa[4];
        a_fragment(pa, s[2 * kk], s[2 * kk + 1]);
        a_fragment(sa, dp[2 * kk], dp[2 * kk + 1]);
        const int rb = c0 + kk * 16 + li + (lj & 1) * 8;
#pragma unroll
        for (int np = 0; np < kSteps; ++np) {
          const int cb = np * 16 + (lj >> 1) * 8;
          unsigned r[4];
          if (np < kVB) {
            ldmatrix_x4_trans(r, smem_u32(dos + swz<HDV>(rb, cb)));
            mma_bf16(adv[2 * np], pa, r[0], r[1]);
            mma_bf16(adv[2 * np + 1], pa, r[2], r[3]);
          }
          if (np < kKB) {
            ldmatrix_x4_trans(r, smem_u32(qs + swz<HD>(rb, cb)));
            mma_bf16(adk[2 * np], sa, r[0], r[1]);
            mma_bf16(adk[2 * np + 1], sa, r[2], r[3]);
          }
        }
      }
    }
    group_sync(group);                  // the stage of fetch j is free
  }

  // group 1's sums, through the rings' memory, added to group 0's in a
  // fixed order (group 0 + group 1)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw +
                                        (kTile + kTileV) * sizeof(bf16));
  constexpr int kValsK = HD / 8 * 4;    // floats of dK a thread
  constexpr int kValsV = HDV / 8 * 4;   // floats of dV a thread
  static_assert((kValsK + kValsV) * kTileThreads * sizeof(float) <=
                    (size_t)kGroups * kRing,
                "the reduction fits in the rings");
  if (group == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        red[(n * 4 + e) * kTileThreads + tid] = adk[n][e];
#pragma unroll
      for (int n = 0; n < HDV / 8; ++n)
        red[(kValsK + n * 4 + e) * kTileThreads + tid] = adv[n][e];
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      adk[n][e] += red[(n * 4 + e) * kTileThreads + tid];
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n)
      adv[n][e] += red[(kValsK + n * 4 + e) * kTileThreads + tid];
  }
  // through the warp's own rows of the K and V tiles to 16-byte stores;
  // kv tiles no q row sees (causal, Sq < Skv) write zeros
  store_rows<HD>(sk, adk, scale, dk + b * st.dk[0] + hkv * st.dk[1],
                 st.dk[2], kv0, Skv);
  store_rows<HDV>(sv, adv, 1.0f, dv + b * st.dv[0] + hkv * st.dv[1],
                  st.dv[2], kv0, Skv);
}

// Allows both bf16 kernels their dynamic shared memory at (HD, HDV).
template <int HD, int HDV>
cudaError_t allow_smem_bf16() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq_bf16<HD, HDV>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_dkdv_bf16<HD, HDV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_dkdv_bf16<HD, HDV>());
}

template <int HD, int HDV>
cudaError_t occupancy_bf16(int* out) {
  cudaError_t err = allow_smem_bf16<HD, HDV>();
  if (err != cudaSuccess) return err;
  out[2] = (int)smem_dq_bf16<HD, HDV>();
  out[3] = (int)smem_dkdv_bf16<HD, HDV>();
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, flash_bwd_dq_bf16<HD, HDV>, kTileThreads, out[2]);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, flash_bwd_dkdv_bf16<HD, HDV>, kDkdvThreads, out[3]);
}

template <int HD, int HDV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int B,
                        int H, int Hkv, int Sq, int Skv, int causal,
                        float scale, const Strides& st, cudaStream_t stream) {
  cudaError_t err = allow_smem_bf16<HD, HDV>();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16<HD, HDV>
      <<<dim3((Sq + kTileRows - 1) / kTileRows, B * H), kTileThreads,
          smem_dq_bf16<HD, HDV>(), stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)o,
          (const bf16*)dout, lse, delta, (bf16*)dq, H, Hkv, Sq, Skv, causal,
          scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_bf16<HD, HDV>
      <<<dim3((Skv + kTileRows - 1) / kTileRows, B * Hkv), kDkdvThreads,
          smem_dkdv_bf16<HD, HDV>(), stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          lse, delta, (bf16*)dk, (bf16*)dv, H, Hkv, Sq, Skv, causal, scale,
          st);
  return cudaGetLastError();
}

template <int HD, int HDV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta,
                   void* dq, void* dk, void* dv, int B, int H, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   const Strides& st, cudaStream_t stream) {
  const size_t s_dq = smem_dq<HD, HDV>(), s_kv = smem_dkdv<HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<HD, HDV, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<HD, HDV, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<HD, HDV, T><<<dim3((Sq + kB - 1) / kB, B * H), kThreads, s_dq,
                              stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse,
      delta, (T*)dq, H, Hkv, Sq, Skv, causal, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<HD, HDV, T><<<dim3((Skv + kB - 1) / kB, B * Hkv), kThreads,
                                s_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, Hkv, Sq, Skv, causal, scale, st);
  return cudaGetLastError();
}

template <int HD, int HDV>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int Hkv, int Sq, int Skv,
                      int causal, float scale, const Strides& st,
                      cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<HD, HDV>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                H, Hkv, Sq, Skv, causal, scale, st, stream);
  return launch<HD, HDV, float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                H, Hkv, Sq, Skv, causal, scale, st, stream);
}

}  // namespace

extern "C" {

// dq, dk, dv of o = attention(q, k, v) (flash_attention.cu's function) for
// the incoming gradient dout: q, dq (B, H, Sq, hd), k, dk (B, Hkv, Skv,
// hd), v, dv (B, Hkv, Skv, hd_v) and o, dout (B, H, Sq, hd_v), all of one
// type (is_bf16 selects bf16, else fp32), except o, fp32 either way (a
// bf16 call's is the forward's o32); (hd, hd_v) is (64, 64), (128, 128)
// or (192, 128), and H a multiple of Hkv.  lse is the forward's fp32
// (B, H, Sq), contiguous; delta an fp32 (B, H, Sq) scratch that receives
// D = rowsum(dout o).  strides holds 24 values: the batch, head and
// sequence strides in elements of q, k, v, o, dout, dq, dk, dv in that
// order (hd at stride 1).  Two launches on `stream`.  Returns cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int B,
                        int H, int Hkv, int Sq, int Skv, int hd, int hd_v,
                        int causal, int is_bf16, float scale,
                        const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      B * H > 65535 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.d_o, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64 && hd_v == 64)
    return launch_hd<64, 64>(is_bf16, q, k, v, o, dout, lse, delta, dq, dk,
                             dv, B, H, Hkv, Sq, Skv, causal, scale, st, s);
  if (hd == 128 && hd_v == 128)
    return launch_hd<128, 128>(is_bf16, q, k, v, o, dout, lse, delta, dq, dk,
                               dv, B, H, Hkv, Sq, Skv, causal, scale, st, s);
  if (hd == 192 && hd_v == 128)
    return launch_hd<192, 128>(is_bf16, q, k, v, o, dout, lse, delta, dq, dk,
                               dv, B, H, Hkv, Sq, Skv, causal, scale, st, s);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of each bf16 kernel an SM holds at once at head dims
// (hd, hd_v), one of the pairs above: out[0] the dQ grid's, out[1] the
// dK/dV grid's; out[2] and out[3] the dynamic shared bytes of a block of
// each.  Returns cudaError_t.
int flash_attention_bwd_occupancy(int hd, int hd_v, int* out) {
  if (hd == 64 && hd_v == 64) return (int)occupancy_bf16<64, 64>(out);
  if (hd == 128 && hd_v == 128) return (int)occupancy_bf16<128, 128>(out);
  if (hd == 192 && hd_v == 128) return (int)occupancy_bf16<192, 128>(out);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
