// FastMix's device code and launch helpers, shared by fastmix.cu (its C
// entries), apply_track.cu (the tracked gossip after the per-agent
// product) and fastmix_ef.cu (the round loop on the fp8-EF wire, and the
// panel receive past its resident limit).  Each source compiles its own
// copy (anonymous namespace); what the kernels compute and why they are
// built this way is set out at the top of fastmix.cu and fastmix_ef.cu,
// and above the panel kernels at the end of this file.
#pragma once
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

// What the round loop sends: the iterate itself, its bf16 rounding, or the
// fp8 error-feedback replica (fastmix_ef.cu).
enum { kWireNone, kWireBf16, kWireFp8Ef };
constexpr float kFp8Max = 448.0f;

__host__ __device__ __forceinline__ int padded_rows(int m) {
  return (m + 7) / 8 * 8;
}

// Row stride of Mt: padded_rows(m) + 4, a multiple of 4 (16-byte rows)
// that is 4 times an odd number, so j * stride covers the 8 residues
// 0, 4, ..., 28 mod 32 as j runs over 8: the transposing loader's warp of
// 4 (i) x 8 (j) stores hits 32 distinct banks.
__host__ __device__ __forceinline__ int mt_stride(int m) {
  return padded_rows(m) + 4;
}

// Mt plus `bufs` m x bn buffers: 2 for the round loop (what is sent, double
// buffered); for apply 2 stages x (3 with tracking, else 1) arrays, or 1
// (one stage of the combined iterate).
__host__ __device__ __forceinline__ size_t smem_bytes(int m, int bn,
                                                      int bufs) {
  return sizeof(float) * ((size_t)m * mt_stride(m) + (size_t)bufs * m * bn);
}

// The slices of one launch (blockIdx.z): slice z reads and writes its
// iterate (S, G, G_prev, the EF replica and the outputs) z * x floats past
// the first slice's, and its mixing matrix z * l floats past (l = 0: one
// matrix shared by every slice).  With coef, slice z takes its (1 + eta,
// eta) from coef[z * coef_stride + 0, 1] in place of the scalar arguments,
// and with k its round count from k[z].  A problem axis has x = m n; a
// window of P_K(L_t) builds has x = l = m m.  Each slice runs on the tile
// one slice alone would take, so its sums are those of a launch of its own.
struct Slices {
  int count;
  long long x;
  long long l;
  const float* coef;
  long long coef_stride;
  const int* k;
};

__device__ __forceinline__ float wire_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// e4m3fn(clamp(f)): the clamp keeps NaN (comparisons, not fminf/fmaxf,
// which would drop it), the cast rounds to nearest even and saturates.
__device__ __forceinline__ __nv_fp8_storage_t fp8_of(float f) {
  f = f > kFp8Max ? kFp8Max : (f < -kFp8Max ? -kFp8Max : f);
  return __nv_cvt_float_to_fp8(f, __NV_SATFINITE, __NV_E4M3);
}

// What an agent sends for the innovation v, the reference's route: the
// cube root in f64, rounded to fp32 once, then e4m3fn(clamp(.)).
__device__ __noinline__ __nv_fp8_storage_t send_fp8_f64(float v) {
  return fp8_of((float)cbrt((double)v));
}

// The same e4m3 value from the fp32 root a = cbrtf(v) (within 1 ulp): the
// f64 route's root lies within 2^-22 |a| of a, so where a (1 - 2^-20) and
// a (1 + 2^-20) cast to one e4m3 value, it casts to that value too;
// elsewhere (some 2^-16 of the inputs, next to an e4m3 rounding boundary)
// the f64 route decides.  Equal to send_fp8_f64 on all 2^32 fp32 inputs
// (the on-card test_fp8_send_equals_the_f64_route_on_every_input).
__device__ __forceinline__ __nv_fp8_storage_t send_fp8(float v) {
  const float a = cbrtf(v);
  const __nv_fp8_storage_t lo = fp8_of(__fmul_rn(a, 1.0f - 0x1p-20f));
  const __nv_fp8_storage_t hi = fp8_of(__fmul_rn(a, 1.0f + 0x1p-20f));
  return lo == hi ? lo : send_fp8_f64(v);
}

// One error-feedback send: the replica advanced by the companded innovation
// (e4m3 -> fp32 exactly, through half).
__device__ __forceinline__ float ef_send(float cur, float h) {
  const float fq = __half2float(
      __half(__nv_cvt_fp8_to_halfraw(send_fp8(__fsub_rn(cur, h)), __NV_E4M3)));
  return __fadd_rn(h, __fmul_rn(__fmul_rn(fq, fq), fq));
}

__device__ __forceinline__ float tracked(float s, float g, float gp) {
  return __fsub_rn(__fadd_rn(s, g), gp);            // (s + g) - gp
}

// v[0..N) = p[0..N): one scalar, or N / 4 16-byte loads (p 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 t = reinterpret_cast<const float4*>(p)[h];
      v[4 * h] = t.x; v[4 * h + 1] = t.y;
      v[4 * h + 2] = t.z; v[4 * h + 3] = t.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h)
      reinterpret_cast<float4*>(p)[h] =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  }
}

// Mt[j * ms + i] = M[i * m + j] for i < m, and 0 for m <= i < mp.
__device__ __forceinline__ void load_transposed(const float* __restrict__ M,
                                                float* Mt, int m) {
  const int mp = padded_rows(m), ms = mt_stride(m);
  const int di = (threadIdx.x & 31) >> 3, dj = threadIdx.x & 7;
  const int tj = (m + 7) / 8;
  const int patches = (mp / 4) * tj;
#pragma unroll 4
  for (int p = threadIdx.x / 32; p < patches; p += kThreads / 32) {
    const int i = p / tj * 4 + di;
    const int j = p % tj * 8 + dj;
    if (j < m) Mt[j * ms + i] = i < m ? M[(long long)i * m + j] : 0.0f;
  }
}

// Where a thread's R x C tile sits in the (m, bn) column tile.  A warp
// holds 4 row groups x 8 column groups, so for each j its loads of x touch
// 8 distinct chunks and its loads of Mt 4: one shared-memory wavefront
// each, not the 4 that 32 distinct 16-byte chunks would cost.
template <int R, int C>
struct Place {
  int i0, c;
  bool active;
  __device__ __forceinline__ Place(int m, int bn) {
    const int wc = (bn / C + 7) / 8;              // warps across the tile
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cg = warp % wc * 8 + (lane & 7);
    const int rg = warp / wc * 4 + (lane >> 3);
    i0 = rg * R;
    c = cg * C;
    active = i0 < m && c < bn;
  }
};

// Warps one block needs for (m, bn) and the R x C thread tile.
__host__ __device__ __forceinline__ int warps_needed(int m, int bn, int R,
                                                     int C) {
  return ((m + R - 1) / R + 3) / 4 * ((bn / C + 7) / 8);
}

// acc[r][q] = sum_j Mt[j][i0 + r] * x[j][c + q], fp32 FMAs over j ascending.
template <int R, int C>
__device__ __forceinline__ void product(const float* Mt, int ms,
                                        const float* x, int bn, int m,
                                        int i0, int c, float (&acc)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) acc[r][q] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    float a[R], s[C];
    load_n<C>(x + j * bn + c, s);
    load_n<R>(Mt + j * ms + i0, a);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < C; ++q)
        acc[r][q] = __fmaf_rn(a[r], s[q], acc[r][q]);
  }
}

// The thread's R x C tile of the iterate from global memory (the tracking
// combine formed in registers), zero outside (m, n).
template <bool TRACK, bool VEC, int R, int C>
__device__ __forceinline__ void load_tile(const float* __restrict__ S,
                                          const float* __restrict__ G,
                                          const float* __restrict__ Gp,
                                          int m, long long n, int i0,
                                          long long col, float (&v)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const long long g = (long long)i * n + col;
    if (VEC && C == 4) {           // n % 4 == 0: the 4 columns are all in
      float x[C] = {}, a[C], b[C];
      if (i < m && col < n) {
        load_n<C>(S + g, x);
        if (TRACK) {
          load_n<C>(G + g, a);
          load_n<C>(Gp + g, b);
#pragma unroll
          for (int q = 0; q < C; ++q) x[q] = tracked(x[q], a[q], b[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < C; ++q) v[r][q] = x[q];
    } else {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        float x = 0.0f;
        if (i < m && col + q < n) {
          x = S[g + q];
          if (TRACK) x = tracked(x, G[g + q], Gp[g + q]);
        }
        v[r][q] = x;
      }
    }
  }
}

// The (m, m) identity's tile: the start of the P_K(L) build.
template <int R, int C>
__device__ __forceinline__ void identity_tile(int m, int i0, long long col,
                                              float (&v)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q)
      v[r][q] = (i0 + r < m && i0 + r == col + q) ? 1.0f : 0.0f;
}

template <bool VEC, int R, int C>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int m,
                                           long long n, int i0,
                                           long long col,
                                           const float (&v)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i >= m) continue;
    const long long g = (long long)i * n + col;
    if (VEC && C == 4) {
      if (col < n) store_n<C>(out + g, v[r]);
    } else {
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (col + q < n) out[g + q] = v[r][q];
    }
  }
}

// What the thread's agents send: its tile of the shared (m, bn) buffer.
template <bool WIRE_BF16, int R, int C>
__device__ __forceinline__ void put_sent(float* x, int bn, int m, int i0,
                                         int c, const float (&v)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r >= m) continue;
    float t[C];
#pragma unroll
    for (int q = 0; q < C; ++q)
      t[q] = WIRE_BF16 ? wire_round(v[r][q]) : v[r][q];
    store_n<C>(x + (i0 + r) * bn + c, t);
  }
}

// K rounds with M = L over one BN-column tile per block, from x (or from
// I when IDENTITY: the P_K(L) build, n = m).  On the fp8-EF wire the
// replica h is what each agent sends, so the sent buffer holds it: the
// thread reads its own tile of h back from the buffer it mixes, and its
// registers hold prev and cur only (as on the other wires).  err is the
// replica on entry, err_out on exit (both unused on the other wires).
template <bool TRACK, int WIRE, bool VEC, bool IDENTITY, int R, int C>
__global__ void __launch_bounds__(kThreads, R == 8 ? 2 : 1)
fastmix_rounds_kernel(const float* __restrict__ M,
                      const float* __restrict__ S,
                      const float* __restrict__ G,
                      const float* __restrict__ Gp,
                      const float* __restrict__ err, float* __restrict__ out,
                      float* __restrict__ err_out, int m, long long n,
                      float one_eta, float eta, int K, int bn, Slices sl) {
  constexpr bool EF = WIRE == kWireFp8Ef;
  const long long z = blockIdx.z;
  M += z * sl.l;
  out += z * sl.x;
  if (!IDENTITY) {
    S += z * sl.x;
    if (TRACK) { G += z * sl.x; Gp += z * sl.x; }
  }
  if (EF) { err += z * sl.x; err_out += z * sl.x; }
  if (sl.coef != nullptr) {
    one_eta = sl.coef[z * sl.coef_stride];
    eta = sl.coef[z * sl.coef_stride + 1];
  }
  if (sl.k != nullptr) K = sl.k[z];
  extern __shared__ float4 smem4[];
  float* const Mt = reinterpret_cast<float*>(smem4);   // m x ms
  const int ms = mt_stride(m);
  float* const sent = Mt + m * ms;                      // 2 x m x bn
  const Place<R, C> at(m, bn);
  const bool active = at.active;
  const int i0 = at.i0, c = at.c;
  const long long col = (long long)blockIdx.x * bn + c;

  load_transposed(M, Mt, m);
  float cur[R][C], prev[R][C];
  if (active) {
    if (IDENTITY) identity_tile<R, C>(m, i0, col, cur);
    else load_tile<TRACK, VEC, R, C>(S, G, Gp, m, n, i0, col, cur);
    if constexpr (EF) {               // the first send (none when K = 0)
      float h[R][C];
      load_tile<false, VEC, R, C>(err, nullptr, nullptr, m, n, i0, col, h);
      if (K > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < C; ++q) h[r][q] = ef_send(cur[r][q], h[r][q]);
      }
      put_sent<false, R, C>(sent, bn, m, i0, c, h);
    } else {
      put_sent<WIRE == kWireBf16, R, C>(sent, bn, m, i0, c, cur);
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) prev[r][q] = cur[r][q];
  for (int round = 0; round < K; ++round) {
    // Round k reads buffer k % 2 and fills the other: every thread passed
    // the previous barrier, so nobody still reads what is overwritten.
    const float* src = sent + (round & 1) * m * bn;
    float* dst = sent + ((round + 1) & 1) * m * bn;
    const bool send = round + 1 < K;
    if (active) {
      float acc[R][C];
      product<R, C>(Mt, ms, src, bn, m, i0, c, acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float h[C] = {};              // EF: the agent's own replica
        if constexpr (EF) {
          if (i0 + r < m) load_n<C>(src + (i0 + r) * bn + c, h);
        }
#pragma unroll
        for (int q = 0; q < C; ++q) {
          float mixed = acc[r][q];
          if constexpr (EF)
            mixed = __fsub_rn(__fadd_rn(cur[r][q], mixed), h[q]);
          const float nxt = __fsub_rn(__fmul_rn(one_eta, mixed),
                                      __fmul_rn(eta, prev[r][q]));
          prev[r][q] = cur[r][q];
          cur[r][q] = nxt;
        }
      }
      if constexpr (EF) {
        // the send, in a pass of its own once acc is dead: the f64 roots'
        // temporaries then fit beside prev and cur without spilling
        if (send) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (i0 + r >= m) continue;
            float h[C];
            load_n<C>(src + (i0 + r) * bn + c, h);
#pragma unroll
            for (int q = 0; q < C; ++q) h[q] = ef_send(cur[r][q], h[q]);
            store_n<C>(dst + (i0 + r) * bn + c, h);
          }
        }
      } else if (send) {
        put_sent<WIRE == kWireBf16, R, C>(dst, bn, m, i0, c, cur);
      }
    }
    __syncthreads();
  }
  if (active) {
    store_tile<VEC, R, C>(out, m, n, i0, col, cur);
    if constexpr (EF) {               // the last replica sent (err if K = 0)
      const float* last = sent + (K > 0 ? (K - 1) & 1 : 0) * m * bn;
      float h[R][C] = {};
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < m) load_n<C>(last + (i0 + r) * bn + c, h[r]);
      store_tile<VEC, R, C>(err_out, m, n, i0, col, h);
    }
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// One column tile's S (G, G_prev) into a stage: 16-byte chunks (VEC) or
// 4-byte elements, consecutive threads on consecutive addresses, zero-filled
// past n.  With TRACK each thread then forms (s + g) - gp on the chunks it
// copied, in place (finish_tile), so no barrier sits between the two.
template <bool TRACK, bool VEC>
__device__ __forceinline__ void copy_tile(float* stage,
                                          const float* __restrict__ S,
                                          const float* __restrict__ G,
                                          const float* __restrict__ Gp,
                                          int m, long long n, int bn,
                                          long long c0) {
  constexpr int W = VEC ? 4 : 1;
  const int per_row = bn / W, size = m * bn;
  for (int idx = threadIdx.x; idx < m * per_row; idx += kThreads) {
    const int i = idx / per_row, c = idx % per_row * W;
    const long long col = c0 + c;
    const bool ok = col < n;
    const long long g = ok ? (long long)i * n + col : 0;
    cp_async(stage + i * bn + c, S + g, 4 * W, ok);
    if (TRACK) {
      cp_async(stage + size + i * bn + c, G + g, 4 * W, ok);
      cp_async(stage + 2 * size + i * bn + c, Gp + g, 4 * W, ok);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void finish_tile(float* stage, int m, int bn) {
  constexpr int W = VEC ? 4 : 1;
  const int per_row = bn / W, size = m * bn;
  for (int idx = threadIdx.x; idx < m * per_row; idx += kThreads) {
    float* x = stage + idx / per_row * bn + idx % per_row * W;
    float s[W], g[W], gp[W];
    load_n<W>(x, s);
    load_n<W>(x + size, g);
    load_n<W>(x + 2 * size, gp);
#pragma unroll
    for (int q = 0; q < W; ++q) s[q] = tracked(s[q], g[q], gp[q]);
    store_n<W>(x, s);
  }
}

// One column tile's iterate into one stage with plain loads, the tracking
// combine formed in registers: the one-stage apply.
template <bool TRACK, bool VEC>
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ S,
                                           const float* __restrict__ G,
                                           const float* __restrict__ Gp,
                                           int m, long long n, int bn,
                                           long long c0) {
  constexpr int W = VEC ? 4 : 1;
  const int per_row = bn / W;
  for (int idx = threadIdx.x; idx < m * per_row; idx += kThreads) {
    const int i = idx / per_row, c = idx % per_row * W;
    const long long col = c0 + c;
    float x[W] = {};
    if (col < n) {                 // VEC: n % 4 == 0, so all W are in
      const long long g = (long long)i * n + col;
      load_n<W>(S + g, x);
      if (TRACK) {
        float a[W], b[W];
        load_n<W>(G + g, a);
        load_n<W>(Gp + g, b);
#pragma unroll
        for (int q = 0; q < W; ++q) x[q] = tracked(x[q], a[q], b[q]);
      }
    }
    store_n<W>(stage + i * bn + c, x);
  }
}

// out = P x: persistent blocks over the column tiles, two cp.async stages
// (two_stages), else one stage loaded before each tile's FMAs.
template <bool TRACK, bool VEC, int R, int C>
__global__ void __launch_bounds__(kThreads)
fastmix_apply_kernel(const float* __restrict__ P,
                     const float* __restrict__ S,
                     const float* __restrict__ G,
                     const float* __restrict__ Gp, float* __restrict__ out,
                     int m, long long n, int bn, bool two_stages,
                     long long xs, long long ps) {
  const long long z = blockIdx.z;          // the slice: x = xs, P = ps
  P += z * ps;
  S += z * xs;
  out += z * xs;
  if (TRACK) { G += z * xs; Gp += z * xs; }
  extern __shared__ float4 smem4[];
  float* const Mt = reinterpret_cast<float*>(smem4);   // m x ms
  const int ms = mt_stride(m);
  const int stage_size = (two_stages && TRACK ? 3 : 1) * m * bn;
  float* const stages = Mt + m * ms;         // 2 (or 1) x stage_size
  const Place<R, C> at(m, bn);
  const bool active = at.active;
  const int i0 = at.i0, c = at.c;
  const long long tiles = (n + bn - 1) / bn;

  long long t = blockIdx.x;
  if (two_stages && t < tiles)
    copy_tile<TRACK, VEC>(stages, S, G, Gp, m, n, bn, t * bn);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  load_transposed(P, Mt, m);            // overlaps the first tile's copy
  for (int s = 0; t < tiles; t += gridDim.x, s ^= two_stages) {
    float* const stage = stages + s * stage_size;
    if (two_stages) {
      const long long next = t + gridDim.x;
      if (next < tiles)
        copy_tile<TRACK, VEC>(stages + (s ^ 1) * stage_size, S, G, Gp, m,
                              n, bn, next * bn);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile has landed
      if (TRACK) finish_tile<VEC>(stage, m, bn);
    } else {
      load_stage<TRACK, VEC>(stage, S, G, Gp, m, n, bn, t * bn);
    }
    __syncthreads();
    if (active) {
      float acc[R][C];
      product<R, C>(Mt, ms, stage, bn, m, i0, c, acc);
      store_tile<VEC, R, C>(out, m, n, i0, t * bn + c, acc);
    }
    __syncthreads();        // the next iteration refills the other stage
  }                         // (one stage: this one)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16-byte copies need every row of every slice to start 16-byte aligned.
bool vectorizable(const void* S, const void* G, const void* Gp,
                  const void* out, long long n, int track, long long xs) {
  return n % 4 == 0 && xs % 4 == 0 && aligned16(S) && aligned16(out) &&
         (!track || (aligned16(G) && aligned16(Gp)));
}

// rows 8: the wide 8 x 4 thread tile; rows 4: the narrow 4 x 1 one.
bool valid_tile(int m, int bn, int rows) {
  const int cols = rows == 8 ? 4 : 1;
  return m > 0 && (rows == 8 || rows == 4) && bn > 0 && bn % 4 == 0 &&
         32 * warps_needed(m, bn, rows, cols) <= kThreads;
}

// The grid's z dimension holds the slices.
constexpr int kMaxSlices = 65535;

bool valid_slices(const Slices& sl) {
  return sl.count >= 1 && sl.count <= kMaxSlices && sl.x >= 0 && sl.l >= 0 &&
         sl.coef_stride >= 0;
}

// err and err_out are the fp8-EF wire's replica (null on the others).
template <bool TRACK, int WIRE, bool VEC, bool IDENTITY, int R, int C>
cudaError_t launch_rounds(const float* L, const float* S, const float* G,
                          const float* Gp, const float* err, float* out,
                          float* err_out, int m, long long n, float one_eta,
                          float eta, int K, int bn, const Slices& sl,
                          cudaStream_t stream) {
  static Setup cache;
  auto kern = fastmix_rounds_kernel<TRACK, WIRE, VEC, IDENTITY, R, C>;
  const size_t smem = smem_bytes(m, bn, 2);
  int resident = 0;
  cudaError_t e = setup(cache, kern, kThreads, smem, &resident);
  if (e != cudaSuccess) return e;
  const long long tiles = (n + bn - 1) / bn;
  const dim3 grid((unsigned)tiles, 1, (unsigned)sl.count);
  kern<<<grid, kThreads, smem, stream>>>(L, S, G, Gp, err, out, err_out, m,
                                         n, one_eta, eta, K, bn, sl);
  return cudaGetLastError();
}

template <bool TRACK, bool VEC, int R, int C>
cudaError_t launch_apply(const float* P, const float* S, const float* G,
                         const float* Gp, float* out, int m, long long n,
                         int bn, bool two_stages, int slices, long long xs,
                         long long ps, cudaStream_t stream) {
  static Setup cache;
  auto kern = fastmix_apply_kernel<TRACK, VEC, R, C>;
  const size_t smem =
      smem_bytes(m, bn, two_stages ? 2 * (TRACK ? 3 : 1) : 1);
  int resident = 0;
  cudaError_t err = setup(cache, kern, kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  // the persistent blocks the device holds, shared out over the slices
  const long long tiles = (n + bn - 1) / bn;
  long long per_slice = (resident + slices - 1) / slices;
  if (per_slice > tiles) per_slice = tiles;
  const dim3 grid((unsigned)per_slice, 1, (unsigned)slices);
  kern<<<grid, kThreads, smem, stream>>>(P, S, G, Gp, out, m, n, bn,
                                         two_stages, xs, ps);
  return cudaGetLastError();
}

// K rounds on the thread tile `rows` picks (8: 8 x 4, 4: 4 x 1); err and
// err_out as in launch_rounds.
template <bool TRACK, int WIRE>
cudaError_t rounds(const float* L, const float* S, const float* G,
                   const float* Gp, const float* err, float* out,
                   float* err_out, int m, long long n, float one_eta,
                   float eta, int K, int bn, int rows, bool vec,
                   const Slices& sl, cudaStream_t st) {
  if (rows == 4)
    return launch_rounds<TRACK, WIRE, false, false, 4, 1>(
        L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K, bn, sl, st);
  return vec ? launch_rounds<TRACK, WIRE, true, false, 8, 4>(
                   L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K,
                   bn, sl, st)
             : launch_rounds<TRACK, WIRE, false, false, 8, 4>(
                   L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K,
                   bn, sl, st);
}

// out = P x over `slices` slices (iterate stride xs, P stride ps).
template <bool TRACK>
cudaError_t apply(const float* P, const float* S, const float* G,
                  const float* Gp, float* out, int m, long long n, int bn,
                  int rows, bool two, bool vec, int slices, long long xs,
                  long long ps, cudaStream_t st) {
  if (rows == 4)
    return vec ? launch_apply<TRACK, true, 4, 1>(P, S, G, Gp, out, m, n, bn,
                                                 two, slices, xs, ps, st)
               : launch_apply<TRACK, false, 4, 1>(P, S, G, Gp, out, m, n,
                                                  bn, two, slices, xs, ps,
                                                  st);
  return vec ? launch_apply<TRACK, true, 8, 4>(P, S, G, Gp, out, m, n, bn,
                                               two, slices, xs, ps, st)
             : launch_apply<TRACK, false, 8, 4>(P, S, G, Gp, out, m, n, bn,
                                                two, slices, xs, ps, st);
}

// ------------------------------------------------------------------ panels
// Any agent count.  Where M (m x m) does not fit one block's shared memory
// beside the iterate's tile (m past 230), the P_K(L) apply, and each
// round, is one launch of a tiled product over a (ceil(n / BN),
// ceil(m / BM), slices) grid.  The wrapper's panel_tile
// (kernels/fastmix.py) picks BM x BN per shape so that the grid covers the
// SMs: no sum is split between blocks (no split-K), so the tile decides
// which outputs a block owns, never an order of summation.  Each thread
// holds an R x C register tile, 4 x 4 where BN >= 32 and 4 x 1 on the
// narrow tiles of small iterates (the P_K(L) build: a chain of FMAs 4x
// shorter a thread), and one fp32 FMA chain per output over the agents j
// ascending from 0, the resident kernels' order.
//
// The block walks the agents in chunks of kChunk = 32 through a ring of
// kStages = 3 stages in shared memory, one barrier a chunk: while chunk
// c's FMAs run, the copies of chunks c + 1 and c + 2 are in flight.  Both
// panels arrive by cp.async (16-byte copies where the rows are 16-byte
// aligned, else 4-byte ones, zero-filled past m and n): M's BM x kChunk
// panel row-major (rows of kChunk + 4 floats) and the iterate's kChunk x
// BN panel.  M needs no transpose: for each 4 agents j .. j + 3 a thread
// reads M[i][j .. j + 3] of its 4 rows as float4 and x[j + t][c .. c + C)
// for t < 4, and runs the FMAs j, j + 1, j + 2, j + 3 in order.  Its rows
// are 4 apart (a warp's 4 row groups take 4 consecutive rows), so a warp's
// loads of M touch 4 consecutive rows, which the padded stride puts on
// distinct banks, and its loads of x 8 consecutive chunks of a row: one
// shared-memory wavefront each, 64 FMAs per 8 loads on the 4 x 4 tile.
// Each thread forms the tracking combine and the bf16 rounding of what is
// sent on the elements it copied, in place once its own copies landed and
// before the chunk's barrier; the combine thus happens once per element
// a row block (the rounds' later iterates are buffers).
//
// The K rounds are K launches on the stream (2K on the fp8 wire: the
// send, then the receive), the iterates rotating through (out, work, work
// + slices m n) so that the last round writes out; prev and cur of the
// first two rounds are read from the source itself, so the tracked
// iterate is never stored.  The slice axis (blockIdx.z, Slices) runs the
// B problems of a batch, or a window of builds that share K, in each
// launch; each slice runs the tile one slice alone would take.

constexpr int kChunk = 32;               // agents a ring stage
constexpr int kStages = 3;
constexpr int kMsStride = kChunk + 4;    // floats a row of the M panel

// The iterate a panel kernel reads: a buffer, the tracking combine of
// three, or the (m, m) identity (the P_K(L) build).
struct Src {
  const float* a;
  const float* b;
  const float* c;
  int kind;                  // 0: a; 1: (a + b) - c; 2: the identity
  __device__ __forceinline__ float at(long long i, long long col,
                                      long long n) const {
    if (kind == 2) return i == col ? 1.0f : 0.0f;
    const long long g = i * n + col;
    return kind == 1 ? tracked(a[g], b[g], c[g]) : a[g];
  }
  // at(i, col + q) for q < 4 by 16-byte loads (every row 16-byte aligned).
  __device__ __forceinline__ void at4(long long i, long long col,
                                      long long n, float (&v)[4]) const {
    if (kind == 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = i == col + q ? 1.0f : 0.0f;
      return;
    }
    const long long g = i * n + col;
    load_n<4>(a + g, v);
    if (kind == 1) {
      float s[4], t[4];
      load_n<4>(b + g, s);
      load_n<4>(c + g, t);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = tracked(v[q], s[q], t[q]);
    }
  }
  // The source off floats further on (a slice; the identity has none).
  __host__ __device__ __forceinline__ Src shifted(long long off) const {
    if (kind == 2) return *this;
    return {a + off, kind == 1 ? b + off : b, kind == 1 ? c + off : c,
            kind};
  }
};

inline Src buffer(const float* p) { return {p, nullptr, nullptr, 0}; }

inline Src source(const float* S, const float* G, const float* Gp,
                  bool track) {
  return {S, G, Gp, track ? 1 : 0};
}

inline Src identity() { return {nullptr, nullptr, nullptr, 2}; }

// A panel kernel's output tile (on_panel_tile lists those built).  C of
// the thread tile: 4 on a tile of 32 or 64 columns, else 1; a warp holds
// 4 x 8 thread tiles.
template <int BM, int BN>
struct PanelTile {
  static constexpr int R = 4;
  static constexpr int C = BN >= 32 ? 4 : 1;
  static constexpr int kThreads = BM / R * (BN / C);
  static constexpr int kWarpsAcross = BN / C / 8;
  static_assert(BM % 16 == 0 && (BN / C) % 8 == 0,
                "a warp holds 4 x 8 thread tiles");
};

// kStages stages of M's BM x kChunk panel (rows of kChunk + 4) and of the
// iterate's kChunk x BN panel (S, G and G_prev side by side with tracking).
inline size_t panel_smem(int bm, int bn, bool track) {
  return sizeof(float) * kStages *
         ((size_t)bm * kMsStride + (size_t)(track ? 3 : 1) * kChunk * bn);
}

// One panel launch: its tile, whether M's rows (m % 4 == 0, base and
// slice stride) and the iterates' rows (n % 4 == 0, every base) are
// 16-byte aligned, and its slices.
struct Panel {
  int bm, bn;
  bool vec_m, vec;
  Slices sl;
};

// Chunk j0 of M's rows r0 .. r0 + BM into a stage: W floats a copy.
template <int BM, int BN, int W>
__device__ __forceinline__ void panel_copy_m(const float* __restrict__ M,
                                             float* Ms, int m, int r0,
                                             int j0) {
  constexpr int kPer = kChunk / W, kN = BM * kPer;
  constexpr int kThreads = PanelTile<BM, BN>::kThreads;
  static_assert(kN % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int k = 0; k < kN / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int i = e / kPer, jj = e % kPer * W;
    const bool ok = r0 + i < m && j0 + jj < m;   // W = 4: m % 4 == 0
    const long long g = ok ? (long long)(r0 + i) * m + j0 + jj : 0;
    cp_async(Ms + i * kMsStride + jj, M + g, 4 * W, ok);
  }
}

// Chunk j0's kChunk x BN panel of x into a stage: W floats a copy (S, G
// and G_prev side by side with tracking); the identity's written directly.
template <int BM, int BN, int W>
__device__ __forceinline__ void panel_copy_x(const Src& x, float* Xs, int m,
                                             long long n, int j0,
                                             long long c0) {
  constexpr int kSize = kChunk * BN, kThreads = PanelTile<BM, BN>::kThreads;
  if (x.kind == 2) {
    static_assert(kSize % kThreads == 0, "whole elements a thread");
#pragma unroll
    for (int k = 0; k < kSize / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int j = j0 + e / BN;
      Xs[e] = j < m && j == c0 + e % BN ? 1.0f : 0.0f;
    }
    return;
  }
  constexpr int kPer = BN / W, kN = kSize / W;
  static_assert(kN % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int k = 0; k < kN / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int j = j0 + e / kPer;
    const long long col = c0 + e % kPer * W;
    const bool ok = j < m && col < n;      // W = 4: n % 4 == 0, all 4 in
    const long long g = ok ? (long long)j * n + col : 0;
    float* d = Xs + e * W;
    cp_async(d, x.a + g, 4 * W, ok);
    if (x.kind == 1) {
      cp_async(d + kSize, x.b + g, 4 * W, ok);
      cp_async(d + 2 * kSize, x.c + g, 4 * W, ok);
    }
  }
}

// What this thread copied of x, once it landed: (s + g) - gp with
// tracking, then the bf16 rounding of what is sent on that wire.
template <int BM, int BN, int W, bool WIRE_BF16>
__device__ __forceinline__ void panel_finish_x(const Src& x, float* Xs) {
  constexpr int kSize = kChunk * BN, kThreads = PanelTile<BM, BN>::kThreads;
  if (x.kind == 2 || (x.kind == 0 && !WIRE_BF16)) return;
#pragma unroll
  for (int k = 0; k < kSize / W / kThreads; ++k) {
    float* d = Xs + (threadIdx.x + k * kThreads) * W;
    float v[W];
    load_n<W>(d, v);
    if (x.kind == 1) {
      float g[W], gp[W];
      load_n<W>(d + kSize, g);
      load_n<W>(d + 2 * kSize, gp);
#pragma unroll
      for (int q = 0; q < W; ++q) v[q] = tracked(v[q], g[q], gp[q]);
    }
    if (WIRE_BF16) {
#pragma unroll
      for (int q = 0; q < W; ++q) v[q] = wire_round(v[q]);
    }
    store_n<W>(d, v);
  }
}

template <int BM, int BN>
__device__ __forceinline__ void panel_copy_chunk(
    const float* __restrict__ M, const Src& x, float* Ms, float* Xs, int m,
    long long n, int r0, int j0, long long c0, const Panel& p) {
  if (p.vec_m) panel_copy_m<BM, BN, 4>(M, Ms, m, r0, j0);
  else panel_copy_m<BM, BN, 1>(M, Ms, m, r0, j0);
  if (p.vec) panel_copy_x<BM, BN, 4>(x, Xs, m, n, j0, c0);
  else panel_copy_x<BM, BN, 1>(x, Xs, m, n, j0, c0);
}

// kApply:  out = M x
// kRound:  out = one_eta M sent(x) - eta prev   (sent = bf16_rne(x) on the
//          bf16 wire, else x)
// kEfRecv: out = one_eta ((cur + M h) - h) - eta prev, with x = h, the
//          wire replica after this round's send
// one_eta is 1 + eta rounded once to fp32 by the caller, as the plain
// versions form it; with per-slice coefficients (sl.coef) slice z's.
enum { kApply, kRound, kEfRecv };

template <int KIND, bool WIRE_BF16, int BM, int BN>
__device__ __forceinline__ void panel_body(const float* __restrict__ M,
                                           Src x, Src prev, Src cur,
                                           float* __restrict__ out, int m,
                                           long long n, float one_eta,
                                           float eta, const Panel& p) {
  using T = PanelTile<BM, BN>;
  constexpr int R = T::R, C = T::C;
  const long long z = blockIdx.z;           // the slice
  M += z * p.sl.l;
  out += z * p.sl.x;
  x = x.shifted(z * p.sl.x);
  prev = prev.shifted(z * p.sl.x);
  cur = cur.shifted(z * p.sl.x);
  if (p.sl.coef != nullptr) {
    one_eta = p.sl.coef[z * p.sl.coef_stride];
    eta = p.sl.coef[z * p.sl.coef_stride + 1];
  }
  extern __shared__ float4 smem4[];
  constexpr int kMs = BM * kMsStride;
  const int x_stage = (x.kind == 1 ? 3 : 1) * kChunk * BN;
  float* const Ms = reinterpret_cast<float*>(smem4);   // kStages x kMs
  float* const Xs = Ms + kStages * kMs;                // kStages x x_stage
  // the thread's tile: rows i0 + 4 r (r < R), columns c .. c + C
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = warp / T::kWarpsAcross * 16 + (lane >> 3);
  const int c = (warp % T::kWarpsAcross * 8 + (lane & 7)) * C;
  const int r0 = blockIdx.y * BM;
  const long long c0 = (long long)blockIdx.x * BN;
  const int chunks = (m + kChunk - 1) / kChunk;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks)
      panel_copy_chunk<BM, BN>(M, x, Ms + s * kMs, Xs + s * x_stage, m, n,
                               r0, s * kChunk, c0, p);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) acc[r][q] = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch % kStages;
    float* const Xc = Xs + s * x_stage;
    // this thread's copies of chunk ch have landed (one group per chunk)
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    if (p.vec) panel_finish_x<BM, BN, 4, WIRE_BF16>(x, Xc);
    else panel_finish_x<BM, BN, 1, WIRE_BF16>(x, Xc);
    // every thread's have, and every thread is done with chunk ch - 1,
    // whose stage the next chunk's copies refill
    __syncthreads();
    const int next = ch + kStages - 1;
    if (next < chunks)
      panel_copy_chunk<BM, BN>(M, x, Ms + next % kStages * kMs,
                               Xs + next % kStages * x_stage, m, n, r0,
                               next * kChunk, c0, p);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* A = Ms + s * kMs + i0 * kMsStride;
    const float* B = Xc + c;
    // not unrolled: the unrolled chunk takes up to 255 registers, two
    // blocks an SM, which leaves the larger grids more than one wave
#pragma unroll 1
    for (int j = 0; j < kChunk; j += 4) {
      float a[R][4];                      // a[r][t] = M[i0 + 4 r][j + t]
#pragma unroll
      for (int r = 0; r < R; ++r) load_n<4>(A + 4 * r * kMsStride + j, a[r]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float b[C];
        load_n<C>(B + (j + t) * BN, b);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < C; ++q)
            acc[r][q] = __fmaf_rn(a[r][t], b[q], acc[r][q]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r0 + i0 + 4 * r;
    const long long col = c0 + c;
    if (i >= m || col >= n) continue;
    if constexpr (C == 4) {
      if (p.vec) {                    // n % 4 == 0: the 4 columns are in
        float v[4], h[4], t[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = acc[r][q];
        if (KIND == kEfRecv) {
          cur.at4(i, col, n, t);
          x.at4(i, col, n, h);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = __fsub_rn(__fadd_rn(t[q], v[q]), h[q]);
        }
        if (KIND != kApply) {
          prev.at4(i, col, n, t);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = __fsub_rn(__fmul_rn(one_eta, v[q]),
                             __fmul_rn(eta, t[q]));
        }
        store_n<4>(out + (long long)i * n + col, v);
        continue;
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (col + q >= n) continue;
      float u = acc[r][q];
      if (KIND == kEfRecv)
        u = __fsub_rn(__fadd_rn(cur.at(i, col + q, n), u),
                      x.at(i, col + q, n));
      if (KIND != kApply)
        u = __fsub_rn(__fmul_rn(one_eta, u),
                      __fmul_rn(eta, prev.at(i, col + q, n)));
      out[(long long)i * n + col + q] = u;
    }
  }
}

template <int KIND, bool WIRE_BF16, int BM, int BN>
__global__ void __launch_bounds__(PanelTile<BM, BN>::kThreads)
panel_kernel(const float* __restrict__ M, Src x, Src prev, Src cur,
             float* __restrict__ out, int m, long long n, float one_eta,
             float eta, Panel p) {
  panel_body<KIND, WIRE_BF16, BM, BN>(M, x, prev, cur, out, m, n, one_eta,
                                      eta, p);
}

// The rounds' kernel asks for 5 blocks of 128 threads an SM (at most 102
// registers, no spills): the bf16 wire at m = 768 then runs its 564 blocks
// in one wave, not 1.07 (0.60 ms against 0.70 on the H100).  The apply and
// the fp8 receive run 3-8% faster without the bound.
template <bool WIRE_BF16, int BM, int BN>
__global__ void __launch_bounds__(PanelTile<BM, BN>::kThreads,
                                  640 / PanelTile<BM, BN>::kThreads)
panel_round_kernel(const float* __restrict__ M, Src x, Src prev, Src cur,
                   float* __restrict__ out, int m, long long n,
                   float one_eta, float eta, Panel p) {
  panel_body<kRound, WIRE_BF16, BM, BN>(M, x, prev, cur, out, m, n, one_eta,
                                        eta, p);
}

// The kernel of a (KIND, WIRE_BF16) launch on the (BM, BN) tile.
template <int KIND, bool WIRE_BF16, int BM, int BN>
constexpr auto panel_entry() {
  if constexpr (KIND == kRound) return panel_round_kernel<WIRE_BF16, BM, BN>;
  else return panel_kernel<KIND, WIRE_BF16, BM, BN>;
}

// Where round t of K writes: the 3-cycle (out, work, work + w), turned so
// that round K - 1 writes out; w = slices m n floats, work holds 2 w when
// K >= 2.
inline float* round_out(float* out, float* work, long long w, int t, int K) {
  const int s = ((t - K + 1) % 3 + 3) % 3;
  return s == 0 ? out : work + (s - 1) * w;
}

// out = x over slices (m, n) iterates, contiguous (K = 0).
__global__ void __launch_bounds__(kThreads)
source_kernel(Src x, float* __restrict__ out, int m, long long n,
              long long total) {
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < total; g += (long long)gridDim.x * kThreads) {
    const long long row = g / n;     // the identity's row within its slice
    out[g] = x.at(x.kind == 2 ? row % m : row, g % n, n);
  }
}

// Blocks of an elementwise pass over m n elements, capped (grid-stride).
inline unsigned elementwise_blocks(long long m, long long n) {
  const long long blocks = (m * n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 65536 ? blocks : 65536);
}

inline cudaError_t copy_source(Src x, float* out, int m, long long n,
                               int slices, cudaStream_t st) {
  const long long total = (long long)slices * m * n;
  source_kernel<<<elementwise_blocks(total, 1), kThreads, 0, st>>>(
      x, out, m, n, total);
  return cudaGetLastError();
}

// The Panel of a launch over M; vec: the iterates' rows are 16-byte
// aligned (the caller's vectorizable and the scratch's alignment).
Panel make_panel(int bm, int bn, const float* M, int m, bool vec,
                 const Slices& sl) {
  return {bm, bn, m % 4 == 0 && aligned16(M) && sl.l % 4 == 0, vec, sl};
}

// One instantiation's shared-memory attribute, raised as launches and
// occupancy queries need it (launch.cuh).
template <int KIND, bool WIRE_BF16, int BM, int BN>
cudaError_t panel_allow(size_t smem) {
  static Setup cache;
  return setup(cache, panel_entry<KIND, WIRE_BF16, BM, BN>(), 0, smem,
               nullptr);
}

template <int KIND, bool WIRE_BF16, int BM, int BN>
cudaError_t launch_panel_tile(const float* M, Src x, Src prev, Src cur,
                              float* out, int m, long long n, float one_eta,
                              float eta, const Panel& p, cudaStream_t st) {
  const size_t smem = panel_smem(BM, BN, x.kind == 1);
  const cudaError_t e = panel_allow<KIND, WIRE_BF16, BM, BN>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((n + BN - 1) / BN),
                  (unsigned)((m + BM - 1) / BM), (unsigned)p.sl.count);
  const auto kern = panel_entry<KIND, WIRE_BF16, BM, BN>();
  kern<<<grid, PanelTile<BM, BN>::kThreads, smem, st>>>(
      M, x, prev, cur, out, m, n, one_eta, eta, p);
  return cudaGetLastError();
}

// f(BM, BN) as integral constants for a tile (bm, bn) the panel kernels
// are built for (the wrapper's PANEL_TILES); any other: an error.
template <typename F>
cudaError_t on_panel_tile(int bm, int bn, F&& f) {
  if (bm == 128 && bn == 32) return f(std::integral_constant<int, 128>{},
                                      std::integral_constant<int, 32>{});
  if (bm == 64 && bn == 64) return f(std::integral_constant<int, 64>{},
                                     std::integral_constant<int, 64>{});
  if (bm == 64 && bn == 32) return f(std::integral_constant<int, 64>{},
                                     std::integral_constant<int, 32>{});
  if (bm == 32 && bn == 64) return f(std::integral_constant<int, 32>{},
                                     std::integral_constant<int, 64>{});
  if (bm == 32 && bn == 32) return f(std::integral_constant<int, 32>{},
                                     std::integral_constant<int, 32>{});
  if (bm == 16 && bn == 32) return f(std::integral_constant<int, 16>{},
                                     std::integral_constant<int, 32>{});
  if (bm == 32 && bn == 16) return f(std::integral_constant<int, 32>{},
                                     std::integral_constant<int, 16>{});
  if (bm == 32 && bn == 8) return f(std::integral_constant<int, 32>{},
                                    std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

// Whether a C entry may launch the panel kernels on (bm, bn) over `sl`:
// a tile they are built for; more than one slice only as contiguous (m,
// n) iterates (what the rotation's buffers and the elementwise passes
// assume).
bool valid_panel(int m, long long n, int bm, int bn, const Slices& sl) {
  const bool built = on_panel_tile(bm, bn, [](auto, auto) {
                       return cudaSuccess;
                     }) == cudaSuccess;
  return m > 0 && n > 0 && built && valid_slices(sl) &&
         (sl.count == 1 || sl.x == (long long)m * n) &&
         (long long)sl.count * m <= 0x7fffffffLL;
}

template <int KIND, bool WIRE_BF16>
cudaError_t launch_panel(const float* M, Src x, Src prev, Src cur,
                         float* out, int m, long long n, float one_eta,
                         float eta, const Panel& p, cudaStream_t st) {
  return on_panel_tile(p.bm, p.bn, [&](auto bm, auto bn) {
    return launch_panel_tile<KIND, WIRE_BF16, decltype(bm)::value,
                             decltype(bn)::value>(M, x, prev, cur, out, m, n,
                                                  one_eta, eta, p, st);
  });
}

// Blocks of the panel kernel (KIND, WIRE_BF16) on a bm x bn tile one SM
// holds at once, as its registers and shared memory allow (out[0]), and a
// block's dynamic shared bytes (out[1]); track: the iterate is a tracked
// source (three staged arrays).
template <int KIND, bool WIRE_BF16>
cudaError_t panel_occupancy(int bm, int bn, bool track, int* out) {
  const size_t smem = panel_smem(bm, bn, track);
  out[1] = (int)smem;
  return on_panel_tile(bm, bn, [&](auto b, auto w) {
    constexpr int BM = decltype(b)::value, BN = decltype(w)::value;
    const cudaError_t e = panel_allow<KIND, WIRE_BF16, BM, BN>(smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, panel_entry<KIND, WIRE_BF16, BM, BN>(),
        PanelTile<BM, BN>::kThreads, smem);
  });
}

// K panel rounds over L from x (cur and prev of round t: the outputs of
// rounds t - 1 and t - 2, x before the first), one launch a round.
// K <= 0: out = x.
template <bool WIRE_BF16>
cudaError_t panel_rounds(const float* L, Src x, float* out, float* work,
                         int m, long long n, float one_eta, float eta,
                         int K, const Panel& p, cudaStream_t st) {
  if (K <= 0) return copy_source(x, out, m, n, p.sl.count, st);
  const long long w = (long long)p.sl.count * m * n;
  for (int t = 0; t < K; ++t) {
    const Src cur = t == 0 ? x : buffer(round_out(out, work, w, t - 1, K));
    const Src prev = t <= 1 ? x : buffer(round_out(out, work, w, t - 2, K));
    const cudaError_t err = launch_panel<kRound, WIRE_BF16>(
        L, cur, prev, cur, round_out(out, work, w, t, K), m, n, one_eta, eta,
        p, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
