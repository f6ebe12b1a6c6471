// FastMix's device code and launch helpers, shared by fastmix.cu (its C
// entries), apply_track.cu (the tracked gossip after the per-agent
// product) and fastmix_ef.cu (the round loop on the fp8-EF wire, and the
// panel receive past its resident limit).  Each source compiles its own
// copy (anonymous namespace); what the kernels compute and why they are
// built this way is set out at the top of fastmix.cu and fastmix_ef.cu,
// and above the panel kernels at the end of this file.
#pragma once
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
                      float one_eta, float eta, int K, int bn) {
  constexpr bool EF = WIRE == kWireFp8Ef;
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
                     int m, long long n, int bn, bool two_stages) {
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

// 16-byte copies need every row to start 16-byte aligned.
bool vectorizable(const void* S, const void* G, const void* Gp,
                  const void* out, long long n, int track) {
  return n % 4 == 0 && aligned16(S) && aligned16(out) &&
         (!track || (aligned16(G) && aligned16(Gp)));
}

// rows 8: the wide 8 x 4 thread tile; rows 4: the narrow 4 x 1 one.
bool valid_tile(int m, int bn, int rows) {
  const int cols = rows == 8 ? 4 : 1;
  return m > 0 && (rows == 8 || rows == 4) && bn > 0 && bn % 4 == 0 &&
         32 * warps_needed(m, bn, rows, cols) <= kThreads;
}

// err and err_out are the fp8-EF wire's replica (null on the others).
template <bool TRACK, int WIRE, bool VEC, bool IDENTITY, int R, int C>
cudaError_t launch_rounds(const float* L, const float* S, const float* G,
                          const float* Gp, const float* err, float* out,
                          float* err_out, int m, long long n, float one_eta,
                          float eta, int K, int bn, cudaStream_t stream) {
  static Setup cache;
  auto kern = fastmix_rounds_kernel<TRACK, WIRE, VEC, IDENTITY, R, C>;
  const size_t smem = smem_bytes(m, bn, 2);
  int resident = 0;
  cudaError_t e = setup(cache, kern, kThreads, smem, &resident);
  if (e != cudaSuccess) return e;
  const long long tiles = (n + bn - 1) / bn;
  kern<<<(unsigned)tiles, kThreads, smem, stream>>>(
      L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K, bn);
  return cudaGetLastError();
}

template <bool TRACK, bool VEC, int R, int C>
cudaError_t launch_apply(const float* P, const float* S, const float* G,
                         const float* Gp, float* out, int m, long long n,
                         int bn, bool two_stages, cudaStream_t stream) {
  static Setup cache;
  auto kern = fastmix_apply_kernel<TRACK, VEC, R, C>;
  const size_t smem =
      smem_bytes(m, bn, two_stages ? 2 * (TRACK ? 3 : 1) : 1);
  int resident = 0;
  cudaError_t err = setup(cache, kern, kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + bn - 1) / bn;
  const long long grid = tiles < resident ? tiles : resident;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(P, S, G, Gp, out, m, n,
                                                   bn, two_stages);
  return cudaGetLastError();
}

// K rounds on the thread tile `rows` picks (8: 8 x 4, 4: 4 x 1); err and
// err_out as in launch_rounds.
template <bool TRACK, int WIRE>
cudaError_t rounds(const float* L, const float* S, const float* G,
                   const float* Gp, const float* err, float* out,
                   float* err_out, int m, long long n, float one_eta,
                   float eta, int K, int bn, int rows, bool vec,
                   cudaStream_t st) {
  if (rows == 4)
    return launch_rounds<TRACK, WIRE, false, false, 4, 1>(
        L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K, bn, st);
  return vec ? launch_rounds<TRACK, WIRE, true, false, 8, 4>(
                   L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K,
                   bn, st)
             : launch_rounds<TRACK, WIRE, false, false, 8, 4>(
                   L, S, G, Gp, err, out, err_out, m, n, one_eta, eta, K,
                   bn, st);
}

template <bool TRACK>
cudaError_t apply(const float* P, const float* S, const float* G,
                  const float* Gp, float* out, int m, long long n, int bn,
                  int rows, bool two, bool vec, cudaStream_t st) {
  if (rows == 4)
    return vec ? launch_apply<TRACK, true, 4, 1>(P, S, G, Gp, out, m, n, bn,
                                                 two, st)
               : launch_apply<TRACK, false, 4, 1>(P, S, G, Gp, out, m, n,
                                                  bn, two, st);
  return vec ? launch_apply<TRACK, true, 8, 4>(P, S, G, Gp, out, m, n, bn,
                                               two, st)
             : launch_apply<TRACK, false, 8, 4>(P, S, G, Gp, out, m, n, bn,
                                                two, st);
}

// ------------------------------------------------------------------ panels
// Any agent count.  Where M (m x m) does not fit one block's shared memory
// beside the iterate's tile (m past 230), the P_K(L)
// apply, and each round, is one launch of a tiled product over a
// (ceil(n / 64), ceil(m / 64)) grid.  A block owns 64 rows x 64 columns of
// the output and walks the agents in chunks of 16, staging M's 64 x 16
// panel (transposed, rows padded by one word against bank conflicts) and
// the iterate's 16 x 64 panel in shared memory; each thread holds a 4 x 4
// register tile (rows ty + 16 r, columns tx + 16 q) and one fp32 FMA chain
// per output over j ascending, the resident kernels' order.  The K rounds
// are K launches on the stream (2K on the fp8 wire: the send, then the
// receive), the iterates rotating through (out, work, work + m n) so that
// the last round writes out; prev and cur of the first two rounds are read
// from the source itself, so the tracked iterate is never stored.

constexpr int kPanel = 64, kChunk = 16;

// The iterate a panel kernel reads: a buffer, the tracking combine of
// three, or the (m, m) identity (the P_K(L) build).
struct Src {
  const float* a;
  const float* b;
  const float* c;
  int kind;                  // 0: a; 1: (a + b) - c; 2: the identity
  __device__ __forceinline__ float at(int i, long long col,
                                      long long n) const {
    if (kind == 2) return i == col ? 1.0f : 0.0f;
    const long long g = (long long)i * n + col;
    return kind == 1 ? tracked(a[g], b[g], c[g]) : a[g];
  }
};

inline Src buffer(const float* p) { return {p, nullptr, nullptr, 0}; }

inline Src source(const float* S, const float* G, const float* Gp,
                  bool track) {
  return {S, G, Gp, track ? 1 : 0};
}

inline Src identity() { return {nullptr, nullptr, nullptr, 2}; }

// kApply:  out = M x
// kRound:  out = one_eta M sent(x) - eta prev   (sent = bf16_rne(x) on the
//          bf16 wire, else x)
// kEfRecv: out = one_eta ((cur + M h) - h) - eta prev, with x = h, the
//          wire replica after this round's send
// one_eta is 1 + eta rounded once to fp32 by the caller, as the plain
// versions form it.
enum { kApply, kRound, kEfRecv };

template <int KIND, bool WIRE_BF16>
__global__ void __launch_bounds__(kThreads)
panel_kernel(const float* __restrict__ M, Src x, Src prev, Src cur,
             float* __restrict__ out, int m, long long n, float one_eta,
             float eta) {
  __shared__ float Ms[kChunk][kPanel + 1];   // Ms[j][i] = M[r0 + i][j0 + j]
  __shared__ float Xs[kChunk][kPanel];  // Xs[j][c] = sent(x[j0 + j][c0 + c])
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * kPanel;
  const long long c0 = (long long)blockIdx.x * kPanel;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    for (int e = threadIdx.x; e < kPanel * kChunk; e += kThreads) {
      const int i = e / kChunk, j = e % kChunk;     // 16 threads per row of M
      Ms[j][i] = r0 + i < m && j0 + j < m
                     ? M[(long long)(r0 + i) * m + j0 + j] : 0.0f;
      const int jj = e / kPanel, cc = e % kPanel;   // 64 per row of x
      float v = 0.0f;
      if (j0 + jj < m && c0 + cc < n) {
        v = x.at(j0 + jj, c0 + cc, n);
        if (WIRE_BF16) v = wire_round(v);
      }
      Xs[jj][cc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float a[4], s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ms[j][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = Xs[j][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = __fmaf_rn(a[r], s[q], acc[r][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long col = c0 + tx + 16 * q;
      if (i >= m || col >= n) continue;
      float v = acc[r][q];
      if (KIND == kEfRecv)
        v = __fsub_rn(__fadd_rn(cur.at(i, col, n), v), x.at(i, col, n));
      if (KIND != kApply)
        v = __fsub_rn(__fmul_rn(one_eta, v),
                      __fmul_rn(eta, prev.at(i, col, n)));
      out[(long long)i * n + col] = v;
    }
  }
}

// out = x over the (m, n) iterate (K = 0).
__global__ void __launch_bounds__(kThreads)
source_kernel(Src x, float* __restrict__ out, int m, long long n) {
  const long long total = (long long)m * n;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < total; g += (long long)gridDim.x * kThreads)
    out[g] = x.at((int)(g / n), g % n, n);
}

// Blocks of an elementwise pass over m n elements, capped (grid-stride).
inline unsigned elementwise_blocks(int m, long long n) {
  const long long blocks = ((long long)m * n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 65536 ? blocks : 65536);
}

inline cudaError_t copy_source(Src x, float* out, int m, long long n,
                               cudaStream_t st) {
  source_kernel<<<elementwise_blocks(m, n), kThreads, 0, st>>>(x, out, m, n);
  return cudaGetLastError();
}

template <int KIND, bool WIRE_BF16>
cudaError_t launch_panel(const float* M, Src x, Src prev, Src cur,
                         float* out, int m, long long n, float one_eta,
                         float eta, cudaStream_t st) {
  const dim3 grid((unsigned)((n + kPanel - 1) / kPanel),
                  (unsigned)((m + kPanel - 1) / kPanel));
  panel_kernel<KIND, WIRE_BF16><<<grid, kThreads, 0, st>>>(M, x, prev, cur,
                                                           out, m, n, one_eta,
                                                           eta);
  return cudaGetLastError();
}

// Where round t of K writes: the 3-cycle (out, work, work + m n), turned
// so that round K - 1 writes out; work holds 2 m n floats when K >= 2.
inline float* round_out(float* out, float* work, int m, long long n, int t,
                        int K) {
  const int s = ((t - K + 1) % 3 + 3) % 3;
  return s == 0 ? out : work + (long long)(s - 1) * m * n;
}

// K panel rounds over L from x (cur and prev of round t: the outputs of
// rounds t - 1 and t - 2, x before the first).  K <= 0: out = x.
template <bool WIRE_BF16>
cudaError_t panel_rounds(const float* L, Src x, float* out, float* work,
                         int m, long long n, float one_eta, float eta,
                         int K, cudaStream_t st) {
  if (K <= 0) return copy_source(x, out, m, n, st);
  for (int t = 0; t < K; ++t) {
    const Src cur = t == 0 ? x : buffer(round_out(out, work, m, n, t - 1, K));
    const Src prev =
        t <= 1 ? x : buffer(round_out(out, work, m, n, t - 2, K));
    const cudaError_t err = launch_panel<kRound, WIRE_BF16>(
        L, cur, prev, cur, round_out(out, work, m, n, t, K), m, n, one_eta,
        eta, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
