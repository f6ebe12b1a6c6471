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
// Ragged edges: rows of Mt past m are zero, columns past n load as zero
// and are not stored; a row length n that is not a multiple of 4, or a
// base that is not 16-byte aligned, takes the 4-byte variant.  M, eta and
// K are runtime operands.
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

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
// I when IDENTITY: the P_K(L) build, n = m).
template <bool TRACK, bool WIRE_BF16, bool VEC, bool IDENTITY, int R, int C>
__global__ void __launch_bounds__(kThreads, R == 8 ? 2 : 1)
fastmix_rounds_kernel(const float* __restrict__ M,
                      const float* __restrict__ S,
                      const float* __restrict__ G,
                      const float* __restrict__ Gp, float* __restrict__ out,
                      int m, long long n, float eta, int K, int bn) {
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
    put_sent<WIRE_BF16, R, C>(sent, bn, m, i0, c, cur);
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) prev[r][q] = cur[r][q];
  const float one_eta = __fadd_rn(1.0f, eta);
  for (int round = 0; round < K; ++round) {
    // Round k reads buffer k % 2 and fills the other: every thread passed
    // the previous barrier, so nobody still reads what is overwritten.
    const float* src = sent + (round & 1) * m * bn;
    float* dst = sent + ((round + 1) & 1) * m * bn;
    if (active) {
      float acc[R][C];
      product<R, C>(Mt, ms, src, bn, m, i0, c, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const float nxt = __fsub_rn(__fmul_rn(one_eta, acc[r][q]),
                                      __fmul_rn(eta, prev[r][q]));
          prev[r][q] = cur[r][q];
          cur[r][q] = nxt;
        }
      if (round + 1 < K) put_sent<WIRE_BF16, R, C>(dst, bn, m, i0, c, cur);
    }
    __syncthreads();
  }
  if (active) store_tile<VEC, R, C>(out, m, n, i0, col, cur);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
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

constexpr int kMaxDevices = 64;

// What one kernel instantiation needs from the CUDA runtime before it launches
// with `smem` dynamic shared-memory bytes on a device: the attribute that
// allows them (raised, never lowered, so a concurrent launch of a larger
// size stays allowed) and how many blocks the device holds at once (the
// persistent apply kernel's grid).  Asked once per device and size, then
// kept: a launch then costs no runtime query.
struct Setup {
  std::mutex mu;
  size_t allowed[kMaxDevices] = {};
  size_t smem[kMaxDevices] = {};
  int resident[kMaxDevices] = {};
};

template <typename Kernel>
cudaError_t setup(Setup& cache, Kernel kern, size_t smem, int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.allowed[dev] < smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cache.allowed[dev] = smem;
  }
  if (cache.smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.smem[dev] = smem;
    cache.resident[dev] = sms * per_sm;
  }
  *resident = cache.resident[dev];
  return cudaSuccess;
}

template <bool TRACK, bool WIRE_BF16, bool VEC, bool IDENTITY, int R, int C>
cudaError_t launch_rounds(const float* L, const float* S, const float* G,
                          const float* Gp, float* out, int m, long long n,
                          float eta, int K, int bn, cudaStream_t stream) {
  static Setup cache;
  auto kern = fastmix_rounds_kernel<TRACK, WIRE_BF16, VEC, IDENTITY, R, C>;
  const size_t smem = smem_bytes(m, bn, 2);
  int resident = 0;
  cudaError_t err = setup(cache, kern, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + bn - 1) / bn;
  kern<<<(unsigned)tiles, kThreads, smem, stream>>>(L, S, G, Gp, out, m, n,
                                                    eta, K, bn);
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
  cudaError_t err = setup(cache, kern, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (n + bn - 1) / bn;
  const long long grid = tiles < resident ? tiles : resident;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(P, S, G, Gp, out, m, n,
                                                   bn, two_stages);
  return cudaGetLastError();
}

template <bool TRACK, bool WIRE_BF16>
cudaError_t rounds(const float* L, const float* S, const float* G,
                   const float* Gp, float* out, int m, long long n, float eta,
                   int K, int bn, int rows, bool vec, cudaStream_t st) {
  if (rows == 4)
    return launch_rounds<TRACK, WIRE_BF16, false, false, 4, 1>(
        L, S, G, Gp, out, m, n, eta, K, bn, st);
  return vec ? launch_rounds<TRACK, WIRE_BF16, true, false, 8, 4>(
                   L, S, G, Gp, out, m, n, eta, K, bn, st)
             : launch_rounds<TRACK, WIRE_BF16, false, false, 8, 4>(
                   L, S, G, Gp, out, m, n, eta, K, bn, st);
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

}  // namespace

extern "C" {

// The wrapper (kernels/fastmix.py) chooses rows, bn and stages; these
// entries refuse a thread tile whose warps exceed the block, and the
// shared-memory attribute refuses bytes past the card's limit.
//
// out = FastMix^K(track ? S + G - Gp : S) over the (m, n) fp32 iterate, K
// rounds in one launch; rows 8 or 4 picks the thread tile.  G and Gp are
// ignored (may be null) when track == 0.  Returns cudaError_t.
int fastmix_rounds(const void* L, const void* S, const void* G,
                   const void* Gp, void* out, int m, long long n, float eta,
                   int K, int bn, int rows, int track, int wire_bf16,
                   void* stream) {
  if (!valid_tile(m, bn, rows)) return cudaErrorInvalidValue;
  const bool vec = vectorizable(S, G, Gp, out, n, track);
  const float* l = (const float*)L;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (track)
    return wire_bf16
        ? rounds<true, true>(l, s, g, gp, o, m, n, eta, K, bn, rows, vec, st)
        : rounds<true, false>(l, s, g, gp, o, m, n, eta, K, bn, rows, vec,
                              st);
  return wire_bf16
      ? rounds<false, true>(l, s, g, gp, o, m, n, eta, K, bn, rows, vec, st)
      : rounds<false, false>(l, s, g, gp, o, m, n, eta, K, bn, rows, vec,
                             st);
}

// out = P (track ? S + G - Gp : S) over the (m, n) fp32 iterate in one
// pass; P is (m, m) fp32, P_K(L) from fastmix_poly; stages 2 (a cp.async
// ring) or 1.  Returns cudaError_t.
int fastmix_apply(const void* P, const void* S, const void* G,
                  const void* Gp, void* out, int m, long long n, int bn,
                  int rows, int stages, int track, void* stream) {
  if (!valid_tile(m, bn, rows) || (stages != 1 && stages != 2))
    return cudaErrorInvalidValue;
  const bool vec = vectorizable(S, G, Gp, out, n, track);
  const float* p = (const float*)P;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  const float* gp = (const float*)Gp;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = stages == 2;
  return track ? apply<true>(p, s, g, gp, o, m, n, bn, rows, two, vec, st)
               : apply<false>(p, s, g, gp, o, m, n, bn, rows, two, vec, st);
}

// P = P_K(L), (m, m) fp32 row-major: the round loop applied to I, on the
// narrow thread tile (rows 4: m columns are little work) where it fits.
int fastmix_poly(const void* L, void* P, int m, float eta, int K, int bn,
                 int rows, void* stream) {
  if (!valid_tile(m, bn, rows)) return cudaErrorInvalidValue;
  const float* l = (const float*)L;
  float* p = (float*)P;
  cudaStream_t st = (cudaStream_t)stream;
  return rows == 4
      ? launch_rounds<false, false, false, true, 4, 1>(
            l, nullptr, nullptr, nullptr, p, m, m, eta, K, bn, st)
      : launch_rounds<false, false, false, true, 8, 4>(
            l, nullptr, nullptr, nullptr, p, m, m, eta, K, bn, st);
}

const char* fastmix_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
