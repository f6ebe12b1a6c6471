// The per-agent product G[a] = A[a] @ W[a] (A (m, d, d), W and G (m, d, k),
// fp32, row-major and contiguous), shared by apply_track.cu (m agents, the
// whole contraction in each block) and power_matmul.cu (one matrix, the
// contraction split across the blocks of a cluster).  Each source compiles
// its own copy (anonymous namespace).
//
// A block owns BM output rows of one agent and all k columns (padded and
// masked to KP; past 64 it loops over column tiles of 64) and walks the
// contraction in chunks of 32 through a 3-stage ring of 16-byte cp.async.cg
// copies (4-byte copies where d or k is not a multiple of 4), one barrier per
// stage.  Each thread owns a TR x TC register tile: 8 x 4 at KP >= 32, 4 x 4
// at KP = 16, one row by the 8 padded columns at KP = 8 (k = 5).  Its rows
// are strided by BM / TR, so a warp's 16-byte loads of A land on distinct
// banks; 4 columns of e per A load feed TR x TC x 4 FMAs.  No TF32.
//   SPLIT = false: grid (ceil(d / BM), m), agent-major, so the blocks of one
//     agent run together and W[a] stays in L2.  Every output is one fp32 FMA
//     chain over the contraction ascending, from 0.
//   SPLIT = true: grid (ceil(d / BM) S, m) in clusters of S consecutive
//     blocks along x, one cluster per BM rows.  Rank r walks the chunks
//     [r C / S, (r + 1) C / S) of the C = ceil(d / 32) (every rank at least
//     one: S <= C) with the same FMA chain from 0, leaves its partial tile
//     in its ring, and after cluster.sync() every rank sums one S-th of the
//     tile over distributed shared memory, the S partials in rank order
//     (deterministic), and writes it.  A grid that would not span the SMs
//     (d = 300: 5 row blocks) gets S times the blocks, each with 1 / S of
//     the serial chain, and W is read S times fewer per row of G.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kBK = 32;               // contraction chunk
constexpr int kRing = 3;              // cp.async stages
constexpr int kAStride = kBK + 4;     // A stage row stride: 16-byte rows whose
                                      // bank offset steps 4 words per row

// Thread tile of a KP-wide output tile: 1 x 8 at KP = 8, 4 x 4 at 16, else
// 8 x 4.
template <int KP> struct TileOf {
  static constexpr int TR = KP == 8 ? 1 : KP == 16 ? 4 : 8;
  static constexpr int TC = KP == 8 ? 8 : 4;
};

template <int BM, int KP>
__host__ __device__ constexpr int product_threads() {
  return (BM / TileOf<KP>::TR) * (KP / TileOf<KP>::TC);
}

template <int BM, int KP>
__host__ __device__ constexpr size_t product_smem() {
  return sizeof(float) * kRing * (BM * kAStride + kBK * KP);
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Chunk `chunk` of A[a][row0 .. row0 + BM, :] and W[a][:, c0 .. c0 + KP)
// into one ring slot, zero-filled past d and k.
template <int BM, int KP, bool VA>
__device__ __forceinline__ void load_chunk(float* As, float* Ws,
                                           const float* __restrict__ Aa,
                                           const float* __restrict__ Wa,
                                           int d, int k, int row0, int c0,
                                           int chunk, bool vw) {
  constexpr int NT = product_threads<BM, KP>();
  const int e0 = chunk * kBK;
  if (VA) {                             // d % 4 == 0: a chunk is in or out
    for (int idx = threadIdx.x; idx < BM * (kBK / 4); idx += NT) {
      const int r = idx / (kBK / 4), e = idx % (kBK / 4) * 4;
      const bool ok = row0 + r < d && e0 + e < d;
      copy16(As + r * kAStride + e,
             ok ? Aa + (long long)(row0 + r) * d + e0 + e : Aa, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * kBK; idx += NT) {
      const int r = idx / kBK, e = idx % kBK;
      const bool ok = row0 + r < d && e0 + e < d;
      copy4(As + r * kAStride + e,
            ok ? Aa + (long long)(row0 + r) * d + e0 + e : Aa, ok);
    }
  }
  if (vw) {                             // k % 4 == 0
    for (int idx = threadIdx.x; idx < kBK * (KP / 4); idx += NT) {
      const int e = idx / (KP / 4), c = idx % (KP / 4) * 4;
      const bool ok = e0 + e < d && c0 + c < k;
      copy16(Ws + e * KP + c, ok ? Wa + (long long)(e0 + e) * k + c0 + c : Wa,
             ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBK * KP; idx += NT) {
      const int e = idx / KP, c = idx % KP;
      const bool ok = e0 + e < d && c0 + c < k;
      copy4(Ws + e * KP + c, ok ? Wa + (long long)(e0 + e) * k + c0 + c : Wa,
            ok);
    }
  }
}

// G[a][row0 .. row0 + BM, :] = A[a][row0 .. row0 + BM, :] @ W[a], the
// contraction whole (SPLIT false) or split over the cluster (SPLIT true).
template <int BM, int KP, bool VA, bool SPLIT>
__global__ void __launch_bounds__(product_threads<BM, KP>())
product_kernel(const float* __restrict__ A, const float* __restrict__ W,
               float* __restrict__ G, int d, int k, bool vw) {
  constexpr int TR = TileOf<KP>::TR, TC = TileOf<KP>::TC;
  constexpr int CG = KP / TC, RG = BM / TR;
  constexpr int NT = product_threads<BM, KP>();
  constexpr int slot = BM * kAStride + kBK * KP;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  const int a = blockIdx.y;
  const int chunks = (d + kBK - 1) / kBK;
  int rank = 0, S = 1, row0 = blockIdx.x * BM;
  int ch0 = 0, ch1 = chunks;
  if constexpr (SPLIT) {
    S = (int)cooperative_groups::this_cluster().num_blocks();
    rank = (int)cooperative_groups::this_cluster().block_rank();
    row0 = blockIdx.x / S * BM;
    ch0 = (int)((long long)rank * chunks / S);
    ch1 = (int)((long long)(rank + 1) * chunks / S);
  }
  const float* Aa = A + (long long)a * d * d;
  const float* Wa = W + (long long)a * d * k;
  float* Ga = G + (long long)a * d * k;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;

  for (int c0 = 0; c0 < k; c0 += KP) {
    float acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int q = 0; q < TC; ++q) acc[r][q] = 0.0f;
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
      if (ch0 + s < ch1)
        load_chunk<BM, KP, VA>(ring + s * slot, ring + s * slot + BM * kAStride,
                               Aa, Wa, d, k, row0, c0, ch0 + s, vw);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int ch = ch0; ch < ch1; ++ch) {
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 2) : "memory");
      __syncthreads();       // chunk ch landed; the slot of ch - 1 is free
      const int nx = ch + kRing - 1;
      if (nx < ch1) {
        float* st = ring + ((nx - ch0) % kRing) * slot;
        load_chunk<BM, KP, VA>(st, st + BM * kAStride, Aa, Wa, d, k, row0, c0,
                               nx, vw);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const float* As = ring + ((ch - ch0) % kRing) * slot;
      const float* Ws = As + BM * kAStride;
#pragma unroll 2
      for (int e = 0; e < kBK; e += 4) {
        float av[TR][4];
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const float4 t = *reinterpret_cast<const float4*>(
              As + (rg + RG * r) * kAStride + e);
          av[r][0] = t.x; av[r][1] = t.y; av[r][2] = t.z; av[r][3] = t.w;
        }
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          float wv[TC];
#pragma unroll
          for (int h = 0; h < TC / 4; ++h) {
            const float4 t = *reinterpret_cast<const float4*>(
                Ws + (e + ee) * KP + cg * TC + 4 * h);
            wv[4 * h] = t.x; wv[4 * h + 1] = t.y;
            wv[4 * h + 2] = t.z; wv[4 * h + 3] = t.w;
          }
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int q = 0; q < TC; ++q)
              acc[r][q] = __fmaf_rn(av[r][ee], wv[q], acc[r][q]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if constexpr (!SPLIT) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = row0 + rg + RG * r;
        if (row >= d) continue;
        float* g = Ga + (long long)row * k + c0 + cg * TC;
#pragma unroll
        for (int q = 0; q < TC; ++q)
          if (c0 + cg * TC + q < k) g[q] = acc[r][q];
      }
      __syncthreads();        // the next column tile refills the ring
    } else {
      cooperative_groups::cluster_group cluster =
          cooperative_groups::this_cluster();
      __syncthreads();        // nobody still reads the ring
      float* const part = ring;                       // BM x KP partial
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int q = 0; q < TC; ++q)
          part[(rg + RG * r) * KP + cg * TC + q] = acc[r][q];
      cluster.sync();         // every rank's partial is in place
      const int per = BM * KP / 4 / S;                // float4s per rank
      for (int v = threadIdx.x; v < per; v += NT) {
        const int idx = (rank * per + v) * 4;
        float4 s = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, 0))[idx / 4];
        for (int p = 1; p < S; ++p) {
          const float4 t = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, p))[idx / 4];
          s.x = __fadd_rn(s.x, t.x); s.y = __fadd_rn(s.y, t.y);
          s.z = __fadd_rn(s.z, t.z); s.w = __fadd_rn(s.w, t.w);
        }
        const int row = row0 + idx / KP, col = c0 + idx % KP;
        if (row >= d) continue;
        float* g = Ga + (long long)row * k + col;
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < k) g[q] = sv[q];
      }
      cluster.sync();         // every partial read: the ring may refill
    }
  }
}

// Column widths KP the product takes, and whether `split` (the cluster
// size, 1 for none) divides the d-contraction into non-empty ranges.
bool product_shape_ok(int d, int k, int bm, int kp, int split) {
  const int chunks = (d + kBK - 1) / kBK;
  return d > 0 && k > 0 && (bm == 64 || bm == 128) &&
         (kp == 8 || kp == 16 || kp == 32 || kp == 64) &&
         kp >= (k < 64 ? k : 64) &&
         (split == 1 || split == 2 || split == 4 || split == 8) &&
         split <= chunks;
}

template <int BM, int KP, bool VA, bool SPLIT>
cudaError_t launch_product(const float* A, const float* W, float* G, int m,
                           int d, int k, bool vw, int split,
                           cudaStream_t stream) {
  static Setup cache;
  auto kern = product_kernel<BM, KP, VA, SPLIT>;
  constexpr int threads = product_threads<BM, KP>();
  constexpr size_t smem = product_smem<BM, KP>();
  int resident = 0;
  cudaError_t err = setup(cache, kern, threads, smem, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + BM - 1) / BM * split, m);
  if constexpr (!SPLIT) {
    kern<<<grid, threads, smem, stream>>>(A, W, G, d, k, vw);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, A, W, G, d, k, vw);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
}

template <int BM, bool VA, bool SPLIT>
cudaError_t product_kp(int kp, const float* A, const float* W, float* G,
                       int m, int d, int k, bool vw, int split,
                       cudaStream_t st) {
  switch (kp) {
    case 8: return launch_product<BM, 8, VA, SPLIT>(
        A, W, G, m, d, k, vw, split, st);
    case 16: return launch_product<BM, 16, VA, SPLIT>(
        A, W, G, m, d, k, vw, split, st);
    case 32: return launch_product<BM, 32, VA, SPLIT>(
        A, W, G, m, d, k, vw, split, st);
    default: return launch_product<BM, 64, VA, SPLIT>(
        A, W, G, m, d, k, vw, split, st);
  }
}

// G[a] = A[a] @ W[a] for a < m on BM = bm rows and KP = kp columns per
// block, the contraction split over clusters of `split` blocks when SPLIT
// (split 1 and SPLIT false: the whole contraction per block).  The caller
// checks product_shape_ok.
template <bool SPLIT>
cudaError_t agent_product(int bm, int kp, int split, const float* A,
                          const float* W, float* G, int m, int d, int k,
                          cudaStream_t st) {
  const bool va = d % 4 == 0 && aligned16(A);
  const bool vw = k % 4 == 0 && aligned16(W);
  if (bm == 128)
    return va ? product_kp<128, true, SPLIT>(kp, A, W, G, m, d, k, vw, split,
                                             st)
              : product_kp<128, false, SPLIT>(kp, A, W, G, m, d, k, vw,
                                              split, st);
  return va ? product_kp<64, true, SPLIT>(kp, A, W, G, m, d, k, vw, split, st)
            : product_kp<64, false, SPLIT>(kp, A, W, G, m, d, k, vw, split,
                                           st);
}

}  // namespace
