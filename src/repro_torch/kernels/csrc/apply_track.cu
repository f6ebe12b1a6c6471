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
//   1. apply_product_kernel: grid (ceil(d / BM), m), agent-major, so the
//      blocks of one agent run together and W[a] stays in L2.  A block owns
//      BM output rows and all k columns (padded and masked to KP; past 64 it
//      loops over column tiles of 64) and walks the contraction in chunks of
//      32 through a 3-stage ring of 16-byte cp.async.cg copies (4-byte
//      copies where d or k is not a multiple of 4), one barrier per stage.
//      Each thread owns a TR x TC register tile: 8 x 4 at KP >= 32, 4 x 4 at
//      KP = 16, one row by the 8 padded columns at KP = 8 (k = 5).  Its rows
//      are strided by BM / TR, so a warp's 16-byte loads of A land on
//      distinct banks; 4 columns of e per A load feed TR x TC x 4 FMAs.
//      Every output is one fp32 FMA chain over e ascending (no TF32).
//   2. FastMix's tracked kernels (fastmix_tiles.cuh, shared with fastmix.cu):
//      without a wire the one-pass apply of the cached P_K(L), forming the
//      tracked iterate from S, G, G_prev on its tile; with the bf16 wire, or
//      K = 0, the register-tiled round loop over L.  Past their resident
//      limit (m > 230) FastMix's panel kernels, which take any m.
// The wrapper (kernels/fastmix.py) picks BM, KP and FastMix's tile; this
// entry refuses what does not fit.  L, P and eta are runtime operands.
#include "fastmix_tiles.cuh"

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

// G[a][row0 .. row0 + BM, :] = A[a][row0 .. row0 + BM, :] @ W[a].
template <int BM, int KP, bool VA>
__global__ void __launch_bounds__(product_threads<BM, KP>())
apply_product_kernel(const float* __restrict__ A,
                     const float* __restrict__ W, float* __restrict__ G,
                     int d, int k, bool vw) {
  constexpr int TR = TileOf<KP>::TR, TC = TileOf<KP>::TC;
  constexpr int CG = KP / TC, RG = BM / TR;
  constexpr int slot = BM * kAStride + kBK * KP;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  const int a = blockIdx.y, row0 = blockIdx.x * BM;
  const float* Aa = A + (long long)a * d * d;
  const float* Wa = W + (long long)a * d * k;
  float* Ga = G + (long long)a * d * k;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int chunks = (d + kBK - 1) / kBK;

  for (int c0 = 0; c0 < k; c0 += KP) {
    float acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int q = 0; q < TC; ++q) acc[r][q] = 0.0f;
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
      if (s < chunks)
        load_chunk<BM, KP, VA>(ring + s * slot, ring + s * slot + BM * kAStride,
                               Aa, Wa, d, k, row0, c0, s, vw);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int ch = 0; ch < chunks; ++ch) {
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 2) : "memory");
      __syncthreads();       // chunk ch landed; slot (ch - 1) % kRing is free
      const int nx = ch + kRing - 1;
      if (nx < chunks) {
        float* st = ring + (nx % kRing) * slot;
        load_chunk<BM, KP, VA>(st, st + BM * kAStride, Aa, Wa, d, k, row0, c0,
                               nx, vw);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const float* As = ring + (ch % kRing) * slot;
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
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = row0 + rg + RG * r;
      if (row >= d) continue;
      float* g = Ga + (long long)row * k + c0 + cg * TC;
#pragma unroll
      for (int q = 0; q < TC; ++q)
        if (c0 + cg * TC + q < k) g[q] = acc[r][q];
    }
    __syncthreads();          // the next column tile refills the ring
  }
}

struct SmemAllowed {
  std::mutex mu;
  size_t allowed[kMaxDevices] = {};
};

template <int BM, int KP, bool VA>
cudaError_t launch_product(const float* A, const float* W, float* G, int m,
                           int d, int k, bool vw, cudaStream_t stream) {
  static SmemAllowed cache;
  auto kern = apply_product_kernel<BM, KP, VA>;
  constexpr size_t smem = product_smem<BM, KP>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.allowed[dev] < smem) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      cache.allowed[dev] = smem;
    }
  }
  const dim3 grid((d + BM - 1) / BM, m);
  kern<<<grid, product_threads<BM, KP>(), smem, stream>>>(A, W, G, d, k, vw);
  return cudaGetLastError();
}

template <int BM, bool VA>
cudaError_t product_kp(int kp, const float* A, const float* W, float* G,
                       int m, int d, int k, bool vw, cudaStream_t st) {
  switch (kp) {
    case 8: return launch_product<BM, 8, VA>(A, W, G, m, d, k, vw, st);
    case 16: return launch_product<BM, 16, VA>(A, W, G, m, d, k, vw, st);
    case 32: return launch_product<BM, 32, VA>(A, W, G, m, d, k, vw, st);
    default: return launch_product<BM, 64, VA>(A, W, G, m, d, k, vw, st);
  }
}

cudaError_t agent_product(int bm, int kp, const float* A, const float* W, float* G,
                    int m, int d, int k, cudaStream_t st) {
  const bool va = d % 4 == 0 && aligned16(A);
  const bool vw = k % 4 == 0 && aligned16(W);
  if (bm == 128)
    return va ? product_kp<128, true>(kp, A, W, G, m, d, k, vw, st)
              : product_kp<128, false>(kp, A, W, G, m, d, k, vw, st);
  return va ? product_kp<64, true>(kp, A, W, G, m, d, k, vw, st)
            : product_kp<64, false>(kp, A, W, G, m, d, k, vw, st);
}

}  // namespace

extern "C" {

// (S_new, G) = (gossip(S + A W - Gp), A W) for A (m, d, d), W, S, Gp, S_new,
// G (m, d, k), all fp32 and contiguous.  M is P_K(L) (m, m) when the call
// applies it (no wire, K > 0: stages 1 or 2, FastMix's apply tile rows x
// bn), else L (the bf16 wire or K = 0: FastMix's round tile); one_eta is
// 1 + eta rounded once to fp32.  rows 0 takes FastMix's panel kernels
// instead (m past their resident limit; `work` holds 2 m d k floats for the
// rounds when K >= 2, else it may be null).
// bm (64 or 128) and kp (8, 16, 32 or 64, at least min(k, 64)) shape the
// product.  Every kernel goes on `stream`.  Returns cudaError_t.
int apply_track(const void* M, const void* A, const void* W, const void* S,
                const void* Gp, void* S_new, void* G, void* work, int m,
                int d, int k, float one_eta, float eta, int K, int bm,
                int kp, int rows, int bn, int stages, int wire_bf16,
                void* stream) {
  const bool rounds_path = wire_bf16 || K <= 0;
  const bool panel = rows == 0;
  if (m <= 0 || d <= 0 || k <= 0 || (bm != 64 && bm != 128) ||
      (kp != 8 && kp != 16 && kp != 32 && kp != 64) ||
      kp < (k < 64 ? k : 64) || (!panel && !valid_tile(m, bn, rows)) ||
      (!panel && !rounds_path && stages != 1 && stages != 2) ||
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
  cudaError_t err = agent_product(bm, kp, a, w, g, m, d, k, st);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)d * k;
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
  const bool vec = vectorizable(s, g, gp, sn, n, 1);
  if (rounds_path)
    return wire_bf16
        ? (int)rounds<true, true>(mm, s, g, gp, sn, m, n, one_eta, eta, K,
                                  bn, rows, vec, st)
        : (int)rounds<true, false>(mm, s, g, gp, sn, m, n, one_eta, eta, K,
                                   bn, rows, vec, st);
  return (int)apply<true>(mm, s, g, gp, sn, m, n, bn, rows, stages == 2, vec,
                          st);
}

const char* apply_track_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
