// CholeskyQR2 with its Gram, one thread-block cluster per batch element.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gram.py::_gram (pallas_call :70), which the reference
//     maps over agents for CholeskyQR2's k x k Gram
//     (src/repro/kernels/cholqr.py::_gram_nk :129-149),
// together with the plain-XLA rest of src/repro/kernels/cholqr.py::cholqr2
// (:204): the unrolled Cholesky (_chol_small), the triangular inverse
// (_tri_inv_lower), the screen, the shifted rescue and the lax.cond third
// pass (:248).
//
// What it computes, per batch element X (d, k), k <= 64 and k <= d:
//   pass 1:  G = X^T X;  L = chol(G) with pivots floored at eps trace(G)/k;
//            flagged (non-finite L, min diag(L)^2 <= k eps trace(G), or
//            max|diag G| / min|diag G| > 0.05 / eps): L = chol(G + s I),
//            s = 11 (d k + k (k + 1)) eps trace(G), floored likewise;
//            Q = X L^-T
//   pass 2:  the same on Q, unscreened
//   pass 3:  when any element of its group (the batch, or one problem of
//            a batch of problems) was flagged, once more on every element
//            of the group (the second launch, gated by the group's flag).
//
// What bounds it on an H100: X is read once and Q written once, 8 B d k
// bytes, for 2 passes x 4 B d k^2 flops (the Gram and X R^-1 each 2 B d k^2):
// at k = 32 that is 32 flops per byte, so the fp32 CUDA cores bound it
// (0.032 ms at B = 64, d = 4096).  The torch version it replaces spent its
// time elsewhere: some hundred launches per call for the unrolled k x k
// algebra, three Gram launches, and a third pass computed on every call.
//
// What the design does about it: one launch does both passes.  A cluster
// of C blocks (1, 2, 4, 8; 16 for a lone element) owns one element; each
// block copies its slice of rows into shared memory once (16-byte cp.async
// where k % 4 == 0; where the slice does not fit, it re-reads it from
// device memory each pass) and forms the partial Gram of its rows in
// register tiles.  After cluster.sync() rank 0 sums the C partials through
// distributed shared memory in rank order (so the result does not depend
// on timing); one warp then factors and inverts the triangle, left-looking
// as the reference does (each lane owns rows of the factor and columns of
// the inverse, so every entry is one register FMA chain), the block
// screens, and a flagged element is factored again on the shifted Gram.
// Every rank copies R^-1 (transposed, so that the lanes of a warp read
// consecutive words) through distributed shared memory, and every block
// forms X R^-1 on its slice with 4 x 4 register tiles.  Q is written once.
// A flagged element sets a device flag (atomicOr); the second launch reads
// it first and returns at once when it is 0, else runs one plain pass over
// every element -- the meaning of the reference's lax.cond(jnp.any(bad),
// ...), with no host sync.  The batch may hold several problems (a batch
// of problems through the driver's problem axis): elements come in groups
// of `group`, each group with a flag of its own, as the reference's vmap
// over problems selects the third pass per problem.  Given counters, the
// last block of a group in the second launch to read its flag clears flag
// and counter, so one set of flags serves every call on a stream with no
// memset between.  Sums are fp32 FMAs, and sqrt
// and division are IEEE (no fast math).
#include <cfloat>
#include <cstdint>
#include <mutex>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kScratch = 4096;      // floats: per-row-group Gram partials
constexpr int kScalars = 8;
constexpr int kMaxK = 64;
constexpr int kMaxDevices = 64;
constexpr int kMaxBatch = 65535;    // the batch sits on grid.y

// Row stride of the factor and its inverse: odd, so that the 32 rows a
// warp's lanes own fall on 32 distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int k) { return k | 1; }

__host__ __device__ __forceinline__ size_t smem_floats(int rows, int k,
                                                       int resident) {
  return kScratch + (resident ? (size_t)rows * k : 0) + 2 * (size_t)k * k +
         2 * (size_t)k * odd_stride(k) + kScalars;
}

// part = x^T x over the block's nr rows (x row-major with stride k, in
// shared or device memory).  Thread t owns a T x T output tile and the rows
// g, g + RG, ... of row group g; the RG partials are then summed in group
// order, so the result does not depend on timing.
template <int T>
__device__ __forceinline__ void gram_tiles(const float* x, int nr, int k,
                                           bool vec, float* scratch,
                                           float* part) {
  const int nt = (k + T - 1) / T, ntiles = nt * nt;
  int groups = kThreads / ntiles;
  if (groups < 1) groups = 1;
  const int t = threadIdx.x;
  if (t < groups * ntiles) {
    const int tile = t % ntiles, g = t / ntiles;
    const int i0 = tile / nt * T, j0 = tile % nt * T;
    float acc[T][T];
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int v = 0; v < T; ++v) acc[u][v] = 0.0f;
#pragma unroll 4
    for (int r = g; r < nr; r += groups) {
      const float* row = x + (long long)r * k;
      float xi[T], xj[T];
      bool loaded = false;
      if constexpr (T == 4) {
        if (vec) {                      // k % 4 == 0: whole 16-byte groups
          const float4 a = *reinterpret_cast<const float4*>(row + i0);
          const float4 b = *reinterpret_cast<const float4*>(row + j0);
          xi[0] = a.x; xi[1] = a.y; xi[2] = a.z; xi[3] = a.w;
          xj[0] = b.x; xj[1] = b.y; xj[2] = b.z; xj[3] = b.w;
          loaded = true;
        }
      }
      if (!loaded) {
#pragma unroll
        for (int u = 0; u < T; ++u) {
          xi[u] = i0 + u < k ? row[i0 + u] : 0.0f;
          xj[u] = j0 + u < k ? row[j0 + u] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int v = 0; v < T; ++v)
          acc[u][v] = __fmaf_rn(xi[u], xj[v], acc[u][v]);
    }
    float* out = scratch + (long long)g * k * k;
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int v = 0; v < T; ++v)
        if (i0 + u < k && j0 + v < k) out[(i0 + u) * k + j0 + v] = acc[u][v];
  }
  __syncthreads();
  for (int idx = t; idx < k * k; idx += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s = __fadd_rn(s, scratch[g * k * k + idx]);
    part[idx] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void gram_partial(const float* x, int nr, int k,
                                             bool vec, float* scratch,
                                             float* part) {
  if (k >= 16) gram_tiles<4>(x, nr, k, vec, scratch, part);
  else gram_tiles<1>(x, nr, k, vec, scratch, part);
}

// Lw = chol(G + shift I) in its lower triangle (row stride ks), pivots
// floored at eps * trace(G + shift I) / k; a NaN pivot stays NaN.  One
// warp, left-looking as the reference's _chol_small: lane i owns rows i
// and i + 32; for column j each owned row i >= j forms G[i][j] - sum_p
// L[i][p] L[j][p] in a register, the pivot arrives by __shfl_sync, and one
// __syncwarp() publishes the column.
__device__ void factor(const float* G, float* Lw, int k, int ks,
                       float shift) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float tr = 0.0f;
  for (int i = 0; i < k; ++i) tr = __fadd_rn(tr, __fadd_rn(G[i * k + i], shift));
  const float floor_ = __fdiv_rn(__fmul_rn(FLT_EPSILON, tr), (float)k);
  for (int j = 0; j < k; ++j) {
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i < j || i >= k) continue;
      float v = i == j ? __fadd_rn(G[j * k + j], shift) : G[i * k + j];
#pragma unroll 8        // the loads run ahead of the FMA chain
      for (int p = 0; p < j; ++p)
        v = __fmaf_rn(-Lw[i * ks + p], Lw[j * ks + p], v);
      s[h] = v;
    }
    float piv = __shfl_sync(full, j < 32 ? s[0] : s[1], j & 31);
    piv = piv < floor_ ? floor_ : piv;
    const float ljj = __fsqrt_rn(piv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      if (i >= j && i < k) Lw[i * ks + j] = i == j ? ljj : __fdiv_rn(s[h], ljj);
    }
    __syncwarp();
  }
}

// M = Lw^-1 (lower, row stride ks), left-looking as the reference's
// _tri_inv_lower: M[i] = (e_i - L[i, :i] M[:i]) / L[i][i].  One warp; lane
// c owns columns c and c + 32, which are independent, so no lane waits on
// another, and each entry is one register FMA chain.
__device__ void invert(const float* Lw, float* M, int k, int ks) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < k; c += 32)
    for (int i = 0; i < k; ++i) {
      float v = i == c ? 1.0f : 0.0f;
#pragma unroll 8
      for (int p = 0; p < i; ++p)
        v = __fmaf_rn(-Lw[i * ks + p], M[p * ks + c], v);
      M[i * ks + c] = __fdiv_rn(v, Lw[i * ks + i]);
    }
}

// One warp: Lw = chol(G + shift I) and M = Lw^-1 (pass 1 inverts before
// the screen has spoken: a rescue, which is rare, factors again).
__device__ void factor_warp(const float* G, float* Lw, float* M, int k,
                            int ks, float shift) {
  factor(G, Lw, k, ks, shift);
  __syncwarp();
  invert(Lw, M, k, ks);
}

// Pass 1's screen on rank 0 (after factor(G, Lw, k, ks, 0)): true when the
// element is flagged.  All the block's threads.
__device__ bool screen(const float* G, const float* Lw, int d, int k, int ks,
                       float* sc) {
  const int t = threadIdx.x;
  bool nonfinite = false;
  for (int idx = t; idx < k * k; idx += kThreads)
    if (idx % k <= idx / k && !isfinite(Lw[idx / k * ks + idx % k]))
      nonfinite = true;
  nonfinite = __syncthreads_or(nonfinite);
  if (t == 0) {
    float tr = 0.0f, lmin = Lw[0], gmax = fabsf(G[0]), gmin = fabsf(G[0]);
    for (int i = 0; i < k; ++i) {
      const float g = G[i * k + i];
      tr = __fadd_rn(tr, g);
      lmin = fminf(lmin, Lw[i * ks + i]);
      gmax = fmaxf(gmax, fabsf(g));
      gmin = fminf(gmin, fabsf(g));
    }
    const float ke = (float)(k * (double)FLT_EPSILON);
    const float guard = (float)(0.05 / (double)FLT_EPSILON);
    const float cond = __fdiv_rn(gmax, fmaxf(gmin, FLT_MIN));
    const bool bad = nonfinite || __fmul_rn(lmin, lmin) <= __fmul_rn(ke, tr) ||
                     cond > guard;
    const float c = (float)(11.0 * (double)(d * k + k * (k + 1)) *
                            (double)FLT_EPSILON);
    sc[1] = bad ? 1.0f : 0.0f;
    sc[2] = __fmul_rn(c, tr);           // the shift
  }
  __syncthreads();
  return sc[1] != 0.0f;
}

// dst = src M^T over nr rows (in place when dst == src), with Mt = M^T
// padded to kp = k rounded up to 4 columns (Mt[p][j] = M[j][p], zero past
// k).  Each thread owns 4 rows x 4 adjacent columns, 16 independent FMA
// chains over p ascending (all k of them, as the reference's matmul sums;
// M is zero above its diagonal); the outputs of a chunk of rows are stored
// after a barrier, so the product may run in place.
template <bool VX>
__device__ void apply_rinv(const float* src, float* dst, int nr, int k,
                           const float* Mt, int kp) {
  constexpr int RT = 4;                 // rows per thread
  const int t = threadIdx.x;
  const int groups = kp / 4, lanes = kThreads / groups;
  const int j0 = t % groups * 4, tr = t / groups;
  const bool active = tr < lanes;
  for (int r0 = 0; r0 < nr; r0 += RT * lanes) {
    const float* x[RT];
    bool on[RT], any = false;
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      const int r = r0 + u * lanes + tr;
      on[u] = active && r < nr;
      any |= on[u];
      x[u] = src + (long long)(on[u] ? r : 0) * k;
    }
    float acc[RT][4];
#pragma unroll
    for (int u = 0; u < RT; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][q] = 0.0f;
    if (any) {
      for (int p = 0; p < k; p += VX ? 4 : 1) {
        float xv[RT][4];
#pragma unroll
        for (int u = 0; u < RT; ++u) {
          if constexpr (VX) {           // k % 4 == 0, rows 16-byte aligned
            const float4 v = *reinterpret_cast<const float4*>(x[u] + p);
            xv[u][0] = v.x; xv[u][1] = v.y; xv[u][2] = v.z; xv[u][3] = v.w;
          } else {
            xv[u][0] = x[u][p];
          }
        }
#pragma unroll
        for (int e = 0; e < (VX ? 4 : 1); ++e) {
          const float4 m = *reinterpret_cast<const float4*>(
              Mt + (p + e) * kp + j0);
          const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int u = 0; u < RT; ++u)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[u][q] = __fmaf_rn(xv[u][e], mv[q], acc[u][q]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      if (!on[u]) continue;
      float* out = dst + (long long)(r0 + u * lanes + tr) * k + j0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < k) out[q] = acc[u][q];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// MAIN: passes 1 and 2 from X into Q (screened first pass, the element's
// group flag set on a rescue).  Otherwise the gated third pass, in place on
// Q; with `arrived` (else null) the last block of a group to read its flag
// clears it and the group's counter.  Element y belongs to group y / group.
// RESIDENT: the block's rows live in shared memory (else each pass
// re-reads them).
template <bool MAIN, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
cholqr2_kernel(const float* __restrict__ X, float* Q, int* flag,
               int* arrived, int d, int k, int rows_per, int group) {
  const int g = (int)blockIdx.y / group;
  flag += g;
  if (!MAIN) {
    __shared__ int seen;
    if (threadIdx.x == 0) {
      seen = *reinterpret_cast<volatile int*>(flag);
      if (arrived != nullptr) {
        arrived += g;
        const int members = min(group, (int)gridDim.y - g * group);
        __threadfence();                // the read above precedes the count
        if (atomicAdd(arrived, 1) == (int)gridDim.x * members - 1) {
          *flag = 0;                    // every block of the group read it
          *arrived = 0;
        }
      }
    }
    __syncthreads();
    if (seen == 0) return;              // the same for a whole cluster
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  // 16-byte aligned first: the scratch (Gram partials, then R^-1
  // transposed) and the row slice; then the k x k matrices and scalars
  extern __shared__ float4 smem4[];
  float* const scratch = reinterpret_cast<float*>(smem4);
  float* const Xs = scratch + kScratch;
  const int ks = odd_stride(k);
  float* const part = Xs + (RESIDENT ? rows_per * k : 0);
  float* const G = part + k * k;
  float* const Lw = G + k * k;
  float* const M = Lw + k * ks;
  float* const sc = M + k * ks;

  const long long base = (long long)blockIdx.y * d * k +
                         (long long)rank * rows_per * k;
  const int nr = max(0, min(rows_per, d - rank * rows_per));
  const float* xin = (MAIN ? X : Q) + base;
  float* qout = Q + base;
  // k % 4 == 0 and 16-byte aligned rows (X and Q alike): vector loads
  const bool vec = k % 4 == 0 &&
                   ((reinterpret_cast<std::uintptr_t>(X) |
                     reinterpret_cast<std::uintptr_t>(Q)) & 15) == 0;
  const int kp = (k + 3) / 4 * 4;
  if (RESIDENT) {
    const int w = vec ? 4 : 1;
    for (int idx = t * w; idx < nr * k; idx += kThreads * w)
      copy_async(Xs + idx, xin + idx, 4 * w);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  for (int pass = 0; pass < (MAIN ? 2 : 1); ++pass) {
    const float* src = RESIDENT ? Xs : (pass == 0 ? xin : qout);
    float* dst = RESIDENT ? Xs : qout;
    gram_partial(src, nr, k, vec, scratch, part);
    cluster.sync();                     // every partial is in place
    if (rank == 0) {
      for (int idx = t; idx < k * k; idx += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < C; ++r)
          s = __fadd_rn(s, cluster.map_shared_rank(part, r)[idx]);
        G[idx] = s;
      }
      __syncthreads();
      if (t < 32) factor_warp(G, Lw, M, k, ks, 0.0f);
      __syncthreads();
      if (MAIN && pass == 0 && screen(G, Lw, d, k, ks, sc)) {
        if (t < 32) factor_warp(G, Lw, M, k, ks, sc[2]);
        if (t == 0) atomicOr(flag, 1);
      }
    }
    cluster.sync();                     // rank 0's R^-1 is ready
    const float* M0 = cluster.map_shared_rank(M, 0);
    for (int idx = t; idx < k * kp; idx += kThreads) {   // Mt, local
      const int p = idx / kp, j = idx % kp;
      scratch[idx] = j < k ? M0[j * ks + p] : 0.0f;
    }
    __syncthreads();
    if (vec) apply_rinv<true>(src, dst, nr, k, scratch, kp);
    else apply_rinv<false>(src, dst, nr, k, scratch, kp);
  }
  cluster.sync();                       // nobody still reads rank 0's M
  if (RESIDENT)
    for (int idx = t; idx < nr * k; idx += kThreads) qout[idx] = Xs[idx];
}

struct Setup {
  std::mutex mu;
  size_t allowed[kMaxDevices] = {};
  bool nonportable[kMaxDevices] = {};
};

template <bool MAIN, bool RESIDENT>
cudaError_t launch(const float* X, float* Q, int* flag, int* arrived, int B,
                   int d, int k, int C, int group, size_t smem,
                   cudaStream_t stream) {
  static Setup cache;
  auto kern = cholqr2_kernel<MAIN, RESIDENT>;
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
    if (C > 8 && !cache.nonportable[dev]) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      cache.nonportable[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rows_per = (d + C - 1) / C;
  err = cudaLaunchKernelEx(&cfg, kern, X, Q, flag, arrived, d, k, rows_per,
                           group);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Q = CholeskyQR2(X) for X, Q (B, d, k) fp32 contiguous, 1 <= k <= 64,
// k <= d: clusters of C blocks (1, 2, 4, 8 or 16) per element, the row
// slice in shared memory when `resident`.  The elements come in groups of
// `group` (the last may be shorter), each gating its third pass on its own
// flag: `flag` holds ceil(B / group) device ints, zero on entry.  With
// `arrived` (as many ints, zero on entry) both are zero again on exit;
// without it (null) a group's flag is left nonzero when its third pass
// ran.  Two launches on `stream`.  Returns cudaError_t.
int cholqr2(const void* X, void* Q, void* flag, void* arrived, int B, int d,
            int k, int C, int resident, int group, void* stream) {
  if (B < 1 || B > kMaxBatch || k < 1 || k > kMaxK || k > d || group < 1 ||
      (C != 1 && C != 2 && C != 4 && C != 8 && C != 16))
    return (int)cudaErrorInvalidValue;
  const int rows_per = (d + C - 1) / C;
  const size_t smem = sizeof(float) * smem_floats(rows_per, k, resident);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)X;
  float* q = (float*)Q;
  int* f = (int*)flag;
  int* a = (int*)arrived;
  cudaStream_t st = (cudaStream_t)stream;
  if (resident) {
    cudaError_t err =
        launch<true, true>(x, q, f, a, B, d, k, C, group, smem, st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<false, true>(x, q, f, a, B, d, k, C, group, smem, st);
  }
  cudaError_t err =
      launch<true, false>(x, q, f, a, B, d, k, C, group, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<false, false>(x, q, f, a, B, d, k, C, group, smem, st);
}

const char* cholqr2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
