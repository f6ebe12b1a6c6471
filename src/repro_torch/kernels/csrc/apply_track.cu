// Dense local power step fused with subspace tracking (Eqn. 3.1) and all K
// FastMix rounds (Alg. 3): DeEPCA's whole gossip half-iteration in one
// launch, for explicit per-agent matrices A_j.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fastmix.py::_apply_track_fused (pallas_call :797,
//     body _apply_track_kernel :629)
//
// What it computes, for every agent a and every column of the flattened
// (m, d*k) iterate:
//   G[a]     = A[a] @ W[a]          (fp32 FMAs over the contraction, ascending)
//   prev=cur = (S + G) - G_prev
//   K times:  sent  = wire ? bf16_rne(cur) : cur
//             mixed = sum_j L[i, j] * sent[j]   (fp32 FMAs, j ascending)
//             prev, cur = cur, (1 + eta) * mixed - eta * prev
//   S_new = cur, and G written once (the next iteration's G_prev).
//
// What bounds it on an H100: A (m d^2 floats) is read once, W, S, G_prev
// once and S_new, G written once; the local step is 2 m d^2 k flops and the
// rounds (2m + 3) m d k K.  At m = 64, d = 4096, k = 32 the local step
// dominates with 16 flops per 4-byte element of A, so HBM and the fp32
// CUDA-core rate bound it about equally: 4.5 GB at 3.35 TB/s is 1.3 ms,
// 69 GFLOP at 67 TFLOP/s is 1.0 ms.  A second cost comes from the fusion
// itself: every row block stages all of W (32 MiB there) from L2.
//
// What the design does about it: the rounds mix across agents, so one block
// owns a block of bd output rows for ALL m agents: the columns
// [r0*k, (r0+bd)*k) of the flattened iterate, a (m, bd*k) tile.  In a loop
// over the contraction axis it stages A[:, rows, e-chunk] (transposed, so a
// thread's rows are adjacent) and W[:, e-chunk, :] (one contiguous run per
// agent) through shared memory with asynchronous copies, all of a chunk in
// flight at once.  Each thread owns TR x TC tiles of one agent's G (rows x
// adjacent columns), one sequential FMA chain per output: TR + TC shared
// loads feed TR * TC FMAs.  When every thread owns at most one tile its
// sums stay in registers for the whole contraction; otherwise they live in
// the shared (m, bd*k) tile between chunks.  Then it writes G, forms prev = (S + G) - G_prev in
// tracking_update's order, runs the K rounds exactly as fastmix.cu does (L
// resident, four rows per thread, nxt over prev in place) and writes S_new.
// Agent blocks of both stages are padded by one word so that agents land on
// different shared-memory banks.  The wrapper's tile_rows() picks bd and
// the chunk be (both powers of two) to fit 227 KB and to give at least one
// block per SM where d allows; the entry point picks the thread tile
// (pick_tile).  L and eta are runtime operands and K is a loop bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float wire_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One 4-byte global -> shared copy in flight (cp.async, sm_80+): the thread
// issues every copy of a chunk before waiting on any, so a chunk costs one
// memory latency, not one per element.  A copy with valid == false writes
// a zero and reads nothing (src-size 0).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int log2_of(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// Where tile `item` (agent, row tile, column tile) of the local step lives:
// offsets into the A stage, the W stage and the (m, bd*k) tile, and its
// first column.
struct Tile {
  int a, w, g, c0;
};

__device__ __forceinline__ Tile tile_of(int item, int ncg, int nrg, int tr,
                                        int tc, int a_st, int w_st, int bn,
                                        int k) {
  const int cg = item % ncg, rest = item / ncg;
  const int rg = rest % nrg, a = rest / nrg;
  const int c0 = cg * tc;
  return {a * a_st + rg * tr, a * w_st + c0, a * bn + rg * tr * k + c0, c0};
}

template <int TR, int TC>
__device__ __forceinline__ void load_tile(float (&acc)[TR][TC],
                                          const float* g, int k, int c0) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j)
      acc[i][j] = c0 + j < k ? g[i * k + j] : 0.0f;
}

template <int TR, int TC>
__device__ __forceinline__ void store_tile(const float (&acc)[TR][TC],
                                           float* g, int k, int c0) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j)
      if (c0 + j < k) g[i * k + j] = acc[i][j];
}

// One staged chunk into a TR x TC tile: TR + TC shared loads per step feed
// TR * TC FMAs, each output's chain running over e ascending.
template <int TR, int TC>
__device__ __forceinline__ void chunk_fma(float (&acc)[TR][TC],
                                          const float* ap, const float* wp,
                                          int bd, int k, int c0, int ne) {
  for (int e = 0; e < ne; ++e) {
    float av[TR], wv[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = ap[e * bd + i];
#pragma unroll
    for (int j = 0; j < TC; ++j) wv[j] = c0 + j < k ? wp[e * k + j] : 0.0f;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        acc[i][j] = __fmaf_rn(av[i], wv[j], acc[i][j]);
  }
}

template <int TR, int TC>
__global__ void __launch_bounds__(kThreads)
apply_track_kernel(const float* __restrict__ L, const float* __restrict__ A,
                   const float* __restrict__ W, const float* __restrict__ S,
                   const float* __restrict__ Gp, float* __restrict__ S_new,
                   float* __restrict__ G_out, int m, int d, int k, float eta,
                   int K, int bd, int be, int wire) {
  extern __shared__ float smem[];
  const int mp = (m + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  const int bn = bd * k;                  // tile columns
  const int bd_shift = log2_of(bd), be_shift = log2_of(be);
  const int a_st = be * bd + 1;           // padded agent block, A stage
  const int w_st = be * k + 1;            // padded agent block, W stage
  float* sL = smem;                       // mp x m   (rows >= m are zero)
  float* prev = sL + mp * m;              // m x bn   (G accumulates here)
  float* cur = prev + m * bn;             // m x bn
  float* sent = wire ? cur + m * bn : cur;
  float* As = cur + (wire ? 2 : 1) * m * bn;   // m x [be][bd] (+1)
  float* Ws = As + m * a_st;                   // m x [be][k]  (+1)

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * bd;
  const int rows = min(bd, d - r0);
  const int ncols = rows * k;             // valid tile columns
  const long long dk = (long long)d * k;
  const long long col0 = (long long)r0 * k;

  for (int idx = tid; idx < mp * m; idx += kThreads)
    sL[idx] = idx < m * m ? L[idx] : 0.0f;
  for (int idx = tid; idx < m * bn; idx += kThreads) prev[idx] = 0.0f;

  // ---- the local power step G[a] = A[a] @ W[a] on this block's rows
  const int ncg = (k + TC - 1) / TC;      // column tiles per agent row block
  const int nrg = bd / TR;                // row tiles
  const int items = m * nrg * ncg;
  // one tile per thread: its sums stay in registers for the whole
  // contraction; else each chunk adds into the shared (m, bd*k) tile
  const bool in_regs = items <= kThreads;
  const int warp = tid >> 5, lane = tid & 31;
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
  for (int e0 = 0; e0 < d; e0 += be) {
    const int ne = min(be, d - e0);
    __syncthreads();                      // the previous chunk is consumed
    for (int idx = tid; idx < m * bd * be; idx += kThreads) {
      const int e = idx & (be - 1), ar = idx >> be_shift;
      const int r = ar & (bd - 1), a = ar >> bd_shift;
      const bool valid = r < rows && e < ne;
      copy_async(As + a * a_st + e * bd + r,
                 valid ? A + ((long long)a * d + r0 + r) * d + e0 + e : A,
                 valid);
    }
    for (int a = warp; a < m; a += kThreads / 32) {   // one run per agent
      const float* src = W + ((long long)a * d + e0) * k;
      float* dst = Ws + a * w_st;
      for (int x = lane; x < be * k; x += 32)
        copy_async(dst + x, x < ne * k ? src + x : W, x < ne * k);
    }
    copy_wait_all();
    __syncthreads();
    for (int item = tid; item < items; item += kThreads) {
      const Tile t = tile_of(item, ncg, nrg, TR, TC, a_st, w_st, bn, k);
      if (!in_regs) load_tile<TR, TC>(acc, prev + t.g, k, t.c0);
      chunk_fma<TR, TC>(acc, As + t.a, Ws + t.w, bd, k, t.c0, ne);
      if (!in_regs) store_tile<TR, TC>(acc, prev + t.g, k, t.c0);
    }
  }
  if (in_regs && tid < items) {
    const Tile t = tile_of(tid, ncg, nrg, TR, TC, a_st, w_st, bn, k);
    store_tile<TR, TC>(acc, prev + t.g, k, t.c0);
  }
  __syncthreads();

  // ---- G out; the tracked iterate (s + g) - gp
  for (int idx = tid; idx < m * bn; idx += kThreads) {
    const int a = idx / bn, col = idx % bn;
    float v = 0.0f;
    if (col < ncols) {
      const long long g = (long long)a * dk + col0 + col;
      const float gv = prev[idx];
      G_out[g] = gv;
      v = __fsub_rn(__fadd_rn(S[g], gv), Gp[g]);
    }
    prev[idx] = v;
    cur[idx] = v;
    if (wire) sent[idx] = wire_round(v);
  }
  __syncthreads();

  // ---- the K rounds on the resident tile (fastmix.cu's arithmetic)
  const float one_eta = __fadd_rn(1.0f, eta);
  const int quads = (mp / kRowsPerThread) * bn;     // (row group, column)
  for (int round = 0; round < K; ++round) {
    for (int item = tid; item < quads; item += kThreads) {
      const int c = item % bn;
      const int i0 = item / bn * kRowsPerThread;
      float acc[kRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < m; ++j) {
        const float s = sent[j * bn + c];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = __fmaf_rn(sL[(i0 + r) * m + j], s, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + r;
        if (i < m) {
          const int e = i * bn + c;
          prev[e] = __fsub_rn(__fmul_rn(one_eta, acc[r]),
                              __fmul_rn(eta, prev[e]));
        }
      }
    }
    __syncthreads();
    float* t = prev; prev = cur; cur = t;     // prev <- cur, cur <- nxt
    if (wire) {
      for (int idx = tid; idx < m * bn; idx += kThreads)
        sent[idx] = wire_round(cur[idx]);
      __syncthreads();
    } else {
      sent = cur;
    }
  }

  for (int idx = tid; idx < m * bn; idx += kThreads) {
    const int a = idx / bn, col = idx % bn;
    if (col < ncols) S_new[(long long)a * dk + col0 + col] = cur[idx];
  }
}

template <int TR, int TC>
cudaError_t launch(const float* L, const float* A, const float* W,
                   const float* S, const float* Gp, float* S_new, float* G,
                   int m, int d, int k, float eta, int K, int bd, int be,
                   int wire, size_t smem, cudaStream_t stream) {
  auto kern = apply_track_kernel<TR, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (d + bd - 1) / bd;
  kern<<<blocks, kThreads, smem, stream>>>(L, A, W, S, Gp, S_new, G, m, d, k,
                                           eta, K, bd, be, wire);
  return cudaGetLastError();
}

// The thread tile (TR x TC, powers of two up to 8, TR <= bd, TC <= k
// rounded up): fewest passes of the block's threads over the tiles first
// (one pass keeps the sums in registers), then the most threads busy, then
// the largest tile (the most reuse of each staged value).
void pick_tile(int m, int k, int bd, int* tr, int* tc) {
  const int kp = 1 << log2_of(k);
  long long best_passes = 0, best_busy = 0;
  int best_area = 0;
  *tr = *tc = 1;
  for (int r = 1; r <= 8 && r <= bd; r *= 2) {
    for (int c = 1; c <= 8 && c <= kp; c *= 2) {
      const long long tiles = (long long)m * (bd / r) * ((k + c - 1) / c);
      const long long passes = (tiles + kThreads - 1) / kThreads;
      const long long busy = tiles < kThreads ? tiles : kThreads;
      const bool better =
          best_area == 0 || passes < best_passes ||
          (passes == best_passes &&
           (busy > best_busy || (busy == best_busy && r * c > best_area)));
      if (better) {
        best_passes = passes;
        best_busy = busy;
        best_area = r * c;
        *tr = r;
        *tc = c;
      }
    }
  }
}

template <int TR>
cudaError_t launch_tc(int tc, const float* L, const float* A, const float* W,
                      const float* S, const float* Gp, float* S_new, float* G,
                      int m, int d, int k, float eta, int K, int bd, int be,
                      int wire, size_t smem, cudaStream_t st) {
  switch (tc) {
    case 1: return launch<TR, 1>(L, A, W, S, Gp, S_new, G, m, d, k, eta, K,
                                 bd, be, wire, smem, st);
    case 2: return launch<TR, 2>(L, A, W, S, Gp, S_new, G, m, d, k, eta, K,
                                 bd, be, wire, smem, st);
    case 4: return launch<TR, 4>(L, A, W, S, Gp, S_new, G, m, d, k, eta, K,
                                 bd, be, wire, smem, st);
    default: return launch<TR, 8>(L, A, W, S, Gp, S_new, G, m, d, k, eta, K,
                                  bd, be, wire, smem, st);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper's apply_track_smem()
// is the same formula.
size_t apply_track_smem_bytes(int m, int k, int bd, int be, int wire_bf16) {
  const int mp = (m + kRowsPerThread - 1) / kRowsPerThread * kRowsPerThread;
  return sizeof(float) * ((size_t)mp * m +
                          (size_t)(wire_bf16 ? 3 : 2) * m * bd * k +
                          (size_t)m * (be * bd + 1) + (size_t)m * (be * k + 1));
}

// (S_new, G) = (FastMix^K(S + A W - Gp), A W) for A (m, d, d), W, S, Gp,
// S_new, G (m, d, k), all fp32 and contiguous; bd and be are powers of two.
// Returns cudaError_t.
int apply_track(const void* L, const void* A, const void* W, const void* S,
                const void* Gp, void* S_new, void* G, int m, int d, int k,
                float eta, int K, int bd, int be, int wire_bf16,
                void* stream) {
  if (bd <= 0 || be <= 0 || (bd & (bd - 1)) || (be & (be - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = apply_track_smem_bytes(m, k, bd, be, wire_bf16);
  int tr, tc;
  pick_tile(m, k, bd, &tr, &tc);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)L;
  const float* a = (const float*)A;
  const float* w = (const float*)W;
  const float* s = (const float*)S;
  const float* gp = (const float*)Gp;
  float* sn = (float*)S_new;
  float* g = (float*)G;
  switch (tr) {
    case 1: return launch_tc<1>(tc, l, a, w, s, gp, sn, g, m, d, k, eta, K,
                                bd, be, wire_bf16, smem, st);
    case 2: return launch_tc<2>(tc, l, a, w, s, gp, sn, g, m, d, k, eta, K,
                                bd, be, wire_bf16, smem, st);
    case 4: return launch_tc<4>(tc, l, a, w, s, gp, sn, g, m, d, k, eta, K,
                                bd, be, wire_bf16, smem, st);
    default: return launch_tc<8>(tc, l, a, w, s, gp, sn, g, m, d, k, eta, K,
                                 bd, be, wire_bf16, smem, st);
  }
}

const char* apply_track_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
