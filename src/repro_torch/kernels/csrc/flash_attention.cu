// Causal flash attention, forward, with grouped-query heads (GQA).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_single
//     (pallas_call :96, body _flash_kernel :29)
// together with the head broadcast and vmaps of its batched wrapper
// src/repro/kernels/ops.py::flash_attention (:79).
//
// What it computes: q (B, H, Sq, HD), k and v (B, Hkv, Skv, HD), all fp32
// or all bf16, contiguous  ->  o (B, H, Sq, HD) in q's type.  Query head h
// reads kv head h / (H / Hkv) (jnp.repeat(k, H / Hkv, axis=1) in the
// reference), indexed directly instead of materialising the repeat.  Per
// (b, h), in the reference's order and in fp32:
//   qs   = fp32(q) * (1 / sqrt(HD))                    (before the dot)
//   s    = qs . k^T;  masked to -1e30 unless col < Skv and, when causal,
//          row >= col on absolute indices (aligned top-left)
//   per kv tile, ascending:  m' = max(m, rowmax s);  a = exp(m - m');
//          p = exp(s - m');  l = a l + rowsum p;  acc = a acc + p v
//   o    = acc / (l == 0 ? 1 : l), cast to q's type.
//
// What bounds it on an H100: the work, 2 * B * H * Sq * Skv * HD flops for
// the unmasked half of a causal score matrix, against reading q, k, v and
// writing o once.  At the LM prefill's shapes (S = 512, HD = 64) that is
// some 100 flops per byte: the arithmetic bounds it (the bf16 tensor cores
// at the data sheet's rate; the fp32 CUDA cores for what this kernel does).
//
// What the design does about it: one block of 256 threads per (64-row q
// tile, b * H + h); one launch covers the whole (B, H) grid.  The q tile,
// scaled and in fp32, stays in shared memory; 64-row K and V tiles are
// staged through shared memory in fp32; kv tiles wholly above the diagonal
// are skipped (exact: they hold no unmasked score), and the first tile
// always holds column 0, so every row has a finite running max from the
// first tile on.  The running max, running sum and accumulator live in
// registers: a thread owns 4 rows x 4 score columns (16 threads per row,
// row reductions by warp shuffles) and 4 rows x HD / 16 output columns.
// All arithmetic is fp32 FMAs, also for bf16 inputs.  Simple first: no
// mma/wgmma, no TMA, no double buffering; these come with a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBKV = 64;                // kv rows per tile
constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;        // threads sharing one row group
constexpr int kRowsPerThread = 4;       // kBQ / (kThreads / kLanesPerRow)
constexpr int kColsPerThread = kBKV / kLanesPerRow;   // 4 score columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int HD>
constexpr size_t smem_floats() {
  // q (kBQ x HD+1), k (kBKV x HD+1), v (kBKV x HD), p (kBQ x kBKV+1)
  return (size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) +
         (size_t)kBKV * HD + (size_t)kBQ * (kBKV + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                 int Sq, int Skv, int causal, float scale) {
  constexpr int kOut = HD / kLanesPerRow;           // output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                                 // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);                  // [kBKV][HD + 1]
  float* vs = ks + kBKV * (HD + 1);                 // [kBKV][HD]
  float* ps = vs + kBKV * HD;                       // [kBQ][kBKV + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + (long long)bh * Sq * HD;
  const T* kb = k + ((long long)b * Hkv + hkv) * Skv * HD;
  const T* vb = v + ((long long)b * Hkv + hkv) * Skv * HD;
  T* ob = o + (long long)bh * Sq * HD;

  const int tr = threadIdx.x / kLanesPerRow;        // row group: 4 rows
  const int tc = threadIdx.x % kLanesPerRow;        // column lane
  const int r0 = tr * kRowsPerThread;

  for (int idx = threadIdx.x; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int row = q0 + r;
    qs[r * (HD + 1) + c] =
        row < Sq ? to_f32(qb[(long long)row * HD + c]) * scale : 0.0f;
  }

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kOut];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }

  int n_tiles = (Skv + kBKV - 1) / kBKV;
  if (causal) {
    // the last query row of this tile that exists sees columns <= its row
    const int last_row = min(q0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, last_row / kBKV + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();                    // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBKV * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD;
      const int row = kv0 + r;
      const bool in = row < Skv;        // padding rows are zero, never NaN
      ks[r * (HD + 1) + c] = in ? to_f32(kb[(long long)row * HD + c]) : 0.0f;
      vs[r * HD + c] = in ? to_f32(vb[(long long)row * HD + c]) : 0.0f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qs[(r0 + i) * (HD + 1) + c];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = ks[(tc + j * kLanesPerRow) * (HD + 1) + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = kv0 + tc + j * kLanesPerRow;
        const bool ok = col < Skv && (!causal || row >= col);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(r0 + i) * (kBKV + 1) + tc + j * kLanesPerRow] = p;
      }
#pragma unroll
      for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = ps[(r0 + i) * (kBKV + 1) + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = vs[c * HD + tc + j * kLanesPerRow];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][j] = __fmaf_rn(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      store(&ob[(long long)row * HD + tc + j * kLanesPerRow],
            acc[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Skv, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Skv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for q, o (B, H, Sq, hd) and k, v (B, Hkv, Skv, hd),
// all of one type (is_bf16 selects bf16, else fp32) and contiguous;
// hd is 64 or 128 and H a multiple of Hkv.  Returns cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Hkv, int Sq, int Skv, int hd,
                    int causal, int is_bf16, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv < 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Hkv, Sq,
                                               Skv, causal, scale, st)
                   : launch<float, 64>(q, k, v, o, B, H, Hkv, Sq, Skv,
                                       causal, scale, st);
  if (hd == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Hkv, Sq,
                                                Skv, causal, scale, st)
                   : launch<float, 128>(q, k, v, o, B, H, Hkv, Sq, Skv,
                                        causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
