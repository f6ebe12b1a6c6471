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
// What it computes, for q, o, dO (B, H, Sq, HD), k, v (B, Hkv, Skv, HD), all
// fp32 or all bf16, and the forward's fp32 lse (B, H, Sq), contiguous.
// Every operand and gradient is taken through its batch, head and
// sequence strides (in elements), with HD at stride 1.  Query head h reads
// kv head h / (H / Hkv).  In fp32, per (b, h), the FlashAttention-2
// backward:
//   D   = rowsum(dO o)                     (written to `delta`, fp32)
//   s   = (fp32(q) / sqrt(HD)) k^T;  P = exp(s - lse) where col < Skv and,
//         when causal, row >= col on absolute indices (top-left), else 0
//   dV  = P^T dO;  dP = dO V^T;  dS = P (dP - D)
//   dQ  = dS K / sqrt(HD);  dK = dS^T (q / sqrt(HD))
// dK and dV sum the H / Hkv query heads of their kv head in fp32 before
// the cast; every gradient is cast to the operands' type.
//
// Deterministic, without atomics: two grids, launched one after the other
// on the caller's stream, each owning what it writes.
//   flash_bwd_dq   grid (q tiles, B H): D for the tile's rows (written for
//                  the second grid), then a loop over the kv tiles the
//                  tile's rows see, dQ held in registers.
//   flash_bwd_dkdv grid (kv tiles, B Hkv): a loop over the kv head's H / Hkv
//                  query heads and, per head, over the q tiles that see the
//                  kv tile, dK and dV held in registers.
// Each sum runs in a fixed order, so two calls give the same bits.
//
// What bounds it on an H100: the operations, 5 * B * H * Sq * Skv * HD
// flops over the unmasked half of a causal score matrix (the products
// S, dP, dV, dQ, dK), against reading q, k, v, o, dO, lse once and writing
// dq, dk, dv once: at the training shape (B = 8, H = 9, Hkv = 3, S = 512,
// HD = 64) some 300 flops per byte.  This first version runs on the CUDA
// cores in fp32 (no tensor cores, no TF32): tiles of 64 rows are staged in
// shared memory as fp32 (rows padded to HD + 1 floats, so the column walks
// are free of bank conflicts); a thread owns 4 rows x 4 score columns (16
// threads a row group) and 4 rows x HD / 16 output columns.  It recomputes
// S and dP in both grids (7 products where the bound counts 5).  A
// wgmma/TMA version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;                  // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;              // threads of one 4-row group
constexpr int kRows = 4;                // rows a thread owns
constexpr int kCols = kB / kLanes;      // score columns a thread owns

// Batch, head and sequence strides of the eight tensors, in elements.
struct Strides {
  long long q[3], k[3], v[3], o[3], d_o[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + kB) of a (rows, HD) operand with row stride `stride`
// into a [kB][HD + 1] fp32 tile, times `mul`; rows at or past n_rows are 0.
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0, int n_rows,
                                      float mul) {
  constexpr int kStep = kThreads / HD;
  const int c = threadIdx.x % HD;
  for (int r = threadIdx.x / HD; r < kB; r += kStep)
    dst[r * (HD + 1) + c] =
        row0 + r < n_rows ? ld(src + (row0 + r) * stride + c) * mul : 0.0f;
}

// s[i][j] = a[r0 + i] . b[tc + kLanes j] over HD, for two [kB][HD + 1] tiles.
template <int HD>
__device__ __forceinline__ void dots(const float* a, const float* b, int r0,
                                     int tc, float (&s)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < HD; ++c) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(r0 + i) * (HD + 1) + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tc + j * kLanes) * (HD + 1) + c];
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

template <int HD>
constexpr size_t smem_dq() {
  // q, dO, k (first o), v tiles; dS; lse and D
  return ((size_t)4 * kB * (HD + 1) + (size_t)kB * (kB + 1) + 2 * kB) *
         sizeof(float);
}

template <int HD>
constexpr size_t smem_dkdv() {
  // k, v, q, dO tiles; P and dS; lse and D
  return ((size_t)4 * kB * (HD + 1) + (size_t)2 * kB * (kB + 1) + 2 * kB) *
         sizeof(float);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv,
             int Sq, int Skv, int causal, float scale, Strides st) {
  constexpr int kP = HD + 1;
  constexpr int kOut = HD / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kB][kP] q scaled
  float* dos = qs + kB * kP;            // [kB][kP] dO
  float* ks = dos + kB * kP;            // [kB][kP] k (first: o, for D)
  float* vs = ks + kB * kP;             // [kB][kP] v
  float* dss = vs + kB * kP;            // [kB][kB + 1] dS
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
  stage<HD>(dos, dob, st.d_o[2], q0, Sq, 1.0f);
  stage<HD>(ks, ob, st.o[2], q0, Sq, 1.0f);
  if (threadIdx.x < kB)
    lse_s[threadIdx.x] =
        q0 + threadIdx.x < Sq ? lse[rows + q0 + threadIdx.x] : 0.0f;
  __syncthreads();
  {
    // D = rowsum(dO o): four lanes a row, summed in a fixed order
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.0f;
    for (int c = part; c < HD; c += 4)
      acc = __fmaf_rn(dos[r * kP + c], ks[r * kP + c], acc);
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
    stage<HD>(vs, vb, st.v[2], kv0, Skv, 1.0f);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    dots<HD>(qs, ks, r0, tc, s);
    dots<HD>(dos, vs, r0, tc, dp);
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

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv,
               int Sq, int Skv, int causal, float scale, Strides st) {
  constexpr int kP = HD + 1;
  constexpr int kOut = HD / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;                     // [kB][kP] this block's k tile
  float* vs = ks + kB * kP;             // [kB][kP] this block's v tile
  float* qs = vs + kB * kP;             // [kB][kP] q scaled
  float* dos = qs + kB * kP;            // [kB][kP] dO
  float* ps = dos + kB * kP;            // [kB][kB + 1] P
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
  stage<HD>(vs, vb, st.v[2], kv0, Skv, 1.0f);

  float adk[kRows][kOut], adv[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      adk[i][j] = 0.0f;
      adv[i][j] = 0.0f;
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
      stage<HD>(dos, dob, st.d_o[2], q0, Sq, 1.0f);
      if (threadIdx.x < kB) {
        const bool in = q0 + threadIdx.x < Sq;
        lse_s[threadIdx.x] = in ? lse[rows + q0 + threadIdx.x] : 0.0f;
        d_s[threadIdx.x] = in ? delta[rows + q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      float s[kRows][kCols], dp[kRows][kCols];
      dots<HD>(qs, ks, r0, tc, s);
      dots<HD>(dos, vs, r0, tc, dp);
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
        for (int j = 0; j < kOut; ++j) {
          const float dov = dos[r * kP + tc + j * kLanes];
          const float qv = qs[r * kP + tc + j * kLanes];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            adv[i][j] = __fmaf_rn(pv[i], dov, adv[i][j]);
            adk[i][j] = __fmaf_rn(dsv[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = kv0 + r0 + i;
    if (row >= Skv) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      put(dkb + row * st.dk[2] + tc + j * kLanes, adk[i][j]);
      put(dvb + row * st.dv[2] + tc + j * kLanes, adv[i][j]);
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta,
                   void* dq, void* dk, void* dv, int B, int H, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   const Strides& st, cudaStream_t stream) {
  const size_t s_dq = smem_dq<HD>(), s_kv = smem_dkdv<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<HD, T><<<dim3((Sq + kB - 1) / kB, B * H), kThreads, s_dq,
                         stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse,
      delta, (T*)dq, H, Hkv, Sq, Skv, causal, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<HD, T><<<dim3((Skv + kB - 1) / kB, B * Hkv), kThreads, s_kv,
                           stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, Hkv, Sq, Skv, causal, scale, st);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int Hkv, int Sq, int Skv,
                      int causal, float scale, const Strides& st,
                      cudaStream_t stream) {
  if (is_bf16)
    return launch<HD, bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                            Hkv, Sq, Skv, causal, scale, st, stream);
  return launch<HD, float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           Hkv, Sq, Skv, causal, scale, st, stream);
}

}  // namespace

extern "C" {

// dq, dk, dv of o = attention(q, k, v) (flash_attention.cu's function) for
// the incoming gradient dout: q, o, dout, dq (B, H, Sq, hd) and k, v, dk,
// dv (B, Hkv, Skv, hd), all of one type (is_bf16 selects bf16, else fp32);
// hd is 64 or 128 and H a multiple of Hkv.  lse is the forward's fp32
// (B, H, Sq), contiguous; delta an fp32 (B, H, Sq) scratch that receives
// D = rowsum(dout o).  strides holds 24 values: the batch, head and
// sequence strides in elements of q, k, v, o, dout, dq, dk, dv in that
// order (hd at stride 1).  Two launches on `stream`.  Returns cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int B,
                        int H, int Hkv, int Sq, int Skv, int hd, int causal,
                        int is_bf16, float scale, const long long* strides,
                        void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      B * H > 65535 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.d_o, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return launch_hd<64>(is_bf16, q, k, v, o, dout, lse, delta, dq, dk, dv,
                         B, H, Hkv, Sq, Skv, causal, scale, st, s);
  if (hd == 128)
    return launch_hd<128>(is_bf16, q, k, v, o, dout, lse, delta, dq, dk, dv,
                          B, H, Hkv, Sq, Skv, causal, scale, st, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
