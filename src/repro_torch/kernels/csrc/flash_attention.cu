// Causal flash attention, forward, with grouped-query heads (GQA).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_single
//     (pallas_call :96, body _flash_kernel :29)
// together with the head broadcast and vmaps of its batched wrapper
// src/repro/kernels/ops.py::flash_attention (:79).
//
// What it computes: q (B, H, Sq, HD), k and v (B, Hkv, Skv, HD), all fp32
// or all bf16  ->  o (B, H, Sq, HD) in q's type.  Every operand is taken
// through its batch, head and sequence strides (in elements), with HD at
// stride 1.  Query head h reads kv head h / (H / Hkv) (jnp.repeat(k, H /
// Hkv, axis=1) in the reference), indexed directly instead of
// materialising the repeat.  Per (b, h), in fp32:
//   s    = scaled q . k^T;  masked to -1e30 unless col < Skv and, when
//          causal, row >= col on absolute indices (aligned top-left)
//   per kv tile, ascending:  m' = max(m, rowmax s);  a = exp(m - m');
//          p = exp(s - m');  l = a l + rowsum p;  acc = a acc + p v
//   o    = acc / (l == 0 ? 1 : l), cast to q's type.
//
// What bounds it on an H100: the work, 2 * B * H * Sq * Skv * HD flops for
// the unmasked half of a causal score matrix, against reading q, k, v and
// writing o once.  At the LM prefill's shapes (B = 8, H = 9, Hkv = 3,
// S = 512, HD = 64) that is some 190 flops per byte, below the card's 295
// for bf16: the bytes bound it; at S = 4096 the tensor cores' rate does.
//
// Two kernels, one per input type.
//
// bf16 (flash_fwd_bf16, the LM's path): the tensor cores.  One block of 4
// warps owns a 64-row q tile of one (b, h); each warp owns 16 q rows.  The
// grid is (q tiles, B * H), and blocks take their work in launch order so
// that every head's causal-heaviest q tile launches first: the i-th block
// (i = blockIdx.y * gridDim.x + blockIdx.x) takes q tile gridDim.x - 1 -
// i / (B * H) of (b, h) = i mod (B * H).  (Reversing grid.x alone orders
// the tiles within one head only; the last heads' heavy tiles then start
// late and set the tail.)  The q tile is copied once (cp.async) and held
// for the whole kv loop as bf16 A fragments (ldmatrix.x4).  64-row K and V
// tiles stream in bf16 through a two-stage cp.async ring (16-byte copies;
// tile t + 1 loads while tile t computes); rows at or past Skv are
// zero-filled by the src-size-0 form and never read, since 0 x NaN would
// poison P V.  Shared tiles are XOR-swizzled by 16-byte chunk (chunk ^ (row
// & 7)), so every ldmatrix and every 16-byte copy is free of bank
// conflicts.
//   S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32 accumulate); K's
//   row-major (kv, HD) layout is the col-major B operand, read by ldmatrix
//   without .trans.  The softmax takes exp2 with the scale and log2(e)
//   folded into one fp32 factor c = (1 / sqrt(HD)) * log2(e): the row max
//   m is taken on the unscaled fp32 scores (rounding is monotone, so
//   fl(m c) is the max of the fl(s c)), and p = 2^(s c - m c) is one FFMA
//   and one ex2.approx.ftz; exp(x) = 2^(x log2 e).  The reference scales q
//   in fp32 before the dot; here the bf16 q enters the dot as it is and
//   the scale comes after it.  At HD 64 the scale is 2^-3 and both orders
//   give the same scaled scores; at HD 128 they differ by one fp32
//   rounding of each score.
//   The masks are applied only on tiles that cross the diagonal or Skv;
//   tiles wholly above the diagonal are skipped (exact: they hold no
//   unmasked score), and the first tile holds column 0, so every row has a
//   finite running max from the first tile on.  The row max comes from
//   shuffles in the 4 threads of an mma quad; each thread keeps a partial
//   row sum, reduced by the same shuffles once, at the end.
//   P V: P is rounded to bf16 in registers (the C fragments of two m16n8
//   score tiles are the A fragment of one m16k16 tile, so P never goes to
//   shared memory), V is read by ldmatrix.trans, and the sum stays in fp32
//   registers.  The row sum l adds the fp32 p, before that rounding.
//   Epilogue: acc / (l == 0 ? 1 : l), rounded to bf16, through the q
//   tile's shared memory (free once its fragments are in registers) to
//   16-byte stores.
//   Shared memory: 8 KB of q and a 32 KB ring at HD 64, 16 KB and 64 KB at
//   HD 128; three blocks an SM at HD 64 (registers capped), two at 128.
//
// fp32 (flash_fwd_f32): no tensor-core path keeps IEEE fp32 dots (TF32
// would not), so fp32 keeps CUDA-core FMAs, in the reference's order: q
// scaled in fp32 before the dot, expf.  One block of 256 threads per
// (64-row q tile, b * H + h); the scaled q tile and 64-row K and V tiles
// are staged in shared memory; a thread owns 4 rows x 4 score columns (16
// threads per row, row reductions by warp shuffles) and 4 rows x HD / 16
// output columns.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBKV = 64;                // kv rows per tile
constexpr float kNegInf = -1e30f;

// Batch, head and sequence strides of the four operands, in elements.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ------------------------------------------------------------ fp32 kernel
constexpr int kThreadsF32 = 256;
constexpr int kLanesPerRow = 16;        // threads sharing one row group
constexpr int kRowsPerThread = 4;       // kBQ / (kThreads / kLanesPerRow)
constexpr int kColsPerThread = kBKV / kLanesPerRow;   // 4 score columns

template <int HD>
constexpr size_t smem_floats() {
  // q (kBQ x HD+1), k (kBKV x HD+1), v (kBKV x HD), p (kBQ x kBKV+1)
  return (size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) +
         (size_t)kBKV * HD + (size_t)kBQ * (kBKV + 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int Hkv, int Sq, int Skv, int causal, float scale,
              Strides st) {
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
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hkv * st.k[1];
  const float* vb = v + b * st.v[0] + hkv * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];

  const int tr = threadIdx.x / kLanesPerRow;        // row group: 4 rows
  const int tc = threadIdx.x % kLanesPerRow;        // column lane
  const int r0 = tr * kRowsPerThread;

  // staging: a thread keeps one column and steps kRowStep rows at a time
  constexpr int kRowStep = kThreadsF32 / HD;
  const int c0 = threadIdx.x % HD, r00 = threadIdx.x / HD;
  {
    const float* src = qb + (q0 + r00) * st.q[2] + c0;
    for (int r = r00; r < kBQ; r += kRowStep, src += kRowStep * st.q[2])
      qs[r * (HD + 1) + c0] = q0 + r < Sq ? *src * scale : 0.0f;
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
    {
      const float* ksrc = kb + (kv0 + r00) * st.k[2] + c0;
      const float* vsrc = vb + (kv0 + r00) * st.v[2] + c0;
      for (int r = r00; r < kBKV; r += kRowStep, ksrc += kRowStep * st.k[2],
               vsrc += kRowStep * st.v[2]) {
        const bool in = kv0 + r < Skv;  // padding rows are zero, never NaN
        ks[r * (HD + 1) + c0] = in ? *ksrc : 0.0f;
        vs[r * HD + c0] = in ? *vsrc : 0.0f;
      }
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
      ob[row * st.o[2] + tc + j * kLanesPerRow] = acc[i][j] / denom;
  }
}

// ------------------------------------------------------------ bf16 kernel
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;               // 16 q rows each
constexpr int kThreadsBf16 = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 16-byte global -> shared copy in flight; src_bytes 0 zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), fp32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU op; a result below 2^-126 flushes to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// Element offset of (row, col) in a [rows][HD] bf16 tile whose 16-byte
// chunks are XOR-swizzled by row; col is a multiple of 8.
template <int HD>
__device__ __forceinline__ int swz(int row, int col) {
  return row * HD + (((col >> 3) ^ (row & 7)) << 3);
}

// Copy rows [row0, row0 + 64) of a (rows, HD) operand with row stride
// `stride` into a swizzled tile; rows at or past n_rows are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = HD / 8;                   // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kBKV * kChunks / kThreadsBf16; ++i) {
    const int idx = threadIdx.x + i * kThreadsBf16;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = row0 + r < n_rows;
    const bf16* g = in ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + swz<HD>(r, c * 8)), g, in ? 16 : 0);
  }
}

constexpr int kStages = 2;              // K/V ring depth

template <int HD>
constexpr size_t smem_bytes_bf16() {
  // q [kBQ][HD], then K and V rings of kStages [kBKV][HD] stages each
  return (size_t)(kBQ * HD + 2 * kStages * kBKV * HD) * sizeof(bf16);
}

// At HD 64, three blocks an SM (at most 170 registers a thread; 164, no
// spills): on an H100 SXM this is faster, most at the LM prefill's shape,
// than the 180 registers and two blocks the compiler picks unbounded.  HD
// 128 needs some 250 registers (two blocks).
template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, HD == 64 ? 3 : 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int H,
               int Hkv, int Sq, int Skv, int causal, float scale,
               Strides st) {
  constexpr int kTile = kBKV * HD;
  constexpr int kKB = HD / 16;          // k-steps of QK^T, n-pairs of PV
  constexpr int kON = HD / 8;           // output n-tiles of 8 columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);     // [kBQ][HD]
  bf16* sk = sq + kBQ * HD;                         // [kStages][kBKV][HD]
  bf16* sv = sk + kStages * kTile;                  // [kStages][kBKV][HD]

  // blocks launch in linear order; the i-th takes q tile (from the last)
  // i / (B H) of (b, h) = i mod (B H): every head's heaviest tile first
  const long long lin = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int bh = (int)(lin % gridDim.y);
  const int q0 = (gridDim.x - 1 - (int)(lin / gridDim.y)) * kBQ;
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + hkv * st.k[1];
  const bf16* vb = v + b * st.v[0] + hkv * st.v[1];
  bf16* ob = o + b * st.o[0] + h * st.o[1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;           // mma quad row, column
  const int li = lane & 7, lj = lane >> 3;          // ldmatrix row, matrix
  const int wr = warp * 16;                         // the warp's first row

  int n_tiles = (Skv + kBKV - 1) / kBKV;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, Sq) - 1) / kBKV + 1);

  // one commit group per tile; the q tile travels with tile 0
  load_tile<HD>(sq, qb, st.q[2], q0, Sq);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) {
      load_tile<HD>(sk + j * kTile, kb, st.k[2], j * kBKV, Skv);
      load_tile<HD>(sv + j * kTile, vb, st.v[2], j * kBKV, Skv);
    }
    cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  unsigned qf[kKB][4];                  // the q tile's A fragments
  float acc[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};      // running max of rows g, g + 8
  float l[2] = {0.0f, 0.0f};            // this thread's partial row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBKV;
    const int tn = t + kStages - 1;     // the tile this iteration prefetches
    if (tn < n_tiles) {
      load_tile<HD>(sk + (tn % kStages) * kTile, kb, st.k[2], tn * kBKV, Skv);
      load_tile<HD>(sv + (tn % kStages) * kTile, vb, st.v[2], tn * kBKV, Skv);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();       // tile t has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(sq + swz<HD>(wr + li + (lj & 1) * 8,
                                                  kk * 16 + (lj >> 1) * 8)));
    }
    const bf16* ks = sk + (t % kStages) * kTile;
    const bf16* vs = sv + (t % kStages) * kTile;

    // S = Q K^T: 16 rows x 64 columns a warp, as 8 n-tiles of 8 columns
    float s[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
#pragma unroll
      for (int np = 0; np < kBKV / 16; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, smem_u32(ks + swz<HD>(np * 16 + li + (lj >> 1) * 8,
                                             kk * 16 + (lj & 1) * 8)));
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // the masks, on the tiles that need them
    if (kv0 + kBKV > Skv || (causal && kv0 + kBKV - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + wr + g + (e >> 1) * 8;
          const int col = kv0 + n * 8 + 2 * t4 + (e & 1);
          if (!(col < Skv && (!causal || row >= col))) s[n][e] = kNegInf;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = ex2((m[hh] - m_new) * scale_log2);
      const float mc = m_new * scale_log2;
      m[hh] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          s[n][e] = ex2(fmaf(s[n][e], scale_log2, -mc));
          sum += s[n][e];
        }
      l[hh] = alpha * l[hh] + sum;
#pragma unroll
      for (int n = 0; n < kON; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kKB; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, smem_u32(vs + swz<HD>(kk * 16 + li + (lj & 1) * 8,
                                                   np * 16 + (lj >> 1) * 8)));
        mma_bf16(acc[2 * np], pa, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();                    // the stage of tile t is free again
  }

  // epilogue: through the q tile's shared rows of this warp to 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = sum == 0.0f ? 1.0f : sum;
    const int r = wr + g + hh * 8;
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(sq + swz<HD>(r, n * 8) + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * hh] / denom,
                                acc[n][2 * hh + 1] / denom);
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int idx = lane + i * 32;
    const int r = wr + idx / kChunks, c = idx % kChunks;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * st.o[2] + c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz<HD>(r, c * 8));
  }
}

template <int HD>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k,
                      const void* v, void* o, int B, int H, int Hkv, int Sq,
                      int Skv, int causal, float scale, const Strides& st,
                      cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  if (is_bf16) {
    const size_t smem = smem_bytes_bf16<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16<HD><<<grid, kThreadsBf16, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, Hkv, Sq,
        Skv, causal, scale, st);
  } else {
    const size_t smem = smem_floats<HD>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32<HD><<<grid, kThreadsF32, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, H, Hkv,
        Sq, Skv, causal, scale, st);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for q, o (B, H, Sq, hd) and k, v (B, Hkv, Skv, hd),
// all of one type (is_bf16 selects bf16, else fp32); hd is 64 or 128 and H
// a multiple of Hkv.  Each operand comes with its batch, head and sequence
// strides in elements (hd at stride 1); every pointer and every stride of
// a dimension larger than 1 must be 16-byte aligned.  Returns cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Hkv, int Sq, int Skv, int hd,
                    int causal, int is_bf16, float scale, long long q_sb,
                    long long q_sh, long long q_ss, long long k_sb,
                    long long k_sh, long long k_ss, long long v_sb,
                    long long v_sh, long long v_ss, long long o_sb,
                    long long o_sh, long long o_ss, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv < 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                      {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}};
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return launch_hd<64>(is_bf16, q, k, v, o, B, H, Hkv, Sq, Skv, causal,
                         scale, st, s);
  if (hd == 128)
    return launch_hd<128>(is_bf16, q, k, v, o, B, H, Hkv, Sq, Skv, causal,
                          scale, st, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
