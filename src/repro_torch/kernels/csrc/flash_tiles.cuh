// The bf16 flash kernels' device helpers, shared by flash_attention.cu (the
// forward) and flash_attention_bwd.cu (the backward): cp.async copies into
// XOR-swizzled 64-row tiles, ldmatrix, mma.sync m16n8k16 (bf16 in, fp32
// accumulate), ex2 and the bf16 packing of C fragments into A fragments.
// Each source compiles its own copy (anonymous namespace); what the kernels
// compute and why they are built this way is set out at the top of each.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kTileRows = 64;           // rows of every q and kv tile
constexpr int kTileThreads = 128;       // 4 warps of 16 tile rows each
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
// `stride` into a swizzled tile, by the 128 threads numbered tid; rows at
// or past n_rows are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = HD / 8;                   // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kTileRows * kChunks / kTileThreads; ++i) {
    const int idx = tid + i * kTileThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = row0 + r < n_rows;
    const bf16* g = in ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + swz<HD>(r, c * 8)), g, in ? 16 : 0);
  }
}
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int n_rows) {
  load_tile<HD>(dst, src, stride, row0, n_rows, (int)threadIdx.x);
}

}  // namespace
