// Tensor-core helpers shared by the matmul's mma body and the attention's
// mma bodies (forward and backward): ldmatrix operand loads, the mma.sync
// m16n8k16 bf16 x bf16 -> f32 product, bf16 row staging into padded shared
// rows, and the shifted read of rows off 16 bytes (the matmul's and its
// gradient's; the cp.async primitives are in common.cuh).
#pragma once

#include "common.cuh"

namespace repro {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo = first, the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stages 8 consecutive bf16 of one row, src[0, valid), into 16 bytes of
// shared memory, zeros past `valid`: one cp.async when the row is read in
// 16-byte-aligned chunks (vec), guarded scalar loads otherwise.  src must be
// a valid address even when valid <= 0.
__device__ __forceinline__ void stage8(__nv_bfloat16* dst, const __nv_bfloat16* src, int valid, bool vec) {
  valid = max(0, min(valid, 8));
  if (vec) {
    cp_async16(smem_addr(dst), src, 2 * valid);
  } else {
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? src[i] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// The shifted read of a row-major bf16 matrix src (rows of ld elements)
// whose rows do not start on 16 bytes, in two steps.  First a ring stage
// of raw rows: for each of rows [k0, k0 + ROWS), the VECS aligned 16-byte
// vectors that hold its columns [c0, c1), by cp.async into raw rows of 8 *
// VECS elements (zeros for rows at and past k and for vectors that hold no
// column of [c0, c1): such a vector may lie past the tensor).
template <int ROWS, int VECS, int THREADS>
__device__ __forceinline__ void stage_raw_rows(__nv_bfloat16* raw, const __nv_bfloat16* src,
                                               long long ld, int k0, int k, int c0, int c1) {
  for (int i = threadIdx.x; i < ROWS * VECS; i += THREADS) {
    const int r = i / VECS, j = i % VECS, gk = k0 + r;
    const __nv_bfloat16* row = src + (size_t)gk * ld;
    const __nv_bfloat16* v = align_down16(row + c0) + 8 * j;
    const bool live = gk < k && v < row + c1;
    cp_async16(smem_addr(raw + r * 8 * VECS + 8 * j), live ? v : align_down16(src), live ? 16 : 0);
  }
}

// Then, once that stage has landed: each raw row's VECS - 1 chunks of 16
// bytes, shifted by the row's own byte offset, into dst (rows of the same
// stride), where ldmatrix reads them.
template <int ROWS, int VECS, int THREADS>
__device__ __forceinline__ void shift_raw_rows(__nv_bfloat16* dst, const __nv_bfloat16* raw,
                                               const __nv_bfloat16* src, long long ld, int k0,
                                               int c0) {
  constexpr int kChunks = ROWS * (VECS - 1);
  static_assert(kChunks % THREADS == 0, "every thread shifts the same number of chunks");
#pragma unroll
  for (int j = 0; j < kChunks / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (VECS - 1), c = (i % (VECS - 1)) * 8;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src + (size_t)(k0 + r) * ld + c0) & 15);
    const uint4* q = reinterpret_cast<const uint4*>(raw + r * 8 * VECS + c);
    *reinterpret_cast<uint4*>(dst + r * 8 * VECS + c) = shift16(q[0], q[1], off);
  }
}

// Rows [g0, g0 + ROWS) of a (rows, D) bf16 matrix into shared rows of DP +
// PAD elements (PAD = 8: 16 bytes against bank conflicts), zeros at and past
// row g1 and past column D; the CTA's THREADS threads share the copies.
template <int ROWS, int DP, int THREADS, int PAD = 8>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int g0,
                                           int g1, int D, bool vec) {
  constexpr int kChunks = ROWS * DP / 8;   // 16-byte chunks
  static_assert(kChunks % THREADS == 0, "every thread stages the same number");
#pragma unroll
  for (int j = 0; j < kChunks / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int gr = g0 + r;
    const int valid = gr < g1 ? D - c : 0;
    stage8(dst + r * (DP + PAD) + c, valid > 0 ? src + (size_t)gr * D + c : src, valid, vec);
  }
}

// two neighbouring outputs: one 4-byte store where aligned
__device__ __forceinline__ void store2(__nv_bfloat16* o, float y0, float y1) {
  if ((reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
  } else {
    o[0] = __float2bfloat16_rn(y0);
    o[1] = __float2bfloat16_rn(y1);
  }
}

}  // namespace repro
