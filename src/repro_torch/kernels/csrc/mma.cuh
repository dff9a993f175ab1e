// Tensor-core helpers shared by the matmul's mma body and the attention's
// mma body: ldmatrix operand loads and the mma.sync m16n8k16 bf16 x bf16 ->
// f32 product (cp.async staging is in common.cuh).
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
