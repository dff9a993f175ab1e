// Shared device helpers for the port's kernels: dtype conversion, the
// activation functions in the exact forms the JAX reference uses, and
// cp.async staging into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round-to-nearest-even, as astype(bfloat16) in XLA and .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// jax.nn.gelu's default (approximate=True): the tanh form
__device__ __forceinline__ float gelu_tanh(float y) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
}

// jax.nn.silu: y * sigmoid(y)
__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that reads `bytes` (0..16) and zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages one 16-byte chunk (16 / sizeof(T) elements) of a row into shared
// memory: one cp.async where the rows are read in whole 16-byte-aligned
// chunks (vec), plain loads of its first `valid` elements otherwise.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* src, int valid, bool vec) {
  if (vec) {
    cp_async16(smem_addr(dst), src, 16);
  } else {
    for (int i = 0; i < valid; ++i) dst[i] = src[i];
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// p rounded down to 16 bytes: the aligned vector that holds *p, which lies
// inside the same allocation (the allocator's blocks start on 16 bytes at
// least), so reading it is safe wherever *p is
template <typename T>
__host__ __device__ inline const T* align_down16(const T* p) {
  return reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15));
}

// The 16 bytes that start `off` bytes (even, 0..14) into lo and run on into
// hi: a row segment read as aligned vectors, shifted into place in
// registers.  Constant register indices only (by 8, then 4, then 2 bytes).
__device__ __forceinline__ uint4 shift16(uint4 lo, uint4 hi, int off) {
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = (off & 8) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = (off & 4) ? w[i + 1] : w[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = (off & 2) ? __funnelshift_r(w[i], w[i + 1], 16) : w[i];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// v with its bytes at and past `bytes` (even) zeroed
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int bytes) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = bytes - 4 * j;
    w[j] = b >= 4 ? w[j] : b >= 2 ? (w[j] & 0xffffu) : 0u;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Logical N tiles that one CTA of cta_n columns covers side by side
// (kernels/matmul.py n_group): floor(cta_n / tile_n) where the N tile is
// narrower than both N and the CTA, else 1.  A CTA's columns are then one
// group of consecutive logical tiles, masked at the group's edge and N's.
__host__ __device__ __forceinline__ int n_group(int n, int tile_n, int cta_n) {
  return tile_n < n && tile_n < cta_n ? cta_n / tile_n : 1;
}

// Logical M tiles that one rows-body CTA of cta_rows rows covers one under
// the other (kernels/matmul.py m_group): floor(cta_rows / tile_m) where the
// M tile is narrower than both M and the CTA, else 1.  The group's rows are
// consecutive, masked at the group's edge and M's.
__host__ __device__ __forceinline__ int m_group(int m, int tile_m, int cta_rows) {
  return tile_m < m && tile_m < cta_rows ? cta_rows / tile_m : 1;
}

}  // namespace repro
