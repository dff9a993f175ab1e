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

}  // namespace repro
