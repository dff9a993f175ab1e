// Shared device helpers for the port's kernels: dtype conversion and the
// activation functions in the exact forms the JAX reference uses.
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

}  // namespace repro
