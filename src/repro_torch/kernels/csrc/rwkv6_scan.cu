// wkv6 recurrence (RWKV6 / Finch time-mix) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/rwkv6_scan.py
// (rwkv6_scan() / _kernel).  The TPU grid is (B*H, T chunks) with T
// innermost, and the D x D f32 state lives in VMEM scratch that persists
// from one time chunk to the next.  Here blocks run in no order, so one CTA
// owns one (b, h) pair and walks the whole sequence itself, in the
// schedule's T tiles; that loop takes the place of the sequential grid axis.
//
// One thread per value column j keeps the state column S[:, j] (D floats)
// in registers for the whole scan.  r, k and w of a token are needed by
// every thread, so they are staged in shared memory, kStage tokens at a
// time (loads coalesced over j); v_j and y_j belong to thread j alone and
// go straight between registers and device memory.  Per token, in the
// order _kernel computes it:
//   kv_i = k_i v_j;   y_j = sum_i r_i (S_ij + u_i kv_i);   S_ij = w_i S_ij + kv_i
// The T tile only sets where one staging run ends and the next begins:
// every token runs the same arithmetic in the same order whatever the
// tile, so y and the final state are bit-identical across T tiles.
//
// What bounds it: the operations, 7 f32 operations per (i, j) per token on
// CUDA cores (no matrix product to give the tensor cores), against bytes of
// only 4 D-vectors per token.  The grid is B*H CTAs of D threads (32 CTAs of
// 2 warps for rwkv6-1.6b's prefill), far from filling 132 SMs.
#include "common.cuh"

namespace repro {

constexpr int kStage = 32;  // tokens of r, k, w staged in shared memory at a time

struct Rwkv6Args {
  const void* r; const void* k; const void* v; const void* w;
  const float* u; const float* s0; void* y; float* sT;
  int h, t, tile_t;
};

template <typename T, int D>
__global__ void __launch_bounds__(D) rwkv6_scan_kernel(Rwkv6Args a) {
  __shared__ float rs[kStage][D];
  __shared__ float ks[kStage][D];
  __shared__ float ws[kStage][D];
  __shared__ float us[D];

  const int bh = blockIdx.x;
  const int j = threadIdx.x;  // the value column this thread owns
  const size_t base = (size_t)bh * a.t * D;
  const T* rb = static_cast<const T*>(a.r) + base;
  const T* kb = static_cast<const T*>(a.k) + base;
  const T* vb = static_cast<const T*>(a.v) + base;
  const T* wb = static_cast<const T*>(a.w) + base;
  T* yb = static_cast<T*>(a.y) + base;

  us[j] = a.u[(size_t)(bh % a.h) * D + j];
  float S[D];
  const float* s0 = a.s0 + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s0[i * D + j];

  for (int c0 = 0; c0 < a.t; c0 += a.tile_t) {        // the schedule's T tile
    const int c1 = min(c0 + a.tile_t, a.t);
    for (int t0 = c0; t0 < c1; t0 += kStage) {        // staged in shared memory
      const int n = min(kStage, c1 - t0);
      __syncthreads();  // the previous stage is consumed (and us is written)
      for (int tt = 0; tt < n; ++tt) {
        const size_t o = (size_t)(t0 + tt) * D + j;
        rs[tt][j] = to_f(rb[o]);
        ks[tt][j] = to_f(kb[o]);
        ws[tt][j] = to_f(wb[o]);
      }
      __syncthreads();
      for (int tt = 0; tt < n; ++tt) {
        const size_t o = (size_t)(t0 + tt) * D + j;
        const float vj = to_f(vb[o]);
        float y = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float kv = ks[tt][i] * vj;
          y += rs[tt][i] * (S[i] + us[i] * kv);
          S[i] = ws[tt][i] * S[i] + kv;
        }
        yb[o] = from_f<T>(y);
      }
    }
  }

  float* sT = a.sT + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) sT[i * D + j] = S[i];
}

template <typename T, int D>
int launch(const Rwkv6Args& a, int bh, cudaStream_t stream) {
  rwkv6_scan_kernel<T, D><<<bh, D, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Rwkv6Args& a, int bh, int d, cudaStream_t s) {
  if (d == 16) return launch<T, 16>(a, bh, s);
  if (d == 32) return launch<T, 32>(a, bh, s);
  if (d == 64) return launch<T, 64>(a, bh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// C entry point bound with ctypes.  r/k/v/w/y (B,H,T,D) contiguous, of one
// dtype; u (H,D), s0/sT (B,H,D,D) f32 contiguous.  Returns a cudaError_t.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* y, void* sT,
                                int b, int h, int t, int d, int dtype, int tile_t,
                                void* stream) {
  using namespace repro;
  if (b <= 0 || h <= 0 || t <= 0 || tile_t <= 0) return (int)cudaErrorInvalidValue;
  Rwkv6Args a;
  a.r = r; a.k = k; a.v = v; a.w = w;
  a.u = static_cast<const float*>(u); a.s0 = static_cast<const float*>(s0);
  a.y = y; a.sT = static_cast<float*>(sT);
  a.h = h; a.t = t; a.tile_t = tile_t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch_d<__nv_bfloat16>(a, b * h, d, s);
  if (dtype == kFloat32) return dispatch_d<float>(a, b * h, d, s);
  return (int)cudaErrorInvalidValue;
}
