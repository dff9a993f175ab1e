// RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/rglru_scan.py
// (rglru_scan() / _kernel).  The TPU grid is (B, C blocks, T chunks) with T
// innermost, and each channel block's f32 state row lives in VMEM scratch
// that persists from one time chunk to the next.  Here blocks run in no
// order, so one CTA owns one (b, C tile) pair and walks the whole sequence
// itself.
//
// One thread per channel keeps h in an f32 register and loops over T:
//   h = a h + sqrt(max(1 - a^2, 0)) x,   y_t = h rounded to x's dtype
// Channels are independent, so nothing is shared between threads: each
// step's loads of x and a, and its store of y, are coalesced across the
// warp's neighbouring channels.  The schedule's C tile is the CTA's logical
// tile, walked in blocks of at most 1024 threads, with the ragged C edge
// masked.  The T tile is not used: the TPU chunked time only to fit VMEM,
// and a thread here streams its channel straight from device memory.
//
// What bounds it: the bytes (x and a read once, y written once, 2-byte
// values for bf16), against ~6 operations per element.  The grid is
// B * C / tile CTAs (5 per batch row for recurrentgemma-2b's 2560 channels
// under the default 512-channel tile), far from filling 132 SMs.
#include "common.cuh"

namespace repro {

struct RglruArgs {
  const void* x; const void* a; const float* h0; void* y; float* hT;
  int t, c, tile_c;
};

template <typename T>
__global__ void __launch_bounds__(1024) rglru_scan_kernel(RglruArgs g) {
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * g.tile_c, c1 = min(c0 + g.tile_c, g.c);
  const size_t base = (size_t)b * g.t * g.c;
  const T* xb = static_cast<const T*>(g.x) + base;
  const T* ab = static_cast<const T*>(g.a) + base;
  T* yb = static_cast<T*>(g.y) + base;
  for (int ch = c0 + threadIdx.x; ch < c1; ch += blockDim.x) {
    float h = g.h0[(size_t)b * g.c + ch];
#pragma unroll 4
    for (int t = 0; t < g.t; ++t) {
      const size_t o = (size_t)t * g.c + ch;
      const float at = to_f(ab[o]);
      const float xt = to_f(xb[o]);
      h = at * h + sqrtf(fmaxf(1.f - at * at, 0.f)) * xt;
      yb[o] = from_f<T>(h);
    }
    g.hT[(size_t)b * g.c + ch] = h;
  }
}

template <typename T>
int launch(const RglruArgs& g, int b, cudaStream_t stream) {
  const int threads = min(1024, cdiv(g.tile_c, 32) * 32);
  const dim3 grid(cdiv(g.c, g.tile_c), b);
  rglru_scan_kernel<T><<<grid, threads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  x/a/y (B,T,C) contiguous, of one dtype;
// h0/hT (B,C) f32 contiguous.  Returns a cudaError_t.
extern "C" int repro_rglru_scan(const void* x, const void* a, const void* h0, void* y,
                                void* hT, int b, int t, int c, int dtype, int tile_c,
                                void* stream) {
  using namespace repro;
  if (b <= 0 || b > 65535 || t <= 0 || c <= 0 || tile_c <= 0) return (int)cudaErrorInvalidValue;
  RglruArgs g;
  g.x = x; g.a = a; g.h0 = static_cast<const float*>(h0); g.y = y;
  g.hT = static_cast<float*>(hT);
  g.t = t; g.c = c; g.tile_c = tile_c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(g, b, s);
  if (dtype == kFloat32) return launch<float>(g, b, s);
  return (int)cudaErrorInvalidValue;
}
