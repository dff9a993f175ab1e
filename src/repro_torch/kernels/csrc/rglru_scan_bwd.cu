// Backward of the RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper
// (sm_90a): dx, da and the initial state's gradient.
//
// The reference has no Pallas backward: jax.value_and_grad differentiates
// its scan (src/repro/kernels/rglru_scan.py, rglru_scan() / _kernel, on the
// default "ref" backend: repro.kernels.ref.rglru_scan) through XLA.  In the
// port a CUDA tensor never takes a plain version, so the gradient of every
// K4 launch of a training step comes from this kernel.
//
// Per channel, with h_t = a_t h_{t-1} + b_t x_t and b_t = sqrt(max(1 - a_t^2, 0)),
// and g_t the gradient reaching h_t (dy_t, plus the final state's gradient
// at t = T - 1, plus what h_{t+1} passes back):
//   g_t = dy_t + a_{t+1} g_{t+1},   dx_t = g_t b_t,
//   da_t = g_t (h_{t-1} + x_t b'(a_t)),  b'(a) = -a / b  (0 where 1 - a^2 < 0),
//   dh_{-1} = a_0 g_0.
// Where 1 - a^2 is 0 (a = 1), b' is -inf and da is +-inf (NaN where x or g
// is 0), as autograd of the plain version gives it: no clamp the reference
// lacks.
//
// h_{t-1} is the f32 state, never rebuilt from the rounded y: a first walk
// over the sequence writes the state at the start of every 32-token stage
// to a workspace (f32), and the reverse walk recomputes each stage's states
// from its checkpoint with the forward kernel's arithmetic (the same FMA,
// the same input factor), so they are its states bit for bit.
//
// Layout: the forward kernel's.  A CTA covers 32 channels of one batch row
// inside one logical C tile; channels are independent, so no atomics and
// no cross-CTA sums.  Eight warps stage a stage's x, a and dy (and work out
// the per-token factors b, x b' and the forward's input factor b x) in
// shared memory; one warp, a lane per channel, runs the chains; then the
// eight warps form and store dx and da.  Simple first: no copy overlaps the
// chains.
//
// What bounds it: the bytes (x and a read twice, dy once, dx and da written
// once, the checkpoints), against ~12 operations per element.
#include <math.h>

#include "common.cuh"

namespace repro {

constexpr int kLruBwdCtaC = 32;      // channels per CTA: the chain warp's lanes
constexpr int kLruBwdStageT = 32;    // tokens per stage (and per checkpoint)
constexpr int kLruBwdThreads = 256;  // threads that stage inputs and store outputs

struct RglruBwdArgs {
  const void* x; const void* a; const float* h0; const void* dy; const float* dhT;
  void* dx; void* da; float* dh0; float* ck;   // ck: (B, stages, C) f32 checkpoints
  int t, c, tile_c, per_tile, stages;
};

template <typename T>
__global__ void __launch_bounds__(kLruBwdThreads) rglru_scan_bwd_kernel(RglruBwdArgs g) {
  constexpr int N = kLruBwdStageT, CW = kLruBwdCtaC;
  // per token and channel of the stage: a, the forward's input factor b x,
  // b, x b', dy, then the chain warp's h_{t-1} and g_t
  __shared__ float s_a[N][CW], s_f[N][CW], s_b[N][CW], s_e[N][CW], s_dy[N][CW];
  __shared__ float s_h[N][CW], s_g[N][CW];

  const int tile = blockIdx.x / g.per_tile;
  const int c0 = tile * g.tile_c + (blockIdx.x % g.per_tile) * CW;
  const int cw = min(min(c0 + CW, (tile + 1) * g.tile_c), g.c) - c0;
  if (cw <= 0) return;   // a ragged last tile can leave a CTA no channel
  const size_t base = (size_t)blockIdx.y * g.t * g.c;
  const T* xb = static_cast<const T*>(g.x) + base;
  const T* ab = static_cast<const T*>(g.a) + base;
  const T* dyb = static_cast<const T*>(g.dy) + base;
  T* dxb = static_cast<T*>(g.dx) + base;
  T* dab = static_cast<T*>(g.da) + base;
  float* ckb = g.ck + (size_t)blockIdx.y * g.stages * g.c;
  const int tid = threadIdx.x, lane = tid % 32;
  const bool chain = tid < 32;   // warp 0 runs the chains, a lane per channel

  auto tokens = [&](int st) { return min(N, g.t - st * N); };
  // stage st's inputs into shared memory, as f32, with the per-token factors;
  // with_grad: also b, x b' and dy (the reverse walk)
  auto stage = [&](int st, bool with_grad) {
    const int n = tokens(st);
    for (int i = tid; i < n * CW; i += kLruBwdThreads) {
      const int tt = i / CW, ch = i % CW;
      if (ch >= cw) continue;
      const size_t o = (size_t)(st * N + tt) * g.c + c0 + ch;
      const float at = to_f(ab[o]), xt = to_f(xb[o]);
      const float u = __fsub_rn(1.f, __fmul_rn(at, at));
      const float b = sqrtf(fmaxf(u, 0.f));
      s_a[tt][ch] = at;
      s_f[tt][ch] = __fmul_rn(b, xt);   // the forward kernel's input factor
      if (with_grad) {
        s_b[tt][ch] = b;
        // b'(a) = -a / b: +-inf at b = 0, 0 where the clamp cut 1 - a^2
        s_e[tt][ch] = __fmul_rn(xt, u < 0.f ? 0.f : __fdiv_rn(-at, b));
        s_dy[tt][ch] = to_f(dyb[o]);
      }
    }
  };

  // the forward walk: the state at the start of every stage
  float h = 0.f;
  if (chain && lane < cw) h = g.h0[(size_t)blockIdx.y * g.c + c0 + lane];
  for (int st = 0; st < g.stages - 1; ++st) {
    __syncthreads();
    stage(st, false);
    __syncthreads();
    if (chain && lane < cw) {
      ckb[(size_t)st * g.c + c0 + lane] = h;
      for (int tt = 0; tt < N; ++tt) h = fmaf(s_a[tt][lane], h, s_f[tt][lane]);
    }
  }
  if (chain && lane < cw) ckb[(size_t)(g.stages - 1) * g.c + c0 + lane] = h;

  // the reverse walk: carry = a_{t+1} g_{t+1} (the final state's gradient at first)
  float carry = 0.f;
  if (chain && lane < cw && g.dhT != nullptr) carry = g.dhT[(size_t)blockIdx.y * g.c + c0 + lane];
  for (int st = g.stages - 1; st >= 0; --st) {
    const int n = tokens(st);
    __syncthreads();
    stage(st, true);
    __syncthreads();
    if (chain && lane < cw) {
      float hh = ckb[(size_t)st * g.c + c0 + lane];
      for (int tt = 0; tt < n; ++tt) {
        s_h[tt][lane] = hh;
        hh = fmaf(s_a[tt][lane], hh, s_f[tt][lane]);
      }
      for (int tt = n - 1; tt >= 0; --tt) {
        const float gt = __fadd_rn(s_dy[tt][lane], carry);
        s_g[tt][lane] = gt;
        carry = __fmul_rn(s_a[tt][lane], gt);
      }
    }
    __syncthreads();
    for (int i = tid; i < n * CW; i += kLruBwdThreads) {
      const int tt = i / CW, ch = i % CW;
      if (ch >= cw) continue;
      const size_t o = (size_t)(st * N + tt) * g.c + c0 + ch;
      const float gt = s_g[tt][ch];
      dxb[o] = from_f<T>(__fmul_rn(gt, s_b[tt][ch]));
      dab[o] = from_f<T>(__fmul_rn(gt, __fadd_rn(s_h[tt][ch], s_e[tt][ch])));
    }
  }
  if (chain && lane < cw) g.dh0[(size_t)blockIdx.y * g.c + c0 + lane] = carry;
}

template <typename T>
int launch_bwd(const RglruBwdArgs& g, int b, int ctas_per_row, cudaStream_t stream) {
  rglru_scan_bwd_kernel<T><<<dim3(ctas_per_row, b), kLruBwdThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  x/a/dy/dx/da (B,T,C) contiguous, of one
// dtype; h0/dh0 (B,C) f32; dhT (B,C) f32 or null (the final state's
// gradient, 0 where null); ck a (B, ceil(T/32), C) f32 workspace.  (cta_c,
// stage_t, ctas): the launch layout the wrapper chose (kernels/rglru_scan.py
// scan_geometry and BWD_STAGE_T), re-checked here.  Returns a cudaError_t
// (cudaErrorInvalidValue for a layout or shape it does not take).
extern "C" int repro_rglru_scan_bwd(const void* x, const void* a, const void* h0, const void* dy,
                                    const void* dhT, void* dx, void* da, void* dh0, void* ck,
                                    int b, int t, int c, int dtype, int tile_c, int cta_c,
                                    int stage_t, int ctas, void* stream) {
  using namespace repro;
  if (b <= 0 || b > 65535 || t <= 0 || c <= 0 || tile_c <= 0) return (int)cudaErrorInvalidValue;
  if (cta_c != kLruBwdCtaC || stage_t != kLruBwdStageT) return (int)cudaErrorInvalidValue;
  RglruBwdArgs g;
  g.x = x; g.a = a; g.h0 = static_cast<const float*>(h0); g.dy = dy;
  g.dhT = static_cast<const float*>(dhT);
  g.dx = dx; g.da = da; g.dh0 = static_cast<float*>(dh0); g.ck = static_cast<float*>(ck);
  g.t = t; g.c = c; g.tile_c = tile_c;
  g.per_tile = cdiv(tile_c < c ? tile_c : c, kLruBwdCtaC);
  g.stages = cdiv(t, kLruBwdStageT);
  const long long per_row = (long long)cdiv(c, tile_c) * g.per_tile;
  if (per_row * b != ctas || per_row > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_bwd<__nv_bfloat16>(g, b, (int)per_row, s);
  if (dtype == kFloat32) return launch_bwd<float>(g, b, (int)per_row, s);
  return (int)cudaErrorInvalidValue;
}
