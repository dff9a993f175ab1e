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
// h_{t-1} is the f32 state, never rebuilt from the rounded y: a forward walk
// over the sequence writes the state at the start of every 32-token stage
// but the last to a workspace (f32), and a reverse walk recomputes each
// stage's states (the last stage's from the walk's own final state)
// from its checkpoint with the forward kernel's arithmetic (the same FMA,
// the same input factor), so they are its states bit for bit.  Every
// element takes the same rounded operations, in the same order, whatever
// the layout, the stage or the ring: the bits do not depend on them.
//
// Layout: the forward kernel's.  A CTA covers 32 channels of one batch row
// inside one logical C tile; channels are independent, so no atomics and
// no cross-CTA sums.  Warp-specialised, as csrc/rglru_scan.cu, with every
// role running at once:
//   - warp 0, the state chain (a lane per channel): the forward walk, one
//     FMA a token, writing the checkpoints; in the reverse walk it
//     recomputes each stage's h_{t-1} from the stage's checkpoint;
//   - warp 1, the gradient chain: g_t = dy_t + a_{t+1} g_{t+1}, backward
//     through each reverse stage (independent of warp 0's chain);
//   - four loader warps: stream x and a (and dy in the reverse walk) in
//     16-byte cp.async chunks through a ring of kLruBwdRing slots, and work
//     out the state chain's input factor sqrt(1 - a^2) x (f32) a stage
//     ahead;
//   - four storer warps: a stage after the chains, form dx and da from g
//     and h_{t-1} (b and x b' recomputed from the stage's x and a) and
//     store them in 16-byte chunks.
// The chains read a and dy where they lie, in the ring (exact in either
// dtype); f32 buffers hold f, overwritten with h_{t-1}, and g.  Both walks
// are one stream of stages -- 0 .. S-2 forward, then S-1 .. 0 in reverse --
// so the reverse walk's first loads are in flight under the forward walk's
// last chain.  Iteration v: the chains run stage v (buffer v % 3), the
// storers store stage v-1 (buffer (v-1) % 3), the loaders prepare stage v+1
// (buffer (v+1) % 3) and refill the ring slot of stage v-2, stored the
// iteration before.  One __syncthreads an iteration orders it all.
//
// Its bound is the bytes (x and a read twice -- the second time mostly
// from the L2 -- dy once, dx and da written once, the checkpoints),
// against ~12 operations per element.  The shared bytes (60 KB a CTA in
// bf16) leave room for 3 CTAs an SM, so recurrentgemma-2b's 320 CTAs at
// B = 4 fill the card in one wave.
#include <math.h>

#include "common.cuh"

namespace repro {

constexpr int kLruBwdCtaC = 32;      // channels per CTA: a chain warp's lanes
constexpr int kLruBwdStageT = 32;    // tokens per stage (and per checkpoint)
constexpr int kLruBwdRing = 6;       // cp.async slots: stages of x, a and dy
constexpr int kLruBwdBufs = 3;       // f32 buffers: being prepared, in the chains, being stored
constexpr int kLruBwdBatch = 8;      // tokens a chain warp reads ahead
constexpr int kLruBwdGroup = 128;    // threads of the loader group and of the storer group
constexpr int kLruBwdThreads = 64 + 2 * kLruBwdGroup;
constexpr int kLruBwdMinCtas = 3;    // CTAs an SM the registers must allow

struct RglruBwdArgs {
  const void* x; const void* a; const float* h0; const void* dy; const float* dhT;
  void* dx; void* da; float* dh0; float* ck;   // ck: (B, stages - 1, C) f32 checkpoints
  int t, c, tile_c, per_tile, stages;
  bool vec;  // x, a, dy, dx, da in whole 16-byte chunks: C and the C tile multiples of one, aligned
};

// one stage of one array, [N][CW]
constexpr int kLruBwdPlane = kLruBwdStageT * kLruBwdCtaC;

template <typename T>
constexpr int lru_bwd_smem_bytes() {
  // the buffers, two f32 planes each (f, then h_{t-1}; g), then the ring
  // of raw x, a and dy
  return kLruBwdBufs * 2 * kLruBwdPlane * (int)sizeof(float) +
         kLruBwdRing * 3 * kLruBwdPlane * (int)sizeof(T);
}

// b = sqrt(max(1 - a^2, 0)) and, with kQ, q = -a / b (0 where 1 - a^2 < 0)
// of K values of a
template <int K, bool kQ>
__device__ __forceinline__ void lru_factors(const float (&a)[K], float (&b)[K], float (&q)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float u = __fsub_rn(1.f, __fmul_rn(a[k], a[k]));
    b[k] = sqrtf(fmaxf(u, 0.f));
    // b'(a) = -a / b: +-inf at b = 0, 0 where the clamp cut 1 - a^2
    if (kQ) q[k] = u < 0.f ? 0.f : __fdiv_rn(-a[k], b[k]);
  }
}

// the loader warps alone (named barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void lru_bwd_loaders_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kLruBwdGroup) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kLruBwdThreads, kLruBwdMinCtas)
rglru_scan_bwd_kernel(RglruBwdArgs g) {
  constexpr int N = kLruBwdStageT, CW = kLruBwdCtaC, P = kLruBwdPlane, R = kLruBwdRing;
  constexpr int kVec = 16 / sizeof(T), kRowChunks = CW / kVec, kChunks = N * kRowChunks;
  constexpr int kGroupWarps = kLruBwdGroup / 32, B = kLruBwdBatch;
  static_assert(R >= 4, "the ring holds the stage stored, the stage in the chains, the stage "
                        "prepared and the one refilled");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bufs = reinterpret_cast<float*>(smem_raw);                // [3][f|h, g][N][CW]
  T* ring = reinterpret_cast<T*>(bufs + kLruBwdBufs * 2 * P);     // [slot][x, a, dy][N][CW]

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
  float* ckb = g.ck + (size_t)blockIdx.y * (g.stages - 1) * g.c + c0;
  const size_t row = (size_t)blockIdx.y * g.c + c0;   // this CTA's channels in (B, C)
  const int warp = (int)threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool h_warp = warp == 0, g_warp = warp == 1;
  const bool storer = warp >= 2 && warp < 2 + kGroupWarps, loader = warp >= 2 + kGroupWarps;
  const int gt_id = ((int)threadIdx.x - 64) % kLruBwdGroup;   // a thread's place in its group
  const int gw = gt_id / 32;                                     // a warp's place in its group

  // The stream of stages: v < S-1 is forward stage v, v >= S-1 reverse stage 2S-2-v.
  const int S = g.stages, V = 2 * S - 1;
  auto reverse = [&](int v) { return v >= S - 1; };
  auto stage_of = [&](int v) { return v < S - 1 ? v : 2 * S - 2 - v; };
  auto tokens = [&](int st) { return min(N, g.t - st * N); };
  auto slot_of = [&](int v) { return ring + (size_t)(v % R) * 3 * P; };
  auto buf_of = [&](int v) { return bufs + (v % kLruBwdBufs) * 2 * P; };

  auto copy = [&](int v) {   // this loader's chunks of stage v's inputs; one commit group per call
    if (v < V) {
      T* s = slot_of(v);
      const int st = stage_of(v), n = tokens(st);
      const bool rev = reverse(v);
      for (int i = gt_id; i < kChunks; i += kLruBwdGroup) {
        const int tt = i / kRowChunks, ch = (i % kRowChunks) * kVec;
        if (tt >= n || ch >= cw) continue;
        const size_t o = (size_t)(st * N + tt) * g.c + c0 + ch;
        const int valid = min(kVec, cw - ch);
        stage16(s + tt * CW + ch, xb + o, valid, g.vec);
        stage16(s + P + tt * CW + ch, ab + o, valid, g.vec);
        if (rev) stage16(s + 2 * P + tt * CW + ch, dyb + o, valid, g.vec);
      }
    }
    cp_async_commit();
  };
  // the state chain's input factor b x of stage v (the forward kernel's),
  // this warp's tokens, a lane per channel (every load before any store:
  // the compiler cannot tell the ring from the buffers, and would otherwise
  // wait out each token's loads in turn)
  auto prepare = [&](int v) {
    constexpr int J = N / kGroupWarps;   // this warp's tokens gw, gw + 4, ...
    const T* s = slot_of(v) + gw * CW + lane;
    float* out = buf_of(v) + gw * CW + lane;
    const int n = tokens(stage_of(v));
    float xv[J], av[J], bv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xv[j] = to_f(s[j * kGroupWarps * CW]);
      av[j] = to_f(s[P + j * kGroupWarps * CW]);
    }
    lru_factors<J, false>(av, bv, bv);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (gw + j * kGroupWarps < n) out[j * kGroupWarps * CW] = __fmul_rn(bv[j], xv[j]);
  };
  // dx and da of reverse stage v, a 16-byte chunk at a time: g and h_{t-1}
  // from the chains, b and x b' from the stage's x and a
  auto store = [&](int v) {
    const T* s = slot_of(v);
    const float* in = buf_of(v);
    const int st = stage_of(v), n = tokens(st);
    for (int i = gt_id; i < kChunks; i += kLruBwdGroup) {
      const int tt = i / kRowChunks, ch = (i % kRowChunks) * kVec;
      if (tt >= n || ch >= cw) continue;
      const int e = tt * CW + ch;
      __align__(16) T xs[kVec], as[kVec], dxs[kVec], das[kVec];
      __align__(16) float hs[kVec], gs[kVec];
      *reinterpret_cast<uint4*>(xs) = *reinterpret_cast<const uint4*>(s + e);
      *reinterpret_cast<uint4*>(as) = *reinterpret_cast<const uint4*>(s + P + e);
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(hs + j) = *reinterpret_cast<const float4*>(in + e + j);
        *reinterpret_cast<float4*>(gs + j) = *reinterpret_cast<const float4*>(in + P + e + j);
      }
      float av[kVec], bv[kVec], qv[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) av[j] = to_f(as[j]);
      lru_factors<kVec, true>(av, bv, qv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float et = __fmul_rn(to_f(xs[j]), qv[j]);
        dxs[j] = from_f<T>(__fmul_rn(gs[j], bv[j]));
        das[j] = from_f<T>(__fmul_rn(gs[j], __fadd_rn(hs[j], et)));
      }
      const size_t o = (size_t)(st * N + tt) * g.c + c0 + ch;
      if (g.vec) {
        *reinterpret_cast<uint4*>(dxb + o) = *reinterpret_cast<const uint4*>(dxs);
        *reinterpret_cast<uint4*>(dab + o) = *reinterpret_cast<const uint4*>(das);
      } else {
        for (int j = 0; j < min(kVec, cw - ch); ++j) {
          dxb[o + j] = dxs[j];
          dab[o + j] = das[j];
        }
      }
    }
  };
  // The state chain over the n tokens of stage v from h, a (ring slot)
  // and f (buffer) read B tokens ahead; with keep, each token's h_{t-1}
  // over its f.
  auto h_chain = [&](int v, int n, float h, bool keep) {
    const T* as = slot_of(v) + P + lane;
    float* fb = buf_of(v) + lane;
    for (int t0 = 0; t0 < n; t0 += B) {
      float af[B], ff[B];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int tt = min(t0 + j, n - 1);
        af[j] = to_f(as[tt * CW]);
        ff[j] = fb[tt * CW];
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        if (t0 + j < n) {
          if (keep) fb[(t0 + j) * CW] = h;
          h = fmaf(af[j], h, ff[j]);
        }
      }
    }
    return h;
  };
  // The gradient chain back through the n tokens of stage v, a and dy from
  // the ring slot, g_t into the buffer.
  auto g_chain = [&](int v, int n, float carry) {
    const T* as = slot_of(v) + P + lane;
    float* gb = buf_of(v) + P + lane;
    for (int t0 = n - 1; t0 >= 0; t0 -= B) {
      float af[B], df[B];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int tt = max(t0 - j, 0);
        af[j] = to_f(as[tt * CW]);
        df[j] = to_f(as[P + tt * CW]);
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        if (t0 - j >= 0) {
          const float gt = __fadd_rn(df[j], carry);
          gb[(t0 - j) * CW] = gt;
          carry = __fmul_rn(af[j], gt);
        }
      }
    }
    return carry;
  };

  // warp 0: h (the forward walk) and the next reverse stage's checkpoint,
  // loaded a stage ahead; warp 1: carry = a_{t+1} g_{t+1}, the final
  // state's gradient at first
  float h = 0.f, h_next = 0.f, carry = 0.f;
  if (h_warp && lane < cw) h = g.h0[row + lane];
  if (g_warp && lane < cw && g.dhT != nullptr) carry = g.dhT[row + lane];
  if (loader) {
#pragma unroll
    for (int v = 0; v < R - 2; ++v) copy(v);
    cp_async_wait<R - 3>();   // this loader's chunks of stage 0
    lru_bwd_loaders_sync();   // everyone's
    prepare(0);
  }
  for (int v = 0; v < V; ++v) {
    __syncthreads();   // stage v is prepared, v-1 through the chains, v-2 stored
    const int st = stage_of(v), n = tokens(st);
    if (h_warp) {
      if (!reverse(v)) {
        // forward stage st (never the last, so never ragged)
        if (lane < cw) ckb[(size_t)st * g.c + lane] = h;
        h = h_chain(v, N, h, false);
      } else {
        // reverse stage st from its first state: the chain's own h (the
        // last stage) or its checkpoint, loaded during the stage before
        const float hh = st < S - 1 ? h_next : h;
        if (st > 0 && lane < cw) h_next = ckb[(size_t)(st - 1) * g.c + lane];
        if (n == N) h_chain(v, N, hh, true);
        else h_chain(v, n, hh, true);
      }
    } else if (g_warp) {
      if (reverse(v)) carry = n == N ? g_chain(v, N, carry) : g_chain(v, n, carry);
    } else if (storer) {
      if (v > 0 && reverse(v - 1)) store(v - 1);
    } else {
      copy(v + R - 2);   // into the slot of stage v-2, stored the iteration before
      if (v + 1 < V) {
        cp_async_wait<R - 3>();   // this loader's chunks of stage v+1
        lru_bwd_loaders_sync();
        prepare(v + 1);
      }
    }
  }
  __syncthreads();
  if (g_warp && lane < cw) g.dh0[row + lane] = carry;
  if (storer) store(V - 1);
  if (loader) cp_async_wait<0>();   // only empty groups remain; leave none in flight
}

// A launch's plan: the one place that knows it; the query entry point reports it.
struct LruBwdPlan {
  int ctas, per_row, stages, smem;
};

// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
int plan_bwd(int b, int t, int c, int dtype, int tile_c, LruBwdPlan& p) {
  if (b <= 0 || b > 65535 || t <= 0 || c <= 0 || tile_c <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const long long per_row = (long long)cdiv(c, tile_c) * cdiv(tile_c < c ? tile_c : c, kLruBwdCtaC);
  if (per_row * b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.per_row = (int)per_row;
  p.ctas = (int)(per_row * b);
  p.stages = cdiv(t, kLruBwdStageT);
  p.smem = dtype == kBFloat16 ? lru_bwd_smem_bytes<__nv_bfloat16>() : lru_bwd_smem_bytes<float>();
  return (int)cudaSuccess;
}

template <typename T>
int allow_smem(int smem) {
  return (int)cudaFuncSetAttribute(rglru_scan_bwd_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// CTAs of the kernel an SM holds at once, from the runtime's occupancy calculator
template <typename T>
int resident_ctas(int smem, int& resident) {
  const int rc = allow_smem<T>(smem);
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, rglru_scan_bwd_kernel<T>,
                                                            kLruBwdThreads, smem);
}

template <typename T>
int launch_bwd(const RglruBwdArgs& g, int b, const LruBwdPlan& p, cudaStream_t stream) {
  const int rc = allow_smem<T>(p.smem);
  if (rc != (int)cudaSuccess) return rc;
  rglru_scan_bwd_kernel<T><<<dim3(p.per_row, b), kLruBwdThreads, p.smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  x/a/dy/dx/da (B,T,C) contiguous, of one
// dtype; h0/dh0 (B,C) f32; dhT (B,C) f32 or null (the final state's
// gradient, 0 where null); ck a (B, ceil(T/32) - 1, C) f32 workspace.  (cta_c,
// stage_t, ctas): the launch layout the wrapper chose (kernels/rglru_scan.py
// bwd_geometry), re-checked here.  Returns a cudaError_t
// (cudaErrorInvalidValue for a layout or shape it does not take).
extern "C" int repro_rglru_scan_bwd(const void* x, const void* a, const void* h0, const void* dy,
                                    const void* dhT, void* dx, void* da, void* dh0, void* ck,
                                    int b, int t, int c, int dtype, int tile_c, int cta_c,
                                    int stage_t, int ctas, void* stream) {
  using namespace repro;
  LruBwdPlan p;
  const int rc = plan_bwd(b, t, c, dtype, tile_c, p);
  if (rc != (int)cudaSuccess) return rc;
  if (cta_c != kLruBwdCtaC || stage_t != kLruBwdStageT || ctas != p.ctas)
    return (int)cudaErrorInvalidValue;
  RglruBwdArgs g;
  g.x = x; g.a = a; g.h0 = static_cast<const float*>(h0); g.dy = dy;
  g.dhT = static_cast<const float*>(dhT);
  g.dx = dx; g.da = da; g.dh0 = static_cast<float*>(dh0); g.ck = static_cast<float*>(ck);
  g.t = t; g.c = c; g.tile_c = tile_c;
  g.per_tile = cdiv(tile_c < c ? tile_c : c, kLruBwdCtaC);
  g.stages = p.stages;
  const int vec_elems = dtype == kBFloat16 ? 8 : 4;
  g.vec = c % vec_elems == 0 && tile_c % vec_elems == 0 && aligned16(x) && aligned16(a) &&
          aligned16(dy) && aligned16(dx) && aligned16(da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_bwd<__nv_bfloat16>(g, b, p, s);
  return launch_bwd<float>(g, b, p, s);
}

// C entry point bound with ctypes: what repro_rglru_scan_bwd would launch
// over (B, T, C) under a C tile in `dtype`, into out[7] = (CTAs, threads a
// CTA, tokens a stage, ring slots, dynamic shared bytes, CTAs resident an
// SM as the runtime's occupancy calculator gives them, checkpoints per
// batch row: one a stage but the last).  Launches nothing.  cudaErrorInvalidValue where
// repro_rglru_scan_bwd would refuse the shape.
extern "C" int repro_rglru_scan_bwd_geometry(int b, int t, int c, int tile_c, int dtype, void* out) {
  using namespace repro;
  LruBwdPlan p;
  int rc = plan_bwd(b, t, c, dtype, tile_c, p);
  if (rc != (int)cudaSuccess) return rc;
  int resident = 0;
  rc = dtype == kBFloat16 ? resident_ctas<__nv_bfloat16>(p.smem, resident)
                          : resident_ctas<float>(p.smem, resident);
  if (rc != (int)cudaSuccess) return rc;
  int* o = static_cast<int*>(out);
  o[0] = p.ctas; o[1] = kLruBwdThreads; o[2] = kLruBwdStageT; o[3] = kLruBwdRing; o[4] = p.smem;
  o[5] = resident; o[6] = p.stages - 1;
  return (int)cudaSuccess;
}
