// RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/rglru_scan.py
// (rglru_scan() / _kernel).  The TPU grid is (B, C blocks, T chunks) with T
// innermost, and each channel block's f32 state row lives in VMEM scratch
// that persists from one time chunk to the next.  Here blocks run in no
// order, so a CTA walks the whole sequence itself.
//
// Per channel, sequential in time, with an f32 state:
//   h = a h + sqrt(max(1 - a^2, 0)) x,   y_t = h rounded to x's dtype
// Channels are independent, so the CTA is decoupled from the schedule's C
// tile: a CTA covers 32 channels of one batch row and never crosses a
// logical C tile's edge (a ragged tile's last CTA covers fewer).  At
// recurrentgemma-2b's 2560 channels under the default 512-channel tile
// that is 80 CTAs per batch row.  Every channel runs the same arithmetic
// whatever the tile, so y and the state are bit-identical across C tiles,
// T tiles and batch sizes, and when a scan is continued from its state.
//
// One warp runs the recurrence, a lane per channel; eight helper warps keep
// it fed.  The helpers stage x and a 64 tokens at a time through a ring of
// 4 cp.async stages, work out (a, sqrt(max(1 - a^2, 0)) x) for the next
// stage while the chain warp runs this one (a lane per channel, a warp per
// token, so shared memory is read and written without bank conflicts), and
// store the last stage's y.  The input factor does not depend on h, so the
// chain warp reads a stage's factors into registers ahead of use and its
// critical path is one FMA per token, h = fma(a, h, f).  The schedule's T
// tile is not used: the stage is fixed, and the TPU chunked time only to
// fit VMEM.
//
// What bounds it: the bytes (x and a read once, y written once, 2-byte
// values for bf16), against ~7 operations per element.
#include "common.cuh"

namespace repro {

constexpr int kLruCtaC = 32;       // channels per CTA: the chain warp's lanes
constexpr int kLruStageT = 64;     // tokens per stage
constexpr int kLruRing = 4;        // stages of x and a in flight
constexpr int kLruBatch = 8;       // tokens the chain warp reads ahead
constexpr int kLruHelpers = 256;   // threads that stage, prepare and store
constexpr int kLruThreads = 32 + kLruHelpers;

struct RglruArgs {
  const void* x; const void* a; const float* h0; void* y; float* hT;
  int t, c, tile_c, per_tile, stages;
  bool vec;  // x, a, y in whole 16-byte chunks: C and the C tile multiples of one, aligned
};

template <typename T>
size_t lru_smem_bytes(int stages) {
  const size_t slots = (size_t)(stages < kLruRing ? stages : kLruRing);
  const size_t stage = (size_t)kLruStageT * kLruCtaC;
  // (a, f) and y double-buffered, then the ring of raw x and a
  return 2 * stage * sizeof(float2) + 2 * stage * sizeof(T) + slots * 2 * stage * sizeof(T);
}

// the helper warps alone (named barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kLruHelpers) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kLruThreads) rglru_scan_kernel(RglruArgs g) {
  constexpr int N = kLruStageT, CW = kLruCtaC, kVec = 16 / sizeof(T);
  constexpr int kChunks = N * CW / kVec;       // 16-byte chunks of x (and of a) per stage
  constexpr int kHelperWarps = kLruHelpers / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* fa = reinterpret_cast<float2*>(smem_raw);   // [2][N][CW]: (a, sqrt(1 - a^2) x)
  T* hb = reinterpret_cast<T*>(fa + 2 * N * CW);     // [2][N][CW]: y
  T* ring = hb + 2 * N * CW;                          // [slot][x, a][N][CW]

  const int tile = blockIdx.x / g.per_tile;
  const int c0 = tile * g.tile_c + (blockIdx.x % g.per_tile) * CW;
  const int cw = min(min(c0 + CW, (tile + 1) * g.tile_c), g.c) - c0;
  if (cw <= 0) return;   // a ragged last tile can leave a CTA no channel
  const size_t base = (size_t)blockIdx.y * g.t * g.c;
  const T* xb = static_cast<const T*>(g.x) + base;
  const T* ab = static_cast<const T*>(g.a) + base;
  T* yb = static_cast<T*>(g.y) + base;
  const int lane = threadIdx.x % 32;            // the channel c0 + lane
  const int hw = (int)threadIdx.x / 32 - 1;     // helper warp; -1: the chain warp


  auto slot_of = [&](int st) { return ring + (size_t)(st % kLruRing) * 2 * N * CW; };
  auto tokens = [&](int st) { return min(N, g.t - st * N); };
  auto copy = [&](int st) {   // this helper's chunks of stage st; one commit group per stage
    if (st < g.stages) {
      T* s = slot_of(st);
      const int n = tokens(st);
      for (int i = (int)threadIdx.x - 32; i < kChunks; i += kLruHelpers) {
        const int tt = i / (CW / kVec), ch = (i % (CW / kVec)) * kVec;
        if (tt >= n || ch >= cw) continue;
        const size_t o = (size_t)(st * N + tt) * g.c + c0 + ch;
        stage16(s + tt * CW + ch, xb + o, min(kVec, cw - ch), g.vec);
        stage16(s + (N + tt) * CW + ch, ab + o, min(kVec, cw - ch), g.vec);
      }
    }
    cp_async_commit();
  };
  auto prepare = [&](int st) {   // (a, f) of stage st, this warp's tokens, a lane per channel
    const T* s = slot_of(st);
    float2* out = fa + (st % 2) * N * CW;
    const int n = tokens(st);
#pragma unroll
    for (int j = 0; j < N / kHelperWarps; ++j) {
      const int tt = hw + j * kHelperWarps;
      if (tt < n) {
        const float at = to_f(s[(N + tt) * CW + lane]);
        const float one_minus = fmaxf(__fsub_rn(1.f, __fmul_rn(at, at)), 0.f);
        out[tt * CW + lane] = make_float2(at, __fmul_rn(sqrtf(one_minus), to_f(s[tt * CW + lane])));
      }
    }
  };
  auto store = [&](int st) {   // y of stage st, this warp's tokens
    const T* s = hb + (st % 2) * N * CW;
    if (lane < cw)
      for (int tt = hw; tt < tokens(st); tt += kHelperWarps)
        yb[(size_t)(st * N + tt) * g.c + c0 + lane] = s[tt * CW + lane];
  };

  float h = 0.f;
  if (hw < 0) {
    if (lane < cw) h = g.h0[(size_t)blockIdx.y * g.c + c0 + lane];
  } else {
#pragma unroll
    for (int st = 0; st < kLruRing; ++st) copy(st);
    cp_async_wait<kLruRing - 1>();   // this helper's chunks of stage 0
    helpers_sync();                  // everyone's
    prepare(0);
  }
  for (int st = 0; st < g.stages; ++st) {
    __syncthreads();   // (a, f) of stage st are in; y of stage st-1 is in
    if (hw < 0) {
      // The chain: one FMA per token.  The stage's (a, f) are read into
      // registers kLruBatch tokens at a time, ahead of the FMAs that use them.
      const float2* in = fa + (st % 2) * N * CW + lane;
      T* out = hb + (st % 2) * N * CW + lane;
      const int n = tokens(st);
      for (int t0 = 0; t0 < n; t0 += kLruBatch) {
        float2 af[kLruBatch];
#pragma unroll
        for (int j = 0; j < kLruBatch; ++j) af[j] = in[min(t0 + j, n - 1) * CW];
#pragma unroll
        for (int j = 0; j < kLruBatch; ++j) {
          if (t0 + j < n) {
            h = fmaf(af[j].x, h, af[j].y);
            out[(t0 + j) * CW] = from_f<T>(h);
          }
        }
      }
    } else {
      if (st > 0) store(st - 1);
      // the slot of stage st was read by prepare(st), before this iteration's barrier
      copy(st + kLruRing);
      if (st + 1 < g.stages) {
        cp_async_wait<kLruRing - 1>();   // this helper's chunks of stage st+1
        helpers_sync();
        prepare(st + 1);
      }
    }
  }
  __syncthreads();
  if (hw < 0) {
    if (lane < cw) g.hT[(size_t)blockIdx.y * g.c + c0 + lane] = h;
  } else {
    store(g.stages - 1);
    cp_async_wait<0>();   // only empty groups remain; leave none in flight
  }
}

template <typename T>
int launch(const RglruArgs& g, int b, int ctas_per_row, cudaStream_t stream) {
  const size_t smem = lru_smem_bytes<T>(g.stages);
  const cudaError_t err = cudaFuncSetAttribute(rglru_scan_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rglru_scan_kernel<T><<<dim3(ctas_per_row, b), kLruThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  x/a/y (B,T,C) contiguous, of one dtype;
// h0/hT (B,C) f32 contiguous.  (cta_c, stage_t, ctas): the launch layout the
// wrapper chose (kernels/rglru_scan.py scan_geometry), re-checked here.
// tile_t, the schedule's T tile, is checked but changes nothing.  Returns
// a cudaError_t (cudaErrorInvalidValue for a layout or shape it does not
// take).
extern "C" int repro_rglru_scan(const void* x, const void* a, const void* h0, void* y,
                                void* hT, int b, int t, int c, int dtype, int tile_t, int tile_c,
                                int cta_c, int stage_t, int ctas, void* stream) {
  using namespace repro;
  if (b <= 0 || b > 65535 || t <= 0 || c <= 0 || tile_t <= 0 || tile_c <= 0)
    return (int)cudaErrorInvalidValue;
  if (cta_c != kLruCtaC || stage_t != kLruStageT) return (int)cudaErrorInvalidValue;
  RglruArgs g;
  g.x = x; g.a = a; g.h0 = static_cast<const float*>(h0); g.y = y;
  g.hT = static_cast<float*>(hT);
  g.t = t; g.c = c; g.tile_c = tile_c;
  g.per_tile = cdiv(tile_c < c ? tile_c : c, kLruCtaC);
  g.stages = cdiv(t, kLruStageT);
  const long long per_row = (long long)cdiv(c, tile_c) * g.per_tile;
  if (per_row * b != ctas || per_row > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec_elems = dtype == kBFloat16 ? 8 : 4;
  g.vec = c % vec_elems == 0 && tile_c % vec_elems == 0 && aligned16(x) && aligned16(a) &&
          aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(g, b, (int)per_row, s);
  if (dtype == kFloat32) return launch<float>(g, b, (int)per_row, s);
  return (int)cudaErrorInvalidValue;
}
