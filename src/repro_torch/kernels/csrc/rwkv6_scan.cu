// wkv6 recurrence (RWKV6 / Finch time-mix) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/rwkv6_scan.py
// (rwkv6_scan() / _kernel).  The TPU grid is (B*H, T chunks) with T
// innermost, and the D x D f32 state lives in VMEM scratch that persists
// from one time chunk to the next.  Here blocks run in no order, so a CTA
// walks the whole sequence itself; that loop takes the place of the
// sequential grid axis.
//
// Per token, in the order _kernel computes it, for key row i and value
// column j of one (b, h):
//   kv_ij = k_i v_j;   y_j = sum_i r_i (S_ij + u_i kv_ij);   S_ij = w_i S_ij + kv_ij
// Column j of the state evolves with v_j alone, so the state is split over
// CTAs by value columns: one CTA per (b, h, 16 columns), 4 per head at
// D = 64 (128 CTAs at rwkv6-1.6b's prefill, 512 at its 4-slot decode).
// Inside a CTA each thread keeps 8 key rows of one column in registers, so
// D/8 threads share a column, each summing its rows' share of y_j.  A
// token's state update is then one FMA per element and independent of y;
// the shares land in shared memory and are added in row-block order while
// the next stage is computed.  That order depends on D alone, never on T,
// the T tile, B or the CTA count, so y and the state are bit-identical
// across T tiles, across batch sizes and when a scan is split and
// continued from its returned state.
//
// r, k, w and v of 32 tokens are four contiguous blocks, which the copy
// engine stages (cp.async.bulk, completion on an mbarrier) at one thread's
// request, into a ring of 3 stages; bf16 stays bf16 in shared memory and is
// widened in registers.  One barrier per stage; each token's operands are
// read while the previous token is computed.  The schedule's T tile is a
// logical boundary only: it changes neither the arithmetic nor the
// staging, so a T tile of 1 (prime lengths under the default schedule)
// runs as fast as a tile of T.
//
// What bounds it: the operations, 7 f32 operations per state element per
// token on CUDA cores (no matrix product to give the tensor cores), against
// bytes of only 4 D-vectors per token plus the state read and written once.
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kWkvStageT = 32;   // tokens per stage
constexpr int kWkvRing = 3;      // stages in flight
constexpr int kWkvRows = 8;      // key rows per thread
constexpr int kWkvCtaCols = 16;  // value columns per CTA, one per thread of a row block

template <int D>
struct WkvLayout {
  static constexpr int kSplit = D / kWkvRows;        // threads sharing a value column
  static constexpr int kThreads = kSplit * kWkvCtaCols;
  static constexpr int kBlocks = D / kWkvCtaCols;    // CTAs per (b, h)
  // partial sums of y per token [row block][column], padded against bank conflicts
  static constexpr int kYStride = kSplit * kWkvCtaCols + 16;
};

// Shared memory: the ring of stages (r, k, w, v, each [ns][D] in the input
// dtype), the partial sums of y twice, then one mbarrier per ring slot.
// Sized by the stage's token count ns = min(32, T), so a decode step
// takes little.
template <typename T, int D>
__host__ __device__ size_t wkv_ring_bytes(int ns, int stages) {
  return (size_t)(stages < kWkvRing ? stages : kWkvRing) * 4 * ns * D * sizeof(T);
}
template <typename T, int D>
size_t wkv_smem_bytes(int ns, int stages) {
  return wkv_ring_bytes<T, D>(ns, stages) + 2 * (size_t)ns * WkvLayout<D>::kYStride * sizeof(float) +
         kWkvRing * sizeof(uint64_t);
}

struct Rwkv6Args {
  const void* r; const void* k; const void* v; const void* w;
  const float* u; const float* s0; void* y; float* sT;
  int h, t, ns, stages;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine; completion is counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// n consecutive values of shared memory into f32 registers (n = 4 or 8)
template <int n>
__device__ __forceinline__ void ldn(float (&o)[n], const float* p) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
  }
}
template <int n>
__device__ __forceinline__ void ldn(float (&o)[n], const __nv_bfloat16* p) {
  uint32_t w[n / 2];   // a bf16 is the high half of an f32
  if constexpr (n == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(WkvLayout<D>::kThreads) rwkv6_scan_kernel(Rwkv6Args a) {
  using L = WkvLayout<D>;
  constexpr int N = kWkvStageT, CB = kWkvCtaCols, R = kWkvRows;

  const int ns = a.ns;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* ypart = reinterpret_cast<float*>(smem_raw + wkv_ring_bytes<T, D>(ns, a.stages));
  const uint32_t bars = smem_addr(ypart + 2 * ns * L::kYStride);

  const int bh = blockIdx.x / L::kBlocks;
  const int j0 = (blockIdx.x % L::kBlocks) * CB;
  const int tid = threadIdx.x;
  const int rb = tid / CB;   // row block: key rows rb*R .. rb*R + R-1
  const int c = tid % CB;    // value column j0 + c
  const size_t base = (size_t)bh * a.t * D;
  T* yb = static_cast<T*>(a.y) + base;

  float uu[R], S[R];
  const float* s0 = a.s0 + (size_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    uu[q] = a.u[(size_t)(bh % a.h) * D + rb * R + q];
    S[q] = s0[(rb * R + q) * D + j0 + c];
  }

  if (tid == 0) {
    for (int i = 0; i < kWkvRing; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto tokens = [&](int st) { return min(N, a.t - st * N); };
  auto slot_of = [&](int st) { return ring + (size_t)(st % kWkvRing) * 4 * ns * D; };
  // stage st into its ring slot: r, k, w and v of its tokens, four
  // contiguous blocks, copied by the copy engine at one thread's request
  auto issue = [&](int st) {
    if (tid == 0 && st < a.stages) {
      const uint32_t bytes = tokens(st) * D * sizeof(T), bar = bars + 8 * (st % kWkvRing);
      const size_t o = base + (size_t)st * N * D;
      T* slot = slot_of(st);
      mbar_expect_tx(bar, 4 * bytes);
      bulk_copy(smem_addr(slot), static_cast<const T*>(a.r) + o, bytes, bar);
      bulk_copy(smem_addr(slot + ns * D), static_cast<const T*>(a.k) + o, bytes, bar);
      bulk_copy(smem_addr(slot + 2 * ns * D), static_cast<const T*>(a.w) + o, bytes, bar);
      bulk_copy(smem_addr(slot + 3 * ns * D), static_cast<const T*>(a.v) + o, bytes, bar);
    }
  };
  // y of stage st: the row blocks' shares summed in row-block order
  auto reduce = [&](int st) {
    const float* part = ypart + (st % 2) * ns * L::kYStride;
    for (int it = tid; it < tokens(st) * CB / 2; it += L::kThreads) {
      const int tt = it / (CB / 2), c2 = 2 * (it % (CB / 2));
      const float* p = part + tt * L::kYStride + c2;
      float2 acc = *reinterpret_cast<const float2*>(p);
#pragma unroll
      for (int blk = 1; blk < L::kSplit; ++blk) {
        const float2 sh = *reinterpret_cast<const float2*>(p + blk * CB);
        acc.x += sh.x;
        acc.y += sh.y;
      }
      T* o = yb + (size_t)(st * N + tt) * D + j0 + c2;
      o[0] = from_f<T>(acc.x);
      o[1] = from_f<T>(acc.y);
    }
  };

#pragma unroll
  for (int st = 0; st < kWkvRing - 1; ++st) issue(st);
  for (int st = 0; st < a.stages; ++st) {
    mbar_wait(bars + 8 * (st % kWkvRing), (st / kWkvRing) & 1);   // stage st has landed
    // Stage st-1 is computed by every thread, so its slot is free for the
    // copy engine and its partial sums are complete.
    __syncthreads();
    issue(st + kWkvRing - 1);
    if (st > 0) reduce(st - 1);

    // Per token: the state update (one FMA per element) and this row
    // block's share of y; the next token's operands are read while this
    // one is computed.
    const int n = tokens(st);
    const T* in = slot_of(st);
    const T* rp = in + rb * R;
    const T* kp = in + ns * D + rb * R;
    const T* wp = in + 2 * ns * D + rb * R;
    const T* vp = in + 3 * ns * D + j0 + c;
    float* yp = ypart + (st % 2) * ns * L::kYStride + rb * CB + c;
    float rr[R], kk[R], ww[R];
    ldn(rr, rp);
    ldn(kk, kp);
    ldn(ww, wp);
    float vv = to_f(*vp);
    for (int tt = 0; tt < n; ++tt) {
      const int tn = min(tt + 1, n - 1);
      float rn[R], kn[R], wn[R];
      ldn(rn, rp + tn * D);
      ldn(kn, kp + tn * D);
      ldn(wn, wp + tn * D);
      const float vn = to_f(vp[tn * D]);
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float kv = __fmul_rn(kk[q], vv);
        y = fmaf(rr[q], fmaf(uu[q], kv, S[q]), y);
        S[q] = fmaf(ww[q], S[q], kv);
      }
      yp[tt * L::kYStride] = y;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        rr[q] = rn[q];
        kk[q] = kn[q];
        ww[q] = wn[q];
      }
      vv = vn;
    }
  }
  __syncthreads();
  reduce(a.stages - 1);

  float* sT = a.sT + (size_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < R; ++q) sT[(rb * R + q) * D + j0 + c] = S[q];
}

template <typename T, int D>
int launch(const Rwkv6Args& a, int ctas, cudaStream_t stream) {
  const size_t smem = wkv_smem_bytes<T, D>(a.ns, a.stages);
  const cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel<T, D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_kernel<T, D><<<ctas, WkvLayout<D>::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Rwkv6Args& a, int d, int ctas, cudaStream_t s) {
  if (d == 16) return launch<T, 16>(a, ctas, s);
  if (d == 32) return launch<T, 32>(a, ctas, s);
  if (d == 64) return launch<T, 64>(a, ctas, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// C entry point bound with ctypes.  r/k/v/w/y (B,H,T,D) contiguous, of one
// dtype; u (H,D), s0/sT (B,H,D,D) f32 contiguous.  (cta_cols, split,
// stage_t, ctas): the launch layout the wrapper chose (kernels/rwkv6_scan.py
// scan_geometry), re-checked here.  tile_t, the schedule's T tile, is
// checked but changes nothing.  Returns a cudaError_t
// (cudaErrorInvalidValue for a layout or shape it does not take,
// cudaErrorMisalignedAddress for r, k, v or w not 16-byte aligned).
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* s0, void* y, void* sT,
                                int b, int h, int t, int d, int dtype, int tile_t,
                                int cta_cols, int split, int stage_t, int ctas, void* stream) {
  using namespace repro;
  if (b <= 0 || h <= 0 || t <= 0 || tile_t <= 0) return (int)cudaErrorInvalidValue;
  if (d != 16 && d != 32 && d != 64) return (int)cudaErrorInvalidValue;
  if (cta_cols != kWkvCtaCols || split != d / kWkvRows || stage_t != kWkvStageT)
    return (int)cudaErrorInvalidValue;
  const long long want = (long long)b * h * (d / kWkvCtaCols);
  if (want != ctas || want > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Rwkv6Args a;
  a.r = r; a.k = k; a.v = v; a.w = w;
  a.u = static_cast<const float*>(u); a.s0 = static_cast<const float*>(s0);
  a.y = y; a.sT = static_cast<float*>(sT);
  a.h = h; a.t = t; a.ns = t < kWkvStageT ? t : kWkvStageT; a.stages = cdiv(t, kWkvStageT);
  // the copy engine reads 16-byte-aligned blocks
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w))) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch_d<__nv_bfloat16>(a, d, ctas, s);
  if (dtype == kFloat32) return dispatch_d<float>(a, d, ctas, s);
  return (int)cudaErrorInvalidValue;
}
