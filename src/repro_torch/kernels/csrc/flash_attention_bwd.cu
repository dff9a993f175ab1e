// Backward of the GQA flash attention for Hopper (sm_90a): dQ, dK and dV.
//
// The reference has no Pallas backward: jax.value_and_grad differentiates
// its attention (src/repro/kernels/flash_attention.py, flash_attention() /
// _kernel, on the default "ref" backend) through XLA.  In the port a CUDA
// tensor never takes a plain version, so the gradient of every K2 launch of
// a training step comes from this kernel.
//
// What it computes, for what the forward takes in training: causal and
// non-causal, a sliding window, softcap (tanh(s / c) * c, its derivative
// 1 - tanh^2 inside the softmax's), GQA (dK and dV summed over the query
// heads of a group), head dims up to 256, bf16 and f32, q_offset 0.  With
// s = scale * q.k, t = softcap(s), P = softmax_masked(t), O = P V:
//   dV = P^T dO,  dP = dO V^T,  dT = P * (dP - rowsum(dO * O)),
//   dS = dT * (1 - tanh^2) (softcap), dQ = scale * dS K,  dK = scale * dS^T Q.
// Products and sums in f32, one rounding to the output dtype.
//
// Design (simple first; tensor cores and TMA come later):
//  * dq kernel: a CTA of 8 warps per (b, hq, 16 query rows), each warp
//    holding 2 rows (q, dO, the dQ accumulator: 8 values a lane at D = 256).
//    K and V stream through shared memory in chunks of 32 keys over the
//    rows' live key range.  Pass 1 computes each row's log-sum-exp (online,
//    one exp per lane per chunk: key j's score lands in lane j), pass 2
//    recomputes the scores, forms dS and accumulates dQ.  It writes the
//    row's log-sum-exp and D = rowsum(dO * O) for the second kernel.
//  * dkv kernel: a CTA of 8 warps per (b, hkv, 16 keys), each warp holding 2
//    keys (k, v and the dK, dV accumulators).  It loops over the query heads
//    of the group and, for each, streams the live query rows (q, dO, their
//    log-sum-exp and D) through shared memory in chunks of 32 rows.  The
//    group's sum stays in registers: no atomics, no second pass.
// Dot products are warp reductions (a lane holds D / 32 contiguous values);
// every CTA skips the chunks its rows or keys all mask.
//
// What bounds it: at gemma2-2b's training shape (4 x 8/4 x 512 x 256) the
// operations, about 2.5x the forward's (five products of Sq x Skv x D
// against two), halved by the causal skip; on the CUDA cores in f32, with
// the shuffles of the reductions, it runs far from that bound.
#include <math.h>

#include "common.cuh"

namespace repro {

constexpr int kBwdWarps = 8;
constexpr int kBwdPerWarp = 2;                      // rows (dq) or keys (dkv) of one warp
constexpr int kBwdPerCta = kBwdWarps * kBwdPerWarp; // 16
constexpr int kBwdChunk = 32;                       // keys (dq) or query rows (dkv) staged at once
constexpr float kBwdNegInf = -1e30f;

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  void* dq; void* dk; void* dv;
  float* lse; float* delta;  // (B*Hq*Sq) f32 scratch: written by the dq kernel, read by dkv
  int b, hq, hkv, sq, skv, d;
  int causal, window; float softcap; float scale;
};

__device__ __forceinline__ bool bwd_ok(const BwdArgs& a, int q_pos, int kv_pos) {
  bool ok = kv_pos < a.skv && q_pos < a.sq;
  if (a.causal) ok = ok && kv_pos <= q_pos;
  if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
  return ok;
}

__device__ __forceinline__ float bwd_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float bwd_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// one row's VPL values of this lane (d = lane * VPL + i), zeros past D
template <typename T, int VPL>
__device__ __forceinline__ void load_row(float (&r)[VPL], const T* src, int lane, int D) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane * VPL + i;
    r[i] = d < D ? to_f(src[d]) : 0.f;
  }
}

template <typename T, int VPL>
__device__ __forceinline__ void store_row(T* dst, const float (&r)[VPL], int lane, int D) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane * VPL + i;
    if (d < D) dst[d] = from_f<T>(r[i]);
  }
}

template <int VPL>
__device__ __forceinline__ float dot_part(const float (&a)[VPL], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// Stages `rows` rows of a (.., D) tensor from `src` (row `first`) into f32
// shared memory [kBwdChunk][DP], zeros past D and past `limit` rows.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int first, int limit, int D) {
  for (int i = threadIdx.x; i < kBwdChunk * DP; i += blockDim.x) {
    const int r = i / DP, d = i % DP;
    const int row = first + r;
    dst[i] = (row < limit && d < D) ? to_f(src[(size_t)row * D + d]) : 0.f;
  }
}

// The softcapped score and the factor its derivative takes: (t, dt/ds).
__device__ __forceinline__ void bwd_cap(float s, float softcap, float& t, float& dcap) {
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    t = th * softcap;
    dcap = 1.f - th * th;
  } else {
    t = s;
    dcap = 1.f;
  }
}

// ---------------------------------------------------------------------------
// dq kernel: grid (ceil(Sq / 16), B * Hq)
// ---------------------------------------------------------------------------
template <typename T, int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32) attention_bwd_dq_kernel(BwdArgs a) {
  constexpr int DP = 32 * VPL;
  extern __shared__ float bwd_smem[];
  float* Ks = bwd_smem;                 // [kBwdChunk][DP]
  float* Vs = Ks + kBwdChunk * DP;      // [kBwdChunk][DP]

  const int D = a.d;
  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int kvh = b * a.hkv + h / (a.hq / a.hkv);
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.sq * D;
  const T* ob = static_cast<const T*>(a.o) + (size_t)bh * a.sq * D;
  const T* gb = static_cast<const T*>(a.dout) + (size_t)bh * a.sq * D;
  T* dqb = static_cast<T*>(a.dq) + (size_t)bh * a.sq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)kvh * a.skv * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)kvh * a.skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int cta_first = blockIdx.x * kBwdPerCta;
  const int cta_last = min(cta_first + kBwdPerCta, a.sq) - 1;
  int kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, cta_last + 1);
  int kv_begin = a.window > 0 ? max(0, cta_first - a.window + 1) : 0;
  kv_begin = (kv_begin / kBwdChunk) * kBwdChunk;

  float q[kBwdPerWarp][VPL], g[kBwdPerWarp][VPL], dq[kBwdPerWarp][VPL];
  float delta[kBwdPerWarp], m[kBwdPerWarp], l[kBwdPerWarp], lse[kBwdPerWarp];
  int row[kBwdPerWarp];
#pragma unroll
  for (int r = 0; r < kBwdPerWarp; ++r) {
    row[r] = cta_first + warp * kBwdPerWarp + r;
    const bool in = row[r] < a.sq;
    float o[VPL];
    if (in) {
      load_row<T, VPL>(q[r], qb + (size_t)row[r] * D, lane, D);
      load_row<T, VPL>(g[r], gb + (size_t)row[r] * D, lane, D);
      load_row<T, VPL>(o, ob + (size_t)row[r] * D, lane, D);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) q[r][i] = g[r][i] = o[i] = 0.f;
    }
    delta[r] = bwd_warp_sum(dot_part<VPL>(g[r], o));
#pragma unroll
    for (int i = 0; i < VPL; ++i) dq[r][i] = 0.f;
    m[r] = kBwdNegInf;
    l[r] = 0.f;
  }

  // pass 1: each row's log-sum-exp over its live keys
  for (int c0 = kv_begin; c0 < kv_end; c0 += kBwdChunk) {
    __syncthreads();
    stage_rows<T, DP>(Ks, kb, c0, a.skv, D);
    __syncthreads();
    float mine[kBwdPerWarp];
#pragma unroll
    for (int r = 0; r < kBwdPerWarp; ++r) mine[r] = 0.f;
    for (int j = 0; j < kBwdChunk; ++j) {
      float kv[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) kv[i] = Ks[j * DP + lane * VPL + i];
#pragma unroll
      for (int r = 0; r < kBwdPerWarp; ++r) {
        const float s = bwd_warp_sum(dot_part<VPL>(q[r], kv));
        if (lane == j) mine[r] = s;
      }
    }
    const int kv_pos = c0 + lane;
#pragma unroll
    for (int r = 0; r < kBwdPerWarp; ++r) {
      float t, dcap;
      bwd_cap(mine[r] * a.scale, a.softcap, t, dcap);
      const bool ok = bwd_ok(a, row[r], kv_pos);
      const float sv = ok ? t : kBwdNegInf;
      const float m_new = fmaxf(m[r], bwd_warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + bwd_warp_sum(p);
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < kBwdPerWarp; ++r) lse[r] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;

  // pass 2: dS and dQ
  for (int c0 = kv_begin; c0 < kv_end; c0 += kBwdChunk) {
    __syncthreads();
    stage_rows<T, DP>(Ks, kb, c0, a.skv, D);
    stage_rows<T, DP>(Vs, vb, c0, a.skv, D);
    __syncthreads();
    float s_mine[kBwdPerWarp], dp_mine[kBwdPerWarp];
#pragma unroll
    for (int r = 0; r < kBwdPerWarp; ++r) s_mine[r] = dp_mine[r] = 0.f;
    for (int j = 0; j < kBwdChunk; ++j) {
      float kv[VPL], vv[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        kv[i] = Ks[j * DP + lane * VPL + i];
        vv[i] = Vs[j * DP + lane * VPL + i];
      }
#pragma unroll
      for (int r = 0; r < kBwdPerWarp; ++r) {
        const float s = bwd_warp_sum(dot_part<VPL>(q[r], kv));
        const float dp = bwd_warp_sum(dot_part<VPL>(g[r], vv));
        if (lane == j) { s_mine[r] = s; dp_mine[r] = dp; }
      }
    }
    const int kv_pos = c0 + lane;
    float ds[kBwdPerWarp];
#pragma unroll
    for (int r = 0; r < kBwdPerWarp; ++r) {
      float t, dcap;
      bwd_cap(s_mine[r] * a.scale, a.softcap, t, dcap);
      const bool ok = bwd_ok(a, row[r], kv_pos);
      const float p = ok ? expf(t - lse[r]) : 0.f;
      ds[r] = p * (dp_mine[r] - delta[r]) * dcap * a.scale;
    }
    for (int j = 0; j < kBwdChunk; ++j) {
      float kv[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) kv[i] = Ks[j * DP + lane * VPL + i];
#pragma unroll
      for (int r = 0; r < kBwdPerWarp; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int i = 0; i < VPL; ++i) dq[r][i] = fmaf(dsj, kv[i], dq[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kBwdPerWarp; ++r) {
    if (row[r] >= a.sq) continue;
    store_row<T, VPL>(dqb + (size_t)row[r] * D, dq[r], lane, D);
    if (lane == 0) {
      a.lse[(size_t)bh * a.sq + row[r]] = lse[r];
      a.delta[(size_t)bh * a.sq + row[r]] = delta[r];
    }
  }
}

// ---------------------------------------------------------------------------
// dkv kernel: grid (ceil(Skv / 16), B * Hkv)
// ---------------------------------------------------------------------------
template <typename T, int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32) attention_bwd_dkv_kernel(BwdArgs a) {
  constexpr int DP = 32 * VPL;
  extern __shared__ float bwd_smem[];
  float* Qs = bwd_smem;                  // [kBwdChunk][DP]
  float* Gs = Qs + kBwdChunk * DP;       // [kBwdChunk][DP] dO
  float* Ls = Gs + kBwdChunk * DP;       // [kBwdChunk] log-sum-exp
  float* Ds = Ls + kBwdChunk;            // [kBwdChunk] rowsum(dO * O)

  const int D = a.d;
  const int bkv = blockIdx.y;
  const int b = bkv / a.hkv, hk = bkv % a.hkv;
  const int group = a.hq / a.hkv;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bkv * a.skv * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bkv * a.skv * D;
  T* dkb = static_cast<T*>(a.dk) + (size_t)bkv * a.skv * D;
  T* dvb = static_cast<T*>(a.dv) + (size_t)bkv * a.skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int cta_first = blockIdx.x * kBwdPerCta;
  const int cta_last = min(cta_first + kBwdPerCta, a.skv) - 1;
  int q_begin = a.causal ? cta_first : 0;
  q_begin = (q_begin / kBwdChunk) * kBwdChunk;
  const int q_end = a.window > 0 ? min(a.sq, cta_last + a.window) : a.sq;

  float k[kBwdPerWarp][VPL], v[kBwdPerWarp][VPL], dk[kBwdPerWarp][VPL], dv[kBwdPerWarp][VPL];
  int key[kBwdPerWarp];
#pragma unroll
  for (int r = 0; r < kBwdPerWarp; ++r) {
    key[r] = cta_first + warp * kBwdPerWarp + r;
    if (key[r] < a.skv) {
      load_row<T, VPL>(k[r], kb + (size_t)key[r] * D, lane, D);
      load_row<T, VPL>(v[r], vb + (size_t)key[r] * D, lane, D);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) k[r][i] = v[r][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) dk[r][i] = dv[r][i] = 0.f;
  }

  for (int gh = 0; gh < group; ++gh) {
    const int bh = b * a.hq + hk * group + gh;
    const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.sq * D;
    const T* gb = static_cast<const T*>(a.dout) + (size_t)bh * a.sq * D;
    const float* lb = a.lse + (size_t)bh * a.sq;
    const float* db = a.delta + (size_t)bh * a.sq;
    for (int c0 = q_begin; c0 < q_end; c0 += kBwdChunk) {
      __syncthreads();
      stage_rows<T, DP>(Qs, qb, c0, a.sq, D);
      stage_rows<T, DP>(Gs, gb, c0, a.sq, D);
      if (threadIdx.x < kBwdChunk) {
        const int qr = c0 + threadIdx.x;
        Ls[threadIdx.x] = qr < a.sq ? lb[qr] : INFINITY;
        Ds[threadIdx.x] = qr < a.sq ? db[qr] : 0.f;
      }
      __syncthreads();
      float s_mine[kBwdPerWarp], dp_mine[kBwdPerWarp];
#pragma unroll
      for (int r = 0; r < kBwdPerWarp; ++r) s_mine[r] = dp_mine[r] = 0.f;
      for (int i = 0; i < kBwdChunk; ++i) {
        float qv[VPL], gv[VPL];
#pragma unroll
        for (int e = 0; e < VPL; ++e) {
          qv[e] = Qs[i * DP + lane * VPL + e];
          gv[e] = Gs[i * DP + lane * VPL + e];
        }
#pragma unroll
        for (int r = 0; r < kBwdPerWarp; ++r) {
          const float s = bwd_warp_sum(dot_part<VPL>(k[r], qv));
          const float dp = bwd_warp_sum(dot_part<VPL>(v[r], gv));
          if (lane == i) { s_mine[r] = s; dp_mine[r] = dp; }
        }
      }
      // lane i: query row c0 + i against each of the warp's keys
      const int q_pos = c0 + lane;
      float p[kBwdPerWarp], ds[kBwdPerWarp];
#pragma unroll
      for (int r = 0; r < kBwdPerWarp; ++r) {
        float t, dcap;
        bwd_cap(s_mine[r] * a.scale, a.softcap, t, dcap);
        const bool ok = bwd_ok(a, q_pos, key[r]);
        p[r] = ok ? expf(t - Ls[lane]) : 0.f;
        ds[r] = p[r] * (dp_mine[r] - Ds[lane]) * dcap * a.scale;
      }
      for (int i = 0; i < kBwdChunk; ++i) {
        float qv[VPL], gv[VPL];
#pragma unroll
        for (int e = 0; e < VPL; ++e) {
          qv[e] = Qs[i * DP + lane * VPL + e];
          gv[e] = Gs[i * DP + lane * VPL + e];
        }
#pragma unroll
        for (int r = 0; r < kBwdPerWarp; ++r) {
          const float pi = __shfl_sync(0xffffffffu, p[r], i);
          const float dsi = __shfl_sync(0xffffffffu, ds[r], i);
#pragma unroll
          for (int e = 0; e < VPL; ++e) {
            dv[r][e] = fmaf(pi, gv[e], dv[r][e]);
            dk[r][e] = fmaf(dsi, qv[e], dk[r][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kBwdPerWarp; ++r) {
    if (key[r] >= a.skv) continue;
    store_row<T, VPL>(dkb + (size_t)key[r] * D, dk[r], lane, D);
    store_row<T, VPL>(dvb + (size_t)key[r] * D, dv[r], lane, D);
  }
}

template <typename T, int VPL>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int DP = 32 * VPL;
  const int dq_smem = 2 * kBwdChunk * DP * (int)sizeof(float);
  const int dkv_smem = (2 * kBwdChunk * DP + 2 * kBwdChunk) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, VPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, VPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<T, VPL><<<dim3(cdiv(a.sq, kBwdPerCta), a.b * a.hq), kBwdWarps * 32,
                                    dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<T, VPL><<<dim3(cdiv(a.skv, kBwdPerCta), a.b * a.hkv), kBwdWarps * 32,
                                     dkv_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dtype(const BwdArgs& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_bwd<T, 1>(a, stream);
  if (a.d <= 64) return launch_bwd<T, 2>(a, stream);
  if (a.d <= 128) return launch_bwd<T, 4>(a, stream);
  return launch_bwd<T, 8>(a, stream);
}

}  // namespace repro

// C entry point bound with ctypes.  q, o, dout, dq (B,Hq,Sq,D); k, v, dk, dv
// (B,Hkv,Skv,D); all contiguous and of one dtype.  lse and delta: f32
// scratch of B*Hq*Sq floats.  Launches the dq kernel, then the dkv kernel,
// on `stream`.  Returns a cudaError_t (cudaErrorInvalidValue for arguments
// the kernels do not take).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int b, int hq, int hkv,
                                         int sq, int skv, int d, int dtype, int causal, int window,
                                         float softcap, float scale, void* stream) {
  using namespace repro;
  if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d > 256 || hq % hkv) return (int)cudaErrorInvalidValue;
  if ((long long)b * hq > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = static_cast<float*>(lse); a.delta = static_cast<float*>(delta);
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.d = d;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_bwd_dtype<__nv_bfloat16>(a, s);
  if (dtype == kFloat32) return launch_bwd_dtype<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
