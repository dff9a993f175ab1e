// Online-softmax GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention() / _kernel).  The TPU grid walks (B*Hq, Q tiles, KV tiles)
// in order and carries the f32 softmax state (m, l, acc) in VMEM from one KV
// step to the next.  Here blocks run in no order, so one CTA owns one
// (b*hq, q tile) pair and loops over the KV range itself, keeping m and l in
// registers (one row per warp lane group) and acc in registers (lanes over D).
//
// The schedule's Q tile is the CTA's logical tile; the CTA walks it in
// sub-blocks of 32 query rows.  KV is consumed in chunks of 32 keys, one key
// per lane, so the row max and row sum are warp shuffles.  Chunks that every
// row of a sub-block masks (beyond the causal frontier, outside the window)
// are skipped: a skipped chunk would leave (m, l, acc) unchanged, so the skip
// granularity does not change the result.
//
// What _kernel computes, kept exactly:
//  * q is scaled in f32 before the dot;
//  * softcap (tanh(s / c) * c) comes before the mask;
//  * masked scores are the finite NEG_INF = -1e30, and p is re-zeroed under
//    the mask after the exp (a fully masked row stays at acc = 0, l = 0);
//  * l is clamped at 1e-30 before the division;
//  * the kv head of query head h is h / (Hq / Hkv).
//
// Any head dim up to 256 runs: the kernel is compiled for padded widths
// DP = 32, 64, 128 (minitron) and 256 (gemma2), and a smaller D is zero-padded
// to the next of them in shared memory.  At S <= 512 the bytes of q, k, v
// and o bound it, the operations (growing as S^2) for longer prompts;
// CUDA-core FMA on f32 copies of q, k and v in shared memory, no tensor
// cores yet.
#include "common.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 32, kBKV = 32, kWarps = 4, kRowsPerWarp = kBQ / kWarps;

struct AttnArgs {
  const void* q; const void* k; const void* v; void* o;
  int hq, hkv, sq, skv, d;
  int causal, window; float softcap; int q_offset; float scale;
  int tile_q;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DP>
constexpr int attn_smem_floats() {
  return kBQ * DP + kBKV * (DP + 1) + kBKV * DP + kBQ * kBKV;
}

// DP: the padded head dim the CTA works in (a multiple of 32, >= a.d).
template <typename T, int DP>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_kernel(AttnArgs a) {
  constexpr int NDV = DP / 32;  // head-dim values per lane
  const int D = a.d;            // the tensors' head dim; columns D..DP-1 are zero
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][DP], pre-scaled
  float* Ks = Qs + kBQ * DP;           // [kBKV][DP + 1], padded against bank conflicts
  float* Vs = Ks + kBKV * (DP + 1);    // [kBKV][DP]
  float* Ps = Vs + kBKV * DP;          // [kBQ][kBKV]

  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int kvh = b * a.hkv + h / (a.hq / a.hkv);
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.sq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)kvh * a.skv * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)kvh * a.skv * D;
  T* ob = static_cast<T*>(a.o) + (size_t)bh * a.sq * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int t0 = blockIdx.x * a.tile_q, t1 = min(t0 + a.tile_q, a.sq);
  for (int s0 = t0; s0 < t1; s0 += kBQ) {
    const int nq = min(kBQ, t1 - s0);
    __syncthreads();  // every warp is done with the previous sub-block's Qs
    for (int i = threadIdx.x; i < kBQ * DP; i += blockDim.x) {
      const int r = i / DP, d = i % DP;
      Qs[i] = (r < nq && d < D) ? to_f(qb[(size_t)(s0 + r) * D + d]) * a.scale : 0.f;
    }

    float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][NDV];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m_r[i] = kNegInf;
      l_r[i] = 0.f;
#pragma unroll
      for (int dv = 0; dv < NDV; ++dv) acc[i][dv] = 0.f;
    }

    // live key range of this sub-block (dead chunks skipped)
    const int q_first = a.q_offset + s0, q_last = a.q_offset + s0 + nq - 1;
    int kv_end = a.skv;
    if (a.causal) kv_end = min(kv_end, q_last + 1);
    int kv_begin = 0;
    if (a.window > 0) kv_begin = max(0, q_first - a.window + 1);
    kv_begin = (kv_begin / kBKV) * kBKV;

    for (int c0 = kv_begin; c0 < kv_end; c0 += kBKV) {
      __syncthreads();  // previous chunk's Ks/Vs fully consumed
      for (int i = threadIdx.x; i < kBKV * DP; i += blockDim.x) {
        const int j = i / DP, d = i % DP;
        const bool in = c0 + j < a.skv && d < D;
        Ks[j * (DP + 1) + d] = in ? to_f(kb[(size_t)(c0 + j) * D + d]) : 0.f;
        Vs[j * DP + d] = in ? to_f(vb[(size_t)(c0 + j) * D + d]) : 0.f;
      }
      __syncthreads();

      const int kv_pos = c0 + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        const float* qr = Qs + r * DP;
        const float* kr = Ks + lane * (DP + 1);
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) s = fmaf(qr[d], kr[d], s);
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        const int q_pos = a.q_offset + s0 + r;
        bool ok = kv_pos < a.skv;
        if (a.causal) ok = ok && kv_pos <= q_pos;
        if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
        s = ok ? s : kNegInf;
        const float m_new = fmaxf(m_r[i], warp_max(s));
        const float alpha = expf(m_r[i] - m_new);
        float p = expf(s - m_new);
        p = ok ? p : 0.f;
        l_r[i] = l_r[i] * alpha + warp_sum(p);
        m_r[i] = m_new;
        Ps[r * kBKV + lane] = p;
#pragma unroll
        for (int dv = 0; dv < NDV; ++dv) acc[i][dv] *= alpha;
      }
      __syncwarp();
      for (int j = 0; j < kBKV; ++j) {
        float vv[NDV];
#pragma unroll
        for (int dv = 0; dv < NDV; ++dv) vv[dv] = Vs[j * DP + lane + 32 * dv];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float p = Ps[(warp * kRowsPerWarp + i) * kBKV + j];
#pragma unroll
          for (int dv = 0; dv < NDV; ++dv) acc[i][dv] = fmaf(p, vv[dv], acc[i][dv]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r >= nq) continue;
      const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int dv = 0; dv < NDV; ++dv)
        if (lane + 32 * dv < D) ob[(size_t)(s0 + r) * D + lane + 32 * dv] = from_f<T>(acc[i][dv] / l);
    }
  }
}

template <typename T, int DP>
int launch(const AttnArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = attn_smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(a.sq, a.tile_q), bh);
  flash_attention_kernel<T, DP><<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const AttnArgs& a, int bh, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 32>(a, bh, s);
  if (a.d <= 64) return launch<T, 64>(a, bh, s);
  if (a.d <= 128) return launch<T, 128>(a, bh, s);
  if (a.d <= 256) return launch<T, 256>(a, bh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// C entry point bound with ctypes.  q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D), o like
// q, all contiguous and of one dtype.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int b, int hq, int hkv, int sq, int skv, int d, int dtype,
                                     int causal, int window, float softcap, int q_offset,
                                     float scale, int tile_q, void* stream) {
  using namespace repro;
  if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || tile_q <= 0) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d > 256) return (int)cudaErrorInvalidValue;
  if (hq % hkv) return (int)cudaErrorInvalidValue;
  if ((long long)b * hq > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.d = d;
  a.causal = causal; a.window = window; a.softcap = softcap; a.q_offset = q_offset;
  a.scale = scale; a.tile_q = tile_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch_d<__nv_bfloat16>(a, b * hq, s);
  if (dtype == kFloat32) return dispatch_d<float>(a, b * hq, s);
  return (int)cudaErrorInvalidValue;
}
