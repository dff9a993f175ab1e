// Online-softmax GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention.py
// (flash_attention() / _kernel).  The TPU grid walks (B*Hq, Q tiles, KV tiles)
// in order and carries the f32 softmax state (m, l, acc) in VMEM from one KV
// step to the next.  Here blocks run in no order, so one CTA owns a block of
// query rows of one (b, hq) and loops over the live KV range itself, keeping
// m, l and acc in registers.
//
// Two bodies, chosen by the dtype (kernels/flash_attention.py body_for makes
// the same choice and counts launches per body):
//
//  * mma (bf16): FlashAttention-2 on the tensor cores.  A CTA of 4 warps
//    holds 64 query rows, 16 per warp; the Q block is staged into shared
//    memory once, K and V come in chunks of 64 keys (32 at D = 256, so the
//    O accumulator and the S fragment fit the registers) through a double-buffered
//    cp.async ring (shared rows padded by 16 bytes against bank conflicts).
//    S = Q K^T is mma.sync m16n8k16 bf16 -> f32 (Q and K fragments by
//    ldmatrix; Q re-read from shared memory every chunk, so D = 256 keeps
//    its 128 accumulator registers per thread); scale, softcap, masks and
//    the online softmax run on the f32 S fragment in registers (quad
//    shuffles for the row max, the row sums per thread until the end); the
//    S fragment is re-packed in registers into the bf16 A operand of
//    O += P V, with V read by ldmatrix.trans.
//    The schedule's Q tile stays the unit of masking: each logical tile is
//    covered by ceil(min(tile, Sq) / 64) CTAs, never crossing its edge, and
//    the CTAs of the last (heaviest, under a causal mask) row blocks of all
//    heads are launched first.
//    Two roundings differ from _kernel: (1) _kernel scales q in f32 before
//    the dot; this body multiplies S by scale in f32 after the product, so q
//    is not rounded a second time; (2) P enters the second product in bf16
//    (the row sum l is taken over the f32 p).  Both stay inside the bf16
//    tolerance (3e-2) against the plain version.
//  * fma (f32): CUDA-core FMA on f32 copies in shared memory, one CTA per
//    (b*hq, Q tile) walking it in sub-blocks of 32 rows, chunks of 32 keys.
//    f32 stays off the tensor cores by rule (TF32 would break the 2e-4 f32
//    tolerance): a dtype rule, not a fallback.
//
// In both, KV chunks start at global multiples of the chunk (the first live
// chunk is rounded down), chunks that every row of the block masks are
// skipped, and a chunk that masks all of one row leaves that row's state
// bit for bit unchanged.  So a query row's result does not depend on which
// CTA holds it, or on how a prompt was split between calls with q_offset.
//
// What _kernel computes, kept:
//  * softcap (tanh(s / c) * c) comes before the mask;
//  * masked scores are the finite NEG_INF = -1e30, and p is re-zeroed under
//    the mask after the exp (a fully masked row stays at acc = 0, l = 0);
//  * l is clamped at 1e-30 before the division;
//  * the kv head of query head h is h / (Hq / Hkv);
//  * causal, window, q_offset and ragged Sq / Skv masks.
//
// Under training (FlashAttentionFn) the forward also writes each row's
// log-sum-exp, m + log(l) in f32 (+inf for a fully masked row), which the
// backward (csrc/flash_attention_bwd.cu) reads in place of a pass of its
// own; asked for or not, the output's bits are the same.
//
// Any head dim up to 256 runs: each body is compiled for padded widths (mma:
// 64, 128, 256; fma: 32, 64, 128, 256) and a smaller D is zero-padded to the
// next of them in shared memory.  At S <= 512 the bytes of q, k, v and o
// bound it, the operations (growing as S^2) for longer prompts.
#include <math.h>

#include <algorithm>

#include "mma.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;

struct AttnArgs {
  const void* q; const void* k; const void* v; void* o;
  float* lse;   // (B*Hq*Sq) f32 row log-sum-exp, or null: not asked for
  int bh, hq, hkv, sq, skv, d;
  int causal, window; float softcap; int q_offset; float scale;
  int tile_q, sub, ctas;   // logical Q tile, CTAs per logical tile, CTAs per (b, h)
};

// A row's log-sum-exp from its max and sum; +inf for a fully masked row
// (l = 0), so exp(s - lse) = 0 there as the output is.
__device__ __forceinline__ float attn_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
}

__device__ __forceinline__ bool attn_ok(const AttnArgs& a, int q_pos, int kv_pos) {
  bool ok = kv_pos < a.skv;
  if (a.causal) ok = ok && kv_pos <= q_pos;
  if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
  return ok;
}

// ---------------------------------------------------------------------------
// mma body: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;     // query rows per CTA (kernels/flash_attention.py MMA_CTA_Q)
constexpr int kMmaWarps = kMmaBQ / 16;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaPad = 8;     // bf16 of padding per shared row (16 bytes)

// keys per chunk: 64, or 32 at D = 256, where the 128 f32 of the O
// accumulator per thread leave no room for a 64-key S fragment
template <int DP>
__host__ __device__ constexpr int attn_mma_bkv() { return DP > 128 ? 32 : 64; }

template <int DP>
constexpr int attn_mma_smem_bytes() {   // Q, then two (K, V) chunk stages
  return (kMmaBQ + 4 * attn_mma_bkv<DP>()) * (DP + kMmaPad) * 2;
}

// On the S fragment of one chunk (lane (g, tq): rows g and g + 8 at query
// positions q_pos0 and q_pos0 + 8, keys c0 + 8j + 2tq and + 1): scale,
// softcap, then NEG_INF under the mask; mx gets this thread's row maxima.
template <bool kMasked, int NJ>
__device__ __forceinline__ void attn_scores(const AttnArgs& a, float (&sacc)[NJ][4], int q_pos0,
                                            int c0, int tq, float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = sacc[j][e] * a.scale;
      if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
      if (kMasked && !attn_ok(a, q_pos0 + 8 * (e / 2), c0 + j * 8 + 2 * tq + (e & 1))) s = kNegInf;
      sacc[j][e] = s;
      mx[e / 2] = fmaxf(mx[e / 2], s);
    }
}

// p = exp(s - m) over the same fragment, 0 under the mask; rs gets this
// thread's part of each row sum.
template <bool kMasked, int NJ>
__device__ __forceinline__ void attn_probs(const AttnArgs& a, float (&sacc)[NJ][4], int q_pos0,
                                           int c0, int tq, const float (&m)[2], float (&rs)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !kMasked || attn_ok(a, q_pos0 + 8 * (e / 2), c0 + j * 8 + 2 * tq + (e & 1));
      const float p = ok ? __expf(sacc[j][e] - m[e / 2]) : 0.f;
      sacc[j][e] = p;
      rs[e / 2] += p;
    }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads) attention_mma_kernel(AttnArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BKV = attn_mma_bkv<DP>();
  constexpr int kLd = DP + kMmaPad;   // shared row stride
  constexpr int kKV = BKV * kLd;      // elements of one staged K or V chunk
  constexpr int NB = DP / 8;          // m16n8 output blocks along D
  constexpr int KS = DP / 16;         // 16-deep steps along D for S
  constexpr int NJ = BKV / 8;         // m16n8 blocks of S along the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kMmaBQ * kLd;   // [2][BKV][kLd]
  bf16* Vs = Ks + 2 * kKV;        // [2][BKV][kLd]

  // heaviest first: rank 0 is the last row block of every (b, h)
  const int rank = blockIdx.x / a.bh, bh = blockIdx.x % a.bh;
  const int idx = a.ctas - 1 - rank;
  const int t0 = (idx / a.sub) * a.tile_q, t1 = min(t0 + a.tile_q, a.sq);
  const int r0 = t0 + (idx % a.sub) * kMmaBQ;
  if (r0 >= t1) return;   // a ragged logical tile needs fewer CTAs
  const int r1 = min(r0 + kMmaBQ, t1);

  const int D = a.d;
  const int b = bh / a.hq, h = bh % a.hq;
  const int kvh = b * a.hkv + h / (a.hq / a.hkv);
  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t)bh * a.sq * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)kvh * a.skv * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)kvh * a.skv * D;
  bf16* ob = static_cast<bf16*>(a.o) + (size_t)bh * a.sq * D;
  // 16-byte copies only where every row starts on 16 bytes
  const bool vec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(a.q) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.k) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.v) % 16) == 0;

  // live keys of this row block; chunks at global multiples of BKV
  const int q_first = a.q_offset + r0, q_last = a.q_offset + r1 - 1;
  int kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, q_first - a.window + 1);
  kv_begin = (kv_begin / BKV) * BKV;
  const int nchunks = kv_end > kv_begin ? cdiv(kv_end - kv_begin, BKV) : 0;

  stage_rows<kMmaBQ, DP, kMmaThreads, kMmaPad>(Qs, qb, r0, r1, D, vec);
  cp_async_commit();
  if (nchunks > 0) {
    stage_rows<BKV, DP, kMmaThreads, kMmaPad>(Ks, kb, kv_begin, a.skv, D, vec);
    stage_rows<BKV, DP, kMmaThreads, kMmaPad>(Vs, vb, kv_begin, a.skv, D, vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int q_pos0 = a.q_offset + r0 + warp * 16 + g;   // fragment row g; row g + 8 is q_pos0 + 8
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = kv_begin + c * BKV;
    if (c + 1 < nchunks) {
      const int slot = (c + 1) & 1;
      stage_rows<BKV, DP, kMmaThreads, kMmaPad>(Ks + slot * kKV, kb, c0 + BKV, a.skv, D, vec);
      stage_rows<BKV, DP, kMmaThreads, kMmaPad>(Vs + slot * kKV, vb, c0 + BKV, a.skv, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // Q and chunk c have landed (this thread's copies)
    __syncthreads();      // ... everyone's
    const bf16* ks = Ks + (c & 1) * kKV;
    const bf16* vs = Vs + (c & 1) * kKV;

    // S = Q K^T: lane (g, tq) holds rows g, g + 8 and keys 8j + 2tq, + 1
    float sacc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, smem_addr(Qs + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        // K rows are keys (the mma's n), columns are D (its k): no .trans
        uint32_t bfr[4];
        ldmatrix_x4(bfr, smem_addr(ks + (j * 8 + (lane / 16) * 8 + lane % 8) * kLd + kk * 16 +
                                   ((lane / 8) % 2) * 8));
        mma_bf16(sacc[j], af, bfr[0], bfr[1]);
        mma_bf16(sacc[j + 1], af, bfr[2], bfr[3]);
      }
    }

    // scale, softcap, mask (none where every row of the warp sees the whole
    // chunk: the same values, fewer instructions); the row max over the quad
    const int wq0 = a.q_offset + r0 + warp * 16;   // the warp's first and last query position
    const bool whole = c0 + BKV <= a.skv && (!a.causal || c0 + BKV - 1 <= wq0) &&
                       (a.window <= 0 || c0 > wq0 + 15 - a.window);
    float mx[2] = {kNegInf, kNegInf};
    if (whole) attn_scores<false>(a, sacc, q_pos0, c0, tq, mx);
    else attn_scores<true>(a, sacc, q_pos0, c0, tq, mx);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_r[hh], mx[hh]);
      // exactly 1 where the chunk leaves the max alone (a fully masked chunk)
      alpha[hh] = m_new == m_r[hh] ? 1.f : __expf(m_r[hh] - m_new);
      m_r[hh] = m_new;
    }
    // p = exp(s - m), re-zeroed under the mask; this thread's part of the row sum
    float rs[2] = {0.f, 0.f};
    if (whole) attn_probs<false>(a, sacc, q_pos0, c0, tq, m_r, rs);
    else attn_probs<true>(a, sacc, q_pos0, c0, tq, m_r, rs);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= alpha[0]; o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1]; o[nb][3] *= alpha[1];
    }

    // O += P V: the S fragment of keys 16kk..16kk+15 is the A operand, in bf16
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, smem_addr(vs + (kk * 16 + lane % 16) * kLd + nb * 8 + (lane / 16) * 8));
        mma_bf16(o[nb], pa, t[0], t[1]);
        mma_bf16(o[nb + 1], pa, t[2], t[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + warp * 16 + g + 8 * hh;
    if (a.lse != nullptr && tq == 0 && row < r1)
      a.lse[(size_t)bh * a.sq + row] = attn_lse(m_r[hh], l);
    l = fmaxf(l, 1e-30f);
    if (row >= r1) continue;
    bf16* orow = ob + (size_t)row * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = nb * 8 + 2 * tq;
      if (col >= D) continue;
      const float y0 = o[nb][2 * hh] / l, y1 = o[nb][2 * hh + 1] / l;
      if (col + 1 < D) store2(orow + col, y0, y1);
      else orow[col] = __float2bfloat16_rn(y0);
    }
  }
}

// ---------------------------------------------------------------------------
// fma body: f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 32, kBKV = 32, kWarps = 4, kRowsPerWarp = kBQ / kWarps;

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
// One CTA per (b*hq, logical Q tile): blockIdx.x = tile, blockIdx.y = b*hq.
template <int DP>
__global__ void __launch_bounds__(kWarps * 32) attention_fma_kernel(AttnArgs a) {
  using T = float;
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
        const bool ok = attn_ok(a, a.q_offset + s0 + r, kv_pos);
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
      if (a.lse != nullptr && lane == 0) a.lse[(size_t)bh * a.sq + s0 + r] = attn_lse(m_r[i], l_r[i]);
      const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int dv = 0; dv < NDV; ++dv)
        if (lane + 32 * dv < D) ob[(size_t)(s0 + r) * D + lane + 32 * dv] = from_f<T>(acc[i][dv] / l);
    }
  }
}

enum AttnBody : int { kAttnMma = 0, kAttnFma = 1 };

template <int DP>
int launch_mma(const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = attn_mma_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<DP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_mma_kernel<DP><<<a.ctas * a.bh, kMmaThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fma(const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = attn_smem_floats<DP>() * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(attention_fma_kernel<DP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fma_kernel<DP><<<dim3(a.ctas, a.bh), kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D), o like
// q, all contiguous and of one dtype.  (cta_q, ctas): the CTA geometry the
// wrapper chose (kernels/flash_attention.py attention_geometry), CTAs per
// (b, h), re-checked here.  lse: null, or (B,Hq,Sq) f32 that gets each row's
// log-sum-exp of its masked, softcapped, scaled scores (+inf for a fully
// masked row), which the backward reads; o's bits do not depend on it.
// Returns a cudaError_t (cudaErrorInvalidValue for bad arguments).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int b, int hq, int hkv, int sq, int skv, int d, int dtype,
                                     int causal, int window, float softcap, int q_offset,
                                     float scale, int tile_q, int cta_q, int ctas, void* stream) {
  using namespace repro;
  if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || tile_q <= 0) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d > 256) return (int)cudaErrorInvalidValue;
  if (hq % hkv) return (int)cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = static_cast<float*>(lse);
  a.bh = b * hq; a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.d = d;
  a.causal = causal; a.window = window; a.softcap = softcap; a.q_offset = q_offset;
  a.scale = scale; a.tile_q = tile_q; a.ctas = ctas;
  const long long tiles = cdiv(sq, tile_q);
  const AttnBody body = dtype == kBFloat16 ? kAttnMma : kAttnFma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kAttnMma) {
    if (cta_q != kMmaBQ) return (int)cudaErrorInvalidValue;
    a.sub = cdiv(std::min(tile_q, sq), kMmaBQ);
    if (tiles * a.sub != ctas || (long long)ctas * a.bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (d <= 64) return launch_mma<64>(a, s);
    if (d <= 128) return launch_mma<128>(a, s);
    return launch_mma<256>(a, s);
  }
  a.sub = 1;
  if (cta_q != tile_q || tiles != ctas) return (int)cudaErrorInvalidValue;
  if ((long long)b * hq > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  if (d <= 32) return launch_fma<32>(a, s);
  if (d <= 64) return launch_fma<64>(a, s);
  if (d <= 128) return launch_fma<128>(a, s);
  return launch_fma<256>(a, s);
}
