// Backward of the GQA flash attention for Hopper (sm_90a): dQ, dK and dV.
//
// The reference has no Pallas backward: jax.value_and_grad differentiates
// its attention (src/repro/kernels/flash_attention.py, flash_attention() /
// _kernel, on the default "ref" backend) through XLA.  In the port a CUDA
// tensor never takes a plain version, so the gradient of every K2 launch of
// a training step comes from these kernels.
//
// What it computes, for what the forward takes in training: causal and
// non-causal, a sliding window, softcap (tanh(s / c) * c, its derivative
// 1 - tanh^2 inside the softmax's), GQA (dK and dV summed over the query
// heads of a group), Sq != Skv, head dims up to 256, bf16 and f32,
// q_offset 0.  With s = scale * q.k, t = softcap(s), P = softmax_masked(t)
// = exp(t - lse), O = P V:
//   dV = P^T dO,  dP = dO V^T,  dT = P * (dP - rowsum(dO * O)),
//   dS = dT * (1 - tanh^2) (softcap), dQ = scale * dS K,  dK = scale * dS^T Q.
// lse, each row's log-sum-exp, comes from the forward (csrc/flash_attention.cu
// writes it under training): +inf for a fully masked row, so P = 0 there.
// Delta = rowsum(dO * O) is taken once per row, in f32, by the dq kernel,
// which runs first; the dkv kernel reads it.  No atomics: every sum is
// taken in a fixed order, so a training step's bits are the same run to run.
//
// Two bodies, by the dtype, as the forward's (kernels/flash_attention.py
// body_for):
//
//  * mma (bf16): the five products on the tensor cores, mma.sync m16n8k16
//    bf16 x bf16 -> f32, operands by ldmatrix (.trans for the products
//    that contract over the rows of a staged tile), tiles staged by
//    16-byte cp.async into a double-buffered ring, shared rows padded by 16
//    bytes.  P and dS are rounded to bf16 for the second products, as the
//    forward rounds P; S, dP, the softmax and every sum stay in f32.
//     - dq kernel: a CTA of 4 warps per (b, hq, 64 query rows), 16 rows a
//       warp; Q and dO staged once, K and V in chunks of 64 keys (32 at
//       D = 256) over the rows' live key range; S = Q K^T and dP = dO V^T
//       into f32 fragments, dS formed in registers, dQ += dS K.
//     - dkv kernel: a CTA of 4 warps per (b, hkv, 64 keys, column block,
//       group part), 16 keys a warp; K and V staged once, Q, dO, lse and
//       Delta in chunks of 64 query rows (32 at D = 128, 16 at D = 256) of
//       each query head of the CTA's part of the group, over the keys' live
//       query range; S^T = K Q^T and dP^T = V dO^T, P^T and dS^T formed in
//       registers, dV += P^T dO and dK += dS^T Q over its columns.
//    The hazard at D = 256: the dK and dV accumulators of 16 keys x 256
//    columns would take 256 f32 registers a thread.  So the dkv kernel
//    splits D's output columns between two CTAs (a column block of 128):
//    each recomputes S^T and dP^T over the full D, and owns half of dK and
//    dV (128 registers a thread, as at D = 128).  The query chunk shrinks
//    with D so S^T and dP^T stay small (BQ / 2 f32 a thread each), and the
//    dq kernel's keys per chunk halve at D = 256 as the forward's do.
//    ptxas -v, sm_90a (chip_smoke.py's build phase prints it per kernel):
//    the dq kernel takes 181, 254 and 255 registers at D = 64, 128 and 256
//    and spills 12 bytes at 256 (its 128 dQ accumulators, S and dP); the
//    dkv kernel 235, 255 and 237, no spills.
//    To fill the 132 SMs at the families' shapes, the query heads of a GQA
//    group may be split between CTAs (kernels/flash_attention.py
//    bwd_geometry picks the split from the shape alone and sizes the
//    workspace; plan_bwd below gives each launch's CTAs and shared bytes):
//    each part writes its f32 dK and dV to a workspace, and a finish kernel
//    adds the parts in part order and rounds.  With one part the dkv kernel rounds and
//    writes dK and dV itself.
//  * fma (f32): CUDA-core FMA on f32 copies in shared memory (TF32 would
//    break the 2e-4 f32 tolerance).  A dq kernel of 8 warps per (b, hq, 16
//    query rows), 2 rows a warp, K and V in chunks of 32 keys; a dkv kernel
//    of 8 warps per (b, hkv, 16 keys) that walks the group's heads in
//    order; dot products are warp reductions (a lane holds D / 32 values).
//
// Every CTA skips the chunks its rows or keys all mask.  What bounds it: at
// the training shapes the bytes of q, k, v, o, dO and the gradients, read
// and written once, with the operations (five products of Sq x Skv x D, 2.5x
// the forward's, less the masked pairs) close behind; the operations bound
// it at whisper's 1500-frame encoder.
#include <math.h>

#include "mma.cuh"

namespace repro {

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;  // (B*Hq*Sq) f32, the forward's
  void* dq; void* dk; void* dv;
  float* delta;      // (B*Hq*Sq) f32 scratch: written by the dq kernel, read by dkv
  float* ws;         // mma, parts > 1: (2, parts, B*Hkv*Skv*D) f32 partial dK, dV
  int b, hq, hkv, sq, skv, d;
  int causal, window; float softcap; float scale;
  int parts;         // CTAs sharing a GQA group (mma dkv kernel)
};

__device__ __forceinline__ bool bwd_ok(const BwdArgs& a, int q_pos, int kv_pos) {
  bool ok = kv_pos < a.skv && q_pos < a.sq;
  if (a.causal) ok = ok && kv_pos <= q_pos;
  if (a.window > 0) ok = ok && kv_pos > q_pos - a.window;
  return ok;
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
// mma body: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBwdMmaRows = 64;   // query rows (dq) or keys (dkv) per CTA
constexpr int kBwdMmaThreads = 128;
constexpr int kBwdMmaPad = 8;     // bf16 of padding per shared row

template <int DP>
struct BwdMma {
  static constexpr int kLd = DP + kBwdMmaPad;             // shared row stride
  static constexpr int BKV = DP > 128 ? 32 : 64;          // dq kernel: keys per chunk
  static constexpr int BQ = DP > 128 ? 16 : DP > 64 ? 32 : 64;  // dkv kernel: rows per chunk
  static constexpr int DO = DP > 128 ? 128 : DP;          // dkv kernel: columns per CTA
  // Q, dO; then two (K, V) chunk stages; then Delta of the CTA's rows
  static constexpr int kDqSmem = (2 * kBwdMmaRows + 4 * BKV) * kLd * 2 + kBwdMmaRows * 4;
  // K, V; then two (Q, dO) chunk stages; then two stages of (lse, Delta)
  static constexpr int kDkvSmem = (2 * kBwdMmaRows + 4 * BQ) * kLd * 2 + 4 * BQ * 4;
};

// S (or S^T) and dP (or dP^T) of one chunk into P and dS, in place, on the
// f32 fragments of a warp: lane (g, tq) holds rows g and g + 8 (row_pos0 and
// row_pos0 + 8) and columns 8j + 2tq, + 1 (col_pos0 + 8j + 2tq).  kRowsAreQ:
// rows are query rows (dq kernel: lse and Delta per row, rl / rd) or keys
// (dkv kernel: per column, from the staged cl / cd).
template <bool kMasked, bool kRowsAreQ, int NJ>
__device__ __forceinline__ void bwd_probs(const BwdArgs& a, float (&s)[NJ][4], float (&dp)[NJ][4],
                                          int row_pos0, int col_pos0, int tq, const float (&rl)[2],
                                          const float (&rd)[2], const float* cl, const float* cd) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_pos0 + 8 * (e / 2), col = j * 8 + 2 * tq + (e & 1);
      const int q_pos = kRowsAreQ ? row : col_pos0 + col;
      const int kv_pos = kRowsAreQ ? col_pos0 + col : row;
      const float lse = kRowsAreQ ? rl[e / 2] : cl[col];
      const float delta = kRowsAreQ ? rd[e / 2] : cd[col];
      float t, dcap;
      bwd_cap(s[j][e] * a.scale, a.softcap, t, dcap);
      const bool ok = !kMasked || bwd_ok(a, q_pos, kv_pos);
      const float p = ok ? __expf(t - lse) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta) * dcap * a.scale;
    }
}

// The f32 fragment of keys (or rows) 16kk .. 16kk + 15 as a bf16 A operand.
template <int NJ>
__device__ __forceinline__ void bwd_a_operand(uint32_t (&r)[4], const float (&f)[NJ][4], int kk) {
  r[0] = pack_bf16(f[2 * kk][0], f[2 * kk][1]);
  r[1] = pack_bf16(f[2 * kk][2], f[2 * kk][3]);
  r[2] = pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]);
  r[3] = pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3]);
}

// dq kernel: one CTA per (64 query rows, b * hq); the last row blocks (the
// heaviest under a causal mask) first.
template <int DP>
__global__ void __launch_bounds__(kBwdMmaThreads) attention_bwd_dq_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = BwdMma<DP>;
  constexpr int BKV = L::BKV, kLd = L::kLd, kKV = BKV * kLd;
  constexpr int NB = DP / 8;    // m16n8 blocks of dQ along D
  constexpr int KS = DP / 16;   // 16-deep steps along D for S and dP
  constexpr int NJ = BKV / 8;   // m16n8 blocks of S along the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [64][kLd]
  bf16* Gs = Qs + kBwdMmaRows * kLd;              // dO [64][kLd]
  bf16* Ks = Gs + kBwdMmaRows * kLd;              // [2][BKV][kLd]
  bf16* Vs = Ks + 2 * kKV;                        // [2][BKV][kLd]
  float* Ds = reinterpret_cast<float*>(Vs + 2 * kKV);   // [64] Delta

  const int bhq = a.b * a.hq;
  const int rank = blockIdx.x / bhq, bh = blockIdx.x % bhq;
  const int tiles = cdiv(a.sq, kBwdMmaRows);
  const int r0 = (a.causal ? tiles - 1 - rank : rank) * kBwdMmaRows;
  const int r1 = min(r0 + kBwdMmaRows, a.sq);
  const int D = a.d;
  const int b = bh / a.hq, h = bh % a.hq;
  const int kvh = b * a.hkv + h / (a.hq / a.hkv);
  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t)bh * a.sq * D;
  const bf16* gb = static_cast<const bf16*>(a.dout) + (size_t)bh * a.sq * D;
  const bf16* ob = static_cast<const bf16*>(a.o) + (size_t)bh * a.sq * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)kvh * a.skv * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)kvh * a.skv * D;
  bf16* dqb = static_cast<bf16*>(a.dq) + (size_t)bh * a.sq * D;
  const bool vec = D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.dout);

  // live keys of this row block; chunks at global multiples of BKV
  int kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, r1);
  int kv_begin = a.window > 0 ? max(0, r0 - a.window + 1) : 0;
  kv_begin = (kv_begin / BKV) * BKV;
  const int nchunks = kv_end > kv_begin ? cdiv(kv_end - kv_begin, BKV) : 0;

  stage_rows<kBwdMmaRows, DP, kBwdMmaThreads>(Qs, qb, r0, r1, D, vec);
  stage_rows<kBwdMmaRows, DP, kBwdMmaThreads>(Gs, gb, r0, r1, D, vec);
  cp_async_commit();
  if (nchunks > 0) {
    stage_rows<BKV, DP, kBwdMmaThreads>(Ks, kb, kv_begin, a.skv, D, vec);
    stage_rows<BKV, DP, kBwdMmaThreads>(Vs, vb, kv_begin, a.skv, D, vec);
  }
  cp_async_commit();

  // Delta = rowsum(dO * O): two threads a row, each over half of D, in order
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2, row = r0 + r;
    const int c0 = half * ((D + 1) / 2), c1 = half ? D : (D + 1) / 2;
    float s = 0.f;
    if (row < r1)
      for (int c = c0; c < c1; ++c)
        s = fmaf(__bfloat162float(gb[(size_t)row * D + c]), __bfloat162float(ob[(size_t)row * D + c]), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) {
      Ds[r] = s;
      if (row < r1) a.delta[(size_t)bh * a.sq + row] = s;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int q_pos0 = r0 + warp * 16 + g;   // fragment row g; row g + 8 is q_pos0 + 8
  float rl[2], rd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q_pos0 + 8 * hh;
    rl[hh] = row < r1 ? a.lse[(size_t)bh * a.sq + row] : INFINITY;
    rd[hh] = Ds[warp * 16 + g + 8 * hh];
  }
  float dq[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nb][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int c0 = kv_begin + c * BKV;
    if (c + 1 < nchunks) {
      const int slot = (c + 1) & 1;
      stage_rows<BKV, DP, kBwdMmaThreads>(Ks + slot * kKV, kb, c0 + BKV, a.skv, D, vec);
      stage_rows<BKV, DP, kBwdMmaThreads>(Vs + slot * kKV, vb, c0 + BKV, a.skv, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // Q, dO and chunk c have landed (this thread's copies)
    __syncthreads();      // ... everyone's
    const bf16* ks = Ks + (c & 1) * kKV;
    const bf16* vs = Vs + (c & 1) * kKV;

    // S = Q K^T and dP = dO V^T: lane (g, tq) holds rows g, g + 8, keys 8j + 2tq, + 1
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      const int arow = (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8;
      ldmatrix_x4(qa, smem_addr(Qs + arow));
      ldmatrix_x4(ga, smem_addr(Gs + arow));
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const int brow = (j * 8 + (lane / 16) * 8 + lane % 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, smem_addr(ks + brow));
        ldmatrix_x4(vf, smem_addr(vs + brow));
        mma_bf16(s[j], qa, kf[0], kf[1]);
        mma_bf16(s[j + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[j], ga, vf[0], vf[1]);
        mma_bf16(dp[j + 1], ga, vf[2], vf[3]);
      }
    }

    // P and dS (no mask where every pair of the warp's rows and the chunk is live)
    const int wq0 = r0 + warp * 16;
    const bool whole = c0 + BKV <= a.skv && wq0 + 15 < a.sq && (!a.causal || c0 + BKV - 1 <= wq0) &&
                       (a.window <= 0 || c0 > wq0 + 15 - a.window);
    if (whole) bwd_probs<false, true>(a, s, dp, q_pos0, c0, tq, rl, rd, nullptr, nullptr);
    else bwd_probs<true, true>(a, s, dp, q_pos0, c0, tq, rl, rd, nullptr, nullptr);

    // dQ += dS K: K's rows (keys) are the contraction, so .trans
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t da[4];
      bwd_a_operand<NJ>(da, dp, kk);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, smem_addr(ks + (kk * 16 + lane % 16) * kLd + nb * 8 + (lane / 16) * 8));
        mma_bf16(dq[nb], da, t[0], t[1]);
        mma_bf16(dq[nb + 1], da, t[2], t[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q_pos0 + 8 * hh;
    if (row >= r1) continue;
    bf16* out = dqb + (size_t)row * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = nb * 8 + 2 * tq;
      if (col >= D) continue;
      if (col + 1 < D) store2(out + col, dq[nb][2 * hh], dq[nb][2 * hh + 1]);
      else out[col] = __float2bfloat16_rn(dq[nb][2 * hh]);
    }
  }
}

// dkv kernel: one CTA per (64 keys, column block, group part, b * hkv), in
// that order from the slowest index: the first key blocks (the heaviest
// under a causal mask) first.
template <int DP>
__global__ void __launch_bounds__(kBwdMmaThreads) attention_bwd_dkv_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  using L = BwdMma<DP>;
  constexpr int BQ = L::BQ, DO = L::DO, kLd = L::kLd, kQc = BQ * kLd;
  constexpr int KS = DP / 16;   // 16-deep steps along D for S^T and dP^T
  constexpr int NQ = BQ / 8;    // m16n8 blocks of S^T along the chunk's rows
  constexpr int NO = DO / 8;    // m16n8 blocks of dK, dV along the CTA's columns
  static_assert(NQ % 2 == 0 && NO % 2 == 0, "fragments go in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [64][kLd]
  bf16* Vs = Ks + kBwdMmaRows * kLd;              // [64][kLd]
  bf16* Qs = Vs + kBwdMmaRows * kLd;              // [2][BQ][kLd]
  bf16* Gs = Qs + 2 * kQc;                        // dO [2][BQ][kLd]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kQc);   // [2][BQ] lse
  float* Dl = Ls + 2 * BQ;                              // [2][BQ] Delta

  const int bhkv = a.b * a.hkv, splits = DP / DO;
  int idx = blockIdx.x;
  const int bkv = idx % bhkv;
  idx /= bhkv;
  const int part = idx % a.parts;
  idx /= a.parts;
  const int col0 = (idx % splits) * DO;
  const int k0 = (idx / splits) * kBwdMmaRows, k1 = min(k0 + kBwdMmaRows, a.skv);
  const int D = a.d;
  const int b = bkv / a.hkv, hk = bkv % a.hkv;
  const int group = a.hq / a.hkv, per = group / a.parts;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)bkv * a.skv * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)bkv * a.skv * D;
  const bool vec = D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.dout);

  // live query rows of this key block; chunks at global multiples of BQ
  int q_begin = a.causal ? k0 : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = a.window > 0 ? min(a.sq, k1 - 1 + a.window) : a.sq;
  const int nq = q_end > q_begin ? cdiv(q_end - q_begin, BQ) : 0;
  const int nchunks = per * nq;   // the part's heads in order, each over its live rows

  // chunk c of the walk into ring slot `slot`: Q, dO (cp.async), lse, Delta
  auto stage = [&](int c, int slot) {
    const int bh = b * a.hq + hk * group + part * per + c / nq;
    const int q0 = q_begin + (c % nq) * BQ;
    stage_rows<BQ, DP, kBwdMmaThreads>(Qs + slot * kQc, static_cast<const bf16*>(a.q) + (size_t)bh * a.sq * D,
                                       q0, a.sq, D, vec);
    stage_rows<BQ, DP, kBwdMmaThreads>(Gs + slot * kQc,
                                       static_cast<const bf16*>(a.dout) + (size_t)bh * a.sq * D, q0,
                                       a.sq, D, vec);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      Ls[slot * BQ + threadIdx.x] = row < a.sq ? a.lse[(size_t)bh * a.sq + row] : INFINITY;
      Dl[slot * BQ + threadIdx.x] = row < a.sq ? a.delta[(size_t)bh * a.sq + row] : 0.f;
    }
  };

  stage_rows<kBwdMmaRows, DP, kBwdMmaThreads>(Ks, kb, k0, k1, D, vec);
  stage_rows<kBwdMmaRows, DP, kBwdMmaThreads>(Vs, vb, k0, k1, D, vec);
  if (nchunks > 0) stage(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int key_pos0 = k0 + warp * 16 + g;   // fragment row g; row g + 8 is key_pos0 + 8
  const float none[2] = {0.f, 0.f};
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int q0 = q_begin + (c % nq) * BQ;
    if (c + 1 < nchunks) stage(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and chunk c have landed (this thread's copies)
    __syncthreads();      // ... everyone's, and the slot's lse and Delta
    const bf16* qs = Qs + (c & 1) * kQc;
    const bf16* gs = Gs + (c & 1) * kQc;

    // S^T = K Q^T and dP^T = V dO^T: lane (g, tq) holds keys g, g + 8 and rows 8j + 2tq, + 1
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      const int arow = (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8;
      ldmatrix_x4(ka, smem_addr(Ks + arow));
      ldmatrix_x4(va, smem_addr(Vs + arow));
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        const int brow = (j * 8 + (lane / 16) * 8 + lane % 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t qf[4], gf[4];
        ldmatrix_x4(qf, smem_addr(qs + brow));
        ldmatrix_x4(gf, smem_addr(gs + brow));
        mma_bf16(s[j], ka, qf[0], qf[1]);
        mma_bf16(s[j + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[j], va, gf[0], gf[1]);
        mma_bf16(dp[j + 1], va, gf[2], gf[3]);
      }
    }

    // P^T and dS^T (no mask where every pair of the warp's keys and the chunk is live)
    const int kw0 = k0 + warp * 16;
    const bool whole = kw0 + 15 < a.skv && q0 + BQ <= a.sq && (!a.causal || kw0 + 15 <= q0) &&
                       (a.window <= 0 || kw0 > q0 + BQ - 1 - a.window);
    const float* cl = Ls + (c & 1) * BQ;
    const float* cd = Dl + (c & 1) * BQ;
    if (whole) bwd_probs<false, false>(a, s, dp, key_pos0, q0, tq, none, none, cl, cd);
    else bwd_probs<true, false>(a, s, dp, key_pos0, q0, tq, none, none, cl, cd);

    // dV += P^T dO and dK += dS^T Q over the CTA's columns: the chunk's rows
    // are the contraction, so .trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      bwd_a_operand<NQ>(pa, s, kk);
      bwd_a_operand<NQ>(da, dp, kk);
#pragma unroll
      for (int nb = 0; nb < NO; nb += 2) {
        const int off = (kk * 16 + lane % 16) * kLd + col0 + nb * 8 + (lane / 16) * 8;
        uint32_t t[4];
        ldmatrix_x4_trans(t, smem_addr(gs + off));
        mma_bf16(dv[nb], pa, t[0], t[1]);
        mma_bf16(dv[nb + 1], pa, t[2], t[3]);
        ldmatrix_x4_trans(t, smem_addr(qs + off));
        mma_bf16(dk[nb], da, t[0], t[1]);
        mma_bf16(dk[nb + 1], da, t[2], t[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // one part: round and write; else this part's f32 sums to the workspace
  const size_t n = (size_t)bhkv * a.skv * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key_pos0 + 8 * hh;
    if (key >= k1) continue;
    const size_t rowo = ((size_t)bkv * a.skv + key) * D;
#pragma unroll
    for (int nb = 0; nb < NO; ++nb) {
      const int col = col0 + nb * 8 + 2 * tq;
      if (col >= D) continue;
      const bool two = col + 1 < D;
      if (a.parts == 1) {
        bf16* ko = static_cast<bf16*>(a.dk) + rowo + col;
        bf16* vo = static_cast<bf16*>(a.dv) + rowo + col;
        if (two) {
          store2(ko, dk[nb][2 * hh], dk[nb][2 * hh + 1]);
          store2(vo, dv[nb][2 * hh], dv[nb][2 * hh + 1]);
        } else {
          *ko = __float2bfloat16_rn(dk[nb][2 * hh]);
          *vo = __float2bfloat16_rn(dv[nb][2 * hh]);
        }
      } else {
        float* wk = a.ws + (size_t)part * n + rowo + col;
        float* wv = a.ws + (size_t)(a.parts + part) * n + rowo + col;
        wk[0] = dk[nb][2 * hh];
        wv[0] = dv[nb][2 * hh];
        if (two) {
          wk[1] = dk[nb][2 * hh + 1];
          wv[1] = dv[nb][2 * hh + 1];
        }
      }
    }
  }
}

// The parts' dK and dV added in part order and rounded: n elements each.
__global__ void attention_bwd_parts_kernel(const float* ws, int parts, long long n, __nv_bfloat16* dk,
                                           __nv_bfloat16* dv) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * n) return;
  const int which = (int)(e / n);
  const long long o = e % n;
  const float* src = ws + (long long)which * parts * n + o;
  float s = src[0];
  for (int p = 1; p < parts; ++p) s += src[(long long)p * n];
  (which == 0 ? dk : dv)[o] = __float2bfloat16_rn(s);
}

// A launch's CTAs and dynamic shared bytes per kernel (plan_bwd).
struct BwdLaunch {
  int dq_ctas, dkv_ctas, dq_smem, dkv_smem;
};

template <int DP>
int launch_bwd_mma(const BwdArgs& a, const BwdLaunch& l, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_mma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, l.dkv_smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_mma_kernel<DP><<<l.dq_ctas, kBwdMmaThreads, l.dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_mma_kernel<DP><<<l.dkv_ctas, kBwdMmaThreads, l.dkv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.parts == 1) return (int)err;
  const long long n = (long long)a.b * a.hkv * a.skv * a.d;
  const int threads = 256;
  attention_bwd_parts_kernel<<<(unsigned)((2 * n + threads - 1) / threads), threads, 0, stream>>>(
      a.ws, a.parts, n, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fma body: f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;
constexpr int kBwdPerWarp = 2;                      // rows (dq) or keys (dkv) of one warp
constexpr int kBwdPerCta = kBwdWarps * kBwdPerWarp; // 16
constexpr int kBwdChunk = 32;                       // keys (dq) or query rows (dkv) staged at once

__device__ __forceinline__ float bwd_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one row's VPL values of this lane (d = lane * VPL + i), zeros past D
template <int VPL>
__device__ __forceinline__ void load_row(float (&r)[VPL], const float* src, int lane, int D) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane * VPL + i;
    r[i] = d < D ? src[d] : 0.f;
  }
}

template <int VPL>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[VPL], int lane, int D) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = lane * VPL + i;
    if (d < D) dst[d] = r[i];
  }
}

template <int VPL>
__device__ __forceinline__ float dot_part(const float (&a)[VPL], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// Stages kBwdChunk rows of a (.., D) f32 tensor from `src` (row `first`)
// into shared memory [kBwdChunk][DP], zeros past D and past `limit` rows.
template <int DP>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int first, int limit, int D) {
  for (int i = threadIdx.x; i < kBwdChunk * DP; i += blockDim.x) {
    const int r = i / DP, d = i % DP;
    const int row = first + r;
    dst[i] = (row < limit && d < D) ? src[(size_t)row * D + d] : 0.f;
  }
}

// dq kernel: grid (ceil(Sq / 16), B * Hq)
template <int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32) attention_bwd_dq_fma_kernel(BwdArgs a) {
  constexpr int DP = 32 * VPL;
  extern __shared__ float bwd_smem[];
  float* Ks = bwd_smem;                 // [kBwdChunk][DP]
  float* Vs = Ks + kBwdChunk * DP;      // [kBwdChunk][DP]

  const int D = a.d;
  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int kvh = b * a.hkv + h / (a.hq / a.hkv);
  const float* qb = static_cast<const float*>(a.q) + (size_t)bh * a.sq * D;
  const float* ob = static_cast<const float*>(a.o) + (size_t)bh * a.sq * D;
  const float* gb = static_cast<const float*>(a.dout) + (size_t)bh * a.sq * D;
  float* dqb = static_cast<float*>(a.dq) + (size_t)bh * a.sq * D;
  const float* kb = static_cast<const float*>(a.k) + (size_t)kvh * a.skv * D;
  const float* vb = static_cast<const float*>(a.v) + (size_t)kvh * a.skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int cta_first = blockIdx.x * kBwdPerCta;
  const int cta_last = min(cta_first + kBwdPerCta, a.sq) - 1;
  int kv_end = a.skv;
  if (a.causal) kv_end = min(kv_end, cta_last + 1);
  int kv_begin = a.window > 0 ? max(0, cta_first - a.window + 1) : 0;
  kv_begin = (kv_begin / kBwdChunk) * kBwdChunk;

  float q[kBwdPerWarp][VPL], g[kBwdPerWarp][VPL], dq[kBwdPerWarp][VPL];
  float delta[kBwdPerWarp], lse[kBwdPerWarp];
  int row[kBwdPerWarp];
#pragma unroll
  for (int r = 0; r < kBwdPerWarp; ++r) {
    row[r] = cta_first + warp * kBwdPerWarp + r;
    const bool in = row[r] < a.sq;
    float o[VPL];
    if (in) {
      load_row<VPL>(q[r], qb + (size_t)row[r] * D, lane, D);
      load_row<VPL>(g[r], gb + (size_t)row[r] * D, lane, D);
      load_row<VPL>(o, ob + (size_t)row[r] * D, lane, D);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) q[r][i] = g[r][i] = o[i] = 0.f;
    }
    delta[r] = bwd_warp_sum(dot_part<VPL>(g[r], o));
    lse[r] = in ? a.lse[(size_t)bh * a.sq + row[r]] : INFINITY;
#pragma unroll
    for (int i = 0; i < VPL; ++i) dq[r][i] = 0.f;
  }

  for (int c0 = kv_begin; c0 < kv_end; c0 += kBwdChunk) {
    __syncthreads();
    stage_rows_f32<DP>(Ks, kb, c0, a.skv, D);
    stage_rows_f32<DP>(Vs, vb, c0, a.skv, D);
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
    store_row<VPL>(dqb + (size_t)row[r] * D, dq[r], lane, D);
    if (lane == 0) a.delta[(size_t)bh * a.sq + row[r]] = delta[r];
  }
}

// dkv kernel: grid (ceil(Skv / 16), B * Hkv)
template <int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32) attention_bwd_dkv_fma_kernel(BwdArgs a) {
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
  const float* kb = static_cast<const float*>(a.k) + (size_t)bkv * a.skv * D;
  const float* vb = static_cast<const float*>(a.v) + (size_t)bkv * a.skv * D;
  float* dkb = static_cast<float*>(a.dk) + (size_t)bkv * a.skv * D;
  float* dvb = static_cast<float*>(a.dv) + (size_t)bkv * a.skv * D;
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
      load_row<VPL>(k[r], kb + (size_t)key[r] * D, lane, D);
      load_row<VPL>(v[r], vb + (size_t)key[r] * D, lane, D);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) k[r][i] = v[r][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) dk[r][i] = dv[r][i] = 0.f;
  }

  for (int gh = 0; gh < group; ++gh) {
    const int bh = b * a.hq + hk * group + gh;
    const float* qb = static_cast<const float*>(a.q) + (size_t)bh * a.sq * D;
    const float* gb = static_cast<const float*>(a.dout) + (size_t)bh * a.sq * D;
    const float* lb = a.lse + (size_t)bh * a.sq;
    const float* db = a.delta + (size_t)bh * a.sq;
    for (int c0 = q_begin; c0 < q_end; c0 += kBwdChunk) {
      __syncthreads();
      stage_rows_f32<DP>(Qs, qb, c0, a.sq, D);
      stage_rows_f32<DP>(Gs, gb, c0, a.sq, D);
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
    store_row<VPL>(dkb + (size_t)key[r] * D, dk[r], lane, D);
    store_row<VPL>(dvb + (size_t)key[r] * D, dv[r], lane, D);
  }
}

template <int VPL>
int launch_bwd_fma(const BwdArgs& a, const BwdLaunch& l, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_fma_kernel<VPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_fma_kernel<VPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, l.dkv_smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_fma_kernel<VPL><<<dim3(cdiv(a.sq, kBwdPerCta), a.b * a.hq), kBwdWarps * 32,
                                     l.dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_fma_kernel<VPL><<<dim3(cdiv(a.skv, kBwdPerCta), a.b * a.hkv), kBwdWarps * 32,
                                      l.dkv_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch over these shapes, with `parts` CTAs sharing a GQA group (the
// wrapper's choice: it sizes the workspace): each kernel's CTAs and shared
// bytes.  The one place that knows them; the query entry point reports
// them.  cudaErrorInvalidValue for what the kernels do not take.
int plan_bwd(int b, int hq, int hkv, int sq, int skv, int d, int dtype, int parts, BwdLaunch& l) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d > 256 || hq % hkv) return (int)cudaErrorInvalidValue;
  if (parts <= 0 || (hq / hkv) % parts) return (int)cudaErrorInvalidValue;
  long long dq, dkv;
  if (dtype == kBFloat16) {
    const int dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
    dq = (long long)cdiv(sq, kBwdMmaRows) * b * hq;
    dkv = (long long)cdiv(skv, kBwdMmaRows) * (dp > 128 ? 2 : 1) * parts * b * hkv;
    l.dq_smem = dp == 64 ? BwdMma<64>::kDqSmem : dp == 128 ? BwdMma<128>::kDqSmem : BwdMma<256>::kDqSmem;
    l.dkv_smem = dp == 64 ? BwdMma<64>::kDkvSmem : dp == 128 ? BwdMma<128>::kDkvSmem : BwdMma<256>::kDkvSmem;
  } else if (dtype == kFloat32) {
    if (parts != 1 || (long long)b * hq > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
    const int dp = d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
    dq = (long long)cdiv(sq, kBwdPerCta) * b * hq;
    dkv = (long long)cdiv(skv, kBwdPerCta) * b * hkv;
    // K and V chunks (dq); Q and dO chunks, then their lse and Delta (dkv)
    l.dq_smem = 2 * kBwdChunk * dp * (int)sizeof(float);
    l.dkv_smem = (2 * kBwdChunk * dp + 2 * kBwdChunk) * (int)sizeof(float);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (dq > 0x7fffffffLL || dkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  l.dq_ctas = (int)dq;
  l.dkv_ctas = (int)dkv;
  return (int)cudaSuccess;
}

}  // namespace repro

// C entry point bound with ctypes.  q, o, dout, dq (B,Hq,Sq,D); k, v, dk, dv
// (B,Hkv,Skv,D); all contiguous and of one dtype.  lse: the forward's
// (B*Hq*Sq) f32 row log-sum-exp; delta: f32 scratch of B*Hq*Sq floats; ws:
// null, or for the mma body with parts > 1, 2 * parts * B*Hkv*Skv*D f32.
// parts: the CTAs sharing a GQA group (kernels/flash_attention.py
// bwd_geometry).  Launches the dq kernel, then the dkv kernel (then, parts >
// 1, the kernel that adds the parts) on `stream`.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* delta, void* ws,
                                         int b, int hq, int hkv, int sq, int skv, int d, int dtype,
                                         int causal, int window, float softcap, float scale,
                                         int parts, void* stream) {
  using namespace repro;
  BwdLaunch l;
  const int rc = plan_bwd(b, hq, hkv, sq, skv, d, dtype, parts, l);
  if (rc != (int)cudaSuccess) return rc;
  if (parts > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = static_cast<const float*>(lse);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.delta = static_cast<float*>(delta); a.ws = static_cast<float*>(ws);
  a.b = b; a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv; a.d = d;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale; a.parts = parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    if (d <= 64) return launch_bwd_mma<64>(a, l, s);
    if (d <= 128) return launch_bwd_mma<128>(a, l, s);
    return launch_bwd_mma<256>(a, l, s);
  }
  if (d <= 32) return launch_bwd_fma<1>(a, l, s);
  if (d <= 64) return launch_bwd_fma<2>(a, l, s);
  if (d <= 128) return launch_bwd_fma<4>(a, l, s);
  return launch_bwd_fma<8>(a, l, s);
}

// C entry point bound with ctypes: what repro_flash_attention_bwd would
// launch over these shapes, into out[4] = (dq CTAs, dkv CTAs, dq shared
// bytes, dkv shared bytes).  Launches nothing.  cudaErrorInvalidValue where
// repro_flash_attention_bwd would refuse the shapes.
extern "C" int repro_flash_attention_bwd_geometry(int b, int hq, int hkv, int sq, int skv, int d,
                                                  int dtype, int parts, void* out) {
  using namespace repro;
  BwdLaunch l;
  const int rc = plan_bwd(b, hq, hkv, sq, skv, d, dtype, parts, l);
  if (rc != (int)cudaSuccess) return rc;
  int* o = static_cast<int*>(out);
  o[0] = l.dq_ctas; o[1] = l.dkv_ctas; o[2] = l.dq_smem; o[3] = l.dkv_smem;
  return (int)cudaSuccess;
}
