// Backward of the wkv6 recurrence (RWKV6 / Finch time-mix) for Hopper
// (sm_90a): dr, dk, dv, dw, du and the initial state's gradient.
//
// The reference has no Pallas backward: jax.value_and_grad differentiates
// its scan (src/repro/kernels/rwkv6_scan.py, rwkv6_scan() / _kernel, on the
// default "ref" backend: repro.kernels.ref.rwkv6_scan) through XLA.  In the
// port a CUDA tensor never takes a plain version, so the gradient of every
// K3 launch of a training step comes from these kernels.
//
// For one (b, h), key row i and value column j, with S_t the state before
// token t and G_t = dL/dS_t (G_T the final state's gradient):
//   G_t     = diag(w_t) G_{t+1} + r_t dy_t^T
//   dr_t[i] = sum_j S_t[i,j] dy_t[j]        + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_{t+1}[i,j] v_t[j]     + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_{t+1}[i,j] k_t[i]     + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_{t+1}[i,j] S_t[i,j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t),    dS_0 = G_0.
//
// dw needs S_t and G_{t+1} at once: S runs forward, G backward, and S is
// never rebuilt backwards by dividing by w (w = exp(-exp(.)) can be near 0).
// So a walk kernel writes the f32 state at the start of every 16-token
// segment to a workspace, and the reverse kernel takes the segments last to
// first, recomputing each one's states from its checkpoint with the forward
// kernel's arithmetic (its states bit for bit) beside G.
//
// Layout: every element of S (and of G) evolves alone, so the state splits
// over CTAs by value columns, as in the forward: a CTA per (b, h, 16
// columns), a thread per key row and 8 of the 16 columns (S and G: 8
// registers each).  Row sums over the CTA's columns (dk, dr, dw) are a
// thread's own 8 plus its neighbour lane's.
//
// What the reverse kernel does about what held the first, simpler design
// back (walk and reverse in one kernel: 2.338 ms at 4x32x512x64, 41.7x its
// operations bound; 103 KB of shared memory, so 2 CTAs of 4 warps an SM;
// plain-load staging between barriers; an 8-shuffle butterfly per token for
// dv; the row sums through a 201 MB workspace and a second kernel):
//  * the states of a sub-stage (8 tokens) stay in registers: 64 f32 a
//    thread, recomputed from the segment's checkpoint (the second half of a
//    segment advances through the first half again: 1.5 recomputed tokens
//    a token), so no shared copy of them is kept.  With the inputs staged in
//    their own dtype, shared memory is ~49 KB at D = 64 in bf16 (4 CTAs an
//    SM; 69 KB in f32);
//  * r, k, w, v and dy of the next segment are in flight (16-byte
//    cp.async into the other half of a two-segment ring) while the current
//    one is walked;
//  * dv's column sums: per token, one shuffle adds each pair of rows (the
//    pair trading halves of its 8 columns) and the pair sums are written to
//    shared memory; once per sub-stage each thread adds one column of one
//    token over the D / 2 row pairs, in order;
//  * dk, dr and dw's sums over a head's D / 16 CTAs stay on chip: the CTAs
//    of a head form a thread-block cluster; each writes its row sums to its
//    shared memory (two buffers), and after one cluster barrier per
//    sub-stage the CTA of rank r adds rows [16r, 16r + 16) of every rank in
//    rank order, reading the others' shared memory directly, adds the bonus
//    terms and writes the outputs.  No workspace, no second pass for them.
// du: the CTA of rank 0 sums its head's terms over the tokens in reverse
// order; a small kernel adds the batch rows' sums in order.  No atomics
// anywhere: the bits do not change from run to run, nor between a batch
// row at B = 1 and at B = 4.
//
// ptxas -v, sm_90a: the reverse kernel 119 registers in bf16 at D = 64
// (capped at 128 for 4 CTAs an SM), no spills; the walk kernel 40.
//
// What bounds it: the operations, ~14 f32 per state element per token (the
// recompute, G, four products) on CUDA cores, against four D-vectors per
// token in and out.  chip_smoke.py times each kernel apart (profiler, per
// kernel) beside an earlier tree's (--scans-ab).  Measured at 4x32x512x64,
// bf16 (NVIDIA H100 80GB HBM3, 700.00 W): the first design's walk-and-reverse
// kernel took 2.12 ms of device time and its finish kernel 0.111 ms; here the
// walk takes 0.064 ms, the reverse kernel 0.574 ms and du's sum 0.002 ms.
// The checkpoint walk and the reverse walk could not be timed apart before
// this design: the first design ran both in one kernel.  So the split above
// was measured after the redesign, from these kernels, and did not choose
// it; it confirms that the reverse walk (~90% of the time) is where the
// cost lies, and the walk stays a plain forward pass.
#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr int kWkvBwdStageT = 16;   // tokens per segment (and per checkpoint)
constexpr int kWkvBwdSubT = 8;      // tokens per reverse sub-stage (states in registers)
constexpr int kWkvBwdCols = 16;     // value columns per CTA
constexpr int kWkvBwdThreadCols = 8;  // columns per thread: two threads cover a row
enum { kWkvR = 0, kWkvK = 1, kWkvW = 2, kWkvV = 3, kWkvDy = 4 };

struct Rwkv6BwdArgs {
  const void* r; const void* k; const void* v; const void* w; const float* u;
  const float* s0; const void* dy; const float* dsT;
  void* dr; void* dk; void* dv; void* dw; float* ds0;
  float* ck;      // (B*H, stages, D, D) f32 checkpoints
  float* du_part; // (B*H, D) f32
  int h, t, stages;
};

template <int D>
struct WkvBwdLayout {
  static constexpr int kThreads = 2 * D;           // a row per thread pair
  static constexpr int kWarps = kThreads / 32 > 0 ? kThreads / 32 : 1;
  static constexpr int kBlocks = D / kWkvBwdCols;  // CTAs per (b, h): the cluster
  // floats of one token's row-pair column sums, padded against bank conflicts
  static constexpr int kColStride = (D / 2) * kWkvBwdCols + 16;
};

// walk kernel: k, w, v of a segment, twice (a ring of two)
template <typename T, int D>
constexpr int wkv_bwd_walk_smem_bytes() {
  return 2 * 3 * kWkvBwdStageT * D * (int)sizeof(T);
}
// reverse kernel: r, k, w, v, dy of a segment twice; the sub-stage's
// row-pair column sums; the row sums twice; v.dy and r.(u k) per token; u
template <typename T, int D>
constexpr int wkv_bwd_smem_bytes() {
  using L = WkvBwdLayout<D>;
  return 2 * 5 * kWkvBwdStageT * D * (int)sizeof(T) +
         4 * (kWkvBwdSubT * L::kColStride + 2 * kWkvBwdSubT * 3 * D + 2 * kWkvBwdStageT + D);
}

// 8 consecutive values of shared memory into f32 registers
__device__ __forceinline__ void ld8(float (&o)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w; o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void ld8(float (&o)[8], const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);   // a bf16 is the high half of an f32
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st8(float* p, const float (&o)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

// Segment `seg` of `count` tensors from `first` (of r, k, w, v, dy) into
// shared memory dst[which - first][16][D] in their own dtype: 16-byte
// cp.async copies, zeros past the last token.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void wkv_stage(T* dst, const void* const (&src)[5], int first, int count,
                                          size_t base, int seg, int t) {
  constexpr int kPer = 16 / (int)sizeof(T);            // elements of one copy
  constexpr int kCopies = kWkvBwdStageT * D / kPer;    // copies of one tensor's segment
  const int live = min(kWkvBwdStageT, t - seg * kWkvBwdStageT) * D / kPer;
  const size_t o = base + (size_t)seg * kWkvBwdStageT * D;
  for (int e = threadIdx.x; e < count * kCopies; e += THREADS) {
    const int which = e / kCopies, c = e % kCopies;
    const T* s = static_cast<const T*>(src[first + which]) + o;
    cp_async16(smem_addr(dst + (which * kWkvBwdStageT) * D + c * kPer), c < live ? s + c * kPer : s,
               c < live ? 16 : 0);
  }
}

// one token of the forward recurrence on a thread's 8 elements, as the
// forward kernel computes it: S = w S + k v
template <typename T>
__device__ __forceinline__ void wkv_advance(float (&S)[8], const T* kp, const T* wp, const T* vp) {
  const float kk = to_f(*kp), ww = to_f(*wp);
  float vv[8];
  ld8(vv, vp);
#pragma unroll
  for (int c = 0; c < 8; ++c) S[c] = fmaf(ww, S[c], __fmul_rn(kk, vv[c]));
}

// The walk: the f32 state at the start of every segment, into ck.
template <typename T, int D>
__global__ void __launch_bounds__(WkvBwdLayout<D>::kThreads) rwkv6_scan_bwd_walk_kernel(Rwkv6BwdArgs a) {
  using L = WkvBwdLayout<D>;
  constexpr int N = kWkvBwdStageT, TC = kWkvBwdThreadCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [2][k, w, v][N][D]
  const int bh = blockIdx.x / L::kBlocks, cb = blockIdx.x % L::kBlocks;
  const int tid = threadIdx.x, i = tid / 2, jc = cb * kWkvBwdCols + (tid % 2) * TC;
  const size_t base = (size_t)bh * a.t * D;
  const void* const src[5] = {a.r, a.k, a.w, a.v, a.dy};
  float* ckb = a.ck + (size_t)bh * a.stages * D * D;
  auto slot_of = [&](int st) { return ring + (size_t)(st & 1) * 3 * N * D; };

  float S[TC];
  ld8(S, a.s0 + (size_t)bh * D * D + i * D + jc);
  if (a.stages > 1) wkv_stage<T, D, L::kThreads>(slot_of(0), src, kWkvK, 3, base, 0, a.t);
  cp_async_commit();
  for (int st = 0; st < a.stages; ++st) {
    st8(ckb + ((size_t)st * D + i) * D + jc, S);
    if (st + 1 == a.stages) break;   // the last segment's tokens change no checkpoint
    cp_async_wait<0>();
    __syncthreads();   // segment st has landed, and st - 1's slot is free
    if (st + 2 < a.stages) wkv_stage<T, D, L::kThreads>(slot_of(st + 1), src, kWkvK, 3, base, st + 1, a.t);
    cp_async_commit();
    const T* in = slot_of(st);
#pragma unroll 4
    for (int tt = 0; tt < N; ++tt)
      wkv_advance(S, in + tt * D + i, in + (N + tt) * D + i, in + (2 * N + tt) * D + jc);
  }
  cp_async_wait<0>();
}

// The reverse walk: a cluster of the head's D / 16 CTAs.
template <typename T, int D>
__global__ void __launch_bounds__(WkvBwdLayout<D>::kThreads, 512 / WkvBwdLayout<D>::kThreads)
    rwkv6_scan_bwd_kernel(Rwkv6BwdArgs a) {
  using L = WkvBwdLayout<D>;
  constexpr int N = kWkvBwdStageT, NS = kWkvBwdSubT, CB = kWkvBwdCols, TC = kWkvBwdThreadCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                       // [2][5][N][D]
  float* colbuf = reinterpret_cast<float*>(ring + 2 * 5 * N * D);  // [NS][kColStride]
  float* rowpart = colbuf + NS * L::kColStride;                   // [2][NS][3][D]
  float* vdy = rowpart + 2 * NS * 3 * D;                          // [N]
  float* ruk = vdy + N;                                           // [N]
  float* s_u = ruk + N;                                           // [D]

  cg::cluster_group cluster = cg::this_cluster();
  const int bh = blockIdx.x / L::kBlocks, cb = blockIdx.x % L::kBlocks;   // cb: the cluster rank
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i = tid / 2, half = tid % 2;
  const int jc = cb * CB + half * TC;        // this thread's first value column
  const bool odd = (lane & 2) != 0;          // row i is the odd one of its pair
  const size_t base = (size_t)bh * a.t * D;
  const void* const src[5] = {a.r, a.k, a.w, a.v, a.dy};
  const float* ckb = a.ck + (size_t)bh * a.stages * D * D;
  auto out = [&](void* p, int tok, int col) -> T& {
    return static_cast<T*>(p)[base + (size_t)tok * D + col];
  };

  for (int q = tid; q < D; q += L::kThreads) s_u[q] = a.u[(size_t)(bh % a.h) * D + q];
  float G[TC];
  if (a.dsT != nullptr) {
    ld8(G, a.dsT + (size_t)bh * D * D + i * D + jc);
  } else {
#pragma unroll
    for (int c = 0; c < TC; ++c) G[c] = 0.f;
  }
  float du_acc = 0.f;   // row tid's sum of r k (v . dy) (rank 0)
  int rp = 0;           // the row-sum buffer of this sub-stage

  wkv_stage<T, D, L::kThreads>(ring + (size_t)((a.stages - 1) & 1) * 5 * N * D, src, 0, 5, base,
                               a.stages - 1, a.t);
  cp_async_commit();
  for (int seg = a.stages - 1; seg >= 0; --seg) {
    const int n = min(N, a.t - seg * N);
    cp_async_wait<0>();
    __syncthreads();   // segment seg has landed, and seg + 1's slot is free
    if (seg > 0) wkv_stage<T, D, L::kThreads>(ring + (size_t)((seg - 1) & 1) * 5 * N * D, src, 0, 5,
                                              base, seg - 1, a.t);
    cp_async_commit();
    const T* in = ring + (size_t)(seg & 1) * 5 * N * D;
    auto at = [&](int which, int tt, int col) { return in + (which * N + tt) * D + col; };

    // v . dy and r . (u k) of each token: a warp per token, lanes over D, in order
    for (int tt = warp; tt < n; tt += L::kWarps) {
      float sv = 0.f, sr = 0.f;
      for (int q = lane; q < D; q += 32) {
        sv = fmaf(to_f(*at(kWkvV, tt, q)), to_f(*at(kWkvDy, tt, q)), sv);
        sr = fmaf(to_f(*at(kWkvR, tt, q)), __fmul_rn(s_u[q], to_f(*at(kWkvK, tt, q))), sr);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
      }
      if (lane == 0) { vdy[tt] = sv; ruk[tt] = sr; }
    }
    __syncthreads();

    for (int sub = 1; sub >= 0; --sub) {
      const int t0 = sub * NS, nh = min(NS, n - t0);
      if (nh <= 0) continue;
      // the sub-stage's states S_t, recomputed from the segment's checkpoint
      float S[TC], H[NS][TC];
      ld8(S, ckb + ((size_t)seg * D + i) * D + jc);
      if (sub == 1) {
#pragma unroll
        for (int tt = 0; tt < NS; ++tt) wkv_advance(S, at(kWkvK, tt, i), at(kWkvW, tt, i), at(kWkvV, tt, jc));
      }
#pragma unroll
      for (int tt = 0; tt < NS; ++tt) {
#pragma unroll
        for (int c = 0; c < TC; ++c) H[tt][c] = S[c];
        if (tt + 1 < nh) wkv_advance(S, at(kWkvK, t0 + tt, i), at(kWkvW, t0 + tt, i), at(kWkvV, t0 + tt, jc));
      }
      // its tokens backwards: G holds G_{t+1}
      float* rows = rowpart + rp * NS * 3 * D;
#pragma unroll
      for (int tt = NS - 1; tt >= 0; --tt) {
        if (tt >= nh) continue;
        const int tl = t0 + tt;
        const float rr = to_f(*at(kWkvR, tl, i)), kk = to_f(*at(kWkvK, tl, i));
        const float ww = to_f(*at(kWkvW, tl, i));
        float vv[TC], dy[TC], col[TC];
        ld8(vv, at(kWkvV, tl, jc));
        ld8(dy, at(kWkvDy, tl, jc));
        float dk = 0.f, dr = 0.f, dw = 0.f;
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          dk = fmaf(G[c], vv[c], dk);
          dr = fmaf(H[tt][c], dy[c], dr);
          dw = fmaf(G[c], H[tt][c], dw);
          col[c] = __fmul_rn(G[c], kk);
          G[c] = fmaf(ww, G[c], __fmul_rn(rr, dy[c]));
        }
        // row sums over the CTA's 16 columns: this thread's 8 and its neighbour's
        dk += __shfl_xor_sync(0xffffffffu, dk, 1);
        dr += __shfl_xor_sync(0xffffffffu, dr, 1);
        dw += __shfl_xor_sync(0xffffffffu, dw, 1);
        if (half == 0) {
          rows[(tt * 3 + 0) * D + i] = dk;
          rows[(tt * 3 + 1) * D + i] = dr;
          rows[(tt * 3 + 2) * D + i] = dw;
        }
        // column parts: the pair of rows (i, i ^ 1) trades halves of its 8
        // columns and adds, so each thread writes 4 pair sums
        float pair[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float send = odd ? col[p] : col[p + 4];
          pair[p] = (odd ? col[p + 4] : col[p]) + __shfl_xor_sync(0xffffffffu, send, 2);
        }
        *reinterpret_cast<float4*>(colbuf + tt * L::kColStride + (i >> 1) * CB + half * TC + (odd ? 4 : 0)) =
            make_float4(pair[0], pair[1], pair[2], pair[3]);
      }
      __syncthreads();
      // dv: one token's column over the D / 2 row pairs, in order, plus the bonus term
      for (int e = tid; e < nh * CB; e += L::kThreads) {
        const int tt = e / CB, jj = e % CB;
        const float* cp = colbuf + tt * L::kColStride + jj;
        float s = cp[0];
        for (int p = 1; p < D / 2; ++p) s += cp[p * CB];
        s = fmaf(ruk[t0 + tt], to_f(*at(kWkvDy, t0 + tt, cb * CB + jj)), s);
        out(a.dv, seg * N + t0 + tt, cb * CB + jj) = from_f<T>(s);
      }
      cluster.sync();   // every rank's row sums of this sub-stage are written
      // dk, dr, dw of rows [16 cb, 16 cb + 16): the ranks' shares in rank order
      for (int e = tid; e < nh * 3 * CB; e += L::kThreads) {
        const int tt = e / (3 * CB), which = (e / CB) % 3, q = cb * CB + e % CB;
        const int off = rp * NS * 3 * D + (tt * 3 + which) * D + q;
        float s = cluster.map_shared_rank(rowpart, 0)[off];
        for (int rk = 1; rk < L::kBlocks; ++rk) s += cluster.map_shared_rank(rowpart, rk)[off];
        if (which < 2) {   // the bonus: u k (v . dy) for dr, u r (v . dy) for dk
          const float other = to_f(*at(which == 0 ? kWkvR : kWkvK, t0 + tt, q));
          s = fmaf(__fmul_rn(s_u[q], other), vdy[t0 + tt], s);
        }
        out(which == 0 ? a.dk : which == 1 ? a.dr : a.dw, seg * N + t0 + tt, q) = from_f<T>(s);
      }
      if (cb == 0 && tid < D) {
        for (int tt = nh - 1; tt >= 0; --tt)
          du_acc = fmaf(__fmul_rn(to_f(*at(kWkvR, t0 + tt, tid)), to_f(*at(kWkvK, t0 + tt, tid))),
                        vdy[t0 + tt], du_acc);
      }
      rp ^= 1;
    }
  }
  cp_async_wait<0>();
  st8(a.ds0 + (size_t)bh * D * D + i * D + jc, G);
  if (cb == 0 && tid < D) a.du_part[(size_t)bh * D + tid] = du_acc;
  cluster.sync();   // no CTA leaves while another still reads its row sums
}

// du: the batch rows' sums added in order.
__global__ void rwkv6_scan_bwd_du_kernel(const float* du_part, float* du, int b, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hd) return;
  float s = du_part[e];
  for (int bb = 1; bb < b; ++bb) s += du_part[(size_t)bb * hd + e];
  du[e] = s;
}

// A launch's CTAs (both kernels), cluster size and shared bytes (plan_bwd).
struct WkvBwdLaunch {
  int ctas, cluster, walk_smem, smem;
};

template <typename T, int D>
WkvBwdLaunch wkv_bwd_launch(long long bh) {
  return {(int)(bh * WkvBwdLayout<D>::kBlocks), WkvBwdLayout<D>::kBlocks,
          wkv_bwd_walk_smem_bytes<T, D>(), wkv_bwd_smem_bytes<T, D>()};
}

// The launch over (B, H, T, D) in `dtype`: the one place that knows it; the
// query entry point reports it.  cudaErrorInvalidValue for what the kernels
// do not take.
int plan_bwd(int b, int h, int t, int d, int dtype, WkvBwdLaunch& l) {
  if (b <= 0 || h <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (d != 16 && d != 32 && d != 64) return (int)cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const long long bh = (long long)b * h;
  if (bh * (d / kWkvBwdCols) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool bf = dtype == kBFloat16;
  if (d == 16) l = bf ? wkv_bwd_launch<__nv_bfloat16, 16>(bh) : wkv_bwd_launch<float, 16>(bh);
  if (d == 32) l = bf ? wkv_bwd_launch<__nv_bfloat16, 32>(bh) : wkv_bwd_launch<float, 32>(bh);
  if (d == 64) l = bf ? wkv_bwd_launch<__nv_bfloat16, 64>(bh) : wkv_bwd_launch<float, 64>(bh);
  return (int)cudaSuccess;
}

template <typename T, int D>
int launch_bwd(const Rwkv6BwdArgs& a, const WkvBwdLaunch& l, float* du, int b, cudaStream_t stream) {
  using L = WkvBwdLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_bwd_walk_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.walk_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             l.smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_bwd_walk_kernel<T, D><<<l.ctas, L::kThreads, l.walk_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.ctas);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rwkv6_scan_bwd_kernel<T, D>, a);
  if (err != cudaSuccess) return (int)err;
  const int hd = a.h * D, threads = 256;
  rwkv6_scan_bwd_du_kernel<<<(hd + threads - 1) / threads, threads, 0, stream>>>(a.du_part, du, b, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const Rwkv6BwdArgs& a, int d, const WkvBwdLaunch& l, float* du, int b,
                 cudaStream_t s) {
  if (d == 16) return launch_bwd<T, 16>(a, l, du, b, s);
  if (d == 32) return launch_bwd<T, 32>(a, l, du, b, s);
  return launch_bwd<T, 64>(a, l, du, b, s);
}

}  // namespace repro

// C entry point bound with ctypes.  r/k/v/w/dy and dr/dk/dv/dw (B,H,T,D)
// contiguous, of one dtype, r/k/v/w/dy 16-byte aligned; u/du (H,D) f32;
// s0/ds0 (B,H,D,D) f32; dsT (B,H,D,D) f32 or null (the final state's
// gradient, 0 where null); workspaces: ck (B*H, ceil(T/stage_t), D, D) and
// du_part (B*H, D), both f32.  stage_t: the tokens between checkpoints the
// wrapper sized ck by (kernels/rwkv6_scan.py BWD_STAGE_T), re-checked here.
// Launches the walk kernel, the reverse kernel (clusters of D / 16 CTAs) and
// the kernel that adds du's batch rows.  Returns a cudaError_t
// (cudaErrorInvalidValue for a layout or shape it does not take,
// cudaErrorMisalignedAddress for inputs not 16-byte aligned).
extern "C" int repro_rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                                    const void* u, const void* s0, const void* dy,
                                    const void* dsT, void* dr, void* dk, void* dv, void* dw,
                                    void* du, void* ds0, void* ck, void* du_part,
                                    int b, int h, int t, int d, int dtype, int stage_t,
                                    void* stream) {
  using namespace repro;
  WkvBwdLaunch l;
  const int rc = plan_bwd(b, h, t, d, dtype, l);
  if (rc != (int)cudaSuccess) return rc;
  if (stage_t != kWkvBwdStageT) return (int)cudaErrorInvalidValue;
  if (!(aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) && aligned16(dy)))
    return (int)cudaErrorMisalignedAddress;
  Rwkv6BwdArgs a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0); a.dy = dy; a.dsT = static_cast<const float*>(dsT);
  a.dr = dr; a.dk = dk; a.dv = dv; a.dw = dw; a.ds0 = static_cast<float*>(ds0);
  a.ck = static_cast<float*>(ck);
  a.du_part = static_cast<float*>(du_part);
  a.h = h; a.t = t; a.stages = cdiv(t, kWkvBwdStageT);
  float* duf = static_cast<float*>(du);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch_bwd<__nv_bfloat16>(a, d, l, duf, b, s);
  return dispatch_bwd<float>(a, d, l, duf, b, s);
}

// C entry point bound with ctypes: what repro_rwkv6_scan_bwd would launch
// over (B, H, T, D) in `dtype`, into out[4] = (CTAs of each kernel, CTAs per
// cluster, walk kernel's shared bytes, reverse kernel's).  Launches nothing.
// cudaErrorInvalidValue where repro_rwkv6_scan_bwd would refuse the shape.
extern "C" int repro_rwkv6_scan_bwd_geometry(int b, int h, int t, int d, int dtype, void* out) {
  using namespace repro;
  WkvBwdLaunch l;
  const int rc = plan_bwd(b, h, t, d, dtype, l);
  if (rc != (int)cudaSuccess) return rc;
  int* o = static_cast<int*>(out);
  o[0] = l.ctas; o[1] = l.cluster; o[2] = l.walk_smem; o[3] = l.smem;
  return (int)cudaSuccess;
}
