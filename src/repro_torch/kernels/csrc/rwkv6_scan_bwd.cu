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
// A first walk writes the f32 state at the start of every 16-token stage
// to a workspace; the reverse walk takes the stages last to first, recomputes
// a stage's 16 states from its checkpoint into shared memory with the
// forward kernel's arithmetic (its states bit for bit), then walks the
// stage's tokens backwards with G in registers.
//
// Layout: every element of S (and of G) evolves alone, so the state splits
// over CTAs by value columns, as in the forward: a CTA per (b, h, 16
// columns).  Inside it a thread holds one key row and 8 of the 16 columns
// (S and G: 8 registers each), so the row sums over the CTA's columns (dk,
// dr, dw) are a thread's own 8 plus its neighbour lane's, and the column sum
// (dv) is a butterfly over the 16 rows of a warp, then the warps' shares
// added in warp order at the stage's end.  The row sums span the D / 16
// CTAs of a head: each CTA writes its share to a workspace, and a second
// kernel adds the shares in CTA order and rounds.  The CTA of columns
// 0..15 adds the bonus terms and sums du's terms over its tokens in a fixed
// order; the second kernel adds the batch rows' du in order.  No atomics:
// the bits do not change from run to run.
//
// What bounds it: the operations, ~14 f32 per state element per token (the
// recompute, G, four products) on CUDA cores, against four D-vectors per
// token in and out.  Simple first: the stage's inputs are read by plain
// loads, not overlapped with the walk.
#include "common.cuh"

namespace repro {

constexpr int kWkvBwdStageT = 16;   // tokens per stage (and per checkpoint)
constexpr int kWkvBwdCols = 16;     // value columns per CTA
constexpr int kWkvBwdThreadCols = 8;  // columns per thread: two threads cover a row

struct Rwkv6BwdArgs {
  const void* r; const void* k; const void* v; const void* w; const float* u;
  const float* s0; const void* dy; const float* dsT;
  void* dv; float* ds0;
  float* ck;      // (B*H, stages, D, D) f32 checkpoints
  float* ws;      // (3, D/16, B*H*T*D) f32 row sums per CTA: dk, dr, dw
  float* du_part; // (B*H, D) f32
  int h, t, stages;
};

template <int D>
struct WkvBwdLayout {
  static constexpr int kThreads = 2 * D;          // a row per thread pair
  static constexpr int kWarps = kThreads / 32 > 0 ? kThreads / 32 : 1;
  static constexpr int kBlocks = D / kWkvBwdCols; // CTAs per (b, h)
};

template <int D>
size_t wkv_bwd_smem_bytes() {
  using L = WkvBwdLayout<D>;
  constexpr int N = kWkvBwdStageT;
  return sizeof(float) * ((size_t)5 * N * D                     // r, k, w, v, dy
                          + (size_t)N * L::kThreads * kWkvBwdThreadCols   // the stage's states
                          + (size_t)3 * N * D                   // row sums: dk, dr, dw
                          + (size_t)N * L::kWarps * kWkvBwdCols // column sums per warp
                          + 2 * N + D);                         // v.dy, r.(u k), u
}

__device__ __forceinline__ void ld8(float (&o)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w; o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void st8(float* p, const float (&o)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

template <typename T, int D>
__global__ void __launch_bounds__(WkvBwdLayout<D>::kThreads) rwkv6_scan_bwd_kernel(Rwkv6BwdArgs a) {
  using L = WkvBwdLayout<D>;
  constexpr int N = kWkvBwdStageT, CB = kWkvBwdCols, TC = kWkvBwdThreadCols;
  enum { kR = 0, kK = 1, kW = 2, kV = 3, kDy = 4 };
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                                  // [5][N][D]
  float* hist = in + 5 * N * D;                      // [N][threads][8]
  float* rowpart = hist + N * L::kThreads * TC;      // [N][3][D]
  float* colpart = rowpart + 3 * N * D;              // [N][warps][16]
  float* vdy = colpart + N * L::kWarps * CB;         // [N]
  float* ruk = vdy + N;                              // [N]
  float* s_u = ruk + N;                              // [D]

  const int bh = blockIdx.x / L::kBlocks, cb = blockIdx.x % L::kBlocks;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i = tid / 2;                     // key row
  const int jc = cb * CB + (tid % 2) * TC;   // this thread's first value column
  const size_t base = (size_t)bh * a.t * D;
  const size_t bhtd = (size_t)gridDim.x / L::kBlocks * a.t * D;
  const float* s0 = a.s0 + (size_t)bh * D * D;
  float* ckb = a.ck + (size_t)bh * a.stages * D * D;

  for (int q = tid; q < D; q += L::kThreads) s_u[q] = a.u[(size_t)(bh % a.h) * D + q];
  auto tokens = [&](int st) { return min(N, a.t - st * N); };
  // stage st's inputs [first, last] of (r, k, w, v, dy) into shared memory, as f32
  auto load = [&](int st, int first, int last) {
    const int n = tokens(st);
    const void* src[5] = {a.r, a.k, a.w, a.v, a.dy};
    for (int e = tid; e < (last - first + 1) * n * D; e += L::kThreads) {
      const int which = first + e / (n * D), rem = e % (n * D);
      in[(which * N) * D + rem] =
          to_f(static_cast<const T*>(src[which])[base + (size_t)st * N * D + rem]);
    }
  };
  // one token of the forward recurrence on this thread's 8 elements, as the
  // forward kernel computes it
  auto advance = [&](float (&S)[TC], int tt) {
    const float kk = in[(kK * N + tt) * D + i], ww = in[(kW * N + tt) * D + i];
    float vv[TC];
    ld8(vv, in + (kV * N + tt) * D + jc);
#pragma unroll
    for (int c = 0; c < TC; ++c) S[c] = fmaf(ww, S[c], __fmul_rn(kk, vv[c]));
  };

  // the forward walk: the state at the start of every stage
  float S[TC], G[TC];
  ld8(S, s0 + i * D + jc);
  for (int st = 0; st < a.stages; ++st) {
    st8(ckb + ((size_t)st * D + i) * D + jc, S);
    if (st + 1 == a.stages) break;
    __syncthreads();
    load(st, kK, kV);
    __syncthreads();
    for (int tt = 0; tt < N; ++tt) advance(S, tt);
  }

  // the reverse walk
  if (a.dsT != nullptr) {
    ld8(G, a.dsT + (size_t)bh * D * D + i * D + jc);
  } else {
#pragma unroll
    for (int c = 0; c < TC; ++c) G[c] = 0.f;
  }
  float du_acc = 0.f;   // row tid's sum of r k (v . dy) (CTA 0 of the head)
  T* dvb = static_cast<T*>(a.dv) + base;
  for (int st = a.stages - 1; st >= 0; --st) {
    const int n = tokens(st);
    __syncthreads();
    load(st, kR, kDy);
    __syncthreads();
    // the stage's states S_t, from its checkpoint
    ld8(S, ckb + ((size_t)st * D + i) * D + jc);
    for (int tt = 0; tt < n; ++tt) {
      st8(hist + ((size_t)tt * L::kThreads + tid) * TC, S);
      advance(S, tt);
    }
    // its tokens backwards: G holds G_{t+1}
    for (int tt = n - 1; tt >= 0; --tt) {
      const float rr = in[(kR * N + tt) * D + i], kk = in[(kK * N + tt) * D + i];
      const float ww = in[(kW * N + tt) * D + i];
      float vv[TC], dy[TC], St[TC], col[TC];
      ld8(vv, in + (kV * N + tt) * D + jc);
      ld8(dy, in + (kDy * N + tt) * D + jc);
      ld8(St, hist + ((size_t)tt * L::kThreads + tid) * TC);
      float dk = 0.f, dr = 0.f, dw = 0.f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        dk = fmaf(G[c], vv[c], dk);
        dr = fmaf(St[c], dy[c], dr);
        dw = fmaf(G[c], St[c], dw);
        col[c] = __fmul_rn(G[c], kk);
        G[c] = fmaf(ww, G[c], __fmul_rn(rr, dy[c]));
      }
      // row sums over the CTA's 16 columns: this thread's 8 and its neighbour's
      dk += __shfl_xor_sync(0xffffffffu, dk, 1);
      dr += __shfl_xor_sync(0xffffffffu, dr, 1);
      dw += __shfl_xor_sync(0xffffffffu, dw, 1);
      if (tid % 2 == 0) {
        rowpart[(tt * 3 + 0) * D + i] = dk;
        rowpart[(tt * 3 + 1) * D + i] = dr;
        rowpart[(tt * 3 + 2) * D + i] = dw;
      }
      // column sums over the warp's rows (lanes of one parity): a butterfly
      // that halves the 8 values at each of lane bits 4, 3 and 2, then bit 1
#pragma unroll
      for (int half = TC / 2, off = 16; half >= 1; half /= 2, off /= 2) {
        const bool up = (lane & off) != 0;
#pragma unroll
        for (int p = 0; p < half; ++p) {
          const float send = up ? col[p] : col[p + half];
          const float keep = up ? col[p + half] : col[p];
          col[p] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      col[0] += __shfl_xor_sync(0xffffffffu, col[0], 2);
      if ((lane & 2) == 0) {
        const int slot = 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
        colpart[(tt * L::kWarps + warp) * CB + (tid % 2) * TC + slot] = col[0];
      }
    }
    __syncthreads();
    // v . dy and r . (u k) of each token: a warp per token, lanes over D
    for (int tt = warp; tt < n; tt += L::kWarps) {
      float sv = 0.f, sr = 0.f;
      for (int q = lane; q < D; q += 32) {
        sv = fmaf(in[(kV * N + tt) * D + q], in[(kDy * N + tt) * D + q], sv);
        sr = fmaf(in[(kR * N + tt) * D + q], __fmul_rn(s_u[q], in[(kK * N + tt) * D + q]), sr);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
      }
      if (lane == 0) { vdy[tt] = sv; ruk[tt] = sr; }
    }
    __syncthreads();
    // dv: the warps' column sums in warp order, plus the bonus term
    for (int e = tid; e < n * CB; e += L::kThreads) {
      const int tt = e / CB, jj = e % CB;
      float s = colpart[(tt * L::kWarps) * CB + jj];
      for (int wp = 1; wp < L::kWarps; ++wp) s += colpart[(tt * L::kWarps + wp) * CB + jj];
      s = fmaf(ruk[tt], in[(kDy * N + tt) * D + cb * CB + jj], s);
      dvb[(size_t)(st * N + tt) * D + cb * CB + jj] = from_f<T>(s);
    }
    // dk, dr, dw: this CTA's shares (CTA 0 of the head adds the bonus terms)
    for (int e = tid; e < n * 3 * D; e += L::kThreads) {
      const int tt = e / (3 * D), which = (e / D) % 3, q = e % D;
      float s = rowpart[e];
      if (cb == 0 && which < 2) {
        const float other = in[((which == 0 ? kR : kK) * N + tt) * D + q];
        s = fmaf(__fmul_rn(s_u[q], other), vdy[tt], s);
      }
      a.ws[((size_t)which * L::kBlocks + cb) * bhtd + base + (size_t)(st * N + tt) * D + q] = s;
    }
    if (cb == 0 && tid < D) {
      for (int tt = n - 1; tt >= 0; --tt)
        du_acc = fmaf(__fmul_rn(in[(kR * N + tt) * D + tid], in[(kK * N + tt) * D + tid]),
                      vdy[tt], du_acc);
    }
  }
  st8(a.ds0 + (size_t)bh * D * D + i * D + jc, G);
  if (cb == 0 && tid < D) a.du_part[(size_t)bh * D + tid] = du_acc;
}

// dk, dr, dw: the CTAs' shares added in CTA order and rounded; du: the batch
// rows' sums added in order.
template <typename T>
__global__ void rwkv6_scan_bwd_finish_kernel(const float* ws, const float* du_part, void* dk,
                                             void* dr, void* dw, float* du, long long bhtd,
                                             int blocks, int b, int hd) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < 3 * bhtd) {
    const int which = (int)(e / bhtd);
    const long long o = e % bhtd;
    float s = ws[(long long)which * blocks * bhtd + o];
    for (int c = 1; c < blocks; ++c) s += ws[((long long)which * blocks + c) * bhtd + o];
    T* out = static_cast<T*>(which == 0 ? dk : which == 1 ? dr : dw);
    out[o] = from_f<T>(s);
  } else if (e < 3 * bhtd + hd) {
    const int q = (int)(e - 3 * bhtd);
    float s = du_part[q];
    for (int bb = 1; bb < b; ++bb) s += du_part[(size_t)bb * hd + q];
    du[q] = s;
  }
}

template <typename T, int D>
int launch_bwd(const Rwkv6BwdArgs& a, int ctas, void* dk, void* dr, void* dw, float* du, int b,
               cudaStream_t stream) {
  using L = WkvBwdLayout<D>;
  const size_t smem = wkv_bwd_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel<T, D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_bwd_kernel<T, D><<<ctas, L::kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long bhtd = (long long)b * a.h * a.t * D;
  const long long total = 3 * bhtd + (long long)a.h * D;
  const int threads = 256;
  rwkv6_scan_bwd_finish_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      a.ws, a.du_part, dk, dr, dw, du, bhtd, L::kBlocks, b, a.h * D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const Rwkv6BwdArgs& a, int d, int ctas, void* dk, void* dr, void* dw, float* du,
                 int b, cudaStream_t s) {
  if (d == 16) return launch_bwd<T, 16>(a, ctas, dk, dr, dw, du, b, s);
  if (d == 32) return launch_bwd<T, 32>(a, ctas, dk, dr, dw, du, b, s);
  if (d == 64) return launch_bwd<T, 64>(a, ctas, dk, dr, dw, du, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// C entry point bound with ctypes.  r/k/v/w/dy and dr/dk/dv/dw (B,H,T,D)
// contiguous, of one dtype; u/du (H,D) f32; s0/ds0 (B,H,D,D) f32; dsT
// (B,H,D,D) f32 or null (the final state's gradient, 0 where null);
// workspaces: ck (B*H, ceil(T/16), D, D), ws (3, D/16, B*H*T*D) and du_part
// (B*H, D), all f32.  (cols, stage_t, ctas): the launch layout the wrapper
// chose (kernels/rwkv6_scan.py bwd_geometry), re-checked here.  Launches
// the walk kernel, then the kernel that adds the CTAs' shares.  Returns a
// cudaError_t (cudaErrorInvalidValue for a layout or shape it does not take).
extern "C" int repro_rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                                    const void* u, const void* s0, const void* dy,
                                    const void* dsT, void* dr, void* dk, void* dv, void* dw,
                                    void* du, void* ds0, void* ck, void* ws, void* du_part,
                                    int b, int h, int t, int d, int dtype, int cols, int stage_t,
                                    int ctas, void* stream) {
  using namespace repro;
  if (b <= 0 || h <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (d != 16 && d != 32 && d != 64) return (int)cudaErrorInvalidValue;
  if (cols != kWkvBwdCols || stage_t != kWkvBwdStageT) return (int)cudaErrorInvalidValue;
  const long long want = (long long)b * h * (d / kWkvBwdCols);
  if (want != ctas || want > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Rwkv6BwdArgs a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0); a.dy = dy; a.dsT = static_cast<const float*>(dsT);
  a.dv = dv; a.ds0 = static_cast<float*>(ds0);
  a.ck = static_cast<float*>(ck); a.ws = static_cast<float*>(ws);
  a.du_part = static_cast<float*>(du_part);
  a.h = h; a.t = t; a.stages = cdiv(t, kWkvBwdStageT);
  float* duf = static_cast<float*>(du);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return dispatch_bwd<__nv_bfloat16>(a, d, ctas, dk, dr, dw, duf, b, s);
  if (dtype == kFloat32) return dispatch_bwd<float>(a, d, ctas, dk, dr, dw, duf, b, s);
  return (int)cudaErrorInvalidValue;
}
