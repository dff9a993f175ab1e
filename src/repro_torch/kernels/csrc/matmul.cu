// Schedule-driven matmul with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/matmul.py (build_call /
// _kernel), reached through matmul() (K1): out = epilogue(x(M,K) @ w(K,N))
// with an f32 accumulator and the epilogue applied once the whole K range is
// summed; and through grouped_matmul() (K1g, the MoE expert GEMM):
// out[e] = epilogue(x[e] @ w[e]) for x(E,M,K), w(E,K,N).
//
// K1g is K1's bodies under a second grid axis, as in the reference (a leading
// expert grid axis over the same kernel body): blockIdx.y = e offsets x, w
// and out by one expert's extent (in size_t: dbrx's w_in stack has 2.1e9
// elements), and the tiles of one expert are masked at that expert's own M
// and N edges, so a ragged tile never reads or writes the next expert's rows.
//
// Three bodies, chosen by the dtype and the schedule's M tile (the wrapper,
// kernels/matmul.py body_for, makes the same choice and counts launches per
// body):
//
//  * rows (tile_m <= 16, either dtype: decode and the 1-row prefill LM head):
//    w's bytes bound it.  A CTA covers one 64-column strip of one logical
//    tile over one K slice; its 256 threads each stream 16-byte vectors of w
//    (eight loads in flight before their FMAs), 8 (bf16) or 16 (f32) threads
//    across the strip and the rest down K.  Where the strips alone launch
//    fewer than two CTAs per SM, K is split across CTAs (split_k, from
//    kernels/matmul.py rows_geometry, a function of K, N, the N tile and the
//    expert count only): each slice writes f32 partial sums to a workspace
//    and a second pass adds them in slice order and applies the epilogue
//    once.  No float atomics; a row's summation order never depends on M.
//    Rows go in passes of 4; x is read through L1, where lanes share it.
//  * mma (bf16, tile_m > 16: every prefill projection and expert GEMM): the
//    tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, operands read from
//    shared memory with ldmatrix (.trans for w, which is (K, N) row-major).
//    A ring of 4 shared stages, each 32 deep in K, is filled by 16-byte
//    cp.async copies, so the next K slices load while this one multiplies.
//    Shared rows are padded by 16 bytes, so the 8 rows one ldmatrix reads
//    fall in 8 distinct bank groups.  w's bytes bound it below ~300 rows
//    per expert (the H100 does ~295 bf16 operations per byte of HBM), the
//    operations above.
//  * fma (f32, tile_m > 16: the main path's one f32 caller is mixtral's
//    router): CUDA-core FMA on 64x64x16 shared tiles, a 4x4 micro-tile per
//    thread.  f32 stays off the tensor cores by rule: TF32 keeps about three
//    decimal digits and the f32 tolerance is 2e-4.  This is a dtype rule,
//    not a fallback: no bf16 call reaches this body.
//
// Logical tile and CTA tile.  The schedule's (tile_m x tile_n) output tile is
// the unit of rasterisation and of edge masking: logical tiles are numbered
// in the schedule's order (m_outer: M is the outer loop, so consecutive tiles
// walk along N).  The fma body runs one CTA per logical tile and walks it in
// sub-blocks.  The rows body covers a logical tile with 64-column strips,
// each split into split_k K slices (numbered strip-major, slices together).
// The mma body runs a compiled CTA tile (128x128,
// 64x128 or 64x64) and covers each logical tile with sub_m x sub_n CTAs,
// numbered consecutively along N, so they run together and share the tile's
// x rows and w columns in L2; a logical tile smaller than the CTA tile gets
// one CTA, masked at the logical tile's edge.  The wrapper chooses the CTA
// tile (kernels/matmul.py tiled_geometry: the largest that fits the logical
// tile and still launches at least one CTA per SM, 132, where M and N allow)
// and run() re-checks the CTA count it passes.
//
// Every body masks the ragged edges of M, N and K itself (the mma body
// zero-fills its stages: cp.async's src-size form, or guarded scalar loads
// where a row of x or w does not start on 16 bytes).  A GLU pair (gate at
// even column n, up at n + 1) stays in one thread in every body.
//
// Rounding mode (round_k > 0; kernels/matmul.py round_k_for).  Without its
// f32 scratch (cache_write off, or K not the innermost grid axis) the
// reference adds each K tile's f32 product to a sum held in the bf16 output
// block, so the sum is rounded to bf16 after every K tile but the last:
// o = bf16(p_0), o = bf16(o + p_j), out = epilogue(o + p_last).  round_k is
// that K tile; it divides K.  Only bf16 non-GLU launches round (the GLU
// classes always take the scratch; for f32 the rounding is the identity), so
// the fma body never does.  The rows body chains the K tiles inside one CTA
// (matmul_rows_round_kernel, K never split); the mma body rounds its f32
// accumulator fragments in place where a K tile ends, and splits an MMA step
// that a tile boundary crosses (mma_round_step).
//
// Z (K1 only, under the `dots` remat policy: kernels/matmul.py MatmulFn).
// Where the caller passes z, every body also writes Z = the pre-epilogue sum
// plus the bias, (M, N) in x's dtype, beside the output: the value a kNone
// launch (class matmul, or matmul_bias with the bias) of the same schedule
// writes, bit for bit, since it is the same f32 sum rounded once.  The
// output's bits do not change; a null z writes nothing (K1g passes none).
//
// f32 output (out_f32, K1 and K1g).  A row-parallel product under tensor
// parallelism gives each rank partial sums over its slice of K, which the
// ranks add over the `model` axis before anything rounds them (the
// reference's dot gives f32 and its cast follows the sum).  With out_f32
// every body writes the epilogue's f32 value to an f32 `out` instead of
// rounding it to x's dtype; the sums, their order and Z are unchanged, so a
// launch without it keeps its bits.
#include <algorithm>

#include "mma.cuh"

namespace repro {

enum Epilogue : int {
  kNone = 0, kGelu = 1, kSiluGlu = 2, kGeluGlu = 3, kResidual = 4, kSoftcap = 5
};

struct MatmulArgs {
  const void* x; const void* w; const float* bias; const float* residual; void* out;
  void* z;                      // Z (M, N), the pre-epilogue sums plus bias, or null
  int m, n, k, n_out;           // per expert when grouped
  int epi; float softcap;
  int tile_m, tile_n, tiles_m, tiles_n, m_outer;   // logical tiles
  int cta_m, cta_n, sub_m, sub_n, ctas;   // CTA tile, CTAs per logical tile in M and N, gridDim.x
  int groups;                   // experts (gridDim.y); 1 for a plain matmul
  int split_k;                  // rows body: K slices per strip (1 in the others)
  float* ws;                    // rows body, split_k > 1: f32 partial sums (E, split_k, M, N)
  int round_k;                  // rounding mode's K tile (0: f32 sums throughout)
  int out_f32;                  // out is f32 (the unrounded epilogue), else x's dtype
};

// f32 -> bf16 -> f32: a partial sum as the reference's bf16 output block holds it
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// This CTA's expert's slices of x, w, out and z (blockIdx.y = expert);
// out32 is out where the launch writes f32 (null otherwise).
template <typename T>
struct ExpertPtrs {
  const T* x; const T* w; T* out; T* z; float* out32;
  __device__ __forceinline__ explicit ExpertPtrs(const MatmulArgs& a) {
    const size_t e = blockIdx.y;
    x = static_cast<const T*>(a.x) + e * a.m * a.k;
    w = static_cast<const T*>(a.w) + e * a.k * a.n;
    out = static_cast<T*>(a.out) + e * a.m * a.n_out;
    z = a.z ? static_cast<T*>(a.z) + e * a.m * a.n : nullptr;
    out32 = a.out_f32 ? static_cast<float*>(a.out) + e * a.m * a.n_out : nullptr;
  }
};

// One output element, from its epilogue's f32 value: f32, or rounded to T.
template <typename T>
__device__ __forceinline__ void store_out(const ExpertPtrs<T>& p, size_t at, float y) {
  if (p.out32) p.out32[at] = y;
  else p.out[at] = from_f<T>(y);
}

// Origin of logical tile t in the schedule's order.
__device__ __forceinline__ void tile_origin(const MatmulArgs& a, int t, int* m0, int* n0) {
  int tm, tn;
  if (a.m_outer) { tm = t / a.tiles_n; tn = t % a.tiles_n; }
  else           { tn = t / a.tiles_m; tm = t % a.tiles_m; }
  *m0 = tm * a.tile_m;
  *n0 = tn * a.tile_n;
}

// The f32 sum y at column n plus its bias: the epilogue's input, and Z.
__device__ __forceinline__ float with_bias(const MatmulArgs& a, float y, int n) {
  return a.bias ? y + a.bias[n] : y;
}

// Z at (row, n) from its f32 sum y, where the caller asked for it.
template <typename T>
__device__ __forceinline__ void store_z(const MatmulArgs& a, T* z, int row, int n, float y) {
  if (z) z[(size_t)row * a.n + n] = from_f<T>(with_bias(a, y, n));
}

// Epilogue for one output element whose f32 sum is y at column n (non-GLU).
__device__ __forceinline__ float epilogue1(const MatmulArgs& a, float y, int row, int n) {
  y = with_bias(a, y, n);
  switch (a.epi) {
    case kGelu: y = gelu_tanh(y); break;
    case kResidual: y += a.residual[(size_t)row * a.n_out + n]; break;
    case kSoftcap: y = tanhf(y / a.softcap) * a.softcap; break;
    default: break;
  }
  return y;
}

// GLU epilogue: gate at even column n, up at n + 1; emits column n / 2.
__device__ __forceinline__ float epilogue_glu(const MatmulArgs& a, float g, float u, int n) {
  g = with_bias(a, g, n);
  u = with_bias(a, u, n + 1);
  return (a.epi == kSiluGlu ? silu(g) : gelu_tanh(g)) * u;
}

__host__ __device__ __forceinline__ bool is_glu(int epi) { return epi == kSiluGlu || epi == kGeluGlu; }

// ---------------------------------------------------------------------------
// rows body: small tile_m, streams w.  A CTA covers one 64-column strip of
// one logical tile over one K slice (kernels/matmul.py rows_geometry).
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;
constexpr int kRowsCtaN = 64;    // columns of one CTA strip (kernels/matmul.py ROWS_CTA_N)
constexpr int kRowsRM = 4;       // rows per pass over the strip
constexpr int kRowsUnroll = 8;   // 16-byte loads of w in flight per thread
constexpr int kRowsSliceAlign = 32;  // K slices are multiples of this (ROWS_SLICE_ALIGN)
static_assert(kRowsSliceAlign % kRowsUnroll == 0, "a thread's K rows start on a multiple of 8");

// K slice length for split_k slices (kernels/matmul.py rows_k_slice)
__host__ __device__ __forceinline__ int rows_k_slice(int k, int split_k) {
  return kRowsSliceAlign * cdiv(cdiv(k, split_k), kRowsSliceAlign);
}

// One thread's FMAs over its K rows for the rows [r0, r0 + rows) and VEC
// columns from col: rounds of kRowsUnroll consecutive K rows, ty's block of
// each round of kRowsUnroll * TK, in ascending order.  Every load of a
// round (kRowsUnroll 16-byte vectors of w, and kRowsUnroll values of x per
// row, 16 bytes at a time where aligned) is requested before its first FMA.
// kVec: 16-byte loads of w; otherwise guarded scalar loads, zeros past the
// strip's edge cn1.  K rows past k1 load zeros for x and w alike.
template <typename T, int TK, bool kVec>
__device__ __forceinline__ void rows_accumulate(const T* __restrict__ x, const T* __restrict__ w,
                                                const MatmulArgs& a, int r0, int rows, int col,
                                                int cn1, int k0, int k1, int ty, bool x_vec,
                                                float (&acc)[kRowsRM][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = kRowsUnroll;
  constexpr int XQ = U * (int)sizeof(T) / 16;   // 16-byte x vectors per row and round
  static_assert(XQ * 16 == U * (int)sizeof(T), "a round's x values are whole 16-byte vectors");
  for (int kb = k0 + ty * U; kb < k1; kb += U * TK) {
    uint4 wr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ku = kb + u;
      if (kVec) {
        wr[u] = ku < k1 ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)ku * a.n + col))
                        : make_uint4(0, 0, 0, 0);
      } else {
        T* e = reinterpret_cast<T*>(&wr[u]);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          e[v] = (ku < k1 && col + v < cn1) ? w[(size_t)ku * a.n + col + v] : from_f<T>(0.f);
      }
    }
    uint4 xq[kRowsRM][XQ];
    const bool whole = x_vec && kb + U <= k1;
#pragma unroll
    for (int r = 0; r < kRowsRM; ++r) {
      const T* xrow = x + (size_t)(r0 + min(r, rows - 1)) * a.k + kb;   // rows past `rows` reload a row
      if (whole) {
#pragma unroll
        for (int q = 0; q < XQ; ++q) xq[r][q] = __ldg(reinterpret_cast<const uint4*>(xrow) + q);
      } else {
        T* e = reinterpret_cast<T*>(&xq[r][0]);
#pragma unroll
        for (int u = 0; u < U; ++u) e[u] = kb + u < k1 ? xrow[u] : from_f<T>(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* e = reinterpret_cast<const T*>(&wr[u]);
#pragma unroll
      for (int r = 0; r < kRowsRM; ++r) {
        if (r < rows) {   // uniform over the CTA
          const float xv = to_f(reinterpret_cast<const T*>(&xq[r][0])[u]);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, to_f(e[v]), acc[r][v]);
        }
      }
    }
  }
}

// Each row's sum: per thread over its K rows in ascending order, then a
// butterfly over the warp's K lanes, then the 8 warps in order, then (when
// split) the K slices in order, in the reduce kernel.  None of it depends on
// M or on the other rows, so a row's bits are the same at M = 1 and M = 4.
template <typename T>
__global__ void __launch_bounds__(kRowsThreads, 2) matmul_rows_kernel(MatmulArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TN = kRowsCtaN / VEC;      // threads along N: 8 (bf16), 16 (f32)
  constexpr int TK = kRowsThreads / TN;    // threads along K: 32, 16
  constexpr int kWarps = kRowsThreads / 32;
  static_assert(TN <= 32 && 32 % TN == 0, "a warp holds whole K lanes");
  __shared__ float red[kWarps][kRowsRM][kRowsCtaN];

  const ExpertPtrs<T> p(a);
  // this CTA's place: logical tile, then its strip, then its K slice
  const int per_tile = a.sub_n * a.split_k;
  const int rem = blockIdx.x % per_tile;
  const int strip = rem / a.split_k, slice = rem % a.split_k;
  int m0, n0;
  tile_origin(a, blockIdx.x / per_tile, &m0, &n0);
  const int m1 = min(m0 + a.tile_m, a.m), n1 = min(n0 + a.tile_n, a.n);
  const int cn0 = n0 + strip * kRowsCtaN;
  if (cn0 >= n1) return;   // a ragged logical tile needs fewer strips
  const int cn1 = min(cn0 + kRowsCtaN, n1);
  const int k_slice = rows_k_slice(a.k, a.split_k);
  const int k0 = slice * k_slice, k1 = min(k0 + k_slice, a.k);
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = cn0 + tx * VEC;
  // 16-byte vectors stay aligned only if every row of w and every tile's
  // first column start on 16 bytes (a default N tile may be 500, say)
  const bool vec_ok = (a.n % VEC) == 0 && (a.tile_n % VEC) == 0 &&
                      (reinterpret_cast<uintptr_t>(p.w) % 16) == 0;
  // ... and x's rows, read kRowsUnroll values at a time from a multiple of 8
  const bool x_vec = (a.k % 8) == 0 && (reinterpret_cast<uintptr_t>(p.x) % 16) == 0;
  const bool glu = is_glu(a.epi);
  const int width = cn1 - cn0;

  for (int r0 = m0; r0 < m1; r0 += kRowsRM) {
    const int rows = min(kRowsRM, m1 - r0);
    float acc[kRowsRM][VEC];
#pragma unroll
    for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
    if (col < cn1) {
      if (vec_ok) rows_accumulate<T, TK, true>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
      else rows_accumulate<T, TK, false>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
    }
    // the warp's K lanes (lane bits from TN up): every lane ends with the same sum
#pragma unroll
    for (int r = 0; r < kRowsRM; ++r) {
      if (r >= rows) break;   // uniform over the CTA
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = acc[r][v];
#pragma unroll
        for (int o = TN; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        acc[r][v] = s;
      }
    }
    if (lane < TN) {
#pragma unroll
      for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) red[warp][r][tx * VEC + v] = acc[r][v];
    }
    __syncthreads();

    if (a.split_k > 1) {   // raw partial sums of every accumulator column; the reduce pass ends it
      float* ws = a.ws + ((size_t)blockIdx.y * a.split_k + slice) * a.m * a.n;
      for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
        const int r = idx / width, j = idx % width;
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r][j];
        ws[(size_t)(r0 + r) * a.n + cn0 + j] = s;
      }
    } else {
      const int ow = glu ? width / 2 : width;   // output columns of this strip
      for (int idx = threadIdx.x; idx < rows * ow; idx += blockDim.x) {
        const int r = idx / ow, j = idx % ow;
        const int row = r0 + r;
        float y;
        int ocol;
        if (glu) {   // cn0 and width are even: the pair (2j, 2j + 1) is in this strip
          float g = 0.f, u = 0.f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) { g += red[wi][r][2 * j]; u += red[wi][r][2 * j + 1]; }
          y = epilogue_glu(a, g, u, cn0 + 2 * j);
          ocol = (cn0 + 2 * j) / 2;
          store_z(a, p.z, row, cn0 + 2 * j, g);
          store_z(a, p.z, row, cn0 + 2 * j + 1, u);
        } else {
          float s = 0.f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r][j];
          ocol = cn0 + j;
          y = epilogue1(a, s, row, ocol);
          store_z(a, p.z, row, ocol, s);
        }
        store_out(p, (size_t)row * a.n_out + ocol, y);
      }
    }
    __syncthreads();
  }
}

// Second pass of a split rows launch: each output sums its K slices'
// partial sums in slice order and takes the epilogue once.
template <typename T>
__global__ void __launch_bounds__(256) matmul_rows_reduce_kernel(MatmulArgs a) {
  const ExpertPtrs<T> p(a);
  const size_t plane = (size_t)a.m * a.n;
  const float* ws = a.ws + (size_t)blockIdx.y * a.split_k * plane;
  const bool glu = is_glu(a.epi);
  const int total = a.m * a.n_out;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int row = i / a.n_out, oc = i % a.n_out;
    float y;
    if (glu) {
      const size_t at = (size_t)row * a.n + 2 * oc;
      float g = ws[at], u = ws[at + 1];
      for (int j = 1; j < a.split_k; ++j) { g += ws[j * plane + at]; u += ws[j * plane + at + 1]; }
      y = epilogue_glu(a, g, u, 2 * oc);
      store_z(a, p.z, row, 2 * oc, g);
      store_z(a, p.z, row, 2 * oc + 1, u);
    } else {
      const size_t at = (size_t)row * a.n + oc;
      float s = ws[at];
      for (int j = 1; j < a.split_k; ++j) s += ws[j * plane + at];
      y = epilogue1(a, s, row, oc);
      store_z(a, p.z, row, oc, s);
    }
    store_out(p, (size_t)row * a.n_out + oc, y);
  }
}

// ---------------------------------------------------------------------------
// rows body, rounding mode (bf16, non-GLU, round_k > 0)
// ---------------------------------------------------------------------------

// K tiles at least this deep are summed by all the CTA's K lanes at once;
// shorter ones by one K lane each
constexpr int kRowsRoundWide = 256;

// One K lane's f32 sum over the K rows [k0, k1) for the rows [r0, r0 + rows)
// and VEC columns from col, in ascending k.  kVec: 16-byte loads of w;
// otherwise guarded scalar loads, zeros past the strip's edge cn1.
template <bool kVec>
__device__ __forceinline__ void rows_tile_serial(const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ w,
                                                 const MatmulArgs& a, int r0, int rows, int col,
                                                 int cn1, int k0, int k1,
                                                 float (&acc)[kRowsRM][8]) {
  using T = __nv_bfloat16;
#pragma unroll 4
  for (int kk = k0; kk < k1; ++kk) {
    uint4 wr;
    if (kVec) {
      wr = __ldg(reinterpret_cast<const uint4*>(w + (size_t)kk * a.n + col));
    } else {
      T* e = reinterpret_cast<T*>(&wr);
#pragma unroll
      for (int v = 0; v < 8; ++v) e[v] = col + v < cn1 ? w[(size_t)kk * a.n + col + v] : from_f<T>(0.f);
    }
    const T* e = reinterpret_cast<const T*>(&wr);
#pragma unroll
    for (int r = 0; r < kRowsRM; ++r) {
      if (r < rows) {   // uniform over the CTA
        const float xv = to_f(x[(size_t)(r0 + r) * a.k + kk]);
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[r][v] = fmaf(xv, to_f(e[v]), acc[r][v]);
      }
    }
  }
}

// A CTA covers one 64-column strip of one logical tile over the whole of K,
// in passes of 4 rows; each of its 256 threads owns one (row, column) of a
// pass and carries that output's chain over the K tiles in a register:
// chain = p_0, then chain = bf16(chain) + p_j.  Each tile's f32 product p_j
// is summed first: a tile of at least kRowsRoundWide rows by all 32 K lanes
// as in the plain rows body (then the warp butterfly and the 8 warps in
// order); a shorter one by one K lane alone, 32 tiles side by side, folded
// into the chains in tile order from shared memory.  Slower than the plain
// rows body (one CTA per strip, no K split), and exact to the rule.
__global__ void __launch_bounds__(kRowsThreads) matmul_rows_round_kernel(MatmulArgs a) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  constexpr int TN = kRowsCtaN / VEC;      // 8 threads across the strip
  constexpr int TK = kRowsThreads / TN;    // 32 K lanes
  constexpr int kWarps = kRowsThreads / 32;
  __shared__ float part[TK][kRowsRM][kRowsCtaN];   // per K lane (narrow) or warp (wide)

  const ExpertPtrs<T> p(a);
  const int strip = blockIdx.x % a.sub_n;
  int m0, n0;
  tile_origin(a, blockIdx.x / a.sub_n, &m0, &n0);
  const int m1 = min(m0 + a.tile_m, a.m), n1 = min(n0 + a.tile_n, a.n);
  const int cn0 = n0 + strip * kRowsCtaN;
  if (cn0 >= n1) return;
  const int cn1 = min(cn0 + kRowsCtaN, n1), width = cn1 - cn0;
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = cn0 + tx * VEC;
  const bool vec_ok = (a.n % VEC) == 0 && (a.tile_n % VEC) == 0 &&
                      (reinterpret_cast<uintptr_t>(p.w) % 16) == 0;
  // x in 16-byte vectors only where every tile starts on a multiple of 8
  const bool x_vec = (a.k % 8) == 0 && (a.round_k % 8) == 0 &&
                     (reinterpret_cast<uintptr_t>(p.x) % 16) == 0;
  const int orow = threadIdx.x / kRowsCtaN, ocol = threadIdx.x % kRowsCtaN;   // this thread's output
  const int tiles = a.k / a.round_k;

  for (int r0 = m0; r0 < m1; r0 += kRowsRM) {
    const int rows = min(kRowsRM, m1 - r0);
    const bool owner = orow < rows && ocol < width;
    float chain = 0.f;
    if (a.round_k >= kRowsRoundWide) {
      for (int t = 0; t < tiles; ++t) {
        float acc[kRowsRM][VEC];
#pragma unroll
        for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
        const int k0 = t * a.round_k, k1 = k0 + a.round_k;
        if (col < cn1) {
          if (vec_ok) rows_accumulate<T, TK, true>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
          else rows_accumulate<T, TK, false>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
        }
#pragma unroll
        for (int r = 0; r < kRowsRM; ++r) {
          if (r >= rows) break;   // uniform over the CTA
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float s = acc[r][v];
#pragma unroll
            for (int o = TN; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            acc[r][v] = s;
          }
        }
        if (lane < TN) {
#pragma unroll
          for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) part[warp][r][tx * VEC + v] = acc[r][v];
        }
        __syncthreads();
        if (owner) {
          float s = 0.f;
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) s += part[wi][orow][ocol];
          chain = t == 0 ? s : round_bf16(chain) + s;
        }
        __syncthreads();
      }
    } else {
      for (int t0 = 0; t0 < tiles; t0 += TK) {
        const int t = t0 + ty;
        float acc[kRowsRM][VEC];
#pragma unroll
        for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
        if (t < tiles && col < cn1) {
          const int k0 = t * a.round_k, k1 = k0 + a.round_k;
          if (vec_ok) rows_tile_serial<true>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, acc);
          else rows_tile_serial<false>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, acc);
        }
#pragma unroll
        for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) part[ty][r][tx * VEC + v] = acc[r][v];
        __syncthreads();
        if (owner) {
          const int last = min(TK, tiles - t0);
          for (int j = 0; j < last; ++j) {
            const float s = part[j][orow][ocol];
            chain = t0 + j == 0 ? s : round_bf16(chain) + s;
          }
        }
        __syncthreads();
      }
    }
    if (owner) {
      const int row = r0 + orow, oc = cn0 + ocol;
      store_out(p, (size_t)row * a.n_out + oc, epilogue1(a, chain, row, oc));
      store_z(a, p.z, row, oc, chain);
    }
  }
}

// ---------------------------------------------------------------------------
// mma body: bf16 on the tensor cores, mma.sync m16n8k16 from a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kStageK = 32;  // K depth of one shared-memory stage
constexpr int kStages = 4;   // stages in the ring
constexpr int kPad = 8;      // bf16 of padding per shared row (16 bytes)

// One compiled CTA tile: BM x BN outputs on WM x WN warps.
template <int BM_, int BN_, int WM_, int WN_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;         // one warp's outputs
  static constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 8;  // its m16n8 fragments
  static constexpr int kLdA = kStageK + kPad, kLdB = BN + kPad;    // shared row strides
  static constexpr int kStageElems = BM * kLdA + kStageK * kLdB;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static constexpr int kChunksA = BM * kStageK / 8, kChunksB = kStageK * BN / 8;  // 16-byte chunks
  static_assert(kWarpM % 16 == 0 && kWarpN % 16 == 0, "a warp tile is whole 16x16 blocks");
  static_assert(kChunksA % kThreads == 0 && kChunksB % kThreads == 0,
                "every thread stages the same number of chunks");
};
// the CTA tiles of kernels/matmul.py MMA_CTA_TILES
using MmaTile128x128 = MmaTile<128, 128, 2, 4>;  // warp tile 64x32
using MmaTile64x128 = MmaTile<64, 128, 2, 4>;    // 32x32
using MmaTile64x64 = MmaTile<64, 64, 2, 2>;      // 32x32

// Rounding mode's MMA step over the global K rows [kg, kg + 16): each K
// tile's products go into the accumulator, which is rounded to bf16 in place
// where a tile ends (not at K's end).  A tile boundary inside the step (a K
// tile that is not a multiple of 16: 8, 40, ...) splits it into segments,
// each an MMA with the A fragment's K columns outside the segment zeroed, so
// no product crosses a rounding.  The next tile's products then accumulate
// onto the rounded sum, where the reference adds the tile's own f32 sum to
// it: the two differ only in the order of one tile's f32 additions.  The
// segments depend on kg and round_k alone, uniform over the CTA.
template <int FM, int FN>
__device__ __forceinline__ void mma_round_step(float (&acc)[FM][FN][4], const uint32_t (&af)[FM][4],
                                               const uint32_t (&bfr)[FN][2], int kg, int round_k,
                                               int k, int tq) {
  for (int s0 = 0; s0 < 16;) {
    const int end = (kg + s0) / round_k * round_k + round_k;   // end of row kg + s0's K tile
    const int s1 = min(end - kg, 16);
    if (s0 == 0 && s1 == 16) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    } else {
      // a lane's A registers hold K columns 2tq, 2tq + 1 (registers 0 and 1,
      // rows g and g + 8) and 2tq + 8, 2tq + 9 (registers 2 and 3), the lower
      // column in the low half
      uint32_t mask[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 2 * tq + 8 * (r >> 1);
        mask[r] = (c >= s0 && c < s1 ? 0x0000ffffu : 0u) | (c + 1 >= s0 && c + 1 < s1 ? 0xffff0000u : 0u);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const uint32_t am[4] = {af[i][0] & mask[0], af[i][1] & mask[1], af[i][2] & mask[2],
                                af[i][3] & mask[3]};
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_bf16(acc[i][j], am, bfr[j][0], bfr[j][1]);
      }
    }
    if (kg + s1 == end && end < k) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = round_bf16(acc[i][j][v]);
    }
    s0 = s1;
  }
}

// kRound: rounding mode (a.round_k > 0), a separate instantiation so the
// plain body's code is untouched by it
template <class Tile, bool kRound>
__global__ void __launch_bounds__(Tile::kThreads) matmul_mma_kernel(MatmulArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = Tile::BM, BN = Tile::BN, kLdA = Tile::kLdA, kLdB = Tile::kLdB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const ExpertPtrs<bf16> p(a);
  // this CTA's place: logical tile, then the sub-tile inside it (along N first)
  const int per_tile = a.sub_m * a.sub_n, sub = blockIdx.x % per_tile;
  int m0, n0;
  tile_origin(a, blockIdx.x / per_tile, &m0, &n0);
  const int m1 = min(m0 + a.tile_m, a.m), n1 = min(n0 + a.tile_n, a.n);
  const int cm0 = m0 + (sub / a.sub_n) * BM, cn0 = n0 + (sub % a.sub_n) * BN;
  if (cm0 >= m1 || cn0 >= n1) return;   // a ragged logical tile needs fewer sub-tiles
  const int cm1 = min(cm0 + BM, m1), cn1 = min(cn0 + BN, n1);
  // 16-byte chunks stay aligned only if every row and every CTA's first
  // column start on 16 bytes
  const bool vec_x = a.k % 8 == 0 && (reinterpret_cast<uintptr_t>(p.x) % 16) == 0;
  const bool vec_w = a.n % 8 == 0 && a.tile_n % 8 == 0 && (reinterpret_cast<uintptr_t>(p.w) % 16) == 0;

  // x rows [cm0, cm1) and w columns [cn0, cn1) of K slice [k0, k0 + kStageK)
  auto load_stage = [&](int slot, int k0) {
    bf16* sa = smem + slot * Tile::kStageElems;
    bf16* sb = sa + BM * kLdA;
#pragma unroll
    for (int j = 0; j < Tile::kChunksA / Tile::kThreads; ++j) {
      const int i = threadIdx.x + j * Tile::kThreads;
      const int r = i / (kStageK / 8), c = (i % (kStageK / 8)) * 8;
      const int gr = cm0 + r, gk = k0 + c;
      const int valid = gr < cm1 ? a.k - gk : 0;
      stage8(sa + r * kLdA + c, valid > 0 ? p.x + (size_t)gr * a.k + gk : p.x, valid, vec_x);
    }
#pragma unroll
    for (int j = 0; j < Tile::kChunksB / Tile::kThreads; ++j) {
      const int i = threadIdx.x + j * Tile::kThreads;
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int gk = k0 + r, gn = cn0 + c;
      const int valid = gk < a.k ? cn1 - gn : 0;
      stage8(sb + r * kLdB + c, valid > 0 ? p.w + (size_t)gk * a.n + gn : p.w, valid, vec_w);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / Tile::WN) * Tile::kWarpM, wn0 = (warp % Tile::WN) * Tile::kWarpN;
  float acc[Tile::kFragM][Tile::kFragN][4];
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int ktiles = cdiv(a.k, kStageK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kStageK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next * kStageK);
    cp_async_commit();

    const bf16* sa = smem + (kt % kStages) * Tile::kStageElems;
    const bf16* sb = sa + BM * kLdA;
#pragma unroll
    for (int kk = 0; kk < kStageK; kk += 16) {
      // lane l addresses row l % 16, column block l / 16 of a 16x16 block:
      // the four 8x8 matrices come back in the order the mma operands take
      uint32_t af[Tile::kFragM][4], bfr[Tile::kFragN][2];
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i)
        ldmatrix_x4(af[i], smem_addr(sa + (wm0 + i * 16 + lane % 16) * kLdA + kk + (lane / 16) * 8));
#pragma unroll
      for (int j = 0; j < Tile::kFragN; j += 2) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, smem_addr(sb + (kk + lane % 16) * kLdB + wn0 + j * 8 + (lane / 16) * 8));
        bfr[j][0] = t[0]; bfr[j][1] = t[1]; bfr[j + 1][0] = t[2]; bfr[j + 1][1] = t[3];
      }
      if constexpr (kRound) {
        mma_round_step(acc, af, bfr, kt * kStageK + kk, a.round_k, a.k, lane % 4);
      } else {
#pragma unroll
        for (int i = 0; i < Tile::kFragM; ++i)
#pragma unroll
          for (int j = 0; j < Tile::kFragN; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none in flight

  // accumulator fragment: lane (g, t) = (lane / 4, lane % 4) holds rows g and
  // g + 8, columns 2t and 2t + 1 of each m16n8 block: a GLU pair (even
  // column, odd column) never leaves its thread
  const bool glu = is_glu(a.epi);
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j) {
      const int col = cn0 + wn0 + j * 8 + 2 * tq;
      if (col >= cn1) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = cm0 + wm0 + i * 16 + g + 8 * h;
        if (row >= cm1) continue;
        const float y0 = acc[i][j][2 * h], y1 = acc[i][j][2 * h + 1];
        bf16* o = p.out + (size_t)row * a.n_out;
        if (p.out32) {   // f32: two scalar stores (an odd N_out leaves a row's pair unaligned)
          float* o32 = p.out32 + (size_t)row * a.n_out;
          if (glu) {
            o32[col / 2] = epilogue_glu(a, y0, y1, col);
          } else {
            o32[col] = epilogue1(a, y0, row, col);
            if (col + 1 < cn1) o32[col + 1] = epilogue1(a, y1, row, col + 1);
          }
        } else if (glu) {  // col is even and cn1 is even, so col + 1 < cn1
          o[col / 2] = from_f<bf16>(epilogue_glu(a, y0, y1, col));
        } else if (col + 1 < cn1) {
          store2(o + col, epilogue1(a, y0, row, col), epilogue1(a, y1, row, col + 1));
        } else {
          o[col] = from_f<bf16>(epilogue1(a, y0, row, col));
        }
        if (p.z) {   // Z's row stride is N, the output's N / 2 under a GLU
          bf16* zr = p.z + (size_t)row * a.n;
          if (col + 1 < cn1) store2(zr + col, with_bias(a, y0, col), with_bias(a, y1, col + 1));
          else zr[col] = from_f<bf16>(with_bias(a, y0, col));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fma body: f32 on the CUDA cores, 64x64x16 shared-memory tiles, 4x4 per thread
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void __launch_bounds__(256) matmul_fma_kernel(MatmulArgs a) {
  using T = float;
  __shared__ float As[kBK][kBM + 4];  // x tile, transposed: As[k][m]
  __shared__ float Bs[kBK][kBN + 4];  // w tile: Bs[k][n]

  const ExpertPtrs<T> p(a);
  const T* x = p.x;
  const T* w = p.w;
  T* out = p.out;
  int m0, n0;
  tile_origin(a, blockIdx.x, &m0, &n0);
  const int m1 = min(m0 + a.tile_m, a.m), n1 = min(n0 + a.tile_n, a.n);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool glu = is_glu(a.epi);

  for (int sm0 = m0; sm0 < m1; sm0 += kBM) {
    for (int sn0 = n0; sn0 < n1; sn0 += kBN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < a.k; k0 += kBK) {
        for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
          const int mm = i / kBK, kk = i % kBK;
          const int gm = sm0 + mm, gk = k0 + kk;
          As[kk][mm] = (gm < m1 && gk < a.k) ? to_f(x[(size_t)gm * a.k + gk]) : 0.f;
        }
        for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
          const int kk = i / kBN, nn = i % kBN;
          const int gk = k0 + kk, gn = sn0 + nn;
          Bs[kk][nn] = (gk < a.k && gn < n1) ? to_f(w[(size_t)gk * a.n + gn]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = sm0 + ty * 4 + i;
        if (row >= m1) continue;
        if (glu) {
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            const int n = sn0 + tx * 4 + j;  // even: gate at n, up at n + 1
            if (n < n1) {
              out[(size_t)row * a.n_out + n / 2] = from_f<T>(epilogue_glu(a, acc[i][j], acc[i][j + 1], n));
              store_z(a, p.z, row, n, acc[i][j]);
              store_z(a, p.z, row, n + 1, acc[i][j + 1]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = sn0 + tx * 4 + j;
            if (n < n1) {
              out[(size_t)row * a.n_out + n] = from_f<T>(epilogue1(a, acc[i][j], row, n));
              store_z(a, p.z, row, n, acc[i][j]);
            }
          }
        }
      }
    }
  }
}

enum Body : int { kRows = 0, kMma = 1, kFma = 2 };

template <class Tile, bool kRound>
int launch_mma_as(const MatmulArgs& a, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(matmul_mma_kernel<Tile, kRound>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Tile::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  matmul_mma_kernel<Tile, kRound><<<dim3(a.ctas, a.groups), Tile::kThreads, Tile::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class Tile>
int launch_mma(const MatmulArgs& a, cudaStream_t stream) {
  return a.round_k > 0 ? launch_mma_as<Tile, true>(a, stream) : launch_mma_as<Tile, false>(a, stream);
}

// Checks the shared arguments and the CTA geometry the wrapper chose
// (kernels/matmul.py launch_geometry), then launches; returns a cudaError_t
// (cudaErrorInvalidValue for bad arguments).
int run(MatmulArgs& a, int dtype, void* stream) {
  if (a.m <= 0 || a.n <= 0 || a.k <= 0 || a.tile_m <= 0 || a.tile_n <= 0) return (int)cudaErrorInvalidValue;
  if (a.groups <= 0 || a.groups > 65535) return (int)cudaErrorInvalidValue;
  if (a.epi < kNone || a.epi > kSoftcap) return (int)cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const bool glu = is_glu(a.epi);
  if (glu && ((a.n % 2) || (a.tile_n % 2))) return (int)cudaErrorInvalidValue;
  // rounding mode: bf16, non-GLU, a K tile that divides K into at least two
  if (a.round_k < 0) return (int)cudaErrorInvalidValue;
  if (a.round_k > 0 && (dtype != kBFloat16 || glu || a.k % a.round_k || a.round_k >= a.k))
    return (int)cudaErrorInvalidValue;
  if (a.epi == kResidual && a.residual == nullptr) return (int)cudaErrorInvalidValue;
  if (a.out_f32 != 0 && a.out_f32 != 1) return (int)cudaErrorInvalidValue;
  a.n_out = glu ? a.n / 2 : a.n;
  a.tiles_m = cdiv(a.m, a.tile_m); a.tiles_n = cdiv(a.n, a.tile_n);
  const Body body = a.tile_m <= 16 ? kRows : dtype == kBFloat16 ? kMma : kFma;
  if (a.split_k < 1 || (body != kRows && a.split_k != 1)) return (int)cudaErrorInvalidValue;
  if (body == kMma) {
    const bool compiled = (a.cta_m == 128 && a.cta_n == 128) || (a.cta_m == 64 && a.cta_n == 128) ||
                          (a.cta_m == 64 && a.cta_n == 64);
    if (!compiled) return (int)cudaErrorInvalidValue;
    a.sub_m = cdiv(std::min(a.tile_m, a.m), a.cta_m);
    a.sub_n = cdiv(std::min(a.tile_n, a.n), a.cta_n);
  } else if (body == kRows) {  // 64-column strips of the logical tile, split_k K slices each
    if (a.cta_m != a.tile_m || a.cta_n != kRowsCtaN) return (int)cudaErrorInvalidValue;
    if (cdiv(a.k, rows_k_slice(a.k, a.split_k)) != a.split_k) return (int)cudaErrorInvalidValue;
    if (a.round_k > 0 && a.split_k != 1) return (int)cudaErrorInvalidValue;   // K tiles chain in one CTA
    if (a.split_k > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
    a.sub_m = 1;
    a.sub_n = cdiv(std::min(a.tile_n, a.n), kRowsCtaN);
  } else {  // one CTA per logical tile
    if (a.cta_m != a.tile_m || a.cta_n != a.tile_n) return (int)cudaErrorInvalidValue;
    a.sub_m = a.sub_n = 1;
  }
  if ((long long)a.tiles_m * a.tiles_n * a.sub_m * a.sub_n * a.split_k != (long long)a.ctas)
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.ctas, a.groups);
  switch (body) {
    case kRows: {
      const dim3 rgrid(std::min(cdiv(a.m * a.n_out, 256), 4096), a.groups);
      if (a.round_k > 0) {
        matmul_rows_round_kernel<<<grid, kRowsThreads, 0, s>>>(a);
      } else if (dtype == kBFloat16) {
        matmul_rows_kernel<__nv_bfloat16><<<grid, kRowsThreads, 0, s>>>(a);
        if (a.split_k > 1) matmul_rows_reduce_kernel<__nv_bfloat16><<<rgrid, 256, 0, s>>>(a);
      } else {
        matmul_rows_kernel<float><<<grid, kRowsThreads, 0, s>>>(a);
        if (a.split_k > 1) matmul_rows_reduce_kernel<float><<<rgrid, 256, 0, s>>>(a);
      }
      break;
    }
    case kFma:
      matmul_fma_kernel<<<grid, 256, 0, s>>>(a);
      break;
    case kMma:
      if (a.cta_m == 128) return launch_mma<MmaTile128x128>(a, s);
      if (a.cta_n == 128) return launch_mma<MmaTile64x128>(a, s);
      return launch_mma<MmaTile64x64>(a, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  bias (N,) and residual (M, N_out) are f32
// (the wrapper converts them: the reference reads both into f32).  z: Z
// (M, N) in x's dtype, written beside out where not null.  round_k:
// the rounding mode's K tile, 0 for f32 sums throughout.  ws: the rows body's
// f32 workspace (split_k, M, N) when split_k > 1, else unused.  out_f32: out
// is f32, the epilogue unrounded.  Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias, const void* residual,
                            void* out, void* z, int m, int n, int k, int dtype, int epi, float softcap,
                            int tile_m, int tile_n, int m_outer, int cta_m, int cta_n, int ctas,
                            int split_k, int round_k, void* ws, int out_f32, void* stream) {
  repro::MatmulArgs a{};
  a.x = x; a.w = w; a.bias = static_cast<const float*>(bias);
  a.residual = static_cast<const float*>(residual); a.out = out; a.z = z;
  a.m = m; a.n = n; a.k = k;
  a.epi = epi; a.softcap = softcap;
  a.tile_m = tile_m; a.tile_n = tile_n; a.m_outer = m_outer; a.groups = 1;
  a.cta_m = cta_m; a.cta_n = cta_n; a.ctas = ctas;
  a.split_k = split_k; a.round_k = round_k; a.ws = static_cast<float*>(ws);
  a.out_f32 = out_f32;
  return repro::run(a, dtype, stream);
}

// Grouped (MoE expert) matmul: out[e] = epilogue(x[e] (M,K) @ w[e] (K,N)) for
// e < groups, contiguous (E,M,K), (E,K,N) and (E,M,N_out).  m, tile_m and
// tile_n are per expert.  No bias or residual (the grouped classes have none).
// round_k: as repro_matmul's, per expert.  ws: (E, split_k, M, N) f32 when
// the rows body splits K.  out_f32: as repro_matmul's.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, int groups,
                                    int m, int n, int k, int dtype, int epi,
                                    int tile_m, int tile_n, int m_outer, int cta_m, int cta_n,
                                    int ctas, int split_k, int round_k, void* ws, int out_f32,
                                    void* stream) {
  repro::MatmulArgs a{};
  a.x = x; a.w = w; a.out = out;
  a.m = m; a.n = n; a.k = k;
  a.epi = epi;
  a.tile_m = tile_m; a.tile_n = tile_n; a.m_outer = m_outer; a.groups = groups;
  a.cta_m = cta_m; a.cta_n = cta_n; a.ctas = ctas;
  a.split_k = split_k; a.round_k = round_k; a.ws = static_cast<float*>(ws);
  a.out_f32 = out_f32;
  return repro::run(a, dtype, stream);
}
