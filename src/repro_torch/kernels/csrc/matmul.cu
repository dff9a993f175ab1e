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
//  * rows (tile_m <= 16, either dtype: decode, verify, the 1-row prefill LM
//    head and the 1-row tiles of a prime prompt length): w's bytes bound it.
//    A CTA covers one 64-column strip of one group of logical N tiles over
//    the rows of one group of logical M tiles (below) and one K slice; its
//    256 threads each stream 16-byte vectors of w (eight loads in flight
//    before their FMAs), 8 (bf16) or 16 (f32) threads across the strip and
//    the rest down K.  Where the strips alone launch fewer than two CTAs per
//    SM, K is split across CTAs (split_k, from kernels/matmul.py
//    rows_geometry, a function of K, N, the N tile and the expert count
//    only): each slice writes f32 partial sums to a workspace and a second
//    pass adds them in slice order and applies the epilogue once.  No float
//    atomics; a row's summation order never depends on M or on its CTA's
//    other rows.  A thread holds the sums of all of its CTA's rows in one
//    pass, so each vector of w it loads serves every row: up to 4 rows with
//    x in registers, read through L1 (decode); up to 16 with x staged a
//    round at a time in shared memory (verify, a group of narrow M tiles).
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
// Logical tile, group and CTA tile.  The schedule's (tile_m x tile_n) output
// tile is the unit of rasterisation and of edge masking.  Where the N tile is
// narrower than both N and a CTA's cta_n columns, one CTA covers a group of
// n_group = floor(cta_n / tile_n) consecutive logical tiles along N (span_n =
// n_group * tile_n columns: internvl2-26b's vocab of 92553 = 3 x 30851 gives
// an N tile of 3, 21 of them in a 64-column CTA); otherwise a group is one
// logical tile.  The tiles of a group are contiguous, so masking each at its
// own edge is masking the group at min(its end, N).  Groups are numbered in
// the schedule's order (m_outer: M is the outer loop, so consecutive groups
// walk along N), as the logical tiles were.  Along M only the rows body
// groups: where the M tile is narrower than both M and its 16-row CTA, one
// CTA covers m_group = floor(16 / tile_m) consecutive logical M tiles
// (span_m = m_group * tile_m rows: a prime prompt's 1-row tiles, 16 a CTA),
// masked at min(the group's end, M); elsewhere span_m is the M tile.  The
// fma body runs one CTA per logical tile (its CTA is the tile, so no group
// forms) and walks it in sub-blocks.  The rows body covers a group with
// 64-column strips, each split into split_k K slices (numbered
// strip-major, slices together).  The
// mma body runs a compiled CTA tile (128x128, 64x128 or 64x64) and covers
// each group with sub_m x sub_n CTAs, numbered consecutively along N, so they
// run together and share the group's x rows and w columns in L2; a group
// smaller than the CTA tile gets one CTA, masked at its edge.  The wrapper
// chooses the CTA tile (kernels/matmul.py tiled_geometry: the largest that
// fits the logical tile, or the group it would cover, and still launches at
// least one CTA per SM, 132, where M and N allow) and run() re-checks the
// CTA count it passes, from the same formula (kernels/matmul.py cta_count).
// No output's summation order depends on which columns share its CTA.
//
// Every body masks the ragged edges of M, N and K itself (the mma body
// zero-fills its stages: cp.async's src-size form, or guarded scalar loads
// where a row of x does not start on 16 bytes).  Rows of w that do not start
// on 16 bytes (an odd N, say) are read as the aligned 16-byte vectors that
// span a CTA's columns, never element by element: the rows body shifts each
// thread's 16 bytes into place in registers (shift16); the mma body copies
// the aligned vectors into its cp.async ring and shifts each stage into a
// staging buffer in shared memory before ldmatrix reads it (those
// instantiations compile in csrc/matmul_shift.cu, beside this file; the
// definitions both share are in csrc/matmul.cuh).  A GLU pair
// (gate at even column n, up at n + 1) stays in one thread in every body: a
// GLU's N tile is even, so are its groups.
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
#include "matmul.cuh"

namespace repro {

// The 16 / sizeof(T) elements from p (any element's address) up to `end`,
// read as the aligned 16-byte vectors that hold them and shifted into place:
// the one at or below p and, where p is not on 16 bytes and the next vector
// starts before end, that one (a vector past every wanted element is never
// read: it may lie past the tensor).  Elements at and past end are zeros.
template <typename T>
__device__ __forceinline__ uint4 load16_shifted(const T* p, const T* end) {
  const uint4* q = reinterpret_cast<const uint4*>(align_down16(p));
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const uint4 lo = __ldg(q);
  const uint4 hi = off && reinterpret_cast<const T*>(q + 1) < end ? __ldg(q + 1) : make_uint4(0, 0, 0, 0);
  const long long live = (end - p) * (long long)sizeof(T);
  const uint4 v = shift16(lo, hi, off);
  return live < 16 ? keep_bytes(v, static_cast<int>(live)) : v;
}

// ---------------------------------------------------------------------------
// rows body: small tile_m, streams w.  A CTA covers one 64-column strip of
// one group of logical N tiles, over the rows of one group of logical M
// tiles, over one K slice (kernels/matmul.py rows_geometry).
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;
constexpr int kRowsCtaN = 64;    // columns of one CTA strip (kernels/matmul.py ROWS_CTA_N)
constexpr int kRowsCtaM = 16;    // rows of one CTA at most: a group of narrow M tiles (ROWS_CTA_M)
constexpr int kRowsRM = 4;       // rows of the register pass (x in registers); above it, staged
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
// kVec: 16-byte loads of w; otherwise each row's 16 bytes come from the two
// aligned vectors that hold them (load16_shifted), zeros past the strip's
// edge cn1, half a round at a time so as many registers wait on loads.  K
// rows past k1 load zeros for x and w alike.  The FMAs' order is the same
// either way.
template <typename T, int TK, bool kVec>
__device__ __forceinline__ void rows_accumulate(const T* __restrict__ x, const T* __restrict__ w,
                                                const MatmulArgs& a, int r0, int rows, int col,
                                                int cn1, int k0, int k1, int ty, bool x_vec,
                                                float (&acc)[kRowsRM][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = kRowsUnroll;
  constexpr int H = kVec ? U : U / 2;           // K rows of w loaded at once
  constexpr int XQ = U * (int)sizeof(T) / 16;   // 16-byte x vectors per row and round
  static_assert(XQ * 16 == U * (int)sizeof(T), "a round's x values are whole 16-byte vectors");
  for (int kb = k0 + ty * U; kb < k1; kb += U * TK) {
    uint4 xq[kRowsRM][XQ];
#pragma unroll
    for (int h0 = 0; h0 < U; h0 += H) {
      uint4 wr[H];
#pragma unroll
      for (int u = 0; u < H; ++u) {
        const int ku = kb + h0 + u;
        const T* row = w + (size_t)ku * a.n;
        if (ku >= k1) wr[u] = make_uint4(0, 0, 0, 0);
        else if (kVec) wr[u] = __ldg(reinterpret_cast<const uint4*>(row + col));
        else wr[u] = load16_shifted(row + col, row + cn1);
      }
      if (h0 == 0) {
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
      }
#pragma unroll
      for (int u = 0; u < H; ++u) {
        const T* e = reinterpret_cast<const T*>(&wr[u]);
#pragma unroll
        for (int r = 0; r < kRowsRM; ++r) {
          if (r < rows) {   // uniform over the CTA
            const float xv = to_f(reinterpret_cast<const T*>(&xq[r][0])[h0 + u]);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, to_f(e[v]), acc[r][v]);
          }
        }
      }
    }
  }
}

// The staged pass (more rows than the register pass holds: a group of
// narrow M tiles, verify's 16 rows).  Its x is staged a round at a time in
// shared memory, in f32, K-major: the round's kRowsUnroll * TK K rows by the
// pass's RM rows, each K lane's 8 K rows 4 floats past the last lane's, so
// a warp's K lanes read 16-byte vectors from distinct banks.  A thread then
// holds RM rows' sums and applies each vector of w, read once, to all of
// them.
__host__ __device__ constexpr int xs_floats(int rm, int round_k) {
  return round_k * rm + (round_k / kRowsUnroll) * 4;
}
template <int RM>
__device__ __forceinline__ int xs_at(int kk, int r) { return kk * RM + (kk / kRowsUnroll) * 4 + r; }

// x's values of the round of K rows from kr for the rows [r0, r0 + rows),
// zeros past k1 and for the pass's rows past `rows`
template <typename T, int TK, int RM>
__device__ __forceinline__ void stage_x_round(float* xs, const T* __restrict__ x, const MatmulArgs& a,
                                              int r0, int rows, int kr, int k1, bool x_vec) {
  constexpr int U = kRowsUnroll;
  constexpr int XQ = U * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < RM * TK; i += kRowsThreads) {
    const int r = i % RM, kk = (i / RM) * U, kg = kr + kk;
    float v[U];
    if (r < rows && x_vec && kg + U <= k1) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * a.k + kg);
      uint4 q[XQ];
#pragma unroll
      for (int j = 0; j < XQ; ++j) q[j] = __ldg(src + j);
      const T* e = reinterpret_cast<const T*>(q);
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = to_f(e[u]);
    } else {
      const T* src = x + (size_t)(r0 + min(r, rows - 1)) * a.k + kg;
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = r < rows && kg + u < k1 ? to_f(src[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) xs[xs_at<RM>(kk + u, r)] = v[u];
  }
}

// H 16-byte vectors of w at the K rows from ku and VEC columns from col, as
// the register pass loads them (zeros past k1; kVec or shifted)
template <typename T, int H, bool kVec>
__device__ __forceinline__ void load_w_rows(uint4 (&wr)[H], const T* __restrict__ w, const MatmulArgs& a,
                                            int ku, int col, int cn1, int k1) {
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const T* row = w + (size_t)(ku + u) * a.n;
    if (ku + u >= k1) wr[u] = make_uint4(0, 0, 0, 0);
    else if (kVec) wr[u] = __ldg(reinterpret_cast<const uint4*>(row + col));
    else wr[u] = load16_shifted(row + col, row + cn1);
  }
}

// rows_accumulate's FMAs, in its order, for the RM rows from r0 (those past
// `rows` sum the staged zeros and are never stored).  Every thread of the
// CTA calls it (it stages x between barriers); `active`: this thread's
// columns lie in the strip.  A K lane does no FMA in a round that starts
// at or past k1, as in the register pass.
template <typename T, int TK, bool kVec, int RM>
__device__ __forceinline__ void rows_accumulate_staged(float* xs, const T* __restrict__ x,
                                                       const T* __restrict__ w, const MatmulArgs& a,
                                                       int r0, int rows, int col, int cn1, bool active,
                                                       int k0, int k1, int ty, bool x_vec,
                                                       float (&acc)[RM][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = kRowsUnroll;
  constexpr int H = kVec ? U : U / 2;
  static_assert(RM % 4 == 0, "x is read 4 rows at a time");
  for (int kr = k0; kr < k1; kr += U * TK) {
    const int kb = kr + ty * U;
    const bool live = active && kb < k1;
    uint4 wr[H];
    if (live) load_w_rows<T, H, kVec>(wr, w, a, kb, col, cn1, k1);   // in flight while x is staged
    __syncthreads();   // every thread is done with the last round's x
    stage_x_round<T, TK, RM>(xs, x, a, r0, rows, kr, k1, x_vec);
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int h0 = 0; h0 < U; h0 += H) {
      if (h0 > 0) load_w_rows<T, H, kVec>(wr, w, a, kb + h0, col, cn1, k1);
#pragma unroll
      for (int u = 0; u < H; ++u) {
        const T* e = reinterpret_cast<const T*>(&wr[u]);
        float wf[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) wf[v] = to_f(e[v]);
        const float* xk = xs + xs_at<RM>(ty * U + h0 + u, 0);
#pragma unroll
        for (int r4 = 0; r4 < RM; r4 += 4) {
          const float4 q = *reinterpret_cast<const float4*>(xk + r4);
          const float xv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r4 + j][v] = fmaf(xv[j], wf[v], acc[r4 + j][v]);
        }
      }
    }
  }
}

// Each row's sum: per thread over its K rows in ascending order, then a
// butterfly over the warp's K lanes, then the 8 warps in order, then (when
// split) the K slices in order, in the reduce kernel.  None of it depends on
// M, on the pass or on the other rows, so a row's bits are the same at
// M = 1 and M = 4, and on a 1-row tile alone or in a group of 16.  RM: rows
// a pass carries, kRowsRM in registers, kRowsCtaM staged.
template <typename T, int RM>
__global__ void __launch_bounds__(kRowsThreads, RM <= kRowsRM ? 2 : 1) matmul_rows_kernel(MatmulArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TN = kRowsCtaN / VEC;      // threads along N: 8 (bf16), 16 (f32)
  constexpr int TK = kRowsThreads / TN;    // threads along K: 32, 16
  constexpr int kWarps = kRowsThreads / 32;
  static_assert(TN <= 32 && 32 % TN == 0, "a warp holds whole K lanes");
  constexpr int kRed = kWarps * RM * kRowsCtaN;
  constexpr int kXs = RM > kRowsRM ? xs_floats(RM, kRowsUnroll * TK) : 0;
  __shared__ __align__(16) float smem[kRed > kXs ? kRed : kXs];   // the staged x, then red
  auto red = reinterpret_cast<float (*)[RM][kRowsCtaN]>(smem);

  const ExpertPtrs<T> p(a);
  // this CTA's place: group, then its strip, then its K slice
  const int per_tile = a.sub_n * a.split_k;
  const int rem = blockIdx.x % per_tile;
  const int strip = rem / a.split_k, slice = rem % a.split_k;
  int m0, n0;
  tile_origin(a, blockIdx.x / per_tile, &m0, &n0);
  const int m1 = min(m0 + a.span_m, a.m), n1 = min(n0 + a.span_n, a.n);
  const int cn0 = n0 + strip * kRowsCtaN;
  if (cn0 >= n1) return;   // a ragged group needs fewer strips
  const int cn1 = min(cn0 + kRowsCtaN, n1);
  const int k_slice = rows_k_slice(a.k, a.split_k);
  const int k0 = slice * k_slice, k1 = min(k0 + k_slice, a.k);
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = cn0 + tx * VEC;
  // 16-byte vectors stay aligned only if every row of w and every group's
  // first column start on 16 bytes (a default N tile may be 500, say)
  const bool vec_ok = (a.n % VEC) == 0 && (a.span_n % VEC) == 0 &&
                      (reinterpret_cast<uintptr_t>(p.w) % 16) == 0;
  // ... and x's rows, read kRowsUnroll values at a time from a multiple of 8
  const bool x_vec = (a.k % 8) == 0 && (reinterpret_cast<uintptr_t>(p.x) % 16) == 0;
  const bool glu = is_glu(a.epi);
  const int width = cn1 - cn0;

  for (int r0 = m0; r0 < m1; r0 += RM) {
    const int rows = min(RM, m1 - r0);
    float acc[RM][VEC];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
    if constexpr (RM <= kRowsRM) {
      if (col < cn1) {
        if (vec_ok) rows_accumulate<T, TK, true>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
        else rows_accumulate<T, TK, false>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
      }
    } else if (vec_ok) {
      rows_accumulate_staged<T, TK, true, RM>(smem, p.x, p.w, a, r0, rows, col, cn1, col < cn1, k0, k1,
                                              ty, x_vec, acc);
    } else {
      rows_accumulate_staged<T, TK, false, RM>(smem, p.x, p.w, a, r0, rows, col, cn1, col < cn1, k0, k1,
                                               ty, x_vec, acc);
    }
    // the warp's K lanes (lane bits from TN up): every lane ends with the same sum
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= rows) break;   // uniform over the CTA
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = acc[r][v];
#pragma unroll
        for (int o = TN; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        acc[r][v] = s;
      }
    }
    if constexpr (RM > kRowsRM) __syncthreads();   // the staged x is read: red takes its place
    if (lane < TN) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
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
// otherwise the two aligned vectors that hold them (load16_shifted), zeros
// past the strip's edge cn1.
template <bool kVec, int RM>
__device__ __forceinline__ void rows_tile_serial(const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ w,
                                                 const MatmulArgs& a, int r0, int rows, int col,
                                                 int cn1, int k0, int k1,
                                                 float (&acc)[RM][8]) {
  using T = __nv_bfloat16;
#pragma unroll 4
  for (int kk = k0; kk < k1; ++kk) {
    const T* row = w + (size_t)kk * a.n;
    const uint4 wr = kVec ? __ldg(reinterpret_cast<const uint4*>(row + col))
                          : load16_shifted(row + col, row + cn1);
    const T* e = reinterpret_cast<const T*>(&wr);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < rows) {   // uniform over the CTA
        const float xv = to_f(x[(size_t)(r0 + r) * a.k + kk]);
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[r][v] = fmaf(xv, to_f(e[v]), acc[r][v]);
      }
    }
  }
}

// A CTA covers one 64-column strip of one group over the whole of K, in
// one pass of RM rows; each of its 256 threads owns one (row,
// column) of each 4-row chunk of a pass and carries that output's chain over
// the K tiles in a register: chain = p_0, then chain = bf16(chain) + p_j.
// Each tile's f32 product p_j is summed first: a tile of at least
// kRowsRoundWide rows by all 32 K lanes as in the plain rows body (then the
// warp butterfly and the 8 warps in order); a shorter one by one K lane
// alone, 32 tiles side by side, folded into the chains in tile order from
// shared memory, a chunk at a time.  Slower than the plain rows body (one
// CTA per strip, no K split), and exact to the rule.
template <int RM>
__global__ void __launch_bounds__(kRowsThreads) matmul_rows_round_kernel(MatmulArgs a) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  constexpr int TN = kRowsCtaN / VEC;      // 8 threads across the strip
  constexpr int TK = kRowsThreads / TN;    // 32 K lanes
  constexpr int kWarps = kRowsThreads / 32;
  constexpr int kChunks = RM / kRowsRM;    // 4-row chunks of a pass: outputs a thread owns
  constexpr int kPart = TK * kRowsRM * kRowsCtaN;
  static_assert(kWarps * RM * kRowsCtaN <= kPart && xs_floats(RM, kRowsUnroll * TK) <= kPart,
                "the per-warp sums and the staged x fit the per-lane buffer");
  // per K lane, a chunk's rows (narrow); per warp, the pass's rows (wide); or the staged x
  __shared__ __align__(16) float smem[kPart];
  auto part = reinterpret_cast<float (*)[kRowsRM][kRowsCtaN]>(smem);
  auto wpart = reinterpret_cast<float (*)[RM][kRowsCtaN]>(smem);

  const ExpertPtrs<T> p(a);
  const int strip = blockIdx.x % a.sub_n;
  int m0, n0;
  tile_origin(a, blockIdx.x / a.sub_n, &m0, &n0);
  const int m1 = min(m0 + a.span_m, a.m), n1 = min(n0 + a.span_n, a.n);
  const int cn0 = n0 + strip * kRowsCtaN;
  if (cn0 >= n1) return;
  const int cn1 = min(cn0 + kRowsCtaN, n1), width = cn1 - cn0;
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = cn0 + tx * VEC;
  const bool vec_ok = (a.n % VEC) == 0 && (a.span_n % VEC) == 0 &&
                      (reinterpret_cast<uintptr_t>(p.w) % 16) == 0;
  // x in 16-byte vectors only where every tile starts on a multiple of 8
  const bool x_vec = (a.k % 8) == 0 && (a.round_k % 8) == 0 &&
                     (reinterpret_cast<uintptr_t>(p.x) % 16) == 0;
  const int orow = threadIdx.x / kRowsCtaN, ocol = threadIdx.x % kRowsCtaN;   // this thread's output
  const int tiles = a.k / a.round_k;

  for (int r0 = m0; r0 < m1; r0 += RM) {
    const int rows = min(RM, m1 - r0);
    float chain[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) chain[c] = 0.f;
    if (a.round_k >= kRowsRoundWide) {
      for (int t = 0; t < tiles; ++t) {
        float acc[RM][VEC];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
        const int k0 = t * a.round_k, k1 = k0 + a.round_k;
        if constexpr (RM <= kRowsRM) {
          if (col < cn1) {
            if (vec_ok) rows_accumulate<T, TK, true>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
            else rows_accumulate<T, TK, false>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, ty, x_vec, acc);
          }
        } else if (vec_ok) {
          rows_accumulate_staged<T, TK, true, RM>(smem, p.x, p.w, a, r0, rows, col, cn1, col < cn1, k0,
                                                  k1, ty, x_vec, acc);
        } else {
          rows_accumulate_staged<T, TK, false, RM>(smem, p.x, p.w, a, r0, rows, col, cn1, col < cn1, k0,
                                                   k1, ty, x_vec, acc);
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r >= rows) break;   // uniform over the CTA
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float s = acc[r][v];
#pragma unroll
            for (int o = TN; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            acc[r][v] = s;
          }
        }
        if constexpr (RM > kRowsRM) __syncthreads();   // the staged x is read
        if (lane < TN) {
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) wpart[warp][r][tx * VEC + v] = acc[r][v];
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c * kRowsRM + orow < rows && ocol < width) {
            float s = 0.f;
#pragma unroll
            for (int wi = 0; wi < kWarps; ++wi) s += wpart[wi][c * kRowsRM + orow][ocol];
            chain[c] = t == 0 ? s : round_bf16(chain[c]) + s;
          }
        }
        __syncthreads();
      }
    } else {
      for (int t0 = 0; t0 < tiles; t0 += TK) {
        const int t = t0 + ty;
        float acc[RM][VEC];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
        if (t < tiles && col < cn1) {
          const int k0 = t * a.round_k, k1 = k0 + a.round_k;
          if (vec_ok) rows_tile_serial<true, RM>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, acc);
          else rows_tile_serial<false, RM>(p.x, p.w, a, r0, rows, col, cn1, k0, k1, acc);
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
#pragma unroll
          for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) part[ty][r][tx * VEC + v] = acc[c * kRowsRM + r][v];
          __syncthreads();
          if (c * kRowsRM + orow < rows && ocol < width) {
            const int last = min(TK, tiles - t0);
            for (int j = 0; j < last; ++j) {
              const float s = part[j][orow][ocol];
              chain[c] = t0 + j == 0 ? s : round_bf16(chain[c]) + s;
            }
          }
          __syncthreads();
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * kRowsRM + orow < rows && ocol < width) {
        const int row = r0 + c * kRowsRM + orow, oc = cn0 + ocol;
        store_out(p, (size_t)row * a.n_out + oc, epilogue1(a, chain[c], row, oc));
        store_z(a, p.z, row, oc, chain[c]);
      }
    }
  }
}

// The rows body's kernels for a pass of RM rows: rounding mode, or the
// plain kernel and, where K is split, its reduce pass
template <int RM>
int launch_rows(const MatmulArgs& a, int dtype, cudaStream_t s) {
  const dim3 grid(a.ctas, a.groups);
  const dim3 rgrid(std::min(cdiv(a.m * a.n_out, 256), 4096), a.groups);
  if (a.round_k > 0) {
    matmul_rows_round_kernel<RM><<<grid, kRowsThreads, 0, s>>>(a);
  } else if (dtype == kBFloat16) {
    matmul_rows_kernel<__nv_bfloat16, RM><<<grid, kRowsThreads, 0, s>>>(a);
    if (a.split_k > 1) matmul_rows_reduce_kernel<__nv_bfloat16><<<rgrid, 256, 0, s>>>(a);
  } else {
    matmul_rows_kernel<float, RM><<<grid, kRowsThreads, 0, s>>>(a);
    if (a.split_k > 1) matmul_rows_reduce_kernel<float><<<rgrid, 256, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
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
  tile_origin(a, blockIdx.x, &m0, &n0);   // a group is one logical tile here (span = tile)
  const int m1 = min(m0 + a.span_m, a.m), n1 = min(n0 + a.span_n, a.n);
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

// The aligned mma body (w copied in aligned 16-byte chunks, cp.async's
// src-size form zero-filling the ragged edges), or kShiftW
// (csrc/matmul_shift.cu) where some row of w, a group's first column or an
// expert's w does not start on 16 bytes
int launch_mma(const MatmulArgs& a, cudaStream_t stream) {
  const bool aligned = a.n % 8 == 0 && a.span_n % 8 == 0 && aligned16(a.w) &&
                       (a.groups == 1 || ((long long)a.k * a.n) % 8 == 0);
  if (!aligned) return launch_mma_shifted(a, stream);
  const bool round = a.round_k > 0;
  if (a.cta_m == 128) return round ? launch_mma_as<MmaTile128x128, true, false>(a, stream)
                                   : launch_mma_as<MmaTile128x128, false, false>(a, stream);
  if (a.cta_n == 128) return round ? launch_mma_as<MmaTile64x128, true, false>(a, stream)
                                   : launch_mma_as<MmaTile64x128, false, false>(a, stream);
  return round ? launch_mma_as<MmaTile64x64, true, false>(a, stream)
               : launch_mma_as<MmaTile64x64, false, false>(a, stream);
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
  const Body body = a.tile_m <= 16 ? kRows : dtype == kBFloat16 ? kMma : kFma;
  // the rows body's CTA covers a group of narrow M tiles; the others' groups are one tile
  a.span_m = body == kRows ? m_group(a.m, a.tile_m, kRowsCtaM) * a.tile_m : a.tile_m;
  a.spans_m = cdiv(a.m, a.span_m);
  if (a.split_k < 1 || (body != kRows && a.split_k != 1)) return (int)cudaErrorInvalidValue;
  if (body == kMma) {
    const bool compiled = (a.cta_m == 128 && a.cta_n == 128) || (a.cta_m == 64 && a.cta_n == 128) ||
                          (a.cta_m == 64 && a.cta_n == 64);
    if (!compiled) return (int)cudaErrorInvalidValue;
  } else if (body == kRows) {  // 64-column strips of a group, split_k K slices each
    if (a.cta_m != a.span_m || a.cta_n != kRowsCtaN) return (int)cudaErrorInvalidValue;
    if (cdiv(a.k, rows_k_slice(a.k, a.split_k)) != a.split_k) return (int)cudaErrorInvalidValue;
    if (a.round_k > 0 && a.split_k != 1) return (int)cudaErrorInvalidValue;   // K tiles chain in one CTA
    if (a.split_k > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
  } else {  // one CTA per logical tile: the tile is the CTA's, so no group forms
    if (a.cta_m != a.tile_m || a.cta_n != a.tile_n) return (int)cudaErrorInvalidValue;
  }
  // kernels/matmul.py cta_count (and rows_geometry): groups of n_group
  // logical N tiles, each of sub_n CTAs; groups of span_m rows along M, each
  // of sub_m CTAs
  a.span_n = n_group(a.n, a.tile_n, a.cta_n) * a.tile_n;
  a.spans_n = cdiv(a.n, a.span_n);
  a.sub_m = cdiv(std::min(a.span_m, a.m), a.cta_m);
  a.sub_n = cdiv(std::min(a.span_n, a.n), a.cta_n);
  if ((long long)a.spans_m * a.spans_n * a.sub_m * a.sub_n * a.split_k != (long long)a.ctas)
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.ctas, a.groups);
  switch (body) {
    case kRows:
      // one pass over the CTA's rows: in registers up to kRowsRM, else staged
      return std::min(a.span_m, a.m) <= kRowsRM ? launch_rows<kRowsRM>(a, dtype, s)
                                                : launch_rows<kRowsCtaM>(a, dtype, s);
    case kFma:
      matmul_fma_kernel<<<grid, 256, 0, s>>>(a);
      break;
    case kMma:
      return launch_mma(a, s);
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
