// The matmul kernels' shared definitions (K1, K1g; csrc/matmul.cu describes
// them): the launch arguments, the epilogues, the placement of a CTA's
// group of logical tiles, the tensor-core bodies' epilogue of an
// accumulator pair (csrc/matmul_wgmma.cu's wgmma body uses it too), and the
// mma body, whose instantiations two sources compile side by side
// (csrc/matmul.cu the aligned ones, csrc/matmul_shift.cu those reading w as
// shifted aligned vectors).
#pragma once

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
  int tile_m, tile_n, m_outer;  // logical tiles
  int span_m, spans_m;          // rows of one group of logical M tiles (rows body: m_group * tile_m,
                                // else tile_m), groups along M
  int span_n, spans_n;          // columns of one group of logical N tiles (n_group * tile_n), groups along N
  int cta_m, cta_n, sub_m, sub_n, ctas;   // CTA tile, CTAs per logical tile (M) and group (N), gridDim.x
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

// Origin of group t (a group of span_m rows x a group of span_n columns) in
// the schedule's order.
__device__ __forceinline__ void tile_origin(const MatmulArgs& a, int t, int* m0, int* n0) {
  int tm, tn;
  if (a.m_outer) { tm = t / a.spans_n; tn = t % a.spans_n; }
  else           { tn = t / a.spans_m; tm = t % a.spans_m; }
  *m0 = tm * a.span_m;
  *n0 = tn * a.span_n;
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

// This CTA's output rectangle [cm0, cm1) x [cn0, cn1) in a tensor-core body
// of bm x bn CTAs: its group in the schedule's order, then its sub-tile
// inside the group (along N first), clipped to the group, M and N.  False:
// a ragged group needs fewer sub-tiles.
__device__ __forceinline__ bool cta_rect(const MatmulArgs& a, int bm, int bn, int* cm0, int* cn0,
                                         int* cm1, int* cn1) {
  const int per_tile = a.sub_m * a.sub_n, sub = blockIdx.x % per_tile;
  int m0, n0;
  tile_origin(a, blockIdx.x / per_tile, &m0, &n0);
  const int m1 = min(m0 + a.span_m, a.m), n1 = min(n0 + a.span_n, a.n);
  *cm0 = m0 + (sub / a.sub_n) * bm;
  *cn0 = n0 + (sub % a.sub_n) * bn;
  *cm1 = min(*cm0 + bm, m1);
  *cn1 = min(*cn0 + bn, n1);
  return *cm0 < m1 && *cn0 < n1;
}

// The epilogue of one accumulator pair of a tensor-core body: the f32 sums
// y0 and y1 at (row, col) and (row, col + 1), col even, the second past the
// CTA's last column cn1 where that is odd.  Y in f32 or rounded to bf16 (a
// GLU's one value at col / 2: gate at col, up at col + 1), and Z beside it.
// In mma.sync's m16n8 blocks and in wgmma's 64 x N fragments alike a thread
// holds columns 2t and 2t + 1 of each 8-column block, so a GLU pair never
// leaves its thread (a GLU's N tile is even, so is every CTA's first column).
__device__ __forceinline__ void store_pair_epilogue(const MatmulArgs& a,
                                                    const ExpertPtrs<__nv_bfloat16>& p, int row,
                                                    int col, int cn1, bool glu, float y0, float y1) {
  using bf16 = __nv_bfloat16;
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
  // the shifted read of w: each stage's rows of BN columns from any column
  // as BN / 8 + 1 aligned vectors (a row of kLdB), shifted into a staging
  // buffer of one stage's B after the ring
  static constexpr int kRawB = BN / 8 + 1;
  static constexpr int kShiftBytes = kStageK * kLdB * 2;
  static_assert(kLdB == 8 * kRawB, "a raw row holds the aligned vectors of BN columns");
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
// plain body's code is untouched by it.  kShiftW: rows of w (or a group's
// first column, or an expert's w) do not start on 16 bytes, so each stage
// of w is copied as the aligned vectors that span the CTA's columns and
// shifted into place in shared memory before ldmatrix reads it
// (csrc/matmul.cu launch_mma chooses; csrc/matmul_shift.cu compiles it)
template <class Tile, bool kRound, bool kShiftW>
__global__ void __launch_bounds__(Tile::kThreads) matmul_mma_kernel(MatmulArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = Tile::BM, BN = Tile::BN, kLdA = Tile::kLdA, kLdB = Tile::kLdB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const ExpertPtrs<bf16> p(a);
  int cm0, cn0, cm1, cn1;
  if (!cta_rect(a, BM, BN, &cm0, &cn0, &cm1, &cn1)) return;
  // 16-byte chunks of x stay aligned only if every row starts on 16 bytes;
  // those of w do unless kShiftW (launch_mma)
  const bool vec_x = a.k % 8 == 0 && (reinterpret_cast<uintptr_t>(p.x) % 16) == 0;
  bf16* shifted = smem + kStages * Tile::kStageElems;   // kShiftW: one stage of w, in place

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
    if constexpr (kShiftW) {   // raw: the aligned vectors that hold columns [cn0, cn1) of each row
      stage_raw_rows<kStageK, Tile::kRawB, Tile::kThreads>(sb, p.w, a.n, k0, a.k, cn0, cn1);
    } else {
#pragma unroll
      for (int j = 0; j < Tile::kChunksB / Tile::kThreads; ++j) {
        const int i = threadIdx.x + j * Tile::kThreads;
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int gk = k0 + r, gn = cn0 + c;
        const int valid = gk < a.k ? cn1 - gn : 0;
        stage8(sb + r * kLdB + c, valid > 0 ? p.w + (size_t)gk * a.n + gn : p.w, valid, true);
      }
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
    if constexpr (kShiftW) {
      shift_raw_rows<kStageK, Tile::kRawB, Tile::kThreads>(shifted, sb, p.w, a.n, kt * kStageK, cn0);
      __syncthreads();   // every chunk shifted; the ring's raw slot is free again
      sb = shifted;
    }
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
  // g + 8, columns 2t and 2t + 1 of each m16n8 block (store_pair_epilogue)
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
        store_pair_epilogue(a, p, row, col, cn1, glu, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <class Tile, bool kRound, bool kShiftW>
int launch_mma_as(const MatmulArgs& a, cudaStream_t stream) {
  constexpr int smem = Tile::kSmemBytes + (kShiftW ? Tile::kShiftBytes : 0);
  const cudaError_t e = cudaFuncSetAttribute(matmul_mma_kernel<Tile, kRound, kShiftW>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  matmul_mma_kernel<Tile, kRound, kShiftW><<<dim3(a.ctas, a.groups), Tile::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The mma body on w read as shifted aligned vectors (kShiftW), for every
// compiled CTA tile, plain and in rounding mode (csrc/matmul_shift.cu).
int launch_mma_shifted(const MatmulArgs& a, cudaStream_t stream);

// The wgmma body (csrc/matmul_wgmma.cu) on the CTA tile a.cta_m x a.cta_n,
// one of kernels/matmul.py WGMMA_CTA_TILES.  cudaErrorNotSupported where the
// driver refuses a tensor map: the launch fails, it never falls through to
// another body.
int launch_wgmma(const MatmulArgs& a, cudaStream_t stream);

}  // namespace repro
