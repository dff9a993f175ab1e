// The gradient GEMMs of K1 and K1g for Hopper (sm_90a): out(M,N) = op(A) · op(B)
// with A stored (M,K) or (K,M) and B stored (K,N) or (N,K), both read where
// they lie, so the backward makes no transposed copy.
//
// Replaces no Pallas kernel of its own: the reference's gradients of
// matmul() and grouped_matmul() (src/repro/kernels/matmul.py:216,236) are
// XLA's.  kernels/matmul.py MatmulFn and GroupedMatmulFn launch it for
// dX = dZ·wᵀ, dW = xᵀ·dZ, a tied head's dE = dZᵀ·x and the pre-activation
// the GLU and gelu classes recompute; K1g puts the expert on the grid's y
// axis and masks each tile at its own expert's edges, as its forward does.
// Sums are f32 in an order fixed by the shape (no atomics, no K split), so
// two runs give the same bits.  Epilogues: none (class matmul) or an f32
// bias (matmul_bias); the output is the operands' dtype.
//
// Operand modes (the wrapper reads them from the strides, kernels/matmul.py
// operand_layout): a_t = 0 stores A as (M,K) rows of a_ld elements, a_t = 1
// as (K,M); b_t = 0 stores B as (K,N) (the forward's w), b_t = 1 as (N,K).
// K1g adds a_batch, b_batch: an expert's stride.
//
// Three bodies, a rule by dtype and alignment (kernels/matmul.py
// grad_geometry; run_grad re-checks it and refuses a mismatch):
//
//  * wgmma (bf16, each operand's base, row stride and expert stride
//    multiples of 16 bytes, and along an operand's contiguous M or N the
//    logical tile a multiple of 8: every training shape of gemma2, rwkv6,
//    recurrentgemma and mixtral).  128x128 or 128x256 CTA tiles
//    (kernels/matmul.py grad_cta: the wider where it leaves no column of a
//    logical tile idle and still gives two waves); a producer warp keeps a
//    ring of 5 stages (4 at 128x256), each 64 deep in K, filled by TMA
//    (tensor maps with 128-byte swizzle, 3-D over the experts; out-of-bounds
//    boxes fill zeros, which covers every ragged edge of M, N and K) and
//    signalled by mbarriers; two consumer warpgroups each run
//    wgmma.mma_async m64n128k16 (m64n256k16) from shared-memory
//    descriptors.  An MN-major operand (A stored (K,M), B stored (K,N)) is
//    loaded as 64-wide boxes along M or N and read with wgmma's transpose
//    bit set; a K-major one as one 64-deep box.  The
//    operations bound it at every training shape: at M, N >= ~300 the
//    H100's tensor cores need ~295 bf16 operations per byte of HBM.
//  * mma (other bf16: the LM heads of whisper-medium and internvl2-26b,
//    whose rows of 51865 and 92553 elements are not 16-byte aligned).  The
//    forward's mma.sync body (csrc/matmul.cu) with operand modes: A stored
//    (K,M) is staged [k][m] and read with ldmatrix.trans, B stored (N,K)
//    staged [n][k] and read with plain ldmatrix; 16-byte cp.async where a
//    row allows it.  Where B stored (K,N) does not (dW's dZ at an odd N),
//    each stage's rows are copied as the aligned vectors that span the CTA's
//    columns and shifted into place in shared memory, as the forward does
//    for w (kShiftB); elsewhere guarded scalar loads.  A 4-deep ring of
//    32-deep stages, 128x128 or 64x128 CTAs on 8 warps.
//  * fma (f32): CUDA-core FMA on 64x64x16 shared tiles, 4x4 per thread,
//    strided scalar loads ordered so a warp's loads follow the contiguous
//    dimension.  f32 stays off the tensor cores by rule (TF32 keeps about
//    three decimal digits; the f32 tolerance is 2e-4).
//
// Logical tile, group and CTA tile, as in the forward (csrc/matmul.cu): the
// schedule's (tile_m x tile_n) output tile (kernels/matmul.py grad_schedule,
// grouped_grad_schedule) is the unit of rasterisation and of edge masking.
// Where the N tile is narrower than both N and the CTA's columns, one CTA
// covers n_group = floor(cta_n / tile_n) consecutive logical tiles along N
// (internvl2-26b's dW at an N tile of 3: 42 in a 128-column CTA), in every
// body; otherwise a group is one tile.  Groups are numbered in the
// schedule's order; each is covered by sub_m x sub_n CTAs numbered along N
// first, and a CTA stores only the part of its tile inside its group and N
// (kernels/matmul.py grad_cta, cta_count).  No output's summation order
// depends on which columns share its CTA.
#include <cuda.h>
#include <dlfcn.h>

#include <algorithm>

#include "mma.cuh"

namespace repro {
namespace grad {

enum Body : int { kWgmma = 0, kMma = 1, kFma = 2 };

struct GradArgs {
  const void* a; const void* b; const float* bias; void* out;
  long long a_ld, b_ld, a_batch, b_batch;   // elements; the batch strides per expert
  int a_t, b_t;                             // operand modes (see above)
  int m, n, k, groups;                      // per expert; groups = gridDim.y
  int tile_m, tile_n, tiles_m, m_outer;     // logical tiles
  int span_n, spans_n;                      // columns of one group of N tiles (n_group * tile_n), groups along N
  int cta_m, cta_n, sub_m, sub_n, ctas;     // CTA tile, CTAs per logical tile (M) and group (N), gridDim.x
  int out_f32;                              // out is f32 (unrounded sums), else the operands' dtype
};

// One output pair (y0 at col, y1 at col + 1 where two) of a bf16 launch:
// rounded to bf16, or f32 where the caller asked for it.  The f32 form is
// a column-parallel product's partial input gradient under tensor
// parallelism, which the ranks add over `model` before it is rounded.
__device__ __forceinline__ void store_pair(const GradArgs& a, size_t at, float y0, float y1,
                                           bool two) {
  if (a.out_f32) {
    float* o = static_cast<float*>(a.out) + at;
    o[0] = y0;
    if (two) o[1] = y1;
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + at;
    if (two) store2(o, y0, y1);
    else *o = __float2bfloat16_rn(y0);
  }
}

// This CTA's output rectangle [cm0, cm1) x [cn0, cn1): its group (logical
// tile rows x span_n columns) in the schedule's order, then its sub-tile
// (along N first), clipped to the group and N.  False: a ragged group needs
// fewer sub-tiles.
__device__ __forceinline__ bool cta_place(const GradArgs& a, int bm, int bn, int* cm0, int* cn0,
                                          int* cm1, int* cn1) {
  const int per_tile = a.sub_m * a.sub_n, sub = blockIdx.x % per_tile, t = blockIdx.x / per_tile;
  int tm, tn;
  if (a.m_outer) { tm = t / a.spans_n; tn = t % a.spans_n; }
  else           { tn = t / a.tiles_m; tm = t % a.tiles_m; }
  const int m0 = tm * a.tile_m, n0 = tn * a.span_n;
  const int m1 = min(m0 + a.tile_m, a.m), n1 = min(n0 + a.span_n, a.n);
  *cm0 = m0 + (sub / a.sub_n) * bm;
  *cn0 = n0 + (sub % a.sub_n) * bn;
  *cm1 = min(*cm0 + bm, m1);
  *cn1 = min(*cn0 + bn, n1);
  return *cm0 < m1 && *cn0 < n1;
}

// ---------------------------------------------------------------------------
// wgmma body
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128, kWgBK = 64;                 // CTA rows, stage depth
constexpr int kWgABytes = kWgBM * kWgBK * 2;           // A's stage: 16 KB
constexpr int kWgBox = 64 * 64 * 2;                    // an MN-major box: 64 wide, 64 deep
constexpr int kWgConsumerWarps = 8;                    // two warpgroups
constexpr int kWgThreads = 32 * kWgConsumerWarps + 32; // and one producer warp

// A CTA tile of 128 x BN (BN = 128 or 256): each consumer warpgroup holds a
// 64 x BN f32 fragment (BN / 2 registers a thread); the ring takes as many
// 64-deep stages as 227 KB hold (5 of 32 KB, 4 of 48 KB).
template <int BN>
struct WgTile {
  static constexpr int kBBytes = BN * kWgBK * 2;
  static constexpr int kStageBytes = kWgABytes + kBBytes;
  static constexpr int kStages = BN == 128 ? 5 : 4;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(BN == 128 || BN == 256, "the compiled widths");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// a box of a 3-D tensor map at coordinates (c0 innermost, c1, c2 = expert)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// A shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
// K-major: rows of 128 bytes (64 K values), 8-row groups SBO = 1024 bytes
// apart (LBO unused).  MN-major: K rows of 128 bytes (64 M or N values),
// 8-row groups SBO = 1024 apart, 64-wide MN blocks LBO apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64x128 f32, the warpgroup's fragment) += A (64x16) · B (16x128) from
// shared memory.  TA: A is MN-major (stored (K,M)); TB: B is MN-major
// (stored (K,N)): wgmma's transpose bits, which swap which dimension is
// contiguous.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the same at N = 256: a 64x256 fragment, 128 registers a thread
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128k16<TA, TB>(d, da, db);
  else wgmma_m64n256k16<TA, TB>(d, da, db);
}

// TA = a_t; TB = 1 - b_t (b_t = 1 stores B as (N,K): K-major, no transpose)
template <int BN, int TA, int TB>
__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_grad_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b, GradArgs a) {
  using bf16 = __nv_bfloat16;
  using Tile = WgTile<BN>;
  constexpr int kStages = Tile::kStages, kStageBytes = Tile::kStageBytes;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  int cm0, cn0, cm1, cn1;
  if (!cta_place(a, kWgBM, BN, &cm0, &cn0, &cm1, &cn1)) return;

  // 1024-byte aligned stages (the swizzle pattern repeats every 1024 bytes)
  const uint32_t base = (smem_addr(wg_smem) + 1023) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes, empty = full + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.y;
  const int ktiles = cdiv(a.k, kWgBK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumerWarps) {   // the producer: one thread keeps the ring full
    if (lane == 0) {
      // an MN-major operand's 64-wide boxes are loaded only where they start
      // inside the tensor: the rows or columns the others would fill are
      // masked at the store, so what the slot holds there does not matter
      const int a_boxes = TA ? min(2, cdiv(a.m - cm0, 64)) : 0;
      const int b_boxes = TB ? min(BN / 64, cdiv(a.n - cn0, 64)) : 0;
      const uint32_t bytes = (TA ? a_boxes * kWgBox : kWgABytes) +
                             (TB ? b_boxes * kWgBox : Tile::kBBytes);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
        const uint32_t sa = base + s * kStageBytes, sb = sa + kWgABytes, bar = full + 8 * s;
        const int k0 = kt * kWgBK;
        mbar_expect_tx(bar, bytes);
        if (TA) {   // (K,M): 64-wide boxes along M
          for (int h = 0; h < a_boxes; ++h) tma_load(sa + h * kWgBox, &map_a, bar, cm0 + 64 * h, k0, e);
        } else {    // (M,K): one box of 128 rows, 64 deep
          tma_load(sa, &map_a, bar, k0, cm0, e);
        }
        if (TB) {   // (K,N): 64-wide boxes along N
          for (int h = 0; h < b_boxes; ++h) tma_load(sb + h * kWgBox, &map_b, bar, cn0 + 64 * h, k0, e);
        } else {    // (N,K): one box of BN rows
          tma_load(sb, &map_b, bar, k0, cn0, e);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t sa = base + s * kStageBytes + wg * kWgBox, sb = base + s * kStageBytes + kWgABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // a 16-deep step: 32 bytes along a K-major row, 16 rows (2048 bytes) of an MN-major box
      const uint64_t da = smem_desc(sa + (TA ? kk * 2048 : kk * 32), TA ? kWgBox : 0, 1024);
      const uint64_t db = smem_desc(sb + (TB ? kk * 2048 : kk * 32), TB ? kWgBox : 0, 1024);
      wgmma_step<BN, TA, TB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: release its slot
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();

  // accumulator fragment: thread (warp w of the warpgroup, lane l) holds rows
  // 16w + l/4 and + 8, columns 8j + 2(l%4) and + 1, j < BN / 8
  const size_t plane = (size_t)e * a.m * a.n;
  const int r0 = cm0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = cn0 + 8 * j + 2 * (lane % 4);
    if (col >= cn1) continue;
    const float b0 = a.bias ? a.bias[col] : 0.f;
    const float b1 = a.bias && col + 1 < cn1 ? a.bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= cm1) continue;
      const float y0 = acc[4 * j + 2 * h] + b0, y1 = acc[4 * j + 2 * h + 1] + b1;
      store_pair(a, plane + (size_t)row * a.n + col, y0, y1, col + 1 < cn1);
    }
  }
}

// ---------------------------------------------------------------------------
// mma body with operand modes (bf16 operands TMA cannot take)
// ---------------------------------------------------------------------------

constexpr int kMmStageK = 32, kMmStages = 4, kMmPad = 8, kMmBN = 128, kMmThreads = 256;

template <int BM, bool TA, bool TB>
struct MmGradTile {
  static constexpr int kWarpM = BM / 2, kWarpN = kMmBN / 4;        // 2 x 4 warps
  static constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 8;
  // shared row strides: A [m][k] or [k][m], B [k][n] or [n][k]
  static constexpr int kLdA = TA ? BM + kMmPad : kMmStageK + kMmPad;
  static constexpr int kLdB = TB ? kMmStageK + kMmPad : kMmBN + kMmPad;
  static constexpr int kElemsA = TA ? kMmStageK * kLdA : BM * kLdA;
  static constexpr int kElemsB = TB ? kMmBN * kLdB : kMmStageK * kLdB;
  static constexpr int kStageElems = kElemsA + kElemsB;
  static constexpr int kSmemBytes = kMmStages * kStageElems * 2;
  static constexpr int kChunksA = BM * kMmStageK / 8, kChunksB = kMmBN * kMmStageK / 8;
  static_assert(kChunksA % kMmThreads == 0 && kChunksB % kMmThreads == 0, "even staging");
  // the shifted read of B stored (K,N): a stage's rows of kMmBN columns from
  // any column as kMmBN / 8 + 1 aligned vectors (a row of kLdB), shifted into
  // a staging buffer of one stage's B after the ring
  static constexpr int kRawB = kMmBN / 8 + 1;
  static constexpr int kShiftBytes = kMmStageK * kLdB * 2;
};

// kShiftB (B stored (K,N) only): B's rows, a group's first column or an
// expert's B do not start on 16 bytes, so each stage is copied as aligned
// vectors and shifted in shared memory (run_grad chooses)
template <int BM, bool TA, bool TB, bool kShiftB>
__global__ void __launch_bounds__(kMmThreads) matmul_grad_mma_kernel(GradArgs a) {
  using bf16 = __nv_bfloat16;
  using Tile = MmGradTile<BM, TA, TB>;
  static_assert(!kShiftB || (!TB && Tile::kLdB == 8 * Tile::kRawB), "the shifted read is of B (K,N)");
  constexpr int kLdA = Tile::kLdA, kLdB = Tile::kLdB;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(mm_smem);
  int cm0, cn0, cm1, cn1;
  if (!cta_place(a, BM, kMmBN, &cm0, &cn0, &cm1, &cn1)) return;
  const size_t e = blockIdx.y;
  const bf16* A = static_cast<const bf16*>(a.a) + e * a.a_batch;
  const bf16* B = static_cast<const bf16*>(a.b) + e * a.b_batch;
  // 16-byte cp.async only where every staged chunk starts on 16 bytes: the
  // rows, and along a contiguous M or N every logical tile's origin
  const bool vec_a = a.a_ld % 8 == 0 && aligned16(A) && (!TA || a.tile_m % 8 == 0);
  const bool vec_b = a.b_ld % 8 == 0 && aligned16(B) && (TB || a.span_n % 8 == 0);
  bf16* shifted = smem + kMmStages * Tile::kStageElems;   // kShiftB: one stage of B, in place

  // A's rows [cm0, cm1) and B's columns [cn0, cn1) of K slice [k0, k0 + 32)
  auto load_stage = [&](int slot, int k0) {
    bf16* sa = smem + slot * Tile::kStageElems;
    bf16* sb = sa + Tile::kElemsA;
#pragma unroll
    for (int j = 0; j < Tile::kChunksA / kMmThreads; ++j) {
      const int i = threadIdx.x + j * kMmThreads;
      if (TA) {   // a k row of 8 m values
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8, gk = k0 + r, gm = cm0 + c;
        const int valid = gk < a.k ? cm1 - gm : 0;
        stage8(sa + r * kLdA + c, valid > 0 ? A + (size_t)gk * a.a_ld + gm : A, valid, vec_a);
      } else {    // an m row of 8 k values
        const int r = i / (kMmStageK / 8), c = (i % (kMmStageK / 8)) * 8, gm = cm0 + r, gk = k0 + c;
        const int valid = gm < cm1 ? a.k - gk : 0;
        stage8(sa + r * kLdA + c, valid > 0 ? A + (size_t)gm * a.a_ld + gk : A, valid, vec_a);
      }
    }
    if constexpr (kShiftB) {   // raw: the aligned vectors that hold columns [cn0, cn1) of each k row
      stage_raw_rows<kMmStageK, Tile::kRawB, kMmThreads>(sb, B, a.b_ld, k0, a.k, cn0, cn1);
    } else {
#pragma unroll
      for (int j = 0; j < Tile::kChunksB / kMmThreads; ++j) {
        const int i = threadIdx.x + j * kMmThreads;
        if (TB) {   // an n row of 8 k values
          const int r = i / (kMmStageK / 8), c = (i % (kMmStageK / 8)) * 8, gn = cn0 + r, gk = k0 + c;
          const int valid = gn < cn1 ? a.k - gk : 0;
          stage8(sb + r * kLdB + c, valid > 0 ? B + (size_t)gn * a.b_ld + gk : B, valid, vec_b);
        } else {    // a k row of 8 n values
          const int r = i / (kMmBN / 8), c = (i % (kMmBN / 8)) * 8, gk = k0 + r, gn = cn0 + c;
          const int valid = gk < a.k ? cn1 - gn : 0;
          stage8(sb + r * kLdB + c, valid > 0 ? B + (size_t)gk * a.b_ld + gn : B, valid, vec_b);
        }
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / 4) * Tile::kWarpM, wn0 = (warp % 4) * Tile::kWarpN;
  float acc[Tile::kFragM][Tile::kFragN][4];
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int ktiles = cdiv(a.k, kMmStageK);
#pragma unroll
  for (int s = 0; s < kMmStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s * kMmStageK);
    cp_async_commit();
  }
  // ldmatrix x4: lane l addresses row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kMmStages - 2>();
    __syncthreads();
    const int next = kt + kMmStages - 1;
    if (next < ktiles) load_stage(next % kMmStages, next * kMmStageK);
    cp_async_commit();

    const bf16* sa = smem + (kt % kMmStages) * Tile::kStageElems;
    const bf16* sb = sa + Tile::kElemsA;
    if constexpr (kShiftB) {
      shift_raw_rows<kMmStageK, Tile::kRawB, kMmThreads>(shifted, sb, B, a.b_ld, kt * kMmStageK, cn0);
      __syncthreads();   // every chunk shifted; the ring's raw slot is free again
      sb = shifted;
    }
#pragma unroll
    for (int kk = 0; kk < kMmStageK; kk += 16) {
      // A fragments: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
      uint32_t af[Tile::kFragM][4], bfr[Tile::kFragN][2];
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i) {
        if (TA) {
          const int m = wm0 + i * 16 + (mi & 1) * 8, kc = kk + (mi >> 1) * 8;
          ldmatrix_x4_trans(af[i], smem_addr(sa + (kc + mr) * kLdA + m));
        } else {
          ldmatrix_x4(af[i], smem_addr(sa + (wm0 + i * 16 + lane % 16) * kLdA + kk + (lane / 16) * 8));
        }
      }
      // B fragments, two n8 blocks per x4: (k 0-7, n j), (k 8-15, n j), then n j + 1
#pragma unroll
      for (int j = 0; j < Tile::kFragN; j += 2) {
        uint32_t t[4];
        if (TB) {
          const int n = wn0 + j * 8 + (mi >> 1) * 8, kc = kk + (mi & 1) * 8;
          ldmatrix_x4(t, smem_addr(sb + (n + mr) * kLdB + kc));
        } else {
          ldmatrix_x4_trans(t, smem_addr(sb + (kk + lane % 16) * kLdB + wn0 + j * 8 + (lane / 16) * 8));
        }
        bfr[j][0] = t[0]; bfr[j][1] = t[1]; bfr[j + 1][0] = t[2]; bfr[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i)
#pragma unroll
        for (int j = 0; j < Tile::kFragN; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  const size_t plane = (size_t)e * a.m * a.n;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j) {
      const int col = cn0 + wn0 + j * 8 + 2 * tq;
      if (col >= cn1) continue;
      const float b0 = a.bias ? a.bias[col] : 0.f;
      const float b1 = a.bias && col + 1 < cn1 ? a.bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = cm0 + wm0 + i * 16 + g + 8 * h;
        if (row >= cm1) continue;
        const float y0 = acc[i][j][2 * h] + b0, y1 = acc[i][j][2 * h + 1] + b1;
        store_pair(a, plane + (size_t)row * a.n + col, y0, y1, col + 1 < cn1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fma body (f32) with operand modes
// ---------------------------------------------------------------------------

constexpr int kFmBM = 64, kFmBN = 64, kFmBK = 16;

__global__ void __launch_bounds__(256) matmul_grad_fma_kernel(GradArgs a) {
  __shared__ float As[kFmBK][kFmBM + 4];   // As[k][m]
  __shared__ float Bs[kFmBK][kFmBN + 4];   // Bs[k][n]
  int cm0, cn0, cm1, cn1;
  if (!cta_place(a, kFmBM, kFmBN, &cm0, &cn0, &cm1, &cn1)) return;
  const size_t e = blockIdx.y;
  const float* A = static_cast<const float*>(a.a) + e * a.a_batch;
  const float* B = static_cast<const float*>(a.b) + e * a.b_batch;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.k; k0 += kFmBK) {
    // neighbouring threads along the operand's contiguous dimension
    for (int i = threadIdx.x; i < kFmBM * kFmBK; i += blockDim.x) {
      const int mm = a.a_t ? i % kFmBM : i / kFmBK, kk = a.a_t ? i / kFmBM : i % kFmBK;
      const int gm = cm0 + mm, gk = k0 + kk;
      As[kk][mm] = gm < cm1 && gk < a.k
                       ? A[a.a_t ? (size_t)gk * a.a_ld + gm : (size_t)gm * a.a_ld + gk] : 0.f;
    }
    for (int i = threadIdx.x; i < kFmBK * kFmBN; i += blockDim.x) {
      const int kk = a.b_t ? i % kFmBK : i / kFmBN, nn = a.b_t ? i / kFmBK : i % kFmBN;
      const int gk = k0 + kk, gn = cn0 + nn;
      Bs[kk][nn] = gk < a.k && gn < cn1
                       ? B[a.b_t ? (size_t)gn * a.b_ld + gk : (size_t)gk * a.b_ld + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmBK; ++kk) {
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

  float* out = static_cast<float*>(a.out) + e * a.m * a.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = cm0 + ty * 4 + i;
    if (row >= cm1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cn0 + tx * 4 + j;
      if (col < cn1) out[(size_t)row * a.n + col] = acc[i][j] + (a.bias ? a.bias[col] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded (no link
// against libcuda); null where there is none
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 3-D bf16 tensor map (inner, outer, expert) with 128-byte swizzle and
// zero fill out of bounds: boxes of 64 inner values by box_outer rows.
bool make_map(CUtensorMap* map, const void* p, long long inner, long long outer, long long ld,
              long long batch, int groups, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)groups};
  // an expert stride is read only when there are several experts
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)(groups > 1 ? batch : ld * outer) * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_outer, 1}, elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int TA, int TB>
int launch_wgmma(const GradArgs& a, cudaStream_t s) {
  using Tile = WgTile<BN>;
  CUtensorMap ma, mb;
  // A: (M,K) rows, one 128-row box per stage; or (K,M), 64-wide boxes
  const bool ok_a = TA ? make_map(&ma, a.a, a.m, a.k, a.a_ld, a.a_batch, a.groups, kWgBK)
                       : make_map(&ma, a.a, a.k, a.m, a.a_ld, a.a_batch, a.groups, kWgBM);
  // B: (K,N) rows (MN-major), 64-wide boxes; or (N,K), one BN-row box
  const bool ok_b = TB ? make_map(&mb, a.b, a.n, a.k, a.b_ld, a.b_batch, a.groups, kWgBK)
                       : make_map(&mb, a.b, a.k, a.n, a.b_ld, a.b_batch, a.groups, BN);
  if (!ok_a || !ok_b) return (int)cudaErrorNotSupported;   // the driver refused a tensor map
  auto kernel = matmul_grad_wgmma_kernel<BN, TA, TB>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.ctas, a.groups), kWgThreads, Tile::kSmemBytes, s>>>(ma, mb, a);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgmma_as(const GradArgs& a, cudaStream_t s) {
  if (a.a_t) return a.b_t ? launch_wgmma<BN, 1, 0>(a, s) : launch_wgmma<BN, 1, 1>(a, s);
  return a.b_t ? launch_wgmma<BN, 0, 0>(a, s) : launch_wgmma<BN, 0, 1>(a, s);
}

template <int BM, bool TA, bool TB, bool kShiftB = false>
int launch_mma_as(const GradArgs& a, cudaStream_t s) {
  using Tile = MmGradTile<BM, TA, TB>;
  constexpr int smem = Tile::kSmemBytes + (kShiftB ? Tile::kShiftBytes : 0);
  auto kernel = matmul_grad_mma_kernel<BM, TA, TB, kShiftB>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.ctas, a.groups), kMmThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// B stored (K,N) takes the shifted read where its rows, a group's first
// column or an expert's B do not start on 16 bytes
template <int BM, bool TA>
int launch_mma_kn(const GradArgs& a, cudaStream_t s) {
  const bool aligned = a.b_ld % 8 == 0 && aligned16(a.b) && a.span_n % 8 == 0 &&
                       (a.groups == 1 || a.b_batch % 8 == 0);
  return aligned ? launch_mma_as<BM, TA, false>(a, s) : launch_mma_as<BM, TA, false, true>(a, s);
}

template <int BM>
int launch_mma(const GradArgs& a, cudaStream_t s) {
  if (a.a_t) return a.b_t ? launch_mma_as<BM, true, true>(a, s) : launch_mma_kn<BM, true>(a, s);
  return a.b_t ? launch_mma_as<BM, false, true>(a, s) : launch_mma_kn<BM, false>(a, s);
}

bool aligned_operand(const void* p, long long ld, long long batch, int groups) {
  return aligned16(p) && (ld * 2) % 16 == 0 && (groups == 1 || (batch * 2) % 16 == 0);
}

// Checks the arguments, the body the wrapper chose (kernels/matmul.py
// grad_geometry) and its CTA geometry (grad_cta), then launches; returns a
// cudaError_t (cudaErrorInvalidValue for bad arguments).
int run_grad(GradArgs& a, int dtype, int body, void* stream) {
  // an error an earlier runtime call left in this thread, unchecked, is not
  // this launch's: clear it, so what the launch returns is its own
  (void)cudaGetLastError();
  if (a.m <= 0 || a.n <= 0 || a.k <= 0 || a.tile_m <= 0 || a.tile_n <= 0) return (int)cudaErrorInvalidValue;
  if (a.groups <= 0 || a.groups > 65535 || a.ctas <= 0) return (int)cudaErrorInvalidValue;
  if ((a.a_t != 0 && a.a_t != 1) || (a.b_t != 0 && a.b_t != 1)) return (int)cudaErrorInvalidValue;
  // each operand's stride covers its contiguous extent
  if (a.a_ld < (a.a_t ? a.m : a.k) || a.b_ld < (a.b_t ? a.k : a.n)) return (int)cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return (int)cudaErrorInvalidValue;
  if (a.out_f32 != 0 && a.out_f32 != 1) return (int)cudaErrorInvalidValue;
  // the rule by dtype and alignment: TMA reads boxes whose contiguous
  // dimension starts on 16 bytes, so along a contiguous M (N) every logical
  // tile's origin must too
  const bool aligned = aligned_operand(a.a, a.a_ld, a.a_batch, a.groups) &&
                       aligned_operand(a.b, a.b_ld, a.b_batch, a.groups) &&
                       (!a.a_t || a.tile_m % 8 == 0) && (a.b_t || a.tile_n % 8 == 0);
  const int want = dtype == kFloat32 ? kFma : aligned ? kWgmma : kMma;
  if (body != want) return (int)cudaErrorInvalidValue;
  const bool cta_ok = body == kWgmma ? a.cta_m == kWgBM && (a.cta_n == 128 || a.cta_n == 256)
                    : body == kMma   ? (a.cta_m == 128 || a.cta_m == 64) && a.cta_n == kMmBN
                                     : a.cta_m == kFmBM && a.cta_n == kFmBN;
  if (!cta_ok) return (int)cudaErrorInvalidValue;
  // kernels/matmul.py cta_count: groups of n_group logical N tiles, each of
  // sub_n CTAs; sub_m CTAs per logical tile along M
  a.span_n = n_group(a.n, a.tile_n, a.cta_n) * a.tile_n;
  a.tiles_m = cdiv(a.m, a.tile_m);
  a.spans_n = cdiv(a.n, a.span_n);
  a.sub_m = cdiv(std::min(a.tile_m, a.m), a.cta_m);
  a.sub_n = cdiv(std::min(a.span_n, a.n), a.cta_n);
  if ((long long)a.tiles_m * a.spans_n * a.sub_m * a.sub_n != (long long)a.ctas)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kWgmma:
      return a.cta_n == 256 ? launch_wgmma_as<256>(a, s) : launch_wgmma_as<128>(a, s);
    case kMma:
      return a.cta_m == 128 ? launch_mma<128>(a, s) : launch_mma<64>(a, s);
    default:
      matmul_grad_fma_kernel<<<dim3(a.ctas, a.groups), 256, 0, s>>>(a);
      return (int)cudaGetLastError();
  }
}

}  // namespace grad
}  // namespace repro

// C entry points bound with ctypes.  out(M,N) = op(A) · op(B) (+ bias, f32
// (N,), or null), out contiguous.  a_t, b_t, a_ld, b_ld: the operand modes
// and row strides in elements (see the top of this file).  body: 0 wgmma,
// 1 mma, 2 fma; cta_m x cta_n: the body's CTA tile; ctas: gridDim.x.
// out_f32: out is f32 (bf16 operands' sums unrounded; an f32 launch's out
// is f32 anyway).  Returns a cudaError_t.
extern "C" int repro_matmul_grad(const void* a, int a_t, long long a_ld, const void* b, int b_t,
                                 long long b_ld, const void* bias, void* out, int m, int n, int k,
                                 int dtype, int body, int tile_m, int tile_n, int m_outer,
                                 int cta_m, int cta_n, int ctas, int out_f32, void* stream) {
  repro::grad::GradArgs g{};
  g.a = a; g.b = b; g.bias = static_cast<const float*>(bias); g.out = out;
  g.a_t = a_t; g.b_t = b_t; g.a_ld = a_ld; g.b_ld = b_ld;
  g.m = m; g.n = n; g.k = k; g.groups = 1;
  g.tile_m = tile_m; g.tile_n = tile_n; g.m_outer = m_outer;
  g.cta_m = cta_m; g.cta_n = cta_n; g.ctas = ctas; g.out_f32 = out_f32;
  return repro::grad::run_grad(g, dtype, body, stream);
}

// The same per expert: A's, B's expert strides a_batch, b_batch (elements),
// out contiguous (E, M, N); m, tile_m, tile_n per expert; no bias.
extern "C" int repro_grouped_matmul_grad(const void* a, int a_t, long long a_ld, long long a_batch,
                                         const void* b, int b_t, long long b_ld, long long b_batch,
                                         void* out, int groups, int m, int n, int k, int dtype,
                                         int body, int tile_m, int tile_n, int m_outer, int cta_m,
                                         int cta_n, int ctas, int out_f32, void* stream) {
  repro::grad::GradArgs g{};
  g.a = a; g.b = b; g.out = out;
  g.a_t = a_t; g.b_t = b_t; g.a_ld = a_ld; g.b_ld = b_ld; g.a_batch = a_batch; g.b_batch = b_batch;
  g.m = m; g.n = n; g.k = k; g.groups = groups;
  g.tile_m = tile_m; g.tile_n = tile_n; g.m_outer = m_outer;
  g.cta_m = cta_m; g.cta_n = cta_n; g.ctas = ctas; g.out_f32 = out_f32;
  return repro::grad::run_grad(g, dtype, body, stream);
}
