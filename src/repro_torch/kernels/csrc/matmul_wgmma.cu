// K1's and K1g's forward tensor-core body for Hopper (sm_90a): wgmma.
//
// Replaces, with the rest of csrc/matmul.cu, the Pallas kernel of
// src/repro/kernels/matmul.py (build_call / _kernel) reached through
// matmul() and grouped_matmul(): out = epilogue(x(M,K) @ w(K,N)), per expert
// for K1g (blockIdx.y = expert).  csrc/matmul.cu run() checks the arguments
// and the body the wrapper chose (kernels/matmul.py body_for: bf16, an M tile
// above 16 rows, no rounding mode, x and w 16-byte aligned in base, row
// stride and expert stride, and every CTA's first column of w on 16 bytes)
// and calls launch_wgmma; the other bf16 launches keep the mma.sync body.
//
// What bounds it: w's bytes below ~300 rows per expert, the operations
// above (the H100 does ~295 bf16 operations per byte of HBM).  Only wgmma
// reaches the tensor cores' full rate, and TMA moves the tiles without
// spending the consumers' registers or instructions on addresses:
//
//  * loads: two 3-D tensor maps (inner, outer, expert) with 128-byte swizzle
//    (csrc/wgmma.cuh make_map, 64-bit strides: dbrx's w_in stack has 2.1e9
//    elements): x (M,K) K-major, one box of BM rows by 64 K values a stage;
//    w (K,N) MN-major, 64-wide boxes along N, read with wgmma's transpose
//    bit.  Out-of-bounds boxes fill zeros, which covers the ragged edges of
//    M, N and K; w's boxes are loaded only where they start inside N.
//  * a ring of 64-deep stages in shared memory, full and empty mbarriers;
//    one producer warp (one thread issues the TMA loads) and BM / 64
//    consumer warpgroups, each running wgmma.mma_async m64nBNk16 from
//    shared-memory descriptors into a 64 x BN f32 fragment in registers.
//  * CTA tiles (kernels/matmul.py WGMMA_CTA_TILES): 128x128 on two consumer
//    warpgroups, 64x128 and 64x64 on one (the paged engine's 64-row chunks,
//    and launches 128-row tiles would leave under one wave); two CTAs an SM,
//    so one CTA's epilogue runs beside another's products, the ring taking
//    the stages that leaves room for (3 of 32 KB at 128x128).  A 128x256
//    tile (one CTA an SM) was slower than 128x128 at every main-path shape
//    on the card (PERF.md §6) and is not compiled.
//  * the epilogue (store_pair_epilogue, csrc/matmul.cuh: the mma body's):
//    bias, gelu, silu-GLU and gelu-GLU (output N / 2), residual, softcap; Z
//    beside Y; f32 Y.  Masked at min(group end, N) and min(tile end, M).
//    The f32 fragments go through shared memory (the ring, free once the
//    last product is done) and the consumers store column pairs, neighbours
//    on neighbouring pairs: coalesced, and one rolled copy of the epilogue's
//    code (unrolled over a 64 x BN fragment's registers it filled the
//    instruction cache and cost several times the products).  wgmma's
//    accumulator layout gives a thread columns 2t and 2t + 1 of each
//    8-column block, and the walk takes whole column pairs, so a GLU pair
//    (gate even, up odd) stays in one thread.
//
// Sums: each output's over K in 16-deep steps in ascending order, f32, the
// same steps whatever the CTA tile (every width runs m64nNk16 on the same
// 64-deep stages), no atomics, no K split: two runs give the same bits, and
// an output's bits do not depend on which rows or columns share its CTA.
// Z is the same f32 sum plus the bias, rounded once: a kNone launch's bits.
#include "matmul.cuh"
#include "wgmma.cuh"

namespace repro {

// A CTA tile of BM x BN outputs: BM / 64 consumer warpgroups, each holding a
// 64 x BN f32 fragment (BN / 2 registers a thread), and one producer warp.
template <int BM_, int BN_>
struct WgmmaTile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int kConsumerWarps = 4 * (BM / 64);
  static constexpr int kThreads = 32 * kConsumerWarps + 32;
  static constexpr int kABytes = BM * kWgBK * 2;    // x: one box of BM rows, 64 deep
  static constexpr int kBBytes = BN * kWgBK * 2;    // w: BN / 64 boxes, 64 wide
  static constexpr int kStageBytes = kABytes + kBBytes;
  // two CTAs an SM: the ring takes as many stages as that leaves shared
  // memory for (and, at 288 threads, 112 registers a thread)
  static constexpr int kMinBlocks = 2;
  static constexpr int kBudget = BM == 128 ? 99 * 1024 : 110 * 1024;
  static constexpr int kStages = kBudget / kStageBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  // the epilogue's f32 tile over the ring, rows padded by 8 floats so a
  // warp's fragment stores (8 rows of 32 bytes) fall in distinct banks
  static constexpr int kAccLd = BN + 8;
  static_assert(BM * kAccLd * 4 <= kStages * kStageBytes, "the f32 tile fits in the ring");
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(BN == 64 || BN == 128, "the compiled widths");
  static_assert(kStages >= 3, "a ring deep enough to keep loads in flight");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

template <class Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w, MatmulArgs a) {
  constexpr int BN = Tile::BN, kStages = Tile::kStages, kStageBytes = Tile::kStageBytes;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const ExpertPtrs<__nv_bfloat16> p(a);
  int cm0, cn0, cm1, cn1;
  if (!cta_rect(a, Tile::BM, BN, &cm0, &cn0, &cm1, &cn1)) return;

  // 1024-byte aligned stages (the swizzle pattern repeats every 1024 bytes)
  const uint32_t base = (smem_addr(wg_smem) + 1023) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes, empty = full + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.y;
  const int ktiles = cdiv(a.k, kWgBK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Tile::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == Tile::kConsumerWarps) {   // the producer: one thread keeps the ring full
    if (lane == 0) {
      // w's 64-wide boxes only where they start inside N: the columns the
      // others would hold are masked at the store
      const int w_boxes = min(BN / 64, cdiv(a.n - cn0, 64));
      const uint32_t bytes = Tile::kABytes + w_boxes * kWgBox;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
        const uint32_t sx = base + s * kStageBytes, sw = sx + Tile::kABytes, bar = full + 8 * s;
        const int k0 = kt * kWgBK;
        mbar_expect_tx(bar, bytes);
        tma_load(sx, &map_x, bar, k0, cm0, e);
        for (int h = 0; h < w_boxes; ++h) tma_load(sw + h * kWgBox, &map_w, bar, cn0 + 64 * h, k0, e);
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
    // x's rows of this warpgroup: 64 rows of 128 bytes (one MN box's bytes)
    const uint32_t sx = base + s * kStageBytes + wg * kWgBox, sw = base + s * kStageBytes + Tile::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // a 16-deep step: 32 bytes along x's K-major rows, 16 K rows (2048
      // bytes) of each of w's MN-major boxes, the boxes kWgBox apart
      const uint64_t dx = smem_desc(sx + kk * 32, 0, 1024);
      const uint64_t dw = smem_desc(sw + kk * 2048, kWgBox, 1024);
      wgmma_step<BN, 0, 1>(acc, dx, dw);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: release its slot
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();

  // The epilogue through shared memory: every consumer is past its last
  // product (so the ring is free), each warpgroup writes its f32 fragment
  // to an (BM x BN) tile, then all consumer threads walk the tile by column
  // pairs, consecutive threads on consecutive pairs: coalesced stores, and
  // one rolled copy of the epilogue's code (unrolled over every register of
  // the fragment it is too large for the instruction cache).  The values
  // are the accumulator's, so the output's bits do not change.
  // Fragment: thread (warp w of the warpgroup, lane l) holds rows 16w + l/4
  // and + 8, columns 8j + 2(l%4) and + 1, j < BN / 8.
  constexpr int kLd = Tile::kAccLd, kThreadsC = 32 * Tile::kConsumerWarps;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreadsC) : "memory");
  float* tile = reinterpret_cast<float*>(wg_smem + (base - smem_addr(wg_smem)));
  {
    float* t0 = tile + (wg * 64 + (warp % 4) * 16 + lane / 4) * kLd + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(t0 + 8 * h * kLd + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreadsC) : "memory");
  // a GLU pair (gate at an even column, up at the odd one after it) is one
  // column pair, so it stays in one thread, as in the fragment
  const bool glu = is_glu(a.epi);
  const int rows = cm1 - cm0, pairs = (cn1 - cn0 + 1) / 2;
#pragma unroll 2
  for (int i = threadIdx.x; i < rows * (BN / 2); i += kThreadsC) {
    const int r = i / (BN / 2), c = i % (BN / 2);
    if (c >= pairs) continue;
    const float2 y = *reinterpret_cast<const float2*>(tile + r * kLd + 2 * c);
    store_pair_epilogue(a, p, cm0 + r, cn0 + 2 * c, cn1, glu, y.x, y.y);
  }
}

template <class Tile>
int launch_wgmma_as(const MatmulArgs& a, cudaStream_t stream) {
  CUtensorMap mx, mw;
  // x: (M,K) rows, one BM-row box per stage; w: (K,N) rows, 64-wide boxes
  const bool ok = make_map(&mx, a.x, a.k, a.m, a.k, (long long)a.m * a.k, a.groups, Tile::BM) &&
                  make_map(&mw, a.w, a.n, a.k, a.n, (long long)a.k * a.n, a.groups, kWgBK);
  if (!ok) return (int)cudaErrorNotSupported;   // the driver refused a tensor map
  auto kernel = matmul_wgmma_kernel<Tile>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.ctas, a.groups), Tile::kThreads, Tile::kSmemBytes, stream>>>(mx, mw, a);
  return (int)cudaGetLastError();
}

int launch_wgmma(const MatmulArgs& a, cudaStream_t stream) {
  if (a.cta_m == 128) return launch_wgmma_as<WgmmaTile<128, 128>>(a, stream);
  return a.cta_n == 128 ? launch_wgmma_as<WgmmaTile<64, 128>>(a, stream)
                        : launch_wgmma_as<WgmmaTile<64, 64>>(a, stream);
}

}  // namespace repro
