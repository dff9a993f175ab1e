// Schedule-driven matmul with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/matmul.py (build_call /
// _kernel), reached through matmul() (K1): out = epilogue(x(M,K) @ w(K,N))
// with an f32 accumulator and the epilogue applied once the whole K range is
// summed; and through grouped_matmul() (K1g, the MoE expert GEMM):
// out[e] = epilogue(x[e] @ w[e]) for x(E,M,K), w(E,K,N).
//
// K1g is K1's body under a second grid axis, as in the reference (a leading
// expert grid axis over the same kernel body): blockIdx.y = e offsets x, w
// and out by one expert's extent (in size_t: dbrx's w_in stack has 2.1e9
// elements), and the tiles of one expert are masked at that expert's own M
// and N edges, so a ragged tile never reads or writes the next expert's rows.
// What bounds K1g is what bounds K1 at the per-expert M: the E weight stacks'
// bytes at decode (mixtral: 3.2 GB for the up-GEMM at 4 rows per expert) and
// up to ~300 rows per expert, the operations above.
//
// One CTA owns one logical (tile_m x tile_n) output tile of the schedule and
// walks it in sub-blocks that fit its registers and shared memory.  Tiles are
// numbered in the schedule's order (m_outer: M is the outer loop, so
// consecutive CTAs walk along N).  Two bodies, chosen by the tile height:
//
//  * rows (tile_m <= 16, decode and the prefill lm head): w's bytes bound
//    it.  Each lane streams 16-byte vectors of w along one column strip, the
//    8 warps split K between them, and the partial sums meet in shared memory
//    before the epilogue.  Rows go in passes of 4; x is read through L1, where
//    a warp's lanes share each element.
//  * tiled (tile_m > 16, prefill): w's bytes bound it up to M ~ 300, the
//    operations above.  Classic 64x64x16 shared-memory tiles, 256 threads
//    each holding a 4x4 f32 micro-tile.
//
// Both mask the ragged edges of M, N and K themselves.  No tensor cores, TMA
// or pipelining yet: CUDA-core FMA on f32 copies of the inputs.
#include "common.cuh"

namespace repro {

enum Epilogue : int {
  kNone = 0, kGelu = 1, kSiluGlu = 2, kGeluGlu = 3, kResidual = 4, kSoftcap = 5
};

struct MatmulArgs {
  const void* x; const void* w; const float* bias; const float* residual; void* out;
  int m, n, k, n_out;           // per expert when grouped
  int epi; float softcap;
  int tile_m, tile_n, tiles_m, tiles_n, m_outer;
  int groups;                   // experts (gridDim.y); 1 for a plain matmul
};

// This CTA's expert's slices of x, w and out (blockIdx.y = expert).
template <typename T>
struct ExpertPtrs {
  const T* x; const T* w; T* out;
  __device__ __forceinline__ explicit ExpertPtrs(const MatmulArgs& a) {
    const size_t e = blockIdx.y;
    x = static_cast<const T*>(a.x) + e * a.m * a.k;
    w = static_cast<const T*>(a.w) + e * a.k * a.n;
    out = static_cast<T*>(a.out) + e * a.m * a.n_out;
  }
};

__device__ __forceinline__ void tile_origin(const MatmulArgs& a, int* m0, int* n0) {
  int t = blockIdx.x, tm, tn;
  if (a.m_outer) { tm = t / a.tiles_n; tn = t % a.tiles_n; }
  else           { tn = t / a.tiles_m; tm = t % a.tiles_m; }
  *m0 = tm * a.tile_m;
  *n0 = tn * a.tile_n;
}

// Epilogue for one output element whose f32 sum is y at column n (non-GLU).
__device__ __forceinline__ float epilogue1(const MatmulArgs& a, float y, int row, int n) {
  if (a.bias) y += a.bias[n];
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
  if (a.bias) { g += a.bias[n]; u += a.bias[n + 1]; }
  return (a.epi == kSiluGlu ? silu(g) : gelu_tanh(g)) * u;
}

__host__ __device__ __forceinline__ bool is_glu(int epi) { return epi == kSiluGlu || epi == kGeluGlu; }

// ---------------------------------------------------------------------------
// rows body: small tile_m, streams w
// ---------------------------------------------------------------------------

constexpr int kRowsWarps = 8;
constexpr int kRowsRM = 4;   // rows per pass

template <typename T>
__device__ __forceinline__ void load_w_vec(const T* wrow, int col, int n1, bool vec_ok,
                                           float (&wv)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec_ok && col + VEC <= n1) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(wrow + col));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) wv[v] = to_f(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) wv[v] = (col + v < n1) ? to_f(wrow[col + v]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowsWarps * 32) matmul_rows_kernel(MatmulArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CW = 32 * VEC;  // columns per pass
  __shared__ float red[kRowsWarps][kRowsRM][CW];

  const ExpertPtrs<T> p(a);
  const T* x = p.x;
  const T* w = p.w;
  T* out = p.out;
  int m0, n0;
  tile_origin(a, &m0, &n0);
  const int m1 = min(m0 + a.tile_m, a.m), n1 = min(n0 + a.tile_n, a.n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // 16-byte vectors stay aligned only if every row of w and every tile's
  // first column start on 16 bytes (a default N tile may be 500, say)
  const bool vec_ok = (a.n % VEC) == 0 && (a.tile_n % VEC) == 0 &&
                      (reinterpret_cast<uintptr_t>(w) % 16) == 0;
  const bool glu = is_glu(a.epi);

  for (int r0 = m0; r0 < m1; r0 += kRowsRM) {
    const int rows = min(kRowsRM, m1 - r0);
    for (int c0 = n0; c0 < n1; c0 += CW) {
      const int col = c0 + lane * VEC;
      float acc[kRowsRM][VEC];
#pragma unroll
      for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

      if (col < n1) {
#pragma unroll 4
        for (int kk = warp; kk < a.k; kk += kRowsWarps) {
          float wv[VEC];
          load_w_vec<T>(w + (size_t)kk * a.n, col, n1, vec_ok, wv);
#pragma unroll
          for (int r = 0; r < kRowsRM; ++r) {
            if (r < rows) {
              const float xv = to_f(x[(size_t)(r0 + r) * a.k + kk]);
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsRM; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) red[warp][r][lane * VEC + v] = acc[r][v];
      __syncthreads();

      const int width = min(CW, n1 - c0);           // accumulator columns in this pass
      const int ow = glu ? width / 2 : width;       // output columns in this pass
      for (int idx = threadIdx.x; idx < rows * ow; idx += blockDim.x) {
        const int r = idx / ow, j = idx % ow;
        const int row = r0 + r;
        float y;
        int ocol;
        if (glu) {
          float g = 0.f, u = 0.f;
#pragma unroll
          for (int wi = 0; wi < kRowsWarps; ++wi) { g += red[wi][r][2 * j]; u += red[wi][r][2 * j + 1]; }
          y = epilogue_glu(a, g, u, c0 + 2 * j);
          ocol = (c0 + 2 * j) / 2;
        } else {
          float s = 0.f;
#pragma unroll
          for (int wi = 0; wi < kRowsWarps; ++wi) s += red[wi][r][j];
          ocol = c0 + j;
          y = epilogue1(a, s, row, ocol);
        }
        out[(size_t)row * a.n_out + ocol] = from_f<T>(y);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// tiled body: 64x64x16 shared-memory tiles, 4x4 per thread
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16;

template <typename T>
__global__ void __launch_bounds__(256) matmul_tiled_kernel(MatmulArgs a) {
  __shared__ float As[kBK][kBM + 4];  // x tile, transposed: As[k][m]
  __shared__ float Bs[kBK][kBN + 4];  // w tile: Bs[k][n]

  const ExpertPtrs<T> p(a);
  const T* x = p.x;
  const T* w = p.w;
  T* out = p.out;
  int m0, n0;
  tile_origin(a, &m0, &n0);
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
            if (n < n1)
              out[(size_t)row * a.n_out + n / 2] = from_f<T>(epilogue_glu(a, acc[i][j], acc[i][j + 1], n));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = sn0 + tx * 4 + j;
            if (n < n1) out[(size_t)row * a.n_out + n] = from_f<T>(epilogue1(a, acc[i][j], row, n));
          }
        }
      }
    }
  }
}

template <typename T>
void launch(const MatmulArgs& a, cudaStream_t stream) {
  const dim3 grid(a.tiles_m * a.tiles_n, a.groups);
  if (a.tile_m <= 16) {
    matmul_rows_kernel<T><<<grid, kRowsWarps * 32, 0, stream>>>(a);
  } else {
    matmul_tiled_kernel<T><<<grid, 256, 0, stream>>>(a);
  }
}

// Checks the shared arguments, fills the tiling and launches; returns a
// cudaError_t (cudaErrorInvalidValue for bad arguments).
int run(MatmulArgs& a, int dtype, void* stream) {
  if (a.m <= 0 || a.n <= 0 || a.k <= 0 || a.tile_m <= 0 || a.tile_n <= 0) return (int)cudaErrorInvalidValue;
  if (a.groups <= 0 || a.groups > 65535) return (int)cudaErrorInvalidValue;
  if (a.epi < kNone || a.epi > kSoftcap) return (int)cudaErrorInvalidValue;
  const bool glu = is_glu(a.epi);
  if (glu && ((a.n % 2) || (a.tile_n % 2))) return (int)cudaErrorInvalidValue;
  if (a.epi == kResidual && a.residual == nullptr) return (int)cudaErrorInvalidValue;
  a.n_out = glu ? a.n / 2 : a.n;
  a.tiles_m = cdiv(a.m, a.tile_m); a.tiles_n = cdiv(a.n, a.tile_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) launch<__nv_bfloat16>(a, s);
  else if (dtype == kFloat32) launch<float>(a, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace repro

// C entry point bound with ctypes.  bias (N,) and residual (M, N_out) are f32
// (the wrapper converts them: the reference reads both into f32).  Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for bad arguments.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias, const void* residual,
                            void* out, int m, int n, int k, int dtype, int epi, float softcap,
                            int tile_m, int tile_n, int m_outer, void* stream) {
  repro::MatmulArgs a{};
  a.x = x; a.w = w; a.bias = static_cast<const float*>(bias);
  a.residual = static_cast<const float*>(residual); a.out = out;
  a.m = m; a.n = n; a.k = k;
  a.epi = epi; a.softcap = softcap;
  a.tile_m = tile_m; a.tile_n = tile_n; a.m_outer = m_outer; a.groups = 1;
  return repro::run(a, dtype, stream);
}

// Grouped (MoE expert) matmul: out[e] = epilogue(x[e] (M,K) @ w[e] (K,N)) for
// e < groups, contiguous (E,M,K), (E,K,N) and (E,M,N_out).  m, tile_m and
// tile_n are per expert.  No bias or residual (the grouped classes have none).
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* out, int groups,
                                    int m, int n, int k, int dtype, int epi,
                                    int tile_m, int tile_n, int m_outer, void* stream) {
  repro::MatmulArgs a{};
  a.x = x; a.w = w; a.out = out;
  a.m = m; a.n = n; a.k = k;
  a.epi = epi;
  a.tile_m = tile_m; a.tile_n = tile_n; a.m_outer = m_outer; a.groups = groups;
  return repro::run(a, dtype, stream);
}
