// The matmul's mma body (csrc/matmul.cuh) reading w as shifted aligned
// vectors (kShiftW: rows of w, a group's first column or an expert's w off
// 16 bytes, as internvl2-26b's LM head of 92553 columns), every compiled CTA
// tile, plain and in rounding mode.  A source of its own so that nvcc
// compiles these instantiations beside csrc/matmul.cu's, not after them;
// csrc/matmul.cu run() checks the arguments and calls it.
#include "matmul.cuh"

namespace repro {

int launch_mma_shifted(const MatmulArgs& a, cudaStream_t stream) {
  const bool round = a.round_k > 0;
  if (a.cta_m == 128) return round ? launch_mma_as<MmaTile128x128, true, true>(a, stream)
                                   : launch_mma_as<MmaTile128x128, false, true>(a, stream);
  if (a.cta_n == 128) return round ? launch_mma_as<MmaTile64x128, true, true>(a, stream)
                                   : launch_mma_as<MmaTile64x128, false, true>(a, stream);
  return round ? launch_mma_as<MmaTile64x64, true, true>(a, stream)
               : launch_mma_as<MmaTile64x64, false, true>(a, stream);
}

}  // namespace repro
