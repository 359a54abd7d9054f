// K6 (csrc/zoo_f32.cu) on the interval, both point tiles, degree 0..15, in a
// source of its own so that nvcc builds it beside the others.  The Phi tile
// takes dubiner1.cuh's recurrence in float, run by the first thread of each
// point (16 members at most: the product, not the recurrence, is the work).

#include "zoo_f32.cuh"

namespace fiat::k6 {

FIAT_K6_INSTANTIATE(1, 128)
FIAT_K6_INSTANTIATE(1, 64)

}  // namespace fiat::k6
