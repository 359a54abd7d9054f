// K6 (csrc/zoo_f32.cu): the instantiations of the 64-point tile at sd = 2, in a
// source of their own so that nvcc builds them beside the others.

#include "zoo_f32.cuh"

namespace fiat::k6 {

FIAT_K6_INSTANTIATE(2, 64)

}  // namespace fiat::k6
