// K6 (csrc/zoo_f32.cu): the instantiations of the 64-point tile at sd = 3, in a
// source of their own so that nvcc builds them beside the others.

#include "zoo_f32.cuh"

namespace fiat::k6 {

FIAT_K6_INSTANTIATE(3, 64)

}  // namespace fiat::k6
