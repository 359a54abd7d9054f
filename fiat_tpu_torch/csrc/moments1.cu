// K45 (csrc/moments.cu): the interval's instantiations, degree 0..15 and the
// generic one past it, in a source of their own so that nvcc builds them
// beside the others.  The recurrence is dubiner1.cuh's three-term loop, its
// members the levels
// (pack_stages(N, sd=1)'s slots are the identity).

#include "moments.cuh"

namespace fiat::k45 {

template int launch_by_degree<1>(const Params&, const double*, int, int, int, cudaStream_t);
template int occupancy_by_degree<1>(int, int, int, int, int, int);

}  // namespace fiat::k45
