// K45 (csrc/moments.cu): the tetrahedron's instantiations, degree 0..10 and
// the generic one past it, in a source of their own so that nvcc builds them
// beside the triangle's.

#include "moments.cuh"

namespace fiat::k45 {

template int launch_by_degree<3>(const Params&, const double*, int, int, int, cudaStream_t);
template int occupancy_by_degree<3>(int, int, int, int, int, int);

}  // namespace fiat::k45
