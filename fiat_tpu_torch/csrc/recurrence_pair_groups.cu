// K1 on the triangle and the tetrahedron, two points a thread, several row groups
// (recurrence.cuh; the design note and the C entry points are in
// recurrence.cu): its own source, so that nvcc builds it beside the others.

#include "recurrence.cuh"

namespace fiat {
namespace k1 {
FIAT_K1_INSTANCES(, Pair, GroupRows)
}  // namespace k1
}  // namespace fiat
