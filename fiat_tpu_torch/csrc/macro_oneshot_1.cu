// K3 (csrc/macro_oneshot.cu) on the interval: the split interval elements'
// tables in f64 and f32 and one row per program in both, degree 0..15, in a
// source of their own so that nvcc builds them beside the others.

#include "macro_oneshot.cuh"

namespace fiat::k3 {

FIAT_K3_INSTANTIATE(1, RC_TABLES, double)
FIAT_K3_INSTANTIATE(1, RC_TABLES, float)
FIAT_K3_INSTANTIATE(1, RC_ONE, double)
FIAT_K3_INSTANTIATE(1, RC_ONE, float)

}  // namespace fiat::k3
