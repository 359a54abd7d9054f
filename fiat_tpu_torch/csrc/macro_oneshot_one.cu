// K3 (csrc/macro_oneshot.cu): the instantiations for one row per program (RC = 1, interpolation), in f64 and f32,
// in a source of their own so that nvcc builds them beside the others.

#include "macro_oneshot.cuh"

namespace fiat::k3 {

FIAT_K3_INSTANTIATE(2, RC_ONE, double)
FIAT_K3_INSTANTIATE(3, RC_ONE, double)
FIAT_K3_INSTANTIATE(2, RC_ONE, float)
FIAT_K3_INSTANTIATE(3, RC_ONE, float)

}  // namespace fiat::k3
