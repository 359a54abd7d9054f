// K3 (csrc/macro_oneshot.cu): the instantiations for the f32 engine's tables (RC = 32 in float),
// in a source of their own so that nvcc builds them beside the others.

#include "macro_oneshot.cuh"

namespace fiat::k3 {

FIAT_K3_INSTANTIATE(2, RC_TABLES, float)
FIAT_K3_INSTANTIATE(3, RC_TABLES, float)

}  // namespace fiat::k3
