// The per-point Dubiner value recurrence on the interval (the orthonormal
// Legendre basis), shared by K1 (recurrence.cu, which writes Phi to device
// memory), K45 (moments1.cu, which adds every value into its row sums as it
// comes), and K3 (macro_oneshot_1.cu) and K6 (zoo_f32_1.cu), which write a
// Phi tile to shared memory.
//
// dubiner1_point<N, T>(x0, consts, scale, emit) runs the one-stage Kirby
// recurrence in T (double or float) at one point x0 of the default (-1, 1)
// interval and calls emit(i, value) once for every level i = 0..N; level
// i is member i (ops/recurrence.py:pack_stages(N, sd=1) gives the identity
// as `slots`).  The collapsed coordinate is formed as the plain version
// forms it (fa = x0 + fb + 1 with fb = 0.5 (-1 + -1)), so that both round
// alike.  The live state is two levels.
//
// Constant layout (ops/recurrence.py:pack_stages(N, variant, sd=1)), in T (a
// pointer or a ConstTable, dubiner2.cuh):
//   consts[4*i + {0,1,2,3}], i = 0..N          level i: a, b, c, norm
// N == 0 calls emit(0, scale) and reads no constants.
//
// dubiner1_point_n(n, ...) is the same recurrence at a degree n given at
// run time (the kernels' generic instantiations past their unrolled
// degrees), its constants through the read-only cache.

#pragma once

#include <cuda_runtime.h>

#include "dubiner2.cuh"

namespace fiat {

template <int N, class T, class Consts, class Emit>
__device__ __forceinline__ void dubiner1_point(T x0, const Consts& consts, T scale,
                                               Emit&& emit) {
  if constexpr (N == 0) {
    emit(0, scale);
  } else {
    const T half = T(0.5), one = T(1.0);
    const T fb = half * (-one + -one);
    const T fa = x0 + fb + one;
    const T fc = fb * fb;
    T prev2 = T(0), prev = scale;
    emit(0, prev * const_at(consts, 3));
#pragma unroll
    for (int i = 1; i <= N; ++i) {
      const int c = 4 * i;
      const T v = (const_at(consts, c) * fa - const_at(consts, c + 1) * fb) * prev -
                  (const_at(consts, c + 2) * fc) * prev2;
      emit(i, v * const_at(consts, c + 3));
      prev2 = prev;
      prev = v;
    }
  }
}

template <class T, class Emit>
__device__ __forceinline__ void dubiner1_point_n(int n, T x0, const T* __restrict__ consts,
                                                 T scale, Emit&& emit) {
  if (n == 0) {
    emit(0, scale);
    return;
  }
  const T half = T(0.5), one = T(1.0);
  const T fb = half * (-one + -one);
  const T fa = x0 + fb + one;
  const T fc = fb * fb;
  T prev2 = T(0), prev = scale;
  emit(0, prev * const_at(consts, 3));
#pragma unroll 1
  for (int i = 1; i <= n; ++i) {
    const int c = 4 * i;
    const T v = (const_at(consts, c) * fa - const_at(consts, c + 1) * fb) * prev -
                (const_at(consts, c + 2) * fc) * prev2;
    emit(i, v * const_at(consts, c + 3));
    prev2 = prev;
    prev = v;
  }
}

}  // namespace fiat
