// The per-point Dubiner value recurrence on the tetrahedron, shared by K1
// (recurrence.cu, which writes Phi to device memory), K45 (moments.cu, which
// adds every value into its row sums as it comes), and K3
// (macro_oneshot.cuh) and K6 (zoo_f32.cu), which write a Phi tile to shared
// memory.
//
// dubiner3_point<N, T>(x0, x1, x2, consts, scale, emit) runs the three-stage
// Kirby recurrence in T (double or float) at one point (x0, x1, x2) of the
// default (-1, 1) tetrahedron and calls emit(e, value) once for every
// stage-2 entry e:
// stage-1 row (p, q), p = 0..N, q = 0..N-p, then level r = 0..N-p-q,
// row-major in (p, q, r).  The entry's member is the morton row of
// (p, q, r) (ops/recurrence.py:pack_stages(N, sd=3) builds it as `slots`).
//
// At degree 8 a point has 165 values, more than a thread's 255 registers
// hold, so nothing of Phi is kept: the stage-0 output (N+1 values) stays in
// a register array, each stage-1 row runs its three-term recurrence over q
// holding two levels, and every stage-1 value starts a stage-2 chain over r
// (two levels again) whose values go straight to the emitter.  The live
// state is the N+1 stage-0 values plus four more.  With N a template
// parameter and the loops unrolled, the entry counters are compile-time
// constants, so the constant loads carry immediate offsets.
//
// Constant layout (ops/recurrence.py:pack_stages(N, variant, sd=3)), in T (a
// pointer or a ConstTable, dubiner2.cuh):
//   consts[4*i + {0,1,2,3}], i = 0..N              stage 0: a, b, c, norm
//   consts[4*(N+1) + 4*e1 + {0,1,2,3}]            stage 1 entry e1 (p, q)
//   consts[4*(N+1) + 4*nexp2 + 4*e + {0,1,2,3}]   stage 2 entry e (p, q, r)
// with nexp2 = (N+1)(N+2)/2.  N == 0 calls emit(0, scale) and reads no
// constants.  An optional last argument keep(p) (default: every row)
// skips the stage-1 rows p it refuses, as dubiner2_point's.
//
// dubiner3_point_n(n, ...) is the same recurrence, in the same entry order,
// at a degree n given at run time (the generic instantiations), streaming
// stage 0 as dubiner2_point_n does: one level for each stage-1 row p, and
// stage 1 one level for each stage-2 row (p, q), so the live state is two
// values a stage whatever the degree.  Constants through the read-only
// cache.

#pragma once

#include <cuda_runtime.h>

#include "dubiner2.cuh"

namespace fiat {

// one level of a three-term recurrence: (a fa - b fb) prev - (c fc) prev2,
// with (a, b, c) at consts[o..o+2] (c = 0 at level 1)
template <class T, class Consts>
__device__ __forceinline__ T dubiner_step(const Consts& consts, int o, T fa, T fb, T fc, T prev,
                                          T prev2) {
  return (const_at(consts, o) * fa - const_at(consts, o + 1) * fb) * prev -
         (const_at(consts, o + 2) * fc) * prev2;
}

template <int N, class T, class Consts, class Emit, class Keep = AllRows>
__device__ __forceinline__ void dubiner3_point(T x0, T x1, T x2, const Consts& consts, T scale,
                                               Emit&& emit, Keep keep = {}) {
  if constexpr (N == 0) {
    emit(0, scale);
  } else {
    constexpr int kNexp2 = (N + 1) * (N + 2) / 2;
    const T half = T(0.5), one = T(1.0);
    // stage 0: the 1D recurrence in the first collapsed coordinate
    T r0[N + 1];
    {
      const T fb = half * (x1 + x2);
      const T fa = x0 + fb + one;
      const T fc = fb * fb;
      T prev2 = T(0), prev = scale;
      r0[0] = prev * const_at(consts, 3);
#pragma unroll
      for (int i = 1; i <= N; ++i) {
        const T v = dubiner_step(consts, 4 * i, fa, fb, fc, prev, prev2);
        r0[i] = v * const_at(consts, 4 * i + 3);
        prev2 = prev;
        prev = v;
      }
    }

    const T fb1 = half * (x2 + -one);
    const T fa1 = x1 + fb1 + one;
    const T fc1 = fb1 * fb1;
    const T fb2 = half * (-one + -one);
    const T fa2 = x2 + fb2 + one;
    const T fc2 = fb2 * fb2;
    constexpr int c1 = 4 * (N + 1);
    constexpr int c2 = c1 + 4 * kNexp2;
    int e1 = 0, e = 0;
#pragma unroll
    for (int p = 0; p <= N; ++p) {
      if (!keep(p)) {
        e1 += N - p + 1;
        e += (N - p + 1) * (N - p + 2) / 2;
        continue;
      }
      // stage 1, row p: levels q = 0..N-p in the second coordinate
      T prev2 = T(0), prev = r0[p];
#pragma unroll
      for (int q = 0; q <= N - p; ++q, ++e1) {
        const int c = c1 + 4 * e1;
        T v = prev;
        if (q > 0) {
          v = dubiner_step(consts, c, fa1, fb1, fc1, prev, prev2);
          prev2 = prev;
          prev = v;
        }
        // stage 2, row (p, q): levels r = 0..N-p-q in the third
        // coordinate, each value straight to the emitter
        T s2 = T(0), s = v * const_at(consts, c + 3);
        emit(e, s * const_at(consts, c2 + 4 * e + 3));
        ++e;
#pragma unroll
        for (int r = 1; r <= N - p - q; ++r, ++e) {
          const int cc = c2 + 4 * e;
          const T w = dubiner_step(consts, cc, fa2, fb2, fc2, s, s2);
          emit(e, w * const_at(consts, cc + 3));
          s2 = s;
          s = w;
        }
      }
    }
  }
}

template <class T, class Emit, class Keep = AllRows>
__device__ __forceinline__ void dubiner3_point_n(int n, T x0, T x1, T x2,
                                                 const T* __restrict__ consts, T scale,
                                                 Emit&& emit, Keep keep = {}) {
  if (n == 0) {
    emit(0, scale);
    return;
  }
  const int nexp2 = (n + 1) * (n + 2) / 2;
  const T half = T(0.5), one = T(1.0);
  const T fb0 = half * (x1 + x2);
  const T fa0 = x0 + fb0 + one;
  const T fc0 = fb0 * fb0;
  const T fb1 = half * (x2 + -one);
  const T fa1 = x1 + fb1 + one;
  const T fc1 = fb1 * fb1;
  const T fb2 = half * (-one + -one);
  const T fa2 = x2 + fb2 + one;
  const T fc2 = fb2 * fb2;
  const int c1 = 4 * (n + 1);
  const int c2 = c1 + 4 * nexp2;
  T s_prev2 = T(0), s_prev = scale;  // stage 0's last two levels
  int e1 = 0, e = 0;
#pragma unroll 1
  for (int p = 0; p <= n; ++p) {
    // stage 0, level p
    T r0;
    if (p == 0) {
      r0 = s_prev * const_at(consts, 3);
    } else {
      const T v = dubiner_step(consts, 4 * p, fa0, fb0, fc0, s_prev, s_prev2);
      r0 = v * const_at(consts, 4 * p + 3);
      s_prev2 = s_prev;
      s_prev = v;
    }
    if (!keep(p)) {
      e1 += n - p + 1;
      e += (n - p + 1) * (n - p + 2) / 2;
      continue;
    }
    // stage 1, row p: levels q = 0..n-p, one a stage-2 row
    T prev2 = T(0), prev = r0;
#pragma unroll 1
    for (int q = 0; q <= n - p; ++q, ++e1) {
      const int c = c1 + 4 * e1;
      T v = prev;
      if (q > 0) {
        v = dubiner_step(consts, c, fa1, fb1, fc1, prev, prev2);
        prev2 = prev;
        prev = v;
      }
      // stage 2, row (p, q): levels r = 0..n-p-q, straight to the emitter
      T s2 = T(0), s = v * const_at(consts, c + 3);
      emit(e, s * const_at(consts, c2 + 4 * e + 3));
      ++e;
#pragma unroll 1
      for (int r = 1; r <= n - p - q; ++r, ++e) {
        const int cc = c2 + 4 * e;
        const T w = dubiner_step(consts, cc, fa2, fb2, fc2, s, s2);
        emit(e, w * const_at(consts, cc + 3));
        s2 = s;
        s = w;
      }
    }
  }
}

}  // namespace fiat
