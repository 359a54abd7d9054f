// The per-point Dubiner value recurrence on the triangle, shared by K1
// (recurrence.cu, which writes Phi to device memory), K3
// (macro_oneshot.cuh) and K6 (zoo_f32.cu), which write a Phi tile to shared
// memory, and K45 (moments.cu, which reduces Phi against the weights).
//
// dubiner2_point<N, T>(x0, x1, consts, scale, emit) runs the two-stage
// Kirby recurrence in T (double or float) at one point (x0, x1) of the
// default (-1, 1) triangle and calls emit(e, r, i, value) once for every
// stage-1 entry e: input row r = 0..N, level i = 0..N-r, row-major.  The
// entry's member is the morton row (r + i)(r + i + 1)/2 + i
// (ops/recurrence.py:pack_stages builds the same table as `slots`).  With N
// a template parameter and the loops unrolled, r and i are compile-time
// constants at every call of emit, so an emitter that indexes a register
// array by them keeps it in registers.
//
// The expansion variants (None, "bubble", "dual") share this structure and
// differ only in their constants; the "bubble" C0 recovery is not part of
// the recurrence (the f32 engine folds it into its change of basis).
//
// Constant layout (ops/recurrence.py:pack_stages), in T (a pointer or a
// ConstTable, below):
//   consts[4*i + {0,1,2,3}], i = 0..N          stage 0: a, b, c, norm
//   consts[4*(N+1) + 4*e + {0,1,2,3}]          stage 1 entry e: a, b, c, norm
// N == 0 calls emit(0, 0, 0, scale) and reads no constants.
//
// An optional last argument keep(r) (default: every row) skips the stage-1
// rows r it refuses, so that two threads can share one point's recurrence
// (K6 gives each half of its rows to one thread); the entries keep their
// numbers.
//
// dubiner2_point_n(n, ...) is the same recurrence, in the same entry order,
// at a degree n given at run time (the kernels' generic instantiations past
// their unrolled degrees).  It streams: stage 0 advances one level for
// each stage-1 row, so row r starts from stage 0's level r as it is made,
// and a thread holds two previous values a stage whatever the degree (no
// array of stage-0 values).  Its constants come through the read-only
// cache (a device pointer).

#pragma once

#include <cuda_runtime.h>

namespace fiat {

// The degree template argument of the kernels' generic instantiations, which
// take the degree at run time (dubiner*_point_n).
constexpr int GENERIC = -1;

template <int N>
struct Nexp {
  static constexpr int value = (N + 1) * (N + 2) / 2;
};

// A table of the recurrence's constants: a device pointer, read through the
// read-only cache, or an array held in the kernel's parameters (K45), whose
// entries at compile-time offsets are constant-bank operands and cost no
// load instruction.
template <class T, int M>
struct ConstTable {
  T v[M];
};
template <class T>
__device__ __forceinline__ T const_at(const T* __restrict__ p, int i) { return __ldg(p + i); }
template <class T, int M>
__device__ __forceinline__ T const_at(const ConstTable<T, M>& t, int i) { return t.v[i]; }

__device__ __forceinline__ double fma_of(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }

// The default row filter of dubiner2_point / dubiner3_point: every row.
struct AllRows {
  __device__ constexpr bool operator()(int) const { return true; }
};

template <int N, class T, class Consts, class Emit, class Keep = AllRows>
__device__ __forceinline__ void dubiner2_point(T x0, T x1, const Consts& consts, T scale,
                                               Emit&& emit, Keep keep = {}) {
  if constexpr (N == 0) {
    emit(0, 0, 0, scale);
  } else {
    const T half = T(0.5), one = T(1.0);
    // stage 0: the 1D recurrence in the first collapsed coordinate
    T r1[N + 1];
    {
      const T fb = half * (x1 + -one);
      const T fa = x0 + fb + one;
      const T fc = fb * fb;
      T prev2 = T(0), prev = scale;
      r1[0] = prev * const_at(consts, 3);
#pragma unroll
      for (int i = 1; i <= N; ++i) {
        const int c = 4 * i;
        const T v = (const_at(consts, c) * fa - const_at(consts, c + 1) * fb) * prev -
                    (const_at(consts, c + 2) * fc) * prev2;
        r1[i] = v * const_at(consts, c + 3);
        prev2 = prev;
        prev = v;
      }
    }

    // stage 1: per input row r, the recurrence in the second coordinate;
    // every level goes to the emitter, times its norm
    const T fb = half * (-one + -one);
    const T fa = x1 + fb + one;
    const T fc = fb * fb;
    constexpr int c1 = 4 * (N + 1);
    int e = 0;
#pragma unroll
    for (int r = 0; r <= N; ++r) {
      if (!keep(r)) {
        e += N - r + 1;
        continue;
      }
      T prev2 = T(0), prev = r1[r];
      emit(e, r, 0, prev * const_at(consts, c1 + 4 * e + 3));
      ++e;
#pragma unroll
      for (int i = 1; i <= N - r; ++i, ++e) {
        const int c = c1 + 4 * e;
        const T v = (const_at(consts, c) * fa - const_at(consts, c + 1) * fb) * prev -
                    (const_at(consts, c + 2) * fc) * prev2;
        emit(e, r, i, v * const_at(consts, c + 3));
        prev2 = prev;
        prev = v;
      }
    }
  }
}

template <class T, class Emit, class Keep = AllRows>
__device__ __forceinline__ void dubiner2_point_n(int n, T x0, T x1, const T* __restrict__ consts,
                                                 T scale, Emit&& emit, Keep keep = {}) {
  if (n == 0) {
    emit(0, 0, 0, scale);
    return;
  }
  const T half = T(0.5), one = T(1.0);
  // stage 0: the 1D recurrence in the first collapsed coordinate, one level
  // a row
  const T fb0 = half * (x1 + -one);
  const T fa0 = x0 + fb0 + one;
  const T fc0 = fb0 * fb0;
  T s_prev2 = T(0), s_prev = scale;
  // stage 1
  const T fb = half * (-one + -one);
  const T fa = x1 + fb + one;
  const T fc = fb * fb;
  const int c1 = 4 * (n + 1);
  int e = 0;
#pragma unroll 1
  for (int r = 0; r <= n; ++r) {
    T r1;
    if (r == 0) {
      r1 = s_prev * const_at(consts, 3);
    } else {
      const int c = 4 * r;
      const T v = (const_at(consts, c) * fa0 - const_at(consts, c + 1) * fb0) * s_prev -
                  (const_at(consts, c + 2) * fc0) * s_prev2;
      r1 = v * const_at(consts, c + 3);
      s_prev2 = s_prev;
      s_prev = v;
    }
    if (!keep(r)) {
      e += n - r + 1;
      continue;
    }
    T prev2 = T(0), prev = r1;
    emit(e, r, 0, prev * const_at(consts, c1 + 4 * e + 3));
    ++e;
#pragma unroll 1
    for (int i = 1; i <= n - r; ++i, ++e) {
      const int c = c1 + 4 * e;
      const T v = (const_at(consts, c) * fa - const_at(consts, c + 1) * fb) * prev -
                  (const_at(consts, c + 2) * fc) * prev2;
      emit(e, r, i, v * const_at(consts, c + 3));
      prev2 = prev;
      prev = v;
    }
  }
}

}  // namespace fiat
