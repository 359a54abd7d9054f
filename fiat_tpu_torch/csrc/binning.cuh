// Subcell binning of one point for the macro (split-complex) programs of a
// zoo, shared by K3 (macro_oneshot.cu) and K45 (moments.cu).
//
// fiat_tpu's rule (fiat_tpu/ops/pallas_recurrence.py:SubcellBinning and
// core/expansions.py:partition_of_unity_masks): with lambda_c(x) the rescaled
// barycentric coordinates of subcell c, dist_c = 0.5 * sum_j (|lambda_cj| -
// lambda_cj) is the L1 distance to it, and the subcell takes the point when
// dist_c <= dist_parent + tol (1e-12 in float64, 1e-5 in float32).  A
// program whose basis is C0 at order 0 keeps the first hit in subcell order;
// every other program averages over its hits, recip = 1 / (number of hits).
//
// Every operation is rounded on its own (no FMA contraction), in the order
// fiat_tpu_torch/core/expansions.py:subcell_masks computes the float32
// distances elementwise, so the float instantiation bins every point as
// the plain version does (a point that changed subcell would move a table
// entry by O(tol)).
//
// Tables (built by fiat_tpu_torch/ops/macro_oneshot.py:pack_geometry):
//   maps[9*m + 3*j + {0,1,2}]   map m (0 = parent, 1 + c = piece c), row j:
//                               lambda_j = a0 * x + a1 * y + b
//   progs[5*g + {0..4}]         program g: first row, end row, first piece,
//                               end piece, unique (0/1)
//   pieces[2*c + {0,1}]         piece c: first column, nexp

#pragma once

#include <cuda_runtime.h>

namespace fiat {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }

template <class T>
__device__ __forceinline__ T l1_distance(const T* __restrict__ map, T x, T y) {
  T s = T(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T b = add_rn(add_rn(mul_rn(x, __ldg(map + 3 * j)), mul_rn(y, __ldg(map + 3 * j + 1))),
                       __ldg(map + 3 * j + 2));
    const T t = add_rn(abs_of(b), -b);
    s = j == 0 ? t : add_rn(s, t);
  }
  return T(0.5) * s;
}

// Bit c of the result is the mask of piece c (all programs, piece order).
template <class T>
__device__ __forceinline__ unsigned subcell_bits(const T* __restrict__ maps, int npieces, T x,
                                                 T y, T tol) {
  const T best = add_rn(l1_distance(maps, x, y), tol);
  unsigned near = 0u;
  for (int c = 0; c < npieces; ++c) {
    if (l1_distance(maps + 9 * (c + 1), x, y) <= best) near |= 1u << c;
  }
  return near;
}

// Program g's masks (bit c - c0 for piece c) and the factor each masked
// value takes: the first hit alone for a unique program, else every hit
// times 1 / (number of hits).
template <class T>
__device__ __forceinline__ unsigned program_mask(unsigned near, const int* __restrict__ progs,
                                                 int g, T& recip) {
  const int c0 = __ldg(progs + 5 * g + 2), c1 = __ldg(progs + 5 * g + 3);
  const int nc = c1 - c0;
  unsigned mk = (near >> c0) & (nc >= 32 ? ~0u : (1u << nc) - 1u);
  if (__ldg(progs + 5 * g + 4)) {
    recip = T(1);
    mk &= 0u - mk;  // the first hit in subcell order
  } else {
    recip = T(1) / static_cast<T>(__popc(mk));
  }
  return mk;
}

}  // namespace fiat
