// Subcell binning of one point for the macro (split-complex) programs of a
// zoo, shared by K3 (macro_oneshot.cuh), K45 (moments.cu) and K7
// (masked_matmul.cu), on triangles and tetrahedra.
//
// fiat_tpu's rule (fiat_tpu/ops/pallas_recurrence.py:SubcellBinning and
// core/expansions.py:partition_of_unity_masks): with lambda_c(x) the rescaled
// barycentric coordinates of subcell c, dist_c = 0.5 * sum_j (|lambda_cj| -
// lambda_cj) is the L1 distance to it, and the subcell takes the point when
// dist_c <= dist_parent + tol (1e-12 in float64, 1e-5 in float32).  A
// program whose basis is C0 at order 0 keeps the first hit in subcell order;
// every other program averages over its hits, recip = 1 / (number of hits
// over the whole program).  A program's masks are as many 32-bit words as
// it has pieces over 32 (``piece_bits`` gives one word, ``rule_word``
// applies the rule word by word), so a program has no cap on its subcells.
//
// Every operation is rounded on its own (no FMA contraction), in the order
// fiat_tpu_torch/core/expansions.py:subcell_masks computes the float32
// distances elementwise (x_0 a_0, + x_1 a_1, ..., + b per row; the rows'
// terms summed in row order), so the float instantiation bins every point as
// the plain version does (a point that changed subcell would move a table
// entry by O(tol)).
//
// Tables (built by fiat_tpu_torch/ops/macro_oneshot.py:pack_geometry), with
// W = SD + 1 barycentric rows of W entries per map:
//   maps[W*W*m + W*j + {0..SD}] map m (0 = parent, 1 + c = piece c), row j:
//                               lambda_j = a_0 x_0 + ... + a_{SD-1} x_{SD-1} + b
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

template <int SD, class T>
__device__ __forceinline__ T l1_distance(const T* __restrict__ map, const T* x) {
  constexpr int W = SD + 1;
  T s = T(0);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    T b = mul_rn(x[0], __ldg(map + W * j));
#pragma unroll
    for (int i = 1; i < SD; ++i) b = add_rn(b, mul_rn(x[i], __ldg(map + W * j + i)));
    b = add_rn(b, __ldg(map + W * j + SD));
    const T t = add_rn(abs_of(b), -b);
    s = j == 0 ? t : add_rn(s, t);
  }
  return T(0.5) * s;
}

// The bound a piece's distance is held to: dist_parent + tol.
template <int SD, class T>
__device__ __forceinline__ T parent_bound(const T* __restrict__ maps, const T* x, T tol) {
  return add_rn(l1_distance<SD>(maps, x), tol);
}

// Word w of a program's masks: bit i is the mask of piece c0 + 32 w + i,
// for the pieces [c0 + 32 w, min(c1, c0 + 32 w + 32)).  A program of P
// pieces has words_of(P) words, so it may have any number of pieces; a zoo
// may have any number of programs, and each kernel bins a point program by
// program.
__host__ __device__ constexpr int words_of(int npieces) { return (npieces + 31) / 32; }

template <int SD, class T>
__device__ __forceinline__ unsigned piece_bits(const T* __restrict__ maps, int c0, int c1, int w,
                                               const T* x, T best) {
  unsigned near = 0u;
  const int lo = c0 + 32 * w, hi = min(c1, lo + 32);
  for (int c = lo; c < hi; ++c) {
    if (l1_distance<SD>(maps + (SD + 1) * (SD + 1) * (c + 1), x) <= best) near |= 1u << (c - lo);
  }
  return near;
}

// A program's rule, applied to its words in subcell order: ``bits`` is word
// w's ``piece_bits`` and ``kept`` the hits kept in the words before it (0
// before the first).  A unique program keeps its first hit alone (the
// lowest bit of the first word that has one; every later word is cleared),
// any other program every hit.  Returns the word's kept bits and adds
// their count to ``kept``.
__device__ __forceinline__ unsigned rule_word(unsigned bits, int unique, int& kept) {
  if (unique) bits = kept ? 0u : bits & (0u - bits);
  kept += __popc(bits);
  return bits;
}

// The factor of a program's sums once all its words are in: 1 for a unique
// program, else recip = 1 / (hits over the whole program).
template <class T>
__device__ __forceinline__ T program_recip(int kept, int unique) {
  return unique ? T(1) : T(1) / static_cast<T>(kept);
}

}  // namespace fiat
