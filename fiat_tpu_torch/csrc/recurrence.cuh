// K1's kernels on the triangle and the tetrahedron (recurrence.cu holds the
// design note and the C entry points).  Each kernel is a template over
//   N     the unrolled degree, or fiat::GENERIC (the degree at the launch);
//   T     double (one point a thread) or Pair (two neighbouring points a
//         thread, their values in one 16-byte store);
//   Keep  EveryRow (one row group) or GroupRows (the rows of blockIdx.y).
// The (T, Keep) combinations are instantiated in four sources, one nvcc
// each (recurrence.cu, recurrence_groups.cu, recurrence_pairs.cu,
// recurrence_pair_groups.cu), so that they build in parallel.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace fiat {
namespace k1 {

// threads a block
constexpr int kThreads = 128;

struct Affine {
  double a00, a01, a10, a11, b0, b1;
};

struct Affine3 {
  double a[9], b[3];
};

// Two neighbouring points' values: the recurrence's arithmetic point by
// point (a double stands for the pair of it), stored as one double2.
struct Pair {
  double x, y;
  Pair() = default;
  __host__ __device__ constexpr Pair(double v) : x(v), y(v) {}
  __host__ __device__ constexpr Pair(double a, double b) : x(a), y(b) {}
};
__device__ __forceinline__ Pair operator+(Pair a, Pair b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ Pair operator-(Pair a, Pair b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ Pair operator*(Pair a, Pair b) { return {a.x * b.x, a.y * b.y}; }
__device__ __forceinline__ Pair operator-(Pair a) { return {-a.x, -a.y}; }

template <class T>
struct PointsOf {
  static constexpr int value = 1;
};
template <>
struct PointsOf<Pair> {
  static constexpr int value = 2;
};

// coordinate k of points p (and p + 1) in a row-major (npts, sd) array
__device__ __forceinline__ void load_coord(const double* __restrict__ pts, int p, int sd, int k,
                                           double* v) {
  *v = pts[sd * p + k];
}
__device__ __forceinline__ void load_coord(const double* __restrict__ pts, int p, int sd, int k,
                                           Pair* v) {
  *v = Pair(pts[sd * p + k], pts[sd * p + sd + k]);
}

// the value(s) at *out (16-byte aligned for a Pair: p and ld even)
__device__ __forceinline__ void store(double* __restrict__ out, double v) { *out = v; }
__device__ __forceinline__ void store(double* __restrict__ out, Pair v) {
  *reinterpret_cast<double2*>(out) = make_double2(v.x, v.y);
}

// Every stage-1 row (one row group): no test at all.
struct EveryRow {
  __device__ EveryRow(const int*, int) {}
  __device__ constexpr bool operator()(int) const { return true; }
};

// The stage-1 rows of this block's row group: owner[r] == blockIdx.y.
struct GroupRows {
  const int* __restrict__ owner;
  int g;
  __device__ GroupRows(const int* o, int group) : owner(o), g(group) {}
  __device__ bool operator()(int r) const { return __ldg(owner + r) == g; }
};

// The instantiations whose launch bounds ask for kBoundedBlocks blocks an
// SM: (Pair, GroupRows) at the unrolled degrees past 10 (triangle) and 5
// (tetrahedron), which take 88-120 registers unbounded (ptxas, sm_90a).  At
// 1e5 points two row groups of two-point threads are 782 blocks, one wave
// at 6 blocks an SM of 132 SMs, so these keep to 80 registers (the
// tetrahedron at degree 8 takes 96 unbounded: 5 blocks an SM, two waves).
// The others name no blocks an SM: given one, ptxas spends registers up to
// its bound (up to 255 on the unrolled degrees for one block an SM).
constexpr int kBoundedBlocks = 6;
template <int SD, int N, class T, class Keep>
constexpr bool kBounded = std::is_same<T, Pair>::value && std::is_same<Keep, GroupRows>::value &&
                          N > (SD == 2 ? 10 : 5);

// One entry's recurrence constants (a, b, c, norm) and its output row,
// loaded a level ahead of the level that uses them.
struct Entry {
  double a, b, c, norm;
  int slot;
};

// entry e of a table of 4 doubles an entry (16-byte aligned: the tables
// start at 4k doubles of a torch allocation); slots may be null
__device__ __forceinline__ Entry entry_at(const double* __restrict__ table,
                                          const int* __restrict__ slots, int e) {
  const double2 ab = __ldg(reinterpret_cast<const double2*>(table) + 2 * e);
  const double2 cn = __ldg(reinterpret_cast<const double2*>(table) + 2 * e + 1);
  return {ab.x, ab.y, cn.x, cn.y, slots == nullptr ? 0 : __ldg(slots + e)};
}

// one level of a three-term recurrence, as fiat::dubiner_step computes it
template <class T>
__device__ __forceinline__ T level(const Entry& k, T fa, T fb, T fc, T prev, T prev2) {
  return (k.a * fa - k.b * fb) * prev - (k.c * fc) * prev2;
}

// The triangle at a degree n >= 1 given at run time: dubiner2_point_n's
// recurrence, in its entry order, on the rows `keep` takes, each value
// stored to out[slots[e] * ld] as it comes, its constants a level ahead.
template <class T, class Keep>
__device__ __forceinline__ void tri_values_n(int n, T x0, T x1, const double* __restrict__ consts,
                                             const int* __restrict__ slots, double scale,
                                             double* __restrict__ out, size_t ld, Keep keep) {
  const T fb0 = 0.5 * (x1 + -1.0);
  const T fa0 = x0 + fb0 + 1.0;
  const T fc0 = fb0 * fb0;
  const T fb = 0.5 * (-1.0 + -1.0);
  const T fa = x1 + fb + 1.0;
  const T fc = fb * fb;
  const double* __restrict__ t1 = consts + 4 * (n + 1);
  const int last = (n + 1) * (n + 2) / 2 - 1;
  T s_prev2 = 0.0, s_prev = scale;
  Entry next{};
  int e = 0, ahead = -1;  // ahead: the entry `next` holds
#pragma unroll 1
  for (int r = 0; r <= n; ++r) {
    // stage 0, level r
    T r1;
    if (r == 0) {
      r1 = s_prev * __ldg(consts + 3);
    } else {
      const T v = dubiner_step(consts, 4 * r, fa0, fb0, fc0, s_prev, s_prev2);
      r1 = v * __ldg(consts + 4 * r + 3);
      s_prev2 = s_prev;
      s_prev = v;
    }
    if (!keep(r)) {
      e += n - r + 1;
      continue;
    }
    if (ahead != e) next = entry_at(t1, slots, e);
    // stage 1, row r: levels 0..n-r
    T prev2 = 0.0, prev = r1;
    Entry cur = next;
    next = entry_at(t1, slots, min(e + 1, last));
    store(out + cur.slot * ld, prev * cur.norm);
    ++e;
#pragma unroll 1
    for (int i = 1; i <= n - r; ++i, ++e) {
      cur = next;
      next = entry_at(t1, slots, min(e + 1, last));
      const T v = level(cur, fa, fb, fc, prev, prev2);
      store(out + cur.slot * ld, v * cur.norm);
      prev2 = prev;
      prev = v;
    }
    ahead = e;
  }
}

// The tetrahedron at a degree n >= 1 given at run time: dubiner3_point_n's
// recurrence, in its entry order, on the stage-1 rows p `keep` takes; the
// stage-1 and the stage-2 constants both a level ahead.
template <class T, class Keep>
__device__ __forceinline__ void tet_values_n(int n, T x0, T x1, T x2,
                                             const double* __restrict__ consts,
                                             const int* __restrict__ slots, double scale,
                                             double* __restrict__ out, size_t ld, Keep keep) {
  const int nexp2 = (n + 1) * (n + 2) / 2;
  const int last2 = nexp2 - 1;
  const int last = (n + 1) * (n + 2) * (n + 3) / 6 - 1;
  const T fb0 = 0.5 * (x1 + x2);
  const T fa0 = x0 + fb0 + 1.0;
  const T fc0 = fb0 * fb0;
  const T fb1 = 0.5 * (x2 + -1.0);
  const T fa1 = x1 + fb1 + 1.0;
  const T fc1 = fb1 * fb1;
  const T fb2 = 0.5 * (-1.0 + -1.0);
  const T fa2 = x2 + fb2 + 1.0;
  const T fc2 = fb2 * fb2;
  const double* __restrict__ t1 = consts + 4 * (n + 1);
  const double* __restrict__ t2 = t1 + 4 * nexp2;
  T s_prev2 = 0.0, s_prev = scale;
  Entry next{}, next1{};
  int e1 = 0, e = 0, ahead = -1;  // ahead: the stage-2 entry `next` holds
#pragma unroll 1
  for (int p = 0; p <= n; ++p) {
    // stage 0, level p
    T r0;
    if (p == 0) {
      r0 = s_prev * __ldg(consts + 3);
    } else {
      const T v = dubiner_step(consts, 4 * p, fa0, fb0, fc0, s_prev, s_prev2);
      r0 = v * __ldg(consts + 4 * p + 3);
      s_prev2 = s_prev;
      s_prev = v;
    }
    if (!keep(p)) {
      e1 += n - p + 1;
      e += (n - p + 1) * (n - p + 2) / 2;
      continue;
    }
    if (ahead != e) {
      next = entry_at(t2, slots, e);
      next1 = entry_at(t1, nullptr, e1);
    }
    // stage 1, row p: levels q = 0..n-p, one a stage-2 row
    T prev2 = 0.0, prev = r0;
#pragma unroll 1
    for (int q = 0; q <= n - p; ++q, ++e1) {
      const Entry k1 = next1;
      next1 = entry_at(t1, nullptr, min(e1 + 1, last2));
      T v = prev;
      if (q > 0) {
        v = level(k1, fa1, fb1, fc1, prev, prev2);
        prev2 = prev;
        prev = v;
      }
      // stage 2, row (p, q): levels r = 0..n-p-q, straight to Phi
      T s2 = 0.0, s = v * k1.norm;
      Entry cur = next;
      next = entry_at(t2, slots, min(e + 1, last));
      store(out + cur.slot * ld, s * cur.norm);
      ++e;
#pragma unroll 1
      for (int r = 1; r <= n - p - q; ++r, ++e) {
        cur = next;
        next = entry_at(t2, slots, min(e + 1, last));
        const T w = level(cur, fa2, fb2, fc2, s, s2);
        store(out + cur.slot * ld, w * cur.norm);
        s2 = s;
        s = w;
      }
    }
    ahead = e;
  }
}

// Thread (blockIdx.x * blockDim.x + threadIdx.x) of row group blockIdx.y
// takes PointsOf<T> neighbouring points.
template <int N, class T, class Keep>
__device__ __forceinline__ void tri_point_values(const double* __restrict__ pts, int npts,
                                                 const double* __restrict__ consts,
                                                 const int* __restrict__ slots,
                                                 const int* __restrict__ owner, Affine m,
                                                 double scale, int n, double* __restrict__ phi) {
  const int p = PointsOf<T>::value * (blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= npts) return;
  T px, py;
  load_coord(pts, p, 2, 0, &px);
  load_coord(pts, p, 2, 1, &py);
  // cell map onto the default (-1, 1) triangle: ref = A @ x + b
  const T x0 = (px * m.a00 + py * m.a01) + m.b0;
  const T x1 = (px * m.a10 + py * m.a11) + m.b1;
  const size_t ld = static_cast<size_t>(npts);
  const Keep keep(owner, static_cast<int>(blockIdx.y));
  if constexpr (N == GENERIC) {
    tri_values_n(n, x0, x1, consts, slots, scale, phi + p, ld, keep);
  } else {
    // every value goes straight to its morton row
    dubiner2_point<N>(x0, x1, consts, T(scale), [&](int e, int, int, T v) {
      store(phi + (N == 0 ? 0 : __ldg(slots + e)) * ld + p, v);
    }, keep);
  }
}

template <int N, class T, class Keep>
__device__ __forceinline__ void tet_point_values(const double* __restrict__ pts, int npts,
                                                 const double* __restrict__ consts,
                                                 const int* __restrict__ slots,
                                                 const int* __restrict__ owner, Affine3 m,
                                                 double scale, int n, double* __restrict__ phi) {
  const int p = PointsOf<T>::value * (blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= npts) return;
  T px, py, pz;
  load_coord(pts, p, 3, 0, &px);
  load_coord(pts, p, 3, 1, &py);
  load_coord(pts, p, 3, 2, &pz);
  // cell map onto the default (-1, 1) tetrahedron: ref = A @ x + b
  const T x0 = (px * m.a[0] + py * m.a[1] + pz * m.a[2]) + m.b[0];
  const T x1 = (px * m.a[3] + py * m.a[4] + pz * m.a[5]) + m.b[1];
  const T x2 = (px * m.a[6] + py * m.a[7] + pz * m.a[8]) + m.b[2];
  const size_t ld = static_cast<size_t>(npts);
  const Keep keep(owner, static_cast<int>(blockIdx.y));
  if constexpr (N == GENERIC) {
    tet_values_n(n, x0, x1, x2, consts, slots, scale, phi + p, ld, keep);
  } else {
    dubiner3_point<N>(x0, x1, x2, consts, T(scale), [&](int e, T v) {
      store(phi + (N == 0 ? 0 : __ldg(slots + e)) * ld + p, v);
    }, keep);
  }
}

// One launch's arguments: the kernels' own and the launch shape.
template <class Map>
struct Launch {
  const double* pts;
  int npts;
  const double* consts;
  const int* slots;
  const int* owner;
  Map m;
  double scale;
  int degree;
  double* phi;
  dim3 grid;
  cudaStream_t stream;
};

// The kernels: one template for every (N, T, Keep), and the bounded one
// (kBounded).
#define FIAT_K1_PARAMS(MAP)                                                                \
  const double *__restrict__ pts, int npts, const double *__restrict__ consts,             \
      const int *__restrict__ slots, const int *__restrict__ owner, MAP m, double scale, \
      int n, double *__restrict__ phi
#define FIAT_K1_ARGS pts, npts, consts, slots, owner, m, scale, n, phi

template <int N, class T, class Keep>
__global__ void __launch_bounds__(kThreads) dubiner2_values_kernel(FIAT_K1_PARAMS(Affine)) {
  tri_point_values<N, T, Keep>(FIAT_K1_ARGS);
}

template <int N>
__global__ void __launch_bounds__(kThreads, kBoundedBlocks)
dubiner2_values_kernel_bounded(FIAT_K1_PARAMS(Affine)) {
  tri_point_values<N, Pair, GroupRows>(FIAT_K1_ARGS);
}

template <int N, class T, class Keep>
__global__ void __launch_bounds__(kThreads) dubiner3_values_kernel(FIAT_K1_PARAMS(Affine3)) {
  tet_point_values<N, T, Keep>(FIAT_K1_ARGS);
}

template <int N>
__global__ void __launch_bounds__(kThreads, kBoundedBlocks)
dubiner3_values_kernel_bounded(FIAT_K1_PARAMS(Affine3)) {
  tet_point_values<N, Pair, GroupRows>(FIAT_K1_ARGS);
}
#undef FIAT_K1_PARAMS
#undef FIAT_K1_ARGS

// The instantiation a launch at (N, T, Keep) runs, and the launch.
template <int N, class T, class Keep>
const void* tri_kernel() {
  if constexpr (kBounded<2, N, T, Keep>)
    return reinterpret_cast<const void*>(dubiner2_values_kernel_bounded<N>);
  else
    return reinterpret_cast<const void*>(dubiner2_values_kernel<N, T, Keep>);
}

template <int N, class T, class Keep>
void tri_launch(const Launch<Affine>& a, int n) {
  if constexpr (kBounded<2, N, T, Keep>) {
    dubiner2_values_kernel_bounded<N><<<a.grid, kThreads, 0, a.stream>>>(
        a.pts, a.npts, a.consts, a.slots, a.owner, a.m, a.scale, n, a.phi);
  } else {
    dubiner2_values_kernel<N, T, Keep><<<a.grid, kThreads, 0, a.stream>>>(
        a.pts, a.npts, a.consts, a.slots, a.owner, a.m, a.scale, n, a.phi);
  }
}

template <int N, class T, class Keep>
const void* tet_kernel() {
  if constexpr (kBounded<3, N, T, Keep>)
    return reinterpret_cast<const void*>(dubiner3_values_kernel_bounded<N>);
  else
    return reinterpret_cast<const void*>(dubiner3_values_kernel<N, T, Keep>);
}

template <int N, class T, class Keep>
void tet_launch(const Launch<Affine3>& a, int n) {
  if constexpr (kBounded<3, N, T, Keep>) {
    dubiner3_values_kernel_bounded<N><<<a.grid, kThreads, 0, a.stream>>>(
        a.pts, a.npts, a.consts, a.slots, a.owner, a.m, a.scale, n, a.phi);
  } else {
    dubiner3_values_kernel<N, T, Keep><<<a.grid, kThreads, 0, a.stream>>>(
        a.pts, a.npts, a.consts, a.slots, a.owner, a.m, a.scale, n, a.phi);
  }
}

// The triangle's launch: degree 0..15 unrolled, any degree past it on the
// generic instantiation.
template <class T, class Keep>
void launch_tri(const Launch<Affine>& a) {
  switch (a.degree) {
#define FIAT_CASE(n)              \
  case n:                         \
    tri_launch<n, T, Keep>(a, n); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      tri_launch<GENERIC, T, Keep>(a, a.degree);
  }
}

// The tetrahedron's launch: degree 0..10 unrolled (nexp 286), any degree
// past it on the generic instantiation.
template <class T, class Keep>
void launch_tet(const Launch<Affine3>& a) {
  switch (a.degree) {
#define FIAT_CASE(n)              \
  case n:                         \
    tet_launch<n, T, Keep>(a, n); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      tet_launch<GENERIC, T, Keep>(a, a.degree);
  }
}

// The blocks an SM holds of the instantiation a launch at `degree` runs.
template <class T, class Keep>
int occupancy_tri(int degree) {
  const void* kernel = nullptr;
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    kernel = tri_kernel<n, T, Keep>(); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      kernel = tri_kernel<GENERIC, T, Keep>();
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <class T, class Keep>
int occupancy_tet(int degree) {
  const void* kernel = nullptr;
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    kernel = tet_kernel<n, T, Keep>(); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      kernel = tet_kernel<GENERIC, T, Keep>();
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// each (T, Keep) is instantiated by one source
#define FIAT_K1_INSTANCES(EXTERN, T, KEEP)                          \
  EXTERN template void launch_tri<T, KEEP>(const Launch<Affine>&);  \
  EXTERN template void launch_tet<T, KEEP>(const Launch<Affine3>&); \
  EXTERN template int occupancy_tri<T, KEEP>(int);                  \
  EXTERN template int occupancy_tet<T, KEEP>(int);
FIAT_K1_INSTANCES(extern, double, EveryRow)
FIAT_K1_INSTANCES(extern, double, GroupRows)
FIAT_K1_INSTANCES(extern, Pair, EveryRow)
FIAT_K1_INSTANCES(extern, Pair, GroupRows)

}  // namespace k1
}  // namespace fiat
