// K1: f64 Dubiner value recurrence on the interval, the triangle and the
// tetrahedron, writing Phi (nexp, npts).
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_recurrence.py:
// PallasSliceRecurrence._kernel (emit_slices + slice_split_ff).  That kernel
// emulates f64 with df32 (hi, lo) pairs, gathers each level into morton
// order through a {0,1} selection matmul, and splits the result into Ozaki
// bf16/int8 windows for the MXU.  Hopper has native FP64, so this kernel
// computes the function itself: plain f64 arithmetic, each value written
// straight to its morton row, no windows.
//
// Bound on the card: the store of Phi, nexp * npts doubles (53 MB on the
// triangle at degree 10, 132 MB on the tetrahedron at degree 8, 1.42 GB on
// the tetrahedron at degree 20, at 1e5 points); the arithmetic is ~5 flops
// per value.  Phi is row-major with points contiguous, so consecutive lanes
// take consecutive points and every store of a warp is one coalesced row
// segment.  The card's own streaming store (fill_) of those bytes reaches
// 85-98% of the bound; a thread a point, 128 a block, 782 blocks at 1e5
// points, reached 46-55% (tet 14, 20; triangle 20, 40): ~24 warps an SM,
// each one serial chain of nexp values, too few stores in flight.
//
// The triangle's and the tetrahedron's kernels (recurrence.cuh) take more
// work in flight in two ways, chosen at the launch:
//  - Row groups.  A point's stage-1 rows are dealt over R groups
//    (blockIdx.y): the thread of (point, group g) runs stage 0 and the
//    recurrence of the stage-1 rows r with owner[r] == g only (the `keep`
//    predicate of dubiner2.cuh / dubiner3.cuh), R times the threads, each
//    chain 1/R as long.  The host deals the rows by entries, largest first
//    to the group with the fewest (ops/recurrence.py:deal_rows).  A group
//    is warp-uniform, so the row test is a uniform branch; one group takes
//    an instantiation with no test at all (EveryRow), the unrolled code of
//    the thread-a-point kernel.
//  - Two points a thread (Pair): the two neighbouring points' recurrences
//    run side by side on the same constants, one load of them for two
//    values and one 16-byte store (a warp's 512 bytes of a row) for two,
//    where the point count is even.
// The wrapper picks R from the card's occupancy of the instantiation
// (fiat_dubiner_occupancy): the fewest waves of blocks for a group's share
// of the rows (ops/recurrence.py:launch_plan).  At 1e5 points on the H100
// that is two or three groups of two-point threads past 64 rows of Phi,
// one group below (chip_smoke.py --k1-cells sweeps every plan): tet 20 0.81
// -> 0.51 ms, triangle 40 0.40 -> 0.23, against bounds of 0.42 and 0.21.
//
// The degree is a template parameter of the unrolled instantiations, so the
// loops unroll and the live state stays in registers: the stage-0 output
// (N+1 values) and the two previous levels of the current row; the
// per-(level, row) constants are warp-uniform, at immediate offsets,
// through the read-only cache.  The per-point recurrence lives in
// dubiner1.cuh (interval: a three-term loop, each level stored as it comes,
// its member the level itself), dubiner2.cuh (triangle; shared with K3,
// K45 and K6) and dubiner3.cuh (tetrahedron: 165 values at degree 8 do not
// fit a thread's registers, so each stage-2 chain streams its values out
// holding two levels); the constant layouts are documented there.  Here
//   slots[e]                                   last-stage entry e: output row
//   owner[r]                                   stage-1 row r: its row group
// (ops/recurrence.py:pack_stages, deal_rows).
//
// Degrees 0..15 (sd 1, 2) and 0..10 (sd 3) are unrolled instantiations.
// Every degree past them runs one generic instantiation per sd, the degree
// a launch argument.  The interval's streams dubiner1.cuh's loop (one
// three-term chain: its members cannot be split, and its cells are
// launch-bound).  The triangle's and the tetrahedron's (tri_values_n,
// tet_values_n in recurrence.cuh) keep the loads off the recurrence's
// chain: a level's (a, b, c, norm) and output row are loaded one level
// ahead (two 16-byte loads and one 4-byte load, warp-uniform), so a value
// waits on the two values before it and on nothing from memory.  The
// table they read is 4 doubles an entry (8092 doubles + 1771 slots, 72 KB,
// at tetrahedron degree 20): it stays in the read-only cache (the kernels
// take no shared memory, so L1 keeps up to 256 KB an SM); staging it in
// shared memory would cost 72 KB a block and cap an SM at 3 blocks of 128,
// where the plans above hold 6-10.

#include <cuda_runtime.h>

#include <cstddef>

#include "dubiner1.cuh"
#include "recurrence.cuh"

namespace fiat {
namespace k1 {
FIAT_K1_INSTANCES(, double, EveryRow)
}  // namespace k1
}  // namespace fiat

namespace {

using fiat::k1::kThreads;
using fiat::k1::Launch;

template <int N>
__global__ void __launch_bounds__(kThreads)
dubiner1_values_kernel(const double* __restrict__ pts, int npts,
                       const double* __restrict__ consts, double a00, double b0,
                       double scale, double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  // cell map onto the default (-1, 1) interval: ref = a00 x + b0
  const double x0 = pts[p] * a00 + b0;
  const size_t ld = static_cast<size_t>(npts);
  fiat::dubiner1_point<N>(x0, consts, scale, [&](int i, double v) { phi[i * ld + p] = v; });
}

__global__ void __launch_bounds__(kThreads)
dubiner1_values_kernel_n(const double* __restrict__ pts, int npts,
                         const double* __restrict__ consts, double a00, double b0,
                         double scale, int n, double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double x0 = pts[p] * a00 + b0;
  const size_t ld = static_cast<size_t>(npts);
  fiat::dubiner1_point_n(n, x0, consts, scale, [&](int i, double v) { phi[i * ld + p] = v; });
}

// The launch shape of the triangle's and the tetrahedron's kernels, into
// a->grid: `groups` row groups, each thread `points` neighbouring points;
// false where the arguments are out of range (groups 1 up to the degree's
// rows, an owner table past one group, 1 or 2 points a thread, 2 only for
// an even point count).
template <class Map>
bool shape(Launch<Map>* a, int groups, int points) {
  if (a->degree < 0 || groups < 1 || groups > a->degree + 1 ||
      (groups > 1 && a->owner == nullptr) || (points != 1 && points != 2) ||
      a->npts % points != 0)
    return false;
  const int threads = a->npts / points;
  a->grid = dim3((threads + kThreads - 1) / kThreads, groups);
  return true;
}

// launch the (T, Keep) instantiation the plan names: one point a thread or
// two, one row group or several
template <class Map>
int launch(Launch<Map>& a, int groups, int points, void (*one)(const Launch<Map>&),
           void (*grouped)(const Launch<Map>&), void (*pairs)(const Launch<Map>&),
           void (*pair_groups)(const Launch<Map>&)) {
  if (!shape(&a, groups, points)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.npts > 0) {
    if (points == 2)
      (groups > 1 ? pair_groups : pairs)(a);
    else
      (groups > 1 ? grouped : one)(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The interval: degree 0..15 unrolled (nexp 16), any degree past it on the
// generic kernel; the members are the levels, so slots (the identity) is
// not read.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a negative degree (the wrapper checks first).
extern "C" int fiat_dubiner1_values(const double* pts, int npts, const double* consts,
                                    const int* /*slots*/, double a00, double b0, double scale,
                                    int degree, double* phi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (npts + kThreads - 1) / kThreads;
  switch (degree) {
#define FIAT_CASE(n)                                                                   \
  case n:                                                                              \
    dubiner1_values_kernel<n><<<blocks, kThreads, 0, s>>>(pts, npts, consts, a00, b0, \
                                                            scale, phi);               \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      if (degree < 0) return static_cast<int>(cudaErrorInvalidValue);
      dubiner1_values_kernel_n<<<blocks, kThreads, 0, s>>>(pts, npts, consts, a00, b0, scale,
                                                             degree, phi);
  }
  return static_cast<int>(cudaGetLastError());
}

// The triangle: degree 0..15 unrolled, any degree past it on the generic
// kernel; `groups` row groups (owner: deal_rows' table, null for one
// group), `points` (1 or 2) neighbouring points a thread.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for arguments out of range (the wrapper checks
// first).
extern "C" int fiat_dubiner2_values(const double* pts, int npts, const double* consts,
                                    const int* slots, const int* owner, int groups,
                                    int points, double a00, double a01, double a10,
                                    double a11, double b0, double b1, double scale, int degree,
                                    double* phi, void* stream) {
  using namespace fiat::k1;
  Launch<Affine> a{pts, npts, consts, slots, owner, Affine{a00, a01, a10, a11, b0, b1}, scale,
                   degree, phi, dim3(), static_cast<cudaStream_t>(stream)};
  return launch(a, groups, points, launch_tri<double, EveryRow>, launch_tri<double, GroupRows>,
                launch_tri<Pair, EveryRow>, launch_tri<Pair, GroupRows>);
}

// The tetrahedron: degree 0..10 unrolled (nexp 286), any degree past it on
// the generic kernel; groups, points and errors as the triangle's.
extern "C" int fiat_dubiner3_values(const double* pts, int npts, const double* consts,
                                    const int* slots, const int* owner, int groups,
                                    int points, double a00, double a01, double a02,
                                    double a10, double a11, double a12, double a20,
                                    double a21, double a22, double b0, double b1, double b2,
                                    double scale, int degree, double* phi, void* stream) {
  using namespace fiat::k1;
  Launch<Affine3> a{pts, npts, consts, slots, owner,
                    Affine3{{a00, a01, a02, a10, a11, a12, a20, a21, a22}, {b0, b1, b2}},
                    scale, degree, phi, dim3(), static_cast<cudaStream_t>(stream)};
  return launch(a, groups, points, launch_tet<double, EveryRow>, launch_tet<double, GroupRows>,
                launch_tet<Pair, EveryRow>, launch_tet<Pair, GroupRows>);
}

// The blocks an SM holds of the triangle's (sd 2) or the tetrahedron's (sd
// 3) kernel at `degree`, one row group or several (`grouped`), `points`
// points a thread (ops/recurrence.py:launch_plan sizes the row groups by
// it); minus the CUDA error, or -cudaErrorInvalidValue for arguments out
// of range.
extern "C" int fiat_dubiner_occupancy(int sd, int degree, int grouped, int points) {
  using namespace fiat::k1;
  if ((sd != 2 && sd != 3) || degree < 0 || (points != 1 && points != 2))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (sd == 2) {
    if (points == 2) return grouped ? occupancy_tri<Pair, GroupRows>(degree)
                                    : occupancy_tri<Pair, EveryRow>(degree);
    return grouped ? occupancy_tri<double, GroupRows>(degree)
                   : occupancy_tri<double, EveryRow>(degree);
  }
  if (points == 2) return grouped ? occupancy_tet<Pair, GroupRows>(degree)
                                  : occupancy_tet<Pair, EveryRow>(degree);
  return grouped ? occupancy_tet<double, GroupRows>(degree)
                 : occupancy_tet<double, EveryRow>(degree);
}
