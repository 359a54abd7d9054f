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
// triangle at degree 10, 132 MB on the tetrahedron at degree 8, 12.8 MB on
// the interval at degree 15, at 1e5 points); the arithmetic is ~5 flops per
// value.  Design: one
// thread per point; Phi is row-major with points contiguous, so every store
// of a warp is one coalesced 256-byte row segment.  The degree is a template
// parameter, so the loops unroll and the live state stays in registers:
// the stage-0 output (N+1 values) and the two previous levels of the
// current row.  The per-(level, row) constants are uniform across the
// warp and come through the read-only cache.
//
// The per-point recurrence lives in dubiner1.cuh (interval: a three-term
// loop, each level stored as it comes, its member the level itself),
// dubiner2.cuh (triangle; shared with K3,
// which keeps Phi in registers) and dubiner3.cuh (tetrahedron: 165 values
// at degree 8 do not fit a thread's registers, so each stage-2 chain streams
// its values out holding two levels); the constant layouts are documented
// there.  Here
//   slots[e]                                   last-stage entry e: output row
// (ops/recurrence.py:pack_stages), the morton row of the entry.
//
// Degrees 0..15 (sd 1, 2) and 0..10 (sd 3) are unrolled instantiations.
// Every degree past them runs one generic kernel per sd, the degree a
// launch argument: the streaming recurrence of dubiner{1,2,3}.cuh
// (dubiner*_point_n: two values a stage in registers, whatever the degree;
// constants through the read-only cache), each value to phi[slots[e] * ld
// + p] as it comes.  It is bound by the same store (231 x 1e5 doubles, 0.18
// GB, at triangle degree 20).

#include <cuda_runtime.h>

#include <cstddef>

#include "dubiner1.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(128)
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

template <int N>
void launch1(const double* pts, int npts, const double* consts, double a00, double b0,
             double scale, double* phi, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (npts + threads - 1) / threads;
  dubiner1_values_kernel<N><<<blocks, threads, 0, stream>>>(pts, npts, consts, a00, b0, scale,
                                                             phi);
}

struct Affine {
  double a00, a01, a10, a11, b0, b1;
};

template <int N>
__global__ void __launch_bounds__(128)
dubiner2_values_kernel(const double* __restrict__ pts, int npts,
                       const double* __restrict__ consts,
                       const int* __restrict__ slots, Affine m, double scale,
                       double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double px = pts[2 * p], py = pts[2 * p + 1];
  // cell map onto the default (-1, 1) triangle: ref = A @ x + b
  const double x0 = (px * m.a00 + py * m.a01) + m.b0;
  const double x1 = (px * m.a10 + py * m.a11) + m.b1;
  const size_t ld = static_cast<size_t>(npts);
  // every value goes straight to its morton row
  fiat::dubiner2_point<N>(x0, x1, consts, scale, [&](int e, int, int, double v) {
    phi[(N == 0 ? 0 : __ldg(slots + e)) * ld + p] = v;
  });
}

template <int N>
void launch(const double* pts, int npts, const double* consts, const int* slots,
            Affine m, double scale, double* phi, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (npts + threads - 1) / threads;
  dubiner2_values_kernel<N><<<blocks, threads, 0, stream>>>(pts, npts, consts, slots, m,
                                                             scale, phi);
}

struct Affine3 {
  double a[9], b[3];
};

template <int N>
__global__ void __launch_bounds__(128)
dubiner3_values_kernel(const double* __restrict__ pts, int npts,
                       const double* __restrict__ consts,
                       const int* __restrict__ slots, Affine3 m, double scale,
                       double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  // cell map onto the default (-1, 1) tetrahedron: ref = A @ x + b
  const double x0 = (px * m.a[0] + py * m.a[1] + pz * m.a[2]) + m.b[0];
  const double x1 = (px * m.a[3] + py * m.a[4] + pz * m.a[5]) + m.b[1];
  const double x2 = (px * m.a[6] + py * m.a[7] + pz * m.a[8]) + m.b[2];
  const size_t ld = static_cast<size_t>(npts);
  fiat::dubiner3_point<N>(x0, x1, x2, consts, scale, [&](int e, double v) {
    phi[(N == 0 ? 0 : __ldg(slots + e)) * ld + p] = v;
  });
}

template <int N>
void launch3(const double* pts, int npts, const double* consts, const int* slots,
             const Affine3& m, double scale, double* phi, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (npts + threads - 1) / threads;
  dubiner3_values_kernel<N><<<blocks, threads, 0, stream>>>(pts, npts, consts, slots, m,
                                                             scale, phi);
}

// the generic kernels: any degree, given at run time
__global__ void __launch_bounds__(128)
dubiner1_values_kernel_n(const double* __restrict__ pts, int npts,
                         const double* __restrict__ consts, double a00, double b0,
                         double scale, int n, double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double x0 = pts[p] * a00 + b0;
  const size_t ld = static_cast<size_t>(npts);
  fiat::dubiner1_point_n(n, x0, consts, scale, [&](int i, double v) { phi[i * ld + p] = v; });
}

__global__ void __launch_bounds__(128)
dubiner2_values_kernel_n(const double* __restrict__ pts, int npts,
                         const double* __restrict__ consts, const int* __restrict__ slots,
                         Affine m, double scale, int n, double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double px = pts[2 * p], py = pts[2 * p + 1];
  const double x0 = (px * m.a00 + py * m.a01) + m.b0;
  const double x1 = (px * m.a10 + py * m.a11) + m.b1;
  const size_t ld = static_cast<size_t>(npts);
  fiat::dubiner2_point_n(n, x0, x1, consts, scale, [&](int e, int, int, double v) {
    phi[__ldg(slots + e) * ld + p] = v;
  });
}

__global__ void __launch_bounds__(128)
dubiner3_values_kernel_n(const double* __restrict__ pts, int npts,
                         const double* __restrict__ consts, const int* __restrict__ slots,
                         Affine3 m, double scale, int n, double* __restrict__ phi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  const double x0 = (px * m.a[0] + py * m.a[1] + pz * m.a[2]) + m.b[0];
  const double x1 = (px * m.a[3] + py * m.a[4] + pz * m.a[5]) + m.b[1];
  const double x2 = (px * m.a[6] + py * m.a[7] + pz * m.a[8]) + m.b[2];
  const size_t ld = static_cast<size_t>(npts);
  fiat::dubiner3_point_n(n, x0, x1, x2, consts, scale, [&](int e, double v) {
    phi[__ldg(slots + e) * ld + p] = v;
  });
}

constexpr int kThreads = 128;
int blocks_for(int npts) { return (npts + kThreads - 1) / kThreads; }

}  // namespace

// The interval: degree 0..15 unrolled (nexp 16), any degree past it on the
// generic kernel; the members are the levels, so slots (the identity) is
// not read.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a negative degree (the wrapper checks first).
extern "C" int fiat_dubiner1_values(const double* pts, int npts, const double* consts,
                                    const int* /*slots*/, double a00, double b0, double scale,
                                    int degree, double* phi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    launch1<n>(pts, npts, consts, a00, b0, scale, phi, s); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      if (degree < 0) return static_cast<int>(cudaErrorInvalidValue);
      dubiner1_values_kernel_n<<<blocks_for(npts), kThreads, 0, s>>>(pts, npts, consts, a00, b0,
                                                                      scale, degree, phi);
  }
  return static_cast<int>(cudaGetLastError());
}

// The triangle: degree 0..15 unrolled, any degree past it on the generic
// kernel.  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a negative degree (the wrapper checks first).
extern "C" int fiat_dubiner2_values(const double* pts, int npts, const double* consts,
                                    const int* slots, double a00, double a01, double a10,
                                    double a11, double b0, double b1, double scale,
                                    int degree, double* phi, void* stream) {
  const Affine m{a00, a01, a10, a11, b0, b1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    launch<n>(pts, npts, consts, slots, m, scale, phi, s); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      if (degree < 0) return static_cast<int>(cudaErrorInvalidValue);
      dubiner2_values_kernel_n<<<blocks_for(npts), kThreads, 0, s>>>(pts, npts, consts, slots, m,
                                                                      scale, degree, phi);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tetrahedron: degree 0..10 unrolled (nexp 286), any degree past it on
// the generic kernel; cudaErrorInvalidValue for a negative degree.
extern "C" int fiat_dubiner3_values(const double* pts, int npts, const double* consts,
                                    const int* slots, double a00, double a01, double a02,
                                    double a10, double a11, double a12, double a20,
                                    double a21, double a22, double b0, double b1, double b2,
                                    double scale, int degree, double* phi, void* stream) {
  const Affine3 m{{a00, a01, a02, a10, a11, a12, a20, a21, a22}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    launch3<n>(pts, npts, consts, slots, m, scale, phi, s); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      if (degree < 0) return static_cast<int>(cudaErrorInvalidValue);
      dubiner3_values_kernel_n<<<blocks_for(npts), kThreads, 0, s>>>(pts, npts, consts, slots, m,
                                                                      scale, degree, phi);
  }
  return static_cast<int>(cudaGetLastError());
}
