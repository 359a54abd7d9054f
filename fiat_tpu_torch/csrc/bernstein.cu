// K8: the degree-N Bernstein basis on the sd-simplex at f64 points, written
// as features (nexp, npts): B_e(x) = multinomial(N; e) * prod_i lam_i(x)^e_i
// over the barycentric exponents e in ops/bernstein.py:bernstein_multiindices
// order (lexicographic in the leading sd exponents).
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_bernstein.py:
// PallasBernsteinFeatures._kernel (emit_bernstein + slice_split_ff).  That
// kernel takes barycentric df32 pairs computed outside it (an in-kernel
// 1 - sum(x) needs literal-constant TwoSums that XLA folds away), builds the
// powers by binary exponentiation gated by host-packed exponent bit masks
// (vectorised over rows), and splits the features into Ozaki bf16 windows.
// Hopper has native f64, so the barycentric map runs here, per point, and
// each feature is one product of register-held powers; no windows.
//
// Bound on the card: the store of the features, nexp * npts doubles (132 MB
// on the tetrahedron at degree 8 and 1e5 points, 0.04 ms at 3.35 TB/s);
// the arithmetic is at most sd + 1 multiplies per feature plus sd * N for
// the power table.  Design: one thread per point; the power table
// lam_i^e (e = 0..N, i = 0..sd) lives in registers (N is a template
// parameter, every loop unrolls, every index is a compile-time constant);
// the exact-integer multinomials are read from shared memory (loaded once
// per block, the same address across the warp); every feature row is
// stored coalesced across the warp's points.
//
// Past the unrolled degrees (15 / 15 / 10 on sd 1 / 2 / 3) one generic
// instantiation per sd takes the degree at the launch, up to fiat_tpu's
// 26 / 17 / 15 (where its packed multinomials reach 2^24; the host refuses
// past them, as fiat_tpu does).  A run-time degree cannot index registers,
// so each thread's power table lives in shared memory, column tid of a
// ((sd + 1) * (n + 1), THREADS) array (the warp's 32 powers of one
// exponent are 32 consecutive doubles: no bank conflict); the powers and
// the products are the same multiplications in the same order as the
// unrolled kernel's and the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;

__host__ __device__ constexpr int num_features(int sd, int n) {
  return sd == 1 ? n + 1 : sd == 2 ? (n + 1) * (n + 2) / 2 : (n + 1) * (n + 2) * (n + 3) / 6;
}

// bary: the barycentric map lam = A x + c, A (sd+1, sd) row-major, then c
// (sd+1); coef: the nexp multinomials.
template <int SD, int N>
__global__ void __launch_bounds__(THREADS)
bernstein_kernel(const double* __restrict__ pts, int npts, const double* __restrict__ bary,
                 const double* __restrict__ coef, double* __restrict__ out) {
  constexpr int NEXP = num_features(SD, N);
  __shared__ double cs[NEXP];
  for (int k = threadIdx.x; k < NEXP; k += blockDim.x) cs[k] = coef[k];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;

  double x[SD];
#pragma unroll
  for (int j = 0; j < SD; ++j) x[j] = pts[static_cast<size_t>(SD) * p + j];
  double pw[SD + 1][N + 1];
#pragma unroll
  for (int i = 0; i <= SD; ++i) {
    double lam = x[0] * __ldg(bary + SD * i);
#pragma unroll
    for (int j = 1; j < SD; ++j) lam += x[j] * __ldg(bary + SD * i + j);
    lam += __ldg(bary + SD * (SD + 1) + i);
    pw[i][0] = 1.0;
#pragma unroll
    for (int e = 1; e <= N; ++e) pw[i][e] = pw[i][e - 1] * lam;
  }

  const size_t ld = static_cast<size_t>(npts);
  int k = 0;
  // one feature: the multinomial times the powers with a nonzero exponent,
  // in coordinate order (the plain version's order of multiplications)
  auto put = [&](int e0, int e1, int e2, int e3) {
    const int e[4] = {e0, e1, e2, e3};
    double v = cs[k];
#pragma unroll
    for (int i = 0; i <= SD; ++i)
      if (e[i]) v *= pw[i][e[i]];
    out[k * ld + p] = v;
    ++k;
  };
  if constexpr (SD == 1) {
#pragma unroll
    for (int a = 0; a <= N; ++a) put(a, N - a, 0, 0);
  } else if constexpr (SD == 2) {
#pragma unroll
    for (int a = 0; a <= N; ++a)
#pragma unroll
      for (int b = 0; b <= N - a; ++b) put(a, b, N - a - b, 0);
  } else {
#pragma unroll
    for (int a = 0; a <= N; ++a)
#pragma unroll
      for (int b = 0; b <= N - a; ++b)
#pragma unroll
        for (int c = 0; c <= N - a - b; ++c) put(a, b, c, N - a - b - c);
  }
}

// Shared memory of the generic kernel: the multinomials, then the power
// table.
size_t generic_smem(int sd, int n) {
  return sizeof(double) * (num_features(sd, n) + static_cast<size_t>(sd + 1) * (n + 1) * THREADS);
}

template <int SD>
__global__ void __launch_bounds__(THREADS)
bernstein_generic_kernel(int n, const double* __restrict__ pts, int npts,
                         const double* __restrict__ bary, const double* __restrict__ coef,
                         double* __restrict__ out) {
  extern __shared__ double sm[];
  const int nexp = num_features(SD, n);
  double* cs = sm;
  double* pw = sm + nexp;  // [(i * (n + 1) + e) * THREADS + tid]: lam_i^e
  for (int k = threadIdx.x; k < nexp; k += blockDim.x) cs[k] = coef[k];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;

  double x[SD];
#pragma unroll
  for (int j = 0; j < SD; ++j) x[j] = pts[static_cast<size_t>(SD) * p + j];
  double* mine = pw + threadIdx.x;
  auto at = [&](int i, int e) -> double& { return mine[(i * (n + 1) + e) * THREADS]; };
#pragma unroll
  for (int i = 0; i <= SD; ++i) {
    double lam = x[0] * __ldg(bary + SD * i);
#pragma unroll
    for (int j = 1; j < SD; ++j) lam += x[j] * __ldg(bary + SD * i + j);
    lam += __ldg(bary + SD * (SD + 1) + i);
    double v = 1.0;
    at(i, 0) = v;
    for (int e = 1; e <= n; ++e) at(i, e) = v = v * lam;
  }

  const size_t ld = static_cast<size_t>(npts);
  int k = 0;
  auto put = [&](int e0, int e1, int e2, int e3) {
    const int e[4] = {e0, e1, e2, e3};
    double v = cs[k];
#pragma unroll
    for (int i = 0; i <= SD; ++i)
      if (e[i]) v *= at(i, e[i]);
    out[k * ld + p] = v;
    ++k;
  };
  if constexpr (SD == 1) {
    for (int a = 0; a <= n; ++a) put(a, n - a, 0, 0);
  } else if constexpr (SD == 2) {
    for (int a = 0; a <= n; ++a)
      for (int b = 0; b <= n - a; ++b) put(a, b, n - a - b, 0);
  } else {
    for (int a = 0; a <= n; ++a)
      for (int b = 0; b <= n - a; ++b)
        for (int c = 0; c <= n - a - b; ++c) put(a, b, c, n - a - b - c);
  }
}

template <int SD>
int launch_generic(int n, const double* pts, int npts, const double* bary, const double* coef,
                   double* out, cudaStream_t stream) {
  const size_t bytes = generic_smem(SD, n);
  cudaError_t err = cudaFuncSetAttribute(bernstein_generic_kernel<SD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const int blocks = (npts + THREADS - 1) / THREADS;
  bernstein_generic_kernel<SD><<<blocks, THREADS, bytes, stream>>>(n, pts, npts, bary, coef, out);
  return static_cast<int>(cudaGetLastError());
}

// the top of the unrolled instantiations, and of the generic one
__host__ __device__ constexpr int unrolled_top(int sd) { return sd == 3 ? 10 : 15; }
__host__ __device__ constexpr int generic_top(int sd) { return sd == 1 ? 26 : sd == 2 ? 17 : 15; }

template <int SD, int N>
void launch(const double* pts, int npts, const double* bary, const double* coef, double* out,
            cudaStream_t stream) {
  const int blocks = (npts + THREADS - 1) / THREADS;
  bernstein_kernel<SD, N><<<blocks, THREADS, 0, stream>>>(pts, npts, bary, coef, out);
}

template <int SD>
bool dispatch(int degree, const double* pts, int npts, const double* bary, const double* coef,
              double* out, cudaStream_t s) {
  switch (degree) {
#define FIAT_CASE(n)                                  \
  case n:                                             \
    if constexpr (SD < 3 || n <= 10) {                \
      launch<SD, n>(pts, npts, bary, coef, out, s);   \
      return true;                                    \
    }                                                 \
    return false;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      return false;
  }
}

}  // namespace

// pts: device (npts, sd) f64; bary: device ((sd+1)*sd + sd+1) f64; coef:
// device (nexp,) f64; out: device (nexp, npts) f64.  sd 1 takes degree
// 0..26, sd 2 0..17, sd 3 0..15: the unrolled instantiations to 15 / 15 /
// 10, the generic one past them.  Returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue, launching nothing, outside those ranges.
extern "C" int fiat_bernstein_features(const double* pts, int npts, int sd, int degree,
                                       const double* bary, const double* coef, double* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sd >= 1 && sd <= 3 && degree > unrolled_top(sd) && degree <= generic_top(sd)) {
    if (sd == 1) return launch_generic<1>(degree, pts, npts, bary, coef, out, s);
    if (sd == 2) return launch_generic<2>(degree, pts, npts, bary, coef, out, s);
    return launch_generic<3>(degree, pts, npts, bary, coef, out, s);
  }
  bool ok = false;
  if (sd == 1) ok = dispatch<1>(degree, pts, npts, bary, coef, out, s);
  if (sd == 2) ok = dispatch<2>(degree, pts, npts, bary, coef, out, s);
  if (sd == 3) ok = dispatch<3>(degree, pts, npts, bary, coef, out, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
