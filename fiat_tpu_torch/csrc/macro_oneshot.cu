// K3: the macro (split-complex) elements of a zoo in one launch, in f64 (the
// f64 engine) or f32 (the f32 engine's macro members): subcell binning, the
// parent-cell Dubiner recurrence, the masked change of basis and the
// multiplicity average, per point.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMacroOneShot._oneshot_kernel (apply_pair_points), with the binning of
// fiat_tpu/ops/pallas_recurrence.py:SubcellBinning.  That kernel computes
// the binning distances and the recurrence in df32 pairs, assembles the
// masked operand B through one-hot MXU products, and multiplies it in Ozaki
// windows, because the TPU has no f64.  Hopper has native FP64, so this
// kernel computes the function itself.  The float instantiation is the
// f32 engine's macro side program (fiat_tpu/ops/pallas_tabulate.py:
// PallasZooTabulator._macro_tables, which XLA runs outside any kernel there).
// For each point x:
//
//   1. the subcell masks of every program (binning.cuh, shared with K45):
//      mask_c = dist_c <= dist_parent + tol; a unique program (C0 basis at
//      order 0) keeps its first hit, every other program averages over its
//      hits, recip = 1 / (number of masks set);
//   2. phi_k(x), k < nexp(N): the parent-cell Dubiner recurrence to degree
//      N (dubiner2.cuh, shared with K1), held in registers;
//   3. out[r, x] = recip[prog(r)] * sum_{c in prog(r)} mask_c(x)
//                    * sum_{k < nexp_c} A[r, off_c + k] phi_k(x).
//
// Bound on the card: the store of out, rows * npts values (63 x 1e5 doubles
// = 50.4 MB for full_zoo's HCT + PS6 at order 1), and the FMA chains: each
// row is one serial chain of up to K FMAs per point (~2.4e3 FMAs per point
// on full_zoo; the H100 run measured it latency-bound).  Design: one
// thread per point; the merged A (rows x K, 33 KB in f64 on full_zoo)
// sits in shared memory and every thread of a warp reads the same element
// of A at once (a broadcast), the small tables come through the read-only
// cache; the masks are bits of one register; phi stays in registers (the
// degree is a template parameter, so the recurrence and the k loop unroll);
// out is row-major with points contiguous, so every store of a warp is one
// coalesced row segment.
//
// A is any change of basis over the pieces' columns whose row ranges the
// program table gives: the merged tables of every program (tabulation), or
// one row per program (interpolation, whose coefficients fold into A).
// Table layouts: binning.cuh.

#include <cuda_runtime.h>

#include <cstddef>

#include "binning.cuh"
#include "dubiner2.cuh"

namespace {

template <class T>
struct Affine {
  T a00, a01, a10, a11, b0, b1;
};

constexpr int THREADS = 128;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

template <int N, class T>
__global__ void __launch_bounds__(THREADS)
macro_oneshot_kernel(const T* __restrict__ pts, int npts, const T* __restrict__ consts,
                     Affine<T> m, T scale, T tol, const T* __restrict__ maps, int npieces,
                     const int* __restrict__ progs, int nprogs, const int* __restrict__ pieces,
                     const T* __restrict__ A, int rows, int K, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [rows][K]: the change of basis
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x) As[e] = A[e];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const T px = pts[2 * p], py = pts[2 * p + 1];

  // 1. binning: bit c of `near` is mask_c
  const unsigned near = fiat::subcell_bits(maps, npieces, px, py, tol);

  // 2. the parent recurrence, into registers
  constexpr int NE = fiat::Nexp<N>::value;
  T ph[NE];
  const T x0 = (px * m.a00 + py * m.a01) + m.b0;
  const T x1 = (px * m.a10 + py * m.a11) + m.b1;
  fiat::dubiner2_point<N>(x0, x1, consts, scale, [&](int, int r, int i, T v) {
    ph[(r + i) * (r + i + 1) / 2 + i] = v;
  });

  // 3. masked change of basis, averaged over the hits
  const size_t ld = static_cast<size_t>(npts);
  for (int g = 0; g < nprogs; ++g) {
    const int r0 = __ldg(progs + 5 * g), r1 = __ldg(progs + 5 * g + 1);
    const int c0 = __ldg(progs + 5 * g + 2), c1 = __ldg(progs + 5 * g + 3);
    T recip;
    const unsigned mk = fiat::program_mask(near, progs, g, recip);
    for (int r = r0; r < r1; ++r) {
      const T* Ar = As + static_cast<size_t>(r) * K;
      T acc = T(0);
      for (int c = c0; c < c1; ++c) {
        const T* Ac = Ar + __ldg(pieces + 2 * c);
        const int nk = __ldg(pieces + 2 * c + 1);
        T part = T(0);
#pragma unroll
        for (int k = 0; k < NE; ++k) {
          if (k < nk) part = fiat::fma_of(Ac[k], ph[k], part);
        }
        if ((mk >> (c - c0)) & 1u) acc += part;
      }
      out[static_cast<size_t>(r) * ld + p] = acc * recip;
    }
  }
}

template <int N, class T>
int launch(const T* pts, int npts, const T* consts, Affine<T> m, T scale, T tol, const T* maps,
           int npieces, const int* progs, int nprogs, const int* pieces, const T* A, int rows,
           int K, T* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * K * sizeof(T);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        macro_oneshot_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
  }
  const int blocks = (npts + THREADS - 1) / THREADS;
  macro_oneshot_kernel<N, T><<<blocks, THREADS, smem, stream>>>(
      pts, npts, consts, m, scale, tol, maps, npieces, progs, nprogs, pieces, A, rows, K, out);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int dispatch(const T* pts, int npts, const T* consts, Affine<T> m, T scale, T tol, int degree,
             const T* maps, int npieces, const int* progs, int nprogs, const int* pieces,
             const T* A, int rows, int K, T* out, void* stream) {
  if (npieces > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n)                                                                      \
  case n:                                                                                 \
    return launch<n, T>(pts, npts, consts, m, scale, tol, maps, npieces, progs, nprogs,   \
                        pieces, A, rows, K, out, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Return the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for a degree outside 0..10 or more than 32 pieces
// (the wrapper checks both first).
extern "C" int fiat_macro_oneshot(const double* pts, int npts, const double* consts,
                                  double a00, double a01, double a10, double a11, double b0,
                                  double b1, double scale, double tol, int degree,
                                  const double* maps, int npieces, const int* progs, int nprogs,
                                  const int* pieces, const double* A, int rows, int K,
                                  double* out, void* stream) {
  return dispatch<double>(pts, npts, consts, {a00, a01, a10, a11, b0, b1}, scale, tol, degree,
                          maps, npieces, progs, nprogs, pieces, A, rows, K, out, stream);
}

extern "C" int fiat_macro_oneshot_f32(const float* pts, int npts, const float* consts,
                                      float a00, float a01, float a10, float a11, float b0,
                                      float b1, float scale, float tol, int degree,
                                      const float* maps, int npieces, const int* progs,
                                      int nprogs, const int* pieces, const float* A, int rows,
                                      int K, float* out, void* stream) {
  return dispatch<float>(pts, npts, consts, {a00, a01, a10, a11, b0, b1}, scale, tol, degree,
                         maps, npieces, progs, nprogs, pieces, A, rows, K, out, stream);
}
