// K3: the macro (split-complex) elements of a zoo in one launch, in f64:
// subcell binning, the parent-cell Dubiner recurrence, the masked change of
// basis and the multiplicity average, per point.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMacroOneShot._oneshot_kernel (apply_pair_points), with the binning of
// fiat_tpu/ops/pallas_recurrence.py:SubcellBinning.  That kernel computes
// the binning distances and the recurrence in df32 pairs, assembles the
// masked operand B through one-hot MXU products, and multiplies it in Ozaki
// windows, because the TPU has no f64.  Hopper has native FP64, so this
// kernel computes the function itself.  For each point x:
//
//   1. dist_c = sum_j max(-lambda_cj(x), 0) over the rescaled barycentric
//      coordinates lambda_c of the parent cell (c = parent) and of every
//      subcell of every program; mask_c = dist_c <= dist_parent + 1e-12.
//      A unique program (C0 basis at order 0) keeps its first hit in
//      subcell order; every other program averages over the hits,
//      recip = 1 / (number of masks set).
//   2. phi_k(x), k < nexp(N): the parent-cell Dubiner recurrence to degree
//      N (dubiner2.cuh, shared with K1), held in registers.
//   3. out[r, x] = recip[prog(r)] * sum_{c in prog(r)} mask_c(x)
//                    * sum_{k < nexp_c} A[r, off_c + k] phi_k(x).
//
// Bound on the card: the store of out, rows * npts doubles (63 x 1e5 =
// 50.4 MB for full_zoo's HCT + PS6 at order 1), and the FMA chains: each
// row is one serial chain of up to K FMAs per point (~2.4e3 FMAs per point
// on full_zoo; the H100 run measured it latency-bound).  Design: one
// thread per point; the merged A (rows x K doubles, 33 KB on full_zoo)
// sits in shared memory and every thread of a warp reads the same element
// of A at once (a broadcast), the small tables come through the read-only
// cache; the masks are bits of one
// register; phi stays in registers (the degree is a template parameter, so
// the recurrence and the k loop unroll); out is row-major with points
// contiguous, so every store of a warp is one coalesced row segment.
//
// Tables (built by fiat_tpu_torch/ops/macro_oneshot.py):
//   maps[9*m + 3*j + {0,1,2}]   map m (0 = parent, 1 + c = piece c), row j:
//                               lambda_j = a0 * x + a1 * y + b
//   progs[5*g + {0..4}]         program g: first row, end row, first piece,
//                               end piece, unique (0/1)
//   pieces[2*c + {0,1}]         piece c: first column of A, nexp (<= nexp(N))

#include <cuda_runtime.h>

#include <cstddef>

#include "dubiner2.cuh"

namespace {

struct Affine {
  double a00, a01, a10, a11, b0, b1;
};

constexpr int THREADS = 128;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ double l1_distance(const double* __restrict__ map, double x,
                                              double y) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const double b = (x * __ldg(map + 3 * j) + y * __ldg(map + 3 * j + 1)) + __ldg(map + 3 * j + 2);
    s += fabs(b) - b;
  }
  return 0.5 * s;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
macro_oneshot_kernel(const double* __restrict__ pts, int npts,
                     const double* __restrict__ consts, Affine m, double scale,
                     const double* __restrict__ maps, int npieces,
                     const int* __restrict__ progs, int nprogs,
                     const int* __restrict__ pieces, const double* __restrict__ A,
                     int rows, int K, double* __restrict__ out) {
  extern __shared__ double As[];  // [rows][K]: the merged change of basis
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x) As[e] = A[e];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const double px = pts[2 * p], py = pts[2 * p + 1];

  // 1. binning: bit c of `near` is mask_c
  const double best = l1_distance(maps, px, py) + 1e-12;
  unsigned near = 0u;
  for (int c = 0; c < npieces; ++c) {
    if (l1_distance(maps + 9 * (c + 1), px, py) <= best) near |= 1u << c;
  }

  // 2. the parent recurrence, into registers
  constexpr int NE = fiat::Nexp<N>::value;
  double ph[NE];
  const double x0 = (px * m.a00 + py * m.a01) + m.b0;
  const double x1 = (px * m.a10 + py * m.a11) + m.b1;
  fiat::dubiner2_point<N>(x0, x1, consts, scale, [&](int, int r, int i, double v) {
    ph[(r + i) * (r + i + 1) / 2 + i] = v;
  });

  // 3. masked change of basis, averaged over the hits
  const size_t ld = static_cast<size_t>(npts);
  for (int g = 0; g < nprogs; ++g) {
    const int r0 = __ldg(progs + 5 * g), r1 = __ldg(progs + 5 * g + 1);
    const int c0 = __ldg(progs + 5 * g + 2), c1 = __ldg(progs + 5 * g + 3);
    const int nc = c1 - c0;
    unsigned mk = (near >> c0) & (nc >= 32 ? ~0u : (1u << nc) - 1u);
    double recip = 1.0;
    if (__ldg(progs + 5 * g + 4)) {
      mk &= 0u - mk;  // the first hit in subcell order
    } else {
      recip = 1.0 / static_cast<double>(__popc(mk));
    }
    for (int r = r0; r < r1; ++r) {
      const double* Ar = As + static_cast<size_t>(r) * K;
      double acc = 0.0;
      for (int c = c0; c < c1; ++c) {
        const double* Ac = Ar + __ldg(pieces + 2 * c);
        const int nk = __ldg(pieces + 2 * c + 1);
        double part = 0.0;
#pragma unroll
        for (int k = 0; k < NE; ++k) {
          if (k < nk) part = fma(Ac[k], ph[k], part);
        }
        if ((mk >> (c - c0)) & 1u) acc += part;
      }
      out[static_cast<size_t>(r) * ld + p] = acc * recip;
    }
  }
}

template <int N>
int launch(const double* pts, int npts, const double* consts, Affine m, double scale,
           const double* maps, int npieces, const int* progs, int nprogs, const int* pieces,
           const double* A, int rows, int K, double* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * K * sizeof(double);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        macro_oneshot_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
  }
  const int blocks = (npts + THREADS - 1) / THREADS;
  macro_oneshot_kernel<N><<<blocks, THREADS, smem, stream>>>(
      pts, npts, consts, m, scale, maps, npieces, progs, nprogs, pieces, A, rows, K, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for a degree outside 0..10 or more than 32 pieces
// (the wrapper checks both first).
extern "C" int fiat_macro_oneshot(const double* pts, int npts, const double* consts,
                                  double a00, double a01, double a10, double a11, double b0,
                                  double b1, double scale, int degree, const double* maps,
                                  int npieces, const int* progs, int nprogs, const int* pieces,
                                  const double* A, int rows, int K, double* out, void* stream) {
  if (npieces > 32) return static_cast<int>(cudaErrorInvalidValue);
  const Affine m{a00, a01, a10, a11, b0, b1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n)                                                                   \
  case n:                                                                              \
    return launch<n>(pts, npts, consts, m, scale, maps, npieces, progs, nprogs, pieces, A, \
                     rows, K, out, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
