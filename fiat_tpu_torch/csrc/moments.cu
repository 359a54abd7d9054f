// K45: the expansion-side moments of a zoo in one launch, in f64: the plain
// moments pw[k] = sum_q phi_k(x_q) wf_q and, for every subcell c of every
// macro program, the masked moments bw[c, k] = sum_q mask_c(x_q) recip(x_q)
// phi_k(x_q) wf_q.
//
// Replaces two TPU kernels: fiat_tpu/ops/pallas_recurrence.py:
// PallasPairMoments._moment_kernel (K4, the plain moments) and
// PallasMaskedPairMoments._masked_moment_kernel (K5, the masked ones).
// Those run the recurrence in df32 pairs, rebuild phi from Ozaki windows,
// and reduce every tile exactly through re-quantised 8-bit windows and bf16
// mask dots, because the TPU has no f64; they are two kernels because
// reusing one window prefix for both was never verified there.  Hopper has
// native FP64, so one kernel computes both sums in plain f64.  The parent
// basis of the macro programs is a morton prefix of the zoo's basis at the
// same scale (the wrapper checks it), so one recurrence per point serves
// every row.
//
// Bound on the card: not memory (24 bytes of points and weights per point,
// 240 MB at 1e7 points), but the per-point work: the recurrence (~5 flops
// per member) and one accumulation per output row.  Design: a grid-stride
// loop over the points, one point per thread; phi stays in registers
// (degree as a template parameter); every lane keeps its own column of row
// sums in shared memory ([warp][row][lane], so a warp's accesses to one row
// are 32 consecutive doubles and every row's read-add-write is independent
// of the others), and adds w * phi_k, or mask * recip * w * phi_k for the
// pieces its point lies on, with no cross-lane traffic and no atomics.  At
// the end the block adds the columns in lane and warp order (the order is
// fixed, so the result is deterministic) and writes one partial row vector;
// the wrapper sums the (blocks, R) partials, as fiat_tpu sums its per-tile
// partials in XLA.  (A first version reduced every row across the warp
// with shuffles: 6.4 ms at 1e7 points, bound by the shuffle chains.)
//
// Output row layout (R = nplain + the pieces' widths): rows 0..nplain-1 are
// pw; piece c's masked moments are rows nplain + off_c + k, k < nexp_c
// (program-major, subcell-major: fiat_tpu's b_stack order).  Tables:
// binning.cuh (maps, progs, pieces) and dubiner2.cuh (consts).
//
// The tetrahedron (sd = 3, degree 0..10) computes the same sums in the same
// layout, but phi does not fit a thread's registers (165 values at degree
// 8), so dubiner3.cuh streams the values and the kernel adds each one into
// its rows as it comes: slots[e] (ops/recurrence.py:pack_stages(N, sd=3))
// gives stage-2 entry e its morton row j.  A point runs one pass of the
// recurrence for each row block it feeds: the plain rows (w * phi_j, j <
// nplain), then, binned as above, every piece it lies on in program and
// subcell order (recip * w * phi_j into piece c's rows, j < nexp_c).  An
// interior point of sv_macro_tet (4 programs) runs 5 passes of the degree-3
// recurrence (167 flops each) beside its binning (33 L1 distances).  A
// single pass feeding every block at once unrolls a compare and add per
// block into each value: with it the kernels' build took 79 s on the H100
// machine, against 23 s with one pass per block.

#include <cuda_runtime.h>

#include <cstddef>

#include "binning.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace {

struct Affine {
  double a00, a01, a10, a11, b0, b1;
};

constexpr int THREADS = 64;
constexpr int WARPS = THREADS / 32;

template <int N>
__global__ void __launch_bounds__(THREADS)
pair_moments_kernel(const double* __restrict__ pts, const double* __restrict__ wf, int npts,
                    const double* __restrict__ consts, Affine m, double scale, double tol,
                    int nplain, const double* __restrict__ maps, int npieces,
                    const int* __restrict__ progs, int nprogs, const int* __restrict__ pieces,
                    int R, double* __restrict__ partials) {
  extern __shared__ double acc[];  // [WARPS][R][32]: every lane's own row sums
  for (int e = threadIdx.x; e < WARPS * R * 32; e += THREADS) acc[e] = 0.0;
  __syncthreads();
  // this lane's column: row r at mine[32 * r]
  double* mine = acc + (threadIdx.x >> 5) * R * 32 + (threadIdx.x & 31);
  constexpr int NE = fiat::Nexp<N>::value;

  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < npts;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const double px = pts[2 * p], py = pts[2 * p + 1];
    const double w = wf[p];
    double ph[NE];
    const double x0 = (px * m.a00 + py * m.a01) + m.b0;
    const double x1 = (px * m.a10 + py * m.a11) + m.b1;
    fiat::dubiner2_point<N>(x0, x1, consts, scale, [&](int, int r, int i, double v) {
      ph[(r + i) * (r + i + 1) / 2 + i] = v;
    });

    // K4's rows: the plain moments
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      if (k < nplain) mine[32 * k] += ph[k] * w;
    }

    // K5's rows: the masked moments of the pieces this point lies on
    const unsigned near = fiat::subcell_bits(maps, npieces, px, py, tol);
    for (int g = 0; g < nprogs; ++g) {
      double recip;
      const unsigned mk = fiat::program_mask(near, progs, g, recip);
      const int c0 = __ldg(progs + 5 * g + 2), c1 = __ldg(progs + 5 * g + 3);
      for (int c = c0; c < c1; ++c) {
        if (!((mk >> (c - c0)) & 1u)) continue;
        const double f = recip * w;
        double* row = mine + 32 * (nplain + __ldg(pieces + 2 * c));
        const int nk = __ldg(pieces + 2 * c + 1);
#pragma unroll
        for (int k = 0; k < NE; ++k) {
          if (k < nk) row[32 * k] += f * ph[k];
        }
      }
    }
  }

  __syncthreads();
  for (int r = threadIdx.x; r < R; r += THREADS) {
    double s = 0.0;
    for (int wi = 0; wi < WARPS; ++wi) {
      const double* col = acc + (wi * R + r) * 32;
#pragma unroll
      for (int l = 0; l < 32; ++l) s += col[l];
    }
    partials[static_cast<size_t>(blockIdx.x) * R + r] = s;
  }
}

template <int N>
int launch(const double* pts, const double* wf, int npts, const double* consts, Affine m,
           double scale, double tol, int nplain, const double* maps, int npieces,
           const int* progs, int nprogs, const int* pieces, int R, double* partials,
           int nblocks, cudaStream_t stream) {
  const size_t smem = sizeof(double) * WARPS * 32 * static_cast<size_t>(R);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_moments_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return static_cast<int>(err);
  }
  pair_moments_kernel<N><<<nblocks, THREADS, smem, stream>>>(
      pts, wf, npts, consts, m, scale, tol, nplain, maps, npieces, progs, nprogs, pieces, R,
      partials);
  return static_cast<int>(cudaGetLastError());
}

struct Affine3 {
  double a[9], b[3];
};

// Adds f * phi_j to rows[32 * j] (this lane's column of a row block) for
// every member j < nk of the degree-N basis at (x0, x1, x2): one pass of
// the streamed recurrence, each value into its morton row as it comes.
template <int N>
__device__ __forceinline__ void add_rows(double x0, double x1, double x2,
                                         const double* __restrict__ consts,
                                         const int* __restrict__ slots, double scale,
                                         double* rows, int nk, double f) {
  fiat::dubiner3_point<N>(x0, x1, x2, consts, scale, [&](int e, double v) {
    const int j = N == 0 ? 0 : __ldg(slots + e);
    if (j < nk) rows[32 * j] += f * v;
  });
}

template <int N>
__global__ void __launch_bounds__(THREADS)
pair_moments3_kernel(const double* __restrict__ pts, const double* __restrict__ wf, int npts,
                     const double* __restrict__ consts, const int* __restrict__ slots,
                     Affine3 m, double scale, double tol, int nplain,
                     const double* __restrict__ maps, int npieces,
                     const int* __restrict__ progs, int nprogs, const int* __restrict__ pieces,
                     int R, double* __restrict__ partials) {
  extern __shared__ double acc[];  // [WARPS][R][32]: every lane's own row sums
  for (int e = threadIdx.x; e < WARPS * R * 32; e += THREADS) acc[e] = 0.0;
  __syncthreads();
  double* mine = acc + (threadIdx.x >> 5) * R * 32 + (threadIdx.x & 31);

  for (long long p = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; p < npts;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const double px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
    const double w = wf[p];
    // cell map onto the default (-1, 1) tetrahedron, as K1's
    const double x0 = (px * m.a[0] + py * m.a[1] + pz * m.a[2]) + m.b[0];
    const double x1 = (px * m.a[3] + py * m.a[4] + pz * m.a[5]) + m.b[1];
    const double x2 = (px * m.a[6] + py * m.a[7] + pz * m.a[8]) + m.b[2];

    // K4's rows: the plain moments
    add_rows<N>(x0, x1, x2, consts, slots, scale, mine, nplain, w);

    // K5's rows: one pass for each piece this point lies on
    if (nprogs == 0) continue;
    const unsigned near = fiat::subcell_bits3(maps, npieces, px, py, pz, tol);
    for (int g = 0; g < nprogs; ++g) {
      double recip;
      const int c0 = __ldg(progs + 5 * g + 2);
      for (unsigned mk = fiat::program_mask(near, progs, g, recip); mk; mk &= mk - 1u) {
        const int c = c0 + __ffs(mk) - 1;
        add_rows<N>(x0, x1, x2, consts, slots, scale, mine + 32 * (nplain + __ldg(pieces + 2 * c)),
                    __ldg(pieces + 2 * c + 1), recip * w);
      }
    }
  }

  __syncthreads();
  for (int r = threadIdx.x; r < R; r += THREADS) {
    double s = 0.0;
    for (int wi = 0; wi < WARPS; ++wi) {
      const double* col = acc + (wi * R + r) * 32;
#pragma unroll
      for (int l = 0; l < 32; ++l) s += col[l];
    }
    partials[static_cast<size_t>(blockIdx.x) * R + r] = s;
  }
}

template <int N>
int launch3(const double* pts, const double* wf, int npts, const double* consts,
            const int* slots, const Affine3& m, double scale, double tol, int nplain,
            const double* maps, int npieces, const int* progs, int nprogs, const int* pieces,
            int R, double* partials, int nblocks, cudaStream_t stream) {
  const size_t smem = sizeof(double) * WARPS * 32 * static_cast<size_t>(R);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_moments3_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return static_cast<int>(err);
  }
  pair_moments3_kernel<N><<<nblocks, THREADS, smem, stream>>>(
      pts, wf, npts, consts, slots, m, scale, tol, nplain, maps, npieces, progs, nprogs, pieces,
      R, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts (npts, 2), wf (npts,), partials (nblocks, R): device f64.  Returns the
// CUDA error code of the launch (0 on success), or the attribute call's
// error (R rows of accumulators need more shared memory than a block may
// have), which is then cleared and nothing is launched;
// cudaErrorInvalidValue for a degree outside 0..10, more than 32 pieces or
// nplain past the degree's members (the wrapper checks all of these first).
extern "C" int fiat_pair_moments(const double* pts, const double* wf, int npts,
                                 const double* consts, double a00, double a01, double a10,
                                 double a11, double b0, double b1, double scale, double tol,
                                 int degree, int nplain, const double* maps, int npieces,
                                 const int* progs, int nprogs, const int* pieces, int R,
                                 double* partials, int nblocks, void* stream) {
  if (npieces > 32 || degree < 0 || nplain > (degree + 1) * (degree + 2) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Affine m{a00, a01, a10, a11, b0, b1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n)                                                                       \
  case n:                                                                                  \
    return launch<n>(pts, wf, npts, consts, m, scale, tol, nplain, maps, npieces, progs,   \
                     nprogs, pieces, R, partials, nblocks, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tetrahedron: pts (npts, 3), slots (pack_stages(degree, sd=3)), the rest
// as above; degree 0..10, cudaErrorInvalidValue outside.
extern "C" int fiat_pair_moments3(const double* pts, const double* wf, int npts,
                                  const double* consts, const int* slots, double a00,
                                  double a01, double a02, double a10, double a11, double a12,
                                  double a20, double a21, double a22, double b0, double b1,
                                  double b2, double scale, double tol, int degree, int nplain,
                                  const double* maps, int npieces, const int* progs, int nprogs,
                                  const int* pieces, int R, double* partials, int nblocks,
                                  void* stream) {
  if (npieces > 32 || degree < 0 || nplain > (degree + 1) * (degree + 2) * (degree + 3) / 6)
    return static_cast<int>(cudaErrorInvalidValue);
  const Affine3 m{{a00, a01, a02, a10, a11, a12, a20, a21, a22}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n)                                                                    \
  case n:                                                                               \
    return launch3<n>(pts, wf, npts, consts, slots, m, scale, tol, nplain, maps, npieces, \
                      progs, nprogs, pieces, R, partials, nblocks, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
