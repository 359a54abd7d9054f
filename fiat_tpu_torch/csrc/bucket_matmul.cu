// K2: C_g = A_g @ Phi[:K_g] in f64 for every contraction-width group g,
// in one launch.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMultiwordMatmul._kernel (_combine_core / _combine_core_i8), launched
// once per degree bucket.  That kernel reaches f64 accuracy on the bf16/int8
// MXU with Ozaki windows, group dots and a TwoSum combine.  Hopper has
// native FP64, so this kernel is a plain f64 product.
//
// Bound on the card: the store of C and the FP64 FMA rate.  For the
// Lagrange 1-10 + DG 1-8 zoo at order 1 and 1e5 points, C is 1347 x 1e5
// doubles, 1.08 GB a pass (0.32 ms at 3.35 TB/s), against ~10 GFLOP of FMA
// work (K <= 66; 0.31 ms at 33.5 TFLOP/s).  Design:
//   * one block per 128-point tile keeps Phi[:kmax] for its points in
//     shared memory (loaded once, 66 x 128 doubles) and walks every 64-row
//     tile of the stacked rows, so Phi is read from memory once a pass;
//   * the rows of all groups are packed back to back, zero-padded to
//     lda = kmax columns, and cut into 64-row tiles; a small table gives
//     each tile its first row, row count and contraction width (the widest
//     row in it; the padding columns hold exact zeros, so narrower rows
//     lose nothing and each group still contracts only its own prefix);
//   * each thread keeps 8 rows x 4 points of accumulators, reads A and Phi
//     from shared memory as double2, and stores C as double2 with
//     evict-first hints (the output is streamed, never re-read here).
// Each output is one sequential FMA chain over k = 0..K-1.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TR = 64;          // rows per tile
constexpr int TP = 128;         // points per block
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int RI = TR / TY;     // rows per thread (contiguous)
constexpr int PJ2 = TP / (2 * TX);  // double2 point pairs per thread
constexpr int TRP = TR + 2;     // padded row stride of the transposed A tile

__global__ void __launch_bounds__(TX * TY, 2)
bucket_matmul_kernel(const double* __restrict__ A, int lda, const int* __restrict__ tiles,
                     int ntiles, const double* __restrict__ phi, int ldphi, int npts,
                     double* __restrict__ C) {
  extern __shared__ __align__(16) double smem[];
  const int kmax = lda;
  double* Bs = smem;              // [kmax][TP]: Phi[:kmax] on this block's points
  double* As = smem + kmax * TP;  // [kmax][TRP]: the current row tile, transposed
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int p0 = blockIdx.x * TP;
  // double2 paths need a whole tile and 16-byte aligned rows of Phi and C
  const bool full = (p0 + TP <= npts) && ((npts & 1) == 0) && ((ldphi & 1) == 0) &&
                    ((reinterpret_cast<uintptr_t>(phi) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(C) & 15) == 0);

  if (full) {
    for (int e = tid; e < kmax * TP / 2; e += TX * TY) {
      const int k = e / (TP / 2), p = 2 * (e % (TP / 2));
      *reinterpret_cast<double2*>(Bs + k * TP + p) =
          *reinterpret_cast<const double2*>(phi + static_cast<size_t>(k) * ldphi + p0 + p);
    }
  } else {
    for (int e = tid; e < kmax * TP; e += TX * TY) {
      const int k = e / TP, p = e % TP;
      Bs[k * TP + p] = (p0 + p < npts) ? phi[static_cast<size_t>(k) * ldphi + p0 + p] : 0.0;
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    const int row0 = __ldg(tiles + 3 * t);
    const int nrows = __ldg(tiles + 3 * t + 1);
    const int K = __ldg(tiles + 3 * t + 2);
    __syncthreads();  // Bs loaded / the previous tile's reads of As done
    for (int e = tid; e < TR * K; e += TX * TY) {
      const int r = e / K, k = e % K;
      As[k * TRP + r] = (r < nrows) ? A[static_cast<size_t>(row0 + r) * lda + k] : 0.0;
    }
    __syncthreads();

    double2 acc[RI][PJ2];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < PJ2; ++j) acc[i][j] = make_double2(0.0, 0.0);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      double a[RI];
      double2 b[PJ2];
#pragma unroll
      for (int i = 0; i < RI; i += 2) {
        const double2 v = *reinterpret_cast<const double2*>(As + k * TRP + threadIdx.y * RI + i);
        a[i] = v.x;
        a[i + 1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < PJ2; ++j)
        b[j] = *reinterpret_cast<const double2*>(Bs + k * TP + 2 * threadIdx.x + 2 * TX * j);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < PJ2; ++j) {
          acc[i][j].x = fma(a[i], b[j].x, acc[i][j].x);
          acc[i][j].y = fma(a[i], b[j].y, acc[i][j].y);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = threadIdx.y * RI + i;
      if (r >= nrows) continue;
      double* crow = C + static_cast<size_t>(row0 + r) * npts;
#pragma unroll
      for (int j = 0; j < PJ2; ++j) {
        const int p = p0 + 2 * threadIdx.x + 2 * TX * j;
        if (full) {
          __stcs(reinterpret_cast<double2*>(crow + p), acc[i][j]);
        } else {
          if (p < npts) __stcs(crow + p, acc[i][j].x);
          if (p + 1 < npts) __stcs(crow + p + 1, acc[i][j].y);
        }
      }
    }
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for contraction width kmax.
extern "C" size_t fiat_bucket_matmul_smem(int kmax) {
  return sizeof(double) * static_cast<size_t>(kmax) * (TP + TRP);
}

// A: device (rows, lda) f64, zero-padded to lda = the widest K; tiles:
// device int32 (ntiles, 3) = (first row, rows <= 64, K <= lda); phi: device
// (>= lda, ldphi) f64; C: device (rows, npts) f64.  Returns
// cudaGetLastError() after the launch, or the attribute call's error (a
// contraction width whose tile needs more shared memory than a block may
// have), which is then cleared and nothing is launched.
extern "C" int fiat_bucket_matmul(const double* A, int lda, const int* tiles, int ntiles,
                                  const double* phi, int ldphi, int npts, double* C,
                                  void* stream) {
  const size_t bytes = fiat_bucket_matmul_smem(lda);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  const int blocks = (npts + TP - 1) / TP;
  bucket_matmul_kernel<<<blocks, dim3(TX, TY), bytes, static_cast<cudaStream_t>(stream)>>>(
      A, lda, tiles, ntiles, phi, ldphi, npts, C);
  return static_cast<int>(cudaGetLastError());
}
