// K7: the macro (split-complex) elements of a zoo as a masked change of basis
// over the zoo's shared Dubiner basis, in one launch, in f64, on triangles
// and tetrahedra.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMaskedMultiword._masked_kernel (apply_pair_masked), together with its
// two XLA neighbours in _specials_merged: the binning masks before it
// (core/expansions.py:partition_of_unity_masks) and the 1 / cover-count
// multiply after it.  The TPU kernel assembles B = (mask_c * Phi[:nexp_c])_c
// in VMEM through one-hot MXU products and multiplies the whole merged A by
// it in df32 pairs and Ozaki windows, because the TPU has no f64; Hopper
// has native FP64, so none of that is carried over.  For each point x:
//
//   1. the subcell masks of the program (binning.cuh, shared with K3 and
//      K45): mask_c = dist_c <= dist_parent + tol; a unique program (C0
//      basis at order 0) keeps its first hit, every other program averages
//      over its hits, recip = 1 / (number of masks set);
//   2. out[r, x] = recip * sum_{c hit} sum_{k < nexp_c} A[r, off_c + k] Phi[k, x],
//      one FMA chain per output in (c, k) order.  The pieces whose mask is 0
//      add exact zeros to the dense product A @ B, so they are skipped: the
//      result is the dense product summed in the same k order.
//
// Phi is the (nexp, npts) f64 tabulation K1 made for K2, read by prefix
// (no second recurrence).
//
// Bound on the card: the store of out (rows * npts doubles; 632 x 1e5 =
// 0.506 GB on sv_macro_tet).  The work is small next to it: only the pieces a
// point bins into are multiplied (6568 FMAs a point on sv_macro_tet).  What
// limits a plain design is reading A: neighbouring points bin into different
// subcells, so the lanes of a warp read different columns of A.  Design:
//   - the grid is (point tiles of THREADS * SUB points) x (row chunks of at
//     most RC rows of one program); a block stages its chunk of A into shared
//     memory once and walks SUB tiles of THREADS points with it, one thread
//     per point, RC accumulators in registers;
//   - the host lays every chunk out as shared memory holds it (ChunkLayout
//     below): column-major with RCP = RC + 2 doubles per column, each piece
//     ps (odd) columns apart, so one 16-byte load gives a lane two rows of a
//     column, lanes in one subcell read the same address (a broadcast), and
//     lanes in up to 8 different subcells read distinct banks;
//   - Phi[k, x] comes straight from global memory, coalesced across the warp
//     (neighbouring points are neighbouring addresses), once per k;
//   - out is row-major with points contiguous, so every store of a warp is
//     one coalesced row segment.
//
// ChunkLayout (built by fiat_tpu_torch/ops/masked_matmul.py):
//   chunks[5*t + {0..4}]   chunk t: program g, first row, rows (<= RC), offset
//                          of its block in At (in doubles), ps
//   At[offset + (j * ps + k) * RCP + r] = A[first row + r, off_(c0 + j) + k]
//                          for piece j of the program, k < nexp, r < rows;
//                          zeros elsewhere.
// Geometry tables (maps, progs, pieces): binning.cuh.

#include <cuda_runtime.h>

#include <cstddef>

#include "binning.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SUB = 8;      // point tiles per block
constexpr int RC = 32;      // rows per chunk (csrc and masked_matmul.py agree)
constexpr int RCP = RC + 2; // doubles per staged column
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

template <int SD>
__global__ void __launch_bounds__(THREADS)
masked_matmul_kernel(const double* __restrict__ pts, int npts, double tol,
                     const double* __restrict__ maps, const int* __restrict__ progs,
                     const int* __restrict__ pieces, const int* __restrict__ chunks,
                     const double* __restrict__ At, const double* __restrict__ phi,
                     double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* As = reinterpret_cast<double*>(smem_raw);
  const int* ch = chunks + 5 * blockIdx.y;
  const int g = __ldg(ch), row0 = __ldg(ch + 1), nrows = __ldg(ch + 2);
  const int off = __ldg(ch + 3), ps = __ldg(ch + 4);
  const int c0 = __ldg(progs + 5 * g + 2), c1 = __ldg(progs + 5 * g + 3);
  const int unique = __ldg(progs + 5 * g + 4);

  // stage the chunk: (c1 - c0) * ps columns of RCP doubles, 16 bytes a copy
  const int n2 = (c1 - c0) * ps * (RCP / 2);
  const double2* src = reinterpret_cast<const double2*>(At + off);
  double2* dst = reinterpret_cast<double2*>(As);
  for (int i = threadIdx.x; i < n2; i += THREADS) dst[i] = __ldg(src + i);
  __syncthreads();

  const size_t ld = static_cast<size_t>(npts);
  for (int s = 0; s < SUB; ++s) {
    const int p = (blockIdx.x * SUB + s) * THREADS + threadIdx.x;
    if (p >= npts) return;
    double x[SD];
#pragma unroll
    for (int i = 0; i < SD; ++i) x[i] = pts[static_cast<size_t>(SD) * p + i];

    // 1. binning: bit j of mk is the mask of piece c0 + j
    const double best = fiat::parent_bound<SD>(maps, x, tol);
    double recip;
    unsigned mk = fiat::program_rule(fiat::piece_bits<SD>(maps, c0, c1, x, best), unique, recip);

    // 2. the hit pieces' columns times Phi's prefix, one chain per row
    double acc[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[r] = 0.0;
    while (mk) {
      const int j = __ffs(mk) - 1;
      mk &= mk - 1u;
      const int nk = __ldg(pieces + 2 * (c0 + j) + 1);
      const double* Aj = As + static_cast<size_t>(j) * ps * RCP;
      for (int k = 0; k < nk; ++k) {
        const double f = __ldg(phi + static_cast<size_t>(k) * ld + p);
        const double2* a = reinterpret_cast<const double2*>(Aj + k * RCP);
#pragma unroll
        for (int r = 0; r < RC / 2; ++r) {
          const double2 v = a[r];
          acc[2 * r] = fma(v.x, f, acc[2 * r]);
          acc[2 * r + 1] = fma(v.y, f, acc[2 * r + 1]);
        }
      }
    }
    double* o = out + static_cast<size_t>(row0) * ld + p;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r < nrows) o[static_cast<size_t>(r) * ld] = acc[r] * recip;
    }
  }
}

template <int SD>
int launch(const double* pts, int npts, double tol, const double* maps, const int* progs,
           const int* pieces, const int* chunks, int nchunks, const double* At, int smem_doubles,
           const double* phi, double* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_doubles) * sizeof(double);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_matmul_kernel<SD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
  }
  const int per_block = THREADS * SUB;
  const dim3 grid((npts + per_block - 1) / per_block, nchunks);
  masked_matmul_kernel<SD><<<grid, THREADS, smem, stream>>>(pts, npts, tol, maps, progs, pieces,
                                                            chunks, At, phi, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Return the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for sd other than 2 or 3, no chunks, or more chunks
// than a grid's second dimension takes (the wrapper checks all three first).
extern "C" int fiat_masked_matmul(const double* pts, int npts, int sd, double tol,
                                  const double* maps, const int* progs, const int* pieces,
                                  const int* chunks, int nchunks, const double* At,
                                  int smem_doubles, const double* phi, double* out,
                                  void* stream) {
  if (nchunks < 1 || nchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sd) {
    case 2:
      return launch<2>(pts, npts, tol, maps, progs, pieces, chunks, nchunks, At, smem_doubles,
                       phi, out, s);
    case 3:
      return launch<3>(pts, npts, tol, maps, progs, pieces, chunks, nchunks, At, smem_doubles,
                       phi, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
