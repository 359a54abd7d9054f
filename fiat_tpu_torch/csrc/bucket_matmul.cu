// K2: C_g = A_g @ Phi[:K_g] in f64 for every contraction-width group g,
// in one launch.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMultiwordMatmul._kernel (_combine_core / _combine_core_i8), launched
// once per degree bucket.  That kernel reaches f64 accuracy on the bf16/int8
// MXU with Ozaki windows, group dots and a TwoSum combine.  Hopper has
// native FP64, so this kernel is a plain f64 product.
//
// Bound on the card: the store of C or the FP64 FMA rate, by contraction
// width.  For full_zoo at order 1 and 1e5 points, C is 4113 x 1e5 doubles,
// 3.29 GB a pass (0.98 ms at 3.35 TB/s), against 21.1 GFLOP (K <= 66; 0.63
// ms at 33.5 TFLOP/s): store-bound.  For tet_lagrange8 (K = 165) C is 660 x
// 1e5 (0.53 GB, 0.16 ms) against 21.8 GFLOP (0.65 ms): FMA-bound, where
// cuBLAS's DGEMM, which has the FP64 tensor cores, is about twice as fast
// (PERF.md).  Design:
//   * one block per TP-point tile keeps Phi[:kmax] for its points in
//     shared memory (loaded once) and walks every 64-row tile of the
//     stacked rows, so Phi is read from memory once a pass;
//   * the rows of all groups are packed back to back, zero-padded to
//     kmax columns, and cut into 64-row tiles, which the host stores
//     transposed, (tile, k, row); a small table gives each tile its first
//     row, row count and contraction width (the widest row in it; the
//     padding holds exact zeros, so narrower rows lose nothing and each
//     group still contracts only its own prefix);
//   * the row tile goes through shared memory in chunks of kc columns,
//     copied with cp.async (16 bytes a thread, all in flight at once, no
//     register staging), the accumulators staying in registers across
//     the chunks.
//     Up to kmax = 151 one chunk holds the whole tile (kc = kmax); wider
//     contractions (the tetrahedron's 165 at degree 8) cut the A tile, not
//     the point tile, so a block still reuses each A value over 128 points
//     and each Phi value over 8 rows of a thread, which keeps the
//     shared-memory loads below the FP64 FMA issue rate.  Only past kmax
//     219, where Phi[:kmax] for 128 points no longer leaves room for a
//     16-column chunk, does the point tile halve to 64 (up to kmax 438);
//   * each thread keeps 8 rows x TP/32 points of accumulators, reads A and
//     Phi from shared memory as double2, and stores C as double2 with
//     evict-first hints (the output is streamed, never re-read here).
// Each output is one sequential FMA chain over k = 0..K-1.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int TR = 64;          // rows per tile
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int RI = TR / TY;     // rows per thread (contiguous)
constexpr int KC_MIN = 16;      // narrowest A chunk worth a pair of barriers
// shared memory a block may take on sm_90 (the only target this builds for)
constexpr size_t SMEM_MAX = 232448;

template <int TP>
__global__ void __launch_bounds__(TX * TY, 2)
bucket_matmul_kernel(const double* __restrict__ At, int kmax, int kc,
                     const int* __restrict__ tiles, int ntiles,
                     const double* __restrict__ phi, int ldphi, int npts,
                     double* __restrict__ C) {
  constexpr int PJ2 = TP / (2 * TX);  // double2 point pairs per thread
  extern __shared__ __align__(16) double smem[];
  double* Bs = smem;              // [kmax][TP]: Phi[:kmax] on this block's points
  double* As = smem + kmax * TP;  // [kc][TR]: a chunk of the current row tile, transposed
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
    const double* At_t = At + static_cast<size_t>(t) * kmax * TR;

    double2 acc[RI][PJ2];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < PJ2; ++j) acc[i][j] = make_double2(0.0, 0.0);

    for (int k0 = 0; k0 < K; k0 += kc) {
      const int kn = min(kc, K - k0);
      __syncthreads();  // Bs loaded / the previous chunk's reads of As done
      const double* src = At_t + static_cast<size_t>(k0) * TR;
      for (int e = tid; e < kn * TR / 2; e += TX * TY)
        __pipeline_memcpy_async(As + 2 * e, src + 2 * e, 16);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();

      const double* Bk = Bs + k0 * TP;
#pragma unroll 2
      for (int k = 0; k < kn; ++k) {
        double a[RI];
        double2 b[PJ2];
#pragma unroll
        for (int i = 0; i < RI; i += 2) {
          const double2 v =
              *reinterpret_cast<const double2*>(As + k * TR + threadIdx.y * RI + i);
          a[i] = v.x;
          a[i + 1] = v.y;
        }
#pragma unroll
        for (int j = 0; j < PJ2; ++j)
          b[j] = *reinterpret_cast<const double2*>(Bk + k * TP + 2 * threadIdx.x + 2 * TX * j);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < PJ2; ++j) {
            acc[i][j].x = fma(a[i], b[j].x, acc[i][j].x);
            acc[i][j].y = fma(a[i], b[j].y, acc[i][j].y);
          }
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

// Shared memory of a block: Phi[:kmax] for tp points and a kc-column A chunk.
size_t smem_bytes(int kmax, int tp, int kc) {
  return sizeof(double) * (static_cast<size_t>(kmax) * tp + static_cast<size_t>(kc) * TR);
}

// The point tile and A chunk for contraction width kmax: the whole A tile
// where it fits beside Phi, else the widest chunk of at least KC_MIN
// columns; 128 points first, then 64.  Returns false past kmax 438.
bool plan(int kmax, int* tp, int* kc) {
  for (int t : {128, 64}) {
    if (smem_bytes(kmax, t, kmax) <= SMEM_MAX) {
      *tp = t;
      *kc = kmax;
      return true;
    }
    const size_t phi_bytes = smem_bytes(kmax, t, 0);
    if (phi_bytes < SMEM_MAX) {
      const int c = static_cast<int>((SMEM_MAX - phi_bytes) / (sizeof(double) * TR)) & ~1;
      if (c >= KC_MIN) {
        *tp = t;
        *kc = c;
        return true;
      }
    }
  }
  return false;
}

template <int TP>
int launch(const double* At, int kmax, int kc, const int* tiles, int ntiles, const double* phi,
           int ldphi, int npts, double* C, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kmax, TP, kc);
  cudaError_t err = cudaFuncSetAttribute(bucket_matmul_kernel<TP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  const int blocks = (npts + TP - 1) / TP;
  bucket_matmul_kernel<TP><<<blocks, dim3(TX, TY), bytes, stream>>>(At, kmax, kc, tiles, ntiles,
                                                                    phi, ldphi, npts, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// At: device (ntiles, kmax, 64) f64, every 64-row tile of the stacked rows
// transposed and zero-padded to kmax = the widest K; tiles: device int32
// (ntiles, 3) = (first row, rows <= 64, K <= kmax); phi: device (>= kmax,
// ldphi) f64; C: device (rows, npts) f64.  Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue, launching nothing, for a
// contraction width whose Phi tile leaves no room for an A chunk in a
// block's shared memory (kmax > 438).
extern "C" int fiat_bucket_matmul(const double* At, int kmax, const int* tiles, int ntiles,
                                  const double* phi, int ldphi, int npts, double* C,
                                  void* stream) {
  int tp = 0, kc = 0;
  if (!plan(kmax, &tp, &kc)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tp == 128 ? launch<128>(At, kmax, kc, tiles, ntiles, phi, ldphi, npts, C, s)
                   : launch<64>(At, kmax, kc, tiles, ntiles, phi, ldphi, npts, C, s);
}
