// K6: the f32 throughput engine. For every plain zoo row r and point x,
// out[dst[r], x] = sum_{k < K_r} A[r, k] phi_k(x), in f32, in one launch,
// with the Dubiner recurrence computed inside the kernel.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_tabulate.py:
// PallasZooTabulator._kernel (launched from _apply).  That kernel runs the
// f32 recurrence in VMEM per point tile (the morton gather as a selection
// matmul on the MXU) and contracts the alpha-stacked change of basis with
// it in one HIGHEST-precision MXU product, so the expansion table never
// reaches HBM.  This kernel keeps that fusion: each block computes its
// Phi tile (dubiner2.cuh in float, one point per thread) straight into
// shared memory, and Phi never goes to device memory.  The expansion
// variants ("bubble", "dual") are the same recurrence with other constants;
// the bubble C0 recovery is folded into A on the host, as fiat_tpu does.
// Plain f32 FMAs: no TF32, no tensor cores.
//
// Bound on the card: the store of out (4113 x 1e5 floats = 1.65 GB a
// full_zoo pass at order 1) and the FP32 FMA rate (1.06e10 FMAs a pass over
// the width groups).  Design: K2's (bucket_matmul.cu) in f32:
//   * a block computes Phi[:nexp] for its 256-point tile into shared memory
//     and walks the 64-row tiles of the stacked rows; gridDim.y blocks share
//     a point tile, each taking every gridDim.y-th row tile (the wrapper
//     picks the split that fills the last wave of blocks: 391 point tiles
//     alone are 1.5 waves of the H100's 264 resident blocks);
//   * the rows of all width groups are packed back to back, zero-padded to
//     lda = the widest K, and cut into 64-row tiles, stored transposed
//     (tile, k, row) so a block loads its tile with coalesced reads and
//     conflict-free shared stores; a table gives each tile its first row,
//     row count and contraction width (its widest row);
//   * each thread keeps 8 rows x 8 points of accumulators, reads A and Phi
//     from shared memory as float4, and stores out as float4 with
//     evict-first hints;
//   * dst maps every packed row to its output row, so the output comes out
//     in the caller's layout (alpha-major, zoo row order) with no copy.
// Each output is one sequential FMA chain over k = 0..K-1.
//
// The tetrahedron (sd = 3, degree 0..10) runs the same kernel with the Phi
// tile from dubiner3.cuh in float, each value to its morton row through
// slots[e] (ops/recurrence.py:pack_stages(N, variant, sd=3)), as K1's sd = 3
// stage writes them.  Its Phi tile is larger (165 rows at degree 8: 169 KB
// at 256 points, one block per SM beside a 45 KB A tile); from degree 9 on
// a 256-point tile does not fit a block's 227 KB, so the tile takes 128
// points there (tile_points below; the wrapper sizes the grid from it).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace {

struct Affine {
  float a00, a01, a10, a11, b0, b1;
};

struct Affine3 {
  float a[9], b[3];
};

constexpr int TR = 64;              // rows per tile
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int RI = TR / TY;         // rows per thread (contiguous)
constexpr int TRP = TR + 4;         // padded row stride of the transposed A tile

// points per block: 256, or 128 where a 256-point Phi tile of the
// tetrahedron would not fit shared memory
__host__ __device__ constexpr int tile_points(int sd, int n) {
  return sd == 3 && n >= 9 ? 128 : 256;
}

template <int SD, int N>
struct Members {
  static constexpr int value = SD == 2 ? (N + 1) * (N + 2) / 2 : (N + 1) * (N + 2) * (N + 3) / 6;
};

template <int SD, int N, class Map>
__global__ void __launch_bounds__(TX * TY, 2)
zoo_f32_kernel(const float* __restrict__ pts, int npts, const float* __restrict__ consts,
               const int* __restrict__ slots, Map m, float scale, const float* __restrict__ At,
               int lda, const int* __restrict__ tiles, int ntiles, const int* __restrict__ dst,
               float* __restrict__ out) {
  constexpr int NE = Members<SD, N>::value;
  constexpr int TP = tile_points(SD, N);
  constexpr int PJ4 = TP / (4 * TX);  // float4 point quads per thread
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;              // [NE][TP]: Phi on this block's points
  float* As = smem + NE * TP;    // [lda][TRP]: the current row tile, transposed
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int p0 = blockIdx.x * TP;
  // float4 paths need a whole tile and 16-byte aligned rows of out
  const bool full = (p0 + TP <= npts) && ((npts & 3) == 0) &&
                    ((reinterpret_cast<uintptr_t>(out) & 15) == 0);

  // the Phi tile: one point per thread, each value to its morton row
  if constexpr (SD == 2) {
    const int p = p0 + tid;
    const float px = p < npts ? pts[2 * p] : 0.0f;
    const float py = p < npts ? pts[2 * p + 1] : 0.0f;
    const float x0 = (px * m.a00 + py * m.a01) + m.b0;
    const float x1 = (px * m.a10 + py * m.a11) + m.b1;
    fiat::dubiner2_point<N>(x0, x1, consts, scale, [&](int, int r, int i, float v) {
      Bs[((r + i) * (r + i + 1) / 2 + i) * TP + tid] = v;
    });
  } else if (tid < TP) {
    const int p = p0 + tid;
    const float px = p < npts ? pts[3 * p] : 0.0f;
    const float py = p < npts ? pts[3 * p + 1] : 0.0f;
    const float pz = p < npts ? pts[3 * p + 2] : 0.0f;
    const float x0 = (px * m.a[0] + py * m.a[1] + pz * m.a[2]) + m.b[0];
    const float x1 = (px * m.a[3] + py * m.a[4] + pz * m.a[5]) + m.b[1];
    const float x2 = (px * m.a[6] + py * m.a[7] + pz * m.a[8]) + m.b[2];
    fiat::dubiner3_point<N>(x0, x1, x2, consts, scale, [&](int e, float v) {
      Bs[(N == 0 ? 0 : __ldg(slots + e)) * TP + tid] = v;
    });
  }

  for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int row0 = __ldg(tiles + 3 * t);
    const int nrows = __ldg(tiles + 3 * t + 1);
    const int K = __ldg(tiles + 3 * t + 2);
    __syncthreads();  // Bs written / the previous tile's reads of As done
    const float* At_t = At + static_cast<size_t>(t) * lda * TR;  // [lda][TR]
    for (int e = tid; e < TR * K; e += TX * TY) As[(e / TR) * TRP + e % TR] = At_t[e];
    __syncthreads();

    float4 acc[RI][PJ4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < PJ4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float a[RI];
      float4 b[PJ4];
#pragma unroll
      for (int i = 0; i < RI; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(As + k * TRP + threadIdx.y * RI + i);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < PJ4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + k * TP + 4 * threadIdx.x + 4 * TX * j);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < PJ4; ++j) {
          acc[i][j].x = fmaf(a[i], b[j].x, acc[i][j].x);
          acc[i][j].y = fmaf(a[i], b[j].y, acc[i][j].y);
          acc[i][j].z = fmaf(a[i], b[j].z, acc[i][j].z);
          acc[i][j].w = fmaf(a[i], b[j].w, acc[i][j].w);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = threadIdx.y * RI + i;
      if (r >= nrows) continue;
      float* orow = out + static_cast<size_t>(__ldg(dst + row0 + r)) * npts;
#pragma unroll
      for (int j = 0; j < PJ4; ++j) {
        const int p = p0 + 4 * threadIdx.x + 4 * TX * j;
        if (full) {
          __stcs(reinterpret_cast<float4*>(orow + p), acc[i][j]);
        } else {
          if (p < npts) __stcs(orow + p, acc[i][j].x);
          if (p + 1 < npts) __stcs(orow + p + 1, acc[i][j].y);
          if (p + 2 < npts) __stcs(orow + p + 2, acc[i][j].z);
          if (p + 3 < npts) __stcs(orow + p + 3, acc[i][j].w);
        }
      }
    }
  }
}

template <int SD, int N, class Map>
int launch(const float* pts, int npts, const float* consts, const int* slots, const Map& m,
           float scale, const float* At, int lda, const int* tiles, int ntiles, const int* dst,
           float* out, int splits, cudaStream_t stream) {
  constexpr int TP = tile_points(SD, N);
  const size_t bytes = sizeof(float) * (static_cast<size_t>(Members<SD, N>::value) * TP +
                                        static_cast<size_t>(lda) * TRP);
  const cudaError_t err = cudaFuncSetAttribute(zoo_f32_kernel<SD, N, Map>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  const dim3 blocks((npts + TP - 1) / TP, splits);
  zoo_f32_kernel<SD, N, Map><<<blocks, dim3(TX, TY), bytes, stream>>>(
      pts, npts, consts, slots, m, scale, At, lda, tiles, ntiles, dst, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts: device (npts, 2) f32; At: device (ntiles, lda, 64) f32, every
// 64-row tile of the packed rows transposed and zero-padded to lda = the
// widest K <= nexp(degree); tiles: device int32 (ntiles, 3) = (first row,
// rows <= 64, K <= lda); dst: device int32 (rows,) output row of every
// packed row; out: device (>= max dst + 1, npts) f32; splits: blocks per
// point tile (1 <= splits <= ntiles).  Returns cudaGetLastError() after the
// launch, or the attribute call's error (a tile that needs more shared
// memory than a block may have), which is then cleared and nothing is
// launched; cudaErrorInvalidValue for a degree outside 0..15, lda past the
// degree's members or splits out of range.
extern "C" int fiat_zoo_f32(const float* pts, int npts, const float* consts, float a00,
                            float a01, float a10, float a11, float b0, float b1, float scale,
                            int degree, const float* At, int lda, const int* tiles, int ntiles,
                            const int* dst, float* out, int splits, void* stream) {
  if (degree < 0 || lda > (degree + 1) * (degree + 2) / 2 || splits < 1 || splits > ntiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const Affine m{a00, a01, a10, a11, b0, b1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    return launch<2, n>(pts, npts, consts, nullptr, m, scale, At, lda, tiles, ntiles, dst, out, \
                        splits, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tetrahedron: pts (npts, 3) f32, slots (pack_stages(degree, variant,
// sd=3)), the rest as above, lda at most the degree's members; tp must be
// the kernel's point tile (256, or 128 from degree 9), which the wrapper
// sized the grid and the splits for.  cudaErrorInvalidValue for a degree
// outside 0..10 or a tp that differs.
extern "C" int fiat_zoo3_f32(const float* pts, int npts, const float* consts, const int* slots,
                             float a00, float a01, float a02, float a10, float a11, float a12,
                             float a20, float a21, float a22, float b0, float b1, float b2,
                             float scale, int degree, const float* At, int lda, const int* tiles,
                             int ntiles, const int* dst, float* out, int splits, int tp,
                             void* stream) {
  if (degree < 0 || degree > 10 || lda > (degree + 1) * (degree + 2) * (degree + 3) / 6 ||
      splits < 1 || splits > ntiles || tp != tile_points(3, degree))
    return static_cast<int>(cudaErrorInvalidValue);
  const Affine3 m{{a00, a01, a02, a10, a11, a12, a20, a21, a22}, {b0, b1, b2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n)                                                                        \
  case n:                                                                                   \
    return launch<3, n>(pts, npts, consts, slots, m, scale, At, lda, tiles, ntiles, dst, out, \
                        splits, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
