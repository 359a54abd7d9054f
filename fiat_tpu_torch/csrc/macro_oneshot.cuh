// K3's kernel template and its launch (csrc/macro_oneshot.cu has the
// design note and the C entry points).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "binning.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace fiat::k3 {

constexpr int THREADS = 128;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr int MAX_SUB = 8;  // point tiles a block may walk
constexpr int RC_TABLES = 32;  // rows per chunk (ops/macro_oneshot.py CHUNK_ROWS, as K7's)
constexpr int RC_ONE = 1;      // one row per program (ONE_ROW_CHUNK)
constexpr int ROW_GROUP = 8;   // rows a chunk skips at a time past its last row

// values per staged column (ops/macro_oneshot.py column_stride): an even
// stride past RC keeps 16-byte pairs aligned and spreads the pieces' columns
// over the banks; a one-row chunk is read one value at a time
__host__ __device__ constexpr int column_stride(int rc) { return rc > 1 ? rc + 2 : 1; }
__host__ __device__ constexpr int nexp_of(int sd, int n) {
  return sd == 2 ? (n + 1) * (n + 2) / 2 : (n + 1) * (n + 2) * (n + 3) / 6;
}

template <class T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// The launch's arguments.  affine holds the SD x SD map onto the default
// simplex row-major, then its shift (SD * SD + SD values of the 12).  Block
// row y takes the chunks [y * cpb, min((y + 1) * cpb, nchunks)).
template <class T>
struct Params {
  const T* pts;
  int npts;
  const T* consts;
  const int* slots;
  T affine[12];
  T scale, tol;
  const T* maps;
  const int* progs;
  const int* pieces;
  const int* chunks;
  int nchunks, cpb, sub, phi_at;
  const T* A;
  int K;
  T* out;
};

// One chunk of the table: its program's pieces [c0, c1), rows and layout.
struct Chunk {
  int row0, nrows, ps, c0, c1, unique;
};

__device__ __forceinline__ Chunk chunk_at(const int* __restrict__ chunks,
                                          const int* __restrict__ progs, int t) {
  const int* ch = chunks + 4 * t;
  const int g = __ldg(ch);
  return {__ldg(ch + 1), __ldg(ch + 2), __ldg(ch + 3), __ldg(progs + 5 * g + 2),
          __ldg(progs + 5 * g + 3), __ldg(progs + 5 * g + 4)};
}

template <int SD, int N, int RC, class T>
__global__ void __launch_bounds__(THREADS) macro_oneshot_kernel(const Params<T> q) {
  using P2 = typename Pair<T>::type;
  constexpr int RCP = column_stride(RC);
  constexpr int G = RC < ROW_GROUP ? RC : ROW_GROUP;
  // one-row chunks: unrolled k steps, so the loads of one run ahead of the
  // FMA chain of another
  constexpr int K_UNROLL = RC == 1 ? 4 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* phi = As + q.phi_at + threadIdx.x;  // this thread's column: member k at phi[k * THREADS]
  const int t0 = blockIdx.y * q.cpb;
  const int t1 = min(t0 + q.cpb, q.nchunks);
  const Chunk first = chunk_at(q.chunks, q.progs, t0);

  // stage the block's chunks one after another, each transposed: row r of
  // piece j's column k at (j * ps + k) * RCP + r, a thread a column; the
  // rows past the chunk's and the columns past a piece's width are never
  // read, so they are left as they are
  for (int t = t0, at = 0; t < t1; ++t) {
    const Chunk c = t == t0 ? first : chunk_at(q.chunks, q.progs, t);
    const int ncols = (c.c1 - c.c0) * c.ps;
    for (int col = threadIdx.x; col < ncols; col += THREADS) {
      const int j = col / c.ps, k = col - j * c.ps;
      const int pc = c.c0 + j;
      if (k < __ldg(q.pieces + 2 * pc + 1)) {
        const T* src = q.A + static_cast<size_t>(c.row0) * q.K + __ldg(q.pieces + 2 * pc) + k;
        T* dst = As + at + col * RCP;
#pragma unroll 8
        for (int r = 0; r < c.nrows; ++r) dst[r] = __ldg(src + static_cast<size_t>(r) * q.K);
      }
    }
    at += ncols * RCP;
  }

  const size_t ld = static_cast<size_t>(q.npts);
  for (int s = 0; s < q.sub; ++s) {
    const int p = (blockIdx.x * q.sub + s) * THREADS + threadIdx.x;
    const bool live = p < q.npts;
    T x[SD], best = T(0);
    if (live) {
#pragma unroll
      for (int i = 0; i < SD; ++i) x[i] = q.pts[static_cast<size_t>(SD) * p + i];

      // 1. the parent recurrence into this thread's column of the Phi tile,
      //    once for every chunk of the block
      T y[SD];
#pragma unroll
      for (int i = 0; i < SD; ++i) {
        T v = x[0] * q.affine[SD * i];
#pragma unroll
        for (int j = 1; j < SD; ++j) v += x[j] * q.affine[SD * i + j];
        y[i] = v + q.affine[SD * SD + i];
      }
      if constexpr (SD == 2) {
        fiat::dubiner2_point<N>(y[0], y[1], q.consts, q.scale, [&](int, int r, int i, T v) {
          phi[((r + i) * (r + i + 1) / 2 + i) * THREADS] = v;
        });
      } else {
        fiat::dubiner3_point<N>(y[0], y[1], y[2], q.consts, q.scale, [&](int e, T v) {
          phi[(N == 0 ? 0 : __ldg(q.slots + e)) * THREADS] = v;
        });
      }
      best = fiat::parent_bound<SD>(q.maps, x, q.tol);
    }
    // the staged chunks, waited for once the first tile's recurrence has run
    // beside their loads
    if (s == 0) __syncthreads();
    if (!live) return;

    for (int t = t0, at = 0; t < t1; ++t) {
      const Chunk c = t == t0 ? first : chunk_at(q.chunks, q.progs, t);
      // 2. binning against the chunk's program: bit j of mk is the mask of
      //    piece c0 + j
      T recip;
      unsigned mk =
          fiat::program_rule(fiat::piece_bits<SD>(q.maps, c.c0, c.c1, x, best), c.unique, recip);

      // 3. the hit pieces' staged columns times phi's prefix, one chain per
      //    row; a group of G rows past the chunk's last row is skipped (the
      //    test is the same for the whole block), so a short tail chunk pays
      //    for its rows rounded up to G, not for RC
      T acc[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[r] = T(0);
      while (mk) {
        const int j = __ffs(mk) - 1;
        mk &= mk - 1u;
        const int nk = __ldg(q.pieces + 2 * (c.c0 + j) + 1);
        const T* Aj = As + at + j * c.ps * RCP;
#pragma unroll(K_UNROLL)
        for (int k = 0; k < nk; ++k) {
          const T v = phi[k * THREADS];
#pragma unroll
          for (int r0 = 0; r0 < RC; r0 += G) {
            if (r0 > 0 && r0 >= c.nrows) break;
            if constexpr (G % 2 == 0) {
              const P2* a = reinterpret_cast<const P2*>(Aj + k * RCP + r0);
#pragma unroll
              for (int r = 0; r < G / 2; ++r) {
                const P2 w = a[r];
                acc[r0 + 2 * r] = fiat::fma_of(w.x, v, acc[r0 + 2 * r]);
                acc[r0 + 2 * r + 1] = fiat::fma_of(w.y, v, acc[r0 + 2 * r + 1]);
              }
            } else {
#pragma unroll
              for (int r = 0; r < G; ++r)
                acc[r0 + r] = fiat::fma_of(Aj[k * RCP + r0 + r], v, acc[r0 + r]);
            }
          }
        }
      }
      T* o = q.out + static_cast<size_t>(c.row0) * ld + p;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < c.nrows) o[static_cast<size_t>(r) * ld] = acc[r] * recip;
      }
      at += (c.c1 - c.c0) * c.ps * RCP;
    }
  }
}

template <int SD, int N, int RC, class T>
int launch(const Params<T>& q, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(q.phi_at) + static_cast<size_t>(nexp_of(SD, N)) * THREADS) * sizeof(T);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err =
        cudaFuncSetAttribute(macro_oneshot_kernel<SD, N, RC, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
  }
  const int per_block = THREADS * q.sub;
  const dim3 grid((q.npts + per_block - 1) / per_block, (q.nchunks + q.cpb - 1) / q.cpb);
  macro_oneshot_kernel<SD, N, RC, T><<<grid, THREADS, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int SD, int RC, class T>
int by_degree(const Params<T>& q, int degree, cudaStream_t s) {
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    return launch<SD, n, RC, T>(q, s);
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
#undef FIAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Each source instantiates its share of (SD, RC, T), so nvcc builds them
// in parallel: macro_oneshot.cu the f64 tables, macro_oneshot_f32.cu the
// f32 tables, macro_oneshot_one.cu one row per program in both types.
#define FIAT_K3_FAMILIES(X)                                                   \
  X(2, RC_TABLES, double) X(3, RC_TABLES, double) X(2, RC_TABLES, float)     \
  X(3, RC_TABLES, float) X(2, RC_ONE, double) X(3, RC_ONE, double)           \
  X(2, RC_ONE, float) X(3, RC_ONE, float)
#define FIAT_K3_EXTERN(SD, RC, T) \
  extern template int by_degree<SD, RC, T>(const Params<T>&, int, cudaStream_t);
#define FIAT_K3_INSTANTIATE(SD, RC, T) \
  template int by_degree<SD, RC, T>(const Params<T>&, int, cudaStream_t);
FIAT_K3_FAMILIES(FIAT_K3_EXTERN)

}  // namespace fiat::k3
