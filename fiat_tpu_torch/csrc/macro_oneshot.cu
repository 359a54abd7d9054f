// K3: the macro (split-complex) elements of a zoo in one launch, in f64 (the
// f64 engine) or f32 (the f32 engine's macro members), on triangles (sd = 2)
// and tetrahedra (sd = 3): subcell binning, the parent-cell Dubiner
// recurrence, the masked change of basis and the multiplicity average, per
// point.
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
//   1. the subcell masks of every program (binning.cuh, shared with K45 and
//      K7): mask_c = dist_c <= dist_parent + tol; a unique program (C0 basis
//      at order 0) keeps its first hit, every other program averages over
//      its hits, recip = 1 / (number of masks set);
//   2. phi_k(x), k < nexp(N): the parent-cell Dubiner recurrence to degree
//      N (dubiner2.cuh, shared with K1, or dubiner3.cuh);
//   3. out[r, x] = recip[prog(r)] * sum_{c in prog(r)} mask_c(x)
//                    * sum_{k < nexp_c} A[r, off_c + k] phi_k(x).
//
// Triangles.  Bound on the card: the store of out, rows * npts values (63 x
// 1e5 doubles = 50.4 MB for full_zoo's HCT + PS6 at order 1), and the FMA
// chains: each row is one serial chain of up to K FMAs per point (~2.4e3
// FMAs per point on full_zoo; the H100 run measured it latency-bound).
// Design: one thread per point; the merged A (rows x K, 33 KB in f64 on
// full_zoo) sits in shared memory and every thread of a warp reads the
// same element of A at once (a broadcast), the small tables come through
// the read-only cache; the masks are bits of one register; phi stays in
// registers (the degree is a template parameter, so the recurrence and the
// k loop unroll); out is row-major with points contiguous, so every store
// of a warp is one coalesced row segment.
//
// Tetrahedra.  Bound on the card: the store of out again (632 x 1e5
// doubles = 0.506 GB for sv_macro_tet at order 1); the product is 6568 FMAs
// a point (the rows of each program against the one subcell an interior
// point bins into).  Two things of the triangle design do not carry over:
//   - A does not fit shared memory (632 x 288: 1.46 MB in f64).  The grid
//     is (point tiles of THREADS * SUB points) x (row chunks of at most RC
//     rows of one program), as K7's (masked_matmul.cu); a block stages its
//     chunk of the row-major A into shared memory once, transposed into
//     K7's bank-spreading layout (piece j's column k at (j * ps + k) * RCP,
//     ps the program's widest piece rounded up to odd), and walks SUB tiles
//     of THREADS points with it, one thread per point, RC accumulators in
//     registers;
//   - phi does not fit registers (286 values at degree 10).  Each thread
//     runs dubiner3.cuh's recurrence for its point once a tile and writes
//     every value to its member's row of its own column of a Phi tile in
//     shared memory ([member][THREADS], so no thread waits for another and
//     a warp's accesses are consecutive); then, for each piece the point
//     bins into, a k loop (not unrolled) reads phi_k back beside the staged
//     column pair and adds it into the RC accumulators, K7's inner loop.
// The recurrence runs again for every row chunk (21 at order 1 on
// sv_macro_tet): 167 flops a point at degree 3 against the chunk's 32 x 20
// FMAs.  K7 reads the same values from K1's Phi in device memory instead.
// A first version streamed each value of the recurrence straight into the
// accumulators (K45's sd = 3 design, no tile): it unrolled a 32-FMA block
// into every one of up to 286 values and took the library's build from
// 21 s to 85 s on the H100 machine.  The tile costs nexp * THREADS values
// of shared memory (20 KB in f64 at degree 3); the wrapper refuses a chunk
// and tile past a block's 227 KB, which holds a program of 4 subcells to
// degree 6 and one of 12 subcells to degree 4 in f64 (8 and 6 in f32).
//
// A is any change of basis over the pieces' columns whose row ranges the
// program table (sd = 2) or the chunk table (sd = 3) gives: the merged
// tables of every program (tabulation), or one row per program
// (interpolation, whose coefficients fold into A).  Table layouts:
// binning.cuh; chunks[4*t + {0..3}] = chunk t: program, first row, rows
// (<= RC), ps; shared memory (sd = 3): the staged chunk, then the Phi tile
// from offset phi_at (in values, a multiple of 2).

#include <cuda_runtime.h>

#include <cstddef>

#include "binning.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

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

// -- tetrahedra ---------------------------------------------------------------

template <class T>
struct Affine3 {
  T a[9], b[3];
};

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

constexpr int SUB = 8;      // point tiles per block
constexpr int nexp3(int n) { return (n + 1) * (n + 2) * (n + 3) / 6; }
constexpr int RC = 32;      // rows per chunk (ops/macro_oneshot.py CHUNK_ROWS, as K7's)
constexpr int RCP = RC + 2; // values per staged column (COLUMN_STRIDE)

template <int N, class T>
__global__ void __launch_bounds__(THREADS)
macro_oneshot3_kernel(const T* __restrict__ pts, int npts, const T* __restrict__ consts,
                      const int* __restrict__ slots, Affine3<T> m, T scale, T tol,
                      const T* __restrict__ maps, const int* __restrict__ progs,
                      const int* __restrict__ pieces, const int* __restrict__ chunks,
                      int phi_at, const T* __restrict__ A, int K, T* __restrict__ out) {
  using P2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* phi = As + phi_at + threadIdx.x;  // this thread's column: member k at phi[k * THREADS]
  const int* ch = chunks + 4 * blockIdx.y;
  const int g = __ldg(ch), row0 = __ldg(ch + 1), nrows = __ldg(ch + 2), ps = __ldg(ch + 3);
  const int c0 = __ldg(progs + 5 * g + 2), c1 = __ldg(progs + 5 * g + 3);
  const int unique = __ldg(progs + 5 * g + 4);

  // stage the chunk transposed: row r of piece j's column k at (j * ps + k)
  // * RCP + r, zeros past the chunk's rows and the piece's width; the reads
  // run along A's rows
  const int ncols = (c1 - c0) * ps;
  for (int i = threadIdx.x; i < RC * ncols; i += THREADS) {
    const int r = i / ncols, col = i - r * ncols;
    const int j = col / ps, k = col - j * ps;
    const int c = c0 + j;
    T v = T(0);
    if (r < nrows && k < __ldg(pieces + 2 * c + 1))
      v = __ldg(A + static_cast<size_t>(row0 + r) * K + __ldg(pieces + 2 * c) + k);
    As[col * RCP + r] = v;
  }
  __syncthreads();

  const size_t ld = static_cast<size_t>(npts);
  for (int s = 0; s < SUB; ++s) {
    const int p = (blockIdx.x * SUB + s) * THREADS + threadIdx.x;
    if (p >= npts) return;
    const T x[3] = {pts[3 * static_cast<size_t>(p)], pts[3 * static_cast<size_t>(p) + 1],
                    pts[3 * static_cast<size_t>(p) + 2]};

    // 1. binning: bit j of mk is the mask of piece c0 + j
    const T best = fiat::parent_bound<3>(maps, x, tol);
    T recip;
    unsigned mk = fiat::program_rule(fiat::piece_bits<3>(maps, c0, c1, x, best), unique, recip);

    // 2. the parent recurrence into this thread's column of the Phi tile
    if (mk) {
      const T x0 = (x[0] * m.a[0] + x[1] * m.a[1] + x[2] * m.a[2]) + m.b[0];
      const T x1 = (x[0] * m.a[3] + x[1] * m.a[4] + x[2] * m.a[5]) + m.b[1];
      const T x2 = (x[0] * m.a[6] + x[1] * m.a[7] + x[2] * m.a[8]) + m.b[2];
      fiat::dubiner3_point<N>(x0, x1, x2, consts, scale, [&](int e, T v) {
        phi[(N == 0 ? 0 : __ldg(slots + e)) * THREADS] = v;
      });
    }

    // 3. the hit pieces' staged columns times phi's prefix, one chain per row
    T acc[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[r] = T(0);
    while (mk) {
      const int j = __ffs(mk) - 1;
      mk &= mk - 1u;
      const int nk = __ldg(pieces + 2 * (c0 + j) + 1);
      const T* Aj = As + j * ps * RCP;
      for (int k = 0; k < nk; ++k) {
        const T v = phi[k * THREADS];
        const P2* a = reinterpret_cast<const P2*>(Aj + k * RCP);
#pragma unroll
        for (int r = 0; r < RC / 2; ++r) {
          const P2 w = a[r];
          acc[2 * r] = fiat::fma_of(w.x, v, acc[2 * r]);
          acc[2 * r + 1] = fiat::fma_of(w.y, v, acc[2 * r + 1]);
        }
      }
    }
    T* o = out + static_cast<size_t>(row0) * ld + p;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r < nrows) o[static_cast<size_t>(r) * ld] = acc[r] * recip;
    }
  }
}

template <int N, class T>
int launch3(const T* pts, int npts, const T* consts, const int* slots, const Affine3<T>& m,
            T scale, T tol, const T* maps, const int* progs, const int* pieces, const int* chunks,
            int nchunks, int phi_at, const T* A, int K, T* out, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(phi_at) + static_cast<size_t>(nexp3(N)) * THREADS) *
      sizeof(T);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        macro_oneshot3_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
  }
  const int per_block = THREADS * SUB;
  const dim3 grid((npts + per_block - 1) / per_block, nchunks);
  macro_oneshot3_kernel<N, T><<<grid, THREADS, smem, stream>>>(
      pts, npts, consts, slots, m, scale, tol, maps, progs, pieces, chunks, phi_at, A, K, out);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int dispatch3(const T* pts, int npts, const T* consts, const int* slots, const Affine3<T>& m,
              T scale, T tol, int degree, const T* maps, const int* progs, const int* pieces,
              const int* chunks, int nchunks, int phi_at, const T* A, int K, T* out,
              void* stream) {
  if (nchunks < 1 || nchunks > 65535 || phi_at % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define FIAT_CASE(n)                                                                    \
  case n:                                                                               \
    return launch3<n, T>(pts, npts, consts, slots, m, scale, tol, maps, progs, pieces,  \
                         chunks, nchunks, phi_at, A, K, out, s);
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

// The tetrahedron: pts (npts, 3), consts and slots (pack_stages(degree,
// sd=3)), the 3 x 3 map and its shift, A (rows, K) row-major, chunks
// (nchunks, 4), phi_at the largest chunk's staged values (even).  Returns
// the CUDA error code of the launch (0 on success), or the attribute call's
// error (a chunk and the Phi tile need more shared memory than a block may
// have), which is then cleared and nothing is launched;
// cudaErrorInvalidValue for a degree outside 0..10, no chunks, more than a
// grid's second dimension takes, or an odd phi_at (the wrapper checks all
// of these first).
extern "C" int fiat_macro_oneshot3(const double* pts, int npts, const double* consts,
                                   const int* slots, double a00, double a01, double a02,
                                   double a10, double a11, double a12, double a20, double a21,
                                   double a22, double b0, double b1, double b2, double scale,
                                   double tol, int degree, const double* maps, const int* progs,
                                   const int* pieces, const int* chunks, int nchunks,
                                   int phi_at, const double* A, int K, double* out,
                                   void* stream) {
  const Affine3<double> m{{a00, a01, a02, a10, a11, a12, a20, a21, a22}, {b0, b1, b2}};
  return dispatch3<double>(pts, npts, consts, slots, m, scale, tol, degree, maps, progs, pieces,
                           chunks, nchunks, phi_at, A, K, out, stream);
}

extern "C" int fiat_macro_oneshot3_f32(const float* pts, int npts, const float* consts,
                                       const int* slots, float a00, float a01, float a02,
                                       float a10, float a11, float a12, float a20, float a21,
                                       float a22, float b0, float b1, float b2, float scale,
                                       float tol, int degree, const float* maps, const int* progs,
                                       const int* pieces, const int* chunks, int nchunks,
                                       int phi_at, const float* A, int K, float* out,
                                       void* stream) {
  const Affine3<float> m{{a00, a01, a02, a10, a11, a12, a20, a21, a22}, {b0, b1, b2}};
  return dispatch3<float>(pts, npts, consts, slots, m, scale, tol, degree, maps, progs, pieces,
                          chunks, nchunks, phi_at, A, K, out, stream);
}
