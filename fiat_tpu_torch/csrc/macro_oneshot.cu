// K3: the macro (split-complex) elements of a zoo in one launch, in f64 (the
// f64 engine) or f32 (the f32 engine's macro members), on triangles (SD = 2)
// and tetrahedra (SD = 3): subcell binning, the parent-cell Dubiner
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
// For each point x and each program g:
//
//   1. the subcell masks of g (binning.cuh, shared with K45 and K7):
//      mask_c = dist_c <= dist_parent + tol; a unique program (C0 basis at
//      order 0) keeps its first hit, every other program averages over its
//      hits, recip = 1 / (number of masks set);
//   2. phi_k(x), k < nexp(N): the parent-cell Dubiner recurrence to degree
//      N (dubiner2.cuh, shared with K1, or dubiner3.cuh);
//   3. out[r, x] = recip * sum_{c in g, mask_c(x)} sum_{k < nexp_c}
//                    A[r, off_c + k] phi_k(x)   for the rows r of g.
//
// Bound on the card: the store of out (rows * npts values: 198 x 1e5
// doubles = 158 MB on c1_macro_hessians, 632 x 1e5 = 0.506 GB on
// sv_macro_tet).  The product is small next to it once only the subcell a
// point falls in is multiplied (1476 FMAs a point on c1_macro_hessians,
// 6568 on sv_macro_tet); a design that multiplies every subcell and then
// drops it by the mask does 6.3x that on c1_macro_hessians.  Design, one
// kernel for both cells (K7's, masked_matmul.cu, with its own recurrence):
//   - the grid is (point tiles of THREADS * sub points) x (groups of cpb row
//     chunks, each at most RC rows of one program, ops/macro_oneshot.py:
//     chunk_table); a block stages its chunks of the row-major A into shared
//     memory once, transposed into K7's bank-spreading layout (piece j's
//     column k at (j * ps + k) * RCP, ps the program's widest piece rounded
//     up to odd), and walks `sub` tiles of THREADS points with them, one
//     thread per point.  A has no size limit: only a block's chunks sit in
//     shared memory.  The loads of the staging run beside the first tile's
//     recurrence, which needs no shared A;
//   - phi does not fit registers on tetrahedra (286 values at degree 10):
//     each thread runs the recurrence for its point once a tile and writes
//     every value to its member's row of its own column of a Phi tile in
//     shared memory ([member][THREADS], so no thread waits for another and a
//     warp's accesses are consecutive), on triangles too (66 values at
//     degree 10; a k loop over registers would have to unroll to nexp);
//   - each point is binned against each chunk's program only (so a zoo may
//     have any number of subcells, at most 32 a program: a program's masks
//     are the bits of one word), and for each
//     piece it falls in (and only those) a k loop reads phi_k back beside
//     the staged column and adds it into RC independent accumulators, so no
//     row waits on another's FMA chain; the groups of 8 rows past a chunk's
//     last row are skipped, so a tail chunk of 4 rows costs 8, not 32;
//   - out is row-major with points contiguous, so every store of a warp is
//     one coalesced row segment.
// The tables take one chunk a block, so the recurrence runs again for every
// row chunk (8 at order 2 on the C1 zoo, 21 at order 1 on sv_macro_tet): 45
// flops a point at degree 3 on a triangle, 167 on a tetrahedron, against a
// chunk's 32 x 10 FMAs; fewer blocks of more chunks measured slower on the
// H100.  A first sd = 3 version streamed each value of the recurrence
// straight into the accumulators (no tile): it unrolled a 32-FMA block into
// every one of up to 286 values and took the library's build from 21 s to
// 85 s on the H100 machine.  The tile costs nexp * THREADS values of shared
// memory (20 KB in f64 at tet degree 3); the wrapper refuses a chunk and
// tile past a block's 227 KB, which holds a tet program of 4 subcells to
// degree 6 and one of 12 subcells to degree 4 in f64 (8 and 6 in f32), and
// a triangle program of 12 subcells to degree 8 (10 in f32).
//
// Two chunk heights are instantiated: RC = 32 for the tables, and RC = 1 for
// one row per program (interpolation, whose coefficients fold into A), where
// 32 accumulators would carry 31 rows of padding; there a block takes every
// program's chunk, so the recurrence runs once a point.  The kernel template
// is in macro_oneshot.cuh; this source instantiates the f64 tables and holds
// the C entry points, macro_oneshot_f32.cu and macro_oneshot_one.cu
// instantiate the rest, so that nvcc builds the three in parallel (all 88 in
// one source took 52.1 s on the H100 machine).
//
// A is any change of basis over the pieces' columns whose row ranges the
// chunk table gives: the merged tables of every program (tabulation), or
// one row per program (interpolation).  Table layouts: binning.cuh;
// chunks[4*t + {0..3}] = chunk t: program, first row, rows (<= RC), ps;
// shared memory: the block's staged chunks one after another, then the Phi
// tile from offset phi_at (in values, a multiple of 2).

#include "macro_oneshot.cuh"

namespace fiat::k3 {

FIAT_K3_INSTANTIATE(2, RC_TABLES, double)
FIAT_K3_INSTANTIATE(3, RC_TABLES, double)

}  // namespace fiat::k3

namespace {

using namespace fiat::k3;

template <class T>
int dispatch(const T* pts, int npts, int sd, const T* consts, const int* slots,
             const T* affine, T scale, T tol, int degree, const T* maps, const int* progs,
             const int* pieces, const int* chunks, int nchunks, int rc, int cpb, int sub,
             int phi_at, const T* A, int K, T* out, void* stream) {
  if (nchunks < 1 || cpb < 1 || (nchunks + cpb - 1) / cpb > 65535 || phi_at % 2 || sub < 1 ||
      sub > MAX_SUB)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> q{pts, npts, consts, slots, {}, scale, tol, maps, progs, pieces, chunks,
              nchunks, cpb, sub, phi_at, A, K, out};
  for (int i = 0; i < 12; ++i) q.affine[i] = affine[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sd == 2 && rc == RC_TABLES) return by_degree<2, RC_TABLES, T>(q, degree, s);
  if (sd == 2 && rc == RC_ONE) return by_degree<2, RC_ONE, T>(q, degree, s);
  if (sd == 3 && rc == RC_TABLES) return by_degree<3, RC_TABLES, T>(q, degree, s);
  if (sd == 3 && rc == RC_ONE) return by_degree<3, RC_ONE, T>(q, degree, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// pts (npts, sd), sd 2 or 3; consts and slots (pack_stages(degree, sd=sd));
// affine: the 12 values the wrapper packs (the sd x sd map row-major, its
// shift, zeros after); maps, progs, pieces: binning.cuh; chunks (nchunks,
// 4) of height at most rc (32, or 1 for one row per program), cpb of them
// a block; sub point tiles a block (1..8); phi_at the staged values of the
// largest group of cpb chunks (even); A (rows, K) row-major; out (rows,
// npts).  Returns the CUDA error code of the launch (0 on success), or the
// attribute call's error (the staged chunks and the Phi tile need more
// shared memory than a block may have), which is then cleared and nothing
// is launched; cudaErrorInvalidValue for an sd, rc or degree it is not
// instantiated for (degree 0..10), no chunks, more groups than a grid's
// second dimension takes, sub outside 1..8 or an odd phi_at (the wrapper
// checks all of these first).
extern "C" int fiat_macro_oneshot(const double* pts, int npts, int sd, const double* consts,
                                  const int* slots, const double* affine, double scale,
                                  double tol, int degree, const double* maps, const int* progs,
                                  const int* pieces, const int* chunks, int nchunks, int rc,
                                  int cpb, int sub, int phi_at, const double* A, int K,
                                  double* out, void* stream) {
  return dispatch<double>(pts, npts, sd, consts, slots, affine, scale, tol, degree, maps, progs,
                          pieces, chunks, nchunks, rc, cpb, sub, phi_at, A, K, out, stream);
}

extern "C" int fiat_macro_oneshot_f32(const float* pts, int npts, int sd, const float* consts,
                                      const int* slots, const float* affine, float scale,
                                      float tol, int degree, const float* maps, const int* progs,
                                      const int* pieces, const int* chunks, int nchunks, int rc,
                                      int cpb, int sub, int phi_at, const float* A, int K,
                                      float* out, void* stream) {
  return dispatch<float>(pts, npts, sd, consts, slots, affine, scale, tol, degree, maps, progs,
                         pieces, chunks, nchunks, rc, cpb, sub, phi_at, A, K, out, stream);
}
