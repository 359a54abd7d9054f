// K3: the macro (split-complex) elements of a zoo in one launch, in f64 (the
// f64 engine) or f32 (the f32 engine's macro members), on triangles (SD = 2)
// and tetrahedra (SD = 3): subcell binning, the parent-cell Dubiner
// recurrence, the masked change of basis and the multiplicity average, per
// point.  The interval (SD = 1: the split interval elements, iso(k) and
// Alfeld) runs the same template on dubiner1.cuh's recurrence and binning.cuh
// at SD = 1 (macro_oneshot_1.cu instantiates it, to degree 15).
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
// kernel for both parents and both chunk heights:
//   - the grid is one dimension: (groups of row chunks, each chunk at most
//     RC rows of one program, ops/macro_oneshot.py chunk_table) x (blocks of
//     `sub` point tiles of tp points, a thread a point), so neither the
//     chunks nor the points meet a grid limit short of 2^31 blocks.  The
//     tables take one chunk a group; one row per program takes every
//     program's chunk in one group, so the recurrence runs once a point;
//   - a group's chunks are cut into slices, runs of k over every piece of
//     the chunk's program, laid out as shared memory holds them (K7's
//     layout, csrc/masked_matmul.cu: column k * P + j for piece j of P,
//     column_stride(RC) values a column, so one 16-byte load gives a thread
//     two rows of a column and threads in up to 8 different subcells read
//     distinct banks), each slice one contiguous block of At padded to 16
//     bytes.  The host plan (MacroOneShot.plan_for) keeps a group's whole
//     chunks resident when they fit beside the Phi tile (each chunk one
//     slice, the group's span of At copied by every thread's 16-byte loads
//     once a block and read by every tile of it, as the staged chunks of
//     the earlier design were), and else streams them through a ring of
//     2-4 buffers of slices of about 17 KB, each brought in by one bulk copy
//     (cp.async.bulk, bulk_copy.cuh) on an mbarrier: each warp done
//     with a buffer arrives on its "empty" mbarrier, and the last of them (a
//     counter elects it) refills it with the slice `stages` visits ahead, as
//     K2, K6 and K7 do.  So no chunk has to fit in shared memory: only the
//     Phi tile and the ring; a block holds 128 points, but 64 on
//     tetrahedra from degree 9 in f64, whose Phi tile of 128 points would
//     not fit alone (286 members x 128 points is 293 KB at degree 10).  On
//     the H100 the resident plan timed fastest where its block takes at
//     most a quarter of an SM's shared memory, and past that a ring of two
//     buffers of ~17 KB slices (PERF.md section 6);
//   - phi does not fit registers on tetrahedra (286 values at degree 10):
//     each thread runs the recurrence for its point once a tile and writes
//     every value to its member's row of its own column of a Phi tile in
//     shared memory ([member][tp], so no thread waits for another and a
//     warp's accesses are consecutive), on triangles too (66 values at
//     degree 10; a k loop over registers would have to unroll to nexp);
//   - each point is binned against each chunk's program only, word by word
//     (binning.cuh: 32 subcells a word, so a program may have any number),
//     into the thread's own column of the mask words in shared memory, since
//     a chunk's slices come one after another and a register array cannot be
//     indexed by word.  The rule needs all of a program's words before its
//     factor is known (1 / hits over the whole program), and the factor
//     multiplies the finished sums only, so one pass of the distances
//     serves: no counting pass, no second binning;
//   - for each piece the point falls in (and only those) a k loop reads
//     phi_k back beside the slice's column and adds it into RC independent
//     accumulators, so no row waits on another's FMA chain; the groups of 8
//     rows past a chunk's last row are skipped, so a tail chunk of 4 rows
//     costs 8, not 32.  A point inside one subcell gets its pieces' k in
//     increasing order under any plan; a tie point gets its pieces in (c,
//     k) order where a slice holds a whole chunk, and interleaved by runs of
//     k otherwise;
//   - out is row-major with points contiguous, so every store of a warp is
//     one coalesced row segment;
//   - past the unrolled degrees (0..15 on the interval, 0..10 on triangles
//     and tetrahedra) a generic instantiation per (SD, RC, T) takes the
//     degree and the point tile (128, 64 or 32) at the launch, so that a
//     high degree's Phi tile fits: triangle degree 20 at 64 points in f64
//     (116 KB), tet degree 14 at 32 points in f64 (174 KB) or 64 in f32
//     (174 KB).  It runs the streaming recurrence of dubiner*_point_n.
// The tables take one chunk a group, so the recurrence runs again for every
// row chunk (8 at order 2 on the C1 zoo, 21 at order 1 on sv_macro_tet): 45
// flops a point at degree 3 on a triangle, 167 on a tetrahedron, against a
// chunk's 32 x 10 FMAs; fewer blocks of more chunks measured slower on the
// H100.  A first sd = 3 version streamed each value of the recurrence
// straight into the accumulators (no tile): it unrolled a 32-FMA block into
// every one of up to 286 values and took the library's build from 21 s to
// 85 s on the H100 machine.
//
// Two chunk heights are instantiated: RC = 32 for the tables, and RC = 1 for
// one row per program (interpolation, whose coefficients fold into A), where
// 32 accumulators would carry 31 rows of padding.  The kernel template is
// in macro_oneshot.cuh; this source instantiates the f64 tables and holds
// the C entry points, macro_oneshot_f32.cu and macro_oneshot_one.cu
// instantiate the rest, so that nvcc builds the three in parallel (all 88 in
// one source took 52.1 s on the H100 machine).
//
// A is any change of basis over the pieces' columns whose row ranges the
// chunk table gives: the merged tables of every program (tabulation), or
// one row per program (interpolation: the call's A, which a resident
// group gathers into shared memory by an index table, and a streamed one
// takes laid out into At by the wrapper).  Table layouts: binning.cuh
// (maps, pieces); slices[11*t + {0..10}] = slice t: program, first row,
// rows (<= RC), first k, end k, offset in At (values, 16-byte aligned),
// pieces P, flags (FIRST_IN_CHUNK, LAST_IN_CHUNK), values (padded to 16
// bytes), the program's first piece c0 and its rule (unique 0/1), so that
// a slice needs no second table; At[offset + ((k - first k) * P + j) *
// column_stride + r] = A[first row + r, off_(c0 + j) + k] for k <
// nexp_(c0 + j), r < rows, zeros elsewhere; groups[g] the first slice of
// group g.

#include "macro_oneshot.cuh"

namespace fiat::k3 {

FIAT_K3_INSTANTIATE(2, RC_TABLES, double)
FIAT_K3_INSTANTIATE(3, RC_TABLES, double)

}  // namespace fiat::k3

namespace {

using namespace fiat::k3;

template <class T>
int dispatch(const T* pts, int npts, int sd, const T* consts, const int* slots,
             const T* affine, T scale, T tol, int degree, const T* maps, const int* pieces,
             const int* slices, const int* groups, int ngroups, int rc, int sub, int resident,
             int stages, int buf, int ring, int nbar, int words, const T* At,
             const int* gather, T* out, int tp, void* stream) {
  if (npts < 1 || ngroups < 1 || sub < 1 || sub > MAX_SUB || nbar < 0 || words < 1 ||
      ring < 0 || ring % (16 / sizeof(T)) ||
      (!resident && (stages < 1 || stages > MAX_STAGES || stages > nbar || buf < 1 ||
                     buf % (16 / sizeof(T)) || stages * buf > ring || gather)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> q{pts, npts, consts, slots, {}, scale, tol, maps, pieces, slices, groups,
              0, sub, resident, stages, buf, ring, nbar, words, At, gather, out, 0};
  for (int i = 0; i < 12; ++i) q.affine[i] = affine[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sd == 1 && rc == RC_TABLES) return by_degree<1, RC_TABLES, T>(q, degree, ngroups, tp, s);
  if (sd == 1 && rc == RC_ONE) return by_degree<1, RC_ONE, T>(q, degree, ngroups, tp, s);
  if (sd == 2 && rc == RC_TABLES) return by_degree<2, RC_TABLES, T>(q, degree, ngroups, tp, s);
  if (sd == 2 && rc == RC_ONE) return by_degree<2, RC_ONE, T>(q, degree, ngroups, tp, s);
  if (sd == 3 && rc == RC_TABLES) return by_degree<3, RC_TABLES, T>(q, degree, ngroups, tp, s);
  if (sd == 3 && rc == RC_ONE) return by_degree<3, RC_ONE, T>(q, degree, ngroups, tp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// pts (npts, sd), sd 1, 2 or 3; consts and slots (pack_stages(degree, sd=sd));
// affine: the 12 values the wrapper packs (the sd x sd map row-major, its
// shift, zeros after); maps, pieces: binning.cuh; slices (nslices, 11) of
// chunks at most rc rows high (32, or 1 for one row per program), groups
// (ngroups + 1) their first slices; sub point tiles a block (1..8), each of
// point_tile(sd, degree, type) points (macro_oneshot.cuh); resident 1 to
// keep each group's slices in shared memory (nbar 0), else a ring of
// `stages` (1..4, at most nbar) buffers of `buf` values; ring the values
// before the Phi tile, words the mask words of the widest program; At (the
// slices' values, or with a resident plan the call's A and gather, the
// int32 index of each of the slices' values in it, -1 for a zero; gather
// null otherwise), out (rows, npts) and tp, the point tile (the
// instantiation's point_tile at an unrolled degree; 128, 64 or 32 past it).  Returns the CUDA error code of the
// launch (0 on success), or the attribute call's error (more shared memory
// than a block may have), which is then cleared and nothing is launched;
// cudaErrorInvalidValue for an sd or rc it is not instantiated for, a
// negative degree, a point tile the degree's instantiation does not take,
// no points or groups, a grid past 2^31 - 1 blocks, or an argument outside
// the ranges above (the wrapper checks all of these first).
extern "C" int fiat_macro_oneshot(const double* pts, int npts, int sd, const double* consts,
                                  const int* slots, const double* affine, double scale,
                                  double tol, int degree, const double* maps, const int* pieces,
                                  const int* slices, const int* groups, int ngroups, int rc,
                                  int sub, int resident, int stages, int buf, int ring, int nbar,
                                  int words, const double* At, const int* gather, double* out,
                                  int tp, void* stream) {
  return dispatch<double>(pts, npts, sd, consts, slots, affine, scale, tol, degree, maps, pieces,
                          slices, groups, ngroups, rc, sub, resident, stages, buf, ring, nbar,
                          words, At, gather, out, tp, stream);
}

extern "C" int fiat_macro_oneshot_f32(const float* pts, int npts, int sd, const float* consts,
                                      const int* slots, const float* affine, float scale,
                                      float tol, int degree, const float* maps,
                                      const int* pieces, const int* slices, const int* groups,
                                      int ngroups, int rc, int sub, int resident, int stages,
                                      int buf, int ring, int nbar, int words, const float* At,
                                      const int* gather, float* out, int tp, void* stream) {
  return dispatch<float>(pts, npts, sd, consts, slots, affine, scale, tol, degree, maps, pieces,
                         slices, groups, ngroups, rc, sub, resident, stages, buf, ring, nbar,
                         words, At, gather, out, tp, stream);
}
