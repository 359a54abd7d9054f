// K45: the expansion-side moments of a zoo in one launch, in f64, on
// intervals, triangles and tetrahedra: the plain moments pw[k] = sum_q phi_k(x_q) wf_q
// and, for every subcell c of every macro program, the masked moments
// bw[c, k] = sum_q mask_c(x_q) recip(x_q) phi_k(x_q) wf_q.
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
// Bound on the card: not memory (8 (sd + 1) bytes of points and weights per
// point), but the per-point work: the recurrence (~8 flops per member), a
// chain of dependent FP64 operations, and one accumulation per output row.
// Latency is hidden only by other warps, so the design keeps what a warp
// holds small and lets registers, not shared memory, set the occupancy
// (moments.cuh block_warps and min_blocks: 20 to 24 warps an SM where the
// sums fit, with no spills):
//
//   * A warp takes 32 points, one a lane, bins them (binning.cuh) and runs
//     the recurrence (dubiner2.cuh, dubiner3.cuh), whose constants sit in
//     the kernel's parameters (constant-bank operands, no loads), streaming
//     each value times the point's weight into its slab: 32 entries x 32
//     points, entry e at row e mod 32 (a row stride of 33 doubles: lane j
//     reading its row across the points, and the points writing one row,
//     hit no bank twice).  Entry e's member is slots[e], its morton row
//     (ops/recurrence.py:pack_stages).
//   * When a chunk of 32 entries is in (a compile-time point of the unrolled
//     recurrence), lane j takes entry 32 c + j and adds the slab's 32
//     points into its plain sum, a register (the chunk index is a constant,
//     so a lane holds ceil(nexp / 32) of them); then, piece by piece, the
//     points that hit the piece (a ballot per piece and tile) into one
//     running sum, added once into the piece's sum of its member in the
//     warp's array of piece sums in shared memory.  A member belongs to one
//     entry, so to one lane: no atomics.  Where a point of the tile lies on
//     several pieces of a program (tie points), each value is scaled by
//     1 / hits.  Nothing is unrolled over the pieces (a compare and add per
//     piece unrolled into every value took 79 s to build).
//   * A block adds its warps' sums in warp order into one partial row
//     vector; the last block of each group of 16 to finish (a
//     __threadfence and a ticket) sums its group's partials in block order,
//     and the last group's block sums the groups' in group order, all in
//     the same launch.  The tickets are left 0.  The order of every sum
//     depends on the launch's shape only, so two calls give identical bits.
//
// Binning is program by program and, within a program, word by word
// (binning.cuh piece_bits and rule_word: 32 pieces a word, any number of
// words), so a zoo may have any number of subcells in all and a program
// any number of its own: per tile the warp keeps one 32-point mask per
// piece (a ballot, taken as each word is binned, so no word is kept) and,
// per program, each point's hit count over the whole program (the tie
// weight 1 / hits, from a table for 1..32 hits and divided past it); each
// piece's sums find their program in the block's piece table.
//
// Shared memory: the block's tables (first row, width and program per
// piece, first and end piece and rule per program: 12 bytes each), then a
// warp's share: the slab (8448 bytes), the tile's piece masks (4 bytes a
// piece) and hit counts (64 bytes a program), and one double per piece
// row, each part rounded up to 16 bytes.  A piece of n members thus costs
// 12 + 4 + 8 n bytes in a block of one warp: one warp stops fitting a
// block's 231,424 bytes at about 5,500 pieces of P1's 3 members (a
// program on iso(16) has 256), 930 of degree 6's 28, 96 of
// tet degree 10's 286; the wrapper raises past that, naming shared memory.
// Sd = 3, degree 10, 32 pieces of 286 members in 4 programs need 80 KB a
// warp, two warps a block.
//
// Past the unrolled degrees (0..15 at sd = 1, 0..10 at sd = 2 and 3) one
// generic instantiation per sd takes the degree at run time
// (moments.cuh): the same schedule on the streaming recurrence, its
// constants read through the read-only cache and its plain sums in the
// warp's shared memory (one double a plain row more a warp).
//
// Output row layout (R = nplain + the pieces' widths): rows 0..nplain-1 are
// pw; piece c's masked moments are rows nplain + off_c + k, k < nexp_c
// (program-major, subcell-major: fiat_tpu's b_stack order).  Tables:
// binning.cuh (maps, progs, pieces) and dubiner2.cuh / dubiner3.cuh
// (consts, slots).

#include "moments.cuh"

using namespace fiat::k45;

// pts (npts, sd), wf (npts,), sd 1, 2 or 3; consts (on the host: they are
// passed in the kernel's parameters) and slots (on the device),
// pack_stages(degree, sd=sd), and dconsts the same on the device (read by
// the generic instantiation only; may be null below it); affine: 12 values on the host (the sd x sd
// map row-major, its shift, zeros after); maps, progs, pieces: binning.cuh;
// R = nplain + the pieces' widths; warps a block, 1 to block_warps(sd,
// degree) (moments.cuh); partials (nblocks +
// ceil(nblocks / 16), R) scratch; tickets 1 + ceil(nblocks / 16) unsigned,
// 0 (the launch leaves them 0); out (R,).
// Every point count from 0 on is taken (out is then 0).  Returns the CUDA
// error code of the launch (0 on success), or the attribute call's error
// (the warps' shared memory is more than a block may have), which is then
// cleared and nothing is launched; cudaErrorInvalidValue for an sd outside
// 1..3, a negative degree, a generic degree without dconsts, nplain past
// the degree's members, no blocks or more warps than the instantiation is
// built for (the wrapper checks all of these first).
extern "C" int fiat_pair_moments(const double* pts, const double* wf, int npts, int sd,
                                 const double* consts, const double* dconsts, const int* slots,
                                 const double* affine,
                                 double scale, double tol, int degree, int nplain,
                                 const double* maps, int npieces, const int* progs, int nprogs,
                                 const int* pieces, int R, int warps, int nblocks,
                                 double* partials, unsigned* tickets, double* out,
                                 void* stream) {
  if (sd < 1 || sd > 3 || degree < 0 || npieces < 0 || nplain > nexp_of(sd, degree) ||
      nblocks < 1 || warps < 1 || warps > MAX_WARPS ||
      (degree > unrolled_top(sd) && dconsts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params q{pts,    wf,     npts,   slots, {}, scale,    tol,    nplain, maps,
           npieces, progs, nprogs, pieces, R,  partials, tickets, out, dconsts, degree};
  for (int i = 0; i < 12; ++i) q.affine[i] = affine[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sd == 1) return launch_by_degree<1>(q, consts, degree, warps, nblocks, s);
  return sd == 2 ? launch_by_degree<2>(q, consts, degree, warps, nblocks, s)
                 : launch_by_degree<3>(q, consts, degree, warps, nblocks, s);
}

// The blocks of ``warps`` warps an SM holds at once for the (sd, degree)
// instantiation with ``piece_rows`` piece rows over ``npieces`` pieces in
// ``nprogs`` programs and ``nplain`` plain rows (registers and shared memory
// both counted: cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus
// the CUDA error; minus cudaErrorInvalidValue for a negative degree or an
// argument out of range.
extern "C" int fiat_pair_moments_occupancy(int sd, int degree, int warps, int piece_rows,
                                           int npieces, int nprogs, int nplain) {
  if (sd < 1 || sd > 3 || warps < 1 || warps > MAX_WARPS || piece_rows < 0 || npieces < 0 ||
      nprogs < 0 || nplain < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (sd == 1) return occupancy_by_degree<1>(degree, warps, piece_rows, npieces, nprogs, nplain);
  return sd == 2 ? occupancy_by_degree<2>(degree, warps, piece_rows, npieces, nprogs, nplain)
                 : occupancy_by_degree<3>(degree, warps, piece_rows, npieces, nprogs, nplain);
}
