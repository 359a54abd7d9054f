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
// Phi tile (dubiner2.cuh / dubiner3.cuh in float) straight into shared
// memory, and Phi never goes to device memory.  The expansion variants
// ("bubble", "dual") are the same recurrence with other constants; the
// bubble C0 recovery is folded into A on the host, as fiat_tpu does.
// Plain f32 FMAs: no TF32, no tensor cores.
//
// Bound on the card: the store of out where the rows are narrow (full_zoo:
// 4113 x 1e5 floats, 1.65 GB a pass at order 1, against 1.06e10 FMAs) and
// the FP32 FMA rate where they are wide (tet_lagrange8: 660 rows at K =
// 165, 1.09e10 FMAs against 0.26 GB).  Design (the kernel template is in
// zoo_f32.cuh):
//   * a block of 2 TP threads (TP = 64 or 128 points) computes Phi[:kmax]
//     for its point tile into shared memory, two threads a point, each the
//     recurrence of half its stage-1 rows, and walks every 128-row tile of
//     the stacked rows of all width groups;
//   * A goes through a ring of 2 to STAGES chunks of kc rows of k: one thread
//     issues a bulk copy (cp.async.bulk) of each chunk, completing on the
//     buffer's "full" mbarrier; each warp done reading a buffer arrives on
//     its "empty" mbarrier, and the last of them (a counter elects it)
//     refills the buffer with the chunk STAGES ahead.  The host stores every
//     row tile transposed at its own width (rounded up to DEPTH), tile after
//     tile (ops/f32_zoo.py k6_layout), so a chunk is one contiguous copy; the
//     first chunks are in flight while the recurrence runs, and no block
//     barrier is left once the Phi tile is complete;
//   * a warp owns 32 rows x 64 points, a lane 8 rows x 8 points of
//     accumulators (lanes 8 to a row group, 4 row groups): a k-step reads two
//     float4 of A (the 4 row groups' 16 bytes lie 32 bytes apart) and two of
//     Phi (8 lanes' consecutive 16 bytes), one conflict-free 128-byte
//     wavefront each, for 64 FMAs a lane; two sets of fragments alternate,
//     so each k-step's loads run beside the last one's FMAs; the Phi tile
//     keeps each pair of points' columns swapped, so that every FMA reads
//     its accumulator and its Phi operand from the two register banks;
//   * a warp contracts its 32 rows only to their widest row (the table
//     holds each warp row's width): a tile that spans two width groups
//     (full_zoo's 33 tiles of 4113 rows in 10 widths) pads only the warps
//     that do, and a warp past a ragged tile's last row (tet_lagrange8's
//     660 rows leave 20 in the last tile) skips its products;
//   * a finished tile goes out from the accumulators as 16-byte stores
//     (evict-first), 8 lanes writing a row's 128 contiguous bytes, so with no
//     block barrier the stores of one warp run beside the products of the
//     others; dst maps every packed row to its output row, so the output
//     comes out in the caller's layout (alpha-major, zoo row order) with no
//     copy;
//   * the plan (point tile, chunk rows, chunks in the ring, blocks an SM) is
//     chosen on the host per (sd, degree, width) (ZooF32Kernel.plan_for) so
//     that at least two blocks share an SM, and one block's recurrence and
//     fill run beside another's products; launch bounds give every point
//     tile 16 warps' worth of registers an SM (128 a thread).  128-row tiles
//     keep 16 warps an SM where the Phi tile leaves room for two blocks of
//     128 points (tet_lagrange8's 85 KB); 64-row tiles held 8 (PERF.md).
// Each output is one sequential FMA chain over k = 0..K_t - 1 (A's padding
// is exact zeros), so two calls give the same bits.
//
// The interval (sd = 1, degree 0..15) takes it from dubiner1.cuh in float,
// the first thread of each point running the whole loop (zoo_f32_1.cu
// instantiates it).
//
// Past those degrees (0..15 on the interval and the triangle, 0..10 on
// the tetrahedron) each (cell, point tile) has one generic instantiation
// that takes the degree at the launch (zoo_f32.cuh), on the streaming
// recurrence; the plan narrows to what its Phi tile leaves room for (tet
// degree 14: 680 rows at 64 points, 174 KB, one block an SM).
//
// The tetrahedron (sd = 3, degree 0..10) takes the Phi tile from
// dubiner3.cuh in float, each value to its morton row through slots[e]
// (ops/recurrence.py:pack_stages(N, variant, sd=3)), as K1's sd = 3 stage
// writes them.

#include "zoo_f32.cuh"

namespace fiat::k6 {

FIAT_K6_INSTANTIATE(2, 128)

namespace {

int members(int sd, int degree) {
  if (sd == 1) return degree + 1;
  return sd == 2 ? (degree + 1) * (degree + 2) / 2 : (degree + 1) * (degree + 2) * (degree + 3) / 6;
}

// whether (sd, degree, kpad, kmax, tp, kc, stages, minb) is a plan this
// kernel runs: kpad is kmax rounded up to DEPTH, a chunk is a positive
// multiple of DEPTH rows, and minb blocks of tp threads fit an SM's
// registers (the launch bounds) and shared memory
bool valid(int sd, int degree, int kpad, int kmax, int tp, int kc, int stages, int minb) {
  if (sd < 1 || sd > 3 || degree < 0 || (sd > 1 && degree > MAX_GENERIC_DEGREE)) return false;
  if (kmax < 1 || kmax > members(sd, degree) || kpad != (kmax + DEPTH - 1) / DEPTH * DEPTH)
    return false;
  if ((tp != 64 && tp != 128) || kc < DEPTH || kc % DEPTH != 0 || kc > kpad || stages < 2 ||
      stages > STAGES || minb < 1 || minb * threads_of(tp) > THREADS_SM)
    return false;
  const size_t bytes = smem_bytes(kpad, tp, kc, stages);
  return bytes <= SMEM_MAX &&
         minb * ((bytes + SMEM_UNIT - 1) / SMEM_UNIT * SMEM_UNIT + SMEM_BLOCK) <= SMEM_SM;
}

int dispatch(int sd, int tp, const Params& q, int degree, size_t bytes, cudaStream_t s) {
  if (sd == 1)
    return tp == 64 ? by_degree<1, 64>(q, degree, bytes, s) : by_degree<1, 128>(q, degree, bytes, s);
  if (sd == 2)
    return tp == 64 ? by_degree<2, 64>(q, degree, bytes, s) : by_degree<2, 128>(q, degree, bytes, s);
  return tp == 64 ? by_degree<3, 64>(q, degree, bytes, s) : by_degree<3, 128>(q, degree, bytes, s);
}

}  // namespace
}  // namespace fiat::k6

// pts: device (npts, sd) f32, sd 1, 2 or 3; consts, slots: pack_stages(degree,
// variant, sd) on the device (slots read at sd = 3 only); affine: HOST array
// of sd * sd + sd floats (A row-major, then b) mapping the points onto the
// default simplex; At: device (sum of widths, 128) f32, every 128-row tile
// of the packed rows transposed at its width, tile after tile; tiles: device
// int32 (ntiles, 8) = (first row, rows <= 128, width (even, <= kpad), first
// row of At, the width of each 32-row warp slab (even, <= the tile's, 0
// past its rows)); kmax: the widest row (Phi rows read), kpad: kmax rounded up
// to 2; dst: device int32, the output row of every packed row; out: device
// (>= max dst + 1, npts) f32; (tp, kc, stages, minb): the plan; any degree
// (up to 63 on triangles and tetrahedra).  Returns cudaGetLastError() after
// the launch; cudaErrorInvalidValue, launching nothing, for a degree or
// plan outside what the kernel takes (`valid`).
extern "C" int fiat_zoo_f32(const float* pts, int npts, int sd, const float* consts,
                            const int* slots, const float* affine, float scale, int degree,
                            const float* At, int kpad, int kmax, const int* tiles, int ntiles,
                            const int* dst, float* out, int tp, int kc, int stages, int minb,
                            void* stream) {
  using namespace fiat::k6;
  if (!valid(sd, degree, kpad, kmax, tp, kc, stages, minb) || npts < 0 || ntiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params q{pts, npts, consts, slots, {}, scale, At, kpad, kmax, tiles, ntiles, dst, out, kc,
           stages, degree};
  for (int i = 0; i < sd * sd + sd; ++i) q.aff[i] = affine[i];
  return dispatch(sd, tp, q, degree, 0, static_cast<cudaStream_t>(stream));
}

// Blocks of the plan an SM holds at once (registers and shared memory, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error;
// -cudaErrorInvalidValue for a plan fiat_zoo_f32 refuses.
extern "C" int fiat_zoo_f32_occupancy(int sd, int degree, int kpad, int kmax, int tp, int kc,
                                      int stages, int minb) {
  using namespace fiat::k6;
  if (!valid(sd, degree, kpad, kmax, tp, kc, stages, minb))
    return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch(sd, tp, Params{}, degree, smem_bytes(kpad, tp, kc, stages), nullptr);
}
