// K2: C_g = A_g @ Phi[:K_g] in f64 for every contraction-width group g,
// in one launch, on the FP64 tensor cores.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMultiwordMatmul._kernel (_combine_core / _combine_core_i8), launched
// once per degree bucket.  That kernel reaches f64 accuracy on the bf16/int8
// MXU with Ozaki windows, group dots and a TwoSum combine.  Hopper has
// native FP64 and FP64 tensor cores (DMMA), so this kernel is a plain f64
// product on the tensor cores.
//
// Bound on the card: the store of C or the FP64 tensor-core rate, by
// contraction width.  For full_zoo at order 1 and 1e5 points, C is 4113 x
// 1e5 doubles, 3.29 GB a pass (0.98 ms at 3.35 TB/s), against 21.1 GFLOP
// (K <= 66; 0.32 ms at 67 TFLOP/s): store-bound.  For tet_lagrange8 (K =
// 165) C is 660 x 1e5 (0.53 GB, 0.16 ms) against 21.8 GFLOP (0.33 ms):
// bound by the tensor cores.  Hopper's wgmma takes no f64, so the products
// go through mma.sync, sm_90's m16n8k4: its depth of 4 pads full_zoo's
// narrow groups (K = 3, 6, 10) least, and it issues half the instructions
// of m8n8k4 for the same fragment loads.  Design:
//   * one block per TP-point tile keeps Phi[:kmax] for its points in
//     shared memory (loaded once) and walks every 64-row tile of the
//     stacked rows, so Phi is read from memory once a pass; rows kmax..kpad
//     of that tile, past Phi's own rows, are written as zeros (0 * NaN is
//     NaN, so nothing is left uninitialised);
//   * the rows of all groups are packed back to back, zero-padded to kpad
//     (kmax rounded up to a multiple of 4) and cut into 64-row tiles, which
//     the host stores transposed, (tile, k, row); a table gives each tile
//     its first row, row count and contraction width K, and a tile
//     contracts only to K rounded up to a multiple of 4 (A's padding holds
//     exact zeros);
//   * 8 warps, 2 along the rows and 4 along the points: a warp's tile is
//     32 rows x TP / 4 points of accumulators in registers, multiplied a
//     k-step at a time from fragments loaded out of shared memory;
//   * A goes through shared memory in chunks of kc rows of k, in a ring of
//     2 to STAGES buffers: one thread issues a bulk copy (cp.async.bulk, the
//     TMA's 1-D form) of each chunk, completing on the buffer's "full"
//     mbarrier, and each warp done reading a buffer arrives on its "empty"
//     mbarrier, so the next chunks are in flight while the MMAs run on this
//     one and no block barrier is left in the loop over the row tiles.  A
//     ninth, producer warp waits on "empty" and refills each buffer with the
//     chunk STAGES ahead; where two 128-point blocks share an SM, its
//     registers would cap every thread at 96 (spills), so there the last of
//     the 8 warps done with a buffer (a relaxed counter elects it) waits for
//     that phase and refills the buffer itself;
//   * the warps copy Phi in PHI_GROUPS groups of rows and wait for a group
//     only before the first chunk that reads it, so the first row tile's
//     products start before the whole Phi tile is in;
//   * Phi and A are stored in shared memory with column ^ 4 (k mod 4): the
//     16 lanes of a half-warp, which load (k0 + t, col0 + g) for t, g < 4,
//     hit 16 distinct 8-byte bank pairs (a row stride of 64 or 128 doubles
//     alone would put the four k's on one bank pair: a 4-way conflict); the
//     host stores A already swizzled, so a chunk is one contiguous copy;
//   * a finished tile goes 8 rows at a time through a small per-warp
//     staging area, so that each store instruction writes whole rows of the
//     warp's points (2 x 256 bytes at TP = 128) with evict-first hints;
//   * where the shared memory of two blocks fits an SM (narrow K), the
//     kernel is built for two resident blocks (registers capped to let
//     them), so that one block's Phi loads and C stores overlap the other's
//     products; wide K keeps one block an SM and uncapped registers.
// The plan (point tile, chunk rows, chunks in the ring, blocks an SM) is
// chosen on the host (ops/fused_zoo.py BucketMatmul.plan_for) and checked
// by this entry.
//
// Past the widest K whose Phi tile a block's shared memory takes (kpad >
// 792: tet degree 15 and up, triangle degree 39 and up) a second kernel
// streams Phi in k (bucket_matmul_stream_kernel, fiat_bucket_matmul_stream):
//   * one block per (128-point tile, 64-row tile): C's 64 x 128 tile stays in
//     the warps' registers over the whole k loop (the same 8 warps, warp
//     tiles and m16n8k4 fragments as above);
//   * each chunk of kc rows of k brings A's chunk (one contiguous run of the
//     swizzled At) and Phi's kc x 128 slab (swizzled as above, rows past
//     kmax and points past npts written as zeros) into a ring of 2 to 4
//     buffers by cp.async, all 256 threads copying, one block barrier a
//     chunk (a multistage cp.async pipeline: chunk c + stages - 1 is in
//     flight while the MMAs run on chunk c);
//   * every block re-reads its Phi slab and its A tile, so the grid is
//     ordered for L2: the row tiles go in groups of `group` (about 16 MB of
//     A), and within a group the blocks of one point tile run together, so
//     each Phi slab (1.8 MB at tet degree 20) is read from device memory
//     once a group and A's group stays in L2 across the point tiles;
//   * the ring is re-used as the C staging area once the k loop is done.
//   At tet degree 20 (7084 rows x K 1771 at 1e5 points: 2.51 TFLOP, 37.4
//   ms at 67 TFLOP/s) a 64 x 128 tile does 16 FLOP a byte of its chunks
//   from L2, so L2 bandwidth, not only the DMMA rate, bounds it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk_copy.cuh"

namespace {

using fiat::bulk_copy;
using fiat::mbar_arrive;
using fiat::mbar_init;
using fiat::mbar_wait;

constexpr int TR = 64;          // rows per tile
constexpr int WARPS = 8;        // warps that multiply
constexpr int WARPS_N = 4;      // of them along the points (2 along the rows)
constexpr int WM = TR / (WARPS / WARPS_N);  // rows of a warp tile
constexpr int SLAB = 8;         // rows of C staged at a time
constexpr int STAGES = 4;       // the most A chunks in the ring
constexpr int PHI_GROUPS = 4;   // Phi's rows arrive in this many groups
// shared memory a block may take on sm_90 (the only target this builds for),
// an SM's, and what the SM keeps for each resident block
constexpr size_t SMEM_MAX = 232448, SMEM_SM = 233472, SMEM_BLOCK = 1024;

// A row's column c of the shared-memory tiles of Phi and A lies at
// c ^ swizzle(k): the four k's of a fragment load land on four bank groups.
__host__ __device__ constexpr int swizzle(int k) { return (k & 3) << 2; }

// Row stride of a warp's C staging area for wn points: 8 mod 16 doubles,
// so that the 16-byte stores of a quarter-warp (rows g, g + 1) and the
// row reads after them hit distinct banks.
__host__ __device__ constexpr int staging_stride(int wn) { return (wn + 15) / 16 * 16 + 8; }

// D (16 x 8) += A (16 x 4, row) B (4 x 8, col) in f64 on the tensor cores
// (sm_90's mma.sync.m16n8k4; PTX ISA, CuTe's SM90_16x8x4_F64F64F64F64_TN).
// With g = lane / 4, t = lane % 4: a = {A[g][t], A[g + 8][t]}, b = B[t][g],
// c = {C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]}.
__device__ __forceinline__ void mma_16x8x4(double* c, const double* a, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Shared memory of a block, in doubles: the Phi tile, a ring of `stages` A
// chunks, every warp's staging area, and the ring's two mbarriers and
// counter of the warps done with each buffer.
size_t smem_doubles(int kpad, int tp, int kc, int stages) {
  return static_cast<size_t>(kpad) * tp + static_cast<size_t>(stages) * kc * TR +
         static_cast<size_t>(WARPS) * SLAB * staging_stride(tp / WARPS_N) + 3 * STAGES;
}

// A block of TP points, MINB of them an SM: whether it has a producer warp,
// and its threads.
template <int TP, int MINB>
struct Block {
  static constexpr bool producer = !(TP == 128 && MINB == 2);
  static constexpr int threads = 32 * (WARPS + (producer ? 1 : 0));
};

// MINB: blocks an SM must hold at once (registers capped to let them)
template <int TP, int MINB>
__global__ void __launch_bounds__(Block<TP, MINB>::threads, MINB)
bucket_matmul_kernel(const double* __restrict__ At, int kpad, int kmax, int kc, int stages,
                     const int* __restrict__ tiles, int ntiles,
                     const double* __restrict__ phi, int ldphi, int npts,
                     double* __restrict__ C) {
  constexpr int WN = TP / WARPS_N;   // points of a warp tile
  constexpr int MT = WM / 16;        // MMA tiles of a warp tile along the rows
  constexpr int NT = WN / 8;         // and along the points
  constexpr int SS = staging_stride(WN);
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  double* Bs = smem;                                   // [kpad][TP]: Phi[:kpad] here
  double* As = Bs + static_cast<size_t>(kpad) * TP;    // stages x [kc][TR]: A chunks
  double* Sg = As + static_cast<size_t>(stages) * kc * TR;  // WARPS x [SLAB][SS]
  uint64_t* full = reinterpret_cast<uint64_t*>(Sg + WARPS * SLAB * SS);  // [STAGES]
  uint64_t* empty = full + STAGES;                                       // [STAGES]
  unsigned* done = reinterpret_cast<unsigned*>(empty + STAGES);  // [STAGES]: warps done

  // tile's contraction width rounded up to the MMA's depth (>= 4, <= kpad)
  auto width = [&](int tile) { return max(4, (__ldg(tiles + 3 * tile + 2) + 3) / 4 * 4); };
  // a chunk of the ring's order, every row tile's chunks in turn
  struct Chunk {
    int tile, k0, kt;
  };
  auto next = [&](Chunk c) {
    if (c.tile >= ntiles) return c;
    c.k0 += kc;
    if (c.k0 >= c.kt) {
      c.k0 = 0;
      if (++c.tile < ntiles) c.kt = width(c.tile);
    }
    return c;
  };
  // chunk c into ring buffer s, completing on its mbarrier
  auto fetch = [&](Chunk c, int s) {
    bulk_copy(As + static_cast<size_t>(s) * kc * TR,
              At + (static_cast<size_t>(c.tile) * kpad + c.k0) * TR,
              sizeof(double) * min(kc, c.kt - c.k0) * TR, full + s);
  };
  constexpr bool PRODUCER = Block<TP, MINB>::producer;
  // the next chunk to fetch (for the multiplying warps, STAGES past the one in use)
  Chunk ahead = {0, 0, ntiles > 0 ? width(0) : 0};

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);        // the fetching thread's arrival, plus the copy's bytes
      mbar_init(empty + s, WARPS);   // one arrival a multiplying warp
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (PRODUCER && warp == WARPS) {  // every chunk of every row tile, in order
    if (lane == 0) {
      for (int q = 0; ahead.tile < ntiles; ++q, ahead = next(ahead)) {
        const int s = q % stages;
        if (q >= stages) mbar_wait(empty + s, (q / stages - 1) & 1);
        fetch(ahead, s);
      }
    }
    return;
  }
  if (!PRODUCER) {
    for (int s = 0; s < stages; ++s) {  // fill the ring
      if (tid == 0 && ahead.tile < ntiles) fetch(ahead, s);
      ahead = next(ahead);
    }
  }

  const int g = lane >> 2, t = lane & 3;
  const int row_w = (warp / WARPS_N) * WM;   // the warp tile's first row in a row tile
  const int pt_w = (warp % WARPS_N) * WN;    // and its first point in the point tile
  double* St = Sg + warp * SLAB * SS;        // [SLAB][SS]
  const int p0 = blockIdx.x * TP;
  // 16-byte paths need a whole tile and 16-byte aligned rows of Phi and C
  const bool full_tile = (p0 + TP <= npts) && ((npts & 1) == 0) && ((ldphi & 1) == 0) &&
                         ((reinterpret_cast<uintptr_t>(phi) & 15) == 0) &&
                         ((reinterpret_cast<uintptr_t>(C) & 15) == 0);
  constexpr int MT_THREADS = 32 * WARPS;  // the multiplying threads
  const int grows = (kmax + PHI_GROUPS - 1) / PHI_GROUPS;  // Phi rows a group
  for (int gi = 0; gi < PHI_GROUPS; ++gi) {
    const int k1 = min(kmax, (gi + 1) * grows);
    if (full_tile) {
      for (int e = gi * grows * TP / 2 + tid; e < k1 * TP / 2; e += MT_THREADS) {
        const int k = e / (TP / 2), p = 2 * (e % (TP / 2));
        __pipeline_memcpy_async(Bs + k * TP + (p ^ swizzle(k)),
                                phi + static_cast<size_t>(k) * ldphi + p0 + p, 16);
      }
    } else {
      for (int e = gi * grows * TP + tid; e < k1 * TP; e += MT_THREADS) {
        const int k = e / TP, p = e % TP;
        Bs[k * TP + (p ^ swizzle(k))] =
            (p0 + p < npts) ? phi[static_cast<size_t>(k) * ldphi + p0 + p] : 0.0;
      }
    }
    __pipeline_commit();
  }
  for (int e = tid; e < (kpad - kmax) * TP; e += MT_THREADS) Bs[kmax * TP + e] = 0.0;
  int ready = -1;  // the Phi rows every thread's copies have put in shared memory

  double acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

  int q = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int kt = width(tile);
    for (int k0 = 0; k0 < kt; k0 += kc, ++q) {
      const int kn = min(kc, kt - k0);
      const int need = min(k0 + kn, kmax);
      if (need > ready) {  // wait for the Phi groups this chunk reads
        const int gi = max(0, need - 1) / max(1, grows);
        switch (gi) {
          case 0: __pipeline_wait_prior(PHI_GROUPS - 1); break;
          case 1: __pipeline_wait_prior(PHI_GROUPS - 2); break;
          case 2: __pipeline_wait_prior(PHI_GROUPS - 3); break;
          default: __pipeline_wait_prior(0);
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(MT_THREADS) : "memory");
        ready = min(kmax, (gi + 1) * grows);
      }
      const int s = q % stages;
      mbar_wait(full + s, (q / stages) & 1);  // this chunk has landed
      const double* Ab = As + static_cast<size_t>(s) * kc * TR;
      const double* Bk = Bs + k0 * TP;
      // two blocks an SM cap registers at 128 a thread: one k-step in flight
#pragma unroll(MINB == 1 ? 2 : 1)
      for (int kk = 0; kk < kn; kk += 4) {
        double a[MT][2], b[NT];
        // kk and k0 are multiples of 4, so every fragment row k has k % 4 == t
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[i][h] = Ab[(kk + t) * TR + ((row_w + 16 * i + 8 * h + g) ^ swizzle(t))];
#pragma unroll
        for (int j = 0; j < NT; ++j) b[j] = Bk[(kk + t) * TP + ((pt_w + 8 * j + g) ^ swizzle(t))];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_16x8x4(acc[i][j], a[i], b[j]);
      }
      __syncwarp();  // every lane's loads from this buffer are done
      if (lane == 0) {
        mbar_arrive(empty + s);  // release this warp's reads of the buffer
        // without a producer, the last warp done with the buffer resets its
        // count and refills it
        if (!PRODUCER && atomicAdd(done + s, 1u) == WARPS - 1) {
          done[s] = 0;
          if (ahead.tile < ntiles) {
            mbar_wait(empty + s, (q / stages) & 1);  // every warp's reads, acquired
            // order those reads before the copy's writes (another proxy)
            fiat::fence_async_smem();
            fetch(ahead, s);
          }
        }
      }
      if (!PRODUCER) ahead = next(ahead);
    }

    // the tile's products are done: write C
    const int row0 = __ldg(tiles + 3 * tile), nrows = __ldg(tiles + 3 * tile + 1);
#pragma unroll
    for (int s = 0; s < WM / SLAB; ++s) {
      const int i = s / 2, h = s % 2;  // MMA tile, half
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<double2*>(St + g * SS + 8 * j + 2 * t) =
            make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      __syncwarp();
      const int r0 = row_w + s * SLAB;  // the slab's first row in the tile
      if (full_tile) {
#pragma unroll
        for (int e = lane; e < SLAB * WN / 2; e += 32) {
          const int r = e / (WN / 2), p = 2 * (e % (WN / 2));
          if (r0 + r < nrows)
            __stcs(reinterpret_cast<double2*>(C + static_cast<size_t>(row0 + r0 + r) * npts +
                                              p0 + pt_w + p),
                   *reinterpret_cast<const double2*>(St + r * SS + p));
        }
      } else {
        for (int e = lane; e < SLAB * WN; e += 32) {
          const int r = e / WN, p = e % WN;
          if (r0 + r < nrows && p0 + pt_w + p < npts)
            __stcs(C + static_cast<size_t>(row0 + r0 + r) * npts + p0 + pt_w + p,
                   St[r * SS + p]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;
  }
}

template <int TP, int MINB>
int launch(const double* At, int kpad, int kmax, int kc, int stages, const int* tiles,
           int ntiles, const double* phi, int ldphi, int npts, double* C, cudaStream_t stream) {
  const size_t bytes = sizeof(double) * smem_doubles(kpad, TP, kc, stages);
  cudaError_t err = cudaFuncSetAttribute(bucket_matmul_kernel<TP, MINB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  const int blocks = (npts + TP - 1) / TP;
  bucket_matmul_kernel<TP, MINB><<<blocks, Block<TP, MINB>::threads, bytes, stream>>>(
      At, kpad, kmax, kc, stages, tiles, ntiles, phi, ldphi, npts, C);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a streamed block, in doubles: the ring of `stages` (A
// chunk, Phi slab) pairs, which the C staging re-uses after the k loop.
constexpr int STP = 128;  // points of a streamed block
size_t stream_smem_doubles(int kc, int stages) {
  const size_t ring = static_cast<size_t>(stages) * kc * (TR + STP);
  const size_t staging = static_cast<size_t>(WARPS) * SLAB * staging_stride(STP / WARPS_N);
  return ring > staging ? ring : staging;
}

__global__ void __launch_bounds__(32 * WARPS, 2)
bucket_matmul_stream_kernel(const double* __restrict__ At, int kpad, int kmax, int kc,
                            int stages, int group, const int* __restrict__ tiles, int ntiles,
                            const double* __restrict__ phi, int ldphi, int npts,
                            double* __restrict__ C) {
  constexpr int TP = STP;
  constexpr int WN = TP / WARPS_N;   // points of a warp tile
  constexpr int MT = WM / 16;        // MMA tiles of a warp tile along the rows
  constexpr int NT = WN / 8;         // and along the points
  constexpr int SS = staging_stride(WN);
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const fiat::StreamBlock blk = fiat::stream_block(blockIdx.x, group, (npts + TP - 1) / TP, ntiles);
  const int tile = blk.tile, p0 = blk.pt * TP;

  const int kt = max(4, (__ldg(tiles + 3 * tile + 2) + 3) / 4 * 4);  // <= kpad
  const int nch = (kt + kc - 1) / kc;
  double* As = smem;                                            // stages x [kc][TR]
  double* Bs = As + static_cast<size_t>(stages) * kc * TR;      // stages x [kc][TP]
  const double* At_t = At + static_cast<size_t>(tile) * kpad * TR;
  // 16-byte copies of Phi need a whole tile and 16-byte aligned rows
  const bool full_tile = (p0 + TP <= npts) && ((ldphi & 1) == 0) &&
                         ((reinterpret_cast<uintptr_t>(phi) & 15) == 0);
  // chunk c (rows c * kc .. of k) into ring buffer s
  auto load = [&](int c, int s) {
    const int k0 = c * kc, kn = min(kc, kt - k0);
    double* Ad = As + static_cast<size_t>(s) * kc * TR;
    double* Bd = Bs + static_cast<size_t>(s) * kc * TP;
    const double* Asrc = At_t + static_cast<size_t>(k0) * TR;
    for (int e = tid; e < kn * TR / 2; e += THREADS)
      __pipeline_memcpy_async(Ad + 2 * e, Asrc + 2 * e, 16);
    if (full_tile) {
      for (int e = tid; e < kn * TP / 2; e += THREADS) {
        const int k = e / (TP / 2), p = 2 * (e % (TP / 2));
        double* dst = Bd + k * TP + (p ^ swizzle(k));
        if (k0 + k < kmax)
          __pipeline_memcpy_async(dst, phi + static_cast<size_t>(k0 + k) * ldphi + p0 + p, 16);
        else
          dst[0] = dst[1] = 0.0;
      }
    } else {
      for (int e = tid; e < kn * TP; e += THREADS) {
        const int k = e / TP, p = e % TP;
        double* dst = Bd + k * TP + (p ^ swizzle(k));
        if (k0 + k < kmax && p0 + p < npts)
          __pipeline_memcpy_async(dst, phi + static_cast<size_t>(k0 + k) * ldphi + p0 + p, 8);
        else
          *dst = 0.0;
      }
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const int row_w = (warp / WARPS_N) * WM;   // the warp tile's first row in the row tile
  const int pt_w = (warp % WARPS_N) * WN;    // and its first point in the point tile
  double acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

  for (int s = 0; s < stages - 1; ++s) {  // the ring's first chunks
    if (s < nch) load(s, s);
    __pipeline_commit();
  }
  for (int c = 0; c < nch; ++c) {
    fiat::wait_pending(stages - 2);  // this thread's copies of chunk c have landed
    __syncthreads();           // every thread's, and every warp is done with chunk c - 1
    if (c + stages - 1 < nch) load(c + stages - 1, (c + stages - 1) % stages);
    __pipeline_commit();       // (an empty group past the last chunk keeps the count)
    const int s = c % stages;
    const int kn = min(kc, kt - c * kc);
    const double* Ab = As + static_cast<size_t>(s) * kc * TR;
    const double* Bk = Bs + static_cast<size_t>(s) * kc * TP;
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 4) {
      double a[MT][2], b[NT];
      // kk and the chunk's first row are multiples of 4: fragment row k has k % 4 == t
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[i][h] = Ab[(kk + t) * TR + ((row_w + 16 * i + 8 * h + g) ^ swizzle(t))];
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = Bk[(kk + t) * TP + ((pt_w + 8 * j + g) ^ swizzle(t))];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_16x8x4(acc[i][j], a[i], b[j]);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free: it becomes the staging area

  // write C as the resident kernel does, 8 rows at a time through the staging
  const int row0 = __ldg(tiles + 3 * tile), nrows = __ldg(tiles + 3 * tile + 1);
  const bool whole = (p0 + TP <= npts) && ((npts & 1) == 0) &&
                     ((reinterpret_cast<uintptr_t>(C) & 15) == 0);
  double* St = smem + warp * SLAB * SS;  // [SLAB][SS]
#pragma unroll
  for (int s = 0; s < WM / SLAB; ++s) {
    const int i = s / 2, h = s % 2;  // MMA tile, half
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<double2*>(St + g * SS + 8 * j + 2 * t) =
          make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncwarp();
    const int r0 = row_w + s * SLAB;  // the slab's first row in the tile
    if (whole) {
#pragma unroll
      for (int e = lane; e < SLAB * WN / 2; e += 32) {
        const int r = e / (WN / 2), p = 2 * (e % (WN / 2));
        if (r0 + r < nrows)
          __stcs(reinterpret_cast<double2*>(C + static_cast<size_t>(row0 + r0 + r) * npts + p0 +
                                            pt_w + p),
                 *reinterpret_cast<const double2*>(St + r * SS + p));
      }
    } else {
      for (int e = lane; e < SLAB * WN; e += 32) {
        const int r = e / WN, p = e % WN;
        if (r0 + r < nrows && p0 + pt_w + p < npts)
          __stcs(C + static_cast<size_t>(row0 + r0 + r) * npts + p0 + pt_w + p, St[r * SS + p]);
      }
    }
  }
}

}  // namespace

// At: device (ntiles, kpad, 64) f64, every 64-row tile of the stacked rows
// transposed, zero-padded to kpad (the widest K rounded up to a multiple of
// 4, at least 4) and swizzled, At[tile][k][m ^ swizzle(k)] = A[row0 +
// m][k]; tiles: device int32 (ntiles, 3) = (first row, rows <= 64, K <=
// kmax); phi: device (>= kmax, ldphi) f64; C: device (rows, npts) f64; tp:
// the point tile (128, 64 or 32); kc: the rows of an A chunk; stages: the
// chunks in the ring (2 to 4); minb: the blocks an SM holds at once (1, or
// 2 where their shared memory fits an SM).  Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue, launching nothing, for a plan
// that does not fit a block's (or minb blocks') shared memory.
extern "C" int fiat_bucket_matmul(const double* At, int kpad, int kmax, int tp, int kc,
                                  int stages, int minb, const int* tiles, int ntiles,
                                  const double* phi, int ldphi, int npts, double* C,
                                  void* stream) {
  const size_t bytes = sizeof(double) * smem_doubles(kpad, tp, kc, stages);
  if (kmax < 0 || kmax > kpad || kpad < 4 || kpad % 4 != 0 || kc < 4 || kc % 4 != 0 ||
      stages < 2 || stages > STAGES || (tp != 128 && tp != 64 && tp != 32) || minb < 1 ||
      minb > 2 || bytes > SMEM_MAX || minb * (bytes + SMEM_BLOCK) > SMEM_SM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto run) {
    return run(At, kpad, kmax, kc, stages, tiles, ntiles, phi, ldphi, npts, C, s);
  };
  if (minb == 2) {
    switch (tp) {
      case 128: return go(launch<128, 2>);
      case 64: return go(launch<64, 2>);
      default: return go(launch<32, 2>);
    }
  }
  switch (tp) {
    case 128: return go(launch<128, 1>);
    case 64: return go(launch<64, 1>);
    default: return go(launch<32, 1>);
  }
}

// The streamed mode, for any kpad (the host runs it past the resident plans):
// At, tiles, phi, C as fiat_bucket_matmul takes them; kc: the rows of a
// chunk (a multiple of 4); stages: the chunks in the ring (2 to 4); group:
// the row tiles of one group of the grid's order.  Two blocks an SM.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue,
// launching nothing, for arguments outside those or a grid past 2^31 - 1
// blocks.
extern "C" int fiat_bucket_matmul_stream(const double* At, int kpad, int kmax, int kc,
                                         int stages, int group, const int* tiles, int ntiles,
                                         const double* phi, int ldphi, int npts, double* C,
                                         void* stream) {
  const size_t bytes = sizeof(double) * stream_smem_doubles(kc, stages);
  const long long blocks = static_cast<long long>((npts + STP - 1) / STP) * ntiles;
  if (kmax < 0 || kmax > kpad || kpad < 4 || kpad % 4 != 0 || kc < 4 || kc % 4 != 0 ||
      stages < 2 || stages > STAGES || group < 1 || ntiles < 0 || npts < 0 ||
      blocks > 2147483647LL || 2 * (bytes + SMEM_BLOCK) > SMEM_SM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(bucket_matmul_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bucket_matmul_stream_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  bucket_matmul_stream_kernel<<<static_cast<unsigned>(blocks), 32 * WARPS, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      At, kpad, kmax, kc, stages, group, tiles, ntiles, phi, ldphi, npts, C);
  return static_cast<int>(cudaGetLastError());
}
