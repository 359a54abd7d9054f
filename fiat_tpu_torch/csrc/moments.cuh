// K45's kernel template, its launch and its occupancy query
// (csrc/moments.cu has the design note and the C entry points; the sd = 3
// instantiations build from csrc/moments3.cu and the sd = 1 ones from
// csrc/moments1.cu, beside the others, each source with its cell's generic
// instantiation).
//
// The generic instantiation (N = GENERIC) takes any degree at run time,
// past the unrolled 0..15 (sd 1) and 0..10 (sd 2, 3): the streaming
// recurrence (dubiner*_point_n), its constants through the read-only cache
// from a device pointer (Params::consts) rather than the parameters (3872
// doubles at tet degree 15 would pass their 32,764 bytes); the entry count,
// the chunks and the slab flushes are run-time values; and the lane's plain
// sums, which the unrolled kernel keeps in registers by chunk, sit in the
// warp's shared memory by member (one double a plain row, after the piece
// sums: each member belongs to one lane, so no atomics).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <type_traits>

#include "binning.cuh"
#include "dubiner1.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace fiat::k45 {

constexpr int MAX_WARPS = 8;   // the most warps a block
constexpr int SLAB_LD = 33;    // slab row stride (doubles)
constexpr int SLAB = 32 * SLAB_LD;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 16;  // blocks whose partials one block sums (ops/moment_kernel.py GROUP)

// The warps a block and the blocks an SM each instantiation is built for
// (__launch_bounds__, ops/moment_kernel.py block_warps): 8 and 3, 24 warps
// within 80 registers a thread; the tetrahedron from degree 7, whose
// recurrence holds more values, in blocks of 4 warps, MIN_BLOCKS_WIDE an SM.
// The generic instantiation is built for blocks of up to 8 warps, 3 an SM
// (80 registers a thread, as the triangle's: its recurrence holds two
// values a stage and no sums); the wrapper picks its warps a block by the
// occupancy query.
constexpr int MIN_BLOCKS_WIDE = 5;
__host__ __device__ constexpr int block_warps(int sd, int n) {
  return sd == 3 && n >= 7 ? 4 : MAX_WARPS;
}
__host__ __device__ constexpr int min_blocks(int sd, int n) {
  return sd == 3 && n >= 7 ? MIN_BLOCKS_WIDE : 3;
}
// the top of the unrolled degrees of an sd
__host__ __device__ constexpr int unrolled_top(int sd) { return sd == 1 ? 15 : 10; }

__host__ __device__ constexpr int nexp_of(int sd, int n) {
  return sd == 1 ? n + 1 : sd == 2 ? (n + 1) * (n + 2) / 2 : (n + 1) * (n + 2) * (n + 3) / 6;
}
// doubles of pack_stages(n, sd=sd): 4 per stage entry (4 at degree 0)
__host__ __device__ constexpr int nconst_of(int sd, int n) {
  return n == 0 ? 4
                : 4 * (n + 1 + (sd > 1 ? nexp_of(2, n) : 0) + (sd == 3 ? nexp_of(3, n) : 0));
}
// Shared memory (ops/moment_kernel.py block_smem): the block's tables first
// (per piece its first row, width and program, then per program its first
// and end piece and its rule, ints), then each warp's share: the slab, the
// tile's point mask of each piece (unsigned), the hits of each point in each
// program (16-bit, [g][point]), and one double per piece row; each part
// rounded up to an even count of doubles, so every warp's slab stays
// 16-byte aligned.
__host__ __device__ constexpr int even_doubles(long long bytes) {
  return static_cast<int>(((bytes + 15) / 16) * 2);
}
__host__ __device__ constexpr int header_doubles(int npieces, int nprogs) {
  return even_doubles(12LL * (npieces + nprogs));
}
__host__ __device__ constexpr int masks_doubles(int npieces, int nprogs) {
  return even_doubles(4LL * npieces + 64LL * nprogs);
}
// (the generic instantiation: then one double a plain row, the lane's plain
// sums by member)
__host__ __device__ constexpr int warp_doubles(int piece_rows, int npieces, int nprogs,
                                               int plain_rows = 0) {
  return SLAB + masks_doubles(npieces, nprogs) + even_doubles(8LL * piece_rows) +
         even_doubles(8LL * plain_rows);
}

inline size_t smem_bytes(int warps, int piece_rows, int npieces, int nprogs, int plain_rows) {
  return sizeof(double) *
         (static_cast<size_t>(header_doubles(npieces, nprogs)) +
          static_cast<size_t>(warps) * warp_doubles(piece_rows, npieces, nprogs, plain_rows));
}

struct Params {
  const double* pts;
  const double* wf;
  long long npts;
  const int* slots;
  double affine[12];  // the SD x SD map row-major, then its shift
  double scale, tol;
  int nplain;
  const double* maps;
  int npieces;
  const int* progs;
  int nprogs;
  const int* pieces;
  int R;
  double* partials;  // (gridDim.x + the groups of GROUP blocks, R)
  unsigned* tickets; // 1 + the groups: 0 before the launch, 0 after it
  double* out;       // (R,)
  const double* consts;  // the generic instantiation: pack_stages(degree, sd) on the device
  int degree;
};

// The unrolled instantiations' constants, in the kernel's parameters; the
// generic one reads Params::consts (an empty table here).
struct NoTable {};
template <int SD, int N>
using Consts = std::conditional_t<(N < 0), NoTable,
                                  fiat::ConstTable<double, nconst_of(SD, N < 0 ? 0 : N)>>;

template <int SD, int N>
__global__ void __launch_bounds__(32 * block_warps(SD, N), min_blocks(SD, N))
    pair_moments_kernel(const __grid_constant__ Params q,
                        const __grid_constant__ Consts<SD, N> consts) {
  constexpr bool kGeneric = N < 0;
  constexpr int NE_U = nexp_of(SD, kGeneric ? 0 : N);
  constexpr int NCH_U = (NE_U + 31) / 32;
  const int NE = kGeneric ? nexp_of(SD, q.degree) : NE_U;
  extern __shared__ double smem[];
  __shared__ double s_rcp[33];
  __shared__ bool last;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int PR = q.R - q.nplain;
  // piece c: first row tab[3 c] of its sums, width tab[3 c + 1], program
  // tab[3 c + 2]; program g: first and end piece ptab[3 g], ptab[3 g + 1],
  // unique ptab[3 g + 2] (the tables sit at the start of shared memory, so
  // their addresses need no register)
  int* const tab = reinterpret_cast<int*>(smem);
  const int* const ptab = tab + 3 * q.npieces;
  const int WD = warp_doubles(PR, q.npieces, q.nprogs, kGeneric ? q.nplain : 0);
  double* wbase = smem + header_doubles(q.npieces, q.nprogs);
  double* slab = wbase + warp * WD;
  unsigned* mq = reinterpret_cast<unsigned*>(slab + SLAB);  // piece c's points
  unsigned short* hc = reinterpret_cast<unsigned short*>(mq + q.npieces);  // [g][point]: hits
  // this warp's piece sums: piece c's member j at off_c + j
  double* acc = slab + SLAB + masks_doubles(q.npieces, q.nprogs);
  // the generic instantiation's plain sums: member j at psum[j], j < nplain
  double* psum = acc + even_doubles(8LL * PR);

  // the tables, and 1 / hits for 1..32 hits (binning.cuh's program_recip
  // computes the same; a point of more hits, on a degenerate split, divides)
  if (threadIdx.x < 32) s_rcp[threadIdx.x + 1] = 1.0 / static_cast<double>(threadIdx.x + 1);
  for (int g = threadIdx.x; g < q.nprogs; g += blockDim.x) {
    const int c0 = __ldg(q.progs + 5 * g + 2), c1 = __ldg(q.progs + 5 * g + 3);
    tab[3 * q.npieces + 3 * g] = c0;
    tab[3 * q.npieces + 3 * g + 1] = c1;
    tab[3 * q.npieces + 3 * g + 2] = __ldg(q.progs + 5 * g + 4);
    for (int c = c0; c < c1; ++c) {
      tab[3 * c] = __ldg(q.pieces + 2 * c);
      tab[3 * c + 1] = __ldg(q.pieces + 2 * c + 1);
      tab[3 * c + 2] = g;
    }
  }
  for (int i = lane; i < PR; i += 32) acc[i] = 0.0;
  if constexpr (kGeneric)
    for (int i = lane; i < q.nplain; i += 32) psum[i] = 0.0;
  __syncthreads();
  int widest = 0;  // the widest piece's members
  for (int c = 0; c < q.npieces; ++c) widest = max(widest, tab[3 * c + 1]);

  // the plain sums of the lane's entries 32 c + lane (unrolled: in
  // registers by chunk; generic: psum)
  double plain[kGeneric ? 1 : NCH_U];
#pragma unroll
  for (int c = 0; c < (kGeneric ? 1 : NCH_U); ++c) plain[c] = 0.0;
  // entry 32 c + lane's member (morton row), INT_MAX past the last entry
  auto member = [&](int c) {
    const int e = 32 * c + lane;
    return e < NE ? __ldg(q.slots + e) : INT_MAX;
  };
  bool ties = false;  // some point of the tile is shared by pieces of one program

  // chunk c of the slab (the tile's weighted values) is complete: the lane
  // adds its entry over the 32 points into its plain sum, and over each
  // piece's points into that piece's sum
  auto flush = [&](const int c) {
    __syncwarp();
    const int j = member(c);
    const double* row = slab + lane * SLAB_LD;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      s0 += row[k];
      s1 += row[k + 1];
      s2 += row[k + 2];
      s3 += row[k + 3];
    }
    // a chunk none of whose members a piece reads (the pieces take the
    // leading members, the chunks run in the recurrence's order) skips them
    const int npieces = __any_sync(FULL, j < widest) ? q.npieces : 0;
    for (int pc = 0; pc < npieces; ++pc) {
      const unsigned m = mq[pc];
      if (!m || j >= tab[3 * pc + 1]) continue;
      double t0 = 0.0, t1 = 0.0;
      if (!ties) {
        // every hit takes the whole weight: two points at a time, the
        // second read from the row's zero past the points where m runs out
        for (unsigned mm = m; mm;) {
          const int k0 = __ffs(mm) - 1;
          mm &= mm - 1u;
          const int k1 = mm ? __ffs(mm) - 1 : 32;
          mm &= mm - 1u;
          t0 += row[k0];
          t1 += row[k1];
        }
      } else {
        for (unsigned mm = m; mm; mm &= mm - 1u) {
          const int k = __ffs(mm) - 1;
          const int h = hc[32 * tab[3 * pc + 2] + k];
          t0 += (h <= 32 ? s_rcp[h] : 1.0 / static_cast<double>(h)) * row[k];
        }
      }
      acc[tab[3 * pc] + j] += t0 + t1;
    }
    __syncwarp();
    // rows past the last entry hold stale values
    return j < INT_MAX ? (s0 + s1) + (s2 + s3) : 0.0;
  };

  double w = 0.0;
  auto put = [&](int e, double v) {
    slab[(e & 31) * SLAB_LD + lane] = v * w;
    if ((e & 31) == 31 || e == NE - 1) {
      if constexpr (kGeneric) {
        const double s = flush(e >> 5);
        const int j = member(e >> 5);
        if (j < q.nplain) psum[j] += s;
      } else {
        plain[e >> 5] += flush(e >> 5);
      }
    }
  };

  slab[lane * SLAB_LD + 32] = 0.0;  // the zero past the points of row lane
  const long long ntiles = (q.npts + 31) / 32;
  for (long long t = static_cast<long long>(blockIdx.x) * warps + warp; t < ntiles;
       t += static_cast<long long>(gridDim.x) * warps) {
    const long long p = t * 32 + lane;
    const bool live = p < q.npts;
    // a lane past the last point runs the recurrence at the cell's first
    // vertex, with no weight and no piece
    double x[SD];
#pragma unroll
    for (int i = 0; i < SD; ++i) x[i] = live ? q.pts[SD * p + i] : 0.0;
    w = live ? q.wf[p] : 0.0;
    if (q.nprogs) {
      // each program's masks of the lane's point, word by word
      // (binning.cuh), then per piece the ballot of the tile's points on it
      // and per program the hits of each point
      const double best = live ? fiat::parent_bound<SD>(q.maps, x, q.tol) : 0.0;
      bool tie = false;
      for (int g = 0; g < q.nprogs; ++g) {
        const int c0 = ptab[3 * g], c1 = ptab[3 * g + 1], unique = ptab[3 * g + 2];
        int kept = 0;
        unsigned mk = 0u;  // the word of pieces c0 + 32 w .. of the lane's point
        for (int c = c0; c < c1; ++c) {
          const int i = (c - c0) & 31;
          if (i == 0 && live)
            mk = fiat::rule_word(fiat::piece_bits<SD>(q.maps, c0, c1, (c - c0) >> 5, x, best),
                                 unique, kept);
          const unsigned m = __ballot_sync(FULL, (mk >> i) & 1u);
          if (lane == (c & 31)) mq[c] = m;
        }
        tie |= kept > 1;
        hc[32 * g + lane] = static_cast<unsigned short>(min(kept, 0xffff));
      }
      ties = __any_sync(FULL, tie);
    }

    // cell map onto the default (-1, 1) simplex, as K1's
    double y[SD];
#pragma unroll
    for (int i = 0; i < SD; ++i) {
      double v = x[0] * q.affine[SD * i];
#pragma unroll
      for (int k = 1; k < SD; ++k) v += x[k] * q.affine[SD * i + k];
      y[i] = v + q.affine[SD * SD + i];
    }
    if constexpr (kGeneric) {
      if constexpr (SD == 1) {
        fiat::dubiner1_point_n(q.degree, y[0], q.consts, q.scale, put);
      } else if constexpr (SD == 2) {
        fiat::dubiner2_point_n(q.degree, y[0], y[1], q.consts, q.scale,
                               [&](int e, int, int, double v) { put(e, v); });
      } else {
        fiat::dubiner3_point_n(q.degree, y[0], y[1], y[SD - 1], q.consts, q.scale, put);
      }
    } else if constexpr (SD == 1) {
      fiat::dubiner1_point<N>(y[0], consts, q.scale, put);
    } else if constexpr (SD == 2) {
      fiat::dubiner2_point<N>(y[0], y[1], consts, q.scale,
                              [&](int e, int, int, double v) { put(e, v); });
    } else {
      fiat::dubiner3_point<N>(y[0], y[1], y[SD - 1], consts, q.scale, put);
    }
  }

  // the block's partial: each warp's plain sums into its slab by member,
  // then every row summed over the warps in order
  __syncwarp();
  if constexpr (!kGeneric) {
#pragma unroll
    for (int c = 0; c < NCH_U; ++c) {
      const int j = member(c);
      if (j < q.nplain) slab[j] = plain[c];
    }
  }
  __syncthreads();
  double* part = q.partials + static_cast<size_t>(blockIdx.x) * q.R;
  const int acc_at = SLAB + masks_doubles(q.npieces, q.nprogs);
  const int plain_at = kGeneric ? acc_at + even_doubles(8LL * PR) : 0;
  for (int r = threadIdx.x; r < q.R; r += blockDim.x) {
    double s = 0.0;
    for (int wi = 0; wi < warps; ++wi) {
      const double* b = wbase + wi * WD;
      s += r < q.nplain ? b[plain_at + r] : b[acc_at + r - q.nplain];
    }
    part[r] = s;
  }

  // the partials are summed in the same launch, in two levels: the last
  // block of each group of GROUP blocks to finish sums its group's in block
  // order, the last group to finish sums the groups' in group order
  __threadfence();
  __syncthreads();
  const int nb = gridDim.x, ngroups = (nb + GROUP - 1) / GROUP;
  const int g = blockIdx.x / GROUP, b0 = g * GROUP, b1 = min(b0 + GROUP, nb);
  if (threadIdx.x == 0) last = atomicAdd(q.tickets + 1 + g, 1u) == b1 - b0 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double* groups = q.partials + static_cast<size_t>(nb) * q.R;  // (ngroups, R)
  for (int r = threadIdx.x; r < q.R; r += blockDim.x) {
    double s = 0.0;
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s += __ldcg(q.partials + static_cast<size_t>(b) * q.R + r);
    groups[static_cast<size_t>(g) * q.R + r] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    q.tickets[1 + g] = 0u;
    last = atomicAdd(q.tickets, 1u) == ngroups - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < q.R; r += blockDim.x) {
    double s = 0.0;
#pragma unroll 8
    for (int gi = 0; gi < ngroups; ++gi) s += __ldcg(groups + static_cast<size_t>(gi) * q.R + r);
    q.out[r] = s;
  }
  if (threadIdx.x == 0) q.tickets[0] = 0u;
}

template <int SD, int N>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(pair_moments_kernel<SD, N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// consts: the host's copy (the unrolled instantiations put it in the
// parameters); the generic one reads q.consts on the device.
template <int SD, int N>
int launch(const Params& q, const double* consts, int warps, int nblocks, cudaStream_t stream) {
  if (warps > block_warps(SD, N)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(warps, q.R - q.nplain, q.npieces, q.nprogs, N < 0 ? q.nplain : 0);
  const cudaError_t err = allow_smem<SD, N>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return static_cast<int>(err);
  }
  Consts<SD, N> table;
  if constexpr (N >= 0)
    for (int i = 0; i < nconst_of(SD, N); ++i) table.v[i] = consts[i];
  pair_moments_kernel<SD, N><<<nblocks, 32 * warps, smem, stream>>>(q, table);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM (registers and shared memory both counted), or
// minus the CUDA error.
template <int SD, int N>
int occupancy(int warps, int piece_rows, int npieces, int nprogs, int nplain) {
  if (warps > block_warps(SD, N)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(warps, piece_rows, npieces, nprogs, N < 0 ? nplain : 0);
  int blocks = 0;
  cudaError_t err = allow_smem<SD, N>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pair_moments_kernel<SD, N>,
                                                        32 * warps, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return blocks;
}

// The generic instantiation's launch and occupancy query.
template <int SD>
int launch_generic(const Params& q, int warps, int nblocks, cudaStream_t stream) {
  return launch<SD, fiat::GENERIC>(q, nullptr, warps, nblocks, stream);
}
template <int SD>
int occupancy_generic(int warps, int piece_rows, int npieces, int nprogs, int nplain) {
  return occupancy<SD, fiat::GENERIC>(warps, piece_rows, npieces, nprogs, nplain);
}

// Every degree of one sd: the launch and the occupancy query, the unrolled
// instantiations to unrolled_top(SD) and the generic one past it;
// cudaErrorInvalidValue for a negative degree.
template <int SD>
int launch_by_degree(const Params& q, const double* consts, int degree, int warps, int nblocks,
                     cudaStream_t stream) {
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    return launch<SD, n>(q, consts, warps, nblocks, stream);
#define FIAT_CASE_1D(n)                                                        \
  case n:                                                                      \
    if constexpr (SD == 1) return launch<SD, n>(q, consts, warps, nblocks, stream); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
    FIAT_CASE_1D(11) FIAT_CASE_1D(12) FIAT_CASE_1D(13) FIAT_CASE_1D(14) FIAT_CASE_1D(15)
#undef FIAT_CASE_1D
#undef FIAT_CASE
    default:
      break;
  }
  if (degree > unrolled_top(SD)) return launch_generic<SD>(q, warps, nblocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int SD>
int occupancy_by_degree(int degree, int warps, int piece_rows, int npieces, int nprogs,
                        int nplain) {
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    return occupancy<SD, n>(warps, piece_rows, npieces, nprogs, nplain);
#define FIAT_CASE_1D(n)                                                                    \
  case n:                                                                                  \
    if constexpr (SD == 1) return occupancy<SD, n>(warps, piece_rows, npieces, nprogs, nplain); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
    FIAT_CASE_1D(11) FIAT_CASE_1D(12) FIAT_CASE_1D(13) FIAT_CASE_1D(14) FIAT_CASE_1D(15)
#undef FIAT_CASE_1D
#undef FIAT_CASE
    default:
      break;
  }
  if (degree > unrolled_top(SD))
    return occupancy_generic<SD>(warps, piece_rows, npieces, nprogs, nplain);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// sd = 3 is instantiated in moments3.cu, sd = 1 in moments1.cu
extern template int launch_by_degree<3>(const Params&, const double*, int, int, int,
                                        cudaStream_t);
extern template int occupancy_by_degree<3>(int, int, int, int, int, int);
extern template int launch_by_degree<1>(const Params&, const double*, int, int, int,
                                        cudaStream_t);
extern template int occupancy_by_degree<1>(int, int, int, int, int, int);

}  // namespace fiat::k45
