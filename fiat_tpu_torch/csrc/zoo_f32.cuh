// K6's kernel template and its launch (csrc/zoo_f32.cu has the design notes
// and the C entry; four sources each instantiate one cell and point tile, so
// that nvcc builds them in parallel).  Past the unrolled degrees (0..15 on
// intervals and triangles, 0..10 on tetrahedra) each (cell, point tile) has
// one generic instantiation (N = GENERIC) that takes the degree at the
// launch and runs the streaming recurrence (dubiner*_point_n), its two
// threads a point splitting the stage-1 rows by second_rows_n.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bulk_copy.cuh"
#include "dubiner1.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace fiat::k6 {

constexpr int TR = 128;           // rows of a row tile
constexpr int WARP_ROWS = 32;     // a warp tile: 32 rows x 64 points,
constexpr int WARP_POINTS = 64;   // 8 rows x 8 points a lane
constexpr int DEPTH = 2;          // k-steps of one turn of the product loop
constexpr int STAGES = 4;         // the most A chunks in the ring
constexpr int THREADS_SM = 512;   // launch bounds: 128 registers a thread
constexpr int TILE_COLS = 4 + TR / WARP_ROWS;  // columns of the tile table

// Threads of a block of TP points: 4 warps along the rows of a row tile,
// TP / 64 along the points, two threads a point in the recurrence.
__host__ __device__ constexpr int threads_of(int tp) { return TR / WARP_ROWS * tp / 2; }

// The stage-1 rows of a degree-N recurrence that the second thread of a
// point computes (a bit each), the first thread the others: the rows go,
// widest first, to the thread with fewer entries so far.
__host__ __device__ constexpr unsigned second_rows(int sd, int n) {
  unsigned mask = 0;
  int load[2] = {0, 0};
  for (int r = 0; r <= n; ++r) {
    const int entries = sd == 2 ? n - r + 1 : (n - r + 1) * (n - r + 2) / 2;
    const int h = load[1] < load[0] ? 1 : 0;
    load[h] += entries;
    if (h) mask |= 1u << r;
  }
  return mask;
}
// second_rows at a degree given at run time, up to 63 (the generic
// instantiation; fiat_zoo_f32 refuses past it on triangles and tetrahedra)
__host__ __device__ inline unsigned long long second_rows_n(int sd, int n) {
  unsigned long long mask = 0;
  int load[2] = {0, 0};
  for (int r = 0; r <= n; ++r) {
    const int entries = sd == 2 ? n - r + 1 : (n - r + 1) * (n - r + 2) / 2;
    const int h = load[1] < load[0] ? 1 : 0;
    load[h] += entries;
    if (h) mask |= 1ull << r;
  }
  return mask;
}
__host__ __device__ constexpr int unrolled_top(int sd) { return sd == 3 ? 10 : 15; }
constexpr int MAX_GENERIC_DEGREE = 63;

// shared memory a block may take on sm_90, an SM's, what the SM keeps for
// each resident block, and the unit it allocates a block's in
constexpr size_t SMEM_MAX = 232448, SMEM_SM = 233472, SMEM_BLOCK = 1024, SMEM_UNIT = 128;

struct Params {
  const float* pts;
  int npts;
  const float* consts;
  const int* slots;   // sd = 3: each recurrence entry's member
  float aff[12];      // the affine map onto the default simplex: A row-major, then b
  float scale;
  const float* At;    // (sum of the tiles' widths, TR): every row tile transposed
  int kpad, kmax;     // Phi tile rows (kmax rounded up to DEPTH), Phi rows the rows read
  const int* tiles;   // (ntiles, TILE_COLS): first row, rows, width, first row of At,
                      // then the width of each warp's 32 rows (0 past the rows)
  int ntiles;
  const int* dst;
  float* out;
  int kc, stages;     // A rows of a chunk, chunks in the ring
  int degree;         // the generic instantiation's degree
  float* phi;         // the wide mode (zoo_f32_wide.cu): its Phi, (kpad, ldphi)
  int ldphi;
  int group;          // and the row tiles of a group of its product's grid
};

// The generic instantiation's recurrence of point p (coordinates 0 past
// npts) at the run-time degree q.degree, the share of thread `half` of the
// point's two: put(m, v) for each value v of member m it computes (the
// interval's first thread runs the whole loop).
template <int SD, class Put>
__device__ __forceinline__ void generic_point(const Params& q, int p, int half, Put put) {
  const int n = q.degree, npts = q.npts;
  const auto& a = q.aff;
  if constexpr (SD == 1) {
    const float px = p < npts ? q.pts[p] : 0.0f;
    const float x0 = px * a[0] + a[1];
    if (half == 0) fiat::dubiner1_point_n(n, x0, q.consts, q.scale, put);
  } else {
    const unsigned long long second_n = second_rows_n(SD, n);
    auto mine_n = [&](int r) { return static_cast<int>((second_n >> r) & 1ull) == half; };
    if constexpr (SD == 2) {
      const float px = p < npts ? q.pts[2 * p] : 0.0f;
      const float py = p < npts ? q.pts[2 * p + 1] : 0.0f;
      const float x0 = (px * a[0] + py * a[1]) + a[4];
      const float x1 = (px * a[2] + py * a[3]) + a[5];
      fiat::dubiner2_point_n(
          n, x0, x1, q.consts, q.scale,
          [&](int, int r, int i, float v) { put((r + i) * (r + i + 1) / 2 + i, v); }, mine_n);
    } else {
      const float px = p < npts ? q.pts[3 * p] : 0.0f;
      const float py = p < npts ? q.pts[3 * p + 1] : 0.0f;
      const float pz = p < npts ? q.pts[3 * p + 2] : 0.0f;
      const float x0 = (px * a[0] + py * a[1] + pz * a[2]) + a[9];
      const float x1 = (px * a[3] + py * a[4] + pz * a[5]) + a[10];
      const float x2 = (px * a[6] + py * a[7] + pz * a[8]) + a[11];
      fiat::dubiner3_point_n(
          n, x0, x1, x2, q.consts, q.scale,
          [&](int e, float v) { put(__ldg(q.slots + e), v); }, mine_n);
    }
  }
}

// Shared memory of a block: the Phi tile, the ring of A chunks, and the
// ring's two mbarriers and counter a buffer.
__host__ __device__ constexpr size_t smem_bytes(int kpad, int tp, int kc, int stages) {
  return sizeof(float) * (static_cast<size_t>(kpad) * tp + static_cast<size_t>(stages) * kc * TR) +
         3 * sizeof(uint64_t) * STAGES;
}

template <int SD, int N, int TP>
__global__ void __launch_bounds__(threads_of(TP), THREADS_SM / threads_of(TP))
zoo_f32_kernel(const __grid_constant__ Params q) {
  constexpr int W = threads_of(TP) / 32;     // warps
  constexpr int WN = TP / WARP_POINTS;       // of them along the points (4 along the rows)
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                                           // [kpad][TP]: Phi
  float* As = Bs + static_cast<size_t>(q.kpad) * TP;          // stages x [kc][TR]: A chunks
  uint64_t* full = reinterpret_cast<uint64_t*>(As + static_cast<size_t>(q.stages) * q.kc * TR);
  uint64_t* empty = full + STAGES;                                              // [STAGES]
  unsigned* done = reinterpret_cast<unsigned*>(empty + STAGES);  // [STAGES]: warps done
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * TP, npts = q.npts, ntiles = q.ntiles, kc = q.kc;
  const int stages = q.stages;

  // the ring's chunks: every row tile's in turn, kc rows of k at a time
  struct Chunk {
    int tile, k0, kt;
  };
  auto width = [&](int t) { return __ldg(q.tiles + TILE_COLS * t + 2); };
  auto next = [&](Chunk c) {
    if (c.tile >= ntiles) return c;
    c.k0 += kc;
    if (c.k0 >= c.kt) {
      c.k0 = 0;
      if (++c.tile < ntiles) c.kt = width(c.tile);
    }
    return c;
  };
  // chunk c into ring buffer s, completing on its mbarrier: one contiguous copy
  auto fetch = [&](Chunk c, int s) {
    bulk_copy(As + static_cast<size_t>(s) * kc * TR,
              q.At + (static_cast<size_t>(__ldg(q.tiles + TILE_COLS * c.tile + 3)) + c.k0) * TR,
              sizeof(float) * min(kc, c.kt - c.k0) * TR, full + s);
  };
  Chunk ahead = {0, 0, ntiles > 0 ? width(0) : 0};  // the next chunk to fetch
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);   // the fetching thread's arrival, plus the copy's bytes
      mbar_init(empty + s, W);  // one arrival a warp
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // fill the ring: its copies run beside the recurrence
  for (int s = 0; s < stages; ++s) {
    if (tid == 0 && ahead.tile < ntiles) fetch(ahead, s);
    ahead = next(ahead);
  }

  // the Phi tile: two threads run the recurrence of one point, each its half
  // of the stage-1 rows (second_rows), and write each value to its member's
  // row of the point's column; members past kmax are read by no tile.  The
  // columns of a pair of points are swapped (pt ^ 1, see fma8)
  {
    const int pt = tid % TP, half = tid / TP;  // warp-uniform: no divergence
    const int p = p0 + pt;
    const int kmax = q.kmax;
    constexpr unsigned second = second_rows(SD, N < 0 ? 0 : N);
    auto mine = [&](int r) { return static_cast<int>((second >> r) & 1u) == half; };
    const auto& a = q.aff;
    if constexpr (N < 0) {
      // the generic instantiation: the same Phi tile at a run-time degree
      generic_point<SD>(q, p, half, [&](int m, float v) {
        if (m < kmax) Bs[m * TP + (pt ^ 1)] = v;
      });
    } else if constexpr (SD == 1) {
      // the interval's recurrence is one loop of N + 1 levels: the first
      // thread of each point runs it alone
      const float px = p < npts ? q.pts[p] : 0.0f;
      const float x0 = px * a[0] + a[1];
      if (half == 0)
        fiat::dubiner1_point<N>(x0, q.consts, q.scale, [&](int m, float v) {
          if (m < kmax) Bs[m * TP + (pt ^ 1)] = v;
        });
    } else if constexpr (SD == 2) {
      const float px = p < npts ? q.pts[2 * p] : 0.0f;
      const float py = p < npts ? q.pts[2 * p + 1] : 0.0f;
      const float x0 = (px * a[0] + py * a[1]) + a[4];
      const float x1 = (px * a[2] + py * a[3]) + a[5];
      fiat::dubiner2_point<N>(
          x0, x1, q.consts, q.scale,
          [&](int, int r, int i, float v) {
            const int m = (r + i) * (r + i + 1) / 2 + i;
            if (m < kmax) Bs[m * TP + (pt ^ 1)] = v;
          },
          mine);
    } else {
      const float px = p < npts ? q.pts[3 * p] : 0.0f;
      const float py = p < npts ? q.pts[3 * p + 1] : 0.0f;
      const float pz = p < npts ? q.pts[3 * p + 2] : 0.0f;
      const float x0 = (px * a[0] + py * a[1] + pz * a[2]) + a[9];
      const float x1 = (px * a[3] + py * a[4] + pz * a[5]) + a[10];
      const float x2 = (px * a[6] + py * a[7] + pz * a[8]) + a[11];
      fiat::dubiner3_point<N>(
          x0, x1, x2, q.consts, q.scale,
          [&](int e, float v) {
            const int m = N == 0 ? 0 : __ldg(q.slots + e);
            if (m < kmax) Bs[m * TP + (pt ^ 1)] = v;
          },
          mine);
    }
    if (half == 0)
      for (int k = kmax; k < q.kpad; ++k) Bs[k * TP + pt] = 0.0f;  // a tile's even width
  }
  __syncthreads();  // the last block barrier: the Phi tile is complete

  const int wr = warp / WN, wp = warp % WN;    // the warp tile's place in the block tile
  const int rg = lane >> 3, pg = lane & 7;     // the lane's row group and point group
  const int row_l = wr * WARP_ROWS + 8 * rg;   // the lane's rows: row_l .. row_l + 7
  const int pt_l = wp * WARP_POINTS + 4 * pg;  // the lane's points: pt_l + {0..3, 32..35}
  // 16-byte stores need a whole tile and 16-byte aligned rows of out
  const bool whole = (p0 + TP <= npts) && ((npts & 3) == 0) &&
                     ((reinterpret_cast<uintptr_t>(q.out) & 15) == 0);

  float4 acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  // b[j] holds the Phi of points (1, 0, 3, 2) of the lane's four: an FMA's
  // accumulator and Phi operand then sit in registers of opposite parity,
  // in the two register banks (with both in one bank, each FMA waits a
  // cycle for its operands: 8% of tet_lagrange8's time, PERF.md)
  auto fma8 = [&](const float4 (&a)[2], const float4 (&b)[2]) {
    const float av[8] = {a[0].x, a[0].y, a[0].z, a[0].w, a[1].x, a[1].y, a[1].z, a[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j].x = fmaf(av[i], b[j].y, acc[i][j].x);
        acc[i][j].y = fmaf(av[i], b[j].x, acc[i][j].y);
        acc[i][j].z = fmaf(av[i], b[j].w, acc[i][j].z);
        acc[i][j].w = fmaf(av[i], b[j].z, acc[i][j].w);
      }
  };

  int qn = 0;  // chunks consumed
  for (int tile = 0; tile < ntiles; ++tile) {
    const int kt = width(tile);
    const int* tile_q = q.tiles + TILE_COLS * tile;
    const int row0 = __ldg(tile_q), nrows = __ldg(tile_q + 1);
    // the warp's rows contract to their own widest (a tile that spans two
    // width groups, or rows past a ragged tile's: 0, the warp only keeps
    // the ring going)
    const int kw = __ldg(tile_q + 4 + wr);
    for (int k0 = 0; k0 < kt; k0 += kc, ++qn) {
      const int kn = max(0, min(kc, kw - k0));  // even: kc and every width are
      const int s = qn % stages;
      mbar_wait(full + s, (qn / stages) & 1);  // this chunk has landed
      const float* Ak = As + static_cast<size_t>(s) * kc * TR + row_l;
      const float* Bk = Bs + k0 * TP + pt_l;
      auto load = [&](float4 (&a)[2], float4 (&b)[2], int k) {
        a[0] = *reinterpret_cast<const float4*>(Ak + k * TR);
        a[1] = *reinterpret_cast<const float4*>(Ak + k * TR + 4);
        b[0] = *reinterpret_cast<const float4*>(Bk + k * TP);
        b[1] = *reinterpret_cast<const float4*>(Bk + k * TP + 32);
      };
      // two sets of fragments: each k-step's loads run beside the last one's FMAs
      float4 a0[2], b0[2], a1[2], b1[2];
      if (kn) load(a0, b0, 0);
#pragma unroll 1
      for (int kk = 0; kk < kn; kk += DEPTH) {
        load(a1, b1, kk + 1);
        fma8(a0, b0);
        load(a0, b0, min(kk + 2, kn - 1));  // past the chunk: a row it never uses again
        fma8(a1, b1);
      }
      __syncwarp();  // every lane's reads of this buffer are done
      if (lane == 0) {
        mbar_arrive(empty + s);
        // the last warp done with the buffer resets its count and refills it
        if (atomicAdd(done + s, 1u) == W - 1) {
          done[s] = 0;
          if (ahead.tile < ntiles) {
            mbar_wait(empty + s, (qn / stages) & 1);  // every warp's reads, acquired
            fiat::fence_async_smem();  // order those reads before the copy's writes
            fetch(ahead, s);
          }
        }
      }
      ahead = next(ahead);
    }

    // the tile's products are done: each row of the lane goes to its row of
    // out as two 16-byte stores (8 lanes write a row group's 128 contiguous
    // bytes), evict-first
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (row_l + i < nrows) {
        float* orow = q.out + static_cast<size_t>(__ldg(q.dst + row0 + row_l + i)) * npts + p0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = pt_l + 32 * j;
          if (whole) {
            __stcs(reinterpret_cast<float4*>(orow + p), acc[i][j]);
          } else {  // a ragged or unaligned tile: one value at a time
            if (p0 + p < npts) __stcs(orow + p, acc[i][j].x);
            if (p0 + p + 1 < npts) __stcs(orow + p + 1, acc[i][j].y);
            if (p0 + p + 2 < npts) __stcs(orow + p + 2, acc[i][j].z);
            if (p0 + p + 3 < npts) __stcs(orow + p + 3, acc[i][j].w);
          }
        }
      }
      acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int SD, int N, int TP>
int launch(const Params& q, cudaStream_t stream) {
  const size_t bytes = smem_bytes(q.kpad, TP, q.kc, q.stages);
  auto kernel = zoo_f32_kernel<SD, N, TP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return static_cast<int>(err);
  }
  kernel<<<(q.npts + TP - 1) / TP, threads_of(TP), bytes, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// with `bytes` of shared memory a block, or minus the CUDA error.
template <int SD, int N, int TP>
int occupancy(size_t bytes) {
  auto kernel = zoo_f32_kernel<SD, N, TP>;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads_of(TP), bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return blocks;
}

// launch (or, with `bytes` > 0, the occupancy query) of degree `degree`
template <int SD, int TP>
int by_degree(const Params& q, int degree, size_t bytes, cudaStream_t s) {
  switch (degree) {
#define FIAT_CASE(n)                                                    \
  case n:                                                               \
    if constexpr (SD != 3 || n <= 10)                                   \
      return bytes ? occupancy<SD, n, TP>(bytes) : launch<SD, n, TP>(q, s); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10) FIAT_CASE(11)
    FIAT_CASE(12) FIAT_CASE(13) FIAT_CASE(14) FIAT_CASE(15)
#undef FIAT_CASE
    default:
      break;
  }
  if (degree > unrolled_top(SD))  // the generic instantiation
    return bytes ? occupancy<SD, fiat::GENERIC, TP>(bytes) : launch<SD, fiat::GENERIC, TP>(q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Each source instantiates one (cell, point tile): zoo_f32.cu (2, 128),
// zoo_f32_3.cu (3, 128), zoo_f32_64.cu (2, 64), zoo_f32_3_64.cu (3, 64),
// and zoo_f32_1.cu both of the interval's, (1, 128) and (1, 64).
#define FIAT_K6_EXTERN(SD, TP) \
  extern template int by_degree<SD, TP>(const Params&, int, size_t, cudaStream_t);
#define FIAT_K6_INSTANTIATE(SD, TP) \
  template int by_degree<SD, TP>(const Params&, int, size_t, cudaStream_t);
FIAT_K6_EXTERN(2, 128)
FIAT_K6_EXTERN(3, 128)
FIAT_K6_EXTERN(2, 64)
FIAT_K6_EXTERN(3, 64)
FIAT_K6_EXTERN(1, 128)
FIAT_K6_EXTERN(1, 64)

}  // namespace fiat::k6
