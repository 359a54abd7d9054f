// K3's kernel template and its launch (csrc/macro_oneshot.cu has the
// design note and the C entry points).
//
// Past the unrolled degrees (0..15 at SD = 1, 0..10 at SD = 2 and 3) each
// (SD, RC, T) has one generic instantiation (N = GENERIC): the degree is a
// launch argument, the recurrence the streaming dubiner*_point_n, and the
// point tile (the block's threads) a launch argument too, 128, 64 or 32,
// since the Phi tile of a high degree outgrows shared memory at 128 points
// (triangle degree 20: 232 x 128 doubles, 237 KB; tet degree 14 at 64
// points: 681 x 64 doubles, 348 KB) and the plan narrows the tile to fit
// (ops/macro_oneshot.py GENERIC_TILES).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "binning.cuh"
#include "bulk_copy.cuh"
#include "dubiner1.cuh"
#include "dubiner2.cuh"
#include "dubiner3.cuh"

namespace fiat::k3 {

constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr int MAX_SUB = 8;      // point tiles a block may walk
constexpr int MAX_STAGES = 4;   // buffers of a streaming ring
constexpr int RC_TABLES = 32;   // rows per chunk (ops/macro_oneshot.py CHUNK_ROWS, as K7's)
constexpr int RC_ONE = 1;       // one row per program (ONE_ROW_CHUNK)
constexpr int ROW_GROUP = 8;    // rows a chunk skips at a time past its last row
constexpr int SLICE_COLS = 11;  // columns of the slice table (ops/macro_oneshot.py)
constexpr int FIRST_IN_CHUNK = 1, LAST_IN_CHUNK = 2;

// values per staged column (ops/macro_oneshot.py column_stride): an even
// stride past RC keeps 16-byte pairs aligned and spreads the pieces' columns
// over the banks; a one-row chunk is read one value at a time
__host__ __device__ constexpr int column_stride(int rc) { return rc > 1 ? rc + 2 : 1; }
__host__ __device__ constexpr int nexp_of(int sd, int n) {
  return sd == 1 ? n + 1 : sd == 2 ? (n + 1) * (n + 2) / 2 : (n + 1) * (n + 2) * (n + 3) / 6;
}
// Points (threads) of a block (ops/macro_oneshot.py point_tile): 128, but
// 64 on tetrahedra from degree 9 in double, whose Phi tile of 128 points
// (220 or 286 members) alone passes a block's shared memory.  A constant
// of the instantiation: the Phi tile's stride then folds into each
// address (a stride read at run time took registers enough for the
// recurrence to spill, and K3's time on the earlier cells up to +68%, on
// the H100), and the H100 timed 128 points fastest on every plan of every
// cell where 64 and 32 fit too (PERF.md section 6).
// (The generic instantiation: at most 128, the launch's choice.)
template <int SD, int N, class T>
__host__ __device__ constexpr int point_tile() {
  return SD == 3 && N >= 9 && sizeof(T) == 8 ? 64 : 128;
}
// the generic instantiation's point tiles (ops/macro_oneshot.py GENERIC_TILES)
__host__ __device__ constexpr bool generic_tile(int tp) { return tp == 128 || tp == 64 || tp == 32; }
__host__ __device__ constexpr int unrolled_top(int sd) { return sd == 1 ? 15 : 10; }

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
// b takes group b / tile_blocks of the slice table (groups[g] .. groups[g +
// 1] - 1) and the point tiles from (b % tile_blocks) * sub on, sub of them
// or up to the last (tile_blocks is set by the launch, from its point
// tile).
template <class T>
struct Params {
  const T* pts;
  int npts;
  const T* consts;
  const int* slots;
  T affine[12];
  T scale, tol;
  const T* maps;
  const int* pieces;
  const int* slices;
  const int* groups;
  int tile_blocks, sub;
  int resident;  // 1: each slice of the group in shared memory for the whole block
  int stages;    // buffers of the streaming ring
  int buf;       // values of one buffer of the streaming ring
  int ring;      // values of shared memory before the Phi tile (a multiple of 16 bytes)
  int nbar;      // mbarriers of each kind: the ring's buffers (none where resident)
  int words;     // mask words a point: words_of(the widest program)
  const T* At;
  const int* gather;  // resident: At[gather[i]] (0 where -1) is the slices' value i; or null
  T* out;
  int degree;  // the generic instantiation's degree
};

// Shared memory of a block of tp points: the ring (or the group's resident
// slices), the Phi tile and each point's factor, its mask words, and per
// buffer of a ring a full and an empty mbarrier and a counter.
template <class T>
__host__ __device__ constexpr size_t smem_bytes(int nexp, int tp, int ring, int words,
                                                int nbar) {
  return sizeof(T) * (static_cast<size_t>(ring) + static_cast<size_t>(nexp + 1) * tp) +
         sizeof(unsigned) * static_cast<size_t>(words) * tp +
         (2 * sizeof(uint64_t) + sizeof(unsigned)) * static_cast<size_t>(nbar);
}

template <int SD, int N, int RC, class T>
__global__ void __launch_bounds__(point_tile<SD, N, T>())
    macro_oneshot_kernel(const __grid_constant__ Params<T> q) {
  using P2 = typename Pair<T>::type;
  constexpr bool kGeneric = N < 0;
  constexpr int RCP = column_stride(RC);
  constexpr int G = RC < ROW_GROUP ? RC : ROW_GROUP;
  // the unrolled instantiations' members and point tile are constants;
  // the generic one's come with the launch
  const int NE = kGeneric ? nexp_of(SD, q.degree) : nexp_of(SD, N);
  const int tp = kGeneric ? static_cast<int>(blockDim.x) : point_tile<SD, N, T>();
  // one-row chunks: unrolled k steps, so the loads of one run ahead of the
  // FMA chain of another
  constexpr int K_UNROLL = RC == 1 ? 4 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwarps = tp / 32;
  const int tid = threadIdx.x, lane = tid & 31;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* phi = ring + q.ring + tid;  // this thread's column: member k at phi[k * tp]
  // this thread's factor of its chunk's program, kept in shared memory (as
  // its words and the program's pieces, read again for each slice), so that
  // only the accumulators and the point live in registers across slices
  T* recip = ring + q.ring + NE * tp + tid;
  unsigned* words_base = reinterpret_cast<unsigned*>(ring + q.ring + (NE + 1) * tp);
  unsigned* words = words_base + tid;  // this thread's mask word w at words[w * tp]
  uint64_t* full = reinterpret_cast<uint64_t*>(words_base + q.words * tp);  // [nbar]
  uint64_t* empty = full + q.nbar;                                         // [nbar]
  unsigned* done = reinterpret_cast<unsigned*>(empty + q.nbar);            // [nbar]

  const int group = blockIdx.x / q.tile_blocks;
  const int tile0 = (blockIdx.x - group * q.tile_blocks) * q.sub;
  const int first = __ldg(q.groups + group), n = __ldg(q.groups + group + 1) - first;
  const int tiles = min(q.sub, (q.npts + tp - 1) / tp - tile0);
  const int visits = tiles * n;  // the block walks its group's slices once a tile
  const bool resident = q.resident != 0;
  const int stages = q.stages;
  const int base = __ldg(q.slices + SLICE_COLS * first + 5);  // the group's first value in At

  // slice t of the group into shared memory at dst: one contiguous copy
  auto fetch = [&](int t, T* dst, uint64_t* bar) {
    const int* sl = q.slices + SLICE_COLS * (first + t);
    fiat::bulk_copy(dst, q.At + __ldg(sl + 5), sizeof(T) * __ldg(sl + 8), bar);
  };
  if (resident) {
    // the group's slices, one contiguous span of At, by 16-byte loads of
    // every thread: they land beside the first tile's recurrence, which
    // needs no shared A, and a barrier after it waits for them (no
    // mbarriers: the H100 timed them slower where the block holds its
    // chunks, PERF.md section 6)
    const int* last = q.slices + SLICE_COLS * (first + n - 1);
    const int end = __ldg(last + 5) + __ldg(last + 8);
    if (q.gather) {  // one row a program: the call's A, laid out by the table
      for (int i = base + tid; i < end; i += tp) {
        const int from = __ldg(q.gather + i);
        ring[i - base] = from >= 0 ? __ldg(q.At + from) : T(0);
      }
    } else {
      const int4* src = reinterpret_cast<const int4*>(q.At + base);
      int4* dst = reinterpret_cast<int4*>(ring);
      for (int i = tid; i < static_cast<int>((end - base) * sizeof(T) / 16); i += tp)
        dst[i] = __ldg(src + i);
    }
  } else {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        fiat::mbar_init(full + s, 1);        // the fetching thread's arrival, plus the bytes
        fiat::mbar_init(empty + s, nwarps);  // one arrival a warp
        done[s] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // the ring's first slices: their copies run beside the first tile's
    // recurrence
    if (tid == 0)
      for (int s = 0; s < stages && s < visits; ++s) fetch(s % n, ring + s * q.buf, full + s);
  }

  const size_t ld = static_cast<size_t>(q.npts);
  T acc[RC];
  for (int s = 0; s < tiles; ++s) {
    const int p = (tile0 + s) * tp + tid;
    const bool live = p < q.npts;
    T x[SD], best = T(0);
    if (live) {
#pragma unroll
      for (int i = 0; i < SD; ++i) x[i] = q.pts[static_cast<size_t>(SD) * p + i];

      // 1. the parent recurrence into this thread's column of the Phi tile,
      //    once a tile for every chunk of the group
      T y[SD];
#pragma unroll
      for (int i = 0; i < SD; ++i) {
        T v = x[0] * q.affine[SD * i];
#pragma unroll
        for (int j = 1; j < SD; ++j) v += x[j] * q.affine[SD * i + j];
        y[i] = v + q.affine[SD * SD + i];
      }
      if constexpr (kGeneric) {
        if constexpr (SD == 1) {
          fiat::dubiner1_point_n(q.degree, y[0], q.consts, q.scale,
                                 [&](int i, T v) { phi[i * tp] = v; });
        } else if constexpr (SD == 2) {
          fiat::dubiner2_point_n(q.degree, y[0], y[1], q.consts, q.scale,
                                 [&](int, int r, int i, T v) {
                                   phi[((r + i) * (r + i + 1) / 2 + i) * tp] = v;
                                 });
        } else {
          fiat::dubiner3_point_n(q.degree, y[0], y[1], y[2], q.consts, q.scale,
                                 [&](int e, T v) { phi[__ldg(q.slots + e) * tp] = v; });
        }
      } else if constexpr (SD == 1) {
        fiat::dubiner1_point<N>(y[0], q.consts, q.scale, [&](int i, T v) { phi[i * tp] = v; });
      } else if constexpr (SD == 2) {
        fiat::dubiner2_point<N>(y[0], y[1], q.consts, q.scale, [&](int, int r, int i, T v) {
          phi[((r + i) * (r + i + 1) / 2 + i) * tp] = v;
        });
      } else {
        fiat::dubiner3_point<N>(y[0], y[1], y[2], q.consts, q.scale, [&](int e, T v) {
          phi[(N == 0 ? 0 : __ldg(q.slots + e)) * tp] = v;
        });
      }
      best = fiat::parent_bound<SD>(q.maps, x, q.tol);
    }
    if (s == 0 && resident) __syncthreads();  // the resident slices have landed

    for (int t = 0; t < n; ++t) {
      const int u = s * n + t;
      const int* sl = q.slices + SLICE_COLS * (first + t);
      const int flags = __ldg(sl + 7);
      const int c0 = __ldg(sl + 9), c1 = c0 + __ldg(sl + 6);
      if (flags & FIRST_IN_CHUNK) {
        // 2. binning against the chunk's program, word by word into this
        //    thread's column of the mask words: bit i of word w is the mask
        //    of piece c0 + 32 w + i
        const int unique = __ldg(sl + 10);
        int kept = 0;
        for (int w = 0; 32 * w < c1 - c0; ++w)
          words[w * tp] =
              live ? fiat::rule_word(fiat::piece_bits<SD>(q.maps, c0, c1, w, x, best), unique, kept)
                   : 0u;
        *recip = fiat::program_recip<T>(kept, unique);
#pragma unroll
        for (int r = 0; r < RC; ++r) acc[r] = T(0);
      }
      const int nrows = __ldg(sl + 2), k0 = __ldg(sl + 3), k1 = __ldg(sl + 4);
      const int stride = __ldg(sl + 6) * RCP;  // between a piece's columns k and k + 1
      const T* buf;
      if (resident) {
        buf = ring + (__ldg(sl + 5) - base);
      } else {
        buf = ring + (u % stages) * q.buf;
        fiat::mbar_wait(full + u % stages, (u / stages) & 1);  // this slice has landed
      }

      // 3. the hit pieces' columns of this slice (a run of k) times phi's
      //    prefix, one chain per row; a group of G rows past the chunk's
      //    last row is skipped (the test is the same for the whole block),
      //    so a short tail chunk pays for its rows rounded up to G, not RC
      for (int w = 0; 32 * w < c1 - c0; ++w) {
        unsigned m = words[w * tp];
        while (m) {
          const int j = 32 * w + __ffs(m) - 1;
          m &= m - 1u;
          const int ke = min(__ldg(q.pieces + 2 * (c0 + j) + 1), k1);
          const T* Aj = buf + j * RCP;
#pragma unroll(K_UNROLL)
          for (int k = k0; k < ke; ++k) {
            const T v = phi[k * tp];
            const T* a = Aj + (k - k0) * stride;
#pragma unroll
            for (int r0 = 0; r0 < RC; r0 += G) {
              if (r0 > 0 && r0 >= nrows) break;
              if constexpr (G % 2 == 0) {
                const P2* a2 = reinterpret_cast<const P2*>(a + r0);
#pragma unroll
                for (int r = 0; r < G / 2; ++r) {
                  const P2 pr = a2[r];
                  acc[r0 + 2 * r] = fiat::fma_of(pr.x, v, acc[r0 + 2 * r]);
                  acc[r0 + 2 * r + 1] = fiat::fma_of(pr.y, v, acc[r0 + 2 * r + 1]);
                }
              } else {
#pragma unroll
                for (int r = 0; r < G; ++r) acc[r0 + r] = fiat::fma_of(a[r0 + r], v, acc[r0 + r]);
              }
            }
          }
        }
      }
      if (!resident) {
        __syncwarp();  // every lane's reads of this buffer are done
        if (lane == 0) {
          const int b = u % stages;
          fiat::mbar_arrive(empty + b);
          // the last warp done with the buffer resets its count and refills
          // it with the slice `stages` visits ahead
          if (atomicAdd(done + b, 1u) == static_cast<unsigned>(nwarps - 1)) {
            done[b] = 0;
            if (u + stages < visits) {
              fiat::mbar_wait(empty + b, (u / stages) & 1);  // every warp's reads, acquired
              fiat::fence_async_smem();  // order those reads before the copy's writes
              fetch((u + stages) % n, ring + b * q.buf, full + b);
            }
          }
        }
      }
      if ((flags & LAST_IN_CHUNK) && live) {
        const T f = *recip;
        T* o = q.out + static_cast<size_t>(__ldg(sl + 1)) * ld + p;
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          if (r < nrows) o[static_cast<size_t>(r) * ld] = acc[r] * f;
        }
      }
    }
  }
}

// tp: the point tile (the instantiation's own for an unrolled degree)
template <int SD, int N, int RC, class T>
int launch(Params<T> q, int ngroups, int tp, cudaStream_t stream) {
  if (N >= 0 ? tp != point_tile<SD, N, T>() : !generic_tile(tp))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile_blocks = ((q.npts + tp - 1) / tp + q.sub - 1) / q.sub;
  if (tile_blocks * ngroups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  q.tile_blocks = static_cast<int>(tile_blocks);
  const int nblocks = static_cast<int>(tile_blocks * ngroups);
  const size_t smem = smem_bytes<T>(nexp_of(SD, N < 0 ? q.degree : N), tp, q.ring, q.words,
                                    q.nbar);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err =
        cudaFuncSetAttribute(macro_oneshot_kernel<SD, N, RC, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(err);
    }
  }
  macro_oneshot_kernel<SD, N, RC, T><<<nblocks, tp, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Degrees 0..10, and on the interval (SD = 1, nexp 16 at most) 0..15,
// unrolled; every degree past them on the generic instantiation.
template <int SD, int RC, class T>
int by_degree(Params<T> q, int degree, int ngroups, int tp, cudaStream_t s) {
  switch (degree) {
#define FIAT_CASE(n) \
  case n:            \
    return launch<SD, n, RC, T>(q, ngroups, tp, s);
#define FIAT_CASE_1D(n)                                                \
  case n:                                                              \
    if constexpr (SD == 1) return launch<SD, n, RC, T>(q, ngroups, tp, s); \
    break;
    FIAT_CASE(0) FIAT_CASE(1) FIAT_CASE(2) FIAT_CASE(3) FIAT_CASE(4) FIAT_CASE(5)
    FIAT_CASE(6) FIAT_CASE(7) FIAT_CASE(8) FIAT_CASE(9) FIAT_CASE(10)
    FIAT_CASE_1D(11) FIAT_CASE_1D(12) FIAT_CASE_1D(13) FIAT_CASE_1D(14) FIAT_CASE_1D(15)
#undef FIAT_CASE_1D
#undef FIAT_CASE
    default:
      break;
  }
  if (degree > unrolled_top(SD)) {
    q.degree = degree;
    return launch<SD, fiat::GENERIC, RC, T>(q, ngroups, tp, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Each source instantiates its share of (SD, RC, T), so nvcc builds them
// in parallel: macro_oneshot.cu the f64 tables, macro_oneshot_f32.cu the
// f32 tables, macro_oneshot_one.cu one row per program in both types, and
// macro_oneshot_1.cu the interval's four families.
#define FIAT_K3_FAMILIES(X)                                                   \
  X(2, RC_TABLES, double) X(3, RC_TABLES, double) X(2, RC_TABLES, float)     \
  X(3, RC_TABLES, float) X(2, RC_ONE, double) X(3, RC_ONE, double)           \
  X(2, RC_ONE, float) X(3, RC_ONE, float) X(1, RC_TABLES, double)            \
  X(1, RC_TABLES, float) X(1, RC_ONE, double) X(1, RC_ONE, float)
#define FIAT_K3_EXTERN(SD, RC, T) \
  extern template int by_degree<SD, RC, T>(Params<T>, int, int, int, cudaStream_t);
#define FIAT_K3_INSTANTIATE(SD, RC, T) \
  template int by_degree<SD, RC, T>(Params<T>, int, int, int, cudaStream_t);
FIAT_K3_FAMILIES(FIAT_K3_EXTERN)

}  // namespace fiat::k3
