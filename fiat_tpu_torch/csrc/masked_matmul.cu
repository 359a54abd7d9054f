// K7: the macro (split-complex) elements of a zoo as a masked change of basis
// over the zoo's shared Dubiner basis, in one launch, in f64, on triangles
// and tetrahedra.
//
// Replaces the TPU kernel fiat_tpu/ops/pallas_multiword.py:
// FusedMaskedMultiword._masked_kernel (apply_pair_masked), together with its
// two XLA neighbours in _specials_merged: the binning masks before it
// (core/expansions.py:partition_of_unity_masks) and the 1 / cover-count
// multiply after it.  The TPU kernel assembles B = (mask_c * Phi[:nexp_c])_c
// in VMEM through one-hot MXU products and multiplies the whole merged A by
// it in df32 pairs and Ozaki windows, because the TPU has no f64; Hopper
// has native FP64, so none of that is carried over.  For each point x:
//
//   1. the subcell masks of the program (binning.cuh, shared with K3 and
//      K45): mask_c = dist_c <= dist_parent + tol; a unique program (C0
//      basis at order 0) keeps its first hit, every other program averages
//      over its hits, recip = 1 / (number of masks set);
//   2. out[r, x] = recip * sum_{c hit} sum_{k < nexp_c} A[r, off_c + k] Phi[k, x],
//      one FMA chain per output in (c, k) order.  The pieces whose mask is 0
//      add exact zeros to the dense product A @ B, so they are skipped: the
//      result is the dense product summed in the same k order.
//
// Phi is the (nexp, npts) f64 tabulation K1 made for K2, read by prefix
// (no second recurrence).
//
// Bound on the card: the store of out (rows * npts doubles; 632 x 1e5 =
// 0.506 GB on sv_macro_tet).  The FMAs are a quarter of that at the FP64
// peak: only the pieces a point bins into are multiplied (6568 a point on
// sv_macro_tet).  What limits the design is feeding them: every FMA takes 8
// bytes of A from shared memory (A changes with the point's subcell, so no
// register holds it for two points), and on the H100 a warp's 16-byte
// shared load costs at least one wavefront for each 8-lane quarter, and one
// more for each further address inside a quarter (PERF.md section 6).  Design:
//   - a block of TP points walks every row chunk of every program with two
//     threads a point, each RT = 16 rows of a chunk (RT accumulators, one
//     FMA chain per row);
//   - the first TP threads bin the points once per program, or once for
//     consecutive programs on one split under one rule (an Alfeld P3 / DG2
//     pair), and deal each warp's 32 points to its lanes in the order of
//     their first subcell, through shared memory: lanes next to each other
//     then read the same columns of A (fewer addresses a quarter), while a
//     warp's stores still cover its 32 contiguous points.  A program's masks
//     are words_of(P) words a point (binning.cuh), kept in shared memory by
//     point slot ([word][TP]: the binning thread writes its own point's
//     column, the multiplying thread reads the column of the point it was
//     dealt), so a program may have any number of subcells; the sort key is
//     the index of the point's first hit in the program (P for a dead
//     point), ranked over the bits it needs;
//   - the block's Phi prefix (kmax rows x TP points) is staged in shared
//     memory once, by bulk copies (cp.async.bulk, bulk_copy.cuh) of each
//     row's TP contiguous doubles on one mbarrier (plain loads on a ragged
//     or unaligned tile), and read from there by every chunk;
//   - A streams through a ring of `stages` buffers of bulk-copied slices:
//     a slice is a run of k of a row chunk, every piece of the program, as
//     shared memory holds it (column k * P + j for piece j of P, RCP = RC +
//     2 doubles a column, so one 16-byte load gives a lane two rows of a
//     column and lanes in up to 8 different subcells read distinct banks).
//     A chunk wider than a buffer is cut along k, so no chunk has to fit in
//     shared memory, and every lane works in every slice.  Each warp done
//     with a buffer arrives on its "empty" mbarrier, and the last of them (a
//     counter elects it) refills it with the slice `stages` ahead, as K2 and
//     K6 do: the next slices land while this one is multiplied, and the
//     first ones while the points are binned and Phi is staged;
//   - a group of G rows past a chunk's last row is skipped (as K3 does), so
//     a 12-row tail pays for 16 rows, not 32;
//   - out is row-major with points contiguous: a finished chunk goes out
//     from the accumulators (evict-first), each warp's store the 256 bytes
//     of its points in one row (a permutation of them, which the coalescer
//     takes as it takes them in order).
// The block's slices run in (program, chunk, k) order and a point's hit
// pieces are added in increasing order within a slice, so a point inside
// one subcell gets the same FMA chain as in K3 and under any plan; a tie
// point (on a face between subcells) gets its pieces in (c, k) order where
// the slices hold whole chunks, and interleaved by runs of k otherwise.
//
// Slice table (built by fiat_tpu_torch/ops/macro_oneshot.py:slice_table,
// K3's layout):
//   slices[SLICE_COLS*q + {0..10}]  slice q: program g, first row, rows (<= RC),
//       first k, end k, offset of its block in At (in doubles), pieces P of
//       the program, flags (FIRST_IN_CHUNK, LAST_IN_CHUNK, FIRST_IN_PROGRAM,
//       SAME_BINS: the program's split and rule are the last program's),
//       doubles of its block, the program's first piece and rule (K3's;
//       this kernel reads them from progs, which kept it within 80
//       registers at sd = 3 where the slice's copies did not)
//   At[offset + ((k - first k) * P + j) * RCP + r] = A[first row + r, off_(c0 + j) + k]
//       for k < nexp_(c0 + j), r < rows; zeros elsewhere.
// Geometry tables (maps, progs, pieces): binning.cuh.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "binning.cuh"
#include "bulk_copy.cuh"

namespace {

constexpr int RC = 32;       // rows per chunk (csrc and masked_matmul.py agree)
constexpr int RCP = RC + 2;  // doubles per staged column
constexpr int G = 8;         // rows a chunk skips at a time past its last row
constexpr int STAGES = 4;    // the most buffers in the ring
constexpr int SLICE_COLS = 11;
constexpr int FIRST_IN_CHUNK = 1, LAST_IN_CHUNK = 2, FIRST_IN_PROGRAM = 4, SAME_BINS = 8;

constexpr int HALVES = 2;    // threads a point, each RC / HALVES rows of a chunk
constexpr int RT = RC / HALVES;
// launch bounds: threads an SM, 768 (80 registers a thread) on tetrahedra,
// 512 (128) on triangles, whose binning inlined spills at 80
__host__ __device__ constexpr int threads_sm(int sd) { return sd == 2 ? 512 : 768; }
__host__ __device__ constexpr int min_blocks(int sd, int tp) {
  return threads_sm(sd) / (HALVES * tp) > 0 ? threads_sm(sd) / (HALVES * tp) : 1;
}

struct Params {
  const double* pts;
  int npts;
  double tol;
  const double* maps;
  const int* progs;
  const int* pieces;
  const int* slices;
  int nslices;
  const double* At;
  const double* phi;  // (>= kmax, npts)
  int kmax;           // Phi rows staged: the widest piece
  int slice_cols, stages;
  int words;          // mask words a point: words_of(the widest program)
  double* out;
};

// Shared memory of a block of tp points: the Phi tile, the ring, every
// point slot's factor, sorted point and mask words, and the ring's two
// mbarriers and counter a buffer plus the Phi tile's mbarrier.
__host__ __device__ constexpr size_t smem_bytes(int kmax, int tp, int slice_cols, int stages,
                                                int words) {
  return sizeof(double) * (static_cast<size_t>(kmax) * tp +
                           static_cast<size_t>(stages) * slice_cols * RCP + tp) +
         sizeof(int) * static_cast<size_t>(tp) * (1 + words) +
         sizeof(uint64_t) * (3 * STAGES + 1);
}

// A piece's columns k = kb .. ke - 1 of a slice (column k at Aj + (k - kb) *
// stride) times Phi's prefix into the first NG groups of G rows, one FMA
// chain per row: 16-byte loads of A (two rows of a column), Phi from this
// lane's column of the tile (f[k * TP]).
template <int NG, int TP>
__device__ __forceinline__ void multiply(double (&acc)[RT], const double* __restrict__ Aj,
                                         int stride, const double* __restrict__ f, int kb,
                                         int ke) {
  for (int k = kb; k < ke; ++k, Aj += stride) {
    const double v = f[k * TP];
    const double2* a = reinterpret_cast<const double2*>(Aj);
#pragma unroll
    for (int r = 0; r < NG * G / 2; ++r) {
      const double2 w = a[r];
      acc[2 * r] = fma(w.x, v, acc[2 * r]);
      acc[2 * r + 1] = fma(w.y, v, acc[2 * r + 1]);
    }
  }
}

// The rank of this lane's key (below 2^bits) among the warp's, ties by
// lane: the lanes in key order.
__device__ __forceinline__ int warp_rank(unsigned key, int lane, int bits) {
  unsigned same = ~0u;
  int less = 0;
  for (int b = bits - 1; b >= 0; --b) {
    const unsigned ones = __ballot_sync(~0u, (key >> b) & 1u);
    if ((key >> b) & 1u) {
      less += __popc(same & ~ones);
      same &= ones;
    } else {
      same &= ~ones;
    }
  }
  return less + __popc(same & ((1u << lane) - 1u));
}

// Two threads a point, each RT rows of every chunk: thread tid takes point
// slot tid % TP and rows (tid / TP) * RT onwards; the first TP threads bin
// and sort the points for both.
template <int SD, int TP>
__global__ void __launch_bounds__(HALVES * TP, min_blocks(SD, TP))
masked_matmul_kernel(const __grid_constant__ Params q) {
  constexpr int W = HALVES * TP / 32;  // warps
  extern __shared__ __align__(16) double smem[];
  double* Bs = smem;                                          // [kmax][TP]: Phi
  double* As = Bs + static_cast<size_t>(q.kmax) * TP;         // stages x [slice_cols][RCP]
  const size_t buf = static_cast<size_t>(q.slice_cols) * RCP;
  double* recips = As + q.stages * buf;                       // [TP]: each slot's factor
  int* slots = reinterpret_cast<int*>(recips + TP);           // [TP]: each slot's point
  unsigned* masks = reinterpret_cast<unsigned*>(slots + TP);  // [words][TP]: by point slot
  uint64_t* full = reinterpret_cast<uint64_t*>(masks + q.words * TP);  // [STAGES]
  uint64_t* empty = full + STAGES;                                // [STAGES]
  uint64_t* phibar = empty + STAGES;                              // [1]
  unsigned* done = reinterpret_cast<unsigned*>(phibar + 1);       // [STAGES]
  const int tid = threadIdx.x, lane = tid & 31;
  const int pt = tid % TP, half = tid / TP;  // warp-uniform
  const int p0 = blockIdx.x * TP, npts = q.npts, nslices = q.nslices;
  const int stages = q.stages, kmax = q.kmax;
  const size_t ld = static_cast<size_t>(npts);
  // a whole tile with 16-byte aligned rows of Phi comes by bulk copy
  const bool whole = (p0 + TP <= npts) && ((npts & 1) == 0) &&
                     ((reinterpret_cast<uintptr_t>(q.phi) & 15) == 0);

  // slice t into ring buffer s, completing on its mbarrier: one contiguous copy
  auto fetch = [&](int t, int s) {
    const int* sl = q.slices + SLICE_COLS * t;
    fiat::bulk_copy(As + s * buf, q.At + __ldg(sl + 5), sizeof(double) * __ldg(sl + 8), full + s);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      fiat::mbar_init(full + s, 1);  // the fetching thread's arrival, plus the copy's bytes
      fiat::mbar_init(empty + s, W);  // one arrival a warp
      done[s] = 0;
    }
    fiat::mbar_init(phibar, kmax);  // one arrival a Phi row, plus its bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // fill the ring and stage Phi: their copies run beside the first binning
  if (tid == 0)
    for (int s = 0; s < stages && s < nslices; ++s) fetch(s, s);
  if (whole) {
    if (tid < 32)
      for (int k = lane; k < kmax; k += 32)
        fiat::bulk_copy(Bs + k * TP, q.phi + k * ld + p0, sizeof(double) * TP, phibar);
  } else {
    for (int k = half; k < kmax; k += HALVES)
      Bs[k * TP + pt] = p0 + pt < npts ? q.phi[k * ld + p0 + pt] : 0.0;
    __syncthreads();
  }

  // the thread's own point, which it bins
  const bool own_live = half == 0 && p0 + pt < npts;
  double x[SD], best = 0.0;
  if (own_live) {
#pragma unroll
    for (int i = 0; i < SD; ++i) x[i] = q.pts[static_cast<size_t>(SD) * (p0 + pt) + i];
    best = fiat::parent_bound<SD>(q.maps, x, q.tol);
  }

  // the point the thread multiplies: after each binning the warp's 32 points
  // are dealt to its lanes in the order of their first subcell, so lanes
  // next to each other read the same columns of A (the stores still cover
  // the warp's 32 contiguous points); its masks in the program are
  // masks[w * TP + slot], bit i of word w for piece c0 + 32 w + i, and its
  // factor recips[slot].  The program's pieces and words are read again
  // for each slice and the factor at each store, so that only the slot and
  // the accumulators live across slices (within 80 registers at sd = 3)
  int slot = pt;
  double acc[RT];
  for (int t = 0; t < nslices; ++t) {
    const int* sl = q.slices + SLICE_COLS * t;
    const int flags = __ldg(sl + 7);
    const int row0 = __ldg(sl + 1), nrows = __ldg(sl + 2);
    const int k0 = __ldg(sl + 3), k1 = __ldg(sl + 4), np = __ldg(sl + 6);
    const int g = __ldg(sl), c0 = __ldg(q.progs + 5 * g + 2);
    const int npc = __ldg(q.progs + 5 * g + 3) - c0;
    if (flags & FIRST_IN_PROGRAM) {
      // 1. binning, once per program (a program on the split and rule of the
      //    one before keeps its masks), and the warp's points sorted by it
      if (!(flags & SAME_BINS)) {
        __syncthreads();  // every thread has read the last program's slots and masks
        if (half == 0) {
          // this thread's point, word by word into its own column; its key
          // is its first hit in the program (npc: none, or a dead point)
          const int unique = __ldg(q.progs + 5 * g + 4);
          int kept = 0, key = npc;
          for (int w = 0; w < fiat::words_of(npc); ++w) {
            const unsigned bits =
                own_live ? fiat::rule_word(fiat::piece_bits<SD>(q.maps, c0, c0 + npc, w, x, best),
                                           unique, kept)
                         : 0u;
            if (bits && key == npc) key = 32 * w + __ffs(bits) - 1;
            masks[w * TP + pt] = bits;
          }
          const int at = (pt & ~31) + warp_rank(key, lane, 32 - __clz(npc));
          slots[at] = pt;
          recips[pt] = fiat::program_recip<double>(kept, unique);
        }
        __syncthreads();
        slot = slots[pt];
      }
    }
    if (flags & FIRST_IN_CHUNK) {
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.0;
    }
    if (t == 0 && whole) fiat::mbar_wait(phibar, 0);
    const int s = t % stages;
    fiat::mbar_wait(full + s, (t / stages) & 1);  // this slice has landed

    // 2. the hit pieces' columns in this slice times Phi's prefix, one chain
    //    per row; the groups of G rows past the chunk's last row are skipped
    const int rows = min(RT, nrows - half * RT);  // of this thread's rows
    if (rows > 0) {
      const double* Ab = As + s * buf + half * RT;
      const double* f = Bs + slot;
      const int groups = (rows + G - 1) / G, stride = np * RCP;
      for (int w = 0; 32 * w < npc; ++w) {
        unsigned m = masks[w * TP + slot];
        while (m) {
          const int j = 32 * w + __ffs(m) - 1;
          m &= m - 1u;
          const int ke = min(__ldg(q.pieces + 2 * (c0 + j) + 1), k1);
          const double* Aj = Ab + j * RCP;
          if (groups == 2) {
            multiply<2, TP>(acc, Aj, stride, f, k0, ke);
          } else {
            multiply<1, TP>(acc, Aj, stride, f, k0, ke);
          }
        }
      }
    }
    __syncwarp();  // every lane's reads of this buffer are done
    if (lane == 0) {
      fiat::mbar_arrive(empty + s);
      // the last warp done with the buffer resets its count and refills it
      if (atomicAdd(done + s, 1u) == W - 1) {
        done[s] = 0;
        if (t + stages < nslices) {
          fiat::mbar_wait(empty + s, (t / stages) & 1);  // every warp's reads, acquired
          fiat::fence_async_smem();  // order those reads before the copy's writes
          fetch(t + stages, s);
        }
      }
    }

    if ((flags & LAST_IN_CHUNK) && p0 + slot < npts) {
      const double recip = recips[slot];
      double* o = q.out + static_cast<size_t>(row0 + half * RT) * ld + p0 + slot;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rows) __stcs(o + static_cast<size_t>(r) * ld, acc[r] * recip);
      }
    }
  }
}

// The instantiation's shared-memory attributes on the current card, set on
// its first launch there and raised when a plan needs more, not on every
// call (each cudaFuncSetAttribute is host time on the wrapper's path).
template <int SD, int TP>
cudaError_t prepare(size_t bytes) {
  constexpr int CARDS = 64;
  static size_t allowed[CARDS] = {};  // bytes allowed so far, per card
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card < CARDS && bytes <= allowed[card]) return cudaSuccess;
  auto kernel = masked_matmul_kernel<SD, TP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && card < CARDS) allowed[card] = bytes;
  return err;
}

// The launch, or with `occupancy` the blocks an SM holds at once (minus the
// CUDA error on failure).
template <int SD, int TP>
int run(const Params& q, bool occupancy, cudaStream_t stream) {
  const size_t bytes = smem_bytes(q.kmax, TP, q.slice_cols, q.stages, q.words);
  cudaError_t err = prepare<SD, TP>(bytes);
  int blocks = 0;
  if (err == cudaSuccess) {
    if (occupancy) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, masked_matmul_kernel<SD, TP>,
                                                          HALVES * TP, bytes);
    } else {
      masked_matmul_kernel<SD, TP><<<(q.npts + TP - 1) / TP, HALVES * TP, bytes, stream>>>(q);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch's check would report it
    return occupancy ? -static_cast<int>(err) : static_cast<int>(err);
  }
  return occupancy ? blocks : 0;
}

template <int SD>
int by_tile(const Params& q, int tp, bool occupancy, cudaStream_t s) {
  switch (tp) {
    case 64: return run<SD, 64>(q, occupancy, s);
    case 128: return run<SD, 128>(q, occupancy, s);
    case 256: return run<SD, 256>(q, occupancy, s);
    default:
      return occupancy ? -static_cast<int>(cudaErrorInvalidValue)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(int sd, int kmax, int slice_cols, int stages, int words) {
  return (sd == 2 || sd == 3) && kmax >= 1 && slice_cols >= 1 && stages >= 1 &&
         stages <= STAGES && words >= 1;
}

}  // namespace

// words: the mask words of the widest program (words_of its pieces).
// Return the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for sd other than 2 or 3, a point tile other than
// 64, 128 or 256, no slices, no words or a ring past STAGES (the wrapper
// checks them first).
extern "C" int fiat_masked_matmul(const double* pts, int npts, int sd, double tol,
                                  const double* maps, const int* progs, const int* pieces,
                                  const int* slices, int nslices, const double* At,
                                  const double* phi, int kmax, double* out, int tp,
                                  int slice_cols, int stages, int words, void* stream) {
  if (!valid(sd, kmax, slice_cols, stages, words) || nslices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params q{pts, npts, tol, maps, progs, pieces, slices, nslices, At, phi, kmax,
                 slice_cols, stages, words, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sd == 2 ? by_tile<2>(q, tp, false, s) : by_tile<3>(q, tp, false, s);
}

// Blocks of the plan an SM holds at once (registers and shared memory), or
// minus the CUDA error.
extern "C" int fiat_masked_matmul_occupancy(int sd, int kmax, int tp, int slice_cols,
                                            int stages, int words) {
  if (!valid(sd, kmax, slice_cols, stages, words))
    return -static_cast<int>(cudaErrorInvalidValue);
  const Params q{nullptr, 0, 0.0, nullptr, nullptr, nullptr, nullptr, 0, nullptr, nullptr,
                 kmax, slice_cols, stages, words, nullptr};
  return sd == 2 ? by_tile<2>(q, tp, true, nullptr) : by_tile<3>(q, tp, true, nullptr);
}
