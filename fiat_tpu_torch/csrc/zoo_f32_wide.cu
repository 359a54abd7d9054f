// K6's wide mode: the f32 engine past the Phi tiles a block's shared memory
// takes (more than 842 rows at 64 points: tet degree 16 and up, triangle
// degree 40 and up), in two launches a pass.
//
// Replaces, with zoo_f32.cu, the TPU kernel fiat_tpu/ops/pallas_tabulate.py:
// PallasZooTabulator._kernel, which has no width cap: a TPU tile of Phi
// fits VMEM at any degree.  On Hopper the fused kernel keeps its Phi tile in
// shared memory, so past 842 rows Phi goes to device memory once:
//   1. zoo_f32_phi_kernel: K6's own generic recurrence (generic_point, the
//      same float32 arithmetic as the fused kernel's Phi tile), two threads
//      a point, writes Phi (kpad, ldphi) float32 with ldphi the points
//      rounded up to the product's 128-point tile, every pair of points'
//      columns swapped as the fused kernel's tile keeps them (fma8), rows
//      kmax..kpad zeros, and points past npts at the coordinates 0, so the
//      product reads whole, aligned, finite slabs;
//   2. zoo_f32_stream_kernel: one block per (128-point tile, 128-row tile),
//      K6's 8 warps, warp tiles (32 rows x 64 points, 8 x 8 a lane) and
//      FMA order, with A's chunk (k6_layout's At) and Phi's kc x 128 slab
//      coming through a ring of 2 to 4 buffers by cp.async, one block
//      barrier a chunk; the grid is ordered as K2's streamed mode
//      (bucket_matmul.cu): row tiles in groups of `group`, the blocks of
//      one point tile together within a group, so that each Phi slab is
//      read from device memory once a group and A's group stays in L2.
// Bound: at tet degree 20, order 1 and 1e5 points, 7084 rows x K 1771 are
// 2.51 TFLOP (37.4 ms at 67 TFLOP/s FP32); Phi is 0.71 GB, written once and
// read about once a group (0.2 ms each at 3.35 TB/s).  Each output is one
// sequential FMA chain over k = 0..K_t - 1, as in the fused kernel.

#include "zoo_f32.cuh"

namespace fiat::k6 {
namespace {

constexpr int WTP = 128;                    // points of a block, both kernels
constexpr int WTHREADS = threads_of(WTP);   // 256: two threads a point, 8 warps

template <int SD>
__global__ void __launch_bounds__(WTHREADS)
zoo_f32_phi_kernel(const __grid_constant__ Params q) {
  const int pt = threadIdx.x % WTP, half = threadIdx.x / WTP;
  const int p = blockIdx.x * WTP + pt;
  float* col = q.phi + (p ^ 1);
  const int kmax = q.kmax;
  generic_point<SD>(q, p, half, [&](int m, float v) {
    if (m < kmax) col[static_cast<size_t>(m) * q.ldphi] = v;
  });
  if (half == 0)
    for (int k = kmax; k < q.kpad; ++k) col[static_cast<size_t>(k) * q.ldphi] = 0.0f;
}

__global__ void __launch_bounds__(WTHREADS, THREADS_SM / WTHREADS)
zoo_f32_stream_kernel(const __grid_constant__ Params q) {
  constexpr int TP = WTP;
  constexpr int WN = TP / WARP_POINTS;       // warps along the points (4 along the rows)
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = q.kc, stages = q.stages, npts = q.npts;

  const fiat::StreamBlock blk = fiat::stream_block(blockIdx.x, q.group, q.ldphi / TP, q.ntiles);
  const int tile = blk.tile, p0 = blk.pt * TP;

  const int* tile_q = q.tiles + TILE_COLS * tile;
  const int kt = __ldg(tile_q + 2);                   // even, <= kpad
  const float* At_t = q.At + static_cast<size_t>(__ldg(tile_q + 3)) * TR;
  const int nch = (kt + kc - 1) / kc;
  float* As = smem;                                         // stages x [kc][TR]
  float* Bs = As + static_cast<size_t>(stages) * kc * TR;   // stages x [kc][TP]
  // chunk c (rows c * kc .. of k) into ring buffer s: 16-byte copies, both
  // sources whole and aligned
  auto load = [&](int c, int s) {
    const int k0 = c * kc, kn = min(kc, kt - k0);
    float* Ad = As + static_cast<size_t>(s) * kc * TR;
    float* Bd = Bs + static_cast<size_t>(s) * kc * TP;
    const float* Asrc = At_t + static_cast<size_t>(k0) * TR;
    for (int e = tid; e < kn * TR / 4; e += WTHREADS)
      __pipeline_memcpy_async(Ad + 4 * e, Asrc + 4 * e, 16);
    for (int e = tid; e < kn * TP / 4; e += WTHREADS) {
      const int k = e / (TP / 4), p = 4 * (e % (TP / 4));
      __pipeline_memcpy_async(Bd + k * TP + p,
                              q.phi + static_cast<size_t>(k0 + k) * q.ldphi + p0 + p, 16);
    }
  };

  const int wr = warp / WN, wp = warp % WN;    // the warp tile's place in the block tile
  const int rg = lane >> 3, pg = lane & 7;     // the lane's row group and point group
  const int row_l = wr * WARP_ROWS + 8 * rg;   // the lane's rows: row_l .. row_l + 7
  const int pt_l = wp * WARP_POINTS + 4 * pg;  // the lane's points: pt_l + {0..3, 32..35}
  const int kw = __ldg(tile_q + 4 + wr);       // the warp's rows contract to their widest
  float4 acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  // Phi's columns come pair-swapped: (1, 0, 3, 2), as the fused kernel's fma8
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

  for (int s = 0; s < stages - 1; ++s) {  // the ring's first chunks
    if (s < nch) load(s, s);
    __pipeline_commit();
  }
  for (int c = 0; c < nch; ++c) {
    fiat::wait_pending(stages - 2);  // this thread's copies of chunk c have landed
    __syncthreads();           // every thread's, and every warp is done with chunk c - 1
    if (c + stages - 1 < nch) load(c + stages - 1, (c + stages - 1) % stages);
    __pipeline_commit();
    const int s = c % stages;
    const int k0 = c * kc;
    const int kn = max(0, min(kc, kw - k0));  // even: kc and every width are
    const float* Ak = As + static_cast<size_t>(s) * kc * TR + row_l;
    const float* Bk = Bs + static_cast<size_t>(s) * kc * TP + pt_l;
    auto ld = [&](float4 (&a)[2], float4 (&b)[2], int k) {
      a[0] = *reinterpret_cast<const float4*>(Ak + k * TR);
      a[1] = *reinterpret_cast<const float4*>(Ak + k * TR + 4);
      b[0] = *reinterpret_cast<const float4*>(Bk + k * TP);
      b[1] = *reinterpret_cast<const float4*>(Bk + k * TP + 32);
    };
    float4 a0[2], b0[2], a1[2], b1[2];
    if (kn) ld(a0, b0, 0);
#pragma unroll 1
    for (int kk = 0; kk < kn; kk += DEPTH) {
      ld(a1, b1, kk + 1);
      fma8(a0, b0);
      ld(a0, b0, min(kk + 2, kn - 1));  // past the chunk: a row it never uses again
      fma8(a1, b1);
    }
  }
  __pipeline_wait_prior(0);

  // each row of the lane to its row of out, as the fused kernel writes it
  const int row0 = __ldg(tile_q), nrows = __ldg(tile_q + 1);
  const bool whole = (p0 + TP <= npts) && ((npts & 3) == 0) &&
                     ((reinterpret_cast<uintptr_t>(q.out) & 15) == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (row_l + i < nrows) {
      float* orow = q.out + static_cast<size_t>(__ldg(q.dst + row0 + row_l + i)) * npts + p0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = pt_l + 32 * j;
        if (whole) {
          __stcs(reinterpret_cast<float4*>(orow + p), acc[i][j]);
        } else {
          if (p0 + p < npts) __stcs(orow + p, acc[i][j].x);
          if (p0 + p + 1 < npts) __stcs(orow + p + 1, acc[i][j].y);
          if (p0 + p + 2 < npts) __stcs(orow + p + 2, acc[i][j].z);
          if (p0 + p + 3 < npts) __stcs(orow + p + 3, acc[i][j].w);
        }
      }
    }
  }
}

size_t stream_smem_bytes(int kc, int stages) {
  return sizeof(float) * static_cast<size_t>(stages) * kc * (TR + WTP);
}

template <int SD>
int launch_phi(const Params& q, cudaStream_t s) {
  zoo_f32_phi_kernel<SD><<<q.ldphi / WTP, WTHREADS, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fiat::k6

// The wide mode's first launch: Phi (kpad, ldphi) float32 at `phi`, device,
// for pts, consts, slots, affine, scale and degree as fiat_zoo_f32 takes
// them (any degree, up to 63 on triangles and tetrahedra: the generic
// recurrence; the host runs it past 842 Phi rows only); ldphi: npts
// rounded up to 128; kmax <= kpad, both at most the basis.  Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue, launching
// nothing, outside those.
extern "C" int fiat_zoo_f32_phi(const float* pts, int npts, int sd, const float* consts,
                                const int* slots, const float* affine, float scale, int degree,
                                int kpad, int kmax, float* phi, int ldphi, void* stream) {
  using namespace fiat::k6;
  const long long members = sd == 1 ? degree + 1
                            : sd == 2 ? (degree + 1LL) * (degree + 2) / 2
                                      : (degree + 1LL) * (degree + 2) * (degree + 3) / 6;
  if (sd < 1 || sd > 3 || degree < 0 || (sd > 1 && degree > MAX_GENERIC_DEGREE) || kmax < 1 ||
      kmax > kpad || kmax > members || npts < 0 || ldphi < npts || ldphi % WTP != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ldphi == 0) return static_cast<int>(cudaSuccess);
  Params q{pts, npts, consts, slots, {}, scale, nullptr, kpad, kmax, nullptr, 0, nullptr,
           nullptr, 0, 0, degree, phi, ldphi, 0};
  for (int i = 0; i < sd * sd + sd; ++i) q.aff[i] = affine[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sd == 1) return launch_phi<1>(q, s);
  if (sd == 2) return launch_phi<2>(q, s);
  return launch_phi<3>(q, s);
}

// The wide mode's second launch: out[dst[r]] = A_r @ Phi for every packed
// row, with At, kpad, kmax, tiles, ntiles, dst, out as fiat_zoo_f32 takes
// them, phi the first launch's (kpad, ldphi), kc the rows of a chunk (a
// positive multiple of 2), stages the chunks in the ring (2 to 4), group
// the row tiles of a group of the grid's order.  Two blocks an SM.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue,
// launching nothing, outside those or for a grid past 2^31 - 1 blocks.
extern "C" int fiat_zoo_f32_stream(const float* At, int kpad, int kmax, const int* tiles,
                                   int ntiles, const float* phi, int ldphi, int npts,
                                   const int* dst, float* out, int kc, int stages, int group,
                                   void* stream) {
  using namespace fiat::k6;
  const size_t bytes = stream_smem_bytes(kc, stages);
  const long long blocks = static_cast<long long>(ldphi / WTP) * ntiles;
  if (kmax < 1 || kmax > kpad || kpad % DEPTH != 0 || kc < DEPTH || kc % DEPTH != 0 ||
      stages < 2 || stages > STAGES || group < 1 || ntiles < 0 || npts < 0 || ldphi < npts ||
      ldphi % WTP != 0 || blocks > 2147483647LL ||
      2 * ((bytes + SMEM_UNIT - 1) / SMEM_UNIT * SMEM_UNIT + SMEM_BLOCK) > SMEM_SM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(zoo_f32_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(zoo_f32_stream_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  Params q{nullptr, npts, nullptr, nullptr, {}, 0.0f, At, kpad, kmax, tiles, ntiles, dst, out,
           kc, stages, 0, const_cast<float*>(phi), ldphi, group};
  zoo_f32_stream_kernel<<<static_cast<unsigned>(blocks), WTHREADS, bytes,
                          static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the wide product an SM holds at once with a ring of `stages`
// chunks of kc rows (registers and shared memory, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
extern "C" int fiat_zoo_f32_stream_occupancy(int kc, int stages) {
  using namespace fiat::k6;
  const size_t bytes = stream_smem_bytes(kc, stages);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(zoo_f32_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(zoo_f32_stream_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, zoo_f32_stream_kernel, WTHREADS,
                                                        bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return blocks;
}
