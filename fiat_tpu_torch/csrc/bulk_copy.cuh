// mbarriers and the bulk copy (cp.async.bulk, the TMA's 1-D form) from
// device to shared memory, PTX ISA 8.0, sm_90: the rings of A chunks of K2
// (bucket_matmul.cu) and K6 (zoo_f32.cuh); and what the streamed products
// of both (bucket_matmul_stream_kernel, zoo_f32_wide.cu) share: the wait on
// their cp.async ring and their grid's order.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fiat {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// copy `bytes` (a multiple of 16) from global src to shared dst, completing
// as transactions on `bar`, whose current phase expects them
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// bulk copies (the async proxy) that read them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (the count must be an immediate: 0 to 2, a ring of 2 to 4).
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    default: __pipeline_wait_prior(2);
  }
}

// The (row tile, point tile) of block b of a streamed product over `ntiles`
// row tiles and `npt` point tiles: the row tiles in groups of `group`, the
// blocks of one point tile together within a group, so that a group's A
// stays in L2 across the point tiles and each point tile's Phi slab is read
// from device memory once a group.
struct StreamBlock {
  int tile, pt;
};
__device__ __forceinline__ StreamBlock stream_block(unsigned b, int group, int npt, int ntiles) {
  const long long span = static_cast<long long>(group) * npt;
  const int gi = static_cast<int>(b / span);
  const int local = static_cast<int>(b - gi * span);
  const int rows = min(group, ntiles - gi * group);
  return {gi * group + local % rows, local / rows};
}

}  // namespace fiat
