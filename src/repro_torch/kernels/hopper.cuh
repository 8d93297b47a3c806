// The Hopper (sm_90) primitives the kernels share: bulk copies into shared
// memory completed on an mbarrier (cp.async.bulk, the 1-D form of the
// Tensor Memory Accelerator), the proxy fence around them, stores into
// another block's shared memory in the cluster completed on its mbarrier
// (st.async), and the int8 tensor-core product mma.sync.m16n8k32.
//
// Fragment layouts of mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (PTX ISA),
// lane = 4 * gid + tig:
//   A (16 x 32, row-major):  a0 = row gid,     k = 4 tig .. 4 tig + 3
//                            a1 = row gid + 8, the same k
//                            a2 = row gid,     k = 16 + 4 tig .. + 3
//                            a3 = row gid + 8, k = 16 + 4 tig .. + 3
//   B (32 x 8, column n):    b.x = column gid, k = 4 tig .. 4 tig + 3
//                            b.y = column gid, k = 16 + 4 tig .. + 3
//   C (16 x 8, int32):       c0, c1 = row gid,     columns 2 tig, 2 tig + 1
//                            c2, c3 = row gid + 8, the same columns
// A host packs a B operand as 256-byte fragments: lane l's 8 bytes at 8 l.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: expect `bytes` more on `bar` (and arrive once).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One thread: expect `bytes` on `bar` and copy them from global `src` to
// shared `dst` (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The address of this block's shared-memory `addr` in block `rank` of the
// cluster (shared::cluster window).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into (possibly another block's) shared memory at cluster
// address `dst`, counted as complete_tx on that block's mbarrier `bar`
// (a cluster address too).
__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Orders this thread's generic-proxy global accesses with the bulk
// copies (async proxy).
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// bulk copies into the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// c += a (16 x 32 int8) . b (32 x 8 int8), int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

}  // namespace hopper
