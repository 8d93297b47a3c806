// What the kernels share beyond the Hopper primitives (hopper.cuh): the
// opt-in shared-memory cap and the widening of an activation element to
// its accumulation type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fixedmat {

constexpr int kMaxSmem = 227 * 1024;    // opt-in dynamic shared memory

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int to_acc(int8_t v) { return v; }
__device__ __forceinline__ int to_acc(int v) { return v; }

// Lifts a kernel's dynamic shared-memory cap; `done` (a static of the
// caller's launch function, one per instantiation) makes it happen once.
template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = e == cudaSuccess;
  return e;
}

}  // namespace fixedmat
