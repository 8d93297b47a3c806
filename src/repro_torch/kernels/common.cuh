// What the fixed-matrix kernels (bitplane_gemv, bcsr_matmul, reservoir_step)
// share: the thread-block shape, the staging of the activations in shared
// memory, and the fixed-order sum over row lanes.
//
// Each thread block is 8 x 32 threads: threadIdx.x = c picks one output
// column (or, in bitplane_gemv, a quad of 4 columns) of the block's column
// slice; threadIdx.y = l is a row lane that walks every 32nd row (or row
// group) of the reduction.  A thread keeps one accumulator per (batch row,
// column) it owns; at the end the 32 row lanes are summed in a fixed tree
// order (two warp shuffles, then the 8 warps in ascending order), so a float
// result is the same from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fixedmat {

constexpr int kCols = 8;                // threadIdx.x
constexpr int kLanes = 32;              // threadIdx.y
constexpr int kThreads = kCols * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;    // opt-in dynamic shared memory

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int to_acc(int8_t v) { return v; }
__device__ __forceinline__ int to_acc(int v) { return v; }

// xs[b * stride + i] = x[(row0 + b) * ld + r_lo + i] for b < BT, i < stride,
// zero past the batch or past n_rows valid rows.  A fixed-trip loop
// unrolled 8 ways, so each thread has 8 loads in flight.
template <int BT, typename XT, typename S>
__device__ __forceinline__ void stage_rows(const XT* __restrict__ x, int ld,
                                           int batch, int row0, int r_lo,
                                           int n_rows, int stride, S* xs) {
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int total = BT * stride;
  const int iters = (total + kThreads - 1) / kThreads;
#pragma unroll 8
  for (int k = 0; k < iters; ++k) {
    const int idx = tid + k * kThreads;
    const int b = idx / stride;
    const int i = idx - b * stride;
    const int gb = row0 + b;
    S v = 0;
    if (idx < total && gb < batch && i < n_rows) {
      v = static_cast<S>(to_acc(x[(size_t)gb * ld + r_lo + i]));
    }
    if (idx < total) xs[idx] = v;
  }
}

// Sums v[k] over the 32 row lanes for every column c and accumulator k.
// red: kWarps * N * kCols scratch; out[k * kCols + c] receives the total.
// Ends with __syncthreads(), so every thread may read out.
template <int N, typename T>
__device__ __forceinline__ void reduce_lanes(T (&v)[N], T* red, T* out) {
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;       // = (l % 4) * kCols + c
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T s = v[k];
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < kCols) red[(warp * N + k) * kCols + lane] = s;
  }
  __syncthreads();
  for (int idx = tid; idx < N * kCols; idx += kThreads) {
    T s = red[idx];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * N * kCols + idx];
    out[idx] = s;
  }
  __syncthreads();
}

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
