// Copy probe for tools/probe_fixed_kernels.py: each of `blocks` thread
// blocks moves its `share` bytes of `src` into shared memory and records,
// in SM clock cycles from its start, when its barriers were initialised,
// when its copies were issued and when the bytes had landed.
//   method 1: thread 0 issues 4 bulk copies of share / 4 (4 mbarriers)
//   method 2: one bulk copy of the whole share (1 mbarrier)
//   method 3: plain 16-byte loads and stores by all 256 threads
//   method 4: as 1, while the other threads read one 16 KiB region that
//             every block reads (as B3's x staging does)

#include <cuda_runtime.h>
#include <stdint.h>

#include "src/repro_torch/kernels/hopper.cuh"

using namespace hopper;

namespace {

constexpr int kThreads = 256;
constexpr int kHot = 16 * 1024;

__global__ void __launch_bounds__(kThreads) copy_kernel(
    const unsigned char* __restrict__ src, const unsigned char* hot,
    int method, int share, long long* ts, int* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* buf = smem + 128;
  const uint32_t bar0 = smem_u32(smem);
  const int tid = threadIdx.x;
  const unsigned char* s = src + (size_t)blockIdx.x * share;
  const long long t0 = clock64();
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar0 + 8 * i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  const long long t1 = clock64();
  const int quarter = share / 4;
  if (method == 1 || method == 4) {
    if (tid == 0) {
      for (int q = 0; q < 4; ++q) {
        bulk_load(smem_u32(buf + q * quarter), s + q * quarter, quarter,
                  bar0 + 8 * q);
      }
    } else if (method == 4) {
      const int4* g = reinterpret_cast<const int4*>(hot);
      int4* d = reinterpret_cast<int4*>(buf + share);
      int4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = g[tid + kThreads * i];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[tid + kThreads * i] = v[i];
    }
  } else if (method == 2) {
    if (tid == 0) bulk_load(smem_u32(buf), s, share, bar0);
  } else {
    const int4* g = reinterpret_cast<const int4*>(s);
    int4* d = reinterpret_cast<int4*>(buf);
    for (int i = tid; i < share / 16; i += kThreads) d[i] = g[i];
  }
  const long long t2 = clock64();
  if (method == 1 || method == 4) {
    for (int q = 0; q < 4; ++q) mbar_wait(bar0 + 8 * q, 0);
  } else if (method == 2) {
    mbar_wait(bar0, 0);
  }
  __syncthreads();
  const long long t3 = clock64();
  if (tid == 0) {
    ts[blockIdx.x * 4 + 0] = t1 - t0;
    ts[blockIdx.x * 4 + 1] = t2 - t0;
    ts[blockIdx.x * 4 + 2] = t3 - t0;
    out[blockIdx.x] = buf[(blockIdx.x * 97) % share];
  }
}

}  // namespace

extern "C" int copy_probe(const void* src, const void* hot, int method,
                          int blocks, int share, void* ts, void* out,
                          void* stream) {
  const int smem = 128 + share + kHot;
  cudaError_t e = cudaFuncSetAttribute(
      copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  copy_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<const unsigned char*>(hot), method, share,
      static_cast<long long*>(ts), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
