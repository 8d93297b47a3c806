// Block-sparse (BCSR) product over a static tile list, hand-written CUDA C++
// for sm_90a:
//
//   y = x @ M,   M given by its nonzero bk x bk tiles, sorted by (col, row)
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/bcsr_matmul/bcsr_matmul.py, launched by `bcsr_matmul`
// (:43, pallas_call at :81).  The TPU kernel walks the tile list on a
// sequential grid, gets each tile's coordinates by scalar prefetch and
// accumulates an output tile over consecutive grid steps.  Here every
// output column block's tiles form one contiguous run (col_ptr, computed
// once by the wrapper from the sorted columns), and each thread block
// walks the run of its own column block for an 8-column slice of it: no
// reduction across blocks and no atomics, so float results are the same
// from run to run.  Every column block has at least one (possibly zero)
// tile, so every output is written.
//
// Types follow the TPU kernel, which casts the tile to x's type before
// the product (`blk.astype(x.dtype)`):
//   float32 x: float32 tiles, float32 sums;
//   bfloat16 x: x and the tile rounded to bf16 by the intrinsics, products
//     summed in float32;
//   int32 x: tile truncated toward zero to int32, sums in int32;
//   int8 x: tile truncated toward zero and narrowed to int8, sums in int32.
// Integer sums run in uint32 (exact modulo 2^32, no signed overflow); the
// integer paths agree with the TPU kernel where the tiles hold integers in
// int8's range.
//
// Bound.  At LARGE_1024 (B = 16, R = C = 1024, all 64 tiles of 128 x 128
// kept) the kernel must read 4 MiB of fp32 tiles: 1.25 us at 3.35 TB/s;
// 34 MFLOP take 0.5 us at 67 TFLOP/s, so it is bound by bytes.  Design: an
// 8-column fp32 slice of a tile row is 32 contiguous bytes (one DRAM
// sector), which gives 128 thread blocks at LARGE_1024; the block's 32 row
// lanes take 4 tile rows each, with several tiles' loads in flight, and x
// (all batch rows of the tile, converted) is staged once in shared memory
// and read 4 rows at a time.  Later work: tensor-core MMA and TMA-fed
// tiles.

#include <type_traits>

#include "../../common.cuh"

using namespace fixedmat;

namespace {

__device__ __forceinline__ float weight(float v, float) { return v; }
__device__ __forceinline__ float weight(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ int weight(float v, int) {
  return __float2int_rz(v);
}
__device__ __forceinline__ int weight(float v, int8_t) {
  return static_cast<int8_t>(__float2int_rz(v));
}

template <int BT, typename XT>
__global__ void __launch_bounds__(kThreads) bcsr_matmul_kernel(
    const XT* __restrict__ x, int ld_x, int batch, int rows,
    const float* __restrict__ tiles, const int* __restrict__ col_ptr,
    const int* __restrict__ tile_rows, int bk, int rows_pad,
    void* __restrict__ y_v, int ld_y) {
  using X = decltype(to_acc(XT()));                 // float or int
  constexpr bool kFloat = std::is_same<X, float>::value;
  using Acc = typename std::conditional<kFloat, float, unsigned>::type;
  using X4 = typename std::conditional<kFloat, float4, int4>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  X* xs = reinterpret_cast<X*>(smem);                // BT x rows_pad
  Acc* red = reinterpret_cast<Acc*>(xs + BT * rows_pad);
  Acc* sums = red + kWarps * BT * kCols;             // BT x kCols

  const int slices = bk / kCols;
  const int ci = blockIdx.x / slices;
  const int c0 = (blockIdx.x - ci * slices) * kCols;
  const int row0 = blockIdx.y * BT;
  stage_rows<BT>(x, ld_x, batch, row0, 0, rows, rows_pad, xs);
  __syncthreads();

  Acc acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0;
  const int lo = col_ptr[ci];
  const int groups = bk / 4;                         // 4 tile rows each
  const int items = (col_ptr[ci + 1] - lo) * groups;
  const float* col = tiles + c0 + threadIdx.x;
#pragma unroll 4
  for (int k = threadIdx.y; k < items; k += kLanes) {
    const int t = lo + k / groups;
    const int g = k - (t - lo) * groups;
    const float* w = col + ((size_t)t * bk + 4 * g) * bk;
    X wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = weight(w[(size_t)j * bk], XT());
    const X4* xr = reinterpret_cast<const X4*>(xs + tile_rows[t] * bk) + g;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const X4 xv = xr[b * (rows_pad / 4)];
      if constexpr (kFloat) {
        acc[b] = fmaf(xv.x, wv[0], acc[b]);
        acc[b] = fmaf(xv.y, wv[1], acc[b]);
        acc[b] = fmaf(xv.z, wv[2], acc[b]);
        acc[b] = fmaf(xv.w, wv[3], acc[b]);
      } else {
        acc[b] += static_cast<unsigned>(xv.x) * static_cast<unsigned>(wv[0]);
        acc[b] += static_cast<unsigned>(xv.y) * static_cast<unsigned>(wv[1]);
        acc[b] += static_cast<unsigned>(xv.z) * static_cast<unsigned>(wv[2]);
        acc[b] += static_cast<unsigned>(xv.w) * static_cast<unsigned>(wv[3]);
      }
    }
  }
  reduce_lanes<BT>(acc, red, sums);                  // sums[b * kCols + c]

  const int tid = threadIdx.y * kCols + threadIdx.x;
  if (tid < BT * kCols) {
    const int b = tid / kCols;
    const int gb = row0 + b;
    const size_t at = (size_t)gb * ld_y + ci * bk + c0 + (tid - b * kCols);
    if (gb < batch) {
      if constexpr (kFloat) {
        static_cast<float*>(y_v)[at] = sums[tid];
      } else {
        static_cast<int*>(y_v)[at] = static_cast<int>(sums[tid]);
      }
    }
  }
}

template <int BT, typename XT>
int launch(const void* x, int ld_x, int batch, int rows, const float* tiles,
           const int* col_ptr, const int* tile_rows, int bk, int rows_pad,
           int n_col_blocks, void* y, int ld_y, cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = bcsr_matmul_kernel<BT, XT>;
  const cudaError_t e = allow_smem(kernel, smem_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_col_blocks * (bk / kCols), (batch + BT - 1) / BT);
  const size_t smem = 4 * ((size_t)BT * rows_pad
                           + (size_t)(kWarps + 1) * BT * kCols);
  kernel<<<grid, dim3(kCols, kLanes), smem, stream>>>(
      static_cast<const XT*>(x), ld_x, batch, rows, tiles, col_ptr,
      tile_rows, bk, rows_pad, y, ld_y);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch(int b_tile, const void* x, int ld_x, int batch, int rows,
             const float* tiles, const int* col_ptr, const int* tile_rows,
             int bk, int rows_pad, int n_col_blocks, void* y, int ld_y,
             cudaStream_t s) {
#define BCSR_ARGS x, ld_x, batch, rows, tiles, col_ptr, tile_rows, bk, \
                  rows_pad, n_col_blocks, y, ld_y, s
  switch (b_tile) {
    case 1: return launch<1, XT>(BCSR_ARGS);
    case 2: return launch<2, XT>(BCSR_ARGS);
    case 4: return launch<4, XT>(BCSR_ARGS);
    case 8: return launch<8, XT>(BCSR_ARGS);
    case 16: return launch<16, XT>(BCSR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BCSR_ARGS
}

}  // namespace

// y (batch, n_col_blocks * bk) <- x (batch, rows) of kind x_kind
// (0 float32, 1 bfloat16, 2 int8, 3 int32; y is float32 for 0/1, int32
// for 2/3), tiles (n_tiles, bk, bk) float32 sorted by (col, row), col_ptr
// (n_col_blocks + 1), tile_rows (n_tiles); rows <= rows_pad.
extern "C" int bcsr_matmul(int x_kind, const void* x, int ld_x, int batch,
                           int rows, const void* tiles, const void* col_ptr,
                           const void* tile_rows, int bk, int rows_pad,
                           int n_col_blocks, void* y, int ld_y, int b_tile,
                           void* stream) {
  if (bk % kCols != 0 || rows_pad % 4 != 0 || rows > rows_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tiles);
  const int* cp = static_cast<const int*>(col_ptr);
  const int* tr = static_cast<const int*>(tile_rows);
#define BCSR_CALL(XT) dispatch<XT>(b_tile, x, ld_x, batch, rows, t, cp, tr, \
                                   bk, rows_pad, n_col_blocks, y, ld_y, s)
  switch (x_kind) {
    case 0: return BCSR_CALL(float);
    case 1: return BCSR_CALL(__nv_bfloat16);
    case 2: return BCSR_CALL(int8_t);
    case 3: return BCSR_CALL(int);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BCSR_CALL
}
