// Exact digit-plane product, hand-written CUDA C++ for sm_90a:
//
//   y[b, c] = sum_w (x @ d_w)[b, c] << w        (int32, two's complement)
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/bitplane_gemv/bitplane_gemv.py, launched by
// `bitplane_gemv` (:55, pallas_call at :84): the TPU form of the paper's
// bit-serial multiplier (Sec. III).  x is (B, R) int8 or int32, the digit
// planes d_w are (W, Rd, C) int8 in {-1, 0, 1} with Rd >= R (rows past R
// are never read, which is what zero-padding x would give); planes whose
// bit is clear in `plane_mask` are never loaded (the TPU kernel drops them
// at trace time).
//
// Arithmetic.  Every plane's digits for one (row, column) are folded into
// the integer weight v = sum_w d_w << w before the batch rows multiply it,
// so a row costs W loads and one multiply-add per batch row instead of W.
// All sums run in uint32: wrapping addition and multiplication are exact
// modulo 2^32, so the result equals sum_w (x @ d_w) << w in int32 for any
// input (what XLA's int32 arithmetic gives), with no signed overflow.
//
// Bound.  At LARGE_1024 (B = 16, R = C = 1024, W = 8) the kernel must read
// 8 MiB of planes: 2.5 us at 3.35 TB/s; the 134 M int8 MACs take 0.07 us at
// 1,979 TOP/s, so it is bound by bytes.  Design: each thread block owns a
// 32-column slice (8 threads x 4 columns, a char4 per plane row: 32
// contiguous bytes per row, one DRAM sector) and a part of the rows; with
// only 32 slices at C = 1024, the rows are split over a thread-block
// cluster of `split` blocks (the wrapper sizes it so the grid fits the
// SMs in one wave), whose partial sums block 0 of the cluster adds in rank
// order through distributed shared memory: no atomics, no second launch,
// no zeroed output.  Inside a block the 32 row lanes each walk every 32nd row with
// all W plane loads of a row in flight at once; x sits in shared memory.
// Later work: int8 tensor-core MMA per plane and TMA-fed plane tiles.

#include <cooperative_groups.h>

#include "../../common.cuh"

namespace cg = cooperative_groups;
using namespace fixedmat;

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kSlice = kCols * 4;   // output columns per thread block

template <int BT, typename XT>
__global__ void __launch_bounds__(kThreads) bitplane_gemv_kernel(
    const XT* __restrict__ x, int ld_x, int batch, int rows,
    const int8_t* __restrict__ digits, int rows_d, int cols, int width,
    unsigned plane_mask, int* __restrict__ y, int ld_y, int split,
    int part_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int part = static_cast<int>(cluster.block_rank());
  const int slice = blockIdx.x / split;
  const int row0 = blockIdx.y * BT;
  const int r_lo = part * part_rows;
  const int n_rows = max(0, min(rows - r_lo, part_rows));
  int* xs = reinterpret_cast<int*>(smem);                   // BT x part_rows
  unsigned* red = reinterpret_cast<unsigned*>(xs + BT * part_rows);
  unsigned* sums = red + kWarps * BT * 4 * kCols;          // BT*4 x kCols

  stage_rows<BT>(x, ld_x, batch, row0, r_lo, n_rows, part_rows, xs);
  __syncthreads();

  unsigned acc[BT * 4];
#pragma unroll
  for (int k = 0; k < BT * 4; ++k) acc[k] = 0u;
  const int col0 = slice * kSlice + threadIdx.x * 4;
  if (col0 < cols) {
    const size_t plane = (size_t)rows_d * cols;
    const int8_t* base = digits + (size_t)r_lo * cols + col0;
#pragma unroll 2
    for (int i = threadIdx.y; i < n_rows; i += kLanes) {
      const int8_t* row = base + (size_t)i * cols;
      char4 d[kMaxPlanes];
#pragma unroll
      for (int w = 0; w < kMaxPlanes; ++w) {
        d[w] = (w < width && ((plane_mask >> w) & 1u))
                   ? *reinterpret_cast<const char4*>(row + w * plane)
                   : make_char4(0, 0, 0, 0);
      }
      unsigned v0 = 0u, v1 = 0u, v2 = 0u, v3 = 0u;
#pragma unroll
      for (int w = 0; w < kMaxPlanes; ++w) {
        v0 += static_cast<unsigned>(static_cast<int>(d[w].x)) << w;
        v1 += static_cast<unsigned>(static_cast<int>(d[w].y)) << w;
        v2 += static_cast<unsigned>(static_cast<int>(d[w].z)) << w;
        v3 += static_cast<unsigned>(static_cast<int>(d[w].w)) << w;
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const unsigned xv = static_cast<unsigned>(xs[b * part_rows + i]);
        acc[b * 4 + 0] += xv * v0;
        acc[b * 4 + 1] += xv * v1;
        acc[b * 4 + 2] += xv * v2;
        acc[b * 4 + 3] += xv * v3;
      }
    }
  }
  reduce_lanes<BT * 4>(acc, red, sums);   // sums[(b * 4 + j) * kCols + c]

  cluster.sync();                          // every part's sums are ready
  if (part == 0) {
    const int tid = threadIdx.y * kCols + threadIdx.x;
    for (int idx = tid; idx < BT * kSlice; idx += kThreads) {
      const int b = idx / kSlice;
      const int rem = idx - b * kSlice;    // column within the slice
      const int k = (b * 4 + (rem & 3)) * kCols + (rem >> 2);
      unsigned s = 0u;
      for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(sums, r)[k];
      const int gb = row0 + b;
      const int col = slice * kSlice + rem;
      if (gb < batch && col < cols) {
        y[(size_t)gb * ld_y + col] = static_cast<int>(s);
      }
    }
  }
  cluster.sync();                          // keep sums alive until read
}

template <int BT, typename XT>
int launch(const void* x, int ld_x, int batch, int rows, const void* digits,
           int rows_d, int cols, int width, unsigned plane_mask, int* y,
           int ld_y, int split, int part_rows, cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = bitplane_gemv_kernel<BT, XT>;
  cudaError_t e = allow_smem(kernel, smem_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_slices = (cols + kSlice - 1) / kSlice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_slices * split, (batch + BT - 1) / BT, 1);
  cfg.blockDim = dim3(kCols, kLanes, 1);
  cfg.dynamicSmemBytes = sizeof(int) * (size_t)BT * part_rows
                         + sizeof(unsigned) * (size_t)(kWarps + 1) * BT * 4
                               * kCols;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), ld_x,
                         batch, rows, static_cast<const int8_t*>(digits),
                         rows_d, cols, width, plane_mask, y, ld_y, split,
                         part_rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch(int b_tile, const void* x, int ld_x, int batch, int rows,
             const void* digits, int rows_d, int cols, int width,
             unsigned plane_mask, int* y, int ld_y, int split, int part_rows,
             cudaStream_t s) {
#define BP_ARGS x, ld_x, batch, rows, digits, rows_d, cols, width, \
                plane_mask, y, ld_y, split, part_rows, s
  switch (b_tile) {
    case 1: return launch<1, XT>(BP_ARGS);
    case 2: return launch<2, XT>(BP_ARGS);
    case 4: return launch<4, XT>(BP_ARGS);
    case 8: return launch<8, XT>(BP_ARGS);
    case 16: return launch<16, XT>(BP_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BP_ARGS
}

}  // namespace

// y (batch, cols) int32 <- x (batch, rows) int8 or int32, digit planes
// (width, rows_d, cols) int8; b_tile in {1, 2, 4, 8, 16} batch rows per
// block; rows split over a cluster of `split` blocks, part_rows each.
extern "C" int bitplane_gemv(int x_is_int8, const void* x, int ld_x,
                             int batch, int rows, const void* digits,
                             int rows_d, int cols, int width, int plane_mask,
                             int* y, int ld_y, int b_tile, int split,
                             int part_rows, void* stream) {
  if (width > kMaxPlanes || split < 1 || split > 8 || cols % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned mask = static_cast<unsigned>(plane_mask);
  if (x_is_int8) {
    return dispatch<int8_t>(b_tile, x, ld_x, batch, rows, digits, rows_d,
                            cols, width, mask, y, ld_y, split, part_rows, s);
  }
  return dispatch<int>(b_tile, x, ld_x, batch, rows, digits, rows_d, cols,
                       width, mask, y, ld_y, split, part_rows, s);
}
