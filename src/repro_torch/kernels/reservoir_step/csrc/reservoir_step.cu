// One dense reservoir step, hand-written CUDA C++ for sm_90a:
//
//   x' = (1 - leak) * x + leak * tanh(u @ W_in + x @ W)      (paper Eq. 1)
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/reservoir_step/reservoir_step.py, launched by
// `reservoir_step` (:44, pallas_call at :72).  The TPU kernel reduces over
// R on a sequential grid axis, seeds the output tile with u @ W_in on the
// first step and applies the leak/tanh epilogue on the last.  A CUDA grid
// has no sequential axis, so here the reduction over R is a loop inside
// the thread block: each block owns an 8-column slice of the output for a
// tile of batch rows, its 32 row lanes walk 4 rows of W at a time, the
// lanes are summed in a fixed order, and the epilogue runs in the same
// launch.  fp32 throughout on CUDA cores (no TF32).  The epilogue adds
// u @ W_in in ascending input order with separately rounded multiplies and
// adds, applies the accurate tanhf and a separately rounded leak, as the
// rollout kernels do.  Dims that are not a multiple of 8 are masked, not
// padded.
//
// Bound.  At LARGE_1024 (B = 16, R = 1024, I = 1) the step must read the
// 4 MiB dense W: 1.25 us at 3.35 TB/s; its 34 MFLOP take 0.5 us at
// 67 TFLOP/s, so it is bound by bytes.  An 8-column fp32 slice of a row of
// W is 32 contiguous bytes (one DRAM sector), which gives 128 thread
// blocks at R = 1024; x is staged once per block in shared memory and
// read 4 rows at a time.  Later work: a tensor-core (3xTF32 or bf16x3)
// product and several steps per launch.

#include "../../common.cuh"

using namespace fixedmat;

namespace {

template <int BT>
__global__ void __launch_bounds__(kThreads) reservoir_step_kernel(
    const float* __restrict__ x, int ld_x, int batch, int dim,
    const float* __restrict__ w, const float* __restrict__ u, int ld_u,
    const float* __restrict__ w_in, int in_dim, float one_minus_leak,
    float leak, float* __restrict__ out, int ld_out, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);          // BT x stride
  float* red = xs + BT * stride;
  float* sums = red + kWarps * BT * kCols;             // BT x kCols

  const int col0 = blockIdx.x * kCols;
  const int col = col0 + threadIdx.x;
  const int row0 = blockIdx.y * BT;
  stage_rows<BT>(x, ld_x, batch, row0, 0, dim, stride, xs);
  __syncthreads();

  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.0f;
  const int groups = stride / 4;
  const bool live = col < dim;
#pragma unroll 4
  for (int g = threadIdx.y; g < groups; g += kLanes) {
    float wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * g + j;
      wv[j] = (live && r < dim) ? w[(size_t)r * dim + col] : 0.0f;
    }
    const float4* xr = reinterpret_cast<const float4*>(xs) + g;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float4 xv = xr[b * groups];
      acc[b] = fmaf(xv.x, wv[0], acc[b]);
      acc[b] = fmaf(xv.y, wv[1], acc[b]);
      acc[b] = fmaf(xv.z, wv[2], acc[b]);
      acc[b] = fmaf(xv.w, wv[3], acc[b]);
    }
  }
  reduce_lanes<BT>(acc, red, sums);                    // sums[b * kCols + c]

  const int tid = threadIdx.y * kCols + threadIdx.x;
  if (tid >= BT * kCols) return;
  const int b = tid / kCols;
  const int gb = row0 + b;
  const int c = col0 + (tid - b * kCols);
  if (gb >= batch || c >= dim) return;
  const float* ub = u + (size_t)gb * ld_u;
  float up = __fmul_rn(ub[0], w_in[c]);
  for (int m = 1; m < in_dim; ++m) {
    up = __fadd_rn(up, __fmul_rn(ub[m], w_in[(size_t)m * dim + c]));
  }
  const float pre = __fadd_rn(up, sums[tid]);
  const float xv = x[(size_t)gb * ld_x + c];
  out[(size_t)gb * ld_out + c] = __fadd_rn(__fmul_rn(one_minus_leak, xv),
                                           __fmul_rn(leak, tanhf(pre)));
}

template <int BT>
int launch(const float* x, int ld_x, int batch, int dim, const float* w,
           const float* u, int ld_u, const float* w_in, int in_dim,
           float one_minus_leak, float leak, float* out, int ld_out,
           cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = reservoir_step_kernel<BT>;
  const cudaError_t e = allow_smem(kernel, smem_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int stride = (dim + 3) / 4 * 4;
  const dim3 grid((dim + kCols - 1) / kCols, (batch + BT - 1) / BT);
  const size_t smem = 4 * ((size_t)BT * stride
                           + (size_t)(kWarps + 1) * BT * kCols);
  kernel<<<grid, dim3(kCols, kLanes), smem, stream>>>(
      x, ld_x, batch, dim, w, u, ld_u, w_in, in_dim, one_minus_leak, leak,
      out, ld_out, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (batch, dim) <- one step from x (batch, dim), W (dim, dim), u
// (batch, in_dim), W_in (in_dim, dim), all float32 and row-major; b_tile in
// {1, 2, 4, 8, 16} batch rows per block.  out must not overlap x.
extern "C" int reservoir_step(const float* x, int ld_x, int batch, int dim,
                              const float* w, const float* u, int ld_u,
                              const float* w_in, int in_dim,
                              float one_minus_leak, float leak, float* out,
                              int ld_out, int b_tile, void* stream) {
  if (in_dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STEP_ARGS x, ld_x, batch, dim, w, u, ld_u, w_in, in_dim, \
                  one_minus_leak, leak, out, ld_out, s
  switch (b_tile) {
    case 1: return launch<1>(STEP_ARGS);
    case 2: return launch<2>(STEP_ARGS);
    case 4: return launch<4>(STEP_ARGS);
    case 8: return launch<8>(STEP_ARGS);
    case 16: return launch<16>(STEP_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STEP_ARGS
}
