// One step of the reservoir rollout, hand-written CUDA C++ for sm_90a.
//
//   x(n) = (1 - leak) * x(n-1) + leak * tanh(u(n) . W_in + x(n-1) . W)
//   y(n) = x(n) . W_out                              (readout, every k steps)
//
// Replaces the two Pallas TPU kernels of the JAX package's serving path:
//   * reservoir_rollout_step   -> kernels/reservoir_rollout/reservoir_rollout.py
//     `_rollout_kernel` (launched by `reservoir_rollout`, :117/:211): the
//     generic banded rollout, every term a per-plane tile product << shift;
//   * specialized_rollout_step -> kernels/reservoir_rollout/specialized.py
//     `_specialized_kernel` (launched by `specialized_rollout`, :162/:253):
//     the plan-specialized rollout, folded int8 tiles (MM terms) plus
//     unrolled shift-add digits (SA terms);
//   * rollout_readout           -> the `y = x @ W_out` epilogue both TPU
//     kernels compute in their own body (specialized.py:142,
//     reservoir_rollout.py:107).
// Both step entry points share one kernel template; B1 instantiates it
// without the shift-add path.
//
// Design.  A TPU grid runs in order, so the JAX kernels carry the state in
// VMEM across a (T, ...) grid.  A CUDA grid has no sequential axis, so
// this first cut is ONE LAUNCH PER STEP from a host loop over T on
// PyTorch's current stream, with the state ping-ponging through device
// memory.  Each thread block owns a slice of `cw` columns (32, or the
// whole block when it is narrower) of one output column block (`bk`
// columns, a runtime parameter: 128 in the configs, 64 in the test
// matrices) and one batch tile (<= 16 rows); thread (j, r) owns one
// output column and one batch row.  The block walks its column block's
// term list from a device-side descriptor table: for each term it stages
// the needed slice of x(n-1) in shared memory (requantized to int32 in
// int8 mode), then
//   MM term (kind 0, tile, shift, row_block): the block stages its
//     bk x cw slice of the tile in shared memory with all threads' loads
//     in flight at once, and each thread reduces its column against its
//     row of the staged state;
//   SA term (kind 1, row_block, digit_lo, digit_hi): the block's threads
//     scatter +-(xq[:, i] << w) for the digits in its columns into a
//     shared int32 accumulator with integer atomics (exact in any order).
// int8 sums are exact int32; fp32 sums follow the term order (ascending
// row block, as the JAX kernels do).  The epilogue adds u(n) . W_in in
// ascending input order, applies the accurate tanhf and the leak with
// explicitly rounded operations (no FMA contraction), so the plain
// PyTorch twin reproduces it; requantization rounds half to even (rintf).
//
// Bound at the LARGE_1024 serve shape (B = 16 slots, R = 1024, int8-CSD,
// 64 folded 128x128 tiles): one step is 16 * 1024 * 1024 int8 MACs, about
// 34 MOP (17 ns at 1,979 TOP/s), and reads about 1 MiB of tiles plus
// 128 KiB of state (about 0.35 us at 3.35 TB/s).  Both bounds are well
// under a microsecond, so a step is bound by latency: of the launch, of
// the tile loads, and of a grid of only 32 blocks (4 slices x 8 column
// blocks) on 132 SMs.  Slicing the column blocks and staging each tile
// slice cut a B2 step from 174 us of device time (one block per column
// block, tile bytes loaded one at a time where used) to 35 us, measured
// by chip_smoke.py with the profiler on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit; the tiles stay L2 resident (1 MiB of the 50 MB L2),
// and the Python host loop now takes about as long to issue a step as
// the device takes to run it.  The rest is later work: a
// CUDA graph or a persistent kernel with a grid barrier over the T loop,
// shared-memory-resident bands, int8 tensor-core MMA and TMA band
// streaming.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kReadoutThreads = 256;

__device__ __forceinline__ int quantize(float v, float smax) {
  // clip(round_half_even(x * smax), -smax - 1, smax), as jnp.round does
  float q = rintf(__fmul_rn(v, smax));
  q = fminf(fmaxf(q, -smax - 1.0f), smax);
  return __float2int_rn(q);
}

template <bool INT8, bool HAS_SA>
__global__ void rollout_step_kernel(
    const float* __restrict__ x_prev, int ld_prev,
    float* __restrict__ x_next, int ld_next,
    float* __restrict__ x_copy, int ld_copy,
    const float* __restrict__ u_t, int ld_u,
    const float* __restrict__ w_in,           // (in_dim, dim)
    const void* __restrict__ tiles_v,         // (n_tiles, bk, bk)
    const int* __restrict__ col_ptr,          // (n_col_blocks + 1)
    const int4* __restrict__ terms,           // (n_terms)
    const int4* __restrict__ digits,          // (n_digits) (i, j, sign, w)
    int batch, int dim, int in_dim, int bk, int cw, int b_tile,
    float one_minus_leak, float leak, float smax, float recur_scale) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  using Tile = typename std::conditional<INT8, int8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* xs = reinterpret_cast<Acc*>(smem_raw);              // b_tile x bk
  int* sa = reinterpret_cast<int*>(xs + b_tile * bk);      // b_tile x cw
  Tile* ts = reinterpret_cast<Tile*>(
      sa + ((HAS_SA && INT8) ? b_tile * cw : 0));          // bk x cw

  const int slices = bk / cw;
  const int ci = blockIdx.x / slices;
  const int c0 = (blockIdx.x - ci * slices) * cw;   // slice's first column
  const int row0 = blockIdx.y * b_tile;
  const int j = threadIdx.x;
  const int r = threadIdx.y;
  const int tid = r * cw + j;
  const int nthreads = cw * b_tile;
  const int col = ci * bk + c0 + j;
  const int slab = b_tile * bk;

  Acc acc = 0;
  if constexpr (HAS_SA && INT8) {
    sa[tid] = 0;
  }

  const int lo = col_ptr[ci];
  const int hi = col_ptr[ci + 1];
  for (int t = lo; t < hi; ++t) {
    const int4 term = terms[t];
    const bool is_mm = term.x == 0;
    const int rb = is_mm ? term.w : term.y;
    __syncthreads();  // the previous term is done with xs and ts
    for (int idx = tid; idx < slab; idx += nthreads) {
      const int rr = idx / bk;
      const int gb = row0 + rr;
      const int gc = rb * bk + (idx - rr * bk);
      const float v = (gb < batch && gc < dim)
                          ? x_prev[(size_t)gb * ld_prev + gc] : 0.0f;
      if constexpr (INT8) {
        xs[idx] = quantize(v, smax);
      } else {
        xs[idx] = v;
      }
    }
    if (is_mm) {
      const Tile* tile =
          static_cast<const Tile*>(tiles_v) + (size_t)term.y * bk * bk + c0;
      for (int idx = tid; idx < bk * cw; idx += nthreads) {
        const int i = idx / cw;
        ts[idx] = tile[(size_t)i * bk + (idx - i * cw)];
      }
    }
    __syncthreads();
    if (is_mm) {
      Acc part = 0;
      const Acc* xr = xs + r * bk;
#pragma unroll 8
      for (int i = 0; i < bk; ++i) {
        part += xr[i] * static_cast<Acc>(ts[i * cw + j]);
      }
      if constexpr (INT8) {
        acc += part << term.z;
      } else {
        acc += part;
      }
    } else if constexpr (HAS_SA && INT8) {
      for (int d = term.z + tid; d < term.w; d += nthreads) {
        const int4 dg = digits[d];
        const int jj = dg.y - c0;
        if (jj < 0 || jj >= cw) continue;   // another slice's column
        for (int rr = 0; rr < b_tile; ++rr) {
          const int v = xs[rr * bk + dg.x] << dg.w;
          atomicAdd(&sa[rr * cw + jj], dg.z > 0 ? v : -v);
        }
      }
    }
  }
  if constexpr (HAS_SA && INT8) {
    __syncthreads();
    acc += sa[tid];
  }
  const int b = row0 + r;
  if (col >= dim || b >= batch) return;

  const float* u = u_t + (size_t)b * ld_u;
  float up = __fmul_rn(u[0], w_in[col]);
  for (int m = 1; m < in_dim; ++m) {
    up = __fadd_rn(up, __fmul_rn(u[m], w_in[(size_t)m * dim + col]));
  }
  float pre;
  if constexpr (INT8) {
    pre = __fadd_rn(up, __fmul_rn(__int2float_rn(acc), recur_scale));
  } else {
    pre = hi > lo ? __fadd_rn(up, acc) : up;
  }
  const float xv = x_prev[(size_t)b * ld_prev + col];
  const float nx = __fadd_rn(__fmul_rn(one_minus_leak, xv),
                             __fmul_rn(leak, tanhf(pre)));
  x_next[(size_t)b * ld_next + col] = nx;
  if (x_copy != nullptr) x_copy[(size_t)b * ld_copy + col] = nx;
}

__global__ void readout_kernel(const float* __restrict__ x, int ld_x,
                               const float* __restrict__ w_out,  // (dim, O)
                               float* __restrict__ y, int ld_y,
                               int dim, int out_dim) {
  __shared__ float red[kReadoutThreads / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xr = x + (size_t)b * ld_x;
  for (int o = 0; o < out_dim; ++o) {
    float p = 0.0f;
    for (int r = threadIdx.x; r < dim; r += kReadoutThreads) {
      p = fmaf(xr[r], w_out[(size_t)r * out_dim + o], p);
    }
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_down_sync(0xffffffffu, p, off);
    }
    if (lane == 0) red[warp] = p;
    __syncthreads();
    if (warp == 0) {
      p = lane < kReadoutThreads / 32 ? red[lane] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        p += __shfl_down_sync(0xffffffffu, p, off);
      }
      if (lane == 0) y[(size_t)b * ld_y + o] = p;
    }
    __syncthreads();
  }
}

template <bool HAS_SA>
int launch_step(int int8_mode, const float* x_prev, int ld_prev,
                float* x_next, int ld_next, float* x_copy, int ld_copy,
                const float* u_t, int ld_u, const float* w_in,
                const void* tiles, const int* col_ptr, const void* terms,
                const void* digits, int batch, int dim, int in_dim, int bk,
                int cw, int n_col_blocks, int b_tile, float one_minus_leak,
                float leak, float smax, float recur_scale, void* stream) {
  const dim3 block(cw, b_tile);
  const dim3 grid(n_col_blocks * (bk / cw), (batch + b_tile - 1) / b_tile);
  const bool sa = HAS_SA && int8_mode;
  const size_t smem = (size_t)b_tile * bk * 4 + (sa ? (size_t)b_tile * cw * 4 : 0)
                      + (size_t)bk * cw * (int8_mode ? 1 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* tm = static_cast<const int4*>(terms);
  const int4* dg = static_cast<const int4*>(digits);
#define ROLLOUT_ARGS                                                       \
  x_prev, ld_prev, x_next, ld_next, x_copy, ld_copy, u_t, ld_u, w_in,      \
      tiles, col_ptr, tm, dg, batch, dim, in_dim, bk, cw, b_tile,          \
      one_minus_leak, leak, smax, recur_scale
  if (!int8_mode) {
    rollout_step_kernel<false, false><<<grid, block, smem, s>>>(ROLLOUT_ARGS);
  } else if (HAS_SA) {
    rollout_step_kernel<true, true><<<grid, block, smem, s>>>(ROLLOUT_ARGS);
  } else {
    rollout_step_kernel<true, false><<<grid, block, smem, s>>>(ROLLOUT_ARGS);
  }
#undef ROLLOUT_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define STEP_PARAMS                                                        \
  int int8_mode, const float *x_prev, int ld_prev, float *x_next,          \
      int ld_next, float *x_copy, int ld_copy, const float *u_t, int ld_u, \
      const float *w_in, const void *tiles, const int *col_ptr,            \
      const void *terms, const void *digits, int batch, int dim,           \
      int in_dim, int bk, int cw, int n_col_blocks, int b_tile,            \
      float one_minus_leak, float leak, float smax, float recur_scale,     \
      void *stream
#define STEP_ARGS                                                          \
  int8_mode, x_prev, ld_prev, x_next, ld_next, x_copy, ld_copy, u_t, ld_u, \
      w_in, tiles, col_ptr, terms, digits, batch, dim, in_dim, bk, cw,     \
      n_col_blocks, b_tile, one_minus_leak, leak, smax, recur_scale, stream

// B1: generic banded rollout step (MM terms only, each with its shift).
extern "C" int reservoir_rollout_step(STEP_PARAMS) {
  return launch_step<false>(STEP_ARGS);
}

// B2: specialized rollout step (folded MM terms + shift-add SA terms).
extern "C" int specialized_rollout_step(STEP_PARAMS) {
  return launch_step<true>(STEP_ARGS);
}

// Readout y = x . W_out for a (batch, dim) state, one block per row.
extern "C" int rollout_readout(const float* x, int ld_x, const float* w_out,
                               float* y, int ld_y, int batch, int dim,
                               int out_dim, void* stream) {
  readout_kernel<<<batch, kReadoutThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, ld_x, w_out, y, ld_y, dim, out_dim);
  return static_cast<int>(cudaGetLastError());
}
