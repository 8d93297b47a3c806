// The reservoir rollout, hand-written CUDA C++ for sm_90a: all T steps in
// one persistent, cooperative launch.
//
//   x(n) = (1 - leak) * x(n-1) + leak * tanh(u(n) . W_in + x(n-1) . W)
//   y(n) = x(n) . W_out                              (readout, every k steps)
//
// rollout_run replaces the two Pallas TPU kernels of the JAX package's
// serving path, whose wrappers both launch it:
//   * B1, kernels/reservoir_rollout/reservoir_rollout.py `_rollout_kernel`
//     (launched by `reservoir_rollout`, :117/:211): the generic banded
//     rollout, every term a per-plane tile product << shift;
//   * B2, kernels/reservoir_rollout/specialized.py `_specialized_kernel`
//     (launched by `specialized_rollout`, :162/:253): the plan-specialized
//     rollout, folded int8 tiles (MM terms) plus unrolled shift-add digits
//     (SA terms);
//   * both compute the `y = x @ W_out` epilogue of the TPU kernels' bodies
//     (specialized.py:142, reservoir_rollout.py:107) inside the launch;
//     rollout_readout is that readout as a kernel of its own, for a
//     (batch, dim) state.
// B1's tables are MM terms with a plane shift and no shift-add digits;
// B2's are folded MM terms (shift 0) and digits.
//
// Design.  A TPU grid runs in order, so the JAX kernels carry the state in
// VMEM across a (T, ...) grid.  Here the T loop runs inside one
// cooperative launch whose blocks are all resident (the grid is sized by
// the wrapper from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM
// count), with one grid-wide barrier between steps.
//   * Ownership.  Block k owns `cw` consecutive output columns (a slice of
//     one column block; 8 at LARGE_1024 with 128 blocks) for every batch
//     row and every step.  Only the owner writes its columns: of the
//     states, of the final (possibly donated) buffer, of its own fp32
//     copy of x(n) (`xkeep`, read back by the same block for the leak
//     term), and of the working state `xbuf` -- requantized to int8 once
//     per element per step in int8 mode, fp32 otherwise.  x0 is read only
//     before the first barrier and the final state written only after the
//     last, so the carry may be donated at any T.
//   * Resident tiles.  The wrapper packs each block's share -- its column
//     block's MM term list (row block, shift), its `cw` columns of every
//     MM term's tile (laid out as m16n8k32 B fragments in int8 mode) and
//     its SA digits -- into one contiguous blob; at the start of the
//     launch the block copies it into shared memory with one bulk copy
//     (cp.async.bulk + mbarrier) and keeps it for all T steps.  When a
//     block's share does not fit (a larger plan, fewer blocks) the whole
//     launch reads the same layout from global memory every step.
//   * State exchange.  After each barrier every block copies the whole
//     working state of one batch tile (<= 16 rows) into shared memory with
//     one bulk copy; the buffer rows are padded by 16 bytes so the MMA
//     fragment loads hit 32 distinct banks.  xbuf ping-pongs between two
//     halves, so one barrier per step orders every write before every
//     read of the next step.
//   * Products.  int8 MM terms run on the tensor cores,
//     mma.sync.m16n8k32.s32.s8.s8.s32: batch on M, 8 of the block's
//     columns on N, 32 rows on K, two independent accumulator chains over
//     K.  Each warp takes (term, column group) units, shifts each term's
//     int32 product by its plane shift, and adds its sums into a shared
//     int32 accumulator with integer atomics; SA digits scatter
//     +-(xq << w) into the same accumulator.  int32 sums
//     are exact in any order.  fp32 MM terms stay on CUDA cores (no TF32),
//     one output per thread, terms in schedule order (ascending row
//     block).
//   * Epilogue.  While the state copy is in flight each thread computes
//     u(n) . W_in for its outputs and fetches their x(n-1) into shared
//     memory.  u(n) . W_in in ascending input order, the accurate
//     tanhf and the leak with explicitly rounded operations (no FMA
//     contraction), requantization rounding half to even (rintf) -- the
//     plain PyTorch twin's rounding sequence, so int8 states match it bit
//     for bit.  A column with no terms gets pre = up in fp32.
//   * Readout.  Every k steps each block writes its partial x(n) . W_out
//     over its columns into a (T/k, blocks, B, O) scratch; after the last
//     barrier all threads reduce it over the blocks in ascending order, so
//     predictions are the same from run to run and for any T or chunking.
//
// Bound at the LARGE_1024 serve shape (B = 16 slots, R = 1024, int8-CSD,
// 64 folded 128x128 tiles): one step is 16 * 1024 * 1024 int8 MACs, about
// 34 MOP (17 ns at 1,979 TOP/s), and reads about 1 MiB of tiles plus
// 128 KiB of state (about 0.35 us at 3.35 TB/s); B1's 512 plane tiles make
// it 2.55 us.  With the tiles resident a step moves only the 16 KiB int8
// state into each block, so its floor is one grid barrier plus that copy
// plus the block's 32 (B2) or 256 (B1) MMAs and the epilogue.  Measured
// by chip_smoke.py (profiler device time, NVIDIA H100 80GB HBM3 at a
// 700 W power limit): 3.31 us (B2) and 5.89 us (B1) per step with 128
// blocks and resident shares, about 9x and 2.3x the byte bounds; about
// 2.9 us of a B2 step does not depend on the batch (barrier, copy
// latency, synchronisations).  The earlier cut (one launch per step, 32
// blocks, tiles staged term by term through L2, scalar int32 MACs) took
// 35.1 us (B2) and 264.9 us (B1) on the same card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // MMA M: batch rows of one tile
constexpr int kBarBytes = 16;           // the mbarrier, padded
constexpr int kReadoutThreads = 256;

struct Params {
  const float* __restrict__ u;          // (T, B, I), unit stride over I
  long long su_t, su_b;
  const float* __restrict__ w_in;       // (I, dim)
  const float* __restrict__ w_out;      // (dim, O), or null
  const float* x0;                      // (B, dim); may alias final_state
  float* states;                        // (T, B, dim), or null
  float* preds;                         // (T / k, B, O), or null
  float* final_state;                   // (B, dim), or null
  unsigned char* xbuf;                  // (2, B, ldx bytes) working state
  float* xkeep;                         // (B, rpad) owner's fp32 x(n)
  float* partial;                       // (T / k, blocks, B, O)
  const unsigned char* __restrict__ blob;   // per-block shares
  const int4* __restrict__ blk_meta;    // (offset, MM terms, digits, bytes)
  int steps, batch, dim, in_dim, out_dim, bk, cw, slices, b_tile;
  int readout_every, ldx, rpad, resident;
  float one_minus_leak, leak, smax, recur_scale;
};

__device__ __forceinline__ int quantize(float v, float smax) {
  // clip(round_half_even(x * smax), -smax - 1, smax), as jnp.round does
  float q = rintf(__fmul_rn(v, smax));
  q = fminf(fmaxf(q, -smax - 1.0f), smax);
  return __float2int_rn(q);
}

// -- mbarrier + bulk copy (sm_90) --------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

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
// copies (async proxy) around the grid barrier.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One warp's int32 sums of column group g into the shared accumulator
// (m16n8 C fragment: rows gid, gid + 8; columns 2 tig, 2 tig + 1).
__device__ __forceinline__ void flush(int* acc_s, int cw, int g, int lane,
                                      const int (&acc)[4]) {
  const int gid = lane >> 2, col = g * 8 + (lane & 3) * 2;
  atomicAdd(&acc_s[gid * cw + col], acc[0]);
  atomicAdd(&acc_s[gid * cw + col + 1], acc[1]);
  atomicAdd(&acc_s[(gid + 8) * cw + col], acc[2]);
  atomicAdd(&acc_s[(gid + 8) * cw + col + 1], acc[3]);
}

template <bool INT8>
__device__ __forceinline__ void store_work(unsigned char* buf, int ldx, int b,
                                           int col, float v, float smax) {
  if constexpr (INT8) {
    buf[(size_t)b * ldx + col] = static_cast<unsigned char>(
        static_cast<signed char>(quantize(v, smax)));
  } else {
    reinterpret_cast<float*>(buf + (size_t)b * ldx)[col] = v;
  }
}

template <bool INT8>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem + kBarBytes;                      // kRows x ldx
  int* acc_s = reinterpret_cast<int*>(xs + kRows * p.ldx);   // kRows x cw
  float* up_s = reinterpret_cast<float*>(
      acc_s + (INT8 ? kRows * p.cw : 0));                    // kRows x cw
  float* prev_s = up_s + kRows * p.cw;                       // kRows x cw
  unsigned char* res =
      reinterpret_cast<unsigned char*>(prev_s + kRows * p.cw);  // the share

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int blk = blockIdx.x;
  const int ci = blk / p.slices;
  const int c0 = ci * p.bk + (blk - ci * p.slices) * p.cw;  // first column
  const int4 meta = p.blk_meta[blk];
  const unsigned char* share = p.resident ? res : p.blob + meta.x;
  const int n_mm = meta.y;
  const int n_dg = meta.z;
  // share: n_mm (row block, shift) pairs padded to 16 bytes, the tiles,
  // the digits
  const int2* mm = reinterpret_cast<const int2*>(share);
  const unsigned char* tiles = share + ((n_mm * 8 + 15) & ~15);
  const uint32_t* digits = reinterpret_cast<const uint32_t*>(
      tiles + (size_t)n_mm * p.bk * p.cw * (INT8 ? 1 : 4));
  const size_t half = (size_t)p.batch * p.ldx;
  const uint32_t bar = smem_u32(smem);
  uint32_t phase = 0;
  cg::grid_group grid = cg::this_grid();

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool load_share = p.resident && meta.w > 0;
  if (load_share && tid == 0) {
    bulk_load(smem_u32(res), p.blob + meta.x, meta.w, bar);
  }
  // x(0): the owner's fp32 copy and the working state's first half
  for (int idx = tid; idx < p.batch * p.cw; idx += kThreads) {
    const int b = idx / p.cw;
    const int col = c0 + idx - b * p.cw;
    const float v = col < p.dim ? p.x0[(size_t)b * p.dim + col] : 0.0f;
    p.xkeep[(size_t)b * p.rpad + col] = v;
    store_work<INT8>(p.xbuf, p.ldx, b, col, v, p.smax);
  }
  fence_async_global();
  grid.sync();
  if (load_share) {
    mbar_wait(bar, phase);
    phase ^= 1;
  }

  const int groups = p.cw >> 3;
  const int kch = p.bk >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_units = n_mm * groups;
  for (int t = 0; t < p.steps; ++t) {
    const unsigned char* xin = p.xbuf + (t & 1) * half;
    unsigned char* xnext = p.xbuf + ((t + 1) & 1) * half;
    for (int b0 = 0; b0 < p.batch; b0 += p.b_tile) {
      const int bt = min(p.b_tile, p.batch - b0);
      __syncthreads();      // the previous tile is done with xs and acc_s
      if (tid == 0) {
        fence_async_global();
        bulk_load(smem_u32(xs), xin + (size_t)b0 * p.ldx, bt * p.ldx, bar);
      }
      // while the copy is in flight: u(n) . W_in and x(n-1) of the
      // thread's outputs (read back by the same thread after the wait)
      for (int idx = tid; idx < bt * p.cw; idx += kThreads) {
        const int r = idx / p.cw;
        const int col = c0 + idx - r * p.cw;
        const int b = b0 + r;
        if (col < p.dim) {
          const float* u = p.u + t * p.su_t + b * p.su_b;
          float up = __fmul_rn(u[0], p.w_in[col]);
          for (int m = 1; m < p.in_dim; ++m) {
            up = __fadd_rn(up,
                           __fmul_rn(u[m], p.w_in[(size_t)m * p.dim + col]));
          }
          up_s[idx] = up;
          prev_s[idx] = p.xkeep[(size_t)b * p.rpad + col];
        }
      }
      if constexpr (INT8) {
        for (int i = tid; i < kRows * p.cw; i += kThreads) acc_s[i] = 0;
        __syncthreads();    // acc_s is zero before any thread adds to it
      }
      mbar_wait(bar, phase);
      phase ^= 1;

      if constexpr (INT8) {
        // MM terms on the tensor cores; rows >= bt of xs hold stale
        // values whose products land in rows nobody reads
        int cur = -1;
        int acc[4] = {0, 0, 0, 0};
        for (int unit = warp; unit < n_units; unit += kWarps) {
          const int m = unit / groups;
          const int g = unit - m * groups;
          if (g != cur) {
            if (cur >= 0) flush(acc_s, p.cw, cur, lane, acc);
            cur = g;
            acc[0] = acc[1] = acc[2] = acc[3] = 0;
          }
          const int2 term = mm[m];
          const unsigned char* xa = xs + gid * p.ldx + term.x * p.bk + tig * 4;
          const uint2* fb = reinterpret_cast<const uint2*>(
              tiles + ((size_t)m * kch * groups + g) * 256) + lane;
          // two independent chains over the 32-row chunks
          int c[4] = {0, 0, 0, 0};
          int d[4] = {0, 0, 0, 0};
          for (int kc = 0; kc < kch; kc += 2) {
            const unsigned char* xk = xa + kc * 32;
            mma_s8(c, ld32(xk), ld32(xk + 8 * p.ldx), ld32(xk + 16),
                   ld32(xk + 8 * p.ldx + 16), fb[kc * groups * 32]);
            if (kc + 1 < kch) {
              xk += 32;
              mma_s8(d, ld32(xk), ld32(xk + 8 * p.ldx), ld32(xk + 16),
                     ld32(xk + 8 * p.ldx + 16), fb[(kc + 1) * groups * 32]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {    // exact modulo 2^32
            const uint32_t part = static_cast<uint32_t>(c[i]) +
                                  static_cast<uint32_t>(d[i]);
            acc[i] = static_cast<int>(static_cast<uint32_t>(acc[i]) +
                                      (part << term.y));
          }
        }
        if (cur >= 0) flush(acc_s, p.cw, cur, lane, acc);
        // SA digits: +-(xq[:, row] << w) into column jj
        for (int idx = tid; idx < n_dg * bt; idx += kThreads) {
          const int d = idx / bt;
          const int r = idx - d * bt;
          const uint32_t dg = digits[d];
          const int v = static_cast<int>(static_cast<signed char>(
                            xs[r * p.ldx + (dg & 0xffffu)]))
                        << ((dg >> 24) & 0xfu);
          atomicAdd(&acc_s[r * p.cw + ((dg >> 16) & 0xffu)],
                    (dg >> 28) ? -v : v);
        }
        __syncthreads();
      }

      for (int idx = tid; idx < bt * p.cw; idx += kThreads) {
        const int r = idx / p.cw;
        const int j = idx - r * p.cw;
        const int col = c0 + j;
        const int b = b0 + r;
        float nx = 0.0f;
        if (col < p.dim) {
          const float up = up_s[idx];
          float pre;
          if constexpr (INT8) {
            pre = __fadd_rn(up, __fmul_rn(__int2float_rn(acc_s[r * p.cw + j]),
                                          p.recur_scale));
          } else {
            // fp32 MM terms in schedule order, one output per thread
            const float* xr = reinterpret_cast<const float*>(xs + r * p.ldx);
            const float* tl = reinterpret_cast<const float*>(tiles) + j;
            float acc = 0.0f;
            for (int m = 0; m < n_mm; ++m) {
              const float* xm = xr + mm[m].x * p.bk;
              const float* tm = tl + (size_t)m * p.bk * p.cw;
              float part = 0.0f;
#pragma unroll 8
              for (int k = 0; k < p.bk; ++k) part += xm[k] * tm[k * p.cw];
              acc += part;
            }
            pre = n_mm > 0 ? __fadd_rn(up, acc) : up;
          }
          nx = __fadd_rn(__fmul_rn(p.one_minus_leak, prev_s[idx]),
                         __fmul_rn(p.leak, tanhf(pre)));
          p.xkeep[(size_t)b * p.rpad + col] = nx;
          if (p.states != nullptr) {
            p.states[((size_t)t * p.batch + b) * p.dim + col] = nx;
          }
          if (p.final_state != nullptr && t == p.steps - 1) {
            p.final_state[(size_t)b * p.dim + col] = nx;
          }
        }
        store_work<INT8>(xnext, p.ldx, b, col, nx, p.smax);
      }
    }
    const bool readout = p.preds != nullptr && (t + 1) % p.readout_every == 0;
    if (readout) {
      __syncthreads();      // every owned x(n) is in xkeep
      const int r = (t + 1) / p.readout_every - 1;
      float* part = p.partial +
                    ((size_t)r * gridDim.x + blk) * p.batch * p.out_dim;
      for (int idx = tid; idx < p.batch * p.out_dim; idx += kThreads) {
        const int b = idx / p.out_dim;
        const int o = idx - b * p.out_dim;
        const float* xr = p.xkeep + (size_t)b * p.rpad;
        float s = 0.0f;
        for (int j = 0; j < p.cw && c0 + j < p.dim; ++j) {
          s = fmaf(xr[c0 + j], p.w_out[(size_t)(c0 + j) * p.out_dim + o], s);
        }
        part[idx] = s;
      }
    }
    if (t + 1 < p.steps || p.preds != nullptr) {
      fence_async_global();
      grid.sync();
    }
  }

  if (p.preds != nullptr) {
    // y = the blocks' partial sums, in ascending block order
    const int per = p.batch * p.out_dim;
    const int n = (p.steps / p.readout_every) * per;
    for (int e = blk * kThreads + tid; e < n; e += gridDim.x * kThreads) {
      const int r = e / per;
      const float* src =
          p.partial + (size_t)r * gridDim.x * per + (e - r * per);
      float s = src[0];
      for (int q = 1; q < (int)gridDim.x; ++q) s += src[(size_t)q * per];
      p.preds[e] = s;
    }
  }
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

template <bool INT8>
int occupancy(int smem, int* blocks_per_sm) {
  static bool done = false;
  cudaError_t e = fixedmat::allow_smem(rollout_kernel<INT8>, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rollout_kernel<INT8>, kThreads, smem));
}

template <bool INT8>
int launch(Params p, int n_blocks, int smem, void* stream) {
  static bool done = false;
  cudaError_t e = fixedmat::allow_smem(rollout_kernel<INT8>, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  // the cooperative launch refuses a grid whose blocks cannot all be
  // resident at once (cudaErrorCooperativeLaunchTooLarge): no fallback
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rollout_kernel<INT8>), dim3(n_blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1 and B2: T steps of the rollout in one cooperative launch.
extern "C" int rollout_run(
    int int8_mode, const float* u, long long su_t, long long su_b,
    const float* w_in, const float* w_out, const float* x0, float* states,
    float* preds, float* final_state, void* xbuf, float* xkeep,
    float* partial, const void* blob, const void* blk_meta, int steps,
    int batch, int dim, int in_dim, int out_dim, int bk, int cw, int slices,
    int b_tile, int readout_every, int ldx, int rpad, int resident,
    int n_blocks, int smem, float one_minus_leak, float leak, float smax,
    float recur_scale, void* stream) {
  Params p;
  p.u = u;
  p.su_t = su_t;
  p.su_b = su_b;
  p.w_in = w_in;
  p.w_out = w_out;
  p.x0 = x0;
  p.states = states;
  p.preds = preds;
  p.final_state = final_state;
  p.xbuf = static_cast<unsigned char*>(xbuf);
  p.xkeep = xkeep;
  p.partial = partial;
  p.blob = static_cast<const unsigned char*>(blob);
  p.blk_meta = static_cast<const int4*>(blk_meta);
  p.steps = steps;
  p.batch = batch;
  p.dim = dim;
  p.in_dim = in_dim;
  p.out_dim = out_dim;
  p.bk = bk;
  p.cw = cw;
  p.slices = slices;
  p.b_tile = b_tile;
  p.readout_every = readout_every;
  p.ldx = ldx;
  p.rpad = rpad;
  p.resident = resident;
  p.one_minus_leak = one_minus_leak;
  p.leak = leak;
  p.smax = smax;
  p.recur_scale = recur_scale;
  return int8_mode ? launch<true>(p, n_blocks, smem, stream)
                   : launch<false>(p, n_blocks, smem, stream);
}

// Blocks of the rollout kernel one SM holds at `smem` bytes of dynamic
// shared memory (the wrapper multiplies by the SM count).
extern "C" int rollout_occupancy(int int8_mode, int smem, int* blocks_per_sm) {
  return int8_mode ? occupancy<true>(smem, blocks_per_sm)
                   : occupancy<false>(smem, blocks_per_sm);
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
