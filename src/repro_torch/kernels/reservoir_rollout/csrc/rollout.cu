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
//     (specialized.py:142, reservoir_rollout.py:107) inside the launch.
// B1's tables are MM terms with a plane shift and no shift-add digits;
// B2's are folded MM terms (shift 0) and digits.
//
// Design.  A TPU grid runs in order, so the JAX kernels carry the state in
// VMEM across a (T, ...) grid.  Here the T loop runs inside one
// cooperative launch whose blocks are all resident (the grid is sized by
// the wrapper from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM
// count), with one grid-wide barrier between steps: each block's first
// thread adds 1 to a count with release semantics (after a __syncthreads)
// and waits with acquire loads until the count reaches (t + 1) x blocks,
// so a block can work between its arrival and its wait.
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
//     its SA digits; or, in the int8 list form, its columns' folded
//     (row, weight) lists -- into one contiguous blob; at the start of the
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
//     are exact in any order.  A sparse int8 table takes the list form
//     instead (LISTS; pack_blocks chooses it from the table): each column
//     is one list of (state row, weight) words whose weight folds every
//     MM term's element << shift and every digit of that (row, column),
//     so a 98 %-sparse column costs its ~80 nonzeros, not a dense tile's
//     128 rows per row block.  The column's L = list_lanes(cw) lanes each
//     sum entries l, l + L, ... as xq * weight in int32 for every batch
//     row of the tile (a weight read once for the tile), the lanes meet
//     in __shfl_xor_sync levels, and the first stores the column's sums
//     into the accumulator with plain stores: no zero-fill of it and no
//     __syncthreads after that, no atomics, no digit scatter.  The int32
//     sums are the MMA path's, exactly.  fp32 MM terms stay on CUDA
//     cores (IEEE fp32 FMAs, no TF32) and use every thread: the block's
//     rows are flattened to q = term * bk + row (terms in schedule order)
//     and each 8-column group's rows split into W = max(1, 8 / groups)
//     contiguous ranges, one warp each.  Lane (column l % 8, kq = l / 8)
//     sums rows kq, kq + 4, ... of its range with one FMA chain per batch
//     row, so a weight is read once for the whole batch tile; the 4 lanes of a
//     column meet in a butterfly over kq, and the epilogue adds the W
//     warps' sums in ascending order.  An output's sum order depends on
//     cw, the block's term count and bk alone -- never on the batch, the
//     tile, T or chunking -- so a row's state is the same bits at any
//     batch.  At cw = 8 (dim 800 on 112 blocks): 32 partials of 28 FMAs
//     instead of one chain of 896 on 8 threads.
//   * Epilogue.  While the state copy is in flight each thread computes
//     u(n) . W_in for its outputs and fetches their x(n-1) into shared
//     memory.  u(n) . W_in in ascending input order, the accurate
//     tanhf and the leak with explicitly rounded operations (no FMA
//     contraction), requantization rounding half to even (rintf) -- the
//     plain PyTorch twin's rounding sequence, so int8 states match it bit
//     for bit.  A column with no terms gets pre = up in fp32.
//   * Readout.  Every k steps each block forms its partial x(n) . W_out
//     over its cw columns: the epilogue leaves each thread's x(n) in
//     shared memory (its own slot of the x(n-1) buffer), and a row's cw
//     products x(n, j) * W_out[j, o] meet in one pairwise tree over column
//     index j (adjacent pairs first, zero-padded to a power of two).  When
//     cw divides 32 a row's columns are one lane group of a warp: each
//     thread reads back only its own x(n), the tree is __shfl_xor_sync
//     levels of width cw, unrolled, and it runs between the block's
//     arrival at the step barrier and its wait, off the step's critical
//     path (for the last batch tile; on the last step before arriving).
//     No __syncthreads of its own and no read-back of xkeep.  Wider slices
//     (cw > 32, small explicit grids) run the same tree after one
//     __syncthreads, 32 columns per lane group and then over the groups.
//     The order depends on cw alone -- never on the batch, the tile, T or
//     chunking.  Lane 0 of the row writes the partial into a (T/k, blocks,
//     B, O) scratch; after the last barrier all threads reduce it over the
//     blocks in ascending order, so predictions are the same from run to
//     run, at any batch and for any T or chunking.
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
// fp32 at dim 800 (7 x 7 blocks of 128, 112 blocks of 8 columns) pays
// the same floor with a 3.6 KB state copy, plus 28 FMAs, two shuffle
// levels and an 8-way shared-memory sum per output: 3.26 us (B2) and
// 3.27 us (B1) a step at batch 1, 6.39 / 6.35 us at batch 16 (T = 64,
// same card and clock).  The earlier branch, one chain of 896 FMAs per
// output on bt * cw threads of a block, took 13.26-13.37 us at batch 1
// and 14.52-14.56 us at batch 16.
// With the readout, as the serving engine launches B2 (predictions and
// final state; CUDA events around 4 queued launches of T = 3,000, same
// card and clock), a step at batch 1 / 4 / 16 takes 3.12-3.16 / 3.33 /
// 3.37 us at LARGE_1024, 3.55-3.57 / 4.27 / 6.42 us in fp32 at dim 800 and
// 8.67-8.69 / 10.39 / 13.72 us at dim 4,096 (256 blocks, shares
// streamed); the readout adds 0.07-0.46 us to a step without it.  Summed
// by one thread from xkeep after an extra __syncthreads, it took 3.33 /
// 3.77 / 3.87, 3.91-3.97 / 4.84 / 6.93 and 9.07-9.14 / 10.86 / 14.26 us.
// In the list form (8 KiB of words a block, resident, same card and
// clock) dim 4,096 at 2 % nonzeros takes 3.32 / 5.15 / 8.04 us a step at
// batch 1 / 4 / 16 against the dense form's 8.72 / 10.45 / 13.57.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common.cuh"
#include "../../hopper.cuh"

namespace cg = cooperative_groups;
using hopper::bulk_load;
using hopper::fence_async_global;
using hopper::mbar_wait;
using hopper::mma_s8;
using hopper::smem_u32;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // MMA M: batch rows of one tile
constexpr int kBarBytes = 16;           // the mbarrier, padded

struct Params {
  const float* __restrict__ u;          // (T, B, I), unit stride over I
  long long su_t, su_b;
  const float* __restrict__ w_in;       // (I, dim)
  const float* __restrict__ w_out;      // (dim, O), or null
  const float* x0;                      // (B, dim); may alias final_state
  float* states;                        // (T, B, dim), or null
  float* preds;                         // (T / k, B, O), or null
  float* final_state;                   // (B, dim), or null
  unsigned char* xbuf;                  // (2, B, ldx bytes) working state,
                                        // then the step barrier's count
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

// The readout's tree over a block's cw columns stays inside a row's lane
// group when the row's columns are whole lane groups of one warp (cw
// divides 32); otherwise a warp per row reads it from shared memory
// ("shuffle" / "shared" of readout_path in reservoir_rollout.py).
__device__ __forceinline__ bool shuffle_readout(int cw) {
  return cw <= 32 && 32 % cw == 0;
}

// The pairwise tree over W consecutive lanes: adjacent pairs first, every
// lane of a group left with its group's sum.  IEEE addition commutes, so
// both lanes of a pair form the same bits.
template <int W>
__device__ __forceinline__ float lane_tree(float v, unsigned mask) {
#pragma unroll
  for (int s = 1; s < W; s <<= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(mask, v, s, W));
  }
  return v;
}

// lane_tree over `width` lanes, a power of two up to 32, unrolled: a
// loop over a run-time width costs several times its shuffles.
__device__ __forceinline__ float lane_tree(float v, unsigned mask,
                                           int width) {
  switch (width) {
    case 1: return v;
    case 2: return lane_tree<2>(v, mask);
    case 4: return lane_tree<4>(v, mask);
    case 8: return lane_tree<8>(v, mask);
    case 16: return lane_tree<16>(v, mask);
    default: return lane_tree<32>(v, mask);
  }
}

// Warps per 8-column group in the fp32 product: each output sums 4 W
// partials (bk is a multiple of 32, so every warp's range of a block's
// n_mm * bk rows splits evenly over the 4 lanes of a column).
__device__ __forceinline__ int f32_warps(int cw) {
  return max(1, kWarps / (cw >> 3));
}

// fp32 MM terms of one batch tile, rows < NB of the staged state xs, into
// red_s[(w * kRows + r) * cw + column] for the group's warp w.  Tiles are
// (term, 8-column group, row, column) floats, so a warp reads 4 rows x 8
// columns of 32 consecutive floats and 4 broadcast state words per row.
// Rows bt .. NB - 1 of xs hold stale values whose sums nobody reads.
template <int NB>
__device__ __forceinline__ void product_f32(const float* xs, int ldxf,
                                            const int2* mm,
                                            const float* tiles, int n_mm,
                                            int bk, int cw, float* red_s,
                                            int warp, int lane) {
  const int groups = cw >> 3;
  const int wpg = f32_warps(cw);
  const int span = n_mm * bk / wpg;      // rows q of one warp
  const int j8 = lane & 7, kq = lane >> 3;
  for (int unit = warp; unit < groups * wpg; unit += kWarps) {
    const int g = unit / wpg;
    const int w = unit - g * wpg;
    float acc[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) acc[r] = 0.0f;
    const int q_end = (w + 1) * span;
    for (int q = w * span + kq; q < q_end;) {
      const int m = q / bk;
      const int seg_end = min(q_end, (m + 1) * bk);
      // row q is state column mm[m].x * bk + q - m * bk and tile word
      // ((m * groups + g) * bk + q - m * bk) * 8 + j8
      const int xoff = (mm[m].x - m) * bk;
      const float* wt = tiles + (size_t)(m * (groups - 1) + g) * bk * 8 + j8;
#pragma unroll 4
      for (; q < seg_end; q += 4) {
        const float wv = wt[(size_t)q * 8];
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          acc[r] = fmaf(xs[r * ldxf + xoff + q], wv, acc[r]);
        }
      }
    }
    const int col = g * 8 + j8;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      // kq's four partials: (kq0 + kq1) + (kq2 + kq3) on every lane
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 8);
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 16);
      if ((r & 3) == kq) red_s[(w * kRows + r) * cw + col] = acc[r];
    }
  }
}

// Lanes that share one column's list: the largest power of two L with
// L * cw <= kThreads (1 when cw exceeds them; the columns then take
// several passes).  _list_lanes in reservoir_rollout.py.
__device__ __forceinline__ int list_lanes(int cw) {
  int lanes = 1;
  while (2 * lanes * cw <= kThreads) lanes <<= 1;
  return lanes;
}

// One level of a list column's lane sum, by recursive halving: the lane
// holds C sums of rows row0 .. row0 + C - 1, keeps the upper half when
// its bit s is set (the lower half otherwise) and adds its partner's sums
// of that half: C / 2 shuffles, all indices fixed at compile time.
template <int C>
__device__ __forceinline__ void halve(uint32_t* acc, int l, int s,
                                      unsigned mask, int& row0) {
  const bool up = (l & s) != 0;
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const uint32_t lo = acc[i], hi = acc[i + C / 2];
    acc[i] = (up ? hi : lo) + __shfl_xor_sync(mask, up ? lo : hi, s);
  }
  if (up) row0 += C / 2;
}

// The list form's int32 product of one batch tile, rows < NB of the
// staged int8 state xs, into acc_s[r * cw + j] for rows r < bt.  Column
// j's word (i, l) -- its entry i * lanes + l, row in bits 0-15 and the
// signed weight in bits 16-31 -- is words[(i * cw + j) * lanes + l], so
// the block's threads read consecutive words; padding words are 0.  The
// column's lanes then meet by recursive halving (halve: NB / 2 + NB / 4
// + ... shuffles, not NB per level); once a lane holds one row the levels
// left add it whole, and the lanes whose bits above NB's are 0 store
// their rows.  Sums wrap modulo 2^32 as the MMA path's do.  Rows bt ..
// NB - 1 of xs hold stale values whose sums are not stored.
template <int NB>
__device__ __forceinline__ void product_lists(const unsigned char* xs,
                                              int ldx, const uint32_t* words,
                                              int per_lane, int cw, int lanes,
                                              int bt, int* acc_s, int tid) {
  const int l = tid & (lanes - 1);
  const int lane = tid & 31;
  // the column's lanes, an aligned group of its warp
  const unsigned mask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  const int stride = cw * lanes;
  for (int j = tid / lanes; j < cw; j += kThreads / lanes) {
    uint32_t acc[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) acc[r] = 0u;
    const uint32_t* w = words + j * lanes + l;
#pragma unroll 4
    for (int i = 0; i < per_lane; ++i) {
      const uint32_t e = w[(size_t)i * stride];
      const unsigned char* xr = xs + (e & 0xffffu);
      const int wt = static_cast<int>(e) >> 16;
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        acc[r] += static_cast<uint32_t>(
            static_cast<int>(static_cast<signed char>(xr[r * ldx])) * wt);
      }
    }
    int row0 = 0, held = NB, s = 1;
    if constexpr (NB >= 16) {
      if (s < lanes) { halve<16>(acc, l, s, mask, row0); held = 8; s <<= 1; }
    }
    if constexpr (NB >= 8) {
      if (s < lanes) { halve<8>(acc, l, s, mask, row0); held = 4; s <<= 1; }
    }
    if constexpr (NB >= 4) {
      if (s < lanes) { halve<4>(acc, l, s, mask, row0); held = 2; s <<= 1; }
    }
    if constexpr (NB >= 2) {
      if (s < lanes) { halve<2>(acc, l, s, mask, row0); held = 1; s <<= 1; }
    }
    for (; s < lanes; s <<= 1) acc[0] += __shfl_xor_sync(mask, acc[0], s);
    if ((l & ~(NB - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (i < held && row0 + i < bt) {
          acc_s[(row0 + i) * cw + j] = static_cast<int>(acc[i]);
        }
      }
    }
  }
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

// The step barrier's halves: the block's arrival, ordered after everything
// the block wrote before it, and the wait for an arrival count.
__device__ __forceinline__ void arrive(unsigned long long* count) {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(count)
               : "memory");
}

__device__ __forceinline__ void wait_for(const unsigned long long* count,
                                         unsigned long long n) {
  unsigned long long seen;
  do {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(seen)
                 : "l"(count)
                 : "memory");
  } while (seen < n);
}

// One batch tile's partial readout, rows b0 .. b0 + bt - 1: x(n) . W_out
// over the block's cw columns starting at c0, from the tile's x(n) in xt
// (bt x cw; a pad column holds 0 and adds 0), into part (B, O).  Shuffle
// path: thread idx reads back the x(n) it wrote and a row's cw lanes meet
// in lane_tree.  Shared path: after one __syncthreads a warp per (row,
// output) runs the same tree, lane c over columns 32c .. 32c + 31, then
// over the lanes' sums.
__device__ __forceinline__ void tile_readout(const Params& p, float* part,
                                             const float* xt, int bt, int b0,
                                             int c0, bool shuffle) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (shuffle) {
    for (int idx = tid; idx < bt * p.cw; idx += kThreads) {
      // the pass's live lanes are whole rows: bt * cw - (idx - lane) is a
      // multiple of cw
      const int live = min(32, bt * p.cw - (idx - lane));
      const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
      const int r = idx / p.cw;
      const int j = idx - r * p.cw;
      const int col = c0 + j;
      for (int o = 0; o < p.out_dim; ++o) {
        const float v =
            col < p.dim
                ? __fmul_rn(xt[idx],
                            __ldg(p.w_out + (size_t)col * p.out_dim + o))
                : 0.0f;
        const float y = lane_tree(v, mask, p.cw);
        if (j == 0) part[(size_t)(b0 + r) * p.out_dim + o] = y;
      }
    }
    return;
  }
  __syncthreads();    // every thread's x(n) is in xt
  const int chunks = (p.cw + 31) >> 5;
  int width = 1;
  while (width < chunks) width <<= 1;
  for (int task = warp; task < bt * p.out_dim; task += kWarps) {
    const int r = task / p.out_dim;
    const int o = task - r * p.out_dim;
    float sum = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const int j = c * 32 + lane;
      const int col = c0 + j;
      const float v =
          j < p.cw && col < p.dim
              ? __fmul_rn(xt[r * p.cw + j],
                          __ldg(p.w_out + (size_t)col * p.out_dim + o))
              : 0.0f;
      const float s = lane_tree<32>(v, 0xffffffffu);
      if (lane == c) sum = s;
    }
    sum = lane_tree(sum, 0xffffffffu, width);
    if (lane == 0) part[(size_t)(b0 + r) * p.out_dim + o] = sum;
  }
}

// INT8 && LISTS: the int8 list form (product_lists); INT8 alone: folded
// tiles on the tensor cores and shift-add digits; neither: fp32.
template <bool INT8, bool LISTS = false>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem + kBarBytes;                      // kRows x ldx
  // int8: the int32 accumulator, kRows x cw; fp32: the warps' partial
  // sums, f32_warps(cw) x kRows x cw
  int* acc_s = reinterpret_cast<int*>(xs + kRows * p.ldx);
  float* red_s = reinterpret_cast<float*>(acc_s);
  float* up_s = reinterpret_cast<float*>(
      acc_s + kRows * p.cw * (INT8 ? 1 : f32_warps(p.cw)));  // kRows x cw
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
  const int n_mm = meta.y;               // the list form: entries per lane
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
    hopper::mbar_init(bar, 1);
    hopper::fence_mbar_init();
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
  // the step barrier's arrival count, after the two halves of xbuf
  unsigned long long* arrived =
      reinterpret_cast<unsigned long long*>(p.xbuf + 2 * half);
  if (blk == 0 && tid == 0) *arrived = 0;
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
  const bool shuffle = shuffle_readout(p.cw);
  for (int t = 0; t < p.steps; ++t) {
    const unsigned char* xin = p.xbuf + (t & 1) * half;
    unsigned char* xnext = p.xbuf + ((t + 1) & 1) * half;
    const bool readout = p.preds != nullptr && (t + 1) % p.readout_every == 0;
    // this block's partial x(n) . W_out of the step, (B, O)
    float* part = readout ? p.partial + ((size_t)((t + 1) / p.readout_every - 1)
                                             * gridDim.x + blk) *
                                            p.batch * p.out_dim
                          : nullptr;
    // the shuffle path sums the last tile's rows between the block's
    // arrival at the step barrier and its wait; on the last step before
    // arriving, so the last barrier orders them before the blocks' sum
    const bool defer = readout && shuffle && t + 1 < p.steps;
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
      if constexpr (INT8 && !LISTS) {
        for (int i = tid; i < kRows * p.cw; i += kThreads) acc_s[i] = 0;
        __syncthreads();    // acc_s is zero before any thread adds to it
      }
      mbar_wait(bar, phase);
      phase ^= 1;

      if constexpr (LISTS) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(share);
        const int lanes = list_lanes(p.cw);
        if (bt == 1) {
          product_lists<1>(xs, p.ldx, words, n_mm, p.cw, lanes, bt, acc_s,
                           tid);
        } else if (bt <= 2) {
          product_lists<2>(xs, p.ldx, words, n_mm, p.cw, lanes, bt, acc_s,
                           tid);
        } else if (bt <= 4) {
          product_lists<4>(xs, p.ldx, words, n_mm, p.cw, lanes, bt, acc_s,
                           tid);
        } else if (bt <= 8) {
          product_lists<8>(xs, p.ldx, words, n_mm, p.cw, lanes, bt, acc_s,
                           tid);
        } else {
          product_lists<kRows>(xs, p.ldx, words, n_mm, p.cw, lanes, bt,
                               acc_s, tid);
        }
        __syncthreads();
      } else if constexpr (INT8) {
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
      } else {
        const float* xf = reinterpret_cast<const float*>(xs);
        const float* tf = reinterpret_cast<const float*>(tiles);
        const int ldxf = p.ldx >> 2;
        if (bt == 1) {
          product_f32<1>(xf, ldxf, mm, tf, n_mm, p.bk, p.cw, red_s, warp, lane);
        } else if (bt <= 2) {
          product_f32<2>(xf, ldxf, mm, tf, n_mm, p.bk, p.cw, red_s, warp, lane);
        } else if (bt <= 4) {
          product_f32<4>(xf, ldxf, mm, tf, n_mm, p.bk, p.cw, red_s, warp, lane);
        } else if (bt <= 8) {
          product_f32<8>(xf, ldxf, mm, tf, n_mm, p.bk, p.cw, red_s, warp, lane);
        } else {
          product_f32<kRows>(xf, ldxf, mm, tf, n_mm, p.bk, p.cw, red_s, warp,
                             lane);
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
            // the group's warps' sums in ascending warp order
            const float* rs = red_s + r * p.cw + j;
            float acc = rs[0];
            for (int w = 1; w < f32_warps(p.cw); ++w) {
              acc = __fadd_rn(acc, rs[w * kRows * p.cw]);
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
        if (readout) prev_s[idx] = nx;    // the readout's x(n)
      }
      if (readout && !(defer && b0 + bt == p.batch)) {
        tile_readout(p, part, prev_s, bt, b0, c0, shuffle);
      }
    }
    if (t + 1 < p.steps || p.preds != nullptr) {
      // the step barrier: every block arrives once a step, so after step t
      // the count reaches (t + 1) x blocks
      fence_async_global();
      __syncthreads();
      if (tid == 0) arrive(arrived);
      if (defer) {
        const int b0 = (p.batch - 1) / p.b_tile * p.b_tile;
        tile_readout(p, part, prev_s, p.batch - b0, b0, c0, true);
      }
      if (tid == 0) wait_for(arrived, (unsigned long long)(t + 1) * gridDim.x);
      __syncthreads();
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

template <bool INT8, bool LISTS>
int occupancy(int smem, int* blocks_per_sm) {
  static bool done = false;
  cudaError_t e = fixedmat::allow_smem(rollout_kernel<INT8, LISTS>, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rollout_kernel<INT8, LISTS>, kThreads, smem));
}

template <bool INT8, bool LISTS>
int launch(Params p, int n_blocks, int smem, void* stream) {
  static bool done = false;
  cudaError_t e = fixedmat::allow_smem(rollout_kernel<INT8, LISTS>, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  // the cooperative launch refuses a grid whose blocks cannot all be
  // resident at once (cudaErrorCooperativeLaunchTooLarge): no fallback.
  // A refused launch also stays this runtime's last error; it is read
  // (and so cleared) here, or the next launch's check would report it.
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(rollout_kernel<INT8, LISTS>), dim3(n_blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// B1 and B2: T steps of the rollout in one cooperative launch.  `form`:
// 0 fp32, 1 int8 folded tiles and digits, 2 int8 lists (pack_blocks).
extern "C" int rollout_run(
    int form, const float* u, long long su_t, long long su_b,
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
  return form == 2   ? launch<true, true>(p, n_blocks, smem, stream)
         : form == 1 ? launch<true, false>(p, n_blocks, smem, stream)
                     : launch<false, false>(p, n_blocks, smem, stream);
}

// Blocks of the rollout kernel's `form` (rollout_run's) one SM holds at
// `smem` bytes of dynamic shared memory (the wrapper multiplies by the SM
// count).
extern "C" int rollout_occupancy(int form, int smem, int* blocks_per_sm) {
  return form == 2   ? occupancy<true, true>(smem, blocks_per_sm)
         : form == 1 ? occupancy<true, false>(smem, blocks_per_sm)
                     : occupancy<false, false>(smem, blocks_per_sm);
}
