// Block-sparse (BCSR) product over a static tile list, hand-written CUDA C++
// for sm_90a:
//
//   y = x @ M,   M given by its nonzero bk x bk tiles, sorted by (col, row)
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/bcsr_matmul/bcsr_matmul.py, launched by `bcsr_matmul`
// (:43, pallas_call at :81).  The TPU kernel walks the tile list on a
// sequential grid and accumulates each output tile over consecutive grid
// steps.  Here column block ci's tiles are one contiguous run; a cluster
// of `parts` thread blocks shares `cw` columns of one column block, block
// p taking part p of the run: its share.
//
// Types follow the TPU kernel, which casts the tile to x's type before
// the product (`blk.astype(x.dtype)`):
//   float32 x: float32 tiles, float32 sums;
//   bfloat16 x: x and the tile rounded to bf16 by the intrinsics, products
//     summed in float32;
//   int32 x: tile truncated toward zero to int32, sums in int32;
//   int8 x: tile truncated toward zero and narrowed to int8, sums in int32.
// Integer sums run in uint32 (exact modulo 2^32, no signed overflow); all
// products run on CUDA cores (no TF32: fp32 stays fp32).
//
// Design (the wrapper, `bcsr_matmul.py`, packs the shares and picks the
// grid).
//   * Shares.  The host packs every block's `cw` columns of its tiles
//     contiguously ([tile][row][column] floats), so the block moves its
//     share into shared memory with one bulk copy (cp.async.bulk) on one
//     mbarrier, issued by warp 0 while warps 1-7 stage x.  (Cutting it
//     into stages, to start on the first rows early, measured slower on
//     the H100.)
//   * x.  A block stages only the x rows of its own tiles (at LARGE_1024,
//     64 blocks of 128 columns and one tile each, the blocks read 512 KiB
//     of x in all, where staging all of x in every block read 8 MiB),
//     batch innermost ([row][batch]), so one 16-byte load gives a thread
//     four batch rows.
//   * Products.  A thread owns 4 columns x up to 4 batch rows and every
//     KL-th row of the share (k = kl, kl + KL, ...), in ascending order;
//     the row lanes of a warp are summed by a fixed butterfly of warp
//     shuffles, those of different warps (small slices only) in
//     ascending order in shared memory.  Across the cluster each part
//     pushes its sums into the shared memory of the part that owns those
//     outputs (distributed shared memory), one cluster barrier, and every
//     part adds its outputs' slots in rank order.
//   Every float sum has a fixed order, so a result is the same from run
//   to run.  A batch above 16 takes a second grid axis.
//   (A multicast design -- clusters of slices receiving their common x
//   rows once by TMA multicast, no sum across blocks -- measured slower on
//   the H100: each block still took all of x into its shared memory.)
//
// Bound.  At LARGE_1024 (B = 16, R = C = 1024, all 64 tiles of 128 x 128
// kept) the kernel must read 4 MiB of fp32 tiles: 1.25 us at 3.35 TB/s;
// 34 MFLOP take 0.5 us at 67 TFLOP/s, so it is bound by bytes.

#include <cooperative_groups.h>
#include <type_traits>

#include "../../common.cuh"
#include "../../hopper.cuh"

namespace cg = cooperative_groups;
using namespace hopper;
using fixedmat::to_acc;

namespace {

constexpr int kThreads = 256;
constexpr int kStagers = kThreads - 32;   // warps 1-7
constexpr int kBarBytes = 16;        // the share's mbarrier
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxTiles = 64;        // tiles of one block's share

struct Params {
  const void* x;
  int ld_x, batch, rows;
  const unsigned char* __restrict__ blob;   // per-block shares
  const int4* __restrict__ meta;   // (byte offset, tiles, first, its row)
  const int* __restrict__ tile_rows;
  int bk, cw, slices, parts, max_tiles, x_vec;
  void* y;
  int ld_y;
};

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

// Element j (a compile-time index after unrolling) of 16 bytes of XT
// held in an int4, as the accumulation type; and the reverse.
__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z
                                                                  : v.w);
}
__device__ __forceinline__ void set_word(int4& v, int i, uint32_t w) {
  const int s = static_cast<int>(w);
  if (i == 0) v.x = s; else if (i == 1) v.y = s;
  else if (i == 2) v.z = s; else v.w = s;
}
template <typename XT>
__device__ __forceinline__ decltype(to_acc(XT())) elem(const int4& v, int j) {
  if constexpr (std::is_same<XT, float>::value) {
    return __uint_as_float(word(v, j));
  } else if constexpr (std::is_same<XT, int>::value) {
    return static_cast<int>(word(v, j));
  } else if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
    const uint32_t w = word(v, j >> 1) >> (16 * (j & 1));
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>(w & 0xffffu)));
  } else {
    return static_cast<int>(static_cast<signed char>(
        word(v, j >> 2) >> (8 * (j & 3))));
  }
}
template <typename XT>
__device__ __forceinline__ void set_elem(int4& v, int j, XT e) {
  constexpr int per = 4 / sizeof(XT);               // elements per word
  const int i = j / per, sh = 8 * sizeof(XT) * (j % per);
  if constexpr (std::is_same<XT, float>::value) {
    set_word(v, i, __float_as_uint(e));
  } else if constexpr (std::is_same<XT, int>::value) {
    set_word(v, i, static_cast<uint32_t>(e));
  } else {
    uint32_t bits;
    if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
      bits = __bfloat16_as_ushort(e);
    } else {
      bits = static_cast<uint8_t>(e);
    }
    const uint32_t mask = ((1u << (8 * sizeof(XT))) - 1u) << sh;
    set_word(v, i, (word(v, i) & ~mask) | (bits << sh));
  }
}

template <typename Acc>
__device__ __forceinline__ void store(void* y, size_t at, Acc v) {
  if constexpr (std::is_same<Acc, float>::value) {
    static_cast<float*>(y)[at] = v;
  } else {
    static_cast<int*>(y)[at] = static_cast<int>(v);
  }
}

template <int BT, typename XT>
__global__ void __launch_bounds__(kThreads) bcsr_matmul_kernel(
    const Params p) {
  using X = decltype(to_acc(XT()));                 // float or int
  constexpr bool kFloat = std::is_same<X, float>::value;
  using Acc = typename std::conditional<kFloat, float, unsigned>::type;
  using X4 = typename std::conditional<kFloat, float4, int4>::type;
  using A4 = typename std::conditional<kFloat, float4, uint4>::type;
  constexpr int RB = BT < 4 ? BT : 4;               // batch rows a thread
  constexpr int BQ = BT / RB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int cw = p.cw;
  const int kmax = p.max_tiles * p.bk;
  float* tiles = reinterpret_cast<float*>(smem + kBarBytes);
  X* xs = reinterpret_cast<X*>(tiles + (size_t)kmax * cw);   // [k][BT]
  Acc* red = reinterpret_cast<Acc*>(xs + (size_t)kmax * BT);
  const int cq_n = cw / 4;
  const int n_out = cq_n * BQ;
  const int KL = kThreads / n_out;                  // row lanes
  const int CL = cq_n < 8 ? cq_n : 8;               // column quads a warp
  const int KLW = KL < 32 / CL ? KL : 32 / CL;      // row lanes a warp
  Acc* inbox = red + (size_t)(KL / KLW) * BT * cw;   // parts x per
  int* rb_s = reinterpret_cast<int*>(
      inbox + (size_t)p.parts * (((BT * cw + p.parts - 1) / p.parts + 3)
                                 & ~3));

  const int blk = blockIdx.x;
  const int per_ci = p.slices * p.parts;
  const int ci = blk / per_ci;
  const int sl = (blk - ci * per_ci) / p.parts;
  const int c0 = ci * p.bk + sl * cw;               // first output column
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, p.batch - b0);
  const int4 m = p.meta[blk];
  const int n_t = m.y;
  const int k_all = n_t * p.bk;                     // rows of the share
  const uint32_t bar = smem_u32(smem);
  const bool split = p.parts > 1;
  if (split) {                  // waited for before the first remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    if (k_all > 0) {
      bulk_load(smem_u32(tiles), p.blob + m.x, k_all * cw * 4, bar);
    }
  } else if (tid >= 32) {
    // this part's x rows, converted, batch innermost; zero past the batch
    // and past x's rows.  Thread (vector, b): 16 bytes of row b a load
    // when x's rows allow it (x_vec), batch rows on neighbouring lanes.
    const int me = tid - 32;
    for (int i = me; i < n_t; i += kStagers) {
      rb_s[i] = i == 0 ? m.w : p.tile_rows[m.z + i];
    }
    asm volatile("bar.sync 1, %0;" :: "r"(kStagers) : "memory");
    const XT* x = static_cast<const XT*>(p.x);
    if (p.x_vec) {
      constexpr int V = 16 / sizeof(XT);
      const int total = BT * (k_all / V);
      for (int base = me; base < total; base += 4 * kStagers) {
        int4 v[4];                          // four loads in flight
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = base + u * kStagers;
          const int k = (idx / BT) * V;
          const int i = k / p.bk;
          const int r = rb_s[min(i, n_t - 1)] * p.bk + (k - i * p.bk);
          const int b = idx % BT;
          v[u] = make_int4(0, 0, 0, 0);
          if (idx < total && b < bt) {
            const XT* src = x + (size_t)(b0 + b) * p.ld_x + r;
            if (r + V <= p.rows) {
              v[u] = *reinterpret_cast<const int4*>(src);
            } else {                        // the ragged end of x's rows
#pragma unroll
              for (int j = 0; j < V; ++j) {
                if (r + j < p.rows) set_elem<XT>(v[u], j, src[j]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = base + u * kStagers;
          const int k = (idx / BT) * V;
          if (idx < total) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              xs[(size_t)(k + j) * BT + idx % BT] = elem<XT>(v[u], j);
            }
          }
        }
      }
    } else {
      for (int idx = me; idx < BT * k_all; idx += kStagers) {
        const int b = idx % BT;
        const int k = idx / BT;
        const int i = k / p.bk;
        const int r = rb_s[i] * p.bk + (k - i * p.bk);
        X v = X(0);
        if (b < bt && r < p.rows) v = to_acc(x[(size_t)(b0 + b) * p.ld_x + r]);
        xs[(size_t)k * BT + b] = v;
      }
    }
  }
  __syncthreads();

  // products: thread (kl, bq, cq) -- 4 columns, RB batch rows, every
  // KL-th row of the share.  Lanes: CL column quads fastest (so the 8
  // lanes of one 16-byte load phase read one row of the share without
  // bank conflicts), then KLW row lanes, summed by warp shuffles
  const int cl = tid % CL;
  const int klw = (tid / CL) % KLW;
  const int rest = tid / CL / KLW;
  const int o = cl + CL * (rest % (n_out / CL));
  const int kl = (rest / (n_out / CL)) * KLW + klw;
  const int cq = o % cq_n;
  const int bq = o / cq_n;
  Acc acc[RB][4];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = Acc(0);
  }
  const X* xb = xs + bq * RB;
  if (k_all > 0) mbar_wait(bar, 0);
#pragma unroll 4
  for (int k = kl; k < k_all; k += KL) {
    const float4 w4 = *reinterpret_cast<const float4*>(
        tiles + (size_t)k * cw + 4 * cq);
    const X w[4] = {weight(w4.x, XT()), weight(w4.y, XT()),
                    weight(w4.z, XT()), weight(w4.w, XT())};
    X xv[RB];
    if constexpr (RB == 4) {
      const X4 v = *reinterpret_cast<const X4*>(xb + (size_t)k * BT);
      xv[0] = v.x;
      xv[1] = v.y;
      xv[2] = v.z;
      xv[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < RB; ++j) xv[j] = xb[(size_t)k * BT + j];
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kFloat) {
          acc[j][i] = fmaf(xv[j], w[i], acc[j][i]);
        } else {
          acc[j][i] += static_cast<unsigned>(xv[j])
                       * static_cast<unsigned>(w[i]);
        }
      }
    }
  }
  // the row lanes: a fixed butterfly over the KLW lanes of a warp, then
  // the KL / KLW warp groups in ascending order
#pragma unroll
  for (int j = 0; j < RB; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int off = CL; off < CL * KLW; off <<= 1) {
        acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], off);
      }
    }
  }
  const int groups = KL / KLW;
  // Every sum of a (batch row, column) leaves here once: straight to y,
  // or, across a cluster, pushed into the inbox of the part that owns
  // that output (part j owns outputs j * per ..), in the slot of this
  // part's rank.
  const int n = BT * cw;
  const int per = ((n + p.parts - 1) / p.parts + 3) & ~3;   // whole quads
  const int rank = split ? static_cast<int>(cg::this_cluster().block_rank())
                         : 0;
  auto emit = [&](int idx, Acc v) {
    if (split) {
      const int j = idx / per;
      cg::this_cluster().map_shared_rank(inbox, j)[rank * per + idx
                                                   - j * per] = v;
    } else if (idx / cw < bt) {
      const int b = idx / cw;
      store(p.y, (size_t)(b0 + b) * p.ld_y + c0 + (idx - b * cw), v);
    }
  };
  if (split) {                  // every block of the cluster has started
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
  if (groups == 1) {
    // a lane's 4 columns are one 16-byte quad: one store each
    if (klw == 0) {
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int idx = (bq * RB + j) * cw + 4 * cq;
        const A4 v = {acc[j][0], acc[j][1], acc[j][2], acc[j][3]};
        if (split) {
          const int q = idx / per;
          *reinterpret_cast<A4*>(cg::this_cluster().map_shared_rank(
              inbox, q) + rank * per + idx - q * per) = v;
        } else if (bq * RB + j < bt) {
          *reinterpret_cast<A4*>(
              static_cast<Acc*>(p.y) + (size_t)(b0 + bq * RB + j) * p.ld_y
              + c0 + 4 * cq) = v;
        }
      }
    }
  } else {
    if (klw == 0) {
      Acc* r = red + (size_t)(kl / KLW) * n;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          r[(bq * RB + j) * cw + 4 * cq + i] = acc[j][i];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n; idx += kThreads) {
      Acc sum = red[idx];
      for (int l = 1; l < groups; ++l) sum += red[(size_t)l * n + idx];
      emit(idx, sum);
    }
  }
  if (split) {
    // one cluster barrier: every part's sums are in their owners'
    // inboxes; each part adds its outputs' slots in rank order and reads
    // only its own shared memory, so no block waits for another to leave
    cg::this_cluster().sync();
    for (int o = tid; o < per && rank * per + o < bt * cw; o += kThreads) {
      Acc sum = inbox[o];
      for (int q = 1; q < p.parts; ++q) sum += inbox[q * per + o];
      const int idx = rank * per + o;
      const int b = idx / cw;
      store(p.y, (size_t)(b0 + b) * p.ld_y + c0 + (idx - b * cw), sum);
    }
  }
}

template <int BT, typename XT>
int launch(const Params& p, int n_blocks, int smem, cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = bcsr_matmul_kernel<BT, XT>;
  cudaError_t e = fixedmat::allow_smem(kernel, smem_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks, (p.batch + BT - 1) / BT, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.parts > 1 ? 1 : 0;
  // a cluster that cannot be scheduled is refused here: no fallback
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch(int b_tile, const Params& p, int n_blocks, int smem,
             cudaStream_t s) {
  switch (b_tile) {
    case 1: return launch<1, XT>(p, n_blocks, smem, s);
    case 2: return launch<2, XT>(p, n_blocks, smem, s);
    case 4: return launch<4, XT>(p, n_blocks, smem, s);
    case 8: return launch<8, XT>(p, n_blocks, smem, s);
    case 16: return launch<16, XT>(p, n_blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y (batch, n_col_blocks * bk) <- x (batch, rows) of kind x_kind
// (0 float32, 1 bfloat16, 2 int8, 3 int32; y is float32 for 0/1, int32
// for 2/3) times the packed shares (blob, meta: one (byte offset, tiles,
// first tile, 0) row per block; tile_rows: the row block of every tile).
// n_blocks = n_col_blocks * slices * parts, clusters of `parts` blocks.
extern "C" int bcsr_matmul(int x_kind, const void* x, int ld_x, int batch,
                           int rows, const void* blob, const void* meta,
                           const void* tile_rows, int bk, int cw, int slices,
                           int parts, int max_tiles, int x_vec, void* y,
                           int ld_y, int b_tile,
                           int n_blocks, int smem, void* stream) {
  if (cw % 8 != 0 || bk % cw != 0
      || kThreads % ((cw / 4) * (b_tile < 4 ? 1 : b_tile / 4)) != 0
      || parts < 1 || parts > kMaxCluster || max_tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.ld_x = ld_x;
  p.batch = batch;
  p.rows = rows;
  p.blob = static_cast<const unsigned char*>(blob);
  p.meta = static_cast<const int4*>(meta);
  p.tile_rows = static_cast<const int*>(tile_rows);
  p.bk = bk;
  p.cw = cw;
  p.slices = slices;
  p.parts = parts;
  p.max_tiles = max_tiles;
  p.x_vec = x_vec;
  p.y = y;
  p.ld_y = ld_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case 0: return dispatch<float>(b_tile, p, n_blocks, smem, s);
    case 1: return dispatch<__nv_bfloat16>(b_tile, p, n_blocks, smem, s);
    case 2: return dispatch<int8_t>(b_tile, p, n_blocks, smem, s);
    case 3: return dispatch<int>(b_tile, p, n_blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
