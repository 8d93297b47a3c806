// One dense reservoir step, hand-written CUDA C++ for sm_90a:
//
//   x' = (1 - leak) * x + leak * tanh(u @ W_in + x @ W)      (paper Eq. 1)
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/reservoir_step/reservoir_step.py, launched by
// `reservoir_step` (:44, pallas_call at :72).  The TPU kernel reduces over
// R on a sequential grid axis, seeds the output tile with u @ W_in on the
// first step and applies the leak/tanh epilogue on the last.  A CUDA grid
// has no sequential axis: here the rows of W are split over the blocks of
// a cluster, which add their partial sums in distributed shared memory,
// and the block that owns an output applies the epilogue in the same
// launch.  fp32 throughout on CUDA cores (no TF32).
//
// Design (the wrapper, `reservoir_step.py`, packs the shares and picks the
// grid).
//   * Grid.  Column slice `sl` holds CW columns; its rows are cut into
//     `parts` (1, 2, 4 or 8) parts of `rows` rows (a multiple of 4).
//     Block sl * parts + p takes part p; the `parts` blocks of a slice
//     form a cluster (of one block when parts is 1).  A batch above the
//     block's tile of BT rows takes a second grid axis.  BT and CW are
//     compile-time, so the kernel's index arithmetic is shifts.
//   * Shares.  The host packs every block's rows x columns of W
//     contiguously ([row][column] floats, zero past the matrix), once, so
//     warp 0 moves the block's share into shared memory with one bulk copy
//     (cp.async.bulk) on one mbarrier (kStages copies on as many barriers
//     are possible; 2 and 4 measured slower on the H100).  Meanwhile warps
//     1-7 stage only this part's rows of x, batch innermost
//     ([row][batch]), with 16-byte loads, and every thread loads what the
//     epilogue of its own outputs reads from global memory (x_old and
//     u @ W_in).  The wait for the cluster's blocks to have started
//     overlaps the share's landing.
//   * Products.  A thread owns 4 columns x 8 batch rows (at a 16-row batch
//     tile; else up to 4 rows) and every KL-th row of the share in
//     ascending order.  (On the H100 at batch 16, 4 x 4, 8 x 4 and 4 x 16
//     tiles and 512 threads per block measured slower.)  The row lanes of
//     a warp are summed by a fixed butterfly of warp shuffles, those of
//     different warps in ascending order in shared memory.
//   * Cross-part sum.  Each part sends its sums into the shared memory of
//     the part that owns those outputs (part j owns the flattened
//     (batch row, column) outputs j * per ..), in the slot of its own
//     rank, by 16-byte st.async stores that complete on the owner's
//     mbarrier; the owner waits for its bytes and adds its slots in rank
//     order.  (A cluster barrier after the sends, instead, cost a
//     GPU-scope memory barrier in every block.)
//   * Epilogue on the owner, on every thread: u @ W_in in ascending input
//     order with separately rounded multiplies and adds, plus the product
//     sum, the accurate tanhf and a separately rounded leak against x_old
//     (read from x, never from out), as the rollout kernels do.
//   Every float sum has a fixed order, so a launch repeats bit for bit.
//
// Bound.  At LARGE_1024 (B = 16, R = 1024, I = 1) the step must read the
// 4 MiB dense W: 1.25 us at 3.35 TB/s; its 34 MFLOP take 0.5 us at
// 67 TFLOP/s, so it is bound by bytes.  Measured (tools/
// probe_fixed_kernels.py, per-block clock64 phases, batch 16): a block's
// 64 KiB share lands about 2,350 cycles after its copy is issued, and
// its 262,144 FMAs then take about 3,900 cycles, twice what the SM's fp32
// units need.

#include "../../common.cuh"
#include "../../hopper.cuh"

using namespace hopper;

namespace {

constexpr int kThreads = 256;
constexpr int kStagers = kThreads - 32;   // warps 1-7
constexpr int kStages = 1;                // bulk copies of a share
constexpr int kBarBytes = 64;             // the stages' and the inbox's
constexpr int kMaxCluster = 8;            // the portable cluster size

struct Params {
  const float* x;
  int ld_x;
  const float* u;
  int ld_u;
  const float* w_in;
  int in_dim;
  const float* __restrict__ blob;         // per-block shares
  int batch, dim, rows, parts, per_shift, x_vec;
  float one_minus_leak, leak;
  float* out;
  int ld_out;
};

// Four consecutive floats of x from `src`, zero from column `live` on.
__device__ __forceinline__ float4 load4(const float* src, int live) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live >= 4) return *reinterpret_cast<const float4*>(src);
  if (live > 0) v.x = src[0];
  if (live > 1) v.y = src[1];
  if (live > 2) v.z = src[2];
  return v;
}

template <int BT, int CW>
__global__ void __launch_bounds__(kThreads) reservoir_step_kernel(
    const Params p) {
  // a thread's register tile: TC columns (TC / 4 quads, CG apart) x RB
  // batch rows (4 x 8 at a 16-row batch tile, else 4 x 4)
  constexpr int TC = 4;
  constexpr int RB = BT < 4 ? BT : BT == 16 ? 8 : 4;
  constexpr int H = TC / 4;
  constexpr int BQ = BT / RB;
  constexpr int CG = CW / TC;                     // column groups
  constexpr int NOUT = CG * BQ;                   // (group, rows) per lane
  static_assert(kThreads % NOUT == 0, "lanes must tile the block");
  constexpr int KL = kThreads / NOUT;             // row lanes
  constexpr int CL = CG < 8 ? CG : 8;             // column groups a warp
  constexpr int KLW = KL < 32 / CL ? KL : 32 / CL;   // row lanes a warp
  constexpr int GROUPS = KL / KLW;
  constexpr int N = BT * CW;                      // outputs of a block
  constexpr int kOwn = (N + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rows = p.rows;
  const int per = 1 << p.per_shift;               // outputs a part owns
  float* share = reinterpret_cast<float*>(smem + kBarBytes);
  float* xs = share + (size_t)rows * CW;          // [row][BT]
  float* red = xs + (size_t)rows * BT;            // GROUPS x N, if > 1
  float* inbox = red + (GROUPS > 1 ? GROUPS * N : 0);   // parts x per

  uint32_t slice, part;          // the cluster's index, the block's rank
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(slice));
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(part));
  const int rank = static_cast<int>(part);
  const int r0 = rank * rows;                     // this part's first row
  const int c0 = static_cast<int>(slice) * CW;    // first output column
  const int b0 = blockIdx.y * BT;
  const int bt = min(BT, p.batch - b0);
  const uint32_t bar = smem_u32(smem);            // stage s's: bar + 8 s
  const uint32_t bar_in = bar + 8 * kStages;      // the inbox's
  // this block's outputs rank * per .. (fewer at the end of the tile)
  const int live = max(0, min(per, N - rank * per));

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= kStages; ++s) mbar_init(bar + 8 * s, 1);
    fence_mbar_init();
    const float* src = p.blob + (size_t)blockIdx.x * rows * CW;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {   // stage s: rows lo(s) .. lo(s + 1)
      const int lo = rows * s / kStages, hi = rows * (s + 1) / kStages;
      bulk_load(smem_u32(share + lo * CW), src + lo * CW, (hi - lo) * CW * 4,
                bar + 8 * s);
    }
    mbar_expect_tx(bar_in, p.parts * live * 4);
  }
  // every block's barriers are set up before any block sends to them
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (tid >= 32) {
    // this part's x rows, batch innermost; zero past the batch and past
    // x's columns.  Four 16-byte loads in flight per thread.
    const int me = tid - 32;
    if (p.x_vec) {
      const int total = BT * (rows / 4);
      for (int base = me; base < total; base += 4 * kStagers) {
        float4 v[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int idx = base + s * kStagers;
          const int b = idx % BT;
          const int r = r0 + (idx / BT) * 4;
          v[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (idx < total && b < bt) {
            v[s] = load4(p.x + (size_t)(b0 + b) * p.ld_x + r, p.dim - r);
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int idx = base + s * kStagers;
          if (idx < total) {
            float* dst = xs + (idx / BT) * 4 * BT + idx % BT;
            dst[0] = v[s].x;
            dst[BT] = v[s].y;
            dst[2 * BT] = v[s].z;
            dst[3 * BT] = v[s].w;
          }
        }
      }
    } else {
      for (int idx = me; idx < BT * rows; idx += kStagers) {
        const int b = idx % BT;
        const int r = r0 + idx / BT;
        xs[idx] = (b < bt && r < p.dim)
                      ? p.x[(size_t)(b0 + b) * p.ld_x + r] : 0.0f;
      }
    }
  }
  // what the epilogue of this block's own outputs (rank * per + o, o =
  // tid, tid + 256, ...) reads from global memory: x_old and u @ W_in
  float up[kOwn], xo[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int o = tid + i * kThreads;
    const int idx = rank * per + o;
    const int b = idx / CW;
    const int c = c0 + idx % CW;
    up[i] = 0.0f;
    xo[i] = 0.0f;
    if (o < live && b < bt && c < p.dim) {
      const float* ub = p.u + (size_t)(b0 + b) * p.ld_u;
      float v = __fmul_rn(ub[0], p.w_in[c]);
      for (int m = 1; m < p.in_dim; ++m) {
        v = __fadd_rn(v, __fmul_rn(ub[m], p.w_in[(size_t)m * p.dim + c]));
      }
      up[i] = v;
      xo[i] = p.x[(size_t)(b0 + b) * p.ld_x + c];
    }
  }
  __syncthreads();

  // products: thread (kl, bq, cg).  Lanes: CL column groups fastest (so
  // the 8 lanes of a 16-byte load phase read one row of the share without
  // bank conflicts), then KLW row lanes, summed by warp shuffles
  const int cl = tid % CL;
  const int klw = (tid / CL) % KLW;
  const int rest = tid / CL / KLW;
  const int o = cl + CL * (rest % (NOUT / CL));
  const int kl = (rest / (NOUT / CL)) * KLW + klw;
  const int cg = o % CG;
  const int bq = o / CG;
  float acc[RB][TC];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
#pragma unroll
    for (int i = 0; i < TC; ++i) acc[j][i] = 0.0f;
  }
  const float* wb = share + 4 * cg;
  const float* xb = xs + bq * RB;
  // every block of the cluster has started and set up its barriers (a
  // wait that overlaps the share's landing)
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // a lane's rows in ascending order, stage by stage as they land
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    const int lo = rows * s / kStages, hi = rows * (s + 1) / kStages;
    mbar_wait(bar + 8 * s, 0);
#pragma unroll 4
    for (int k = lo + ((kl - lo) & (KL - 1)); k < hi; k += KL) {
      float w[TC];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            wb + k * CW + 4 * h * CG);
        w[4 * h] = w4.x;
        w[4 * h + 1] = w4.y;
        w[4 * h + 2] = w4.z;
        w[4 * h + 3] = w4.w;
      }
      float xv[RB];
      if constexpr (RB % 4 == 0) {
#pragma unroll
        for (int q = 0; q < RB / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              xb + k * BT + 4 * q);
          xv[4 * q] = v.x;
          xv[4 * q + 1] = v.y;
          xv[4 * q + 2] = v.z;
          xv[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < RB; ++j) xv[j] = xb[k * BT + j];
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          acc[j][i] = fmaf(xv[j], w[i], acc[j][i]);
        }
      }
    }
  }
  // the row lanes: a fixed butterfly over the KLW lanes of a warp
#pragma unroll
  for (int j = 0; j < RB; ++j) {
#pragma unroll
    for (int i = 0; i < TC; ++i) {
#pragma unroll
      for (int off = CL; off < CL * KLW; off <<= 1) {
        acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], off);
      }
    }
  }
  // Every sum of a quad of (batch row, column) outputs leaves here once,
  // into the inbox of the part that owns it, in the slot of this part's
  // rank, counted on that part's inbox barrier.
  auto send = [&](int idx, float4 v) {
    const int j = idx >> p.per_shift;
    st_async(map_rank(smem_u32(inbox + rank * per + idx - j * per), j), v,
             map_rank(bar_in, j));
  };
  if constexpr (GROUPS == 1) {
    // after the butterfly the first lane holds the sums of the KLW lanes
    if (klw == 0) {
#pragma unroll
      for (int j = 0; j < RB; ++j) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          send((bq * RB + j) * CW + 4 * (cg + h * CG),
               make_float4(acc[j][4 * h], acc[j][4 * h + 1],
                           acc[j][4 * h + 2], acc[j][4 * h + 3]));
        }
      }
    }
  } else {
    // the warp groups' sums in ascending order
    float4* r4 = reinterpret_cast<float4*>(red);
    if (klw == 0) {
#pragma unroll
      for (int j = 0; j < RB; ++j) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          r4[(kl / KLW) * (N / 4) + (bq * RB + j) * (CW / 4) + cg + h * CG] =
              make_float4(acc[j][4 * h], acc[j][4 * h + 1],
                          acc[j][4 * h + 2], acc[j][4 * h + 3]);
        }
      }
    }
    __syncthreads();
    for (int q = tid; q < N / 4; q += kThreads) {
      float4 sum = r4[q];
#pragma unroll
      for (int l = 1; l < GROUPS; ++l) {
        const float4 v = r4[l * (N / 4) + q];
        sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z,
                          sum.w + v.w);
      }
      send(4 * q, sum);
    }
  }
  // the epilogue, once every part's sums of this block's outputs are in
  mbar_wait(bar_in, 0);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int o = tid + i * kThreads;
    const int idx = rank * per + o;
    const int b = idx / CW;
    const int c = c0 + idx % CW;
    if (o < live && b < bt && c < p.dim) {
      float sum = inbox[o];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q) {
        if (q < p.parts) sum += inbox[q * per + o];
      }
      const float pre = __fadd_rn(up[i], sum);
      p.out[(size_t)(b0 + b) * p.ld_out + c] = __fadd_rn(
          __fmul_rn(p.one_minus_leak, xo[i]), __fmul_rn(p.leak, tanhf(pre)));
    }
  }
}

template <int BT, int CW>
int launch(const Params& p, int n_blocks, int smem, cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = reservoir_step_kernel<BT, CW>;
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
  cfg.numAttrs = 1;
  // a cluster that cannot be scheduled is refused here: no fallback
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BT>
int dispatch(int cw, const Params& p, int n_blocks, int smem,
             cudaStream_t s) {
  switch (cw) {
    case 128: return launch<BT, 128>(p, n_blocks, smem, s);
    case 64: return launch<BT, 64>(p, n_blocks, smem, s);
    case 32: return launch<BT, 32>(p, n_blocks, smem, s);
    case 16: return launch<BT, 16>(p, n_blocks, smem, s);
    case 8: return launch<BT, 8>(p, n_blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (batch, dim) <- one step from x (batch, dim), the packed shares of W
// (dim, dim) (blob: block sl * parts + p holds rows p * rows .. and
// columns sl * cw .. as rows x cw floats), u (batch, in_dim) and W_in
// (in_dim, dim), all float32 with unit stride over their last dim; b_tile
// in {1, 2, 4, 8, 16} batch rows and cw in {8, .., 128} columns per
// block; parts in {1, 2, 4, 8}, each finishing 2^per_shift outputs.
// n_blocks = slices * parts, clusters of `parts` blocks.  out must not
// overlap x.
extern "C" int reservoir_step(const float* x, int ld_x, const float* u,
                              int ld_u, const float* w_in, int in_dim,
                              const float* blob, int batch, int dim, int cw,
                              int rows, int parts, int per_shift, int x_vec,
                              float one_minus_leak, float leak, float* out,
                              int ld_out, int b_tile, int n_blocks, int smem,
                              void* stream) {
  if (in_dim < 1 || rows % 4 != 0 || parts < 1 || parts > kMaxCluster
      || (parts & (parts - 1)) != 0 || per_shift < 2
      || (parts << per_shift) < b_tile * cw || n_blocks % parts != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.ld_x = ld_x;
  p.u = u;
  p.ld_u = ld_u;
  p.w_in = w_in;
  p.in_dim = in_dim;
  p.blob = blob;
  p.batch = batch;
  p.dim = dim;
  p.rows = rows;
  p.parts = parts;
  p.per_shift = per_shift;
  p.x_vec = x_vec;
  p.one_minus_leak = one_minus_leak;
  p.leak = leak;
  p.out = out;
  p.ld_out = ld_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b_tile) {
    case 1: return dispatch<1>(cw, p, n_blocks, smem, s);
    case 2: return dispatch<2>(cw, p, n_blocks, smem, s);
    case 4: return dispatch<4>(cw, p, n_blocks, smem, s);
    case 8: return dispatch<8>(cw, p, n_blocks, smem, s);
    case 16: return dispatch<16>(cw, p, n_blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
