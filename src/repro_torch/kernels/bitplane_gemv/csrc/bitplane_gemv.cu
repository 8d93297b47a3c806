// Exact digit-plane product, hand-written CUDA C++ for sm_90a:
//
//   y[b, c] = sum_w (x @ d_w)[b, c] << w        (int32, two's complement)
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/bitplane_gemv/bitplane_gemv.py, launched by
// `bitplane_gemv` (:55, pallas_call at :84): the TPU form of the paper's
// bit-serial multiplier (Sec. III).  x is (B, R) int8 or int32; the digit
// planes d_w in {-1, 0, 1} arrive packed by the host (`pack_planes`):
// only the kept planes (the TPU kernel drops the others at trace time),
// rows padded with zeros to a multiple of 32, columns to a multiple of 8.
//
// Layout.  Block k owns `groups` 8-column groups (columns 8 groups k ..)
// for every row and every kept plane: its share, `share_bytes` at byte
// k * share_bytes of the blob.  The share is cut along the rows into
// stages of `sc` 32-row chunks; inside a stage the 256-byte units run
// (group, chunk, plane), each one m16n8k32 B fragment (lane l's 8 bytes
// at 8 l: column l / 4, rows 4 (l % 4) .. + 3 and 16 + 4 (l % 4) .. + 3).
//
// Design.
//   * Stages come into shared memory by bulk copies (cp.async.bulk, one
//     mbarrier per buffer), all issued at the start when the share fits
//     (resident), else through a ring of `n_buf` buffers refilled as the
//     block finishes each stage.  A share that fits is one stage: on the
//     H100 every further copy cost more than starting the MMAs on the
//     first stage early gained (tools/probe_fixed_kernels.py).
//   * x, one tile of <= 16 batch rows, is staged once per tile in shared
//     memory by warps 1-7 with 16-byte loads while warp 0 issues the bulk
//     copies (int8 rows padded by 16 bytes, so the A-fragment loads hit 32
//     distinct banks; rows past the batch are zero).  Bulk copies of x's
//     rows measured slower on the H100: they landed after the share's.
//   * int8 x runs on the tensor cores: one mma.sync.m16n8k32.s32.s8.s8.s32
//     per kept plane and 32-row chunk, batch on M, 8 columns on N.  The
//     kernel is instantiated per kept-plane count, so each warp keeps one
//     int32 accumulator fragment per plane in registers across its chunks
//     (the MMA adds); each plane's sum is shifted by its plane index and
//     added in uint32 once, when the warp's column group changes or its
//     chunks end.
//   * int32 x runs on CUDA cores over the same fragments: each lane folds
//     its 8 digits of a unit over the planes (v = sum_w d_w << w) and
//     multiplies them by x in uint32.
//   * The units of a stage are spread over the 8 warps; every warp adds
//     into its own (16 x columns) partial in shared memory, and the 8
//     partials are summed in warp order at the end of the tile.
//   Every sum runs in uint32: exact modulo 2^32, so the result equals
//   sum_w (x @ d_w) << w in int32 arithmetic for any input.
//   * A batch above 16 loops over tiles of 16 inside the block; a resident
//     share stays in shared memory for all of them.
//
// Bound.  At LARGE_1024 (B = 16, R = C = 1024, 8 kept planes) the kernel
// must read 8 MiB of planes: 2.5 us at 3.35 TB/s; the 134 M int8 MACs take
// 0.07 us at 1,979 TOP/s, so it is bound by bytes.  The grid is 128 blocks
// of 8 columns (one per SM), each with a 64 KiB resident share moved by
// one bulk copy.

#include "../../common.cuh"
#include "../../hopper.cuh"

using namespace hopper;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;            // MMA M: batch rows of one tile
constexpr int kMaxBufs = 16;         // stage buffers: one mbarrier each
constexpr int kBarBytes = 8 * kMaxBufs;
constexpr int kFrag = 256;           // bytes of one B fragment
constexpr int kMaxPlanes = 16;

struct Params {
  const void* x;
  int ld_x, batch, rows;
  const unsigned char* __restrict__ blob;
  int cols, groups, n_kept;
  unsigned long long shifts;         // plane index of kept plane p at 4 p
  int kch, sc, n_stages, n_buf;
  int share_bytes, stage_bytes, x_stride, x_vec;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows b0 .. b0 + 15 of x into xs (row r at r * x_stride elements of
// XT), zero past the batch and past `rows`, by warps 1-7 (warp 0 issues
// the bulk copies meanwhile); 16 bytes a load when x's rows allow it
// (`x_vec`: 16-byte aligned, rows a multiple of 16 bytes), four loads in
// flight per thread.
template <typename XT>
__device__ void stage_x(const Params& p, int b0, XT* xs) {
  constexpr int kStagers = kThreads - 32;
  const int me = static_cast<int>(threadIdx.x) - 32;
  if (me < 0) return;
  const XT* x = static_cast<const XT*>(p.x);
  const int kpad = p.kch * 32;
  if (p.x_vec) {
    constexpr int V = 16 / sizeof(XT);
    const int nv = kpad / V;
    const int total = kRows * nv;
    for (int base = me; base < total; base += 4 * kStagers) {
      int4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kStagers;
        const int r = idx / nv;
        const int k = (idx - r * nv) * V;
        v[j] = make_int4(0, 0, 0, 0);
        if (idx < total && b0 + r < p.batch && k < p.rows) {
          v[j] = *reinterpret_cast<const int4*>(
              x + (size_t)(b0 + r) * p.ld_x + k);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kStagers;
        const int r = idx / nv;
        if (idx < total) {
          *reinterpret_cast<int4*>(xs + r * p.x_stride
                                   + (idx - r * nv) * V) = v[j];
        }
      }
    }
    return;
  }
  for (int idx = me; idx < kRows * kpad; idx += kStagers) {
    const int r = idx / kpad;
    const int k = idx - r * kpad;
    const int b = b0 + r;
    XT v = 0;
    if (b < p.batch && k < p.rows) v = x[(size_t)b * p.ld_x + k];
    xs[r * p.x_stride + k] = v;
  }
}

// Adds one warp's per-plane int32 sums of column group g, each shifted by
// its plane index, into the warp's partial (C fragment: rows gid, gid + 8;
// columns 2 tig, 2 tig + 1).
template <int NP>
__device__ __forceinline__ void flush(uint32_t* mine, int cw, int g, int lane,
                                      int (&c)[NP][4],
                                      unsigned long long shifts) {
  uint32_t tot[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) {
    const int sh = static_cast<int>((shifts >> (4 * pl)) & 0xf);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tot[i] += static_cast<uint32_t>(c[pl][i]) << sh;
      c[pl][i] = 0;
    }
  }
  const int gid = lane >> 2, col = g * 8 + (lane & 3) * 2;
  mine[gid * cw + col] += tot[0];
  mine[gid * cw + col + 1] += tot[1];
  mine[(gid + 8) * cw + col] += tot[2];
  mine[(gid + 8) * cw + col + 1] += tot[3];
}

// NP > 0: int8 x and NP kept planes on the tensor cores; NP = 0: int32 x
// on CUDA cores.
template <int NP>
__global__ void __launch_bounds__(kThreads) bitplane_gemv_kernel(
    const Params p, int* __restrict__ y, int ld_y) {
  constexpr bool INT8 = NP > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cw = p.groups * 8;
  unsigned char* ring = smem + kBarBytes;
  unsigned char* xs_raw = ring + (size_t)p.n_buf * p.stage_bytes;
  uint32_t* red = reinterpret_cast<uint32_t*>(     // 8 warps x 16 x cw
      xs_raw + (size_t)kRows * p.x_stride * (INT8 ? 1 : 4));
  const unsigned char* share = p.blob + (size_t)blockIdx.x * p.share_bytes;
  const uint32_t bar0 = smem_u32(smem);
  const bool resident = p.n_buf >= p.n_stages;
  const int n_tiles = (p.batch + kRows - 1) / kRows;
  const int loads = resident ? p.n_stages : n_tiles * p.n_stages;

  auto stage_bytes = [&](int s) {
    const int n = min(p.sc, p.kch - s * p.sc);
    return n * p.groups * p.n_kept * kFrag;
  };
  if (tid == 0) {
    for (int i = 0; i < p.n_buf; ++i) mbar_init(bar0 + 8 * i, 1);
    fence_mbar_init();
    for (int q = 0; q < min(p.n_buf, loads); ++q) {
      const int s = q % p.n_stages;
      bulk_load(smem_u32(ring + (size_t)q * p.stage_bytes),
                share + (size_t)s * p.stage_bytes, stage_bytes(s),
                bar0 + 8 * q);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int b0 = t * kRows;
    __syncthreads();          // the previous tile is done with xs and red
    if constexpr (INT8) {
      stage_x<int8_t>(p, b0, reinterpret_cast<int8_t*>(xs_raw));
    } else {
      stage_x<int>(p, b0, reinterpret_cast<int*>(xs_raw));
    }
    for (int i = tid - 32; i >= 0 && i < kWarps * kRows * cw;
         i += kThreads - 32) {
      red[i] = 0u;                          // warp 0 may still be issuing
    }
    __syncthreads();
    uint32_t* mine = red + warp * kRows * cw;
    // int8: the warp's per-plane sums of column group `cur`, accumulated
    // in the MMAs over its chunks, shifted and added when the group changes
    int c[INT8 ? NP : 1][4] = {};
    int cur = -1;

    for (int s = 0; s < p.n_stages; ++s) {
      const int q = t * p.n_stages + s;       // the sequence of stage uses
      const int buf = resident ? s : q % p.n_buf;
      if (!resident || t == 0) {
        mbar_wait(bar0 + 8 * buf, resident ? 0u : (q / p.n_buf) & 1u);
      }
      const unsigned char* st = ring + (size_t)buf * p.stage_bytes;
      const int n_s = min(p.sc, p.kch - s * p.sc);
      for (int u = warp; u < n_s * p.groups; u += kWarps) {
        const int g = u / n_s;
        const int kc = s * p.sc + (u - g * n_s);
        const uint2* fb = reinterpret_cast<const uint2*>(
            st + (size_t)u * p.n_kept * kFrag) + lane;
        if constexpr (INT8) {
          if (g != cur) {
            if (cur >= 0) flush<NP>(mine, cw, cur, lane, c, p.shifts);
            cur = g;
          }
          const unsigned char* xa = xs_raw + gid * p.x_stride + kc * 32
                                    + tig * 4;
          const uint32_t a0 = ld32(xa), a1 = ld32(xa + 8 * p.x_stride);
          const uint32_t a2 = ld32(xa + 16);
          const uint32_t a3 = ld32(xa + 8 * p.x_stride + 16);
          uint2 b[NP];
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) b[pl] = fb[pl * (kFrag / 8)];
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
            mma_s8(c[pl], a0, a1, a2, a3, b[pl]);
          }
        } else {
          // lane: column gid, rows 4 tig + e and 16 + 4 tig + e
          uint32_t v[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
          for (int pl = 0; pl < p.n_kept; ++pl) {
            const uint2 d = fb[pl * (kFrag / 8)];
            const int sh = (p.shifts >> (4 * pl)) & 0xf;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[e] += static_cast<uint32_t>(static_cast<int>(
                          static_cast<signed char>(d.x >> (8 * e)))) << sh;
              v[4 + e] += static_cast<uint32_t>(static_cast<int>(
                              static_cast<signed char>(d.y >> (8 * e)))) << sh;
            }
          }
          const int* xk = reinterpret_cast<const int*>(xs_raw) + kc * 32
                          + tig * 4;
          for (int r = 0; r < kRows; ++r) {
            const int4 lo = *reinterpret_cast<const int4*>(
                xk + r * p.x_stride);
            const int4 hi = *reinterpret_cast<const int4*>(
                xk + r * p.x_stride + 16);
            uint32_t acc = static_cast<uint32_t>(lo.x) * v[0]
                           + static_cast<uint32_t>(lo.y) * v[1]
                           + static_cast<uint32_t>(lo.z) * v[2]
                           + static_cast<uint32_t>(lo.w) * v[3]
                           + static_cast<uint32_t>(hi.x) * v[4]
                           + static_cast<uint32_t>(hi.y) * v[5]
                           + static_cast<uint32_t>(hi.z) * v[6]
                           + static_cast<uint32_t>(hi.w) * v[7];
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            if (tig == 0) mine[r * cw + g * 8 + gid] += acc;
          }
        }
      }
      if (!resident) {
        __syncthreads();                    // every warp is done with buf
        if (tid == 0 && q + p.n_buf < loads) {
          fence_async_shared();
          const int s2 = (q + p.n_buf) % p.n_stages;
          bulk_load(smem_u32(st), share + (size_t)s2 * p.stage_bytes,
                    stage_bytes(s2), bar0 + 8 * buf);
        }
      }
    }
    if constexpr (INT8) {
      if (cur >= 0) flush<NP>(mine, cw, cur, lane, c, p.shifts);
    }
    __syncthreads();
    // the warps' partials in warp order
    const int bt = min(kRows, p.batch - b0);
    for (int idx = tid; idx < bt * cw; idx += kThreads) {
      uint32_t sum = red[idx];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w * kRows * cw + idx];
      const int r = idx / cw;
      const int col = blockIdx.x * cw + (idx - r * cw);
      if (col < p.cols) {
        y[(size_t)(b0 + r) * ld_y + col] = static_cast<int>(sum);
      }
    }
  }
}

template <int NP>
int launch(const Params& p, int* y, int ld_y, int n_blocks, int smem,
           cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = bitplane_gemv_kernel<NP>;
  const cudaError_t e = fixedmat::allow_smem(kernel, smem_ok);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, kThreads, smem, stream>>>(p, y, ld_y);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_int8(const Params& p, int* y, int ld_y, int n_blocks, int smem,
                cudaStream_t stream) {
  if (p.n_kept == NP) return launch<NP>(p, y, ld_y, n_blocks, smem, stream);
  if constexpr (NP < kMaxPlanes) {
    return launch_int8<NP + 1>(p, y, ld_y, n_blocks, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y (batch, cols) int32 <- x (batch, rows) int8 or int32 times the packed
// kept planes (blob: n_blocks shares of share_bytes, see above).  The
// wrapper (`bitplane_gemv.py`) computes the geometry and `smem`.
extern "C" int bitplane_gemv(int x_is_int8, const void* x, int ld_x,
                             int batch, int rows, const void* blob, int cols,
                             int groups, int n_kept,
                             unsigned long long shifts, int kch, int sc,
                             int n_stages, int n_buf, int share_bytes,
                             int stage_bytes, int x_stride, int x_vec,
                             int* y, int ld_y,
                             int n_blocks, int smem, void* stream) {
  if (n_kept < 1 || n_kept > kMaxPlanes || n_buf < 1 || n_buf > kMaxBufs
      || (n_buf < n_stages && n_buf < 2) || rows > kch * 32
      || share_bytes % 16 || stage_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.ld_x = ld_x;
  p.batch = batch;
  p.rows = rows;
  p.blob = static_cast<const unsigned char*>(blob);
  p.cols = cols;
  p.groups = groups;
  p.n_kept = n_kept;
  p.shifts = shifts;
  p.kch = kch;
  p.sc = sc;
  p.n_stages = n_stages;
  p.n_buf = n_buf;
  p.share_bytes = share_bytes;
  p.stage_bytes = stage_bytes;
  p.x_stride = x_stride;
  p.x_vec = x_vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_int8 ? launch_int8<1>(p, y, ld_y, n_blocks, smem, s)
                   : launch<0>(p, y, ld_y, n_blocks, smem, s);
}
