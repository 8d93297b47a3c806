"""What the host packs for the fixed-matrix kernels B3 and B4, checked on
the CPU: the packed bytes decoded by the layouts the CUDA kernels read
them with give back the JAX package's operands bit for bit, and walking
them the way the kernels do gives the exact (B3) or reference (B4)
product.  The launch geometry at LARGE_1024 on a 132-SM H100 is pinned.

B3's packing is decoded by the PTX lane mapping of
``mma.sync.m16n8k32`` (``kernels/hopper.cuh``): lane ``l = 4 gid + tig``
holds column ``gid`` of the B fragment, rows ``4 tig + e`` and ``16 + 4
tig + e``; its A fragment holds rows ``gid`` / ``gid + 8`` at the same
``k``; its C fragment rows ``gid`` / ``gid + 8``, columns ``2 tig`` and
``2 tig + 1``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import BlockSparse as JBlockSparse
from repro.core.sparse import FixedMatrix as JFixedMatrix
from repro.core.sparse import random_sparse_matrix as j_random_sparse
from repro.kernels.bcsr_matmul.ops import BcsrMatmul as JBcsrMatmul
from repro.plan import plan_for as j_plan_for
from repro_torch.core.sparse import (BlockSparse, FixedMatrix,
                                     random_sparse_matrix)
from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
from repro_torch.plan import BcsrLayout, plan_for


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module's reference calls compiled once
    its tests in this worker are done: each holds JIT memory mappings, and
    a test worker that keeps every module's executables can pass the
    kernel's per-process mapping limit (``vm.max_map_count``) inside a
    later compile, which then aborts the worker (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One PyTorch thread per test: the suite's parallel workers share the
    cores with XLA's own thread pools, and torch's default of one thread
    per core in every worker oversubscribes them (restored after each
    test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LARGE_SMS = 132               # an H100 SXM


def _pair(r, c, sparsity, seed):
    """The same FixedMatrix compiled by both packages."""
    rng = np.random.default_rng(seed)
    jfm = JFixedMatrix.compile(j_random_sparse(r, c, sparsity, rng),
                               mode="csd", block=64, rng=rng)
    rng = np.random.default_rng(seed)
    fm = FixedMatrix.compile(random_sparse_matrix(r, c, sparsity, rng),
                             mode="csd", block=64, rng=rng)
    return jfm, fm


# -- B3: plane fragments -------------------------------------------------------
def _b3_units(grid, blob):
    """Yield (block, group, chunk, plane index, fragment (32, 8) bytes) as
    the kernel walks the blob."""
    share = blob.reshape(grid.n_blocks, grid.share_bytes)
    n_p = len(grid.planes)
    for blk in range(grid.n_blocks):
        for s in range(grid.n_stages):
            n_s = min(grid.sc, grid.kch - s * grid.sc)
            st = share[blk, s * grid.stage_bytes:]
            for u in range(n_s * grid.groups):
                g, kc = u // n_s, s * grid.sc + u % n_s
                for p in range(n_p):
                    frag = st[(u * n_p + p) * 256:(u * n_p + p + 1) * 256]
                    frag = frag.view(np.int8).reshape(32, 8)  # lane, byte
                    yield blk, g, kc, grid.planes[p], frag


def _decode_b(frag):
    """A B fragment (lane, 8 bytes) as the 32 x 8 matrix it stands for."""
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for e in range(4):
            b[4 * tig + e, gid] = frag[lane, e]
            b[16 + 4 * tig + e, gid] = frag[lane, 4 + e]
    return b


def _decode_planes(grid, blob, width):
    out = np.zeros((width, grid.kch * 32, grid.n_blocks * grid.groups * 8),
                   np.int64)
    for blk, g, kc, w, frag in _b3_units(grid, blob):
        c0 = (blk * grid.groups + g) * 8
        out[w, kc * 32:(kc + 1) * 32, c0:c0 + 8] = _decode_b(frag)
    return out[:, :grid.rows, :grid.cols]


def _mma(a_tile, frag):
    """One m16n8k32 through the fragments: lane registers in, C out."""
    b = _decode_b(frag)
    c = np.zeros((16, 8), np.int64)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for row in (gid, gid + 8):
            for col in (2 * tig, 2 * tig + 1):
                c[row, col] = a_tile[row] @ b[:, col]
    return c


def _emulate_b3(grid, blob, x):
    """The int8 kernel's arithmetic in uint32 over the packed blob."""
    bsz = x.shape[0]
    kpad = grid.kch * 32
    y = np.zeros((bsz, grid.n_blocks * grid.groups * 8), np.uint64)
    for t0 in range(0, bsz, 16):
        xs = np.zeros((16, kpad), np.int64)
        xs[:min(16, bsz - t0), :grid.rows] = x[t0:t0 + 16]
        for blk, g, kc, w, frag in _b3_units(grid, blob):
            c = _mma(xs[:, kc * 32:(kc + 1) * 32], frag)
            c0 = (blk * grid.groups + g) * 8
            part = (c.astype(np.uint64) << np.uint64(w)) & np.uint64(
                0xffffffff)
            y[t0:t0 + 16, c0:c0 + 8] += part[:min(16, bsz - t0)]
    y &= np.uint64(0xffffffff)
    return y.astype(np.uint32).view(np.int32)[:, :grid.cols]


@pytest.mark.parametrize("r,c,sparsity,n_sms", [
    (200, 150, 0.9, LARGE_SMS),       # ragged rows and columns
    (256, 256, 0.95, 4),              # 4 SMs: 8 groups per block
    (96, 64, 0.8, LARGE_SMS),
])
def test_b3_packing_decodes_to_the_reference_planes(r, c, sparsity, n_sms):
    jfm, fm = _pair(r, c, sparsity, seed=r + c)
    want = np.asarray(j_plan_for(jfm).digits)
    plan = plan_for(fm)
    planes = tuple(w for w, k in enumerate(plan.plane_mask) if k)
    grid = b3.plane_grid(r, c, planes, n_sms)
    blob = b3.pack_blob(plan.digits, grid)
    assert blob.size == grid.n_blocks * grid.share_bytes
    got = _decode_planes(grid, blob, plan.width)
    kept = np.asarray(plan.plane_mask)
    np.testing.assert_array_equal(got[kept], want[kept])
    assert not got[~kept].any()
    assert not want[~kept].any()


@pytest.mark.parametrize("r,c,batch,n_sms", [(200, 150, 3, LARGE_SMS),
                                             (64, 96, 17, 2)])
def test_b3_packing_gives_the_exact_product(r, c, batch, n_sms):
    jfm, fm = _pair(r, c, 0.9, seed=7 * r)
    plan = plan_for(fm)
    planes = tuple(w for w, k in enumerate(plan.plane_mask) if k)
    grid = b3.plane_grid(r, c, planes, n_sms)
    x = np.random.default_rng(1).integers(-128, 128, (batch, r))
    got = _emulate_b3(grid, b3.pack_blob(plan.digits, grid), x)
    np.testing.assert_array_equal(got, x @ np.asarray(jfm.q).astype(np.int64))
    np.testing.assert_array_equal(got, np.asarray(
        jfm.matvec_int_exact(jnp.asarray(x, jnp.int32))))


def test_b3_culled_planes_are_not_packed():
    """A matrix whose high planes are empty: only the kept planes are
    packed (fewer bytes), and the product is still exact."""
    rng = np.random.default_rng(3)
    v = rng.integers(0, 4, size=(128, 64)).astype(np.float64)
    v[0, 0] = 127                        # scale 1.0, one plane-6 digit
    fm = FixedMatrix.compile(v, weight_bits=8, mode="csd", block=64, rng=rng)
    plan = plan_for(fm)
    planes = tuple(w for w, k in enumerate(plan.plane_mask) if k)
    assert 0 < len(planes) < plan.width
    grid = b3.plane_grid(128, 64, planes, LARGE_SMS)
    blob = b3.pack_blob(plan.digits, grid)
    assert blob.size == len(planes) * 128 * 64
    x = rng.integers(-128, 128, (5, 128))
    np.testing.assert_array_equal(_emulate_b3(grid, blob, x),
                                  x @ np.asarray(fm.q).astype(np.int64))


def test_b3_grid_at_large_1024():
    """LARGE_1024 (8 kept planes) on 132 SMs: 128 blocks of 8 columns,
    each with a 64 KiB share moved by one bulk copy, resident for int8 and
    int32 x."""
    grid = b3.plane_grid(1024, 1024, tuple(range(8)), LARGE_SMS)
    assert (grid.n_blocks, grid.groups, grid.kch, grid.sc,
            grid.n_stages) == (128, 1, 32, 32, 1)
    assert (grid.stage_bytes, grid.share_bytes) == (65536, 65536)
    assert grid.n_blocks * grid.share_bytes == 8 * 1024 * 1024
    assert grid.buffers(True) == grid.buffers(False) == 1
    # barriers + the share + 16 x 1040 int8 x + 8 warps x 16 x 8 uint32
    assert grid.smem(1, True) == 128 + 65536 + 16640 + 4096
    assert grid.smem(1, False) == 128 + 65536 + 65536 + 4096


def test_b3_grid_streams_a_share_that_does_not_fit():
    """dim 4096 (16 MiB of planes): four groups per block, a 1 MiB share
    streamed through a ring of 16 KiB stage buffers; an int32 x tile of
    16 x 16384 rows no longer fits and raises."""
    grid = b3.plane_grid(4096, 4096, tuple(range(8)), LARGE_SMS)
    assert (grid.n_blocks, grid.groups, grid.stage_bytes) == (128, 4, 16384)
    n_buf = grid.buffers(True)
    assert 2 <= n_buf < grid.n_stages
    assert grid.smem(n_buf, True) <= 227 * 1024
    wide = b3.plane_grid(16384, 64, tuple(range(8)), LARGE_SMS)
    with pytest.raises(ValueError, match="do not fit"):
        wide.buffers(False)


def test_b3_packing_rejects_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        b3.pack_planes(np.zeros((2, 8, 8), np.int8), None, "cpu")


# -- B4: tile shares -----------------------------------------------------------
def _layout(r, c, sparsity, seed, scale=None):
    rng = np.random.default_rng(seed)
    d = j_random_sparse(r, c, sparsity, rng).astype(np.float32)
    if scale is not None:
        d = np.clip(np.round(d * scale), -128, 127).astype(np.float32)
    jop = JBcsrMatmul(JBlockSparse.from_dense(d, block=128))
    return jop, BlockSparse.from_dense(d, 128), d, rng


def _decode_shares(grid, blob, meta, n_tiles, lay_rows):
    """Every block's share back into the (n_tiles, bk, bk) tile list."""
    bk, cw = grid.bk, grid.cw
    out = np.full((n_tiles, bk, bk), np.nan, np.float32)
    floats = blob.view(np.float32)
    for blk, (off, n_t, t0, rb0) in enumerate(meta):
        assert n_t == 0 or rb0 == lay_rows[t0]
        sl = (blk % (grid.slices * grid.parts)) // grid.parts
        share = floats[off // 4:off // 4 + n_t * bk * cw]
        out[t0:t0 + n_t, :, sl * cw:(sl + 1) * cw] = share.reshape(
            n_t, bk, cw)
    return out


def _emulate_b4(grid, blob, meta, tile_rows, x):
    """The kernel's walk in float64 (integer x: int64): each block sums its
    share's rows against the x rows of its tiles; the parts of a slice are
    added."""
    bk, cw = grid.bk, grid.cw
    floats = blob.view(np.float32)
    y = np.zeros((x.shape[0], grid.n_col_blocks * bk), x.dtype)
    xp = np.zeros((x.shape[0], int(tile_rows.max() + 1) * bk), x.dtype)
    xp[:, :x.shape[1]] = x
    for blk, (off, n_t, t0, _z) in enumerate(meta):
        ci = blk // (grid.slices * grid.parts)
        sl = (blk % (grid.slices * grid.parts)) // grid.parts
        share = floats[off // 4:off // 4 + n_t * bk * cw].reshape(
            n_t * bk, cw)
        xr = np.concatenate([xp[:, tile_rows[t] * bk:(tile_rows[t] + 1) * bk]
                             for t in range(t0, t0 + n_t)], axis=1) \
            if n_t else np.zeros((x.shape[0], 0), x.dtype)
        w = share if x.dtype.kind == "f" else np.trunc(share).astype(x.dtype)
        c0 = ci * bk + sl * cw
        y[:, c0:c0 + cw] += xr @ w
    return y


@pytest.mark.parametrize("r,c,sparsity", [(256, 256, 0.95), (512, 256, 0.99),
                                          (256, 512, 0.999), (384, 384, 0.98)])
@pytest.mark.parametrize("n_sms", [LARGE_SMS, 8])
def test_b4_packing_decodes_to_the_layout(r, c, sparsity, n_sms):
    jop, bs, _d, _rng = _layout(r, c, sparsity, seed=r * 7 + c)
    lay = BcsrLayout.from_blocks(bs)
    grid = b4.bcsr_grid(lay.col_ptr, lay.block, n_sms)
    blob, meta = b4.pack_share_blob(lay.data, lay.col_ptr, lay.rows, grid)
    assert meta.shape == (grid.n_blocks, 4)
    assert blob.size == lay.data.nbytes          # the same bytes, regrouped
    got = _decode_shares(grid, blob, meta, lay.n_tiles, lay.rows)
    np.testing.assert_array_equal(got, np.asarray(jop.data))
    assert all(n <= grid.max_tiles for n in meta[:, 1])


@pytest.mark.parametrize("n_sms", [LARGE_SMS, 6])
@pytest.mark.parametrize("x_kind", ["f32", "int"])
def test_b4_packing_gives_the_product(n_sms, x_kind):
    jop, bs, d, rng = _layout(384, 256, 0.9, seed=5,
                              scale=None if x_kind == "f32" else 60.0)
    lay = BcsrLayout.from_blocks(bs)
    grid = b4.bcsr_grid(lay.col_ptr, lay.block, n_sms)
    blob, meta = b4.pack_share_blob(lay.data, lay.col_ptr, lay.rows, grid)
    if x_kind == "f32":
        x = rng.standard_normal((5, 384))
        got = _emulate_b4(grid, blob, meta, lay.rows, x)[:, :256]
        want = np.asarray(jop(jnp.asarray(x, jnp.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        x = rng.integers(-100, 100, (5, 384)).astype(np.int64)
        got = _emulate_b4(grid, blob, meta, lay.rows, x)[:, :256]
        np.testing.assert_array_equal(got, np.asarray(
            jop(jnp.asarray(x, jnp.int32))))
        np.testing.assert_array_equal(got, x @ d.astype(np.int64))


def test_b4_grid_at_large_1024():
    """LARGE_1024 (8 column blocks, runs of 8 tiles of 128) on 132 SMs:
    64 blocks of 128 columns and one tile each, in clusters of 8 parts;
    the blocks read 512 KiB of x in all at batch 16 (against 8 MiB when
    every block staged all of x)."""
    cp = np.arange(0, 65, 8)
    grid = b4.bcsr_grid(cp, 128, LARGE_SMS)
    assert (grid.n_blocks, grid.cw, grid.slices, grid.parts,
            grid.max_tiles) == (64, 128, 1, 8, 1)
    assert grid.n_blocks * grid.max_tiles * 128 * 16 * 4 == 1 << 19
    # barrier + 64 KiB share + 128 x 16 x values + 16 x 128 partials (the
    # 2 row lanes share a warp with 8 column quads) + the inbox for the
    # cluster's sums (8 slots of 256) + one row block
    assert grid.smem(16) == 16 + 65536 + 8192 + 2 * 8192 + 4
    # batch 1: 8 row lanes, 4 to a warp: 2 groups; 8 inbox slots of 16
    assert grid.smem(1) == 16 + 65536 + 512 + 3 * 128 * 4 + 4


def test_b4_grid_keeps_a_quarter_of_the_card_busy():
    """A sparse layout (runs of one tile) takes no cluster and slices
    narrow enough for 33 blocks; a long run is cut into at most 8 parts."""
    sparse = b4.bcsr_grid(np.arange(5), 128, LARGE_SMS)
    assert (sparse.parts, sparse.cw, sparse.n_blocks) == (1, 8, 64)
    long_run = b4.bcsr_grid(np.asarray([0, 40]), 128, LARGE_SMS)
    assert (long_run.parts, long_run.max_tiles) == (8, 5)
    with pytest.raises(ValueError, match="multiple of 8"):
        b4.bcsr_grid(np.arange(3), 12, LARGE_SMS)


def test_b4_packing_rejects_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        b4.pack_tiles(np.zeros((1, 8, 8), np.float32), [0, 1], [0], 8, "cpu")
