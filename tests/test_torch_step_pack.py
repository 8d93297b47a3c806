"""What the host packs for the fused step kernel B5, checked on the CPU: the
per-block shares decoded by the indexing the CUDA kernel reads them with
give back W, and walking them the way the kernel does (each part's partial
sums in its row lanes' order, the lanes by the shuffle butterfly, the
parts in rank order, then the leak/tanh epilogue) gives the plain twin's
step.  The grids the picker chooses at LARGE_1024 on a 132-SM H100 are
pinned, and a W whose share cannot fit one block is refused.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels._launch import batch_tile
from repro_torch.kernels.reservoir_step import reservoir_step as b5
from repro_torch.kernels.reservoir_step.ops import FusedReservoir


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


def _operands(dim, batch, seed, in_dim=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((dim, dim)) * (0.9 / np.sqrt(dim))
         ).astype(np.float32)
    w_in = rng.uniform(-0.5, 0.5, (in_dim, dim)).astype(np.float32)
    x = rng.uniform(-1, 1, (batch, dim)).astype(np.float32)
    u = rng.standard_normal((batch, in_dim)).astype(np.float32)
    return w, w_in, x, u


def _decode(grid, blob):
    """W (padded to whole parts and slices) as the kernel reads the blob:
    block sl * parts + p holds rows p * rows .. and columns sl * cw .."""
    g = grid
    shares = blob.reshape(g.n_blocks, g.rows, g.cw)
    w = np.zeros((g.parts * g.rows, g.slices * g.cw), np.float32)
    for blk in range(g.n_blocks):
        sl, p = divmod(blk, g.parts)
        w[p * g.rows:(p + 1) * g.rows, sl * g.cw:(sl + 1) * g.cw] = \
            shares[blk]
    return w


def _emulate(grid, blob, x, u, w_in, leak):
    """The kernel's arithmetic in float32, block by block."""
    g = grid
    bt_max, rows, cw = g.b_tile, g.rows, g.cw
    lanes, in_warp = g.lanes
    shares = blob.reshape(g.slices, g.parts, rows, cw)
    batch, dim = x.shape
    f32 = np.float32
    out = np.zeros((batch, dim), f32)
    for b0 in range(0, batch, bt_max):
        bt = min(bt_max, batch - b0)
        xt = np.zeros((bt_max, g.parts * rows), f32)
        xt[:bt, :dim] = x[b0:b0 + bt]
        for sl in range(g.slices):
            total = None
            for p in range(g.parts):              # rank order
                xs = xt[:, p * rows:(p + 1) * rows]
                acc = np.zeros((lanes, bt_max, cw), f32)
                # each lane's rows, in ascending order
                for s in range(-(-rows // lanes)):
                    k = s * lanes + np.arange(lanes)
                    live = k < rows
                    acc[live] += (xs[:, k[live]].T[:, :, None]
                                  * shares[sl, p, k[live]][:, None, :])
                a = acc.reshape(lanes // in_warp, in_warp, bt_max, cw)
                off = 1
                while off < in_warp:              # the shuffle butterfly
                    a = a + a[:, np.arange(in_warp) ^ off]
                    off *= 2
                part = a[0, 0]
                for grp in range(1, lanes // in_warp):
                    part = part + a[grp, 0]
                total = part if total is None else total + part
            c0, c1 = sl * cw, min((sl + 1) * cw, dim)
            up = u[b0:b0 + bt, :1] * w_in[0, c0:c1]
            for m in range(1, u.shape[1]):
                up = up + u[b0:b0 + bt, m:m + 1] * w_in[m, c0:c1]
            pre = up + total[:bt, :c1 - c0]
            out[b0:b0 + bt, c0:c1] = (f32(1.0 - leak) * x[b0:b0 + bt, c0:c1]
                                      + f32(leak) * np.tanh(pre))
    return out


@pytest.mark.parametrize("dim", [128, 800, 1024])
@pytest.mark.parametrize("b_tile", [1, 16])
def test_b5_packing_decodes_to_w(dim, b_tile):
    w = _operands(dim, 1, dim)[0]
    grid = b5.step_grid(dim, b_tile, LARGE_SMS)
    blob = b5.pack_share_blob(torch.as_tensor(w), grid)
    assert blob.is_contiguous()                   # the bytes the kernel reads
    blob = blob.numpy()
    assert blob.shape == (grid.n_blocks, grid.rows, grid.cw)
    assert grid.share_bytes == grid.rows * grid.cw * 4
    assert grid.share_bytes % 16 == 0             # one bulk copy
    got = _decode(grid, blob)
    np.testing.assert_array_equal(got[:dim, :dim], w)
    assert not got[dim:].any() and not got[:, dim:].any()


@pytest.mark.parametrize("cw,parts", [(32, 4), (8, 2), (16, 1), (64, 8)])
def test_b5_packing_decodes_on_other_grids(cw, parts):
    """Grids the picker does not choose at dim 800 (its sweep's) decode the
    same way; with one part too, where the blob must still be a copy."""
    w = _operands(800, 1, 3)[0]
    grid = b5.StepGrid(800, 16, cw, parts)
    blob = b5.pack_share_blob(torch.as_tensor(w), grid)
    assert blob.is_contiguous()
    np.testing.assert_array_equal(_decode(grid, blob.numpy())[:800, :800], w)


@pytest.mark.parametrize("dim", [128, 800, 1024])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_b5_emulated_kernel_matches_twin(dim, batch):
    w, w_in, x, u = _operands(dim, batch, dim + batch)
    leak = 0.3
    grid = b5.step_grid(dim, batch_tile(batch), LARGE_SMS)
    blob = b5.pack_share_blob(torch.as_tensor(w), grid).numpy()
    got = _emulate(grid, blob, x, u, w_in, leak)
    want = b5.reservoir_step_plain(torch.as_tensor(x), torch.as_tensor(w),
                                   torch.as_tensor(u), torch.as_tensor(w_in),
                                   leak=leak).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_b5_emulated_kernel_over_batch_tiles():
    """A batch above 16 takes a second grid axis: batch 33 at tile 16 is
    three row tiles, the last one holding one live row."""
    w, w_in, x, u = _operands(256, 33, 7, in_dim=3)
    grid = b5.step_grid(256, 16, LARGE_SMS)
    blob = b5.pack_share_blob(torch.as_tensor(w), grid).numpy()
    got = _emulate(grid, blob, x, u, w_in, 0.6)
    want = b5.reservoir_step_plain(torch.as_tensor(x), torch.as_tensor(w),
                                   torch.as_tensor(u), torch.as_tensor(w_in),
                                   leak=0.6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_b5_share_that_cannot_fit_raises():
    """At dim 20480 a 16-row batch tile's share and x rows do not fit one
    block even in 8-column slices, while a 1-row tile does; at dim 65536
    no tile fits.  Each refusal names the shape."""
    assert b5.step_grid(20480, 1, LARGE_SMS).smem <= 227 * 1024
    with pytest.raises(ValueError, match=r"\(20480, 20480\) W at 16 batch"):
        b5.step_grid(20480, 16, LARGE_SMS)
    with pytest.raises(ValueError, match=r"\(65536, 65536\) W at 1 batch"):
        b5.step_grid(65536, 1, LARGE_SMS)


def test_b5_packing_rejects_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        b5.pack_weights(np.eye(8, dtype=np.float32), "cpu")


def test_b5_fused_reservoir_on_cpu_packs_nothing():
    """On the CPU the wrapper keeps only the dense W the twin reads."""
    fr = FusedReservoir(np.eye(8, dtype=np.float32),
                        np.ones((1, 8), np.float32), device="cpu")
    assert fr.packed is None and fr.w.shape == (8, 8)


def test_b5_grid_at_large_1024():
    """LARGE_1024 on 132 SMs: at batch 16, 8 parts of 128 rows and 128
    columns (64 blocks; 8 KiB of x rows per block, 512 KiB in all); at
    batch 1, 2 parts of 512 rows and 16 columns (128 blocks)."""
    g16 = b5.step_grid(1024, 16, LARGE_SMS)
    assert (g16.cw, g16.parts, g16.rows, g16.n_blocks) == (128, 8, 128, 64)
    assert g16.n_blocks * g16.rows * 16 * 4 == 1 << 19
    # 4 x 8 register tiles: 4 row lanes, all in one warp (no warp-group
    # sums); barriers + 64 KiB share + 128 x 16 x rows + the inbox (8
    # slots of 256 outputs)
    assert g16.rb == 8 and g16.lanes == (4, 4) and g16.per == 256
    assert g16.smem == 64 + 65536 + 8192 + 8 * 256 * 4
    g1 = b5.step_grid(1024, 1, LARGE_SMS)
    assert (g1.cw, g1.parts, g1.rows, g1.n_blocks) == (16, 2, 512, 128)
    # 64 row lanes, 8 to a warp: 8 groups of 16 sums; 2 slots of 8
    assert g1.lanes == (64, 8) and g1.per == 8
    assert g1.smem == 64 + 32768 + 2048 + (8 * 16 + 2 * 8) * 4


@pytest.mark.parametrize("dim,cw,parts", [(128, 8, 1), (512, 32, 4),
                                          (3104, 128, 8), (3112, 64, 8)])
def test_b5_grid_narrows_slices(dim, cw, parts):
    """At batch 16: no more parts than 128-row pieces of W; slices narrowed
    while fewer than 33 blocks would run (dims 128 and 512) and from dim
    3112 on, where 128 columns of 392 rows no longer fit one block."""
    g = b5.step_grid(dim, 16, LARGE_SMS)
    assert (g.cw, g.parts) == (cw, parts)
    assert g.smem <= 227 * 1024
