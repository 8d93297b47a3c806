"""The fixed-matrix kernels' plain twins (B3, B4, B5) against the JAX
package's Pallas kernels.

The JAX kernels run in Pallas interpret mode, as the reference's own tests
(tests/test_kernels.py) run them; the port's wrappers run their plain
twins on CPU tensors.  Inputs are made with numpy from a seed and handed
to both.

* B3 ``bitplane_gemv``: bit for bit (exact int32 products).
* B4 ``bcsr_matmul``: the layout's arrays identical; float32 within
  rtol 1e-5 / atol 1e-4 (the sums run in another order), bfloat16 within
  2e-2, integer inputs exact on integer tiles within int8's range.
* B5 ``reservoir_step``: one step within 1e-5, 20-step trajectories within
  1e-4 (float32 matmul order and tanh differ between the frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitplanes import decompose as j_decompose
from repro.core.sparse import BlockSparse as JBlockSparse
from repro.core.sparse import FixedMatrix as JFixedMatrix
from repro.core.sparse import random_sparse_matrix as j_random_sparse
from repro.kernels.bcsr_matmul.ops import BcsrMatmul as JBcsrMatmul
from repro.kernels.bitplane_gemv.bitplane_gemv import \
    bitplane_gemv as j_bitplane_gemv
from repro.kernels.bitplane_gemv.ops import BitplaneGemv as JBitplaneGemv
from repro.kernels.reservoir_step.ops import FusedReservoir as JFused
from repro.plan import plan_for as j_plan_for
from repro_torch.core.esn import ESNConfig, init_esn
from repro_torch.core.sparse import (BlockSparse, FixedMatrix,
                                     random_sparse_matrix)
from repro_torch.kernels.bcsr_matmul import bcsr_matmul as b4
from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
from repro_torch.kernels.bcsr_matmul.ref import bcsr_matmul_ref
from repro_torch.kernels.bitplane_gemv import bitplane_gemv as b3
from repro_torch.kernels.bitplane_gemv.ops import (BitplaneGemv,
                                                   digits_from_fixed)
from repro_torch.kernels.bitplane_gemv.ref import (bitplane_gemv_ref,
                                                   dense_gemv_ref)
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_step import reservoir_step as b5
from repro_torch.kernels.reservoir_step.ops import FusedReservoir
from repro_torch.kernels.reservoir_step.ref import reservoir_step_ref
from repro_torch.plan import plan_for

CPU = "cpu"


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _digits(v, bits, mode, seed):
    """The same signed digit planes of ``v`` for both packages (CSD draws
    its tie-breaks from the rng, so the reference's planes are used)."""
    dp = j_decompose(v, bits, mode=mode, rng=np.random.default_rng(seed))
    return (dp.pos.astype(np.int8) - dp.neg.astype(np.int8))


# -- B3 bitplane_gemv ---------------------------------------------------------
@pytest.mark.parametrize("r,c,br,bc", [(128, 128, 128, 128),
                                       (256, 128, 128, 128),
                                       (128, 256, 64, 128),
                                       (256, 256, 64, 64)])
@pytest.mark.parametrize("mode", ["pn", "csd"])
def test_bitplane_gemv_bit_for_bit(r, c, br, bc, mode):
    rng = np.random.default_rng(r + c)
    v = rng.integers(-128, 128, size=(r, c))
    v[rng.random(v.shape) < 0.9] = 0
    digits = _digits(v, 8, mode, r)
    x = rng.integers(-128, 128, size=(4, r)).astype(np.int32)
    want = np.asarray(j_bitplane_gemv(jnp.asarray(x), jnp.asarray(digits),
                                      block_r=br, block_c=bc))
    got = b3.bitplane_gemv(_t(x), _t(digits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ v)
    np.testing.assert_array_equal(
        bitplane_gemv_ref(_t(x), _t(digits)).numpy(), want)
    np.testing.assert_array_equal(dense_gemv_ref(_t(x), _t(v)).numpy(), want)


@pytest.mark.parametrize("x_dtype", [np.int8, np.int32])
def test_bitplane_gemv_input_dtypes(x_dtype):
    rng = np.random.default_rng(0)
    v = rng.integers(-8, 8, size=(128, 128))
    digits = _digits(v, 4, "pn", 0)
    x = rng.integers(-100, 100, size=(2, 128)).astype(x_dtype)
    want = np.asarray(j_bitplane_gemv(jnp.asarray(x), jnp.asarray(digits)))
    got = b3.bitplane_gemv(_t(x), _t(digits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitplane_gemv_plane_mask_culls_safely():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 4, size=(128, 128))      # only low planes populated
    digits = _digits(v, 8, "pn", 1)
    mask = tuple(bool(np.any(digits[w])) for w in range(digits.shape[0]))
    assert not all(mask)
    x = rng.integers(-128, 128, size=(2, 128)).astype(np.int32)
    want = np.asarray(j_bitplane_gemv(jnp.asarray(x), jnp.asarray(digits),
                                      plane_mask=mask))
    got = b3.bitplane_gemv(_t(x), _t(digits), plane_mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)
    # a culled plane is never read: poisoning it changes nothing
    poisoned = digits.copy()
    poisoned[mask.index(False)] = 1
    np.testing.assert_array_equal(
        b3.bitplane_gemv(_t(x), _t(poisoned), plane_mask=mask).numpy(), want)


def _ragged_pair(seed=2):
    rng = np.random.default_rng(seed)
    jfm = JFixedMatrix.compile(j_random_sparse(200, 150, 0.9, rng),
                               mode="csd", block=64, rng=rng)
    rng = np.random.default_rng(seed)
    fm = FixedMatrix.compile(random_sparse_matrix(200, 150, 0.9, rng),
                             mode="csd", block=64, rng=rng)
    return jfm, fm


@pytest.mark.parametrize("x_dtype", [np.int8, np.int32])
def test_bitplane_gemv_ops_ragged(x_dtype):
    """The 200 x 150 wrapper case: the reference pads digits and x to
    128-blocks (256 x 256); the port pads only the columns to 152 (a
    multiple of 4) and reads the rows x covers.  The outputs are
    identical."""
    jfm, fm = _ragged_pair()
    jop, op = JBitplaneGemv(jfm), BitplaneGemv(fm, device=CPU)
    assert tuple(op.digits.shape) == (plan_for(fm).width, 200, 152)
    np.testing.assert_array_equal(op.digits[:, :, :150].numpy(),
                                  np.asarray(jop.digits)[:, :200, :150])
    assert not op.digits[:, :, 150:].any()
    assert op.plane_mask == jop.plane_mask
    x = np.random.default_rng(3).integers(-128, 128, (3, 200)).astype(x_dtype)
    got = op(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jop(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy(),
                                  fm.matvec_int_dense_ref(_t(x)).numpy())


@pytest.mark.parametrize("block_r,block_c", [(128, 128), (64, 128),
                                             (256, 64)])
def test_padded_digits_identical(block_r, block_c):
    jfm, fm = _ragged_pair(seed=4)
    want = np.asarray(j_plan_for(jfm).padded_digits(block_r, block_c))
    got = plan_for(fm).padded_digits(block_r, block_c)
    assert got.dtype == want.dtype and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(digits_from_fixed(fm),
                                  np.asarray(j_plan_for(jfm).digits))


@pytest.mark.parametrize("r,c", [(128, 128), (200, 150), (96, 64)])
def test_bitplane_gemv_ops_digits_fit_the_kernel(r, c):
    """The planes BitplaneGemv hands the kernel: contiguous, C padded to
    the next multiple of 4 only (one char4 per plane row), rows as is."""
    rng = np.random.default_rng(r + c)
    fm = FixedMatrix.compile(random_sparse_matrix(r, c, 0.9, rng),
                             mode="csd", block=64, rng=rng)
    op = BitplaneGemv(fm, device=CPU)
    assert op.digits.is_contiguous() and op.digits.dtype == torch.int8
    assert tuple(op.digits.shape) == (plan_for(fm).width, r, -(-c // 4) * 4)
    np.testing.assert_array_equal(op.digits[:, :, :c].numpy(),
                                  plan_for(fm).digits)


def test_bitplane_gemv_matches_spatial_emulator():
    """The twin equals the register-level bit-serial emulator (the
    fidelity oracle of Sec. III) on a 64 x 64 matrix."""
    from repro_torch.core.spatial import simulate_gemv
    rng = np.random.default_rng(11)
    v = rng.integers(-127, 128, size=(64, 64))
    v[rng.random(v.shape) < 0.8] = 0
    v[0, 0] = 127                               # pins scale = 1.0
    fm = FixedMatrix.compile(v.astype(np.float64), weight_bits=8,
                             mode="csd", block=64, rng=rng)
    assert fm.scale == 1.0
    x = rng.integers(-128, 128, size=(3, 64)).astype(np.int8)
    got = BitplaneGemv(fm, device=CPU)(_t(x)).numpy()
    for b in range(3):
        res = simulate_gemv(fm.q, x[b], input_bits=8, weight_bits=8,
                            planes=fm.planes)
        np.testing.assert_array_equal(got[b], res.output)


def test_cluster_split_fills_the_card():
    # LARGE_1024: 32 column slices, one batch tile, 132 SMs -> 4 parts
    # (128 blocks, one wave)
    assert b3.cluster_split(1024, 32, 1, 132) == 4
    assert b3.cluster_split(1024, 32, 2, 132) == 2
    assert b3.cluster_split(1024, 2, 1, 132) == 8      # at most 8 per cluster
    assert b3.cluster_split(64, 2, 1, 132) == 2        # >= 32 rows per part
    assert b3.cluster_split(4096, 200, 4, 132) == 1


# -- B4 bcsr_matmul -----------------------------------------------------------
def _bcsr_pair(r, c, sparsity, block=128, seed=None, scale=None):
    rng = np.random.default_rng(r * 7 + c if seed is None else seed)
    d = j_random_sparse(r, c, sparsity, rng).astype(np.float32)
    if scale is not None:
        d = np.clip(np.round(d * scale), -128, 127).astype(np.float32)
    return (JBcsrMatmul(JBlockSparse.from_dense(d, block=block)),
            BcsrMatmul(BlockSparse.from_dense(d, block=block), device=CPU),
            d, rng)


SHAPES = [(256, 256, 0.95), (512, 256, 0.99), (256, 512, 0.999),
          (384, 384, 0.98)]


@pytest.mark.parametrize("r,c,sparsity", SHAPES)
def test_bcsr_layout_identical(r, c, sparsity):
    jop, op, _d, _rng = _bcsr_pair(r, c, sparsity)
    for name in ("data", "cols", "rows"):
        want = np.asarray(getattr(jop, name))
        got = getattr(op, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for name in ("n_tiles", "rows_pad", "cols_pad", "block", "shape"):
        assert getattr(op, name) == getattr(jop, name)
    cp = op.layout.col_ptr
    assert cp[0] == 0 and cp[-1] == op.n_tiles and np.all(np.diff(cp) >= 1)


@pytest.mark.parametrize("r,c,sparsity", SHAPES)
def test_bcsr_fp32_vs_reference(r, c, sparsity):
    jop, op, d, rng = _bcsr_pair(r, c, sparsity)
    x = rng.standard_normal((4, r)).astype(np.float32)
    want = np.asarray(jop(jnp.asarray(x)))
    got = op(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ d, rtol=1e-5, atol=1e-4)
    oracle = bcsr_matmul_ref(_t(x), op.data, op.cols, op.rows, op.cols_pad,
                             block=op.block)[:, :c]
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("r,c,sparsity", [(256, 256, 0.95), (256, 512, 0.999)])
def test_bcsr_bf16_vs_reference(r, c, sparsity):
    jop, op, d, rng = _bcsr_pair(r, c, sparsity, seed=6)
    x = rng.standard_normal((2, r)).astype(np.float32)
    want = np.asarray(jop(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = op(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("r,c,sparsity", SHAPES)
@pytest.mark.parametrize("x_dtype", [np.int8, np.int32])
def test_bcsr_integer_exact(r, c, sparsity, x_dtype):
    """Integer x on integer tiles within int8's range: exact, and equal to
    the reference's int32 output."""
    jop, op, d, rng = _bcsr_pair(r, c, sparsity, scale=60.0)
    x = rng.integers(-100, 100, (3, r)).astype(x_dtype)
    want = np.asarray(jop(jnp.asarray(x)))
    got = op(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ d.astype(np.int64))


def test_bcsr_all_zero():
    bs = BlockSparse.from_dense(np.zeros((256, 256), np.float32), 128)
    op = BcsrMatmul(bs, device=CPU)
    assert op.n_tiles == 2
    np.testing.assert_array_equal(op(torch.ones((2, 256))).numpy(), 0.0)


def test_bcsr_culling_reduces_tiles():
    d = np.zeros((512, 512), np.float32)
    d[:128, :128] = 1.0
    op = BcsrMatmul(BlockSparse.from_dense(d, block=128), device=CPU)
    jop = JBcsrMatmul(JBlockSparse.from_dense(d, block=128))
    # 1 data tile + 3 zero-padding tiles for empty output columns
    assert op.n_tiles == jop.n_tiles == 4
    np.testing.assert_array_equal(op.layout.col_ptr, [0, 1, 2, 3, 4])


def test_bcsr_ragged_fixed_matrix():
    """A FixedMatrix source (its plan's cached layout) at a ragged shape:
    the port reads x's missing rows as zero, the reference pads x."""
    jfm, fm = _ragged_pair(seed=8)
    jop, op = JBcsrMatmul(jfm), BcsrMatmul(fm, device=CPU)
    assert op.layout is plan_for(fm).bcsr
    x = np.random.default_rng(9).standard_normal((3, 200)).astype(np.float32)
    got = op(_t(x))
    assert got.shape == (3, 150)
    np.testing.assert_allclose(got.numpy(), np.asarray(jop(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-4)


# -- B5 reservoir_step --------------------------------------------------------
def _step_operands(dim, batch, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((dim, dim)) * 0.05).astype(np.float32)
    w_in = (rng.standard_normal((8, dim)) * 0.3).astype(np.float32)
    return w, w_in, rng


@pytest.mark.parametrize("dim", [128, 256, 384])
@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("leak", [1.0, 0.3])
def test_reservoir_step_vs_reference(dim, batch, leak):
    w, w_in, rng = _step_operands(dim, batch, dim + batch)
    x = rng.standard_normal((batch, dim)).astype(np.float32)
    u = rng.standard_normal((batch, 8)).astype(np.float32)
    want = np.asarray(JFused(w, w_in, leak=leak).step(jnp.asarray(x),
                                                      jnp.asarray(u)))
    fr = FusedReservoir(w, w_in, leak=leak, device=CPU)
    got = fr.step(_t(x), _t(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        reservoir_step_ref(_t(x), _t(w), _t(u), _t(w_in), leak=leak).numpy(),
        want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [128, 256, 384])
@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("leak", [1.0, 0.3])
def test_reservoir_run_vs_reference(dim, batch, leak):
    w, w_in, rng = _step_operands(dim, batch, 2 * dim + batch)
    u = rng.standard_normal((20, batch, 8)).astype(np.float32)
    want = np.asarray(JFused(w, w_in, leak=leak).run(jnp.asarray(u)))
    got = FusedReservoir(w, w_in, leak=leak, device=CPU).run(_t(u))
    assert got.shape == (20, batch, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_reservoir_run_writes_each_step_in_place():
    """run() allocates the states once; step t lands in states[t]."""
    w, w_in, rng = _step_operands(128, 2, 5)
    fr = FusedReservoir(w, w_in, leak=0.6, device=CPU)
    u = _t(rng.standard_normal((5, 2, 8)).astype(np.float32))
    x0 = _t(rng.standard_normal((2, 128)).astype(np.float32))
    states = fr.run(u, x0)
    x = x0
    for t in range(5):
        x = fr.step(x, u[t])
        np.testing.assert_array_equal(states[t].numpy(), x.numpy())
    out = torch.empty((2, 128))
    assert fr.step(x0, u[0], out=out) is out


def test_reservoir_step_matches_fp32_rollout():
    """B5 over the dense matrix == the fp32 B1 rollout over its culled
    tiles, as tests/test_rollout.py holds the reference's two kernels."""
    cfg = ESNConfig(reservoir_dim=128, element_sparsity=0.8, seed=9,
                    leak=0.6, block=64)
    p = init_esn(cfg, device=CPU)
    fr_step = FusedReservoir(p.w.dense_f32(), p.w_in, leak=0.6, device=CPU)
    fr_roll = FusedRollout(p.w, p.w_in, leak=0.6, device=CPU)
    u = _t(np.random.default_rng(0).standard_normal((10, 2, 1)),
           torch.float32)
    np.testing.assert_allclose(fr_step.run(u).numpy(), fr_roll(u).numpy(),
                               rtol=1e-4, atol=1e-5)


# -- the wrappers on CPU tensors and what they reject -------------------------
def test_cpu_tensors_take_the_twins_without_building_or_counting():
    jfm, fm = _ragged_pair()
    before = (b3.bitplane_gemv.launches, b4.bcsr_matmul.launches,
              b5.reservoir_step.launches)
    BitplaneGemv(fm, device=CPU)(torch.zeros((2, 200), dtype=torch.int8))
    BcsrMatmul(fm, device=CPU)(torch.zeros((2, 200)))
    FusedReservoir(np.eye(8, dtype=np.float32), np.ones((1, 8), np.float32),
                   device=CPU).run(torch.zeros((3, 2, 1)))
    assert (b3.bitplane_gemv.launches, b4.bcsr_matmul.launches,
            b5.reservoir_step.launches) == before
    for lib in (b3.LIBRARY, b4.LIBRARY, b5.LIBRARY):
        assert not lib.loaded


def test_wrappers_reject_bad_operands():
    digits = torch.zeros((2, 8, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8 or int32"):
        b3.bitplane_gemv(torch.zeros((1, 8)), digits)
    with pytest.raises(ValueError, match="columns"):
        b3.bitplane_gemv(torch.zeros((1, 9), dtype=torch.int8), digits)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        b3.bitplane_gemv(torch.zeros((1, 8), dtype=torch.int8,
                                     device="meta"), digits.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        b3.bitplane_gemv(torch.zeros((1, 8), dtype=torch.int8),
                         digits.to("meta"))
    tiles = torch.zeros((1, 8, 8))
    cp, rows = torch.tensor([0, 1], dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)
    with pytest.raises(TypeError, match="bfloat16"):
        b4.bcsr_matmul(torch.zeros((1, 8), dtype=torch.float64), tiles, cp,
                       rows, 8)
    with pytest.raises(ValueError, match="rows_pad"):
        b4.bcsr_matmul(torch.zeros((1, 16)), tiles, cp, rows, 8)
    with pytest.raises(ValueError, match="w_in"):
        b5.reservoir_step(torch.zeros((1, 8)), torch.zeros((8, 8)),
                          torch.zeros((1, 2)), torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="out must be"):
        b5.reservoir_step(torch.zeros((1, 8)), torch.zeros((8, 8)),
                          torch.zeros((1, 2)), torch.zeros((2, 8)),
                          out=torch.zeros((2, 8)))


@pytest.mark.parametrize("offset,overlap", [(0, True), (8, True), (15, True),
                                            (16, False)])
def test_reservoir_step_rejects_out_overlapping_x(offset, overlap):
    """``out`` taken from x's storage at an offset: any shared byte is
    rejected (the kernel's blocks would read rows another one wrote)."""
    buf = torch.zeros(40)
    x = buf[:16].view(2, 8)
    out = buf[offset:offset + 16].view(2, 8)
    operands = (x, torch.eye(8), torch.ones((2, 1)), torch.ones((1, 8)))
    if overlap:
        with pytest.raises(ValueError, match="overlap"):
            b5.reservoir_step(*operands, out=out)
    else:
        want = b5.reservoir_step_plain(*operands)
        assert b5.reservoir_step(*operands, out=out) is out
        torch.testing.assert_close(out, want, rtol=0, atol=0)
