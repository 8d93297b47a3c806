"""The CUDA kernels on the card (marked ``gpu``; skipped here).

Run on a machine with an NVIDIA GPU:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Rollout: each call is one cooperative launch (no per-step or readout
launch); int8 kernel states equal the plain twins' exactly and B1's equal
B2's; fp32 within 1e-4 (another summation order in the tile products),
readouts within 1e-4; a donated carry resumes bit for bit.  Bitplane gemv
and the integer BCSR product equal their twins exactly; float BCSR products
and reservoir-step trajectories within 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sparse import (BlockSparse, FixedMatrix,
                                     random_sparse_matrix)
from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (bcsr_matmul,
                                                         bcsr_matmul_plain)
from repro_torch.kernels.bcsr_matmul.ops import BcsrMatmul
from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (
    bitplane_gemv, bitplane_gemv_plain)
from repro_torch.kernels.bitplane_gemv.ops import BitplaneGemv
from repro_torch.kernels.reservoir_rollout.ops import FusedRollout
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import (
    _launch_rollout, reservoir_rollout, reservoir_rollout_plain, rollout_grid,
    rollout_readout)
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout, specialized_rollout_plain)
from repro_torch.kernels.reservoir_step.ops import FusedReservoir
from repro_torch.kernels.reservoir_step.reservoir_step import (
    reservoir_step, reservoir_step_plain)
from repro_torch.plan import specialize_summary

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_specialized_kernel_matches_twin(cuda, mode):
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(256, 256, 0.97, rng) * 0.05,
                             weight_bits=8, mode="csd", block=32, rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (3, 256)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (256, 2)).astype(np.float32)
    op = SpecializedRollout(fm, w_in, leak=0.7, mode=mode, w_out=w_out,
                            device=cuda)
    u = torch.as_tensor(rng.standard_normal((6, 5, 3)).astype(np.float32),
                        device=cuda)
    x0 = torch.zeros((5, 256), device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=True)
    before = specialized_rollout.launches, rollout_readout.launches
    s, p, f = op(u, x0, **kw)
    assert (specialized_rollout.launches - before[0],
            rollout_readout.launches - before[1]) == (1, 0)
    ps, pp, pf = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, op.w_out, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    tol = 0.0 if mode == "int8" else 1e-4
    assert (s - ps).abs().max().item() <= tol
    assert (f - pf).abs().max().item() <= tol
    assert (p - pp).abs().max().item() <= 1e-4


# -- B1 and B2: one persistent launch per call --------------------------------
_SPARSE = {}


def _sparse_fm():
    """dim 256, block 32, 97 % zeros: thin digit planes become B2's
    shift-add digits."""
    if not _SPARSE:
        rng = np.random.default_rng(0)
        _SPARSE["fm"] = FixedMatrix.compile(
            random_sparse_matrix(256, 256, 0.97, rng) * 0.05, weight_bits=8,
            mode="csd", block=32, rng=rng)
    return _SPARSE["fm"]


def _pipelined_budget(plan, mode):
    tile = plan.block * plan.block * (4 if mode == "fp32" else 1)
    for n in range(1, 256):
        try:
            s = specialize_summary(plan, mode, vmem_budget=2 * n * tile)
        except ValueError:
            continue
        if s["regime"] == "pipelined":
            return 2 * n * tile
    raise AssertionError("no pipelined budget")


def _run(fn, op, u, x0, b_tile, k, n_blocks=None, **kw):
    """One call of B1 or B2 on the op's tables: (outputs, launches made,
    standalone readout launches made).  An explicit ``n_blocks`` launches
    below the entry point, on that grid."""
    before = fn.launches, rollout_readout.launches
    kw.update(leak=op.leak, smax=op.smax, recur_scale=op.recur_scale,
              b_tile=b_tile, readout_every=k)
    if n_blocks is None:
        out = fn(u, op.tables, op.w_in, x0, op.w_out, **kw)
    else:
        out = _launch_rollout(fn, u, op.tables, op.w_in, x0, op.w_out,
                              n_blocks=n_blocks, **kw)
    return out, fn.launches - before[0], rollout_readout.launches - before[1]


@pytest.mark.parametrize("batch", [1, 5, 16, 24])
@pytest.mark.parametrize("regime", ["resident", "pipelined"])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_rollout_kernels_one_launch_match_twins(cuda, mode, regime, batch):
    """B1 and B2 against their twins over T in {1, 7, 33} with a readout
    every step and T in {8, 32} with one every 4 steps; batch 24 is two
    batch tiles.  One launch per call, no readout launch; int8 exact and
    B1 == B2; a donated carry at T = 1 and T > 1 equals one shot."""
    fm = _sparse_fm()
    plan = fm.plan()
    rng = np.random.default_rng(batch)
    w_in = rng.uniform(-0.5, 0.5, (3, 256)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (256, 2)).astype(np.float32)
    budget = None if regime == "resident" else _pipelined_budget(plan, mode)
    b2 = SpecializedRollout(plan, w_in, leak=0.7, mode=mode, w_out=w_out,
                            vmem_budget=budget, device=cuda)
    b1 = FusedRollout(plan, w_in, leak=0.7, mode=mode, w_out=w_out,
                      device=cuda)
    assert b2.regime == regime
    assert mode == "fp32" or b2.tables.n_digits > 0
    tol = 0.0 if mode == "int8" else 1e-4
    kw = dict(want_states=True, want_preds=True, want_final=True)
    for t, k in ((1, 1), (7, 1), (33, 1), (8, 4), (32, 4)):
        u = torch.as_tensor(rng.standard_normal((t, batch, 3)),
                            dtype=torch.float32, device=cuda)
        x0 = torch.as_tensor(0.5 * rng.standard_normal((batch, 256)),
                             dtype=torch.float32, device=cuda)
        got = {}
        for fn, plain, op in ((specialized_rollout,
                               specialized_rollout_plain, b2),
                              (reservoir_rollout, reservoir_rollout_plain,
                               b1)):
            b_tile = op._batch_tile(batch)
            (s, p, f), n, ro = _run(fn, op, u, x0, b_tile, k, **kw)
            assert (n, ro) == (1, 0)
            ps, pp, pf = plain(u, op.tables, op.w_in, x0, op.w_out,
                               leak=op.leak, smax=op.smax,
                               recur_scale=op.recur_scale, readout_every=k,
                               **kw)
            torch.cuda.synchronize()
            assert p.shape == (t // k, batch, 2)
            assert (s - ps).abs().max().item() <= tol
            assert (f - pf).abs().max().item() <= tol
            assert (p - pp).abs().max().item() <= 1e-4
            got[fn] = (s, p, f)
            # the carry donated in place: at T = 1 x0 is read and x(1)
            # written by every block in the same launch
            carry = x0.clone()
            states = []
            for lo, hi in [(0, 1)] + ([(1, t)] if t > 1 else []):
                (cs, cf), n, ro = _run(fn, op, u[lo:hi], carry, b_tile, 1,
                                       want_states=True, want_final=True,
                                       final_out=carry)
                assert (n, ro) == (1, 0) and cf.data_ptr() == carry.data_ptr()
                states.append(cs)
            assert torch.equal(torch.cat(states), s)
            assert torch.equal(carry, f)
        if mode == "int8":
            for a, b in zip(got[specialized_rollout], got[reservoir_rollout]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("mode,n_blocks", [("int8", 32), ("int8", 128),
                                           ("fp32", 8)])
def test_rollout_kernels_stream_or_keep_tiles(cuda, mode, n_blocks):
    """dim 1024, block 128 (LARGE_1024's shape): at 32 blocks B1's int8
    share (256 KiB) and at 8 blocks its fp32 share (512 KiB) exceed shared
    memory and stream from global memory every step; at 128 blocks both
    kernels keep theirs resident.  Either way B1 and B2 match their twins
    (and each other in int8), and a non-default grid is one launch too."""
    rng = np.random.default_rng(n_blocks)
    fm = FixedMatrix.compile(random_sparse_matrix(1024, 1024, 0.95, rng)
                             * 0.05, weight_bits=8, mode="csd", block=128,
                             rng=rng)
    w_in = rng.uniform(-0.5, 0.5, (1, 1024)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (1024, 1)).astype(np.float32)
    u = torch.as_tensor(rng.standard_normal((16, 16, 1)),
                        dtype=torch.float32, device=cuda)
    x0 = torch.as_tensor(0.5 * rng.standard_normal((16, 1024)),
                         dtype=torch.float32, device=cuda)
    kw = dict(want_states=True, want_preds=True, want_final=False)
    got = []
    for fn, plain, cls in ((reservoir_rollout, reservoir_rollout_plain,
                            FusedRollout),
                           (specialized_rollout, specialized_rollout_plain,
                            SpecializedRollout)):
        op = cls(fm, w_in, leak=0.3, mode=mode, w_out=w_out, device=cuda)
        grid, _ = rollout_grid(op.tables, cuda, n_blocks)
        if fn is reservoir_rollout:
            assert grid.resident is (n_blocks == 128)
        (s, p), n, ro = _run(fn, op, u, x0, 16, 1, n_blocks=n_blocks, **kw)
        assert (n, ro) == (1, 0)
        ps, pp = plain(u, op.tables, op.w_in, x0, op.w_out, leak=op.leak,
                       smax=op.smax, recur_scale=op.recur_scale, **kw)
        torch.cuda.synchronize()
        tol = 0.0 if mode == "int8" else 1e-4
        assert (s - ps).abs().max().item() <= tol
        assert (p - pp).abs().max().item() <= 1e-4
        got.append((s, p))
    if mode == "int8":
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])


def test_rollout_launch_too_large_raises(cuda):
    """fp32 at dim 2048: one 16-row state tile takes 128 KiB, so an SM
    holds one block.  The default grid fits the card and runs; 256 blocks
    of 8 columns do not, and the cooperative launch refuses: the wrapper
    raises and counts nothing (no per-step fallback)."""
    rng = np.random.default_rng(0)
    fm = FixedMatrix.compile(random_sparse_matrix(2048, 2048, 0.99, rng)
                             * 0.05, weight_bits=8, mode="csd", block=128,
                             rng=rng)
    op = SpecializedRollout(fm, np.zeros((1, 2048), np.float32), mode="fp32",
                            device=cuda)
    u = torch.zeros((2, 4, 1), device=cuda)
    x0 = torch.zeros((4, 2048), device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    grid, _ = rollout_grid(op.tables, cuda)
    assert grid.n_blocks <= sms
    s, n, ro = _run(specialized_rollout, op, u, x0, 4, 1, want_states=True)
    torch.cuda.synchronize()
    assert (n, ro) == (1, 0) and torch.equal(s, torch.zeros_like(s))
    before = specialized_rollout.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(specialized_rollout, op, u, x0, 4, 1, n_blocks=256,
             want_states=True)
    assert specialized_rollout.launches == before


# -- fixed-matrix kernels (B3, B4, B5) against their twins on the card --------
def _fixed(dim_r, dim_c, sparsity, block, seed=0):
    rng = np.random.default_rng(seed)
    return FixedMatrix.compile(
        random_sparse_matrix(dim_r, dim_c, sparsity, rng) * 0.05,
        weight_bits=8, mode="csd", block=block, rng=rng)


@pytest.mark.parametrize("shape,block", [((256, 256), 64), ((200, 150), 64),
                                         ((1024, 1024), 128)])
@pytest.mark.parametrize("batch", [1, 3, 16, 20])
@pytest.mark.parametrize("x_dtype", [torch.int8, torch.int32])
def test_bitplane_gemv_kernel_exact(cuda, shape, block, batch, x_dtype):
    fm = _fixed(*shape, 0.9, block)
    op = BitplaneGemv(fm, device=cuda)
    rng = np.random.default_rng(batch)
    x = torch.as_tensor(rng.integers(-128, 128, (batch, shape[0])),
                        dtype=x_dtype, device=cuda)
    before = bitplane_gemv.launches
    y = op(x)
    assert bitplane_gemv.launches == before + 1
    torch.cuda.synchronize()
    want = fm.matvec_int_exact(x)
    assert torch.equal(y, want)
    assert torch.equal(y, bitplane_gemv_plain(x, op.digits,
                                              op.plane_mask)[:, :shape[1]])


@pytest.mark.parametrize("shape,sparsity", [((256, 256), 0.95),
                                            ((256, 512), 0.999),
                                            ((200, 300), 0.9),
                                            ((1024, 1024), 0.95)])
@pytest.mark.parametrize("batch", [1, 5, 16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16,
                                     torch.int8, torch.int32])
def test_bcsr_matmul_kernel_matches_twin(cuda, shape, sparsity, batch,
                                         x_dtype):
    rng = np.random.default_rng(batch)
    d = random_sparse_matrix(*shape, sparsity, rng).astype(np.float32)
    if not x_dtype.is_floating_point:
        d = np.clip(np.round(d * 40), -128, 127).astype(np.float32)
    op = BcsrMatmul(BlockSparse.from_dense(d, 128), device=cuda)
    if x_dtype.is_floating_point:
        x = torch.as_tensor(rng.standard_normal((batch, shape[0])),
                            dtype=x_dtype, device=cuda)
    else:
        x = torch.as_tensor(rng.integers(-100, 100, (batch, shape[0])),
                            dtype=x_dtype, device=cuda)
    before = bcsr_matmul.launches
    y = op(x)
    assert bcsr_matmul.launches == before + 1
    want = bcsr_matmul_plain(x, op.tiles, op.col_ptr, op.tile_rows,
                             op.rows_pad)[:, :shape[1]]
    torch.cuda.synchronize()
    assert y.dtype == want.dtype
    if x_dtype.is_floating_point:
        assert (y - want).abs().max().item() <= 1e-4
    else:
        assert torch.equal(y, want)


@pytest.mark.parametrize("dim,batch", [(128, 1), (256, 3), (800, 16),
                                       (1024, 16), (1024, 20)])
def test_reservoir_step_kernel_matches_twin(cuda, dim, batch):
    rng = np.random.default_rng(dim + batch)
    w = (rng.standard_normal((dim, dim)) * (0.9 / np.sqrt(dim))
         ).astype(np.float32)
    w_in = rng.uniform(-0.5, 0.5, (2, dim)).astype(np.float32)
    fr = FusedReservoir(w, w_in, leak=0.3, device=cuda)
    u = torch.as_tensor(rng.standard_normal((12, batch, 2)),
                        dtype=torch.float32, device=cuda)
    before = reservoir_step.launches
    states = fr.run(u)
    assert reservoir_step.launches == before + 12
    x = torch.zeros((batch, dim), device=cuda)
    want = []
    for t in range(12):
        x = reservoir_step_plain(x, fr.w, u[t], fr.w_in, leak=0.3)
        want.append(x)
    torch.cuda.synchronize()
    assert (states - torch.stack(want)).abs().max().item() <= 1e-4
