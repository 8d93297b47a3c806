"""The CUDA kernels on the card (marked ``gpu``; skipped here).

Run on a machine with an NVIDIA GPU:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Rollout: int8 kernel states equal the plain twins' exactly; fp32 within
1e-4 (another summation order in the tile products).  Bitplane gemv and
the integer BCSR product equal their twins exactly; float BCSR products
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
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import \
    rollout_readout
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout, specialized_rollout_plain)
from repro_torch.kernels.reservoir_step.ops import FusedReservoir
from repro_torch.kernels.reservoir_step.reservoir_step import (
    reservoir_step, reservoir_step_plain)

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
            rollout_readout.launches - before[1]) == (6, 6)
    ps, pp, pf = specialized_rollout_plain(
        u, op.tables, op.w_in, x0, op.w_out, leak=op.leak, smax=op.smax,
        recur_scale=op.recur_scale, **kw)
    torch.cuda.synchronize()
    tol = 0.0 if mode == "int8" else 1e-4
    assert (s - ps).abs().max().item() <= tol
    assert (f - pf).abs().max().item() <= tol
    assert (p - pp).abs().max().item() <= 1e-4


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
