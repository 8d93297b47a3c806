"""The CUDA rollout kernels on the card (marked ``gpu``; skipped here).

Run on a machine with an NVIDIA GPU:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
int8 kernel states equal the plain twins' exactly; fp32 within 1e-4
(another summation order in the tile products).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sparse import FixedMatrix, random_sparse_matrix
from repro_torch.kernels.reservoir_rollout.reservoir_rollout import \
    rollout_readout
from repro_torch.kernels.reservoir_rollout.specialized import (
    SpecializedRollout, specialized_rollout, specialized_rollout_plain)

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
