"""Plain-PyTorch oracle for the BCSR matmul kernel."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse import int_matmul_exact


def bcsr_matmul_ref(x, blocks, block_cols, block_rows, out_cols, block=128):
    """Dense reconstruction reference: scatter blocks, then one matmul."""
    r = x.shape[-1]
    blks = np.asarray(blocks)
    dense = np.zeros((r, out_cols), dtype=blks.dtype)
    for i in range(blks.shape[0]):
        br, bc = int(block_rows[i]), int(block_cols[i])
        dense[br * block:(br + 1) * block, bc * block:(bc + 1) * block] += blks[i]
    m = torch.as_tensor(dense, device=x.device)
    if x.dtype.is_floating_point:
        return x.to(torch.float32) @ m.to(torch.float32)
    return int_matmul_exact(x, m.to(torch.int32))
