"""Plain-PyTorch oracles for the digit-plane gemv kernel."""

from __future__ import annotations

import torch

from repro_torch.core.sparse import int_matmul_exact


def bitplane_gemv_ref(x: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Exact integer ``x @ (sum_w 2^w digits[w])`` in int32.

    x: (B, R) integer; digits: (W, R, C) in {-1, 0, 1}.
    """
    out = torch.zeros((x.shape[0], digits.shape[2]), dtype=torch.int32,
                      device=x.device)
    for b in range(digits.shape[0]):
        out = out + (int_matmul_exact(x, digits[b]) << b)
    return out


def dense_gemv_ref(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Direct dense integer product (ground truth for both paths)."""
    return int_matmul_exact(x, v)
