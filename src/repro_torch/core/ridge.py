"""Ridge-regression readout training — the only *trained* piece of an ESN.

"W_out is trained via linear regression ... which completely eliminates the
need for error backpropagation" (paper Sec. II).  The Gram statistics
``X^T X`` and ``X^T Y`` accumulate in float32 on the states' device, so the
solver streams over arbitrarily long state trajectories; the regularized
normal equations are then solved once on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gram_accumulate", "ridge_fit"]


def gram_accumulate(x: torch.Tensor, y: torch.Tensor,
                    carry: tuple[torch.Tensor, torch.Tensor] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulate (X^T X, X^T Y) in float32 from a chunk of rows."""
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    y = y.reshape(-1, y.shape[-1]).to(torch.float32)
    xtx = x.T @ x
    xty = x.T @ y
    if carry is not None:
        xtx = xtx + carry[0]
        xty = xty + carry[1]
    return xtx, xty


def ridge_fit(x: torch.Tensor, y: torch.Tensor,
              lam: float = 1e-6) -> torch.Tensor:
    """One-shot ridge fit: returns W_out with ``y ~ x @ W_out``.

    The Gram statistics accumulate on the device (float32); the final
    (d x d) solve runs on the host in float64 — reservoir Grams are
    ill-conditioned enough that float32 solves visibly hurt readout
    quality, and the solve is a one-time O(d^3) epilogue.
    """
    xtx, xty = gram_accumulate(x, y)
    a = xtx.cpu().numpy().astype(np.float64)
    b = xty.cpu().numpy().astype(np.float64)
    w = np.linalg.solve(a + lam * np.eye(a.shape[0]), b)
    return torch.as_tensor(w, dtype=torch.float32, device=x.device)
