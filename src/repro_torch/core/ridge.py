"""Ridge-regression readout training — the only *trained* piece of an ESN.

"W_out is trained via linear regression ... which completely eliminates the
need for error backpropagation" (paper Sec. II).  The Gram statistics
``X^T X`` and ``X^T Y`` accumulate in float32 on the states' device, so the
solver streams over arbitrarily long state trajectories; the regularized
normal equations are then solved once on the host in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["gram_accumulate", "ridge_solve", "ridge_fit",
           "ridge_fit_sharded"]


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


def ridge_solve(xtx: torch.Tensor, xty: torch.Tensor,
                lam: float) -> torch.Tensor:
    """Solve (X^T X + lam I) W = X^T Y on the Grams' device.

    Uses a symmetric eigendecomposition rather than Cholesky: reservoir Gram
    matrices are often near-singular (strongly correlated states) and a
    float32 Cholesky fails where eigh merely clamps the tiny eigenvalues,
    which the ridge term then regularizes.
    """
    evals, evecs = torch.linalg.eigh(xtx)
    evals = torch.clamp(evals, min=0.0)     # clamp negative round-off
    inv = 1.0 / (evals + lam)
    return evecs @ (inv[:, None] * (evecs.T @ xty))


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


def ridge_fit_sharded(x: Sequence[torch.Tensor], y: Sequence[torch.Tensor],
                      lam: float, axis_name: str) -> torch.Tensor:
    """Ridge fit over rows sharded across the replicas of ``axis_name``.

    ``x`` and ``y`` hold one tensor per shard, in shard order, each on its
    shard's device.  Each shard accumulates its own Gram block there; the
    blocks are summed in shard order on the first shard's device — the
    JAX package's ``psum`` over ``axis_name`` — and solved with
    :func:`ridge_solve`.  Only the (d x d) / (d x k) statistics move
    between devices, never the trajectories, so the traffic is
    independent of sequence length.
    """
    if len(x) != len(y) or not x:
        raise ValueError(f"ridge_fit_sharded needs one (x, y) pair per "
                         f"{axis_name!r} shard, got {len(x)} x and "
                         f"{len(y)} y")
    dev = x[0].device
    xtx = xty = None
    for xs, ys in zip(x, y):
        a, b = gram_accumulate(xs, ys)
        a, b = a.to(dev), b.to(dev)
        xtx = a if xtx is None else xtx + a
        xty = b if xty is None else xty + b
    return ridge_solve(xtx, xty, lam)
