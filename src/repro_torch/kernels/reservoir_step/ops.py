"""Dense reservoir matrix -> fused step kernel, one launch per step.

The JAX wrapper pads W and W_in to block multiples and drives the step
with ``lax.scan``; here the kernel masks the ragged edge instead, and
:meth:`FusedReservoir.run` is a Python loop over T with one launch per
step.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.reservoir_step.reservoir_step import reservoir_step

__all__ = ["FusedReservoir"]


class FusedReservoir:
    """Run a whole input sequence through the fused step kernel, on
    ``device`` (default ``cuda``; ``"cpu"`` runs the plain twin)."""

    def __init__(self, w, w_in, leak: float = 1.0, device=None):
        self.device = resolve_device(device)
        as_t = lambda a: torch.as_tensor(                     # noqa: E731
            a, dtype=torch.float32, device=self.device).contiguous()
        self.w = as_t(w)
        self.w_in = as_t(w_in)
        self.dim = self.w.shape[0]
        self.leak = float(leak)

    def step(self, x, u, out: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, dim), u: (B, I) -> (B, dim) (written into ``out`` when
        given)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        u = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        return reservoir_step(x, self.w, u, self.w_in, leak=self.leak,
                              out=out)

    def run(self, inputs, x0=None) -> torch.Tensor:
        """inputs: (T, B, I) -> states (T, B, dim).

        The states output is allocated once; step t's launch writes its
        slice ``states[t]`` in place and reads ``states[t - 1]``."""
        inputs = torch.as_tensor(inputs, dtype=torch.float32,
                                 device=self.device)
        t_steps, b, _ = inputs.shape
        x = (torch.zeros((b, self.dim), device=self.device) if x0 is None
             else torch.as_tensor(x0, dtype=torch.float32,
                                  device=self.device))
        states = torch.empty((t_steps, b, self.dim), device=self.device)
        for t in range(t_steps):
            x = self.step(x, inputs[t], out=states[t])
        return states
