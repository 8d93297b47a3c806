"""ExecutionPlan -> digit planes -> bitplane gemv.

The digit decomposition and whole-plane cull mask come from the shared
:mod:`repro_torch.plan` lowering; this wrapper only places the planes on
the device once and dispatches.  Nothing is padded to a block multiple:
the kernel reads only the digit rows ``x`` covers, and its columns only
to the next multiple of 4 (one ``char4`` of a plane row).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse import FixedMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels.bitplane_gemv.bitplane_gemv import bitplane_gemv
from repro_torch.plan import ExecutionPlan, plan_for
from repro_torch.plan.plan import pad_axis

__all__ = ["BitplaneGemv", "digits_from_fixed"]


def digits_from_fixed(fm: FixedMatrix) -> np.ndarray:
    """Signed digit planes (W, R, C) int8 via the shared ExecutionPlan."""
    return plan_for(fm).digits


class BitplaneGemv:
    """Precompiled digit-plane multiplier for one fixed matrix.

    Offline (init): pull the planes and the per-plane cull mask from the
    ExecutionPlan and place the planes on ``device`` (default ``cuda``;
    ``"cpu"`` runs the plain twin).  Online (``__call__``): one kernel
    launch, exact int32 result.
    """

    def __init__(self, source: FixedMatrix | ExecutionPlan, device=None):
        plan = source if isinstance(source, ExecutionPlan) else plan_for(source)
        self.plan = plan
        self.device = resolve_device(device)
        self.rows, self.cols = plan.shape
        self.digits = torch.as_tensor(np.ascontiguousarray(
            pad_axis(plan.digits, 2, -(-self.cols // 4) * 4)),
            device=self.device)
        # Whole-plane culling: CSD often leaves high planes empty.
        self.plane_mask = plan.plane_mask

    def __call__(self, x) -> torch.Tensor:
        """x: (B, rows) int8/int32 -> (B, cols) int32 exact."""
        x = torch.as_tensor(x, device=self.device)
        if x.dim() != 2 or x.shape[1] != self.rows:
            raise ValueError(f"x must be (B, {self.rows}), got "
                             f"{tuple(x.shape)}")
        y = bitplane_gemv(x, self.digits, plane_mask=self.plane_mask)
        return y[:, : self.cols]
