"""ExecutionPlan -> digit planes -> bitplane gemv.

The digit decomposition and whole-plane cull mask come from the shared
:mod:`repro_torch.plan` lowering.  On a CUDA device the wrapper packs the
kept planes once, at construction, into the kernel's per-block shares
(:func:`~repro_torch.kernels.bitplane_gemv.bitplane_gemv.pack_planes`), so
a call is the operand checks, one output allocation and one launch.  The
planes themselves reach the device only if the plain twin asks for them
(:attr:`BitplaneGemv.digits`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse import FixedMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels.bitplane_gemv.bitplane_gemv import (bitplane_gemv,
                                                             pack_planes)
from repro_torch.plan import ExecutionPlan, plan_for

__all__ = ["BitplaneGemv", "digits_from_fixed"]


def digits_from_fixed(fm: FixedMatrix) -> np.ndarray:
    """Signed digit planes (W, R, C) int8 via the shared ExecutionPlan."""
    return plan_for(fm).digits


class BitplaneGemv:
    """Precompiled digit-plane multiplier for one fixed matrix.

    Offline (init): pull the planes and the per-plane cull mask from the
    ExecutionPlan and, on ``device`` ``cuda`` (the default), pack the kept
    planes for the kernel; ``"cpu"`` runs the plain twin.  Online
    (``__call__``): one kernel launch, exact int32 result.
    """

    def __init__(self, source: FixedMatrix | ExecutionPlan, device=None):
        plan = source if isinstance(source, ExecutionPlan) else plan_for(source)
        self.plan = plan
        self.device = resolve_device(device)
        self.rows, self.cols = plan.shape
        # Whole-plane culling: CSD often leaves high planes empty.
        self.plane_mask = plan.plane_mask
        self.packed = (pack_planes(plan.digits, self.plane_mask, self.device)
                       if self.device.type == "cuda" else None)
        self._digits = None

    @property
    def digits(self) -> torch.Tensor:
        """The (W, rows, cols) int8 planes on the device (what the twin
        reads), made at first use."""
        if self._digits is None:
            self._digits = torch.as_tensor(
                np.ascontiguousarray(self.plan.digits), device=self.device)
        return self._digits

    def __call__(self, x) -> torch.Tensor:
        """x: (B, rows) int8/int32 -> (B, cols) int32 exact."""
        x = torch.as_tensor(x, device=self.device)
        if x.dim() != 2 or x.shape[1] != self.rows:
            raise ValueError(f"x must be (B, {self.rows}), got "
                             f"{tuple(x.shape)}")
        planes = self.digits if self.packed is None else self.packed
        return bitplane_gemv(x, planes, plane_mask=self.plane_mask)
