"""ExecutionPlan -> sorted/padded BCSR tile list -> BCSR kernel.

The tile sort, empty-column padding and gather all live in
:class:`repro_torch.plan.BcsrLayout`; this wrapper places the tiles and
their per-column offsets on the device once and dispatches.  It accepts a
FixedMatrix / ExecutionPlan (the shared compile path), a bare BlockSparse
(standalone block-sparse matmuls) or a layout.  The activations are not
padded: the kernel reads columns past ``x``'s width as zero.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparse import BlockSparse, FixedMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels.bcsr_matmul.bcsr_matmul import bcsr_matmul
from repro_torch.plan import BcsrLayout, ExecutionPlan, plan_for

__all__ = ["BcsrMatmul"]


class BcsrMatmul:
    """Precompiled block-sparse multiplier over one static tile layout, on
    ``device`` (default ``cuda``; ``"cpu"`` runs the plain twin)."""

    def __init__(self,
                 source: FixedMatrix | ExecutionPlan | BlockSparse | BcsrLayout,
                 device=None):
        if isinstance(source, BcsrLayout):
            layout = source
        elif isinstance(source, ExecutionPlan):
            layout = source.bcsr
        elif isinstance(source, FixedMatrix):
            layout = plan_for(source).bcsr
        else:
            layout = BcsrLayout.from_blocks(source)
        self.layout = layout
        self.device = resolve_device(device)
        self.tiles = torch.as_tensor(layout.data, device=self.device)
        self.col_ptr = torch.as_tensor(layout.col_ptr, device=self.device)
        self.tile_rows = torch.as_tensor(layout.rows, device=self.device)

    # Everything static lives on the layout; expose the public surface
    # as read-only views instead of mirrored copies.
    block = property(lambda self: self.layout.block)
    shape = property(lambda self: self.layout.shape)
    rows_pad = property(lambda self: self.layout.rows_pad)
    cols_pad = property(lambda self: self.layout.cols_pad)
    data = property(lambda self: self.layout.data)
    cols = property(lambda self: self.layout.cols)
    rows = property(lambda self: self.layout.rows)
    n_tiles = property(lambda self: self.layout.n_tiles)

    def __call__(self, x) -> torch.Tensor:
        """x: (B, rows) -> (B, cols); float32 for float x, int32 for
        integer x."""
        x = torch.as_tensor(x, device=self.device)
        if x.dim() != 2 or x.shape[1] != self.shape[0]:
            raise ValueError(f"x must be (B, {self.shape[0]}), got "
                             f"{tuple(x.shape)}")
        y = bcsr_matmul(x, self.tiles, self.col_ptr, self.tile_rows,
                        self.rows_pad)
        return y[:, : self.shape[1]]
