"""ExecutionPlan -> sorted/padded BCSR tile list -> BCSR kernel.

The tile sort, empty-column padding and gather all live in
:class:`repro_torch.plan.BcsrLayout`.  On a CUDA device this wrapper packs
the tiles once, at construction, into the kernel's per-block shares
(:func:`~repro_torch.kernels.bcsr_matmul.bcsr_matmul.pack_tiles`), so a
call is the operand checks, one output allocation and one launch; the
tile list itself reaches the device only if the plain twin asks for it.  It accepts a
FixedMatrix / ExecutionPlan (the shared compile path), a bare BlockSparse
(standalone block-sparse matmuls) or a layout.  The activations are not
padded: the kernel reads columns past ``x``'s width as zero.
"""

from __future__ import annotations

import torch

from repro_torch.core.sparse import BlockSparse, FixedMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels.bcsr_matmul.bcsr_matmul import (bcsr_matmul,
                                                         pack_tiles)
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
        self.packed = (pack_tiles(layout.data, layout.col_ptr, layout.rows,
                                  layout.rows_pad, self.device)
                       if self.device.type == "cuda" else None)
        self._twin = {}

    def _on_device(self, name: str, host) -> torch.Tensor:
        if name not in self._twin:
            self._twin[name] = torch.as_tensor(host, device=self.device)
        return self._twin[name]

    # The tile list on the device (what the plain twin reads), made at
    # first use.
    tiles = property(lambda self: self._on_device("tiles", self.layout.data))
    col_ptr = property(lambda self: self._on_device("col_ptr",
                                                    self.layout.col_ptr))
    tile_rows = property(lambda self: self._on_device("tile_rows",
                                                      self.layout.rows))

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
        if self.packed is not None:
            y = bcsr_matmul(x, self.packed)
        else:
            y = bcsr_matmul(x, self.tiles, self.col_ptr, self.tile_rows,
                            self.rows_pad)
        return y[:, : self.shape[1]]
