"""Data-axis helpers of sharded serving.

The JAX package's module also resolves logical model axes to a mesh
(tensor parallelism, FSDP, KV-cache placement) for the LM substrate; the
reservoir server needs only the batch axis, so only these helpers are
here.  A :class:`~repro_torch.launch.mesh.DataMesh` has the one axis
``'data'``; the helpers also compose a ``'pod'`` axis, as the reference's
do, for any mesh-like object with ``axis_names`` and ``shape``.
"""

from __future__ import annotations

import math

__all__ = ["batch_spec", "data_axis_names", "data_axis_size"]


def data_axis_names(mesh) -> tuple:
    """The batch axes present in this mesh ('pod' composes with 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_axis_size(mesh) -> int:
    """Data-parallel width: product of the batch axes ('pod' x 'data')."""
    return math.prod(mesh.shape[a] for a in data_axis_names(mesh))


def batch_spec(mesh) -> tuple:
    """Batch dim over all data axes, as a partition spec: one entry per
    tensor dim, the first naming the axis (or axes) it is split over."""
    d = data_axis_names(mesh)
    return (d if len(d) > 1 else d[0],)
