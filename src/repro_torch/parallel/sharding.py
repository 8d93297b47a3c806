"""Logical-axis -> mesh-axis sharding rules (TP / FSDP / EP).

Model code annotates every parameter dim with a logical name (see
``models/common.py``); this module resolves those names against a mesh:

  TP  ('model'):  vocab, heads, kv, ffn, expert, lru
  FSDP('data' [+ 'pod']): embed  — every weight's d_model dim is sharded
      across the data axes, ZeRO-3 style; DTensor's sharding propagation
      gathers a weight where an op needs it whole and reduce-scatters its
      gradient back.

A dim is only sharded when its size divides the axis size — e.g. MQA's one
kv head stays replicated on a 16-way model axis rather than failing — so no
rule ever makes an uneven shard.

The rules are pure functions of any mesh-like object with ``axis_names``
and a ``shape`` mapping (an :class:`~repro_torch.launch.mesh.LMMesh`, an
:class:`~repro_torch.launch.mesh.AbstractMesh`, a ``DataMesh``).  A spec is
a tuple with one entry per tensor dim, as the JAX package's
``PartitionSpec`` lists them: ``None`` (replicated), an axis name, or a
tuple of axis names (``("pod", "data")``: split over both, pod outer).
:func:`placements` turns a spec into DTensor placements, one per mesh dim;
:class:`NamedSharding` pairs a mesh with a spec, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

__all__ = ["TP_AXES", "NamedSharding", "batch_sharding", "batch_spec",
           "cache_sharding", "data_axis_names", "data_axis_size",
           "distribute_tree",
           "param_shardings", "placements", "resolve_axes"]

TP_AXES = ("vocab", "heads", "kv", "ffn", "expert", "lru")


def data_axis_names(mesh) -> tuple:
    """The batch/FSDP axes present in this mesh ('pod' composes with 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_axis_size(mesh) -> int:
    """Data-parallel width: product of the batch axes ('pod' x 'data')."""
    return _axis_size(mesh, data_axis_names(mesh))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _entry(axes: tuple):
    """A spec entry for ``axes``: one name alone, several as a tuple."""
    return axes if len(axes) > 1 else axes[0]


def resolve_axes(logical: tuple, shape: tuple, mesh, fsdp: bool = True,
                 use_tp: bool = True, expert_fsdp: bool = True) -> tuple:
    """Logical names + concrete shape -> spec (divisibility-safe).

    use_tp=False: the 'model' axis joins the FSDP axes instead of carrying
    tensor parallelism (right for collective-bound models that fit without
    TP).  expert_fsdp=False: weights with an 'expert' dim skip FSDP on
    their other dims (EP-resident experts).
    """
    daxes = data_axis_names(mesh)
    fsdp_axes = daxes if use_tp else daxes + (
        ("model",) if "model" in mesh.axis_names else ())
    is_expert_w = "expert" in logical
    spec: list = []
    used_model = False
    used_data = False
    for name, dim in zip(logical, shape):
        entry = None
        if (name in TP_AXES and use_tp and not used_model
                and "model" in mesh.axis_names):
            if dim % mesh.shape["model"] == 0 and dim > 0:
                entry = "model"
                used_model = True
        elif (name == "embed" and fsdp and not used_data and fsdp_axes
                and not (is_expert_w and not expert_fsdp)):
            n = _axis_size(mesh, fsdp_axes)
            if dim % n == 0 and dim >= n:
                entry = _entry(fsdp_axes)
                used_data = True
        spec.append(entry)
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the port's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> DTensor placements, one per mesh dim in the mesh's order.

    Tensor dim ``d`` split over axes ``(a, b)`` puts ``Shard(d)`` on the
    mesh dims of ``a`` and ``b``; DTensor splits a dim sharded by several
    mesh dims in mesh order, the first outermost, as JAX splits
    ``P(("pod", "data"))`` when 'pod' precedes 'data' in the mesh.  Every
    other mesh dim is ``Replicate()``, and so is a mesh dim of size 1: its
    one shard is the whole dim, and DTensor's propagation would treat a
    ``Shard`` there as split (it refuses views across it).
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for a in axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            if mesh.shape[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(x is None or isinstance(x, str)
                                        for x in a)


def _map_axes(fn, axes_tree, shapes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree, shapes_tree)
    if axes_tree is None:
        return None
    return {k: _map_axes(fn, axes_tree[k], shapes_tree[k])
            for k in axes_tree}


def param_shardings(axes_tree: Any, shapes_tree: Any, mesh,
                    fsdp: bool = True, use_tp: bool = True,
                    expert_fsdp: bool = True) -> Any:
    """Tree of logical-axes tuples + tree of tensors (anything with
    ``.shape``) -> tree of :class:`NamedSharding`."""
    return _map_axes(
        lambda ax, sh: NamedSharding(
            mesh, resolve_axes(ax, tuple(sh.shape), mesh, fsdp, use_tp,
                               expert_fsdp)),
        axes_tree, shapes_tree)


def batch_spec(mesh) -> tuple:
    """Batch dim over all data axes, as a partition spec: one entry per
    tensor dim, the first naming the axis (or axes) it is split over."""
    return (_entry(data_axis_names(mesh)),)


def batch_sharding(mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh) + (None,) * (ndim - 1))


def cache_sharding(mesh, shape: tuple, n_kv: Optional[int] = None,
                   batch_dim: int = 0, kv_dim: Optional[int] = None,
                   seq_dim: Optional[int] = None) -> NamedSharding:
    """KV-cache policy: batch over data axes; kv-heads over 'model' when
    divisible, else the sequence dim over 'model' (distributed decode)."""
    d = data_axis_names(mesh)
    spec = [None] * len(shape)
    if shape[batch_dim] % _axis_size(mesh, d) == 0 and shape[batch_dim] > 1:
        spec[batch_dim] = _entry(d)
    nm = mesh.shape.get("model", 1)
    if (kv_dim is not None and n_kv and n_kv % nm == 0):
        spec[kv_dim] = "model"
    elif seq_dim is not None and shape[seq_dim] % nm == 0:
        spec[seq_dim] = "model"
    return NamedSharding(mesh, tuple(spec))


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """A tree of full tensors (the same on every rank) -> DTensors placed
    by the matching tree of :class:`NamedSharding`: each rank keeps only
    its own shard, cut locally (no communication).  On a mesh of one a
    local shard may alias its source."""
    from torch.distributed.tensor import distribute_tensor

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return distribute_tensor(tree, shardings.mesh.device_mesh,
                             shardings.placements, src_data_rank=None)
