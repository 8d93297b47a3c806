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
:func:`placements` turns a spec into DTensor placements, one per DTensor
mesh dim; :class:`NamedSharding` pairs a mesh with a spec, as JAX's does.

The DTensor mesh has one dim per named axis but for 'pod' and 'data',
which share one (:func:`mesh_dims`): every data-parallel split names both
(``data_axis_names``), and one mesh dim of pod x data ranks, pod outer,
cuts a tensor dim into the same shards in the same rank order as the two
nested ones, while DTensor's sharding propagation plans a tensor dim split
by one mesh dim directly, where two nested ones send every candidate
strategy through its graph search of redistribute paths (minutes per
product at 2 x 16 x 16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

__all__ = ["TP_AXES", "NamedSharding", "ShapeDtypeStruct", "batch_sharding",
           "batch_spec", "cache_sharding", "data_axis_names",
           "data_axis_size", "distribute_tree", "mesh_dim_axes",
           "mesh_dim_sizes", "mesh_dims", "param_shardings", "placements",
           "placements_by_axis", "resolve_axes", "scale_spec"]

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


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A shape, a ``torch.dtype`` and an optional :class:`NamedSharding`:
    an input that allocates nothing (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: Any
    sharding: Optional[NamedSharding] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))


def scale_spec(spec: tuple, ndim: int) -> tuple:
    """The spec of an int8 leaf's scale from its weight's: the out-channel
    (last) dim's entry, after the layer dim's for a stacked (rank >= 3)
    weight, as the reference's ``quant_struct_like`` places it."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return (spec[0], spec[-1]) if ndim >= 3 else (spec[-1],)


def mesh_dims(mesh) -> tuple:
    """The named axes behind each DTensor mesh dim, in mesh order: one dim
    per axis, but 'pod' and 'data' (when both are present, 'pod' just
    before 'data') one dim together, pod outer."""
    names = tuple(mesh.axis_names)
    if "pod" not in names or "data" not in names:
        return tuple((a,) for a in names)
    i = names.index("pod")
    if names[i + 1:i + 2] != ("data",):
        raise ValueError(f"'pod' must come just before 'data' in a mesh: "
                         f"{names}")
    return (tuple((a,) for a in names[:i]) + (("pod", "data"),)
            + tuple((a,) for a in names[i + 2:]))


def mesh_dim_sizes(mesh) -> tuple:
    """The size of each DTensor mesh dim (:func:`mesh_dims`)."""
    return tuple(_axis_size(mesh, g) for g in mesh_dims(mesh))


def mesh_dim_axes(mesh, entry) -> tuple:
    """The DTensor mesh dims a spec entry (an axis name or a tuple of them,
    in mesh order) splits over.  An entry that names 'pod' or 'data'
    without the other, on a mesh that holds both, raises: the two are one
    DTensor mesh dim."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    groups = mesh_dims(mesh)
    dims = []
    for i, g in enumerate(groups):
        hit = [a for a in g if a in axes]
        if hit and len(hit) < len(g):
            raise ValueError(f"spec entry {entry} splits over {hit} "
                             f"without the rest of mesh dim {g}")
        if hit:
            dims.append(i)
    if list(axes) != [a for i in dims for a in groups[i]]:
        raise ValueError(f"spec entry {entry} is not in mesh order "
                         f"{tuple(mesh.axis_names)}")
    return tuple(dims)


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> DTensor placements, one per DTensor mesh dim
    (:func:`mesh_dims`) in the mesh's order.

    Tensor dim ``d`` split over axes ``(a, b)`` puts ``Shard(d)`` on the
    mesh dims of ``a`` and ``b``; DTensor splits a dim sharded by several
    mesh dims in mesh order, the first outermost, as JAX splits
    ``P(("pod", "data"))`` when 'pod' precedes 'data' in the mesh (here one
    mesh dim of pod x data ranks, pod outer: the same shards).  Every
    other mesh dim is ``Replicate()``, and so is a mesh dim of size 1: its
    one shard is the whole dim, and DTensor's propagation would treat a
    ``Shard`` there as split (it refuses views across it).
    """
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_dim_sizes(mesh)
    out = [Replicate()] * len(sizes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for i in mesh_dim_axes(mesh, entry):
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {mesh_dims(mesh)[i]} used "
                                 f"twice in {spec}")
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def placements_by_axis(mesh, by_axis: dict) -> tuple:
    """DTensor placements from one placement per named axis (an axis not
    named is ``Replicate()``); axes that share a DTensor mesh dim must be
    given the same placement."""
    from torch.distributed.tensor import Replicate

    unknown = set(by_axis) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"no mesh axis {sorted(unknown)} in "
                         f"{tuple(mesh.axis_names)}")
    out = []
    for g in mesh_dims(mesh):
        got = [by_axis.get(a, Replicate()) for a in g]
        if any(p != got[0] for p in got):
            raise ValueError(f"axes {g} share one mesh dim and were given "
                             f"{got}")
        out.append(got[0])
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
    local shard may alias its source.  An int8 leaf ``{"q", "scale"}``
    facing its weight's sharding places ``q`` by it and ``scale`` by
    :func:`scale_spec`."""
    from torch.distributed.tensor import distribute_tensor

    if tree is None:
        return None
    if (isinstance(tree, dict) and set(tree) == {"q", "scale"}
            and isinstance(shardings, NamedSharding)):
        sh = shardings
        shardings = {"q": sh, "scale": NamedSharding(
            sh.mesh, scale_spec(sh.spec, tree["q"].ndim))}
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return distribute_tensor(tree, shardings.mesh.device_mesh,
                             shardings.placements, src_data_rank=None)
