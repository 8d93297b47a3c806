"""Activation sharding constraints via an ambient mesh context.

Model code stays mesh-agnostic: it calls ``shard_batch(x, dim)`` and
:func:`pin` at anchor points (attention inputs, each block's input and
norms, the logits) and the launch layer decides what that means by
installing a context.  Without a context every helper is a no-op, so
single-device runs are unchanged.

On a mesh the activations are DTensors, and a constraint is a
``redistribute`` of the named dims only: every other dim keeps the
placement DTensor's propagation gave it (the JAX package's
``P.UNCONSTRAINED``; a hard replicate would undo e.g. the heads sharding
that came from the weights).  Inside the context plain tensors (positions,
masks, zeros) enter DTensor ops as replicated
(``implicit_replication``), and ``keep_context`` carries the context into
a checkpointed function's recompute in the backward pass.

The model pins more than the reference anchors: each block gathers its
FSDP weights (:func:`gather_weights`), and the residual stream, the norms'
outputs and the logits are pinned with their gradients (:func:`pin`), so
every product's split is the one XLA gives the reference, whatever torch
version's DTensor plans it.

:func:`to_local` / :func:`from_local` are the two ends of a local region,
the port's ``shard_map``: each rank runs plain PyTorch on its shards, with
explicit collectives where the reference has them.  The gradient that
leaves a region is declared per mesh dim: ``Partial`` where the ranks of
that dim computed different terms of one sum (a weight replicated inside
the region, each data shard's tokens), the region's own placement where
they computed the same thing.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

__all__ = ["activation_mesh", "current", "data_entry", "from_local",
           "gather_weights", "is_dtensor", "keep_context", "model_entry",
           "pin", "pin_batch", "region", "shard_batch", "summed_over",
           "to_local"]

_CTX: contextvars.ContextVar = contextvars.ContextVar("act_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh, data_axes: tuple, model_axis: str = "model"):
    tok = _CTX.set({"mesh": mesh, "data": tuple(data_axes),
                    "model": model_axis})
    try:
        with _replicate_plain_tensors():
            yield
    finally:
        _CTX.reset(tok)


@contextlib.contextmanager
def _replicate_plain_tensors():
    """DTensor's ``implicit_replication``, restoring the flag it found:
    the public context manager sets it back to False on exit, which would
    end an enclosing one (a recompute inside a step, ``keep_context``)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    old = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = old


def current():
    """The installed context (``{"mesh", "data", "model"}``) or ``None``."""
    return _CTX.get()


def keep_context(fn):
    """``fn`` run under the context installed now, wherever it is called
    later: a checkpointed function is recomputed in the backward pass, on
    the autograd engine's own thread on a card, where the caller's
    context variables are not set."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        tok = _CTX.set(ctx)
        try:
            with _replicate_plain_tensors():
                return fn(*args, **kwargs)
        finally:
            _CTX.reset(tok)

    return run


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, mesh, dim_axes: dict):
    """Redistribute ``x`` so dim ``d`` is split over exactly the axes
    ``dim_axes[d]`` of ``mesh``; the other mesh dims keep their placements
    unless they split one of the named dims, which then becomes theirs
    alone."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import mesh_dim_axes

    dm = x.device_mesh
    pl = list(x.placements)
    for dim, axes in dim_axes.items():
        dims = mesh_dim_axes(mesh, axes)
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == dim and i not in dims:
                pl[i] = Replicate()
        for i in dims:     # a mesh dim of size 1 stays replicated
            pl[i] = Shard(dim) if dm.size(i) > 1 else Replicate()
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(dm, pl)


def _fits(n: int, size: int) -> bool:
    return size % n == 0 and size >= n


def shard_batch(x, dim: int = 0):
    """Constrain dim ``dim`` of x to the data axes (if divisible)."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x) or x.ndim <= dim:
        return x
    n = math.prod(ctx["mesh"].shape[a] for a in ctx["data"])
    if not _fits(n, x.shape[dim]):
        return x
    return _constrain(x, ctx["mesh"], {dim: ctx["data"]})


def pin(x, **dim_axes):
    """``x`` with the named dims split as named (``pin(x, d0="data",
    d2="model")``, where they divide), whole along every other mesh dim,
    and its gradient placed the same on the way back: a region that
    computes nothing.  The reference's anchors leave the other dims
    unconstrained and XLA splits the products that follow by rows; given
    that freedom DTensor's propagation picks a split by a cost model that
    differs between torch versions.  Pinned inputs and gradients leave
    each product one strategy that moves nothing."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    entry = {"data": data_entry, "model": model_entry}
    dims = {key: entry[kind](ctx, x.shape[int(key[1:])])
            for key, kind in dim_axes.items() if int(key[1:]) < x.ndim}
    pl = region(ctx, x.ndim, **dims)
    return from_local(to_local(x, ctx["mesh"], pl, pl), ctx["mesh"], pl)


def pin_batch(x):
    """:func:`pin` of the batch dim (0) over the data axes."""
    return pin(x, d0="data")


def gather_weights(tree):
    """Every DTensor leaf of ``tree`` (nested dicts) with its splits over
    the data axes gathered (ZeRO-3's gather before use, as XLA gathers an
    FSDP weight for its products), under an installed context; the
    gradient is reduce-scattered back to the weight's split.  With rows
    split over the data axes and weights whole along them, a product has
    one strategy that moves nothing (:func:`pin`)."""
    ctx = _CTX.get()
    if ctx is None:
        return tree
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import mesh_dim_axes

    dims = mesh_dim_axes(ctx["mesh"], ctx["data"])

    def one(w):
        if isinstance(w, dict):
            return {k: one(v) for k, v in w.items()}
        if not is_dtensor(w):
            return w
        pl = tuple(Replicate() if i in dims and isinstance(p, Shard) else p
                   for i, p in enumerate(w.placements))
        return w if pl == tuple(w.placements) else w.redistribute(
            w.device_mesh, pl)

    return one(tree)


def to_local(x, mesh, placements, grad_placements=None):
    """The local shard of ``x`` redistributed to ``placements`` (a plain
    tensor is taken as replicated).  Its gradient leaves the region with
    ``grad_placements`` (default: ``placements``).  ``mesh`` is an
    ``LMMesh`` or a ``DeviceMesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    dm = getattr(mesh, "device_mesh", mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(dm, placements)
    return x.to_local(grad_placements=grad_placements)


def from_local(t, mesh, placements):
    """A region's local result ``t`` as a DTensor with ``placements``
    (every ``Shard`` even: the rules never make an uneven one)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, getattr(mesh, "device_mesh", mesh),
                              placements, run_check=False)


def data_entry(ctx, size: int):
    """The spec entry that splits a dim of ``size`` over the data axes,
    or ``None`` when it does not divide."""
    axes = ctx["data"]
    n = math.prod(ctx["mesh"].shape[a] for a in axes)
    return (axes if len(axes) > 1 else axes[0]) if _fits(n, size) else None


def model_entry(ctx, *sizes):
    """``model`` when every one of ``sizes`` divides over the model axis
    (and the model axis carries no data), else ``None``."""
    m = ctx["model"]
    mesh = ctx["mesh"]
    if m in ctx["data"] or m not in mesh.axis_names:
        return None
    n = mesh.shape[m]
    return m if all(_fits(n, s) for s in sizes) else None


def region(ctx, ndim: int, **dims) -> tuple:
    """Placements of an ``ndim`` tensor whose dims ``d<i>=entry`` are
    split as named (``None`` entries stay replicated)."""
    from repro_torch.parallel.sharding import placements

    spec = [None] * ndim
    for key, entry in dims.items():
        spec[int(key[1:])] = entry
    return placements(tuple(spec), ctx["mesh"])


def summed_over(mesh, pl: tuple, entry) -> tuple:
    """``pl`` with ``Partial()`` on the mesh dims of ``entry`` (an axis or
    a tuple of axes; ``None`` changes nothing): how a gradient leaves a
    region whose ranks along those axes each computed a term of it."""
    from torch.distributed.tensor import Partial

    from repro_torch.parallel.sharding import mesh_dim_axes

    if entry is None:
        return tuple(pl)
    dims = mesh_dim_axes(mesh, entry)
    return tuple(Partial() if i in dims else p for i, p in enumerate(pl))
