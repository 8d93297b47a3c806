"""Activation sharding constraints via an ambient mesh context.

Model code stays mesh-agnostic: it calls ``shard_batch(x, dim)`` at anchor
points (attention inputs, the layer carry, embeddings, logits chunks) and
the launch layer decides what that means by installing a context.  Without
a context every helper is a no-op, so single-device runs are unchanged.

On a mesh the activations are DTensors, and a constraint is a
``redistribute`` of the named dims only: every other dim keeps the
placement DTensor's propagation gave it (the JAX package's
``P.UNCONSTRAINED``; a hard replicate would undo e.g. the heads sharding
that came from the weights).  Inside the context plain tensors (positions,
masks, zeros) enter DTensor ops as replicated
(``implicit_replication``), and ``keep_context`` carries the context into
a checkpointed function's recompute in the backward pass.

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
           "is_dtensor", "keep_context", "model_entry", "region",
           "shard_batch", "shard_spec", "to_local"]

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


def _constrain(x, dim_axes: dict):
    """Redistribute ``x`` so dim ``d`` is split over exactly the axes
    ``dim_axes[d]``; the other mesh dims keep their placements unless they
    split one of the named dims, which then becomes theirs alone."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    pl = list(x.placements)
    for dim, axes in dim_axes.items():
        for i, p in enumerate(pl):
            if (isinstance(p, Shard) and p.dim == dim
                    and names[i] not in axes):
                pl[i] = Replicate()
        for a in axes:     # a mesh dim of size 1 stays replicated
            i = names.index(a)
            pl[i] = Shard(dim) if mesh.size(i) > 1 else Replicate()
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


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
    return _constrain(x, {dim: ctx["data"]})


def shard_spec(x, **dim_axes):
    """Constrain named dims: shard_spec(x, d0='data', d2='model')."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    mesh = ctx["mesh"]
    want = {}
    for key, kind in dim_axes.items():
        dim = int(key[1:])
        if dim >= x.ndim:
            continue
        axes = ctx["data"] if kind == "data" else (
            (ctx["model"],) if kind == "model" else ())
        if axes and _fits(math.prod(mesh.shape[a] for a in axes),
                          x.shape[dim]):
            want[dim] = axes
    return _constrain(x, want) if want else x


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
