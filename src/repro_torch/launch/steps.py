"""Step builders: train / prefill / decode, mesh-aware.

Each builder returns the function that drives training or serving (the
JAX package's builders return the same functions for ``jax.jit``; eager
PyTorch calls them as they are).  With a mesh (an
:class:`~repro_torch.launch.mesh.LMMesh`) the step runs under the
activation context of ``parallel/act.py``: the parameters and the
optimizer state are DTensors placed by ``parallel/sharding.py`` (e.g.
through ``lm_params_from_numpy(mesh=)``), a plain batch is split over the
data axes on the way in (each rank keeps its own rows of the global batch
every rank holds), and the outputs are DTensors (``.full_tensor()`` reads
one whole).  ``lower_cell`` (lowering a cell for the dry run) waits for
ROADMAP A12f3.
"""

from __future__ import annotations

import torch

from repro_torch.device import ieee_fp32
from repro_torch.models.common import (tree_leaves,
                                       tree_leaves_with_path,
                                       tree_map)
from repro_torch.models.transformer import LM, ParallelCtx
from repro_torch.optim import adamw
from repro_torch.parallel.act import (activation_mesh, current, data_entry,
                                      is_dtensor, region)
from repro_torch.parallel.sharding import data_axis_names

__all__ = ["make_ctx", "make_train_step", "make_prefill_step",
           "make_decode_step"]


def make_ctx(mesh, cfg=None) -> ParallelCtx:
    if mesh is None:
        return ParallelCtx()
    daxes = data_axis_names(mesh) or ("data",)
    if cfg is not None and not cfg.use_tp and "model" in mesh.axis_names:
        daxes = daxes + ("model",)  # model axis joins DP/FSDP
    fsdp = cfg.expert_fsdp if cfg is not None else True
    return ParallelCtx(mesh=mesh, data_axes=daxes, fsdp=fsdp)


def _with_act_ctx(fn, mesh, ctx):
    """Run fn under the activation-sharding context, so the in-model
    ``shard_batch`` anchors constrain the DTensors."""
    if mesh is None:
        return fn

    def wrapped(*args, **kw):
        with activation_mesh(mesh, ctx.data_axes, ctx.model_axis):
            return fn(*args, **kw)

    return wrapped


def _place_batch(batch: dict, mesh) -> dict:
    """Each plain tensor of the batch (the same global batch on every rank)
    as a DTensor with its batch dim over the data axes, when it divides;
    DTensors pass as they are."""
    from torch.distributed.tensor import distribute_tensor

    ctx = current()
    out = {}
    for key, x in batch.items():
        if is_dtensor(x) or not isinstance(x, torch.Tensor):
            out[key] = x
            continue
        pl = region(ctx, x.ndim, d0=data_entry(ctx, x.shape[0]))
        out[key] = distribute_tensor(x, mesh.device_mesh, pl,
                                     src_data_rank=None)
    return out


def make_train_step(lm: LM, mesh, opt_cfg: adamw.AdamWConfig | None = None,
                    grad_shardings=None):
    """The train step ``(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt": {"m", "v", "step"}}``; ``batch`` the
    loss's (``tokens`` (B, S+1) on the device, int64).  With
    ``microbatches = k > 1`` the batch splits into ``k`` slices along B,
    each slice's gradients (``torch.autograd.grad`` of ``lm.loss``) are
    added into an accumulator in ``opt_dtype`` and loss and gradients are
    divided by ``k``; with ``k == 1`` the gradients keep the parameters'
    dtype until the clip casts them, as in the reference.  Then
    ``adamw.apply_updates``; the new parameters and optimizer state are
    written into the state's own tensors (the port's stand-in for the
    reference's ``donate_argnums=0``; a DTensor into a DTensor of the same
    placements), and that state is returned with ``{"loss", "grad_norm",
    "lr"}`` (0-dim device tensors: nothing waits on the host).

    ``grad_shardings``: optional tree of ``NamedSharding`` for the gradient
    accumulator (ZeRO: shard grads even where the weights are kept
    resident, so per-microbatch reductions become reduce-scatters); each
    accumulator and each microbatch's gradients are redistributed to it.
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = make_ctx(mesh, lm.cfg)
    k = max(lm.cfg.microbatches, 1)
    acc_dtype = (torch.bfloat16 if lm.cfg.opt_dtype == "bfloat16"
                 else torch.float32)
    targets = (None if grad_shardings is None else
               dict(tree_leaves_with_path(grad_shardings)))

    def constrain(flat, params):
        """On a mesh the accumulator takes ``grad_shardings``, else the
        parameters' placements (the reference's accumulator inherits
        them)."""
        if mesh is None:
            return flat
        pls = ([p.placements for p in tree_leaves(params)] if targets is None
               else [targets[path].placements for path in _paths(params)])
        return [g if tuple(g.placements) == tuple(pl) else
                g.redistribute(g.device_mesh, pl)
                for g, pl in zip(flat, pls)]

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss = lm.loss(params, batch, ctx)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state, batch):
        # microbatch i is rows [i*m, (i+1)*m) of the global batch, as the
        # reference's reshape makes it; on a mesh each is then split over
        # the data axes
        micro = _split(batch, k) if k > 1 else [batch]
        if mesh is not None:
            micro = [_place_batch(mb, mesh) for mb in micro]
        # differentiable aliases of the parameters (no copy)
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with ieee_fp32(lm.device):      # the backward's products too
            if k == 1:
                loss, flat = grads_of(params, micro[0])
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=lm.device)
                flat = None
                for mb in micro:
                    mb_loss, g = grads_of(params, mb)
                    loss = loss + mb_loss
                    g = constrain([gi.to(acc_dtype) for gi in g], params)
                    if flat is None:
                        flat = [torch.zeros_like(gi) for gi in g]
                    for a, gi in zip(flat, g):
                        a.add_(gi)
                    del g
                loss = loss / k
                for a in flat:
                    a.div_(k)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), state["params"])
        del flat
        with torch.no_grad():
            new_params, new_opt, metrics = adamw.apply_updates(
                state["params"], grads, state["opt"], opt_cfg)
            del grads
            _write_into(state["params"], new_params)
            _write_into(state["opt"], new_opt)
        return state, {"loss": loss, **metrics}

    return _with_act_ctx(train_step, mesh, ctx)


def _paths(tree, path=()) -> list:
    """The leaves' paths in ``tree_leaves`` order (insertion order)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    return [] if tree is None else [path]


def _split(batch: dict, k: int) -> list:
    """``k`` microbatches: consecutive slices of B (the reference's
    ``reshape((k, B // k) + ...)``), views with no copy (a DTensor batch is
    gathered whole first)."""
    batch = {key: x.full_tensor() if is_dtensor(x) else x
             for key, x in batch.items()}
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    m = b // k
    return [{key: x[i * m:(i + 1) * m] for key, x in batch.items()}
            for i in range(k)]


def _write_into(dst, src) -> None:
    """Every leaf of ``src`` into the tensor at the same path of ``dst``
    (a DTensor into a DTensor: ``src`` redistributed to ``dst``'s
    placements, then shard into shard)."""
    d, s = tree_leaves_with_path(dst), tree_leaves_with_path(src)
    if [p for p, _ in d] != [p for p, _ in s]:
        raise ValueError("the updated state's leaves do not match the "
                         "state's")
    dl, sl = [x for _, x in d], [x for _, x in s]
    for i, (a, b) in enumerate(zip(dl, sl)):
        if is_dtensor(a):
            if tuple(b.placements) != tuple(a.placements):
                b = b.redistribute(a.device_mesh, a.placements)
            dl[i], sl[i] = a.to_local(), b.to_local()
        elif is_dtensor(b):
            sl[i] = b.full_tensor()
    torch._foreach_copy_(dl, sl)


def make_prefill_step(lm: LM, mesh, cache_len: int):
    ctx = make_ctx(mesh, lm.cfg)

    def prefill_step(params, batch):
        if mesh is not None:
            batch = _place_batch(batch, mesh)
        return lm.prefill(params, batch, cache_len=cache_len, ctx=ctx)

    return _with_act_ctx(prefill_step, mesh, ctx)


def make_decode_step(lm: LM, mesh):
    ctx = make_ctx(mesh, lm.cfg)

    def decode_step(params, caches, token):
        if mesh is not None:
            token = _place_batch({"t": token}, mesh)["t"]
        return lm.decode_step(params, caches, token, ctx=ctx)

    return _with_act_ctx(decode_step, mesh, ctx)
