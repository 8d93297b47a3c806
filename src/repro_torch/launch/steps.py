"""Step builders: train / prefill / decode on one device.

Each builder returns the function that drives training or serving (the
JAX package's builders return the same functions for ``jax.jit``; eager
PyTorch calls them as they are).  Only ``mesh=None`` runs: a device mesh
(TP/FSDP, sharded gradient accumulators) comes with ROADMAP A12f, and
``lower_cell`` (lowering a cell for the dry run) with A12f3.
"""

from __future__ import annotations

import torch

from repro_torch.device import ieee_fp32
from repro_torch.models.common import (tree_leaves,
                                       tree_leaves_with_path,
                                       tree_map)
from repro_torch.models.transformer import LM, ParallelCtx, _WAITS
from repro_torch.optim import adamw

__all__ = ["make_ctx", "make_train_step", "make_prefill_step",
           "make_decode_step"]


def make_ctx(mesh, cfg=None) -> ParallelCtx:
    if mesh is None:
        return ParallelCtx()
    raise NotImplementedError(_WAITS["mesh"])


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
    reference's ``donate_argnums=0``), and that state is returned with
    ``{"loss", "grad_norm", "lr"}`` (0-dim device tensors: nothing waits on
    the host).  ``grad_shardings`` (ZeRO-sharded accumulators) must be
    ``None``.
    """
    if grad_shardings is not None:
        raise NotImplementedError(
            "A12f: sharded gradient accumulators (grad_shardings=) need a "
            "device mesh, not ported yet; pass grad_shardings=None")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    ctx = make_ctx(mesh, lm.cfg)
    k = max(lm.cfg.microbatches, 1)
    acc_dtype = (torch.bfloat16 if lm.cfg.opt_dtype == "bfloat16"
                 else torch.float32)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss = lm.loss(params, batch, ctx)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state, batch):
        # differentiable aliases of the parameters (no copy)
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        with ieee_fp32(lm.device):      # the backward's products too
            if k == 1:
                loss, flat = grads_of(params, batch)
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=lm.device)
                flat = None
                for mb in _split(batch, k):
                    mb_loss, g = grads_of(params, mb)
                    loss = loss + mb_loss
                    if flat is None:
                        flat = [torch.zeros(a.shape, dtype=acc_dtype,
                                            device=a.device) for a in g]
                    for a, gi in zip(flat, g):
                        a.add_(gi.to(acc_dtype))
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

    return train_step


def _split(batch: dict, k: int) -> list:
    """``k`` microbatches: consecutive slices of B (the reference's
    ``reshape((k, B // k) + ...)``), views with no copy."""
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    m = b // k
    return [{key: x[i * m:(i + 1) * m] for key, x in batch.items()}
            for i in range(k)]


def _write_into(dst, src) -> None:
    """Every leaf of ``src`` into the tensor at the same path of ``dst``."""
    d, s = tree_leaves_with_path(dst), tree_leaves_with_path(src)
    if [p for p, _ in d] != [p for p, _ in s]:
        raise ValueError("the updated state's leaves do not match the "
                         "state's")
    torch._foreach_copy_([x for _, x in d], [x for _, x in s])


def make_prefill_step(lm: LM, mesh, cache_len: int):
    ctx = make_ctx(mesh, lm.cfg)

    def prefill_step(params, batch):
        return lm.prefill(params, batch, cache_len=cache_len, ctx=ctx)

    return prefill_step


def make_decode_step(lm: LM, mesh):
    ctx = make_ctx(mesh, lm.cfg)

    def decode_step(params, caches, token):
        return lm.decode_step(params, caches, token, ctx=ctx)

    return decode_step
