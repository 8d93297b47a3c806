"""Step builders: prefill / decode on one device.

Each builder returns the function that drives serving (the JAX package's
builders return the same functions for ``jax.jit``; eager PyTorch calls
them as they are).  Only ``mesh=None`` runs: a device mesh (TP/FSDP) comes
with ROADMAP A12f, training steps with A12e.
"""

from __future__ import annotations

from repro_torch.models.transformer import LM, ParallelCtx, _WAITS

__all__ = ["make_ctx", "make_prefill_step", "make_decode_step"]


def make_ctx(mesh, cfg=None) -> ParallelCtx:
    if mesh is None:
        return ParallelCtx()
    raise NotImplementedError(_WAITS["mesh"])


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
