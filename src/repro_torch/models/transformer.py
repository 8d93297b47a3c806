"""Model assembly: block dispatch, stacked layer groups, the LM API.

A config's ``block_pattern`` (e.g. ``("rglru", "rglru", "local")``) defines
one *group*; the depth is ``n_groups`` repetitions (plus an optional tail).
Groups are homogeneous, so every group parameter is one stacked tensor with
a leading layer dim, the JAX package's layout; the layer stack is a Python
loop over views of those tensors (the JAX package's ``lax.scan``).

Block types:
  attn   - global causal attention + MLP (or MoE)
  local  - sliding-window attention + MLP
  mla    - DeepSeek-V2 latent attention + MoE
  rglru  - Griffin recurrent block + MLP
  mlstm  - xLSTM matrix-memory block (no separate MLP when d_ff == 0)
  slstm  - xLSTM scalar-memory block
An ``encoder`` config (whisper) adds the enc-dec stack: a bidirectional
encoder over stub frame embeddings and a cross-attention after each
decoder group.

On a device mesh (``ParallelCtx(mesh=)``, set up by the step builders)
parameters, caches and activations are DTensors placed by the rules of
``parallel/sharding.py``; the blocks run on them as on tensors, with the
reference's activation anchors (``shard_batch`` at the embeddings and the
layer carry) and local regions where the reference uses ``shard_map``
(the MoE's expert parallelism, ``_slstm_sharded``).  Int8 serving leaves
on a mesh wait for ROADMAP A12f3.

``LM`` keeps the JAX package's functional API: parameters are a nested
dict of tensors, ``loss`` / ``prefill`` / ``decode_step`` take them as
arguments.  It departs where PyTorch works differently: an explicit
``device`` (``None`` = ``cuda``, raising without one) and
``torch.Generator`` keys; caches and recurrent states preallocated and
written in place (a decode step returns the caches it was given,
advanced); the decode position a 0-dim device tensor, so a decode step
never synchronises with the host; ``param_count`` on the ``meta`` device in
place of ``jax.eval_shape``.  ``loss`` runs the same blocks without caches
(nothing written in place, so autograd can differentiate it), and its
``remat`` modes are ``torch.utils.checkpoint`` (``_remat``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import ieee_fp32, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import gqa, mla as mla_lib, moe as moe_lib
from repro_torch.models import rglru as rglru_lib, xlstm as xlstm_lib
from repro_torch.models.common import (ParamsWithAxes, apply_norm,
                                       cross_entropy, cross_entropy_streamed,
                                       dense_init, embed_init, embed_lookup,
                                       logits_from_embedding, mlp_apply,
                                       mlp_init, norm_init, split_tree,
                                       tree_leaves, tree_map)
from repro_torch.models.quantize import dequant_tree, is_quantized_leaf
from repro_torch.parallel import act
from repro_torch.parallel.sharding import (cache_sharding, distribute_tree,
                                           param_shardings, placements)

__all__ = ["LM", "ParallelCtx", "cache_spec", "lm_param_shardings",
           "lm_params_from_numpy", "train_state_from_numpy"]

# what the port does not run yet, by ROADMAP item
_WAITS = {
    "int8_mesh": ("A12f3: int8 frozen-weight leaves on a device mesh (the "
                  "reference's quant_struct_like) are not ported yet; serve "
                  "int8 with mesh=None"),
}


@dataclasses.dataclass
class ParallelCtx:
    mesh: Any = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp: bool = True


def _check_leaves(params, ctx) -> None:
    """Int8 leaves run on one device only (ROADMAP A12f3)."""
    if ctx.mesh is None:
        return
    stack = [params]
    while stack:
        t = stack.pop()
        if is_quantized_leaf(t):
            raise NotImplementedError(_WAITS["int8_mesh"])
        if isinstance(t, dict):
            stack.extend(t.values())


# ---------------------------------------------------------------------------
# Single block init / forward / decode
# ---------------------------------------------------------------------------
def _init_block(key, cfg: ModelConfig, kind: str, dtype, *, lead, device):
    kw = dict(lead=lead, device=device)
    p: dict = {"norm1": norm_init(cfg.d_model, cfg.norm, **kw)}
    if kind in ("attn", "local"):
        p["attn"] = gqa.init_attn(key, cfg, dtype, **kw)
    elif kind == "mla":
        p["attn"] = mla_lib.init_mla(key, cfg, dtype, **kw)
    elif kind == "rglru":
        p["mixer"] = rglru_lib.init_rglru(key, cfg, dtype, **kw)
    elif kind == "mlstm":
        p["mixer"] = xlstm_lib.init_mlstm(key, cfg, dtype, **kw)
    elif kind == "slstm":
        p["mixer"] = xlstm_lib.init_slstm(key, cfg, dtype, **kw)
    else:
        raise ValueError(kind)
    has_ffn = cfg.d_ff > 0 or cfg.moe is not None
    if has_ffn and kind not in ("mlstm", "slstm"):
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, **kw)
        if cfg.moe is not None:
            p["moe"] = moe_lib.init_moe(key, cfg, dtype, **kw)
        else:
            p["mlp"] = mlp_init(key, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                dtype, **kw)
    return p


def _slstm_sharded(h, mixer, cfg: ModelConfig, ctx: ParallelCtx,
                   state=None):
    """sLSTM as the reference runs it under ``shard_map`` (batch over the
    data axes).

    Each rank runs the time loop on its batch shard with the mixer's
    weights gathered whole (the reference's replicated ``in_specs``); the
    weights' gradient leaves the region ``Partial`` over the data axes, so
    it is summed once per block call, as the transpose of ``shard_map``
    sums it, never inside the time loop.  ``state`` (decode) is the
    recurrent state, batch over the data axes too.
    """
    if ctx.mesh is None or not act.is_dtensor(h):
        return xlstm_lib.slstm_forward(h, mixer, cfg, state)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ctx.mesh
    dp = ctx.data_axes if len(ctx.data_axes) > 1 else ctx.data_axes[0]
    h_pl = placements((dp, None, None), mesh)
    rep = (Replicate(),) * len(h_pl)
    summed = tuple(Partial() if isinstance(p, Shard) else Replicate()
                   for p in h_pl)
    h_l = act.to_local(h, mesh, h_pl)
    mixer_l = tree_map(lambda w: act.to_local(w, mesh, rep, summed), mixer)
    st_l = (None if state is None else
            tree_map(lambda t: act.to_local(t, mesh, h_pl), state))
    out, cache = xlstm_lib.slstm_forward(h_l, mixer_l, cfg, st_l)
    return (act.from_local(out, mesh, h_pl),
            tree_map(lambda t: act.from_local(t, mesh, h_pl), cache))


def _store(cache, state) -> None:
    """A recurrent block's new state into its preallocated cache view."""
    for k, v in state.items():
        c = cache[k]
        if act.is_dtensor(c):     # shard into shard, placed as the cache
            c.to_local().copy_(act.to_local(v, c.device_mesh, c.placements))
        else:
            c.copy_(v)


def _ffn(x, p, cfg: ModelConfig, ctx: ParallelCtx, aux: bool = False):
    """The block's second half: MLP or MoE.  Returns (x, aux_loss): the MoE
    aux loss with ``aux`` (the training loss), else ``None`` (the
    reference's serving path drops it, so it is not computed)."""
    loss = torch.zeros((), dtype=torch.float32, device=x.device) \
        if aux else None
    if "norm2" in p:
        h = apply_norm(x, p["norm2"], cfg.norm)
        if "moe" in p:
            out, loss = moe_lib.moe_forward(h, p["moe"], cfg, ctx.mesh,
                                            ctx.data_axes, ctx.model_axis,
                                            fsdp_gather=ctx.fsdp, aux=aux)
        else:
            out = mlp_apply(h, p["mlp"], cfg.mlp_act)
        x = x + out
    return x, loss


def _block_forward(x, p, cfg: ModelConfig, kind: str, ctx: ParallelCtx, *,
                   cache=None, cache_len=None):
    """Full-sequence block.  Returns (x, aux_loss).

    With ``cache`` (prefill) it fills that cache (one layer's view) in
    place and drops the MoE aux loss (``None``).  Without one (the
    training loss) it writes nothing in place, so autograd can
    differentiate it, and returns the aux loss (0 without a MoE).
    """
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else None
        clen = None if cache is None else _cache_len_for(cfg, kind,
                                                         cache_len)
        out, _ = gqa.attn_forward(h, p["attn"], cfg, window=window,
                                  make_cache=cache is not None, cache=cache,
                                  cache_len=clen)
    elif kind == "mla":
        out, _ = mla_lib.mla_forward(h, p["attn"], cfg,
                                     make_cache=cache is not None,
                                     cache=cache, cache_len=cache_len)
    else:
        if kind == "rglru":
            out, state = rglru_lib.rglru_block_forward(h, p["mixer"], cfg)
        elif kind == "mlstm":
            out, state = xlstm_lib.mlstm_chunk_forward(h, p["mixer"], cfg)
        elif kind == "slstm":
            out, state = _slstm_sharded(h, p["mixer"], cfg, ctx)
        else:
            raise ValueError(kind)
        if cache is not None:
            _store(cache, state)
    return _ffn(x + out, p, cfg, ctx, aux=cache is None)


def _block_decode(x, p, cfg: ModelConfig, kind: str, ctx: ParallelCtx,
                  cache, index):
    """One-token block step; advances ``cache`` in place."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else None
        out, _ = gqa.attn_decode(h, p["attn"], cfg, cache, index,
                                 window=window)
    elif kind == "mla":
        out, _ = mla_lib.mla_decode(h, p["attn"], cfg, cache, index)
    else:
        if kind == "rglru":
            out, state = rglru_lib.rglru_block_decode(h, p["mixer"], cfg,
                                                      cache)
        elif kind == "mlstm":
            out, state = xlstm_lib.mlstm_decode(h, p["mixer"], cfg, cache)
        elif kind == "slstm":
            out, state = _slstm_sharded(h, p["mixer"], cfg, ctx, cache)
        else:
            raise ValueError(kind)
        _store(cache, state)
    return _ffn(x + out, p, cfg, ctx)[0]


def _cache_len_for(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    if kind == "local" and cfg.window:
        return min(cache_len, cfg.window)
    return cache_len


def _init_cache_for(cfg: ModelConfig, kind: str, batch, cache_len, dtype, *,
                    lead, device):
    kw = dict(lead=lead, device=device)
    if kind in ("attn", "local"):
        return attn_lib.init_cache(batch, _cache_len_for(cfg, kind,
                                                         cache_len),
                                   cfg.n_kv_heads, cfg.head_dim, dtype, **kw)
    if kind == "mla":
        return mla_lib.init_cache(batch, cache_len, cfg, dtype, **kw)
    if kind == "rglru":
        return rglru_lib.init_state(batch, cfg, dtype, **kw)
    if kind == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, cfg, **kw)
    if kind == "slstm":
        return xlstm_lib.init_slstm_state(batch, cfg, **kw)
    raise ValueError(kind)


def _layers(tree, n: int) -> list:
    """A stacked tree -> ``n`` per-layer trees of views (one ``unbind`` per
    leaf, no copy; gradients flow back into the stacked leaf)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], split) for i in range(n)]


def _save_products(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of products without batch
    dims (``mm`` / ``addmm``: every weight projection, ``x @ W`` and the
    einsums that fold to one), recompute everything else (batched
    attention and expert products, elementwise work) -- the reference's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` under the config's rematerialization mode (the reference's
    ``jax.checkpoint``): ``none`` keeps every activation, ``full`` keeps
    only ``fn``'s inputs and recomputes the rest in the backward pass,
    ``dots`` recomputes all but the products ``_save_products`` keeps.
    Recomputation runs the same operations on the same inputs: the loss and
    gradients are the same bits in every mode."""
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_products)

    def wrapped(*args):
        # the recompute runs in the backward pass: keep the mesh context
        return torch_checkpoint.checkpoint(act.keep_context(fn), *args,
                                           use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# LM: the end-to-end decoder-only model (plus enc-dec variant)
# ---------------------------------------------------------------------------
class LM:
    """Functional language model for one ModelConfig on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                      else torch.float32)

    # -- init ---------------------------------------------------------------
    def init(self, key) -> ParamsWithAxes:
        """Parameters drawn from the generator ``key`` (on this LM's
        device); each stacked group parameter is allocated once."""
        if key.device.type != self.device.type:
            raise ValueError(f"generator on {key.device}, LM on "
                             f"{self.device}")
        return self._init(key, self.device)

    def _init(self, key, device) -> ParamsWithAxes:
        cfg = self.cfg
        kw = dict(device=device)
        groups = {f"b{i}": _init_block(key, cfg, kind, self.dtype,
                                       lead=(cfg.n_groups,), **kw)
                  for i, kind in enumerate(cfg.block_pattern)}
        if cfg.encoder is not None:  # enc-dec: one cross-attention per group
            groups["xnorm"] = norm_init(cfg.d_model, cfg.norm,
                                        lead=(cfg.n_groups,), **kw)
            groups["xattn"] = gqa.init_cross_attn(key, cfg, self.dtype,
                                                  lead=(cfg.n_groups,), **kw)
        tree = {
            "embed": embed_init(key, cfg.vocab_size, cfg.d_model, self.dtype,
                                **kw),
            "final_norm": norm_init(cfg.d_model, cfg.norm, **kw),
            "groups": split_tree(groups),
        }
        if cfg.tail_pattern:
            tree["tail"] = split_tree({
                f"b{i}": _init_block(key, cfg, kind, self.dtype, lead=(),
                                     **kw)
                for i, kind in enumerate(cfg.tail_pattern)})
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(key, (cfg.d_model, cfg.vocab_size),
                                         ("embed", "vocab"), 0, self.dtype,
                                         **kw)
        if cfg.encoder is not None:
            tree["encoder"] = self._init_encoder(key, device)
        return split_tree(tree)

    def _init_encoder(self, key, device):
        cfg = self.cfg
        n = cfg.encoder.n_layers
        return {
            "blocks": split_tree(_init_block(key, cfg, "attn", self.dtype,
                                             lead=(n,), device=device)),
            "pos_embed": dense_init(key, (cfg.encoder.seq_len, cfg.d_model),
                                    (None, "embed"), 0, self.dtype,
                                    device=device),
            "final_norm": norm_init(cfg.d_model, cfg.norm, device=device),
        }

    # -- the layer stack -------------------------------------------------------
    def _groups(self, params, caches):
        """Each group, then the tail: (its params, int8 leaves expanded to
        the model's dtype one layer at a time; its caches; its block
        pattern)."""
        cfg = self.cfg
        n = cfg.n_groups
        for gp, cg in zip(_layers(params["groups"], n),
                          _layers(caches["groups"], n)):
            # int8 serving: the int8 tree streams, one layer expanded
            yield dequant_tree(gp, self.dtype), cg, cfg.block_pattern
        if cfg.tail_pattern:
            yield (dequant_tree(params["tail"], self.dtype), caches["tail"],
                   cfg.tail_pattern)

    def _backbone(self, params, x, caches, cache_len, ctx, enc=None):
        """The prefill's layer stack, filling ``caches`` in place; with an
        encoder output ``enc`` a cross-attention follows each group (the
        reference's ``_encdec_forward``)."""
        cfg = self.cfg
        for gp, cg, pattern in self._groups(params, caches):
            x = act.shard_batch(x)  # anchor the layer carry
            for i, kind in enumerate(pattern):
                x, _ = _block_forward(x, gp[f"b{i}"], cfg, kind, ctx,
                                      cache=cg[f"b{i}"], cache_len=cache_len)
            if enc is not None and "xattn" in gp:
                x = self._cross(x, gp, enc)
        return x

    def _group_loss(self, x, gp, pattern, ctx, enc=None):
        """One group of the training forward: (x, the group's aux loss),
        summed block by block from 0 as the reference's ``_group_forward``
        does."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        gp = dequant_tree(gp, self.dtype)
        x = act.shard_batch(x)  # anchor the layer carry
        for i, kind in enumerate(pattern):
            x, a = _block_forward(x, gp[f"b{i}"], self.cfg, kind, ctx)
            aux = aux + a
        if enc is not None:
            x = self._cross(x, gp, enc)
        return x, aux

    def _train_stack(self, params, x, ctx, enc=None):
        """The layer stack of the loss: no cache, each group under
        ``_remat`` (the decoder-only stack; the reference remats neither the
        tail nor the enc-dec stack), the aux loss summed over groups and
        then the tail in the reference's order.  Returns (x, aux)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        group = functools.partial(self._group_loss, pattern=cfg.block_pattern,
                                  ctx=ctx, enc=enc)
        if enc is None:
            group = _remat(group, cfg.remat)
        for gp in _layers(params["groups"], cfg.n_groups):
            x, a = group(x, gp)
            aux = aux + a
        if cfg.tail_pattern:
            x, a = self._group_loss(x, params["tail"], cfg.tail_pattern, ctx)
            aux = aux + a
        return x, aux

    def _cross(self, x, gp, enc):
        """The enc-dec cross-attention after a group (its k/v from the
        encoder output, recomputed per call as the reference does)."""
        h = apply_norm(x, gp["xnorm"], self.cfg.norm)
        enc_kv = gqa.encode_kv(enc, gp["xattn"], self.cfg)
        return x + gqa.cross_attn_forward(h, enc_kv, gp["xattn"], self.cfg)

    def _encode(self, params, frames, ctx=None):
        """Encoder stack over stub frame/patch embeddings (B, T, d)."""
        cfg = self.cfg
        enc_p = params["encoder"]
        x = frames.to(self.dtype) + dequant_tree(
            enc_p["pos_embed"], self.dtype)[:frames.shape[1]].to(self.dtype)
        for bp in _layers(enc_p["blocks"], cfg.encoder.n_layers):
            bp = dequant_tree(bp, self.dtype)
            h = apply_norm(x, bp["norm1"], cfg.norm)
            out, _ = gqa.attn_forward(h, bp["attn"], cfg, causal=False,
                                      rope=False)
            x = x + out
            h = apply_norm(x, bp["norm2"], cfg.norm)
            x = x + mlp_apply(h, bp["mlp"], cfg.mlp_act)
        return apply_norm(x, enc_p["final_norm"], cfg.norm)

    # -- embeddings / logits --------------------------------------------------
    def _embed(self, params, tokens, extra_embeds=None):
        cfg = self.cfg
        scale = cfg.name.startswith(("gemma", "recurrentgemma"))
        table = dequant_tree(params["embed"], self.dtype)
        x = embed_lookup(tokens, table, scale_by_sqrt_dim=scale)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return act.shard_batch(x)

    def _logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(x, params["final_norm"], cfg.norm)
        if cfg.tie_embeddings:
            return logits_from_embedding(
                x, dequant_tree(params["embed"], x.dtype), cfg.logit_softcap)
        out = x @ dequant_tree(params["lm_head"], x.dtype).to(x.dtype)
        if cfg.logit_softcap:
            out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
        return out

    # -- training loss --------------------------------------------------------
    def loss(self, params, batch, ctx: Optional[ParallelCtx] = None):
        """The training loss: token-mean cross entropy plus the MoE aux loss.

        ``batch["tokens"]`` (B, S+1) integer ids (int64 on the device; the
        inputs are ``[:, :-1]``, the labels ``[:, 1:]``), plus ``patches``
        (B, P, d) for a ``vision`` config (prefixed, then sliced off before
        the logits) or ``frames`` (B, T, d) for an enc-dec one, and an
        optional ``mask`` (B, S).  Above 2^24 logits per sequence row
        (``S * V``) the vocab projection streams in chunks
        (``cross_entropy_streamed``).  Differentiate it with
        ``torch.autograd.grad`` over parameters that require grad
        (``make_train_step`` does).
        """
        ctx = ctx or ParallelCtx()
        _check_leaves(params, ctx)
        cfg = self.cfg
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        extra = batch.get("patches") if cfg.frontend == "vision" else None
        with ieee_fp32(self.device):
            x = self._embed(params, inp, extra)
            enc = (self._encode(params, batch["frames"], ctx)
                   if cfg.encoder is not None else None)
            x, aux = self._train_stack(params, x, ctx, enc)
            if extra is not None:
                x = x[:, extra.shape[1]:]
            mask = batch.get("mask")
            x = apply_norm(x, params["final_norm"], cfg.norm)
            table = (params["embed"] if cfg.tie_embeddings
                     else params["lm_head"].T)
            if x.shape[1] * cfg.vocab_size > (1 << 24):
                # stream the vocab projection: never materialize (B, S, V)
                loss = cross_entropy_streamed(x, table, labels, mask,
                                              softcap=cfg.logit_softcap)
            else:
                logits = logits_from_embedding(x, table, cfg.logit_softcap)
                loss = cross_entropy(logits, labels, mask)
            return loss + aux

    # -- serving ---------------------------------------------------------------
    def init_caches(self, batch, cache_len, *, mesh=None):
        """Zeroed caches and recurrent states: one stacked (n_groups, ...)
        cache per block of the pattern, the tail's per block, and the
        decode position 0.  On a ``mesh`` each cache leaf is a DTensor
        placed by its role (``cache_spec``); the position stays a plain
        0-dim tensor, the same on every rank."""
        cfg = self.cfg

        def one_group(pattern, lead):
            return {f"b{i}": _init_cache_for(cfg, kind, batch, cache_len,
                                             self.dtype, lead=lead,
                                             device=self.device)
                    for i, kind in enumerate(pattern)}

        if mesh is not None:
            return self._mesh_caches(batch, cache_len, mesh)
        return {"groups": one_group(cfg.block_pattern, (cfg.n_groups,)),
                "tail": (one_group(cfg.tail_pattern, ())
                         if cfg.tail_pattern else None),
                "index": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def _mesh_caches(self, batch, cache_len, mesh):
        """``init_caches`` on a mesh: each rank allocates only its shard
        (on the ``meta`` device first for the global shapes)."""
        cfg = self.cfg
        meta = LM(cfg, device="meta")
        like = meta.init_caches(batch, cache_len)

        def place(path, t):
            spec = cache_spec(path, tuple(t.shape), cfg, mesh)
            pl = placements(spec, mesh)
            shape = list(t.shape)
            for i, p in enumerate(pl):
                if hasattr(p, "dim"):
                    shape[p.dim] //= mesh.device_mesh.size(i)
            fill = -1 if path[-1] == "pos" else 0
            local = torch.full(shape, fill, dtype=t.dtype,
                               device=self.device)
            return act.from_local(local, mesh, pl)

        out = {}
        for key in ("groups", "tail"):
            out[key] = _map_path(place, like[key], (key,))
        out["index"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return out

    def prefill(self, params, batch, cache_len, ctx=None):
        """Forward the prompt, building caches. Returns (last_logits, caches).

        ``batch["tokens"]`` (B, S) int64; a ``vision`` config also takes
        ``batch["patches"]`` (B, P, d), prefixed to the token embeddings;
        an enc-dec config ``batch["frames"]`` (B, T, d), whose encoder
        output the caches keep under ``"enc"``.
        """
        ctx = ctx or ParallelCtx()
        _check_leaves(params, ctx)
        cfg = self.cfg
        tokens = batch["tokens"]
        extra = batch.get("patches") if cfg.frontend == "vision" else None
        with ieee_fp32(self.device):
            x = self._embed(params, tokens, extra)
            caches = self.init_caches(x.shape[0], cache_len, mesh=ctx.mesh)
            enc = None
            if cfg.encoder is not None:
                enc = self._encode(params, batch["frames"], ctx)
                caches["enc"] = enc
            x = self._backbone(params, x, caches, cache_len, ctx, enc)
            logits = self._logits(params, x[:, -1:])
        caches["index"].fill_(x.shape[1])
        return logits, caches

    def decode_step(self, params, caches, token, ctx=None):
        """token: (B, 1). Returns (logits (B,1,V), caches), the caches
        advanced in place by one position."""
        ctx = ctx or ParallelCtx()
        _check_leaves(params, ctx)
        cfg = self.cfg
        index = caches["index"]
        enc = caches.get("enc")
        with ieee_fp32(self.device):
            x = self._embed(params, token)
            for gp, cg, pattern in self._groups(params, caches):
                for i, kind in enumerate(pattern):
                    x = _block_decode(x, gp[f"b{i}"], cfg, kind, ctx,
                                      cg[f"b{i}"], index)
                if enc is not None and "xattn" in gp:
                    x = self._cross(x, gp, enc)
            logits = self._logits(params, x)
        out = {"groups": caches["groups"], "tail": caches["tail"],
               "index": index + 1}
        if enc is not None:
            out["enc"] = enc
        return logits, out

    # -- misc -------------------------------------------------------------------
    def param_count(self, params=None) -> int:
        """Number of parameters (of ``params``' leaves if given; else of
        this config, counted on the ``meta`` device: nothing allocated)."""
        if params is None:
            params = self._init(torch.Generator(),
                                torch.device("meta")).params
        return sum(int(a.numel()) for a in tree_leaves(params))


def _map_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def cache_spec(path: tuple, shape: tuple, cfg: ModelConfig, mesh) -> tuple:
    """A cache leaf's spec by its structural role (the reference's
    ``launch/specs._cache_leaf_sharding``): k/v batch over the data axes
    and kv heads over ``model`` (else the sequence), latent caches the
    sequence over ``model``, positions and the encoder output the batch
    only, RG-LRU state its width, xLSTM state its heads.  A stacked group
    cache keeps its leading layer dim replicated."""
    name = path[-1] if path else ""
    off = 1 if "groups" in path else 0
    rank = len(shape)

    def build(**kw):
        inner = cache_sharding(mesh, shape[off:], batch_dim=0, **kw).spec
        return ((None,) * off + tuple(inner)
                + (None,) * (rank - off - len(inner)))

    if name in ("k", "v") and rank - off == 4:
        return build(n_kv=cfg.n_kv_heads, kv_dim=2, seq_dim=1)
    if name in ("c_kv", "k_rope") and rank - off == 3:
        return build(seq_dim=1)
    if name in ("pos", "enc"):
        return build()
    if name in ("h", "conv"):
        return build(n_kv=cfg.lru_dim, kv_dim=rank - off - 1)
    if name in ("c", "n", "m") and rank - off >= 2:
        return build(n_kv=cfg.n_heads, kv_dim=1)
    return (None,) * rank


def lm_param_shardings(cfg: ModelConfig, mesh, fsdp: Optional[bool] = None,
                       expert_fsdp: Optional[bool] = None):
    """The tree of ``NamedSharding`` for ``cfg``'s parameters on ``mesh``
    (the reference's ``launch/specs.params_specs``): ``param_shardings``
    of the logical axes with ``use_tp = cfg.use_tp`` and, by default,
    ``fsdp = cfg.fsdp`` and ``expert_fsdp = cfg.expert_fsdp``."""
    pa = LM(cfg, device="meta")._init(torch.Generator(),
                                      torch.device("meta"))
    return param_shardings(
        pa.axes, pa.params, mesh, fsdp=cfg.fsdp if fsdp is None else fsdp,
        use_tp=cfg.use_tp,
        expert_fsdp=cfg.expert_fsdp if expert_fsdp is None else expert_fsdp)


def lm_params_from_numpy(tree, cfg: ModelConfig, *, device=None, mesh=None,
                         shardings=None):
    """The JAX package's LM params for ``cfg`` (a nested dict of NumPy
    arrays, floats as float32) -> the port's, on ``device``.  Each float
    leaf takes the dtype of the matching leaf of the port's own tree
    (built on the ``meta`` device): the model's dtype for weights, float32
    where both packages keep it (norms, the MoE router, xLSTM's gate
    projections and biases, RG-LRU's ``lam``); bf16 -> float32 -> bf16 is
    exact.  Int8 ``{"q", "scale"}`` leaves are carried as they are.

    With a ``mesh`` each leaf becomes a DTensor placed by ``shardings``
    (default ``lm_param_shardings(cfg, mesh)``): each rank keeps its own
    shard of the NumPy array (int8 leaves on a mesh wait for A12f3)."""
    dev = resolve_device(device)
    lm = LM(cfg, device="meta")
    like = lm._init(torch.Generator(), torch.device("meta")).params

    def walk(t, ref):
        if is_quantized_leaf(t):
            return {"q": torch.tensor(np.asarray(t["q"], np.int8),
                                      device=dev),
                    "scale": torch.tensor(np.asarray(t["scale"], np.float32),
                                          device=dev)}
        if isinstance(t, dict):
            return {k: walk(v, ref[k]) for k, v in t.items()}
        a = np.asarray(t)
        if a.dtype.kind == "f":
            return torch.as_tensor(a.astype(np.float32)).to(
                device=dev, dtype=ref.dtype)
        return torch.tensor(a, device=dev)

    out = walk(tree, like)
    if mesh is None:
        return out
    _check_leaves(out, ParallelCtx(mesh=mesh))
    return distribute_tree(out, shardings or lm_param_shardings(cfg, mesh))


def train_state_from_numpy(state, cfg: ModelConfig, *, device=None,
                           mesh=None):
    """The JAX package's train state ``{"params", "opt": {"m", "v",
    "step"}}`` (NumPy leaves, floats as float32) -> the port's, on
    ``device``: the parameters through ``lm_params_from_numpy`` (the
    port's own dtypes), ``m`` and ``v`` in ``cfg.opt_dtype``, ``step`` a
    0-dim int32 tensor.  On a ``mesh`` the parameters and both moments are
    placed by ``lm_param_shardings(cfg, mesh)``; ``step`` stays a plain
    tensor, the same on every rank."""
    dev = resolve_device(device)
    opt_dtype = (torch.bfloat16 if cfg.opt_dtype == "bfloat16"
                 else torch.float32)
    # a copy: the state is written in place, never into the caller's
    # arrays
    moment = lambda a: torch.tensor(np.asarray(a, np.float32)).to(
        device=dev, dtype=opt_dtype)
    opt = state["opt"]
    m, v = tree_map(moment, opt["m"]), tree_map(moment, opt["v"])
    if mesh is not None:
        sh = lm_param_shardings(cfg, mesh)
        m, v = distribute_tree(m, sh), distribute_tree(v, sh)
    return {"params": lm_params_from_numpy(state["params"], cfg, device=dev,
                                           mesh=mesh),
            "opt": {"m": m, "v": v,
                    "step": torch.tensor(np.asarray(opt["step"], np.int32),
                                         device=dev)}}
