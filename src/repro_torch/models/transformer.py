"""Model assembly: block dispatch, stacked layer groups, the LM serving API.

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
decoder group.  Only a device mesh (TP/FSDP/EP, ROADMAP A12f) raises
``NotImplementedError``.

``LM`` keeps the JAX package's functional API: parameters are a nested
dict of tensors, ``prefill`` / ``decode_step`` take them as arguments.  It
departs where PyTorch works differently: an explicit ``device`` (``None``
= ``cuda``, raising without one) and ``torch.Generator`` keys; caches and
recurrent states preallocated and written in place (a decode step returns
the caches it was given, advanced); the decode position a 0-dim device
tensor, so a decode step never synchronises with the host; ``param_count``
on the ``meta`` device in place of ``jax.eval_shape``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import ieee_fp32, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import gqa, mla as mla_lib, moe as moe_lib
from repro_torch.models import rglru as rglru_lib, xlstm as xlstm_lib
from repro_torch.models.common import (ParamsWithAxes, apply_norm,
                                       dense_init, embed_init, embed_lookup,
                                       logits_from_embedding, mlp_apply,
                                       mlp_init, norm_init, split_tree,
                                       tree_leaves, tree_map)
from repro_torch.models.quantize import dequant_tree, is_quantized_leaf

__all__ = ["LM", "ParallelCtx", "lm_params_from_numpy"]

# what the port does not run yet, by ROADMAP item
_WAITS = {
    "mesh": ("A12f: a device mesh (TP/FSDP/EP) is not ported yet; pass "
             "mesh=None"),
}


@dataclasses.dataclass
class ParallelCtx:
    mesh: Any = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp: bool = True


def _check_ctx(ctx) -> None:
    if ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(_WAITS["mesh"])


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


def _slstm_sharded(h, mixer, cfg: ModelConfig, ctx: ParallelCtx):
    """sLSTM; the reference runs it under ``shard_map`` on a mesh (one
    recurrent-weight psum per block call), which waits for A12f."""
    if ctx.mesh is not None:
        raise NotImplementedError(_WAITS["mesh"])
    return xlstm_lib.slstm_forward(h, mixer, cfg)


def _store(cache, state) -> None:
    """A recurrent block's new state into its preallocated cache view."""
    for k, v in state.items():
        cache[k].copy_(v)


def _ffn(x, p, cfg: ModelConfig, ctx: ParallelCtx):
    """The block's second half: MLP or MoE (its aux loss dropped, as the
    reference's serving path drops it)."""
    if "norm2" in p:
        h = apply_norm(x, p["norm2"], cfg.norm)
        if "moe" in p:
            out, _ = moe_lib.moe_forward(h, p["moe"], cfg, ctx.mesh,
                                         ctx.data_axes, ctx.model_axis,
                                         fsdp_gather=ctx.fsdp, aux=False)
        else:
            out = mlp_apply(h, p["mlp"], cfg.mlp_act)
        x = x + out
    return x


def _block_forward(x, p, cfg: ModelConfig, kind: str, ctx: ParallelCtx, *,
                   cache, cache_len):
    """Full-sequence block; fills ``cache`` (one layer's view) in place."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind in ("attn", "local"):
        window = cfg.window if kind == "local" else None
        out, _ = gqa.attn_forward(h, p["attn"], cfg, window=window,
                                  make_cache=True, cache=cache,
                                  cache_len=_cache_len_for(cfg, kind,
                                                           cache_len))
    elif kind == "mla":
        out, _ = mla_lib.mla_forward(h, p["attn"], cfg, make_cache=True,
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
        _store(cache, state)
    return _ffn(x + out, p, cfg, ctx)


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
            out, state = xlstm_lib.slstm_decode(h, p["mixer"], cfg, cache)
        else:
            raise ValueError(kind)
        _store(cache, state)
    return _ffn(x + out, p, cfg, ctx)


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
    leaf, no copy)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], split) for i in range(n)]


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
            for i, kind in enumerate(pattern):
                x = _block_forward(x, gp[f"b{i}"], cfg, kind, ctx,
                                   cache=cg[f"b{i}"], cache_len=cache_len)
            if enc is not None and "xattn" in gp:
                x = self._cross(x, gp, enc)
        return x

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
        return x

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

    # -- serving ---------------------------------------------------------------
    def init_caches(self, batch, cache_len):
        """Zeroed caches and recurrent states: one stacked (n_groups, ...)
        cache per block of the pattern, the tail's per block, and the
        decode position 0."""
        cfg = self.cfg

        def one_group(pattern, lead):
            return {f"b{i}": _init_cache_for(cfg, kind, batch, cache_len,
                                             self.dtype, lead=lead,
                                             device=self.device)
                    for i, kind in enumerate(pattern)}

        return {"groups": one_group(cfg.block_pattern, (cfg.n_groups,)),
                "tail": (one_group(cfg.tail_pattern, ())
                         if cfg.tail_pattern else None),
                "index": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def prefill(self, params, batch, cache_len, ctx=None):
        """Forward the prompt, building caches. Returns (last_logits, caches).

        ``batch["tokens"]`` (B, S) int64; a ``vision`` config also takes
        ``batch["patches"]`` (B, P, d), prefixed to the token embeddings;
        an enc-dec config ``batch["frames"]`` (B, T, d), whose encoder
        output the caches keep under ``"enc"``.
        """
        _check_ctx(ctx)
        ctx = ctx or ParallelCtx()
        cfg = self.cfg
        tokens = batch["tokens"]
        extra = batch.get("patches") if cfg.frontend == "vision" else None
        with ieee_fp32(self.device):
            x = self._embed(params, tokens, extra)
            caches = self.init_caches(x.shape[0], cache_len)
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
        _check_ctx(ctx)
        ctx = ctx or ParallelCtx()
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


def lm_params_from_numpy(tree, cfg: ModelConfig, *, device=None):
    """The JAX package's LM params for ``cfg`` (a nested dict of NumPy
    arrays, floats as float32) -> the port's, on ``device``.  Each float
    leaf takes the dtype of the matching leaf of the port's own tree
    (built on the ``meta`` device): the model's dtype for weights, float32
    where both packages keep it (norms, the MoE router, xLSTM's gate
    projections and biases, RG-LRU's ``lam``); bf16 -> float32 -> bf16 is
    exact.  Int8 ``{"q", "scale"}`` leaves are carried as they are."""
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

    return walk(tree, like)
