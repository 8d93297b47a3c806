"""Model assembly: block dispatch, stacked layer groups, the LM serving API.

A config's ``block_pattern`` (e.g. ``("attn", "local")``) defines one
*group*; the depth is ``n_groups`` repetitions (plus an optional tail).
Groups are homogeneous, so every group parameter is one stacked tensor with
a leading layer dim, the JAX package's layout; the layer stack is a Python
loop over views of those tensors (the JAX package's ``lax.scan``).

Block types on this path: ``attn`` (global causal attention + MLP) and
``local`` (sliding-window attention + MLP).  The other kinds of the JAX
package (``mla``, ``rglru``, ``mlstm``, ``slstm``), MoE and the enc-dec
encoder raise ``NotImplementedError`` naming their ROADMAP item.

``LM`` keeps the JAX package's functional API: parameters are a nested
dict of tensors, ``prefill`` / ``decode_step`` take them as arguments.  It
departs where PyTorch works differently: an explicit ``device`` (``None``
= ``cuda``, raising without one) and ``torch.Generator`` keys; caches
preallocated and written in place (a decode step returns the caches it was
given, advanced); the decode position a 0-dim device tensor, so a decode
step never synchronises with the host; ``param_count`` on the ``meta``
device in place of ``jax.eval_shape``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import ieee_fp32, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import gqa
from repro_torch.models.common import (ParamsWithAxes, apply_norm,
                                       dense_init, embed_init, embed_lookup,
                                       logits_from_embedding, mlp_apply,
                                       mlp_init, norm_init, split_tree,
                                       tree_leaves, tree_map)
from repro_torch.models.quantize import dequant_tree, is_quantized_leaf

__all__ = ["LM", "ParallelCtx", "lm_params_from_numpy"]

# what the port does not run yet, by ROADMAP item
_WAITS = {
    "mla": "A12b: MLA attention (models/mla.py) is not ported yet",
    "moe": "A12b: MoE layers (models/moe.py) are not ported yet",
    "rglru": "A12c: the RG-LRU block (models/rglru.py) is not ported yet",
    "mlstm": "A12c: the xLSTM blocks (models/xlstm.py) are not ported yet",
    "slstm": "A12c: the xLSTM blocks (models/xlstm.py) are not ported yet",
    "encoder": ("A12d: the enc-dec encoder and cross-attention stack "
                "(whisper) is not ported yet"),
    "mesh": ("A12f: a device mesh (TP/FSDP) is not ported yet; pass "
             "mesh=None"),
}


@dataclasses.dataclass
class ParallelCtx:
    mesh: Any = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp: bool = True


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.block_pattern:
        if kind not in ("attn", "local"):
            if kind not in _WAITS:
                raise ValueError(kind)
            raise NotImplementedError(_WAITS[kind])
    if cfg.moe is not None:
        raise NotImplementedError(_WAITS["moe"])
    if cfg.encoder is not None:
        raise NotImplementedError(_WAITS["encoder"])


def _check_ctx(ctx) -> None:
    if ctx is not None and ctx.mesh is not None:
        raise NotImplementedError(_WAITS["mesh"])


# ---------------------------------------------------------------------------
# Single block init / forward / decode
# ---------------------------------------------------------------------------
def _init_block(key, cfg: ModelConfig, kind: str, dtype, *, lead, device):
    p: dict = {"norm1": norm_init(cfg.d_model, cfg.norm, lead=lead,
                                  device=device),
               "attn": gqa.init_attn(key, cfg, dtype, lead=lead,
                                     device=device)}
    if cfg.d_ff > 0:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, lead=lead,
                               device=device)
        p["mlp"] = mlp_init(key, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype,
                            lead=lead, device=device)
    return p


def _block_forward(x, p, cfg: ModelConfig, kind: str, *, cache, cache_len):
    """Full-sequence block; fills ``cache`` (one layer's view) in place."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    window = cfg.window if kind == "local" else None
    out, _ = gqa.attn_forward(h, p["attn"], cfg, window=window,
                              make_cache=True, cache=cache,
                              cache_len=_cache_len_for(cfg, kind, cache_len))
    x = x + out
    if "norm2" in p:
        h = apply_norm(x, p["norm2"], cfg.norm)
        x = x + mlp_apply(h, p["mlp"], cfg.mlp_act)
    return x


def _block_decode(x, p, cfg: ModelConfig, kind: str, cache, index):
    """One-token block step; appends to ``cache`` in place."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    window = cfg.window if kind == "local" else None
    out, _ = gqa.attn_decode(h, p["attn"], cfg, cache, index, window=window)
    x = x + out
    if "norm2" in p:
        h = apply_norm(x, p["norm2"], cfg.norm)
        x = x + mlp_apply(h, p["mlp"], cfg.mlp_act)
    return x


def _cache_len_for(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    if kind == "local" and cfg.window:
        return min(cache_len, cfg.window)
    return cache_len


def _layers(tree, n: int) -> list:
    """A stacked tree -> ``n`` per-layer trees of views (one ``unbind`` per
    leaf, no copy)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], split) for i in range(n)]


# ---------------------------------------------------------------------------
# LM: the end-to-end decoder-only model
# ---------------------------------------------------------------------------
class LM:
    """Functional language model for one ModelConfig on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        _check_supported(cfg)
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
        return split_tree(tree)

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
        """Zeroed caches: one stacked (n_groups, ...) cache per block of the
        pattern, the tail's per block, and the decode position 0."""
        cfg = self.cfg

        def one_group(pattern, lead):
            return {f"b{i}": attn_lib.init_cache(
                        batch, _cache_len_for(cfg, kind, cache_len),
                        cfg.n_kv_heads, cfg.head_dim, self.dtype, lead=lead,
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
        ``batch["patches"]`` (B, P, d), prefixed to the token embeddings.
        """
        _check_ctx(ctx)
        cfg = self.cfg
        tokens = batch["tokens"]
        extra = batch.get("patches") if cfg.frontend == "vision" else None
        with ieee_fp32(self.device):
            x = self._embed(params, tokens, extra)
            caches = self.init_caches(x.shape[0], cache_len)
            for gp, cg, pattern in self._groups(params, caches):
                for i, kind in enumerate(pattern):
                    x = _block_forward(x, gp[f"b{i}"], cfg, kind,
                                       cache=cg[f"b{i}"], cache_len=cache_len)
            logits = self._logits(params, x[:, -1:])
        caches["index"].fill_(x.shape[1])
        return logits, caches

    def decode_step(self, params, caches, token, ctx=None):
        """token: (B, 1). Returns (logits (B,1,V), caches), the caches
        advanced in place by one position."""
        _check_ctx(ctx)
        cfg = self.cfg
        index = caches["index"]
        with ieee_fp32(self.device):
            x = self._embed(params, token)
            for gp, cg, pattern in self._groups(params, caches):
                for i, kind in enumerate(pattern):
                    x = _block_decode(x, gp[f"b{i}"], cfg, kind, cg[f"b{i}"],
                                      index)
            logits = self._logits(params, x)
        return logits, {"groups": caches["groups"], "tail": caches["tail"],
                        "index": index + 1}

    # -- misc -------------------------------------------------------------------
    def param_count(self, params=None) -> int:
        """Number of parameters (of ``params``' leaves if given; else of
        this config, counted on the ``meta`` device: nothing allocated)."""
        if params is None:
            params = self._init(torch.Generator(),
                                torch.device("meta")).params
        return sum(int(a.numel()) for a in tree_leaves(params))


def lm_params_from_numpy(tree, *, dtype=torch.bfloat16, device=None):
    """The JAX package's LM params (a nested dict of NumPy arrays, floats
    as float32) -> the port's, on ``device``.  Float weights take
    ``dtype`` (the model's; bf16 -> float32 -> bf16 is exact); norm weights
    stay float32, as both packages make them; int8 ``{"q", "scale"}``
    leaves are carried as they are."""
    dev = resolve_device(device)

    def walk(t, norm):
        if is_quantized_leaf(t):
            return {"q": torch.tensor(np.asarray(t["q"], np.int8),
                                      device=dev),
                    "scale": torch.tensor(np.asarray(t["scale"], np.float32),
                                          device=dev)}
        if isinstance(t, dict):
            return {k: walk(v, norm or "norm" in k) for k, v in t.items()}
        a = np.asarray(t)
        if a.dtype.kind == "f":
            return torch.as_tensor(a.astype(np.float32)).to(
                device=dev, dtype=torch.float32 if norm else dtype)
        return torch.tensor(a, device=dev)

    return walk(tree, False)
