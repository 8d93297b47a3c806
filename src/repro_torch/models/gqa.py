"""GQA/MQA attention block: projections + RoPE + (self|cross) attention."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_rope, dense_init, ones_init,
                                       rmsnorm)

__all__ = ["init_attn", "attn_forward", "attn_decode", "init_cross_attn",
           "cross_attn_forward", "encode_kv"]


def init_attn(key, cfg, dtype=torch.float32, cross: bool = False, *,
              lead=(), device=None):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(key, (d, hq, hd), ("embed", "heads", None), 0,
                         dtype, **kw),
        "wk": dense_init(key, (d, hkv, hd), ("embed", "kv", None), 0, dtype,
                         **kw),
        "wv": dense_init(key, (d, hkv, hd), ("embed", "kv", None), 0, dtype,
                         **kw),
        "wo": dense_init(key, (hq, hd, d), ("heads", None, "embed"), (0, 1),
                         dtype, **kw),
    }
    if cfg.qk_norm:
        dev = key.device if device is None else device
        p["q_norm"] = ones_init((hd,), (None,), lead=lead, device=dev)
        p["k_norm"] = ones_init((hd,), (None,), lead=lead, device=dev)
    return p


def _project_qkv(x, p, cfg, positions, rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"].float())
        k = rmsnorm(k, p["k_norm"].float())
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attn_forward(x, p, cfg, *, window: Optional[int] = None, causal=True,
                 q_offset: int = 0, rope: bool = True, make_cache=False,
                 cache_len: Optional[int] = None, cache=None):
    """Full-sequence attention (train/prefill).

    Returns (out, cache|None); cache covers positions [0, S).  ``cache``
    (port only) is a preallocated cache of length ``cache_len`` to fill in
    place, e.g. one layer's view of a stacked cache; without it one is
    allocated.
    """
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions, rope)
    o = attn_lib.attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, softcap=None)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if not make_cache:
        return out, None
    length = cache_len or s
    if cache is None:
        cache = attn_lib.init_cache(b, length, cfg.n_kv_heads, cfg.head_dim,
                                    dtype=x.dtype, device=x.device)
    if length >= s:
        attn_lib.cache_prefill(cache, k, v, 0)
    else:  # ring cache shorter than the prefill (sliding window)
        attn_lib.cache_prefill(cache, k[:, -length:], v[:, -length:], 0)
        cache["pos"][:] = torch.arange(s - length, s, dtype=torch.int32,
                                       device=x.device)
    return out, cache


def attn_decode(x, p, cfg, cache, index, *, window: Optional[int] = None,
                rope: bool = True):
    """One-token decode step. x: (B, 1, d); index: absolute position (an
    int or a 0-dim tensor on x's device).  Writes the cache in place."""
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    positions = index.view(1, 1).expand(x.shape[0], 1)
    q, k, v = _project_qkv(x, p, cfg, positions, rope)
    cache = attn_lib.cache_append(cache, k, v, index)
    o = attn_lib.decode_attention(q, cache, index, window=window)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache


# --- cross attention (whisper decoder) -------------------------------------
def init_cross_attn(key, cfg, dtype=torch.float32, *, lead=(), device=None):
    return init_attn(key, cfg, dtype, lead=lead, device=device)


def cross_attn_forward(x, enc_kv, p, cfg):
    """x: (B, S, d); enc_kv: precomputed (k, v) from encoder output."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k, v = enc_kv
    o = attn_lib.attention(q, k.to(x.dtype), v.to(x.dtype), causal=False)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


def encode_kv(enc_out, p, cfg):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(enc_out.dtype))
    return k, v
